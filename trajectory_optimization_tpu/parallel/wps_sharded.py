"""Multi-chip Waypoints Optimization: per-waypoint X/Y/yaw over a point mesh.

Scales ``models.wps_opt`` (the reference README's cam_wps_opt mode,
`README.md:66-71`) to clouds larger than one chip: the point axis is sharded
over the mesh, every shard scores ALL W waypoints against its point slice
((W, N_local) local work — the waypoint axis stays replicated because the
per-waypoint parameter state is tiny), and the only cross-chip traffic is
ONE ``psum`` of the (W,) per-waypoint observation sums. Gradients transpose
that psum to an identity, so the backward is as local as the forward.

The optimizable params ({'xy': (W, 2), 'yaw': (W,)}), frozen path parts,
Adam state and per-waypoint losses are replicated; points/valid and the
(W, N) observations stay sharded. Parity with the single-chip
``wps_forward`` is pinned on the virtual CPU mesh in tests/test_wps_eval.py.

``problem.soft_hpr=True`` gates every waypoint's scores with the
point-sharded differentiable binned HPR on that waypoint's camera-frame
cloud (``parallel.hpr_sharded._local_mask`` — per-bin candidate tables,
one all_gather per grid), scanned over waypoints with a
checkpointed body exactly like the single-chip ``wps_forward`` and the
trajectory step ``parallel.traj_sharded``. Reverse-mode only in that case
(the binned kernel's custom-VJP sorts).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from trajectory_optimization_tpu.models.wps_opt import WpsOptProblem, wps_path
from trajectory_optimization_tpu.ops.hpr import SOFT_BINNED_DEFAULTS as _HPR_DEF
from trajectory_optimization_tpu.ops.scores import (
    camera_planes,
    scores_from_planes,
    waypoint_scores,
)
from trajectory_optimization_tpu.opt.engine import OptimizerConfig, make_optimizer
from trajectory_optimization_tpu.parallel.hpr_sharded import (
    _local_mask,
    resolve_hpr_knobs as _resolve_hpr_knobs,
)
from trajectory_optimization_tpu.parallel.mesh import replicated

__all__ = ["wps_loss_sharded", "make_sharded_wps_step"]




def _build_local(problem: WpsOptProblem, axis: str, n_pts_shards: int,
                 hpr_cap: int, hpr_safety: float):
    """Per-shard loss body (runs under shard_map over ``axis``).

    ``occ_l`` is the per-shard slice of the static occlusion gate. Like
    pose_sharded (and unlike the pre-soft-HPR valid-fold this module used
    to do), it scales scores only and never feeds the soft-HPR coverer
    set — the single-chip ``wps_forward`` keeps the two gates independent.
    """

    def local(params, frozen, points_l, valid_l, occ_l, K):
        trans, quats = wps_path(params, frozen)  # replicated tiny math
        if problem.soft_hpr:
            n_l = points_l.shape[0]
            gid0 = (jax.lax.axis_index(axis) * n_l).astype(jnp.int32)

            @jax.checkpoint  # remat per waypoint: O(n_l) live memory
            def wp_mask(quat, pose):
                # one world→camera transform feeds score AND HPR input —
                # same gate pipeline as models.traj.gated_waypoint_scores,
                # with the point-sharded binned HPR (traj_sharded mirror)
                cxp, cyp, czp = camera_planes(points_l, quat[None], pose[None])
                score = scores_from_planes(
                    cxp, cyp, czp, K,
                    problem.img_width, problem.img_height,
                    min_dist=problem.min_dist, max_dist=problem.max_dist,
                    eps=problem.eps,
                )[0]
                cam = jnp.stack([cxp[0], cyp[0], czp[0]], axis=-1)
                hpr = _local_mask(
                    cam, valid_l, gid0,
                    r_param=_HPR_DEF["r_param"],
                    sharpness=_HPR_DEF["sharpness"],
                    tau=_HPR_DEF["tau"], cap=hpr_cap, safety=hpr_safety,
                    axis=axis, n_global=n_l * n_pts_shards,
                )
                return hpr * score

            def body(_, qp):
                quat, pose = qp
                return None, wp_mask(quat, pose)

            _, mask = jax.lax.scan(body, None, (quats, trans))  # (W, N_l)
        else:
            mask = waypoint_scores(
                points_l, quats, trans, K,
                problem.img_width, problem.img_height,
                min_dist=problem.min_dist, max_dist=problem.max_dist,
                eps=problem.eps,
            )  # (W, N_local)
        mask = mask * (occ_l * valid_l)[None, :]
        per_wp = jax.lax.psum(jnp.sum(mask, axis=-1), axis)  # (W,) replicated
        losses = 1.0 / (per_wp + problem.eps)
        aux = {
            "losses": losses,
            "observations": mask,
            "mean_reward": jnp.mean(per_wp),
        }
        return jnp.sum(losses), aux

    return local


def wps_loss_sharded(
    mesh: Mesh,
    params,
    frozen,
    points,
    valid,
    K,
    problem: WpsOptProblem,
    *,
    axis: str = "pts",
    occlusion_mask=None,
    hpr_cap=None,
    hpr_safety=None,
):
    """Summed per-waypoint loss with the point axis sharded over ``axis``.

    Traceable under an outer jit / value_and_grad. Returns (loss, aux) with
    aux = {'losses' (W,), 'observations' (W, N) sharded on the point axis,
    'mean_reward' scalar} — the single-chip ``wps_forward`` contract.
    With ``problem.soft_hpr`` the scores are occlusion-gated by the
    point-sharded differentiable binned HPR (module docstring); parity vs
    ``wps_forward(soft_hpr=True)`` with the binned kernel forced is pinned
    in tests/test_wps_eval.py.

    ``occlusion_mask`` is the single-chip ``wps_forward`` static hard-HPR
    gate, an (N,) weight multiplied into every waypoint's scores (sharded
    along ``axis``; independent of the soft-HPR coverer set, matching the
    single-chip model).
    """
    n, d = points.shape[0], mesh.shape[axis]
    if n % d != 0:
        raise ValueError(
            f"cloud size {n} not divisible by mesh axis '{axis}'={d}; "
            "pad with a valid mask first (utils.data.pad_points)")
    valid = jnp.asarray(valid, jnp.float32)
    occ = (jnp.ones((n,), jnp.float32) if occlusion_mask is None
           else jnp.asarray(occlusion_mask, jnp.float32))
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    local = _build_local(problem, axis, d, hpr_cap, hpr_safety)
    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P(axis), P(axis), P()),
        out_specs=(
            P(),
            {"losses": P(), "observations": P(None, axis), "mean_reward": P()},
        ),
    )
    return f(params, frozen, points, valid, occ, K)


def make_sharded_wps_step(
    mesh: Mesh,
    problem: WpsOptProblem,
    cfg: OptimizerConfig,
    *,
    axis: str = "pts",
    hpr_cap=None,
    hpr_safety=None,
    occlusion: bool = False,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for multi-chip waypoint refinement
    (occlusion-aware when ``problem.soft_hpr``, plain visibility otherwise).

    ``step_fn(params, opt_state, frozen, points, valid, K) -> (params,
    opt_state, losses, observations)`` — one jitted dispatch per Adam step;
    ``losses`` is the replicated (W,) per-waypoint vector, observations stay
    sharded for lazy fetching. Two-group Adam on ('xy', 'yaw') exactly like
    the single-chip engine path.

    ``occlusion=True`` adds the single-chip static hard-HPR gate
    (``wps_forward(occlusion_mask=...)``) to the step signature:
    ``step_fn(params, opt_state, frozen, points, valid, occlusion_mask,
    K)`` with the (N,) gate sharded like ``valid``. It rides
    ``wps_loss_sharded(occlusion_mask=...)``, which multiplies scores but
    stays out of the soft-HPR coverer set — folding the gate into
    ``valid`` instead would change the coverer semantics (mirror of
    pose_sharded's flag). A build flag (not a runtime None) so both
    variants keep a fixed jit signature.
    """
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    tx = make_optimizer(cfg, pose_key="xy", quat_key="yaw")
    rep = replicated(mesh)
    ps_1d = NamedSharding(mesh, P(axis))
    ps_2d = NamedSharding(mesh, P(axis, None))
    ps_wn = NamedSharding(mesh, P(None, axis))

    def loss_fn(params, frozen, points, valid, occ, K):
        return wps_loss_sharded(
            mesh, params, frozen, points, valid, K, problem, axis=axis,
            occlusion_mask=occ, hpr_cap=hpr_cap, hpr_safety=hpr_safety)

    def init_fn(params):
        return jax.device_put(tx.init(params), rep)

    def _step(params, opt_state, frozen, points, valid, occ, K):
        (_, aux), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, frozen, points, valid, occ, K)
        losses, obs = aux["losses"], aux["observations"]
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, losses, obs

    if occlusion:
        step_fn = partial(
            jax.jit,
            donate_argnums=(0, 1),
            in_shardings=(rep, rep, rep, ps_2d, ps_1d, ps_1d, rep),
            out_shardings=(rep, rep, rep, ps_wn),
        )(_step)
    else:
        @partial(
            jax.jit,
            donate_argnums=(0, 1),
            in_shardings=(rep, rep, rep, ps_2d, ps_1d, rep),
            out_shardings=(rep, rep, rep, ps_wn),
        )
        def step_fn(params, opt_state, frozen, points, valid, K):
            occ = jnp.ones((points.shape[0],), jnp.float32)
            return _step(params, opt_state, frozen, points, valid, occ, K)

    return init_fn, step_fn
