"""Multi-chip occlusion-aware trajectory optimization: 2D (wps × pts) step.

The trajectory counterpart of :mod:`~trajectory_optimization_tpu.parallel.
pose_sharded`, completing the multi-chip soft-HPR story. The reference's
``ModelTraj`` has no occlusion handling at all (its per-waypoint loop is
`src/model.py:217-231`; the HPR TODO is `src/tools.py:61-62`);
:func:`~trajectory_optimization_tpu.models.traj.traj_forward` with
``soft_hpr=True`` adds a differentiable Katz HPR per selected waypoint on
one chip; this module distributes that loss over BOTH natural axes of a
('wps', 'pts') mesh:

- **waypoint axis**: the selected waypoints (padded to the axis size with
  weight-0 dummies) are split across ``wps`` shards; each shard scans only
  its own subset — the per-waypoint HPR is the dominant cost, so this is
  near-linear strong scaling in W_sel;
- **point axis**: within each waypoint, the cloud is sharded over ``pts``
  and occlusion comes from the point-sharded binned-HPR body
  (:func:`~trajectory_optimization_tpu.parallel.hpr_sharded._local_mask` —
  per-bin candidate tables, one all_gather per grid); the
  min-max score normalization becomes a differentiable all_gather+min/max.

Everything lives in ONE shard_map: per-shard transform + scores, sharded
HPR, log-odds partials, then a single ``psum`` over 'wps' closes the
log-odds fusion (an order-independent sum — SURVEY.md §5's sequence-
parallel analogue, here made literal). The composite criterion
(vis + anchor + smoothness + length) runs on the replicated lo_sum.

Occlusion always uses the BINNED kernel (the dense O(N²) form cannot be
point-sharded without materializing cross-shard pair tiles); parity with
the single-chip ``soft_hpr_dense_max=0`` loss is pinned on the virtual CPU
mesh in ``tests/test_traj_sharded.py``, gradients included. Reverse-mode
only (the binned kernel's custom-VJP sorts).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from trajectory_optimization_tpu.models.traj import (
    TrajProblem,
    logodds_from_minmax,
    traj_criterion,
)
from trajectory_optimization_tpu.ops.hpr import SOFT_BINNED_DEFAULTS as _HPR_DEF
from trajectory_optimization_tpu.ops.scores import camera_planes, scores_from_planes
from trajectory_optimization_tpu.opt.engine import OptimizerConfig, make_optimizer
from trajectory_optimization_tpu.parallel.hpr_sharded import (
    _local_mask,
    resolve_hpr_knobs as _resolve_hpr_knobs,
)
from trajectory_optimization_tpu.parallel.mesh import replicated

__all__ = ["traj_soft_hpr_loss_sharded", "make_sharded_traj_step"]




def _logodds_sharded(raw_l, valid_l, eps, pts_axis):
    """observation_logodds with the per-waypoint min/max taken over the
    GLOBAL cloud: one scalar all_gather+min/max pair over the point axis
    (differentiable, unlike lax.pmin/pmax), then the single-chip tail via
    the shared models.traj.logodds_from_minmax helper."""
    big = jnp.asarray(jnp.finfo(raw_l.dtype).max, raw_l.dtype)
    v = valid_l > 0
    pmin_l = jnp.min(jnp.where(v, raw_l, big))
    pmax_l = jnp.max(jnp.where(v, raw_l, -big))
    pmin = jnp.min(jax.lax.all_gather(pmin_l, pts_axis))
    pmax = jnp.max(jax.lax.all_gather(pmax_l, pts_axis))
    return logodds_from_minmax(raw_l, pmin, pmax, eps)


def _build_local(problem: TrajProblem, wps_axis: str, pts_axis: str,
                 n_pts_shards: int, hpr_cap: int, hpr_safety: float):
    """The per-shard loss body (runs under shard_map over both axes)."""

    def local(quats_sel, poses_sel, wts, points_l, valid_l, K):
        n_l = points_l.shape[0]
        gid0 = (jax.lax.axis_index(pts_axis) * n_l).astype(jnp.int32)

        @jax.checkpoint  # remat per waypoint: O(n_l) live memory for the scan
        def wp_lo(quat, pose, w):
            # one world→camera transform feeds both score and HPR input
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
                r_param=_HPR_DEF["r_param"], sharpness=_HPR_DEF["sharpness"],
                tau=_HPR_DEF["tau"], cap=hpr_cap, safety=hpr_safety,
                axis=pts_axis, n_global=n_l * n_pts_shards,
                vma_axes=(wps_axis, pts_axis),
            )
            lo = _logodds_sharded(hpr * score, valid_l, problem.eps, pts_axis)
            # w = 0 on the padded dummy waypoints: kills value AND gradient
            return w * lo

        def body(acc, x):
            quat, pose, w = x
            return acc + wp_lo(quat, pose, w), None

        acc0 = jax.lax.pcast(  # replicated-constant init, varying body output
            jnp.zeros((n_l,), jnp.float32), (wps_axis, pts_axis), to="varying")
        acc, _ = jax.lax.scan(body, acc0, (quats_sel, poses_sel, wts))
        # log-odds fusion across waypoint shards — ONE psum over 'wps'
        return jax.lax.psum(acc, wps_axis)

    return local


def _pad_selected(params, problem: TrajProblem, n_wps_shards: int):
    """Stride-select the visibility waypoints and pad to the axis size with
    weight-0 dummies (identity quat, origin pose — constants, no gradient
    path). Returns (quats_sel, poses_sel, weights), each W_pad-long."""
    sel = slice(None, None, problem.wps_step)
    q_sel, p_sel = params["quats"][sel], params["poses"][sel]
    w_sel = q_sel.shape[0]
    w_pad = -(-w_sel // n_wps_shards) * n_wps_shards
    pad = w_pad - w_sel
    if pad:
        q_sel = jnp.concatenate(
            [q_sel, jnp.tile(jnp.asarray([[1.0, 0.0, 0.0, 0.0]], q_sel.dtype),
                             (pad, 1))])
        p_sel = jnp.concatenate([p_sel, jnp.zeros((pad, 3), p_sel.dtype)])
    wts = jnp.concatenate(
        [jnp.ones((w_sel,), jnp.float32), jnp.zeros((pad,), jnp.float32)])
    return q_sel, p_sel, wts


def traj_soft_hpr_loss_sharded(
    mesh: Mesh,
    params,
    points,
    valid,
    K,
    poses0,
    problem: TrajProblem,
    *,
    wps_axis: str = "wps",
    pts_axis: str = "pts",
    hpr_cap=None,
    hpr_safety=None,
):
    """Occlusion-aware trajectory loss over a ('wps', 'pts') mesh.

    Traceable (usable under an outer jit / value_and_grad). Returns the
    same (loss, aux) as ``traj_forward(soft_hpr=True)`` with the binned
    HPR forced (``soft_hpr_dense_max=0``), up to quantized-key candidate
    ties (see parallel.hpr_sharded); aux['rewards'] is sharded over
    ``pts_axis``. ``len(points)`` must divide the 'pts' axis size.
    """
    n = points.shape[0]
    d_pts = mesh.shape[pts_axis]
    if n % d_pts != 0:
        raise ValueError(
            f"cloud size {n} not divisible by mesh axis '{pts_axis}'={d_pts}; "
            "pad with a valid mask first (utils.data.pad_points)")
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    q_sel, p_sel, wts = _pad_selected(params, problem, mesh.shape[wps_axis])
    local = _build_local(problem, wps_axis, pts_axis, d_pts,
                         hpr_cap, hpr_safety)
    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(wps_axis, None), P(wps_axis, None), P(wps_axis),
                  P(pts_axis, None), P(pts_axis), P()),
        out_specs=P(pts_axis),
    )
    lo_sum = f(q_sel, p_sel, wts, points,
               jnp.asarray(valid, jnp.float32), K)
    return traj_criterion(lo_sum, params, poses0, problem, valid=valid)


def make_sharded_traj_step(
    mesh: Mesh,
    problem: TrajProblem,
    cfg: OptimizerConfig,
    *,
    wps_axis: str = "wps",
    pts_axis: str = "pts",
    hpr_cap=None,
    hpr_safety=None,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for the multi-chip occlusion-aware
    trajectory step (same contract as parallel.sharded.make_sharded_train_
    step): ``step_fn(params, opt_state, points, valid, K, poses0, quats0)
    -> (params, opt_state, loss, scalar_aux)``. Points/valid sharded over
    ``pts_axis``; params, Adam state and the frozen initial path
    replicated; the waypoint axis is sharded internally per step.
    """
    if not problem.soft_hpr:
        raise ValueError(
            "make_sharded_traj_step is the occlusion-aware (soft_hpr) step; "
            "for the plain visibility loss use "
            "parallel.sharded.make_sharded_train_step")
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    tx = make_optimizer(cfg)
    rep = replicated(mesh)
    ps = NamedSharding(mesh, P(pts_axis, None))
    ps_1d = NamedSharding(mesh, P(pts_axis))

    def loss_fn(params, points, valid, K, poses0):
        return traj_soft_hpr_loss_sharded(
            mesh, params, points, valid, K, poses0, problem,
            wps_axis=wps_axis, pts_axis=pts_axis,
            hpr_cap=hpr_cap, hpr_safety=hpr_safety,
        )

    def init_fn(params):
        return jax.device_put(tx.init(params), rep)

    @partial(
        jax.jit,
        donate_argnums=(0, 1),
        in_shardings=(rep, rep, ps, ps_1d, rep, rep, rep),
        out_shardings=(rep, rep, rep, rep),
    )
    def step_fn(params, opt_state, points, valid, K, poses0, quats0):
        del quats0  # criterion anchors on poses0 only (reference parity)
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, points, valid, K, poses0
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        scalars = {k: v for k, v in aux.items() if v.ndim == 0}
        return params, opt_state, loss, scalars

    return init_fn, step_fn
