"""Multi-chip occlusion-aware pose optimization: one shard_map step.

The flagship-exceeding feature composed end to end across a device mesh:
the reference's ``hpr=True`` pose branch (`src/pose_optimization.py:93-96`
+ `src/model.py:112-115`) recomputes a *detached* CPU Qhull HPR each step;
:func:`~trajectory_optimization_tpu.models.pose.pose_forward` with
``soft_hpr=True`` differentiates THROUGH Katz occlusion on one chip
(answering the reference's TODO, `src/tools.py:61-62`); this module scales
that same loss over the point axis of a mesh, so the 1M-point north-star
cloud can be pose-optimized occlusion-aware on multiple chips.

Everything lives in ONE shard_map (one jit, no per-step host round trips):

- world->camera transform and the fused visibility score are per-point
  local math on each shard's slice;
- the differentiable binned-HPR mask comes from
  :func:`~trajectory_optimization_tpu.parallel.hpr_sharded._local_mask`
  (per-shard bin+sort, one fixed-size candidate-table ``all_gather`` per
  grid — see that module's docstring for the SPMD design);
- the scalar loss 1/(Σ mask + eps) closes with a single ``psum``.

Gradients flow through the whole composition (shard_map transposes the
all_gathers/psum to psum_scatters/identity); the Adam update runs on the
replicated (1,3)+(1,4) params. Agreement with the single-chip
``pose_forward(soft_hpr=True)`` is pinned on the virtual CPU mesh in
``tests/test_hpr_sharded.py``.

``problem.soft_hpr=False`` is honored too: the HPR gate drops out and the
step is the plain multi-chip visibility loss (single-chip ``pose_forward``
default semantics), parity-pinned in the same test module.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from trajectory_optimization_tpu.models.pose import PoseProblem
from trajectory_optimization_tpu.ops.hpr import SOFT_BINNED_DEFAULTS as _HPR_DEF
from trajectory_optimization_tpu.ops.scores import camera_planes, scores_from_planes
from trajectory_optimization_tpu.opt.engine import OptimizerConfig, make_optimizer
from trajectory_optimization_tpu.parallel.hpr_sharded import (
    _local_mask,
    resolve_hpr_knobs as _resolve_hpr_knobs,
)
from trajectory_optimization_tpu.parallel.mesh import replicated

__all__ = ["pose_loss_sharded", "make_sharded_pose_step"]




def _build_local(problem: PoseProblem, axis: str, n_devices: int,
                 hpr_cap: int, hpr_safety: float):
    """The per-shard loss body (runs under shard_map over ``axis``).

    ``occ_l`` is the per-shard slice of the static occlusion gate
    (single-chip ``pose_forward(occlusion_mask=...)``). It multiplies the
    scores only — NOT the HPR ``valid`` mask: folding it into ``valid``
    (the wps_sharded shortcut) would also remove gated points from the
    soft-HPR coverer set, diverging from the single-chip semantics where
    the two gates are independent."""

    def local(params, points_l, valid_l, occ_l, K):
        n_l = points_l.shape[0]
        quat, trans = params["quat"], params["trans"]
        # one world→camera transform feeds both the visibility score and the
        # HPR input — differentiable occlusion in the CAMERA frame
        # (single-chip pose_forward semantics; the reference's world-frame
        # HPR is a bug preserved only in its own exact tier)
        cxp, cyp, czp = camera_planes(points_l, quat, trans)
        score = scores_from_planes(
            cxp,
            cyp,
            czp,
            K,
            problem.img_width,
            problem.img_height,
            min_dist=problem.min_dist,
            max_dist=problem.max_dist,
            eps=problem.eps,
        )[0]
        if problem.soft_hpr:
            cam = jnp.stack([cxp[0], cyp[0], czp[0]], axis=-1)
            gid0 = (jax.lax.axis_index(axis) * n_l).astype(jnp.int32)
            hpr = _local_mask(
                cam, valid_l, gid0,
                r_param=_HPR_DEF["r_param"], sharpness=_HPR_DEF["sharpness"],
                tau=_HPR_DEF["tau"], cap=hpr_cap, safety=hpr_safety,
                axis=axis, n_global=n_l * n_devices,
            )
            mask = hpr * score * occ_l * valid_l
        else:
            # plain-visibility problem: honor problem.soft_hpr instead of
            # silently occlusion-gating a loss the caller didn't ask for
            # (single-chip pose_forward semantics)
            mask = score * occ_l * valid_l
        total = jax.lax.psum(jnp.sum(mask), axis)
        loss = 1.0 / (total + problem.eps)
        return loss, mask

    return local


def pose_loss_sharded(
    mesh: Mesh,
    params,
    points,
    valid,
    K,
    problem: PoseProblem,
    *,
    axis: str = "pts",
    hpr_cap=None,
    hpr_safety=None,
    occlusion_mask=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pose loss with the point axis sharded over ``axis``.

    Traceable (usable under an outer jit / value_and_grad). Returns
    (scalar loss — replicated, (N,) observations — sharded along ``axis``).
    The differentiable binned-HPR gate follows ``problem.soft_hpr``:
    with it, matches ``pose_forward(..., soft_hpr=True)`` up to
    candidate-tie noise (see parallel.hpr_sharded); without it, the plain
    visibility loss (single-chip ``pose_forward`` default).

    ``occlusion_mask`` is the single-chip static hard-HPR gate
    (``pose_forward(occlusion_mask=...)``): an (N,) weight multiplied into
    the scores, sharded along ``axis``. Unlike wps_sharded it is NOT folded
    into ``valid`` — with ``soft_hpr=True`` the single-chip model keeps the
    two gates independent (valid feeds the soft-HPR coverer set, the
    occlusion weight only scales scores), and this path mirrors that.
    """
    n, d = points.shape[0], mesh.shape[axis]
    if n % d != 0:
        raise ValueError(
            f"cloud size {n} not divisible by mesh axis '{axis}'={d}; "
            "pad with a valid mask first (utils.data.pad_points)")
    occ = (jnp.ones((n,), jnp.float32) if occlusion_mask is None
           else jnp.asarray(occlusion_mask, jnp.float32))
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    local = _build_local(problem, axis, mesh.shape[axis], hpr_cap, hpr_safety)
    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis), P(axis), P()),
        out_specs=(P(), P(axis)),
    )
    return f(params, points, jnp.asarray(valid, jnp.float32), occ, K)


def make_sharded_pose_step(
    mesh: Mesh,
    problem: PoseProblem,
    cfg: OptimizerConfig,
    *,
    axis: str = "pts",
    hpr_cap=None,
    hpr_safety=None,
    occlusion: bool = False,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for the multi-chip pose step
    (occlusion-aware when ``problem.soft_hpr``, plain visibility otherwise).

    Shardings: points/valid/observations along ``axis``; the (1,3)+(1,4)
    params, Adam state and loss replicated. ``step_fn(params, opt_state,
    points, valid, K) -> (params, opt_state, loss, observations)`` — one
    jitted dispatch per step, observations stay sharded on-device for the
    rewards-cloud publisher to fetch (or not) lazily.

    ``occlusion=True`` adds the single-chip static hard-HPR gate
    (``pose_forward(occlusion_mask=...)``) to the step signature:
    ``step_fn(params, opt_state, points, valid, occlusion_mask, K)`` with
    the (N,) gate sharded like ``valid``. A separate build flag (not a
    runtime None) so both variants keep a fixed jit signature.
    """
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    tx = make_optimizer(cfg, pose_key="trans", quat_key="quat")
    rep = replicated(mesh)
    ps_1d = NamedSharding(mesh, P(axis))
    ps = NamedSharding(mesh, P(axis, None))

    def loss_fn(params, points, valid, occ, K):
        return pose_loss_sharded(
            mesh, params, points, valid, K, problem,
            axis=axis, hpr_cap=hpr_cap, hpr_safety=hpr_safety,
            occlusion_mask=occ,
        )

    def init_fn(params):
        return jax.device_put(tx.init(params), rep)

    def _step(params, opt_state, points, valid, occ, K):
        (loss, obs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, points, valid, occ, K
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, obs

    if occlusion:
        step_fn = partial(
            jax.jit,
            donate_argnums=(0, 1),
            in_shardings=(rep, rep, ps, ps_1d, ps_1d, rep),
            out_shardings=(rep, rep, rep, ps_1d),
        )(_step)
    else:
        @partial(
            jax.jit,
            donate_argnums=(0, 1),
            in_shardings=(rep, rep, ps, ps_1d, rep),
            out_shardings=(rep, rep, rep, ps_1d),
        )
        def step_fn(params, opt_state, points, valid, K):
            occ = jnp.ones((points.shape[0],), jnp.float32)
            return _step(params, opt_state, points, valid, occ, K)

    return init_fn, step_fn
