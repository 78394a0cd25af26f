"""Multi-chip frozen-routing occlusion-aware trajectory step.

Composes the two flagship pieces of the occlusion-aware trajectory story
(VERDICT r4 item 1):

- the **frozen-routing engine** (models.traj_frozen): host-planned soft-HPR
  routing refreshed every k steps, ONE fused dominance op per device step —
  the 13× win over per-step binned routing at reference scale;
- the **('wps','pts') mesh step** (parallel.traj_sharded): waypoints and
  cloud sharded over the mesh, log-odds fused with one psum.

The reference has neither: its trajectory model loops waypoints on host
(`src/model.py:210-217`) and its HPR TODO (`src/tools.py:56-85`) is
host-side Qhull. Here the 504→40 ms single-chip win stacks onto multi-chip
scaling instead of being thrown away by per-step routing inside every shard
(which is what parallel.traj_sharded still pays).

Sharding design — the plan is HOST-BUILT numpy, so the point axis is
partitioned at build time, not on device:

- **queries** (points whose visibility the loss reads) partition exactly by
  canonical id range: shard s owns ids [s·n/d, (s+1)·n/d) — the same
  contiguous blocks ``P('pts')`` gives the points array, so the embedded
  (W, n_local) gate lands on exactly the shard's own slice of the cloud;
- **coverers** (points that can occlude a query) are drawn from the FULL
  cloud on every shard — occluders don't respect shard boundaries.
  Duplicating them is correct: each query's dominance max consumes every
  same-bin coverer exactly once, on the query's owner shard. The per-bin
  coverer band keys off the owned queries only — a subset of the
  single-chip band that still contains every coverer relevant to an owned
  query (same-bin dominance + the logsumexp tail bound, see
  models.traj_frozen.build_traj_plan's ``owner`` docs);
- **waypoints** shard over 'wps' exactly like parallel.traj_sharded: padded
  to the axis size with weight-0 dummies, which get all-padding layouts
  (zero queries → zero loss and gradient);
- cross-shard reductions are three cheap collectives: an all_gather'd max
  for the flip radius, an all_gather'd min/max pair for the per-waypoint
  score normalization (differentiable — lax.pmax has no VJP), and the ONE
  psum over 'wps' that closes the log-odds fusion. Everything heavy — the
  (W,G,T,cap,cap) dominance tiles, the stored-permutation sorts — is
  embarrassingly parallel per shard.

Parity vs the single-chip frozen step (and hence, at a refresh, vs the
per-step-routed ``traj_forward(soft_hpr=True, soft_hpr_dense_max=0)``) is
pinned on the virtual CPU mesh in tests/test_traj_frozen_sharded.py,
gradients included.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from trajectory_optimization_tpu.models.traj import (
    TrajProblem,
    logodds_from_minmax,
    traj_criterion,
)
from trajectory_optimization_tpu.models.traj_frozen import (
    FrozenPlanConfig,
    FrozenTrajOptimizer,
    PlanMeta,
    build_traj_plan,
    frozen_soft_hpr_scores,
)
from trajectory_optimization_tpu.opt.engine import OptimizerConfig, make_optimizer
from trajectory_optimization_tpu.parallel.mesh import replicated
from trajectory_optimization_tpu.parallel.traj_sharded import _pad_selected

__all__ = [
    "build_frozen_sharded_plan",
    "traj_frozen_loss_sharded",
    "make_frozen_sharded_traj_step",
    "FrozenShardedTrajOptimizer",
]


# ---------------------------------------------------------------------------
# host-side plan construction (numpy; one call per refresh)
# ---------------------------------------------------------------------------


def build_frozen_sharded_plan(
    points: np.ndarray,
    valid: Optional[np.ndarray],
    poses_sel: np.ndarray,
    quats_sel: np.ndarray,
    K: np.ndarray,
    problem: TrajProblem,
    cfg: FrozenPlanConfig = FrozenPlanConfig(),
    *,
    d_wps: int,
    d_pts: int,
    min_tiles: int = 1,
    min_t_big: int = 1,
) -> Tuple[Dict[str, np.ndarray], PlanMeta]:
    """Build the mesh-sharded frozen plan: one owner-sliced sub-plan per
    point shard, stacked along a leading (d_pts,) axis, waypoints padded to
    a multiple of ``d_wps`` with inactive dummies.

    Returned arrays have shape (d_pts, W_pad, ...) and device-put with
    ``P(pts_axis, wps_axis)`` slice cleanly into per-shard sub-plans. The
    returned meta is PER SHARD: ``n_sel`` = W_pad (the wps axis is sliced
    by shard_map), ``n_points`` = n // d_pts, ``tiles``/``t_big`` unified
    to the max across shards (one compiled program for all of them).
    """
    n = len(points)
    if n % d_pts != 0:
        raise ValueError(
            f"cloud size {n} not divisible by point-shard count {d_pts}; "
            "pad with a valid mask first (utils.data.pad_points)")
    n_l = n // d_pts
    w_sel = len(poses_sel)
    w_pad = -(-w_sel // d_wps) * d_wps
    pad = w_pad - w_sel
    poses_p = np.asarray(poses_sel, np.float64)
    quats_p = np.asarray(quats_sel, np.float64)
    if pad:
        poses_p = np.concatenate([poses_p, np.zeros((pad, 3))])
        quats_p = np.concatenate(
            [quats_p, np.tile([[1.0, 0.0, 0.0, 0.0]], (pad, 1))])
    wp_active = np.arange(w_pad) < w_sel

    def _one(s: int, mt: int, mtb: int):
        return build_traj_plan(
            points, valid, poses_p, quats_p, K, problem, cfg,
            min_tiles=mt, min_t_big=mtb,
            owner=(s * n_l, (s + 1) * n_l), wp_active=wp_active)

    built = [_one(s, min_tiles, min_t_big) for s in range(d_pts)]
    # unify the static shape across shards (ONE compiled program); rebuild
    # only the shards below the max — after the runner's floors warm up,
    # every shard hits the floor on the first pass and no rebuilds happen
    T = max(m.tiles for _, m in built)
    TB = max(m.t_big for _, m in built)
    built = [b if (b[1].tiles == T and b[1].t_big == TB) else _one(s, T, TB)
             for s, b in enumerate(built)]
    meta = built[0][1]
    # the single-chip sparse-criterion arrays (combine_*/seg_head/n_q) are
    # unused by the sharded loss (it embeds per shard) and their flat W·M
    # layout doesn't follow the (pts, wps) sharding — drop them
    skip = {"combine_fwd", "combine_bwd", "seg_head", "n_q"}
    plan = {
        k: np.stack([p[k] for p, _ in built])
        for k in built[0][0]
        if not k.startswith("_") and k not in skip
    }
    return plan, meta


# ---------------------------------------------------------------------------
# the sharded loss (traceable under an outer jit)
# ---------------------------------------------------------------------------


def _build_frozen_local(problem: TrajProblem, meta_l: PlanMeta,
                        wps_axis: str, pts_axis: str):
    """Per-(wps,pts)-shard loss body (runs under shard_map)."""

    def local(plan_l, q_sel, p_sel, wts, points_l, valid_l, K):
        # squeeze the size-1 point-shard dim shard_map leaves on the plan
        plan_l = {k: v[0] for k, v in plan_l.items()}

        def allred(maxnorm):  # local (W_loc,) -> global per-waypoint max
            return jnp.max(jax.lax.all_gather(maxnorm, pts_axis), axis=0)

        gated, _ = frozen_soft_hpr_scores(
            plan_l, meta_l, q_sel, p_sel, points_l, K, problem, valid_l,
            norm_allreduce=allred)  # (W_loc, n_l)

        # per-waypoint min/max over the GLOBAL cloud: one all_gather'd
        # min/max pair (differentiable), then the shared normalize→clip→
        # log-odds tail — same split as parallel.traj_sharded
        big = jnp.asarray(jnp.finfo(gated.dtype).max, gated.dtype)
        vb = valid_l > 0
        pmin_l = jnp.min(jnp.where(vb[None], gated, big), axis=1)
        pmax_l = jnp.max(jnp.where(vb[None], gated, -big), axis=1)
        pmin = jnp.min(jax.lax.all_gather(pmin_l, pts_axis), axis=0)
        pmax = jnp.max(jax.lax.all_gather(pmax_l, pts_axis), axis=0)
        lo = logodds_from_minmax(
            gated, pmin[:, None], pmax[:, None], problem.eps)

        # wts = 0 on padded dummy waypoints (their layouts are empty, so
        # lo is already 0 — the weight also kills any gradient path)
        acc = jnp.sum(wts[:, None] * lo, axis=0)
        # log-odds fusion across waypoint shards — ONE psum over 'wps'
        return jax.lax.psum(acc, wps_axis)

    return local


def traj_frozen_loss_sharded(
    mesh: Mesh,
    params,
    plan,
    meta: PlanMeta,
    points,
    valid,
    K,
    poses0,
    problem: TrajProblem,
    *,
    wps_axis: str = "wps",
    pts_axis: str = "pts",
):
    """Occlusion-aware trajectory loss under a frozen plan on a
    ('wps','pts') mesh. Same (loss, aux) contract as
    ``models.traj_frozen.traj_forward_frozen`` (and, at a refresh, as
    ``traj_forward(soft_hpr=True, soft_hpr_dense_max=0)`` up to the gate
    threshold). ``plan``/``meta`` from :func:`build_frozen_sharded_plan`
    built for the CURRENT selected waypoints.
    """
    d_wps, d_pts = mesh.shape[wps_axis], mesh.shape[pts_axis]
    q_sel, p_sel, wts = _pad_selected(params, problem, d_wps)
    if q_sel.shape[0] != meta.n_sel:
        raise ValueError(
            f"plan was built for {meta.n_sel} padded waypoints, params "
            f"select {q_sel.shape[0]} — rebuild the plan (refresh)")
    if points.shape[0] != meta.n_points * d_pts:
        raise ValueError(
            f"plan was built for {meta.n_points}-point shards x {d_pts}, "
            f"got a {points.shape[0]}-point cloud")
    meta_l = dataclasses.replace(meta, n_sel=meta.n_sel // d_wps)
    local = _build_frozen_local(problem, meta_l, wps_axis, pts_axis)
    plan_specs = {k: P(pts_axis, wps_axis) for k in plan}
    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(plan_specs, P(wps_axis, None), P(wps_axis, None),
                  P(wps_axis), P(pts_axis, None), P(pts_axis), P()),
        out_specs=P(pts_axis),
    )
    lo_sum = f(plan, q_sel, p_sel, wts, points,
               jnp.asarray(valid, jnp.float32), K)
    return traj_criterion(lo_sum, params, poses0, problem, valid=valid)


# ---------------------------------------------------------------------------
# step builder + runner
# ---------------------------------------------------------------------------


def make_frozen_sharded_traj_step(
    mesh: Mesh,
    problem: TrajProblem,
    cfg: OptimizerConfig,
    meta: PlanMeta,
    *,
    wps_axis: str = "wps",
    pts_axis: str = "pts",
) -> Callable:
    """Jitted multi-chip frozen-plan Adam step for a fixed PlanMeta:
    ``step_fn(params, opt_state, plan, points, valid, K, poses0, quats0)
    -> (params, opt_state, loss, scalar_aux)`` — the single-chip
    FrozenTrajOptimizer step contract, with points/valid sharded over
    ``pts_axis`` and the plan over ``(pts_axis, wps_axis)``. Compiled once
    per meta; the runner caches per-meta step functions exactly like the
    single-chip one.
    """
    tx = make_optimizer(cfg)
    rep = replicated(mesh)
    ps = NamedSharding(mesh, P(pts_axis, None))
    ps_1d = NamedSharding(mesh, P(pts_axis))
    plan_sh = NamedSharding(mesh, P(pts_axis, wps_axis))

    def loss_fn(params, plan, points, valid, K, poses0):
        return traj_frozen_loss_sharded(
            mesh, params, plan, meta, points, valid, K, poses0, problem,
            wps_axis=wps_axis, pts_axis=pts_axis)

    @partial(
        jax.jit,
        donate_argnums=(0, 1),
        in_shardings=(rep, rep, plan_sh, ps, ps_1d, rep, rep, rep),
        out_shardings=(rep, rep, rep, rep),
    )
    def step_fn(params, opt_state, plan, points, valid, K, poses0, quats0):
        del quats0  # criterion anchors on poses0 only (reference parity)
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, plan, points, valid, K, poses0)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        scalars = {k: v for k, v in aux.items() if v.ndim == 0}
        return params, opt_state, loss, scalars

    return step_fn


class FrozenShardedTrajOptimizer(FrozenTrajOptimizer):
    """Multi-chip occlusion-aware trajectory optimization with
    host-refreshed frozen routing — the single-chip runner's refresh
    cadence, async plan builds and per-meta jit cache, with the plan
    sliced per point shard and the step running over the ('wps','pts')
    mesh. Drop-in peer of FrozenTrajOptimizer (same step()/run() API)."""

    _need_embed = True  # the sharded loss embeds per shard (n_l-sized)

    def __init__(self, mesh: Mesh, points, K, poses0, quats0,
                 problem: TrajProblem, opt_cfg=None,
                 plan_cfg: FrozenPlanConfig = FrozenPlanConfig(),
                 valid=None, *, wps_axis: str = "wps",
                 pts_axis: str = "pts"):
        super().__init__(points, K, poses0, quats0, problem, opt_cfg,
                         plan_cfg, valid)
        self.mesh = mesh
        self.wps_axis, self.pts_axis = wps_axis, pts_axis
        self._d_wps = mesh.shape[wps_axis]
        self._d_pts = mesh.shape[pts_axis]
        self._plan_sh = NamedSharding(mesh, P(pts_axis, wps_axis))
        rep = replicated(mesh)
        ps = NamedSharding(mesh, P(pts_axis, None))
        ps_1d = NamedSharding(mesh, P(pts_axis))
        # commit the static inputs to their step shardings once
        self.points = jax.device_put(self.points, ps)
        self.valid = jax.device_put(
            jnp.ones((len(self.points_np),), jnp.float32)
            if self.valid is None else self.valid, ps_1d)
        self.K = jax.device_put(self.K, rep)
        self.poses0 = jax.device_put(self.poses0, rep)
        self.quats0 = jax.device_put(self.quats0, rep)

    def _build(self, params):
        poses_sel, quats_sel = self._selected(
            {k: np.asarray(v) for k, v in params.items()})
        plan, meta = build_frozen_sharded_plan(
            self.points_np, self.valid_np, poses_sel, quats_sel,
            self.K_np, self.problem, self.plan_cfg,
            d_wps=self._d_wps, d_pts=self._d_pts,
            min_tiles=self._t_floor, min_t_big=self._tb_floor)
        self._t_floor = max(self._t_floor, meta.tiles)
        self._tb_floor = max(self._tb_floor, meta.t_big)
        return plan, meta

    def _put_plan(self, plan_np):
        return jax.device_put(
            {k: v for k, v in plan_np.items() if not k.startswith("_")},
            self._plan_sh)

    def _dummy_plan_arrays(self, meta: PlanMeta):
        # sharded plans carry a leading (d_pts,) shard axis and drop the
        # single-chip sparse-criterion arrays (see build_frozen_sharded_plan)
        skip = {"combine_fwd", "combine_bwd", "seg_head", "n_q"}
        return {k: jnp.zeros((self._d_pts,) + v.shape, v.dtype)
                for k, v in super()._dummy_plan_arrays(meta).items()
                if k not in skip}

    def _get_step(self, meta: PlanMeta):
        if meta not in self._step_cache:
            self._step_cache[meta] = make_frozen_sharded_traj_step(
                self.mesh, self.problem, self.opt_cfg, meta,
                wps_axis=self.wps_axis, pts_axis=self.pts_axis)
        return self._step_cache[meta]
