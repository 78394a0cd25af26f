"""Sharded training step and explicit-collective visibility evaluation.

Two complementary paths:

1. :func:`make_sharded_train_step` — the production path. One jitted
   grad+Adam update with sharding annotations on the inputs; GSPMD
   propagates the shardings through the batched visibility evaluation and
   inserts the collectives (all-reduce for the per-waypoint min/max and
   the mean-reward sum, collective-permute for the trajectory regularizers).
   This replaces what the reference cannot do at all: jointly optimizing
   against clouds larger than one device's memory (SURVEY.md §2c).

2. :func:`shardmap_visibility` — an explicit shard_map implementation of the
   per-waypoint observation log-odds with hand-placed ``lax.pmin/pmax/psum``.
   Used to validate the GSPMD path numerically.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from trajectory_optimization_tpu.models.traj import (
    TrajProblem,
    logodds_from_minmax,
    traj_forward,
)
from trajectory_optimization_tpu.opt.engine import OptimizerConfig, make_optimizer
from trajectory_optimization_tpu.ops.scores import waypoint_scores
from trajectory_optimization_tpu.parallel.mesh import points_sharding, replicated


def shard_points(mesh: Mesh, points, valid=None):
    """Place an (N, 3) cloud (and optional (N,) mask) on the mesh, sharded
    along the point axis. N must divide by the 'pts' axis size (pad first —
    utils.data.pad_points buckets to multiples of 1024)."""
    ps = points_sharding(mesh)
    points = jax.device_put(jnp.asarray(points), ps)
    if valid is None:
        return points
    return points, jax.device_put(jnp.asarray(valid), ps)


def make_sharded_train_step(
    mesh: Mesh,
    problem: TrajProblem,
    cfg: OptimizerConfig,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for a fully sharded trajectory training step.

    Shardings: points/valid/rewards along 'pts'; params, optimizer state and
    the initial path replicated (waypoint counts are tiny — tens — so
    replicating them and sharding the million-point cloud is the right
    bandwidth trade; the (W, N) visibility intermediate is sharded along
    'pts' by propagation).

    step_fn(params, opt_state, points, valid, K, poses0, quats0)
      -> (params, opt_state, loss, scalar_aux)
    """
    tx = make_optimizer(cfg)
    rep = replicated(mesh)
    ps = points_sharding(mesh)

    def loss_fn(params, points, valid, K, poses0, quats0):
        return traj_forward(params, points, K, poses0, quats0, problem, valid=valid)

    def init_fn(params):
        return jax.device_put(tx.init(params), rep)

    @partial(
        jax.jit,
        donate_argnums=(0, 1),
        in_shardings=(rep, rep, ps, ps, rep, rep, rep),
        out_shardings=(rep, rep, rep, rep),
    )
    def step_fn(params, opt_state, points, valid, K, poses0, quats0):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, points, valid, K, poses0, quats0
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        scalars = {k: v for k, v in aux.items() if v.ndim == 0}
        return params, opt_state, loss, scalars

    return init_fn, step_fn


def shardmap_visibility(
    mesh: Mesh,
    points: jnp.ndarray,
    valid: jnp.ndarray,
    quats: jnp.ndarray,
    poses: jnp.ndarray,
    K: jnp.ndarray,
    problem: TrajProblem,
) -> jnp.ndarray:
    """Per-point trajectory rewards with explicit collectives.

    Each device holds an N/D slice of the cloud; the per-waypoint score
    normalization needs the *global* min/max over points, which here are
    explicit ``lax.pmin``/``lax.pmax`` over the 'pts' mesh axis.
    Returns the (N,) rewards, sharded along 'pts'.

    Numerically identical to the single-device models.traj path (tested on
    the virtual CPU mesh).
    """
    sel = slice(None, None, problem.wps_step)
    quats_sel, poses_sel = quats[sel], poses[sel]

    def local(points_l, valid_l):
        p = waypoint_scores(
            points_l,
            quats_sel,
            poses_sel,
            K,
            problem.img_width,
            problem.img_height,
            min_dist=problem.min_dist,
            max_dist=problem.max_dist,
            eps=problem.eps,
        )  # (W_sel, n_loc)
        big = jnp.asarray(jnp.finfo(p.dtype).max, p.dtype)
        pmin_l = jnp.min(jnp.where(valid_l > 0, p, big), axis=-1)
        pmax_l = jnp.max(jnp.where(valid_l > 0, p, -big), axis=-1)
        pmin = jax.lax.pmin(pmin_l, "pts")[:, None]  # all-reduce(min)
        pmax = jax.lax.pmax(pmax_l, "pts")[:, None]
        lo = logodds_from_minmax(p, pmin, pmax, problem.eps)
        return 1.0 / (1.0 + jnp.exp(-jnp.sum(lo, axis=0)))

    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("pts"), P("pts")),
        out_specs=P("pts"),
    )
    return f(points, valid)
