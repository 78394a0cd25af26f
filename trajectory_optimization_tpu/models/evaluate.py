"""Trajectory Evaluation: visibility scoring of a FIXED camera trajectory.

The reference README's "Trajectory Evaluation" demo (`README.md:73-80`,
`demos/cam_traj_eval.gif`): "A camera trajectory could be evaluated by a
number of observed voxels (points in the cloud). Single pose visibility
estimation rewards are combined using log odds representation as it is done
in OctoMap." The reference has no dedicated evaluation entry point — it runs
ModelTraj's forward pass and inspects `rewards` (`src/model.py:200-242`);
this module makes that a first-class, gradient-free surface.

Evaluation is exactly one forward of the trajectory model (with or without
the per-waypoint soft-HPR occlusion of ``TrajProblem.soft_hpr``), plus the
observed-point census: with the
reference's [0.5, 1−eps] observation clip, a point NO waypoint sees
accumulates zero log-odds and lands at fused probability exactly σ(0) = 0.5,
so "observed" is the strict test reward > 0.5. "Voxels" in the README are
the points of the (already voxel-downsampled) input cloud — feed
``ops.voxel.voxel_downsample`` output to evaluate on a literal voxel grid.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from trajectory_optimization_tpu.models.traj import TrajProblem, traj_forward
from trajectory_optimization_tpu.ops.trajectory import (
    mean_segment_angle,
    polyline_length,
)


@dataclasses.dataclass
class TrajEvalResult:
    """Host-side evaluation summary of one trajectory against one cloud."""

    rewards: np.ndarray  # (N,) fused per-point observation probability
    n_observed: int  # points with reward > 0.5 (the README's voxel count)
    frac_observed: float  # n_observed / n_real_points
    mean_reward: float  # mean fused probability over real points
    length: float  # polyline length of the trajectory
    mean_angle: float  # mean inter-segment angle (higher = straighter)
    loss_vis: float  # 1/(mean_reward + eps) — the optimizer's visibility term
    loss_smooth: float  # smoothness term at the problem's weight


@partial(jax.jit, static_argnums=(4,))
def _evaluate_device(points, poses, quats, K, problem: TrajProblem, valid):
    params = {"poses": poses, "quats": quats}
    # poses0/quats0 = the evaluated path itself: anchor and length terms
    # vanish and the aux carries the pure visibility/smoothness numbers
    _, aux = traj_forward(params, points, K, poses, quats, problem, valid=valid)
    rewards = aux["rewards"]
    observed = rewards > 0.5
    if valid is not None:
        observed = jnp.logical_and(observed, valid > 0)
        n_real = jnp.maximum(jnp.sum(valid), 1.0)
    else:
        n_real = float(points.shape[0])
    n_observed = jnp.sum(observed)
    # mean_segment_angle reports pi (straight by definition) for <3-waypoint
    # paths, so aux['loss_smooth'] from traj_criterion is already well
    # defined at every W — one convention, defined in ops/trajectory.py
    mean_angle = mean_segment_angle(poses, problem.eps)
    loss_smooth = aux["loss_smooth"]
    return {
        "rewards": rewards,
        "n_observed": n_observed,
        "frac_observed": n_observed / n_real,
        "mean_reward": aux["mean_reward"],
        "length": polyline_length(poses),
        "mean_angle": mean_angle,
        "loss_vis": aux["loss_vis"],
        "loss_smooth": loss_smooth,
    }


def evaluate_trajectory(
    points,
    poses,
    quats,
    K,
    problem: TrajProblem,
    *,
    valid: Optional[jnp.ndarray] = None,
) -> TrajEvalResult:
    """Score a fixed (W, 3)/(W, 4 wxyz) trajectory against an (N, 3) cloud.

    One jitted forward (compile cached per (problem, shapes)) and ONE
    batched device→host fetch. ``problem.wps_step`` selects the evaluated
    waypoints exactly as optimization would; pass a padded cloud + ``valid``
    in serving paths to reuse shape buckets.
    """
    out = _evaluate_device(
        jnp.asarray(points, jnp.float32),
        jnp.asarray(poses, jnp.float32),
        jnp.asarray(quats, jnp.float32),
        jnp.asarray(K, jnp.float32),
        problem,
        None if valid is None else jnp.asarray(valid),
    )
    f = jax.device_get(out)
    return TrajEvalResult(
        rewards=np.asarray(f["rewards"]),
        n_observed=int(f["n_observed"]),
        frac_observed=float(f["frac_observed"]),
        mean_reward=float(f["mean_reward"]),
        length=float(f["length"]),
        mean_angle=float(f["mean_angle"]),
        loss_vis=float(f["loss_vis"]),
        loss_smooth=float(f["loss_smooth"]),
    )
