"""Batched multi-camera visibility processing.

The reference handles its six cameras *serially*, one TF lookup + transform +
cull + HPR per CameraInfo callback (`src/pc_processor.py:33-39,139-197`,
SURVEY.md §2c). Here all cameras are one batched evaluation: the camera axis
is just another leading batch dimension of the fused scorer / cull kernels,
so C cameras cost one kernel launch, and per-camera results come back
together. Used by PointsProcessorNode's batch path and available directly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from trajectory_optimization_tpu.ops.geometry import frustum_cull, to_camera_frame
from trajectory_optimization_tpu.ops.scores import waypoint_scores


def multicam_scores(
    points: jnp.ndarray,
    cam_quats: jnp.ndarray,
    cam_trans: jnp.ndarray,
    K: jnp.ndarray,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    eps: float = 1e-6,
) -> jnp.ndarray:
    """(C, N) smooth visibility scores for C cameras (shared intrinsics).

    Identical math to the per-waypoint scorer — cameras ARE waypoints to the
    kernel.
    """
    return waypoint_scores(
        points, cam_quats, cam_trans, K, img_width, img_height,
        min_dist=min_dist, max_dist=max_dist, eps=eps,
    )


def multicam_frustum_masks(
    points: jnp.ndarray,
    cam_quats: jnp.ndarray,
    cam_trans: jnp.ndarray,
    K: jnp.ndarray,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 15.0,
) -> jnp.ndarray:
    """(C, N) boolean hard-frustum masks for C cameras, one batched pass.

    The frustum semantics live in ONE place — geometry.frustum_cull (batched
    over the leading camera axis) — so the fused rig path and the serial
    per-camera path cannot diverge.
    """
    cam = to_camera_frame(points, cam_quats, cam_trans)  # (C, N, 3)
    return frustum_cull(
        cam, K, img_width, img_height, min_dist=min_dist, max_dist=max_dist
    )[0]


def combined_coverage(
    points: jnp.ndarray,
    cam_quats: jnp.ndarray,
    cam_trans: jnp.ndarray,
    K: jnp.ndarray,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    eps: float = 1e-6,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fuse per-camera observations across a rig.

    Returns (per_point_coverage (N,), per_camera_mean (C,)): coverage is the
    log-odds fusion of the per-camera smooth scores (same OctoMap-style
    update the trajectory model applies along time, applied across cameras) —
    one batched replacement for combining six serial callbacks.
    """
    s = multicam_scores(
        points, cam_quats, cam_trans, K, img_width, img_height,
        min_dist=min_dist, max_dist=max_dist, eps=eps,
    )
    p = jnp.clip(s, 0.5, 1.0 - eps)
    lo = jnp.log(p / (1.0 - p))
    coverage = 1.0 / (1.0 + jnp.exp(-jnp.sum(lo, axis=0)))
    return coverage, jnp.mean(s, axis=1)
