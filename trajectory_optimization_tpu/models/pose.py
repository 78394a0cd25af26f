"""Single-pose visibility optimization model.

Counterpart of the reference ``ModelPose``
(`src/model.py:65-127`): a pure function of a parameter pytree
{'trans': (1,3), 'quat': (1,4)} instead of an nn.Module, so it composes with
jax.grad / jit / vmap / shard_map. The forward pass is the fused visibility
kernel; the loss is 1/(Σ observations + eps).

Occlusion gating (the reference's ``hpr=True`` branch, `src/model.py:112-115`)
takes a precomputed per-point occlusion mask. The reference recomputes exact
Katz HPR on *detached, world-frame* points every optimization step — a
constant! — so computing it once at problem setup (ops.hpr) is semantically
identical and removes a host Qhull round-trip from the hot loop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax.numpy as jnp

from trajectory_optimization_tpu.ops.scores import waypoint_scores


Params = Dict[str, jnp.ndarray]


@dataclasses.dataclass(frozen=True)
class PoseProblem:
    """Static (hashable) problem description for a single-pose optimization.

    ``soft_hpr=True`` enables differentiable Katz occlusion *inside* the
    loss, recomputed per step on the camera-frame points — the capability the
    reference's TODO asked for (`src/tools.py:61-62`; its HPR is a detached
    CPU Qhull call, and — bug — evaluated in the world frame). Clouds over
    32k points route through the direction-binned O(N·cap) relaxation
    (ops.hpr.hpr_mask_soft_binned, tested to 1M points); the
    dense O(N²) form serves small clouds. ``occlusion_mask`` remains for
    clouds where a static world-frame gate suffices.
    """

    img_width: float
    img_height: float
    min_dist: float = 1.0
    max_dist: float = 5.0
    eps: float = 1e-6
    soft_hpr: bool = False
    # largest cloud the dense O(N²) soft HPR serves before routing to the
    # binned O(N·cap) kernel (see TrajProblem.soft_hpr_dense_max)
    soft_hpr_dense_max: int = 32768
    # binned-kernel knobs (see TrajProblem.hpr_cap)
    hpr_cap: int = 1024
    hpr_safety: float = 3.0


def init_pose_params(trans0, quat0) -> Params:
    """Parameter pytree from initial (1,3) translation and (1,4) wxyz quat."""
    trans0 = jnp.asarray(trans0, dtype=jnp.float32).reshape(1, 3)
    quat0 = jnp.asarray(quat0, dtype=jnp.float32).reshape(1, 4)
    return {"trans": trans0, "quat": quat0}


def pose_forward(
    params: Params,
    points: jnp.ndarray,
    K: jnp.ndarray,
    problem: PoseProblem,
    *,
    valid: Optional[jnp.ndarray] = None,
    occlusion_mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Loss and observations for one camera pose.

    Args:
      params: {'trans': (1,3), 'quat': (1,4) wxyz}.
      points: (N, 3) world points (padded entries allowed).
      K: (3, 3) intrinsics.
      valid: optional (N,) 0/1 mask of real (non-padding) points.
      occlusion_mask: optional (N,) visibility gate from HPR.

    Returns:
      (loss, aux) with aux['observations'] the (N,) per-point scores —
      what the reference publishes as the rewards-cloud intensity channel
      (`src/pose_optimization.py:109-112`).
    """
    if problem.soft_hpr:
        # differentiable occlusion in the CAMERA frame, inside the loss —
        # one world→camera transform feeds both the score and the HPR input
        from trajectory_optimization_tpu.ops.hpr import (
            hpr_mask_soft,
            hpr_mask_soft_binned,
        )
        from trajectory_optimization_tpu.ops.scores import (
            camera_planes,
            scores_from_planes,
        )

        cxp, cyp, czp = camera_planes(points, params["quat"], params["trans"])
        mask = scores_from_planes(
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
        cam = jnp.stack([cxp[0], cyp[0], czp[0]], axis=-1)
        if points.shape[0] > problem.soft_hpr_dense_max:
            # direction-binned O(N·cap) relaxation: same formula, scales to
            # the 1M north star (dense O(N²) tops out ~50k; see ops.hpr)
            hpr = hpr_mask_soft_binned(
                cam, valid=valid, cap=problem.hpr_cap,
                safety=problem.hpr_safety)
        else:
            hpr = hpr_mask_soft(cam, valid=valid)
        mask = hpr * mask
    else:
        mask = waypoint_scores(
            points,
            params["quat"],
            params["trans"],
            K,
            problem.img_width,
            problem.img_height,
            min_dist=problem.min_dist,
            max_dist=problem.max_dist,
            eps=problem.eps,
        )[0]  # fused SoA scorer with a single-waypoint batch
    if occlusion_mask is not None:
        mask = occlusion_mask * mask
    if valid is not None:
        mask = mask * valid
    loss = 1.0 / (jnp.sum(mask) + problem.eps)
    return loss, {"observations": mask}
