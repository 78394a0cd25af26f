"""Fused waypoint visibility scorer — the hot kernel, in SoA layout.

Computes the (W, N) smooth visibility scores dist·fov for W camera poses
over N points. Numerically equivalent to composing
``to_camera_frame`` + ``dist_mask`` + ``fov_mask`` (ops.geometry), but laid
out for fused elementwise evaluation:

  * coordinates live as separate (W, N) planes — the AoS (W, N, 3) layout
    would put 3 on the minor dimension and stride every vector access;
  * the world→camera rotation is 9 broadcast FMAs per plane instead of a
    K=3 matmul (a matrix unit cannot help with a 3-deep contraction);
  * the distance Gaussian uses d²/σ² directly — no sqrt, so the r=0
    singularity of the norm gradient never exists;
  * everything fuses into a single elementwise XLA kernel per pass: N·W·~40
    flops with exactly one (W, N) output, which is the HBM-traffic lower
    bound for a materialized score matrix.

Used by models.traj for the batched evaluation and by parallel.sharded for
the per-shard local computation. Parity with the reference formulas
(`src/model.py:13-57`) is covered by tests against the float64 oracles.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from trajectory_optimization_tpu.ops import quat as quat_ops


def camera_frames(quats: jnp.ndarray, trans: jnp.ndarray):
    """(W,4),(W,3) → rotation matrices (W,3,3) and precomputed t·R (W,3)."""
    R = quat_ops.to_matrix(quat_ops.normalize(quats))
    tR = jnp.einsum("wj,wjc->wc", trans, R, precision="highest")
    return R, tR


def camera_planes(
    points: jnp.ndarray, quats: jnp.ndarray, trans: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Camera-frame coordinates of N points under W poses, as (W, N) planes.

    cam = (p − t) @ R ≡ q⁻¹ ⊗ (p − t) — numerically interchangeable with
    ``geometry.to_camera_frame`` (same rotation, matrix-form association).
    Exposed so callers that need both the visibility scores AND the
    camera-frame points (the soft-HPR losses) compute the transform once.
    """
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]  # (N,) planes
    R, tR = camera_frames(quats, trans)

    # cam = (p − t) @ R, one (W, N) plane per camera coordinate
    cx = (
        px[None, :] * R[:, 0, 0, None]
        + py[None, :] * R[:, 1, 0, None]
        + pz[None, :] * R[:, 2, 0, None]
        - tR[:, 0, None]
    )
    cy = (
        px[None, :] * R[:, 0, 1, None]
        + py[None, :] * R[:, 1, 1, None]
        + pz[None, :] * R[:, 2, 1, None]
        - tR[:, 1, None]
    )
    cz = (
        px[None, :] * R[:, 0, 2, None]
        + py[None, :] * R[:, 1, 2, None]
        + pz[None, :] * R[:, 2, 2, None]
        - tR[:, 2, None]
    )
    return cx, cy, cz


def waypoint_scores(
    points: jnp.ndarray,
    quats: jnp.ndarray,
    trans: jnp.ndarray,
    K: jnp.ndarray,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    eps: float = 1e-6,
) -> jnp.ndarray:
    """(W, N) smooth visibility scores (dist mask × FOV mask).

    Args:
      points: (N, 3) world points.
      quats: (W, 4) wxyz; trans: (W, 3).
      K: (3, 3) intrinsics (only fx, fy, cx, cy are read).
    """
    cx, cy, cz = camera_planes(points, quats, trans)
    return scores_from_planes(
        cx, cy, cz, K, img_width, img_height,
        min_dist=min_dist, max_dist=max_dist, eps=eps,
    )


def scores_from_planes(
    cx: jnp.ndarray,
    cy: jnp.ndarray,
    cz: jnp.ndarray,
    K: jnp.ndarray,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    eps: float = 1e-6,
) -> jnp.ndarray:
    """Scores from precomputed (W, N) camera-frame planes (see camera_planes)."""
    # distance mask: exp(−½ d²/σ²), d² = Σ_c (cam_c − c₀)², scalar center c₀
    c0 = (min_dist + max_dist) / 2.0
    inv_var = 1.0 / ((max_dist - min_dist) / 2.0) ** 2
    d2 = jnp.square(cx - c0) + jnp.square(cy - c0) + jnp.square(cz - c0)
    dm = jnp.exp(-0.5 * d2 * inv_var)

    # FOV mask: sigmoid(z) · Gaussians of the normalized pixel coordinates
    fx, fy = K[0, 0], K[1, 1]
    cx0, cy0 = K[0, 2], K[1, 2]
    u = fx * cx + cx0 * cz
    v = fy * cy + cy0 * cz
    zd = cz + eps
    zd = jnp.where(zd >= 0, jnp.maximum(zd, 1e-12), jnp.minimum(zd, -1e-12))
    xu = jnp.clip((u / zd - img_width / 2.0) / img_width, -20.0, 20.0)
    xv = jnp.clip((v / zd - img_height / 2.0) / img_height, -20.0, 20.0)
    fm = jax.nn.sigmoid(cz) * jnp.exp(-0.5 * (jnp.square(xu) + jnp.square(xv)))

    return dm * fm
