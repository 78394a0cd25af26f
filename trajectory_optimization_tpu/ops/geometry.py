"""SE(3) transforms, pinhole projection, and differentiable visibility masks.

This is the batched rewrite of the reference visibility kernels
(`src/model.py:13-57` — get_dist_mask / get_fov_mask / to_camera_frame — and
`src/tools.py:176-187` — get_cam_frustum_pts). The reference applies a
quaternion rotation per point and loops over waypoints in Python
(`src/model.py:217`); here the whole (W waypoints × N points) evaluation is a
pair of batched (N,3)x(3,3) matmuls (world→camera, then camera→pixel via Kᵀ)
plus fused elementwise math, with waypoints as a leading batch axis. XLA
fuses the mask chain into the matmul epilogue; no per-point Python exists.

Semantics are numerically matched to the reference, including its quirks:
  * the smooth distance mask measures ‖p − c·𝟙‖ — the norm of the point minus
    the *scalar* mid-range broadcast over all three camera-frame coordinates —
    not z-depth (`src/model.py:20-23`);
  * the smooth FOV mask divides pixel coordinates by (z + eps) and normalizes
    the Gaussians by the full image width/height (`src/model.py:42-46`);
  * the binary frustum test requires pixels strictly inside a 1-px border
    (`src/tools.py:183-185`).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from trajectory_optimization_tpu.ops import quat as quat_ops
from trajectory_optimization_tpu.ops.numerics import safe_norm


def to_camera_frame(
    points: jnp.ndarray, quats: jnp.ndarray, trans: jnp.ndarray
) -> jnp.ndarray:
    """Transform world points into one or many camera frames.

    cam = R(q)⁻¹ · (p − t), with q unit-normalized first (reference
    `src/model.py:50-57`). Batched: ``quats`` (..., 4) and ``trans`` (..., 3)
    share leading axes; the result is (..., N, 3). The rotation is applied as
    a single (N,3)@(3,3) matmul per camera.

    Args:
      points: (N, 3) world points.
      quats: (4,) or (W, 4) wxyz quaternions (world←camera orientation).
      trans: (3,) or (W, 3) camera positions in world frame.
    """
    single = quats.ndim == 1
    q = jnp.atleast_2d(quats)
    t = jnp.atleast_2d(trans)
    R = quat_ops.to_matrix(quat_ops.normalize(q))  # (W, 3, 3), R @ v rotates cam→world
    # R⁻¹ x = Rᵀ x  ⇒  cam = (p − t) @ R. Full-f32 precision: a GPU would
    # otherwise round the 3-wide contraction through TF32, breaking
    # numerical parity with the reference; the matmul is tiny so this is free.
    cam = (
        jnp.einsum("nj,wjk->wnk", points, R, precision="highest")
        - jnp.einsum("wj,wjk->wk", t, R, precision="highest")[:, None, :]
    )
    return cam[0] if single else cam


def dist_mask(
    cam_points: jnp.ndarray,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    *,
    binary: bool = False,
) -> jnp.ndarray:
    """Soft (or hard) mask of points within [min_dist, max_dist] of the camera.

    Smooth: Gaussian of ‖p − c·𝟙‖ with c=(min+max)/2, σ=(max−min)/2 — the
    reference's exact (quirky) formula, norm over all coordinates minus the
    scalar center (`src/model.py:20-23`). Binary: z-depth range test, the
    variant the reference uses for hard frustum culling
    (`src/tools.py:178`).

    Args:
      cam_points: (..., N, 3) points in camera frame.
    Returns:
      (..., N) mask.
    """
    if binary:
        z = cam_points[..., 2]
        return jnp.logical_and(z > min_dist, z < max_dist)
    center = (min_dist + max_dist) / 2.0
    std = (max_dist - min_dist) / 2.0
    # safe_norm: a point sitting exactly at the scalar center would give the
    # 2-norm's NaN gradient at 0 (torch defines the subgradient as 0 there).
    d = safe_norm(cam_points - center, axis=-1)
    return jnp.exp(-0.5 * jnp.square(d / std))


def project(cam_points: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """Pinhole projection: homogeneous pixel coordinates (u·z, v·z, z).

    One matmul with Kᵀ — (..., N, 3) @ (3, 3). Full-f32 precision for parity
    (see :func:`to_camera_frame`).
    """
    return jnp.matmul(cam_points, K.T, precision="highest")


def fov_mask(
    cam_points: jnp.ndarray,
    K: jnp.ndarray,
    img_width: float,
    img_height: float,
    *,
    eps: float = 1e-6,
    binary: bool = False,
) -> jnp.ndarray:
    """Differentiable (or exact) frustum-membership mask.

    Smooth (`src/model.py:40-46`):
        sigmoid(z) · exp(−½((u/(z+eps) − W/2)/W)²) · exp(−½((v/(z+eps) − H/2)/H)²)
    Binary (`src/model.py:34-39`): z > 0 and pixel strictly inside a 1-px
    border.

    Args:
      cam_points: (..., N, 3) camera-frame points.
      K: (3, 3) intrinsics.
    Returns:
      (..., N) mask (float for smooth, bool for binary).
    """
    ph = project(cam_points, K)
    u, v, z = ph[..., 0], ph[..., 1], ph[..., 2]
    if binary:
        uz = u / z
        vz = v / z
        return (
            (z > 0)
            & (uz > 1)
            & (uz < img_width - 1)
            & (vz > 1)
            & (vz < img_height - 1)
        )
    depth = jax.nn.sigmoid(z)
    # Gradient safety, value-preserving:
    #  * a point on the plane z = −eps makes u/(z+eps) = ±inf (forward value
    #    exp(−inf) = 0 is fine, but the backward 0·inf = NaN); bound the
    #    denominator away from 0 keeping its sign;
    #  * clamp the Gaussian argument at ±20 — exp(−200) underflows to exactly
    #    0.0f anyway, so values are unchanged while gradients stay finite.
    zd = z + eps
    zd = jnp.where(zd >= 0, jnp.maximum(zd, 1e-12), jnp.minimum(zd, -1e-12))
    xu = jnp.clip((u / zd - img_width / 2.0) / img_width, -20.0, 20.0)
    xv = jnp.clip((v / zd - img_height / 2.0) / img_height, -20.0, 20.0)
    wg = jnp.exp(-0.5 * jnp.square(xu))
    hg = jnp.exp(-0.5 * jnp.square(xv))
    return depth * wg * hg


def visibility(
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
    """Fused smooth visibility score: dist_mask · fov_mask per camera pose.

    The flagship batched kernel: for W poses and N points this is two batched
    small matmuls plus fused elementwise — the whole of the reference's
    per-waypoint Python loop body (`src/model.py:219-223`) for all waypoints
    at once.

    Args:
      points: (N, 3) world points.
      quats: (4,) or (W, 4); trans: (3,) or (W, 3).
    Returns:
      (N,) or (W, N) visibility scores in [0, 1].
    """
    cam = to_camera_frame(points, quats, trans)
    dm = dist_mask(cam, min_dist, max_dist)
    fm = fov_mask(cam, K, img_width, img_height, eps=eps)
    return dm * fm


def frustum_cull(
    cam_points: jnp.ndarray,
    K: jnp.ndarray,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 10.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Hard frustum mask (reference `src/tools.py:176-187`).

    Returns (combined_mask, dist_mask, fov_mask), all (..., N) bool. Unlike
    the reference, which gathers a ragged subset, we return the mask —
    fixed-shape, jit-friendly; callers compact on host if they need a dense
    subset (see :func:`compact_masked`).
    """
    dm = dist_mask(cam_points, min_dist, max_dist, binary=True)
    fm = fov_mask(cam_points, K, img_width, img_height, binary=True)
    return jnp.logical_and(dm, fm), dm, fm


def compact_masked(points, mask):
    """Host-side helper: gather the masked subset as a dense (M, 3) array.

    Not jittable (data-dependent shape) — for bus/visualization paths only,
    mirroring where the reference gathers (`src/tools.py:186`).
    """
    import numpy as np

    pts = np.asarray(points)
    m = np.asarray(mask).astype(bool)
    return pts[m]
