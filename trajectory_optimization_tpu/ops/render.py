"""Point-splat renderer: z-nearest perspective splatting in pure XLA.

Replaces the reference's pytorch3d Pulsar renderer (`src/tools.py:122-173`):
camera-frame points are splatted as discs of world radius 0.03 m with
1 point per pixel (z-nearest wins), znear/zfar clipping, white background,
and RGB = min-max-normalized xyz — the same visual contract, without the
CUDA dependency.

Algorithm (two scatter passes, fixed shapes, jittable):
  1. project each point, compute its pixel-space radius r·f/z, and
     scatter-min its depth into a z-buffer over a static footprint window;
  2. re-walk the footprint and write the color of every point whose depth
     equals the z-buffer entry (ties are benign — same depth, one color
     wins deterministically per XLA scatter ordering).

This is a visualization path, not the optimization hot loop. The footprint is capped at ``max_radius_px`` to bound work.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@partial(
    jax.jit,
    static_argnames=("img_width", "img_height", "max_radius_px"),
)
def render_point_cloud(
    cam_points: jnp.ndarray,
    K: jnp.ndarray,
    img_height: int,
    img_width: int,
    *,
    colors: Optional[jnp.ndarray] = None,
    point_radius: float = 0.03,
    znear: float = 1.0,
    zfar: float = 10.0,
    bg_color: float = 1.0,
    max_radius_px: int = 4,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Render camera-frame points to an (H, W, 3) image.

    Args:
      cam_points: (N, 3) points in camera frame (+z forward).
      K: (3, 3) intrinsics.
      colors: optional (N, 3); defaults to min-max-normalized xyz, the
        reference's scheme (`src/tools.py:137-138`).
      point_radius: world-space splat radius (reference: 0.03).
      znear/zfar: depth clip (reference: the pc_clip_limits).
      bg_color: background intensity (reference: white).
      max_radius_px: cap on the per-point pixel footprint radius.
      valid: optional (N,) mask of real points.
    """
    H, W = int(img_height), int(img_width)
    x, y, z = cam_points[:, 0], cam_points[:, 1], cam_points[:, 2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    if colors is None:
        if valid is not None:  # padding rows must not skew the normalization
            vm = (valid > 0)[:, None]
            lo = jnp.min(jnp.where(vm, cam_points, jnp.inf))
            hi = jnp.max(jnp.where(vm, cam_points, -jnp.inf))
        else:
            lo, hi = jnp.min(cam_points), jnp.max(cam_points)
        colors = (cam_points - lo) / jnp.maximum(hi - lo, 1e-12)

    zs = jnp.maximum(z, 1e-6)
    u = fx * x / zs + cx
    v = fy * y / zs + cy
    r_px = point_radius * fx / zs  # pixel-space splat radius

    ok = (z > znear) & (z < zfar)
    ok = ok & (u > -r_px) & (u < W + r_px) & (v > -r_px) & (v < H + r_px)
    if valid is not None:
        ok = ok & (valid > 0)

    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    big = jnp.asarray(jnp.finfo(jnp.float32).max, jnp.float32)

    zbuf = jnp.full((H * W,), big, jnp.float32)
    r_eff = jnp.minimum(r_px, float(max_radius_px))

    # pass 1: depth into the z-buffer over each point's disc footprint
    for dy in range(-max_radius_px, max_radius_px + 1):
        for dx in range(-max_radius_px, max_radius_px + 1):
            rr = float(dy * dy + dx * dx)
            yy = vi + dy
            xx = ui + dx
            inside = (
                ok
                & (rr <= jnp.square(jnp.maximum(r_eff, 0.5)))  # ≥1 px per point
                & (yy >= 0)
                & (yy < H)
                & (xx >= 0)
                & (xx < W)
            )
            flat = jnp.where(inside, yy * W + xx, 0)
            zval = jnp.where(inside, z, big)
            zbuf = zbuf.at[flat].min(zval, mode="drop")

    # pass 2: colors of the winning (nearest) points
    img = jnp.full((H * W, 3), bg_color, jnp.float32)
    for dy in range(-max_radius_px, max_radius_px + 1):
        for dx in range(-max_radius_px, max_radius_px + 1):
            rr = float(dy * dy + dx * dx)
            yy = vi + dy
            xx = ui + dx
            inside = (
                ok
                & (rr <= jnp.square(jnp.maximum(r_eff, 0.5)))
                & (yy >= 0)
                & (yy < H)
                & (xx >= 0)
                & (xx < W)
            )
            flat = jnp.where(inside, yy * W + xx, 0)
            win = inside & (z <= zbuf[flat])
            img = img.at[jnp.where(win, flat, H * W)].set(colors, mode="drop")

    return img.reshape(H, W, 3)


def normalized_xyz_colors(points: jnp.ndarray) -> jnp.ndarray:
    """The reference's point coloring: global min-max-normalized coordinates."""
    lo = jnp.min(points)
    hi = jnp.max(points)
    return (points - lo) / jnp.maximum(hi - lo, 1e-12)


def denormalize_image(img, eps: float = 1e-6):
    """Percentile contrast-stretch to [0,1] for display (reference
    `src/tools.py:190-196`)."""
    import numpy as np

    x = np.asarray(img)
    x_max = np.percentile(x, 98)
    x_min = np.percentile(x, 2)
    x = (x - x_min) / max(x_max - x_min, eps)
    return x.clip(0, 1)
