"""Quaternion algebra in pure JAX (wxyz convention).

Replaces the reference's dependency on pytorch3d.transforms
(`quaternion_invert` / `quaternion_apply` / `random_quaternions`, used at
reference `src/model.py:4,50-57` and `src/pose_optimization_sample.py:17,64`).
No kernel is needed — these are tiny elementwise ops; rotating a large point
set should instead go through :func:`to_matrix` + one matmul (see
ops.geometry).

All functions broadcast over leading batch axes. Quaternions are (..., 4)
arrays in (w, x, y, z) order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def normalize(q: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Unit-normalize, guarding the zero quaternion (torch F.normalize semantics:
    divide by max(norm, eps), reference `src/model.py:53`)."""
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, eps)


def conjugate(q: jnp.ndarray) -> jnp.ndarray:
    """(w, -x, -y, -z). For unit quaternions this is the inverse — the same
    assumption pytorch3d's quaternion_invert makes."""
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


invert = conjugate


def multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product a ⊗ b."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def apply(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors v (..., 3) by quaternions q (..., 4).

    Uses the expanded Rodrigues form (two cross products) — cheaper than
    q ⊗ v ⊗ q* and fully fused by XLA.
    """
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion(s) (..., 4) → rotation matrices (..., 3, 3) with
    R @ v == apply(q, v). Does NOT normalize; callers normalize first."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = jnp.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)], axis=-1)
    row1 = jnp.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)], axis=-1)
    row2 = jnp.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def from_matrix(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4), w >= 0.

    Shepperd's branch-free formulation: build all four candidate quaternions
    and select the numerically best (largest pivot) with jnp.where — no
    data-dependent control flow, so it vectorizes and jits cleanly.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    pivots = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                        1.0 - m00 - m11 + m22], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32), axis=-2)
    q = jnp.squeeze(q, axis=-2)
    q = normalize(q)
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def from_euler(roll, pitch, yaw, dtype=jnp.float32) -> jnp.ndarray:
    """Intrinsic x-y-z (roll, pitch, yaw) Euler angles → wxyz quaternion.

    Matches tf.transformations.quaternion_from_euler(r, p, y) (sxyz order),
    which the reference uses for feeder poses (`src/pose_publisher.py:25-28`)
    — except we return wxyz, not xyzw.
    """
    r, p, y = [jnp.asarray(a, dtype=dtype) * 0.5 for a in (roll, pitch, yaw)]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def random(key: jax.Array, n: int, dtype=jnp.float32) -> jnp.ndarray:
    """(n, 4) uniformly random unit quaternions (Gaussian-projection method,
    same distribution as pytorch3d.random_quaternions)."""
    q = jax.random.normal(key, (n, 4), dtype=dtype)
    q = normalize(q)
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def wxyz_to_xyzw(q: jnp.ndarray) -> jnp.ndarray:
    """Reorder (w,x,y,z) → (x,y,z,w) (bus/ROS wire order,
    reference `src/trajectory_optimization.py:97-98`)."""
    return jnp.concatenate([q[..., 1:], q[..., :1]], axis=-1)


def xyzw_to_wxyz(q: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([q[..., 3:], q[..., :3]], axis=-1)


# NumPy mirrors for host-side (bus) code ------------------------------------
# Feeders and codecs must never touch the device: the first JAX dispatch in a
# process pays the backend's start-up, which can blow the approximate-time
# pairing window between bus messages.

def from_euler_np(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """NumPy twin of :func:`from_euler` (wxyz)."""
    r, p, y = roll * 0.5, pitch * 0.5, yaw * 0.5
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ]
    )


def normalize_np(q: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    return q / np.maximum(n, eps)


def wxyz_to_xyzw_np(q: np.ndarray) -> np.ndarray:
    return np.concatenate([q[..., 1:], q[..., :1]], axis=-1)


def xyzw_to_wxyz_np(q: np.ndarray) -> np.ndarray:
    return np.concatenate([q[..., 3:], q[..., :3]], axis=-1)
