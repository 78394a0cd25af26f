"""trajectory_optimization_tpu — perception-aware trajectory optimization in JAX.

A from-scratch JAX/XLA framework with the capabilities of
ctu-vras/trajectory_optimization (IEEE RA-L 2022, DOI 10.1109/LRA.2022.3147332):
optimize a camera pose or a trajectory of waypoint poses to maximize the number
of point-cloud points visible in the camera frustum, by gradient descent through
a differentiable visibility model.

Architecture (batched and compiled, not a port):
  - ``ops``      — geometry/visibility kernels: quaternions, SE(3), smooth &
                   binary frustum masks, hidden-point removal, point-splat
                   rendering, voxelization. Batched over waypoints/cameras and
                   expressed as matmuls + fused elementwise ops.
  - ``models``   — pose & trajectory visibility models (pure functions of a
                   parameter pytree; waypoints are a vmapped batch axis, not a
                   Python loop).
  - ``opt``      — jitted Adam/optax optimization engine with per-group LRs,
                   exponential decay, and on-device early stopping.
  - ``parallel`` — jax.sharding Mesh / shard_map scale-out over the point axis
                   (collectives for global reductions), vmapped multi-camera.
  - ``bus``      — host-side scene bus replacing ROS: typed messages, topics,
                   approximate-time pairing, frame graph, replay feeders.
  - ``utils``    — configs, intrinsics, data loading/padding, profiling.
  - ``native``   — C++ helpers (exact convex-hull HPR oracle, voxel filter)
                   loaded via ctypes with pure-NumPy fallback.
"""

__version__ = "0.1.0"

from trajectory_optimization_tpu.utils.intrinsics import CameraIntrinsics, default_intrinsics


def __getattr__(name):
    # lazy re-exports so `import trajectory_optimization_tpu` stays light
    if name in ("TrajectoryOptimizer", "PoseOptimizer", "TrajResult", "PoseResult"):
        from trajectory_optimization_tpu import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CameraIntrinsics",
    "default_intrinsics",
    "TrajectoryOptimizer",
    "PoseOptimizer",
    "__version__",
]
