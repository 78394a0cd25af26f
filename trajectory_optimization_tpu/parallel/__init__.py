from trajectory_optimization_tpu.parallel.mesh import make_mesh, points_sharding, replicated
from trajectory_optimization_tpu.parallel.sharded import (
    make_sharded_train_step,
    shard_points,
    shardmap_visibility,
)
from trajectory_optimization_tpu.parallel.hpr_sharded import (
    hpr_mask_soft_binned_sharded,
)
from trajectory_optimization_tpu.parallel.pose_sharded import (
    make_sharded_pose_step,
    pose_loss_sharded,
)
from trajectory_optimization_tpu.parallel.traj_sharded import (
    make_sharded_traj_step,
    traj_soft_hpr_loss_sharded,
)
from trajectory_optimization_tpu.parallel.traj_frozen_sharded import (
    FrozenShardedTrajOptimizer,
    build_frozen_sharded_plan,
    make_frozen_sharded_traj_step,
    traj_frozen_loss_sharded,
)
from trajectory_optimization_tpu.parallel.wps_sharded import (
    make_sharded_wps_step,
    wps_loss_sharded,
)

__all__ = [
    "FrozenShardedTrajOptimizer",
    "build_frozen_sharded_plan",
    "make_frozen_sharded_traj_step",
    "traj_frozen_loss_sharded",
    "make_sharded_pose_step",
    "pose_loss_sharded",
    "make_sharded_traj_step",
    "traj_soft_hpr_loss_sharded",
    "make_sharded_wps_step",
    "wps_loss_sharded",
    "make_mesh",
    "points_sharding",
    "replicated",
    "make_sharded_train_step",
    "shard_points",
    "shardmap_visibility",
    "hpr_mask_soft_binned_sharded",
]
