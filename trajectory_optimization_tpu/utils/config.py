"""Config system: dataclass configs with CLI-style overrides.

Replaces the reference's rosparam knobs (`rospy.get_param` with defaults at
node start, values injected by launch-file <param> blocks — SURVEY.md §5).
Every reference tunable has a field here with the same default; overrides use
``section.key=value`` strings, the moral equivalent of a launch file's
parameter block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple


@dataclasses.dataclass
class PoseOptNodeConfig:
    """`src/pose_optimization.py:43-50` + pose_optimization.launch defaults."""

    pc_topic: str = "/pts"
    pose_topic: str = "/pose"
    opt_steps: int = 10
    lr_pose: float = 0.1
    lr_quat: float = 0.0
    min_dist: float = 1.0
    max_dist: float = 5.0
    rate: float = 0.5
    num_pub_samples: int = 20
    publish_rewards_cloud: bool = True
    use_hpr: bool = False
    # Parity+: differentiable Katz occlusion INSIDE the loss, recomputed per
    # step on camera-frame points (PoseProblem.soft_hpr) — what the
    # reference's `hpr` flag wished it could do (its TODO, src/tools.py:61).
    # Mutually compatible with use_hpr (a static world-frame pre-gate).
    use_soft_hpr: bool = False


@dataclasses.dataclass
class TrajOptNodeConfig:
    """`src/trajectory_optimization.py:42-46` + trajectory_optimization.launch."""

    pc_topic: str = "/final_cost_cloud"
    path_topic: str = "/path"
    opt_steps: int = 10
    smooth_weight: float = 14.0
    length_weight: float = 0.02
    lr_pose: float = 0.1
    lr_quat: float = 0.0
    min_dist: float = 1.0
    max_dist: float = 5.0
    vis_wps_dist: float = 0.5
    rewards_th: float = 1.2
    smoothness_th: float = 0.9
    publish_rewards_cloud: bool = False
    # Parity+: per-waypoint differentiable occlusion inside the trajectory
    # loss (TrajProblem.soft_hpr). The reference's ModelTraj has no occlusion
    # handling at all. Costs one binned-HPR fwd+bwd per selected waypoint per
    # step — use a coarser vis_wps_dist or fewer opt_steps for rate budgets.
    use_soft_hpr: bool = False
    # >1 keeps d-1 callbacks in flight (async dispatch + copy_to_host_async),
    # overlapping transfers across messages; outputs lag by up to d-1.
    # 1 = the reference's synchronous publish-before-return semantics.
    pipeline_depth: int = 1


@dataclasses.dataclass
class PointsProcessorConfig:
    """`src/pc_processor.py:30-53` + pointcloud_processor.launch."""

    pc_topic: str = "/final_cost_cloud"
    cam_info_topics: Tuple[str, ...] = ("/viz/camera_0/camera_info",)
    frustum_min_dist: float = 1.0
    frustum_max_dist: float = 15.0
    hpr_backend: str = "approx"  # 'exact' (Qhull) | 'approx' (on device) | 'none'
    render: bool = True
    # TransformListener role: the node's FrameGraph ingests these topics
    # (reference constructs a tf.TransformListener, `src/pc_processor.py:57`)
    tf_topics: Tuple[str, ...] = ("/tf", "/tf_static")


@dataclasses.dataclass
class CloudFeederConfig:
    """`src/pc_publisher.py` knobs."""

    output_topic: str = "/pts"
    rate: float = 1.0
    pc_index: int = 10  # -1 = random in [0, 30)
    data_dir: str = "data/points"
    frame_id: str = "world"


@dataclasses.dataclass
class PoseFeederConfig:
    """`src/pose_publisher.py` knobs (None → random like the reference)."""

    output_topic: str = "/pose"
    rate: float = 1.0
    x: Optional[float] = None
    y: Optional[float] = None
    z: Optional[float] = None
    roll: Optional[float] = None
    pitch: Optional[float] = None
    yaw: Optional[float] = None
    frame_id: str = "world"


@dataclasses.dataclass
class VoxelFilterConfig:
    """`launch/voxels_filtering.launch` PCL VoxelGrid knobs."""

    input_topic: str = "/local_map"
    output_topic: str = "/local_map/voxels"
    leaf_size: float = 0.15
    z_limits: Optional[Tuple[float, float]] = None


@dataclasses.dataclass
class ViewerConfig:
    """Live HTTP scene viewer (bus.viewer.ViewerNode) — the rviz role
    (`launch/pointcloud_processor.launch:20`, `config/*.rviz`) on a
    headless host. Subscribes to ``pc_topic``(+"/rewards") and
    ``path_topic``(+"/optimized"); ``port=0`` binds an ephemeral port
    (tests), ``port=None`` disables the server (render_png() only)."""

    pc_topic: str = "/pts"
    path_topic: str = "/path"
    host: str = "127.0.0.1"
    port: Optional[int] = 8123
    max_points: int = 20000
    title: str = "trajectory_optimization viewer"


def _coerce(value: str, target_type) -> Any:
    import typing

    origin = typing.get_origin(target_type)
    if origin is typing.Union:  # Optional[X] and friends
        if value.strip().lower() in ("none", "null", ""):
            return None
        args = [a for a in typing.get_args(target_type) if a is not type(None)]
        if args:
            return _coerce(value, args[0])
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if origin is tuple or target_type in (tuple, Tuple):
        # element-typed tuples: 'z_limits=-1,5' on Tuple[float, float] must
        # yield (-1.0, 5.0), not ('-1', '5')
        args = typing.get_args(target_type)
        parts = [v.strip() for v in value.split(",")]
        if args and Ellipsis not in args:
            if len(parts) != len(args):
                raise ValueError(
                    f"expected {len(args)} comma-separated values, got {value!r}"
                )
            return tuple(_coerce(p, a) for p, a in zip(parts, args))
        elem = args[0] if args else str
        return tuple(_coerce(p, elem) for p in parts)
    return value


def apply_overrides(cfg, overrides: Sequence[str], section: Optional[str] = None):
    """Apply 'key=value' (or 'section.key=value') strings to a dataclass.

    Returns a new dataclass instance; unknown keys raise.
    """
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    updates = {}
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not key=value")
        key, value = ov.split("=", 1)
        if "." in key:
            sec, key = key.split(".", 1)
            if section is not None and sec != section:
                continue
        if key not in fields:
            raise ValueError(f"unknown config key {key!r} for {type(cfg).__name__}")
        f = fields[key]
        if isinstance(f.type, type):
            base = f.type
        else:
            # `from __future__ import annotations` stringifies field types;
            # resolve them so tuple/Optional fields coerce element-wise
            import typing

            try:
                base = typing.get_type_hints(type(cfg))[key]
            except Exception:  # unresolvable forward ref — fall back on value
                base = type(getattr(cfg, key) or "")
        updates[key] = _coerce(value, base)
    return dataclasses.replace(cfg, **updates)
