"""High-level facade: one-call pose / trajectory optimization.

The reference's user-facing surface is "construct ModelPose/ModelTraj, build
an Adam, loop" (`src/pose_optimization.py:82-97`). This facade wraps the
functional core with production conveniences the reference lacks:

  * automatic padding + shape bucketing (one XLA compile per bucket, cached
    across calls — no per-message recompilation);
  * optional device mesh for clouds larger than one chip;
  * warm-starting from a previous solution and checkpointing;
  * structured results (optimized path, per-point rewards, gain metrics).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from trajectory_optimization_tpu.models.pose import PoseProblem, init_pose_params
from trajectory_optimization_tpu.models.traj import (
    TrajProblem,
    init_traj_params,
    waypoint_stride,
)
from trajectory_optimization_tpu.opt.engine import EarlyStop, OptimizerConfig
from trajectory_optimization_tpu.utils.data import identity_quaternions, pad_points
from trajectory_optimization_tpu.utils.intrinsics import CameraIntrinsics, default_intrinsics


@dataclasses.dataclass
class TrajResult:
    poses: np.ndarray  # (W, 3) optimized waypoint positions
    quats_wxyz: np.ndarray  # (W, 4) optimized (normalized) orientations
    rewards: np.ndarray  # (N,) per-point observation probability
    n_iters: int
    loss: float
    visibility_gain: float
    smoothness_gain: float


@dataclasses.dataclass
class PoseResult:
    position: np.ndarray  # (3,)
    quat_wxyz: np.ndarray  # (4,) normalized
    observations: np.ndarray  # (N,)
    n_iters: int
    loss: float


class TrajectoryOptimizer:
    """Reusable trajectory optimizer with compile caching across calls."""

    def __init__(
        self,
        intrinsics: Optional[CameraIntrinsics] = None,
        *,
        min_dist: float = 1.0,
        max_dist: float = 5.0,
        smoothness_weight: float = 14.0,
        length_weight: float = 0.02,
        lr_pose: float = 0.1,
        lr_quat: float = 0.0,
        vis_wps_dist: float = 0.5,
        soft_hpr: bool = False,
    ):
        self.intr = intrinsics or default_intrinsics()
        self.min_dist, self.max_dist = min_dist, max_dist
        self.smoothness_weight, self.length_weight = smoothness_weight, length_weight
        self.opt_cfg = OptimizerConfig(lr_pose=lr_pose, lr_quat=lr_quat)
        self.vis_wps_dist = vis_wps_dist
        # per-waypoint differentiable occlusion inside the loss (models.traj)
        self.soft_hpr = soft_hpr

    def optimize(
        self,
        points: np.ndarray,
        path: np.ndarray,
        quats_wxyz: Optional[np.ndarray] = None,
        *,
        n_steps: int = 400,
        early_stop: Optional[EarlyStop] = None,
        warm_start: Optional[Dict] = None,
    ) -> TrajResult:
        """Optimize a (W, 3) path against an (N, 3) cloud."""
        points = np.asarray(points, np.float32)
        path = np.asarray(path, np.float32)
        if quats_wxyz is None:
            quats_wxyz = identity_quaternions(len(path))
        padded, valid = pad_points(points)

        problem = self._traj_problem(path)
        P, V, K = jnp.asarray(padded), jnp.asarray(valid), self.intr.matrix()
        p0, q0 = jnp.asarray(path), jnp.asarray(quats_wxyz)

        # cached runner: one compile per (problem, config, shape bucket)
        from trajectory_optimization_tpu.opt.runners import traj_runner

        stop = early_stop or EarlyStop(rewards_th=float("inf"), smoothness_th=float("inf"))
        run = traj_runner(problem, self.opt_cfg, stop, int(n_steps))
        params = warm_start or init_traj_params(path, quats_wxyz)
        params, n_iters, loss, aux = run(params, P, V, K, p0, q0)
        # ONE batched device→host fetch for the eight values this result needs
        f = jax.device_get(
            {
                "poses": params["poses"], "quats": params["quats"],
                "n_iters": n_iters, "loss": loss, "rewards": aux["rewards"],
                "mean_reward": aux["mean_reward"], "reward0": aux["reward0"],
                "loss_smooth": aux["loss_smooth"], "smooth0": aux["smooth0"],
            }
        )

        quats = np.asarray(f["quats"], np.float64)
        quats = quats / np.linalg.norm(quats, axis=1, keepdims=True)
        return TrajResult(
            poses=np.asarray(f["poses"], np.float64),
            quats_wxyz=quats,
            rewards=np.asarray(f["rewards"])[: len(points)],
            n_iters=int(f["n_iters"]),
            loss=float(f["loss"]),
            visibility_gain=float(f["mean_reward"]) / max(float(f["reward0"]), 1e-9),
            smoothness_gain=float(f["smooth0"]) / max(float(f["loss_smooth"]), 1e-9),
        )


    def _traj_problem(self, path, wps_step=None) -> TrajProblem:
        """The ONE place the facade builds its TrajProblem — optimize and
        evaluate must construct identical problems (same compile-cache
        buckets, same knobs). ``wps_step`` overrides the stride computed
        from ``path`` (pass the initial path's stride when evaluating an
        optimized path so before/after censuses select the same number of
        waypoints)."""
        return TrajProblem(
            img_width=self.intr.width,
            img_height=self.intr.height,
            min_dist=self.min_dist,
            max_dist=self.max_dist,
            smoothness_weight=self.smoothness_weight,
            length_weight=self.length_weight,
            wps_step=int(wps_step) if wps_step is not None
            else waypoint_stride(path, self.vis_wps_dist),
            soft_hpr=self.soft_hpr,
        )

    def evaluate(self, points, path, quats_wxyz=None, *, wps_step=None):
        """Score a FIXED path — the reference README's "Trajectory
        Evaluation" mode (`README.md:73-80`): one gradient-free jitted
        forward returning the observed-voxel census + fused rewards
        (models.evaluate.TrajEvalResult). Same padding/bucketing as
        ``optimize``, so alternating evaluate/optimize calls share
        compile-cache buckets. When comparing an optimized path against
        its initial one, pass the initial path's ``wps_step``
        (models.traj.waypoint_stride) to both calls — otherwise the stride
        recomputed from each path can select different waypoint subsets
        and the censuses aren't commensurable."""
        from trajectory_optimization_tpu.models.evaluate import evaluate_trajectory

        points = np.asarray(points, np.float32)
        path = np.asarray(path, np.float32)
        if quats_wxyz is None:
            quats_wxyz = identity_quaternions(len(path))
        padded, valid = pad_points(points)
        problem = self._traj_problem(path, wps_step)
        res = evaluate_trajectory(
            padded, path, np.asarray(quats_wxyz, np.float32),
            self.intr.matrix(), problem, valid=valid,
        )
        res.rewards = res.rewards[: len(points)]
        return res


class PoseOptimizer:
    """Reusable single-pose optimizer with compile caching across calls."""

    def __init__(
        self,
        intrinsics: Optional[CameraIntrinsics] = None,
        *,
        min_dist: float = 1.0,
        max_dist: float = 5.0,
        lr_pose: float = 0.1,
        lr_quat: float = 0.0,
        use_hpr: bool = False,
        soft_hpr: bool = False,
    ):
        """``use_hpr`` gates the loss with a hard occlusion mask computed
        once at the initial pose (the reference's behavior). ``soft_hpr``
        instead differentiates THROUGH Katz occlusion recomputed every step
        (the reference's TODO) — clouds over 32k points use the
        direction-binned O(N·cap) relaxation, tested to 1M."""
        self.intr = intrinsics or default_intrinsics()
        self.problem_kw = dict(min_dist=min_dist, max_dist=max_dist,
                               soft_hpr=soft_hpr)
        self.opt_cfg = OptimizerConfig(lr_pose=lr_pose, lr_quat=lr_quat)
        self.use_hpr = use_hpr

    def optimize(
        self,
        points: np.ndarray,
        position: np.ndarray,
        quat_wxyz: np.ndarray = (1.0, 0.0, 0.0, 0.0),
        *,
        n_steps: int = 200,
    ) -> PoseResult:
        points = np.asarray(points, np.float32)
        padded, valid = pad_points(points)
        problem = PoseProblem(
            img_width=self.intr.width, img_height=self.intr.height, **self.problem_kw
        )
        P, V, K = jnp.asarray(padded), jnp.asarray(valid), self.intr.matrix()

        occlusion = None
        if self.use_hpr:
            from trajectory_optimization_tpu.ops.hpr import hpr_mask_approx

            # bucket-padded + valid-masked: HPR compiles per bucket size,
            # not per message size
            occlusion = hpr_mask_approx(P, valid=V)

        from trajectory_optimization_tpu.opt.runners import pose_runner

        init_opt, advance = pose_runner(problem, self.opt_cfg, int(n_steps))
        params = init_pose_params(
            np.asarray(position, np.float32)[None], np.asarray(quat_wxyz, np.float32)[None]
        )
        params, _, loss, aux = advance(params, init_opt(params), P, V, K, occlusion)
        f = jax.device_get(
            {"trans": params["trans"], "quat": params["quat"], "loss": loss,
             "observations": aux["observations"]}
        )  # one batched fetch instead of four
        q = np.asarray(f["quat"], np.float64).reshape(4)
        return PoseResult(
            position=np.asarray(f["trans"], np.float64).reshape(3),
            quat_wxyz=q / np.linalg.norm(q),
            observations=np.asarray(f["observations"])[: len(points)],
            n_iters=int(n_steps),
            loss=float(f["loss"]),
        )
