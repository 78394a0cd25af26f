"""Waypoints Optimization: per-waypoint X/Y/yaw camera-pose refinement.

The reference README's "Waypoints Optimization" demo (`README.md:66-71`,
`demos/cam_wps_opt.gif`): "Camera pose (X, Y and Yaw) optimization is
consequently applied here for each separate sampled way-point of an initial
trajectory" — i.e. the single-pose visibility objective (`src/model.py:65-127`)
run once per waypoint, with the pose restricted to planar translation plus a
rotation about the world vertical (the robot stays on its path plane and
only re-aims the camera).

Batched design: the reference applies the pose optimizations
*consequently* (a Python loop of independent single-pose problems). The
problems share no parameters and no loss terms, and Adam's update is
elementwise per parameter — so optimizing all W waypoints in ONE batched
program, waypoints as a leading vmapped axis with the loss summed over
waypoints, produces exactly the per-waypoint optima the sequential loop
would, W× fewer dispatches. The summed loss's gradient w.r.t. waypoint w's
parameters equals the gradient of waypoint w's own loss (the other terms are
constant in them), and the two-group Adam engine (opt.engine) treats every
(x, y) and yaw entry independently.

Yaw parameterization: a yaw angle is the ONE rotation DOF, applied about the
world z axis on top of the waypoint's frozen base orientation —
``q_w = qz(yaw_w) ⊗ q0_w`` — so gradients steer a single well-conditioned
scalar per waypoint instead of fighting the quaternion-normalization
null direction. Roll/pitch and the z coordinate stay frozen at their
initial-path values, matching the demo's "X, Y and Yaw" restriction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from trajectory_optimization_tpu.ops import quat as quat_ops
from trajectory_optimization_tpu.ops.scores import waypoint_scores

Params = Dict[str, jnp.ndarray]


@dataclasses.dataclass(frozen=True)
class WpsOptProblem:
    """Static problem description for per-waypoint X/Y/yaw pose refinement.

    The visibility knobs mirror PoseProblem (`models/pose.py`); ``soft_hpr``
    gates each waypoint's scores with the differentiable Katz HPR on that
    waypoint's camera-frame cloud (binned kernel above
    ``soft_hpr_dense_max`` points, like the pose/trajectory models).
    """

    img_width: float
    img_height: float
    min_dist: float = 1.0
    max_dist: float = 5.0
    eps: float = 1e-6
    soft_hpr: bool = False
    soft_hpr_dense_max: int = 32768
    # binned-kernel knobs, as TrajProblem (gated_waypoint_scores reads them)
    hpr_cap: int = 1024
    hpr_safety: float = 3.0


def init_wps_params(poses0, quats0) -> Tuple[Params, Dict[str, jnp.ndarray]]:
    """Split an initial path into optimizable and frozen parts.

    Args:
      poses0: (W, 3) initial waypoint positions.
      quats0: (W, 4) initial wxyz orientations.

    Returns:
      (params, frozen): params = {'xy': (W, 2), 'yaw': (W,)} — yaw starts at
      0 (an *offset* from the base orientation, so arbitrary initial quats
      are supported); frozen = {'z': (W,), 'quats0': (W, 4)}.
    """
    poses0 = jnp.asarray(poses0, jnp.float32).reshape(-1, 3)
    quats0 = jnp.asarray(quats0, jnp.float32).reshape(-1, 4)
    params = {
        "xy": poses0[:, :2],
        "yaw": jnp.zeros((poses0.shape[0],), jnp.float32),
    }
    frozen = {"z": poses0[:, 2], "quats0": quats0}
    return params, frozen


def wps_path(params: Params, frozen: Dict[str, jnp.ndarray]):
    """Assemble the full (W, 3) positions + (W, 4) wxyz quats from the
    optimizable X/Y/yaw and the frozen z / base orientations — what callers
    publish as the refined path."""
    trans = jnp.concatenate([params["xy"], frozen["z"][:, None]], axis=-1)
    yaw = params["yaw"]
    half = 0.5 * yaw
    qz = jnp.stack(
        [jnp.cos(half), jnp.zeros_like(half), jnp.zeros_like(half), jnp.sin(half)],
        axis=-1,
    )  # rotation about world z, wxyz
    quats = quat_ops.multiply(qz, frozen["quats0"])
    return trans, quats


def wps_forward(
    params: Params,
    frozen: Dict[str, jnp.ndarray],
    points: jnp.ndarray,
    K: jnp.ndarray,
    problem: WpsOptProblem,
    *,
    valid: Optional[jnp.ndarray] = None,
    occlusion_mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Summed per-waypoint single-pose visibility loss.

    Returns (loss, aux): loss = Σ_w 1/(Σ_n mask_wn + eps) (each term is the
    reference ModelPose criterion, `src/model.py:124-127`); aux carries
    'losses' (W,) per-waypoint losses, 'observations' (W, N) scores, and
    'mean_reward' (mean over waypoints of each waypoint's summed
    observations — the scalar the engine's EarlyStop can watch).
    """
    trans, quats = wps_path(params, frozen)

    if problem.soft_hpr:
        from trajectory_optimization_tpu.models.traj import gated_waypoint_scores

        # scan over waypoints (not vmap): each HPR holds O(N·cap) live
        # state, and the checkpointed scan keeps the whole-loss residuals
        # O(N) — same structure as models.traj's occlusion-aware path
        @jax.checkpoint
        def wp_mask(quat, pose):
            return gated_waypoint_scores(quat, pose, points, K, problem, valid)

        def body(_, qp):
            quat, pose = qp
            return None, wp_mask(quat, pose)

        _, mask = jax.lax.scan(body, None, (quats, trans))  # (W, N)
    else:
        mask = waypoint_scores(
            points, quats, trans, K,
            problem.img_width, problem.img_height,
            min_dist=problem.min_dist, max_dist=problem.max_dist,
            eps=problem.eps,
        )  # (W, N)

    if occlusion_mask is not None:
        mask = mask * occlusion_mask[None, :]
    if valid is not None:
        mask = mask * valid[None, :]

    per_wp_obs = jnp.sum(mask, axis=-1)  # (W,)
    losses = 1.0 / (per_wp_obs + problem.eps)
    loss = jnp.sum(losses)
    aux = {
        "losses": losses,
        "observations": mask,
        "mean_reward": jnp.mean(per_wp_obs),
    }
    return loss, aux


def optimize_waypoints(
    points,
    poses0,
    quats0,
    K,
    problem: WpsOptProblem,
    *,
    n_steps: int = 100,
    lr_xy: float = 0.02,
    lr_yaw: float = 0.02,
    valid: Optional[jnp.ndarray] = None,
    occlusion_mask: Optional[jnp.ndarray] = None,
):
    """One-call waypoint refinement: returns (poses, quats, aux).

    Runs the batched X/Y/yaw optimization with the standard two-group Adam
    engine (lr_xy on positions, lr_yaw on headings — the pose node's
    lr_pose/lr_quat split, `src/pose_optimization.py:93-96`) for a fixed
    ``n_steps`` and reassembles the refined (W, 3)/(W, 4) path. aux is the
    final forward's aux dict plus 'losses0', the initial per-waypoint
    losses, so callers can report per-waypoint visibility gains.

    ONE-SHOT convenience API: it jits fresh per-call closures, so every
    call recompiles the whole optimization program even at identical
    shapes. Never wire it into a per-message serving loop — route through
    the cached runners (opt/runners.py) instead, the same recompile trap
    the node paths already avoid (0.04 → 5.7 msgs/s in round 2).
    """
    from trajectory_optimization_tpu.opt.engine import (
        EarlyStop,
        OptimizerConfig,
        optimize,
    )

    points = jnp.asarray(points, jnp.float32)
    K = jnp.asarray(K, jnp.float32)
    params, frozen = init_wps_params(poses0, quats0)

    def loss_fn(p):
        return wps_forward(
            p, frozen, points, K, problem,
            valid=valid, occlusion_mask=occlusion_mask,
        )

    jit_loss = jax.jit(loss_fn)  # one wrapper: trace/compile the forward once
    _, aux0 = jit_loss(params)
    cfg = OptimizerConfig(lr_pose=lr_xy, lr_quat=lr_yaw)
    # fixed-length run; the engine's gain tracker needs aux keys, so point
    # both at mean_reward (thresholds are inf — never triggers)
    stop = EarlyStop(rewards_th=float("inf"), smoothness_th=float("inf"),
                     reward_key="mean_reward", smooth_key="mean_reward")
    params, _, _ = optimize(
        loss_fn, params, cfg, n_steps, early_stop=stop,
        pose_key="xy", quat_key="yaw",
    )
    trans, quats = wps_path(params, frozen)
    _, aux = jit_loss(params)
    aux = dict(aux)
    aux["losses0"] = aux0["losses"]
    return trans, quats, aux
