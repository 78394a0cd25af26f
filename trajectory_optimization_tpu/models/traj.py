"""Trajectory visibility optimization model.

Counterpart of the reference ``ModelTraj`` (`src/model.py:158-260`).
The reference evaluates visibility waypoint-by-waypoint in a sequential Python
loop (its own TODO asks for batching, `src/model.py:210`); here the selected
waypoints are a leading batch axis of one fused evaluation — two batched
matmuls + elementwise — and the log-odds fusion is a sum over that axis. A
(W_sel, N) intermediate never needs to live past the fused computation; for
huge clouds wrap ``traj_forward`` in ``jax.checkpoint`` or shard the point
axis (see ``parallel``).

Semantics matched to the reference, in order (`src/model.py:200-260`):
  1. waypoint subsampling by stride ⌊vis_wps_dist / mean Δwp of the *initial*
     path⌋ + 1 (static — poses0 never changes during optimization);
  2. per-waypoint observation probability = dist·fov mask, min-max normalized
     to (0,1) over the cloud, clipped to [0.5, 1−eps];
  3. log-odds accumulation over waypoints; rewards = σ(Σ log-odds);
  4. loss = 1/(mean rewards + eps) + ‖p₀ − p₀⁰‖ (anchor on the FIRST waypoint
     only) + w_s/(mean angle + eps) + w_l·|len − len⁰|.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from trajectory_optimization_tpu.ops.numerics import safe_norm
from trajectory_optimization_tpu.ops.scores import waypoint_scores
from trajectory_optimization_tpu.ops.trajectory import mean_segment_angle, polyline_length


Params = Dict[str, jnp.ndarray]


@dataclasses.dataclass(frozen=True)
class TrajProblem:
    """Static (hashable) problem description for trajectory optimization."""

    img_width: float
    img_height: float
    min_dist: float = 1.0
    max_dist: float = 5.0
    smoothness_weight: float = 14.0
    length_weight: float = 0.02
    eps: float = 1e-6
    wps_step: int = 1  # evaluate visibility at every wps_step-th waypoint
    # Differentiable Katz occlusion inside the loss, recomputed per selected
    # waypoint on that waypoint's camera-frame points — the trajectory-wide
    # generalization of the pose model's soft HPR (the reference has NO
    # occlusion in ModelTraj at all; its TODO `src/tools.py:61-62` wanted a
    # differentiable HPR even for the single pose). Clouds over 32k points
    # use the direction-binned O(N·cap) relaxation per waypoint.
    soft_hpr: bool = False
    # Largest cloud the dense O(N²) soft HPR serves before routing to the
    # binned O(N·cap) kernel. Lower it to force the binned kernel (e.g. to
    # match the always-binned multi-chip step); raise it only with HBM to
    # spare (the dense form materializes N²/block pair tiles).
    soft_hpr_dense_max: int = 32768
    # Binned-kernel knobs (ops.hpr.hpr_mask_soft_binned cap/safety): cap is
    # the per-bin coverer budget AND the tile edge — the per-step cost is
    # ~(n_bins + N/cap)·cap² pair ops per waypoint, so smaller caps are
    # cheaper when typical bin occupancy is well under cap (the 40k
    # reference cloud holds ~400 pts/bin; cap=512 keeps grad parity 4e-7
    # against 1024; the frozen-plan engine packs bins so cap just sets its
    # tile edge). Fidelity vs cap is measured in the soft-HPR operating
    # curve (PARITY.md).
    hpr_cap: int = 512
    hpr_safety: float = 3.0


def waypoint_stride(poses0: np.ndarray, vis_wps_dist: float = 0.5) -> int:
    """Stride between visibility waypoints, from the initial path's mean
    inter-waypoint distance (reference `src/model.py:213-215`). Static: the
    reference recomputes it every forward from frozen poses0, so hoisting it
    to setup time is exact.
    """
    poses0 = np.asarray(poses0)
    if len(poses0) < 2:  # single-waypoint path: nothing to stride over
        return 1
    mean_d = float(np.mean(np.linalg.norm(poses0[1:] - poses0[:-1], axis=-1)))
    if not np.isfinite(mean_d) or mean_d <= 0.0:
        return 1  # coincident waypoints (stationary robot): use every one
    return int(vis_wps_dist / mean_d) + 1


def init_traj_params(poses0, quats0) -> Params:
    """Parameter pytree from initial (W,3) positions + (W,4) wxyz quats."""
    return {
        "poses": jnp.asarray(poses0, dtype=jnp.float32),
        "quats": jnp.asarray(quats0, dtype=jnp.float32),
    }


def _masked_minmax(p: jnp.ndarray, valid: Optional[jnp.ndarray]):
    """Per-waypoint min/max of (W, N) scores over real points only."""
    if valid is None:
        return jnp.min(p, axis=-1, keepdims=True), jnp.max(p, axis=-1, keepdims=True)
    big = jnp.asarray(jnp.finfo(p.dtype).max, p.dtype)
    pmin = jnp.min(jnp.where(valid > 0, p, big), axis=-1, keepdims=True)
    pmax = jnp.max(jnp.where(valid > 0, p, -big), axis=-1, keepdims=True)
    return pmin, pmax


def observation_logodds(
    p: jnp.ndarray,
    eps: float,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """(W, N) raw visibility scores → (W, N) per-waypoint log-odds.

    Min-max normalize each waypoint's scores over the cloud, clip to
    [0.5, 1−eps], convert to log-odds (reference `src/model.py:225-230`).
    Padded points land on the clip floor 0.5 ⇒ log-odds 0 ⇒ no contribution.
    """
    pmin, pmax = _masked_minmax(p, valid)
    return logodds_from_minmax(p, pmin, pmax, eps)


def logodds_from_minmax(p, pmin, pmax, eps: float) -> jnp.ndarray:
    """The normalize → clip → log-odds tail with the min/max precomputed.

    Shared by :func:`observation_logodds` (per-waypoint masked min/max) and
    the multi-chip trajectory step (parallel.traj_sharded, where the min/max
    is an all_gather+min/max over the point shards) so the numerics — span
    floor, clip window, log-odds formula — cannot de-sync.
    """
    # reference: p -= p.min(); p /= p.max()  ⇒  (p − min)/(max − min).
    # Floor the span at 1e-8: a waypoint that sees nothing has an underflowed
    # score span, and the division backward needs 1/span² to stay inside f32
    # range (span ≥ 1e-8 ⇒ 1/span² ≤ 1e16). With the floor, a blind
    # waypoint's normalized scores collapse below the 0.5 clip ⇒ log-odds 0 ⇒
    # it contributes nothing — the correct limit. Healthy waypoints have
    # span = O(1) and are bit-identical to the reference formula.
    span = jnp.maximum(pmax - pmin, 1e-8)
    p = (p - pmin) / span
    p = jnp.clip(p, 0.5, 1.0 - eps)
    return jnp.log(p / (1.0 - p))


def gated_waypoint_scores(
    quat: jnp.ndarray,
    pose: jnp.ndarray,
    points: jnp.ndarray,
    K: jnp.ndarray,
    problem,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """One waypoint's occlusion-gated raw visibility scores: (N,) hpr × p.

    The shared per-waypoint gate pipeline — world→camera planes, smooth
    visibility scores, differentiable Katz HPR on the waypoint's
    camera-frame cloud (binned kernel above ``problem.soft_hpr_dense_max``
    points) — used by the trajectory loss (`soft_hpr_wp_logodds` below) and
    the per-waypoint X/Y/yaw refinement (`models.wps_opt.wps_forward`).
    ``problem`` is duck-typed: any object with img_width/img_height/
    min_dist/max_dist/eps/soft_hpr_dense_max (TrajProblem, WpsOptProblem).
    The waypoint-sharded multi-chip step (parallel.traj_sharded._build_local)
    mirrors this sequence with the point-sharded HPR — keep in sync.
    Reverse-mode only when the binned kernel is selected — its custom-VJP
    sorts have no JVP rule.
    """
    from trajectory_optimization_tpu.ops.hpr import (
        hpr_mask_soft,
        hpr_mask_soft_binned,
    )
    from trajectory_optimization_tpu.ops.scores import (
        camera_planes,
        scores_from_planes,
    )

    cxp, cyp, czp = camera_planes(points, quat[None], pose[None])
    p = scores_from_planes(
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
        hpr = hpr_mask_soft_binned(
            cam, valid=valid,
            cap=getattr(problem, "hpr_cap", 1024),
            safety=getattr(problem, "hpr_safety", 3.0))
    else:
        hpr = hpr_mask_soft(cam, valid=valid)
    return hpr * p


@partial(jax.checkpoint, static_argnums=(4,))
def soft_hpr_wp_logodds(
    quat: jnp.ndarray,
    pose: jnp.ndarray,
    points: jnp.ndarray,
    K: jnp.ndarray,
    problem: TrajProblem,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """One waypoint's occlusion-gated (N,) log-odds: visibility score ×
    differentiable Katz HPR on the waypoint's camera-frame cloud, min-max
    normalized and clipped.

    The per-waypoint body of the occlusion-aware trajectory loss, scanned
    over selected waypoints by ``traj_forward(soft_hpr=True)``. The gate
    pipeline itself lives in ``gated_waypoint_scores`` (shared with
    models.wps_opt and mirrored by parallel.traj_sharded._build_local).
    Checkpointed: the backward rematerializes the HPR instead of saving its
    internals (O(N) live memory for the whole scan). One world→camera
    transform feeds both the visibility score and the HPR input.
    """
    gated = gated_waypoint_scores(quat, pose, points, K, problem, valid)
    lo = observation_logodds(gated[None], problem.eps, valid)
    return lo[0]


def traj_forward(
    params: Params,
    points: jnp.ndarray,
    K: jnp.ndarray,
    poses0: jnp.ndarray,
    quats0: jnp.ndarray,
    problem: TrajProblem,
    *,
    valid: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Composite trajectory loss + per-point rewards.

    Args:
      params: {'poses': (W,3), 'quats': (W,4) wxyz}.
      points: (N, 3) world points (padded entries allowed).
      K: (3, 3) intrinsics.
      poses0/quats0: frozen initial trajectory (anchor/length targets).
      valid: optional (N,) 0/1 mask of real points.

    Returns:
      (loss, aux); aux = {'rewards': (N,), 'loss_vis', 'loss_l2',
      'loss_smooth', 'loss_length', 'mean_reward'}.
    """
    poses, quats = params["poses"], params["quats"]
    sel = slice(None, None, problem.wps_step)

    if problem.soft_hpr:
        # Occlusion-aware trajectory visibility: every selected waypoint gets
        # its own differentiable HPR gate on ITS camera-frame cloud, applied
        # to the raw scores before normalization — occluded points collapse
        # below the 0.5 clip and contribute no log-odds, exactly like the
        # pose model's soft_hpr branch. A lax.scan over waypoints keeps the
        # live set at O(N) (never a (W, N·cap) residual); the per-waypoint
        # body is checkpointed so the backward rematerializes each HPR
        # instead of saving its internals.
        def scan_body(acc, qp):
            quat, pose = qp
            return acc + soft_hpr_wp_logodds(
                quat, pose, points, K, problem, valid), None

        lo_sum, _ = jax.lax.scan(
            scan_body,
            jnp.zeros(points.shape[0], jnp.float32),
            (quats[sel], poses[sel]),
        )
    else:
        # jax.checkpoint: the (W, N) score/log-odds intermediates would
        # otherwise be saved as autodiff residuals (~10 × W·N·4 bytes of
        # HBM traffic on the backward pass); rematerializing them costs one
        # cheap fused forward recompute.
        @jax.checkpoint
        def lo_sum_fn(quats_sel, poses_sel):
            p = waypoint_scores(
                points,
                quats_sel,
                poses_sel,
                K,
                problem.img_width,
                problem.img_height,
                min_dist=problem.min_dist,
                max_dist=problem.max_dist,
                eps=problem.eps,
            )  # (W_sel, N)
            lo = observation_logodds(p, problem.eps, valid)
            return jnp.sum(lo, axis=0)  # (N,) — order-independent log-odds fusion

        lo_sum = lo_sum_fn(quats[sel], poses[sel])
    return traj_criterion(lo_sum, params, poses0, problem, valid=valid)


def traj_criterion(
    lo_sum: jnp.ndarray,
    params: Params,
    poses0: jnp.ndarray,
    problem: TrajProblem,
    *,
    valid: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Composite loss from the (N,) accumulated log-odds.

    The tail of the reference criterion (`src/model.py:237,244-260`): rewards
    = σ(Σ log-odds), then visibility + first-waypoint anchor + smoothness +
    length terms. Split out so the sharded steps share it with
    traj_forward.
    """
    rewards = 1.0 / (1.0 + jnp.exp(-lo_sum))  # σ(Σ log-odds), `src/model.py:237`

    # --- loss terms (reference `src/model.py:244-260`) ---------------------
    if valid is None:
        mean_reward = jnp.mean(rewards)
    else:
        mean_reward = jnp.sum(rewards * valid) / jnp.maximum(jnp.sum(valid), 1.0)
    loss, aux = traj_criterion_from_mean(mean_reward, params, poses0, problem)
    aux["rewards"] = rewards
    return loss, aux


def traj_criterion_from_mean(
    mean_reward: jnp.ndarray,
    params: Params,
    poses0: jnp.ndarray,
    problem: TrajProblem,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """The criterion tail given the mean reward directly — for paths that
    never materialize the (N,) rewards vector (the frozen engine's sparse
    training step computes the mean from query rows + the closed-form
    σ(0)=0.5 contribution of every untouched point). aux carries the
    scalar terms only (no 'rewards')."""
    poses = params["poses"]
    loss_vis = 1.0 / (mean_reward + problem.eps)
    loss_l2 = safe_norm(poses[0] - poses0[0])  # zero subgradient at init (torch parity)
    loss_smooth = problem.smoothness_weight / (
        mean_segment_angle(poses, problem.eps) + problem.eps
    )
    loss_length = problem.length_weight * jnp.abs(
        polyline_length(poses) - polyline_length(poses0)
    )
    loss = loss_vis + loss_l2 + loss_length + loss_smooth
    aux = {
        "mean_reward": mean_reward,
        "loss_vis": loss_vis,
        "loss_l2": loss_l2,
        "loss_smooth": loss_smooth,
        "loss_length": loss_length,
    }
    return loss, aux
