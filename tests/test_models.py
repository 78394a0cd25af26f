import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajectory_optimization_tpu.models.pose import PoseProblem, init_pose_params, pose_forward
from trajectory_optimization_tpu.models.traj import (
    TrajProblem,
    init_traj_params,
    traj_forward,
    waypoint_stride,
)
from trajectory_optimization_tpu.utils.data import identity_quaternions, pad_points
from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

import oracles

INTR = default_intrinsics()


def test_pose_loss_matches_oracle(cloud10):
    pts = cloud10[:5000]
    q0 = np.array([[0.9, 0.1, -0.2, 0.3]], dtype=np.float32)
    t0 = np.array([[6.0, 2.0, 0.0]], dtype=np.float32)
    params = init_pose_params(t0, q0)
    prob = PoseProblem(img_width=INTR.width, img_height=INTR.height)
    loss, aux = pose_forward(params, jnp.asarray(pts), INTR.matrix(), prob)
    want_loss, want_obs = oracles.pose_loss(
        pts.astype(np.float64), q0[0], t0[0], INTR.matrix_np(np.float64), INTR.width, INTR.height
    )
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(aux["observations"]), want_obs, atol=1e-4)


def test_pose_loss_padding_invariant(cloud10):
    pts = cloud10[:3000]
    q0 = np.array([[1.0, 0.0, 0.0, 0.0]], dtype=np.float32)
    t0 = np.array([[5.0, 5.0, 0.0]], dtype=np.float32)
    params = init_pose_params(t0, q0)
    prob = PoseProblem(img_width=INTR.width, img_height=INTR.height)
    loss_plain, _ = pose_forward(params, jnp.asarray(pts), INTR.matrix(), prob)
    padded, valid = pad_points(pts, 4096)
    loss_pad, _ = pose_forward(
        params, jnp.asarray(padded), INTR.matrix(), prob, valid=jnp.asarray(valid)
    )
    np.testing.assert_allclose(float(loss_plain), float(loss_pad), rtol=1e-5)


def test_waypoint_stride_matches_reference_formula(path10):
    # cloud-10 path has dense waypoints => stride > 1 with the 0.5 m default
    mean_d = np.mean(np.linalg.norm(np.diff(path10, axis=0), axis=1))
    assert waypoint_stride(path10, 0.5) == int(0.5 / mean_d) + 1
    # degenerate paths from real replays (review finding, reproduced):
    # single waypoint -> int(NaN) crash; coincident waypoints -> div by zero
    assert waypoint_stride(np.zeros((1, 3))) == 1
    assert waypoint_stride(np.zeros((5, 3))) == 1


def test_traj_loss_matches_oracle(cloud10, path10):
    pts = cloud10[:4000]
    quats = identity_quaternions(len(path10))
    step = waypoint_stride(path10, 0.5)
    params = init_traj_params(path10, quats)
    prob = TrajProblem(img_width=INTR.width, img_height=INTR.height, wps_step=step)
    loss, aux = traj_forward(
        params, jnp.asarray(pts), INTR.matrix(), jnp.asarray(path10), jnp.asarray(quats), prob
    )
    want_loss, want_terms, want_rewards = oracles.traj_loss(
        pts.astype(np.float64),
        path10.astype(np.float64),
        quats.astype(np.float64),
        path10.astype(np.float64),
        INTR.matrix_np(np.float64),
        INTR.width,
        INTR.height,
        wps_step=step,
    )
    np.testing.assert_allclose(float(aux["loss_vis"]), want_terms["vis"], rtol=1e-3)
    np.testing.assert_allclose(float(aux["loss_l2"]), want_terms["l2"], atol=1e-5)
    np.testing.assert_allclose(float(aux["loss_smooth"]), want_terms["smooth"], rtol=1e-3)
    np.testing.assert_allclose(float(aux["loss_length"]), want_terms["length"], atol=1e-3)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-3)
    # Per-point rewards: near the 1−eps clip ceiling log-odds are extremely
    # sensitive to f32 vs f64 rounding (SURVEY.md §7), so allow a tiny tail
    # of near-saturated points to deviate; the bulk must match tightly.
    diff = np.abs(np.asarray(aux["rewards"]) - want_rewards)
    assert (diff < 1e-3).mean() > 0.995, f"bulk mismatch: {(diff >= 1e-3).sum()} points"
    assert diff.max() < 0.5


def test_traj_loss_padding_invariant(cloud10, path10):
    pts = cloud10[:3000]
    quats = identity_quaternions(len(path10))
    params = init_traj_params(path10, quats)
    prob = TrajProblem(img_width=INTR.width, img_height=INTR.height, wps_step=2)
    loss_plain, aux_plain = traj_forward(
        params, jnp.asarray(pts), INTR.matrix(), jnp.asarray(path10), jnp.asarray(quats), prob
    )
    padded, valid = pad_points(pts, 4096)
    loss_pad, aux_pad = traj_forward(
        params,
        jnp.asarray(padded),
        INTR.matrix(),
        jnp.asarray(path10),
        jnp.asarray(quats),
        prob,
        valid=jnp.asarray(valid),
    )
    np.testing.assert_allclose(float(loss_plain), float(loss_pad), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(aux_plain["rewards"]), np.asarray(aux_pad["rewards"])[:3000], atol=1e-5
    )


def test_traj_gradients_finite(cloud10, path10):
    pts = jnp.asarray(cloud10[:2000])
    quats = identity_quaternions(len(path10))
    params = init_traj_params(path10, quats)
    prob = TrajProblem(img_width=INTR.width, img_height=INTR.height, wps_step=2)

    def loss_fn(p):
        return traj_forward(
            p, pts, INTR.matrix(), jnp.asarray(path10), jnp.asarray(quats), prob
        )

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    for k, g in grads.items():
        assert np.all(np.isfinite(np.asarray(g))), f"non-finite grad in {k}"
    assert np.linalg.norm(np.asarray(grads["poses"])) > 0


def test_traj_forward_jits_and_is_deterministic(cloud10, path10):
    pts = jnp.asarray(cloud10[:2000])
    quats = jnp.asarray(identity_quaternions(len(path10)))
    params = init_traj_params(path10, quats)
    prob = TrajProblem(img_width=INTR.width, img_height=INTR.height, wps_step=2)
    f = jax.jit(traj_forward, static_argnames=("problem",))
    l1, _ = f(params, pts, INTR.matrix(), jnp.asarray(path10), quats, problem=prob)
    l2, _ = f(params, pts, INTR.matrix(), jnp.asarray(path10), quats, problem=prob)
    assert float(l1) == float(l2)


# ---------------------------------------------------------------------------
# Occlusion-aware trajectory optimization (TrajProblem.soft_hpr) — the
# trajectory-wide generalization of the pose model's differentiable HPR.
# The reference's ModelTraj has NO occlusion handling at all; its TODO
# (`src/tools.py:61-62`) asked for a differentiable HPR.
# ---------------------------------------------------------------------------


def _two_walls_world():
    """Near wall (z=3) fully occluding the center of a far wall (z=7),
    camera path near the origin looking +z."""
    def plane(n, z, half, seed):
        rng = np.random.default_rng(seed)
        a = np.linspace(-half, half, n, dtype=np.float32)
        g1, g2 = np.meshgrid(a, a)
        pts = np.stack([g1.ravel(), g2.ravel(), np.full(n * n, z, np.float32)], 1)
        return pts + rng.normal(scale=0.01, size=pts.shape).astype(np.float32)

    near = plane(50, 3.0, 3.0, 0)
    far = plane(50, 7.0, 2.5, 1)  # strictly inside the near wall's shadow
    return near, far


def test_traj_soft_hpr_suppresses_occluded_points():
    near, far = _two_walls_world()
    pts = jnp.asarray(np.vstack([near, far]))
    poses0 = np.array([[0.0, 0.0, -0.2], [0.05, 0.0, 0.0]], np.float32)
    quats0 = identity_quaternions(2)
    params = init_traj_params(poses0, quats0)
    kw = dict(img_width=INTR.width, img_height=INTR.height,
              min_dist=1.0, max_dist=12.0)
    prob_plain = TrajProblem(**kw)
    prob_hpr = TrajProblem(**kw, soft_hpr=True)
    K = INTR.matrix()

    _, aux_plain = traj_forward(params, pts, K, poses0, quats0, prob_plain)
    _, aux_hpr = traj_forward(params, pts, K, poses0, quats0, prob_hpr)

    n_near = len(near)
    r_plain = np.asarray(aux_plain["rewards"])
    r_hpr = np.asarray(aux_hpr["rewards"])
    # without occlusion the hidden far wall is (wrongly) rewarded — its
    # points sit near the distance-mask peak so some score top of the cloud
    seen_far = r_plain[n_near:] > 0.9
    assert seen_far.mean() > 0.03, seen_far.mean()
    # with soft HPR every one of those collapses to the no-information 0.5
    assert r_hpr[n_near:][seen_far].max() < 0.505, r_hpr[n_near:][seen_far].max()
    assert r_hpr[n_near:].mean() < 0.51, r_hpr[n_near:].mean()
    # and the visible near wall GAINS reward (normalization is no longer
    # dominated by the occluded wall at the distance-mask peak)
    assert r_hpr[:n_near].mean() > r_plain[:n_near].mean() + 0.05


def test_traj_soft_hpr_gradients_and_optimizes():
    import optax

    near, far = _two_walls_world()
    pts = jnp.asarray(np.vstack([near[::3], far[::3]]))
    poses0 = np.array(
        [[0.0, -0.5, -0.4], [0.1, -0.4, -0.2], [0.2, -0.5, 0.0]], np.float32)
    quats0 = jnp.asarray(identity_quaternions(3))
    params = init_traj_params(poses0, quats0)
    prob = TrajProblem(img_width=INTR.width, img_height=INTR.height,
                       min_dist=1.0, max_dist=12.0, soft_hpr=True)
    prob_plain = dataclasses.replace(prob, soft_hpr=False)
    K = INTR.matrix()

    def loss_fn(p, problem=prob):
        return traj_forward(p, pts, K, jnp.asarray(poses0), quats0, problem)

    (l0, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    for k, g in grads.items():
        assert np.all(np.isfinite(np.asarray(g))), k
    # occlusion changes the trajectory gradient
    g_plain = jax.grad(
        lambda p: loss_fn(p, prob_plain)[0], allow_int=False)(params)
    assert not np.allclose(np.asarray(grads["poses"]),
                           np.asarray(g_plain["poses"]), atol=1e-6)

    f = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p)[0]))
    tx = optax.adam(0.02)
    st = tx.init(params)
    p = params
    for _ in range(12):
        _, g = f(p)
        u, st = tx.update(g, st, p)
        p = optax.apply_updates(p, u)
    l1, _ = loss_fn(p)
    assert float(l1) < float(l0), (float(l0), float(l1))


def test_traj_soft_hpr_binned_route_forward():
    """>32k points route through the binned kernel per waypoint; the far
    hemisphere of a shell stays unrewarded."""
    rng = np.random.default_rng(4)
    d = rng.normal(size=(33000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = jnp.asarray(d * 2.0 + np.array([0.0, 0.0, 8.0], np.float32))
    poses0 = np.array([[0.0, 0.0, 0.0], [0.0, 0.05, 0.0]], np.float32)
    quats0 = identity_quaternions(2)
    params = init_traj_params(poses0, quats0)
    prob = TrajProblem(img_width=INTR.width, img_height=INTR.height,
                       min_dist=1.0, max_dist=15.0, soft_hpr=True)
    _, aux = traj_forward(params, pts, INTR.matrix(), poses0, quats0, prob)
    r = np.asarray(aux["rewards"])
    near = d[:, 2] < -0.35  # hemisphere facing the camera
    far = d[:, 2] > 0.35
    assert r[near].mean() > 0.6, r[near].mean()
    assert r[far].mean() < 0.55, r[far].mean()
