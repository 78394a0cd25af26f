"""Tests for the notebook-parity model variants and demo entry points."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajectory_optimization_tpu.models.distance_reward import (
    DistanceRewardProblem,
    distance_reward_forward,
    gaussian,
    init_distance_reward_params,
)
from trajectory_optimization_tpu.models.frustum_fd import (
    binary_visibility_count,
    fd_pose_loss,
    frustum_visibility_fd,
    look_at_view_transform,
)
from trajectory_optimization_tpu.utils.data import load_path, load_point_cloud
from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

INTR = default_intrinsics()


def test_look_at_camera_axes():
    # camera on +z axis looking at origin: z-axis points toward -z (to origin)
    R, T = look_at_view_transform(5.0, 0.0, 0.0)
    R, T = np.asarray(R), np.asarray(T)
    np.testing.assert_allclose(R[:, 2], [0, 0, -1], atol=1e-6)  # look dir
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-6)
    # T = -C @ R with C = (0, 0, 5)
    np.testing.assert_allclose(T, -np.array([0, 0, 5.0]) @ R, atol=1e-5)


@pytest.fixture(scope="module")
def centered_cloud(cloud10):
    # the (dist, elev, azim) camera orbits the origin; center the cloud there
    pts = cloud10[:8000]
    return jnp.asarray(pts - pts.mean(axis=0))


def test_binary_visibility_count_nonzero(centered_cloud):
    counts = [
        float(binary_visibility_count(jnp.array([10.0, e, 0.0]), centered_cloud))
        for e in (0.0, 20.0, 45.0)
    ]
    assert max(counts) > 1000
    assert all(c >= 0 and c == int(c) for c in counts)


def test_binary_visibility_count_matches_f64_oracle(centered_cloud):
    """Exact count parity vs an independent float64 pipeline: the border
    tests are strict inequalities, so this pins the precision='highest'
    matmuls (review finding — bf16 skews pixels ~4 px and flips them)."""
    import math

    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    pts64 = np.asarray(centered_cloud, np.float64)
    intr = default_intrinsics()
    for dea in ([8.0, 10.0, 60.0], [10.0, 25.0, 140.0]):
        d, e, a = dea
        er, ar = math.radians(e), math.radians(a)
        C = np.array([d * math.cos(er) * math.sin(ar), d * math.sin(er),
                      d * math.cos(er) * math.cos(ar)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= max(np.linalg.norm(x), 1e-9)
        R = np.stack([x, np.cross(z, x), z], axis=1)
        cam = (pts64 - (-C @ R)) @ R
        ph = cam @ np.asarray(intr.matrix(), np.float64).T
        u, v = ph[:, 0] / ph[:, 2], ph[:, 1] / ph[:, 2]
        want = int(((cam[:, 2] > 1.0) & (cam[:, 2] < 10.0) & (ph[:, 2] > 0)
                    & (u > 1) & (u < intr.width - 1)
                    & (v > 1) & (v < intr.height - 1)).sum())
        got = int(binary_visibility_count(jnp.asarray(dea, jnp.float32), centered_cloud))
        assert got == want, (dea, got, want)


def test_fd_gradients_are_reward_differences(centered_cloud):
    pts = centered_cloud
    x = jnp.array([10.0, 30.0, 10.0])
    r0 = float(binary_visibility_count(x, pts))
    g = jax.grad(lambda p: frustum_visibility_fd(p, pts, 0.1))(x)
    # notebook semantics: grad_i == f(x + δ e_i) − f(x) exactly (no /δ)
    for i in range(3):
        ri = float(binary_visibility_count(x + 0.1 * jnp.eye(3)[i], pts))
        np.testing.assert_allclose(float(g[i]), ri - r0, atol=1e-3)


def test_fd_pose_optimization_improves(centered_cloud):
    import optax

    pts = centered_cloud
    x = jnp.array([12.0, 30.0, 20.0])
    tx = optax.adam(0.5)  # notebook lr
    state = tx.init(x)
    r_init = float(binary_visibility_count(x, pts))
    for _ in range(40):
        g = jax.grad(lambda p: fd_pose_loss(p, pts))(x)
        updates, state = tx.update(g, state, x)
        x = optax.apply_updates(x, updates)
    r_final = float(binary_visibility_count(x, pts))
    assert r_final >= r_init


def test_gaussian_shape():
    np.testing.assert_allclose(float(gaussian(jnp.float32(3.0), mu=3.0, sigma=2.0)), 1.0)
    assert float(gaussian(jnp.float32(9.0), mu=3.0, sigma=2.0)) < 0.02


def test_distance_reward_forward_and_grads(cloud10, path10):
    pts = jnp.asarray(cloud10[:4000])
    params = init_distance_reward_params(path10)
    prob = DistanceRewardProblem(img_width=INTR.width, img_height=INTR.height)
    K = INTR.matrix()

    def loss_fn(p):
        return distance_reward_forward(p, pts, K, jnp.asarray(path10), prob)

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(grads["traj"])).all()
    assert np.isfinite(np.asarray(grads["rots"])).all()
    assert np.linalg.norm(np.asarray(grads["traj"])) > 0
    r = np.asarray(aux["rewards"])
    assert r.min() >= 0.49 and r.max() <= 1.0


def test_distance_reward_optimization_improves(cloud10, path10):
    import optax

    pts = jnp.asarray(cloud10[::8])
    params = init_distance_reward_params(path10)
    prob = DistanceRewardProblem(img_width=INTR.width, img_height=INTR.height)
    K = INTR.matrix()
    p0 = jnp.asarray(path10)

    def loss_fn(p):
        return distance_reward_forward(p, pts, K, p0, prob)

    tx = optax.multi_transform(
        {"t": optax.adam(0.1), "r": optax.adam(0.0)},
        param_labels={"traj": "t", "rots": "r"},
    )
    state = tx.init(params)
    (_, aux0) = loss_fn(params)
    for _ in range(25):
        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    assert float(aux["mean_reward"]) > float(aux0["mean_reward"])


def test_demo_scripts_run(tmp_path, monkeypatch):
    import sys, os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demos"))
    import pose_optimization_demo
    import trajectory_optimization_demo

    log = trajectory_optimization_demo.main(["opt_steps=10", "pub_sample=5"])
    assert len(log["visibility"]) == 2
    loss = pose_optimization_demo.main(["opt_steps=10", "pub_sample=5"])
    assert np.isfinite(loss)


def test_bag_replay_demo_runs():
    import sys, os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demos"))
    import bag_replay_demo

    bag_replay_demo.main()  # asserts internally: no bus errors, paths out
