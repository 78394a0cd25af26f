"""Waypoints Optimization (per-waypoint X/Y/yaw) and Trajectory Evaluation.

Covers the reference README's cam_wps_opt and cam_traj_eval demo modes
(`/root/reference/README.md:66-80`): batched per-waypoint pose refinement
must equal the reference's sequential per-waypoint runs, and evaluation must
report the log-odds-fused observed-point census.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajectory_optimization_tpu.models.evaluate import evaluate_trajectory
from trajectory_optimization_tpu.models.traj import TrajProblem
from trajectory_optimization_tpu.models.wps_opt import (
    WpsOptProblem,
    init_wps_params,
    optimize_waypoints,
    wps_forward,
    wps_path,
)
from trajectory_optimization_tpu.ops import quat as quat_ops


W, H = 64.0, 48.0
K = np.array([[50.0, 0, 32.0], [0, 50.0, 24.0], [0, 0, 1.0]], np.float32)


def _scene(rng, n=512):
    """A point blob around (1, 0.6, 3): in front of an identity-quat camera
    at the origin (looking along +z) but off the optical axis and outside
    the sweet-spot distance band, so every waypoint has visibility to gain
    from X/Y translation and yaw re-aiming."""
    return (rng.standard_normal((n, 3)) * 0.4 + np.array([1.0, 0.6, 3.0])).astype(
        np.float32
    )


def test_wps_path_identity_and_yaw():
    poses0 = np.array([[0, 0, 0.5], [1, 2, 0.7]], np.float32)
    quats0 = np.stack(
        [quat_ops.from_euler_np(0.1, -0.2, 0.3), quat_ops.from_euler_np(0, 0, 0)]
    ).astype(np.float32)
    params, frozen = init_wps_params(poses0, quats0)
    trans, quats = wps_path(params, frozen)
    np.testing.assert_allclose(np.asarray(trans), poses0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(quats), quats0, atol=1e-6)

    # a yaw offset must compose as a WORLD-z rotation on the base quat
    yaw = 0.8
    params = dict(params, yaw=jnp.array([yaw, 0.0], jnp.float32))
    _, quats = wps_path(params, frozen)
    expect = quat_ops.multiply(
        jnp.asarray(quat_ops.from_euler_np(0, 0, yaw), jnp.float32)[None],
        jnp.asarray(quats0[:1]),
    )
    np.testing.assert_allclose(np.asarray(quats[0]), np.asarray(expect[0]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(quats[1]), quats0[1], atol=1e-6)


def test_wps_opt_improves_every_waypoint_and_freezes_z(rng):
    pts = _scene(rng)
    poses0 = np.array([[0, 0, 0.2], [0.5, -0.5, 0.4], [-0.5, 0.5, 0.6]], np.float32)
    quats0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (3, 1))
    problem = WpsOptProblem(img_width=W, img_height=H, min_dist=1.0, max_dist=5.0)
    trans, quats, aux = optimize_waypoints(
        pts, poses0, quats0, K, problem, n_steps=60, lr_xy=0.05, lr_yaw=0.05
    )
    losses0 = np.asarray(aux["losses0"])
    losses = np.asarray(aux["losses"])
    assert losses.shape == (3,)
    assert (losses < losses0).all(), (losses, losses0)
    # z and roll/pitch are frozen: positions keep their z, quats stay pure
    # world-z rotations of the (identity) base orientation
    np.testing.assert_allclose(np.asarray(trans)[:, 2], poses0[:, 2], atol=1e-6)
    q = np.asarray(quats)
    np.testing.assert_allclose(q[:, 1], 0.0, atol=1e-6)
    np.testing.assert_allclose(q[:, 2], 0.0, atol=1e-6)


def test_wps_batched_equals_sequential(rng):
    """The batched W-waypoint optimization must reproduce the reference's
    sequential per-waypoint runs: the problems are independent and Adam is
    elementwise, so each waypoint's trajectory through parameter space is
    identical either way."""
    pts = _scene(rng)
    poses0 = np.array([[0, 0, 0.2], [0.5, -0.5, 0.4], [-0.3, 0.4, 0.1]], np.float32)
    quats0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (3, 1))
    problem = WpsOptProblem(img_width=W, img_height=H)

    trans_b, quats_b, _ = optimize_waypoints(
        pts, poses0, quats0, K, problem, n_steps=25, lr_xy=0.05, lr_yaw=0.05
    )
    for w in range(3):
        trans_1, quats_1, _ = optimize_waypoints(
            pts, poses0[w : w + 1], quats0[w : w + 1], K, problem,
            n_steps=25, lr_xy=0.05, lr_yaw=0.05,
        )
        np.testing.assert_allclose(
            np.asarray(trans_b)[w], np.asarray(trans_1)[0], rtol=0, atol=2e-5
        )
        np.testing.assert_allclose(
            np.asarray(quats_b)[w], np.asarray(quats_1)[0], rtol=0, atol=2e-5
        )


def test_wps_soft_hpr_gradient_finite(rng):
    pts = _scene(rng, n=256)
    poses0 = np.zeros((2, 3), np.float32)
    quats0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1))
    problem = WpsOptProblem(img_width=W, img_height=H, soft_hpr=True)
    params, frozen = init_wps_params(poses0, quats0)

    def loss(p):
        return wps_forward(p, frozen, jnp.asarray(pts), jnp.asarray(K), problem)[0]

    g = jax.grad(loss)(params)
    assert all(np.isfinite(np.asarray(v)).all() for v in jax.tree_util.tree_leaves(g))


def test_wps_occlusion_and_valid_masks(rng):
    """occlusion_mask and valid must suppress their points' contributions."""
    pts = _scene(rng, n=128)
    poses0 = np.zeros((1, 3), np.float32)
    quats0 = np.array([[1.0, 0, 0, 0]], np.float32)
    problem = WpsOptProblem(img_width=W, img_height=H)
    params, frozen = init_wps_params(poses0, quats0)
    P, Kj = jnp.asarray(pts), jnp.asarray(K)

    _, aux_full = wps_forward(params, frozen, P, Kj, problem)
    occ = jnp.zeros(len(pts), jnp.float32).at[: len(pts) // 2].set(1.0)
    _, aux_occ = wps_forward(params, frozen, P, Kj, problem, occlusion_mask=occ)
    np.testing.assert_allclose(
        np.asarray(aux_occ["observations"][0, len(pts) // 2 :]), 0.0, atol=0
    )
    _, aux_val = wps_forward(params, frozen, P, Kj, problem, valid=occ)
    np.testing.assert_allclose(
        np.asarray(aux_occ["observations"]), np.asarray(aux_val["observations"]), atol=0
    )
    assert float(aux_occ["losses"][0]) > float(aux_full["losses"][0])


def test_evaluate_trajectory_census(rng):
    """Observed = fused reward > 0.5; points behind every camera stay at
    exactly the 0.5 prior and must not be counted."""
    front = (rng.standard_normal((64, 3)) * 0.3 + np.array([0, 0, 3.0])).astype(
        np.float32
    )
    behind = (rng.standard_normal((64, 3)) * 0.3 + np.array([0, 0, -40.0])).astype(
        np.float32
    )
    pts = np.concatenate([front, behind])
    poses = np.array([[0, 0, 0], [0.2, 0, 0]], np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1))
    problem = TrajProblem(img_width=W, img_height=H)
    res = evaluate_trajectory(pts, poses, quats, K, problem)
    assert res.rewards.shape == (128,)
    # far-behind points: no waypoint observes them -> exactly the 0.5 prior
    np.testing.assert_allclose(res.rewards[64:], 0.5, atol=1e-6)
    # observed = strictly above the prior. Only front points CAN be
    # observed, and some are (min-max normalization floors sub-median
    # scores at the 0.5 clip, so not every front point counts)
    n_front = int((res.rewards[:64] > 0.5).sum())
    assert 0 < n_front <= 64
    assert res.n_observed == n_front
    assert res.frac_observed == pytest.approx(n_front / 128.0)
    assert res.mean_reward == pytest.approx(float(res.rewards.mean()), rel=1e-5)
    assert res.length == pytest.approx(0.2, rel=1e-5)
    assert res.loss_vis == pytest.approx(1.0 / (res.mean_reward + problem.eps), rel=1e-5)
    # a 2-waypoint path has no interior angles: the census must still report
    # finite smoothness numbers (straight by definition), not the 0/0 NaN
    assert res.mean_angle == pytest.approx(np.pi, rel=1e-6)
    assert res.loss_smooth == pytest.approx(
        problem.smoothness_weight / (np.pi + problem.eps), rel=1e-5)


def test_evaluate_valid_mask_excludes_padding(rng):
    pts = (rng.standard_normal((32, 3)) * 0.3 + np.array([0, 0, 3.0])).astype(
        np.float32
    )
    pad = np.zeros((16, 3), np.float32)
    padded = np.concatenate([pts, pad])
    valid = np.concatenate([np.ones(32, np.float32), np.zeros(16, np.float32)])
    poses = np.zeros((2, 3), np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1))
    problem = TrajProblem(img_width=W, img_height=H)
    res_pad = evaluate_trajectory(padded, poses, quats, K, problem, valid=valid)
    res_ref = evaluate_trajectory(pts, poses, quats, K, problem)
    assert res_pad.n_observed == res_ref.n_observed
    assert res_pad.frac_observed == pytest.approx(res_ref.frac_observed, rel=1e-5)
    assert res_pad.mean_reward == pytest.approx(res_ref.mean_reward, rel=1e-4)


def test_wps_sharded_matches_single_chip(rng):
    """Multi-chip per-waypoint refinement == single-chip wps_forward: the
    psum'd per-waypoint sums and the Adam trajectories must agree on the
    8-device CPU mesh."""
    from trajectory_optimization_tpu.opt.engine import OptimizerConfig
    from trajectory_optimization_tpu.parallel.mesh import make_mesh
    from trajectory_optimization_tpu.parallel.wps_sharded import (
        make_sharded_wps_step,
        wps_loss_sharded,
    )

    pts = _scene(rng, n=256)  # divisible by 8
    poses0 = np.array([[0, 0, 0.2], [0.5, -0.5, 0.4]], np.float32)
    quats0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1))
    problem = WpsOptProblem(img_width=W, img_height=H)
    params, frozen = init_wps_params(poses0, quats0)
    valid = np.ones(len(pts), np.float32)
    mesh = make_mesh(8)
    P, Kj = jnp.asarray(pts), jnp.asarray(K)

    loss_s, aux_s = wps_loss_sharded(
        mesh, params, frozen, P, valid, Kj, problem)
    losses_s, obs_s = aux_s["losses"], aux_s["observations"]
    loss_1, aux_1 = wps_forward(params, frozen, P, Kj, problem,
                                valid=jnp.asarray(valid))
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-5)
    np.testing.assert_allclose(float(aux_s["mean_reward"]),
                               float(aux_1["mean_reward"]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(losses_s), np.asarray(aux_1["losses"]),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(obs_s), np.asarray(aux_1["observations"]),
                               rtol=1e-4, atol=1e-6)

    # a few Adam steps through the sharded step_fn vs the single-chip engine
    cfg = OptimizerConfig(lr_pose=0.05, lr_quat=0.05)
    init_fn, step_fn = make_sharded_wps_step(mesh, problem, cfg)
    # explicit copy: device_put to an already-matching sharding aliases the
    # buffers, and step_fn DONATES its params — without the copy the
    # single-chip comparison below would read deleted arrays
    p_s = jax.device_put(
        jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), params),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    state = init_fn(p_s)
    for _ in range(5):
        p_s, state, losses_s, _ = step_fn(p_s, state, frozen, P,
                                          jnp.asarray(valid), Kj)

    from trajectory_optimization_tpu.opt.engine import EarlyStop, optimize

    def loss_fn(p):
        return wps_forward(p, frozen, P, Kj, problem, valid=jnp.asarray(valid))

    stop = EarlyStop(rewards_th=float("inf"), smoothness_th=float("inf"),
                     reward_key="mean_reward", smooth_key="mean_reward")
    p_1, _, _ = optimize(loss_fn, params, cfg, 5, early_stop=stop,
                         pose_key="xy", quat_key="yaw")
    np.testing.assert_allclose(np.asarray(p_s["xy"]), np.asarray(p_1["xy"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(p_s["yaw"]), np.asarray(p_1["yaw"]),
                               rtol=1e-4, atol=1e-5)


def test_wps_sharded_edges(rng):
    """Review-found edges: the occlusion_mask gate matches single-chip
    wps_forward, indivisible clouds get the friendly pad_points error, and
    a soft_hpr problem is rejected at BUILD time, not first trace."""
    from trajectory_optimization_tpu.opt.engine import OptimizerConfig
    from trajectory_optimization_tpu.parallel.mesh import make_mesh
    from trajectory_optimization_tpu.parallel.wps_sharded import (
        make_sharded_wps_step,
        wps_loss_sharded,
    )

    pts = _scene(rng, n=256)
    poses0 = np.array([[0, 0, 0.2], [0.5, -0.5, 0.4]], np.float32)
    quats0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1))
    problem = WpsOptProblem(img_width=W, img_height=H)
    params, frozen = init_wps_params(poses0, quats0)
    valid = np.ones(len(pts), np.float32)
    occ = (rng.uniform(size=len(pts)) > 0.3).astype(np.float32)
    mesh = make_mesh(8)
    P, Kj = jnp.asarray(pts), jnp.asarray(K)

    loss_s, aux_s = wps_loss_sharded(
        mesh, params, frozen, P, valid, Kj, problem,
        occlusion_mask=jnp.asarray(occ))
    loss_1, aux_1 = wps_forward(params, frozen, P, Kj, problem,
                                valid=jnp.asarray(valid),
                                occlusion_mask=jnp.asarray(occ))
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(aux_s["observations"]), np.asarray(aux_1["observations"]),
        rtol=1e-4, atol=1e-6)

    with pytest.raises(ValueError, match="pad_points"):
        wps_loss_sharded(mesh, params, frozen, P[:255], valid[:255], Kj,
                         problem)


def test_wps_sharded_soft_hpr_matches_single_chip(rng):
    """wps_loss_sharded(soft_hpr=True) == wps_forward with the binned
    kernel forced: per-waypoint losses, gradients and a short Adam run on
    the 8-device CPU mesh. Occlusion comes from the point-sharded binned
    HPR per waypoint (the traj_sharded body, here under the waypoints-mode
    criterion)."""
    from trajectory_optimization_tpu.opt.engine import OptimizerConfig
    from trajectory_optimization_tpu.parallel.mesh import make_mesh
    from trajectory_optimization_tpu.parallel.wps_sharded import (
        make_sharded_wps_step,
        wps_loss_sharded,
    )

    pts = _scene(rng, n=1024)
    poses0 = np.array([[0, 0, 0.2], [0.5, -0.5, 0.4]], np.float32)
    quats0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1))
    # soft_hpr_dense_max=0 forces the binned kernel single-chip — the tier
    # the sharded body distributes — so this is kernel-to-kernel parity
    problem = WpsOptProblem(img_width=W, img_height=H, soft_hpr=True,
                            soft_hpr_dense_max=0)
    params, frozen = init_wps_params(poses0, quats0)
    valid = jnp.ones(len(pts), jnp.float32).at[-32:].set(0.0)
    occ = jnp.asarray((rng.uniform(size=len(pts)) > 0.3).astype(np.float32))
    mesh = make_mesh(8)
    P, Kj = jnp.asarray(pts), jnp.asarray(K)

    def loss_sh(p):
        return wps_loss_sharded(mesh, p, frozen, P, valid, Kj, problem,
                                hpr_cap=256, occlusion_mask=occ)

    def loss_1(p):
        return wps_forward(p, frozen, P, Kj, problem, valid=valid,
                           occlusion_mask=occ)

    # outer jit: the checkpointed scan body inside shard_map cannot be
    # evaluated eagerly (jax closed_call limitation)
    (l_s, aux_s), g_s = jax.jit(
        jax.value_and_grad(loss_sh, has_aux=True))(params)
    (l_1, aux_1), g_1 = jax.jit(
        jax.value_and_grad(loss_1, has_aux=True))(params)
    np.testing.assert_allclose(float(l_s), float(l_1), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(aux_s["losses"]),
                               np.asarray(aux_1["losses"]), rtol=1e-4)
    # per-element observations agree up to quantized-key candidate ties
    d = np.abs(np.asarray(aux_s["observations"])
               - np.asarray(aux_1["observations"]))
    assert d.mean() < 5e-4, d.mean()
    for k in ("xy", "yaw"):
        a, b = np.asarray(g_1[k]), np.asarray(g_s[k])
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
        assert rel < 5e-3, (k, rel)

    # the full sharded step optimizes: per-waypoint losses drop
    cfg = OptimizerConfig(lr_pose=0.05, lr_quat=0.05)
    init_fn, step_fn = make_sharded_wps_step(mesh, problem, cfg, hpr_cap=256)
    p_s = jax.device_put(
        jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), params),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    state = init_fn(p_s)
    first = None
    for _ in range(6):
        p_s, state, losses_s, _ = step_fn(p_s, state, frozen, P, valid, Kj)
        if first is None:
            first = np.asarray(losses_s)
    assert (np.asarray(losses_s) < first).all(), (losses_s, first)


def test_demo_scripts_run():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demos"))
    import trajectory_evaluation_demo
    import waypoints_optimization_demo

    gains = waypoints_optimization_demo.main(["opt_steps=8"])
    assert np.isfinite(gains).all()
    ev0, ev1 = trajectory_evaluation_demo.main(["opt_steps=8"])
    assert ev0.n_observed > 0 and ev1.n_observed > 0


def test_cli_eval(tmp_path, capsys, cloud10, path10):
    """`python -m trajectory_optimization_tpu eval CLOUD PATH` prints the
    observed-voxel census."""
    from trajectory_optimization_tpu.__main__ import main

    np.savez(tmp_path / "cloud.npz", pts=cloud10[::16])
    np.savez(tmp_path / "path.npz", poses=path10)
    rc = main(["eval", str(tmp_path / "cloud.npz"), str(tmp_path / "path.npz")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "observed" in out and "mean reward" in out
    rc = main(["eval", str(tmp_path / "missing.npz"), str(tmp_path / "path.npz")])
    assert rc == 1


def test_evaluate_improves_after_optimization(cloud10, path10):
    """The cam_traj_eval story end to end: the optimizer's output must
    evaluate better than the initial path on the reference scene."""
    from trajectory_optimization_tpu.api import TrajectoryOptimizer

    pts = cloud10[::8]  # keep CPU-suite cost down; same geometry
    opt = TrajectoryOptimizer()
    res = opt.optimize(pts, path10, n_steps=60)
    problem = TrajProblem(
        img_width=opt.intr.width, img_height=opt.intr.height
    )
    quats0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (len(path10), 1))
    ev0 = evaluate_trajectory(pts, path10, quats0, opt.intr.matrix(), problem)
    ev1 = evaluate_trajectory(
        pts, res.poses.astype(np.float32), res.quats_wxyz.astype(np.float32),
        opt.intr.matrix(), problem,
    )
    assert ev1.mean_reward > ev0.mean_reward
    assert ev1.n_observed >= ev0.n_observed
