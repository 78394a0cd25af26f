#!/usr/bin/env python
"""On-card smoke test: the trajectory optimizer's main path on one GPU.

Run from the root of a checkout:

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # the sharded train step on four cards

Phases (one card):
  1. the node graph: ``launch_trajectory_optimization()`` answers three
     cloud-10 / path-10 messages; step-0 loss terms against the float64
     oracle (tests/oracles.py), and the published path must see more than
     the input path;
  2. the same jitted runner (``opt.runners.traj_runner``) and train step at
     cloud 10 x path 10 and at 1,048,576 points x 50 waypoints: step-0 terms
     against the oracle, the step-0 gradient against the CPU backend, step
     time beside the shape floor;
  3. the occlusion-aware trajectory step (40,452 x 14, binned soft HPR):
     step-0 loss and gradient against the CPU backend;
  4. rig pieces: ``hpr_mask_approx`` against Qhull, ``render_point_cloud``
     at 1616 x 1232 against the CPU backend's image.

Every time printed is labelled with the card's name and power limit; times
are printed for the record and claim nothing. Any failed check raises, so
the process exits non-zero and prints no result line. The last line of
stdout is one JSON object naming the device. The process needs a CUDA
device: with none, JAX fails at start-up.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# float32 outside the tensor cores and HBM bandwidth. Keyed by a substring
# of jax's device_kind; a card not listed is an error, not a default.
PEAKS = {"H100": {"fp32_flop_s": 67e12, "hbm_byte_s": 3.35e12}}

# Operations per (waypoint, point) pair of the visibility log-odds, counted
# from ops/scores.py and models/traj.py (mul and add counted apart,
# transcendentals as one): the world->camera transform 18, the distance
# Gaussian 11, the FOV mask 28, normalize/clip/log-odds/sum 9. The backward
# is counted as twice the forward.
VIS_FWD_FLOP_PER_PAIR = 66
VIS_BWD_FLOP_PER_PAIR = 2 * VIS_FWD_FLOP_PER_PAIR

# Sizes.
BIG_N, BIG_W = 1_048_576, 50
FOUR_N = 4_194_304
RENDER_HW = (1232, 1616)

# Tolerances (each with its reason).
# Oracle comparisons: the bound tests/test_api_golden.py uses on the CPU.
ORACLE_RTOL = 1e-3
# Visibility gradient, GPU vs CPU backend: the f32 rounding of the
# clip-boundary tail. Points whose normalized score sits near the 1-eps
# ceiling carry a ~1e6 log-odds derivative, so last-bit differences in the
# score move their gradient terms visibly; this tail measured ~3e-2 relnorm
# between two f32 implementations at W>=128 / N=256k. A real backward error
# shows up orders of magnitude above it.
GRAD_RELNORM_BIG = 3e-2
# Smoothness gradient: d acos(x)/dx = -1/sqrt(1 - x^2) is ill-conditioned at
# near-straight waypoints (x near -1), so any f32 evaluation of it is
# percent-level off: the CPU backend's is 3.9e-2 relnorm from float64 on
# the 50-waypoint sine path. Both backends are held to a float64
# evaluation, and the GPU may be at most this factor further from it than
# the CPU backend is (or within the floor, where both are exact to f32).
SMOOTH_GRAD_F64_RATIO = 2.0
SMOOTH_GRAD_F64_FLOOR = 1e-4
# Occlusion-aware step, GPU vs CPU: the binned HPR sorts points by direction
# and cuts bins at fixed edges, so a point within an ulp of an edge can land
# in another bin on the other backend and change which coverers its tile
# sees. That moves a handful of the 40k soft gates; the loss is a mean over
# all points and stays within the oracle bound, the gradient sums those
# few points' changed terms.
OCCL_LOSS_RTOL = 1e-3
OCCL_GRAD_RELNORM = 5e-2
# Approximate HPR against Qhull: the README's claim.
HPR_MIN_RECALL = 0.99
# Four cards against one. The sum over point shards reorders f32 adds, so
# the step-0 visibility gradient may differ by ~sqrt(N) ulps of its norm.
FOUR_LOSS_RTOL = 1e-3
FOUR_GRAD_RELNORM = FOUR_N ** 0.5 * 2.0 ** -24
# Poses after a few Adam steps: where a coordinate's gradient changes sign
# between steps, Adam's first moment cancels and the ratio m/sqrt(v) can
# magnify those last-bit differences (1.4e-4 measured on four H100s at
# 4M x 50, in one waypoint's y). Bound: 1% of one Adam step (lr_pose 0.1);
# a sharding error moves the poses by a step's order.
FOUR_POSES_ATOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# comparison helpers (tested on the CPU in tests/test_chip_smoke.py)
# ---------------------------------------------------------------------------


def rel_err(got: float, want: float) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def tree_relnorm(got, want) -> float:
    """||got - want|| / ||want|| over every leaf of two pytrees of arrays."""
    import jax

    g = [np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(got)]
    w = [np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(want)]
    g, w = np.concatenate(g), np.concatenate(w)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def oracle_terms(points, poses, quats_wxyz, poses0, intr, wps_step, smooth_w=14.0):
    """The float64 oracle's loss terms: {'vis', 'smooth', 'mean_reward'}."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import oracles

    _, terms, rewards = oracles.traj_loss(
        np.asarray(points, np.float64), np.asarray(poses, np.float64),
        np.asarray(quats_wxyz, np.float64), np.asarray(poses0, np.float64),
        intr.matrix_np(np.float64), intr.width, intr.height,
        smooth_w=smooth_w, wps_step=wps_step)
    return {"vis": terms["vis"], "smooth": terms["smooth"],
            "mean_reward": float(rewards.mean())}


def check_terms(name: str, got: dict, want: dict, rtol: float) -> float:
    """Every key of ``want`` within ``rtol`` of ``got``; returns the worst."""
    errs = {k: rel_err(got[k], want[k]) for k in want}
    log(f"[{name}] " + ", ".join(
        f"{k} {float(got[k])!r} vs {float(want[k])!r} (rel {errs[k]:.2e})" for k in want)
        + f"; bound {rtol}")
    worst = max(errs.values())
    if not worst <= rtol:
        raise AssertionError(f"{name}: loss terms off by {worst:.3e} > {rtol}")
    return worst


def vis_step_floor(n_points: int, n_wps: int, peaks: dict) -> dict:
    """Operations and bytes one visibility forward+backward needs, from the
    shapes, and the least time the card could take for them.

    Bytes: the (N, 3) cloud and the (N,) mask are read once by the forward
    and once by the backward, and the (N,) rewards are written once; the
    (W, N) planes need never reach memory."""
    pairs = n_points * n_wps
    flop = pairs * (VIS_FWD_FLOP_PER_PAIR + VIS_BWD_FLOP_PER_PAIR)
    nbytes = 2 * n_points * (3 + 1) * 4 + n_points * 4
    t_flop = flop / peaks["fp32_flop_s"]
    t_bytes = nbytes / peaks["hbm_byte_s"]
    return {"flop": flop, "bytes": nbytes, "floor_s": max(t_flop, t_bytes),
            "bound": "compute" if t_flop >= t_bytes else "memory"}


def hpr_scores(approx: np.ndarray, exact: np.ndarray):
    """(recall, false positives) of a visible mask against the exact one."""
    approx, exact = np.asarray(approx, bool), np.asarray(exact, bool)
    recall = float((approx & exact).sum() / max(exact.sum(), 1))
    return recall, int((approx & ~exact).sum())


def image_diff(img_a, img_b, depth_a, depth_b):
    """Pixels where two renders differ: (n_differ, n_depth_differ).

    ``depth_*`` are the same renders with each point colored by its depth.
    The z-buffer minimum does not depend on scatter order, so the depth
    images must match everywhere; a pixel whose color differs while its
    depth matches was won by two splats of equal depth (a tie), which either
    backend may resolve either way."""
    differ = np.any(np.asarray(img_a) != np.asarray(img_b), axis=-1)
    depth_differ = np.any(np.asarray(depth_a) != np.asarray(depth_b), axis=-1)
    return int(differ.sum()), int(depth_differ.sum())


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------


def start_jax():
    """Bring JAX up on the GPU, with the CPU backend beside it for in-process
    comparisons. A missing CUDA backend is an error, never a fallback."""
    import jax

    jax.config.update("jax_platforms", "cuda,cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"default device is {dev.platform}, not a GPU")
    return jax


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def peaks_for(kind: str) -> dict:
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    raise KeyError(f"no published peaks for device kind {kind!r}")


def on_cpu(x):
    import jax

    return jax.device_put(x, jax.devices("cpu")[0])


def load_reference():
    from trajectory_optimization_tpu.utils.data import load_path, load_point_cloud

    pts = load_point_cloud(os.path.join(HERE, "data/points/point_cloud_10.npz"))
    path = load_path(os.path.join(HERE, "data/paths/path_poses_10.npz"))
    return pts.astype(np.float32), path.astype(np.float32)


def big_workload(n_points: int, seed: int = 0):
    """Seeded uniform cloud and the 50-waypoint sine path used by bench.py."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, size=(n_points, 3)).astype(np.float32)
    t = np.linspace(0, 1, BIG_W, dtype=np.float32)
    path = np.stack([30 * t, 10 * np.sin(4 * t), np.zeros_like(t)], axis=1)
    return pts, path


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_node(card: str, pts, path) -> None:
    """Phase 1: the node graph, through launch_trajectory_optimization()."""
    from trajectory_optimization_tpu.bus.launch import launch_trajectory_optimization
    from trajectory_optimization_tpu.bus.messages import CloudMsg, Header, PathMsg
    from trajectory_optimization_tpu.models.traj import waypoint_stride
    from trajectory_optimization_tpu.utils.data import identity_quaternions
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    launch = launch_trajectory_optimization()
    try:
        node = launch.nodes["traj_opt"]
        cfg = node.cfg
        out = []
        launch.bus.subscribe(cfg.path_topic + "/optimized", out.append)
        walls = []
        results = []
        for i in range(3):
            stamp = 10.0 * i
            t0 = time.perf_counter()
            launch.bus.publish(cfg.pc_topic, CloudMsg(Header(stamp=stamp, frame_id="map"), pts))
            launch.bus.publish(cfg.path_topic, PathMsg.straight(path, frame_id="map", stamp=stamp))
            walls.append(time.perf_counter() - t0)
            results.append(dict(node.last_result or {}))
    finally:
        launch.close()
    if launch.bus.errors:
        raise AssertionError(f"bus errors: {launch.bus.errors}")
    if len(out) != 3:
        raise AssertionError(f"{len(out)} /path/optimized messages, expected 3")

    intr = default_intrinsics()
    step = waypoint_stride(path, cfg.vis_wps_dist)
    quats0 = identity_quaternions(len(path))
    want = oracle_terms(pts, path, quats0, path, intr, step, smooth_w=cfg.smooth_weight)
    for i, r in enumerate(results):
        # loss_vis is 1 / (mean_reward + eps) (models.traj.traj_criterion)
        got = {"vis": 1.0 / (r["mean_reward0"] + 1e-6), "smooth": r["loss_smooth0"],
               "mean_reward": r["mean_reward0"]}
        check_terms(f"phase1 node msg {i} step 0 vs f64 oracle", got, want, ORACLE_RTOL)

    msg = out[-1]
    q_wxyz = np.concatenate([msg.orientations_xyzw[:, 3:], msg.orientations_xyzw[:, :3]], axis=1)
    after = oracle_terms(pts, msg.positions, q_wxyz, path, intr, step,
                         smooth_w=cfg.smooth_weight)
    log(f"[phase1] oracle mean reward: input path {want['mean_reward']!r}, "
        f"published path {after['mean_reward']!r}; iterations {results[-1]['n_iters']}")
    if not after["mean_reward"] > want["mean_reward"]:
        raise AssertionError("the published path sees no more than the input path")
    log(f"[phase1] printed, not claimed ({card}): first callback incl. compile "
        f"{walls[0]!r} s; later callbacks {[w * 1e3 for w in walls[1:]]!r} ms wall")


def _traj_step_fns(problem, cfg):
    """(value_and_grad fn, one jitted grad+Adam step) for a TrajProblem."""
    import jax
    import optax

    from trajectory_optimization_tpu.models.traj import traj_forward
    from trajectory_optimization_tpu.opt.engine import make_optimizer

    tx = make_optimizer(cfg)

    def vg(params, points, valid, K, poses0, quats0):
        return jax.value_and_grad(
            lambda p: traj_forward(p, points, K, poses0, quats0, problem, valid=valid),
            has_aux=True)(params)

    @jax.jit
    def step(params, opt_state, points, valid, K, poses0, quats0):
        _, grads = vg(params, points, valid, K, poses0, quats0)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return jax.jit(vg), step, tx


def _term_grad(problem, term: str):
    """Jitted gradient of one loss term of traj_forward's aux."""
    import jax

    from trajectory_optimization_tpu.models.traj import traj_forward

    def fn(params, points, valid, K, poses0, quats0):
        return traj_forward(params, points, K, poses0, quats0, problem, valid=valid)[1][term]

    return jax.jit(jax.grad(fn))


def phase_step(card: str, peaks: dict, pts, path, n_steps: int = 20) -> None:
    """Phase 2: the jitted runner and the train step on one workload."""
    import jax
    import jax.numpy as jnp

    from trajectory_optimization_tpu.models.traj import (
        TrajProblem, init_traj_params, waypoint_stride,
    )
    from trajectory_optimization_tpu.opt.engine import EarlyStop, OptimizerConfig
    from trajectory_optimization_tpu.opt.runners import traj_runner
    from trajectory_optimization_tpu.utils.data import identity_quaternions
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    n_points = len(pts)
    intr = default_intrinsics()
    quats0 = identity_quaternions(len(path))
    step = waypoint_stride(path, 0.5)
    problem = TrajProblem(img_width=intr.width, img_height=intr.height, wps_step=step)
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    args = (jnp.asarray(pts), jnp.ones((n_points,), jnp.float32), intr.matrix(),
            jnp.asarray(path), jnp.asarray(quats0))
    params = init_traj_params(path, quats0)
    vg, train_step, tx = _traj_step_fns(problem, cfg)

    tag = f"[phase2 {n_points}x{len(path)}]"
    (loss, aux), grads = vg(params, *args)
    got = {"vis": aux["loss_vis"], "smooth": aux["loss_smooth"],
           "mean_reward": aux["mean_reward"]}
    want = oracle_terms(pts, path, quats0, path, intr, step)
    check_terms(f"{tag[1:-1]} step 0 vs f64 oracle", got, want, ORACLE_RTOL)
    (_, _), grads_cpu = vg(on_cpu(params), *on_cpu(args))
    g_vis = _term_grad(problem, "loss_vis")
    rn_vis = tree_relnorm(g_vis(params, *args), g_vis(on_cpu(params), *on_cpu(args)))
    g_smooth = _term_grad(problem, "loss_smooth")
    s_gpu, s_cpu = g_smooth(params, *args), g_smooth(on_cpu(params), *on_cpu(args))
    with jax.enable_x64(True):
        p64, a64 = on_cpu(jax.tree.map(lambda x: np.asarray(x, np.float64), (params, args)))
        s_64 = g_smooth(p64, *a64)
    e_gpu, e_cpu = tree_relnorm(s_gpu, s_64), tree_relnorm(s_cpu, s_64)
    smooth_bound = max(SMOOTH_GRAD_F64_RATIO * e_cpu, SMOOTH_GRAD_F64_FLOOR)
    log(f"{tag} step-0 gradient: full, GPU vs CPU backend relnorm "
        f"{tree_relnorm(grads, grads_cpu):.3e} (printed); visibility term, GPU vs CPU "
        f"backend {rn_vis:.3e} (bound {GRAD_RELNORM_BIG}); smoothness term vs float64: "
        f"GPU {e_gpu:.3e}, CPU backend {e_cpu:.3e} (bound {smooth_bound:.3e})")
    if not (rn_vis <= GRAD_RELNORM_BIG and e_gpu <= smooth_bound):
        raise AssertionError(f"{tag} step-0 gradient out of bounds")

    stop = EarlyStop(rewards_th=float("inf"), smoothness_th=float("inf"))
    run = traj_runner(problem, cfg, stop, n_steps)
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(params, *args))
    t_compile = time.perf_counter() - t0
    if not (np.isfinite(float(out[2])) and int(out[1]) == n_steps):
        raise AssertionError(f"{tag} runner: loss {out[2]}, {out[1]} iterations")
    t0 = time.perf_counter()
    jax.block_until_ready(run(params, *args))
    t_run = time.perf_counter() - t0

    compiled = train_step.lower(params, tx.init(params), *args).compile()
    log(f"{tag} train step memory_analysis: {compiled.memory_analysis()}")
    p, s = params, tx.init(params)
    p, s = jax.block_until_ready(compiled(p, s, *args))
    n_time, t_steps = 50, []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_time):
            p, s = compiled(p, s, *args)
        jax.block_until_ready((p, s))
        t_steps.append((time.perf_counter() - t0) / n_time)
    t_step = float(np.median(t_steps))
    stats = jax.devices()[0].memory_stats() or {}
    floor = vis_step_floor(n_points, -(-len(path) // step), peaks)
    log(f"{tag} peak_bytes_in_use {stats.get('peak_bytes_in_use')!r}")
    log(f"{tag} printed, not claimed ({card}): runner compile+run {t_compile!r} s; "
        f"runner {n_steps} steps {t_run * 1e3!r} ms; steady train step "
        f"{[t * 1e3 for t in t_steps]!r} ms (3 windows of {n_time} steps)")
    log(f"{tag} visibility fwd+bwd floor: {floor['flop']} flop, {floor['bytes']} "
        f"bytes -> {floor['floor_s'] * 1e6!r} us ({floor['bound']}-bound at the "
        f"published peaks); floor / median steady step {floor['floor_s'] / t_step!r}")


def phase_occlusion(card: str, pts, path, n_steps: int = 5) -> None:
    """Phase 3: the occlusion-aware trajectory step, binned HPR."""
    import jax
    import jax.numpy as jnp

    from trajectory_optimization_tpu.models.traj import (
        TrajProblem, init_traj_params, waypoint_stride,
    )
    from trajectory_optimization_tpu.opt.engine import EarlyStop, OptimizerConfig
    from trajectory_optimization_tpu.opt.runners import traj_runner
    from trajectory_optimization_tpu.utils.data import identity_quaternions
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    intr = default_intrinsics()
    quats0 = identity_quaternions(len(path))
    step = waypoint_stride(path, 0.5)
    problem = TrajProblem(img_width=intr.width, img_height=intr.height,
                          wps_step=step, soft_hpr=True)
    if not len(pts) > problem.soft_hpr_dense_max:
        raise AssertionError("phase3 must route to the binned HPR")
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    args = (jnp.asarray(pts), jnp.ones((len(pts),), jnp.float32), intr.matrix(),
            jnp.asarray(path), jnp.asarray(quats0))
    params = init_traj_params(path, quats0)
    vg, _, _ = _traj_step_fns(problem, cfg)

    t0 = time.perf_counter()
    (loss, _), grads = vg(params, *args)
    t_vg = time.perf_counter() - t0
    (loss_c, _), grads_c = vg(on_cpu(params), *on_cpu(args))
    le, rn = rel_err(loss, loss_c), tree_relnorm(grads, grads_c)
    log(f"[phase3] {len(pts)}x{-(-len(path) // step)} soft-HPR step 0, GPU vs CPU "
        f"backend: loss {float(loss)!r} vs {float(loss_c)!r} (rel {le:.2e}, bound "
        f"{OCCL_LOSS_RTOL}); gradient relnorm {rn:.3e} (bound {OCCL_GRAD_RELNORM})")
    if not (le <= OCCL_LOSS_RTOL and rn <= OCCL_GRAD_RELNORM):
        raise AssertionError("phase3 GPU and CPU backends disagree")

    run = traj_runner(problem, cfg, EarlyStop(float("inf"), float("inf")), n_steps)
    t0 = time.perf_counter()
    compiled = run.lower(params, *args).compile()
    t_compile = time.perf_counter() - t0
    log(f"[phase3] runner memory_analysis: {compiled.memory_analysis()}")
    out = jax.block_until_ready(compiled(params, *args))
    if not (np.isfinite(float(out[2])) and int(out[1]) == n_steps):
        raise AssertionError(f"phase3 runner: loss {out[2]}, {out[1]} iterations")
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(params, *args))
    t_run = time.perf_counter() - t0
    log(f"[phase3] printed, not claimed ({card}): step-0 value_and_grad incl. compile "
        f"{t_vg!r} s; runner compile {t_compile!r} s; runner {n_steps} steps "
        f"{t_run * 1e3!r} ms")


def phase_rig(card: str, pts, path) -> None:
    """Phase 4: approximate HPR against Qhull, and the splat renderer."""
    import jax
    import jax.numpy as jnp

    from trajectory_optimization_tpu.ops.hpr import hpr_mask_approx
    from trajectory_optimization_tpu.ops.render import render_point_cloud
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import oracles

    cam = pts - path[0]  # identity orientation: world offsets are camera frame
    t0 = time.perf_counter()
    approx = np.asarray(jax.block_until_ready(hpr_mask_approx(jnp.asarray(cam)))) > 0.5
    t_hpr = time.perf_counter() - t0
    exact = oracles.hpr_visible_mask(cam.astype(np.float64))
    recall, fp = hpr_scores(approx, exact)
    log(f"[phase4] hpr_mask_approx on {len(cam)} pts vs Qhull: recall {recall!r} "
        f"(bound >= {HPR_MIN_RECALL}), false positives {fp} (bound 0); first call "
        f"incl. compile {t_hpr!r} s ({card}, printed, not claimed)")
    if not (recall >= HPR_MIN_RECALL and fp == 0):
        raise AssertionError("phase4 approximate HPR misses its bounds")

    intr = default_intrinsics()
    vis = jnp.asarray(cam[approx])
    H, W = RENDER_HW
    kw = dict(znear=1.0, zfar=15.0)
    depth_colors = jnp.repeat(vis[:, 2:3], 3, axis=1)

    def render(points, colors=None):
        return np.asarray(render_point_cloud(points, intr.matrix(), H, W, colors=colors, **kw))

    img_g, depth_g = render(vis), render(vis, depth_colors)
    img_c = render(on_cpu(vis))
    depth_c = render(on_cpu(vis), on_cpu(depth_colors))
    n_diff, n_bad = image_diff(img_g, img_c, depth_g, depth_c)
    log(f"[phase4] render {W}x{H} of {vis.shape[0]} visible pts, GPU vs CPU backend: "
        f"{n_diff} of {H * W} pixels differ (share {n_diff / (H * W)!r}), "
        f"all but {n_bad} of them depth ties (bound 0)")
    if n_bad:
        raise AssertionError("phase4 renders differ beyond depth ties")

    # warm device times, no host fetch inside the window
    P = jnp.asarray(cam)
    t_hpr = _best_of(lambda: hpr_mask_approx(P))
    t_render = _best_of(lambda: render_point_cloud(vis, intr.matrix(), H, W, **kw))
    log(f"[phase4] printed, not claimed ({card}): warm hpr_mask_approx {t_hpr * 1e3!r} ms; "
        f"warm render {t_render * 1e3!r} ms (best of 5)")


def _best_of(fn, n: int = 5) -> float:
    """Least wall time of ``n`` calls of ``fn``, each waited on."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def phase_four_cards(card: str, n_points: int = FOUR_N, n_steps: int = 3) -> None:
    """The sharded train step on four cards against the same step on one card
    and against one card's runner."""
    import jax
    import jax.numpy as jnp

    from trajectory_optimization_tpu.models.traj import (
        TrajProblem, init_traj_params, waypoint_stride,
    )
    from trajectory_optimization_tpu.opt.engine import EarlyStop, OptimizerConfig
    from trajectory_optimization_tpu.opt.runners import traj_runner
    from trajectory_optimization_tpu.parallel.mesh import make_mesh
    from trajectory_optimization_tpu.parallel.sharded import (
        make_sharded_train_step, shard_points,
    )
    from trajectory_optimization_tpu.utils.data import identity_quaternions
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    if len(jax.devices()) != 4:
        raise AssertionError(f"--four-cards needs 4 devices, found {len(jax.devices())}")
    pts, path = big_workload(n_points)
    intr = default_intrinsics()
    quats0 = identity_quaternions(len(path))
    problem = TrajProblem(img_width=intr.width, img_height=intr.height,
                          wps_step=waypoint_stride(path, 0.5))
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    K, p0, q0 = intr.matrix(), jnp.asarray(path), jnp.asarray(quats0)
    valid = np.ones((n_points,), np.float32)

    # one card: the runner, n_steps exact Adam steps, then the loss there
    run = traj_runner(problem, cfg, EarlyStop(float("inf"), float("inf")), n_steps)
    p1, iters, loss1, _ = run(init_traj_params(path, quats0), jnp.asarray(pts),
                              jnp.asarray(valid), K, p0, q0)
    p1, loss1 = jax.device_get((p1, loss1))

    def sharded(n_cards):
        """n_steps sharded steps on an n_cards mesh: (step-0 visibility
        gradient, poses, loss at them, first-steps seconds incl. compile,
        steady step seconds)."""
        mesh = make_mesh(n_cards)
        P, V = shard_points(mesh, pts, valid)
        init_fn, step_fn = make_sharded_train_step(mesh, problem, cfg)
        params = init_traj_params(path, quats0)
        g_vis = jax.device_get(_term_grad(problem, "loss_vis")(params, P, V, K, p0, q0))
        opt_state = init_fn(params)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            params, opt_state, _, _ = step_fn(params, opt_state, P, V, K, p0, q0)
        params = jax.block_until_ready(params)
        t_first = time.perf_counter() - t0
        poses = np.asarray(jax.device_get(params["poses"]))
        # one more step returns the loss at the n_steps result
        params, opt_state, loss, _ = step_fn(params, opt_state, P, V, K, p0, q0)
        loss = float(loss)
        t0 = time.perf_counter()
        for _ in range(10):
            params, opt_state, _, _ = step_fn(params, opt_state, P, V, K, p0, q0)
        jax.block_until_ready(params)
        return g_vis, poses, loss, t_first, (time.perf_counter() - t0) / 10

    g4, p4, loss4, t_first4, t_step4 = sharded(4)
    g1, p1s, loss1s, _, t_step1s = sharded(1)
    rn = tree_relnorm(g4, g1)
    log(f"[four-cards] step-0 visibility gradient, 4 cards vs 1: relnorm {rn:.3e} "
        f"(bound {FOUR_GRAD_RELNORM:.3e})")

    def compare(what, poses, loss, bound):
        le = rel_err(loss4, loss)
        diff = np.abs(p4 - poses)
        w, c = np.unravel_index(np.argmax(diff), diff.shape)
        log(f"[four-cards] {n_points}x{len(path)}, {n_steps} Adam steps, 4 cards vs "
            f"{what}: loss {loss4!r} vs {loss!r} (rel {le:.2e}, bound {FOUR_LOSS_RTOL}); "
            f"poses max-abs {diff.max():.3e} at waypoint {w} axis {c} (bound {bound})")
        return le <= FOUR_LOSS_RTOL and diff.max() <= bound

    ok = rn <= FOUR_GRAD_RELNORM
    ok &= compare("the same step on one card", p1s, loss1s, FOUR_POSES_ATOL)
    ok &= compare("one card's runner", np.asarray(p1["poses"]), float(loss1),
                  FOUR_POSES_ATOL)
    if not (int(iters) == n_steps and ok):
        raise AssertionError("four cards disagree with one")
    log(f"[four-cards] printed, not claimed ({card}): first {n_steps} steps incl. "
        f"compile {t_first4!r} s; steady sharded step {t_step4 * 1e3!r} ms on 4 cards, "
        f"{t_step1s * 1e3!r} ms on 1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded train step on four cards")
    args = ap.parse_args(argv)

    jax = start_jax()
    from trajectory_optimization_tpu.bus.launch import enable_compilation_cache

    dev = jax.devices()[0]
    card = card_label()
    cache = enable_compilation_cache()
    log(f"device: {dev.device_kind}, {len(jax.devices())} device(s); compile cache {cache}")
    log(card)  # nvidia-smi: name, power limit

    if args.four_cards:
        phase_four_cards(card)
    else:
        peaks = peaks_for(dev.device_kind)
        pts, path = load_reference()
        phase_node(card, pts, path)
        phase_step(card, peaks, pts, path)
        phase_step(card, peaks, *big_workload(BIG_N))
        phase_occlusion(card, pts, path)
        phase_rig(card, pts, path)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
