#!/usr/bin/env python
"""Offline single-pose optimization demo.

Parity with the reference `src/pose_optimization_sample.py`: load cloud 10,
random initial orientation, trans0 = (6, 2, 0); Adam with per-group LRs and
ExponentialLR(0.95) stepped every N/10 iterations; publish the rewards cloud
and camera odometry to the scene bus every `pub_sample` iterations; print
mean optimization and publication times.

Run: python demos/pose_optimization_demo.py [opt_steps=400] [lr_pose=0.1] ...
Pass ``soft_hpr=1`` for occlusion-aware optimization: differentiable Katz
HPR *inside* the loss (the reference's own TODO — its Qhull HPR runs on
detached tensors and cannot be differentiated).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main(argv=None):
    from trajectory_optimization_tpu.bus.launch import enable_compilation_cache

    enable_compilation_cache()  # repeat runs reload executables

    from trajectory_optimization_tpu.bus.core import Bus
    from trajectory_optimization_tpu.bus.messages import CloudMsg, Header, OdometryMsg
    from trajectory_optimization_tpu.models.pose import PoseProblem, init_pose_params, pose_forward
    from trajectory_optimization_tpu.opt.engine import OptimizerConfig, OptimizerLoop
    from trajectory_optimization_tpu.ops import quat as quat_ops
    from trajectory_optimization_tpu.utils.data import load_point_cloud
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    # knobs (reference `src/pose_optimization_sample.py:29-32`)
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:]))
    pub_sample = int(args.get("pub_sample", 10))
    n_steps = int(args.get("opt_steps", 400))
    lr_pose = float(args.get("lr_pose", 0.1))
    lr_quat = float(args.get("lr_quat", 0.1))
    index = int(args.get("pc_index", 10))

    here = os.path.dirname(os.path.abspath(__file__))
    pts_np = load_point_cloud(os.path.join(here, "..", "data", "points", f"point_cloud_{index}.npz"))
    intr = default_intrinsics()

    trans0 = np.array([[6.0, 2.0, 0.0]], np.float32)
    q0 = np.asarray(quat_ops.random(jax.random.PRNGKey(int(args.get("seed", 0))), 1))

    problem = PoseProblem(
        img_width=intr.width, img_height=intr.height, min_dist=1.0, max_dist=5.0,
        soft_hpr=bool(int(args.get("soft_hpr", 0))),
    )
    P, K = jnp.asarray(pts_np), intr.matrix()

    def loss_fn(params):
        loss, aux = pose_forward(params, P, K, problem)
        return loss, aux

    loop = OptimizerLoop(
        loss_fn,
        init_pose_params(trans0, q0),
        OptimizerConfig(lr_pose=lr_pose, lr_quat=lr_quat, decay_gamma=0.95,
                        decay_every=max(n_steps // 10, 1)),
        pose_key="trans",
        quat_key="quat",
    )

    bus = Bus()
    t_step, t_pub, done = 0.0, 0.0, 0
    while done < n_steps:
        t0 = time.perf_counter()
        n = min(pub_sample, n_steps - done)
        loss, aux = loop.run(n)
        np.asarray(loop.params["trans"])  # true device sync
        done += n
        t_step += time.perf_counter() - t0

        t2 = time.perf_counter()
        obs = np.asarray(aux["observations"])
        bus.publish("/pts", CloudMsg(Header.make("world"),
                                     np.concatenate([pts_np, obs[:, None]], axis=1)))
        trans = np.asarray(loop.params["trans"], np.float64).reshape(3)
        q = np.asarray(loop.params["quat"], np.float64).reshape(4)
        q = q / np.linalg.norm(q)
        bus.publish("/odom", OdometryMsg(Header.make("world"), trans,
                                         np.array([q[1], q[2], q[3], q[0]])))
        t_pub += time.perf_counter() - t2

    print(f"final loss: {float(loss):.6f}, visible score sum: {float(obs.sum()):.1f}")
    print(f"Mean optimization time: {1000 * t_step / n_steps} msec")
    print(f"Mean publication time: {1000 * t_pub / (n_steps / pub_sample)} msec")
    return float(loss)


if __name__ == "__main__":
    main()
