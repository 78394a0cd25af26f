#!/usr/bin/env python
"""Offline scene visualization — the rviz-substitute.

The reference ships seven .rviz view configs; headless accelerator hosts have no
rviz, so this renders the same views to PNG: the point cloud colored by the
rewards/intensity channel, the initial and optimized trajectories, and the
camera frusta. Consumes live bus topics or runs standalone on the sample
data.

Run: python demos/visualize.py [out=scene.png] [pc_index=10]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def plot_scene(
    points: np.ndarray,
    rewards: np.ndarray = None,
    paths: dict = None,
    out: str = "scene.png",
    elev: float = 35.0,
    azim: float = -60.0,
):
    """Save a 3D scatter of the cloud (+reward colors) and trajectories."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 9))
    ax = fig.add_subplot(111, projection="3d")
    sub = points[:: max(len(points) // 20000, 1)]
    c = None
    if rewards is not None:
        c = rewards[:: max(len(points) // 20000, 1)]
    sc = ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=1, c=c, cmap="viridis")
    if rewards is not None:
        fig.colorbar(sc, ax=ax, shrink=0.6, label="reward / intensity")
    for name, (poses, style) in (paths or {}).items():
        ax.plot(poses[:, 0], poses[:, 1], poses[:, 2], style, label=name, linewidth=2)
    if paths:
        ax.legend()
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x [m]"), ax.set_ylabel("y [m]"), ax.set_zlabel("z [m]")
    fig.tight_layout()
    fig.savefig(out, dpi=90)
    plt.close(fig)
    return out


def rendered_vs_real(
    frames,
    cloud_world: np.ndarray,
    cloud_frame: str,
    camera_frame: str,
    K,
    real_img: np.ndarray,
    *,
    time: float = None,
    znear: float = 1.0,
    zfar: float = 10.0,
    out: str = None,
):
    """The paper's qualitative evaluation: render the cloud from a camera's
    TF pose and put it beside the real (decoded) camera frame.

    The reference does this manually in rviz with the six
    `/viz/camera_*/image/compressed` streams (`src/pc_processor.py:190-197`
    renders; the bag supplies the real frames). Here the camera pose comes
    from the live :class:`bus.frames.FrameGraph` (TF), the real frame from
    the from-spec JPEG decoder, and the render from ops.render — end to end
    through this framework's own machinery.

    Returns (side_by_side_uint8, ncc): the concatenated image and the
    zero-mean normalized cross-correlation of the grayscale pair (1.0 =
    identical; real-vs-splat typically lands well below). When ``out`` is
    given the pair is written as PNG with the framework's own encoder.
    """
    import jax.numpy as jnp

    from trajectory_optimization_tpu.bus.png import encode_png
    from trajectory_optimization_tpu.ops.render import render_point_cloud

    h, w = real_img.shape[:2]
    cam_pts = frames.transform_points(
        np.asarray(cloud_world, np.float32), camera_frame, cloud_frame, time)
    img = render_point_cloud(
        jnp.asarray(cam_pts), jnp.asarray(np.asarray(K, np.float32)),
        int(h), int(w), znear=znear, zfar=zfar)
    rendered = np.asarray(
        np.clip(np.asarray(img) * 255.0, 0, 255)).astype(np.uint8)
    if real_img.ndim == 2:
        real_rgb = np.repeat(real_img[:, :, None], 3, axis=2)
    else:
        real_rgb = real_img[:, :, :3]
    side = np.concatenate([real_rgb, rendered], axis=1)
    a = real_rgb.mean(axis=2).astype(np.float64)
    b = rendered.mean(axis=2).astype(np.float64)
    a -= a.mean()
    b -= b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    ncc = float((a * b).sum() / denom) if denom > 0 else 0.0
    if out:
        with open(out, "wb") as f:
            f.write(encode_png(side))
    return side, ncc


def main(argv=None):
    from trajectory_optimization_tpu.bus.launch import enable_compilation_cache

    enable_compilation_cache()  # repeat runs reload executables

    import jax.numpy as jnp

    from trajectory_optimization_tpu.models.traj import (
        TrajProblem, init_traj_params, traj_forward, waypoint_stride,
    )
    from trajectory_optimization_tpu.opt.engine import OptimizerConfig, optimize_with_history
    from trajectory_optimization_tpu.utils.data import identity_quaternions, load_path, load_point_cloud
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:]))
    index = int(args.get("pc_index", 10))
    here = os.path.dirname(os.path.abspath(__file__))
    out = args.get("out", os.path.join(here, "scene.png"))

    pts = load_point_cloud(os.path.join(here, "..", "data", "points", f"point_cloud_{index}.npz"))
    path = load_path(os.path.join(here, "..", "data", "paths", f"path_poses_{index}.npz"))
    quats = identity_quaternions(len(path))
    intr = default_intrinsics()
    prob = TrajProblem(img_width=intr.width, img_height=intr.height,
                       wps_step=waypoint_stride(path, 0.5))
    P, K = jnp.asarray(pts), intr.matrix()

    def loss_fn(p):
        return traj_forward(p, P, K, jnp.asarray(path), jnp.asarray(quats), prob)

    params, _ = optimize_with_history(
        loss_fn, init_traj_params(path, quats),
        OptimizerConfig(lr_pose=0.1, lr_quat=0.02), int(args.get("opt_steps", 100)),
    )
    _, aux = loss_fn(params)
    plot_scene(
        pts,
        rewards=np.asarray(aux["rewards"]),
        paths={
            "initial": (path, "r--"),
            "optimized": (np.asarray(params["poses"]), "b-"),
        },
        out=out,
    )
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
