"""Processing nodes: the reference's ROS node layer on the scene bus.

Each node mirrors one reference process (SURVEY.md §2 #16-18, #21-22):

  * :class:`TrajOptNode`   — `src/trajectory_optimization.py`: pair
    (cloud, path), optimize the trajectory with early stopping, publish the
    optimized path (+ optional rewards cloud).
  * :class:`PoseOptNode`   — `src/pose_optimization.py`: pair (cloud, pose),
    optimize a single camera pose, publishing odometry/TF/camera-info and a
    rewards cloud ~num_pub_samples times during the loop.
  * :class:`PointsProcessorNode` — `src/pc_processor.py`: per camera-info,
    transform the cloud into the camera frame via the frame graph, hard
    frustum-cull, HPR, publish both subsets and a rendered image.
  * :class:`CloudFeederNode` / :class:`PoseFeederNode` — `src/pc_publisher.py`
    / `src/pose_publisher.py`: replay npz clouds / (random) poses.
  * :class:`VoxelFilterNode` — the PCL VoxelGrid nodelet's role
    (`launch/voxels_filtering.launch`).

Device work happens inside the nodes through the jitted engine; cloud sizes
are bucketed (utils.data) so repeated messages hit the compile cache.
"""
from __future__ import annotations

import functools
import os
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from trajectory_optimization_tpu.bus.core import ApproximateTimeSynchronizer, Bus
from trajectory_optimization_tpu.bus.frames import FrameGraph
from trajectory_optimization_tpu.bus.messages import (
    CameraInfoMsg,
    CloudMsg,
    Header,
    ImageMsg,
    OdometryMsg,
    PathMsg,
    PoseMsg,
    TransformMsg,
)
from trajectory_optimization_tpu.models.pose import PoseProblem, init_pose_params
from trajectory_optimization_tpu.models.traj import (
    TrajProblem,
    init_traj_params,
    waypoint_stride,
)
from trajectory_optimization_tpu.opt.engine import EarlyStop, OptimizerConfig
from trajectory_optimization_tpu.utils.config import (
    CloudFeederConfig,
    PointsProcessorConfig,
    PoseFeederConfig,
    PoseOptNodeConfig,
    TrajOptNodeConfig,
    VoxelFilterConfig,
)
from trajectory_optimization_tpu.utils.data import pad_points
from trajectory_optimization_tpu.utils.intrinsics import CameraIntrinsics, default_intrinsics
from trajectory_optimization_tpu.utils.profiling import Metrics


class TrajOptNode:
    """Trajectory optimizer node (`src/trajectory_optimization.py:25-158`)."""

    def __init__(self, bus: Bus, cfg: TrajOptNodeConfig, intrinsics: Optional[CameraIntrinsics] = None):
        self.bus = bus
        self.cfg = cfg
        self.intr = intrinsics or default_intrinsics()
        self.last_result: Optional[Dict] = None
        self.metrics = Metrics()  # callbacks, iters, per-callback ms — the
        # reference's per-step prints (`src/trajectory_optimization.py:126`)
        self._pending = []  # in-flight (dispatched, not yet published) results
        self._sync = ApproximateTimeSynchronizer(
            bus, [cfg.pc_topic, cfg.path_topic], self.callback, queue_size=10, slop=0.5
        )

    def callback(self, pc_msg: CloudMsg, path_msg: PathMsg) -> None:
        """Dispatch this pair's optimization, then publish finished results.

        With cfg.pipeline_depth == 1 (default, the reference's synchronous
        semantics) each callback publishes its own result before returning.
        Depth d > 1 keeps up to d-1 messages in flight: JAX dispatch is
        async and the result leaves start a `copy_to_host_async` at dispatch
        time, so message i's device execution and device→host transfer
        overlap message i+1's decode and upload. Outputs then lag their
        inputs by up to d-1 messages; call flush() to drain.
        """
        self._pending.append(self._dispatch(pc_msg, path_msg))
        while len(self._pending) >= max(int(self.cfg.pipeline_depth), 1):
            self._finish(self._pending.pop(0))

    def flush(self) -> None:
        """Publish every in-flight result (pipeline_depth > 1)."""
        while self._pending:
            self._finish(self._pending.pop(0))

    def _dispatch(self, pc_msg: CloudMsg, path_msg: PathMsg):
        _t0 = time.perf_counter()
        cfg = self.cfg
        points, valid = pad_points(pc_msg.xyz.astype(np.float32))
        poses0 = path_msg.positions.astype(np.float32)
        quats0 = path_msg.orientations_wxyz.astype(np.float32)

        problem = TrajProblem(
            img_width=self.intr.width,
            img_height=self.intr.height,
            min_dist=cfg.min_dist,
            max_dist=cfg.max_dist,
            smoothness_weight=cfg.smooth_weight,
            length_weight=cfg.length_weight,
            wps_step=waypoint_stride(poses0, cfg.vis_wps_dist),
            soft_hpr=cfg.use_soft_hpr,
        )
        P, V = jnp.asarray(points), jnp.asarray(valid)
        K = self.intr.matrix()
        p0, q0 = jnp.asarray(poses0), jnp.asarray(quats0)

        # cached runner: compiles once per (problem, config, shape bucket),
        # then every subsequent message reuses the executable
        from trajectory_optimization_tpu.opt.runners import traj_runner

        run = traj_runner(
            problem,
            OptimizerConfig(lr_pose=cfg.lr_pose, lr_quat=cfg.lr_quat),
            EarlyStop(rewards_th=cfg.rewards_th, smoothness_th=cfg.smoothness_th),
            cfg.opt_steps,
        )
        params = init_traj_params(poses0, quats0)
        params, n_iters, loss, aux = run(params, P, V, K, p0, q0)
        leaves = {
            "poses": params["poses"],
            "quats": params["quats"],
            "n_iters": n_iters,
            "loss": loss,
            "rewards": aux["rewards"],
            "mean_reward": aux["mean_reward"],
            "reward0": aux["reward0"],  # step-0 terms, from the same executable
            "smooth0": aux["smooth0"],
        }
        # start the device→host copies now so that, under pipelining, they
        # overlap the next message's decode/upload
        for v in leaves.values():
            if hasattr(v, "copy_to_host_async"):
                v.copy_to_host_async()
        # record the dispatch-side processing cost now: under pipelining this
        # result may sit queued across messages, and wall time from _t0 at
        # _finish would measure message cadence, not work
        return leaves, pc_msg, path_msg, (time.perf_counter() - _t0) * 1e3

    def _finish(self, pending) -> None:
        leaves, pc_msg, path_msg, dispatch_ms = pending
        _t1 = time.perf_counter()
        cfg = self.cfg
        # one batched device→host fetch for the values this callback needs
        fetched = jax.device_get(leaves)
        n_iters, loss = int(fetched["n_iters"]), float(fetched["loss"])

        # optimized path out, wxyz → xyzw with normalization
        # (`src/trajectory_optimization.py:141-145`)
        poses_out = np.asarray(fetched["poses"], np.float64)
        quats = np.asarray(fetched["quats"], np.float64)
        quats = quats / np.linalg.norm(quats, axis=1, keepdims=True)
        quats_xyzw = np.concatenate([quats[:, 1:], quats[:, :1]], axis=1)
        self.bus.publish(
            cfg.path_topic + "/optimized",
            PathMsg(Header.make(path_msg.header.frame_id), poses_out, quats_xyzw),
        )

        if cfg.publish_rewards_cloud:
            rewards = np.asarray(fetched["rewards"])[: len(pc_msg.xyz)]
            cloud = np.concatenate(
                [pc_msg.xyz, rewards[:, None].astype(np.float32)], axis=1
            )
            self.bus.publish(
                cfg.pc_topic + "/rewards",
                CloudMsg(Header.make(pc_msg.header.frame_id), cloud),
            )

        self.last_result = {
            "n_iters": n_iters,
            "loss": loss,
            "mean_reward": float(fetched["mean_reward"]),
            "mean_reward0": float(fetched["reward0"]),
            "loss_smooth0": float(fetched["smooth0"]),
        }
        self.metrics.incr("callbacks")
        self.metrics.incr("opt_iters", n_iters)
        # dispatch cost + finish cost, EXCLUDING any pipelined queue wait
        self.metrics.gauge(
            "last_callback_ms", dispatch_ms + (time.perf_counter() - _t1) * 1e3
        )
        self.metrics.gauge("last_loss", loss)
        self.metrics.gauge("last_mean_reward", float(fetched["mean_reward"]))

    def close(self):
        self.flush()
        self._sync.close()


class PoseOptNode:
    """Single-pose optimizer node (`src/pose_optimization.py:31-147`)."""

    def __init__(self, bus: Bus, cfg: PoseOptNodeConfig, intrinsics: Optional[CameraIntrinsics] = None):
        self.bus = bus
        self.cfg = cfg
        self.intr = intrinsics or default_intrinsics()
        self.frames = FrameGraph()
        self.last_result: Optional[Dict] = None
        self.metrics = Metrics()  # reference prints step ms, `src/pose_optimization.py:145`
        self._sync = ApproximateTimeSynchronizer(
            bus, [cfg.pc_topic, cfg.pose_topic], self.callback, queue_size=10, slop=0.5
        )

    def callback(self, pc_msg: CloudMsg, pose_msg: PoseMsg) -> None:
        _t0 = time.perf_counter()
        cfg = self.cfg
        points, valid = pad_points(pc_msg.xyz.astype(np.float32))
        problem = PoseProblem(
            img_width=self.intr.width,
            img_height=self.intr.height,
            min_dist=cfg.min_dist,
            max_dist=cfg.max_dist,
            soft_hpr=cfg.use_soft_hpr,
        )
        P, V, K = jnp.asarray(points), jnp.asarray(valid), self.intr.matrix()

        occlusion = None
        if cfg.use_hpr:
            # the reference recomputes HPR on detached world points every step
            # (`src/model.py:112-115`); constant during the loop ⇒ once here.
            # Run on the bucket-padded cloud (valid-masked) so the HPR jit
            # cache keys on bucket sizes, not per-message sizes
            from trajectory_optimization_tpu.ops.hpr import hpr_mask_approx

            occlusion = hpr_mask_approx(P, valid=V)

        # cached segmented runner (compile once per shape bucket; see runners)
        from trajectory_optimization_tpu.opt.runners import pose_runner

        seg = max(cfg.opt_steps // cfg.num_pub_samples, 1)
        opt_cfg = OptimizerConfig(lr_pose=cfg.lr_pose, lr_quat=cfg.lr_quat)
        init_opt, advance = pose_runner(problem, opt_cfg, seg)
        params = init_pose_params(
            pose_msg.position.astype(np.float32)[None],
            pose_msg.orientation_wxyz.astype(np.float32)[None],
        )
        opt_state = init_opt(params)
        loss, aux = jnp.asarray(jnp.inf), {"observations": jnp.zeros(len(points))}
        done = 0
        # Enqueue ALL segments first (JAX dispatch is async; the runner does
        # not donate, so chaining segments before fetching is safe), starting
        # each segment's device→host copies as it is enqueued. The publishes
        # then stream below as segment results land, instead of stalling the
        # device once per publish.
        pend = []

        def _enqueue(params, aux):
            fetch = {
                "trans": params["trans"],
                "quat": params["quat"],
                "observations": aux["observations"],
            }
            for v in fetch.values():
                if hasattr(v, "copy_to_host_async"):
                    v.copy_to_host_async()
            pend.append(fetch)

        while done + seg <= cfg.opt_steps:
            params, opt_state, loss, aux = advance(params, opt_state, P, V, K, occlusion)
            done += seg
            _enqueue(params, aux)
        if done < cfg.opt_steps:  # exact step-count parity for the remainder
            _, advance_rem = pose_runner(problem, opt_cfg, cfg.opt_steps - done)
            params, opt_state, loss, aux = advance_rem(params, opt_state, P, V, K, occlusion)
            done = cfg.opt_steps
            _enqueue(params, aux)
        for fetch in pend:
            self._publish(pc_msg, pose_msg, fetch)
        loss_f = float(loss)  # fetch the scalar once
        self.last_result = {"loss": loss_f, "n_iters": done}
        self.metrics.incr("callbacks")
        self.metrics.incr("opt_iters", done)
        self.metrics.gauge("last_callback_ms", (time.perf_counter() - _t0) * 1e3)
        self.metrics.gauge("last_loss", loss_f)

    def _publish(self, pc_msg, pose_msg, fetch):
        # odometry + TF + camera info (`src/pose_optimization.py:99-112`).
        # One batched fetch per publish (the copies were already started by
        # _enqueue, so this mostly just waits)
        fetched = jax.device_get(fetch)
        trans = np.asarray(fetched["trans"], np.float64).reshape(3)
        q = np.asarray(fetched["quat"], np.float64).reshape(4)
        q = q / np.linalg.norm(q)
        q_xyzw = np.array([q[1], q[2], q[3], q[0]])
        frame = pose_msg.header.frame_id
        self.bus.publish("/odom", OdometryMsg(Header.make(frame), trans, q_xyzw))
        self.frames.set_transform(frame, "camera_frame", trans, q_xyzw)
        self.bus.publish(
            "/tf", TransformMsg(Header.make(frame), "camera_frame", trans, q_xyzw)
        )
        self.bus.publish(
            "/camera/camera_info",
            CameraInfoMsg(
                Header.make("camera_frame"),
                int(self.intr.width),
                int(self.intr.height),
                K=tuple(self.intr.matrix_np(np.float64).reshape(-1)),
                D=tuple(self.intr.distortion),
            ),
        )
        if self.cfg.publish_rewards_cloud:
            obs = np.asarray(fetched["observations"])[: len(pc_msg.xyz)]
            cloud = np.concatenate([pc_msg.xyz, obs[:, None].astype(np.float32)], axis=1)
            self.bus.publish(
                self.cfg.pc_topic + "/rewards",
                CloudMsg(Header.make(pc_msg.header.frame_id), cloud),
            )

    def close(self):
        self._sync.close()


def _hpr_mask_bucketed(culled: np.ndarray) -> np.ndarray:
    """Approx-HPR visible mask for a ragged culled subset, computed on a
    bucket-padded cloud so the HPR jit cache keys on O(log N) bucket sizes
    instead of every distinct culled size (the per-message recompile trap)."""
    from trajectory_optimization_tpu.ops.hpr import hpr_mask_approx

    if len(culled) == 0:
        return np.zeros(0, bool)
    padded, valid = pad_points(culled.astype(np.float32))
    m = hpr_mask_approx(jnp.asarray(padded), valid=jnp.asarray(valid))
    return np.asarray(m)[: len(culled)] > 0.5


@functools.partial(
    jax.jit, static_argnames=("img_w", "img_h", "min_dist", "max_dist")
)
def _rig_cull_and_transform(pts, valid, Q, T, K, *, img_w, img_h, min_dist, max_dist):
    """One fused dispatch for the whole rig: (C, N) frustum masks AND the
    (C, N, 3) camera-frame points (separate calls paid two device round
    trips per cloud). ``pts`` must be bucket-padded (valid-masked) so the
    jit cache keys on bucket sizes."""
    from trajectory_optimization_tpu.ops.geometry import to_camera_frame
    from trajectory_optimization_tpu.ops.multicam import multicam_frustum_masks

    masks = multicam_frustum_masks(
        pts, Q, T, K, img_w, img_h, min_dist=min_dist, max_dist=max_dist
    )
    masks = masks & (valid[None, :] > 0)
    return masks, to_camera_frame(pts, Q, T)


def _hpr_masks_rig(culled_list) -> list:
    """Approx-HPR masks for a whole rig in ONE vmapped evaluation: every
    camera's culled subset is padded to the same bucket and the pursuit runs
    with a leading camera axis — C cameras cost one dispatch (SURVEY.md §2c
    multi-camera axis), with the same valid-mask semantics as the serial
    path."""
    from trajectory_optimization_tpu.ops.hpr import hpr_mask_approx
    from trajectory_optimization_tpu.utils.data import bucket_size

    sizes = [len(c) for c in culled_list]
    if max(sizes, default=0) == 0:
        return [np.zeros(0, bool) for _ in culled_list]
    bucket = bucket_size(max(sizes))
    padded, valids = zip(*(pad_points(c.astype(np.float32), target=bucket)
                           for c in culled_list))
    masks = jax.vmap(lambda p, v: hpr_mask_approx(p, valid=v))(
        jnp.asarray(np.stack(padded)), jnp.asarray(np.stack(valids))
    )
    masks = np.asarray(masks)
    return [masks[i, : sizes[i]] > 0.5 for i in range(len(culled_list))]


class PointsProcessorNode:
    """Multi-camera visibility processor (`src/pc_processor.py:30-197`)."""

    def __init__(self, bus: Bus, cfg: PointsProcessorConfig, frames: Optional[FrameGraph] = None):
        self.bus = bus
        self.cfg = cfg
        self.frames = frames or FrameGraph()
        self._cloud: Optional[CloudMsg] = None
        self._pending: Dict[str, CameraInfoMsg] = {}  # topic → info since cloud
        self.metrics = Metrics()
        self.n_batched = 0  # fused rig evaluations (observability/tests)
        self.n_serial = 0
        self.frames.listen(bus, cfg.tf_topics)  # tf.TransformListener role
        bus.subscribe(cfg.pc_topic, self._pc_callback)
        for t in cfg.cam_info_topics:
            bus.subscribe(t, self._make_info_cb(t))

    def _pc_callback(self, msg: CloudMsg):
        # flush a partial rig against the outgoing cloud so a dead camera
        # topic can only delay processing by one cloud period
        if self._cloud is not None and self._pending:
            self._flush()
        self._cloud = msg
        self._pending = {}

    def _make_info_cb(self, topic: str):
        def cb(info: CameraInfoMsg):
            if self._cloud is None:
                return
            if len(self.cfg.cam_info_topics) == 1:
                self.n_serial += 1
                self.process(self._cloud, info)
                return
            self._pending[topic] = info
            if len(self._pending) == len(self.cfg.cam_info_topics):
                self._flush()

        return cb

    def _flush(self):
        """Process the collected rig infos against the current cloud: one
        fused evaluation when the rig shares intrinsics (the default for the
        reference's six-camera robot, `src/pc_processor.py:33-39`), serial
        per-camera otherwise."""
        infos = [self._pending[t] for t in self.cfg.cam_info_topics if t in self._pending]
        self._pending = {}
        if not infos:
            return
        keys = {(i.K, i.width, i.height) for i in infos}
        _t0 = time.perf_counter()
        if len(infos) > 1 and len(keys) == 1:
            self.n_batched += 1
            self.metrics.incr("rig_batched")
            self.process_all(self._cloud, infos)
        else:
            self.n_serial += len(infos)
            self.metrics.incr("rig_serial", len(infos))
            for info in infos:
                self.process(self._cloud, info)
        self.metrics.gauge("last_rig_ms", (time.perf_counter() - _t0) * 1e3)

    def process(self, cloud: CloudMsg, info: CameraInfoMsg):
        from trajectory_optimization_tpu.ops.geometry import compact_masked, frustum_cull
        from trajectory_optimization_tpu.ops.hpr import hpr_points_exact

        cam_frame = info.header.frame_id
        intr = info.intrinsics()
        # cloud frame → camera frame through the frame graph
        # (`src/pc_processor.py:161-168`)
        cam_pts = self.frames.transform_points(
            cloud.xyz.astype(np.float64), cam_frame, cloud.header.frame_id
        ).astype(np.float32)

        mask, _, _ = frustum_cull(
            jnp.asarray(cam_pts),
            intr.matrix(),
            intr.width,
            intr.height,
            min_dist=self.cfg.frustum_min_dist,
            max_dist=self.cfg.frustum_max_dist,
        )
        culled = compact_masked(cam_pts, mask)
        out_topic = f"/{cam_frame}/pointcloud"
        self.bus.publish(out_topic, CloudMsg(Header.make(cam_frame), culled))

        if self.cfg.hpr_backend == "exact":
            visible, _ = hpr_points_exact(culled)
        elif self.cfg.hpr_backend == "approx":
            visible = culled[_hpr_mask_bucketed(culled)]
        else:
            visible = culled
        self.bus.publish(out_topic + "_visible", CloudMsg(Header.make(cam_frame), visible))

        if self.cfg.render and len(visible):
            self._render(visible, intr, cam_frame)
        return visible

    def _render(self, visible, intr, cam_frame):
        """Render ``visible`` with ops.render.render_point_cloud and publish.

        The input is bucket-padded (valid-masked) so the renderer's jit
        cache keys on O(log N) bucket sizes: visible counts change every
        message in a moving-robot replay, and compiling per exact count
        would recompile on nearly every message.

        The image is published as a device array, NOT copied to the host:
        consumers that need pixels np.asarray the payload and pay the
        transfer only then.
        """
        from trajectory_optimization_tpu.ops.render import render_point_cloud

        padded, pvalid = pad_points(np.asarray(visible, np.float32))
        img = render_point_cloud(
            jnp.asarray(padded),
            intr.matrix(),
            int(intr.height),
            int(intr.width),
            znear=self.cfg.frustum_min_dist,
            zfar=self.cfg.frustum_max_dist,
            valid=jnp.asarray(pvalid),
        )
        self.bus.publish(
            f"/{cam_frame}/pointcloud_image",
            ImageMsg(Header.make(cam_frame), img, encoding="rgb32f"),
        )

    def process_all(self, cloud: CloudMsg, infos):
        """Batched multi-camera processing: one fused evaluation for all
        cameras sharing intrinsics (the reference handles its six cameras
        serially, `src/pc_processor.py:139-197`; SURVEY.md §2c asks for a
        vmapped camera axis). Returns {cam_frame: visible_points}.
        """
        import numpy as _np

        from trajectory_optimization_tpu.ops.geometry import compact_masked

        infos = list(infos)
        intr = infos[0].intrinsics()
        # camera poses in the cloud frame, from the frame graph
        quats, trans = [], []
        for info in infos:
            t, q_xyzw = self.frames.lookup(cloud.header.frame_id, info.header.frame_id)
            trans.append(t)
            quats.append([q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]])  # wxyz
        n = len(cloud.xyz)
        padded, valid = pad_points(cloud.xyz.astype(np.float32))
        Q = jnp.asarray(_np.asarray(quats, _np.float32))
        T = jnp.asarray(_np.asarray(trans, _np.float32))
        # one fused dispatch: (C, N) masks + (C, N, 3) camera-frame points,
        # bucket-padded so the compile cache keys on bucket sizes
        masks, cam_pts_all = jax.device_get(
            _rig_cull_and_transform(
                jnp.asarray(padded),
                jnp.asarray(valid),
                Q,
                T,
                intr.matrix(),
                img_w=float(intr.width),
                img_h=float(intr.height),
                min_dist=self.cfg.frustum_min_dist,
                max_dist=self.cfg.frustum_max_dist,
            )
        )
        culled_all = [
            compact_masked(cam_pts_all[c][:n], masks[c][:n]) for c in range(len(infos))
        ]
        if self.cfg.hpr_backend == "approx":
            hpr_masks = _hpr_masks_rig(culled_all)  # one vmapped HPR for the rig
        out = {}
        for c, info in enumerate(infos):
            cam_frame = info.header.frame_id
            culled = culled_all[c]
            self.bus.publish(f"/{cam_frame}/pointcloud", CloudMsg(Header.make(cam_frame), culled))
            if self.cfg.hpr_backend == "exact":
                from trajectory_optimization_tpu.ops.hpr import hpr_points_exact

                visible, _ = hpr_points_exact(culled)
            elif self.cfg.hpr_backend == "approx" and len(culled):
                visible = culled[hpr_masks[c]]
            else:
                visible = culled
            self.bus.publish(
                f"/{cam_frame}/pointcloud_visible", CloudMsg(Header.make(cam_frame), visible)
            )
            if self.cfg.render and len(visible):
                self._render(visible, intr, cam_frame)
            out[cam_frame] = visible
        return out


class CloudFeederNode:
    """npz cloud replay (`src/pc_publisher.py`). Call tick() at the configured
    rate (launch.spin does this), or drive manually in tests."""

    def __init__(self, bus: Bus, cfg: CloudFeederConfig, rng: Optional[np.random.Generator] = None):
        self.bus = bus
        self.cfg = cfg
        self.rng = rng or np.random.default_rng()

    def tick(self):
        from trajectory_optimization_tpu.utils.data import load_point_cloud

        idx = self.cfg.pc_index
        if idx == -1:
            idx = int(self.rng.integers(0, 30))
        path = os.path.join(self.cfg.data_dir, f"point_cloud_{idx}.npz")
        pts = load_point_cloud(path)
        self.bus.publish(self.cfg.output_topic, CloudMsg(Header.make(self.cfg.frame_id), pts))


class PoseFeederNode:
    """Random-or-fixed pose feeder (`src/pose_publisher.py`)."""

    def __init__(self, bus: Bus, cfg: PoseFeederConfig, rng: Optional[np.random.Generator] = None):
        self.bus = bus
        self.cfg = cfg
        self.rng = rng or np.random.default_rng()

    def tick(self):
        # host-only math: a JAX dispatch here would stamp this message tens of
        # seconds after the cloud on first use (device init), breaking pairing
        from trajectory_optimization_tpu.ops.quat import from_euler_np

        c = self.cfg
        pos = np.array(
            [
                c.x if c.x is not None else self.rng.random() * 5 + 15,
                c.y if c.y is not None else self.rng.random() * 5 + 15,
                c.z if c.z is not None else self.rng.random() * 2,
            ]
        )
        rpy = [
            c.roll if c.roll is not None else self.rng.random() * np.pi,
            c.pitch if c.pitch is not None else self.rng.random() * np.pi,
            c.yaw if c.yaw is not None else self.rng.random() * np.pi,
        ]
        q_wxyz = from_euler_np(*rpy)
        q_xyzw = np.concatenate([q_wxyz[1:], q_wxyz[:1]])
        self.bus.publish(
            c.output_topic, PoseMsg(Header.make(c.frame_id), pos, q_xyzw)
        )


class VoxelFilterNode:
    """Voxel-grid downsampling filter (the PCL VoxelGrid nodelet's role,
    `launch/voxels_filtering.launch:8-21`). Uses the native C++ filter when
    built, NumPy otherwise."""

    def __init__(self, bus: Bus, cfg: VoxelFilterConfig):
        self.bus = bus
        self.cfg = cfg
        bus.subscribe(cfg.input_topic, self.callback)

    def callback(self, msg: CloudMsg):
        from trajectory_optimization_tpu.native import voxel_downsample_native

        out = voxel_downsample_native(
            msg.points, self.cfg.leaf_size, z_limits=self.cfg.z_limits
        )
        self.bus.publish(self.cfg.output_topic, CloudMsg(msg.header, out))
