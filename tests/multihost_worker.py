"""Subprocess worker for the real multi-process multihost tests.

Launched (not imported) by tests/test_multihost_process.py, twice, with
argv = [pid, nproc, port, outdir, mode]. Each process owns 2 virtual CPU
devices; together they form the 4-device ('wps'=1, 'pts'=4) multihost mesh
that parallel.multihost builds over the distributed runtime, with
cross-process collectives riding Gloo — the CPU stand-in for NCCL.

mode='traj': N full sharded train steps (the multi-device path,
parallel.sharded.make_sharded_train_step) on per-process cloud slices
assembled via shard_points_multihost, then process 0 saves the final params
next to a single-device ground truth computed from the full cloud
(models.traj.traj_forward + the same optimizer) for the parent test to
compare.

mode='pose': the occlusion-aware sharded pose loss+step
(parallel.pose_sharded) — its differentiable binned-HPR candidate
exchange is an all_gather per grid, here genuinely crossing processes
over Gloo. Process 0 saves the sharded init loss next to the single-chip
pose_forward(soft_hpr=True) loss, plus two Adam steps' losses.
"""
import os
import sys


def _pose_phase(pid: int, nproc: int, mesh, outdir: str) -> None:
    """Occlusion-aware sharded pose step across processes (mode='pose')."""
    import jax.numpy as jnp
    import numpy as np

    from trajectory_optimization_tpu.models.pose import (
        PoseProblem,
        init_pose_params,
        pose_forward,
    )
    from trajectory_optimization_tpu.opt.engine import OptimizerConfig
    from trajectory_optimization_tpu.parallel.multihost import (
        shard_points_multihost,
    )
    from trajectory_optimization_tpu.parallel.pose_sharded import (
        make_sharded_pose_step,
        pose_loss_sharded,
    )
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    n_pts = 4096
    rng = np.random.default_rng(11)
    full = rng.uniform(-8.0, 8.0, size=(n_pts, 3)).astype(np.float32)
    full[:, 2] += 6.0  # in front of the initial camera
    n_local = n_pts // nproc
    local = full[pid * n_local : (pid + 1) * n_local]
    pts, valid = shard_points_multihost(mesh, local, np.ones(n_local, np.float32))

    intr = default_intrinsics()
    # soft_hpr_dense_max=0: the single-chip reference must route through
    # the binned kernel (the tier _local_mask shards) even at this small N,
    # with the same default cap — else it compares the O(N^2) relaxation
    prob = PoseProblem(img_width=intr.width, img_height=intr.height,
                       min_dist=1.0, max_dist=12.0, soft_hpr=True,
                       soft_hpr_dense_max=0)
    K = intr.matrix()
    params = init_pose_params(jnp.zeros(3), jnp.asarray([1.0, 0.0, 0.0, 0.0]))

    # init-loss parity vs the single-chip soft-HPR pose loss — the
    # candidate exchange underneath is an all_gather that here REALLY
    # crosses processes over Gloo
    loss0, _ = pose_loss_sharded(mesh, params, pts, valid, K, prob)
    loss0 = float(loss0)

    init_fn, step_fn = make_sharded_pose_step(
        mesh, prob, OptimizerConfig(lr_pose=0.05, lr_quat=0.02))
    opt_state = init_fn(params)
    losses = []
    for _ in range(2):
        params, opt_state, loss, obs = step_fn(params, opt_state, pts, valid, K)
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses

    if pid == 0:
        ref_loss, _ = pose_forward(
            init_pose_params(jnp.zeros(3), jnp.asarray([1.0, 0.0, 0.0, 0.0])),
            jnp.asarray(full), K, prob)
        np.savez(os.path.join(outdir, "pose_result.npz"),
                 loss0=loss0, ref_loss0=float(ref_loss),
                 losses=np.asarray(losses))
    print(f"[worker {pid}] pose ok loss0={loss0} steps={losses}", flush=True)


def main() -> None:
    pid, nproc, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    mode = sys.argv[5] if len(sys.argv) > 5 else "traj"

    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=2"
        ).strip()

    import jax

    jax.distributed.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid)

    import jax.numpy as jnp
    import numpy as np
    import optax

    from trajectory_optimization_tpu.models.traj import (
        TrajProblem,
        init_traj_params,
        traj_forward,
    )
    from trajectory_optimization_tpu.opt.engine import OptimizerConfig, make_optimizer
    from trajectory_optimization_tpu.parallel.multihost import (
        make_multihost_mesh,
        shard_points_multihost,
    )
    from trajectory_optimization_tpu.parallel.sharded import make_sharded_train_step
    from trajectory_optimization_tpu.utils.data import identity_quaternions
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    assert len(jax.devices()) == 2 * nproc, jax.devices()
    mesh = make_multihost_mesh()
    assert dict(mesh.shape) == {"wps": 1, "pts": 2 * nproc}

    if mode == "pose":
        _pose_phase(pid, nproc, mesh, outdir)
        return

    # Deterministic shared workload: every process regenerates the same full
    # cloud and takes its own contiguous slice (as a real multi-host loader
    # would read its own shard of a dataset).
    n_pts = 4096
    rng = np.random.default_rng(7)
    full = rng.uniform(-10.0, 10.0, size=(n_pts, 3)).astype(np.float32)
    t = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    poses0 = np.stack([12.0 * t, 4.0 * np.sin(3.0 * t), np.zeros_like(t)], axis=1)
    quats0 = identity_quaternions(len(poses0))

    n_local = n_pts // nproc
    local = full[pid * n_local : (pid + 1) * n_local]
    pts, valid = shard_points_multihost(mesh, local, np.ones(n_local, np.float32))

    intr = default_intrinsics()
    problem = TrajProblem(img_width=intr.width, img_height=intr.height, wps_step=1)
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    init_fn, step_fn = make_sharded_train_step(mesh, problem, cfg)
    params = init_traj_params(poses0, quats0)
    opt_state = init_fn(params)
    K = intr.matrix()
    p0, q0 = jnp.asarray(poses0), jnp.asarray(quats0)

    n_steps = 3
    for _ in range(n_steps):
        params, opt_state, loss, _ = step_fn(params, opt_state, pts, valid, K, p0, q0)
    loss_f = float(loss)  # replicated scalar: addressable from every process
    assert np.isfinite(loss_f), loss_f

    if pid == 0:
        # Single-device ground truth on the full cloud.
        tx = make_optimizer(cfg)

        @jax.jit
        def ref_step(state):
            p, o = state
            (l, _), g = jax.value_and_grad(
                lambda q: traj_forward(q, jnp.asarray(full), K, p0, q0, problem), has_aux=True
            )(p)
            up, o = tx.update(g, o, p)
            return (optax.apply_updates(p, up), o), l

        state = (init_traj_params(poses0, quats0), tx.init(init_traj_params(poses0, quats0)))
        for _ in range(n_steps):
            state, ref_loss = ref_step(state)
        np.savez(
            os.path.join(outdir, "result.npz"),
            poses=np.asarray(params["poses"]),
            quats=np.asarray(params["quats"]),
            ref_poses=np.asarray(state[0]["poses"]),
            ref_quats=np.asarray(state[0]["quats"]),
            loss=loss_f,
            ref_loss=float(ref_loss),
        )
    print(f"[worker {pid}] ok loss={loss_f}", flush=True)


if __name__ == "__main__":
    main()
