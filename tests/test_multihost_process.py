"""Real multi-process test of parallel.multihost.

The multi-host *software* path — jax.distributed.initialize, a mesh
spanning processes, cross-process collectives,
make_array_from_process_local_data — is hardware-agnostic: on CPU the
inter-process collectives ride Gloo instead of NCCL. Two spawned processes
with 2 virtual devices each run the full sharded train step (reference
capability: `src/model.py:244-260`'s criterion chain, here at
beyond-one-host scale) and must match the single-device result.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, mode: str):
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # the workers set their own device count; drop the 8-device conftest flag
    env.pop("XLA_FLAGS", None)

    # stdout goes to files, not PIPEs: waiting on worker 0 while worker 1's
    # pipe fills would deadlock the collectives both are blocked on
    logs = [open(tmp_path / f"worker{pid}.log", "w+") for pid in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), str(tmp_path),
             mode],
            env=env,
            stdout=logs[pid],
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    try:
        for p in procs:
            # generous: the workers compile a sharded train step each; on an
            # oversubscribed single-core box 300 s has flaked (passes in
            # ~50 s alone) while a genuine hang still fails fast enough
            p.wait(timeout=600)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise
    finally:
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"


@pytest.mark.slow
def test_two_process_sharded_train_step(tmp_path):
    _run_workers(tmp_path, "traj")
    r = np.load(tmp_path / "result.npz")
    assert np.isfinite(r["loss"]) and np.isfinite(r["ref_loss"])
    # same algorithm, different reduction topology (Gloo tree vs one-device):
    # f32 bit-exactness is not expected, close agreement is
    np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-4)
    np.testing.assert_allclose(r["poses"], r["ref_poses"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r["quats"], r["ref_quats"], rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_two_process_occlusion_aware_pose_step(tmp_path):
    """The occlusion-aware sharded pose loss/step over a REAL 2-process
    jax.distributed runtime: the differentiable binned-HPR candidate
    exchange is an all_gather per grid that here genuinely crosses
    processes over Gloo (the NCCL stand-in). Init loss must match the
    single-chip pose_forward(soft_hpr=True) binned tier, and two Adam
    steps must stay finite."""
    _run_workers(tmp_path, "pose")
    r = np.load(tmp_path / "pose_result.npz")
    assert np.isfinite(r["loss0"]) and np.isfinite(r["ref_loss0"])
    np.testing.assert_allclose(r["loss0"], r["ref_loss0"], rtol=1e-4)
    assert np.isfinite(r["losses"]).all()
