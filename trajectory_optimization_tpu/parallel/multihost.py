"""Multi-host scale-out helpers.

For clouds beyond one host's devices: initialize jax.distributed, build a
(hosts × local-devices) mesh with the point axis spanning hosts and the
waypoint axis staying intra-host, and shard per-host cloud slices with
make_array_from_process_local_data. The per-waypoint min/max and mean-reward
all-reduces then cross the host network once per step (a few KB — latency-,
not bandwidth-bound), while all heavy elementwise work stays local.

The software path is exercised for real in tests/test_multihost_process.py:
two spawned processes, jax.distributed.initialize, cross-process Gloo
collectives (the CPU stand-in for NCCL), and the full sharded train step
matching the single-device result.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX distributed runtime (no-op if already up)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # Only the benign re-init case may be swallowed; a connect timeout /
        # port conflict (XlaRuntimeError subclasses RuntimeError) must fail
        # fast, not silently proceed as an uninitialized single-process JAX.
        if "only be called once" not in str(e):  # jax._src.distributed
            raise


def make_multihost_mesh(*, wps: int = 1) -> Mesh:
    """('wps', 'pts') mesh over ALL processes' devices.

    Device order puts each host's devices contiguous along 'pts', so the
    point axis shards host-locally first and traffic between hosts is
    limited to the reduction collectives.
    """
    devices = np.asarray(jax.devices())
    n = len(devices)
    if n % wps != 0:
        raise ValueError(f"{n} devices not divisible by wps={wps}")
    return Mesh(devices.reshape(wps, n // wps), axis_names=("wps", "pts"))


def shard_points_multihost(mesh: Mesh, local_points: np.ndarray, local_valid: np.ndarray):
    """Assemble a global sharded cloud from per-host slices.

    Each process passes its own (N_local, 3) slice; the result is a global
    (N_local · n_processes, 3) jax.Array sharded along 'pts' without any
    host ever materializing the full cloud.
    """
    ps = NamedSharding(mesh, P("pts"))
    vs = NamedSharding(mesh, P("pts"))
    pts = jax.make_array_from_process_local_data(ps, np.asarray(local_points, np.float32))
    val = jax.make_array_from_process_local_data(vs, np.asarray(local_valid, np.float32))
    return pts, val
