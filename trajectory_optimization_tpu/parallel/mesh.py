"""Device-mesh helpers.

The reference is single-process single-GPU (SURVEY.md §2c); scale-out here is
jax.sharding over a Mesh. The natural parallel axes of this workload:

  * ``pts`` — the point-cloud axis (the 1M-point north star): sharded like
    sequence/data parallelism; global reductions (per-waypoint min/max, mean
    rewards) become collectives inserted by GSPMD or written explicitly
    with shard_map (see sharded.py).
  * ``wps`` — the waypoint batch axis: sharded like model parallelism for the
    (W, N) visibility evaluation; trajectory regularizers need neighbor
    waypoints, which XLA lowers to cheap collective-permutes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    wps: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('wps', 'pts') mesh over the first n devices.

    With wps=1 (default) this is a pure point-sharding mesh; set wps>1 to
    also shard the waypoint axis (2D parallelism).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if n_devices % wps != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by wps={wps}")
    grid = devices.reshape(wps, n_devices // wps)
    return Mesh(grid, axis_names=("wps", "pts"))


def points_sharding(mesh: Mesh) -> NamedSharding:
    """(N, 3) clouds and (N,) masks: shard the point axis."""
    return NamedSharding(mesh, P("pts"))


def waypoint_sharding(mesh: Mesh) -> NamedSharding:
    """(W, ...) waypoint-major params: shard the waypoint axis."""
    return NamedSharding(mesh, P("wps"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
