"""Test config: force an 8-virtual-device CPU platform so sharding tests run
without an accelerator (multi-device code is validated on a virtual mesh;
the GPU is checked by chip_smoke.py, and no test needs it)."""
import os
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
# cache XLA compilations across test runs (compiles dominate CPU test time)
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(tempfile.gettempdir(), "jax_cache_tests"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


# ---------------------------------------------------------------------------
# Tiering: `-m fast` is the iteration tier (< 5 min warm); `-m slow` is the
# compile-heavy / optimization-loop tier; `-m subprocess` spawns OS
# processes (remote bus, jax.distributed) and is both slow AND
# oversubscription-sensitive — those tests are moved to the END of the
# collection so they run with the machine to themselves (a multihost
# shutdown-barrier flake was a mid-suite CPU-contention artifact).
# ---------------------------------------------------------------------------

# modules whose tests are wholesale slow (giant XLA compiles or real
# optimization loops); individual tests elsewhere use @pytest.mark.slow
SLOW_MODULES = {
    "test_hpr",             # Qhull sweeps + soft-HPR compiles
    "test_hpr_sharded",     # sharded binned-HPR programs
    "test_traj_sharded",
    "test_traj_frozen",
    "test_traj_frozen_sharded",
    "test_sharding",
    "test_wps_eval",
    "test_models",
    "test_occlusion_outcome",
    "test_reference_parity",  # executes the reference under torch
    "test_multihost_process",
    "test_remote_bus",
    "test_serving",
    "test_multicam",   # 133 s batched-rig pipeline
    "test_nodes",      # several 20-60 s node pipelines
    "test_replay",     # 37 s session-replay demo
}

SUBPROCESS_MODULES = {"test_multihost_process", "test_remote_bus"}


def pytest_collection_modifyitems(config, items):
    subproc, rest = [], []
    for it in items:
        mod = it.module.__name__.rsplit(".", 1)[-1]
        if mod in SLOW_MODULES or it.get_closest_marker("slow"):
            it.add_marker(pytest.mark.slow)
        else:
            it.add_marker(pytest.mark.fast)
        if mod in SUBPROCESS_MODULES:
            it.add_marker(pytest.mark.subprocess)
            subproc.append(it)
        else:
            rest.append(it)
    items[:] = rest + subproc


DATA_POINTS = os.path.join(os.path.dirname(__file__), "..", "data", "points", "point_cloud_10.npz")
DATA_PATH = os.path.join(os.path.dirname(__file__), "..", "data", "paths", "path_poses_10.npz")


@pytest.fixture(scope="session")
def cloud10():
    """The reference benchmark cloud: 40452 x 3 (index 10)."""
    pts = np.load(DATA_POINTS)["pts"]
    if pts.shape[0] < pts.shape[1]:
        pts = pts.T
    return pts.astype(np.float32)


@pytest.fixture(scope="session")
def path10():
    """The reference benchmark path: 27 x 3 waypoints (index 10)."""
    return np.load(DATA_PATH)["poses"].astype(np.float32)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
