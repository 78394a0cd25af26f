"""Platform independence: no module is tied to one accelerator, the compile
cache lands where it should, and the multi-device dry run exits cleanly."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

from trajectory_optimization_tpu.models.traj import TrajProblem

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "trajectory_optimization_tpu"


def _run(code, env_extra=None, drop=(), timeout=600):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("needle", [
    "jax.experimental.pallas.tpu", "pltpu", "default_backend()",
])
def test_no_module_is_tied_to_one_platform(needle):
    hits = [str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")
            if needle in p.read_text()]
    assert hits == [], f"{needle!r} in {hits}"


def test_traj_problem_has_no_backend_switch():
    assert "backend" not in {f.name for f in dataclasses.fields(TrajProblem)}


_CACHE_PROBE = (
    "import jax; from trajectory_optimization_tpu.bus.launch import "
    "enable_compilation_cache; d = enable_compilation_cache(); "
    "assert d == jax.config.jax_compilation_cache_dir, d; print(d)"
)


def test_compile_cache_honours_env(tmp_path):
    want = str(tmp_path / "cache")
    r = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": want, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == want


def test_compile_cache_defaults_into_the_checkout():
    r = _run(_CACHE_PROBE, {"JAX_PLATFORMS": "cpu"}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_dryrun_multichip_exits_zero_on_8_cpu_devices():
    """The frozen engine's prewarm threads are joined before exit, so the
    dry run ends with rc 0 instead of aborting in interpreter teardown."""
    r = _run("from __graft_entry__ import dryrun_multichip; dryrun_multichip(8)",
             {"JAX_PLATFORMS": "cpu",
              "XLA_FLAGS": "--xla_force_host_platform_device_count=8"},
             timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "dryrun_multichip(8): ok" in r.stdout
