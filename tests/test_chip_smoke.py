"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
comparison helpers judge correctly at tiny sizes."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

from trajectory_optimization_tpu.models.traj import (  # noqa: E402
    TrajProblem, init_traj_params, traj_forward,
)
from trajectory_optimization_tpu.utils.data import identity_quaternions  # noqa: E402
from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics  # noqa: E402


def test_refuses_to_run_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_oracle_terms_match_traj_forward_at_tiny_size():
    pts, path = cs.big_workload(2048)
    intr = default_intrinsics()
    quats = identity_quaternions(len(path))
    want = cs.oracle_terms(pts, path, quats, path, intr, wps_step=3)
    prob = TrajProblem(img_width=intr.width, img_height=intr.height, wps_step=3)
    _, aux = traj_forward(init_traj_params(path, quats), jnp.asarray(pts),
                          intr.matrix(), jnp.asarray(path), jnp.asarray(quats), prob)
    got = {"vis": aux["loss_vis"], "smooth": aux["loss_smooth"],
           "mean_reward": aux["mean_reward"]}
    assert cs.check_terms("tiny", got, want, cs.ORACLE_RTOL) <= cs.ORACLE_RTOL


def test_check_terms_rejects_a_term_off_by_more_than_rtol():
    with pytest.raises(AssertionError, match="loss terms off"):
        cs.check_terms("off", {"vis": 1.01, "smooth": 2.0}, {"vis": 1.0, "smooth": 2.0}, 1e-3)


def test_tree_relnorm_spans_every_leaf():
    want = {"a": np.ones(3), "b": np.zeros(1)}
    got = {"a": np.ones(3), "b": np.full(1, np.sqrt(3) * 0.1)}
    assert cs.tree_relnorm(got, want) == pytest.approx(0.1)
    assert cs.tree_relnorm(want, want) == 0.0


def test_vis_step_floor_counts_from_shapes():
    f = cs.vis_step_floor(1_048_576, 50, cs.PEAKS["H100"])
    assert f["flop"] == 1_048_576 * 50 * 3 * cs.VIS_FWD_FLOP_PER_PAIR
    assert f["bytes"] == 1_048_576 * 36
    assert f["bound"] == "compute"
    assert f["floor_s"] == pytest.approx(f["flop"] / 67e12)
    with pytest.raises(KeyError):
        cs.peaks_for("cpu")
    assert cs.peaks_for("NVIDIA H100 80GB HBM3") is cs.PEAKS["H100"]


def test_hpr_scores_counts_recall_and_false_positives():
    exact = np.array([1, 1, 1, 1, 0, 0], bool)
    approx = np.array([1, 1, 1, 0, 1, 0], bool)
    assert cs.hpr_scores(approx, exact) == (0.75, 1)


def test_image_diff_tells_ties_from_real_differences():
    img = np.ones((4, 4, 3))
    depth = np.full((4, 4, 3), 2.0)
    tie = img.copy()
    tie[1, 1] = 0.5  # another winner at the same depth
    assert cs.image_diff(img, tie, depth, depth) == (1, 0)
    moved = depth.copy()
    moved[2, 2] = 3.0  # a different depth won: not a tie
    other = img.copy()
    other[2, 2] = 0.0
    assert cs.image_diff(img, other, depth, moved) == (1, 1)


def test_on_cpu_commits_to_the_cpu_device():
    x = cs.on_cpu({"a": jnp.ones(2)})
    assert x["a"].devices() == {jax.devices("cpu")[0]}
