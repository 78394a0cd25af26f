#!/usr/bin/env python
"""Hidden-point-removal demo (parity with `notebooks/hidden_points_removal.ipynb`,
per the reference's configuration list: single-pose Katz HPR on one sample
cloud). Compares the three tiers — exact Qhull, on-device support sampling, and the
differentiable soft mask — and reports agreement + timings.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np


def main():
    from trajectory_optimization_tpu.bus.launch import enable_compilation_cache

    enable_compilation_cache()  # repeat runs reload executables

    from trajectory_optimization_tpu.ops.hpr import (
        hpr_mask_approx,
        hpr_mask_exact,
        hpr_mask_soft,
    )
    from trajectory_optimization_tpu.utils.data import load_point_cloud

    here = os.path.dirname(os.path.abspath(__file__))
    pts = load_point_cloud(os.path.join(here, "..", "data", "points", "point_cloud_10.npz"))
    viewpoint = np.array([6.0, 2.0, 0.0], np.float32)
    cam = pts - viewpoint
    print(f"cloud: {len(cam)} points, camera at {viewpoint}")

    t0 = time.perf_counter()
    exact = hpr_mask_exact(cam)
    t_exact = time.perf_counter() - t0
    print(f"exact (Qhull):          {exact.sum():6d} visible   {1000*t_exact:8.1f} ms")

    P = jnp.asarray(cam)
    approx = np.asarray(hpr_mask_approx(P)) > 0.5  # includes compile
    t0 = time.perf_counter()
    approx = np.asarray(hpr_mask_approx(P)) > 0.5
    t_approx = time.perf_counter() - t0
    agree_a = (approx == exact).mean()
    print(f"approx (on device):    {approx.sum():6d} visible   {1000*t_approx:8.1f} ms   agreement {agree_a:.3f}")

    soft = np.asarray(hpr_mask_soft(P))
    t0 = time.perf_counter()
    soft = np.asarray(hpr_mask_soft(P))
    t_soft = time.perf_counter() - t0
    agree_s = ((soft > 0.5) == exact).mean()
    print(f"soft (differentiable):  {(soft > 0.5).sum():6d} visible   {1000*t_soft:8.1f} ms   agreement {agree_s:.3f}")

    return {"exact": exact, "approx": approx, "soft": soft}


if __name__ == "__main__":
    main()
