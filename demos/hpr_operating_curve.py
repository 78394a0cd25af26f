"""Soft-HPR operating curve: precision/recall of the differentiable Katz
relaxation (thresholded at 0.5) against exact Qhull HPR.

Sweeps (sharpness, tau) of the dense soft kernel over the four adversarial
geometry scenes (tests/test_hpr.py) and four real cloud-10 viewpoints, in
ONE compile per scene (both knobs traced, combos vmapped), then evaluates
the production binned kernel (cap/safety variants) at the chosen operating
point on the full clouds. Output: markdown tables (PARITY.md §soft-HPR).

Run: python demos/hpr_operating_curve.py          (GPU if available)
     JAX_PLATFORMS=cpu python demos/...           (slow but works)
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import jax
import jax.numpy as jnp

from trajectory_optimization_tpu.ops.hpr import (
    _BIG_SOFT,
    hpr_mask_exact,
    hpr_mask_soft_binned,
)
from trajectory_optimization_tpu.ops.numerics import safe_norm
from trajectory_optimization_tpu.utils.data import load_path, load_point_cloud

SHARPNESS = np.array([50.0, 100.0, 200.0, 400.0, 800.0], np.float32)
TAU = np.array([0.0, 0.01, 0.02, 0.03, 0.05, 0.08], np.float32)


def sweep_dense(points: np.ndarray) -> np.ndarray:
    """(S, T, N) soft visibility for every (sharpness, tau) combo in one
    compiled evaluation (the dense O(N²) form with both knobs traced)."""

    @jax.jit
    def run(pts, sharp, tau):
        n = pts.shape[0]
        norms = safe_norm(pts, axis=-1)
        radius = jnp.max(norms) * 100.0  # r_param = 2
        rho = 2.0 * radius - norms
        scale = jnp.maximum(jnp.max(norms), 1e-6)
        u = pts / jnp.maximum(norms, 1e-12)[:, None]
        cos = jnp.clip(
            u[:, 0:1] * u[:, 0][None] + u[:, 1:2] * u[:, 1][None]
            + u[:, 2:3] * u[:, 2][None], -1.0, 1.0)
        idx = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
        slf = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
        dom = jnp.where(idx == slf, -_BIG_SOFT, jnp.maximum(cos, 0.0) * rho)
        beta = sharp / scale  # (S,)
        # (S, N): logsumexp over j of beta_s·dom_ij — dom stays a fused
        # elementwise producer for every s
        smax = jax.nn.logsumexp(
            beta[:, None, None] * dom[None], axis=-1) / beta[:, None]
        arg = beta[:, None, None] * (
            rho[None, None, :] + tau[None, :, None] * scale
            - smax[:, None, :])
        return jax.nn.sigmoid(arg)  # (S, T, N)

    return np.asarray(run(jnp.asarray(points, jnp.float32),
                          jnp.asarray(SHARPNESS), jnp.asarray(TAU)))


def scenes():
    from test_hpr import _ADVERSARIAL_SCENES  # the CI scenes, verbatim

    out = {name: fn() for name, fn in _ADVERSARIAL_SCENES.items()}
    pts = load_point_cloud(
        os.path.join(os.path.dirname(__file__), "..",
                     "data/points/point_cloud_10.npz"))
    path = load_path(
        os.path.join(os.path.dirname(__file__), "..",
                     "data/paths/path_poses_10.npz"))
    rng = np.random.default_rng(0)
    sub = rng.permutation(len(pts))[:12288]  # dense sweep budget
    for i, wp in enumerate([0, 9, 18, 26]):
        out[f"cloud10-wp{wp}"] = (pts[sub] - path[wp]).astype(np.float32)
    return out, pts, path


def prf(pred: np.ndarray, truth: np.ndarray):
    tp = int((pred & truth).sum())
    fp = int((pred & ~truth).sum())
    fn = int((~pred & truth).sum())
    return tp, fp, fn


def main():
    sc, pts_full, path = scenes()
    print(f"# soft-HPR operating curve ({jax.default_backend()})\n")
    totals = np.zeros((len(SHARPNESS), len(TAU), 3), np.int64)
    for name, pts in sc.items():
        truth = hpr_mask_exact(pts)
        vis = sweep_dense(pts)
        for i in range(len(SHARPNESS)):
            for j in range(len(TAU)):
                totals[i, j] += prf(vis[i, j] > 0.5, truth)
        print(f"scene {name}: n={len(pts)}, exact visible "
              f"{int(truth.sum())}", file=sys.stderr, flush=True)

    print("## dense relaxation, micro-averaged over all 8 scenes\n")
    print("| sharpness | " + " | ".join(f"τ={t:g}" for t in TAU) + " |")
    print("|---" * (len(TAU) + 1) + "|")
    best = None
    for i, s in enumerate(SHARPNESS):
        row = [f"| {s:g} "]
        for j, t in enumerate(TAU):
            tp, fp, fn = totals[i, j]
            p = tp / max(tp + fp, 1)
            r = tp / max(tp + fn, 1)
            f1 = 2 * p * r / max(p + r, 1e-12)
            row.append(f"| P{p:.3f}/R{r:.3f} ")
            if best is None or f1 > best[0]:
                best = (f1, s, t, p, r)
        print("".join(row) + "|")
    f1, s_b, t_b, p_b, r_b = best
    print(f"\nbest F1 {f1:.4f} at sharpness={s_b:g}, tau={t_b:g} "
          f"(P {p_b:.3f} / R {r_b:.3f})\n")

    print("## binned kernel at the operating point, full cloud-10 "
          "viewpoints\n")
    print("(strat = the tiered distance-rank coverer sampling in over-full "
          "bins, the production default; 'P unstrat' = the closest-cap "
          "prefix it replaced)\n")
    print("| viewpoint | cap | safety | precision | recall | agreement "
          "| P unstrat |")
    print("|---|---|---|---|---|---|---|")
    for wp in (0, 9, 18, 26):
        cam = (pts_full - path[wp]).astype(np.float32)
        truth = hpr_mask_exact(cam)
        for cap, safety in ((1024, 3.0), (512, 3.0), (256, 3.0),
                            (1024, 2.0)):
            vis = np.asarray(hpr_mask_soft_binned(
                jnp.asarray(cam), sharpness=float(s_b), tau=float(t_b),
                cap=cap, safety=safety))
            vis_u = np.asarray(hpr_mask_soft_binned(
                jnp.asarray(cam), sharpness=float(s_b), tau=float(t_b),
                cap=cap, safety=safety, stratified_coverers=False))
            tp, fp, fn = prf(vis > 0.5, truth)
            tp_u, fp_u, _ = prf(vis_u > 0.5, truth)
            p = tp / max(tp + fp, 1)
            r = tp / max(tp + fn, 1)
            agree = ((vis > 0.5) == truth).mean()
            pu = tp_u / max(tp_u + fp_u, 1)
            print(f"| cloud10-wp{wp} | {cap} | {safety:g} | {p:.3f} "
                  f"| {r:.3f} | {agree:.3f} | {pu:.3f} |", flush=True)


if __name__ == "__main__":
    main()
