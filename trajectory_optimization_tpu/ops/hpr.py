"""Hidden-point removal (Katz spherical-flip HPR).

Reference semantics (`src/tools.py:38-85`): spherical-flip the cloud about the
origin with R = max‖p‖·10^param, append the origin, take the convex hull
(Qhull); hull vertices = visible points. The reference runs this on CPU via
scipy and admits it is non-differentiable (its own TODO, `src/tools.py:61-62`).

This module provides three tiers:

1. :func:`hpr_mask_exact` — bit-exact reference parity: the same spherical
   flip + Qhull hull (scipy wraps the identical Qhull C library the reference
   calls). Host-side, non-differentiable — exactly like the reference, which
   only ever calls it on detached tensors.

2. :func:`hpr_mask_approx` — on-device fixed-shape approximation: every
   point pursues a witness direction for the hull support function, refined
   per pass by Agmon–Motzkin relaxation against its current blocker; winners
   of the support argmax are marked visible (margin-gated against f32 ties).
   Each pass is an (N, N) support sweep fused into its reductions,
   evaluated in row blocks so memory stays O(block·N). Recall ≥ 0.99 vs Qhull's visible set on the
   sample cloud with zero false positives (tests/test_hpr.py); jittable.

3. :func:`hpr_mask_soft` — differentiable relaxation of (2): replaces the
   hard max-dominance test with a log-sum-exp + sigmoid, giving useful
   gradients for occlusion-aware optimization — the thing the reference's
   TODO wished for.

The Open3D variant (`src/tools.py:88-119`, same algorithm with an axis flip
and radius = 100·diameter) is subsumed by :func:`hpr_mask_exact` with an
explicit ``radius`` argument.
"""
from __future__ import annotations

import inspect
from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from trajectory_optimization_tpu.ops.numerics import safe_norm

_BIG_SOFT = 1.0e30  # self-exclusion sentinel for the soft dominance test


def spherical_flip(points: jnp.ndarray, r_param: float = 2.0) -> jnp.ndarray:
    """Katz spherical flip: p' = p·(2R − ‖p‖)/‖p‖ with R = max‖p‖·10^r_param.

    Jittable and differentiable, including at ‖p‖ = 0 (sensor-origin
    points appear in real scans; safe_norm keeps their gradient finite).
    """
    norms = safe_norm(points, axis=-1)
    radius = jnp.max(norms) * 10.0 ** r_param
    safe = jnp.maximum(norms, 1e-12)
    scale = (2.0 * (radius - norms) / safe) + 1.0
    return points * scale[:, None]


def hpr_mask_exact(
    points: np.ndarray, r_param: float = 2.0, radius: Optional[float] = None
) -> np.ndarray:
    """Exact Katz HPR visible-point mask via Qhull (host-side, reference parity).

    Args:
      points: (N, 3) cloud, camera at the origin.
      r_param: flip-radius exponent (reference default 2).
      radius: override the flip radius directly (the Open3D variant uses
        100 · cloud diameter, `src/tools.py:107`).

    Returns (N,) bool visibility mask.
    """
    from scipy.spatial import ConvexHull  # Qhull — the reference's own backend

    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    norms = np.linalg.norm(pts, axis=1)
    if radius is None:
        radius = norms.max() * 10.0 ** r_param
    safe = np.maximum(norms, 1e-12)
    flipped = pts * ((2.0 * (radius - norms) / safe) + 1.0)[:, None]
    hull = ConvexHull(np.vstack([flipped, np.zeros(3)]))
    mask = np.zeros(n, dtype=bool)
    mask[[v for v in hull.vertices if v < n]] = True
    return mask


def hpr_points_exact(points: np.ndarray, r_param: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """(visible_points, mask) — the reference's `hidden_pts_removal` return
    shape (`src/tools.py:67-85`)."""
    mask = hpr_mask_exact(points, r_param)
    return np.asarray(points)[mask], mask


@partial(jax.jit, static_argnames=("r_param", "block", "n_passes", "full_passes"))
def hpr_mask_approx(
    points: jnp.ndarray,
    r_param: float = 2.0,
    *,
    block: int = 1024,
    n_passes: int = 16,
    full_passes: int = 4,
    relax: float = 1.9,
    rel_tol: float = 1e-7,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """On-device HPR visible mask by adaptive support-function pursuit
    (jittable).

    A flipped point p'ᵢ is a hull vertex (⇔ visible) iff it is the argmax of
    the support function d ↦ maxⱼ p'ⱼ·d for SOME direction d. Each point
    pursues a witness direction dᵢ, starting radial (uᵢ) and refined by
    Agmon–Motzkin relaxation: on each pass the current blocker b =
    argmaxⱼ p'ⱼ·dᵢ defines the violated constraint (p'ᵢ − p'_b)·d > 0, and dᵢ
    is projected λ=1.9 of the way onto its boundary (the Polyak step for the
    separation margin — converges linearly for true vertices, unlike fixed
    jitter sampling). Each pass is a (block, N) fused support sweep (see
    row_block for why it is NOT a matmul).

    Narrowing: after ``full_passes`` all-point passes, ~95% of vertices are
    already found and their probe rows are idle (they just keep winning
    themselves), so the pursuit continues for a fixed N/4 subset — the
    unfound rows with the smallest separation deficits (hidden points'
    deficits never shrink, so they cannot crowd out barely-visible vertices).
    Measured 2.6× faster than all-full passes at equal recall.

    Soundness: a direction's argmax winner is by definition a hull vertex, so
    winners are only marked when they beat the runner-up by a margin
    > rel_tol·2R — suppressing f32 argmax ties, the one way a rounding error
    could crown a non-vertex. Validated against Qhull on the sample cloud
    (tests/test_hpr.py): recall ≥ 0.99 with ZERO false positives at defaults;
    missed points are "barely-visible" vertices with the tiniest normal
    cones, so the error direction stays conservative.

    ``valid``: optional (N,) 0/1 mask — padded entries are excluded from the
    flip radius, can never win a support test, and report 0 visibility. Pass
    bucket-padded clouds (utils.data.pad_points) in serving paths so the jit
    cache is keyed on O(log N) bucket sizes instead of every message size.

    Returns (N,) float mask in {0, 1}.
    """
    n = points.shape[0]
    norms = jnp.linalg.norm(points, axis=-1)
    if valid is not None:
        v = valid > 0
        norms_v = jnp.where(v, norms, 0.0)
    else:
        v = None
        norms_v = norms
    radius = jnp.maximum(jnp.max(norms_v), 1e-12) * 10.0 ** r_param
    rho = 2.0 * radius - norms  # flipped radii (flip preserves direction)
    u = points / jnp.maximum(norms, 1e-12)[:, None]
    if v is not None:
        # invalid points contribute 0 to every support test (real supports
        # are ~2R·cos > 0 near a real point's own direction), and their probe
        # rows produce an all-zero projection whose margin never clears the
        # gate — so they neither win nor get marked
        rho = jnp.where(v, rho, 0.0)
        u = jnp.where(v[:, None], u, 0.0)
    inv2r = 1.0 / (2.0 * radius)
    thresh = rel_tol * 2.0 * radius

    def sweep(d_rows):
        """One pursuit pass for m probe rows against ALL N points:
        (winner, max support, winner-vs-runner-up margin) per row."""
        m = d_rows.shape[0]
        n_pad = (-m) % block
        d_p = jnp.pad(d_rows, ((0, n_pad), (0, 0)))
        nb = (m + n_pad) // block

        # support-weighted flipped points, broadcast once for all blocks
        sx, sy, sz = (rho * u[:, 0])[None], (rho * u[:, 1])[None], (rho * u[:, 2])[None]

        def row_block(i):
            db = jax.lax.dynamic_slice(d_p, (i * block, 0), (block, 3))
            # ELEMENTWISE broadcast, not a matmul: a matmul output is its
            # own fusion root, so the (block, N) proj tile (165 MB at N=40k)
            # would reach device memory once per reduction. As an
            # elementwise producer it fuses INTO the reductions and never
            # materializes (same f32 precision as the precision="highest"
            # matmul it replaces).
            proj = db[:, 0:1] * sx + db[:, 1:2] * sy + db[:, 2:3] * sz
            win = jnp.argmax(proj, axis=1)
            maxv = jnp.max(proj, axis=1)
            col = jax.lax.broadcasted_iota(jnp.int32, proj.shape, 1)
            runner_up = jnp.max(jnp.where(col == win[:, None], -_BIG_SOFT, proj), axis=1)
            return win, maxv, maxv - runner_up

        # rows beyond m are padding (zero directions) — never mark from them
        w, mv, mg = jax.lax.map(row_block, jnp.arange(nb))
        return w.reshape(-1)[:m], mv.reshape(-1)[:m], mg.reshape(-1)[:m]

    def update(d_rows, ids, winners, maxv):
        s_own = rho[ids] * jnp.sum(u[ids] * d_rows, axis=-1)
        deficit = (maxv - s_own) * inv2r  # ≥ 0 while the point is blocked
        gv = (rho[ids][:, None] * u[ids] - rho[winners][:, None] * u[winners]) * inv2r
        g2 = jnp.sum(gv * gv, axis=-1)
        d2 = d_rows + (relax * deficit / jnp.maximum(g2, 1e-18))[:, None] * gv
        d2 = d2 / jnp.maximum(jnp.linalg.norm(d2, axis=-1, keepdims=True), 1e-12)
        return d2, deficit

    mask = jnp.zeros((n,), jnp.float32)
    d = u
    ids = jnp.arange(n)
    deficit = jnp.zeros((n,), jnp.float32)
    k_full = min(full_passes, n_passes)
    for p in range(k_full):
        winners, maxv, margin = sweep(d)
        mask = mask.at[winners].max((margin > thresh).astype(jnp.float32))
        if p + 1 < n_passes:
            d, deficit = update(d, ids, winners, maxv)

    if n_passes > k_full:
        m_sub = -(-n // 4)
        key = mask * 1e9 + deficit  # unfound first, smallest deficit first
        if v is not None:
            key = key + jnp.where(v, 0.0, 2e9)  # padding rows sort out
        ids = jnp.argsort(key, stable=True)[:m_sub]
        d = d[ids]
        for p in range(k_full, n_passes):
            winners, maxv, margin = sweep(d)
            mask = mask.at[winners].max((margin > thresh).astype(jnp.float32))
            if p + 1 < n_passes:
                d, _ = update(d, ids, winners, maxv)

    if v is not None:
        mask = mask * v.astype(jnp.float32)
    return mask


@partial(jax.jit, static_argnames=("r_param", "sharpness", "tau"))
def hpr_mask_soft(
    points: jnp.ndarray,
    r_param: float = 2.0,
    *,
    block: int = 1024,
    sharpness: float = 400.0,
    tau: float = 0.02,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Differentiable HPR visibility in (0, 1).

    Smooth margin test in the flipped geometry: point i is visible to the
    degree that its flipped radius stands clear of the strongest radial
    coverer, σ(β·(ρ'ᵢ + τ·scale − softmaxⱼ ρ'ⱼcosθᵢⱼ)). The slack τ
    compensates the single-witness-direction bias of the margin test.
    Defaults (sharpness=400, τ=0.02) sit at the best-F1 point of the
    precision/recall operating curve vs exact Qhull, swept over the four
    adversarial CI scenes and four real cloud-10 viewpoints — P 0.958 /
    R 0.956 micro-averaged (PARITY.md "soft-HPR operating curve";
    regenerate with demos/hpr_operating_curve.py; CI pin in
    tests/test_hpr.py::test_soft_binned_operating_point_vs_exact).

    Gradients flow to the point coordinates — usable *inside* the
    optimization loop, which the reference could never do (its HPR is a CPU
    Qhull call on detached tensors; `src/tools.py:61-62`). For a
    high-fidelity non-differentiable mask use :func:`hpr_mask_approx`.

    ``block`` is retained for API compatibility but unused (and deliberately
    NOT a jit static arg, so different values cannot trigger spurious
    recompiles): the (N, N) dominance tile is an elementwise producer that
    XLA fuses into the logsumexp, so no blocking is needed to bound memory —
    and the fused unblocked form compiles and runs fwd+bwd at 40k points.
    Whether XLA fuses the tile on a given backend shows in
    ``compiled.memory_analysis()`` (chip_smoke.py prints it for the binned
    trajectory step); where it does not, very large N may materialize
    O(N²) — soft HPR is O(N²) compute regardless, so cap N (~50k) either
    way.
    """
    del block
    n = points.shape[0]
    # safe_norm, not jnp.linalg.norm: real scans contain points EXACTLY at
    # the sensor origin (cloud-10 has one per pose), and the norm gradient
    # at 0 is 0/0 = NaN — which poisons the whole trajectory gradient when
    # soft HPR runs inside the loss at a waypoint the scan was taken from
    norms = safe_norm(points, axis=-1)
    if valid is not None:
        # padded points must neither set the flip radius nor cover anyone
        norms_v = jnp.where(valid > 0, norms, 0.0)
    else:
        norms_v = norms
    radius = jnp.max(norms_v) * 10.0 ** r_param
    rho = 2.0 * radius - norms
    if valid is not None:
        rho = jnp.where(valid > 0, rho, -_BIG_SOFT)
    # normalization constant; stop_gradient — a traced beta multiplying the
    # -BIG self-exclusion sentinel would otherwise poison the backward
    scale = jax.lax.stop_gradient(jnp.maximum(jnp.max(norms_v), 1e-6))
    u = points / jnp.maximum(norms, 1e-12)[:, None]

    # elementwise broadcast, not a K=3 matmul — fuses into the logsumexp so
    # the (N, N) tile never hits HBM (same fix as hpr_mask_approx)
    cos = jnp.clip(
        u[:, 0:1] * u[:, 0][None] + u[:, 1:2] * u[:, 1][None] + u[:, 2:3] * u[:, 2][None],
        -1.0,
        1.0,
    )
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    self_col = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    beta = sharpness / scale
    dom = jnp.where(
        idx == self_col, -_BIG_SOFT, jnp.maximum(cos, 0.0) * rho
    )  # finite sentinel: softmax weight underflows to 0, gradient stays clean
    smax = jax.nn.logsumexp(beta * dom, axis=1) / beta
    return jax.nn.sigmoid(beta * (rho + tau * scale - smax))


# ---------------------------------------------------------------------------
# custom-VJP sort helpers for hpr_mask_soft_binned (and its sharded variant)
#
# JAX's built-in lax.sort VJP transposes the implicit gather into a
# scatter-add over every sort operand. The helpers below instead un-permute
# cotangents by the saved perm (one write per row, :func:`_unsort`) or
# re-apply the forward permutation with one stable co-sort on the original
# key (sort permutations depend only on the keys). Gradients agree with
# autodiff-through-sort bit-exactly, ties included (a stable sort's
# transpose IS the inverse of the forward permutation).
#
# Being custom_vjp, these are REVERSE-MODE ONLY: jax.jvp/jacfwd through
# hpr_mask_soft_binned (and anything built on it) raises. The dense
# hpr_mask_soft keeps full forward-mode support.
# ---------------------------------------------------------------------------


def _unsort(perm, x, dimension: int = 0):
    """Canonical-order copy of sorted-order ``x``: the row at sorted
    position ``p`` along ``dimension`` goes to row ``perm[p]``.

    ``perm`` is a permutation, so this is a scatter that writes every row
    exactly once. (Sorting ``x`` by ``perm`` gives the same result, but
    XLA's GPU pipeline rewrites a sort keyed by a provable permutation into
    a scatter whose update computation it mistypes when the values are not
    int32: the HLO verifier then rejects the program.)"""
    perm = jnp.moveaxis(perm, dimension, -1)
    x = jnp.moveaxis(x, dimension, -1)
    batch = tuple(i[..., None] for i in jnp.indices(perm.shape[:-1], sparse=True))
    out = jnp.zeros_like(x).at[batch + (perm,)].set(x, unique_indices=True)
    return jnp.moveaxis(out, -1, dimension)


@lru_cache(maxsize=None)
def make_cosort(n_diff: int, n_aux: int, dimension: int = 0):
    """Build a multi-operand sort-by-key with a custom VJP.

    The returned function ``cosort(key, *diff_ops, *aux_ops)`` stable-sorts
    all operands along ``dimension`` by the integer ``key`` alone and
    returns ``(key_sorted, *diff_sorted, *aux_sorted, perm)`` where
    ``perm[p]`` is the canonical index landing at sorted position ``p``.
    Gradients flow to the ``n_diff`` leading operands only; the backward
    drops cotangents back to canonical order by the saved ``perm``
    (:func:`_unsort`) — never lax.sort's scatter-add transpose over every
    operand. Reverse-mode
    only (custom_vjp): forward-mode autodiff through it raises.
    """

    @jax.custom_vjp
    def cosort(key, *ops):
        out, _ = fwd(key, *ops)
        return out

    def fwd(key, *ops):
        assert len(ops) == n_diff + n_aux
        iota = jnp.broadcast_to(
            jnp.arange(key.shape[dimension], dtype=jnp.int32), key.shape)
        sorted_ = jax.lax.sort((key, *ops, iota), num_keys=1,
                               dimension=dimension)
        perm = sorted_[-1]
        return sorted_, perm

    def bwd(perm, cots):
        # forward put canonical row perm[p] at sorted position p; the
        # sorted-order cotangents drop back to their canonical rows
        cdiff = cots[1:1 + n_diff]
        unsorted = [_unsort(perm, c, dimension) for c in cdiff]
        return (None, *unsorted, *([None] * n_aux))

    cosort.defvjp(fwd, bwd)
    return cosort


# sort (u0, u1, u2, rho) by key — the single-chip binned-HPR layout sort
_cosort = make_cosort(4, 0)


def _stratified_priority(rank, base: int, n: int):
    """Tiered distance-rank stratification of a bin's coverer candidates.

    Keeps ALL of the closest ``base`` members, then every 2^(k+1)-th member
    of tier k = ranks [base·2^k, base·2^(k+1)) — ≤ base/2 selections per
    tier, so a fixed budget of ~base + T·base/2 coverers reaches depth
    base·2^T in the bin's distance order instead of stopping at the budget.
    Rationale (measured on cloud-10): in over-full bins the strongest
    dominator of a truncation false-visible sits at rank 2-4× cap — never
    inside the closest-cap prefix — while dense occluding surfaces provide
    MANY dominators, so sampling every 2^k-th at depth keeps ≥1 of them.

    Tiers stop at depth 16·base (4 tiers): beyond that the sampled members
    are the bin's weakest-ρ tail AND a bounded depth is what lets the
    multi-chip kernel (parallel.hpr_sharded) reproduce this selection
    EXACTLY from a 4·cap-deep gathered candidate table.

    Returns an int priority: selected members keep their rank (distance
    order), unselected sort after everything selected (``n + rank``).
    """
    r = rank
    rb = jnp.maximum(r // base, 1).astype(jnp.float32)
    k = jnp.floor(jnp.log2(rb)).astype(jnp.int32)
    stride_mask = (1 << (k + 1)) - 1  # stride is a power of two
    selected = (r < base) | ((r < 16 * base) & ((r & stride_mask) == 0))
    return jnp.where(selected, r, n + r)


@jax.custom_vjp
def _unpermute(key, perm, x):
    """Map sorted-order ``x`` back to canonical order (perm from
    :func:`_cosort`). Backward re-applies the forward permutation by
    co-sorting the cotangent on the original ``key``."""
    return _unsort(perm, x)


def _unpermute_fwd(key, perm, x):
    return _unpermute(key, perm, x), key


def _unpermute_bwd(key, cot):
    # cot is canonical-order; the stable key-sort reproduces the forward
    # permutation exactly, sending cot[perm[p]] to sorted position p
    _, g = jax.lax.sort((key, cot), num_keys=1)
    return None, None, g


_unpermute.defvjp(_unpermute_fwd, _unpermute_bwd)


def _binned_grids(r_param: float, tau: float, safety: float):
    """Static lat/az binning layouts for :func:`hpr_mask_soft_binned`.

    The Katz dominance term cosθᵢⱼ·ρⱼ only beats ρᵢ + τ·scale when
    cosθ ≥ 1 − (1+τ)·maxnorm/2R, i.e. within θ_max ≈ √(2c) of radial
    (c = (1+τ)·10^-r/2, padded by ``safety`` for the sigmoid tails) — for
    the reference's r_param=2 that is ~7°. So dominance is local in
    DIRECTION: bins of angular size Δ = 2θ_max, in four half-cell-staggered
    grids (lat shift × az shift), guarantee any pair within (Δ/2, Δ/2)
    shares a bin in at least one grid. Rings get ∝cos(lat) azimuth cells so
    the cell's angular width is ~Δ at every latitude (no cube-map corner
    distortion).

    Returns (theta_max, list of (n_rings, delta, lat_shift, az_shift,
    n_az array, ring offsets, n_bins)).
    """
    c = safety * (1.0 + tau) * 0.5 * 10.0 ** (-r_param)
    theta_max = float(np.sqrt(2.0 * c))
    delta = 2.0 * theta_max
    grids = []
    for lat_shift in (0.0, 0.5):
        n_rings = int(np.ceil(np.pi / delta + lat_shift))
        lat_centers = -np.pi / 2 + (np.arange(n_rings) + 0.5 - lat_shift) * delta
        lat_centers = np.clip(lat_centers, -np.pi / 2, np.pi / 2)
        n_az = np.maximum(
            1, np.round(2.0 * np.pi * np.cos(lat_centers) / delta)
        ).astype(np.int32)
        offsets = np.concatenate([[0], np.cumsum(n_az)]).astype(np.int32)
        for az_shift in (0.0, 0.5):
            grids.append((n_rings, delta, lat_shift, az_shift, n_az,
                          offsets[:-1], int(offsets[-1])))
    return theta_max, grids


def _direction_angles(u: jnp.ndarray):
    """(lat, az) routing angles of unit directions ``u`` — stop-gradiented:
    visibility gradients flow through rho/u inside the dominance tiles, not
    through the discrete bin assignment."""
    ud = jax.lax.stop_gradient(u)
    lat = jnp.arcsin(jnp.clip(ud[:, 2], -1.0, 1.0))
    az = jnp.arctan2(ud[:, 1], ud[:, 0]) + np.pi  # [0, 2π)
    return lat, az


def _grid_bin_key(grid, lat, az, norms, scale, v):
    """Bin ids + quantized (bin, distance) int32 sort key for one static
    grid layout from :func:`_binned_grids`.

    Sorting by this key makes bin members contiguous with the closest
    (strongest-covering, largest ρ) members first. ``v`` (optional bool
    mask) routes padded points to the overflow bin ``n_bins``. frac gets
    the int32 bits left over after the bin id — a fixed 1<<20 shift
    overflowed int32 once n_bins > 2047 (large r_param), silently
    interleaving unrelated bins. Returns (key, frac_bits, n_bins); recover
    bins from a sorted key with ``key >> frac_bits``.
    """
    n_rings, delta, lat_shift, az_shift, n_az_np, offs_np, n_bins = grid
    n_az = jnp.asarray(n_az_np)
    offs = jnp.asarray(offs_np)
    ring = jnp.clip(
        jnp.floor((lat + np.pi / 2) / delta + lat_shift).astype(jnp.int32),
        0, n_rings - 1)
    cells = n_az[ring]
    azbin = jnp.floor(az / (2.0 * np.pi) * cells + az_shift).astype(jnp.int32)
    azbin = jnp.where(azbin >= cells, azbin - cells, azbin)  # wrap
    bins = offs[ring] + azbin
    if v is not None:
        bins = jnp.where(v, bins, n_bins)  # padding -> overflow bin

    frac_bits = 30 - max(1, int(n_bins + 1)).bit_length()
    if frac_bits < 8:
        raise ValueError(
            f"binning too fine for an int32 sort key ({n_bins} bins); "
            f"lower safety/raise r_param")
    frac = jnp.clip(norms / jnp.maximum(scale, 1e-12), 0.0, 1.0 - 1e-6)
    key = jax.lax.stop_gradient(bins * (1 << frac_bits) + (
        frac * float(1 << frac_bits)).astype(jnp.int32))
    return key, frac_bits, n_bins


@partial(jax.jit, static_argnames=("r_param", "sharpness", "tau", "cap",
                                   "safety", "stratified_coverers"))
def hpr_mask_soft_binned(
    points: jnp.ndarray,
    r_param: float = 2.0,
    *,
    sharpness: float = 400.0,
    tau: float = 0.02,
    cap: int = 1024,
    safety: float = 3.0,
    stratified_coverers: bool = True,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Differentiable HPR at scale: direction-binned dominance, O(N·cap).

    Same smooth visibility as :func:`hpr_mask_soft` — σ(β(ρᵢ + τ·scale −
    softmaxⱼ cosθᵢⱼ·ρⱼ)) — but each point only competes against members of
    its own angular bin (see :func:`_binned_grids`: the coverer is always
    within ~θ_max of radial, so far-angle pairs contribute only sigmoid
    tail mass). Layout, end to end:

    - one sort per grid by (bin, ‖p‖): bin members become CONTIGUOUS with
      the closest (strongest-covering, largest ρ) members first;
    - a scan over fixed-size query tiles: each tile is a ``dynamic_slice``
      of ``cap`` consecutive sorted queries against the first ``cap``
      members of their bin — contiguous slices, so forward AND backward
      lower to dynamic(-update)-slice, never a row scatter;
    - per-grid soft maxima combine by elementwise max (union lower bound,
      under-counts duplicated pairs by ≤ ln4/β — below f32 noise).

    Approximation vs the dense form: exact to sigmoid-tail precision except
    in bins holding more than ``cap`` points, where only ``cap`` members
    act as coverers. With ``stratified_coverers`` (the default) those are
    a tiered distance-rank sample — the closest cap/4 plus every 2^(k+1)-th
    of each deeper tier (:func:`_stratified_priority`) — reaching ~16× cap
    deep; with it off, the plain closest-``cap`` prefix (round-3 behavior:
    on full cloud-10 that prefix missed the real occluders of points deep
    in over-full bins — their strongest dominator sits at rank 2-4× cap —
    leaking ~30% of the occluded mass to "visible"). Agreement vs exact
    Qhull is pinned in tests/test_hpr.py.

    ``valid`` follows the package convention: padded points contribute
    nothing and report 0. Returns (N,) visibility in (0, 1).

    Reverse-mode only: the sort helpers are custom_vjp, so
    jax.jvp/jacfwd through this kernel (or any soft_hpr loss built on it)
    raises; use :func:`hpr_mask_soft` where forward-mode is needed.
    """
    n = points.shape[0]
    cap = min(cap, n)
    norms = safe_norm(points, axis=-1)  # NaN-free gradient at ‖p‖ = 0 (see
    # hpr_mask_soft: scans contain sensor-origin points)
    if valid is not None:
        v = valid > 0
        norms_v = jnp.where(v, norms, 0.0)
    else:
        v = None
        norms_v = norms
    radius = jnp.maximum(jnp.max(norms_v), 1e-12) * 10.0 ** r_param
    rho = 2.0 * radius - norms
    scale = jax.lax.stop_gradient(jnp.maximum(jnp.max(norms_v), 1e-6))
    beta = sharpness / scale
    u = points / jnp.maximum(norms, 1e-12)[:, None]

    lat, az = _direction_angles(u)

    _, grids = _binned_grids(r_param, tau, safety)
    smax = jnp.full((n,), -_BIG_SOFT, jnp.float32)
    for grid in grids:
        # sort by (bin, distance): closest members of each bin first
        key, frac_bits, n_bins = _grid_bin_key(grid, lat, az, norms, scale, v)
        # ONE multi-operand sort carries the data along with the key
        # instead of a row gather per column after an argsort. The bin column
        # is not carried: it is recovered exactly from the sorted key by
        # shifting the distance bits back out. _cosort's custom VJP keeps
        # the backward to one row write per operand.
        key_s, u0_s, u1_s, u2_s, rho_s, perm = _cosort(
            key, u[:, 0], u[:, 1], u[:, 2], rho)
        bin_s = key_s >> frac_bits
        u_s = jnp.stack([u0_s, u1_s, u2_s], axis=1)

        # bins are sorted: member counts come from binary search, not a
        # bincount (which lowers to a row scatter)
        edges = jnp.searchsorted(bin_s, jnp.arange(n_bins + 1, dtype=bin_s.dtype))
        counts = edges[1:] - edges[:-1]
        starts = edges[:-1]

        # coverer layout: by default a SECOND (bin, stratified-priority)
        # sort re-orders each bin so its first ``cap`` rows are the tiered
        # distance-rank sample (see _stratified_priority) instead of the
        # plain closest-cap prefix. Rank-in-bin comes from a searchsorted
        # against the row's own bin (scatter/gather-free); the extra
        # 4-operand sort costs ~1 sort of N — the same discipline as the
        # layout sort. cov_pos carries each coverer row's LAYOUT-1 position
        # for the self-pair exclusion.
        strat = (stratified_coverers and cap < n
                 and (2 * n) < (1 << frac_bits))
        if strat:
            # rank-in-bin WITHOUT a searchsorted over all n rows (that
            # lowers to ~log n full-array gather passes): segment starts
            # via one cummax pass
            iota = jnp.arange(n, dtype=jnp.int32)
            seg_first = jnp.concatenate(
                [jnp.ones((1,), bool), bin_s[1:] != bin_s[:-1]])
            rank = iota - jax.lax.cummax(jnp.where(seg_first, iota, 0))
            prio = _stratified_priority(rank, max(cap // 4, 1), n)
            key2 = jax.lax.stop_gradient(bin_s * (1 << frac_bits) + prio)
            _, cov_u0, cov_u1, cov_u2, cov_rho, cov_pos = _cosort(
                key2, u0_s, u1_s, u2_s, rho_s)
            cov_u = jnp.stack([cov_u0, cov_u1, cov_u2], axis=1)
            cov_bin = bin_s  # same per-bin segments, re-ordered within
        else:
            cov_u, cov_rho, cov_bin = u_s, rho_s, bin_s
            cov_pos = jnp.arange(n, dtype=jnp.int32)
        tiles_per_bin = -(-counts // cap)  # ceil; 0 for empty bins
        tile_cum = jnp.concatenate(
            [jnp.zeros((1,), tiles_per_bin.dtype), jnp.cumsum(tiles_per_bin)])
        n_tiles_static = n_bins + -(-n // cap)

        slot = jnp.arange(n_tiles_static)
        tile_bin = jnp.clip(
            jnp.searchsorted(tile_cum, slot, side="right") - 1, 0, n_bins - 1)
        within = slot - tile_cum[tile_bin]
        tile_ok = within < tiles_per_bin[tile_bin]
        tile_qoff = jnp.clip(starts[tile_bin] + within * cap, 0, n - cap)
        tile_coff = jnp.clip(starts[tile_bin], 0, n - cap)

        @jax.checkpoint  # recompute the (cap, cap) tile in backward: saving
        # it per scan step held n_tiles·cap² residuals (18+ GB at 64k pts on
        # a 16 GB chip, measured OOM); remat keeps residuals O(cap)
        def tile_smax(b, qoff, coff, deep, u_s, rho_s, bin_s, cov_u, cov_rho,
                      cov_bin, cov_pos):
            qu = jax.lax.dynamic_slice(u_s, (qoff, 0), (cap, 3))
            qi = qoff + jnp.arange(cap)
            # chunk 0 of a bin ('deep'=False) keeps the EXACT closest-cap
            # prefix — every preceding member of its queries is inside it.
            # Deeper chunks read the stratified layout (the tiered sample
            # reaches the ranks where their occluders actually sit).
            cu = jnp.where(
                deep,
                jax.lax.dynamic_slice(cov_u, (coff, 0), (cap, 3)),
                jax.lax.dynamic_slice(u_s, (coff, 0), (cap, 3)))
            crho = jnp.where(
                deep,
                jax.lax.dynamic_slice(cov_rho, (coff,), (cap,)),
                jax.lax.dynamic_slice(rho_s, (coff,), (cap,)))
            cbin = jnp.where(
                deep,
                jax.lax.dynamic_slice(cov_bin, (coff,), (cap,)),
                jax.lax.dynamic_slice(bin_s, (coff,), (cap,)))
            # self-exclusion compares LAYOUT-1 positions (cov_pos maps
            # stratified coverer rows back)
            ci = jnp.where(deep,
                           jax.lax.dynamic_slice(cov_pos, (coff,), (cap,)),
                           coff + jnp.arange(cap))
            # elementwise broadcast (a K=3 contraction fuses into the
            # logsumexp like the dense path; a matmul would not)
            cos = (qu[:, 0:1] * cu[None, :, 0] + qu[:, 1:2] * cu[None, :, 1]
                   + qu[:, 2:3] * cu[None, :, 2])
            pair_ok = ((cbin[None, :] == b)
                       & (qi[:, None] != ci[None, :]))
            dom = jnp.where(pair_ok, jnp.maximum(cos, 0.0) * crho[None, :],
                            -_BIG_SOFT)
            return jax.nn.logsumexp(beta * dom, axis=1) / beta

        def body(carry, tile, u_s=u_s, rho_s=rho_s, bin_s=bin_s,
                 cov_u=cov_u, cov_rho=cov_rho, cov_bin=cov_bin,
                 cov_pos=cov_pos):
            b, qoff, coff, ok, deep = tile
            qbin = jax.lax.dynamic_slice(bin_s, (qoff,), (cap,))
            s = tile_smax(b, qoff, coff, deep, u_s, rho_s, bin_s,
                          cov_u, cov_rho, cov_bin, cov_pos)
            cur = jax.lax.dynamic_slice(carry, (qoff,), (cap,))
            upd = jnp.where((qbin == b) & ok, jnp.maximum(cur, s), cur)
            return jax.lax.dynamic_update_slice(carry, upd, (qoff,)), None

        tile_deep = strat & (within >= 1)
        smax_g = jnp.full((n,), -_BIG_SOFT, jnp.float32)
        smax_g, _ = jax.lax.scan(
            body, smax_g, (tile_bin, tile_qoff, tile_coff, tile_ok,
                           tile_deep))
        # un-permute by the saved perm: one write per row, no inverse
        # permutation and no gather (whose transpose is a scatter-add).
        smax_c = _unpermute(key, perm, smax_g)
        smax = jnp.maximum(smax, smax_c)

    out = jax.nn.sigmoid(beta * (rho + tau * scale - smax))
    if v is not None:
        out = out * v.astype(jnp.float32)
    return out


#: canonical soft-binned HPR knob defaults, read off the signature above —
#: the single source for internal callers that re-expose only a subset of
#: the knobs (parallel.pose_sharded hardcoded them once and drifted)
SOFT_BINNED_DEFAULTS = {
    k: p.default
    for k, p in inspect.signature(hpr_mask_soft_binned).parameters.items()
    if p.default is not inspect.Parameter.empty and k != "valid"
}
