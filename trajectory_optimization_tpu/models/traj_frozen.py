"""Frozen-routing occlusion-aware trajectory loss: host-planned soft HPR.

The occlusion-aware trajectory loss (``traj_forward(soft_hpr=True)``,
answering the reference's differentiable-HPR TODO `src/tools.py:61-62` at
trajectory scale, beyond the reference's per-waypoint loop
`src/model.py:210-217`) re-derives the binned-HPR routing — 4 sorts,
searchsorteds and tile tables per waypoint — inside EVERY Adam step, even
though the routing is ``stop_gradient``-ed and contributes nothing to the
gradient. This module splits the computation in two:

- **Refresh (host, every k steps)**: build a :class:`TrajPlan` — for each
  selected waypoint, gate the cloud down to the loss-relevant subset
  (points whose visibility score is non-negligible, plus every point close
  enough in angle+range to occlude one of them), route the survivors into
  the 4 staggered direction grids of :func:`ops.hpr.hpr_mask_soft_binned`,
  and pack bins into cap-aligned tiles (several small bins per tile —
  the per-step kernel's fixed ``cap``-sized tiles waste (cap/members)² of
  their work when bins are under-full, the dominant cost at reference
  scale: ~400 pts/bin vs cap=1024). All offsets become static data.

- **Step (device, jitted)**: ONE fused batched dominance computation over
  (W, grids, tiles, cap, cap) — no sorts, no gathers, no scatters, no
  scan. Cross-grid alignment and the plan→cloud embedding apply the plan's
  stored permutations via key-sorts wrapped in custom VJPs (the package's
  scatter-free sort discipline, ops.hpr). rho/u/score are recomputed from
  live params every step, so gradients are exact for the CURRENT pose;
  only the pairing (which points compete in which tile) is frozen between
  refreshes — precisely the part the kernel already stop-gradients.

Fidelity: at a refresh (drift 0) the gated loss matches
``traj_forward(soft_hpr=True, soft_hpr_dense_max=0)`` to gate-threshold
tolerance (pinned in tests/test_traj_frozen.py); between refreshes the
binning degrades gracefully with pose drift (the ``safety`` factor's
angular slack absorbs it) and the gate dilations (``drift_slack``) keep
newly-relevant points from being missed. Use ``refresh_every=1`` for
maximum fidelity; the default trades ≤1e-3-level loss deviation for a
cheaper per-step program.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from trajectory_optimization_tpu.models.traj import (
    TrajProblem,
    logodds_from_minmax,
    observation_logodds,
    traj_criterion,
    traj_criterion_from_mean,
)
from trajectory_optimization_tpu.ops.hpr import (
    _BIG_SOFT,
    _binned_grids,
    SOFT_BINNED_DEFAULTS as _HPR_DEF,
)
from trajectory_optimization_tpu.ops.numerics import safe_norm
from trajectory_optimization_tpu.ops.scores import (
    camera_frames,
    camera_planes,
    scores_from_planes,
)

_PAD_COORD = 1.0e6  # padding rows: huge norm -> rho ~ -2e6, can never cover


# ---------------------------------------------------------------------------
# host-side mirrors (the refresh runs in numpy on the host)
# ---------------------------------------------------------------------------


def _np_quat_matrices(quats: np.ndarray) -> np.ndarray:
    """(W, 4) wxyz -> (W, 3, 3); mirrors ops.quat.normalize+to_matrix."""
    q = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty(q.shape[:-1] + (3, 3), np.float64)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _np_scores(cam: np.ndarray, K: np.ndarray, problem) -> np.ndarray:
    """(N, 3) camera-frame points -> (N,) dist·fov score (ops.scores mirror).

    The plan only THRESHOLDS these (gate decisions are the plan's own
    choice, like the stop-gradiented bin routing), so numpy dtype vs the
    kernel's f32 is immaterial — the builder runs f32 (matches the device
    kernel's own routing dtype and halves host build time at 1M points).
    """
    c0 = (problem.min_dist + problem.max_dist) / 2.0
    inv_var = 1.0 / ((problem.max_dist - problem.min_dist) / 2.0) ** 2
    d2 = np.sum(np.square(cam - c0), axis=-1)
    dm = np.exp(-0.5 * d2 * inv_var)
    fx, fy, cx0, cy0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * cam[:, 0] + cx0 * cam[:, 2]
    v = fy * cam[:, 1] + cy0 * cam[:, 2]
    zd = cam[:, 2] + problem.eps
    zd = np.where(zd >= 0, np.maximum(zd, 1e-12), np.minimum(zd, -1e-12))
    xu = np.clip((u / zd - problem.img_width / 2.0) / problem.img_width, -20, 20)
    xv = np.clip((v / zd - problem.img_height / 2.0) / problem.img_height, -20, 20)
    fm = 1.0 / (1.0 + np.exp(-cam[:, 2])) * np.exp(-0.5 * (xu**2 + xv**2))
    return dm * fm


def _np_grid_bins(grid, lat: np.ndarray, az: np.ndarray) -> np.ndarray:
    """ops.hpr._grid_bin_key's routing, in numpy (ids only, no quantization)."""
    n_rings, delta, lat_shift, az_shift, n_az, offs, _n_bins = grid
    ring = np.clip(
        np.floor((lat + np.pi / 2) / delta + lat_shift).astype(np.int64),
        0, n_rings - 1)
    cells = n_az[ring]
    azbin = np.floor(az / (2.0 * np.pi) * cells + az_shift).astype(np.int64)
    azbin = np.where(azbin >= cells, azbin - cells, azbin)
    return offs[ring] + azbin


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrozenPlanConfig:
    """Knobs for the host-side plan builder.

    score_rel_thresh: a point is a loss-relevant QUERY when its visibility
      score exceeds this fraction of the waypoint's max score — below it,
      the normalized score lands under the 0.5 log-odds clip with zero
      value AND zero gradient (the pmin shift this induces is second-order,
      see models.traj.logodds_from_minmax).
    tail: logsumexp tail cutoff T — a coverer with β·(ρⱼcosθ − ρᵢ − τs)
      < −T shifts a query's sigmoid by < e^−T, so per grid a point is kept
      as a COVERER only when its own bin holds a query with
      normᵢ ≥ normⱼ − (T/sharpness − τ)·scale (dominance is same-bin only,
      so the test is per-bin-exact, not a global band).
    drift_slack: metres of pose motion the gates stay valid under between
      refreshes (added to the coverer norm band; angular drift is absorbed
      by the binning ``safety`` factor).
    tile_round: tiles-per-grid bucket granularity (jit cache friendliness).
    tile_ladder_ratio: tile counts round UP onto a geometric ladder
      (base=tile_round, each rung ≥ ratio x the previous) instead of just
      the next tile_round multiple. Active-set growth then crosses a
      handful of predictable rungs — each a one-off compile the runner
      pre-warms in the background (``prewarm``) — instead of recompiling
      at every +tile_round breath. Costs ≤ (ratio−1) padded-tile compute
      at steady state. 1.0 = plain rounding (no ladder).
    prewarm: compile the NEXT ladder rung's step program on a background
      thread whenever a new PlanMeta activates, so active-set growth never
      blocks a serving step on a 15-25 s XLA compile (it also seeds the
      persistent compile cache for future sessions).
    """

    refresh_every: int = 8
    score_rel_thresh: float = 1e-5
    tail: float = 12.0
    drift_slack: float = 0.5
    tile_round: int = 8
    tile_ladder_ratio: float = 1.15
    prewarm: bool = True
    # Build the next plan on a host thread WHILE device steps run on the
    # current one, swapping at the next refresh boundary (deterministic:
    # the plan applied at boundary b was built from the params at boundary
    # b−1, so the effective drift window is 2·refresh_every steps — the
    # gate slacks are sized for it). False = build synchronously at each
    # boundary from the current params (fidelity reference; used by tests).
    async_refresh: bool = True


@dataclasses.dataclass(frozen=True)
class PlanMeta:
    """Static (hashable) shape info of a TrajPlan — the jit cache key."""

    n_sel: int
    n_points: int
    cap: int
    n_grids: int
    tiles: int  # T per grid
    # tiles whose coverer span is NOT their own query span (big-bin query
    # chunks) — only these carry separate coverer data; everything else
    # reuses the query arrays on device (self-covering), which keeps the
    # per-refresh host->device plan transfer ~40% smaller
    t_big: int = 1

    @property
    def rows(self) -> int:  # M = tiles * cap
        return self.tiles * self.cap


def _ladder_ceil(n: int, base: int, ratio: float) -> int:
    """Smallest rung ≥ n of the geometric ladder {base, ~base·ratio^k}
    (each rung a multiple of ``base``, strictly increasing). ratio ≤ 1
    degrades to plain ceil-to-base."""
    if ratio <= 1.0:
        return max(-(-int(n) // base) * base, base)
    v = base
    while v < n:
        v = max(-(-int(v * ratio) // base) * base, v + base)
    return v


def _ladder_next(v: int, base: int, ratio: float) -> int:
    """The rung after ``v`` (assumes ``v`` is on the ladder)."""
    if ratio <= 1.0:
        return v + base
    return max(-(-int(v * ratio) // base) * base, v + base)


def _np_stratified_ranks(count: int, cap: int) -> np.ndarray:
    """Numpy mirror of ops.hpr._stratified_priority's selection: the first
    ``cap`` in-bin distance ranks in tiered-priority order (all of the
    closest cap/4, then every 2^(k+1)-th of tier k; unselected ranks fill
    any remaining budget in distance order)."""
    base = max(cap // 4, 1)
    r = np.arange(count, dtype=np.int64)
    rb = np.maximum(r // base, 1)
    k = np.floor(np.log2(rb)).astype(np.int64)
    sel = (r < base) | ((r < 16 * base)
                        & ((r & ((1 << (k + 1)) - 1)) == 0))
    order = np.concatenate([r[sel], r[~sel]])
    return order[: min(cap, count)]


def _layout_grid(ids_sorted: np.ndarray, bins_sorted: np.ndarray, cap: int):
    """Pack one grid's (bin, distance)-sorted active points into cap-aligned
    tiles. Returns (row_ids, tile_coffs, tile_bigcnt): row_ids has -1
    padding; tile t's queries are rows [t·cap, (t+1)·cap); tile_bigcnt[t]
    is the tile's bin member count when the tile is a big-bin chunk
    (0 otherwise) — the assembly uses it to pick stratified coverers for
    the deep chunks.

    Small bins (≤ cap) are packed first-fit-decreasing, several to a tile
    (coff = own tile ⇒ coverers = the whole tile, restricted to same-bin
    pairs by the bin-id test — exactly the bin's full member set; row order
    inside a tile is irrelevant to the math). A bin larger than cap gets a
    dedicated tile-aligned span: queries chunked per tile; chunk 0's
    coverers are the span's FIRST cap rows (exact — every possible
    dominator of a rank<cap query is nearer, i.e. inside the prefix);
    deeper chunks get the tiered distance-rank sample
    (:func:`_np_stratified_ranks`) — the same rules as
    hpr_mask_soft_binned's stratified coverer layout.
    """
    if len(bins_sorted):
        cut = np.flatnonzero(np.diff(bins_sorted)) + 1
        starts = np.concatenate([[0], cut]).astype(np.int64)
        ends = np.concatenate([cut, [len(bins_sorted)]]).astype(np.int64)
    else:
        starts = ends = np.zeros(0, np.int64)
    counts = ends - starts

    big = np.flatnonzero(counts > cap)
    small = np.flatnonzero(counts <= cap)
    # first-fit-decreasing over the small bins
    order = small[np.argsort(-counts[small], kind="stable")]
    tiles: list[list[int]] = []   # small-bin groups per tile
    space: list[int] = []         # remaining capacity per tile
    for g in order:
        c = int(counts[g])
        for t, sp in enumerate(space):
            if sp >= c:
                tiles[t].append(g)
                space[t] -= c
                break
        else:
            tiles.append([g])
            space.append(cap - c)

    rows: list[np.ndarray] = []
    coffs: list[int] = []
    bigcnt: list[int] = []
    n_rows = 0
    for t, groups in enumerate(tiles):
        coffs.append(n_rows)
        bigcnt.append(0)
        used = 0
        for g in groups:
            rows.append(ids_sorted[starts[g]:ends[g]])
            used += int(counts[g])
        if used < cap:
            rows.append(np.full(cap - used, -1, np.int64))
        n_rows += cap
    for g in big:
        span = n_rows
        c = int(counts[g])
        nt = -(-c // cap)
        rows.append(ids_sorted[starts[g]:ends[g]])
        pad = nt * cap - c
        if pad:
            rows.append(np.full(pad, -1, np.int64))
        n_rows += nt * cap
        coffs.extend(span for _ in range(nt))
        bigcnt.extend(c for _ in range(nt))
    if not coffs:  # empty grid: one all-padding tile
        coffs.append(0)
        bigcnt.append(0)
        rows.append(np.full(cap, -1, np.int64))
        n_rows += cap
    return (np.concatenate(rows), np.asarray(coffs, np.int64),
            np.asarray(bigcnt, np.int64))


def build_traj_plan(
    points: np.ndarray,
    valid: Optional[np.ndarray],
    poses_sel: np.ndarray,
    quats_sel: np.ndarray,
    K: np.ndarray,
    problem: TrajProblem,
    cfg: FrozenPlanConfig = FrozenPlanConfig(),
    min_tiles: int = 1,
    min_t_big: int = 1,
    owner: Optional[Tuple[int, int]] = None,
    wp_active: Optional[np.ndarray] = None,
    embed: bool = True,
) -> Tuple[Dict[str, np.ndarray], PlanMeta]:
    """Build the frozen routing plan for the selected waypoints (host-side).

    ``min_tiles`` floors the per-grid tile count T: the runner passes the
    largest T it has seen so successive refreshes keep ONE PlanMeta (= one
    compiled program) instead of recompiling whenever the active set
    breathes across a tile_round boundary.

    ``owner=(lo, hi)`` builds a POINT-SHARD slice of the plan (the
    multi-chip composition, parallel.traj_frozen_sharded): only points
    with lo <= id < hi become queries, and the embedding maps plan rows
    into the LOCAL id range [0, hi-lo) — while coverers still come from
    the full cloud (occluders don't respect shard boundaries; duplicating
    them across shards is correct because each query's dominance max uses
    every coverer exactly once, on its owner's shard). The per-bin coverer
    band then keys off the OWNED queries only — a subset of the
    single-chip band that still contains every coverer relevant to an
    owned query (same-bin dominance + the logsumexp tail bound), so the
    union over shards reproduces the single-chip gate to tail tolerance.

    ``wp_active`` (bool, per selected waypoint) marks dummy padding
    waypoints False: they get all-padding layouts (zero queries, zero
    gradient) instead of real routing — the sharded step pads W to the
    mesh axis with weight-0 dummies.

    Returns (plan arrays, meta). Plan arrays (device-put by the caller):
      q_xyz   (W,G,M,3) world coords in layout order (_PAD_COORD padding)
      c_xyz_ext (W,G,TB,cap,3) coverer coords for non-self tiles
      q_bin/c_bin_ext int16 bin ids (-1 padding)
      align_fwd/align_bwd (W,G,M) int32 grid→grid-0 permutation keys
      embed_fwd/embed_bwd (W,M+n_emb) int32 plan→cloud embedding keys
      (n_emb = hi-lo under ``owner``, the full cloud size otherwise)
    """
    # f32 throughout the per-point host math: every output is either a
    # threshold decision (gates, bins — the device kernel itself routes in
    # f32) or re-derived exactly on device from live params; f64 here only
    # doubled the build time (measured ~2x at 1M points)
    pts = np.asarray(points, np.float32)
    n = len(pts)
    v = (np.ones(n, bool) if valid is None
         else np.asarray(valid) > 0)
    lo_own, hi_own = (0, n) if owner is None else owner
    n_emb = hi_own - lo_own
    owned = np.zeros(n, bool)
    owned[lo_own:hi_own] = True
    min_tiles = int(min_tiles)
    K = np.asarray(K, np.float64)
    poses_sel = np.asarray(poses_sel, np.float64)
    quats_sel = np.asarray(quats_sel, np.float64)
    w_sel = len(poses_sel)
    cap = min(problem.hpr_cap, n)
    tau = _HPR_DEF["tau"]
    sharpness = _HPR_DEF["sharpness"]
    r_param = _HPR_DEF["r_param"]
    theta_max, grids = _binned_grids(r_param, tau, problem.hpr_safety)
    G = len(grids)
    # bin ids ride int16 to the device (plan['q_bin']/['c_bin_ext']); the
    # defaults give ~10² bins, but _grid_bin_key itself allows up to ~4M —
    # fail loudly instead of silently wrapping the same-bin dominance test
    # if a future r_param/safety change ever gets this far
    n_bins_max = max(g[-1] for g in grids)
    if n_bins_max >= 32768:
        raise ValueError(
            f"binned grids produced {n_bins_max} bins >= 2**15; widen the "
            "plan's bin-id dtype to int32 before raising r_param/safety "
            "this far")
    Rs = _np_quat_matrices(quats_sel).astype(np.float32)
    poses32 = poses_sel.astype(np.float32)

    per_wp = []  # (g_rows (G,), g_coffs (G,), g_bins (G,), q_rel)
    max_tiles = 1
    for w in range(w_sel):
        cam = (pts - poses32[w]) @ Rs[w]
        norms = np.linalg.norm(cam, axis=1)
        score = np.where(v, _np_scores(cam, K, problem), 0.0)
        smax = score.max()
        q_rel = v & (score > cfg.score_rel_thresh * max(smax, 1e-300))
        if not q_rel.any():
            q_rel = v.copy()  # degenerate: keep everything (blind waypoint)
        # owner restriction AFTER the global gate/fallback: the query SET
        # partitions exactly across shards (union = the single-chip set)
        q_rel &= owned
        if wp_active is not None and not wp_active[w]:
            q_rel = np.zeros(n, bool)  # dummy waypoint: empty layout
        scale = max(norms[v].max() if v.any() else 1.0, 1e-6)
        # a point only matters as a coverer when ITS OWN BIN holds a query
        # within the logsumexp tail's norm band (dominance is same-bin
        # only, so the test is exact per grid, not a global band)
        slack = max(0.0, cfg.tail / sharpness - tau) * scale + cfg.drift_slack
        u = cam / np.maximum(norms, 1e-12)[:, None]
        lat = np.arcsin(np.clip(u[:, 2], -1.0, 1.0))
        az = np.arctan2(u[:, 1], u[:, 0]) + np.pi
        g_rows, g_coffs, g_bins, g_bigs = [], [], [], []
        for grid in grids:
            n_bins = grid[-1]
            bins = _np_grid_bins(grid, lat, az)
            qmax = np.full(n_bins, -np.inf)
            np.maximum.at(qmax, bins[q_rel], norms[q_rel])
            keep = v & (norms <= qmax[bins] + slack)  # queries pass trivially
            active = np.flatnonzero(keep)
            order = np.lexsort((norms[active], bins[active]))
            row_ids, coffs, bigcnt = _layout_grid(
                active[order], bins[active][order], cap)
            g_rows.append(row_ids)
            g_coffs.append(coffs)
            g_bigs.append(bigcnt)
            g_bins.append(bins)
            max_tiles = max(max_tiles, len(coffs))
        per_wp.append((g_rows, g_coffs, g_bins, q_rel, g_bigs))

    T = max(_ladder_ceil(max_tiles, cfg.tile_round, cfg.tile_ladder_ratio),
            min_tiles)
    M = T * cap
    # meta is finalized after the assembly loop (t_big needs the layouts)

    q_id = np.full((w_sel, G, M), -1, np.int64)
    q_bin = np.full((w_sel, G, M), -1, np.int64)
    coff_arr = np.zeros((w_sel, G, T), np.int64)
    qmask = np.zeros((w_sel, G, M), bool)
    align_fwd = np.empty((w_sel, G, M), np.int64)
    align_bwd = np.empty((w_sel, G, M), np.int64)
    if embed:
        embed_fwd = np.empty((w_sel, M + n_emb), np.int64)
        embed_bwd = np.empty((w_sel, M + n_emb), np.int64)
    ids_all = np.full((w_sel, M), -1, np.int64)  # grid-0 rows' local ids
    n_q_arr = np.zeros(w_sel, np.int64)
    ar_m = np.arange(M)
    for w in range(w_sel):
        g_rows, g_coffs, g_bins, q_rel, _ = per_wp[w]
        # grid-0 row of every query point (queries are in every grid)
        g0 = np.full(M, -1, np.int64)
        g0[: len(g_rows[0])] = g_rows[0]
        valid0 = g0 >= 0
        qmask0 = np.zeros(M, bool)
        qmask0[valid0] = q_rel[g0[valid0]]
        pos0_q = np.full(n, -1, np.int64)
        pos0_q[g0[qmask0]] = ar_m[qmask0]
        nonq_pool = ar_m[~qmask0]  # grid-0 slots not holding a query
        for g in range(G):
            rows = g_rows[g]
            q_id[w, g, : len(rows)] = rows
            coffs = np.full(T, -1, np.int64)
            coffs[: len(g_coffs[g])] = g_coffs[g]
            # padding tiles cover themselves (all-pad rows)
            coffs[len(g_coffs[g]):] = ar_m[len(g_coffs[g]) * cap:: cap][
                : T - len(g_coffs[g])]
            coff_arr[w, g] = coffs
            qi = q_id[w, g]
            ok = qi >= 0
            q_bin[w, g, ok] = g_bins[g][qi[ok]]
            is_q = np.zeros(M, bool)
            is_q[ok] = q_rel[qi[ok]]
            qmask[w, g] = is_q

            # grid→grid-0 alignment: query rows go to the SAME point's
            # grid-0 row (smax must merge across grids per query); all
            # other rows (coverer-only, padding — their smax is masked to
            # −BIG in the kernel) fill the remaining slots bijectively
            fwd = np.empty(M, np.int64)
            fwd[is_q] = pos0_q[qi[is_q]]
            fwd[~is_q] = nonq_pool[: (~is_q).sum()]
            align_fwd[w, g] = fwd
            inv = np.empty(M, np.int64)
            inv[fwd] = ar_m
            align_bwd[w, g] = inv

        # sparse-criterion bookkeeping: grid-0 query rows' local ids + count
        loc0 = g0[qmask0] - lo_own  # owned query points' local ids
        ids_all[w, ar_m[qmask0]] = loc0
        n_q_arr[w] = int(qmask0.sum())
        if not embed:
            continue
        # plan(grid-0) → cloud embedding keys (see _make_perm_apply):
        # slots are [M plan rows, n_emb extension]; sort by fwd key, take
        # [:n_emb]. Only QUERY rows land at their canonical position —
        # coverer-only and padding rows sort past the end, so every
        # non-query point reads exactly 0 (the gate semantics). Canonical
        # positions are LOCAL under ``owner`` (global id − lo).
        fwd = np.empty(M + n_emb, np.int64)
        fwd[ar_m[qmask0]] = loc0
        nonq_pts = np.ones(n_emb, bool)
        nonq_pts[loc0] = False
        ext = np.arange(M, M + n_emb)
        fwd[ext[nonq_pts]] = np.flatnonzero(nonq_pts)  # fillers (0-valued)
        rest = np.concatenate([ar_m[~qmask0], ext[~nonq_pts]])
        fwd[rest] = np.arange(n_emb, n_emb + len(rest))
        embed_fwd[w] = fwd
        # backward: cotangent slots are [n_emb canonical, M zero-extension];
        # sort by bwd key, take [:M] = plan-row-ordered cotangents
        bwd = np.empty(M + n_emb, np.int64)
        bwd[loc0] = ar_m[qmask0]
        zslots = np.arange(n_emb, n_emb + M)
        bwd[zslots[: (~qmask0).sum()]] = ar_m[~qmask0]
        rest_dst = np.arange(M, M + n_emb)
        rest_src = np.concatenate([np.flatnonzero(nonq_pts),
                                   zslots[(~qmask0).sum():]])
        bwd[rest_src] = rest_dst
        embed_bwd[w] = bwd

    # Coverer data: a tile whose coverer span IS its own query span (all
    # packed small-bin tiles — nearly every tile at reference scale)
    # reuses the query arrays on device; only big-bin query-chunk tiles
    # carry separate coverer rows, compacted into (W, G, TB, cap) ext
    # arrays — this roughly halves the per-refresh plan transfer.
    self_tile = coff_arr == (np.arange(T, dtype=np.int64) * cap)[None, None]
    # round TB up and floor it at the runner's max-seen (like T): t_big is
    # part of PlanMeta, so letting it drift per refresh would recompile
    # the step program every boundary (measured: a recompile storm)
    TB = max(_ladder_ceil(int((~self_tile).sum(axis=2).max()), 4,
                          cfg.tile_ladder_ratio), 4, int(min_t_big))
    meta = PlanMeta(n_sel=w_sel, n_points=n_emb, cap=cap, n_grids=G, tiles=T,
                    t_big=TB)
    strat = bool(_HPR_DEF.get("stratified_coverers", True))
    c_sel = np.full((w_sel, G, T), -1, np.int64)
    c_sel_inv = np.full((w_sel, G, TB), -1, np.int64)  # slot -> its one tile
    c_id_ext = np.full((w_sel, G, TB, cap), -1, np.int64)
    c_bin_ext = np.full((w_sel, G, TB, cap), -1, np.int64)
    c_row_ext = np.full((w_sel, G, TB, cap), -1, np.int64)  # layout rows
    for w in range(w_sel):
        g_bins = per_wp[w][2]
        g_bigs = per_wp[w][4]
        for g in range(G):
            for k, t in enumerate(np.flatnonzero(~self_tile[w, g])):
                c_sel[w, g, t] = k
                c_sel_inv[w, g, k] = t
                off = coff_arr[w, g, t]
                cnt = int(g_bigs[g][t]) if t < len(g_bigs[g]) else 0
                if strat and cnt > cap:
                    # deep chunk of a big bin: tiered distance-rank sample
                    # over the WHOLE bin (mirrors the per-step kernel's
                    # stratified coverer layout — chunk 0 stays a self
                    # tile = the exact closest-cap prefix)
                    pos = off + _np_stratified_ranks(cnt, cap)
                else:
                    pos = off + np.arange(cap)
                rows = q_id[w, g][pos]
                c_id_ext[w, g, k, : len(rows)] = rows
                c_row_ext[w, g, k, : len(rows)] = pos
                okr = rows >= 0
                c_bin_ext[w, g, k, : len(rows)][okr] = g_bins[g][rows[okr]]

    # sparse criterion tail (traj_forward_frozen_mean): group every
    # (w, grid-0 row) QUERY entry by canonical id — one stored permutation
    # over the W·M entries (tiny next to the embed keys it replaces) plus
    # a segment-head mask for the device-side O(log W) fused suffix-sum
    flat = ids_all.reshape(-1)
    wm = flat.shape[0]
    order = np.argsort(np.where(flat >= 0, flat, n_emb), kind="stable")
    combine_bwd = order
    combine_fwd = np.empty(wm, np.int64)
    combine_fwd[order] = np.arange(wm)
    sorted_ids = flat[order]
    seg_head = (sorted_ids >= 0) & np.concatenate(
        [[True], sorted_ids[1:] != sorted_ids[:-1]])

    pad3 = np.full(3, _PAD_COORD)
    pts_ext = np.concatenate([pts, pad3[None]], axis=0)  # id -1 -> padding
    # self-exclusion on device compares LAYOUT ROWS (each point appears
    # once per grid layout), so the id arrays never go to the device; bins
    # ride int16 (n_bins ~10²). c_row_ext carries the ext coverers'
    # layout rows (stratified picks are non-contiguous).
    plan = {
        "q_xyz": pts_ext[q_id].astype(np.float32),
        "c_xyz_ext": pts_ext[c_id_ext].astype(np.float32),
        "q_bin": q_bin.astype(np.int16),
        "c_bin_ext": c_bin_ext.astype(np.int16),
        "c_sel": c_sel.astype(np.int32),
        "c_sel_inv": c_sel_inv.astype(np.int32),
        "c_row_ext": c_row_ext.astype(np.int32),
        "qmask": qmask,
        "align_fwd": align_fwd.astype(np.int32),
        "align_bwd": align_bwd.astype(np.int32),
        "combine_fwd": combine_fwd.astype(np.int32),
        "combine_bwd": combine_bwd.astype(np.int32),
        "seg_head": seg_head,
        "n_q": n_q_arr.astype(np.int32),
        # host-only diagnostics (underscored keys stay on the host)
        "_q_id": q_id.astype(np.int32),
    }
    if embed:
        plan["embed_fwd"] = embed_fwd.astype(np.int32)
        plan["embed_bwd"] = embed_bwd.astype(np.int32)
    return plan, meta


# ---------------------------------------------------------------------------
# scatter-free stored-permutation application (custom VJP)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _make_perm_apply(n_in: int, n_out: int, fill: float):
    """Build a batched stored-permutation apply with a custom VJP.

    The returned ``apply(fwd_key, bwd_key, x)`` pads ``x`` (..., n_in) with
    ``fill`` to the key length n_ext, sorts the last axis by ``fwd_key``
    (a permutation of 0..n_ext-1 per batch row) and slices to (..., n_out).
    The backward sorts the cotangent by ``bwd_key`` (the stored inverse
    permutation) — never lax.sort's scatter-add transpose. Reverse-mode
    only.
    """

    @jax.custom_vjp
    def apply(fwd_key, bwd_key, x):
        out, _ = fwd(fwd_key, bwd_key, x)
        return out

    def fwd(fwd_key, bwd_key, x):
        pad = fwd_key.shape[-1] - n_in
        xp = jnp.concatenate(
            [x, jnp.full(x.shape[:-1] + (pad,), fill, x.dtype)], axis=-1)
        _, out = jax.lax.sort((fwd_key, xp), num_keys=1, dimension=-1)
        return out[..., :n_out], bwd_key

    def bwd(bwd_key, cot):
        pad = bwd_key.shape[-1] - n_out
        cp = jnp.concatenate(
            [cot, jnp.zeros(cot.shape[:-1] + (pad,), cot.dtype)], axis=-1)
        _, g = jax.lax.sort((bwd_key, cp), num_keys=1, dimension=-1)
        return (None, None, g[..., :n_in])

    apply.defvjp(fwd, bwd)
    return apply


def perm_apply(fwd_key, bwd_key, x, fill, n_out: int):
    """Batched stored-permutation apply (see _make_perm_apply)."""
    return _make_perm_apply(x.shape[-1], n_out, float(fill))(
        fwd_key, bwd_key, x)


@jax.custom_vjp
def _select_ext(ext, self_vals, sel, inv):
    """Per-tile coverer pick: ``where(sel < 0, self_vals, ext[sel])`` along
    the tile axis, with a GATHER transpose.

    ``ext`` is (W, G, TB, cap[, 3]) compact non-self coverer data; ``sel``
    (W, G, T) maps tile → ext slot (−1 = self-covering tile, which reads
    ``self_vals`` (W, G, T, cap[, 3]) instead). ``sel`` is INJECTIVE per
    (w, g) — each ext slot feeds exactly one tile — so the autodiff
    transpose (a scatter-add over (W·G·T·cap) rows) collapses to a
    tile-block gather by the host-stored inverse ``inv`` (W, G, TB),
    tile index per slot, −1 = slot unused.
    """
    out, _ = _select_ext_fwd(ext, self_vals, sel, inv)
    return out


def _expand(idx, ndim):
    """(W, G, X) int → (W, G, X, 1[, 1]) for take_along_axis on axis 2."""
    return idx.reshape(idx.shape + (1,) * (ndim - idx.ndim))


def _select_ext_fwd(ext, self_vals, sel, inv):
    is_self = sel < 0
    picked = jnp.take_along_axis(ext, _expand(jnp.maximum(sel, 0), ext.ndim),
                                 axis=2)
    out = jnp.where(_expand(is_self, ext.ndim), self_vals, picked)
    return out, (sel, inv)


def _select_ext_bwd(res, cot):
    sel, inv = res
    is_self = _expand(sel < 0, cot.ndim)
    d_self = jnp.where(is_self, cot, 0.0)
    cot_ext_src = jnp.where(is_self, 0.0, cot)
    gathered = jnp.take_along_axis(
        cot_ext_src, _expand(jnp.maximum(inv, 0), cot.ndim), axis=2)
    d_ext = jnp.where(_expand(inv >= 0, cot.ndim), gathered, 0.0)
    return d_ext, d_self, None, None


_select_ext.defvjp(_select_ext_fwd, _select_ext_bwd)


# ---------------------------------------------------------------------------
# the per-step device computation
# ---------------------------------------------------------------------------


def _cam_planes_nd(xyz, R, tR):
    """(W, *batch, 3) world coords -> camera-frame (..., 3) under
    per-waypoint (R, t·R): broadcast FMAs (a K=3 contraction gains nothing
    from a matmul unit, ops.scores). Any number of batch dims after the leading W."""
    px, py, pz = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    ones = (1,) * (xyz.ndim - 2)
    Rb = R.reshape((R.shape[0],) + ones + (3, 3))
    tb = tR.reshape((tR.shape[0],) + ones + (3,))
    cx = px * Rb[..., 0, 0] + py * Rb[..., 1, 0] + pz * Rb[..., 2, 0] - tb[..., 0]
    cy = px * Rb[..., 0, 1] + py * Rb[..., 1, 1] + pz * Rb[..., 2, 1] - tb[..., 1]
    cz = px * Rb[..., 0, 2] + py * Rb[..., 1, 2] + pz * Rb[..., 2, 2] - tb[..., 2]
    return jnp.stack([cx, cy, cz], axis=-1)


def _frozen_vis(
    plan: Dict[str, jnp.ndarray],
    meta: PlanMeta,
    quats_sel: jnp.ndarray,
    poses_sel: jnp.ndarray,
    points: jnp.ndarray,
    K: jnp.ndarray,
    problem: TrajProblem,
    valid: Optional[jnp.ndarray] = None,
    *,
    norm_allreduce=None,
    need_score: bool = True,
):
    """Shared frozen-plan core: everything up to the per-query visibility.

    Returns (vis (W, M) in grid-0 layout order, score (W, N) or None,
    qcam0 (W, M, 3) grid-0 camera-frame coords). ``need_score=False``
    skips the full-cloud score pass (the sparse training path recomputes
    scores only at query rows from qcam0); the full-cloud camera planes
    are still needed for the per-waypoint flip radius.
    """
    W, cap, T, M = meta.n_sel, meta.cap, meta.tiles, meta.rows
    tau = _HPR_DEF["tau"]
    sharpness = _HPR_DEF["sharpness"]
    r_param = _HPR_DEF["r_param"]

    # full-cloud scores + per-waypoint flip radius (exact, every step)
    cxp, cyp, czp = camera_planes(points, quats_sel, poses_sel)
    score = None
    if need_score:
        score = scores_from_planes(
            cxp, cyp, czp, K, problem.img_width, problem.img_height,
            min_dist=problem.min_dist, max_dist=problem.max_dist,
            eps=problem.eps)  # (W, N)
    n2 = cxp * cxp + cyp * cyp + czp * czp
    if valid is not None:
        n2 = jnp.where(valid[None, :] > 0, n2, 0.0)
    maxnorm = jnp.sqrt(jnp.max(n2, axis=-1))  # (W,)
    if norm_allreduce is not None:
        maxnorm = norm_allreduce(maxnorm)
    radius = jnp.maximum(maxnorm, 1e-12) * 10.0 ** r_param
    scale = jax.lax.stop_gradient(jnp.maximum(maxnorm, 1e-6))
    beta = sharpness / scale  # (W,)

    R, tR = camera_frames(quats_sel, poses_sel)
    qcam = _cam_planes_nd(plan["q_xyz"], R, tR)  # (W, G, M, 3)
    qn = safe_norm(qcam, axis=-1)
    rad_b = radius[:, None, None]
    q_rho = 2.0 * rad_b - qn
    qu = qcam / jnp.maximum(qn, 1e-12)[..., None]

    # coverers: self-covering tiles (coff == own span — nearly all) reuse
    # the query data; big-bin query-chunk tiles pick their rows from the
    # compact (W, G, TB, cap) ext arrays (a coarse per-tile gather)
    ccam_ext = _cam_planes_nd(plan["c_xyz_ext"], R, tR)  # (W, G, TB, cap, 3)
    cn_ext = safe_norm(ccam_ext, axis=-1)
    c_rho_ext = 2.0 * radius[:, None, None, None] - cn_ext
    cu_ext = ccam_ext / jnp.maximum(cn_ext, 1e-12)[..., None]

    G = meta.n_grids
    qv = qu.reshape(W, G, T, cap, 3)
    sel = plan["c_sel"]  # (W, G, T); -1 = self-covering tile
    sel_inv = plan["c_sel_inv"]
    selc = jnp.maximum(sel, 0)
    is_self = sel < 0
    cv = _select_ext(cu_ext, qv, sel, sel_inv)
    # (W, G, T, cap, cap) dominance tiles — elementwise producers that fuse
    # into the logsumexp (the dense-kernel discipline, ops.hpr)
    cos = (qv[..., :, None, 0] * cv[..., None, :, 0]
           + qv[..., :, None, 1] * cv[..., None, :, 1]
           + qv[..., :, None, 2] * cv[..., None, :, 2])
    qb = plan["q_bin"].reshape(W, G, T, cap)
    cb = jnp.where(is_self[..., None], qb,
                   jnp.take_along_axis(plan["c_bin_ext"],
                                       selc[..., None], axis=2))
    # self-exclusion by LAYOUT ROW: each point appears exactly once per
    # grid layout, so a query row and a coverer row are the same point iff
    # they are the same row — no id arrays needed on device. Self tiles
    # cover themselves (rows = own span); ext tiles carry their
    # (stratified, non-contiguous) coverer rows in c_row_ext.
    q_row = (jnp.arange(T, dtype=jnp.int32)[:, None] * cap
             + jnp.arange(cap, dtype=jnp.int32)[None, :])  # (T, cap)
    c_row = jnp.where(
        is_self[..., None], q_row[None, None],
        jnp.take_along_axis(plan["c_row_ext"], selc[..., None], axis=2))
    crho_t = _select_ext(c_rho_ext, q_rho.reshape(W, G, T, cap), sel,
                         sel_inv)
    pair_ok = ((qb[..., :, None] == cb[..., None, :])
               & (qb[..., :, None] >= 0)
               & (q_row[None, None, :, :, None] != c_row[..., None, :]))
    beta_b = beta[:, None, None, None]
    dom = jnp.where(pair_ok, jnp.maximum(cos, 0.0) * crho_t[..., None, :],
                    -_BIG_SOFT)
    smax = jax.nn.logsumexp(beta_b[..., None] * dom, axis=-1) / beta_b
    smax = smax.reshape(W, G, M)

    # active sets differ per grid: only QUERY rows carry meaningful smax
    # into the cross-grid merge (coverer-only rows would land on arbitrary
    # grid-0 slots through the alignment permutation otherwise)
    smax = jnp.where(plan["qmask"], smax, -_BIG_SOFT)

    # cross-grid combine in grid-0 layout order, then σ(β(ρ + τs − smax))
    smax0 = perm_apply(plan["align_fwd"], plan["align_bwd"], smax,
                       -_BIG_SOFT, M)
    smax_all = jnp.max(smax0, axis=1)  # (W, M)
    vis = jax.nn.sigmoid(
        beta[:, None] * (q_rho[:, 0] + tau * scale[:, None] - smax_all))
    return vis, score, qcam[:, 0]


def frozen_soft_hpr_scores(
    plan: Dict[str, jnp.ndarray],
    meta: PlanMeta,
    quats_sel: jnp.ndarray,
    poses_sel: jnp.ndarray,
    points: jnp.ndarray,
    K: jnp.ndarray,
    problem: TrajProblem,
    valid: Optional[jnp.ndarray] = None,
    *,
    norm_allreduce=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(W, N) occlusion-gated visibility scores hpr·p under the frozen plan.

    Returns (gated_scores, hpr) — both (W_sel, N); points outside the
    plan's active set get exactly 0 (their score is below the gate
    threshold, see FrozenPlanConfig). Differentiable in (quats_sel,
    poses_sel); reverse-mode only (the stored-permutation custom VJPs).
    Requires a plan built with ``embed=True`` (the default).

    ``norm_allreduce`` (multi-chip composition): maps the per-waypoint max
    point norm (W,) computed over the LOCAL ``points`` to the global
    maximum — under shard_map, an all_gather+max over the point axis —
    so the flip radius and sharpness scale match the single-chip values
    exactly. None (default) = ``points`` is the whole cloud already.
    """
    vis, score, _ = _frozen_vis(
        plan, meta, quats_sel, poses_sel, points, K, problem, valid,
        norm_allreduce=norm_allreduce, need_score=True)
    # embed plan rows into the cloud; inactive/padding -> 0
    hpr = perm_apply(plan["embed_fwd"], plan["embed_bwd"], vis, 0.0,
                     meta.n_points)
    return hpr * score, hpr


def traj_forward_frozen(
    params,
    plan: Dict[str, jnp.ndarray],
    meta: PlanMeta,
    points: jnp.ndarray,
    K: jnp.ndarray,
    poses0: jnp.ndarray,
    quats0: jnp.ndarray,
    problem: TrajProblem,
    *,
    valid: Optional[jnp.ndarray] = None,
):
    """traj_forward(soft_hpr=True) under a frozen routing plan.

    Same (loss, aux) contract as models.traj.traj_forward; the plan must
    have been built for the problem's CURRENT selected waypoints
    (params['poses'][::wps_step] at some refresh point ≤ drift_slack away).
    """
    sel = slice(None, None, problem.wps_step)
    quats_sel, poses_sel = params["quats"][sel], params["poses"][sel]
    gated, _ = frozen_soft_hpr_scores(
        plan, meta, quats_sel, poses_sel, points, K, problem, valid)
    lo = observation_logodds(gated, problem.eps, valid)  # (W, N)
    lo_sum = jnp.sum(lo, axis=0)
    return traj_criterion(lo_sum, params, poses0, problem, valid=valid)


def traj_forward_frozen_mean(
    params,
    plan: Dict[str, jnp.ndarray],
    meta: PlanMeta,
    points: jnp.ndarray,
    K: jnp.ndarray,
    poses0: jnp.ndarray,
    quats0: jnp.ndarray,
    problem: TrajProblem,
    *,
    valid: Optional[jnp.ndarray] = None,
):
    """traj_forward_frozen WITHOUT materializing the (N,) rewards — the
    production training step (the runner only consumes scalar aux).

    Everything the criterion needs from the cloud reduces to the mean
    reward, and every point outside the plan's query set contributes
    exactly σ(0) = 1/2 to it. So the tail runs entirely in PLAN space:
    scores recomputed at the (W, M) grid-0 query rows (not the full
    cloud), per-waypoint min/max from query rows plus the closed-form
    zero, the cross-waypoint log-odds fusion as a host-grouped
    stored-permutation sort of the W·M query entries + a O(log W)
    segmented Hillis-Steele suffix-sum — no (W, M+N) embedding sorts at
    all. At the 1M-point scale those embeds were ~40% of the step and the
    embed keys ~45% of the plan transfer. Parity with the dense tail is
    f32 summation-order level (pinned in tests/test_traj_frozen.py).

    Same loss as ``traj_forward_frozen``; aux carries the scalar terms
    only (no 'rewards'). Requires a plan built by build_traj_plan (any
    ``embed=`` setting — the sparse arrays are always present).
    """
    sel = slice(None, None, problem.wps_step)
    quats_sel, poses_sel = params["quats"][sel], params["poses"][sel]
    vis, _, qcam0 = _frozen_vis(
        plan, meta, quats_sel, poses_sel, points, K, problem, valid,
        need_score=False)
    score_q = scores_from_planes(
        qcam0[..., 0], qcam0[..., 1], qcam0[..., 2], K,
        problem.img_width, problem.img_height,
        min_dist=problem.min_dist, max_dist=problem.max_dist,
        eps=problem.eps)  # (W, M)
    qmask0 = plan["qmask"][:, 0]
    gated_q = jnp.where(qmask0, vis * score_q, 0.0)

    n_valid = (jnp.asarray(float(meta.n_points), jnp.float32)
               if valid is None else jnp.sum(valid))
    big = jnp.asarray(jnp.finfo(gated_q.dtype).max, gated_q.dtype)
    min_g = jnp.min(jnp.where(qmask0, gated_q, big), axis=1)
    max_g = jnp.max(jnp.where(qmask0, gated_q, -big), axis=1)
    # non-query VALID points exist almost always; their gated score is an
    # exact 0, which extends the min/max window (dense-path semantics)
    has_other = plan["n_q"].astype(jnp.float32) < n_valid
    pmin = jnp.where(has_other, jnp.minimum(min_g, 0.0), min_g)
    pmax = jnp.where(has_other, jnp.maximum(max_g, 0.0), max_g)
    lo_q = jnp.where(
        qmask0,
        logodds_from_minmax(gated_q, pmin[:, None], pmax[:, None],
                            problem.eps),
        0.0)

    # cross-waypoint fusion: group the W·M grid-0 entries by canonical id
    # (host-stored permutation), then a segmented suffix-sum — segments
    # are ≤ W_sel long, so ceil(log2 W) shifted adds close the fusion
    x = lo_q.reshape(1, -1)
    wm = x.shape[-1]
    grouped = perm_apply(plan["combine_fwd"][None],
                         plan["combine_bwd"][None], x, 0.0, wm)[0]
    head = plan["seg_head"]
    seg_id = jnp.cumsum(head.astype(jnp.int32))
    tot = grouped
    k = 1
    while k < max(meta.n_sel, 2):
        sh = jnp.concatenate([tot[k:], jnp.zeros((k,), tot.dtype)])
        sid = jnp.concatenate(
            [seg_id[k:], jnp.full((k,), -1, seg_id.dtype)])
        tot = tot + jnp.where(sid == seg_id, sh, 0.0)
        k *= 2
    # Σ_valid σ(lo_sum) = Σ_heads (σ − ½) + ½·n_valid (untouched points
    # sit at exactly lo_sum = 0)
    sum_sig = jnp.sum(jnp.where(head, jax.nn.sigmoid(tot) - 0.5, 0.0))
    mean_reward = (sum_sig + 0.5 * n_valid) / jnp.maximum(n_valid, 1.0)
    return traj_criterion_from_mean(mean_reward, params, poses0, problem)


# ---------------------------------------------------------------------------
# runner: refresh cadence + jit cache
# ---------------------------------------------------------------------------


class FrozenTrajOptimizer:
    """Occlusion-aware trajectory optimization with host-refreshed routing.

    Drop-in peer of running Adam over ``traj_forward(soft_hpr=True)``:
    every ``cfg.refresh_every`` steps the routing plan is rebuilt on host
    for the current waypoints; in between, steps run the frozen-plan jitted
    program (compiled once per PlanMeta, cached). The step itself runs the
    SPARSE criterion tail (traj_forward_frozen_mean — no (N,)-rewards
    embedding; the runner only consumes scalar aux anyway).
    """

    _need_embed = False  # sparse step: skip building/transferring embeds

    def __init__(self, points, K, poses0, quats0, problem: TrajProblem,
                 opt_cfg=None, plan_cfg: FrozenPlanConfig = FrozenPlanConfig(),
                 valid=None):
        from trajectory_optimization_tpu.opt.engine import (
            OptimizerConfig, make_optimizer)

        self.points_np = np.asarray(points, np.float32)
        self.points = jnp.asarray(self.points_np)
        self.valid_np = None if valid is None else np.asarray(valid)
        self.valid = None if valid is None else jnp.asarray(valid, jnp.float32)
        self.K_np = np.asarray(K, np.float32)
        self.K = jnp.asarray(self.K_np)
        self.poses0 = jnp.asarray(poses0, jnp.float32)
        self.quats0 = jnp.asarray(quats0, jnp.float32)
        self.problem = problem
        self.plan_cfg = plan_cfg
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.tx = make_optimizer(self.opt_cfg)
        self._step_cache: Dict[PlanMeta, callable] = {}
        self._steps_since_refresh = 0
        self._plan = None
        self._meta = None
        self._pending = None
        self._pool = None
        self._ones = None  # cached all-ones valid mask (hot-loop reuse)
        self._t_floor = 1  # largest tile count seen: keeps ONE PlanMeta
        self._tb_floor = 1  # largest big-tile count seen (same reason)
        self._warming: set = set()  # metas with a background warm in flight
        self._warm_threads: list = []  # joined by close()
        self._params_avals = None  # params shapes, for prewarm dummies
        self.stats = {"refreshes": 0, "swap_s": 0.0, "build_s": 0.0,
                      "prewarms": 0}

    def _selected(self, params_host):
        """(poses_sel, quats_sel) the plan is built for — numpy, host."""
        sel = slice(None, None, self.problem.wps_step)
        return params_host["poses"][sel], params_host["quats"][sel]

    def _build(self, params):
        poses_sel, quats_sel = self._selected(
            {k: np.asarray(v) for k, v in params.items()})
        plan, meta = build_traj_plan(
            self.points_np, self.valid_np, poses_sel, quats_sel,
            self.K_np, self.problem, self.plan_cfg,
            min_tiles=self._t_floor, min_t_big=self._tb_floor,
            embed=self._need_embed)
        self._t_floor = max(self._t_floor, meta.tiles)
        self._tb_floor = max(self._tb_floor, meta.t_big)
        return plan, meta

    def _swap(self, plan, meta):
        import time

        t0 = time.perf_counter()
        # ONE batched host->device transfer for the whole plan pytree.
        # Underscored keys are host-only diagnostics and stay on the host.
        # Async builds arrive already device-put (the builder thread ships
        # them the moment the build finishes, overlapping the transfer
        # with device steps).
        if any(isinstance(v, np.ndarray) for v in plan.values()):
            plan = self._put_plan(plan)
        self._plan = plan
        self._meta = meta
        self._steps_since_refresh = 0
        self.stats["refreshes"] += 1
        self.stats["swap_s"] += time.perf_counter() - t0
        self._maybe_prewarm(meta)

    def _put_plan(self, plan_np):
        """Host plan dict -> device arrays (underscored diagnostics stay on
        host). Subclasses with sharded steps override this to device_put
        with the plan's NamedSharding."""
        return jax.device_put(
            {k: v for k, v in plan_np.items() if not k.startswith("_")})

    # -- background pre-warm of the NEXT tile-ladder rungs ----------------
    # Active-set growth moves T / TB up the geometric ladder
    # (FrozenPlanConfig.tile_ladder_ratio); each new rung is a fresh jit
    # signature = a 15-25 s XLA compile. Warming the three neighbor metas
    # (T↑, TB↑, both↑) with zero-filled dummies on a daemon thread turns
    # that serving stall into background work (and seeds the persistent
    # compile cache for future sessions).

    def _dummy_plan_arrays(self, meta: PlanMeta):
        W, G, T, TB = meta.n_sel, meta.n_grids, meta.tiles, meta.t_big
        cap, M, n = meta.cap, meta.rows, meta.n_points
        z = jnp.zeros
        out = {
            "q_xyz": z((W, G, M, 3), jnp.float32),
            "c_xyz_ext": z((W, G, TB, cap, 3), jnp.float32),
            "q_bin": z((W, G, M), jnp.int16),
            "c_bin_ext": z((W, G, TB, cap), jnp.int16),
            "c_sel": z((W, G, T), jnp.int32),
            "c_sel_inv": z((W, G, TB), jnp.int32),
            "c_row_ext": z((W, G, TB, cap), jnp.int32),
            "qmask": z((W, G, M), bool),
            "align_fwd": z((W, G, M), jnp.int32),
            "align_bwd": z((W, G, M), jnp.int32),
            "combine_fwd": z((W * M,), jnp.int32),
            "combine_bwd": z((W * M,), jnp.int32),
            "seg_head": z((W * M,), bool),
            "n_q": z((W,), jnp.int32),
        }
        if self._need_embed:
            out["embed_fwd"] = z((W, M + n), jnp.int32)
            out["embed_bwd"] = z((W, M + n), jnp.int32)
        return out

    def _dummy_args(self, meta: PlanMeta):
        plan = self._put_plan(self._dummy_plan_arrays(meta))
        params = jax.tree_util.tree_map(
            lambda a: jnp.zeros(a.shape, a.dtype), self._params_avals)
        st = self.tx.init(params)
        if self.valid is None and self._ones is None:
            self._ones = jnp.ones((self.points.shape[0],), jnp.float32)
        valid = self._ones if self.valid is None else self.valid
        return (params, st, plan, self.points, valid, self.K, self.poses0,
                self.quats0)

    def _warm_metas(self, metas):
        try:
            for m in metas:
                step_fn = self._get_step(m)
                out = step_fn(*self._dummy_args(m))
                jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
                self.stats["prewarms"] += 1
        except Exception:  # noqa: BLE001 — warm-up is best effort
            pass
        finally:
            self._warming.difference_update(metas)

    def _maybe_prewarm(self, meta: PlanMeta):
        if not self.plan_cfg.prewarm or self._params_avals is None:
            return
        import dataclasses as _dc
        import threading

        r = self.plan_cfg.tile_ladder_ratio
        nt = _ladder_next(meta.tiles, self.plan_cfg.tile_round, r)
        ntb = _ladder_next(meta.t_big, 4, r)
        cands = [
            _dc.replace(meta, tiles=nt, t_big=ntb),
            _dc.replace(meta, tiles=nt),
            _dc.replace(meta, t_big=ntb),
        ]
        cands = [m for m in cands
                 if m not in self._step_cache and m not in self._warming]
        if not cands:
            return
        self._warming.update(cands)
        self._warm_threads = [t for t in self._warm_threads if t.is_alive()]
        t = threading.Thread(target=self._warm_metas, args=(cands,),
                             daemon=True, name="frozenwarm")
        self._warm_threads.append(t)
        t.start()

    def _build_put(self, host):
        plan_np, meta = self._build(host)
        return self._put_plan(plan_np), meta

    def _kick_async(self, params):
        import concurrent.futures

        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="frozenplan")
        # snapshot params on host NOW (device steps keep mutating them)
        host = {k: np.asarray(v) for k, v in params.items()}
        self._pending = self._pool.submit(self._build_put, host)

    def _refresh(self, params):
        import time

        if self._pending is not None:
            # async: apply the plan kicked off at the previous boundary
            # (built from params refresh_every steps back — the gate
            # slacks budget for that lag) and start the next build from
            # the CURRENT params
            t0 = time.perf_counter()
            plan_meta = self._pending.result()
            self.stats["build_s"] += time.perf_counter() - t0  # blocked part
            self._swap(*plan_meta)
            self._kick_async(params)
            return
        t0 = time.perf_counter()
        built = self._build(params)
        self.stats["build_s"] += time.perf_counter() - t0
        self._swap(*built)
        if self.plan_cfg.async_refresh:
            self._kick_async(params)

    def close(self):
        """Wait for background plan builds and prewarm compiles to end.

        A daemon thread still compiling when the interpreter exits aborts
        the process, so short-lived callers must call this before exit."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        for t in self._warm_threads:
            t.join()
        self._warm_threads = []

    def __del__(self):  # best effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def _get_step(self, meta: PlanMeta):
        if meta not in self._step_cache:
            problem, tx = self.problem, self.tx

            @jax.jit
            def step(params, opt_state, plan, points, valid, K, poses0,
                     quats0):
                import optax

                def loss_fn(p):
                    return traj_forward_frozen_mean(
                        p, plan, meta, points, K, poses0, quats0, problem,
                        valid=valid)

                (loss, aux), g = jax.value_and_grad(
                    loss_fn, has_aux=True)(params)
                updates, opt_state = tx.update(g, opt_state, params)
                params = optax.apply_updates(params, updates)
                scalars = {k: v for k, v in aux.items() if v.ndim == 0}
                return params, opt_state, loss, scalars

            self._step_cache[meta] = step
        return self._step_cache[meta]

    def init(self, params):
        return self.tx.init(params)

    def reset(self):
        """Drop the current plan (and any in-flight async build). Call
        before optimizing from params discontinuous with the previous
        run — the routing gates are only valid within ``drift_slack`` of
        the poses they were built for, and a stale plan silently excludes
        the wrong points (zero value AND gradient). ``run()`` resets
        automatically; manual ``step()`` loops across restarts must not
        skip this."""
        if self._pending is not None:
            if not self._pending.cancel():
                # a build already running on the pool thread cannot be
                # cancelled — wait it out (sub-second) so its device_put
                # doesn't overlap the next synchronous build. The floor
                # updates it makes are harmless either way: _t_floor /
                # _tb_floor are intentionally monotonic.
                try:
                    self._pending.result()
                except Exception:
                    pass
            self._pending = None
        self._plan = None
        self._meta = None
        self._steps_since_refresh = 0

    def step(self, params, opt_state):
        """One Adam step (refreshing the plan when due). Returns
        (params, opt_state, loss, scalar_aux). Assumes ``params``
        continues the trajectory of the previous step call — call
        :meth:`reset` first when jumping to unrelated params."""
        if self._params_avals is None:
            self._params_avals = jax.tree_util.tree_map(
                lambda x: jax.ShapeDtypeStruct(jnp.shape(x),
                                               jnp.result_type(x)), params)
        if (self._plan is None
                or self._steps_since_refresh >= self.plan_cfg.refresh_every):
            self._refresh(params)
        step_fn = self._get_step(self._meta)
        if self.valid is None and self._ones is None:
            self._ones = jnp.ones((self.points.shape[0],), jnp.float32)
        out = step_fn(params, opt_state, self._plan, self.points,
                      self._ones if self.valid is None else self.valid,
                      self.K, self.poses0, self.quats0)
        self._steps_since_refresh += 1
        return out

    def run(self, params, n_steps: int):
        """Run n_steps from ``params``; returns (params, losses list).
        Resets any plan left over from a previous run (its routing was
        built for different poses)."""
        self.reset()
        opt_state = self.init(params)
        losses = []
        for _ in range(n_steps):
            params, opt_state, loss, _ = self.step(params, opt_state)
            losses.append(float(loss))
        return params, losses


# ---------------------------------------------------------------------------
# frozen-routing variants for the other two optimization modes — the gate
# pipeline (frozen_soft_hpr_scores) is model-agnostic; only the criterion
# and the parameterization differ
# ---------------------------------------------------------------------------


def wps_forward_frozen(params, frozen, plan, meta, points, K, problem, *,
                       valid=None, occlusion_mask=None):
    """wps_forward(soft_hpr=True) under a frozen routing plan: the
    Waypoints-Optimization criterion Σ_w 1/(Σ_n hpr·score + eps) with the
    per-waypoint differentiable HPR gates coming from the plan. Same
    (loss, aux) contract as models.wps_opt.wps_forward."""
    from trajectory_optimization_tpu.models.wps_opt import wps_path

    trans, quats = wps_path(params, frozen)
    gated, _ = frozen_soft_hpr_scores(
        plan, meta, quats, trans, points, K, problem, valid)
    if occlusion_mask is not None:
        gated = gated * occlusion_mask[None, :]
    if valid is not None:
        gated = gated * valid[None, :]
    per_wp = jnp.sum(gated, axis=-1)
    losses = 1.0 / (per_wp + problem.eps)
    return jnp.sum(losses), {
        "losses": losses,
        "observations": gated,
        "mean_reward": jnp.mean(per_wp),
    }


def pose_forward_frozen(params, plan, meta, points, K, problem, *,
                        valid=None, occlusion_mask=None):
    """pose_forward(soft_hpr=True) under a frozen routing plan (W = 1).
    Same (loss, aux) contract as models.pose.pose_forward."""
    gated, _ = frozen_soft_hpr_scores(
        plan, meta, params["quat"], params["trans"], points, K, problem,
        valid)
    mask = gated[0]
    if occlusion_mask is not None:
        mask = mask * occlusion_mask
    if valid is not None:
        mask = mask * valid
    loss = 1.0 / (jnp.sum(mask) + problem.eps)
    return loss, {"observations": mask}


def _sum_criterion_cfg(plan_cfg: FrozenPlanConfig) -> FrozenPlanConfig:
    """The pose/wps criteria SUM raw gated scores — no log-odds clip floor
    protects the tail, so the query gate must bound the DROPPED MASS:
    error ≤ N·thresh·smax ≤ N·thresh·Σ. The trajectory default (1e-5,
    sized for the 0.5 clip) loses whole percents when a pose sees little;
    1e-9 bounds the relative loss error at N·1e-9 (4e-5 at 40k points).
    Only applied when the caller left the field at its class default."""
    if plan_cfg.score_rel_thresh == FrozenPlanConfig.score_rel_thresh:
        plan_cfg = dataclasses.replace(plan_cfg, score_rel_thresh=1e-9)
    return plan_cfg


class FrozenWpsOptimizer(FrozenTrajOptimizer):
    """Waypoints-Optimization (X/Y/yaw per waypoint) with host-refreshed
    soft-HPR routing. Params are the wps_opt {'xy','yaw'} pytree; pass the
    frozen path parts from models.wps_opt.init_wps_params. Two-group Adam
    (xy/yaw) like the single-chip engine path."""

    _need_embed = True  # wps_forward_frozen materializes (W, N) gates

    def __init__(self, points, K, frozen, problem, opt_cfg=None,
                 plan_cfg: FrozenPlanConfig = FrozenPlanConfig(),
                 valid=None, occlusion_mask=None):
        from trajectory_optimization_tpu.opt.engine import (
            OptimizerConfig, make_optimizer)

        # reuse the base state via a dummy poses0/quats0 (criterion-unused)
        super().__init__(points, K, np.zeros((1, 3), np.float32),
                         np.asarray([[1.0, 0, 0, 0]], np.float32), problem,
                         opt_cfg, _sum_criterion_cfg(plan_cfg), valid)
        self.tx = make_optimizer(opt_cfg or OptimizerConfig(),
                                 pose_key="xy", quat_key="yaw")
        self.frozen = {k: jnp.asarray(v) for k, v in frozen.items()}
        self._frozen_np = {k: np.asarray(v) for k, v in frozen.items()}
        self.occ = (None if occlusion_mask is None
                    else jnp.asarray(occlusion_mask, jnp.float32))

    def _selected(self, params_host):
        # numpy mirror of wps_opt.wps_path (the host refresh stays off
        # the device)
        xy, yaw = params_host["xy"], params_host["yaw"]
        z = self._frozen_np["z"]
        q0 = self._frozen_np["quats0"]
        trans = np.concatenate([xy, z[:, None]], axis=1)
        half = 0.5 * yaw
        qz = np.stack([np.cos(half), np.zeros_like(half),
                       np.zeros_like(half), np.sin(half)], axis=1)
        aw, ax, ay, az = qz[:, 0], qz[:, 1], qz[:, 2], qz[:, 3]
        bw, bx, by, bz = q0[:, 0], q0[:, 1], q0[:, 2], q0[:, 3]
        quats = np.stack([
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ], axis=1)
        return trans, quats

    def _get_step(self, meta: PlanMeta):
        if meta not in self._step_cache:
            problem, tx, frozen, occ = (self.problem, self.tx, self.frozen,
                                        self.occ)

            @jax.jit
            def step(params, opt_state, plan, points, valid, K, poses0,
                     quats0):
                import optax

                del poses0, quats0

                def loss_fn(p):
                    return wps_forward_frozen(
                        p, frozen, plan, meta, points, K, problem,
                        valid=valid, occlusion_mask=occ)

                (loss, aux), g = jax.value_and_grad(
                    loss_fn, has_aux=True)(params)
                updates, opt_state = tx.update(g, opt_state, params)
                params = optax.apply_updates(params, updates)
                return params, opt_state, loss, {"losses": aux["losses"]}

            self._step_cache[meta] = step
        return self._step_cache[meta]


class FrozenPoseOptimizer(FrozenTrajOptimizer):
    """Single-pose occlusion-aware optimization with host-refreshed
    routing (W = 1). Params are the pose {'trans','quat'} pytree."""

    _need_embed = True  # pose_forward_frozen materializes the (N,) gate

    def __init__(self, points, K, problem, opt_cfg=None,
                 plan_cfg: FrozenPlanConfig = FrozenPlanConfig(),
                 valid=None, occlusion_mask=None):
        from trajectory_optimization_tpu.opt.engine import (
            OptimizerConfig, make_optimizer)

        super().__init__(points, K, np.zeros((1, 3), np.float32),
                         np.asarray([[1.0, 0, 0, 0]], np.float32), problem,
                         opt_cfg, _sum_criterion_cfg(plan_cfg), valid)
        self.tx = make_optimizer(opt_cfg or OptimizerConfig(),
                                 pose_key="trans", quat_key="quat")
        self.occ = (None if occlusion_mask is None
                    else jnp.asarray(occlusion_mask, jnp.float32))

    def _selected(self, params_host):
        return (params_host["trans"].reshape(1, 3),
                params_host["quat"].reshape(1, 4))

    def _get_step(self, meta: PlanMeta):
        if meta not in self._step_cache:
            problem, tx, occ = self.problem, self.tx, self.occ

            @jax.jit
            def step(params, opt_state, plan, points, valid, K, poses0,
                     quats0):
                import optax

                del poses0, quats0

                def loss_fn(p):
                    return pose_forward_frozen(
                        p, plan, meta, points, K, problem,
                        valid=valid, occlusion_mask=occ)

                (loss, aux), g = jax.value_and_grad(
                    loss_fn, has_aux=True)(params)
                updates, opt_state = tx.update(g, opt_state, params)
                params = optax.apply_updates(params, updates)
                return params, opt_state, loss, {}

            self._step_cache[meta] = step
        return self._step_cache[meta]
