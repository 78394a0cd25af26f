"""Multi-chip differentiable HPR: point-sharded direction-binned dominance.

Extends :func:`trajectory_optimization_tpu.ops.hpr.hpr_mask_soft_binned`
(the differentiable answer to the reference's HPR TODO,
``/root/reference/src/tools.py:61-62``) across a device mesh. The reference
is single-GPU and its Qhull HPR is CPU-only and non-differentiable
(``src/tools.py:56-85``); here the 1M-point north-star cloud can be
occlusion-gated differentiably with the point axis sharded over devices.

SPMD design (no global sort, no cross-chip scatter):

- every shard bins and sorts only its LOCAL points (the same
  :func:`~trajectory_optimization_tpu.ops.hpr._binned_grids` static
  layouts, so bin ids agree across shards);
- dominance candidates are per-bin top-``cap``-closest tables — a shard's
  local top-cap per bin is a superset of its contribution to the global
  top-cap, so one fixed-size ``all_gather`` of (n_bins, cap) tables plus a
  batched merge-sort reproduces the single-chip candidate set exactly
  (ties in the quantized distance key aside);
- each shard's points then compete against the merged global table of
  their own bin — O(n_local · cap) local work, perfectly partitioned;
- collectives: one scalar ``all_gather``+max for radius/scale (NOT
  ``lax.pmax`` — it has no differentiation rule), then the candidate
  tables' ``all_gather``s per grid (key/u×3/rho/gid/ok columns,
  ~n_bins·cap·7 words ≈ a few MB total). Gradients flow back
  through the all_gathers as ``psum_scatter``s placed by shard_map's
  transpose; everything else differentiates locally (the local sort uses
  the same sort custom VJP as the single-chip kernel).

Agreement with the single-chip kernel is pinned in
``tests/test_hpr_sharded.py`` on the 8-virtual-device CPU mesh, gradients
included.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.hpr import (
    _BIG_SOFT,
    _binned_grids,
    _direction_angles,
    _grid_bin_key,
    _unpermute,
    SOFT_BINNED_DEFAULTS,
    make_cosort,
)
from ..ops.numerics import safe_norm

__all__ = ["hpr_mask_soft_binned_sharded"]


# Both sorts share ops.hpr.make_cosort — the custom-VJP
# sort-by-key (reverse-mode only; see that factory's docstring):
#
# - _cosort_gid: the local layout sort, carrying the GLOBAL point id as a
#   gradient-free extra operand (self-exclusion across shards);
# - _cosort_merge: the batched (dimension=1) merge of the gathered
#   candidate tables — autodiff through lax.sort would transpose to a
#   row scatter-add. Bit-exactness vs autodiff is pinned
#   in tests/test_hpr_sharded.py::test_merge_cosort_vjp_matches_sort_autodiff.
_cosort_gid = make_cosort(4, 1)     # (key, u0, u1, u2, rho, gid)
_cosort_merge = make_cosort(4, 2, dimension=1)  # (key, u×3, rho, gid, ok)


def resolve_hpr_knobs(problem, hpr_cap, hpr_safety):
    """Default builder knobs to the PROBLEM's hpr_cap/hpr_safety so the
    single-chip and sharded paths compute the same visibility unless the
    caller explicitly overrides (review-found drift: TrajProblem moved to
    cap=512 while the sharded builders stayed on the kernel default)."""
    if hpr_cap is None:
        hpr_cap = getattr(problem, "hpr_cap", SOFT_BINNED_DEFAULTS["cap"])
    if hpr_safety is None:
        hpr_safety = getattr(problem, "hpr_safety",
                             SOFT_BINNED_DEFAULTS["safety"])
    return hpr_cap, hpr_safety


def _local_mask(points_l, valid_l, gid0, *, r_param, sharpness, tau, cap,
                safety, axis, n_global, vma_axes=None, stratified=None):
    """Per-shard body (runs under shard_map over ``axis``).

    ``vma_axes``: all mesh axes the INPUTS vary over, when the enclosing
    shard_map spans more axes than the point axis (the 2D waypoint×point
    trajectory step: camera-frame points vary over the waypoint axis too).
    The internal scan's carry init must be pcast to exactly that set or
    shard_map's varying-axes checker rejects the scan. Defaults to
    ``(axis,)`` — the 1D point-sharded case.
    """
    if vma_axes is None:
        vma_axes = (axis,)
    if stratified is None:
        stratified = bool(SOFT_BINNED_DEFAULTS.get("stratified_coverers",
                                                   True))
    n_l = points_l.shape[0]
    # cap is the GLOBAL per-bin candidate budget (single-chip semantics:
    # min(cap, N)); a shard contributes at most min(cap_g, n_l) rows —
    # it can never supply more survivors of the global merge than that
    cap_g = min(cap, n_global)
    cap_l = min(cap_g, n_l)
    # safe_norm: sensor-origin points (‖p‖ = 0) exist in real scans and
    # jnp.linalg.norm's gradient there is NaN (see ops.hpr)
    norms = safe_norm(points_l, axis=-1)
    v = valid_l > 0
    norms_v = jnp.where(v, norms, 0.0)

    # global normalization: one scalar max over the mesh axis. Not
    # lax.pmax — it has no differentiation rule; all_gather + max is
    # differentiable (gradient reaches the argmax shard's point through
    # the all_gather transpose, matching the single-chip jnp.max)
    gmax = jnp.max(jax.lax.all_gather(jnp.max(norms_v), axis))
    radius = jnp.maximum(gmax, 1e-12) * 10.0 ** r_param
    rho = 2.0 * radius - norms
    scale = jax.lax.stop_gradient(jnp.maximum(gmax, 1e-6))
    beta = sharpness / scale
    u = points_l / jnp.maximum(norms, 1e-12)[:, None]

    gid = gid0 + jnp.arange(n_l, dtype=jnp.int32)
    lat, az = _direction_angles(u)

    _, grids = _binned_grids(r_param, tau, safety)
    smax = jnp.full((n_l,), -_BIG_SOFT, jnp.float32)
    for grid in grids:
        key, frac_bits, n_bins = _grid_bin_key(grid, lat, az, norms, scale, v)

        key_s, u0_s, u1_s, u2_s, rho_s, gid_s, perm = _cosort_gid(
            key, u[:, 0], u[:, 1], u[:, 2], rho, gid)
        bin_s = key_s >> frac_bits
        u_s = jnp.stack([u0_s, u1_s, u2_s], axis=1)

        edges = jnp.searchsorted(bin_s, jnp.arange(n_bins + 1, dtype=bin_s.dtype))
        counts = edges[1:] - edges[:-1]
        starts = edges[:-1]

        # --- local per-bin candidate tables ---------------------------------
        # first (closest) cand_l members per bin; with stratification the
        # tables go 4x deeper (cand_l = 4·cap_g) so the MERGED order below
        # is the exact global distance order to the tier reach 16·base =
        # 4·cap_g — each shard keeps at least its share of the global
        # top-4·cap_g, so no member of that range is ever truncated away.
        # n_bins is static and small (~10²); a scan of contiguous
        # dynamic_slices stays scatter/gather-free.
        cand_l = min(4 * cap_g, n_l) if stratified else cap_l

        def cand_body(_, b):
            off = jnp.clip(starts[b], 0, n_l - cand_l)
            ck = jax.lax.dynamic_slice(key_s, (off,), (cand_l,))
            cu = jax.lax.dynamic_slice(u_s, (off, 0), (cand_l, 3))
            cr = jax.lax.dynamic_slice(rho_s, (off,), (cand_l,))
            cg = jax.lax.dynamic_slice(gid_s, (off,), (cand_l,))
            # rows can spill into a neighbouring bin when the slice is
            # clipped at the array edge — mark them invalid (same
            # semantics as the single-chip cbin==b pair test)
            ok = (ck >> frac_bits) == b
            ck = jnp.where(ok, ck, jnp.int32(0x7FFFFFFF))  # sort-last sentinel
            return None, (ck, cu, cr, cg, ok)

        _, (tk, tu, tr, tg, tok) = jax.lax.scan(
            cand_body, None, jnp.arange(n_bins, dtype=jnp.int32))

        # --- all-gather + batched merge: global top-cap_g per bin ----------
        # (D, n_bins, cap_l, ...) -> (n_bins, D*cap_l) rows, merge-sorted by
        # the quantized distance key (single-chip candidate order), keep
        # cap_g — the single-chip min(cap, N) budget (D*cap_l >= cap_g
        # always: each shard contributes min(cap_g, n_l)).
        def gather_flat(x):
            g = jax.lax.all_gather(x, axis)  # (D, n_bins, cap_l)
            return jnp.moveaxis(g, 0, 1).reshape(n_bins, -1)

        gk = gather_flat(tk)
        gu = jnp.moveaxis(jax.lax.all_gather(tu, axis), 0, 1)
        gu = gu.reshape(n_bins, -1, 3)
        gr = gather_flat(tr)
        gg = gather_flat(tg)
        gok = gather_flat(tok)

        gk_s, gu0, gu1, gu2, gr_s, gg_s, gok_s, _mperm = _cosort_merge(
            gk, gu[..., 0], gu[..., 1], gu[..., 2], gr, gg,
            gok.astype(jnp.int32))
        # candidate columns — the union of the single-chip per-chunk
        # coverer sets, selected by STATIC merged-position index (the
        # merged order is the exact global in-bin distance order to depth
        # 4·cap_g, see cand_l above):
        #   * prefix columns  [0, cap_g): what single-chip gives chunk-0
        #     (rank < cap_g) queries — every possible dominator of theirs;
        #   * strat columns: the single-chip stratified layout's first
        #     cap_g priority picks (ops.hpr._stratified_priority) — what
        #     deeper chunks see.
        # Each query then masks to ITS OWN rule via its global rank
        # (searchsorted into the merged keys, in tile_smax below), so the
        # sharded coverer sets match the single-chip kernel exactly, up to
        # quantized-key ties. Cost: ~1.5x candidate columns.
        m = int(gk_s.shape[1])
        prefix_cols = np.arange(min(cap_g, m))
        if stratified:
            r = np.arange(m)
            base = max(cap_g // 4, 1)
            kk = np.floor(np.log2(np.maximum(r // base, 1))).astype(np.int64)
            sel = (r < base) | ((r < 16 * base)
                               & ((r & ((1 << (kk + 1)) - 1)) == 0))
            strat_cols = np.concatenate([r[sel], r[~sel]])[:cap_g]
            cols = np.unique(np.concatenate([prefix_cols, strat_cols]))
            col_prefix = jnp.asarray(cols < cap_g)
            col_strat = jnp.asarray(np.isin(cols, strat_cols))
        else:
            cols = prefix_cols
            col_prefix = col_strat = None
        n_cols = len(cols)
        cu_tab = jnp.stack(
            [gu0[:, cols], gu1[:, cols], gu2[:, cols]], axis=-1)
        cr_tab = gr_s[:, cols]
        cg_tab = gg_s[:, cols]
        cok_tab = gok_s[:, cols] > 0

        # --- local query tiles vs the global candidate table ---------------
        tiles_per_bin = -(-counts // cap_l)
        tile_cum = jnp.concatenate(
            [jnp.zeros((1,), tiles_per_bin.dtype), jnp.cumsum(tiles_per_bin)])
        n_tiles_static = n_bins + -(-n_l // cap_l)
        slot = jnp.arange(n_tiles_static)
        tile_bin = jnp.clip(
            jnp.searchsorted(tile_cum, slot, side="right") - 1, 0, n_bins - 1)
        within = slot - tile_cum[tile_bin]
        tile_ok = within < tiles_per_bin[tile_bin]
        tile_qoff = jnp.clip(starts[tile_bin] + within * cap_l, 0, n_l - cap_l)

        @jax.checkpoint  # O(cap) residuals per step, like the single-chip body
        def tile_smax(b, qoff, u_s, cu_tab, cr_tab, cg_tab, cok_tab):
            qu = jax.lax.dynamic_slice(u_s, (qoff, 0), (cap_l, 3))
            qg = jax.lax.dynamic_slice(gid_s, (qoff,), (cap_l,))
            cu = jax.lax.dynamic_slice(cu_tab, (b, 0, 0), (1, n_cols, 3))[0]
            cr = jax.lax.dynamic_slice(cr_tab, (b, 0), (1, n_cols))[0]
            cg = jax.lax.dynamic_slice(cg_tab, (b, 0), (1, n_cols))[0]
            cok = jax.lax.dynamic_slice(cok_tab, (b, 0), (1, n_cols))[0]
            cos = (qu[:, 0:1] * cu[None, :, 0] + qu[:, 1:2] * cu[None, :, 1]
                   + qu[:, 2:3] * cu[None, :, 2])
            pair_ok = cok[None, :] & (qg[:, None] != cg[None, :])
            if stratified:
                # each query follows ITS chunk's single-chip rule: global
                # in-bin rank < cap_g → the prefix columns (chunk 0 of the
                # single-chip layout); deeper → the stratified columns.
                # The rank test is ONE scalar compare against the bin's
                # cap_g-th merged key (not a searchsorted — that lowers to
                # log-m gather passes per tile); key ties at the
                # boundary fall on one side, the documented quantized-key
                # tie class.
                qk = jax.lax.dynamic_slice(key_s, (qoff,), (cap_l,))
                kth = jax.lax.dynamic_slice(
                    gk_s, (b, min(cap_g, m) - 1), (1, 1))[0, 0]
                colmask = jnp.where((qk > kth)[:, None],
                                    col_strat[None, :], col_prefix[None, :])
                pair_ok = pair_ok & colmask
            dom = jnp.where(pair_ok, jnp.maximum(cos, 0.0) * cr[None, :],
                            -_BIG_SOFT)
            return jax.nn.logsumexp(beta * dom, axis=1) / beta

        def body(carry, tile, u_s=u_s, cu_tab=cu_tab,
                 cr_tab=cr_tab, cg_tab=cg_tab, cok_tab=cok_tab):
            b, qoff, ok = tile
            qbin = jax.lax.dynamic_slice(bin_s, (qoff,), (cap_l,))
            s = tile_smax(b, qoff, u_s, cu_tab, cr_tab, cg_tab, cok_tab)
            cur = jax.lax.dynamic_slice(carry, (qoff,), (cap_l,))
            upd = jnp.where((qbin == b) & ok, jnp.maximum(cur, s), cur)
            return jax.lax.dynamic_update_slice(carry, upd, (qoff,)), None

        # pcast: the init carry is a replicated constant but each step's
        # output varies over the mesh axes — make that explicit for
        # shard_map's varying-axes checker
        smax_g = jax.lax.pcast(
            jnp.full((n_l,), -_BIG_SOFT, jnp.float32), vma_axes, to="varying")
        smax_g, _ = jax.lax.scan(
            body, smax_g, (tile_bin, tile_qoff, tile_ok))
        smax = jnp.maximum(smax, _unpermute(key, perm, smax_g))

    out = jax.nn.sigmoid(beta * (rho + tau * scale - smax))
    return out * v.astype(jnp.float32)


@lru_cache(maxsize=64)
def _sharded_fn(mesh: Mesh, axis: str, r_param: float, sharpness: float,
                tau: float, cap: int, safety: float, stratified: bool):
    """Build (and cache) the jitted shard_map for one config.

    Without this cache every call re-built the shard_map closure and
    retraced from scratch — measured ~14× slower than warm execution on
    the CPU mesh. jit handles per-shape specialization inside."""
    d = mesh.shape[axis]

    def local(points_l, valid_l):
        n_l = points_l.shape[0]
        gid0 = (jax.lax.axis_index(axis) * n_l).astype(jnp.int32)
        return _local_mask(
            points_l, valid_l, gid0, r_param=r_param, sharpness=sharpness,
            tau=tau, cap=cap, safety=safety, axis=axis, n_global=n_l * d,
            stratified=stratified)

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=P(axis),
    ))


def hpr_mask_soft_binned_sharded(
    points: jnp.ndarray,
    mesh: Mesh,
    r_param: float = 2.0,
    *,
    sharpness: float = 400.0,
    tau: float = 0.02,
    cap: int = 1024,
    safety: float = 3.0,
    stratified_coverers: bool = True,
    valid: Optional[jnp.ndarray] = None,
    axis: str = "pts",
) -> jnp.ndarray:
    """Point-sharded differentiable HPR over a device mesh.

    Same semantics (and defaults) as
    :func:`~trajectory_optimization_tpu.ops.hpr.hpr_mask_soft_binned` —
    including the global min(cap, N) per-bin candidate budget, whatever
    the shard count; the point axis is sharded over ``mesh[axis]``.
    ``len(points)`` must divide by the axis size — pad with ``valid``
    (utils.data.pad_points) first. Returns the (N,) visibility mask,
    sharded along ``axis``. Reverse-mode only, like the single-chip kernel
    (custom_vjp sort helpers — no jax.jvp/jacfwd).
    """
    n = points.shape[0]
    d = mesh.shape[axis]
    if n % d != 0:
        raise ValueError(
            f"cloud size {n} not divisible by mesh axis '{axis}'={d}; "
            "pad with a valid mask first")
    if valid is None:
        valid = jnp.ones((n,), jnp.float32)

    f = _sharded_fn(mesh, axis, float(r_param), float(sharpness),
                    float(tau), int(cap), float(safety),
                    bool(stratified_coverers))
    pts_sh = jax.device_put(points, NamedSharding(mesh, P(axis, None)))
    val_sh = jax.device_put(
        jnp.asarray(valid, jnp.float32), NamedSharding(mesh, P(axis)))
    return f(pts_sh, val_sh)
