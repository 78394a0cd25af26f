import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajectory_optimization_tpu.ops.hpr import (
    hpr_mask_approx,
    hpr_mask_exact,
    hpr_mask_soft,
    hpr_mask_soft_binned,
    hpr_points_exact,
    spherical_flip,
)

import oracles


@pytest.fixture(scope="module")
def cam_cloud(cloud10):
    # camera-frame cloud: viewpoint at the reference pose-demo start
    return cloud10 - np.array([6.0, 2.0, 0.0], np.float32)


def test_spherical_flip_matches_oracle(cam_cloud):
    sub = cam_cloud[:5000]
    got = np.asarray(spherical_flip(jnp.asarray(sub)))
    want = oracles.spherical_flip(sub.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_flip_preserves_direction_and_inverts_radius_order(cam_cloud):
    sub = jnp.asarray(cam_cloud[:2000])
    flipped = spherical_flip(sub)
    norms = np.linalg.norm(np.asarray(sub), axis=1)
    fnorms = np.linalg.norm(np.asarray(flipped), axis=1)
    # direction preserved
    cos = np.sum(np.asarray(sub) * np.asarray(flipped), axis=1) / (norms * fnorms)
    np.testing.assert_allclose(cos, 1.0, atol=1e-5)
    # nearer original => farther flipped
    order = np.argsort(norms)
    assert (np.diff(fnorms[order]) <= 1e-3).all()


def test_exact_matches_oracle(cam_cloud):
    sub = cam_cloud[:8000]
    got = hpr_mask_exact(sub)
    want = oracles.hpr_visible_mask(sub.astype(np.float64))
    assert (got == want).mean() > 0.999


def test_exact_points_shape(cam_cloud):
    sub = cam_cloud[:4000]
    vis_pts, mask = hpr_points_exact(sub)
    assert vis_pts.shape == (int(mask.sum()), 3)


def test_approx_no_false_positives_and_good_recall(cam_cloud):
    """Adaptive witness pursuit must reach Qhull-grade recall at defaults
    with no false positives (VERDICT round-1 item 3: recall ≥ 0.99).

    Subsampled ×2 to keep the CPU (N, N)-matmul cost CI-friendly; the full
    cloud is checked against the same bounds on the GPU by chip_smoke.py."""
    sub = cam_cloud[::2]
    exact = hpr_mask_exact(sub)
    approx = np.asarray(hpr_mask_approx(jnp.asarray(sub))) > 0.5
    false_pos = (approx & ~exact).sum()
    recall = (approx & exact).sum() / exact.sum()
    assert false_pos == 0, f"{false_pos} hidden marked visible"
    assert recall >= 0.99, f"recall {recall}"


def test_approx_second_viewpoint(cloud10):
    """Same bars from a different camera pose (not the tuning viewpoint)."""
    rel = cloud10[::4] - np.array([12.0, -3.0, 1.0], np.float32)
    exact = hpr_mask_exact(rel)
    approx = np.asarray(hpr_mask_approx(jnp.asarray(rel))) > 0.5
    assert (approx & ~exact).sum() == 0
    recall = (approx & exact).sum() / exact.sum()
    assert recall >= 0.985, f"recall {recall}"


def test_approx_valid_mask_padding_invariance(cam_cloud):
    """Bucket-padded + valid-masked hpr_mask_approx must reproduce the
    unpadded mask exactly (serving paths pad so the jit cache keys on bucket
    sizes, not per-message sizes)."""
    from trajectory_optimization_tpu.utils.data import pad_points

    sub = cam_cloud[:3000]
    plain = np.asarray(hpr_mask_approx(jnp.asarray(sub), n_passes=4))
    padded, valid = pad_points(sub, 4096)
    masked = np.asarray(
        hpr_mask_approx(jnp.asarray(padded), n_passes=4, valid=jnp.asarray(valid))
    )
    # ~1-ulp rounding differences between program shapes can nudge the
    # pursuit trajectory of individual points (winners stay true hull
    # vertices either way) — require near-identity, not bit-identity
    assert (masked[:3000] != plain).mean() < 0.01
    assert masked[3000:].max() == 0.0  # padded entries never visible
    # and the padded mask keeps the zero-false-positive property
    exact = hpr_mask_exact(sub)
    assert ((masked[:3000] > 0.5) & ~exact).sum() == 0


def test_approx_jittable_fixed_shape(cam_cloud):
    sub = jnp.asarray(cam_cloud[:3000])
    f = jax.jit(lambda p: hpr_mask_approx(p, n_passes=2))
    m1 = f(sub)
    assert m1.shape == (3000,)
    assert set(np.unique(np.asarray(m1))) <= {0.0, 1.0}


def test_soft_agreement_and_gradients(cam_cloud):
    sub = cam_cloud[:6000]
    exact = hpr_mask_exact(sub)
    soft = np.asarray(hpr_mask_soft(jnp.asarray(sub)))
    assert ((soft > 0.5) == exact).mean() > 0.8
    # differentiable: finite, nonzero gradient w.r.t. points
    g = jax.grad(lambda p: jnp.sum(hpr_mask_soft(p)))(jnp.asarray(sub))
    g = np.asarray(g)
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def test_soft_hpr_valid_mask(cam_cloud):
    import jax.numpy as jnp
    from trajectory_optimization_tpu.utils.data import pad_points

    sub = cam_cloud[:3000]
    plain = np.asarray(hpr_mask_soft(jnp.asarray(sub)))
    padded, valid = pad_points(sub, 4096)
    masked = np.asarray(hpr_mask_soft(jnp.asarray(padded), valid=jnp.asarray(valid)))
    # real points unaffected by padding; padded entries report ~0 visibility
    np.testing.assert_allclose(masked[:3000], plain, atol=3e-3)  # reduction-order drift through the sharp sigmoid
    assert masked[3000:].max() < 1e-3


# ---------------------------------------------------------------------------
# adversarial geometry (VERDICT r2 item 4): structured scenes vs the Qhull
# oracle. The SubT-like scans this system targets are walls/corridors, not
# the lumpy sample cloud the recall claim was originally validated on.
# ---------------------------------------------------------------------------


def _grid_plane(n, axis, value, span1, span2, jitter=0.0, seed=0):
    """n×n grid on the plane axis=value; span1/span2 = (lo, hi) of the two
    in-plane coordinates (in axis order, axis removed). Camera at origin."""
    rng = np.random.default_rng(seed)
    a1 = np.linspace(*span1, n, dtype=np.float32)
    a2 = np.linspace(*span2, n, dtype=np.float32)
    g1, g2 = np.meshgrid(a1, a2)
    flat = np.stack([g1.ravel(), g2.ravel()], axis=1)
    if jitter:
        flat = flat + rng.normal(scale=jitter, size=flat.shape).astype(np.float32)
    out = np.insert(flat, axis, np.float32(value), axis=1)
    return out.astype(np.float32)


def _scene_walls():
    """Axis-aligned wall in front of a second wall (pure occlusion)."""
    near = _grid_plane(60, 2, 3.0, (-3, 3), (-3, 3), jitter=0.01)
    far = _grid_plane(60, 2, 7.0, (-6, 6), (-6, 6), jitter=0.01, seed=1)
    return np.vstack([near, far])


def _scene_corridor():
    """Camera inside a corridor (two side walls + floor/ceiling) with a
    thin occluder slab halfway down."""
    walls = []
    for i, (axis, value) in enumerate([(0, -1.2), (0, 1.2), (1, -1.0), (1, 1.0)]):
        lateral = (-1.0, 1.0) if axis == 0 else (-1.2, 1.2)
        w = _grid_plane(45, axis, value, lateral, (0.5, 9.5), jitter=0.01, seed=i)
        walls.append(w)
    occluder = _grid_plane(25, 2, 4.0, (-0.9, 0.9), (-0.8, 0.8), jitter=0.005, seed=11)
    end_wall = _grid_plane(40, 2, 10.0, (-1.2, 1.2), (-1.0, 1.0), jitter=0.005, seed=12)
    return np.vstack(walls + [occluder, end_wall])


def _scene_plane_and_background():
    """Dense foreground plane + sparse far background (density contrast)."""
    rng = np.random.default_rng(3)
    plane = _grid_plane(80, 2, 2.0, (-2, 2), (-2, 2), jitter=0.005)
    back = rng.normal(size=(600, 3)).astype(np.float32)
    back = back / np.linalg.norm(back, axis=1, keepdims=True) * 15.0
    back[:, 2] = np.abs(back[:, 2]) + 5.0  # keep it behind the plane
    return np.vstack([plane, back])


def _scene_sphere_shell():
    """Shell seen from outside: the near hemisphere is visible, the far
    one hidden — the canonical Katz test case."""
    rng = np.random.default_rng(4)
    d = rng.normal(size=(6000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d * 2.0 + np.array([0.0, 0.0, 8.0], np.float32)


_ADVERSARIAL_SCENES = {
    "walls": _scene_walls,
    "corridor": _scene_corridor,
    "plane+background": _scene_plane_and_background,
    "sphere-shell": _scene_sphere_shell,
}


@pytest.mark.parametrize("name", sorted(_ADVERSARIAL_SCENES))
def test_approx_adversarial_geometry(name):
    """hpr_mask_approx on structured scenes: recall ≥ 0.98 vs Qhull, and no
    false positive deeper than 1e-4·2R inside the hull (the load-bearing
    claim behind the pose HPR gate and PointsProcessor; reference semantics
    `src/tools.py:56-85`).

    Planar scenes (walls/corridor/plane) give exactly ZERO false positives.
    Smooth curved silhouettes (the sphere shell) admit a handful of
    *horizon-marginal* points — the visible/hidden boundary on a smooth rim
    is ill-conditioned (an infinitesimal perturbation flips Qhull's own
    verdict), and the measured offenders sit ≤6e-5·2R inside the hull. The
    assertion pins that depth bound instead of pretending the boundary is
    sharp."""
    from scipy.spatial import ConvexHull

    pts = _ADVERSARIAL_SCENES[name]().astype(np.float64)
    truth = hpr_mask_exact(pts)
    got = np.asarray(hpr_mask_approx(jnp.asarray(pts.astype(np.float32)))) > 0.5
    recall = (got & truth).sum() / max(1, truth.sum())
    assert recall >= 0.98, f"{name}: recall {recall:.4f}"
    fp_idx = np.flatnonzero(got & ~truth)
    assert len(fp_idx) <= 0.005 * max(1, truth.sum()), (
        f"{name}: {len(fp_idx)} false positives")
    if len(fp_idx):
        norms = np.linalg.norm(pts, axis=1)
        radius = norms.max() * 100.0
        flipped = pts * (
            (2.0 * (radius - norms) / np.maximum(norms, 1e-12)) + 1.0)[:, None]
        hull = ConvexHull(np.vstack([flipped, np.zeros(3)]))
        depth = (hull.equations[:, :3] @ flipped[fp_idx].T
                 + hull.equations[:, 3:4]).max(0)
        assert (depth > -1e-4 * 2.0 * radius).all(), (
            f"{name}: non-marginal false positives, depth/2R "
            f"{depth.min() / (2 * radius):.2e}")


@pytest.mark.parametrize("name", sorted(_ADVERSARIAL_SCENES))
def test_soft_binned_matches_dense_adversarial(name):
    """The direction-binned soft HPR (hpr_mask_soft_binned) tracks the dense
    O(N²) relaxation on structured geometry: ≤0.1% of points may flip near
    the angular capture boundary, bulk mean error ≤1e-3."""
    pts = jnp.asarray(_ADVERSARIAL_SCENES[name]())
    dense = np.asarray(hpr_mask_soft(pts))
    binned = np.asarray(hpr_mask_soft_binned(pts))
    d = np.abs(dense - binned)
    assert d.mean() <= 1e-3, f"{name}: mean {d.mean():.5f}"
    assert (d > 0.05).mean() <= 1e-3, f"{name}: {(d > 0.05).sum()} flips"


def test_soft_binned_bucketed_padding():
    """Bucket-padded clouds (the serving path): padded entries report 0 and
    do not perturb real points."""
    from trajectory_optimization_tpu.utils.data import pad_points

    pts = _scene_sphere_shell()
    plain = np.asarray(hpr_mask_soft_binned(jnp.asarray(pts)))
    padded, valid = pad_points(pts, 8192)
    masked = np.asarray(
        hpr_mask_soft_binned(jnp.asarray(padded), valid=jnp.asarray(valid)))
    np.testing.assert_allclose(masked[: len(pts)], plain, atol=3e-3)
    assert masked[len(pts):].max() < 1e-3


def test_soft_binned_large_r_param():
    """r_param=4 makes the binning ~20x finer (n_bins in the thousands);
    the sort key must not overflow int32 (review-found: a fixed 1<<20
    shift silently interleaved unrelated bins past 2047 bins)."""
    pts = jnp.asarray(_scene_sphere_shell()[:3000])
    dense = np.asarray(hpr_mask_soft(pts, r_param=4.0))
    # small cap: fine binnings leave ~2 points/bin, so big query tiles
    # would burn (cap x cap) work per nearly-empty bin (CI time)
    binned = np.asarray(hpr_mask_soft_binned(pts, r_param=4.0, cap=64))
    d = np.abs(dense - binned)
    assert d.mean() <= 1e-3 and (d > 0.05).mean() <= 2e-3, (
        d.mean(), (d > 0.05).sum())


def test_soft_binned_gradients():
    pts = jnp.asarray(_scene_walls()[::4])
    g = jax.grad(lambda p: jnp.sum(hpr_mask_soft_binned(p)))(pts)
    g = np.asarray(g)
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def test_cosort_custom_vjp_matches_sort_autodiff():
    """The scatter-free custom VJPs of _cosort/_unpermute must reproduce
    autodiff-through-lax.sort exactly — including on tie-heavy keys, where
    a stability mismatch between the forward permutation and the backward
    co-sort would mis-route cotangents."""
    from trajectory_optimization_tpu.ops.hpr import _cosort, _unpermute

    rng = np.random.default_rng(7)
    n = 4096
    # few distinct keys -> long tie runs (same-bin points share a key prefix)
    key = jnp.asarray(rng.integers(0, 17, n).astype(np.int32))
    ops = [jnp.asarray(rng.normal(size=n).astype(np.float32))
           for _ in range(4)]
    cot_sorted = jnp.asarray(rng.normal(size=n).astype(np.float32))
    cot_x = jnp.asarray(rng.normal(size=n).astype(np.float32))

    def via_custom(u0, u1, u2, rho, x):
        key_s, u0s, u1s, u2s, rhos, perm = _cosort(key, u0, u1, u2, rho)
        xs = _unpermute(key, perm, x)
        return (jnp.sum((u0s + u1s + u2s + rhos) * cot_sorted)
                + jnp.sum(xs * cot_x))

    def via_autodiff(u0, u1, u2, rho, x):
        iota = jnp.arange(n, dtype=jnp.int32)
        _, u0s, u1s, u2s, rhos, perm = jax.lax.sort(
            (key, u0, u1, u2, rho, iota), num_keys=1)
        _, xs = jax.lax.sort((perm, x), num_keys=1)
        return (jnp.sum((u0s + u1s + u2s + rhos) * cot_sorted)
                + jnp.sum(xs * cot_x))

    args = (*ops, jnp.asarray(rng.normal(size=n).astype(np.float32)))
    va, ga = jax.value_and_grad(via_custom, argnums=(0, 1, 2, 3, 4))(*args)
    vb, gb = jax.value_and_grad(via_autodiff, argnums=(0, 1, 2, 3, 4))(*args)
    assert float(va) == float(vb)
    for a, b in zip(ga, gb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pose_optimization_through_soft_hpr(cloud10):
    """Occlusion-aware pose optimization: gradients THROUGH Katz HPR — the
    reference's TODO (`src/tools.py:61-62`) realized."""
    import jax
    import jax.numpy as jnp
    import optax

    from trajectory_optimization_tpu.models.pose import (
        PoseProblem, init_pose_params, pose_forward,
    )
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    intr = default_intrinsics()
    pts = jnp.asarray(cloud10[::16])
    prob = PoseProblem(img_width=intr.width, img_height=intr.height, soft_hpr=True)
    params = init_pose_params(
        np.array([[6.0, 2.0, 0.0]], np.float32), np.array([[0.9, 0.1, -0.2, 0.3]], np.float32)
    )
    K = intr.matrix()

    def loss_fn(p):
        return pose_forward(p, pts, K, prob)

    (l0, aux0), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert np.isfinite(np.asarray(grads["trans"])).all()
    assert np.linalg.norm(np.asarray(grads["trans"])) > 0

    # the occlusion term changes the gradient vs the plain model
    prob_plain = PoseProblem(img_width=intr.width, img_height=intr.height)
    g_plain = jax.grad(lambda p: pose_forward(p, pts, K, prob_plain)[0])(params)
    assert not np.allclose(np.asarray(grads["trans"]), np.asarray(g_plain["trans"]))

    # and a few steps reduce the loss
    tx = optax.adam(0.02)
    st = tx.init(params)
    p = params
    for _ in range(15):
        g = jax.grad(lambda q: loss_fn(q)[0])(p)
        u, st = tx.update(g, st, p)
        p = optax.apply_updates(p, u)
    l1, _ = loss_fn(p)
    assert float(l1) < float(l0)


def test_soft_hpr_gradient_finite_at_sensor_origin():
    """Real scans contain points EXACTLY at the sensor origin (cloud-10 has
    one per scan pose); jnp.linalg.norm's 0/0 gradient there NaN'd the whole
    trajectory gradient until the kernels switched to safe_norm. Pin both
    soft tiers and the flip."""
    import jax

    from trajectory_optimization_tpu.ops.hpr import (
        hpr_mask_soft,
        hpr_mask_soft_binned,
        spherical_flip,
    )

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(512, 3)).astype(np.float32) + np.array(
        [0.0, 0.0, 5.0], np.float32)
    pts[0] = 0.0  # the sensor-origin point
    pts = jnp.asarray(pts)

    for fn in (hpr_mask_soft, hpr_mask_soft_binned,
               lambda p: jnp.sum(spherical_flip(p) ** 2, axis=-1)):
        val = fn(pts)
        assert np.isfinite(np.asarray(val)).all()
        g = jax.grad(lambda p: jnp.sum(fn(p) ** 2))(pts)
        assert np.isfinite(np.asarray(g)).all(), fn
        assert np.abs(np.asarray(g)[1:]).max() > 0  # real gradients elsewhere


def test_soft_binned_operating_point_vs_exact(cloud10, path10):
    """CI pin of the production binned soft-HPR tier at its default
    operating point (sharpness=400, tau=0.02, stratified coverers — see
    PARITY.md 'soft-HPR operating curve') against exact Qhull on a real
    cloud-10 viewpoint. Thresholds sit under the round-5 measured values
    on this exact 16k subsample (P 0.909 / R 0.948 / agreement 0.958);
    a regression in the relaxation, the binning, or the stratified
    coverer layout fails loudly here instead of silently degrading every
    soft_hpr loss. (Full-cloud production-tier values: P 0.804 / R 0.969
    micro-averaged — within ~1 point of the pointwise criterion's own
    precision ceiling, PARITY.md.)"""
    import jax.numpy as jnp

    from trajectory_optimization_tpu.ops.hpr import (
        hpr_mask_exact,
        hpr_mask_soft_binned,
    )

    rng = np.random.default_rng(0)
    sub = rng.permutation(len(cloud10))[:16384]
    cam = (cloud10[sub] - path10[9]).astype(np.float32)
    truth = hpr_mask_exact(cam)
    vis = np.asarray(hpr_mask_soft_binned(jnp.asarray(cam))) > 0.5
    tp = (vis & truth).sum()
    precision = tp / max(vis.sum(), 1)
    recall = tp / max(truth.sum(), 1)
    agree = (vis == truth).mean()
    assert recall >= 0.93, (precision, recall, agree)
    assert precision >= 0.86, (precision, recall, agree)
    assert agree >= 0.93, (precision, recall, agree)
