"""The XLA splat renderer at odd sizes and masks, and the rig node's use of it."""
import jax.numpy as jnp
import numpy as np

from trajectory_optimization_tpu.ops.render import render_point_cloud

K = jnp.array([[100.0, 0.0, 64.0], [0.0, 100.0, 48.0], [0.0, 0.0, 1.0]])


def _cloud(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        np.stack(
            [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(1.5, 9, n)],
            axis=1,
        ).astype(np.float32)
    )


def test_nontile_multiple_image_size():
    img = np.asarray(render_point_cloud(_cloud(seed=1), K, 100, 130, znear=1.0, zfar=10.0))
    assert img.shape == (100, 130, 3)
    assert (img < 1).any()


def test_empty_and_clipped():
    pts = jnp.array([[0.0, 0.0, 0.2], [0.0, 0.0, 50.0]])  # both outside [znear, zfar]
    img = np.asarray(render_point_cloud(pts, K, 64, 128, znear=1.0, zfar=10.0))
    np.testing.assert_allclose(img, 1.0)


def test_custom_colors_and_valid_mask():
    pts = jnp.array([[0.0, 0.0, 2.0], [0.5, 0.0, 2.0]])
    colors = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    valid = jnp.array([1.0, 0.0])  # second point masked out
    img = np.asarray(render_point_cloud(
        pts, K, 96, 128, colors=colors, valid=valid, znear=1.0, zfar=10.0))
    # red point projects to (u=64, v=48); green (masked) would land at u=89
    np.testing.assert_allclose(img[48, 64], [1.0, 0.0, 0.0])
    np.testing.assert_allclose(img[48, 89], [1.0, 1.0, 1.0])


def test_dense_cluster_has_no_per_pixel_cap():
    """Many splats in one small patch: the nearest still wins every pixel it
    covers, however many others land there."""
    rng = np.random.default_rng(0)
    n = 512
    pts = np.stack([rng.uniform(-0.02, 0.02, n), rng.uniform(-0.02, 0.02, n),
                    np.full(n, 2.0)], axis=1).astype(np.float32)
    pts[-1] = [0.0, 0.0, 1.5]  # one nearer splat at the center
    colors = np.zeros((n, 3), np.float32)
    colors[-1] = [1.0, 0.0, 0.0]
    img = np.asarray(render_point_cloud(
        jnp.asarray(pts), K, 64, 128, colors=jnp.asarray(colors), znear=1.0, zfar=10.0))
    np.testing.assert_allclose(img[48, 64], [1.0, 0.0, 0.0])
    assert (img[40:57, 56:73] < 1).all(axis=-1).any()


def test_points_processor_renders_through_xla(monkeypatch):
    """PointsProcessorNode._render calls ops.render.render_point_cloud on
    the bucket-padded visible points and publishes its image."""
    import trajectory_optimization_tpu.ops.render as render_mod
    from trajectory_optimization_tpu.bus.core import Bus
    from trajectory_optimization_tpu.bus.nodes import PointsProcessorNode
    from trajectory_optimization_tpu.utils.config import PointsProcessorConfig
    from trajectory_optimization_tpu.utils.intrinsics import CameraIntrinsics

    calls = []
    real = render_mod.render_point_cloud

    def spy(points, *a, **kw):
        calls.append((points.shape, kw.get("valid")))
        return real(points, *a, **kw)

    monkeypatch.setattr(render_mod, "render_point_cloud", spy)
    bus = Bus()
    node = PointsProcessorNode(bus, PointsProcessorConfig())
    got = []
    bus.subscribe("/cam0/pointcloud_image", got.append)
    intr = CameraIntrinsics(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96)
    visible = np.asarray(_cloud(n=300))
    node._render(visible, intr, "cam0")

    assert len(calls) == 1 and calls[0][0] == (1024, 3)  # bucket-padded
    assert float(np.asarray(calls[0][1]).sum()) == 300
    assert len(got) == 1 and got[0].encoding == "rgb32f"
    want = real(jnp.asarray(visible), intr.matrix(), 96, 128, znear=1.0, zfar=15.0)
    np.testing.assert_array_equal(np.asarray(got[0].data), np.asarray(want))
