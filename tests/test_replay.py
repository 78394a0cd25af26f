import numpy as np
import pytest

from trajectory_optimization_tpu.bus.core import Bus
from trajectory_optimization_tpu.bus.messages import (
    CameraInfoMsg,
    CloudMsg,
    Header,
    PathMsg,
    PoseMsg,
)
from trajectory_optimization_tpu.bus.replay import Player, Recorder


def test_record_replay_roundtrip(tmp_path):
    bus = Bus()
    with Recorder(bus, ["/pc", "/pose", "/info"], str(tmp_path / "bag")) as rec:
        bus.publish("/pc", CloudMsg(Header(stamp=1.0, frame_id="map"), np.ones((7, 3), np.float32)))
        bus.publish("/pose", PoseMsg(Header(stamp=2.0, frame_id="map"), [1, 2, 3], [0, 0, 0, 1]))
        bus.publish(
            "/info",
            CameraInfoMsg(Header(stamp=0.5, frame_id="cam"), 100, 200,
                          K=(1.0, 0, 50, 0, 1, 100, 0, 0, 1)),
        )

    player = Player(str(tmp_path / "bag"))
    assert len(player) == 3

    bus2 = Bus()
    got = {}
    for t in ("/pc", "/pose", "/info"):
        bus2.subscribe(t, (lambda t: lambda m: got.setdefault(t, m))(t))
    n = player.play(bus2)
    assert n == 3
    np.testing.assert_array_equal(got["/pc"].points, np.ones((7, 3), np.float32))
    assert got["/pc"].header.frame_id == "map"
    np.testing.assert_allclose(got["/pose"].position, [1, 2, 3])
    assert got["/info"].K == (1.0, 0, 50, 0, 1, 100, 0, 0, 1)
    assert got["/info"].width == 100

    # stamp-ordered replay: /info (0.5) must arrive before /pc (1.0)
    order = [m["stamp"] for m in player.index]
    assert order == sorted(order)


def test_player_loop_start_duration(tmp_path):
    """npz Player mirrors rosbag play -l/-s/-u like BagPlayer: bag-time
    window [start, start+duration], `loop` passes."""
    bus = Bus()
    with Recorder(bus, ["/pose"], str(tmp_path / "bag")):
        for i in range(6):
            bus.publish("/pose", PoseMsg(Header(stamp=float(i), frame_id="m"),
                                         [0, 0, 0], [0, 0, 0, 1]))
    player = Player(str(tmp_path / "bag"))

    def stamps(**kw):
        b = Bus()
        seen = []
        b.subscribe("/pose", lambda m: seen.append(m.header.stamp))
        n = player.play(b, **kw)
        assert n == len(seen)
        return seen

    assert stamps(start=2.0) == [2.0, 3.0, 4.0, 5.0]
    assert stamps(start=1.0, duration=2.0) == [1.0, 2.0, 3.0]
    assert stamps(duration=0.0, loop=2) == [0.0, 0.0]


def test_record_device_array_image(tmp_path):
    """On an accelerator, renderer nodes publish ImageMsg with an on-device payload;
    recording one must force the host copy, not mis-route the array into
    the JSON scalars (found in review: jax.Array is not np.ndarray)."""
    import jax.numpy as jnp

    from trajectory_optimization_tpu.bus.messages import ImageMsg

    bus = Bus()
    img = jnp.full((4, 6, 3), 0.25, jnp.float32)  # device array, has __array__
    with Recorder(bus, ["/img"], str(tmp_path / "bag")):
        bus.publish("/img", ImageMsg(Header(stamp=1.0, frame_id="cam"), img, encoding="rgb32f"))

    player = Player(str(tmp_path / "bag"))
    bus2 = Bus()
    got = []
    bus2.subscribe("/img", got.append)
    assert player.play(bus2) == 1
    np.testing.assert_allclose(np.asarray(got[0].data), 0.25)
    assert got[0].encoding == "rgb32f"


def test_replay_drives_node_graph(tmp_path, cloud10, path10):
    """Record a session, replay it into a fresh optimizer node — the
    'multi-node without a robot' workflow (reference play_bag.launch)."""
    from trajectory_optimization_tpu.bus.nodes import TrajOptNode
    from trajectory_optimization_tpu.utils.config import TrajOptNodeConfig

    bus = Bus()
    with Recorder(bus, ["/pc", "/path"], str(tmp_path / "bag")):
        bus.publish("/pc", CloudMsg(Header(stamp=1.0, frame_id="map"), cloud10[::16]))
        bus.publish("/path", PathMsg.straight(path10, frame_id="map", stamp=1.1))

    bus2 = Bus()
    node = TrajOptNode(bus2, TrajOptNodeConfig(pc_topic="/pc", path_topic="/path", opt_steps=5))
    out = []
    bus2.subscribe("/path/optimized", out.append)
    Player(str(tmp_path / "bag")).play(bus2)
    assert out and out[0].positions.shape == path10.shape
    assert not bus2.errors


def test_session_replay_demo_runs():
    """The reference's recorded-session workflow end-to-end: synth bag with
    /tf + /tf_static + 6-camera rig + clouds + path, replayed through
    PointsProcessor (TF listener, rig batching) and TrajOpt. Small camera
    (img_scale) keeps the CPU interpret-mode renders cheap."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demos"))
    import session_replay_demo

    factor = session_replay_demo.main(["12", "5", "0.08"])
    assert factor > 0


def test_bus_error_isolation():
    bus = Bus()
    events = []
    bus.subscribe(Bus.ERROR_TOPIC, events.append)

    def bad(_msg):
        raise RuntimeError("boom")

    good = []
    bus.subscribe("/t", bad, latch=False)
    bus.subscribe("/t", good.append, latch=False)
    bus.publish("/t", 42)  # must not raise
    assert good == [42]  # healthy subscriber still served
    assert len(bus.errors) == 1 and "boom" in bus.errors[0]["error"]
    assert events and events[0]["topic"] == "/t"


def test_bus_error_raise_policy():
    bus = Bus(error_policy="raise")
    bus.subscribe("/t", lambda m: 1 / 0, latch=False)
    with pytest.raises(ZeroDivisionError):
        bus.publish("/t", 1)
