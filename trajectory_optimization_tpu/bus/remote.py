"""Cross-process scene bus: TCP/UDS transport between per-process buses.

The reference's node graph is OS processes exchanging TCPROS messages
(reference ``launch/pose_optimization.launch:13-60`` starts feeders, the
voxel nodelet, and the optimizer as separate processes). The in-process
:class:`bus.core.Bus` covers the single-process workflows; this module is
the process boundary: a :class:`BusBroker` (the rosmaster-shaped hub — it
routes rather than just naming peers, which keeps the socket count linear)
plus one :class:`BusBridge` per process mirroring its local bus onto the
wire.

Message bytes on the wire are the same ROS1 serializations the bag
container uses (``bus.rosbag`` codecs), so anything that can be recorded
can cross a process boundary, compressed camera passthroughs included.

Framing (all little-endian):
    frame    := u32 length | payload
    payload  := op:u8 | fields
    HELLO    := 0x01 | name:str16          (client -> broker)
    SUB      := 0x02 | topic:str16         ('*' = all topics)
    PUB      := 0x03 | topic:str16 | ros_type:str16 | body
    str16    := u16 len | utf8 bytes

The broker never decodes bodies — PUB frames are routed verbatim to every
other client whose subscriptions match, so routing cost is O(bytes), not
O(messages × fields).
"""
from __future__ import annotations

import os
import socket
import struct
import tempfile
import threading
import uuid
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from trajectory_optimization_tpu.bus.core import Bus

__all__ = ["BusBroker", "BusBridge", "NodeProcess", "default_address"]

_OP_HELLO = 0x01
_OP_SUB = 0x02
_OP_PUB = 0x03

Address = Union[str, Tuple[str, int]]


def default_address() -> str:
    """A fresh abstract-namespace-free UDS path (works on any POSIX)."""
    return os.path.join(tempfile.gettempdir(), f"trajopt_bus_{uuid.uuid4().hex[:12]}.sock")


def _connect(address: Address) -> socket.socket:
    if isinstance(address, str):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    s.connect(address)
    return s


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<H", len(b)) + b


def _unpack_str(buf: memoryview, pos: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<H", buf, pos)
    return bytes(buf[pos + 2:pos + 2 + n]).decode(), pos + 2 + n


def _send_frame(sock: socket.socket, payload: bytes, lock: threading.Lock) -> None:
    with lock:
        sock.sendall(struct.pack("<I", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    out = bytearray()
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            return None
        out += chunk
    return bytes(out)


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (length,) = struct.unpack("<I", hdr)
    if length > (1 << 31):
        raise ValueError("oversized frame")
    return _recv_exact(sock, length)


# ---------------------------------------------------------------------------
# broker
# ---------------------------------------------------------------------------


class _Client:
    __slots__ = ("sock", "lock", "subs", "name", "all_topics", "outbox",
                 "n_dropped")

    def __init__(self, sock: socket.socket, queue_size: int):
        import queue

        self.sock = sock
        self.lock = threading.Lock()
        self.subs: set = set()
        self.all_topics = False
        self.name = ""
        # bounded outbox + dedicated writer: a slow subscriber drops its
        # oldest frames (ROS queue_size semantics) instead of back-pressuring
        # the broker into a cross-client deadlock
        self.outbox: "queue.Queue[Optional[bytes]]" = queue.Queue(maxsize=queue_size)
        self.n_dropped = 0


class BusBroker:
    """Routes PUB frames between connected :class:`BusBridge` clients.

    Runs in whichever process owns the graph (typically the launch parent);
    clients connect over a unix socket (str address) or TCP (host, port).
    """

    def __init__(self, address: Optional[Address] = None, *,
                 queue_size: int = 256):
        self.address: Address = address if address is not None else default_address()
        self.queue_size = queue_size
        self._clients: List[_Client] = []
        self._lock = threading.Lock()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._client_event = threading.Condition(self._lock)

    def start(self) -> "BusBroker":
        if isinstance(self.address, str):
            if os.path.exists(self.address):
                os.unlink(self.address)
            lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            lst.bind(self.address)
        else:
            lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lst.bind(self.address)
            self.address = lst.getsockname()
        lst.listen(64)
        self._listener = lst
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="bus-broker-accept")
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        while not self._closed.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            client = _Client(sock, self.queue_size)
            with self._client_event:
                self._clients.append(client)
                self._client_event.notify_all()
            threading.Thread(
                target=self._client_loop, args=(client,), daemon=True,
                name="bus-broker-client").start()
            threading.Thread(
                target=self._writer_loop, args=(client,), daemon=True,
                name="bus-broker-writer").start()

    def _writer_loop(self, client: _Client):
        while True:
            frame = client.outbox.get()
            if frame is None:
                return
            try:
                _send_frame(client.sock, frame, client.lock)
            except OSError:
                return  # reader loop reaps the client

    def _client_loop(self, client: _Client):
        try:
            while True:
                frame = _recv_frame(client.sock)
                if frame is None:
                    break
                op = frame[0]
                mv = memoryview(frame)
                if op == _OP_PUB:
                    topic, _ = _unpack_str(mv, 1)
                    self._route(client, topic, frame)
                elif op == _OP_SUB:
                    topic, _ = _unpack_str(mv, 1)
                    with self._lock:
                        if topic == "*":
                            client.all_topics = True
                        else:
                            client.subs.add(topic)
                elif op == _OP_HELLO:
                    name, _ = _unpack_str(mv, 1)
                    with self._client_event:
                        client.name = name
                        self._client_event.notify_all()
        except (OSError, ValueError, IndexError, struct.error):
            pass  # malformed frame or dead socket: reap the client quietly
        finally:
            with self._lock:
                if client in self._clients:
                    self._clients.remove(client)
            try:
                client.outbox.put_nowait(None)  # stop the writer
            except Exception:  # noqa: BLE001 - full outbox; writer dies with sock
                pass
            try:
                client.sock.close()
            except OSError:
                pass

    def _route(self, origin: _Client, topic: str, frame: bytes):
        import queue

        with self._lock:
            targets = [c for c in self._clients
                       if c is not origin and (c.all_topics or topic in c.subs)]
        for c in targets:
            while True:
                try:
                    c.outbox.put_nowait(frame)
                    break
                except queue.Full:
                    try:  # drop the oldest frame for this slow client
                        c.outbox.get_nowait()
                        c.n_dropped += 1
                    except queue.Empty:
                        pass

    def wait_for_clients(self, n: int, timeout: float = 30.0) -> bool:
        """Block until ``n`` clients have completed HELLO (readiness gate so
        early feeder ticks aren't dropped before workers attach)."""
        deadline = threading.TIMEOUT_MAX if timeout is None else timeout
        with self._client_event:
            return self._client_event.wait_for(
                lambda: sum(1 for c in self._clients if c.name) >= n,
                timeout=deadline)

    def n_clients(self) -> int:
        with self._lock:
            return len(self._clients)

    def close(self):
        self._closed.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            try:
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.sock.close()
            except OSError:
                pass
        if isinstance(self.address, str) and os.path.exists(self.address):
            try:
                os.unlink(self.address)
            except OSError:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------


def _wire_encode(msg) -> Optional[Tuple[str, bytes]]:
    """(ros_type, body) via the bag codecs; None if the type has no codec."""
    from trajectory_optimization_tpu.bus import rosbag as rb
    from trajectory_optimization_tpu.bus.messages import ImageMsg

    enc = rb._TYPE_OF_MSG.get(type(msg))
    if enc is None:
        return None
    ros_type, encoder = enc
    if isinstance(msg, ImageMsg) and np.asarray(msg.data).ndim == 1:
        return ("sensor_msgs/CompressedImage", rb._encode_compressed_image(msg))
    return ros_type, encoder(msg)


def _wire_decode(ros_type: str, body: bytes):
    from trajectory_optimization_tpu.bus import rosbag as rb

    decoder = rb._DECODERS.get(ros_type)
    if decoder is None:
        return None
    return decoder(body)


class BusBridge:
    """Mirror a local :class:`Bus` onto a :class:`BusBroker`.

    Every local publish whose message has a wire codec is exported; every
    frame received is injected into the local bus. Injection never
    re-exports (thread-local suppression), so two bridged buses cannot
    loop a message. Internal topics (``/__...``) stay process-local.
    """

    def __init__(self, bus: Bus, address: Address, *,
                 name: str = "", subscribe: Sequence[str] = ("*",),
                 export: Optional[Iterable[str]] = None):
        self.bus = bus
        self.name = name or f"bridge-{os.getpid()}"
        self._export = None if export is None else set(export)
        self._sock = _connect(address)
        self._send_lock = threading.Lock()
        self._injecting = threading.local()
        self._closed = threading.Event()
        self.n_sent = 0
        self.n_received = 0
        self.n_skipped = 0  # publishes with no wire codec
        # SUB strictly before HELLO: the broker processes a client's frames
        # in order and wait_for_clients() gates on HELLO, so this ordering
        # guarantees subscriptions are live before the client counts as
        # ready (otherwise an early publish races the SUB and is dropped)
        for t in subscribe:
            _send_frame(self._sock, bytes([_OP_SUB]) + _pack_str(t),
                        self._send_lock)
        _send_frame(self._sock, bytes([_OP_HELLO]) + _pack_str(self.name),
                    self._send_lock)
        self._tap = bus.add_tap(self._on_local_publish)
        self._reader = threading.Thread(
            target=self._reader_loop, daemon=True, name=f"bus-bridge-{self.name}")
        self._reader.start()

    # -- outbound ----------------------------------------------------------
    def _on_local_publish(self, topic: str, msg):
        # loop guard: suppress ONLY the message object being injected from
        # the wire — downstream publishes a subscriber makes synchronously
        # (e.g. an optimizer node emitting its result inside the injected
        # message's callback, on this same reader thread) MUST still export
        if getattr(self._injecting, "current", None) == (topic, id(msg)):
            return
        if topic.startswith(Bus.INTERNAL_TOPIC_PREFIX):
            return
        if self._export is not None and topic not in self._export:
            return
        if self._closed.is_set():
            return
        wire = _wire_encode(msg)
        if wire is None:
            self.n_skipped += 1
            return
        ros_type, body = wire
        payload = (bytes([_OP_PUB]) + _pack_str(topic) + _pack_str(ros_type)
                   + body)
        try:
            _send_frame(self._sock, payload, self._send_lock)
            self.n_sent += 1
        except OSError:
            self._closed.set()

    # -- inbound -----------------------------------------------------------
    def _reader_loop(self):
        try:
            while not self._closed.is_set():
                frame = _recv_frame(self._sock)
                if frame is None:
                    break
                if frame[0] != _OP_PUB:
                    continue
                mv = memoryview(frame)
                topic, pos = _unpack_str(mv, 1)
                ros_type, pos = _unpack_str(mv, pos)
                msg = _wire_decode(ros_type, bytes(mv[pos:]))
                if msg is None:
                    continue
                try:
                    items = msg if isinstance(msg, list) else [msg]
                    for m in items:  # TFMessage decodes to a list
                        self._injecting.current = (topic, id(m))
                        self.bus.publish(topic, m)
                    self.n_received += 1
                finally:
                    self._injecting.current = None
        except (OSError, ValueError, IndexError, struct.error):
            pass
        finally:
            self._closed.set()

    def wait_closed(self, timeout: Optional[float] = None) -> bool:
        """Block until the broker connection drops (worker lifetime hook)."""
        return self._closed.wait(timeout)

    def close(self):
        self._closed.set()
        self.bus.remove_tap(self._tap)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# node worker processes
# ---------------------------------------------------------------------------


def _node_worker(node_cls_name: str, cfg, address: Address, name: str,
                 env: Dict[str, str]) -> None:
    """Entry point of a spawned node process: own bus + node + bridge.

    Runs until the broker connection drops (parent closed) — the
    cross-process equivalent of a ROS node spinning until roscore exits.
    """
    os.environ.update(env)
    log_path = os.environ.get("TRAJOPT_NODE_DEBUG")
    log = open(log_path, "a", buffering=1) if log_path else None

    def _log(msg):
        if log is not None:
            log.write(f"[{name} pid={os.getpid()}] {msg}\n")

    try:
        _log("start")
        from trajectory_optimization_tpu.bus import nodes as node_mod
        from trajectory_optimization_tpu.bus.launch import enable_compilation_cache

        enable_compilation_cache()
        bus = Bus()
        node_cls = getattr(node_mod, node_cls_name)
        node_cls(bus, cfg)
        _log("node built")
        bridge = BusBridge(bus, address, name=name)
        _log("bridge attached")
        if log is not None:
            while not bridge.wait_closed(5.0):
                _log(f"recv={bridge.n_received} sent={bridge.n_sent} "
                     f"errors={bus.errors}")
        else:
            bridge.wait_closed()
        _log("bridge closed; exiting")
    except BaseException as e:  # pragma: no cover - debug surface
        _log(f"FATAL {e!r}")
        raise
    finally:
        if log is not None:
            log.close()


class NodeProcess:
    """A bus node running in its own OS process (reference: one ROS node
    per ``<node>`` tag, launch/pose_optimization.launch:13-60).

    ``NodeProcess("PoseOptNode", cfg, broker.address)`` spawns a fresh
    Python process that builds the node on a private bus and bridges it to
    the broker. The parent's launch handle keeps feeders local, so
    ``Launch.step()`` drives the whole multi-process graph deterministically
    from one place.
    """

    def __init__(self, node_cls_name: str, cfg, address: Address, *,
                 name: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None):
        import multiprocessing as mp

        self.name = name or node_cls_name
        ctx = mp.get_context("spawn")
        fwd = {k: os.environ[k] for k in
               ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")
               if k in os.environ}
        if env:
            fwd.update(env)
        self.process = ctx.Process(
            target=_node_worker,
            args=(node_cls_name, cfg, address, self.name, fwd),
            daemon=True, name=f"node-{self.name}")
        self.process.start()

    def alive(self) -> bool:
        return self.process.is_alive()

    def terminate(self, timeout: float = 5.0):
        if self.process.is_alive():
            self.process.terminate()
            self.process.join(timeout)
        if self.process.is_alive():  # pragma: no cover - last resort
            self.process.kill()
            self.process.join(timeout)
