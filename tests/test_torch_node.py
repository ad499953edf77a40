"""The port's live node (``orb_slam3_noted_tpu_torch.node``) against the
JAX package's on the CPU: ``tests/test_node.py``'s cases run on the port,
a 16-pair stereo node run in both packages, TCP round trips for each
message kind, and the JAX node's faults (ROADMAP Queue 3) shown in both
packages and repaired in the port:

- an IMUS block in the documented layout (samples at offset 4): the port
  receives the samples bit for bit, the JAX server raises on it;
- IMG1 / DPT1 with no IMG0: the port raises ``ValueError``, the JAX
  server a ``TypeError``;
- ``stop()`` after a join that timed out: the port raises and never runs
  ``slam.process`` in two threads, the JAX node drains beside the worker;
- an exception inside ``slam.process`` reaches the port's ``stop()`` and
  ``serve`` (the connection is closed), instead of dying with the thread.

Inputs are rendered with numpy from a seed at 320x240 and cross as uint8.
"""

import json
import socket
import struct
import threading
import time

import jax
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu import node as jnode
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu_torch import node as tnode
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

W, H = 320, 240
FX = 260.0
PARAMS = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
BASELINE = 0.12
CPU = torch.device("cpu")
MONO_KW = dict(width=W, height=H, n_features=600, max_keyframes=32, max_map_points=4096,
               local_window=5, kf_max_interval=10)
# tests/test_torch_stereo.py's configuration, the mapper on
STEREO_KW = dict(MONO_KW, bf=FX * BASELINE, th_depth=35.0, enable_loop_closing=False)
N_STEREO = 16
# published camera centres against the JAX node's: float32 sums in other
# orders (the per-frame limit of tests/test_torch_checkpoint.py), and frame
# 1 as tests/test_torch_stereo.py::test_stereo_localization_lap holds it:
# it starts from frame 0's pose with no motion model, and the Gauss-Newton
# steps stop short of convergence from that far (3.2 mm measured there)
POS_TOL_M, FRAME1_TOL_M = 2e-3, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """JAX in float32 as in use; torch on one thread (the test workers run
    side by side)."""
    prev, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", prev)


def _port_cfg(**kw):
    return SlamConfig(camera=Camera(PINHOLE, PARAMS), **kw)


def _jax_cfg(**kw):
    return JConfig(camera=JCamera(PINHOLE, PARAMS), **kw)


def _poses(n):
    return orbit_trajectory(n, forward=0.03, yaw0=0.45)


@pytest.fixture(scope="module")
def mono_imgs():
    room = BoxRoom(seed=0)
    return [room.render(R, t, PARAMS, W, H) for R, t in _poses(20)]


@pytest.fixture(scope="module")
def stereo_pairs():
    room = BoxRoom(seed=0)
    return [tuple(x.astype(np.uint8) for x in stereo_pair(room, R, t, PARAMS, W, H, BASELINE)[:2])
            for R, t in _poses(N_STEREO)]


# ---- the producer side of the protocol --------------------------------

def _start_server(mod, node):
    """``serve(node)`` on an ephemeral port in a thread; returns (client
    socket, thread, [the exception serve raised])."""
    ready, bound, raised = threading.Event(), [], []

    def run():
        try:
            mod.serve(node, port=0, ready_event=ready, _bound=bound)
        except BaseException as e:
            raised.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(10.0)
    return socket.create_connection(bound[0], timeout=60), th, raised


def _img0(t, img):
    return struct.pack("<dII", t, W, H) + np.clip(img, 0, 255).astype(np.uint8).tobytes()


def _img2(img, dtype):
    return struct.pack("<II", W, H) + np.asarray(img, dtype).tobytes()


def _imus(samples: np.ndarray) -> bytes:
    """The documented layout: u32 n, then n x 7 f64 from offset 4."""
    return struct.pack("<I", len(samples)) + np.asarray(samples, "<f8").tobytes()


def _collect(cli):
    """POSE records until FINI."""
    poses = []
    while True:
        tag, payload = tnode._recv_msg(cli)
        msg = json.loads(bytes(payload))
        if tag == b"FINI":
            return poses, msg
        assert tag == b"POSE", tag
        poses.append(msg)


# ---- tests/test_node.py's cases on the port -----------------------------

@pytest.fixture(scope="module")
def mono_run(mono_imgs):
    """The 20 mono frames as IMG0 messages through the port's server, with
    an in-process subscriber beside the socket: (node, the subscriber's
    records, the POSE records, FINI).  ``serve`` feeds the node through
    its grab callbacks and drains it with ``stop(drain=True)`` at DONE, so
    one run carries both of ``tests/test_node.py``'s mono cases."""
    node = tnode.SlamNode(_port_cfg(**MONO_KW), "mono", device=CPU)
    got = []
    node.subscribe(got.append)
    cli, th, raised = _start_server(tnode, node)
    for i, img in enumerate(mono_imgs):
        tnode._send_msg(cli, b"IMG0", _img0(i / 20.0, img))
    tnode._send_msg(cli, b"DONE", b"")
    poses, fini = _collect(cli)
    cli.close()
    th.join(timeout=30)
    assert not raised, raised
    return node, got, poses, fini


def test_node_inproc_mono(mono_run, mono_imgs):
    node, got, _, _ = mono_run
    assert node.n_published == len(mono_imgs)
    states = [m["state"] for m in got]
    assert states.count("OK") >= 10, states
    ok = next(m for m in got if m["state"] == "OK")
    R = np.asarray(ok["Rwc"])  # camera to world, float64 on the host
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-5) and len(ok["twc"]) == 3


def test_node_imu_sync_guard(mono_imgs):
    """An inertial frame waits for IMU samples past its time
    (`ros_mono_inertial.cc:150`)."""
    node = tnode.SlamNode(_port_cfg(**MONO_KW), "mono-inertial", device=CPU)
    node.grab_image(mono_imgs[0], 1.0)
    assert node.spin_once() is False  # no IMU yet: frame held
    node.grab_imu(0.95, [0, 0, 9.81], [0, 0, 0])
    assert node.spin_once() is False  # the samples end before the frame
    node.grab_imu(1.05, [0, 0, 9.81], [0, 0, 0])
    assert node.spin_once() is True
    assert node.n_published == 1


def test_node_realtime_drops_backlog(mono_imgs):
    node = tnode.SlamNode(_port_cfg(**MONO_KW), "mono", realtime=True, device=CPU)
    for i, img in enumerate(mono_imgs[:6]):
        node.grab_image(img, i / 20.0)
    assert node.spin_once() is True  # keeps only the newest queued frame
    assert node.n_dropped == 5 and node.n_published == 1


@pytest.mark.parametrize("mode", ["mono", "rgbd"])
def test_node_tcp_round_trip(mode, mono_run):
    """IMG0 frames (``tests/test_node.py``'s case: the POSE records are the
    in-process records through JSON), and IMG0 + DPT1 (f32 depth) for
    RGB-D, over a socket: a POSE a frame, then FINI."""
    if mode == "mono":
        node, got, poses, fini = mono_run
        assert poses == got and fini["n_tracked"] >= 8, fini
        n = len(got)
    else:
        node = tnode.SlamNode(_port_cfg(**STEREO_KW), mode, device=CPU)
        cli, th, raised = _start_server(tnode, node)
        room = BoxRoom(seed=0)
        n = 4
        for i, (R, t) in enumerate(_poses(n)):
            img, depth = room.render(R, t, PARAMS, W, H, return_depth=True)
            tnode._send_msg(cli, b"IMG0", _img0(i / 20.0, img))
            tnode._send_msg(cli, b"DPT1", _img2(depth, "<f4"))
        tnode._send_msg(cli, b"DONE", b"")
        poses, fini = _collect(cli)
        cli.close()
        th.join(timeout=30)
        assert not raised, raised
        assert fini["n_tracked"] == n, fini
    assert fini["n_frames"] == n == len(poses) and fini["n_dropped"] == 0
    assert [p["t"] for p in poses] == [i / 20.0 for i in range(n)]


def test_stereo_node_over_tcp_matches_jax(stereo_pairs):
    """16 rectified pairs as IMG0 + IMG1 through the port's server, against
    the JAX node fed the same pairs in process (its grab callbacks, then
    ``stop(drain=True)``), both in localisation mode after the stereo
    initialisation (the node's transport and publisher, not the mapper:
    with it, one keyframe decision moves later frames by millimetres): the
    published states equal, every published camera centre within
    ``POS_TOL_M`` (frame 1 ``FRAME1_TOL_M``), the same FINI counts."""
    jn = jnode.SlamNode(_jax_cfg(**STEREO_KW), "stereo")
    jn.slam.set_localization_mode(True)
    ref = []
    jn.subscribe(ref.append)
    for i, (left, right) in enumerate(stereo_pairs):
        jn.grab_image(left.astype(np.float32), i / 20.0, img2=right.astype(np.float32))
    jn.start()
    jn.stop(drain=True)

    node = tnode.SlamNode(_port_cfg(**STEREO_KW), "stereo", device=CPU)
    node.slam.set_localization_mode(True)
    cli, th, raised = _start_server(tnode, node)
    for i, (left, right) in enumerate(stereo_pairs):
        tnode._send_msg(cli, b"IMG0", _img0(i / 20.0, left))
        tnode._send_msg(cli, b"IMG1", _img2(right, np.uint8))
    tnode._send_msg(cli, b"DONE", b"")
    poses, fini = _collect(cli)
    cli.close()
    th.join(timeout=30)
    assert not raised, raised
    assert [p["state"] for p in poses] == [p["state"] for p in ref]
    assert [p["frame_id"] for p in poses] == list(range(N_STEREO))
    d = np.linalg.norm(np.asarray([p["twc"] for p in poses]) - np.asarray([p["twc"] for p in ref]),
                       axis=1)
    assert d[1] < FRAME1_TOL_M and np.delete(d, 1).max() < POS_TOL_M, d
    assert fini == {"n_frames": len(jn.slam.trajectory), "n_dropped": 0,
                    "n_tracked": sum(r.state == "OK" for r in jn.slam.trajectory)}


# ---- the JAX node's faults, shown in both packages ----------------------

def test_imus_documented_layout():
    """An IMUS block as the protocol documents it (``u32 n``, then the
    samples): the port's node holds the samples bit for bit; the JAX server
    reads them at offset 8, past the end of the payload, and raises."""
    rng = np.random.default_rng(5)
    samples = rng.normal(size=(9, 7))
    samples[:, 0] = np.sort(rng.uniform(0.0, 1.0, 9))
    node = tnode.SlamNode(_port_cfg(**MONO_KW), "mono-inertial", device=CPU)
    cli, th, raised = _start_server(tnode, node)
    tnode._send_msg(cli, b"IMUS", _imus(samples))
    tnode._send_msg(cli, b"DONE", b"")
    poses, fini = _collect(cli)
    cli.close()
    th.join(timeout=30)
    assert not raised and poses == [] and fini["n_frames"] == 0
    got = np.asarray([[t, *a, *g] for t, a, g in node._imu_buf])
    assert got.dtype == np.float64 and np.array_equal(got, samples)

    jn = jnode.SlamNode(_jax_cfg(**MONO_KW), "mono-inertial")
    cli, th, raised = _start_server(jnode, jn)
    jnode._send_msg(cli, b"IMUS", _imus(samples))
    th.join(timeout=30)
    cli.close()
    assert len(raised) == 1 and isinstance(raised[0], ValueError), raised
    assert len(jn._imu_buf) == 0


@pytest.mark.parametrize("tag", [b"IMG1", b"DPT1"])
def test_second_image_without_img0(tag):
    """IMG1 / DPT1 before any IMG0: the port's server raises ``ValueError``
    naming it, the JAX server a ``TypeError`` (it unpacks ``None``)."""
    mode = "stereo" if tag == b"IMG1" else "rgbd"
    payload = _img2(np.zeros((H, W)), np.uint8 if tag == b"IMG1" else "<f4")
    for mod, cfg, want in ((tnode, _port_cfg(**STEREO_KW), ValueError),
                           (jnode, _jax_cfg(**STEREO_KW), TypeError)):
        node = (mod.SlamNode(cfg, mode, device=CPU) if mod is tnode else mod.SlamNode(cfg, mode))
        cli, th, raised = _start_server(mod, node)
        mod._send_msg(cli, tag, payload)
        th.join(timeout=30)
        cli.close()
        assert len(raised) == 1 and type(raised[0]) is want, raised
        if mod is tnode:
            assert str(raised[0]) == f"{tag.decode()} without IMG0"


class _StubFacade:
    """Stands in for a facade: its first ``process`` blocks until released
    (or raises ``fail``); records how many calls ran at once."""

    def __init__(self, fail=None):
        self.lock = threading.Lock()
        self.trajectory = []
        self.fail = fail
        self.entered, self.release = threading.Event(), threading.Event()
        self.calls = self.inside = self.most_inside = 0
        self._count = threading.Lock()

    def process(self, img, frame_id):
        with self._count:
            self.calls += 1
            self.inside += 1
            self.most_inside = max(self.most_inside, self.inside)
            first = self.calls == 1
        try:
            if self.fail is not None:
                raise self.fail
            if first:
                self.entered.set()
                self.release.wait(30)
            return None
        finally:
            with self._count:
                self.inside -= 1


class _ShortJoin:
    """A thread whose ``join`` gives up after 0.2 s, whatever it is asked
    (the JAX node's ``stop`` joins with a fixed 30 s)."""

    def __init__(self, th):
        self.th = th

    def join(self, timeout=None):
        self.th.join(0.2)

    def is_alive(self):
        return self.th.is_alive()


def test_stop_after_a_failed_join():
    """A worker still inside ``slam.process`` when the join times out: the
    port's ``stop`` raises and the backlog waits; the JAX node's drains
    beside the worker, two ``process`` calls at once."""
    for mod in (tnode, jnode):
        node = (mod.SlamNode(_port_cfg(**MONO_KW), "mono", device=CPU) if mod is tnode
                else mod.SlamNode(_jax_cfg(**MONO_KW), "mono"))
        stub = node.slam = _StubFacade()
        for i in range(2):
            node.grab_image(np.zeros((H, W), np.uint8), i / 20.0)
        node.start()
        assert stub.entered.wait(10)
        if mod is tnode:
            with pytest.raises(RuntimeError, match="join timeout"):
                node.stop(drain=True, timeout=0.2)
            assert stub.calls == 1 and stub.most_inside == 1
            stub.release.set()
            node.stop(drain=True)
            assert stub.calls == 2 and stub.most_inside == 1 and node.n_published == 2
        else:
            node._thread = _ShortJoin(node._thread)
            th = node._thread.th
            node.stop(drain=True)  # returns: the drain ran the second frame
            assert stub.calls == 2 and stub.most_inside == 2
            stub.release.set()
            th.join(10)


@pytest.mark.parametrize("where", ["stop", "serve"])
def test_worker_exception_is_raised(where):
    """An exception inside ``slam.process`` in the worker thread: ``stop()``
    raises it; ``serve`` raises it while it waits for the next message and
    closes the connection, so a producer waiting for its POSE sees the
    stream end instead of waiting for ever."""
    node = tnode.SlamNode(_port_cfg(**MONO_KW), "mono", device=CPU)
    fault = RuntimeError("kernel fault on the card")
    node.slam = _StubFacade(fail=fault)
    if where == "stop":
        node.grab_image(np.zeros((H, W), np.uint8), 0.0)
        node.start()
        deadline = time.monotonic() + 10
        while node.error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="kernel fault") as e:
            node.stop(drain=True)
        assert e.value is fault
        return
    cli, th, raised = _start_server(tnode, node)
    tnode._send_msg(cli, b"IMG0", _img0(0.0, np.zeros((H, W))))
    with pytest.raises(ConnectionError):
        tnode._recv_msg(cli)  # no POSE: the server closed the stream
    th.join(timeout=10)
    cli.close()
    assert not th.is_alive() and raised == [fault]
