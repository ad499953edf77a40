"""Live streaming SLAM node (port of :mod:`orb_slam3_noted_tpu.node`): the
role of the reference's five ROS nodes (``ros_mono.cc``,
``ros_mono_inertial.cc``, ``ros_stereo.cc``, ``ros_rgbd.cc``,
``ros_stereo_inertial.cc``) on plain sockets and threads.

- :class:`SlamNode` owns a SLAM facade built by :func:`..cli.build_system`
  on ``device`` (the card unless named), thread-safe ``grab_image`` /
  ``grab_imu`` intake queues, a sync loop in a worker thread that releases
  an image once the IMU samples reach its time, and a publisher of one pose
  record a frame.
- :func:`serve` speaks a length-prefixed binary TCP protocol to one
  producer (camera driver, bag replayer, another process): frames and IMU
  samples in, one POSE record a processed frame back on the same socket.

Run it as::

    python -m orb_slam3_noted_tpu_torch.node --settings S.yaml --mode stereo \\
        --port 7777 [--realtime] [--device cuda]

Where the JAX package's node is at fault, this one does what its protocol
documents:

- an IMUS block's samples start at offset 4, after its ``u32 n`` (the JAX
  server reads them at 8, past the end of the payload);
- IMG1 or DPT1 with no IMG0 before it raises ``ValueError`` (the JAX
  server unpacks ``None``);
- ``stop()`` never drains while the worker thread is still in
  ``slam.process`` after the join timed out: it raises ``RuntimeError``;
- an exception in the sync loop is kept: ``stop()`` raises it, and
  ``serve`` raises it while it waits for the next message, closing the
  connection (the JAX loop dies with its daemon thread and the producer
  waits for a POSE that never comes).

The facade's ``lock`` is held around every ``slam.process``, so a
:class:`..utils.viewer.LiveViewer` on the same system never reads a map
that is half written.
"""

from __future__ import annotations

import json
import select
import socket
import struct
import threading
from collections import deque

import numpy as np

__all__ = ["SlamNode", "serve", "main"]

_INERTIAL_MODES = {"mono-inertial", "stereo-inertial", "fisheye-stereo-inertial"}
_TWO_IMAGE_MODES = {"stereo", "fisheye-stereo", "rgbd", "stereo-inertial",
                    "fisheye-stereo-inertial"}
JOIN_TIMEOUT_S = 30.0  # how long stop() waits for a frame in flight
POLL_S = 0.05          # the sync loop's idle wait, and serve's error check while it reads


class SlamNode:
    """In-process live node: grab callbacks, the sync loop, the pose
    publisher (reference ``ImageGrabber`` + ``ImuGrabber`` + the sync
    thread, `ros_mono_inertial.cc:96-185`, in one object)."""

    def __init__(self, cfg, mode: str, realtime: bool = False, device=None):
        from orb_slam3_noted_tpu_torch.cli import build_system, resolve_mode

        self.mode = resolve_mode(cfg, mode)
        self.slam = build_system(cfg, self.mode, device=device)
        self.two_image = self.mode in _TWO_IMAGE_MODES
        self.inertial = self.mode in _INERTIAL_MODES
        # drop the backlog to the newest frame (the stereo-inertial reference
        # node keeps only the freshest images); off: every frame is processed
        self.realtime = realtime

        self._lock = threading.Lock()          # the intake queues (mBufMutex)
        self._img_buf: deque = deque()         # (t, img, img2)
        self._imu_buf: deque = deque()         # (t, acc3, gyr3)
        self._have_work = threading.Event()
        self._stop = threading.Event()
        self._subs: list = []
        self._thread: threading.Thread | None = None
        self._frame_id = 0
        self.n_dropped = 0
        self.n_published = 0
        self.error: Exception | None = None  # what ended the sync loop

    # ---- intake callbacks (thread-safe; the Grab* topic callbacks) ----

    def grab_image(self, img, t: float, img2=None):
        """Queue a frame (``ImageGrabber::GrabImage``); ``img2`` is the
        right or depth image of a two-image mode."""
        if self.two_image and img2 is None:
            raise ValueError(f"mode {self.mode} needs img2")
        with self._lock:
            self._img_buf.append((float(t), img, img2))
        self._have_work.set()

    def grab_imu(self, t: float, acc, gyr):
        """Queue one IMU sample (``ImuGrabber::GrabImu``)."""
        with self._lock:
            self._imu_buf.append((float(t), np.asarray(acc, np.float64),
                                  np.asarray(gyr, np.float64)))
        self._have_work.set()

    def subscribe(self, fn):
        """Register a pose subscriber ``fn(record_dict)``."""
        self._subs.append(fn)

    # ---- sync loop -----------------------------------------------------

    def _imu_ready(self, img_t: float) -> bool:
        # an image waits until the IMU samples reach its time
        # (`ros_mono_inertial.cc:150`)
        return bool(self._imu_buf) and self._imu_buf[-1][0] >= img_t

    def spin_once(self) -> bool:
        """Process at most one queued frame; True if one ran."""
        with self._lock:
            if not self._img_buf:
                return False
            if self.realtime and len(self._img_buf) > 1:
                self.n_dropped += len(self._img_buf) - 1
                while len(self._img_buf) > 1:
                    self._img_buf.popleft()
            t, img, img2 = self._img_buf[0]
            if self.inertial and not self._imu_ready(t):
                return False
            self._img_buf.popleft()
            samples = []
            while self.inertial and self._imu_buf and self._imu_buf[0][0] <= t:
                samples.append(self._imu_buf.popleft())

        fid = self._frame_id
        self._frame_id += 1
        with self.slam.lock:
            if self.inertial:
                imu_t = np.array([s[0] for s in samples], np.float64)
                acc = np.array([s[1] for s in samples], np.float64).reshape(-1, 3)
                gyr = np.array([s[2] for s in samples], np.float64).reshape(-1, 3)
                imgs = (img, img2) if self.two_image else (img,)
                rec = self.slam.process(*imgs, fid, t=t, acc=acc, gyr=gyr, imu_t=imu_t)
            elif self.two_image:
                rec = self.slam.process(img, img2, fid)
            else:
                rec = self.slam.process(img, fid)
        self._publish(rec, t)
        return True

    def _publish(self, rec, t: float):
        if rec is None:
            msg = {"t": float(t), "state": "NOT_INITIALIZED"}
        else:
            # camera-to-world, as the reference publishes on its pose topic
            Rwc = np.asarray(rec.Rcw, np.float64).T
            twc = -Rwc @ np.asarray(rec.tcw, np.float64)
            msg = {"t": float(t), "frame_id": int(rec.frame_id), "state": str(rec.state),
                   "n_inliers": int(rec.n_inliers), "Rwc": Rwc.tolist(), "twc": twc.tolist()}
        self.n_published += 1
        for fn in self._subs:
            fn(msg)

    def _loop(self):
        try:
            while not self._stop.is_set():
                self._have_work.clear()
                if not self.spin_once():
                    self._have_work.wait(timeout=POLL_S)
        except Exception as e:  # kept for stop() and serve, not lost with the thread
            self.error = e

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True, name="slam-node")
        self._thread.start()

    def check(self):
        """Raise the exception that ended the sync loop, if one did."""
        if self.error is not None:
            raise self.error

    def _halt(self, timeout: float):
        self._stop.set()
        self._have_work.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"the sync loop did not stop within the {timeout} s join timeout; not "
                    "draining while it may still be inside slam.process")
            self._thread = None

    def stop(self, drain: bool = True, timeout: float = JOIN_TIMEOUT_S):
        """Stop the sync loop, raise its exception if it died of one, and
        with ``drain`` process the backlog after.  The worker is joined
        before the drain: ``slam.process`` must never run in two threads."""
        self._halt(timeout)
        self.check()
        if drain:
            while self.spin_once():
                pass


# ---- TCP transport -----------------------------------------------------
#
# One duplex connection.  Inbound messages, each ``4-byte tag + u32 length
# + payload`` (little-endian):
#   IMG0  payload = f64 t, u32 w, u32 h, w*h u8 gray (starts a frame)
#   IMG1  payload = u32 w, u32 h, w*h u8: the right image of a two-image mode
#   DPT1  payload = u32 w, u32 h, w*h f32: the depth image (rgbd)
#   IMUS  payload = u32 n, n x 7 f64 (t, ax, ay, az, gx, gy, gz), from offset 4
#   DONE  payload empty: drain, reply the trajectory summary, close
# Outbound: POSE + u32 length + a JSON record per processed frame, then on
# DONE one FINI + u32 length + JSON {"n_frames", "n_tracked", "n_dropped"}.


def _read_exact(sock: socket.socket, n: int, check=None) -> bytearray:
    """``n`` bytes from ``sock``; while none arrive, ``check()`` every
    ``POLL_S`` (it raises to give up)."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        if check is not None:
            while not select.select([sock], [], [], POLL_S)[0]:
                check()
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError("stream closed mid-message")
        got += k
    return buf


def _send_msg(sock: socket.socket, tag: bytes, payload: bytes):
    sock.sendall(tag + struct.pack("<I", len(payload)) + payload)


def _recv_msg(sock: socket.socket, check=None):
    head = _read_exact(sock, 8, check)
    tag, n = bytes(head[:4]), struct.unpack("<I", head[4:])[0]
    return tag, _read_exact(sock, n, check)


def _decode_image(payload, off: int, dtype) -> np.ndarray:
    w, h = struct.unpack_from("<II", payload, off)
    size = np.dtype(dtype).itemsize * w * h
    if len(payload) != off + 8 + size:
        raise ValueError(f"a {w}x{h} {np.dtype(dtype).name} image needs {off + 8 + size} "
                         f"bytes, the message has {len(payload)}")
    return np.frombuffer(payload, dtype, count=w * h, offset=off + 8).reshape(h, w)


def _decode_imus(payload) -> np.ndarray:
    (n,) = struct.unpack_from("<I", payload)
    if len(payload) != 4 + 56 * n:
        raise ValueError(f"IMUS of {n} samples needs {4 + 56 * n} bytes, has {len(payload)}")
    return np.frombuffer(payload, np.float64, count=7 * n, offset=4).reshape(n, 7)


def serve(node: SlamNode, host: str = "127.0.0.1", port: int = 0,
          ready_event: threading.Event | None = None, _bound: list | None = None):
    """Accept ONE producer connection and stream poses back over it.

    Returns when the producer sends DONE; raises on a malformed message, a
    closed stream, or the sync loop's exception (the connection is closed
    first).  ``port=0`` binds an ephemeral port, reported through
    ``_bound.append((host, port))``."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    if _bound is not None:
        _bound.append(srv.getsockname())
    if ready_event is not None:
        ready_event.set()
    conn, _ = srv.accept()
    send_lock = threading.Lock()

    def pose_out(msg):
        with send_lock:
            try:
                _send_msg(conn, b"POSE", json.dumps(msg).encode())
            except OSError:
                pass  # the producer hung up; DONE never comes and the loop ends

    node.subscribe(pose_out)
    node.start()
    pending = None  # (t, left) awaiting its IMG1 / DPT1
    try:
        while True:
            tag, payload = _recv_msg(conn, node.check)
            node.check()
            if tag == b"IMG0":
                t = struct.unpack_from("<d", payload)[0]
                img = _decode_image(payload, 8, np.uint8)
                if node.two_image:
                    pending = (t, img)
                else:
                    node.grab_image(img, t)
            elif tag in (b"IMG1", b"DPT1"):
                if pending is None:
                    raise ValueError(f"{tag.decode()} without IMG0")
                t, left = pending
                img2 = _decode_image(payload, 0, np.uint8 if tag == b"IMG1" else np.float32)
                node.grab_image(left, t, img2=img2)
                pending = None
            elif tag == b"IMUS":
                for row in _decode_imus(payload):
                    node.grab_imu(row[0], row[1:4], row[4:7])
            elif tag == b"DONE":
                node.stop(drain=True)
                traj = node.slam.trajectory
                fini = {"n_frames": len(traj), "n_tracked": sum(r.state == "OK" for r in traj),
                        "n_dropped": node.n_dropped}
                with send_lock:
                    _send_msg(conn, b"FINI", json.dumps(fini).encode())
                break
            else:
                raise ValueError(f"unknown message tag {tag!r}")
    finally:
        try:
            node._halt(JOIN_TIMEOUT_S)
        finally:
            conn.close()
            srv.close()


def main(argv=None):
    """``python -m orb_slam3_noted_tpu_torch.node --settings S.yaml --mode
    mono --port 7777 [--realtime] [--device cuda]`` (the ``rosrun ORB_SLAM3
    Mono voc settings`` analogue)."""
    import argparse

    from orb_slam3_noted_tpu_torch.io.yaml_compat import load_settings

    ap = argparse.ArgumentParser(description="live streaming SLAM node")
    ap.add_argument("--settings", required=True)
    ap.add_argument("--mode", default="mono")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7777)
    ap.add_argument("--realtime", action="store_true", help="drop backlog to the newest frame")
    ap.add_argument("--device", default="cuda", help="torch device of the SLAM state")
    args = ap.parse_args(argv)
    cfg, _ = load_settings(args.settings)
    node = SlamNode(cfg, args.mode, realtime=args.realtime, device=args.device)
    ready, bound = threading.Event(), []
    failed = []

    def run():
        try:
            serve(node, args.host, args.port, ready_event=ready, _bound=bound)
        except BaseException as e:
            failed.append(e)
            ready.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    ready.wait()
    if bound:
        host, port = bound[0]
        print(f"listening on {host}:{port} mode={node.mode} device={node.slam.device}",
              flush=True)
    th.join()
    if failed:
        raise failed[0]


if __name__ == "__main__":
    main()
