"""Trajectory savers in the reference's output formats (port of
:mod:`orb_slam3_noted_tpu.io.trajectory`; ``System::SaveTrajectory{TUM,
EuRoC,KITTI}`` and the keyframe variant):

- TUM:   ``t tx ty tz qx qy qz qw`` per line (camera-to-world)
- EuRoC: the same fields, timestamp in ns
- KITTI: 12 numbers per line, the 3x4 camera-to-world matrix row-major

The quaternions come from :func:`..geometry.so3.to_quat` in float32 on the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.geometry import so3


def _twc_quat(Rcw: np.ndarray, tcw: np.ndarray):
    Rwc = Rcw.T
    twc = -Rwc @ tcw
    q = so3.to_quat(torch.as_tensor(np.asarray(Rwc, np.float32))).numpy()  # (w, x, y, z)
    return Rwc, twc, q


def _stamp(rec):
    """Timestamp of a record; the frame id stands in when none is stored."""
    t = getattr(rec, "timestamp", None)
    return t if t is not None else rec.frame_id


def save_tum(path: str, records):
    """records: iterable of FrameRecord (frame id as timestamp when the
    record has none)."""
    with open(path, "w") as f:
        for rec in records:
            _, twc, q = _twc_quat(rec.Rcw, rec.tcw)
            f.write(
                f"{_stamp(rec):.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
            )


def save_euroc(path: str, records):
    with open(path, "w") as f:
        for rec in records:
            _, twc, q = _twc_quat(rec.Rcw, rec.tcw)
            f.write(
                f"{int(_stamp(rec) * 1e9)} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_kitti(path: str, records):
    with open(path, "w") as f:
        for rec in records:
            Rwc, twc, _ = _twc_quat(rec.Rcw, rec.tcw)
            M = np.concatenate([Rwc, twc[:, None]], axis=1).reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in M) + "\n")


def save_keyframes_tum(path: str, slam, stamps=None):
    """Keyframe trajectory (``SaveKeyFrameTrajectoryTUM``): one line per
    valid keyframe in frame-id order, with each keyframe's final pose.
    ``stamps``: optional frame id -> seconds table; the frame id otherwise."""
    m = slam.m
    kf_valid = m.kf_valid.cpu().numpy()
    fids = m.kf_frame_id.cpu().numpy()
    Rcw = m.kf_Rcw.cpu().numpy()
    tcw = m.kf_tcw.cpu().numpy()
    slots = np.flatnonzero(kf_valid)
    slots = slots[np.argsort(fids[slots])]
    with open(path, "w") as f:
        for s in slots:
            t = fids[s]
            if stamps is not None and 0 <= t < len(stamps):
                t = stamps[int(t)]
            _, twc, q = _twc_quat(Rcw[s], tcw[s])
            f.write(
                f"{float(t):.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
            )
    return path


def load_tum(path: str):
    """-> (t (N,), pos (N, 3), quat_wxyz (N, 4))."""
    raw = np.loadtxt(path)
    return raw[:, 0], raw[:, 1:4], raw[:, [7, 4, 5, 6]]  # the file has qx qy qz qw
