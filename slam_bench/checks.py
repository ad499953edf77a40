"""The numbers a cell compares with its plain reference.

Each returns a share or a distance that is 0 for a perfect answer, so that a
limit is an upper bound.  The readings and limits are in ``PERF.md``; the
limits themselves in ``limits/<cell>.json``.
"""

from __future__ import annotations

import numpy as np
import torch

XY_TOL_PX = 1e-3       # a keypoint's level-0 position
ANGLE_TOL_RAD = 1e-4   # its orientation
DEPTH_RTOL = 1e-3      # a stereo depth, relative


def orb_agree(prog, ref) -> torch.Tensor:
    """Per slot: both invalid, or both valid at the same level, position,
    orientation and descriptor."""
    vp, vr = prog.valid.bool(), ref.valid.bool()
    dang = torch.remainder(prog.angle.double() - ref.angle.double() + np.pi, 2 * np.pi) - np.pi
    same = ((prog.level == ref.level)
            & ((prog.xy.double() - ref.xy.double()).abs() <= XY_TOL_PX).all(-1)
            & (dang.abs() <= ANGLE_TOL_RAD)
            & (prog.desc.to(torch.int32) == ref.desc.to(torch.int32)).all(-1))
    return (vp == vr) & (~vp | same)


def orb_mismatch(prog, ref) -> tuple:
    """(slots that differ, slots valid on either side)."""
    either = prog.valid.bool() | ref.valid.bool()
    bad = either & ~orb_agree(prog, ref)
    return int(bad.sum()), int(either.sum())


def stereo_mismatch(prog, prog_depth, ref, ref_depth) -> tuple:
    """(keypoints whose stereo depth differs, keypoints with a depth on
    either side): a keypoint agrees where ORB agrees and both sides give no
    depth, or depths within ``DEPTH_RTOL``."""
    dp, dr = prog_depth.double(), ref_depth.double()
    either = (dp > 0) | (dr > 0)
    close = (dp > 0) & (dr > 0) & ((dp - dr).abs() <= DEPTH_RTOL * dr.abs())
    bad = either & ~(orb_agree(prog, ref) & close)
    return int(bad.sum()), int(either.sum())


def share(parts: list) -> float:
    """Summed (bad, of) pairs as one share; 1 where nothing was compared."""
    bad = sum(b for b, _ in parts)
    of = sum(o for _, o in parts)
    return bad / of if of else 1.0
