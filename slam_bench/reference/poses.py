"""Tracked poses against the generator's true poses, in float64 numpy.

The relative pose error (RPE) over a lag of frames, as the TUM RGB-D
benchmark's RPE over one second: for frames k - lag and k tracked, the
rotation and translation of Tcw_k Tcw_{k-lag}^-1 (camera k from camera
k - lag) as estimated, against the same from the true camera-to-world poses.
It does not depend on the map's world frame, which is camera 0's.
"""

from __future__ import annotations

import numpy as np


def true_tcw(Rwc: np.ndarray, twc: np.ndarray) -> tuple:
    """World-to-camera (R, t) of camera-to-world poses, (n, 3, 3), (n, 3)."""
    R = np.transpose(Rwc, (0, 2, 1))
    return R, -np.einsum("nij,nj->ni", R, twc)


def in_first_camera(Rcw: np.ndarray, tcw: np.ndarray, R0wc: np.ndarray, t0wc: np.ndarray):
    """World-to-camera poses re-expressed with camera 0 as the world, as the
    map expresses them: Tcw o Twc_0."""
    return Rcw @ R0wc, np.einsum("nij,j->ni", Rcw, t0wc) + tcw


def _rel(R: np.ndarray, t: np.ndarray, lag: int) -> tuple:
    """Camera k from camera k - ``lag``: (R_k R_{k-lag}^T, t_k - that R t_{k-lag})."""
    Rr = np.einsum("nij,nkj->nik", R[lag:], R[:-lag])
    return Rr, t[lag:] - np.einsum("nij,nj->ni", Rr, t[:-lag])


def _pairs(ok: np.ndarray, lag: int) -> np.ndarray:
    return ok[lag:] & ok[:-lag]


def rpe_mm(Rcw: np.ndarray, tcw: np.ndarray, Rcw_true: np.ndarray, tcw_true: np.ndarray,
           ok: np.ndarray, lag: int = 1) -> float:
    """RMS of the relative translation error in mm over the pairs of frames
    ``lag`` apart whose two frames are both tracked (``ok``); inf where no
    pair is."""
    pair = _pairs(ok, lag)
    if not pair.any():
        return float("inf")
    err = np.linalg.norm(_rel(Rcw, tcw, lag)[1] - _rel(Rcw_true, tcw_true, lag)[1], axis=-1)
    return float(np.sqrt(np.mean(err[pair] ** 2)) * 1e3)


def rpe_deg(Rcw: np.ndarray, Rcw_true: np.ndarray, ok: np.ndarray, lag: int = 1) -> float:
    """RMS of the relative rotation error in degrees over the pairs of
    frames ``lag`` apart whose two frames are both tracked; inf where no
    pair is."""
    pair = _pairs(ok, lag)
    if not pair.any():
        return float("inf")
    zero = np.zeros((Rcw.shape[0], 3))
    E = np.einsum("nji,njk->nik", _rel(Rcw, zero, lag)[0], _rel(Rcw_true, zero, lag)[0])
    cos = np.clip((np.trace(E, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))[pair]
    return float(np.sqrt(np.mean(ang ** 2)))


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 and back to float64 (the control)."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).double().numpy()
