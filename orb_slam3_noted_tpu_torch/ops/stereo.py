"""Rectified stereo matching: row-band Hamming + SAD subpixel refinement.

Port of :mod:`orb_slam3_noted_tpu.ops.stereo` (``Frame::ComputeStereoMatches``):
one (NL, NR) masked Hamming matrix picks each left keypoint's right
candidate (row band +-2 x scale, octave +-1, disparity in [0, bf/b], best
below (TH_HIGH + TH_LOW) / 2); the sliding SAD refinement runs at the
keypoint's own pyramid level on a level-stacked atlas per side (kernel K4,
:func:`..cuda_kernels.sad_stereo`), followed by the parabola subpixel fit
with the reference's gates and its median-based outlier filter
(1.5 x 1.4 x median SAD).

Also :func:`stereo_from_depth` for RGB-D (``ComputeStereoFromRGBD``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
from orb_slam3_noted_tpu_torch.ops import matching as M
from orb_slam3_noted_tpu_torch.ops.orb import FrameFeatures, scale_factors
from orb_slam3_noted_tpu_torch.utils import interop

_L = ck.SAD_SLIDE


class StereoMatches(NamedTuple):
    u_right: torch.Tensor  # (NL,) refined right-image u at level 0 (-1 if none)
    depth: torch.Tensor    # (NL,) bf/disparity (-1 if none)
    valid: torch.Tensor    # (NL,) bool


def to_numpy(s: StereoMatches) -> dict:
    return interop.to_numpy(s)


def from_numpy(d: dict, device=None) -> StereoMatches:
    """{field: array} (e.g. ``jax.device_get(sm)._asdict()``) -> StereoMatches."""
    return interop.from_numpy(StereoMatches, d, device)


class PyramidAtlas(NamedTuple):
    """The levels of one pyramid stacked into one (sum h_l, W0) image, each
    level left-aligned and zero-padded to the level-0 width, with the
    per-level tables the SAD kernel indexes by keypoint level."""

    image: torch.Tensor  # (HA, W0) float32
    off: torch.Tensor    # (n_levels,) int32 first row of each level
    h: torch.Tensor      # (n_levels,) int32
    w: torch.Tensor      # (n_levels,) int32


def build_atlas(pyr: tuple) -> PyramidAtlas:
    W0 = pyr[0].shape[-1]
    hs = [int(p.shape[-2]) for p in pyr]
    ws = [int(p.shape[-1]) for p in pyr]
    dev = pyr[0].device
    image = torch.cat([F.pad(p, (0, W0 - w)) for p, w in zip(pyr, ws)], dim=-2).contiguous()
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return PyramidAtlas(image, i32(np.concatenate([[0], np.cumsum(hs)])[:len(hs)]), i32(hs), i32(ws))


def level_centres(left: FrameFeatures, right: FrameFeatures, idx_r: torch.Tensor, pyr_left: tuple):
    """(cv, cu, cur) int32: each left keypoint's row and column, and its
    matched right keypoint's column, at the left keypoint's level
    (half-pixel centres, rounded half to even)."""
    dtype = left.xy.dtype
    dev = left.xy.device
    H0, W0 = pyr_left[0].shape[-2], pyr_left[0].shape[-1]
    sx_t = torch.tensor([W0 / p.shape[-1] for p in pyr_left], dtype=dtype, device=dev)
    sy_t = torch.tensor([H0 / p.shape[-2] for p in pyr_left], dtype=dtype, device=dev)
    lvl = left.level.long()
    sx, sy = sx_t[lvl], sy_t[lvl]
    uR0 = right.xy[idx_r.long(), 0]
    cu = torch.round((left.xy[:, 0] + 0.5) / sx - 0.5).to(torch.int32)
    cv = torch.round((left.xy[:, 1] + 0.5) / sy - 0.5).to(torch.int32)
    cur = torch.round((uR0 + 0.5) / sx - 0.5).to(torch.int32)
    return cv, cu, cur, sx


def hamming_candidates(left: FrameFeatures, right: FrameFeatures, bf: float, baseline: float,
                       n_levels: int = 8, scale_factor: float = 1.2):
    """(idx_r (NL,) int64, have (NL,) bool): best right candidate per left
    keypoint under the row, octave and disparity gates, first index on
    ties."""
    sf = torch.as_tensor(scale_factors(n_levels, scale_factor), dtype=left.xy.dtype,
                         device=left.xy.device)
    max_d = bf / baseline
    th_orb = (M.TH_HIGH + M.TH_LOW) // 2
    d = M.hamming_matrix(left.desc, right.desc)  # (NL, NR)
    row_tol = 2.0 * sf[right.level.long()]       # reference: 2 x right scale
    dv = torch.abs(left.xy[:, None, 1] - right.xy[None, :, 1])
    row_ok = dv <= row_tol[None, :]
    lvl_ok = torch.abs(left.level[:, None] - right.level[None, :]) <= 1
    disp = left.xy[:, None, 0] - right.xy[None, :, 0]
    disp_ok = (disp >= 0.0) & (disp <= max_d)
    gate = row_ok & lvl_ok & disp_ok & left.valid[:, None] & right.valid[None, :]
    masked = torch.where(gate, d, M.BIG)
    best = torch.amin(masked, dim=1)
    idx_r = torch.argmin(masked, dim=1)
    return idx_r, best < th_orb


def match_stereo(
    left: FrameFeatures,
    right: FrameFeatures,
    pyr_left: tuple,
    pyr_right: tuple,
    bf: float,
    baseline: float,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> StereoMatches:
    """Match left features to right features on a rectified pair.

    ``pyr_left``/``pyr_right``: the per-level images of
    :func:`..image.build_pyramid`, for the SAD refinement at the keypoint's
    own pyramid level.
    """
    NL = left.xy.shape[0]
    dtype = left.xy.dtype
    max_d = bf / baseline
    idx_r, have = hamming_candidates(left, right, bf, baseline, n_levels, scale_factor)

    uL0 = left.xy[:, 0]
    cv, cu, cur, sx = level_centres(left, right, idx_r, pyr_left)
    al, ar = build_atlas(pyr_left), build_atlas(pyr_right)
    sads = ck.sad_stereo(al.image, ar.image, cv, cu, cur, left.level.contiguous(),
                         al.off, al.h, al.w)     # (NL, 11)

    k = torch.argmin(sads, dim=1)
    interior = (k > 0) & (k < 2 * _L)
    km = torch.clamp(k, 1, 2 * _L - 1)
    d1 = torch.gather(sads, 1, (km - 1)[:, None])[:, 0]
    d2 = torch.gather(sads, 1, km[:, None])[:, 0]
    d3 = torch.gather(sads, 1, (km + 1)[:, None])[:, 0]
    denom = d1 + d3 - 2.0 * d2
    delta = torch.where(torch.abs(denom) > 1e-9, (d1 - d3) / (2.0 * denom), 0.0)
    good_delta = (delta >= -1.0) & (delta <= 1.0) & interior
    u_lvl = cur.to(dtype) + (km - _L) + delta
    uR_best = (u_lvl + 0.5) * sx - 0.5  # inverse half-pixel mapping
    inf = torch.tensor(float("inf"), dtype=dtype, device=sads.device)

    ok_all = have & good_delta
    u_best = torch.where(ok_all, uR_best, -1.0)
    sad_best = torch.where(ok_all, d2, inf)

    disparity = uL0 - u_best
    in_range = (disparity >= 0.0) & (disparity < max_d)
    # clamp tiny/negative disparity like the reference
    disparity = torch.where(disparity <= 0.0, 0.01, disparity)
    u_final = torch.where(disparity <= 0.01, uL0 - 0.01, u_best)
    ok = ok_all & in_range

    # median SAD outlier filter (1.5 * 1.4 * median)
    sadv = torch.where(ok, sad_best, inf)
    n_ok = torch.sum(ok)
    sorted_sad = torch.sort(sadv).values
    med = sorted_sad[torch.clamp(n_ok // 2, 0, NL - 1)]
    keep = ok & (sad_best < 1.5 * 1.4 * med)

    return StereoMatches(
        u_right=torch.where(keep, u_final, -1.0),
        depth=torch.where(keep, bf / disparity, -1.0),
        valid=keep,
    )


def stereo_from_depth(feats: FrameFeatures, depth_img: torch.Tensor, bf: float) -> StereoMatches:
    """RGB-D: read depth at each keypoint, derive the virtual right coord."""
    xi = torch.clamp(feats.xy[:, 0].to(torch.int32), 0, depth_img.shape[1] - 1).long()
    yi = torch.clamp(feats.xy[:, 1].to(torch.int32), 0, depth_img.shape[0] - 1).long()
    dpt = depth_img[yi, xi]
    ok = (dpt > 0) & feats.valid
    return StereoMatches(
        u_right=torch.where(ok, feats.xy[:, 0] - bf / torch.clamp(dpt, min=1e-6), -1.0),
        depth=torch.where(ok, dpt, -1.0),
        valid=ok,
    )
