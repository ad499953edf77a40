"""Non-rectified fisheye stereo: lapping-area matching and direct
triangulation (port of :mod:`orb_slam3_noted_tpu.ops.fisheye_stereo`).

``Frame::ComputeStereoFishEyeMatches`` matches left and right ORB
descriptors inside each camera's lapping area (mutual best Hamming
neighbours within ``TH_LOW``); ``KannalaBrandt8::TriangulateMatches`` keeps
the pairs whose rays have parallax (cos < 0.9998), triangulates them with
the known extrinsic ``Tlr``, and gates them on depth in both cameras and on
the reprojection error (5.991 sigma^2 of each keypoint's octave).  Every
pair is evaluated at once on the dense (NL, NR) Hamming matrix; argmin
returns the first minimum, as ``jnp.argmin`` does.  A leading batch of
pairs (the fisheye batch mode's front end) goes through in one call, each
pair on its own block (the JAX package's matcher takes one pair).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry.triangulation import triangulate_dlt
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops import matching as M
from orb_slam3_noted_tpu_torch.ops.orb import FrameFeatures
from orb_slam3_noted_tpu_torch.optim.robust import CHI2_MONO
from orb_slam3_noted_tpu_torch.utils import interop
from orb_slam3_noted_tpu_torch.utils.interop import const_tensor

PARALLAX_COS = 0.9998  # reference TriangulateMatches: at least ~1.15 deg of parallax
MIN_Z = 0.05           # in front of both cameras


class FisheyeStereoMatches(NamedTuple):
    """Per-left-feature stereo association (fixed NF length; a leading
    batch of pairs where the features have one)."""

    idx_r: torch.Tensor   # (..., NF) int32 matched right feature, -1 if none
    depth: torch.Tensor   # (..., NF) z in the left camera frame, -1 if none
    pos_l: torch.Tensor   # (..., NF, 3) triangulated point, left camera frame
    valid: torch.Tensor   # (..., NF) bool


def to_numpy(s: FisheyeStereoMatches) -> dict:
    return interop.to_numpy(s)


def _in_lap(f: FrameFeatures, lap) -> torch.Tensor:
    return f.valid & (f.xy[..., 0] >= lap[0]) & (f.xy[..., 0] <= lap[1])


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` (or ``x[..., idx]`` for one value per row) per
    pair: rows of (..., N, C) or (..., N) picked by (..., NF) indices."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def match_fisheye_stereo(
    feats_l: FrameFeatures,
    feats_r: FrameFeatures,
    cam_l: cam_mod.Camera,
    cam_r: cam_mod.Camera,
    Rlr: torch.Tensor,           # (3, 3) rotation of the right camera in the left frame
    tlr: torch.Tensor,           # (3,) right camera origin in the left frame
    lap_l: tuple = (0.0, 1e9),   # (u_begin, u_end) left lapping area
    lap_r: tuple = (0.0, 1e9),
    level_sigma2: tuple | None = None,
    max_dist: int = M.TH_LOW,
) -> FisheyeStereoMatches:
    """Associate and triangulate left/right fisheye features, one pair
    ((NF, ...) fields) or a leading batch of B pairs ((B, NF, ...)), each
    pair on its own (NF, NF) Hamming block.  ``depth`` is the left-frame z
    of ``pos_l``; the KB8 rays are z = 1, so ray x depth is the point."""
    NF = feats_l.xy.shape[-2]
    dev = feats_l.xy.device
    in_l, in_r = _in_lap(feats_l, lap_l), _in_lap(feats_r, lap_r)
    d = M.hamming_matrix(feats_l.desc, feats_r.desc)
    masked = torch.where(in_l[..., :, None] & in_r[..., None, :], d, M.BIG)
    best = torch.amin(masked, dim=-1)
    idx = torch.argmin(masked, dim=-1)   # first minima
    back = torch.argmin(masked, dim=-2)
    ok = (best <= max_dist) & in_l & (_rows(back, idx) == torch.arange(NF, device=dev))

    rays_l = cam_mod.unproject(cam_l, feats_l.xy)              # (..., NF, 3), z = 1
    rays_r = _rows(cam_mod.unproject(cam_r, feats_r.xy), idx)
    bl = rays_l / torch.linalg.vector_norm(rays_l, dim=-1, keepdim=True)
    br = rays_r @ Rlr.T
    br = br / torch.linalg.vector_norm(br, dim=-1, keepdim=True)
    ok = ok & (torch.sum(bl * br, dim=-1) < PARALLAX_COS)

    # x_r = Rrl x_l + trl
    Rrl = Rlr.T
    trl = -(Rrl @ tlr)
    pts_l = triangulate_dlt(rays_l, rays_r, Rrl, trl)
    pts_r = pts_l @ Rrl.T + trl
    zl = pts_l[..., 2]
    ok = ok & (zl > MIN_Z) & (pts_r[..., 2] > MIN_Z)

    # reprojection gates in pixels through each camera's own model: 5.991
    # times the octave's sigma^2 per view
    e_l = torch.sum((cam_mod.project(cam_l, pts_l) - feats_l.xy) ** 2, dim=-1)
    e_r = torch.sum((cam_mod.project(cam_r, pts_r) - _rows(feats_r.xy, idx)) ** 2, dim=-1)
    if level_sigma2 is None:
        s2_l = s2_r = torch.ones_like(zl)
    else:
        s2 = const_tensor(tuple(level_sigma2), pts_l.dtype, dev)
        s2_l = s2[feats_l.level.long()]
        s2_r = s2[_rows(feats_r.level, idx).long()]
    ok = ok & (e_l <= CHI2_MONO * s2_l) & (e_r <= CHI2_MONO * s2_r)
    return FisheyeStereoMatches(
        idx_r=torch.where(ok, idx.to(torch.int32), -1),
        depth=torch.where(ok, zl, -1.0),
        pos_l=pts_l,
        valid=ok,
    )
