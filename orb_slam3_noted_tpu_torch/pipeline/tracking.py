"""Per-frame tracking: local-map projection matching + motion-only pose opt.

Port of the tracking half of :mod:`orb_slam3_noted_tpu.pipeline.tracking`
(``Tracking::TrackLocalMap``): batched frustum/scale visibility of every map
point, window-gated descriptor matching, a compacted observation table for
pose optimisation, and the wide-window retry when too few inliers survive.
The retry is a host branch on the inlier count (one sync per frame) where
the JAX package uses ``lax.cond``.

Triangulation, fuse, local BA and keyframe insertion wait for the
keyframe-insertion slice (ROADMAP, next steps 1).
"""

from __future__ import annotations

import math

import torch

from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops import matching as M
from orb_slam3_noted_tpu_torch.ops import orb as O
from orb_slam3_noted_tpu_torch.ops.fast import topk_stable
from orb_slam3_noted_tpu_torch.optim.pose_opt import PoseObs, pose_optimization
from orb_slam3_noted_tpu_torch.pipeline import map_state as MS


def _scale_table(cfg: SlamConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(
        O.scale_factors(cfg.n_levels, cfg.scale_factor), dtype=like.dtype, device=like.device
    )


def project_map_points(
    m: MS.MapArrays,
    Rcw: torch.Tensor,
    tcw: torch.Tensor,
    cam: cam_mod.Camera,
    width: int,
    height: int,
    n_levels: int = 8,
    scale_factor: float = 1.2,
):
    """uv, predicted level, visibility for ALL map points (batched isInFrustum)."""
    xc = m.mp_pos @ Rcw.T + tcw
    uv = cam_mod.project(cam, xc)
    z_ok = xc[:, 2] > 0.05
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    # distance within the scale-invariance range (reference isInFrustum)
    cam_center = -(Rcw.T @ tcw)
    diff = m.mp_pos - cam_center
    d = torch.linalg.vector_norm(diff, dim=-1)
    dist_ok = (d >= 0.8 * m.mp_dmin) & (d <= 1.2 * m.mp_dmax)
    # viewing angle < 60 deg of the mean normal
    view = diff / torch.clamp(d, min=1e-9)[:, None]
    angle_ok = torch.sum(view * m.mp_normal, dim=-1) > 0.5
    # predicted octave from distance (reference MapPoint::PredictScale)
    ratio = torch.clamp(m.mp_dmax / torch.clamp(d, min=1e-9), min=1.0)
    log_sf = torch.tensor(math.log(scale_factor), dtype=ratio.dtype, device=ratio.device)
    level = torch.clamp(torch.ceil(torch.log(ratio) / log_sf).to(torch.int32), 0, n_levels - 1)
    visible = m.mp_valid & z_ok & in_img & dist_ok & angle_ok
    return uv, level, visible


def match_local_map(
    m: MS.MapArrays,
    feats: O.FrameFeatures,
    Rcw_pred: torch.Tensor,
    tcw_pred: torch.Tensor,
    local_mp_mask: torch.Tensor,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    feat_uvr: torch.Tensor | None = None,
    radius_scale: float = 1.0,
    max_dist: int = M.TH_HIGH,
):
    """Project local map points into the frame and associate features.

    Returns (obs: PoseObs indexed per map point, f_idx (MP,) matched feature
    per map point, vis (MP,)).
    """
    uv_pred, level_pred, visible = project_map_points(
        m, Rcw_pred, tcw_pred, cam, cfg.width, cfg.height, cfg.n_levels, cfg.scale_factor,
    )
    vis = visible & local_mp_mask
    sf = _scale_table(cfg, uv_pred)
    radius = cfg.search_radius_px * radius_scale * sf[level_pred.long()]
    mm = M.search_by_projection(
        uv_pred, radius, level_pred, m.mp_desc, vis,
        feats.xy, feats.level, feats.desc, feats.valid,
        max_dist=max_dist, ratio=cfg.nn_ratio_track,
    )
    mm = M.resolve_duplicates(mm, feats.xy.shape[0])

    matched = mm.idx >= 0
    f_idx = mm.idx.clamp(min=0).long()
    sigma2 = torch.as_tensor(cfg.level_sigma2, dtype=uv_pred.dtype, device=uv_pred.device)
    if feat_uvr is not None:
        uvr = feat_uvr[f_idx]
        is_st = matched & (uvr >= 0)
    else:
        uvr = torch.full_like(uv_pred[:, 0], -1.0)
        is_st = torch.zeros_like(matched)
    obs = PoseObs(
        uv=feats.xy[f_idx],
        uv_r=uvr,
        inv_sigma2=1.0 / sigma2[feats.level[f_idx].long()],
        is_stereo=is_st,
        valid=matched,
    )
    return obs, f_idx, vis


def _optimize_compact(m, obs: PoseObs, R0, t0, cam, bf, n_compact):
    """Pose optimisation on the matched rows only: the valid rows in map
    order first (a stable top-k of the 0/1 mask, as ``lax.top_k`` orders
    it), then inliers scattered back per map point."""
    MP = m.mp_pos.shape[0]
    _, sel = topk_stable(obs.valid.to(torch.int32), n_compact)
    obs_c = PoseObs(
        uv=obs.uv[sel], uv_r=obs.uv_r[sel], inv_sigma2=obs.inv_sigma2[sel],
        is_stereo=obs.is_stereo[sel], valid=obs.valid[sel],
    )
    res = pose_optimization(cam, R0, t0, m.mp_pos[sel], obs_c, bf=bf)
    inl_full = torch.zeros(MP, dtype=torch.bool, device=sel.device)
    inl_full[sel] = res.inliers & obs_c.valid
    return res._replace(inliers=inl_full)


def track_frame(
    m: MS.MapArrays,
    feats: O.FrameFeatures,
    Rcw_pred: torch.Tensor,
    tcw_pred: torch.Tensor,
    local_mp_mask: torch.Tensor,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    feat_uvr: torch.Tensor | None = None,
    bf: float = 0.0,
):
    """Match local map points into the frame and optimise the pose.

    For stereo/RGB-D frames pass ``feat_uvr`` (right-u per feature, -1 for
    mono features) and ``bf``.  Returns (Rcw, tcw, n_inliers, mp_of_feature
    (NF,) int32, vis (MP,), found (MP,)).
    """
    MP = m.mp_pos.shape[0]
    NF = feats.xy.shape[0]
    NC = min(MP, max(2048, 1 << (NF - 1).bit_length()))

    obs, f_idx, vis = match_local_map(
        m, feats, Rcw_pred, tcw_pred, local_mp_mask, cam, cfg, feat_uvr=feat_uvr,
    )
    res = _optimize_compact(m, obs, Rcw_pred, tcw_pred, cam, bf, NC)

    # wide-window retry when the narrow search fails: 3x radius, re-optimise
    # from the first result if it is a usable seed, keep the better one
    n0 = int(res.n_inliers)
    if n0 < 25:
        Rs, ts = (res.Rcw, res.tcw) if n0 >= 10 else (Rcw_pred, tcw_pred)
        obs2, f_idx2, vis2 = match_local_map(
            m, feats, Rs, ts, local_mp_mask, cam, cfg, feat_uvr=feat_uvr, radius_scale=3.0,
        )
        res2 = _optimize_compact(m, obs2, Rs, ts, cam, bf, NC)
        if int(res2.n_inliers) > n0:
            res, obs, f_idx, vis = res2, obs2, f_idx2, vis2

    # map point per frame feature (inverse of the matching); non-kept
    # entries go to a scratch slot NF that is sliced away
    keep = obs.valid & res.inliers
    tgt = torch.where(keep, f_idx, NF)
    src_mp = torch.arange(MP, dtype=torch.int32, device=keep.device)
    mp_of_feat = torch.full((NF + 1,), -1, dtype=torch.int32, device=keep.device)
    mp_of_feat[tgt] = src_mp  # kept targets are unique (resolve_duplicates)
    return res.Rcw, res.tcw, res.n_inliers, mp_of_feat[:NF], vis, keep


def stereo_points_from_depth(
    m: MS.MapArrays,
    slot: int,
    depth: torch.Tensor,      # (NF,) per-feature stereo depth (-1 invalid)
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    bf: float,
):
    """Candidate map points from depth for unbound features of a keyframe
    (stereo branch of ``Tracking::CreateNewKeyFrame``).  Returns (pos_w,
    desc, normal, dmin, dmax, feat_a, feat_b, accept)."""
    NF = m.kf_xy.shape[1]
    R, t = m.kf_Rcw[slot], m.kf_tcw[slot]
    close_th = (bf / cam.fx) * cfg.th_depth
    free = m.kf_feat_valid[slot] & (m.kf_mp[slot] < 0)
    accept = free & (depth > 0) & (depth < close_th)
    rays = cam_mod.unproject(cam, m.kf_xy[slot])
    xc = rays * depth[:, None]
    pos_w = (xc - t) @ R
    cam_center = -(R.T @ t)
    vecs = pos_w - cam_center
    dist = torch.linalg.vector_norm(vecs, dim=-1)
    normal = vecs / torch.clamp(dist, min=1e-9)[:, None]
    sf = _scale_table(cfg, pos_w)
    dmax = dist * sf[m.kf_level[slot].long()]
    dmin = dmax / sf[cfg.n_levels - 1]
    feat = torch.arange(NF, dtype=torch.int32, device=pos_w.device)
    return pos_w, m.kf_desc[slot], normal, dmin, dmax, feat, feat, accept


def track_step(
    m: MS.MapArrays,
    img_u8: torch.Tensor,
    last_kf_slot: int,
    Rcw_pred: torch.Tensor,
    tcw_pred: torch.Tensor,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    bf: float = 0.0,
):
    """Per-frame mono step: extract + local map + matching + pose
    optimisation + visibility counters.  Returns (m, feats, Rcw, tcw,
    n_inliers, mp_of_feat)."""
    feats = O.extract_orb(
        img_u8.to(torch.float32),
        n_features=cfg.n_features, n_levels=cfg.n_levels,
        scale_factor=cfg.scale_factor, th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast,
    )
    mp_mask, _ = MS.local_map_mask(m, last_kf_slot, n_neighbors=cfg.local_window)
    Rcw, tcw, n_inl, mp_of_feat, vis, found = track_frame(
        m, feats, Rcw_pred, tcw_pred, mp_mask, cam, cfg, feat_uvr=None, bf=bf
    )
    m = m._replace(
        mp_visible=m.mp_visible + vis.to(torch.int32),
        mp_found=m.mp_found + found.to(torch.int32),
    )
    return m, feats, Rcw, tcw, n_inl, mp_of_feat
