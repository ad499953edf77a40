"""Per-frame tracking and the synchronous local mapper.

Port of :mod:`orb_slam3_noted_tpu.pipeline.tracking`.  Tracking
(``Tracking::TrackLocalMap``): batched frustum/scale visibility of every map
point, window-gated descriptor matching, a compacted observation table for
pose optimisation, and the wide-window retry when too few inliers survive.
The retry is a host branch on the inlier count (one sync per frame) where
the JAX package uses ``lax.cond``.  A fisheye rig (``cfg.camera2``) adds the
right camera's two rows to every observation with a right pixel, in
tracking, local BA and the keyframe's ``kf_xy_r`` (:func:`_second_camera`).

Monocular initialisation (:func:`init_attempt_batch`): one reference frame
against a batch of candidate frames, batched Hamming matching and two-view
RANSAC (:mod:`..geometry.twoview`).  Batch (throughput) mode
(:func:`track_batch`, :func:`stereo_track_batch`, and the front ends
:func:`fisheye_frontend_batch` and :func:`rgbd_frontend_batch`): extraction
once for the whole batch (the stereo pairs as one batch of 2B images, then
:func:`..ops.stereo.match_stereo` or the fisheye lapping-area matcher over
the B pairs; RGB-D frames read their depth maps), then the frames one
after another with the constant-velocity model carried on the device
(:func:`track_batch_feats`, the ``lax.scan`` of the JAX package as a
Python loop with no host read of its own).

Mapping (``LocalMapping::Run``), one call per keyframe
(:func:`insert_keyframe_step`): depth-seeded points, epipolar-gated
triangulation against the top covisible keyframes
(:func:`triangulate_between`), duplicate fusion (:func:`fuse_map_points`),
point culling and statistics, windowed bundle adjustment with fixed anchors
(:func:`local_ba`) and keyframe culling.  The allocation pointer travels
as a 0-d tensor; the host waits only where ``add_map_points`` packs its
accepted rows and where a capacity counter is read.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.geometry import se3, so3
from orb_slam3_noted_tpu_torch.geometry import twoview as TV
from orb_slam3_noted_tpu_torch.geometry.triangulation import triangulate_dlt
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops import matching as M
from orb_slam3_noted_tpu_torch.ops import image as image_ops
from orb_slam3_noted_tpu_torch.ops import orb as O
from orb_slam3_noted_tpu_torch.ops.fast import topk_stable
from orb_slam3_noted_tpu_torch.ops.fisheye_stereo import match_fisheye_stereo
from orb_slam3_noted_tpu_torch.ops.stereo import match_stereo
from orb_slam3_noted_tpu_torch.optim.pose_opt import PoseObs, pose_optimization
from orb_slam3_noted_tpu_torch.optim.window_ba import WindowObs, window_bundle_adjust
from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
from orb_slam3_noted_tpu_torch.utils.interop import const_tensor, set_scalar
from orb_slam3_noted_tpu_torch.utils.timing import count, device_read, report_saturation, span


# spans (``utils.timing.span``: with nothing recording, a flag check): a
# pair's stereo matching (the batch front ends' too; the pyramid's is
# ``ops.orb.PYRAMID_RANGE``); one ``track_frame`` call and in it each local-map
# match and pose optimisation; the mapper pass's steps
STEREO_RANGE = "stereo_matching"
TRACK_FRAME_RANGE = "track_frame"
MATCH_RANGE = "match_local_map"
POSE_OPT_RANGE = "pose_optimize"
TRIANGULATE_RANGE = "triangulate"
FUSE_RANGE = "fuse"
CULL_POINTS_RANGE = "cull_points"
LOCAL_BA_RANGE = "local_ba"
CULL_KF_RANGE = "cull_keyframes"


def rig_extrinsic(cfg: SlamConfig) -> tuple[np.ndarray, np.ndarray]:
    """(Rlr (3, 3), tlr (3,)) float32: the right camera's pose in the left
    frame, from ``cfg.tlr_r`` (identity when empty) and ``cfg.tlr_t``."""
    Rlr = (np.asarray(cfg.tlr_r, np.float32).reshape(3, 3) if cfg.tlr_r
           else np.eye(3, dtype=np.float32))
    return Rlr, np.asarray(cfg.tlr_t, np.float32)


def _second_camera(cfg: SlamConfig, device):
    """(cam2, Rrl, trl) for two-camera residual rows, on ``device``, or
    (None, None, None) for a rectified or single-camera rig.  The rows need
    the left -> right transform x_r = Rlr^T (x_l - tlr)."""
    if cfg.camera2 is None:
        return None, None, None
    Rlr, tlr = rig_extrinsic(cfg)
    Rrl = Rlr.T
    trl = -Rlr.T @ tlr
    device = torch.device(device)
    return (cfg.camera2, const_tensor(tuple(map(tuple, Rrl.tolist())), torch.float32, device),
            const_tensor(tuple(trl.tolist()), torch.float32, device))


def _scale_table(cfg: SlamConfig, like: torch.Tensor) -> torch.Tensor:
    return const_tensor(
        tuple(O.scale_factors(cfg.n_levels, cfg.scale_factor).tolist()), like.dtype, like.device
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
    log_sf = const_tensor((math.log(scale_factor),), ratio.dtype, ratio.device)[0]
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
    feat_uv2: torch.Tensor | None = None,
):
    """Project local map points into the frame and associate features.

    Returns (obs: PoseObs indexed per map point, f_idx (MP,) matched feature
    per map point, vis (MP,)).  ``feat_uv2`` (NF, 2): the right-camera pixel
    per feature of a fisheye rig (-1 for none); matched features with one
    become two-camera observations.
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
    sigma2 = const_tensor(tuple(cfg.level_sigma2), uv_pred.dtype, uv_pred.device)
    if feat_uvr is not None:
        uvr = feat_uvr[f_idx]
        is_st = matched & (uvr >= 0)
    else:
        uvr = torch.full_like(uv_pred[:, 0], -1.0)
        is_st = torch.zeros_like(matched)
    uv2 = is_right = None
    if feat_uv2 is not None:
        uv2 = feat_uv2[f_idx]
        is_right = matched & (uv2[:, 0] >= 0)
    obs = PoseObs(
        uv=feats.xy[f_idx],
        uv_r=uvr,
        inv_sigma2=1.0 / sigma2[feats.level[f_idx].long()],
        is_stereo=is_st,
        valid=matched,
        uv2=uv2,
        is_right=is_right,
    )
    return obs, f_idx, vis


def _optimize_compact(m, obs: PoseObs, R0, t0, cam, bf, n_compact, rig2=(None, None, None)):
    """Pose optimisation on the matched rows only: the valid rows in map
    order first (a stable top-k of the 0/1 mask, as ``lax.top_k`` orders
    it), then inliers scattered back per map point.  ``rig2`` = (cam2, Rrl,
    trl) of a second camera."""
    MP = m.mp_pos.shape[0]
    _, sel = topk_stable(obs.valid.to(torch.int32), n_compact)
    obs_c = PoseObs(*(None if x is None else x[sel] for x in obs))
    res = pose_optimization(cam, R0, t0, m.mp_pos[sel], obs_c, bf, *rig2)
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
    feat_uv2: torch.Tensor | None = None,
):
    """Match local map points into the frame and optimise the pose.

    For stereo/RGB-D frames pass ``feat_uvr`` (right-u per feature, -1 for
    mono features) and ``bf``; for a fisheye rig ``feat_uv2`` (the matched
    right-camera pixel per feature, -1 for none).  Returns (Rcw, tcw,
    n_inliers, mp_of_feature (NF,) int32, vis (MP,), found (MP,)).
    """
    with span(TRACK_FRAME_RANGE) as sp:
        return _track_frame(m, feats, Rcw_pred, tcw_pred, local_mp_mask, cam, cfg, feat_uvr, bf,
                            feat_uv2, sp)


def _track_frame(m, feats, Rcw_pred, tcw_pred, local_mp_mask, cam, cfg, feat_uvr, bf, feat_uv2,
                 sp):
    MP = m.mp_pos.shape[0]
    NF = feats.xy.shape[0]
    NC = min(MP, max(2048, 1 << (NF - 1).bit_length()))
    rig2 = _second_camera(cfg, m.mp_pos.device)
    count("track_calls")

    with span(MATCH_RANGE):
        obs, f_idx, vis = match_local_map(
            m, feats, Rcw_pred, tcw_pred, local_mp_mask, cam, cfg, feat_uvr=feat_uvr,
            feat_uv2=feat_uv2,
        )
    with span(POSE_OPT_RANGE):
        res = _optimize_compact(m, obs, Rcw_pred, tcw_pred, cam, bf, NC, rig2)

    # wide-window retry when the narrow search fails: 3x radius, re-optimise
    # from the first result if it is a usable seed, keep the better one
    with device_read():
        n0 = int(res.n_inliers)
    if n0 < 25:
        count("track_wide_search")
        sp.set(wide=True)
        Rs, ts = (res.Rcw, res.tcw) if n0 >= 10 else (Rcw_pred, tcw_pred)
        with span(MATCH_RANGE):
            obs2, f_idx2, vis2 = match_local_map(
                m, feats, Rs, ts, local_mp_mask, cam, cfg, feat_uvr=feat_uvr, radius_scale=3.0,
                feat_uv2=feat_uv2,
            )
        with span(POSE_OPT_RANGE):
            res2 = _optimize_compact(m, obs2, Rs, ts, cam, bf, NC, rig2)
        with device_read():
            n2 = int(res2.n_inliers)
        if n2 > n0:
            res, obs, f_idx, vis = res2, obs2, f_idx2, vis2

    # map point per frame feature (inverse of the matching); non-kept
    # entries go to a scratch slot NF that is sliced away
    keep = obs.valid & res.inliers
    tgt = torch.where(keep, f_idx, NF)
    src_mp = torch.arange(MP, dtype=torch.int32, device=keep.device)
    mp_of_feat = torch.full((NF + 1,), -1, dtype=torch.int32, device=keep.device)
    mp_of_feat[tgt] = src_mp  # kept targets are unique (resolve_duplicates)
    return res.Rcw, res.tcw, res.n_inliers, mp_of_feat[:NF], vis, keep


def reloc_matches(m: MS.MapArrays, cand_slot: int, feats: O.FrameFeatures, cam: cam_mod.Camera):
    """3D-2D matches for relocalisation against a candidate keyframe (the
    ``SearchByBoW(KF, F)`` step of ``Tracking::Relocalization``): the frame's
    features matched to the candidate's features that carry a map point,
    mutual nearest neighbours within ``TH_LOW``.  Returns (Xw (NF, 3), rays
    (NF, 3) on z = 1, ok (NF,) bool)."""
    d = M.hamming_matrix(feats.desc, m.kf_desc[cand_slot])
    kf_mp = m.kf_mp[cand_slot]
    gate = feats.valid[:, None] & ((kf_mp >= 0) & m.kf_feat_valid[cand_slot])[None, :]
    masked = torch.where(gate, d, M.BIG)
    best = torch.amin(masked, dim=1)
    idx = torch.argmin(masked, dim=1)   # first minima, as jnp.argmin
    back = torch.argmin(masked, dim=0)
    ok = (best <= M.TH_LOW) & (back[idx] == torch.arange(d.shape[0], device=d.device))
    mp = kf_mp[idx].clamp(min=0).long()
    ok = ok & m.mp_valid[mp]
    return m.mp_pos[mp], cam_mod.unproject(cam, feats.xy), ok


# ---------------------------------------------------------------------------
# new map points between keyframes
# ---------------------------------------------------------------------------

def triangulate_between(m: MS.MapArrays, slot_a, slot_b, cam: cam_mod.Camera, cfg: SlamConfig):
    """Match unbound features of keyframe a against keyframe b and triangulate
    (``LocalMapping::CreateNewMapPoints`` with ``SearchForTriangulation``:
    epipolar-gated mutual-best descriptor match, then the cheirality,
    parallax and reprojection gates).

    ``slot_b`` is one slot, or an (N,) tensor of slots: then every output
    carries a leading N, one batched pass over all neighbours.  Returns
    (pos_w, desc, normal, dmin, dmax, feat_a, feat_b, accept), one candidate
    per feature of keyframe a.
    """
    single = not (isinstance(slot_b, torch.Tensor) and slot_b.dim() == 1)
    dev = m.kf_xy.device
    sb = torch.as_tensor(slot_b, device=dev).reshape(-1).long()
    N, NF = sb.shape[0], m.kf_xy.shape[1]
    Ra, ta = m.kf_Rcw[slot_a], m.kf_tcw[slot_a]
    Rb, tb = m.kf_Rcw[sb], m.kf_tcw[sb]
    # relative pose b<-a : x_b = Rba x_a + tba
    Rba = Rb @ Ra.T
    tba = tb - torch.einsum("nij,j->ni", Rba, ta)

    free_a = m.kf_feat_valid[slot_a] & (m.kf_mp[slot_a] < 0)
    free_b = m.kf_feat_valid[sb] & (m.kf_mp[sb] < 0)
    rays_a = cam_mod.unproject(cam, m.kf_xy[slot_a])               # (NF, 3)
    rays_b = cam_mod.unproject(cam, m.kf_xy[sb])                   # (N, NF, 3)

    # descriptor distances with epipolar gating (Sampson, normalised coords)
    d = M.hamming_matrix(m.kf_desc[slot_a], m.kf_desc[sb].reshape(N * NF, 8))
    d = d.reshape(NF, N, NF).permute(1, 0, 2)                      # (N, a, b)
    E = so3.hat(tba) @ Rba
    Ex1 = torch.einsum("nij,aj->nai", E, rays_a)
    Etx2 = torch.einsum("nji,nbj->nbi", E, rays_b)
    x2Ex1 = torch.einsum("nbi,nai->nab", rays_b, Ex1)
    denom = (
        (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2)[:, :, None]
        + (Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)[:, None, :]
    )
    sampson = x2Ex1 ** 2 / torch.clamp(denom, min=1e-12)
    fx = cam.fx
    gate = free_a[None, :, None] & free_b[:, None, :] & (sampson < (3.84 / (fx * fx)))
    masked = torch.where(gate, d, M.BIG)
    best = torch.amin(masked, dim=2)
    idx_b = torch.argmin(masked, dim=2)                             # (N, NF)
    ok = (best <= M.TH_LOW) & free_a
    best_for_b = torch.argmin(masked, dim=1)                        # (N, NFb)
    ok = ok & (torch.gather(best_for_b, 1, idx_b) == torch.arange(NF, device=dev))

    ra = rays_a.expand(N, NF, 3)
    rb = torch.gather(rays_b, 1, idx_b[..., None].expand(N, NF, 3))
    pts_a = triangulate_dlt(ra, rb, Rba[:, None], tba[:, None])
    za = pts_a[..., 2]
    pb = torch.einsum("naj,nij->nai", pts_a, Rba) + tba[:, None]
    zb = pb[..., 2]
    # acceptance: cheirality, parallax, reprojection in both views
    za_s = torch.where(za.abs() < 1e-9, 1e-9, za)
    zb_s = torch.where(zb.abs() < 1e-9, 1e-9, zb)
    e_a = torch.sum((pts_a[..., :2] / za_s[..., None] - ra[..., :2]) ** 2, dim=-1)
    e_b = torch.sum((pb[..., :2] / zb_s[..., None] - rb[..., :2]) ** 2, dim=-1)
    reproj_ok = (e_a < 2 * 3.84 / (fx * fx)) & (e_b < 2 * 3.84 / (fx * fx))
    cam_b_in_a = -torch.einsum("nji,nj->ni", Rba, tba)
    v2 = pts_a - cam_b_in_a[:, None]
    cosp = torch.sum(pts_a * v2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(pts_a, dim=-1) * torch.linalg.vector_norm(v2, dim=-1), min=1e-12
    )
    accept = ok & (za > 0.05) & (zb > 0.05) & (cosp < 0.9998) & reproj_ok

    # to world: x_w = Ra^T (x_a - ta); normal and scale range from keyframe a
    pos_w = torch.einsum("ji,naj->nai", Ra, pts_a - ta)
    vecs = pos_w + Ra.T @ ta
    dist = torch.linalg.vector_norm(vecs, dim=-1)
    normal = vecs / torch.clamp(dist, min=1e-9)[..., None]
    sf = _scale_table(cfg, pos_w)
    dmax = dist * sf[m.kf_level[slot_a].long()]
    dmin = dmax / sf[cfg.n_levels - 1]
    out = (
        pos_w, m.kf_desc[slot_a].expand(N, NF, 8), normal, dmin, dmax,
        torch.arange(NF, dtype=torch.int32, device=dev).expand(N, NF),
        idx_b.to(torch.int32), accept,
    )
    return tuple(x[0] for x in out) if single else out


def fuse_map_points(
    m: MS.MapArrays,
    target_slot: int,
    source_mask: torch.Tensor,   # (MP,) candidate source points
    cam: cam_mod.Camera,
    cfg: SlamConfig,
) -> MS.MapArrays:
    """Project source map points into a keyframe; bind or merge duplicates
    (``ORBmatcher::Fuse`` driven by ``LocalMapping::SearchInNeighbors``).

    A source point matching an unbound feature gets bound; one matching a
    feature bound to a different point triggers a merge that keeps the
    better-observed point.  Merges are applied globally in one pass; merge
    chains are skipped (their members fuse on a later call).  Where two
    merges name the same losing point, the one from the higher source index
    counts.
    """
    MP = m.mp_pos.shape[0]
    NF = m.kf_xy.shape[1]
    dev = m.mp_pos.device
    R, t = m.kf_Rcw[target_slot], m.kf_tcw[target_slot]
    uv, level, visible = project_map_points(
        m, R, t, cam, cfg.width, cfg.height, cfg.n_levels, cfg.scale_factor
    )
    src = source_mask & visible & m.mp_valid
    sf = _scale_table(cfg, uv)
    mm = M.search_by_projection(
        uv, 3.0 * sf[level.long()], level, m.mp_desc, src,
        m.kf_xy[target_slot], m.kf_level[target_slot], m.kf_desc[target_slot],
        m.kf_feat_valid[target_slot], max_dist=M.TH_LOW,
    )
    mm = M.resolve_duplicates(mm, NF)
    matched = mm.idx >= 0
    f_idx = mm.idx.clamp(min=0).long()
    old_row = m.kf_mp[target_slot]
    existing = old_row[f_idx]                        # (MP,) bound point or -1
    mp_ids = torch.arange(MP, dtype=torch.int32, device=dev)

    # case A: bind to an unbound feature (targets are unique after
    # resolve_duplicates; the rest go to a scratch entry that is cut off)
    bind = matched & (existing < 0)
    new_row = torch.cat([old_row, old_row.new_full((1,), -1)])
    new_row[torch.where(bind, f_idx, NF)] = torch.where(bind, mp_ids, -1)
    obs_mat = m.obs_mat.clone()
    obs_mat[target_slot] |= bind
    m = m._replace(
        kf_mp=MS._set(m.kf_mp, target_slot, new_row[:NF]),
        obs_mat=obs_mat,
        mp_nobs=m.mp_nobs + bind.to(torch.int32),
    )

    # case B: merge with an already-bound different point
    other = existing.clamp(min=0)
    mergeable = matched & (existing >= 0) & (existing != mp_ids) & m.mp_valid[other.long()]
    keep_self = m.mp_nobs >= m.mp_nobs[other.long()]
    winner = torch.where(keep_self, mp_ids, other)
    loser = torch.where(keep_self, other, mp_ids)
    # replace map: identity except losers; rows that merge nothing park on
    # the scratch point MP-1 with its own value
    replace = MS.scatter_set_last(
        mp_ids, torch.where(mergeable, loser, MP - 1), torch.where(mergeable, winner, MP - 1)
    )
    is_loser = replace != mp_ids
    chain = is_loser[replace.long()]  # the winner is itself a loser -> skip
    replace = torch.where(chain, mp_ids, replace)
    is_loser = replace != mp_ids
    rep = replace.long()

    kf_mp = torch.where(m.kf_mp >= 0, replace[m.kf_mp.clamp(min=0).long()], -1)
    # fold loser observation columns into the winner's, then drop losers
    folded = torch.zeros(m.obs_mat.shape, dtype=torch.int32, device=dev)
    folded.index_add_(1, rep, m.obs_mat.to(torch.int32))
    nobs_new = torch.zeros_like(m.mp_nobs).index_add_(
        0, rep, torch.where(m.mp_valid, m.mp_nobs, 0))
    return m._replace(
        kf_mp=kf_mp,
        obs_mat=(folded > 0) & ~is_loser[None, :],
        mp_valid=m.mp_valid & ~is_loser,
        mp_nobs=nobs_new,
    )


def _add_candidates_dev(m, slot: int, out, n_mp, kf_b_override=None):
    """Insert accepted candidates at consecutive slots from ``n_mp``;
    returns (m, new n_mp as a 0-d tensor).  Candidates past the table's end
    are dropped and counted by ``add_map_points``."""
    pos_w, desc, normal, dmin, dmax, feat_a, feat_b, accept = out
    MP = m.mp_pos.shape[0]
    offs = torch.cumsum(accept.to(torch.int32), dim=0) - 1
    stored = accept & (n_mp + offs < MP - 1)
    kf_b = slot if kf_b_override is None else kf_b_override
    m = MS.add_map_points(
        m, n_mp, pos_w, desc, normal, dmin, dmax, slot, accept, slot, feat_a, kf_b, feat_b,
    )
    return m, n_mp + torch.sum(stored.to(torch.int32))


def insert_keyframe_step(
    m: MS.MapArrays,
    slot: int,
    Rcw: torch.Tensor,
    tcw: torch.Tensor,
    frame_id: int,
    feats: O.FrameFeatures,
    mp_of_feat: torch.Tensor,    # (NF,) map-point binding per feature
    uvr: torch.Tensor,           # (NF,) stereo right-u or -1
    depth: torch.Tensor,         # (NF,) stereo depth or -1 (ignored unless has_depth)
    n_mp,                        # allocation pointer: int or 0-d int32 tensor
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    n_neighbors: int = 2,
    bf: float = 0.0,
    has_depth: bool = False,
    visual_ba: bool = True,
    xy_r: torch.Tensor | None = None,   # (NF, 2) right-camera obs (fisheye) or None
):
    """The whole synchronous mapper pass for one keyframe
    (``LocalMapping::Run``): insert -> (stereo) depth-seeded points ->
    triangulate against the top covisible neighbours -> fuse -> point cull
    -> point statistics -> local BA -> keyframe cull.  ``visual_ba=False``
    (the inertial caller, which runs LocalInertialBA over the temporal chain
    and owns keyframe culling) stops after the statistics.  Returns (m,
    n_mp) with ``n_mp`` a 0-d int32 tensor."""
    dev = m.mp_pos.device
    n_mp = torch.as_tensor(n_mp, dtype=torch.int32, device=dev)
    m = MS.add_keyframe(
        m, slot, Rcw, tcw, frame_id,
        feats.xy, feats.level, feats.angle, feats.desc, feats.valid, mp_of_feat, uvr, xy_r=xy_r,
    )
    with span(TRIANGULATE_RANGE):
        if has_depth:
            out = stereo_points_from_depth(m, slot, depth, cam, cfg, bf=bf)
            m, n_mp = _add_candidates_dev(m, slot, out, n_mp)

        # all top covisible neighbours in one batch; a feature triangulated by
        # several neighbours keeps only its first (best-covisibility) hit
        NF = m.kf_xy.shape[1]
        w = MS.covisibility_weights(m, slot)
        nbs = topk_stable(w, n_neighbors)[1]                                # (N,)
        pos_w, desc, normal, dmin, dmax, feat_a, feat_b, acc = triangulate_between(
            m, slot, nbs, cam, cfg)
        acc = acc & (w[nbs] > 0)[:, None]
        k_first = torch.argmax(acc.to(torch.uint8), dim=0)                  # (NF,)
        keep = acc & (torch.arange(n_neighbors, device=dev)[:, None] == k_first[None, :])
        out = (
            pos_w.reshape(-1, 3), desc.reshape(-1, 8), normal.reshape(-1, 3),
            dmin.reshape(-1), dmax.reshape(-1),
            feat_a.reshape(-1), feat_b.reshape(-1), keep.reshape(-1),
        )
        m, n_mp = _add_candidates_dev(m, slot, out, n_mp,
                                      kf_b_override=nbs.repeat_interleave(NF))

    with span(FUSE_RANGE):
        mp_mask, kf_mask = MS.local_map_mask(m, slot, n_neighbors=cfg.local_window)
        m = fuse_map_points(m, slot, mp_mask, cam, cfg)
    with span(CULL_POINTS_RANGE):
        m = MS.cull_map_points(m, slot)
        m = MS.update_point_stats(m, mp_mask, n_levels=cfg.n_levels,
                                  scale_factor=cfg.scale_factor)
    if not visual_ba:
        return m, n_mp
    with span(LOCAL_BA_RANGE):
        m = local_ba(m, slot, cam, cfg, window=cfg.local_window, bf=bf)
    with span(CULL_KF_RANGE):
        protect = torch.zeros(m.kf_valid.shape[0], dtype=torch.bool, device=dev)
        set_scalar(protect, slot, True)
        set_scalar(protect, 0, True)
        return MS.cull_keyframes(m, kf_mask, protect), n_mp


# ---------------------------------------------------------------------------
# local bundle adjustment over the covisibility window
# ---------------------------------------------------------------------------

_ANCHOR_OBS_CAP = 4096  # out-of-window anchor observations kept (compacted)


def _any_at(n: int, idx: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """(n,) bool: ``zeros(n).at[idx].max(flag)`` (an integer add, exact in
    any order)."""
    hits = torch.zeros(n, dtype=torch.int32, device=idx.device)
    return hits.index_add_(0, idx.long(), flag.to(torch.int32)) > 0


def local_ba(
    m: MS.MapArrays,
    center_slot: int,
    cam: cam_mod.Camera,
    cfg: SlamConfig,
    window: int = 8,
    bf: float = 0.0,
) -> MS.MapArrays:
    """Windowed BA with the reference's full fixed-anchor set
    (``LocalBundleAdjustment``).

    Free: the top-``window`` covisible keyframes of ``center_slot``, the
    centre, and the points they see; the earliest frame of the window fixes
    the gauge.  Fixed anchors: all other keyframes observing those points
    contribute their observations with frozen poses, compacted to
    ``_ANCHOR_OBS_CAP`` rows (overflow is counted).  Window observations
    classified as outliers are unbound afterwards.
    """
    KF, NF = m.kf_xy.shape[0], m.kf_xy.shape[1]
    MP = m.mp_pos.shape[0]
    K = window + 1
    dev = m.mp_pos.device
    i32 = torch.int32

    w = MS.covisibility_weights(m, center_slot)
    top_w, top_i = topk_stable(w, window)
    kf_slots = torch.cat([torch.tensor([center_slot], device=dev), top_i])   # (K,) long
    kf_mask = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), top_w > 0])
    in_window = _any_at(KF, kf_slots, kf_mask)
    fids = torch.where(kf_mask, m.kf_frame_id[kf_slots], 1 << 30)
    pose_fixed_w = ~kf_mask
    set_scalar(pose_fixed_w, torch.argmin(fids), True)
    # padded entries read and write the scratch row KF of the padded tables
    kf_slots_w = torch.where(kf_mask, kf_slots, KF)

    # window observation rows: every feature of the window keyframes
    k_local = torch.arange(K, device=dev).repeat_interleave(NF)
    f_idx = torch.arange(NF, device=dev).repeat(K)
    kf_g = kf_slots[k_local]
    mp_id = m.kf_mp[kf_g, f_idx]
    mp_idx = mp_id.clamp(min=0).long()
    valid = kf_mask[k_local] & (mp_id >= 0) & m.kf_feat_valid[kf_g, f_idx] & m.mp_valid[mp_idx]
    seen = _any_at(MP, mp_idx, valid)

    # anchor rows: out-of-window observations of window points
    all_k = torch.arange(KF, device=dev).repeat_interleave(NF)
    all_f = torch.arange(NF, device=dev).repeat(KF)
    all_mp = m.kf_mp.reshape(-1)
    cand = (
        m.kf_valid[all_k] & ~in_window[all_k] & (all_mp >= 0)
        & m.kf_feat_valid.reshape(-1) & seen[all_mp.clamp(min=0).long()]
    )
    sel = topk_stable(cand.to(i32), _ANCHOR_OBS_CAP)[1]
    report_saturation(
        "local_ba_anchor_obs", torch.clamp(torch.sum(cand.to(i32)) - _ANCHOR_OBS_CAP, min=0)
    )
    a_k, a_f = all_k[sel], all_f[sel]

    sigma2 = const_tensor(tuple(cfg.level_sigma2), m.mp_pos.dtype, dev)
    pose_idx = torch.cat([kf_g, a_k])
    feat_idx = torch.cat([f_idx, a_f])
    uvr = m.kf_uvr[pose_idx, feat_idx]
    cam2, Rrl, trl = _second_camera(cfg, dev)
    uv2 = m.kf_xy_r[pose_idx, feat_idx] if cam2 is not None else None
    obs = WindowObs(
        pose_idx=pose_idx.to(i32),
        wpose_idx=torch.cat([k_local, torch.full_like(a_k, K)]).to(i32),
        point_idx=torch.cat([mp_idx, all_mp[sel].clamp(min=0).long()]).to(i32),
        uv=m.kf_xy[pose_idx, feat_idx],
        uv_r=uvr,
        inv_sigma2=1.0 / sigma2[m.kf_level[pose_idx, feat_idx].long()],
        is_stereo=uvr >= 0,
        valid=torch.cat([valid, cand[sel]]),
        uv2=uv2,
        is_right=None if uv2 is None else uv2[:, 0] >= 0,
    )
    Rcw_pad = torch.cat([m.kf_Rcw, torch.eye(3, dtype=m.kf_Rcw.dtype, device=dev)[None]])
    tcw_pad = torch.cat([m.kf_tcw, torch.zeros((1, 3), dtype=m.kf_tcw.dtype, device=dev)])
    res = window_bundle_adjust(
        cam, Rcw_pad, tcw_pad, m.mp_pos, obs, kf_slots_w, pose_fixed_w, ~seen,
        bf=bf, n_iters=cfg.ba_iters, n_iters_final=cfg.ba_iters_final,
        cam2=cam2, Rrl=Rrl, trl=trl,
    )
    # unbind window observations classified as outliers; rows of padded
    # entries are not valid and so change nothing
    out = valid & ~res.inlier[: K * NF]
    # the centre can come up again among the padded entries (its own weight
    # is 0); the JAX package's scatters run in row order, so that later
    # entry restores the centre's bindings and observation row
    centre_again = torch.any(~kf_mask & (kf_slots == center_slot))
    out = out & ~(centre_again & (k_local == 0))
    kf_mp = torch.cat([m.kf_mp.reshape(-1), m.kf_mp.new_full((1,), -1)])
    set_scalar(kf_mp, torch.where(out, kf_g * NF + f_idx, KF * NF), -1)
    kf_mp = kf_mp[: KF * NF].reshape(KF, NF)
    # obs_mat rows of the window keyframes, rebuilt from the surviving bindings
    rows = _any_at(K * MP, k_local * MP + mp_idx, valid & ~out).reshape(K, MP)
    rows[0] = torch.where(centre_again, m.obs_mat[center_slot], rows[0])
    obs_ext = torch.cat([m.obs_mat, m.obs_mat[:1]])
    obs_ext[kf_slots_w] = rows
    return m._replace(
        kf_Rcw=res.Rcw[:KF], kf_tcw=res.tcw[:KF], mp_pos=res.points,
        kf_mp=kf_mp, obs_mat=obs_ext[:KF],
    )


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


# ---------------------------------------------------------------------------
# monocular initialisation
# ---------------------------------------------------------------------------

N_HYP = 256  # RANSAC hypotheses per model and attempt


def init_attempt_batch(ref: O.FrameFeatures, feats_all: O.FrameFeatures, cam: cam_mod.Camera,
                       draw):
    """Two-view initialisation attempts of one reference frame against a
    batch of B candidate frames (``Tracking::MonocularInitialization``):
    batched Hamming matching (mutual, ratio 0.9, rotation-consistent), then
    :func:`..geometry.twoview.reconstruct_two_views` over all B pairs.

    ``draw`` maps the (B, N) match mask to the RANSAC minimal sets, (B,
    n_hyp, 8) indices (for instance :func:`..geometry.twoview.
    sample_minimal_sets` with :data:`N_HYP` and a generator).  The
    reconstruction runs for every candidate, however few its matches; the
    caller gates on ``n_matches``.  Returns (n_matches (B,), success (B,),
    good (B, N), points1 (B, N, 3), R21 (B, 3, 3), t21 (B, 3), idx (B, N)).
    """
    d = M.hamming_matrix(ref.desc, feats_all.desc)                       # (B, N, N)
    B = d.shape[0]
    mm = M.match_nn(
        d, ref.valid.expand(B, -1), feats_all.valid, max_dist=M.TH_LOW, ratio=0.9,
        mutual=True, ang_a=ref.angle.expand(B, -1), ang_b=feats_all.angle,
    )
    idx = mm.idx
    matched = idx >= 0
    rays1 = cam_mod.unproject(cam, ref.xy).expand(B, -1, -1)
    xy2 = torch.gather(feats_all.xy, 1, idx.clamp(min=0).long()[..., None].expand(-1, -1, 2))
    rays2 = cam_mod.unproject(cam, xy2)
    res = TV.reconstruct_two_views(rays1, rays2, matched, draw(matched),
                                   err_thresh=3.84 / (cam.fx * cam.fx))
    return (torch.sum(matched, dim=-1), res.success, res.is_inlier, res.points1, res.R21,
            res.t21, idx)


# ---------------------------------------------------------------------------
# batch (throughput) mode
# ---------------------------------------------------------------------------

def track_batch_feats(m, feats_all, last_kf_slot, Rcw0, tcw0, vel0, cam, cfg, bf=0.0,
                      count_mask=None, uvr_all=None, uv2_all=None):
    """Track the B already-extracted frames of ``feats_all`` one after
    another against the same map (the JAX package's ``lax.scan``; also the
    re-track after a keyframe inserted mid-batch): each frame's prediction
    is the constant-velocity model applied to the previous output, and a
    frame below ``min_tracked_points`` keeps the prediction and the old
    velocity (``torch.where``; nothing is read back here beyond what
    :func:`track_frame` reads).  ``count_mask`` (B,) keeps padding and
    already-committed frames out of the visible/found counters; ``uvr_all``
    (B, NF) gives stereo frames their 3-row observations, ``uv2_all`` (B, NF,
    2) a fisheye rig's matched right pixels (-1 for none; the second camera
    comes from ``cfg``).  Returns (m, Rcw (B, 3, 3), tcw (B, 3), n_inl (B,),
    feats_all, mp_of_feat (B, NF))."""
    mp_mask, _ = MS.local_map_mask(m, last_kf_slot, n_neighbors=cfg.local_window)
    B = feats_all.xy.shape[0]
    if count_mask is None:
        count_mask = torch.ones(B, dtype=torch.bool, device=feats_all.xy.device)
    Rprev, tprev = Rcw0, tcw0
    Rv, tv = vel0
    vis_c = torch.zeros_like(m.mp_visible)
    found_c = torch.zeros_like(m.mp_found)
    outs = []
    for b in range(B):
        Rp, tp = se3.compose((Rv, tv), (Rprev, tprev))
        Rcw, tcw, n_inl, mp_of_feat, vis, found = track_frame(
            m, O.FrameFeatures(*(f[b] for f in feats_all)), Rp, tp, mp_mask, cam, cfg,
            feat_uvr=None if uvr_all is None else uvr_all[b], bf=bf,
            feat_uv2=None if uv2_all is None else uv2_all[b],
        )
        ok = n_inl >= cfg.min_tracked_points
        # the velocity moves only when tracking succeeded
        Rv_new, tv_new = se3.compose((Rcw, tcw), se3.inverse((Rprev, tprev)))
        Rv, tv = torch.where(ok, Rv_new, Rv), torch.where(ok, tv_new, tv)
        Rprev, tprev = torch.where(ok, Rcw, Rp), torch.where(ok, tcw, tp)
        vis_c = vis_c + (vis & count_mask[b]).to(torch.int32)
        found_c = found_c + (found & count_mask[b]).to(torch.int32)
        outs.append((Rprev, tprev, n_inl, mp_of_feat))
    Rs, ts, n_inls, mp_feats = (torch.stack(x) for x in zip(*outs))
    m = m._replace(mp_visible=m.mp_visible + vis_c, mp_found=m.mp_found + found_c)
    return m, Rs, ts, n_inls, feats_all, mp_feats


def _orb_kw(cfg: SlamConfig) -> dict:
    return dict(n_features=cfg.n_features, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
                th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast)


def track_batch(m, imgs_u8, last_kf_slot, Rcw0, tcw0, vel0, cam, cfg, bf=0.0, count_mask=None):
    """Track a (B, H, W) uint8 batch: extraction once for the batch (K1, K2
    and K3 one launch each), then :func:`track_batch_feats`.  ``vel0``: (R,
    t) relative motion, identity when none.  Returns (m, Rcw (B, 3, 3), tcw
    (B, 3), n_inl (B,), feats of all frames (leading B), mp_of_feat (B, NF))."""
    feats_all = O.extract_orb_batch(imgs_u8.to(torch.float32), **_orb_kw(cfg))
    return track_batch_feats(m, feats_all, last_kf_slot, Rcw0, tcw0, vel0, cam, cfg, bf,
                             count_mask)


def stereo_frontend_batch(imgs_u8, cam, cfg, bf):
    """Batched extraction of B rectified pairs and their stereo matching.
    ``imgs_u8`` (2B, H, W): the B left images, then the B right ones, one
    atlas batch (K1, K2 and K3 once each); then
    :func:`..ops.stereo.match_stereo` over the B pairs (K4 once).  Returns
    (featsL (leading B), uvr (B, NF), depth (B, NF))."""
    B = imgs_u8.shape[0] // 2
    with span(O.PYRAMID_RANGE):
        pyr = tuple(image_ops.build_pyramid(imgs_u8.to(torch.float32), cfg.n_levels,
                                            cfg.scale_factor))
        atlas = image_ops.build_atlas(pyr)
    feats2 = O.extract_from_atlas(atlas, **_orb_kw(cfg))
    featsL = O.FrameFeatures(*(f[:B] for f in feats2))
    featsR = O.FrameFeatures(*(f[B:] for f in feats2))
    with span(STEREO_RANGE):
        sm = match_stereo(
            featsL, featsR, tuple(p[:B] for p in pyr), tuple(p[B:] for p in pyr),
            bf=bf, baseline=bf / cam.fx, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
            atlases=(atlas._replace(image=atlas.image[:B]),
                     atlas._replace(image=atlas.image[B:])),
        )
        return (featsL, torch.where(sm.valid, sm.u_right, -1.0),
                torch.where(sm.valid, sm.depth, -1.0))


def fisheye_stereo_rows(feats_l, feats_r, cfg: SlamConfig, Rlr, tlr):
    """A fisheye rig's stereo rows for one pair ((NF, ...) features) or a
    batch of pairs ((B, NF, ...)): the lapping-area match
    (:func:`..ops.fisheye_stereo.match_fisheye_stereo`; no kernel, K4 is for
    rectified pairs only) with the rig of ``cfg`` (``Rlr``, ``tlr``: the
    right camera's pose in the left frame, :func:`rig_extrinsic`).  Returns
    (depth (..., NF) in the left camera frame or -1, uv2 (..., NF, 2) the
    matched right pixel or -1)."""
    sm = match_fisheye_stereo(
        feats_l, feats_r, cfg.camera, cfg.camera2, Rlr, tlr, lap_l=tuple(cfg.lapping_l),
        lap_r=tuple(cfg.lapping_r), level_sigma2=cfg.level_sigma2,
    )
    idx = sm.idx_r.clamp(min=0).long()
    uv2 = torch.gather(feats_r.xy, -2, idx[..., None].expand(*idx.shape, 2))
    return torch.where(sm.valid, sm.depth, -1.0), torch.where(sm.valid[..., None], uv2, -1.0)


def fisheye_frontend_batch(imgs_u8, cfg, Rlr, tlr):
    """Batched extraction of B fisheye pairs and their stereo rows.
    ``imgs_u8`` (2B, H, W): the B left images, then the B right ones, one
    atlas batch (K1, K2 and K3 once each); then :func:`fisheye_stereo_rows`
    over the B pairs in one call.  Returns (featsL (leading B), depth (B,
    NF), uv2 (B, NF, 2))."""
    B = imgs_u8.shape[0] // 2
    feats2 = O.extract_orb_batch(imgs_u8.to(torch.float32), **_orb_kw(cfg))
    featsL = O.FrameFeatures(*(f[:B] for f in feats2))
    featsR = O.FrameFeatures(*(f[B:] for f in feats2))
    with span(STEREO_RANGE):
        return (featsL, *fisheye_stereo_rows(featsL, featsR, cfg, Rlr, tlr))


def rgbd_depth_rows(feats: O.FrameFeatures, dmap: torch.Tensor, bf: float):
    """Per-feature depth from a registered depth map and the virtual right
    coordinate ``u_r = u - bf / d`` (``Frame::ComputeStereoFromRGBD``), for
    one frame ((NF, ...) features, (H, W) map) or a batch ((B, NF, ...),
    (B, H, W)): the bilinear depth at the sub-pixel keypoint, the nearest
    pixel's where any of the four neighbours is invalid (depth edges).
    Returns (depth, uvr), -1 where the feature or its depth is invalid."""
    H, W = dmap.shape[-2:]
    flat = dmap.reshape(*dmap.shape[:-2], H * W)
    at = lambda yi, xi: torch.gather(flat, -1, yi * W + xi)
    x = torch.clamp(feats.xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(feats.xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx_ = x - x0
    fy_ = y - y0
    d00 = at(y0, x0)
    d01 = at(y0, x0 + 1)
    d10 = at(y0 + 1, x0)
    d11 = at(y0 + 1, x0 + 1)
    all_ok = (d00 > 0) & (d01 > 0) & (d10 > 0) & (d11 > 0)
    d_bil = (
        d00 * (1 - fx_) * (1 - fy_) + d01 * fx_ * (1 - fy_)
        + d10 * (1 - fx_) * fy_ + d11 * fx_ * fy_
    )
    d_near = at(torch.round(y).long(), torch.round(x).long())
    d = torch.where(all_ok, d_bil, d_near)
    valid_d = feats.valid & (d > 0)
    depth = torch.where(valid_d, d, -1.0)
    uvr = torch.where(valid_d, feats.xy[..., 0] - bf / torch.clamp(d, min=1e-6), -1.0)
    return depth, uvr


def rgbd_frontend_batch(imgs_u8, depth, cfg):
    """Batched extraction of B gray images (K1, K2 and K3 once each; no K4)
    and their depth rows (:func:`rgbd_depth_rows`) from the B registered
    depth maps ``depth`` (B, H, W) float32.  Returns (feats (leading B), uvr
    (B, NF), depth (B, NF))."""
    feats = O.extract_orb_batch(imgs_u8.to(torch.float32), **_orb_kw(cfg))
    d, uvr = rgbd_depth_rows(feats, depth, cfg.bf)
    return feats, uvr, d


def stereo_track_batch(m, imgs_u8, last_kf_slot, Rcw0, tcw0, vel0, cam, cfg, bf,
                       count_mask=None):
    """Stereo batch mode: B rectified pairs, (2B, H, W) as
    :func:`stereo_frontend_batch` takes them, through the batched front
    end, then :func:`track_batch_feats` with 3-row stereo observations.
    Returns (m, Rs, ts, n_inls, featsL (leading B), mp_feats (B, NF), uvr
    (B, NF), depth (B, NF))."""
    featsL, uvr, depth = stereo_frontend_batch(imgs_u8, cam, cfg, bf)
    m, Rs, ts, n_inls, feats_out, mp_feats = track_batch_feats(
        m, featsL, last_kf_slot, Rcw0, tcw0, vel0, cam, cfg, bf, count_mask, uvr_all=uvr)
    return m, Rs, ts, n_inls, feats_out, mp_feats, uvr, depth
