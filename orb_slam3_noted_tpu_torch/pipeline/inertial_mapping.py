"""Inertial mapping over the device map: Local/Full inertial BA (port of
:mod:`orb_slam3_noted_tpu.pipeline.inertial_mapping`).

:func:`chain_inertial_ba` connects :mod:`..optim.inertial_ba` to the
fixed-capacity :class:`..map_state.MapArrays`: a temporal keyframe chain
(padded, masked) with its preintegrated segments, the reprojection factors
of every map point its keyframes observe (compacted to the points they
see), the oldest real entry fixed.  ``LocalInertialBA`` passes the last
``inertial_window`` keyframes, ``FullInertialBA`` the whole chain with the
stage's bias priors.  Results go back into the map and the per-keyframe
inertial table :class:`KFInertial`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.imu.preintegration import Calib, Preintegrated
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops.fast import topk_stable
from orb_slam3_noted_tpu_torch.optim import factors
from orb_slam3_noted_tpu_torch.optim.inertial_ba import VIBAProblem, visual_inertial_ba
from orb_slam3_noted_tpu_torch.optim.vi_factors import (
    InertialEdges,
    VIState,
    body_from_cam,
    cam_from_body,
)
from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
from orb_slam3_noted_tpu_torch.pipeline import tracking as T
from orb_slam3_noted_tpu_torch.utils.interop import const_tensor
from orb_slam3_noted_tpu_torch.utils.timing import report_saturation


class KFInertial(NamedTuple):
    """Per-keyframe inertial state table (parallel to the map's KF slots)."""

    vel: torch.Tensor  # (KF, 3)
    bg: torch.Tensor   # (KF, 3)
    ba: torch.Tensor   # (KF, 3)


def empty_inertial(cfg: SlamConfig, dtype=torch.float32, device=None) -> KFInertial:
    z = lambda: torch.zeros((cfg.max_keyframes, 3), dtype=dtype, device=device)
    return KFInertial(vel=z(), bg=z(), ba=z())


def _window_obs(m: MS.MapArrays, kf_slots, kf_mask, cfg: SlamConfig):
    """Reprojection table over the window keyframes' feature bindings:
    (obs, seen (MP,) points observed, (keyframe slot, feature) per row)."""
    NF = m.kf_xy.shape[1]
    MP = m.mp_pos.shape[0]
    K = kf_slots.shape[0]
    dev = kf_slots.device
    k_local = torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(NF)
    f_idx = torch.arange(NF, device=dev).repeat(K)
    kf_g = kf_slots.long()[k_local.long()]
    mp_id = m.kf_mp[kf_g, f_idx]
    valid = kf_mask[k_local.long()] & (mp_id >= 0) & m.kf_feat_valid[kf_g, f_idx]
    mp_idx = mp_id.clamp(min=0)
    valid = valid & m.mp_valid[mp_idx.long()]
    sigma2 = const_tensor(tuple(cfg.level_sigma2), m.mp_pos.dtype, dev)
    uvr = m.kf_uvr[kf_g, f_idx]
    # a fisheye rig's second-camera pixels, -1 where there is none
    uv2 = m.kf_xy_r[kf_g, f_idx] if cfg.camera2 is not None else None
    obs = factors.ReprojObs(
        pose_idx=k_local, point_idx=mp_idx, uv=m.kf_xy[kf_g, f_idx], uv_r=uvr,
        inv_sigma2=1.0 / sigma2[m.kf_level[kf_g, f_idx].long()], is_stereo=uvr >= 0,
        valid=valid, uv2=uv2, is_right=None if uv2 is None else valid & (uv2[:, 0] >= 0),
    )
    return obs, T._any_at(MP, mp_idx, valid), (kf_g, f_idx)


def chain_inertial_ba(m: MS.MapArrays, ki: KFInertial, kf_slots: torch.Tensor,
                      kf_mask: torch.Tensor, preints: Preintegrated, seg_valid: torch.Tensor,
                      cam: cam_mod.Camera, calib: Calib, cfg: SlamConfig, bf: float = 0.0,
                      n_iters: int = 4, bias_prior_g: float = 0.0, bias_prior_a: float = 0.0,
                      fix_all_but_last: bool = False):
    """Visual-inertial BA over a temporal keyframe chain: ``kf_slots`` (K,)
    oldest first, ``kf_mask`` its real entries, ``preints`` the (K-1,)
    segments between consecutive entries.  Covers LocalInertialBA (the
    window) and FullInertialBA (the whole chain, bias priors on).  Returns
    (m, ki) updated."""
    K = kf_slots.shape[0]
    dev = kf_slots.device
    dtype = m.mp_pos.dtype
    sl = kf_slots.long()
    Rwb, twb = body_from_cam(m.kf_Rcw[sl], m.kf_tcw[sl], calib)
    idxs = torch.where(kf_mask, kf_slots, 0).long()
    st0 = VIState(Rwb=Rwb, twb=twb, vel=ki.vel[idxs], bg=ki.bg[idxs], ba=ki.ba[idxs])
    obs, seen, (kf_g, f_idx) = _window_obs(m, kf_slots, kf_mask, cfg)
    edges = InertialEdges(
        i=torch.arange(K - 1, dtype=torch.int32, device=dev),
        j=torch.arange(1, K, dtype=torch.int32, device=dev),
        preint=preints, valid=seg_valid & kf_mask[:-1] & kf_mask[1:])
    # gauge: the oldest real entry fixed; padded entries fixed
    first_real = torch.argmax(kf_mask.to(torch.uint8))
    pose_fixed = ~kf_mask | (torch.arange(K, device=dev) == first_real)
    if fix_all_but_last:
        pose_fixed = pose_fixed | (torch.arange(K, device=dev) < (K - 1))
    # the landmark table compacted to the points the window sees (the
    # solver's marginalisation is linear in its size); points beyond the
    # budget are dropped from this BA and counted
    MP = m.mp_pos.shape[0]
    MPC = min(K * m.kf_xy.shape[1] // 2, MP)
    n_seen = torch.sum(seen.to(torch.int32))
    report_saturation("chain_ba_landmarks", torch.clamp(n_seen - MPC, min=0))
    sel = topk_stable(seen.to(torch.int32), MPC)[1]
    inv = torch.zeros(MP, dtype=torch.int32, device=dev)
    inv[sel] = torch.arange(MPC, dtype=torch.int32, device=dev)
    seen_c = seen[sel]
    pidx = obs.point_idx.long()
    obs = obs._replace(point_idx=inv[pidx], valid=obs.valid & seen[pidx])
    cam2, Rrl, trl = T._second_camera(cfg, dev)
    prob = VIBAProblem(state=st0, points=m.mp_pos[sel], obs=obs, edges=edges,
                       pose_fixed=pose_fixed, point_fixed=~seen_c, prior=None)
    res = visual_inertial_ba(cam, calib, prob, bf=bf, n_iters=n_iters, n_iters_final=n_iters,
                             huber_inertial=True, bias_prior_g=bias_prior_g,
                             bias_prior_a=bias_prior_a, cam2=cam2, Rrl=Rrl, trl=trl)
    st = res.state
    Rcw_n, tcw_n = cam_from_body(st, calib)
    m = MS.apply_ba_result(m, kf_slots, kf_mask, Rcw_n, tcw_n, sel, seen_c, res.points)
    # unbind the outlier observations (masked integer deltas: padded
    # entries alias a real slot and add exactly zero), then rebuild the
    # window's observation-matrix rows
    out = obs.valid & ~res.inlier
    old_bind = m.kf_mp[kf_g, f_idx]
    kf_mp = m.kf_mp.index_put((kf_g, f_idx), torch.where(out, -1 - old_bind, 0), accumulate=True)
    k_local = obs.pose_idx.long()
    new_bind = kf_mp[kf_g, f_idx]
    rows = T._any_at(K * MP, k_local * MP + new_bind.clamp(min=0).long(),
                     (new_bind >= 0) & kf_mask[k_local]).reshape(K, MP)
    rows_full = torch.zeros(m.obs_mat.shape, dtype=torch.int32, device=dev).index_add_(
        0, sl, (rows & kf_mask[:, None]).to(torch.int32)) > 0
    mask_full = T._any_at(m.obs_mat.shape[0], sl, kf_mask)
    m = m._replace(kf_mp=kf_mp, obs_mat=torch.where(mask_full[:, None], rows_full, m.obs_mat))
    mk = kf_mask[:, None]
    upd = lambda table, new: table.index_add(0, sl, torch.where(mk, new - table[sl], 0.0))
    return m, KFInertial(vel=upd(ki.vel, st.vel), bg=upd(ki.bg, st.bg), ba=upd(ki.ba, st.ba))
