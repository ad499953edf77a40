"""Fixed-capacity device-resident map state (port of :mod:`orb_slam3_noted_tpu.pipeline.map_state`).

The same structure-of-arrays ``MapArrays`` with the same field names and
shapes, so states compare field by field with the JAX package
(:func:`to_numpy` / :func:`from_numpy`).  Updates are functional: each
function returns a new ``MapArrays`` and leaves its argument untouched.
Descriptors are int32 tensors holding the JAX package's uint32 bits.

Keyframe and point culling, compaction and the point-statistics refresh
wait for the keyframe-insertion slice (ROADMAP, next steps 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.ops.fast import topk_stable
from orb_slam3_noted_tpu_torch.utils import interop
from orb_slam3_noted_tpu_torch.utils.timing import report_saturation


class MapArrays(NamedTuple):
    """All device-resident map storage. Shapes fixed by SlamConfig."""

    # keyframes: pose Tcw, features, bindings
    kf_Rcw: torch.Tensor        # (KF, 3, 3)
    kf_tcw: torch.Tensor        # (KF, 3)
    kf_valid: torch.Tensor      # (KF,) bool
    kf_frame_id: torch.Tensor   # (KF,) int32 source frame index
    kf_xy: torch.Tensor         # (KF, NF, 2) level-0 pixel coords
    kf_level: torch.Tensor      # (KF, NF) int32
    kf_angle: torch.Tensor      # (KF, NF) float32
    kf_desc: torch.Tensor       # (KF, NF, 8) int32 (uint32 bits)
    kf_feat_valid: torch.Tensor  # (KF, NF) bool
    kf_mp: torch.Tensor         # (KF, NF) int32 map-point slot or -1
    kf_uvr: torch.Tensor        # (KF, NF) float32 stereo right-u (<0 if mono)
    kf_xy_r: torch.Tensor       # (KF, NF, 2) float32 second-camera obs, -1 = none
    kf_parent: torch.Tensor     # (KF,) int32 spanning-tree parent, -1 = root

    # map points
    mp_pos: torch.Tensor        # (MP, 3)
    mp_valid: torch.Tensor      # (MP,) bool
    mp_desc: torch.Tensor       # (MP, 8) int32 representative descriptor
    mp_normal: torch.Tensor     # (MP, 3) mean viewing direction (world)
    mp_dmin: torch.Tensor       # (MP,) scale-invariance range (min distance)
    mp_dmax: torch.Tensor       # (MP,)
    mp_ref_kf: torch.Tensor     # (MP,) int32
    mp_nobs: torch.Tensor       # (MP,) int32 observation count
    mp_visible: torch.Tensor    # (MP,) int32 "visible" counter (reference mnVisible)
    mp_found: torch.Tensor      # (MP,) int32 "found" counter (mnFound)

    # dense observation incidence (covisibility)
    obs_mat: torch.Tensor       # (KF, MP) bool


_DESC_FIELDS = ("kf_desc", "mp_desc")


def to_numpy(m: MapArrays) -> dict:
    """MapArrays -> {JAX field name: ndarray}, descriptors as uint32."""
    return interop.to_numpy(m, uint32_fields=_DESC_FIELDS)


def from_numpy(d: dict, device=None) -> MapArrays:
    """{field: array} -> MapArrays on ``device``; takes the JAX package's
    ``jax.device_get(m)._asdict()`` as it is."""
    return interop.from_numpy(MapArrays, d, device)


def empty_map(cfg: SlamConfig, device=None, dtype=torch.float32) -> MapArrays:
    KF, NF, MP = cfg.max_keyframes, cfg.n_features, cfg.max_map_points
    i32 = torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapArrays(
        kf_Rcw=torch.eye(3, dtype=dtype, device=device).repeat(KF, 1, 1),
        kf_tcw=full((KF, 3), 0.0, dtype),
        kf_valid=full((KF,), False, torch.bool),
        kf_frame_id=full((KF,), 0, i32),
        kf_xy=full((KF, NF, 2), 0.0, dtype),
        kf_level=full((KF, NF), 0, i32),
        kf_angle=full((KF, NF), 0.0, dtype),
        kf_desc=full((KF, NF, 8), 0, i32),
        kf_feat_valid=full((KF, NF), False, torch.bool),
        kf_mp=full((KF, NF), -1, i32),
        kf_uvr=full((KF, NF), -1.0, dtype),
        kf_xy_r=full((KF, NF, 2), -1.0, dtype),
        kf_parent=full((KF,), -1, i32),
        mp_pos=full((MP, 3), 0.0, dtype),
        mp_valid=full((MP,), False, torch.bool),
        mp_desc=full((MP, 8), 0, i32),
        mp_normal=full((MP, 3), 0.0, dtype),
        mp_dmin=full((MP,), 0.0, dtype),
        mp_dmax=full((MP,), 1e9, dtype),
        mp_ref_kf=full((MP,), 0, i32),
        mp_nobs=full((MP,), 0, i32),
        mp_visible=full((MP,), 1, i32),
        mp_found=full((MP,), 1, i32),
        obs_mat=full((KF, MP), False, torch.bool),
    )


def _set(t: torch.Tensor, idx, value) -> torch.Tensor:
    """Functional ``t.at[idx].set(value)``."""
    out = t.clone()
    out[idx] = value
    return out


def add_keyframe(
    m: MapArrays,
    slot: int,
    Rcw: torch.Tensor,
    tcw: torch.Tensor,
    frame_id: int,
    xy: torch.Tensor,          # (NF, 2)
    level: torch.Tensor,
    angle: torch.Tensor,
    desc: torch.Tensor,
    feat_valid: torch.Tensor,
    mp_bind: torch.Tensor,     # (NF,) int32 map-point slot per feature or -1
    uvr: torch.Tensor,
    xy_r: torch.Tensor | None = None,   # (NF, 2) right-camera obs or None
) -> MapArrays:
    """Insert/overwrite a keyframe and bind its features to map points."""
    MP = m.mp_pos.shape[0]
    if xy_r is None:
        xy_r = torch.full_like(xy, -1.0)
    m = m._replace(
        kf_xy_r=_set(m.kf_xy_r, slot, xy_r),
        kf_Rcw=_set(m.kf_Rcw, slot, Rcw),
        kf_tcw=_set(m.kf_tcw, slot, tcw),
        kf_valid=_set(m.kf_valid, slot, True),
        kf_frame_id=_set(m.kf_frame_id, slot, frame_id),
        kf_xy=_set(m.kf_xy, slot, xy),
        kf_level=_set(m.kf_level, slot, level),
        kf_angle=_set(m.kf_angle, slot, angle),
        kf_desc=_set(m.kf_desc, slot, desc),
        kf_feat_valid=_set(m.kf_feat_valid, slot, feat_valid),
        kf_mp=_set(m.kf_mp, slot, mp_bind),
        kf_uvr=_set(m.kf_uvr, slot, uvr),
    )
    bound = mp_bind >= 0
    mp_idx = mp_bind.clamp(min=0).long()
    row = torch.zeros(MP, dtype=torch.bool, device=bound.device)
    row[mp_idx[bound]] = True
    m = m._replace(
        obs_mat=_set(m.obs_mat, slot, row),
        mp_nobs=m.mp_nobs.index_add(0, mp_idx, bound.to(torch.int32)),
    )
    return refresh_parent(m, slot)


def refresh_parent(m: MapArrays, slot: int) -> MapArrays:
    """Recompute `slot`'s spanning-tree parent (strongest covisible keyframe,
    -1 when nothing is shared)."""
    w = covisibility_weights(m, slot)
    parent = torch.where(torch.amax(w) > 0, torch.argmax(w).to(torch.int32), -1)
    return m._replace(kf_parent=_set(m.kf_parent, slot, parent))


def covisibility_weights(m: MapArrays, slot: int) -> torch.Tensor:
    """(KF,) number of map points shared with keyframe `slot`: one float32
    product of the 0/1 observation matrix (exact: counts < 2^24)."""
    q = m.obs_mat[slot].to(torch.float32)
    w = m.obs_mat.to(torch.float32) @ q
    w = w * m.kf_valid
    return _set(w, slot, 0.0)


def local_map_mask(m: MapArrays, slot: int, n_neighbors: int = 10):
    """Map-point mask + KF mask of the covisibility-local map around `slot`
    (``Tracking::UpdateLocalKeyFrames/UpdateLocalPoints``)."""
    w = covisibility_weights(m, slot)
    top_w, top_i = topk_stable(w, n_neighbors)
    kf_mask = torch.zeros(m.kf_valid.shape[0], dtype=torch.bool, device=w.device)
    kf_mask[top_i] = top_w > 0
    kf_mask[slot] = True
    sel = m.obs_mat & kf_mask[:, None]
    mp_mask = torch.any(sel, dim=0) & m.mp_valid
    return mp_mask, kf_mask


def add_map_points(
    m: MapArrays,
    start_slot: int,
    pos: torch.Tensor,          # (n_new, 3) world positions
    desc: torch.Tensor,         # (n_new, 8)
    normal: torch.Tensor,       # (n_new, 3)
    dmin: torch.Tensor,
    dmax: torch.Tensor,
    ref_kf: int,
    accept: torch.Tensor,       # (n_new,) bool
    kf_a: int,
    feat_a: torch.Tensor,       # (n_new,) feature index in kf_a
    kf_b: int,
    feat_b: torch.Tensor,       # (n_new,) feature index in kf_b
) -> MapArrays:
    """Allocate `accept`-masked new map points at consecutive slots.

    Slot for entry i = start_slot + cumsum(accept)[i] (dense packing);
    rejected entries go to the scratch slot MP-1, which stays invalid.  Also
    binds the two observing features.  Only accepted entries are written,
    so every index written is unique.
    """
    MP = m.mp_pos.shape[0]
    offs = torch.cumsum(accept.to(torch.int32), dim=0) - 1
    slot = torch.where(accept, start_slot + offs, MP - 1).clamp(0, MP - 1)
    ok = accept & (slot < MP - 1)
    report_saturation(
        "map_point_capacity",
        torch.sum(accept.to(torch.int32)) - torch.sum(ok.to(torch.int32)),
    )
    s = slot[ok].long()

    def put(t, v, val=None):
        out = t.clone()
        out[s] = v[ok] if val is None else val
        return out

    m = m._replace(
        mp_pos=put(m.mp_pos, pos),
        mp_valid=put(m.mp_valid, None, True),
        mp_desc=put(m.mp_desc, desc),
        mp_normal=put(m.mp_normal, normal),
        mp_dmin=put(m.mp_dmin, dmin),
        mp_dmax=put(m.mp_dmax, dmax),
        mp_ref_kf=put(m.mp_ref_kf, None, ref_kf),
        mp_nobs=put(m.mp_nobs, None, 2),
        mp_visible=put(m.mp_visible, None, 1),
        mp_found=put(m.mp_found, None, 1),
    )
    kf_mp = m.kf_mp.clone()
    kf_mp[kf_a, feat_a[ok].long()] = slot[ok].to(torch.int32)
    kf_mp[kf_b, feat_b[ok].long()] = slot[ok].to(torch.int32)
    obs = m.obs_mat.clone()
    obs[kf_a, s] = True
    obs[kf_b, s] = True
    return m._replace(kf_mp=kf_mp, obs_mat=obs)
