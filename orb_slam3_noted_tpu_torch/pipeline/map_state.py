"""Fixed-capacity device-resident map state (port of :mod:`orb_slam3_noted_tpu.pipeline.map_state`).

The same structure-of-arrays ``MapArrays`` with the same field names and
shapes, so states compare field by field with the JAX package
(:func:`to_numpy` / :func:`from_numpy`).  Updates are functional: each
function returns a new ``MapArrays`` and leaves its argument untouched.
Descriptors are int32 tensors holding the JAX package's uint32 bits.

Integer segment sums are ``index_add_`` (exact in any order), float ones
sum each segment's rows in one fixed order (``ops/segsum.py``); where two
rows of a scatter can name the same target the write is resolved to the
last row (:func:`scatter_set_last`), so results do not change from run to
run on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.ops.fast import topk_stable
from orb_slam3_noted_tpu_torch.ops.segsum import segment_order, segment_sum
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
    if isinstance(value, torch.Tensor):
        out[idx] = value
    else:
        interop.set_scalar(out, idx, value)
    return out


def scatter_set_last(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Functional ``dst.at[idx].set(val)`` along dim 0 where ``idx`` may
    repeat: the last row naming a target wins, on every device (a scatter
    with repeated indices has no defined order on CUDA).  Losing rows write
    to a scratch row that is cut off."""
    n = dst.shape[0]
    idx = idx.long()
    rows = torch.arange(idx.shape[0], device=dst.device)
    last = torch.full((n,), -1, dtype=torch.long, device=dst.device)
    last.scatter_reduce_(0, idx, rows, reduce="amax")
    ext = torch.cat([dst, dst[:1]])
    ext[torch.where(last[idx] == rows, idx, n)] = val
    return ext[:n]


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
    interop.set_scalar(row, mp_idx[bound], True)
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


def covisibility_matrix(m: MapArrays) -> torch.Tensor:
    """(KF, KF) shared-map-point counts with a zero diagonal: one float32
    product of the 0/1 observation matrix (exact: counts < 2^24; a bf16
    product would round counts above 256)."""
    a = m.obs_mat.to(torch.float32)
    cv = a @ a.T
    cv = cv * (m.kf_valid[:, None] & m.kf_valid[None, :])
    return cv * (1.0 - torch.eye(cv.shape[0], dtype=cv.dtype, device=cv.device))


def local_map_mask(m: MapArrays, slot: int, n_neighbors: int = 10):
    """Map-point mask + KF mask of the covisibility-local map around `slot`
    (``Tracking::UpdateLocalKeyFrames/UpdateLocalPoints``)."""
    w = covisibility_weights(m, slot)
    top_w, top_i = topk_stable(w, n_neighbors)
    kf_mask = torch.zeros(m.kf_valid.shape[0], dtype=torch.bool, device=w.device)
    kf_mask[top_i] = top_w > 0
    interop.set_scalar(kf_mask, slot, True)
    sel = m.obs_mat & kf_mask[:, None]
    mp_mask = torch.any(sel, dim=0) & m.mp_valid
    return mp_mask, kf_mask


def add_map_points(
    m: MapArrays,
    start_slot,                 # int or 0-d int32 tensor: first free slot
    pos: torch.Tensor,          # (n_new, 3) world positions
    desc: torch.Tensor,         # (n_new, 8)
    normal: torch.Tensor,       # (n_new, 3)
    dmin: torch.Tensor,
    dmax: torch.Tensor,
    ref_kf: int,
    accept: torch.Tensor,       # (n_new,) bool
    kf_a: int,
    feat_a: torch.Tensor,       # (n_new,) feature index in kf_a
    kf_b,                       # int, or (n_new,) keyframe per entry
    feat_b: torch.Tensor,       # (n_new,) feature index in kf_b
) -> MapArrays:
    """Allocate `accept`-masked new map points at consecutive slots.

    Slot for entry i = start_slot + cumsum(accept)[i] (dense packing);
    rejected entries go to the scratch slot MP-1, which stays invalid.  Also
    binds the two observing features.
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
    # feature bindings, first keyframe a's then keyframe b's.  As in the JAX
    # package every row writes: an accepted row its slot, any other row the
    # value it found.  Where rows name the same feature the last row counts
    # (the order its scatter runs in), so a rejected row after an accepted
    # one restores the old binding.
    NF = m.kf_mp.shape[1]
    slot32 = slot.to(torch.int32)
    kf_mp = m.kf_mp.reshape(-1)
    for kf, feat in ((kf_a, feat_a), (kf_b, feat_b)):
        tgt = torch.as_tensor(kf, device=slot.device).long() * NF + feat.long()
        kf_mp = scatter_set_last(kf_mp, tgt, torch.where(ok, slot32, kf_mp[tgt]))
    kf_mp = kf_mp.reshape(m.kf_mp.shape)
    obs = m.obs_mat.clone()
    obs[kf_a, s] = True
    obs[kf_b[ok].long() if isinstance(kf_b, torch.Tensor) and kf_b.dim() else kf_b, s] = True
    return m._replace(kf_mp=kf_mp, obs_mat=obs)


def cull_map_points(m: MapArrays, current_kf: int) -> MapArrays:
    """Remove unreliable recent map points (``LocalMapping::MapPointCulling``):
    found/visible ratio below 0.25, or 2+ keyframes old and still observed by
    fewer than 3 keyframes.  Only points up to 3 keyframes old are audited."""
    ratio_bad = m.mp_found.to(torch.float32) < 0.25 * m.mp_visible.to(torch.float32)
    age = current_kf - m.mp_ref_kf
    recent = age <= 3
    weak = (age >= 2) & (m.mp_nobs < 3)
    keep = m.mp_valid & ~(recent & (ratio_bad | weak))
    # unbind culled points everywhere
    kf_mp = torch.where(keep[m.kf_mp.clamp(min=0).long()] & (m.kf_mp >= 0), m.kf_mp, -1)
    return m._replace(mp_valid=keep, kf_mp=kf_mp, obs_mat=m.obs_mat & keep[None, :])


def update_point_stats(
    m: MapArrays, mp_sel: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2,
) -> MapArrays:
    """Re-elect distinctive descriptors and refresh normals and scale ranges
    of the points in ``mp_sel`` (``ComputeDistinctiveDescriptors`` and
    ``UpdateNormalAndDepth``).

    The descriptor is the observation minimising the summed Hamming distance
    to the point's other observations, from per-point bit counts:
    ``sum_o' ham(a, b_o') = sum(c) + sum_j a_j (n - 2 c_j)``; ties go to the
    lowest observation row.  Points with fewer than 3 observations keep
    their descriptor.  All counts are small integers in float32, so the
    election does not depend on summation order.
    """
    KF, NF = m.kf_xy.shape[0], m.kf_xy.shape[1]
    MP = m.mp_pos.shape[0]
    dev = m.mp_pos.device
    k_idx = torch.arange(KF, device=dev).repeat_interleave(NF)
    mp = m.kf_mp.reshape(-1)
    mp_c = mp.clamp(min=0).long()
    row_ok = (mp >= 0) & m.kf_valid[k_idx] & m.kf_feat_valid.reshape(-1)
    row_ok = row_ok & mp_sel[mp_c] & m.mp_valid[mp_c]
    seg = torch.where(row_ok, mp_c, MP)  # invalid rows -> scratch segment
    okf = row_ok.to(torch.float32)

    # one 32-bit word at a time keeps the transient at (KF*NF, 32)
    desc = m.kf_desc.reshape(KF * NF, 8)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)

    def word_bits(w):
        return ((desc[:, w, None] >> shifts) & 1).to(torch.float32)

    order = segment_order(seg, MP + 1, row_ok)
    n_obs = segment_sum(okf, seg, MP + 1, order)[:MP]
    c_words = [segment_sum(word_bits(w) * okf[:, None], seg, MP + 1, order)[:MP]
               for w in range(8)]
    sc = sum(torch.sum(cw, dim=1) for cw in c_words)[mp_c]
    for w in range(8):
        sc = sc + torch.sum(word_bits(w) * (n_obs[mp_c, None] - 2.0 * c_words[w][mp_c]), dim=1)
    inf = torch.tensor(float("inf"), device=dev)
    sc = torch.where(row_ok, sc, inf)
    best = torch.full((MP + 1,), float("inf"), device=dev).scatter_reduce_(
        0, seg, sc, reduce="amin")[:MP]
    is_best = row_ok & (sc == best[mp_c])
    big = 1 << 30
    rows = torch.arange(KF * NF, dtype=torch.int32, device=dev)
    first = torch.full((MP + 1,), big, dtype=torch.int32, device=dev).scatter_reduce_(
        0, seg, torch.where(is_best, rows, big), reduce="amin")[:MP]
    has = (first < big) & (n_obs >= 3)
    new_desc = desc[first.clamp(0, KF * NF - 1).long()]
    mp_desc = torch.where(has[:, None], new_desc, m.mp_desc)

    # normal: mean unit vector from each observing keyframe centre
    centers = -torch.einsum("kji,kj->ki", m.kf_Rcw, m.kf_tcw)  # (KF, 3)
    vec = m.mp_pos[mp_c] - centers[k_idx]
    vn = vec / torch.clamp(torch.linalg.vector_norm(vec, dim=-1, keepdim=True), min=1e-9)
    nsum = segment_sum(vn * okf[:, None], seg, MP + 1, order)[:MP]
    nrm = torch.linalg.vector_norm(nsum, dim=-1, keepdim=True)
    mp_normal = torch.where(has[:, None] & (nrm > 1e-9),
                            nsum / torch.clamp(nrm, min=1e-9), m.mp_normal)

    # scale-invariance range from the reference keyframe's distance and the
    # octave it observed the point at; untouched when it no longer does
    ref = m.mp_ref_kf.long()
    d_ref = torch.linalg.vector_norm(m.mp_pos - centers[ref], dim=-1)
    is_ref_row = row_ok & (k_idx == ref[mp_c])
    zeros = torch.zeros(MP + 1, dtype=torch.int32, device=dev)
    lvl = zeros.scatter_reduce(
        0, seg, torch.where(is_ref_row, m.kf_level.reshape(-1), 0), reduce="amax")[:MP]
    ref_seen = zeros.scatter_reduce(0, seg, is_ref_row.to(torch.int32), reduce="amax")[:MP] > 0
    sf = scale_factor ** torch.arange(n_levels, dtype=m.mp_pos.dtype, device=dev)
    dmax = d_ref * sf[lvl.clamp(0, n_levels - 1).long()]
    dmin = dmax / sf[n_levels - 1]
    upd = has & m.mp_valid & (d_ref > 1e-6) & ref_seen
    return m._replace(
        mp_desc=mp_desc,
        mp_normal=mp_normal,
        mp_dmin=torch.where(upd, dmin, m.mp_dmin),
        mp_dmax=torch.where(upd, dmax, m.mp_dmax),
    )


def cull_keyframes(m: MapArrays, window_mask: torch.Tensor, protect: torch.Tensor,
                   ratio: float = 0.9) -> MapArrays:
    """Mark redundant keyframes invalid (``KeyFrameCulling``: at least
    ``ratio`` of a keyframe's points seen by 3 or more other keyframes).

    ``window_mask`` (KF,): candidates; ``protect`` (KF,): never culled.  All
    individually redundant keyframes are re-checked against their joint
    observation loss; when that rejects every one, the single most redundant
    candidate goes.  Points whose reference keyframe went re-home to their
    first surviving observer, children of a culled keyframe re-parent to its
    parent."""
    MP = m.mp_pos.shape[0]
    bound = (m.kf_mp >= 0) & m.kf_feat_valid
    mp_idx = m.kf_mp.clamp(min=0).long()
    n_bound = torch.sum(bound, dim=1).to(torch.int32)
    seg = torch.where(bound, mp_idx, MP - 1).reshape(-1)

    def redundancy(nobs):
        well_observed = nobs[mp_idx] >= 4  # the point survives without this KF
        n_red = torch.sum(bound & well_observed, dim=1).to(torch.int32)
        red_ratio = n_red / torch.clamp(n_bound, min=1)
        return (m.kf_valid & window_mask & ~protect & (n_bound > 20)
                & (n_red >= ratio * n_bound)), red_ratio

    def lost(which):
        return segment_sum((bound & which[:, None]).reshape(-1).to(torch.int32), seg, MP)

    cand, red = redundancy(m.mp_nobs)
    cull_joint, _ = redundancy(m.mp_nobs - lost(cand))
    cull = cand & cull_joint
    best = torch.argmax(torch.where(cand, red, -1.0))
    fallback = torch.zeros_like(cand)
    interop.set_scalar(fallback, best, True)
    cull = torch.where(torch.any(cull), cull, fallback & cand)
    keep = ~cull
    kf_valid = m.kf_valid & keep
    obs_mat = m.obs_mat & keep[:, None]
    ref_dead = ~kf_valid[m.mp_ref_kf.long()]
    new_ref = torch.argmax(obs_mat.to(torch.uint8), dim=0).to(torch.int32)  # first observer
    mp_ref_kf = torch.where(ref_dead & torch.any(obs_mat, dim=0), new_ref, m.mp_ref_kf)
    # pointer-jump a few rounds so a chain of culled ancestors collapses;
    # a fully culled ancestry becomes a root
    kf_parent = m.kf_parent
    for _ in range(4):
        p_idx = kf_parent.clamp(min=0).long()
        parent_dead = (kf_parent >= 0) & ~kf_valid[p_idx]
        kf_parent = torch.where(parent_dead, kf_parent[p_idx], kf_parent)
    p_idx = kf_parent.clamp(min=0).long()
    kf_parent = torch.where((kf_parent >= 0) & ~kf_valid[p_idx], -1, kf_parent)
    return m._replace(
        kf_valid=kf_valid,
        mp_nobs=m.mp_nobs - lost(cull),
        obs_mat=obs_mat,
        kf_mp=torch.where(cull[:, None], -1, m.kf_mp),
        mp_ref_kf=mp_ref_kf,
        kf_parent=kf_parent,
    )


def compact_map_points(m: MapArrays):
    """Compact valid map points to the front and free the culled slots.

    Returns ``(m, n_valid, inv)``: ``n_valid`` a 0-d int32 tensor, ``inv``
    mapping old point index -> new point index, -1 for culled slots.  Point
    bindings computed before the compaction must pass through ``inv``
    (:func:`remap_point_bindings`) before they touch the compacted map."""
    MP = m.mp_pos.shape[0]
    iota = torch.arange(MP, dtype=torch.int32, device=m.mp_pos.device)
    order_key = torch.where(m.mp_valid, iota, iota + MP)  # valid first, in order
    perm = torch.sort(order_key, stable=True).indices     # new pos -> old idx
    inv = torch.zeros(MP, dtype=torch.int32, device=iota.device)
    inv[perm] = iota                                      # old idx -> new pos
    inv_safe = torch.where(m.mp_valid, inv, -1)
    mp_c = m.kf_mp.clamp(min=0).long()
    bound_valid = (m.kf_mp >= 0) & m.mp_valid[mp_c]
    m = m._replace(
        **{f: getattr(m, f)[perm] for f in (
            "mp_pos", "mp_valid", "mp_desc", "mp_normal", "mp_dmin", "mp_dmax",
            "mp_ref_kf", "mp_nobs", "mp_visible", "mp_found")},
        obs_mat=m.obs_mat[:, perm],
        kf_mp=torch.where(bound_valid, inv[mp_c], -1),
    )
    return m, torch.sum(m.mp_valid.to(torch.int32)), inv_safe


def remap_point_bindings(mp_of_feat: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Translate point bindings through a compaction remap (-1 stays -1)."""
    return torch.where(mp_of_feat >= 0, inv[mp_of_feat.clamp(min=0).long()], -1)


def compose_point_remaps(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Compose two compaction remaps: oldest index -> newest index."""
    return remap_point_bindings(first, second)


def apply_ba_result(
    m: MapArrays,
    kf_slots: torch.Tensor,   # (K,) slots that were optimised
    kf_mask: torch.Tensor,    # (K,) bool which entries are real
    Rcw: torch.Tensor,        # (K, 3, 3)
    tcw: torch.Tensor,
    mp_slots: torch.Tensor,   # (M,)
    mp_mask: torch.Tensor,    # (M,) bool
    pos: torch.Tensor,        # (M, 3)
) -> MapArrays:
    """Write optimised poses and points back into the map: a scatter-add of
    the masked delta, not a set, so padded entries add exactly zero and a
    repeated padded slot can never overwrite a real update."""
    ks, ms = kf_slots.long(), mp_slots.long()
    dR = torch.where(kf_mask[:, None, None], Rcw - m.kf_Rcw[ks], 0.0)
    dt = torch.where(kf_mask[:, None], tcw - m.kf_tcw[ks], 0.0)
    dp = torch.where(mp_mask[:, None], pos - m.mp_pos[ms], 0.0)
    return m._replace(
        kf_Rcw=m.kf_Rcw.index_add(0, ks, dR),
        kf_tcw=m.kf_tcw.index_add(0, ks, dt),
        mp_pos=m.mp_pos.index_add(0, ms, dp),
    )
