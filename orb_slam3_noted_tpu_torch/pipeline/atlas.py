"""Atlas: multi-map management with merge on revisit (port of
:mod:`orb_slam3_noted_tpu.pipeline.atlas`).

The reference's ``Atlas`` with the multi-map halves of Tracking and
LoopClosing:

- On unrecoverable tracking loss the active map is stored and a fresh one
  started (``Tracking::CreateMapInAtlas``); a just-born map (fewer than
  ``MIN_KFS_TO_STORE`` keyframes) is dropped instead (``ResetActiveMap``).
- Every new keyframe queries the stored maps' keyframe databases; a BoW hit
  verified by Sim(3) RANSAC triggers a merge (``LoopClosing::MergeLocal``):
  the active map is transformed by the relative Sim(3) into the stored map's
  frame, its keyframes and points are copied in behind the stored map's,
  the two spanning trees are welded at the matched keyframe, a welding BA
  runs around the junction and an essential-graph optimisation pulls the
  remainder along.

All maps share one vocabulary.  The merge runs on the map's device: slices
of the fixed-capacity arrays and one Sim(3) transform, no host round trip
of the map.  The RANSAC minimal sets of a merge come from
:meth:`AtlasSLAM._merge_sets` (a ``torch.Generator`` seeded with the
keyframe's slot, as the JAX package seeds its key); tests hand in the JAX
package's draws there.

Where the JAX package is at fault the port keeps the documented behaviour
(ROADMAP Queue 3): a merge shifts the active system's host slot mirrors
(recycled slots, culled slots, keyframe frame ids), the standalone
relocalisation database's rows and the trajectory's keyframe-relative
records by the slot offset, as it shifts the map, and drops a loop
detection queued against the incoming map's numbering.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.geometry import sim3
from orb_slam3_noted_tpu_torch.geometry import twoview as TV
from orb_slam3_noted_tpu_torch.geometry.sim3_solver import N_HYP, sim3_ransac
from orb_slam3_noted_tpu_torch.ops import matching as M
from orb_slam3_noted_tpu_torch.optim.pose_graph import Sim3Edges, optimize_pose_graph_sim3
from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
from orb_slam3_noted_tpu_torch.pipeline import tracking as T
from orb_slam3_noted_tpu_torch.pipeline.loop_closing import LoopCloser, _apply_correction
from orb_slam3_noted_tpu_torch.pipeline.system import NOT_INITIALIZED, OK, MonoSLAM, _np
from orb_slam3_noted_tpu_torch.place.database import KeyFrameDatabase
from orb_slam3_noted_tpu_torch.place.vocab import train_vocabulary
from orb_slam3_noted_tpu_torch.utils.interop import pull

@dataclass
class StoredMap:
    m: MS.MapArrays      # the map's arrays, on the device
    n_kf: int
    n_mp: int
    db: KeyFrameDatabase
    trajectory: list
    inertial: dict | None = None   # the inertial chain's state (InertialAtlasSLAM)


def _cross_map_pairs(m_new: MS.MapArrays, slot_new: int, m_old: MS.MapArrays, slot_old: int):
    """3D-3D pairs between a keyframe of each map, in the two keyframes'
    camera frames: mutual best descriptor matches under ``TH_LOW`` between
    bound, valid features whose points are valid.  Returns (x_old, x_new,
    ok), each of length NF."""
    d = M.hamming_matrix(m_new.kf_desc[slot_new], m_old.kf_desc[slot_old])
    gate = ((m_new.kf_mp[slot_new] >= 0) & m_new.kf_feat_valid[slot_new])[:, None] & (
        (m_old.kf_mp[slot_old] >= 0) & m_old.kf_feat_valid[slot_old])[None, :]
    masked = torch.where(gate, d, M.BIG)
    best = torch.amin(masked, dim=1)
    idx = torch.argmin(masked, dim=1)
    best_back = torch.argmin(masked, dim=0)
    ok = (best <= M.TH_LOW) & (best_back[idx] == torch.arange(d.shape[0], device=d.device))
    mp_new = m_new.kf_mp[slot_new].clamp(min=0).long()
    mp_old = m_old.kf_mp[slot_old][idx].clamp(min=0).long()
    x_new = m_new.mp_pos[mp_new] @ m_new.kf_Rcw[slot_new].T + m_new.kf_tcw[slot_new]
    x_old = m_old.mp_pos[mp_old] @ m_old.kf_Rcw[slot_old].T + m_old.kf_tcw[slot_old]
    ok = ok & m_new.mp_valid[mp_new] & m_old.mp_valid[mp_old]
    return x_old, x_new, ok


def merge_map_arrays(old: StoredMap, new_m: MS.MapArrays, n_kf_new: int, n_mp_new: int, S_wold_wnew):
    """Copy the new map's keyframes and points into the old map, behind its
    own, transformed by ``S_wold_wnew = (R, t, s)``: x_old = s R x_new + t.

    Returns (merged MapArrays, kf_off, n_kf, n_mp), or None when the two do
    not fit in the capacity.  Everything stays on the map's device."""
    mo = old.m
    KF, MP = mo.kf_xy.shape[0], mo.mp_pos.shape[0]
    if old.n_kf + n_kf_new > KF or old.n_mp + n_mp_new > MP:
        return None
    R, t, s = S_wold_wnew
    kf_off, mp_off = old.n_kf, old.n_mp
    out = {k: v.clone() for k, v in mo._asdict().items()}
    mn = new_m

    # map points: x_old = s R x_new + t
    sl_mp = slice(mp_off, mp_off + n_mp_new)
    out["mp_pos"][sl_mp] = (s * mn.mp_pos[:n_mp_new]) @ R.T + t
    out["mp_normal"][sl_mp] = mn.mp_normal[:n_mp_new] @ R.T
    out["mp_dmin"][sl_mp] = s * mn.mp_dmin[:n_mp_new]
    out["mp_dmax"][sl_mp] = s * mn.mp_dmax[:n_mp_new]
    out["mp_ref_kf"][sl_mp] = mn.mp_ref_kf[:n_mp_new] + kf_off
    for k in ("mp_valid", "mp_desc", "mp_nobs", "mp_visible", "mp_found"):
        out[k][sl_mp] = getattr(mn, k)[:n_mp_new]

    # keyframes: Tc_wold = Tc_wnew o S^-1, stored as the SE(3) [R' | t' / s']
    sl_kf = slice(kf_off, kf_off + n_kf_new)
    R2 = mn.kf_Rcw[:n_kf_new] @ R.T
    s2 = 1.0 / s
    t2 = mn.kf_tcw[:n_kf_new] - s2 * (R2 @ t)
    out["kf_Rcw"][sl_kf] = R2
    out["kf_tcw"][sl_kf] = t2 / s2
    for k in ("kf_valid", "kf_frame_id", "kf_xy", "kf_level", "kf_angle", "kf_desc",
              "kf_feat_valid", "kf_uvr", "kf_xy_r"):
        out[k][sl_kf] = getattr(mn, k)[:n_kf_new]
    bind = mn.kf_mp[:n_kf_new]
    out["kf_mp"][sl_kf] = torch.where(bind >= 0, bind + mp_off, -1)
    # spanning tree: the incoming map's parents shift by the slot offset;
    # its roots keep -1 (the caller welds them onto the old map's tree)
    par = mn.kf_parent[:n_kf_new]
    out["kf_parent"][sl_kf] = torch.where(par >= 0, par + kf_off, -1)
    out["obs_mat"][sl_kf] = False
    out["obs_mat"][sl_kf, sl_mp] = mn.obs_mat[:n_kf_new, :n_mp_new]
    return MS.MapArrays(**out), kf_off, old.n_kf + n_kf_new, old.n_mp + n_mp_new


def _shift_host_mirrors(a, kf_off: int, n_kf_new: int, s: float):
    """After a merge: move the active system's slot-indexed host state (its
    recycled and culled slots, the keyframe frame-id mirror, the standalone
    relocalisation database's rows and the trajectory's keyframe-relative
    records) from the incoming map's slots to the merged ones."""
    a.free_kf_slots = [kf_off + int(v) for v in a.free_kf_slots]
    a._dead_slots = {kf_off + int(v) for v in a._dead_slots}
    fids = np.full_like(a.kf_frame_ids, -1)
    fids[:kf_off] = _np(a.m.kf_frame_id[:kf_off])
    fids[kf_off:kf_off + n_kf_new] = a.kf_frame_ids[:n_kf_new]
    a.kf_frame_ids = fids
    db = a.reloc_db
    if db is not None:
        occ = np.flatnonzero(db.present[:n_kf_new])
        rows = db.bow_mat[torch.from_numpy(occ).to(db.device)]
        for slot in np.flatnonzero(db.present):
            db.erase(int(slot))
        for k, slot in enumerate(occ):
            db.add(kf_off + int(slot), rows[k])
    # a record made in the incoming map is relative to one of its keyframes
    # (the switch baked every earlier one); the keyframe's merged pose is
    # its camera scaled by s, so the relative translation scales with it
    for rec in a.trajectory:
        if rec.ref_slot >= 0 and rec.rel_R is not None:
            rec.ref_slot += kf_off
            rec.rel_t = (s * rec.rel_t).astype(rec.rel_t.dtype)


class AtlasSLAM:
    """Multi-map wrapper around a (monocular, stereo or RGB-D) SLAM system
    whose state lives on ``device`` (the card unless the caller names
    another)."""

    MIN_KFS_TO_STORE = 6     # smaller maps are dropped on loss (reference ~10)
    LOST_PATIENCE = 8        # lost frames before the map switch
    MERGE_MIN_INLIERS = 25

    def __init__(self, cfg, base_cls=MonoSLAM, fix_scale=False, device=None):
        self.cfg = cfg
        self.base_cls = base_cls
        self.fix_scale = fix_scale
        self.device = torch.device("cuda" if device is None else device)
        self.active = base_cls(cfg, device=self.device)
        self.stored: list[StoredMap] = []
        self.vocab = None
        self.lost_streak = 0
        self.maps_created = 1
        self.merges = 0
        self._last_nkf = 0

    # ------------------------------------------------------------------
    def process(self, *args, **kw):
        rec = self.active.process(*args, **kw)
        if rec is None:
            return rec
        if rec.state == OK:
            self.lost_streak = 0
        elif rec.state != NOT_INITIALIZED:
            self.lost_streak += 1
            if self.lost_streak > self.LOST_PATIENCE:
                self._switch_map()
                return rec
        if self.active.n_kf != self._last_nkf and self.active.n_kf > 0:
            self._last_nkf = self.active.n_kf
            self._try_merge()
        return rec

    # ------------------------------------------------------------------
    def _ensure_vocab(self) -> bool:
        """The Atlas-wide vocabulary: the loop closer's, else one trained on
        the active map's keyframe descriptors (False while too few)."""
        if self.vocab is not None:
            return True
        lc = self.active.loop_closer
        if lc is not None:
            self.vocab = _np(lc.db.vocab).view(np.uint32)
            return True
        a = self.active
        kv = _np(a.m.kf_feat_valid[: a.n_kf])
        if kv.sum() < 64:
            return False
        desc = _np(a.m.kf_desc[: a.n_kf])[kv].view(np.uint32)
        self.vocab = train_vocabulary(
            desc, n_words=min(self.cfg.vocab_words, max(len(desc) // 2, 16)), n_iters=6,
            device=self.device)
        return True

    # ------------------------------------------------------------------
    def _switch_map(self):
        """Store (or drop) the active map and start a fresh one."""
        a = self.active
        self._bake_trajectory(a)  # its relative records anchor to THIS map
        if a.n_kf >= self.MIN_KFS_TO_STORE and self._ensure_vocab():
            db = KeyFrameDatabase(self.vocab, self.cfg.max_keyframes, device=self.device)
            m = a.m
            for slot in np.flatnonzero(_np(m.kf_valid[: a.n_kf])):
                _, bow = db.compute_bow(m.kf_desc[slot], m.kf_feat_valid[slot])
                db.add(int(slot), bow)
            self.stored.append(StoredMap(m=m, n_kf=a.n_kf, n_mp=a.n_mp, db=db,
                                         trajectory=list(a.trajectory)))
        fresh = self.base_cls(self.cfg, device=self.device)
        fresh.trajectory = a.trajectory  # one global trajectory log
        self.active = fresh
        self.lost_streak = 0
        self._last_nkf = 0
        self.maps_created += 1

    # ------------------------------------------------------------------
    def _merge_sets(self, valid: torch.Tensor, slot: int) -> torch.Tensor:
        """(N_HYP, 3) RANSAC minimal sets of distinct valid pairs for a merge
        attempt from keyframe ``slot``, from a generator on the device
        seeded with the slot."""
        g = torch.Generator(device=valid.device)
        g.manual_seed(int(slot))
        return TV.sample_minimal_sets(valid, N_HYP, g, size=3)

    def _try_merge(self) -> bool:
        """Query the stored maps with the newest keyframe; merge on a
        verified hit."""
        if not self.stored or not self._ensure_vocab():
            return False
        a = self.active
        slot = a.last_kf_slot
        m = a.m
        for si, st in enumerate(self.stored):
            _, bow = st.db.compute_bow(m.kf_desc[slot], m.kf_feat_valid[slot])
            slots, _ = st.db.detect_candidates(bow, np.zeros(self.cfg.max_keyframes, bool),
                                               n_best=3, min_rel_score=0.5)
            for cand in slots:
                x_old, x_new, ok = _cross_map_pairs(m, slot, st.m, cand)
                if int(ok.sum()) < self.MERGE_MIN_INLIERS:
                    continue
                res = sim3_ransac(x_old, x_new, ok, self._merge_sets(ok, slot),
                                  fix_scale=self.fix_scale)
                success, n_in = pull(res.success, res.n_inliers)
                if not bool(success) or int(n_in) < self.MERGE_MIN_INLIERS:
                    continue
                if self._do_merge(st, si, slot, cand, res):
                    return True
        return False

    # ------------------------------------------------------------------
    def _merge_transform(self, st: StoredMap, slot: int, cand: int, res):
        """S_wold_wnew = T_cand_w^-1 o S_nc^-1 o T_cur_w, where the RANSAC's
        S_nc maps the candidate keyframe's (old map) camera frame into the
        current keyframe's (new map): x_cur = S_nc(x_cand)."""
        m = self.active.m
        one = torch.ones((), dtype=m.kf_tcw.dtype, device=m.kf_tcw.device)
        T_cur_w = (m.kf_Rcw[slot], m.kf_tcw[slot], one)
        T_cand_w = (st.m.kf_Rcw[cand], st.m.kf_tcw[cand], one)
        return sim3.compose(sim3.inverse(T_cand_w),
                            sim3.compose(sim3.inverse((res.R, res.t, res.s)), T_cur_w))

    def _do_merge(self, st: StoredMap, si: int, slot: int, cand: int, res) -> bool:
        """Weld the active map into stored map ``st`` and make it active."""
        a = self.active
        S = self._merge_transform(st, slot, cand, res)
        n_kf_new = a.n_kf
        out = merge_map_arrays(st, a.m, n_kf_new, a.n_mp, S)
        if out is None:
            return False
        merged, kf_off, n_kf, n_mp = out
        # weld the spanning trees: the incoming map's roots hang off the
        # matched old-map keyframe (the junction becomes a tree edge)
        sl = slice(kf_off, n_kf)
        par = merged.kf_parent[sl]
        roots = (par == -1) & merged.kf_valid[sl]
        merged.kf_parent[sl] = torch.where(roots, cand, par)
        # rebuild the active system on the merged map
        a.m = merged
        a.n_kf, a.n_mp = n_kf, n_mp
        a.last_kf_slot = kf_off + slot
        a.last_Rcw = merged.kf_Rcw[kf_off + slot]
        a.last_tcw = merged.kf_tcw[kf_off + slot]
        a.vel = None
        a._mp_remap = None
        _shift_host_mirrors(a, kf_off, n_kf_new, float(S[2]))
        # a detection queued in this frame names the incoming map's slots
        # and ran against its own database: it has no meaning in the merge
        a._pending_loops = []
        # the remainder's pose graph measures its edges on the pre-weld map
        m_pre = a.m
        # welding BA around the junction (reference MergeLocal's window)
        a.m = T.local_ba(a.m, kf_off + slot, a.cam, self.cfg, window=self.cfg.local_window,
                         bf=self.cfg.bf)
        self._remainder_pose_graph(a, m_pre, kf_off + slot)
        # the merged system keeps both maps' BoW rows (the reference's
        # database spans the whole Atlas)
        a.loop_closer = self._merged_loop_closer(a, st, kf_off, a.n_kf - kf_off)
        del self.stored[si]
        self.merges += 1
        self._last_nkf = a.n_kf
        return True

    # ------------------------------------------------------------------
    def _remainder_pose_graph(self, a, m_pre, weld_slot: int):
        """Essential-graph optimisation over the non-welding remainder: the
        welding window is fixed at its BA-refined poses, spanning-tree and
        covisibility (>= 20) edges measured on the pre-weld map pull the rest
        along."""
        m = a.m
        kf_valid = _np(m.kf_valid)
        if kf_valid.sum() < 3:
            return
        parent, covis = (_np(x) for x in (m.kf_parent, MS.covisibility_matrix(m)))
        child = np.flatnonzero((parent >= 0) & kf_valid & kf_valid[np.maximum(parent, 0)])
        ii, jj = np.nonzero(np.triu(covis) >= 20)
        keep = kf_valid[ii] & kf_valid[jj]
        ei = np.concatenate([child, ii[keep]]).astype(np.int64)
        ej = np.concatenate([parent[child], jj[keep]]).astype(np.int64)
        if not len(ei):
            return
        dev, dtype = m.kf_tcw.device, m.kf_tcw.dtype
        i_arr = torch.from_numpy(ei).to(dev)
        j_arr = torch.from_numpy(ej).to(dev)
        KF = m.kf_Rcw.shape[0]
        s_all = torch.ones(KF, dtype=dtype, device=dev)
        # measurements S_j S_i^-1 from the pre-weld snapshot, one batched compose
        Si = (m_pre.kf_Rcw[i_arr], m_pre.kf_tcw[i_arr], s_all[i_arr])
        Sj = (m_pre.kf_Rcw[j_arr], m_pre.kf_tcw[j_arr], s_all[j_arr])
        Rr, tr, sr = sim3.compose(Sj, sim3.inverse(Si))
        E = len(ei)
        edges = Sim3Edges(i=i_arr.to(torch.int32), j=j_arr.to(torch.int32), R=Rr, t=tr, s=sr,
                          weight=torch.ones(E, dtype=torch.float32, device=dev),
                          valid=torch.ones(E, dtype=torch.bool, device=dev))
        _, weld_mask = MS.local_map_mask(m, weld_slot, n_neighbors=self.cfg.local_window)
        fixed = ~m.kf_valid | weld_mask
        R_new, t_new, s_new, _ = optimize_pose_graph_sim3(m.kf_Rcw, m.kf_tcw, s_all, edges, fixed)
        a.m = _apply_correction(m, R_new, t_new, s_new)

    # ------------------------------------------------------------------
    def _merged_loop_closer(self, a, st: StoredMap, kf_off: int, n_kf_new: int):
        """A loop closer over both maps' BoW rows: the stored map's at their
        slots, the active map's shifted by ``kf_off`` (both built on the
        Atlas-wide vocabulary)."""
        lc_old = a.loop_closer
        if lc_old is None and st.db is None:
            return None
        idf = st.db.idf
        lc = LoopCloser(_np(st.db.vocab).view(np.uint32), self.cfg.max_keyframes,
                        enable_gba=getattr(lc_old, "enable_gba", True),
                        idf=_np(idf) if idf is not None else None, device=st.db.device)
        lc.db.bow_mat = st.db.bow_mat.clone()
        lc.db.present = st.db.present.copy()
        if lc_old is not None and lc_old.db.vocab.shape == st.db.vocab.shape:
            occ = np.flatnonzero(lc_old.db.present)
            occ = occ[occ < n_kf_new]
            if len(occ):
                src = torch.from_numpy(occ).to(lc.device)
                lc.db.bow_mat[src + kf_off] = lc_old.db.bow_mat[src]
                lc.db.present[occ + kf_off] = True
        lc.db.present_dev = torch.from_numpy(lc.db.present).to(lc.device)
        return lc

    # ------------------------------------------------------------------
    @property
    def trajectory(self):
        return self.active.trajectory

    @property
    def n_maps(self) -> int:
        return 1 + len(self.stored)

    # delegation: a caller treats an Atlas as one system
    @property
    def n_kf(self):
        return self.active.n_kf

    @property
    def n_mp(self):
        return self.active.n_mp

    @property
    def m(self):
        return self.active.m

    def flush(self):
        if hasattr(self.active, "flush"):
            self.active.flush()
        return self

    def positions(self):
        return self.active.positions()

    def final_poses(self):
        return self.active.final_poses()

    @staticmethod
    def _bake_trajectory(a):
        """Turn keyframe-relative records into absolute ones before the map
        that anchors them is stored (their slots belong to THAT map): the
        spanning-tree recovery of ``SaveTrajectoryTUM`` done eagerly."""
        kfR, kft = _np(a.m.kf_Rcw), _np(a.m.kf_tcw)
        for rec in a.trajectory:
            if rec.ref_slot >= 0 and rec.rel_R is not None:
                Rr, tr = kfR[rec.ref_slot], kft[rec.ref_slot]
                rec.Rcw = rec.rel_R @ Rr
                rec.tcw = rec.rel_R @ tr + rec.rel_t
                rec.ref_slot = -1
                rec.rel_R = rec.rel_t = None

    def on_sequence_end(self):
        """Multi-session boundary (the reference's multi-session protocol,
        ``Examples/euroc_examples.sh:15``): store the active map; the next
        sequence starts a fresh one and merges back on revisit."""
        self._bake_trajectory(self.active)
        self._switch_map()
