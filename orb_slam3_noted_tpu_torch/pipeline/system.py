"""SLAM system facades (port of :mod:`orb_slam3_noted_tpu.pipeline.system`).

``StereoSLAM`` and ``RGBDSLAM`` run frame by frame as full SLAM with loop
closing off: single-frame initialisation from stereo depth, then per frame
ORB extraction (both images for stereo, matched by
:func:`..ops.stereo.match_stereo`), local-map projection matching and
motion-only pose optimisation, the OK / RECENTLY_LOST / LOST state machine,
the relative-pose trajectory records, and at every keyframe decision the
synchronous mapper (:func:`..tracking.insert_keyframe_step`) with slot
recycling and map-point compaction.  ``set_localization_mode(True)`` freezes
the map.

What is not ported raises ``NotImplementedError`` naming its step in
ROADMAP.md (next steps): monocular initialisation and batch mode (1),
relocalisation and loop closing (2).  Without a relocalisation database a
lost frame stays lost until projection matching recovers.

All state lives on the constructor's ``device`` (the CUDA device unless the
caller names another); the host holds the scalar counters, the trajectory
records (numpy) and the state machine.  The map-point allocation pointer
``n_mp`` is a plain int, read back once per keyframe.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.geometry import se3
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.ops import image as I
from orb_slam3_noted_tpu_torch.ops import orb as O
from orb_slam3_noted_tpu_torch.ops.stereo import match_stereo
from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
from orb_slam3_noted_tpu_torch.pipeline import tracking as T

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
RECENTLY_LOST = "RECENTLY_LOST"
LOST = "LOST"


def _todo(what: str, step: int):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, next steps {step})")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class FrameRecord:
    frame_id: int
    Rcw: np.ndarray
    tcw: np.ndarray
    state: str
    n_inliers: int
    # pose relative to the reference keyframe at track time (reference
    # ``mlRelativeFramePoses``); exported poses compose it with the
    # keyframe's current pose
    ref_slot: int = -1
    rel_R: np.ndarray | None = None
    rel_t: np.ndarray | None = None


class MonoSLAM:
    """Base facade: map, state machine and trajectory on one device."""

    def __init__(self, cfg: SlamConfig, device=None):
        if cfg.enable_loop_closing:
            raise _todo("loop closing", 2)
        self.cfg = cfg
        self.cam = cfg.camera
        # the card unless the caller names another device; no fallback
        self.device = torch.device("cuda" if device is None else device)
        self.kf_inserted = 0  # total keyframe insertions (incl. recycled slots)
        self.trajectory: list[FrameRecord] = []
        # RECENTLY_LOST holds for ~2 s before the state degrades to LOST
        self.lost_patience = max(int(2.0 * cfg.fps), 4)
        # track against the frozen map, never insert keyframes
        self.localization_only = False
        self.reset()

    def reset(self):
        """Full reset (reference ``System::Reset``): drop map and state; the
        trajectory records stay."""
        cfg = self.cfg
        self.m = MS.empty_map(cfg, device=self.device)
        self.n_kf = 0
        self.n_mp = 0  # map-point allocation pointer
        # composed old->new point-index map of every compaction since the
        # last track call; bindings from that call pass through it before
        # they touch the map
        self._mp_remap = None
        # host mirror of keyframe frame ids (-1 = empty slot)
        self.kf_frame_ids = np.full(cfg.max_keyframes, -1, np.int64)
        # recycled keyframe slots, refilled from kf_valid when the monotone
        # allocator is exhausted
        self.free_kf_slots: list[int] = []
        self._dead_slots: set[int] = set()  # culled slots already fixed up
        self._refill_cooldown = 0
        self.state = NOT_INITIALIZED
        self.vel = None  # relative motion (R, t): Tcw_k = vel o Tcw_{k-1}
        self.last_Rcw = torch.eye(3, dtype=torch.float32, device=self.device)
        self.last_tcw = torch.zeros(3, dtype=torch.float32, device=self.device)
        self.last_kf_slot = 0
        self.frames_since_kf = 0
        self.tracked_at_kf = 0
        self.lost_frames = 0
        # built by the relocalisation and loop-closing slice: both stay None
        self.loop_closer = None
        self.reloc_db = None

    # ------------------------------------------------------------------
    def _refill_free_slots(self, kf_valid: np.ndarray):
        """Recompute the recycled-slot list from a fresh ``kf_valid`` pull.

        Before a slot may be recycled, every trajectory record anchored to
        it is re-anchored to the culled keyframe's spanning-tree parent
        (``SaveTrajectoryTUM``'s walk): rel' = rel o T_dead o T_parent^-1
        keeps the record relative to a live keyframe, so it still follows
        every later refinement.  Records whose culled reference has no live
        parent fall back to an absolute pose."""
        kf_valid = np.asarray(kf_valid)
        dead = np.flatnonzero(~kf_valid[: self.n_kf])
        newly_dead = [
            int(s) for s in dead if s != self.last_kf_slot and int(s) not in self._dead_slots
        ]
        if newly_dead:
            refs = {r.ref_slot for r in self.trajectory if r.ref_slot >= 0}
            fixup = [s for s in newly_dead if s in refs]
            if fixup:
                sl = torch.tensor(fixup, device=self.device)
                par_t = self.m.kf_parent[sl]
                psl = par_t.clamp(min=0).long()
                Rk, tk, par, Rp, tp = (_np(x) for x in (
                    self.m.kf_Rcw[sl], self.m.kf_tcw[sl], par_t,
                    self.m.kf_Rcw[psl], self.m.kf_tcw[psl],
                ))
                info = {s: (Rk[k], tk[k], int(par[k]), Rp[k], tp[k]) for k, s in enumerate(fixup)}
                for r in self.trajectory:
                    if r.ref_slot in info:
                        Rr, tr, p, Rpp, tpp = info[r.ref_slot]
                        if p >= 0 and kf_valid[p]:
                            A_R = Rr @ Rpp.T  # T_dead o T_parent^-1
                            A_t = tr - A_R @ tpp
                            r.rel_t = r.rel_R @ A_t + r.rel_t
                            r.rel_R = r.rel_R @ A_R
                            r.ref_slot = p
                        else:
                            r.Rcw = r.rel_R @ Rr
                            r.tcw = r.rel_R @ tr + r.rel_t
                            r.ref_slot = -1
                            r.rel_R = r.rel_t = None
            self._dead_slots.update(newly_dead)
        self.free_kf_slots = [int(s) for s in dead if s != self.last_kf_slot]

    def _alloc_kf_slot(self):
        """Next keyframe slot: fresh while capacity lasts, else recycled."""
        if self.n_kf < self.cfg.max_keyframes:
            slot = self.n_kf
            self.n_kf += 1
            return slot
        if self.free_kf_slots:
            slot = self.free_kf_slots.pop(0)
            self._dead_slots.discard(slot)  # the slot gets a new occupant
            return slot
        return None

    def _can_insert_kf(self) -> bool:
        if self.n_kf < self.cfg.max_keyframes or self.free_kf_slots:
            return True
        # at capacity with no known-free slot: the mapper pass (which culls)
        # cannot run, so cull explicitly and refresh liveness, at most every
        # ~8 frames
        if self._refill_cooldown <= 0:
            self._refill_cooldown = 8
            slot = self.last_kf_slot
            _, kf_mask = MS.local_map_mask(self.m, slot, n_neighbors=self.cfg.local_window)
            protect = torch.zeros(self.cfg.max_keyframes, dtype=torch.bool, device=self.device)
            protect[slot] = True
            protect[0] = True
            self.m = MS.cull_keyframes(self.m, kf_mask, protect)
            self._refill_free_slots(_np(self.m.kf_valid))
            return bool(self.free_kf_slots)
        self._refill_cooldown -= 1
        return False

    def _need_new_kf(self, n_inl: int, tracked_close=None, nontracked_close=None) -> bool:
        """``Tracking::NeedNewKeyFrame`` policy (c1a/c1b/c1c and c2, with the
        stereo/RGB-D close-point trigger)."""
        cfg = self.cfg
        if self.localization_only or not self._can_insert_kf():
            return False
        ref = max(self.tracked_at_kf, 1)
        close_trigger = (
            tracked_close is not None and tracked_close < 100
            and nontracked_close is not None and nontracked_close > 70
        )
        c1a = self.frames_since_kf >= cfg.kf_max_interval
        c1b = self.frames_since_kf >= cfg.kf_min_interval
        c1c = tracked_close is not None and (n_inl < 0.25 * ref or close_trigger)
        c2 = (n_inl < cfg.kf_tracked_ratio * ref or close_trigger) and n_inl > 15
        return (c1a or c1b or c1c) and c2

    def set_localization_mode(self, on: bool):
        """Reference ``System::ActivateLocalizationMode``."""
        self.localization_only = bool(on)

    def _update_lost_state(self, ok: bool):
        """OK / RECENTLY_LOST / LOST transition (reference state machine)."""
        if ok:
            self.state = OK
            self.lost_frames = 0
        else:
            self.lost_frames += 1
            self.state = LOST if self.lost_frames > self.lost_patience else RECENTLY_LOST

    # ------------------------------------------------------------------
    def process(self, img, frame_id: int):
        raise _todo("monocular initialisation and tracking", 1)

    def process_batch(self, imgs, frame_ids):
        raise _todo("batch (throughput) mode", 1)

    def _try_initialize(self, feats, frame_id):
        raise _todo("monocular two-view initialisation", 1)

    def _try_relocalize(self, feats, frame_id):
        """None while no relocalisation database exists (the only case the
        ported slices reach); querying one is not ported."""
        if self.reloc_db is None and self.loop_closer is None:
            return None
        raise _todo("relocalisation", 2)

    def _insert_keyframe(self, feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                         uvr=None, depth=None):
        """The whole mapper pass for a new keyframe
        (:func:`..tracking.insert_keyframe_step`); the host reads back the
        new allocation pointer."""
        cfg = self.cfg
        slot = self._alloc_kf_slot()
        if slot is None:
            return  # at capacity with no culled slot to recycle
        self.kf_inserted += 1
        NF = cfg.n_features
        none = lambda: torch.full((NF,), -1.0, dtype=torch.float32, device=self.device)
        # bindings from a track call made before an earlier compaction still
        # carry old point indices
        if self._mp_remap is not None:
            mp_of_feat = MS.remap_point_bindings(mp_of_feat, self._mp_remap)
        # free-list half of the map-point lifecycle: compact culled slots
        # away before the allocator runs out
        if self.n_mp > 0.85 * cfg.max_map_points:
            self.m, n_valid, inv = MS.compact_map_points(self.m)
            self.n_mp = int(n_valid)
            mp_of_feat = MS.remap_point_bindings(mp_of_feat, inv)
            self._mp_remap = inv if self._mp_remap is None else (
                MS.compose_point_remaps(self._mp_remap, inv)
            )
        self.m, n_mp = T.insert_keyframe_step(
            self.m, slot, Rcw, tcw, int(frame_id), feats, mp_of_feat,
            uvr if uvr is not None else none(), depth if depth is not None else none(),
            self.n_mp, self.cam, cfg, n_neighbors=cfg.triangulate_neighbors,
            bf=cfg.bf, has_depth=depth is not None,
        )
        self.n_mp = int(n_mp)
        self.kf_frame_ids[slot] = int(frame_id)
        self.last_kf_slot = slot
        self.frames_since_kf = 0
        self.tracked_at_kf = max(n_inl, 1)

    # ------------------------------------------------------------------
    def _orb_args(self) -> dict:
        cfg = self.cfg
        return dict(
            n_features=cfg.n_features, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
            th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast,
        )

    def _extract(self, img: torch.Tensor) -> O.FrameFeatures:
        return O.extract_orb(img, **self._orb_args())

    def _track(self, feats, frame_id, uvr=None, depth=None):
        cfg = self.cfg
        # constant-velocity motion model, else the last pose
        if self.vel is not None:
            Rp, tp = se3.compose(self.vel, (self.last_Rcw, self.last_tcw))
        else:
            Rp, tp = self.last_Rcw, self.last_tcw
        mp_mask, _ = MS.local_map_mask(self.m, self.last_kf_slot, n_neighbors=cfg.local_window)
        Rcw, tcw, n_inl, mp_of_feat, vis, found = T.track_frame(
            self.m, feats, Rp, tp, mp_mask, self.cam, cfg, feat_uvr=uvr, bf=cfg.bf,
        )
        self._mp_remap = None  # fresh bindings against the current map
        self.m = self.m._replace(
            mp_visible=self.m.mp_visible + vis.to(torch.int32),
            mp_found=self.m.mp_found + found.to(torch.int32),
        )
        self._after_track(feats, frame_id, Rp, tp, Rcw, tcw, int(n_inl),
                          mp_of_feat, uvr=uvr, depth=depth)

    def _after_track(self, feats, frame_id, Rp, tp, Rcw, tcw, n_inl,
                     mp_of_feat, uvr=None, depth=None):
        cfg = self.cfg
        if n_inl < cfg.min_tracked_points:
            reloc = self._try_relocalize(feats, frame_id)
            if reloc is not None:
                Rcw, tcw, n_inl, mp_of_feat = reloc
            else:
                self._update_lost_state(False)
                self.vel = None
                self._record(frame_id, Rp, tp, n_inl)
                self.frames_since_kf += 1
                return
        self._update_lost_state(True)
        self.vel = se3.compose((Rcw, tcw), se3.inverse((self.last_Rcw, self.last_tcw)))
        self.frames_since_kf += 1
        ref_now = (
            self.last_kf_slot,
            _np(self.m.kf_Rcw[self.last_kf_slot]),
            _np(self.m.kf_tcw[self.last_kf_slot]),
        )
        self._record(frame_id, Rcw, tcw, n_inl, ref_pose=ref_now)
        tc = ntc = None
        if depth is not None:
            close_th = (cfg.bf / self.cam.fx) * cfg.th_depth
            close = (depth > 0) & (depth < close_th)
            counts = torch.stack([
                torch.sum((mp_of_feat >= 0) & close), torch.sum((mp_of_feat < 0) & close),
            ])
            tc, ntc = (int(c) for c in _np(counts))
        if self._need_new_kf(n_inl, tracked_close=tc, nontracked_close=ntc):
            self._insert_keyframe(feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                                  uvr=uvr, depth=depth)

    def _record(self, frame_id, Rcw, tcw, n_inl, ref_pose=None):
        """Append a trajectory record; ``ref_pose`` = (ref_slot, Rr, tr), the
        reference keyframe's pose at track time."""
        Rn, tn = _np(Rcw), _np(tcw)
        if ref_pose is not None:
            ref_slot, Rr, tr = ref_pose
            rel_R = Rn @ Rr.T
            rel_t = tn - rel_R @ tr
            rec = FrameRecord(frame_id, Rn, tn, self.state, n_inl,
                              ref_slot=int(ref_slot), rel_R=rel_R, rel_t=rel_t)
        else:
            rec = FrameRecord(frame_id, Rn, tn, self.state, n_inl)
        self.trajectory.append(rec)
        self.last_Rcw = torch.as_tensor(Rcw, device=self.device)
        self.last_tcw = torch.as_tensor(tcw, device=self.device)

    def _add_candidates_init(self, m, out, accept):
        """Insert the initial map's candidate points (all bound to KF 0)."""
        pos_w, desc, normal, dmin, dmax, feat_a, feat_b, _ = out
        n_new = int(torch.sum(accept))
        m = MS.add_map_points(
            m, self.n_mp, pos_w, desc, normal, dmin, dmax,
            0, accept, 0, feat_a, 0, feat_b,
        )
        self.n_mp += n_new
        return m, n_new

    def positions(self) -> np.ndarray:
        """(N, 3) camera-centre trajectory (world frame), relative records
        composed with their reference keyframe's current pose."""
        kfR = _np(self.m.kf_Rcw)
        kft = _np(self.m.kf_tcw)
        out = []
        for rec in self.trajectory:
            if rec.ref_slot >= 0 and rec.rel_R is not None:
                Rr, tr = kfR[rec.ref_slot], kft[rec.ref_slot]
                R = rec.rel_R @ Rr
                t = rec.rel_R @ tr + rec.rel_t
            else:
                R, t = rec.Rcw, rec.tcw
            out.append(-R.T @ t)
        return np.stack(out)


class StereoSLAM(MonoSLAM):
    """Stereo SLAM: rectified pair in, metric-scale map out.

    Against the monocular base: initialisation from a single frame's stereo
    depth (``Tracking::StereoInitialization``), 3-row stereo observations in
    pose optimisation and local BA, and new map points created directly
    from depth at keyframe insertion."""

    MIN_INIT_POINTS = 300  # reference requires 500 stereo points at init

    def process(self, img_left, img_right, frame_id: int):
        """Feed one rectified grayscale pair, (H, W) each, values in [0, 255]."""
        cfg = self.cfg
        kw = self._orb_args()
        # each pyramid is built once and shared by extraction and matching
        pyrs, feats_lr = [], []
        for img in (img_left, img_right):
            im = torch.as_tensor(np.asarray(img), dtype=torch.float32).to(self.device)
            pyrs.append(tuple(I.build_pyramid(im, cfg.n_levels, cfg.scale_factor)))
            feats_lr.append(O.extract_from_pyramid(pyrs[-1], **kw))
        feats = feats_lr[0]
        sm = match_stereo(
            feats, feats_lr[1], pyrs[0], pyrs[1], bf=cfg.bf, baseline=cfg.bf / self.cam.fx,
            n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
        )
        uvr = torch.where(sm.valid, sm.u_right, -1.0)
        depth = torch.where(sm.valid, sm.depth, -1.0)

        if self.state == NOT_INITIALIZED:
            self._stereo_initialize(feats, frame_id, uvr, depth)
        else:
            self._track(feats, frame_id, uvr=uvr, depth=depth)
        return self.trajectory[-1] if self.trajectory else None

    def _stereo_initialize(self, feats, frame_id, uvr, depth):
        cfg = self.cfg
        eye = torch.eye(3, dtype=torch.float32, device=self.device)
        zero = torch.zeros(3, dtype=torch.float32, device=self.device)
        n_depth = int(torch.sum((depth > 0) & feats.valid))
        if n_depth < self.MIN_INIT_POINTS:
            self._record(frame_id, eye, zero, 0)
            return
        m = MS.add_keyframe(
            self.m, 0, eye, zero, frame_id,
            feats.xy, feats.level, feats.angle, feats.desc, feats.valid,
            torch.full((cfg.n_features,), -1, dtype=torch.int32, device=self.device), uvr,
        )
        self.n_kf = 1
        self.kf_frame_ids[0] = int(frame_id)
        # every valid-depth feature becomes a point (no close/far limit at init)
        out = T.stereo_points_from_depth(m, 0, depth, self.cam, cfg, bf=cfg.bf)
        accept = feats.valid & (depth > 0)
        m, _ = self._add_candidates_init(m, out, accept)
        self.m = m
        self.state = OK
        self.last_kf_slot = 0
        self.frames_since_kf = 0
        self.tracked_at_kf = self.n_mp
        self.vel = None
        self._record(frame_id, eye, zero, self.n_mp)


class RGBDSLAM(StereoSLAM):
    """RGB-D SLAM: gray image + registered depth map in, metric map out.

    Depth becomes a virtual right-image coordinate per feature,
    ``u_r = u - bf / depth`` (``Frame::ComputeStereoFromRGBD``), and the
    stereo machinery does the rest.
    """

    def process(self, img, depth_img, frame_id: int):
        cfg = self.cfg
        im = torch.as_tensor(np.asarray(img), dtype=torch.float32).to(self.device)
        feats = self._extract(im)
        dmap = torch.as_tensor(np.asarray(depth_img), dtype=torch.float32).to(self.device)
        H, W = dmap.shape
        # bilinear depth at sub-pixel keypoints, nearest when any neighbour
        # is invalid (depth edges)
        x = torch.clamp(feats.xy[:, 0], 0.0, W - 1.001)
        y = torch.clamp(feats.xy[:, 1], 0.0, H - 1.001)
        x0 = torch.floor(x).long()
        y0 = torch.floor(y).long()
        fx_ = x - x0
        fy_ = y - y0
        d00 = dmap[y0, x0]
        d01 = dmap[y0, x0 + 1]
        d10 = dmap[y0 + 1, x0]
        d11 = dmap[y0 + 1, x0 + 1]
        all_ok = (d00 > 0) & (d01 > 0) & (d10 > 0) & (d11 > 0)
        d_bil = (
            d00 * (1 - fx_) * (1 - fy_) + d01 * fx_ * (1 - fy_)
            + d10 * (1 - fx_) * fy_ + d11 * fx_ * fy_
        )
        d_near = dmap[torch.round(y).long(), torch.round(x).long()]
        d = torch.where(all_ok, d_bil, d_near)
        valid_d = feats.valid & (d > 0)
        depth = torch.where(valid_d, d, -1.0)
        uvr = torch.where(valid_d, feats.xy[:, 0] - cfg.bf / torch.clamp(d, min=1e-6), -1.0)

        if self.state == NOT_INITIALIZED:
            self._stereo_initialize(feats, frame_id, uvr, depth)
        else:
            self._track(feats, frame_id, uvr=uvr, depth=depth)
        return self.trajectory[-1] if self.trajectory else None
