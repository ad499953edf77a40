"""SLAM system facades (port of :mod:`orb_slam3_noted_tpu.pipeline.system`).

``MonoSLAM``, ``StereoSLAM``, ``FisheyeStereoSLAM`` and ``RGBDSLAM`` run full
SLAM, loop closing included.  Monocular: two-view initialisation (``Tracking::
MonocularInitialization``, :func:`..tracking.init_attempt_batch`), the
initial map from its triangulated points and a BA over both keyframes, then
per frame extraction, local-map projection matching and motion-only pose
optimisation.  Stereo and RGB-D: single-frame initialisation from depth,
then the same tracking with stereo rows.  Fisheye stereo (the TUM-VI
configuration): a Kannala-Brandt pair that is not rectified, matched in its
lapping areas and triangulated with the known extrinsic, the right pixel a
second-camera row carrying ``Tlr``.  All of them share the OK /
RECENTLY_LOST / LOST state machine, the relative-pose trajectory records,
and at every keyframe decision the synchronous mapper
(:func:`..tracking.insert_keyframe_step`) with slot recycling and map-point
compaction.  ``set_localization_mode(True)`` freezes the map.

``process`` takes one frame; ``process_batch`` takes a batch (images,
rectified or fisheye (left, right) pairs, or RGB-D (image, depth map)
pairs): extraction once for all its frames, tracking frame after frame on
the device, one device-to-host copy of everything the host walks per
dispatch, and the keyframe policy evaluated per frame.  The JAX package's
fisheye and RGB-D facades inherit the rectified stereo batch hooks (SAD on
unrectified images and on depth maps, no second-camera rows); the port
runs their documented front ends in batch mode too.

A frame that tracks too few points tries relocalisation
(``Tracking::Relocalization``): BoW candidates from the keyframe database
(:mod:`..place`, with covisibility-group accumulation), SearchByBoW matches
against each candidate, PnP RANSAC (:mod:`..optim.pnp`) and a re-track of
the candidate's local map from its pose.  With loop closing off the facade
keeps a standalone database, to which every keyframe the mapper inserts is
added, as the reference's database exists whatever loop closing does;
without the vocabulary asset relocalisation is unavailable, as in the JAX
package.  Batch mode never relocalises, in either package.

With ``cfg.enable_loop_closing`` each keyframe the mapper inserts is queued
for loop detection (:class:`..loop_closing.LoopCloser`, built at the first
keyframe on the shipped 32k-word vocabulary, whose database relocalisation
then queries); the queue drains at the next frame boundary of ``process`` or
``process_batch`` with one device-to-host copy, and a
correction's deferred fuses and GBA steps run one slice per frame boundary
(``_service_background``).  ``flush()`` drains everything; stereo and RGB-D
frame by frame leave their detections queued until then, as the JAX package
does.

All state lives on the constructor's ``device`` (the CUDA device unless the
caller names another); the host holds the scalar counters, the trajectory
records (numpy) and the state machine.  The map-point allocation pointer
``n_mp`` is a plain int, read back once per keyframe.  The RANSAC draws of
the monocular initialisation come from a ``torch.Generator`` on that device
seeded with the frame id (:meth:`MonoSLAM._minimal_sets`), and so do the
PnP draws of a relocalisation attempt (:meth:`MonoSLAM._pnp_sets`).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.geometry import se3
from orb_slam3_noted_tpu_torch.geometry import twoview as TV
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops import image as I
from orb_slam3_noted_tpu_torch.ops import matching as M
from orb_slam3_noted_tpu_torch.ops import orb as O
from orb_slam3_noted_tpu_torch.ops.stereo import match_stereo
from orb_slam3_noted_tpu_torch.optim import pnp as PNP
from orb_slam3_noted_tpu_torch.pipeline import loop_closing as LC
from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
from orb_slam3_noted_tpu_torch.pipeline import tracking as T
from orb_slam3_noted_tpu_torch.place.database import KeyFrameDatabase
from orb_slam3_noted_tpu_torch.place.pretrained import load_default_vocabulary
from orb_slam3_noted_tpu_torch.place.vocab import train_vocabulary
from orb_slam3_noted_tpu_torch.utils.interop import pull as _pull, set_scalar
from orb_slam3_noted_tpu_torch.utils.timing import count, device_read, span

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
RECENTLY_LOST = "RECENTLY_LOST"
LOST = "LOST"

# spans (``utils.timing.span``: with nothing recording, one flag check and no
# profiler event; recording, a profiler range and a kept span).  The root of
# each ``process`` / ``process_batch`` call, which carries its frame id (a
# batch's first id and its size) to every span inside it
FRAME_RANGE = "frame"
# a frame's ORB extraction and stereo matching (the batch front ends' stereo
# matching in pipeline/tracking.py)
EXTRACTION_RANGE = "orb_extraction"
STEREO_RANGE = T.STEREO_RANGE
# inside extraction: the pyramid and its atlas, the rest in ops/orb.py
PYRAMID_RANGE = O.PYRAMID_RANGE
EXTRACTION_PARTS = (PYRAMID_RANGE, O.SELECT_RANGE, O.ANGLE_RANGE, O.DESCRIBE_RANGE)
# a tracked frame's bookkeeping after ``tracking.track_frame`` (relocalisation
# when it failed, the record, the keyframe decision), without the mapper
# pass; the whole mapper pass of a keyframe, and in it the point compaction
AFTER_TRACK_RANGE = "after_track"
MAPPER_RANGE = "mapper_pass"
COMPACT_RANGE = "compact_points"
# the facade's stages: initialisation attempts, a batch dispatch, a re-track
# after a mid-batch keyframe, the mapper pass of a keyframe, a relocalisation
# attempt's matching, PnP and re-track, and the place-recognition work (a
# relocalisation query, a keyframe's BoW vector and loop detection); none of
# these nests in another
INIT_RANGE = "initialize"
TRACK_BATCH_RANGE = "track_batch"
RETRACK_RANGE = "track_batch_feats"
KEYFRAME_RANGE = "insert_keyframe"
RELOC_RANGE = "relocalize"
PLACE_RANGE = "place_recognition"
# loop closing: draining the detection queue (a correction's ``loop_correct``
# nests inside it), and one slice of a correction's deferred work
LOOP_DRAIN_RANGE = "loop_drain"
BACKGROUND_RANGE = "background_slice"
STAGES = (INIT_RANGE, TRACK_BATCH_RANGE, RETRACK_RANGE, KEYFRAME_RANGE, RELOC_RANGE, PLACE_RANGE,
          LOOP_DRAIN_RANGE, BACKGROUND_RANGE, LC.CORRECT_RANGE)
RELOC_MIN_MATCHES = 15  # SearchByBoW matches a candidate needs before PnP


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        with device_read():
            return x.detach().cpu().numpy()
    return np.asarray(x)


def _frame(feats: O.FrameFeatures, i) -> O.FrameFeatures:
    """Row ``i`` (an index or a slice) of batched features."""
    return O.FrameFeatures(*(f[i] for f in feats))


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
        # FrameDrawer hook (reference ``FrameDrawer::Update``): when on, a
        # tracked frame records its keypoints and matches for
        # ``utils.viewer.draw_frame`` (one device-to-host copy a frame, or a
        # batch dispatch) and the image they lie on; off, nothing is copied
        self.keep_frame_overlay = False
        self.last_overlay = None
        self.last_image = None
        # the map is updated in place: a thread that runs ``process`` and
        # one that reads the map (``node.SlamNode``, ``utils.viewer``) both
        # hold this lock
        self.lock = threading.Lock()
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
        self.ref_feats = None  # monocular initialisation's reference frame
        self.ref_frame_id = None
        self.vel = None  # relative motion (R, t): Tcw_k = vel o Tcw_{k-1}
        self.last_Rcw = torch.eye(3, dtype=torch.float32, device=self.device)
        self.last_tcw = torch.zeros(3, dtype=torch.float32, device=self.device)
        self.last_kf_slot = 0
        self.frames_since_kf = 0
        self.tracked_at_kf = 0
        self.lost_frames = 0
        self.loop_closer = None  # built at the first keyframe when loop closing is on
        self._pending_loops = []  # queued loop detections (device work, not read yet)
        # standalone relocalisation database, built at the first keyframe
        # the mapper inserts (the reference's exists whatever loop closing does)
        self.reloc_db = None

    # ------------------------------------------------------------------
    def flush(self):
        """Drain the deferred loop-closing work: the queued detections (one
        device-to-host copy), then the deferred fuses and the in-flight GBA."""
        if self._pending_loops:
            with span(LOOP_DRAIN_RANGE):
                pendings, self._pending_loops = self._pending_loops, []
                count("loop_detect_drained", len(pendings))
                if self.loop_closer.finish_detect_many(self, pendings):
                    self.state = OK
        if self.loop_closer is not None:
            self.loop_closer.finish_gba(self)
        return self

    def _service_background(self):
        """One slice of a correction's deferred work per frame boundary (a
        fuse, or a GBA step): the single-device stand-in for the reference's
        GBA thread."""
        if self.loop_closer is not None:
            with span(BACKGROUND_RANGE):
                self.loop_closer.service_gba(self, n_steps=1)

    def _frame_boundary(self):
        """What ``process`` and ``process_batch`` do first: drain the queued
        detections, then one background slice."""
        if self._pending_loops:
            self.flush()
        self._service_background()

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
            set_scalar(protect, slot, True)
            set_scalar(protect, 0, True)
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
    def _last_pose(self):
        """(Rcw, tcw) of the last record as tensors on the device (a record
        made from a batch's host copy holds numpy arrays)."""
        return tuple(torch.as_tensor(x, dtype=torch.float32, device=self.device)
                     for x in (self.last_Rcw, self.last_tcw))

    def _velocity(self):
        """The motion model as tensors on the device, identity when none."""
        if self.vel is None:
            return (torch.eye(3, dtype=torch.float32, device=self.device),
                    torch.zeros(3, dtype=torch.float32, device=self.device))
        return tuple(torch.as_tensor(x, dtype=torch.float32, device=self.device) for x in self.vel)

    def _on_device(self, img, dtype) -> torch.Tensor:
        """An image (numpy or a tensor) on the device as ``dtype``."""
        return torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor) else img
                               ).to(self.device, dtype)

    def _prediction(self):
        """Constant-velocity prediction of the next pose, else the last pose."""
        last = self._last_pose()
        return se3.compose(self._velocity(), last) if self.vel is not None else last

    # ------------------------------------------------------------------
    def process(self, img, frame_id: int):
        """Feed one grayscale image (H, W), values in [0, 255]."""
        with span(FRAME_RANGE, frame=frame_id, frames=1):
            self._frame_boundary()
            self._keep_image(img)
            if self.state == NOT_INITIALIZED:
                with span(INIT_RANGE):
                    with span(EXTRACTION_RANGE):
                        feats = self._extract(self._on_device(img, torch.float32))
                    self._try_initialize(feats, frame_id)
            else:
                self._track_fused(self._on_device(img, torch.uint8), frame_id)
            return self.trajectory[-1] if self.trajectory else None

    def _track_fused(self, img_u8, frame_id):
        Rp, tp = self._prediction()
        self.m, feats, Rcw, tcw, n_inl, mp_of_feat = T.track_step(
            self.m, img_u8, self.last_kf_slot, Rp, tp, self.cam, self.cfg, bf=0.0,
        )
        self._mp_remap = None  # fresh bindings against the current map
        with device_read():
            n = int(n_inl)
        self._after_track(feats, frame_id, Rp, tp, Rcw, tcw, n, mp_of_feat)

    # ------------------------------------------------------------------
    def _minimal_sets(self, valid: torch.Tensor, seed: int) -> torch.Tensor:
        """RANSAC minimal sets of an initialisation attempt, (n_hyp, 8) for a
        (N,) match mask or (B, n_hyp, 8) for (B, N): drawn from a generator
        on the facade's device seeded with the frame id (the JAX package
        seeds its key with it)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return TV.sample_minimal_sets(valid, T.N_HYP, g)

    def _try_initialize(self, feats, frame_id):
        """One two-view attempt of this frame against the reference frame;
        the first frame (and any frame that matches too little) becomes the
        reference."""
        eye = torch.eye(3, dtype=torch.float32, device=self.device)
        if self.ref_feats is None:
            self.ref_feats = feats
            self.ref_frame_id = frame_id
            self._record(frame_id, eye, torch.zeros(3, dtype=torch.float32, device=self.device), 0)
            return
        ref = self.ref_feats
        mm = M.match_nn(
            M.hamming_matrix(ref.desc, feats.desc), ref.valid, feats.valid, max_dist=M.TH_LOW,
            ratio=0.9, mutual=True, ang_a=ref.angle, ang_b=feats.angle,
        )
        idx = mm.idx
        matched = idx >= 0
        rays1 = cam_mod.unproject(self.cam, ref.xy)
        rays2 = cam_mod.unproject(self.cam, feats.xy[idx.clamp(min=0).long()])
        # the reconstruction runs whatever the match count; the host branches
        # on what comes back in one copy
        res = TV.reconstruct_two_views(
            rays1, rays2, matched, self._minimal_sets(matched, frame_id),
            err_thresh=3.84 / (self.cam.fx * self.cam.fx),
        )
        n_matches, success, good, pts1_np, R21_np, t21_np = _pull(
            torch.sum(matched), res.success, res.is_inlier, res.points1, res.R21, res.t21)
        if int(n_matches) < 100:
            # matching too weak: this frame becomes the reference
            self.ref_feats = feats
            self.ref_frame_id = frame_id
            self._record(frame_id, self.last_Rcw, self.last_tcw, 0)
            return
        if not bool(success):
            self._record(frame_id, self.last_Rcw, self.last_tcw, 0)
            return
        self._finish_initialize(feats, frame_id, idx, good, res.points1, res.R21, res.t21,
                                pts1_np, R21_np, t21_np)

    def _finish_initialize(self, feats, frame_id, idx, good, pts1_dev, R21_dev, t21_dev,
                           pts1_np, R21_np, t21_np):
        """The two-keyframe initial map of a successful reconstruction
        (``CreateInitialMapMonocular``): median depth scaled to 1, keyframes
        0 and 1, a point per inlier bound to both, then BA over the two."""
        cfg = self.cfg
        ref = self.ref_feats
        dev = self.device
        # too few accepted points would give a nan median and a nan-scaled map
        if int(np.sum(good)) < 30:
            self._record(frame_id, self.last_Rcw, self.last_tcw, 0)
            return
        med = float(np.median(pts1_np[:, 2][good]))
        if not np.isfinite(med) or med <= 1e-6:
            self._record(frame_id, self.last_Rcw, self.last_tcw, 0)
            return
        scale = 1.0 / max(med, 1e-6)
        pts_w = pts1_dev * scale  # keyframe 0's frame is the world frame
        t21 = t21_dev * scale
        NF = cfg.n_features
        nobind = torch.full((NF,), -1, dtype=torch.int32, device=dev)
        no_uvr = torch.full((NF,), -1.0, dtype=torch.float32, device=dev)
        m = MS.add_keyframe(
            self.m, 0, torch.eye(3, dtype=torch.float32, device=dev),
            torch.zeros(3, dtype=torch.float32, device=dev), int(self.ref_frame_id),
            ref.xy, ref.level, ref.angle, ref.desc, ref.valid, nobind, no_uvr,
        )
        m = MS.add_keyframe(m, 1, R21_dev, t21, int(frame_id), feats.xy, feats.level,
                            feats.angle, feats.desc, feats.valid, nobind, no_uvr)
        # normal and scale range from keyframe 0's geometry
        dist = torch.linalg.vector_norm(pts_w, dim=-1)
        normal = pts_w / torch.clamp(dist, min=1e-9)[:, None]
        sf = T._scale_table(cfg, pts_w)
        dmax = dist * sf[ref.level.long()]
        dmin = dmax / sf[cfg.n_levels - 1]
        m = MS.add_map_points(
            m, 0, pts_w, ref.desc, normal, dmin, dmax, 0, torch.from_numpy(good).to(dev),
            0, torch.arange(NF, dtype=torch.int32, device=dev), 1, idx.clamp(min=0),
        )
        self.n_mp = int(np.sum(good))
        self.n_kf = 2
        self.kf_frame_ids[0] = int(self.ref_frame_id)
        self.kf_frame_ids[1] = int(frame_id)
        # keyframe 1's bindings came after its insertion: refresh its parent
        m = MS.refresh_parent(m, 1)
        # BA over the initial map (reference GlobalBundleAdjustemnt(20))
        self.m = T.local_ba(m, 1, self.cam, cfg, window=1)
        self.state = OK
        self.last_kf_slot = 1
        self.frames_since_kf = 0
        self.tracked_at_kf = self.n_mp
        self.vel = None
        self._record(frame_id, R21_np, t21_np * scale, self.n_mp)

    # ------------------------------------------------------------------
    # batch mode; the hooks below are StereoSLAM's to override
    def _process_one(self, frame, frame_id):
        self.process(frame, frame_id)

    def _on_batch_frame(self, frame_id):
        """Per-committed-frame hook inside the batch walk (the inertial
        facades' time bookkeeping); nothing for the visual ones."""

    def _prep_batch(self, frames, n_pad):
        """(B, H, W) uint8 on the device, the last frame repeated ``n_pad``
        times; host frames go over in one copy."""
        if isinstance(frames[0], torch.Tensor):
            return torch.stack(list(frames) + [frames[-1]] * n_pad).to(self.device, torch.uint8)
        batch = [np.asarray(f).astype(np.uint8) for f in frames]
        return torch.from_numpy(np.stack(batch + [batch[-1]] * n_pad)).to(self.device)

    def _batch_track(self, prep, vel, cm):
        Rl, tl = self._last_pose()
        self.m, Rs, ts, n_inls, feats_all, mp_feats = T.track_batch(
            self.m, prep, self.last_kf_slot, Rl, tl, vel, self.cam, self.cfg, bf=0.0,
            count_mask=cm,
        )
        return Rs, ts, n_inls, feats_all, mp_feats, None

    def _batch_retrack(self, rolled, aux_rolled, vel, cm):
        Rl, tl = self._last_pose()
        self.m, Rs, ts, n_inls, _, mp_feats = T.track_batch_feats(
            self.m, rolled, self.last_kf_slot, Rl, tl, vel, self.cam, self.cfg, bf=0.0,
            count_mask=cm,
        )
        return Rs, ts, n_inls, mp_feats

    @staticmethod
    def _roll_aux(aux, pos):
        return None if aux is None else tuple(torch.roll(x, -pos, dims=0) for x in aux)

    @staticmethod
    def _kf_extras(aux, d):
        """The rows of the keyframe frame at dispatch index d, in
        ``_insert_keyframe``'s order after ``n_inl``: (uvr, depth), and a
        fisheye rig's xy_r; none for mono."""
        return () if aux is None else tuple(x[d] for x in aux)

    def _close_counts(self, mp_feats, aux):
        """(tracked_close, nontracked_close) per frame on the device, or None
        (stereo/RGB-D only: the close-point trigger of ``NeedNewKeyFrame``)."""
        if aux is None:
            return None
        close_th = (self.cfg.bf / self.cam.fx) * self.cfg.th_depth
        close = (aux[1] > 0) & (aux[1] < close_th)
        return (torch.sum((mp_feats >= 0) & close, dim=1),
                torch.sum((mp_feats < 0) & close, dim=1))

    def _host_copy(self, Rs, ts, n_inls, mp_feats, aux):
        """What the host walks after a tracking dispatch, in one copy: inlier
        counts, poses, the reference keyframe's pose (the trajectory records
        are relative to it) and the close-point counts."""
        self._mp_remap = None  # fresh bindings against the current map
        cc = self._close_counts(mp_feats, aux)
        n_np, Rs_np, ts_np, refR, reft, *cc_np = _pull(
            n_inls, Rs, ts, self.m.kf_Rcw[self.last_kf_slot], self.m.kf_tcw[self.last_kf_slot],
            *(cc or ()))
        return n_np, Rs_np, ts_np, (self.last_kf_slot, refR, reft), (cc_np or None)

    def process_batch(self, imgs, frame_ids):
        """Throughput mode: track a batch of frames per dispatch.

        Frames before initialisation go through batched two-view attempts
        (``_init_consume``).  Then one dispatch extracts and tracks the rest;
        the host walks the per-frame inlier counts, inserts a keyframe at
        each frame whose policy fires (evaluated per frame, not at the batch
        tail), and with ``retrack_after_kf`` re-tracks the frames after the
        first keyframe against the updated map without re-extracting.
        """
        with span(FRAME_RANGE, frame=frame_ids[0] if len(frame_ids) else None,
                  frames=len(frame_ids)):
            return self._process_batch(imgs, frame_ids)

    def _process_batch(self, imgs, frame_ids):
        self._frame_boundary()
        cfg = self.cfg
        i = 0
        while self.state == NOT_INITIALIZED and i < len(imgs):
            i += self._init_consume(imgs[i:], frame_ids[i:])
        if i >= len(imgs):
            return self.trajectory[-1] if self.trajectory else None

        B = len(imgs)
        ids = list(frame_ids[i:])
        n_real = len(ids)
        prep = self._prep_batch(imgs[i:], B - n_real)
        dev = self.device
        pos = 0            # frames committed so far
        feats_all = None   # the batch's features on the device
        aux = None         # per-frame stereo rows (uvr, depth[, uv2]) or None
        attempts = 0
        shown = None       # the overlay of the last tracked frame, copied at the end
        while pos < n_real:
            vel = self._velocity()
            if feats_all is None:
                with span(TRACK_BATCH_RANGE):
                    cm = torch.arange(B, device=dev) < n_real  # padding never counts
                    Rs, ts, n_inls, feats_all, mp_feats, aux = self._batch_track(prep, vel, cm)
                    n_np, Rs_np, ts_np, ref_now, cc_np = self._host_copy(
                        Rs, ts, n_inls, mp_feats, aux)
                offset, cur_feats, cur_aux = 0, feats_all, aux
            else:
                # roll so the next uncommitted frame leads; the wrapped tail is
                # tracked but ignored, and only the uncommitted head counts
                count("frames_retracked", n_real - pos)
                with span(RETRACK_RANGE):
                    cur_feats = O.FrameFeatures(*(torch.roll(f, -pos, dims=0) for f in feats_all))
                    cur_aux = self._roll_aux(aux, pos)
                    cm = torch.arange(B, device=dev) < (n_real - pos)
                    Rs, ts, n_inls, mp_feats = self._batch_retrack(cur_feats, cur_aux, vel, cm)
                    n_np, Rs_np, ts_np, ref_now, cc_np = self._host_copy(
                        Rs, ts, n_inls, mp_feats, cur_aux)
                offset = pos

            # walk the frames; with retrack_after_kf the walk stops at the
            # first keyframe and the rest re-track against the updated map
            k_kf = None
            for k in range(n_real - pos):
                j = pos + k          # batch index of this frame
                d = j - offset       # index into this dispatch's outputs
                self._on_batch_frame(ids[j])
                n = int(n_np[d])
                ok = n >= cfg.min_tracked_points
                self._update_lost_state(ok)
                self.frames_since_kf += 1
                self._record(ids[j], Rs_np[d], ts_np[d], n, ref_pose=ref_now)
                if ok and self.keep_frame_overlay:
                    shown = self._overlay_now(_frame(cur_feats, d), mp_feats[d], ids[j],
                                              imgs[i + j])
                if ok and d >= 1:
                    Rv = Rs_np[d] @ Rs_np[d - 1].T
                    self.vel = (Rv, ts_np[d] - Rv @ ts_np[d - 1])
                need = ok and self._need_new_kf(
                    n,
                    tracked_close=int(cc_np[0][d]) if cc_np is not None else None,
                    nontracked_close=int(cc_np[1][d]) if cc_np is not None else None,
                )
                if need:
                    self._insert_keyframe(_frame(cur_feats, d), ids[j], Rs_np[d], ts_np[d],
                                          mp_feats[d], n, *self._kf_extras(cur_aux, d))
                    if cfg.retrack_after_kf and attempts < 3 and j + 1 < n_real:
                        k_kf = j
                        break
            if k_kf is None:
                pos = n_real
            else:
                pos = k_kf + 1
                attempts += 1
        self._show_overlay(shown)
        return self.trajectory[-1]

    def _init_consume(self, imgs, frame_ids):
        """Batched initialisation attempts: one extraction for the remaining
        frames and one two-view attempt per frame against the reference, all
        in one batch; the host walks the outcomes in frame order with the
        per-frame policy of ``_try_initialize``.  Returns the number of
        frames consumed (>= 1)."""
        with span(INIT_RANGE):
            return self._init_consume_timed(imgs, frame_ids)

    def _init_consume_timed(self, imgs, frame_ids):
        with span(EXTRACTION_RANGE):
            feats_all = self._extract(self._prep_batch(imgs, 0).to(torch.float32))
        start = 0
        if self.ref_feats is None:
            self.ref_feats = _frame(feats_all, 0)
            self.ref_frame_id = frame_ids[0]
            self._record(frame_ids[0], np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0)
            if len(imgs) == 1:
                return 1
            start = 1
        cand = _frame(feats_all, slice(start, None))
        seed = int(frame_ids[start])
        n_m, succ, good, pts1, R21, t21, idx = T.init_attempt_batch(
            self.ref_feats, cand, self.cam, lambda matched: self._minimal_sets(matched, seed))
        n_m_np, succ_np, good_np, pts1_np, R21_np, t21_np = _pull(n_m, succ, good, pts1, R21, t21)
        for j in range(len(frame_ids) - start):
            fid = frame_ids[start + j]
            if int(n_m_np[j]) < 100:
                # matching too weak: this frame becomes the reference
                self.ref_feats = _frame(cand, j)
                self.ref_frame_id = fid
                self._record(fid, self.last_Rcw, self.last_tcw, 0)
                return start + j + 1
            if bool(succ_np[j]):
                self._finish_initialize(_frame(cand, j), fid, idx[j], good_np[j], pts1[j],
                                        R21[j], t21[j], pts1_np[j], R21_np[j], t21_np[j])
                return start + j + 1
            self._record(fid, self.last_Rcw, self.last_tcw, 0)
        return len(frame_ids)

    def _pnp_sets(self, valid: torch.Tensor, seed: int) -> torch.Tensor:
        """PnP minimal sets of a relocalisation attempt, (N_HYP, 6) distinct
        valid matches, drawn from a generator on the facade's device seeded
        with the frame id (the JAX package seeds its key with it)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return TV.sample_minimal_sets(valid, PNP.N_HYP, g, size=6)

    def _try_relocalize(self, feats, frame_id):
        """BoW candidates -> SearchByBoW matches -> PnP RANSAC -> re-track of
        the candidate's local map from the PnP pose.  Returns (Rcw, tcw,
        n_inl, mp_of_feat) on success, else None (also while no database
        exists).  The query copies its winners back once; per candidate the
        host reads the match count, the PnP verdict and the re-track's
        inlier count (and ``track_frame`` its own retry check)."""
        db = self._reloc_database()
        if db is None:
            return None
        cfg = self.cfg
        with span(PLACE_RANGE):
            _, bow = db.compute_bow(feats.desc, feats.valid)
            exclude = torch.zeros(cfg.max_keyframes, dtype=torch.bool, device=self.device)
            # the full DetectRelocalizationCandidates policy: covisibility-group
            # accumulation, not the best scores alone
            slots, _ = db.detect_candidates(bow, exclude, n_best=3, min_rel_score=0.75,
                                            covis=MS.covisibility_matrix(self.m))
        count("relocalize_attempts")
        with span(RELOC_RANGE):
            for cand in slots:
                Xw, rays, ok = T.reloc_matches(self.m, cand, feats, self.cam)
                with device_read():
                    n_ok = int(torch.sum(ok))
                if n_ok < RELOC_MIN_MATCHES:
                    continue
                res = PNP.pnp_ransac(Xw, rays, ok, self._pnp_sets(ok, frame_id))
                with device_read():
                    success = bool(res.success)
                if not success:
                    continue
                mp_mask, _ = MS.local_map_mask(self.m, cand, n_neighbors=cfg.local_window)
                Rcw, tcw, n_inl, mp_of_feat, _, _ = T.track_frame(
                    self.m, feats, res.Rcw, res.tcw, mp_mask, self.cam, cfg, feat_uvr=None,
                    bf=0.0,
                )
                self._mp_remap = None  # fresh bindings against the current map
                with device_read():
                    n = int(n_inl)
                if n >= 2 * cfg.min_tracked_points:
                    count("relocalize_ok")
                    self.last_kf_slot = cand
                    self.vel = None
                    return Rcw, tcw, n, mp_of_feat
        return None

    def _reloc_database(self):
        """The database relocalisation queries: the loop closer's, or the
        standalone one kept while loop closing is off."""
        if self.loop_closer is not None:
            return self.loop_closer.db
        return self.reloc_db

    def _register_reloc_kf(self, slot: int):
        """Add keyframe ``slot`` to the standalone database, building it at
        the first call; without the vocabulary asset there is none, and
        relocalisation is unavailable."""
        if self.reloc_db is None:
            vocab, idf = load_default_vocabulary()
            if vocab is None:
                return
            self.reloc_db = KeyFrameDatabase(vocab, self.cfg.max_keyframes, idf=idf,
                                             device=self.device)
        with span(PLACE_RANGE):
            _, bow = self.reloc_db.compute_bow(self.m.kf_desc[slot], self.m.kf_feat_valid[slot])
            self.reloc_db.add(slot, bow)

    def _insert_keyframe(self, feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                         uvr=None, depth=None, xy_r=None):
        """The whole mapper pass for a new keyframe
        (:func:`..tracking.insert_keyframe_step`); the host reads back the
        new allocation pointer.  ``xy_r``: a fisheye rig's right-camera
        pixel per feature."""
        with span(MAPPER_RANGE):
            self._mapper_pass(feats, frame_id, Rcw, tcw, mp_of_feat, n_inl, uvr, depth, xy_r)

    def _mapper_pass(self, feats, frame_id, Rcw, tcw, mp_of_feat, n_inl, uvr, depth, xy_r):
        cfg = self.cfg
        slot = self._alloc_kf_slot()
        if slot is None:
            return  # at capacity with no culled slot to recycle
        self.kf_inserted += 1
        count("keyframes_inserted")
        Rcw, tcw = (torch.as_tensor(x, dtype=torch.float32, device=self.device)
                    for x in (Rcw, tcw))
        NF = cfg.n_features
        none = lambda: torch.full((NF,), -1.0, dtype=torch.float32, device=self.device)
        # bindings from a track call made before an earlier compaction still
        # carry old point indices
        if self._mp_remap is not None:
            mp_of_feat = MS.remap_point_bindings(mp_of_feat, self._mp_remap)
        # free-list half of the map-point lifecycle: compact culled slots
        # away before the allocator runs out
        if self.n_mp > 0.85 * cfg.max_map_points:
            with span(COMPACT_RANGE):
                # compaction permutes point slots under an in-flight GBA's
                # snapshot: finish it first
                if self.loop_closer is not None:
                    self.loop_closer.finish_gba(self)
                self.m, n_valid, inv = MS.compact_map_points(self.m)
                with device_read():
                    self.n_mp = int(n_valid)
                mp_of_feat = MS.remap_point_bindings(mp_of_feat, inv)
                self._mp_remap = inv if self._mp_remap is None else (
                    MS.compose_point_remaps(self._mp_remap, inv)
                )
        with span(KEYFRAME_RANGE):
            self.m, n_mp = T.insert_keyframe_step(
                self.m, slot, Rcw, tcw, int(frame_id), feats, mp_of_feat,
                uvr if uvr is not None else none(), depth if depth is not None else none(),
                self.n_mp, self.cam, cfg, n_neighbors=cfg.triangulate_neighbors,
                bf=cfg.bf, has_depth=depth is not None, xy_r=xy_r,
            )
            with device_read():
                self.n_mp = int(n_mp)
        self.kf_frame_ids[slot] = int(frame_id)
        self.last_kf_slot = slot
        self.frames_since_kf = 0
        self.tracked_at_kf = max(n_inl, 1)
        if cfg.enable_loop_closing:
            self._maybe_close_loop(slot, feats)
        else:
            # the standalone database serves relocalisation
            self._register_reloc_kf(slot)

    def _maybe_build_loop_closer(self, feats):
        """Build the loop closer at the first keyframe: on the shipped 32k-word
        vocabulary, or, without the asset, on a small vocabulary trained on
        this keyframe's descriptors."""
        if self.loop_closer is None:
            vocab, idf = load_default_vocabulary()
            if vocab is None:
                desc = _np(feats.desc)[_np(feats.valid)].view(np.uint32)
                vocab = train_vocabulary(desc, n_words=min(self.cfg.vocab_words,
                                                           max(len(desc) // 2, 16)),
                                         n_iters=6, device=self.device)
                idf = None
            self.loop_closer = LC.LoopCloser(vocab, self.cfg.max_keyframes,
                                             min_inliers=self.cfg.loop_min_inliers, idf=idf,
                                             device=self.device)

    def _maybe_close_loop(self, slot, feats):
        """Queue keyframe ``slot``'s detection (device work only); it finishes
        at the next frame boundary, several queued ones with one copy."""
        self._maybe_build_loop_closer(feats)
        with span(PLACE_RANGE):
            self._pending_loops.append(self.loop_closer.start_detect(self, slot))
        count("loop_detect_queued")

    # ------------------------------------------------------------------
    def _orb_args(self) -> dict:
        cfg = self.cfg
        return dict(
            n_features=cfg.n_features, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
            th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast,
        )

    def _pyramid_atlas(self, img: torch.Tensor):
        """(pyramid, its atlas) of an (H, W) image or a (B, H, W) batch."""
        with span(PYRAMID_RANGE):
            pyr = tuple(I.build_pyramid(img, self.cfg.n_levels, self.cfg.scale_factor))
            return pyr, I.build_atlas(pyr)

    def _extract(self, img: torch.Tensor) -> O.FrameFeatures:
        return O.extract_from_atlas(self._pyramid_atlas(img)[1], **self._orb_args())

    def _track(self, feats, frame_id, uvr=None, depth=None, xy_r=None):
        cfg = self.cfg
        Rp, tp = self._prediction()  # constant-velocity model, else the last pose
        mp_mask, _ = MS.local_map_mask(self.m, self.last_kf_slot, n_neighbors=cfg.local_window)
        Rcw, tcw, n_inl, mp_of_feat, vis, found = T.track_frame(
            self.m, feats, Rp, tp, mp_mask, self.cam, cfg, feat_uvr=uvr, bf=cfg.bf,
            feat_uv2=xy_r,
        )
        self._mp_remap = None  # fresh bindings against the current map
        self.m = self.m._replace(
            mp_visible=self.m.mp_visible + vis.to(torch.int32),
            mp_found=self.m.mp_found + found.to(torch.int32),
        )
        with device_read():
            n = int(n_inl)
        self._after_track(feats, frame_id, Rp, tp, Rcw, tcw, n,
                          mp_of_feat, uvr=uvr, depth=depth, xy_r=xy_r)

    def _after_track(self, feats, frame_id, Rp, tp, Rcw, tcw, n_inl,
                     mp_of_feat, uvr=None, depth=None, xy_r=None):
        cfg = self.cfg
        with span(AFTER_TRACK_RANGE):
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
            if self.keep_frame_overlay:
                self._record_overlay(feats, mp_of_feat, frame_id)
            self.vel = se3.compose((Rcw, tcw), se3.inverse(self._last_pose()))
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
            need = self._need_new_kf(n_inl, tracked_close=tc, nontracked_close=ntc)
        if need:
            self._insert_keyframe(feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                                  uvr=uvr, depth=depth, xy_r=xy_r)

    @staticmethod
    def _shown_image(frame):
        """The image of a batch frame that the overlay is drawn on."""
        return frame

    def _keep_image(self, img):
        """With the overlay on, the image the next overlay is drawn on (a
        tensor stays on its device until a viewer draws it)."""
        if self.keep_frame_overlay:
            self.last_image = img if isinstance(img, torch.Tensor) else np.asarray(img)

    def _overlay_now(self, feats, mp_of_feat, frame_id, image=None):
        """The FrameDrawer snapshot of a frame as it stands, its tensors not
        copied yet: (tensors, host fields, image)."""
        return ((feats.xy, feats.valid, mp_of_feat >= 0),
                dict(frame_id=int(frame_id), state=self.state, n_kf=self.n_kf, n_mp=self.n_mp),
                image)

    def _show_overlay(self, snap):
        """Copy a snapshot of :meth:`_overlay_now` to the host in one copy
        and make it ``last_overlay`` (with its image, when it has one)."""
        if snap is None:
            return
        (xy, valid, matched), fields, image = snap
        xy, valid, matched = _pull(xy, valid, matched)
        self.last_overlay = dict(xy=xy, valid=valid, matched=matched, **fields)
        if image is not None:
            self._keep_image(self._shown_image(image))

    def _record_overlay(self, feats, mp_of_feat, frame_id):
        """FrameDrawer snapshot of this frame (see ``keep_frame_overlay``):
        keypoints ``xy``, ``valid``, ``matched`` (bound to a map point) as
        numpy, and the state and map counts."""
        self._show_overlay(self._overlay_now(feats, mp_of_feat, frame_id))

    def _record(self, frame_id, Rcw, tcw, n_inl, ref_pose=None):
        """Append a trajectory record; ``ref_pose`` = (ref_slot, Rr, tr), the
        reference keyframe's pose at track time.  Every frame handed to the
        facade gets one, so the ``frames`` counter counts here."""
        count("frames")
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
        # kept as given (device tensors, or a batch's host copies); turned
        # into device tensors where the next prediction needs them
        self.last_Rcw, self.last_tcw = Rcw, tcw

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
        """(N, 3) camera-centre trajectory (world frame) of :meth:`final_poses`."""
        return np.stack([-R.T @ t for R, t in self.final_poses()])

    def final_poses(self) -> list:
        """[(Rcw, tcw)] per trajectory record, relative records composed with
        their reference keyframe's current pose, so that every refinement
        since track time shows (the full-pose sibling of :meth:`positions`;
        reference ``SaveTrajectoryTUM``)."""
        kfR = _np(self.m.kf_Rcw)
        kft = _np(self.m.kf_tcw)
        out = []
        for rec in self.trajectory:
            if rec.ref_slot >= 0 and rec.rel_R is not None:
                Rr, tr = kfR[rec.ref_slot], kft[rec.ref_slot]
                out.append((rec.rel_R @ Rr, rec.rel_R @ tr + rec.rel_t))
            else:
                out.append((np.asarray(rec.Rcw), np.asarray(rec.tcw)))
        return out


class StereoSLAM(MonoSLAM):
    """Stereo SLAM: rectified pair in, metric-scale map out.

    Against the monocular base: initialisation from a single frame's stereo
    depth (``Tracking::StereoInitialization``), 3-row stereo observations in
    pose optimisation and local BA, and new map points created directly
    from depth at keyframe insertion."""

    MIN_INIT_POINTS = 300  # reference requires 500 stereo points at init

    # batch-mode hooks: ``process_batch`` takes a list of (left, right) pairs;
    # the 2B images are one extraction batch and the B pairs one K4 launch
    def _process_one(self, frame, frame_id):
        self.process(frame[0], frame[1], frame_id)

    @staticmethod
    def _shown_image(frame):
        return frame[0]

    def _init_consume(self, imgs, frame_ids):
        # stereo initialisation is single-frame (from depth)
        self._process_one(imgs[0], frame_ids[0])
        return 1

    def _prep_batch(self, frames, n_pad):
        """(2B, H, W) uint8 on the device: the B left images, then the B
        right ones; host frames go over in one copy."""
        frames = list(frames) + [frames[-1]] * n_pad
        if isinstance(frames[0][0], torch.Tensor):
            both = torch.stack([f[0] for f in frames] + [f[1] for f in frames])
            return both.to(self.device, torch.uint8)
        return torch.from_numpy(np.stack(
            [np.asarray(f[0]).astype(np.uint8) for f in frames]
            + [np.asarray(f[1]).astype(np.uint8) for f in frames])).to(self.device)

    def _batch_track(self, prep, vel, cm):
        Rl, tl = self._last_pose()
        self.m, Rs, ts, n_inls, feats_all, mp_feats, uvr, depth = T.stereo_track_batch(
            self.m, prep, self.last_kf_slot, Rl, tl, vel, self.cam, self.cfg,
            bf=self.cfg.bf, count_mask=cm,
        )
        return Rs, ts, n_inls, feats_all, mp_feats, (uvr, depth)

    def _batch_retrack(self, rolled, aux_rolled, vel, cm):
        Rl, tl = self._last_pose()
        self.m, Rs, ts, n_inls, _, mp_feats = T.track_batch_feats(
            self.m, rolled, self.last_kf_slot, Rl, tl, vel, self.cam, self.cfg,
            bf=self.cfg.bf, count_mask=cm, uvr_all=aux_rolled[0],
        )
        return Rs, ts, n_inls, mp_feats

    def process(self, img_left, img_right, frame_id: int):
        """Feed one rectified grayscale pair, (H, W) each, values in [0, 255]."""
        with span(FRAME_RANGE, frame=frame_id, frames=1):
            return self._process_pair(img_left, img_right, frame_id)

    def _process_pair(self, img_left, img_right, frame_id):
        cfg = self.cfg
        self._keep_image(img_left)
        # one pyramid and one atlas for the stacked pair, shared by
        # extraction (K1, K2 and K3 once each) and matching (K4 on the two
        # images' atlases, views of the pair's)
        with span(EXTRACTION_RANGE):
            pair = torch.stack([self._on_device(img_left, torch.float32),
                                self._on_device(img_right, torch.float32)])
            pyr, atlas = self._pyramid_atlas(pair)
            both = O.extract_from_atlas(atlas, **self._orb_args())
            feats, feats_r = (O.FrameFeatures(*(f[i] for f in both)) for i in range(2))
        with span(STEREO_RANGE):
            sm = match_stereo(
                feats, feats_r, tuple(p[0] for p in pyr), tuple(p[1] for p in pyr),
                bf=cfg.bf, baseline=cfg.bf / self.cam.fx, n_levels=cfg.n_levels,
                scale_factor=cfg.scale_factor,
                atlases=tuple(atlas._replace(image=atlas.image[i]) for i in range(2)),
            )
        uvr = torch.where(sm.valid, sm.u_right, -1.0)
        depth = torch.where(sm.valid, sm.depth, -1.0)

        if self.state == NOT_INITIALIZED:
            self._stereo_initialize(feats, frame_id, uvr, depth)
        else:
            self._track(feats, frame_id, uvr=uvr, depth=depth)
        return self.trajectory[-1] if self.trajectory else None

    def _stereo_initialize(self, feats, frame_id, uvr, depth, xy_r=None):
        cfg = self.cfg
        eye = torch.eye(3, dtype=torch.float32, device=self.device)
        zero = torch.zeros(3, dtype=torch.float32, device=self.device)
        with device_read():
            n_depth = int(torch.sum((depth > 0) & feats.valid))
        if n_depth < self.MIN_INIT_POINTS:
            self._record(frame_id, eye, zero, 0)
            return
        m = MS.add_keyframe(
            self.m, 0, eye, zero, frame_id,
            feats.xy, feats.level, feats.angle, feats.desc, feats.valid,
            torch.full((cfg.n_features,), -1, dtype=torch.int32, device=self.device), uvr,
            xy_r=xy_r,
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


class FisheyeStereoSLAM(StereoSLAM):
    """Non-rectified Kannala-Brandt stereo SLAM, the TUM-VI configuration.

    The pair is not rectified: descriptors match inside the two cameras'
    lapping areas and triangulate directly with the known extrinsic ``Tlr``
    (``Frame::ComputeStereoFishEyeMatches``,
    ``KannalaBrandt8::TriangulateMatches``; :mod:`..ops.fisheye_stereo`).
    The triangulated left-frame depth seeds map points at metric scale, and
    the matched right pixel becomes a second-camera observation carrying
    ``Tlr`` through pose optimisation and BA (the reference's two-camera
    ``EdgeMono``); there is no rectified u_right row.

    Needs ``cfg.camera`` and ``cfg.camera2`` (KB8), ``cfg.tlr_r``/``tlr_t``
    and ``cfg.lapping_l``/``lapping_r``; ``cfg.bf`` (baseline x fx) scales
    only the close-point threshold.
    """

    MIN_INIT_POINTS = 100  # the lapping area covers only part of the frame

    def __init__(self, cfg: SlamConfig, device=None):
        super().__init__(cfg, device=device)
        self._init_rig()

    def _init_rig(self):
        """The second camera's pose in the left frame, on the device (the
        camera itself is ``cfg.camera2``)."""
        if self.cfg.camera2 is None:
            raise ValueError("fisheye stereo needs cfg.camera2")
        self.Rlr, self.tlr = (torch.from_numpy(x).to(self.device)
                              for x in T.rig_extrinsic(self.cfg))

    # batch-mode hooks: the pairs as StereoSLAM lays them out, (2B, H, W);
    # the lapping-area matcher over the B pairs and the second-camera rows
    # through the scan and into each keyframe (the reference's facade
    # inherits the rectified hooks: SAD on unrectified images, no right rows)
    def _batch_track(self, prep, vel, cm):
        Rl, tl = self._last_pose()
        feats, depth, uv2 = T.fisheye_frontend_batch(prep, self.cfg, self.Rlr, self.tlr)
        self.m, Rs, ts, n_inls, _, mp_feats = T.track_batch_feats(
            self.m, feats, self.last_kf_slot, Rl, tl, vel, self.cam, self.cfg,
            bf=self.cfg.bf, count_mask=cm, uv2_all=uv2,
        )
        # no rectified u_right row, as in ``process``
        return Rs, ts, n_inls, feats, mp_feats, (torch.full_like(depth, -1.0), depth, uv2)

    def _batch_retrack(self, rolled, aux_rolled, vel, cm):
        Rl, tl = self._last_pose()
        self.m, Rs, ts, n_inls, _, mp_feats = T.track_batch_feats(
            self.m, rolled, self.last_kf_slot, Rl, tl, vel, self.cam, self.cfg,
            bf=self.cfg.bf, count_mask=cm, uv2_all=aux_rolled[2],
        )
        return Rs, ts, n_inls, mp_feats

    def _fisheye_frontend(self, img_left, img_right):
        """Both images as one atlas batch (K1, K2 and K3 once each), then the
        lapping-area match.  Returns (left features, depth (NF,) in the left
        camera frame or -1, uv2 (NF, 2) the matched right pixel or -1)."""
        with span(EXTRACTION_RANGE):
            pair = torch.stack([self._on_device(img_left, torch.float32),
                                self._on_device(img_right, torch.float32)])
            both = O.extract_from_atlas(self._pyramid_atlas(pair)[1], **self._orb_args())
            feats, feats_r = (_frame(both, i) for i in range(2))
        with span(STEREO_RANGE):
            depth, uv2 = T.fisheye_stereo_rows(feats, feats_r, self.cfg, self.Rlr, self.tlr)
        return feats, depth, uv2

    def process(self, img_left, img_right, frame_id: int):
        """Feed one fisheye pair, (H, W) each, values in [0, 255]."""
        with span(FRAME_RANGE, frame=frame_id, frames=1):
            self._keep_image(img_left)
            feats, depth, uv2 = self._fisheye_frontend(img_left, img_right)
            if self.state == NOT_INITIALIZED:
                uvr = torch.full((self.cfg.n_features,), -1.0, dtype=torch.float32,
                                 device=self.device)
                self._stereo_initialize(feats, frame_id, uvr, depth, xy_r=uv2)
            else:
                self._track(feats, frame_id, depth=depth, xy_r=uv2)
            return self.trajectory[-1] if self.trajectory else None


class RGBDSLAM(StereoSLAM):
    """RGB-D SLAM: gray image + registered depth map in, metric map out.

    Depth becomes a virtual right-image coordinate per feature,
    ``u_r = u - bf / depth`` (``Frame::ComputeStereoFromRGBD``,
    :func:`..tracking.rgbd_depth_rows`), and the stereo machinery does the
    rest.  ``process_batch`` takes (image, depth map) pairs.
    """

    # batch-mode hooks: ``process_batch`` takes (image, depth map) pairs;
    # one extraction over the B images (no K4), the depth rows from the B
    # maps (the reference's facade inherits the stereo hooks, which read the
    # depth map as a right image); initialisation stays single-frame
    def _prep_batch(self, frames, n_pad):
        """((B, H, W) uint8, (B, H, W) float32) on the device, one copy each."""
        frames = list(frames) + [frames[-1]] * n_pad
        if isinstance(frames[0][0], torch.Tensor):
            return (torch.stack([f[0] for f in frames]).to(self.device, torch.uint8),
                    torch.stack([f[1] for f in frames]).to(self.device, torch.float32))
        return tuple(torch.from_numpy(np.stack([np.asarray(f[k]).astype(dt) for f in frames])
                                      ).to(self.device)
                     for k, dt in ((0, np.uint8), (1, np.float32)))

    def _batch_track(self, prep, vel, cm):
        Rl, tl = self._last_pose()
        feats, uvr, depth = T.rgbd_frontend_batch(*prep, self.cfg)
        self.m, Rs, ts, n_inls, _, mp_feats = T.track_batch_feats(
            self.m, feats, self.last_kf_slot, Rl, tl, vel, self.cam, self.cfg,
            bf=self.cfg.bf, count_mask=cm, uvr_all=uvr,
        )
        return Rs, ts, n_inls, feats, mp_feats, (uvr, depth)

    def process(self, img, depth_img, frame_id: int):
        with span(FRAME_RANGE, frame=frame_id, frames=1):
            self._keep_image(img)
            with span(EXTRACTION_RANGE):
                feats = self._extract(self._on_device(img, torch.float32))
            depth, uvr = T.rgbd_depth_rows(feats, self._on_device(depth_img, torch.float32),
                                           self.cfg.bf)

            if self.state == NOT_INITIALIZED:
                self._stereo_initialize(feats, frame_id, uvr, depth)
            else:
                self._track(feats, frame_id, uvr=uvr, depth=depth)
            return self.trajectory[-1] if self.trajectory else None
