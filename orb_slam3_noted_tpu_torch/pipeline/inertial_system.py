"""Visual-inertial SLAM systems (port of :mod:`orb_slam3_noted_tpu.pipeline.inertial_system`).

``MonoInertialSLAM``, ``StereoInertialSLAM`` and ``FisheyeStereoInertialSLAM``:
the reference's IMU_MONOCULAR and IMU_STEREO modes, the latter also with two
Kannala-Brandt cameras that are not rectified.  The frame-boundary resampling of
``Tracking::PreintegrateIMU`` (:func:`resample_interval`, host numpy), the
``PredictStateIMU`` pose prediction, visual-inertial motion-only
optimisation (``PoseInertialOptimizationLastKeyFrame``), the staged IMU
initialisation of ``LocalMapping::InitializeIMU`` (init, VIBA1, VIBA2 with
bias priors 1e2/1e10 (1e5 stereo) -> 1/1e5 -> 0/0) and ``LocalInertialBA`` at
keyframe insertion, the temporal keyframe chain with its IMU segments
(merged when a keyframe is culled, re-integrated after a bias update),
the timestamp and bad-IMU watchdogs.  Before the IMU is initialised the
visual machinery of the base facade runs; keyframes land on the chain.

The host keeps the raw IMU samples and the chain's segments (numpy); each
preintegration call is one batched :func:`..imu.preintegration.
integrate_measurements` over every segment it needs (all chain segments
after a bias update, the B frames of a tracking dispatch), stepped only as
far as the longest real segment.  ``process_batch`` (stereo) runs, once
the IMU is initialised, one batched stereo front end (K1-K4 once each) and
one visual-inertial tracking dispatch over the batch
(:func:`vi_track_batch`: the frames predict from the shared anchor
keyframe, so they are independent; matching and pose optimisation run
frame after frame with no host read), then one copy of what the host walks.
The facades place their state on ``device``, the CUDA device unless the
caller names another.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.geometry import so3
from orb_slam3_noted_tpu_torch.imu.preintegration import (
    Bias,
    Preintegrated,
    index as preint_index,
    init_preintegrated,
    integrate_measurements,
    predict_state,
    stack as preint_stack,
)
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.ops import orb as O
from orb_slam3_noted_tpu_torch.ops.fast import topk_stable
from orb_slam3_noted_tpu_torch.ops.stereo import match_stereo
from orb_slam3_noted_tpu_torch.optim.inertial import inertial_init
from orb_slam3_noted_tpu_torch.optim.inertial_ba import vi_pose_optimization
from orb_slam3_noted_tpu_torch.optim.pose_opt import PoseObs
from orb_slam3_noted_tpu_torch.optim.vi_factors import VIState, body_from_cam, cam_from_body
from orb_slam3_noted_tpu_torch.pipeline import inertial_mapping as IMAP
from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
from orb_slam3_noted_tpu_torch.pipeline import tracking as T
from orb_slam3_noted_tpu_torch.pipeline.system import (
    COMPACT_RANGE,
    EXTRACTION_RANGE,
    FRAME_RANGE,
    KEYFRAME_RANGE,
    MAPPER_RANGE,
    NOT_INITIALIZED,
    OK,
    STEREO_RANGE,
    FisheyeStereoSLAM,
    MonoSLAM,
    StereoSLAM,
    _frame,
    _np,
)
from orb_slam3_noted_tpu_torch.utils.interop import pull as _pull
from orb_slam3_noted_tpu_torch.utils.timing import count, device_read, report_saturation, span

# the most samples a keyframe interval keeps (the oldest extras are dropped,
# as the JAX package's pad drops them), and the most an anchor -> frame span
# of a tracking dispatch keeps (the first ones, as the JAX package's)
_KF_PAD = 1024
_BATCH_PAD = 512

# spans of the inertial stages (``utils.timing.span``: with nothing
# recording, a flag check): a batch's front end and tracking dispatch, a chain BA, an IMU
# initialisation solve with its re-integration and FullInertialBA
VI_FRONTEND_RANGE = "vi_frontend_batch"
VI_TRACK_RANGE = "vi_track_batch"
CHAIN_BA_RANGE = "chain_ba"
IMU_INIT_RANGE = "imu_init"

_EMPTY = (np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,)))


def resample_interval(acc, gyr, ts, t0, t1):
    """Midpoint-resample raw samples onto [t0, t1] (host, numpy): the
    frame-boundary handling of ``Tracking::PreintegrateIMU``, virtual
    samples at t0/t1 by linear interpolation, then midpoint measurements
    over consecutive intervals.  Returns (acc (M, 3), gyr (M, 3), dt (M,))."""
    acc = np.asarray(acc, np.float64).reshape(-1, 3)
    gyr = np.asarray(gyr, np.float64).reshape(-1, 3)
    ts = np.asarray(ts, np.float64).reshape(-1)
    if t1 <= t0 or len(ts) == 0:
        return _EMPTY
    tt = np.concatenate([[t0], ts[(ts > t0) & (ts < t1)], [t1]])
    a = np.stack([np.interp(tt, ts, acc[:, k]) for k in range(3)], -1)
    w = np.stack([np.interp(tt, ts, gyr[:, k]) for k in range(3)], -1)
    dt = np.diff(tt)
    keep = dt > 1e-9
    return 0.5 * (a[:-1] + a[1:])[keep], 0.5 * (w[:-1] + w[1:])[keep], dt[keep]


class _ImuStream:
    """Host-side raw IMU sample buffer with interval extraction."""

    def __init__(self):
        self.acc, self.gyr, self.t = _EMPTY

    def push(self, acc, gyr, ts):
        if len(np.atleast_1d(ts)) == 0:
            return
        self.acc = np.concatenate([self.acc, np.asarray(acc).reshape(-1, 3)])[-8192:]
        self.gyr = np.concatenate([self.gyr, np.asarray(gyr).reshape(-1, 3)])[-8192:]
        self.t = np.concatenate([self.t, np.asarray(ts).reshape(-1)])[-8192:]

    def interval(self, t0, t1):
        return resample_interval(self.acc, self.gyr, self.t, t0, t1)


def _stack_segments(segments, keep_last: bool, cap: int, device):
    """(acc (S, n, 3), gyr (S, n, 3), dts (S, n)) float32 on ``device`` in one
    copy, each segment at most ``cap`` samples (its last ones if
    ``keep_last``, else its first), padded with dt = 0 to the longest, and
    n, the number of steps the longest needs."""
    segs = [tuple(x[-cap:] if keep_last else x[:cap] for x in s) for s in segments]
    n = max([len(s[2]) for s in segs] + [0])
    buf = np.zeros((len(segs), max(n, 1), 7), np.float32)
    for k, (a, w, d) in enumerate(segs):
        m = len(d)
        buf[k, :m, 0:3], buf[k, :m, 3:6], buf[k, :m, 6] = a, w, d
    dev = torch.from_numpy(buf).to(device)
    return dev[..., 0:3], dev[..., 3:6], dev[..., 6], n


class InertialMixin:
    """Visual-inertial machinery layered over a visual facade."""

    def _init_inertial(self, cfg: SlamConfig):
        dev = self.device
        self.calib = cfg.imu_calib(device=dev)
        self.imu = _ImuStream()
        self.ki = IMAP.empty_inertial(cfg, device=dev)
        self.bias = Bias.zero(device=dev)
        self.imu_stage = 0          # 0: vision only, 1: init, 2: VIBA1, 3: VIBA2
        self.kf_order: list[int] = []       # KF slots in temporal order
        self.kf_times: list[float] = []
        self.kf_segments: list[tuple] = []  # raw (acc, gyr, dt) per chain segment
        self.seg_preints: list[Preintegrated] = []
        # False marks a chain break (no IMU data spans the gap)
        self.seg_ok: list[bool] = []
        self.since_kf = _EMPTY
        self.last_t = None
        self.cur_vel = torch.zeros(3, dtype=torch.float32, device=dev)
        self.frames_total = 0
        # bad-IMU watchdog: accumulated "moving" time since init
        self._tinit_moving = 0.0

    # -- preintegration ------------------------------------------------
    def _integrate(self, segments, bias=None) -> Preintegrated:
        """Every segment of ``segments`` (raw (acc, gyr, dt) triples) in one
        batched call; a segment keeps its last ``_KF_PAD`` samples."""
        acc, gyr, dts, n = _stack_segments(segments, True, _KF_PAD, self.device)
        return integrate_measurements(bias or self.bias, acc, gyr, dts, self.calib, n_steps=n)

    def _preint_since_kf(self, bias=None) -> Preintegrated:
        return preint_index(self._integrate([self.since_kf], bias), 0)

    # -- robustness plumbing -------------------------------------------
    def _check_timestamps(self, t):
        """Timestamp sanity (reference ``Tracking::Track``): a clock that went
        backwards resets the map; a gap over 1 s resets it, keeping it only
        after VIBA2.  True when the map was reset."""
        if self.last_t is None or self.state == NOT_INITIALIZED:
            return False
        if t < self.last_t - 1e-9:
            self._reset_inertial_map(save=False)
            return True
        if t > self.last_t + 1.0:
            self._reset_inertial_map(save=self.imu_stage >= 3)
            return True
        return False

    def _reset_inertial_map(self, save: bool):
        """Reset the active map and the inertial chain (``save`` is the Atlas
        hook: a facade with ``_store_active_map`` stores the map first)."""
        if save and hasattr(self, "_store_active_map"):
            self._store_active_map()
        self.reset()
        self._init_inertial(self.cfg)

    def _check_bad_imu(self):
        """Not-enough-motion watchdog (reference ``LocalMapping::Run``):
        after IMU init but before VIBA2, if the last three keyframes (over
        at least 0.45 s) moved < 2 cm in total, the init was unobservable
        and the map resets.  True when a reset happened."""
        if not (1 <= self.imu_stage < 3) or len(self.kf_order) < 3:
            return False
        if self.kf_times[-1] - self.kf_times[-3] < 0.45:
            return False
        sl = torch.tensor(self.kf_order[-3:], device=self.device)
        R, tt = _pull(self.m.kf_Rcw[sl], self.m.kf_tcw[sl])
        centers = np.einsum("kji,kj->ki", R, -tt)
        dist = (np.linalg.norm(centers[2] - centers[1]) + np.linalg.norm(centers[1] - centers[0]))
        if dist > 0.05:
            self._tinit_moving += self.kf_times[-1] - self.kf_times[-2]
        if self._tinit_moving < 10.0 and dist < 0.02:
            self._reset_inertial_map(save=False)
            return True
        return False

    # -- raw sample ingestion ------------------------------------------
    def feed_imu(self, acc, gyr, ts):
        self.imu.push(acc, gyr, ts)

    def _accumulate_interval(self, t):
        """Collect the resampled measurements from the last frame to t."""
        if self.last_t is None:
            self.last_t = t
            return _EMPTY
        a, w, d = self.imu.interval(self.last_t, t)
        self.last_t = t
        sa, sw, sd = self.since_kf
        self.since_kf = (np.concatenate([sa, a]), np.concatenate([sw, w]), np.concatenate([sd, d]))
        return a, w, d

    def _on_batch_frame(self, frame_id):
        """Inside the visual batch walk (stage 0): advance the IMU
        accumulators and the current time for this committed frame."""
        t = getattr(self, "_frame_times", {}).get(frame_id)
        if t is not None:
            self._accumulate_interval(t)
            self._cur_time = t
            self.frames_total += 1

    # -- keyframe bookkeeping ------------------------------------------
    def _on_inertial_keyframe(self, slot, t):
        """Record the temporal chain segment ending at this new keyframe."""
        if self.kf_order:
            a, w, d = self.since_kf
            self.kf_segments.append((a.copy(), w.copy(), d.copy()))
            self.seg_preints.append(self._preint_since_kf())
            self.seg_ok.append(True)
        self.kf_order.append(slot)
        self.kf_times.append(t)
        self.since_kf = _EMPTY
        vel, bg, ba = (x.clone() for x in self.ki)
        vel[slot], bg[slot], ba[slot] = self.cur_vel, self.bias.bg, self.bias.ba
        self.ki = IMAP.KFInertial(vel=vel, bg=bg, ba=ba)

    def _reintegrate_segments(self):
        """Re-integrate every chain segment with the current bias, in one
        call (reference ``Preintegrated::Reintegrate``)."""
        if not self.kf_segments:
            self.seg_preints = []
            return
        p = self._integrate(self.kf_segments)
        self.seg_preints = [preint_index(p, k) for k in range(len(self.kf_segments))]

    # -- inertial keyframe culling + slot recycling --------------------
    def _splice_chain(self, kf_valid):
        """Drop culled keyframes from the temporal chain, merging their raw
        IMU segments (reference ``Preintegrated::MergePrevious``); the merged
        segments re-integrate in one call.  Runs from every
        ``_refill_free_slots``, so any cull keeps the chain consistent before
        a slot can be recycled."""
        kf_valid = np.asarray(kf_valid)
        changed = False
        k = len(self.kf_order) - 1
        while k >= 0:
            if kf_valid[self.kf_order[k]]:
                k -= 1
                continue
            changed = True
            n = len(self.kf_order)
            if k == 0:
                del self.kf_order[0], self.kf_times[0]
                if self.kf_segments:
                    del self.kf_segments[0], self.seg_preints[0], self.seg_ok[0]
            elif k == n - 1:
                del self.kf_order[-1], self.kf_times[-1]
                del self.kf_segments[-1], self.seg_preints[-1], self.seg_ok[-1]
            else:
                a0, w0, d0 = self.kf_segments[k - 1]
                a1, w1, d1 = self.kf_segments[k]
                self.kf_segments[k - 1] = (np.concatenate([a0, a1]), np.concatenate([w0, w1]),
                                           np.concatenate([d0, d1]))
                self.seg_preints[k - 1] = None  # re-integrated below
                self.seg_ok[k - 1] = self.seg_ok[k - 1] and self.seg_ok[k]
                del self.kf_segments[k], self.seg_preints[k], self.seg_ok[k]
                del self.kf_order[k], self.kf_times[k]
            k -= 1
        merged = [k for k, p in enumerate(self.seg_preints) if p is None]
        if merged:
            p = self._integrate([self.kf_segments[k] for k in merged])
            for r, k in enumerate(merged):
                self.seg_preints[k] = preint_index(p, r)
        return changed

    def _refill_free_slots(self, kf_valid):
        MonoSLAM._refill_free_slots(self, kf_valid)
        self._splice_chain(kf_valid)

    def _cull_inertial_kfs(self):
        """KeyFrameCulling on the temporal chain: redundancy ratio 0.5
        stereo-inertial / 0.9 mono-inertial, never the origin or the last
        two keyframes, and a culled keyframe's neighbours stay < 3 s apart
        (the merged segment must stay short).  One cull dispatch and one
        ``kf_valid`` copy, then the chain is spliced and the slots recycled."""
        n = len(self.kf_order)
        if n < 8:
            return
        KF = self.cfg.max_keyframes
        cand = np.zeros(KF, bool)
        for k in range(1, n - 2):
            if self.kf_times[k + 1] - self.kf_times[k - 1] < 3.0:
                cand[self.kf_order[k]] = True
        if not cand.any():
            return
        ratio = 0.5 if (self.FIX_SCALE and self.cfg.bf > 0) else 0.9
        cand_t = torch.from_numpy(cand).to(self.device)
        self.m = MS.cull_keyframes(self.m, cand_t, ~cand_t, ratio=ratio)
        kf_valid = _np(self.m.kf_valid)
        self._refill_free_slots(kf_valid)  # splices the chain too
        db = self._reloc_database()
        if db is not None:
            for s in np.flatnonzero(db.present & ~kf_valid):
                db.erase(int(s))

    def _can_insert_kf(self) -> bool:
        """At capacity with no recyclable slot, run the chain-aware cull (a
        visual cull would drop keyframes without merging their segments)."""
        if self.n_kf < self.cfg.max_keyframes or self.free_kf_slots:
            return True
        if not self.kf_order:
            return MonoSLAM._can_insert_kf(self)
        if self._refill_cooldown <= 0:
            self._refill_cooldown = 4
            self._cull_inertial_kfs()
            return bool(self.free_kf_slots)
        self._refill_cooldown -= 1
        return False

    # -- IMU initialisation stages -------------------------------------
    def _try_imu_init(self, t):
        with span(IMU_INIT_RANGE):
            return self._try_imu_init_timed(t)

    def _try_imu_init_timed(self, t):
        cfg = self.cfg
        stage_times = [cfg.imu_init_time, cfg.imu_viba1_time, cfg.imu_viba2_time]
        if self.imu_stage >= 3 or len(self.kf_order) < cfg.imu_init_min_kfs:
            return
        if t - self.kf_times[0] < stage_times[self.imu_stage]:
            return
        # the stage-0 visual mapper culls keyframes on the device: drop any
        # culled slot from the chain before the first solve reads its poses
        if self.imu_stage == 0:
            self._splice_chain(_np(self.m.kf_valid))
            if len(self.kf_order) < cfg.imu_init_min_kfs:
                return
        priors = [(1e2, 1e10 if self.FIX_SCALE is False else 1e5), (1.0, 1e5), (0.0, 0.0)]
        prior_g, prior_a = priors[self.imu_stage]
        slots = np.asarray(self.kf_order, np.int64)
        K = len(slots)
        # the chain padded to a power of two with masked segments, as the
        # JAX package pads it: the padding adds residual rows and parameters
        # that the observability gate's degrees of freedom count
        Kpad = 4
        while Kpad < K:
            Kpad *= 2
        slots_p = torch.from_numpy(np.concatenate([slots, np.full(Kpad - K, slots[-1])])).to(
            self.device)
        Rwb, twb = body_from_cam(self.m.kf_Rcw[slots_p], self.m.kf_tcw[slots_p], self.calib)
        pre = preint_stack(list(self.seg_preints)
                           + [init_preintegrated(self.bias)] * (Kpad - K))
        seg_ok = np.zeros(Kpad - 1, bool)
        seg_ok[: K - 1] = self.seg_ok
        res = inertial_init(Rwb, twb, pre, torch.from_numpy(seg_ok).to(self.device),
                            prior_g=prior_g, prior_a=max(prior_a, 1e-6), n_iters=30,
                            fix_scale=self.FIX_SCALE)
        s, sig = (float(x) for x in _pull(res.scale, res.scale_sigma))
        if not np.isfinite(s) or s < 1e-2 or s > 1e3:
            return
        if self.imu_stage == 0 and not self.FIX_SCALE:
            # observability gate: on a weakly excited window the scale is
            # absorbed by a velocity offset; wait until log-scale tightens
            if not np.isfinite(sig) or sig > 0.2:
                return
        sl = torch.from_numpy(slots).to(self.device)
        if self.imu_stage == 0:
            # gravity-align and rescale the whole map (Map::ApplyScaledRotation)
            Rwg = so3.exp(torch.cat([res.gdir, torch.zeros_like(res.gdir[:1])]))
            Ryw = Rwg.T
            sj = res.scale
            self.m = MS.apply_scaled_rotation_map(self.m, Ryw, sj)
            vel_new = s * torch.einsum("ij,kj->ki", Ryw, res.velocities[:K])
            last_R, last_t = self._last_pose()
            self.last_Rcw = last_R @ Ryw.T
            self.last_tcw = last_t * sj
            self.vel = None
        else:
            vel_new = res.velocities[:K]  # already metric; scale ~ 1
        vel, bg, ba = (x.clone() for x in self.ki)
        vel[sl] = vel_new
        bg[sl] = res.bg.expand(K, 3)
        ba[sl] = res.ba.expand(K, 3)
        self.ki = IMAP.KFInertial(vel=vel, bg=bg, ba=ba)
        self.bias = Bias(res.bg.clone(), res.ba.clone())
        self._reintegrate_segments()
        self.cur_vel = self.ki.vel[int(slots[-1])]
        # FullInertialBA over the whole chain with the stage's bias priors;
        # stereo enters with metric scale and converges in half the
        # iterations a monocular rescale needs
        self._chain_ba(window=None, bias_prior_g=float(prior_g),
                       bias_prior_a=float(min(prior_a, 1e5)), n_iters=8 if self.FIX_SCALE else 16)
        self.imu_stage += 1

    # -- inertial local mapping ----------------------------------------
    def _chain_ba(self, window=None, bias_prior_g=0.0, bias_prior_a=0.0, n_iters=4):
        with span(CHAIN_BA_RANGE):
            return self._chain_ba_timed(window, bias_prior_g, bias_prior_a, n_iters)

    def _chain_ba_timed(self, window=None, bias_prior_g=0.0, bias_prior_a=0.0, n_iters=4):
        cfg = self.cfg
        n = len(self.kf_order)
        if n < 2:
            return
        if window is None:
            # the full chain (FullInertialBA), capped, padded to a power of two
            W = min(n - 1, 63)
            Wpad = 1
            while Wpad < W:
                Wpad *= 2
        else:
            W = min(window, n - 1)
            Wpad = cfg.inertial_window
        Wpad = max(Wpad, W)
        slots = self.kf_order[-(W + 1):]
        pres = self.seg_preints[-W:]
        K = Wpad + 1
        kf_slots = np.full(K, slots[0], np.int32)
        kf_mask = np.zeros(K, bool)
        kf_slots[:len(slots)] = slots
        kf_mask[:len(slots)] = True
        seg_valid = np.zeros(K - 1, bool)
        seg_valid[:len(pres)] = self.seg_ok[-W:]
        preints = preint_stack(pres + [init_preintegrated(self.bias)] * (K - 1 - len(pres)))
        host = torch.from_numpy(np.concatenate([kf_slots, kf_mask, seg_valid]).astype(np.int32))
        dev = host.to(self.device)
        self.m, self.ki = IMAP.chain_inertial_ba(
            self.m, self.ki, dev[:K], dev[K:2 * K] > 0, preints, dev[2 * K:] > 0, self.cam,
            self.calib, cfg, bf=cfg.bf, n_iters=n_iters, bias_prior_g=bias_prior_g,
            bias_prior_a=bias_prior_a)

    # -- per-frame inertial tracking (after IMU init) -------------------
    def _anchor(self, anchor_slot: int):
        aRwb, atwb = body_from_cam(self.m.kf_Rcw[anchor_slot], self.m.kf_tcw[anchor_slot],
                                   self.calib)
        return VIState(Rwb=aRwb, twb=atwb, vel=self.ki.vel[anchor_slot],
                       bg=self.ki.bg[anchor_slot], ba=self.ki.ba[anchor_slot])

    def _track_inertial(self, feats, frame_id, feat_uvr=None, feat_uv2=None):
        cfg = self.cfg
        anchor_slot = self.kf_order[-1]
        anchor = self._anchor(anchor_slot)
        bias = Bias(anchor.bg, anchor.ba)
        pre = self._preint_since_kf(bias)
        Rp, tp, vp = predict_state(anchor.Rwb, anchor.twb, anchor.vel, pre, bias)
        frame0 = VIState(Rwb=Rp, twb=tp, vel=vp, bg=anchor.bg, ba=anchor.ba)
        Rcw_p, tcw_p = cam_from_body(frame0, self.calib)
        mp_mask, _ = MS.local_map_mask(self.m, anchor_slot, n_neighbors=cfg.local_window)
        obs, f_idx, vis = T.match_local_map(self.m, feats, Rcw_p, tcw_p, mp_mask, self.cam, cfg,
                                            feat_uvr=feat_uvr, feat_uv2=feat_uv2)
        # the optimiser runs on the matched rows only
        NF = feats.xy.shape[0]
        MP = self.m.mp_pos.shape[0]
        sel = topk_stable(obs.valid.to(torch.int32), NF)[1]
        obs_c = PoseObs(*(None if x is None else x[sel] for x in obs))
        res = vi_pose_optimization(self.cam, self.calib, anchor, frame0, pre, self.m.mp_pos[sel],
                                   obs_c, None, cfg.bf, *T._second_camera(cfg, self.device))
        Rcw, tcw = cam_from_body(VIState(res.Rwb, res.twb, res.vel, res.bg, res.ba), self.calib)
        self.cur_vel = res.vel
        with device_read():
            n_inl = int(res.n_inliers)
        keep_c = obs_c.valid & res.inliers
        tgt = torch.where(keep_c, f_idx[sel], NF)
        mp_of_feat = torch.full((NF + 1,), -1, dtype=torch.int32, device=sel.device)
        mp_of_feat[tgt] = sel.to(torch.int32)
        keep = T._any_at(MP, sel, keep_c)
        self._mp_remap = None  # fresh bindings against the current map
        self.m = self.m._replace(mp_visible=self.m.mp_visible + vis.to(torch.int32),
                                 mp_found=self.m.mp_found + keep.to(torch.int32))
        return Rcw, tcw, n_inl, mp_of_feat[:NF], (Rcw_p, tcw_p)


def vi_track_batch(m, feats_all, uvr_all, anchor_slot: int, anchor_vel, anchor_bg, anchor_ba,
                   acc, gyr, dts, n_steps: int, calib, cam, cfg: SlamConfig, bf: float,
                   count_mask, uv2_all=None):
    """Visual-inertial tracking of a batch of frames in one dispatch: each
    frame predicts from the shared anchor keyframe through its own
    preintegrated span (``PredictStateIMU``; the B spans are one
    preintegration call), then local-map matching and
    ``PoseInertialOptimizationLastKeyFrame`` per frame (a Python loop over
    the batch, no host read).  ``acc``/``gyr`` (B, N, 3), ``dts`` (B, N):
    the anchor -> frame spans, stepped ``n_steps`` samples; ``count_mask``
    (B,) the frames allowed to bump the visible/found counters; ``uv2_all``
    (B, NF, 2) a fisheye rig's right-camera pixels, or None.  Returns
    (m, Rcw (B, 3, 3), tcw (B, 3), n_inl (B,), mp_of_feat (B, NF), body
    velocities (B, 3))."""
    anchor_Rwb, anchor_twb = body_from_cam(m.kf_Rcw[anchor_slot], m.kf_tcw[anchor_slot], calib)
    bias = Bias(anchor_bg, anchor_ba)
    mp_mask, _ = MS.local_map_mask(m, anchor_slot, n_neighbors=cfg.local_window)
    NF = feats_all.xy.shape[1]
    MP = m.mp_pos.shape[0]
    # the local map compacted to a bounded row set before matching (the
    # local window holds ~2-3k live points); the excess is counted
    MPC = min(4096, MP)
    report_saturation("vi_local_map_rows",
                      torch.clamp(torch.sum(mp_mask.to(torch.int32)) - MPC, min=0))
    sel_mp = topk_stable(mp_mask.to(torch.int32), MPC)[1]
    mask_c = mp_mask[sel_mp]
    m_sub = m._replace(**{k: getattr(m, k)[sel_mp] for k in (
        "mp_pos", "mp_desc", "mp_normal", "mp_dmin", "mp_dmax", "mp_valid", "mp_ref_kf", "mp_nobs",
        "mp_visible", "mp_found")})
    pre = integrate_measurements(bias, acc, gyr, dts, calib, n_steps=n_steps)
    Rp, tp, vp = predict_state(anchor_Rwb, anchor_twb, anchor_vel, pre, bias)
    B = Rp.shape[0]
    frames0 = VIState(Rwb=Rp, twb=tp, vel=vp, bg=anchor_bg.expand(B, 3), ba=anchor_ba.expand(B, 3))
    Rcw_p, tcw_p = cam_from_body(frames0, calib)
    anchor = VIState(Rwb=anchor_Rwb, twb=anchor_twb, vel=anchor_vel, bg=anchor_bg, ba=anchor_ba)
    rig2 = T._second_camera(cfg, sel_mp.device)
    outs = []
    vis_c = torch.zeros(MPC, dtype=torch.int32, device=sel_mp.device)
    found_c = torch.zeros_like(vis_c)
    for b in range(B):
        obs, f_idx, vis = T.match_local_map(m_sub, _frame(feats_all, b), Rcw_p[b], tcw_p[b],
                                            mask_c, cam, cfg, feat_uvr=uvr_all[b],
                                            feat_uv2=None if uv2_all is None else uv2_all[b])
        # the optimiser's cost is linear in its rows: the matched ones only
        sel = topk_stable(obs.valid.to(torch.int32), NF)[1]
        obs_c = PoseObs(*(None if x is None else x[sel] for x in obs))
        res = vi_pose_optimization(cam, calib, anchor, VIState(*(x[b] for x in frames0)),
                                   preint_index(pre, b), m_sub.mp_pos[sel], obs_c, None, bf,
                                   *rig2)
        Rcw, tcw = cam_from_body(VIState(res.Rwb, res.twb, res.vel, res.bg, res.ba), calib)
        keep_c = obs_c.valid & res.inliers
        tgt = torch.where(keep_c, f_idx[sel], NF)
        # feature bindings carry global point ids (sel indexes the view)
        mp_of_feat = torch.full((NF + 1,), -1, dtype=torch.int32, device=sel.device)
        mp_of_feat[tgt] = sel_mp[sel].to(torch.int32)
        keep = T._any_at(MPC, sel, keep_c)
        vis_c = vis_c + (vis & count_mask[b]).to(torch.int32)
        found_c = found_c + (keep & count_mask[b]).to(torch.int32)
        outs.append((Rcw, tcw, res.n_inliers, mp_of_feat[:NF], res.vel))
    Rs, ts, n_inls, mp_feats, vels = (torch.stack(x) for x in zip(*outs))
    # the counters come back on the compacted rows: scatter them to the
    # global tables through sel_mp (integer adds, exact in any order)
    m = m._replace(mp_visible=m.mp_visible.index_add(0, sel_mp, vis_c),
                   mp_found=m.mp_found.index_add(0, sel_mp, found_c))
    return m, Rs, ts, n_inls, mp_feats, vels


class MonoInertialSLAM(InertialMixin, MonoSLAM):
    """Monocular-inertial SLAM (reference ``System::IMU_MONOCULAR``)."""

    FIX_SCALE = False  # mono: the scale is estimated by the IMU init

    def __init__(self, cfg: SlamConfig, device=None):
        MonoSLAM.__init__(self, cfg, device=device)
        self._init_inertial(cfg)

    def _begin_frame(self, frame_id, t, acc, gyr, imu_t) -> float:
        """What every frame does first: the loop-closing frame boundary,
        the timestamp check, the IMU samples, the interval since the last
        frame."""
        self._frame_boundary()
        t = float(frame_id) / self.cfg.fps if t is None else float(t)
        self._check_timestamps(t)  # on a broken stream: reset, re-init below
        if acc is not None:
            self.feed_imu(acc, gyr, imu_t)
        self._accumulate_interval(t)
        self._cur_time = t
        self.frames_total += 1
        return t

    def process(self, img, frame_id, t=None, acc=None, gyr=None, imu_t=None):
        """Feed one grayscale image at time ``t`` (default frame_id / fps)
        with the IMU samples since the last frame (``acc``, ``gyr`` (M, 3),
        ``imu_t`` (M,))."""
        with span(FRAME_RANGE, frame=frame_id, frames=1):
            return self._process_mono(img, frame_id, t, acc, gyr, imu_t)

    def _process_mono(self, img, frame_id, t, acc, gyr, imu_t):
        t = self._begin_frame(frame_id, t, acc, gyr, imu_t)
        self._keep_image(img)
        with span(EXTRACTION_RANGE):
            feats = self._extract(self._on_device(img, torch.float32))
        if self.state == NOT_INITIALIZED:
            n_kf_before, prev_ref = self.n_kf, self.ref_frame_id
            self._try_initialize(feats, frame_id)
            if self.n_kf > n_kf_before:  # the two-view init made keyframes 0 and 1
                self._register_init_keyframes(t)
            elif self.ref_frame_id != prev_ref:
                # a new reference frame: the chain segment must span
                # exactly [ref, next]
                self.since_kf = _EMPTY
            return self.trajectory[-1] if self.trajectory else None
        if self.imu_stage == 0:
            self._track(feats, frame_id)  # vision only while the chain accumulates
        else:
            Rcw, tcw, n_inl, mp_of_feat, _ = self._track_inertial(feats, frame_id)
            if n_inl < self.cfg.min_tracked_points:
                # right after the init the IMU prediction can miss the
                # matching windows where visual tracking is fine
                self._track(feats, frame_id)
            else:
                self.state = OK
                self.frames_since_kf += 1
                self._record(frame_id, Rcw, tcw, n_inl)
                if self.keep_frame_overlay:
                    self._record_overlay(feats, mp_of_feat, frame_id)
                if self._need_new_kf(n_inl):
                    self._insert_keyframe(feats, frame_id, Rcw, tcw, mp_of_feat, n_inl)
        self._try_imu_init(t)
        self._cur_time = t
        return self.trajectory[-1]

    def _register_init_keyframes(self, t):
        """After the two-view init, keyframes 0 and 1 start the chain (the
        accumulated samples span the reference frame -> this one)."""
        self.kf_order = [0]
        self.kf_times = [t - max(self.since_kf[2].sum(), 1e-3)]
        self.kf_segments = []
        self.seg_preints = []
        self._on_inertial_keyframe(1, t)

    def _need_new_kf(self, n_inl, tracked_close=None, nontracked_close=None):
        """Inertial sensors also force a keyframe every 0.5 s (the
        preintegration chain must stay short)."""
        if MonoSLAM._need_new_kf(self, n_inl, tracked_close=tracked_close,
                                 nontracked_close=nontracked_close):
            return True
        t = getattr(self, "_cur_time", None)
        return bool(t is not None and self.kf_times and not self.localization_only
                    and n_inl > 15 and self._can_insert_kf() and t - self.kf_times[-1] >= 0.5)

    def _insert_keyframe(self, feats, frame_id, Rcw, tcw, mp_of_feat, n_inl, uvr=None,
                         depth=None, xy_r=None):
        t = getattr(self, "_cur_time", None)
        if t is None:
            t = self.last_t if self.last_t is not None else 0.0
        if self.imu_stage == 0:
            # the visual mapper
            MonoSLAM._insert_keyframe(self, feats, frame_id, Rcw, tcw, mp_of_feat, n_inl,
                                      uvr=uvr, depth=depth, xy_r=xy_r)
            self._on_inertial_keyframe(self.last_kf_slot, t)
            return
        with span(MAPPER_RANGE):
            self._inertial_mapper_pass(feats, frame_id, Rcw, tcw, mp_of_feat, n_inl, uvr, depth,
                                       xy_r, t)

    def _inertial_mapper_pass(self, feats, frame_id, Rcw, tcw, mp_of_feat, n_inl, uvr, depth,
                              xy_r, t):
        # the inertial mapper: one mapper pass without visual BA (insert ->
        # depth points -> triangulation -> fuse -> point cull -> statistics),
        # then LocalInertialBA over the chain
        cfg = self.cfg
        slot = self._alloc_kf_slot()
        if slot is None:
            return  # at capacity with nothing recyclable
        self.kf_inserted += 1
        count("keyframes_inserted")
        Rcw, tcw = (torch.as_tensor(x, dtype=torch.float32).to(self.device) for x in (Rcw, tcw))
        NF = cfg.n_features
        none = lambda: torch.full((NF,), -1.0, dtype=torch.float32, device=self.device)
        if self._mp_remap is not None:
            mp_of_feat = MS.remap_point_bindings(mp_of_feat, self._mp_remap)
        if self.n_mp > 0.85 * cfg.max_map_points:
            with span(COMPACT_RANGE):
                # compaction permutes point slots under an in-flight GBA: finish it
                if self.loop_closer is not None:
                    self.loop_closer.finish_gba(self)
                self.m, n_valid, inv = MS.compact_map_points(self.m)
                with device_read():
                    self.n_mp = int(n_valid)
                mp_of_feat = MS.remap_point_bindings(mp_of_feat, inv)
                self._mp_remap = inv if self._mp_remap is None else (
                    MS.compose_point_remaps(self._mp_remap, inv))
        with span(KEYFRAME_RANGE):
            self.m, n_mp = T.insert_keyframe_step(
                self.m, slot, Rcw, tcw, int(frame_id), feats, mp_of_feat,
                uvr if uvr is not None else none(), depth if depth is not None else none(),
                self.n_mp, self.cam, cfg, n_neighbors=cfg.triangulate_neighbors, bf=cfg.bf,
                has_depth=depth is not None, visual_ba=False, xy_r=xy_r)
            with device_read():
                self.n_mp = int(n_mp)
        self.kf_frame_ids[slot] = int(frame_id)
        self.last_kf_slot = slot
        self.frames_since_kf = 0
        self.tracked_at_kf = max(n_inl, 1)
        self._on_inertial_keyframe(slot, t)
        self._chain_ba(window=cfg.inertial_window)
        self.bias = Bias(self.ki.bg[slot], self.ki.ba[slot])
        self.cur_vel = self.ki.vel[slot]
        # the back end on the inertial path: the chain-aware cull every few
        # inserts, loop detection once VIBA1 has refined the map (before
        # that a keyframe only joins the database), else the standalone
        # relocalisation database
        if self.kf_inserted % 4 == 0:
            self._cull_inertial_kfs()
        if cfg.enable_loop_closing:
            if self.imu_stage >= 2:
                self._maybe_close_loop(slot, feats)
            else:
                self._register_loop_db_kf(slot, feats)
        else:
            self._register_reloc_kf(slot)
        self._check_bad_imu()

    def _register_loop_db_kf(self, slot, feats):
        """Add the keyframe to the loop closer's database without querying
        for loops (the reference's pre-VIBA1 guard)."""
        self._maybe_build_loop_closer(feats)
        _, bow = self.loop_closer.db.compute_bow(self.m.kf_desc[slot], self.m.kf_feat_valid[slot])
        self.loop_closer.db.add(slot, bow)


class StereoInertialSLAM(MonoInertialSLAM):
    """Stereo-inertial SLAM (reference ``System::IMU_STEREO``): metric
    scale from stereo, the IMU init with the scale fixed."""

    FIX_SCALE = True
    MIN_INIT_POINTS = 300

    def process(self, img_left, img_right, frame_id, t=None, acc=None, gyr=None, imu_t=None):
        """Feed one rectified pair at time ``t`` with the IMU samples since
        the last frame."""
        with span(FRAME_RANGE, frame=frame_id, frames=1):
            return self._process_vi_pair(img_left, img_right, frame_id, t, acc, gyr, imu_t)

    def _process_vi_pair(self, img_left, img_right, frame_id, t, acc, gyr, imu_t):
        t = self._begin_frame(frame_id, t, acc, gyr, imu_t)
        cfg = self.cfg
        self._keep_image(img_left)
        with span(EXTRACTION_RANGE):
            pair = torch.stack([self._on_device(img_left, torch.float32),
                                self._on_device(img_right, torch.float32)])
            pyr, atlas = self._pyramid_atlas(pair)
            both = O.extract_from_atlas(atlas, **self._orb_args())
            feats, feats_r = (_frame(both, i) for i in range(2))
        with span(STEREO_RANGE):
            sm = match_stereo(
                feats, feats_r, tuple(p[0] for p in pyr), tuple(p[1] for p in pyr), bf=cfg.bf,
                baseline=cfg.bf / self.cam.fx, n_levels=cfg.n_levels,
                scale_factor=cfg.scale_factor,
                atlases=tuple(atlas._replace(image=atlas.image[i]) for i in range(2)))
        uvr = torch.where(sm.valid, sm.u_right, -1.0)
        depth = torch.where(sm.valid, sm.depth, -1.0)
        return self._after_frontend(feats, frame_id, t, uvr, depth)

    def _after_frontend(self, feats, frame_id, t, uvr, depth, xy_r=None):
        """A pair after its front end: the stereo initialisation, or tracking
        (visual until the IMU init, then visual-inertial with the visual
        tracker as the fallback) and the keyframe decision.  ``uvr``: the
        rectified right u per feature, or None; ``xy_r``: a fisheye rig's
        right pixel per feature, or None."""
        cfg = self.cfg
        if self.state == NOT_INITIALIZED:
            if uvr is None:
                uvr = torch.full((cfg.n_features,), -1.0, dtype=torch.float32,
                                 device=self.device)
            StereoSLAM._stereo_initialize(self, feats, frame_id, uvr, depth, xy_r=xy_r)
            if self.state == OK:
                self.kf_order, self.kf_times = [0], [t]
                self.kf_segments, self.seg_preints = [], []
                self.since_kf = _EMPTY
            self._cur_time = t
            return self.trajectory[-1] if self.trajectory else None
        if self.imu_stage == 0:
            self._track(feats, frame_id, uvr=uvr, depth=depth, xy_r=xy_r)
        else:
            Rcw, tcw, n_inl, mp_of_feat, _ = self._track_inertial(feats, frame_id, feat_uvr=uvr,
                                                                  feat_uv2=xy_r)
            if n_inl < cfg.min_tracked_points:
                self._track(feats, frame_id, uvr=uvr, depth=depth, xy_r=xy_r)
            else:
                self.state = OK
                self.frames_since_kf += 1
                self._record(frame_id, Rcw, tcw, n_inl)
                if self.keep_frame_overlay:
                    self._record_overlay(feats, mp_of_feat, frame_id)
                close_th = (cfg.bf / self.cam.fx) * cfg.th_depth
                close = (depth > 0) & (depth < close_th)
                tc, ntc = (int(c) for c in _pull(torch.sum((mp_of_feat >= 0) & close),
                                                 torch.sum((mp_of_feat < 0) & close)))
                if self._need_new_kf(n_inl, tracked_close=tc, nontracked_close=ntc):
                    self._insert_keyframe(feats, frame_id, Rcw, tcw, mp_of_feat, n_inl, uvr=uvr,
                                          depth=depth, xy_r=xy_r)
        self._try_imu_init(t)
        self._cur_time = t
        return self.trajectory[-1]

    # the visual batch machinery's hooks: the stereo ones, with the init and
    # fallback frames routed through the inertial ``process``
    def _process_one(self, frame, frame_id):
        t = getattr(self, "_frame_times", {}).get(frame_id)
        self.process(frame[0], frame[1], frame_id, t=t)

    def _init_consume(self, imgs, frame_ids):
        self._process_one(imgs[0], frame_ids[0])
        return 1

    def _batch_track(self, prep, vel, cm):
        return StereoSLAM._batch_track(self, prep, vel, cm)

    def _batch_retrack(self, rolled, aux_rolled, vel, cm):
        return StereoSLAM._batch_retrack(self, rolled, aux_rolled, vel, cm)

    def _prep_batch(self, frames, n_pad):
        return StereoSLAM._prep_batch(self, frames, n_pad)

    @staticmethod
    def _shown_image(frame):
        return frame[0]

    def process_batch(self, imgs, frame_ids, ts=None, acc=None, gyr=None, imu_t=None):
        """Track a batch of (left, right) pairs at times ``ts`` (default
        frame_id / fps), with the batch's IMU samples.

        Until the IMU is initialised, the visual stereo batch walk (the
        chain and the clock advance per committed frame, keyframes land on
        the chain), with the staged init checked at the batch's end.  Then
        one batched stereo front end and one :func:`vi_track_batch` dispatch
        over the batch; the host walks the per-frame outcomes in one copy
        and inserts keyframes (the remaining frames keep their results,
        computed against the pre-keyframe anchor, unless
        ``cfg.retrack_after_kf``)."""
        with span(FRAME_RANGE, frame=frame_ids[0] if len(frame_ids) else None,
                  frames=len(frame_ids)):
            return self._process_vi_batch(imgs, frame_ids, ts, acc, gyr, imu_t)

    def _process_vi_batch(self, imgs, frame_ids, ts, acc, gyr, imu_t):
        cfg = self.cfg
        if acc is not None:
            self.feed_imu(acc, gyr, imu_t)
        if ts is None:
            ts = [float(f) / cfg.fps for f in frame_ids]
        if self.state == NOT_INITIALIZED or self.imu_stage == 0:
            self._frame_times = dict(zip(frame_ids, ts))
            StereoSLAM.process_batch(self, imgs, frame_ids)
            self._cur_time = ts[-1]
            self._try_imu_init(ts[-1])
            return self.trajectory[-1] if self.trajectory else None

        B = len(imgs)
        ids, tss = list(frame_ids), list(ts)
        with span(VI_FRONTEND_RANGE):
            feats_all, uvr_all, depth_all = T.stereo_frontend_batch(
                StereoSLAM._prep_batch(self, imgs, 0), self.cam, cfg, bf=cfg.bf)
        # drain queued loop detections after the front end is enqueued: the
        # drain's copy waits only for the previous batch's tail
        self._frame_boundary()
        pos = 0
        shown = None  # the overlay of the last tracked frame, copied at the end
        while pos < B:
            if self.state == NOT_INITIALIZED or self.imu_stage == 0:
                # a reset mid-walk dropped the chain: the rest frame by frame
                for j in range(pos, B):
                    self.process(imgs[j][0], imgs[j][1], ids[j], t=tss[j])
                shown = None
                break
            anchor_slot = self.kf_order[-1]
            t_kf = self.kf_times[-1]
            # each frame's resampled span anchor -> frame, the next
            # uncommitted frame first (rolled dispatches keep B frames)
            spans = [self.imu.interval(t_kf, tss[pos + k]) for k in range(B - pos)]
            spans += [_EMPTY] * pos
            acc_d, gyr_d, dts_d, n_steps = _stack_segments(spans, False, _BATCH_PAD, self.device)
            if pos:
                feats_cur = O.FrameFeatures(*(torch.roll(f, -pos, dims=0) for f in feats_all))
                uvr_cur = torch.roll(uvr_all, -pos, dims=0)
                depth_cur = torch.roll(depth_all, -pos, dims=0)
            else:
                feats_cur, uvr_cur, depth_cur = feats_all, uvr_all, depth_all
            cm = torch.arange(B, device=self.device) < (B - pos)
            with span(VI_TRACK_RANGE):
                self.m, Rs, ts_d, n_inls, mp_feats, vels = vi_track_batch(
                    self.m, feats_cur, uvr_cur, anchor_slot, self.ki.vel[anchor_slot],
                    self.ki.bg[anchor_slot], self.ki.ba[anchor_slot], acc_d, gyr_d, dts_d,
                    n_steps, self.calib, self.cam, cfg, cfg.bf, cm)
                self._mp_remap = None  # fresh bindings against the current map
                close_th = (cfg.bf / self.cam.fx) * cfg.th_depth
                close = (depth_cur > 0) & (depth_cur < close_th)
                n_np, Rs_np, ts_np, tc_np, ntc_np = _pull(
                    n_inls, Rs, ts_d, torch.sum((mp_feats >= 0) & close, dim=1),
                    torch.sum((mp_feats < 0) & close, dim=1))
            k_kf = None
            inserted = False
            for k in range(B - pos):
                j = pos + k
                t_j = tss[j]
                self._cur_time = t_j
                nk = int(n_np[k])
                ok = nk >= cfg.min_tracked_points
                self._update_lost_state(ok)
                self.frames_since_kf += 1
                self._record(ids[j], Rs_np[k], ts_np[k], nk)
                if ok:
                    self.state = OK
                    self.cur_vel = vels[k]
                    if self.keep_frame_overlay:
                        shown = self._overlay_now(_frame(feats_cur, k), mp_feats[k], ids[j],
                                                  imgs[j])
                need = ok and self._need_new_kf(nk, tracked_close=int(tc_np[k]),
                                                nontracked_close=int(ntc_np[k]))
                # after a mid-dispatch keyframe the remaining inlier counts
                # reflect the pre-keyframe anchor: only the 0.5 s rule holds
                if need and inserted and self.kf_times and t_j - self.kf_times[-1] < 0.45:
                    need = False
                if need:
                    # the chain segment spans anchor -> this frame
                    self.since_kf = self.imu.interval(t_kf, t_j)
                    self.last_t = t_j
                    self._insert_keyframe(_frame(feats_cur, k), ids[j], Rs[k], ts_d[k],
                                          mp_feats[k], nk, uvr=uvr_cur[k], depth=depth_cur[k])
                    inserted = True
                    self._try_imu_init(t_j)
                    if cfg.retrack_after_kf and j + 1 < B:
                        k_kf = j
                        break
            pos = B if k_kf is None else k_kf + 1
        self._show_overlay(shown)
        # leave the incremental accumulators consistent for per-frame use
        if self.kf_times:
            self.since_kf = self.imu.interval(self.kf_times[-1], tss[-1])
        self.last_t = tss[-1]
        self._cur_time = tss[-1]
        return self.trajectory[-1]


class FisheyeStereoInertialSLAM(StereoInertialSLAM):
    """Non-rectified Kannala-Brandt stereo with an IMU, the TUM-VI gate
    configuration (reference ``IMU_STEREO`` with two ``KannalaBrandt8``
    cameras): the fisheye front end of :class:`..system.FisheyeStereoSLAM`
    (one atlas batch for the pair, the lapping-area match), its
    second-camera rows through the visual-inertial pose optimisation and
    the inertial chain BA, and the staged IMU init with the scale fixed.
    Needs what ``FisheyeStereoSLAM`` needs."""

    MIN_INIT_POINTS = 100  # the lapping overlap covers part of the frame

    def __init__(self, cfg: SlamConfig, device=None):
        super().__init__(cfg, device=device)
        FisheyeStereoSLAM._init_rig(self)

    def process(self, img_left, img_right, frame_id, t=None, acc=None, gyr=None, imu_t=None):
        """Feed one fisheye pair at time ``t`` with the IMU samples since the
        last frame."""
        with span(FRAME_RANGE, frame=frame_id, frames=1):
            t = self._begin_frame(frame_id, t, acc, gyr, imu_t)
            self._keep_image(img_left)
            feats, depth, uv2 = FisheyeStereoSLAM._fisheye_frontend(self, img_left, img_right)
            return self._after_frontend(feats, frame_id, t, None, depth, xy_r=uv2)

    def process_batch(self, imgs, frame_ids, ts=None, acc=None, gyr=None, imu_t=None):
        """The (left, right) pairs through :meth:`process` one after another
        (times ``ts``, default frame_id / fps), with the batch's IMU samples
        fed first: the fisheye front end has no batched dispatch."""
        with span(FRAME_RANGE, frame=frame_ids[0] if len(frame_ids) else None,
                  frames=len(frame_ids)):
            if acc is not None:
                self.feed_imu(acc, gyr, imu_t)
            if ts is None:
                ts = [float(f) / self.cfg.fps for f in frame_ids]
            for (left, right), fid, t in zip(imgs, frame_ids, ts):
                self.process(left, right, fid, t=t)
            return self.trajectory[-1] if self.trajectory else None
