"""Inertial multi-map (port of :mod:`orb_slam3_noted_tpu.pipeline.inertial_atlas`):
an Atlas merge that carries velocities, biases and the IMU temporal chain
through the weld.

The reference's inertial merge, ``LoopClosing::MergeLocal2`` with
``Optimizer::MergeInertialBA``:

- When both maps are IMU-initialised their worlds are gravity-aligned, so
  the merge transform is 4-DoF: the RANSAC runs with the scale fixed, and
  the world-to-world rotation is projected onto yaw (about the gravity
  axis, z); a full rotation would tilt one map's gravity.  The JAX package
  projects the RANSAC's camera-to-camera rotation instead, about the
  camera's optical axis, which leaves the world transform tilted (29 deg on
  ``chip_smoke.py``'s inertial lap); the port projects the world transform
  (ROADMAP Queue 3).
- The per-keyframe velocity and bias tables move into the merged slot
  space; velocities rotate (and scale, for a map not yet initialised) with
  the world transform.
- The two IMU chains are joined by one INVALID junction segment (no IMU
  data spans the gap between the maps' recording intervals); the chain BA
  skips inertial factors across it (``seg_valid``).
- Welding: the visual local BA of the base class, then a windowed inertial
  BA around the junction (the ``MergeInertialBA`` analogue).

As in the JAX package, an inertial reset on a timestamp jump calls a
``_store_active_map`` hook that no class defines, so such a reset drops the
map instead of storing it in the Atlas (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.imu.preintegration import Bias
from orb_slam3_noted_tpu_torch.pipeline import inertial_mapping as IMAP
from orb_slam3_noted_tpu_torch.pipeline.atlas import AtlasSLAM
from orb_slam3_noted_tpu_torch.pipeline.inertial_system import MonoInertialSLAM
from orb_slam3_noted_tpu_torch.pipeline.system import _np


def yaw_only(R: np.ndarray) -> np.ndarray:
    """The rotation about +z (the gravity axis) closest to R."""
    yaw = np.arctan2(R[1, 0] - R[0, 1], R[0, 0] + R[1, 1])
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], R.dtype)


class InertialAtlasSLAM(AtlasSLAM):
    """Multi-map wrapper for the visual-inertial systems."""

    def __init__(self, cfg, base_cls=MonoInertialSLAM, device=None):
        super().__init__(cfg, base_cls=base_cls, fix_scale=False, device=device)
        self._metric_weld = False  # set per merge: both maps IMU-initialised

    # ------------------------------------------------------------------
    def _switch_map(self):
        a = self.active
        n_before = len(self.stored)
        super()._switch_map()
        if len(self.stored) > n_before:
            self.stored[-1].inertial = dict(
                ki=a.ki, kf_order=list(a.kf_order), kf_times=list(a.kf_times),
                kf_segments=list(a.kf_segments), seg_preints=list(a.seg_preints),
                seg_ok=list(a.seg_ok), imu_stage=a.imu_stage, bias=a.bias)

    # ------------------------------------------------------------------
    def _try_merge(self):
        # metric maps merge with the scale fixed (MergeLocal2 is a 4-DoF
        # weld); maps not yet initialised still estimate it
        self.fix_scale = self.active.imu_stage >= 1
        return super()._try_merge()

    # ------------------------------------------------------------------
    def _merge_transform(self, st, slot, cand, res):
        """The base class's world transform; between two gravity-aligned
        worlds its yaw and translation at scale 1."""
        Rw, tw, sw = super()._merge_transform(st, slot, cand, res)
        if not self._metric_weld:
            return Rw, tw, sw
        return torch.from_numpy(yaw_only(_np(Rw))).to(Rw), tw, torch.ones_like(sw)

    def _do_merge(self, st, si, slot, cand, res):
        a = self.active
        old_inertial = st.inertial
        self._metric_weld = (a.imu_stage >= 1 and old_inertial is not None
                             and old_inertial["imu_stage"] >= 1)

        # the chain's state before the base class rewires the active system
        new_order = list(a.kf_order)
        new_times = list(a.kf_times)
        new_segments = list(a.kf_segments)
        new_preints = list(a.seg_preints)
        new_seg_ok = list(a.seg_ok)
        new_ki = a.ki
        new_stage = a.imu_stage

        # the world transform the base merge applies to the new map
        Rw, _, sw = self._merge_transform(st, slot, cand, res)
        if not super()._do_merge(st, si, slot, cand, res):
            return False
        kf_off = a.last_kf_slot - slot

        # --- weld the inertial state ---
        if old_inertial is None:
            # the old map had no chain: keep the new one, shifted
            a.kf_order = [kf_off + s_ for s_ in new_order]
            a.kf_times = new_times
            a.kf_segments = new_segments
            a.seg_preints = new_preints
            a.seg_ok = new_seg_ok
        else:
            a.kf_order = list(old_inertial["kf_order"]) + [kf_off + s_ for s_ in new_order]
            a.kf_times = list(old_inertial["kf_times"]) + new_times
            empty = (np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,)))
            a.kf_segments = list(old_inertial["kf_segments"]) + [empty] + new_segments
            junction = new_preints[0] if new_preints else old_inertial["seg_preints"][0]
            a.seg_preints = list(old_inertial["seg_preints"]) + [junction] + new_preints
            a.seg_ok = list(old_inertial["seg_ok"]) + [False] + new_seg_ok
        a.imu_stage = max(new_stage, old_inertial["imu_stage"] if old_inertial else 0)

        # velocity and bias tables: the old entries at their slots, the new
        # ones shifted by kf_off with world-rotated (and scaled) velocities
        KF = a.m.kf_Rcw.shape[0]
        dev = a.m.kf_Rcw.device
        vel, bg, ba = (torch.zeros((KF, 3), dtype=torch.float32, device=dev) for _ in range(3))
        if old_inertial is not None:
            o = torch.tensor(old_inertial["kf_order"], dtype=torch.long, device=dev)
            ok_i = old_inertial["ki"]
            vel[o], bg[o], ba[o] = ok_i.vel[o], ok_i.bg[o], ok_i.ba[o]
        n = torch.tensor(new_order, dtype=torch.long, device=dev)
        vel[n + kf_off] = sw * (new_ki.vel[n] @ Rw.T)
        bg[n + kf_off] = new_ki.bg[n]
        ba[n + kf_off] = new_ki.ba[n]
        a.ki = IMAP.KFInertial(vel=vel, bg=bg, ba=ba)
        last = a.kf_order[-1]
        a.bias = Bias(a.ki.bg[last], a.ki.ba[last])
        a.cur_vel = a.ki.vel[last]

        # the MergeInertialBA analogue around the junction
        if a.imu_stage >= 1 and len(a.kf_order) >= 3:
            a._chain_ba(window=self.cfg.inertial_window)
        return True
