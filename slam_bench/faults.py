"""Faults planted under a cell's timed path, each of which the cell's
comparison has to judge not correct.  ``plant(patcher, cell, name)`` swaps
the port's functions through ``patcher.setattr(obj, attr, value)`` (pytest's
``monkeypatch``, or :class:`Patcher`); the tests in ``tests/`` drive every
cell on the CPU with each fault, and ``control.py --faults`` reads them on
the card at the cell's own size.

Stereo cells, from the first window frame on unless said otherwise:

- ``state_unchanged``: the facade's step returns at once, from the start;
  no pose comes back.
- ``stale_pose``: every frame reports the pose of the frame before, so the
  reported pose stays where the warm-up left it, with the inliers counted;
  the tracker itself goes on from its true pose.
- ``predicted_pose``: tracking reports the motion model's prediction
  without optimising, with the inliers the optimisation counted; the facade
  predicts the next frame from it, so the velocity stays as the warm-up
  left it.
- ``half_batch``: half of each batch (every other frame live) left out.
- ``descriptor_altered``, ``depth_altered``, ``pose_altered``: a descriptor
  bit, 1% of every stereo depth, every frame's rotation turned 0.02 sin(frame
  id) rad altered where they are produced, from the start (a turn that
  differs from frame to frame, so that no lag of the relative pose error
  pairs two frames turned alike).

GBA cell: ``state_unchanged`` (the map handed back as it came in),
``half_batch`` (every other row left out), ``answer_altered`` (every
camera moved 1 cm).
"""

from __future__ import annotations

import numpy as np
import torch

STEREO = ("state_unchanged", "stale_pose", "predicted_pose", "half_batch",
          "descriptor_altered", "depth_altered", "pose_altered")
GBA = ("state_unchanged", "half_batch", "answer_altered")


class Patcher:
    """``setattr`` that remembers what it replaced; ``undo`` puts it back."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, attr: str, value) -> None:
        self.saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def undo(self) -> None:
        while self.saved:
            obj, attr, value = self.saved.pop()
            setattr(obj, attr, value)


def plant(patcher, cell, name: str, start: int | None = None) -> None:
    """Plant fault ``name`` under ``cell``'s timed path; a stereo fault that
    begins at the window begins at frame ``start`` where it is given."""
    if cell.traffic["driver"] == "gba":
        _gba(patcher, name)
    else:
        _stereo(patcher, name, start=1 + cell.traffic["warm_frames"] if start is None else start)


def _stereo(mp, fault: str, start: int) -> None:
    from orb_slam3_noted_tpu_torch.ops import orb
    from orb_slam3_noted_tpu_torch.pipeline import system, tracking

    S = system.StereoSLAM
    if fault == "state_unchanged":
        mp.setattr(S, "process_batch", lambda self, imgs, ids: None)
        mp.setattr(S, "_track", lambda self, feats, frame_id, **kw: None)
    elif fault == "stale_pose":
        inner_r = S._record

        def stale(self, frame_id, Rcw, tcw, n_inl, ref_pose=None):
            if frame_id < start or not self.trajectory:
                return inner_r(self, frame_id, Rcw, tcw, n_inl, ref_pose=ref_pose)
            last = self.trajectory[-1]
            inner_r(self, frame_id, last.Rcw, last.tcw, n_inl, ref_pose=ref_pose)
            self.last_Rcw, self.last_tcw = Rcw, tcw  # the tracker's own state stays true

        mp.setattr(S, "_record", stale)
    elif fault == "predicted_pose":
        on = {"now": False}
        inner_b, inner_p, inner_t = S.process_batch, S.process, tracking.track_frame

        def batch(self, imgs, ids):
            on["now"] = ids[0] >= start
            return inner_b(self, imgs, ids)

        def frame(self, left, right, frame_id):
            on["now"] = frame_id >= start
            return inner_p(self, left, right, frame_id)

        def predicted(m, feats, Rp, tp, *a, **kw):
            out = inner_t(m, feats, Rp, tp, *a, **kw)
            return (Rp, tp, *out[2:]) if on["now"] else out

        mp.setattr(S, "process_batch", batch)
        mp.setattr(S, "process", frame)
        mp.setattr(tracking, "track_frame", predicted)
    elif fault == "half_batch":
        inner_b, inner_p = S.process_batch, S.process
        mp.setattr(S, "process_batch",
                   lambda self, imgs, ids: inner_b(self, imgs[:len(imgs) // 2],
                                                   ids[:len(ids) // 2]))
        mp.setattr(S, "process", lambda self, l, r, i: None if i % 2 else inner_p(self, l, r, i))
    elif fault == "descriptor_altered":
        inner_x = orb.extract_from_atlas
        mp.setattr(orb, "extract_from_atlas",
                   lambda *a, **kw: (lambda f: f._replace(desc=f.desc ^ 1))(inner_x(*a, **kw)))
    elif fault == "depth_altered":
        for mod in (system, tracking):
            inner_m = mod.match_stereo

            def scaled(*a, _inner=inner_m, **kw):
                sm = _inner(*a, **kw)
                return sm._replace(depth=torch.where(sm.valid, sm.depth * 1.01, sm.depth))

            mp.setattr(mod, "match_stereo", scaled)
    elif fault == "pose_altered":
        inner_r = S._record

        def turned(self, frame_id, Rcw, tcw, n_inl, ref_pose=None):
            a = 0.02 * np.sin(frame_id)
            turn = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                             [-np.sin(a), 0.0, np.cos(a)]])
            R = np.asarray(Rcw.cpu() if isinstance(Rcw, torch.Tensor) else Rcw, np.float64)
            return inner_r(self, frame_id, (turn @ R).astype(np.float32), tcw, n_inl,
                           ref_pose=ref_pose)

        mp.setattr(S, "_record", turned)
    else:
        raise ValueError(f"unknown stereo fault {fault!r}")


def _gba(mp, fault: str) -> None:
    from orb_slam3_noted_tpu_torch.optim import gba as G

    inner = G.global_bundle_adjust
    if fault == "state_unchanged":
        def same(cam, prob, **kw):
            res = inner(cam, prob, **kw)
            return res._replace(Rcw=prob.Rcw, tcw=prob.tcw, points=prob.points)

        mp.setattr(G, "global_bundle_adjust", same)
    elif fault == "half_batch":
        def half(cam, prob, **kw):
            keep = torch.arange(len(prob.obs.valid), device=prob.obs.valid.device) % 2 == 0
            return inner(cam, prob._replace(obs=prob.obs._replace(valid=prob.obs.valid & keep)),
                         **kw)

        mp.setattr(G, "global_bundle_adjust", half)
    elif fault == "answer_altered":
        def moved(cam, prob, **kw):
            res = inner(cam, prob, **kw)
            return res._replace(tcw=res.tcw + torch.tensor([0.01, 0.0, 0.0],
                                                           device=res.tcw.device))

        mp.setattr(G, "global_bundle_adjust", moved)
    else:
        raise ValueError(f"unknown GBA fault {fault!r}")
