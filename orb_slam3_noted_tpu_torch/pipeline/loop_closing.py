"""Loop detection and correction (port of :mod:`orb_slam3_noted_tpu.pipeline.loop_closing`).

The reference's LoopClosing thread: BoW candidates from the keyframe
database (``DetectNBestCandidates``), temporal consistency, the Sim(3)
verification ladder (RANSAC, ``SearchBySim3``, ``OptimizeSim3``) and the
correction (``CorrectLoop``): the corrected Sim(3) spread through the
essential graph by a pose-graph optimisation, map points re-anchored through
their reference keyframes, a deferred SearchAndFuse and a time-sliced global
BA.

Detection is split in two: ``start_detect`` enqueues the device work of a
new keyframe and reads nothing back; ``finish_detect_many`` drains the
queue at a frame boundary with one copy of every queued detection's winners
and covisibility rows.  The ladder reads back once per step.  The RANSAC
minimal sets come from :meth:`LoopCloser._sim3_sets` (a ``torch.Generator``
on the database's device seeded with the keyframe's slot, as the JAX
package seeds its key), where tests hand in the JAX package's draws.

In a gravity-aligned inertial map (``imu_stage >= 1``) the correction runs
the 4-DoF graph (yaw and translation, ``OptimizeEssentialGraph4DoF``),
rotates the keyframes' body velocities with their corrections and runs
FullInertialBA over the chain instead of a global BA.

Inside an initialised ``torch.distributed`` group of more than one rank
(where the JAX package sees more than one device) the Sim(3) graph is
split over the group's ranks (``distributed_pose_graph_sim3``) and the GBA
runs at once, sharded (``run_global_ba_mesh``, 6 + 4 LM steps), in place of
the ``SlicedGBA``.  Every rank runs the same SLAM on the same input, so the
ranks reach each collective together; the 4-DoF graph and the inertial
chain BA stay on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.geometry import sim3
from orb_slam3_noted_tpu_torch.geometry import twoview as TV
from orb_slam3_noted_tpu_torch.geometry.sim3_solver import N_HYP, Sim3Result, sim3_ransac
from orb_slam3_noted_tpu_torch.ops import matching as M
from orb_slam3_noted_tpu_torch.optim.gba import SlicedGBA, run_global_ba_mesh
from orb_slam3_noted_tpu_torch.geometry import se3
from orb_slam3_noted_tpu_torch.optim.pose_graph import (
    SE3Edges,
    Sim3Edges,
    distributed_pose_graph_sim3,
    optimize_pose_graph_4dof,
    optimize_pose_graph_sim3,
)
from orb_slam3_noted_tpu_torch.parallel.dist_ba import group_size, make_mesh
from orb_slam3_noted_tpu_torch.optim.sim3_opt import sim3_refine
from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
from orb_slam3_noted_tpu_torch.pipeline import tracking as T
from orb_slam3_noted_tpu_torch.place.database import KeyFrameDatabase, _detect_nbest
from orb_slam3_noted_tpu_torch.utils.interop import pull
from orb_slam3_noted_tpu_torch.utils.timing import span

# spans (``utils.timing.span``: with nothing recording, a flag check): a correction, and
# inside detection and correction the steps of the ladder and the pose graph
# (with its write-back); GBA's merge is ``gba.MERGE_RANGE``
CORRECT_RANGE = "loop_correct"
RANSAC_RANGE = "loop_ransac"
REFINE_RANGE = "loop_refine"
POSE_GRAPH_RANGE = "loop_pose_graph"


def _matched_point_pairs(m, slot_cur: int, slot_cand: int):
    """3D-3D pairs from mutual descriptor matches between two keyframes'
    bound map points, each in its keyframe's camera frame (as the
    reference's Sim3Solver takes them).  Returns (x_cand, x_cur, ok,
    cand index per current feature), each of length NF."""
    d = M.hamming_matrix(m.kf_desc[slot_cur], m.kf_desc[slot_cand])
    gate = ((m.kf_mp[slot_cur] >= 0) & m.kf_feat_valid[slot_cur])[:, None] & (
        (m.kf_mp[slot_cand] >= 0) & m.kf_feat_valid[slot_cand])[None, :]
    masked = torch.where(gate, d, M.BIG)
    best = torch.amin(masked, dim=1)
    idx = torch.argmin(masked, dim=1)
    best_back = torch.argmin(masked, dim=0)
    ok = (best <= M.TH_LOW) & (best_back[idx] == torch.arange(d.shape[0], device=d.device))
    mp_cur = m.kf_mp[slot_cur].clamp(min=0).long()
    mp_cand = m.kf_mp[slot_cand][idx].clamp(min=0).long()
    x_cur = m.mp_pos[mp_cur] @ m.kf_Rcw[slot_cur].T + m.kf_tcw[slot_cur]
    x_cand = m.mp_pos[mp_cand] @ m.kf_Rcw[slot_cand].T + m.kf_tcw[slot_cand]
    ok = ok & m.mp_valid[mp_cur] & m.mp_valid[mp_cand]
    return x_cand, x_cur, ok, idx.to(torch.int32)


def _apply_correction(m, R_new, t_new, s_new):
    """Write the corrected Sim(3) keyframe poses, Tcw = [R | t / s], and
    re-anchor every map point through its reference keyframe:
    x_new = S_new_ref^-1 (T_old_ref x)."""
    ref = m.mp_ref_kf.long()
    x_ref = torch.einsum("nij,nj->ni", m.kf_Rcw[ref], m.mp_pos) + m.kf_tcw[ref]
    x_new = torch.einsum("nji,nj->ni", R_new[ref], x_ref - t_new[ref]) / s_new[ref][:, None]
    return m._replace(
        kf_Rcw=torch.where(m.kf_valid[:, None, None], R_new, m.kf_Rcw),
        kf_tcw=torch.where(m.kf_valid[:, None], t_new / s_new[:, None], m.kf_tcw),
        mp_pos=torch.where(m.mp_valid[:, None], x_new, m.mp_pos),
    )


def _scale_fixed(slam) -> bool:
    """Reference ``mbFixScale``: scale is observable with metric depth
    (stereo, RGB-D: ``bf > 0``) and in inertial maps once the IMU is
    initialised; their loop Sim(3) and essential graph run at 6 DoF."""
    cfg = getattr(slam, "cfg", None)
    if cfg is not None and getattr(cfg, "bf", 0.0) > 0:
        return True
    return getattr(slam, "imu_stage", 0) >= 1


class LoopCloser:
    """Loop-closing stage over the facade's map, on the database's device
    (the card unless the caller names another)."""

    def __init__(self, vocab: np.ndarray, max_keyframes: int, min_inliers: int = 25,
                 covis_edge_weight: int = 30, exclude_recent: int = 10, enable_gba: bool = True,
                 consistency_th: int = 3, idf: np.ndarray | None = None, device=None):
        self.db = KeyFrameDatabase(vocab, max_keyframes, idf=idf, device=device)
        self.device = self.db.device
        self.min_inliers = min_inliers
        # gate after OptimizeSim3 (reference nInliers >= 20)
        self.sim3_min_inliers = 20
        self.covis_edge_weight = covis_edge_weight
        self.exclude_recent = exclude_recent
        self.enable_gba = enable_gba
        # consecutive covisibility-consistent detections a candidate needs
        # (reference mnCovisibilityConsistencyTh = 3)
        self.consistency_th = consistency_th
        self.consistent_groups: list[tuple[set, int]] = []
        self.loops_closed = 0
        self.last_loop_kf = -1
        # accepted loops stay pose-graph edges in every later correction
        # (reference KeyFrame::AddLoopEdge)
        self.loop_edges: list[tuple[int, int]] = []
        self.active_gba = None      # in-flight SlicedGBA, advanced by service_gba
        self._post_fuse: list[int] = []  # deferred SearchAndFuse targets
        # a verified hypothesis not yet accepted: the next keyframe refines
        # it by projection (DetectAndReffineSim3FromLastKF)
        self.pending = None  # dict(cand, slot, R, t, s, hits)

    def _sim3_sets(self, valid: torch.Tensor, slot: int) -> torch.Tensor:
        """(N_HYP, 3) RANSAC minimal sets of distinct valid pairs, from a
        generator on the database's device seeded with the keyframe's slot."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(slot))
        return TV.sample_minimal_sets(valid, N_HYP, g, size=3)

    # ------------------------------------------------------------------
    def service_gba(self, slam, n_steps: int = 1) -> bool:
        """One slice of the deferred work after a correction: a queued
        SearchAndFuse first, else the in-flight GBA's next LM steps.  True
        when a GBA finished and was merged."""
        if self._post_fuse:
            target = self._post_fuse.pop(0)
            mask, _ = MS.local_map_mask(slam.m, target, n_neighbors=5)
            slam.m = T.fuse_map_points(slam.m, target, slam.m.mp_valid & ~mask, slam.cam,
                                       slam.cfg)
            return False
        g = self.active_gba
        if g is None:
            return False
        for _ in range(n_steps):
            if g.done:
                break
            g.step()
        if g.done:
            slam.m = g.finish(slam.m)
            self.active_gba = None
            return True
        return False

    def finish_gba(self, slam) -> bool:
        """Drain the deferred fuses and the in-flight GBA completely."""
        while self._post_fuse:
            self.service_gba(slam)
        if self.active_gba is not None:
            slam.m = self.active_gba.finish(slam.m)
            self.active_gba = None
            return True
        return False

    # ------------------------------------------------------------------
    def on_keyframe(self, slam, slot: int) -> bool:
        """Detect and correct a loop for the new keyframe ``slot`` (both
        halves at once).  True if a loop was closed."""
        return self.finish_detect(slam, self.start_detect(slam, slot))

    def start_detect(self, slam, slot: int) -> dict:
        """Enqueue the detection of keyframe ``slot`` on the device: its BoW
        vector, the covisibility matrix and ``DetectNBestCandidates``, which
        excludes the covisible and the most recent keyframes.  Reads nothing
        back; the keyframe joins the database."""
        m = slam.m
        _, bow = self.db.compute_bow(m.kf_desc[slot], m.kf_feat_valid[slot])
        covis = MS.covisibility_matrix(m)
        # recency by frame id from the facade's host mirror (robust to slot
        # recycling), else by slot order
        fid_mirror = getattr(slam, "kf_frame_ids", None)
        KF = self.db.bow_mat.shape[0]
        recent = np.zeros(KF, bool)
        if fid_mirror is not None:
            fids = np.asarray(fid_mirror)
            live = fids >= 0
            order = np.sort(fids[live])
            if len(order):
                min_recent = order[max(0, len(order) - self.exclude_recent - 1)]
                recent = live & (fids >= min_recent)
        else:
            recent[max(0, slot - self.exclude_recent): slot + 1] = True
        recent[slot] = True
        exclude = (covis[slot] > 0) | torch.from_numpy(recent).to(self.device)
        slots, scores = _detect_nbest(self.db.bow_mat, self.db.present_dev, bow, exclude, covis,
                                      0.75, 3)
        self.db.add(slot, bow)
        return {"slot": slot, "covis": covis, "slots": slots, "scores": scores}

    def finish_detect(self, slam, pending: dict) -> bool:
        return self.finish_detect_many(slam, [pending])

    def finish_detect_many(self, slam, pendings: list) -> bool:
        """Finish queued detections with one device-to-host copy of their
        winners, their covisibility matrices and ``kf_valid``; then the
        consistency groups and the verification ladder per detection.  True
        if a loop was closed."""
        pulled = pull(*[x for p in pendings for x in (p["slots"], p["covis"])],
                       slam.m.kf_valid)
        kf_valid = pulled[-1]
        # keep the database in step with keyframe culling (KeyFrameDatabase::erase)
        for s in np.flatnonzero(self.db.present & ~kf_valid):
            self.db.erase(int(s))
        if hasattr(slam, "_refill_free_slots"):
            slam._refill_free_slots(kf_valid)
        closed = False
        for k, p in enumerate(pendings):
            closed |= self._finish_one(slam, p["slot"], pulled[2 * k], pulled[2 * k + 1],
                                       kf_valid)
        return closed

    def _finish_one(self, slam, slot, slots_np, covis_np, kf_valid) -> bool:
        m = slam.m
        # the temporal path: a pending verified hypothesis is refined by
        # projection from its propagated Sim(3), without BoW or RANSAC
        if self.pending is not None and kf_valid[self.pending["cand"]]:
            hit = self._refine_pending(slam, slot)
            if hit is not None:
                return hit
        self.pending = None

        slots = [int(s) for s in slots_np[slots_np >= 0] if kf_valid[int(s)]]
        if not slots:
            self.consistent_groups = []
            return False
        covis_rows = covis_np[np.asarray(slots)]
        # temporal consistency: a place must be detected again in consecutive
        # keyframes (groups linked by covisibility); with camera context the
        # last hit is the geometric temporal path instead
        have_cam = getattr(slam, "cam", None) is not None and getattr(slam, "cfg", None) is not None
        geo_gate = self.consistency_th - 1 if have_cam else self.consistency_th
        new_groups: list[tuple[set, int]] = []
        verified: list[int] = []
        for ci, cand in enumerate(slots):
            grp = set(np.flatnonzero(covis_rows[ci] > 0).tolist()) | {cand}
            count = 0
            for prev_grp, prev_count in self.consistent_groups:
                if grp & prev_grp:
                    count = max(count, prev_count + 1)
            new_groups.append((grp, count))
            if count >= geo_gate:
                verified.append(cand)
        self.consistent_groups = new_groups
        if not verified:
            return False

        fix_scale = _scale_fixed(slam)
        for cand in verified:
            with span(RANSAC_RANGE):
                x_cand, x_cur, ok, idx_cand = _matched_point_pairs(m, slot, cand)
                res = sim3_ransac(x_cand, x_cur, ok, self._sim3_sets(ok, slot),
                                  fix_scale=fix_scale)
            if have_cam:
                # the ladder: Sim(3)-guided projection matching grows the
                # pairs, the reprojection optimisation refines and gates them
                with span(REFINE_RANGE):
                    ref = sim3_refine(m, slot, cand, res.R, res.t, res.s, slam.cam, slam.cfg,
                                      seed_idx=idx_cand, seed_ok=ok & res.inliers)
                    n_ok, success, n_inl, rn_inl = pull(torch.sum(ok), res.success,
                                                         res.n_inliers, ref.n_inliers)
                if (int(n_ok) < self.min_inliers or not bool(success)
                        or int(n_inl) < self.min_inliers or int(rn_inl) < self.sim3_min_inliers):
                    continue
                res = Sim3Result(success=res.success, R=ref.R, t=ref.t, s=ref.s,
                                 inliers=res.inliers, n_inliers=ref.n_inliers)
                if 1 < max(self.consistency_th - 1, 1):
                    # verified, not yet ripe: the next keyframe confirms by projection
                    self.pending = dict(cand=cand, slot=slot, R=res.R, t=res.t, s=res.s, hits=1)
                    return False
            else:
                n_ok, success, n_inl = pull(torch.sum(ok), res.success, res.n_inliers)
                if int(n_ok) < self.min_inliers or not bool(success) or int(n_inl) < self.min_inliers:
                    continue
            self._accept(slam, slot, cand, res, covis_np)
            return True
        return False

    def _accept(self, slam, slot, cand, res, covis=None):
        """Run the correction and record the accepted loop."""
        with span(CORRECT_RANGE):
            self._correct(slam, slot, cand, res, covis=covis)
        self.loop_edges.append((slot, cand))
        self.loops_closed += 1
        self.last_loop_kf = slot
        self.consistent_groups = []
        self.pending = None

    def _refine_pending(self, slam, slot):
        """``DetectAndReffineSim3FromLastKF``: refine the pending hypothesis
        against keyframe ``slot`` by projection through the Sim(3) propagated
        by the relative motion since its keyframe.  True: accepted and
        corrected; False: advanced; None: the refinement failed (the caller
        falls back to the BoW path)."""
        cam = getattr(slam, "cam", None)
        cfg = getattr(slam, "cfg", None)
        if cam is None or cfg is None:
            return None
        m = slam.m
        p = self.pending
        # S_new = (T_new o T_prev^-1) o S_prev
        Rn, tn = m.kf_Rcw[slot], m.kf_tcw[slot]
        Rp, tp = m.kf_Rcw[p["slot"]], m.kf_tcw[p["slot"]]
        R_rel = Rn @ Rp.T
        t_rel = tn - R_rel @ tp
        Rg, tg, sg = sim3.compose((R_rel, t_rel, torch.ones((), dtype=tn.dtype, device=tn.device)),
                                  (p["R"], p["t"], p["s"]))
        with span(REFINE_RANGE):
            ref = sim3_refine(m, slot, p["cand"], Rg, tg, sg, cam, cfg)
            (n_inl,) = pull(ref.n_inliers)
        if int(n_inl) < self.sim3_min_inliers:
            return None
        hits = p["hits"] + 1
        res = Sim3Result(success=torch.ones((), dtype=torch.bool, device=tn.device), R=ref.R,
                         t=ref.t, s=ref.s,
                         inliers=torch.zeros(m.kf_xy.shape[1], dtype=torch.bool, device=tn.device),
                         n_inliers=ref.n_inliers)
        if hits >= max(self.consistency_th - 1, 1):
            self._accept(slam, slot, p["cand"], res)
            return True
        self.pending = dict(cand=p["cand"], slot=slot, R=res.R, t=res.t, s=res.s, hits=hits)
        return False

    # ------------------------------------------------------------------
    def _correct(self, slam, slot: int, cand: int, res, covis=None):
        """``CorrectLoop``: the essential graph (spanning tree, strong
        covisibility, every accepted loop, this loop), the Sim(3) pose graph
        (the 4-DoF graph in an inertial map) with ``cand`` fixed, the
        corrected poses and points written back, SearchAndFuse queued on
        both loop keyframes, a ``SlicedGBA`` started (FullInertialBA over the
        chain in an inertial map; inside a group of ranks the graph and a
        synchronous GBA sharded over them), and the last tracked pose re-anchored
        through ``slot``'s correction."""
        inertial_4dof = getattr(slam, "imu_stage", 0) >= 1
        m = slam.m
        KF = m.kf_Rcw.shape[0]
        dev = m.kf_tcw.device
        if covis is None:
            kf_valid, parent, covis = pull(m.kf_valid, m.kf_parent, MS.covisibility_matrix(m))
        else:
            kf_valid, parent = pull(m.kf_valid, m.kf_parent)
        child = np.flatnonzero((parent >= 0) & kf_valid & kf_valid[np.maximum(parent, 0)])
        ei, ej = list(child.astype(int)), list(parent[child].astype(int))
        ii, jj = np.nonzero(np.triu(np.asarray(covis)) >= self.covis_edge_weight)
        keep = kf_valid[ii] & kf_valid[jj]
        ei += list(ii[keep].astype(int))
        ej += list(jj[keep].astype(int))
        for a, b in self.loop_edges:
            if kf_valid[a] and kf_valid[b]:
                ei.append(a)
                ej.append(b)
        n_real = len(ei)

        # measurements from the current (drifted) estimates: S_ji = T_j T_i^-1;
        # the loop edge is S_cur_cand from the ladder
        R_all, t_all = m.kf_Rcw, m.kf_tcw
        s_all = torch.ones(KF, dtype=t_all.dtype, device=dev)
        ij = torch.from_numpy(np.asarray([ei + [cand], ej + [slot]], np.int64)).to(dev)
        i_e, j_e = ij[0, :-1], ij[1, :-1]
        # edge weights (the loop edge counts n/4 + 1) and the fixed vertices
        # (the candidate, and invalid slots to keep H regular), in one copy
        host = np.ones(n_real + 1 + KF, np.float32)
        host[n_real] = float(n_real) / 4 + 1.0
        host[n_real + 1:] = ~kf_valid
        host[n_real + 1 + cand] = 1.0
        wf = torch.from_numpy(host).to(dev)
        valid = torch.ones(n_real + 1, dtype=torch.bool, device=dev)
        with span(POSE_GRAPH_RANGE):
            if inertial_4dof:
                # yaw + translation: a Sim(3)/SE(3) graph would let the
                # correction tilt the gravity direction the IMU made
                # observable; the loop Sim(3) ran with the scale fixed
                Rr, tr = se3.compose((R_all[j_e], t_all[j_e]), se3.inverse((R_all[i_e], t_all[i_e])))
                edges = SE3Edges(
                    i=ij[0].to(torch.int32), j=ij[1].to(torch.int32),
                    R=torch.cat([Rr, res.R[None]]), t=torch.cat([tr, (res.t / res.s)[None]]),
                    weight=wf[:n_real + 1], valid=valid)
                R_new, t_new, _ = optimize_pose_graph_4dof(R_all, t_all, edges,
                                                           wf[n_real + 1:] > 0)
                s_new = s_all
            else:
                Rr, tr, sr = sim3.compose((R_all[j_e], t_all[j_e], s_all[j_e]),
                                          sim3.inverse((R_all[i_e], t_all[i_e], s_all[i_e])))
                edges = Sim3Edges(
                    i=ij[0].to(torch.int32), j=ij[1].to(torch.int32),
                    R=torch.cat([Rr, res.R[None]]), t=torch.cat([tr, res.t[None]]),
                    s=torch.cat([sr, res.s.reshape(1)]), weight=wf[:n_real + 1], valid=valid)
                graph = (R_all, t_all, s_all, edges, wf[n_real + 1:] > 0)
                if group_size() > 1:
                    R_new, t_new, s_new, _ = distributed_pose_graph_sim3(
                        make_mesh(device=dev), *graph, fix_scale=_scale_fixed(slam))
                else:
                    R_new, t_new, s_new, _ = optimize_pose_graph_sim3(
                        *graph, fix_scale=_scale_fixed(slam))
            slam.m = _apply_correction(m, R_new, t_new, s_new)

        if inertial_4dof and getattr(slam, "ki", None) is not None:
            # the keyframes' body velocities turn with their corrections:
            # world vectors transform by R_new^T R_old
            Rdelta = torch.einsum("kji,kjl->kil", R_new, R_all)
            vel_rot = torch.einsum("kij,kj->ki", Rdelta, slam.ki.vel)
            slam.ki = slam.ki._replace(
                vel=torch.where(m.kf_valid[:, None], vel_rot, slam.ki.vel))
            slam.cur_vel = slam.ki.vel[slot]

        cfg = getattr(slam, "cfg", None)
        if cfg is not None:
            # SearchAndFuse, one dispatch per frame boundary (service_gba)
            self._post_fuse.extend([cand, slot])
        if inertial_4dof and hasattr(slam, "_chain_ba"):
            # an inertial map: FullInertialBA over the chain, not a visual GBA
            # that would drag poses off the gravity-consistent solution
            slam._chain_ba(window=None, n_iters=8)
        elif self.enable_gba and cfg is not None and group_size() > 1:
            # the ranks of a group run the GBA at once, sharded
            slam.m, _ = run_global_ba_mesh(slam.m, slam.cam, cfg, make_mesh(device=dev),
                                           bf=cfg.bf, n_iters=6, n_iters_final=4)
        elif self.enable_gba and cfg is not None:
            # the reference's GBA thread: one LM slice per frame boundary
            self.active_gba = SlicedGBA(slam.m, slam.cam, cfg, bf=cfg.bf, n_iters=6,
                                        n_iters_final=4)
        # tracking continues from the last tracked frame re-anchored through
        # the loop keyframe's correction:
        # T_last_new = (T_last_old o T_kf_old^-1) o T_kf_new
        last_R, last_t = (torch.as_tensor(x, dtype=t_all.dtype).to(dev)
                          for x in (slam.last_Rcw, slam.last_tcw))
        R_rel = last_R @ R_all[slot].T
        t_rel = last_t - R_rel @ t_all[slot]
        slam.last_Rcw = R_rel @ slam.m.kf_Rcw[slot]
        slam.last_tcw = R_rel @ slam.m.kf_tcw[slot] + t_rel
