"""Sim(3) refinement for loop verification (port of :mod:`orb_slam3_noted_tpu.optim.sim3_opt`).

The verification ladder after Sim(3) RANSAC (``LoopClosing::
DetectCommonRegionsFromBoW``):

1. ``ORBmatcher::SearchBySim3``: grow the pair set by projecting each
   keyframe's map points into the other through the candidate Sim(3), both
   directions, keeping the pairs on which both agree;
2. ``Optimizer::OptimizeSim3``: Gauss-Newton on the 7-dof Sim(3) over the
   two-sided reprojection error, Huber sqrt(10), outliers dropped between
   rounds;
3. the caller accepts with >= 20 inliers after the optimisation.

Both matching directions are masked Hamming matrices with window gates
(``matching.hamming_matrix``, the port's one Hamming form); the Gauss-Newton
loop runs over fixed-size pair tables with invalid rows weighted 0, and
reads nothing back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry import so3
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops import matching as M
from orb_slam3_noted_tpu_torch.pipeline.tracking import _scale_table
from orb_slam3_noted_tpu_torch.utils.interop import const_tensor

CHI2_SIM3 = 9.99  # reference OptimizeSim3 th2 = 10


class Sim3RefineResult(NamedTuple):
    R: torch.Tensor          # (3, 3) refined S_cur_cand rotation
    t: torch.Tensor          # (3,)
    s: torch.Tensor          # ()
    n_inliers: torch.Tensor  # () int32 inliers after the optimisation
    n_matches: torch.Tensor  # () int32 pairs entering the optimisation


def _cam_points(m, slot: int):
    """(NF, 3) bound map points in the keyframe's camera frame + validity."""
    mp = m.kf_mp[slot]
    mpc = mp.clamp(min=0).long()
    ok = (mp >= 0) & m.kf_feat_valid[slot] & m.mp_valid[mpc]
    Xc = m.mp_pos[mpc] @ m.kf_Rcw[slot].T + m.kf_tcw[slot]
    return Xc, ok


def _project_match(cam, Xc_src, src_ok, desc_src, S, xy_tgt, lvl_tgt, desc_tgt, tgt_ok, sf,
                   width, height, radius_px=7.5):
    """One direction of ``SearchBySim3``: source camera-frame points through
    S into the target keyframe, radius 7.5 x the target feature's octave
    scale, the TH_HIGH gate.  Returns (target index per source, matched)."""
    R, t, s = S
    Xt = s * (Xc_src @ R.T) + t
    uv = cam_mod.project(cam, Xt)
    z_ok = Xt[:, 2] > 0.05
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    d = M.hamming_matrix(desc_src, desc_tgt)
    du = uv[:, None, 0] - xy_tgt[None, :, 0]
    dv = uv[:, None, 1] - xy_tgt[None, :, 1]
    r = radius_px * sf[lvl_tgt.long()]
    inside = (du * du + dv * dv) <= (r[None, :] ** 2)
    gate = inside & (src_ok & z_ok & in_img)[:, None] & tgt_ok[None, :]
    masked = torch.where(gate, d, M.BIG)
    best = torch.amin(masked, dim=1)
    idx = torch.argmin(masked, dim=1).to(torch.int32)  # the first minimum
    return idx, best <= M.TH_HIGH


def search_by_sim3(m, slot_cur: int, slot_cand: int, R0, t0, s0, cam, cfg, seed_idx=None,
                   seed_ok=None):
    """Grow cur <-> cand feature pairs through the candidate Sim(3).

    Returns (cand_of_cur (NF,) int32, ok (NF,)): for each current-keyframe
    feature with a bound point, the agreeing candidate feature.  ``seed_*``
    carries earlier (RANSAC) matches, kept where the growth found none."""
    sf = _scale_table(cfg, m.kf_xy)
    Xc_cur, ok_cur = _cam_points(m, slot_cur)
    Xc_cand, ok_cand = _cam_points(m, slot_cand)
    S12 = (R0, t0, s0)                                    # cand -> cur
    Rt = R0.T
    S21 = (Rt, -(Rt @ t0) / s0, 1.0 / s0)
    idx1, ok1 = _project_match(
        cam, Xc_cand, ok_cand, m.kf_desc[slot_cand], S12, m.kf_xy[slot_cur],
        m.kf_level[slot_cur], m.kf_desc[slot_cur], ok_cur, sf, cfg.width, cfg.height)
    idx2, ok2 = _project_match(
        cam, Xc_cur, ok_cur, m.kf_desc[slot_cur], S21, m.kf_xy[slot_cand],
        m.kf_level[slot_cand], m.kf_desc[slot_cand], ok_cand, sf, cfg.width, cfg.height)
    # agreement: cand i -> cur j and cur j -> cand i.  idx2[j] == i pins one
    # candidate feature per current slot, so the scatter never collides;
    # misses land in the scratch entry that is cut off
    NF = m.kf_xy.shape[1]
    j = idx1.long()
    ar = torch.arange(NF, dtype=torch.int32, device=j.device)
    agree = ok1 & ok2[j] & (idx2[j] == ar)
    cand_of_cur = torch.full((NF + 1,), -1, dtype=torch.int32, device=j.device)
    cand_of_cur[torch.where(agree, j, NF)] = torch.where(agree, ar, -1)
    cand_of_cur = cand_of_cur[:NF]
    ok = cand_of_cur >= 0
    if seed_idx is not None:
        keep_seed = seed_ok & ~ok
        cand_of_cur = torch.where(keep_seed, seed_idx.to(torch.int32), cand_of_cur)
        ok = ok | keep_seed
    return cand_of_cur, ok


def _sim3_residuals(cam, R, t, s, Xc_cand, Xc_cur, uv_cur, uv_cand, inv_s2_cur, inv_s2_cand, ok):
    """Two-sided reprojection residuals and Jacobians wrt the 7-dof update
    S <- exp(rho, phi, sigma) S, to first order x -> (1 + sigma)(x + rho +
    phi x x)."""
    Rt = R.T
    X1 = s * (Xc_cand @ R.T) + t          # forward: x1_hat = S x2
    X2 = ((Xc_cur - t) @ Rt.T) / s        # inverse: x2_hat = S^-1 x1
    uv1 = cam_mod.project(cam, X1)
    J1p = cam_mod.project_jac(cam, X1)
    uv2 = cam_mod.project(cam, X2)
    J2p = cam_mod.project_jac(cam, X2)
    r1 = uv_cur - uv1
    r2 = uv_cand - uv2
    N = X1.shape[0]
    eye = torch.eye(3, dtype=X1.dtype, device=X1.device).expand(N, 3, 3)
    dX1 = torch.cat([eye, -so3.hat(X1), X1[:, :, None]], dim=-1)
    dx1 = torch.cat([eye, -so3.hat(Xc_cur), Xc_cur[:, :, None]], dim=-1)
    dX2 = -torch.einsum("ij,njk->nik", Rt / s, dx1)
    J1 = -torch.einsum("nab,nbc->nac", J1p, dX1)  # (N, 2, 7)
    J2 = -torch.einsum("nab,nbc->nac", J2p, dX2)
    ok1 = ok & (X1[:, 2] > 1e-4)
    ok2 = ok & (X2[:, 2] > 1e-4)
    chi1 = torch.where(ok1, torch.sum(r1 * r1, -1) * inv_s2_cur, 0.0)
    chi2 = torch.where(ok2, torch.sum(r2 * r2, -1) * inv_s2_cand, 0.0)

    def z(a, mk):
        return torch.nan_to_num(a * (mk[:, None, None] if a.dim() == 3 else mk[:, None]))

    return z(r1, ok1), z(J1, ok1), chi1, ok1, z(r2, ok2), z(J2, ok2), chi2, ok2


def optimize_sim3(cam, R0, t0, s0, Xc_cand, Xc_cur, uv_cur, uv_cand, inv_s2_cur, inv_s2_cand,
                  ok, fix_scale: bool = False, n_iters: int = 10) -> Sim3RefineResult:
    """Gauss-Newton on the 7-dof Sim(3), Huber(sqrt(10)), reclassification
    between the rounds (``Optimizer::OptimizeSim3``: 5 iterations, drop
    chi2 > 10 edges, ``n_iters`` more).  A pair is an inlier when both its
    edges survive, as the reference counts them."""
    dtype, dev = t0.dtype, t0.device
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    keep = const_tensor((1.0,) * 6 + ((0.0,) if fix_scale else (1.0,)), dtype, dev)

    def gn(state, active, n):
        R, t, s = state
        for _ in range(n):
            r1, J1, c1, o1, r2, J2, c2, o2 = _sim3_residuals(
                cam, R, t, s, Xc_cand, Xc_cur, uv_cur, uv_cand, inv_s2_cur, inv_s2_cand, active)
            w1 = torch.where(o1, inv_s2_cur, 0.0) * torch.clamp(
                torch.sqrt(CHI2_SIM3 / torch.clamp(c1, min=1e-12)), max=1.0)
            w2 = torch.where(o2, inv_s2_cand, 0.0) * torch.clamp(
                torch.sqrt(CHI2_SIM3 / torch.clamp(c2, min=1e-12)), max=1.0)
            H = (torch.einsum("nai,n,naj->ij", J1, w1, J1)
                 + torch.einsum("nai,n,naj->ij", J2, w2, J2))
            g = (torch.einsum("nai,na->i", J1, w1[:, None] * r1)
                 + torch.einsum("nai,na->i", J2, w2[:, None] * r2))
            H = H + 1e-3 * torch.diag(torch.diagonal(H)) + 1e-6 * eye7
            dx = torch.linalg.solve_ex(H, -g[:, None]).result[:, 0]
            dx = torch.nan_to_num(dx) * keep
            dR = so3.exp(dx[3:6])
            es = torch.exp(dx[6])
            R, t, s = so3.normalize(dR @ R), es * (dR @ t) + dx[:3], es * s
        return R, t, s

    def inliers(state):
        _, _, c1, o1, _, _, c2, o2 = _sim3_residuals(
            cam, *state, Xc_cand, Xc_cur, uv_cur, uv_cand, inv_s2_cur, inv_s2_cand, ok)
        return ok & o1 & o2 & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)

    state = gn((R0, t0, s0), ok, 5)
    state = gn(state, inliers(state), n_iters)
    R, t, s = state
    return Sim3RefineResult(R=R, t=t, s=s, n_inliers=torch.sum(inliers(state).to(torch.int32)),
                            n_matches=torch.sum(ok.to(torch.int32)))


def sim3_refine(m, slot_cur: int, slot_cand: int, R0, t0, s0, cam, cfg, seed_idx=None,
                seed_ok=None) -> Sim3RefineResult:
    """One ladder step: ``SearchBySim3`` growth, then the reprojection
    ``OptimizeSim3``; the caller gates on ``n_inliers >= 20``."""
    cand_of_cur, ok = search_by_sim3(m, slot_cur, slot_cand, R0, t0, s0, cam, cfg,
                                     seed_idx=seed_idx, seed_ok=seed_ok)
    Xc_cur, ok_cur = _cam_points(m, slot_cur)
    Xc_cand, ok_cand = _cam_points(m, slot_cand)
    ci = cand_of_cur.clamp(min=0).long()
    pair_ok = ok & ok_cur & ok_cand[ci]
    sigma2 = const_tensor(tuple(float(v) for v in cfg.level_sigma2), m.kf_xy.dtype,
                          m.kf_xy.device)
    return optimize_sim3(
        cam, R0, t0, s0, Xc_cand[ci], Xc_cur, m.kf_xy[slot_cur], m.kf_xy[slot_cand][ci],
        1.0 / sigma2[m.kf_level[slot_cur].long()],
        1.0 / sigma2[m.kf_level[slot_cand][ci].long()], pair_ok)
