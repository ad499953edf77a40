"""Dense-Schur windowed bundle adjustment (port of :mod:`orb_slam3_noted_tpu.optim.window_ba`).

``Optimizer::LocalBundleAdjustment``: a handful of free window poses, fixed
anchor cameras, and the landmarks they see.  With KW <= ~10 free poses the
reduced camera system S is only (KW*6, KW*6), so it is assembled exactly:

    U_m   = (KW, 6, 3) pose-point coupling per landmark (one segment sum)
    S     = blkdiag(Hpp) - sum_m U_m Hll_m^-1 U_m^T
    rhs   = -gp + sum_m U_m Hll_m^-1 gl_m

followed by one dense solve and closed-form landmark back-substitution.
Anchor (fixed) observations carry ``wpose_idx == KW``: their pose Jacobians
are dropped, they only constrain the landmarks.

Everything is float32.  The pose-side sums (KW + 1 segments) are one-hot
products; the landmark-side sums are segment sums over the observations
sorted once by point (``ops/segsum.py``).  Both run in a fixed order, so a
window's result is the same in every run on the card.  Every LM step is
checked against the robust cost before it is taken.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry import se3, so3
from orb_slam3_noted_tpu_torch.geometry.linalg3 import inv3
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops.segsum import segment_order, segment_sum
from orb_slam3_noted_tpu_torch.optim import factors
from orb_slam3_noted_tpu_torch.optim.robust import chi2_threshold, huber_cost, huber_weight
from orb_slam3_noted_tpu_torch.utils import interop


class WindowObs(NamedTuple):
    """Observation table for the windowed solver.

    ``pose_idx`` indexes the full pose table (anchors keep their true
    poses); ``wpose_idx`` is the compact window index in [0, KW), or KW for
    anchor rows (pose treated as fixed).
    """

    pose_idx: torch.Tensor    # (O,) int32 into the full pose table
    wpose_idx: torch.Tensor   # (O,) int32 into the window table, KW = anchor
    point_idx: torch.Tensor   # (O,) int32 into the landmark table
    uv: torch.Tensor          # (O, 2)
    uv_r: torch.Tensor        # (O,)
    inv_sigma2: torch.Tensor  # (O,)
    is_stereo: torch.Tensor   # (O,) bool
    valid: torch.Tensor       # (O,) bool
    uv2: torch.Tensor | None = None       # fisheye second camera (not ported)
    is_right: torch.Tensor | None = None


class WindowBAResult(NamedTuple):
    Rcw: torch.Tensor     # (KF+1, 3, 3) updated full pose table (scratch row last)
    tcw: torch.Tensor     # (KF+1, 3)
    points: torch.Tensor  # (M, 3)
    inlier: torch.Tensor  # (O,) bool
    cost: torch.Tensor


def to_numpy(o: WindowObs) -> dict:
    return interop.to_numpy(o)


def from_numpy(d: dict, device=None) -> WindowObs:
    """{field: array} (e.g. ``jax.device_get(obs)._asdict()``) -> WindowObs."""
    return interop.from_numpy(WindowObs, d, device)


def _evaluate(cam, Rcw, tcw, points, obs: WindowObs, active, use_huber: bool, bf):
    robs = factors.ReprojObs(
        pose_idx=obs.pose_idx, point_idx=obs.point_idx, uv=obs.uv, uv_r=obs.uv_r,
        inv_sigma2=obs.inv_sigma2, is_stereo=obs.is_stereo, valid=active,
        uv2=obs.uv2, is_right=obs.is_right,
    )
    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(cam, Rcw, tcw, points, robs, bf=bf)
    delta2 = chi2_threshold(obs)
    if use_huber:
        w = torch.where(ok, obs.inv_sigma2 * huber_weight(chi2, delta2), 0.0)
        cost = torch.sum(torch.where(ok, huber_cost(chi2, delta2), 0.0))
    else:
        w = torch.where(ok, obs.inv_sigma2, 0.0)
        cost = torch.sum(torch.where(ok, chi2, 0.0))
    return r, Jp, Jl, chi2, w, ok, cost


def _lm_step(cam, Rcw, tcw, points, obs, kf_slots, pose_fixed_w, point_fixed,
             active, use_huber, lam, bf, lin, cost_old, oh_pose, seg_point, pt_order):
    """One cost-checked LM step with the dense reduced camera system.

    ``lin`` = (r, Jp, Jl, w) is the linearisation at the current state: an
    accepted step's candidate evaluation becomes the next step's
    linearisation, a rejected step reuses the old one, so each step costs
    one residual/Jacobian evaluation.  Accept/reject is a ``torch.where`` on
    the device: no host sync inside the solve.
    """
    M = points.shape[0]
    KW = kf_slots.shape[0]
    dtype = tcw.dtype
    dev = tcw.device
    r, Jp, Jl, w = lin
    # anchors (wpose == KW) and fixed window poses drop Jp
    wfree = torch.cat([(~pose_fixed_w).to(dtype), torch.zeros(1, dtype=dtype, device=dev)])
    point_free = (~point_fixed).to(dtype)
    Jp = Jp * wfree[obs.wpose_idx.long()][:, None, None]
    Jl = Jl * point_free[seg_point][:, None, None]

    wJp = w[:, None, None] * Jp
    wr = w[:, None] * r
    W_o = torch.einsum("oai,oaj->oij", wJp, Jl)                               # (O, 6, 3)
    n_obs = r.shape[0]
    pose_side = torch.cat([
        torch.einsum("oai,oaj->oij", wJp, Jp).reshape(n_obs, 36),
        torch.einsum("oai,oa->oi", Jp, wr),
    ], dim=1)
    pose_sums = oh_pose @ pose_side                                           # (KW, 42)
    Hpp = pose_sums[:, :36].reshape(KW, 6, 6)
    gp = pose_sums[:, 36:]
    Hll = segment_sum(torch.einsum("oai,oaj->oij", w[:, None, None] * Jl, Jl), seg_point, M,
                      pt_order)
    gl = segment_sum(torch.einsum("oai,oa->oi", Jl, wr), seg_point, M, pt_order)

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hpp_d = Hpp + lam * Hpp * eye6 + (1e-8 + pose_fixed_w.to(dtype))[:, None, None] * eye6
    Hll_d = Hll + lam * Hll * eye3 + (1e-8 + point_fixed.to(dtype))[:, None, None] * eye3
    Cinv = inv3(Hll_d)

    # per-landmark pose coupling U_m = sum_o 1[point_o = m] 1[wpose_o = p] W_o;
    # anchor rows have W_o == 0 (Jp masked)
    WP = W_o[:, None, :, :] * oh_pose.T[:, :, None, None]                     # (O, KW, 6, 3)
    U = segment_sum(WP, seg_point, M, pt_order)                                        # (M, KW, 6, 3)

    T1 = torch.einsum("mpab,mbc->mpac", U, Cinv)
    S = -torch.einsum("mpac,mqbc->paqb", T1, U)                               # (KW, 6, KW, 6)
    ar = torch.arange(KW, device=dev)
    S[ar, :, ar, :] += Hpp_d
    rhs = -gp + torch.einsum("mpac,mc->pa", T1, gl)

    n = KW * 6
    # solve_ex neither raises on a singular system nor syncs to check:
    # non-finite entries are zeroed below, as after jnp.linalg.solve
    dp = torch.linalg.solve_ex(S.reshape(n, n), rhs.reshape(n, 1)).result.reshape(KW, 6)
    dp = torch.nan_to_num(dp) * (~pose_fixed_w)[:, None]
    # landmark back-substitution: dl = Hll^-1 (-gl - U^T dp)
    utdp = torch.einsum("mpab,pa->mb", U, dp)
    dl = torch.einsum("mbc,mc->mb", Cinv, -gl - utdp)
    dl = torch.nan_to_num(dl) * point_free[:, None]

    # window pose updates into the full (padded) table; padded window
    # entries all write the same unchanged scratch row
    Rw_new, tw_new = se3.compose(se3.exp(dp), (Rcw[kf_slots], tcw[kf_slots]))
    R_new = Rcw.clone()
    R_new[kf_slots] = so3.normalize(Rw_new)
    t_new = tcw.clone()
    t_new[kf_slots] = tw_new
    p_new = points + dl
    r2, Jp2, Jl2, _, w2, _, cost_new = _evaluate(
        cam, R_new, t_new, p_new, obs, active, use_huber, bf)
    better = cost_new < cost_old
    sel = lambda a, b: torch.where(better, a, b)
    lin = tuple(sel(a, b) for a, b in zip((r2, Jp2, Jl2, w2), lin))
    lam = torch.where(better, lam * 0.5, lam * 5.0)
    return (sel(R_new, Rcw), sel(t_new, tcw), sel(p_new, points), lam, lin,
            torch.minimum(cost_new, cost_old))


def window_bundle_adjust(
    cam: cam_mod.Camera,
    Rcw_full: torch.Tensor,      # (KF+1, 3, 3) full pose table + scratch row
    tcw_full: torch.Tensor,      # (KF+1, 3)
    points: torch.Tensor,        # (M, 3)
    obs: WindowObs,
    kf_slots: torch.Tensor,      # (KW,) window slots into the full table
    pose_fixed_w: torch.Tensor,  # (KW,) bool (gauge anchors / padding)
    point_fixed: torch.Tensor,   # (M,) bool
    bf: float = 0.0,
    n_iters: int = 5,
    n_iters_final: int = 5,
) -> WindowBAResult:
    """Two-phase LM (Huber -> chi2 reclassify -> plain least squares) with
    cost-checked adaptive damping, as ``LocalBundleAdjustment``'s schedule
    with kernel removal."""
    KW = kf_slots.shape[0]
    kf_slots = kf_slots.long()
    seg_point = obs.point_idx.long()
    pt_order = segment_order(seg_point, points.shape[0], obs.valid)
    oh_pose = (
        torch.arange(KW, device=tcw_full.device)[:, None] == obs.wpose_idx.long()[None, :]
    ).to(tcw_full.dtype)                                                      # (KW, O)

    def phase(Rcw, tcw, pts, active, use_huber, n):
        if n <= 0:
            return Rcw, tcw, pts
        r0, Jp0, Jl0, _, w0, _, cost = _evaluate(cam, Rcw, tcw, pts, obs, active, use_huber, bf)
        lin = (r0, Jp0, Jl0, w0)
        lam = torch.tensor(1e-4, dtype=tcw.dtype, device=tcw.device)
        for _ in range(n):
            Rcw, tcw, pts, lam, lin, cost = _lm_step(
                cam, Rcw, tcw, pts, obs, kf_slots, pose_fixed_w, point_fixed,
                active, use_huber, lam, bf, lin, cost, oh_pose, seg_point, pt_order)
        return Rcw, tcw, pts

    Rcw, tcw, pts = phase(Rcw_full, tcw_full, points, obs.valid, True, n_iters)
    _, _, _, chi2, _, ok, _ = _evaluate(cam, Rcw, tcw, pts, obs, obs.valid, True, bf)
    th = chi2_threshold(obs)
    active = obs.valid & ok & (chi2 <= th)
    Rcw, tcw, pts = phase(Rcw, tcw, pts, active, False, n_iters_final)
    _, _, _, chi2, _, ok, cost = _evaluate(cam, Rcw, tcw, pts, obs, obs.valid, False, bf)
    inlier = obs.valid & ok & (chi2 <= th)
    return WindowBAResult(Rcw=Rcw, tcw=tcw, points=pts, inlier=inlier, cost=cost)
