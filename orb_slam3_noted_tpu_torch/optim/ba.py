"""Dense-Schur bundle adjustment (port of :mod:`orb_slam3_noted_tpu.optim.ba`).

``BAProblem`` and ``BAResult`` are the types global BA shares; the dense
engine ``bundle_adjust`` (``BundleAdjustment``: LM with Huber kernels
sqrt(5.991) / sqrt(7.815), the Schur complement of the landmark blocks,
outlier reclassification between the two phases) materialises the
pose-landmark coupling U (K, 6, M, 3) and solves the reduced (6K, 6K) camera
system exactly.  It is the reference that the matrix-free engine of
:mod:`.gba` is held against, and sized for windows, not whole maps.

Fixed vertices get their Jacobian columns zeroed and identity diagonal
blocks, so their updates are exactly zero.  Segment sums are
``ops/segsum.py``'s, in a fixed order, so a run on the card repeats bit for
bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry import se3, so3
from orb_slam3_noted_tpu_torch.geometry.linalg3 import inv3
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops.segsum import segment_sum
from orb_slam3_noted_tpu_torch.optim import factors
from orb_slam3_noted_tpu_torch.optim.robust import chi2_threshold, huber_cost, huber_weight


class BAProblem(NamedTuple):
    Rcw: torch.Tensor          # (K, 3, 3)
    tcw: torch.Tensor          # (K, 3)
    points: torch.Tensor       # (M, 3)
    obs: factors.ReprojObs     # (O,)
    pose_fixed: torch.Tensor   # (K,) bool
    point_fixed: torch.Tensor  # (M,) bool


class BAResult(NamedTuple):
    Rcw: torch.Tensor
    tcw: torch.Tensor
    points: torch.Tensor
    chi2: torch.Tensor    # (O,) final per-obs chi2 (information-weighted)
    inlier: torch.Tensor  # (O,) bool after the final classification
    cost: torch.Tensor    # () final cost


def _evaluate(cam, Rcw, tcw, points, obs, active, use_huber: bool, bf):
    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, obs._replace(valid=active), bf=bf)
    delta2 = chi2_threshold(obs)
    w_rob = huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
    w = torch.where(ok, obs.inv_sigma2 * w_rob, 0.0)
    cost = torch.sum(torch.where(ok, huber_cost(chi2, delta2) if use_huber else chi2, 0.0))
    return r, Jp, Jl, chi2, w, ok, cost


def _lm_step(cam, Rcw, tcw, points, obs, prob, active, use_huber, lam, bf):
    K, M = Rcw.shape[0], points.shape[0]
    dtype, dev = tcw.dtype, tcw.device
    r, Jp, Jl, chi2, w, ok, cost_old = _evaluate(cam, Rcw, tcw, points, obs, active, use_huber,
                                                 bf)
    pi, li = obs.pose_idx.long(), obs.point_idx.long()
    Jp = Jp * (~prob.pose_fixed).to(dtype)[pi][:, None, None]
    Jl = Jl * (~prob.point_fixed).to(dtype)[li][:, None, None]
    wJp = w[:, None, None] * Jp
    Hpp = segment_sum(torch.einsum("oai,oaj->oij", wJp, Jp), pi, K)
    gp = segment_sum(torch.einsum("oai,oa->oi", Jp, w[:, None] * r), pi, K)
    Hll = segment_sum(torch.einsum("oai,oaj->oij", w[:, None, None] * Jl, Jl), li, M)
    gl = segment_sum(torch.einsum("oai,oa->oi", Jl, w[:, None] * r), li, M)
    W_o = torch.einsum("oai,oaj->oij", wJp, Jl)  # (O, 6, 3)

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hpp = Hpp + lam * Hpp * eye6 + (1e-8 + prob.pose_fixed.to(dtype))[:, None, None] * eye6
    Hll = Hll + lam * Hll * eye3 + (1e-8 + prob.point_fixed.to(dtype))[:, None, None] * eye3
    Cinv = inv3(Hll)

    # U[k, a, m, b] = sum of W_o over the observations (k, m)
    U = torch.zeros((K, M, 6, 3), dtype=dtype, device=dev)
    U.index_put_((pi, li), W_o, accumulate=True)
    U = U.permute(0, 2, 1, 3)
    V = torch.einsum("kamb,mbc->kamc", U, Cinv)
    S = -torch.einsum("kamc,jdmc->kajd", V, U)
    ar = torch.arange(K, device=dev)
    S[ar, :, ar, :] += Hpp
    rhs = -gp + torch.einsum("kamc,mc->ka", V, gl)
    dp = torch.linalg.solve_ex(S.reshape(K * 6, K * 6), rhs.reshape(K * 6, 1)).result.reshape(K, 6)
    dl = torch.einsum("mbc,mc->mb", Cinv, -gl - torch.einsum("kamb,ka->mb", U, dp))

    R_new, t_new = se3.compose(se3.exp(dp), (Rcw, tcw))
    R_new = so3.normalize(R_new)
    p_new = points + dl
    cost_new = _evaluate(cam, R_new, t_new, p_new, obs, active, use_huber, bf)[-1]
    better = cost_new < cost_old
    return (torch.where(better, R_new, Rcw), torch.where(better, t_new, tcw),
            torch.where(better, p_new, points), torch.where(better, lam * 0.5, lam * 5.0))


def bundle_adjust(cam: cam_mod.Camera, prob: BAProblem, bf: float = 0.0, n_iters: int = 5,
                  n_iters_final: int = 10) -> BAResult:
    """LM bundle adjustment with the reference's two-phase schedule: phase 1
    ``n_iters`` robust iterations on every observation, reclassification by
    chi2 (5.991 / 7.815), phase 2 ``n_iters_final`` plain iterations
    without the outliers."""
    obs = prob.obs

    def phase(Rcw, tcw, points, active, use_huber, n):
        lam = torch.tensor(1e-4, dtype=tcw.dtype, device=tcw.device)
        for _ in range(n):
            Rcw, tcw, points, lam = _lm_step(cam, Rcw, tcw, points, obs, prob, active, use_huber,
                                             lam, bf)
        return Rcw, tcw, points

    Rcw, tcw, points = phase(prob.Rcw, prob.tcw, prob.points, obs.valid, True, n_iters)
    _, _, _, chi2, _, ok, _ = _evaluate(cam, Rcw, tcw, points, obs, obs.valid, True, bf)
    th = chi2_threshold(obs)
    active = obs.valid & ok & (chi2 <= th)
    Rcw, tcw, points = phase(Rcw, tcw, points, active, False, n_iters_final)
    _, _, _, chi2, _, ok, cost = _evaluate(cam, Rcw, tcw, points, obs, obs.valid, False, bf)
    inlier = obs.valid & ok & (chi2 <= th)
    return BAResult(Rcw=Rcw, tcw=tcw, points=points, chi2=chi2, inlier=inlier, cost=cost)
