"""Joint visual-inertial bundle adjustment (port of :mod:`orb_slam3_noted_tpu.optim.inertial_ba`).

One engine for the reference's inertial optimisations: ``LocalInertialBA``
and ``FullInertialBA`` (body states, landmarks, the inertial chain, bias
random walks, reprojection factors) and the motion-only
``PoseInertialOptimizationLastKeyFrame`` (two states, the anchor fixed,
landmarks fixed: :func:`vi_pose_optimization`).

Body states are a (K, 15) table; landmarks are Schur-marginalised; the
dense (15K, 15K) state system is assembled from segment sums over the
observations (``ops/segsum.py``, in a fixed order) and one-hot products
over the chain's edges, so a run on the card repeats bit for bit, and
solved by Cholesky (``cholesky_ex``), whose failure rejects the step as a
worse cost does.  The LM accept test is a ``torch.where``: nothing is read
back inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry.linalg3 import inv3
from orb_slam3_noted_tpu_torch.imu.preintegration import Calib, Preintegrated, stack
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops.segsum import segment_order, segment_sum
from orb_slam3_noted_tpu_torch.optim import factors
from orb_slam3_noted_tpu_torch.optim.robust import CHI2_MONO, CHI2_STEREO, huber_cost, huber_weight
from orb_slam3_noted_tpu_torch.utils.interop import const_tensor
from orb_slam3_noted_tpu_torch.optim.inertial import whitener
from orb_slam3_noted_tpu_torch.optim.vi_factors import (
    InertialEdges,
    VIPrior,
    VIState,
    bias_rw_residuals,
    body_reproj_residuals,
    inertial_edge_residuals,
    prior_residuals,
    retract,
)

# Huber delta^2 for inertial edges in LocalInertialBA (reference sqrt(16.92))
CHI2_INERTIAL = 16.92


class VIBAProblem(NamedTuple):
    state: VIState              # (K,) body states
    points: torch.Tensor        # (M, 3)
    obs: factors.ReprojObs      # (O,) reprojection table
    edges: InertialEdges        # (E,) temporal chain
    pose_fixed: torch.Tensor    # (K,) bool
    point_fixed: torch.Tensor   # (M,) bool
    prior: VIPrior | None       # anchor prior (valid flag inside), or None


class VIBAResult(NamedTuple):
    state: VIState
    points: torch.Tensor
    chi2: torch.Tensor    # (O,) reprojection chi2 after optimisation
    inlier: torch.Tensor  # (O,)
    cost: torch.Tensor    # () total (visual robust + inertial) cost


def no_prior(dtype=torch.float32, device=None) -> VIPrior:
    z3 = torch.zeros(3, dtype=dtype, device=device)
    return VIPrior(idx=torch.zeros((), dtype=torch.int32, device=device),
                   Rwb=torch.eye(3, dtype=dtype, device=device), twb=z3, vel=z3, bg=z3, ba=z3,
                   sqrt_info=torch.zeros((15, 15), dtype=dtype, device=device),
                   valid=torch.zeros((), dtype=torch.bool, device=device))


def _visual_eval(cam, st, calib, points, obs, active, use_huber: bool, bf, rig2=()):
    """The visual rows; ``rig2`` = (cam2, Rrl, trl) of a second camera, or
    empty.  The Huber gate is the mono or stereo one, whatever rows a
    second camera adds (as in the JAX package)."""
    r, Jp, Jl, chi2, ok = body_reproj_residuals(cam, st, calib, points,
                                                obs._replace(valid=active), bf, *rig2)
    delta2 = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(chi2.dtype)
    w_rob = huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
    w = torch.where(ok, obs.inv_sigma2 * w_rob, 0.0)
    cost = torch.sum(torch.where(ok, huber_cost(chi2, delta2) if use_huber else chi2, 0.0))
    return r, Jp, Jl, chi2, w, ok, cost


def _inertial_eval(st, edges, prior, use_huber_inertial: bool, bpg: float, bpa: float, W,
                   jacobians: bool = True):
    """Residual/Jacobian bundles of the non-visual factors and their cost;
    ``W`` the edges' whitening, ``prior`` None for none.  Without
    ``jacobians`` (an accept test) the Jacobians are not formed."""
    ri, Ji, Jj = inertial_edge_residuals(st, edges, W, jacobians)
    chi2_i = torch.sum(ri * ri, dim=-1)
    w_i = huber_weight(chi2_i, CHI2_INERTIAL) if use_huber_inertial else torch.ones_like(chi2_i)
    rb, wb = bias_rw_residuals(st, edges)
    cost = (torch.sum(huber_cost(chi2_i, CHI2_INERTIAL) if use_huber_inertial else chi2_i)
            + torch.sum(rb * rb) + bpg * torch.sum(st.bg * st.bg)
            + bpa * torch.sum(st.ba * st.ba))
    rp = Jp = None
    if prior is not None:
        rp, Jp = prior_residuals(st, prior)
        cost = cost + torch.sum(rp * rp)
    return (ri, Ji, Jj, w_i), (rb, wb), (rp, Jp), cost


def _vi_lm_step(cam, calib, st, points, prob, active, use_huber, lam, bf, use_huber_inertial,
                bpg, bpa, orders, solve_points: bool, W, rig2=()):
    K = st.twb.shape[0]
    M = points.shape[0]
    dtype, dev = st.twb.dtype, st.twb.device
    obs = prob.obs
    pi, li = obs.pose_idx.long(), obs.point_idx.long()
    ei, ej = prob.edges.i.long(), prob.edges.j.long()

    r, Jp6, Jl, chi2, w, ok, vcost = _visual_eval(cam, st, calib, points, obs, active, use_huber,
                                                  bf, rig2)
    (ri, Ji, Jj, w_i), (rb, wb), (rp, Jpr), icost = _inertial_eval(
        st, prob.edges, prob.prior, use_huber_inertial, bpg, bpa, W)
    cost_old = vcost + icost

    pose_free = (~prob.pose_fixed).to(dtype)
    point_free = (~prob.point_fixed).to(dtype)
    Jp6 = Jp6 * pose_free[pi][:, None, None]
    Jl = Jl * point_free[li][:, None, None]
    Ji = Ji * pose_free[ei][:, None, None]
    Jj = Jj * pose_free[ej][:, None, None]

    # visual blocks (the pose part touches tangent rows 0:6 only)
    wJp = w[:, None, None] * Jp6
    Hpp6 = segment_sum(torch.einsum("oai,oaj->oij", wJp, Jp6), pi, K, order=orders["pose"])
    gp6 = segment_sum(torch.einsum("oai,oa->oi", Jp6, w[:, None] * r), pi, K,
                      order=orders["pose"])

    # the dense state system H (K, 15, K, 15), g (K, 15): one-hot products
    # over the states for the chain's edges
    ks = torch.arange(K, device=dev)
    Oi = (ks[:, None] == ei[None, :]).to(dtype)  # (K, E)
    Oj = (ks[:, None] == ej[None, :]).to(dtype)
    wJi = w_i[:, None, None] * Ji
    Hii = torch.einsum("eai,eaj->eij", wJi, Ji)
    Hjj = torch.einsum("eai,eaj->eij", w_i[:, None, None] * Jj, Jj)
    Hij = torch.einsum("eai,eaj->eij", wJi, Jj)
    H = (torch.einsum("ae,be,exy->axby", Oi, Oi, Hii)
         + torch.einsum("ae,be,exy->axby", Oj, Oj, Hjj)
         + torch.einsum("ae,be,exy->axby", Oi, Oj, Hij)
         + torch.einsum("ae,be,eyx->axby", Oj, Oi, Hij))
    g = (Oi @ torch.einsum("eai,ea->ei", Ji, w_i[:, None] * ri)
         + Oj @ torch.einsum("eai,ea->ei", Jj, w_i[:, None] * ri))
    H[ks, 0:6, ks, 0:6] += Hpp6
    g[:, 0:6] += gp6

    # bias random walks: J_i = -diag(wb), J_j = +diag(wb) on rows 9:15
    wb_i = wb * pose_free[ei][:, None]
    wb_j = wb * pose_free[ej][:, None]
    Bd = torch.zeros((K, K, 6), dtype=dtype, device=dev)  # [a, b, c]: H[a, 9+c, b, 9+c]
    Bd = (Bd + torch.einsum("ae,be,ec->abc", Oi, Oi, wb_i * wb_i)
          + torch.einsum("ae,be,ec->abc", Oj, Oj, wb_j * wb_j)
          - torch.einsum("ae,be,ec->abc", Oi, Oj, wb_i * wb_j)
          - torch.einsum("ae,be,ec->abc", Oj, Oi, wb_i * wb_j))
    bb = torch.arange(9, 15, device=dev)
    H[:, bb, :, bb] += Bd.permute(2, 0, 1)
    g[:, 9:15] += Oj @ (wb_j * rb) - Oi @ (wb_i * rb)

    # prior
    if prob.prior is not None:
        pk = prob.prior.idx.long()
        Jpr = Jpr * pose_free[pk]
        H[pk, :, pk, :] += Jpr.T @ Jpr
        g[pk] += Jpr.T @ rp

    # direct bias priors (FullInertialBA's EdgePriorGyro/EdgePriorAcc)
    bias_diag = torch.cat([torch.full((K, 3), bpg, dtype=dtype, device=dev),
                           torch.full((K, 3), bpa, dtype=dtype, device=dev)], dim=-1)
    H[ks[:, None], bb[None, :], ks[:, None], bb[None, :]] += bias_diag * pose_free[:, None]
    g[:, 9:12] += bpg * st.bg * pose_free[:, None]
    g[:, 12:15] += bpa * st.ba * pose_free[:, None]

    # damping + gauge fixing
    H = H.reshape(K * 15, K * 15)
    fixed_diag = prob.pose_fixed.to(dtype).repeat_interleave(15)
    H = H + torch.diag(lam * torch.diagonal(H) + 1e-6 + fixed_diag)

    rhs = -g
    if solve_points:
        Hll = segment_sum(torch.einsum("oai,oaj->oij", w[:, None, None] * Jl, Jl), li, M,
                          order=orders["point"])
        gl = segment_sum(torch.einsum("oai,oa->oi", Jl, w[:, None] * r), li, M,
                         order=orders["point"])
        W_o = torch.einsum("oai,oaj->oij", wJp, Jl)  # (O, 6, 3)
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        Hll = Hll + lam * Hll * eye3 + (1e-8 + prob.point_fixed.to(dtype))[:, None, None] * eye3
        Cinv = inv3(Hll)
        # Schur: U (K, 6, M, 3), the visual coupling on tangent rows 0:6
        U = segment_sum(W_o, pi * M + li, K * M, order=orders["pair"]).reshape(K, M, 6, 3)
        U = U.permute(0, 2, 1, 3)
        V = torch.einsum("kamb,mbc->kamc", U, Cinv)
        S6 = torch.einsum("kamc,jdmc->kajd", V, U)  # (K, 6, K, 6)
        Hs = H.reshape(K, 15, K, 15).clone()
        Hs[:, 0:6, :, 0:6] -= S6
        Hs = Hs.reshape(K * 15, K * 15)
        rhs = rhs.clone()
        rhs[:, 0:6] += torch.einsum("kamc,mc->ka", V, gl)
    else:
        Hs = H
    L, info = torch.linalg.cholesky_ex(Hs)
    dp = torch.cholesky_solve(rhs.reshape(K * 15, 1), L).reshape(K, 15)
    st_new = retract(st, dp)
    if solve_points:
        dl = torch.einsum("mbc,mc->mb", Cinv,
                          -gl - torch.einsum("kamb,ka->mb", U, dp[:, 0:6]))
        p_new = points + dl
    else:
        p_new = points
    vcost_new = _visual_eval(cam, st_new, calib, p_new, obs, active, use_huber, bf, rig2)[-1]
    icost_new = _inertial_eval(st_new, prob.edges, prob.prior, use_huber_inertial, bpg, bpa, W,
                               jacobians=False)[-1]
    better = (info == 0) & ((vcost_new + icost_new) < cost_old)
    st = VIState(*(torch.where(better, a, b) for a, b in zip(st_new, st)))
    points = torch.where(better, p_new, points)
    return st, points, torch.where(better, lam * 0.5, lam * 5.0)


def visual_inertial_ba(cam: cam_mod.Camera, calib: Calib, prob: VIBAProblem, bf: float = 0.0,
                       n_iters: int = 5, n_iters_final: int = 5, huber_inertial: bool = True,
                       bias_prior_g: float = 0.0, bias_prior_a: float = 0.0,
                       solve_points: bool = True, cam2: cam_mod.Camera | None = None,
                       Rrl: torch.Tensor | None = None,
                       trl: torch.Tensor | None = None) -> VIBAResult:
    """LM over body states and landmarks with the reference's two-phase
    schedule (robust first phase, chi2 outlier cut, clean second phase).
    ``solve_points=False`` when every landmark is fixed: their Schur blocks
    are then exactly zero and are not formed.  ``cam2``/``Rrl``/``trl``:
    the second camera of a fisheye rig."""
    rig2 = (cam2, Rrl, trl)
    obs = prob.obs
    st, points = prob.state, prob.points
    K, M = st.twb.shape[0], points.shape[0]
    W = whitener(prob.edges.preint)  # fixed while the states move
    pi, li = obs.pose_idx.long(), obs.point_idx.long()
    # rows that are not valid carry zero in every sum: spread over the
    # segments (padding would otherwise pile onto point 0)
    orders = {"pose": segment_order(pi, K, obs.valid)}
    if solve_points:
        orders["point"] = segment_order(li, M, obs.valid)
        orders["pair"] = segment_order(pi * M + li, K * M, obs.valid)

    def phase(st, points, active, use_huber, n):
        lam = torch.full((), 1e-2, dtype=st.twb.dtype, device=st.twb.device)
        for _ in range(n):
            st, points, lam = _vi_lm_step(cam, calib, st, points, prob, active, use_huber, lam, bf,
                                          huber_inertial, bias_prior_g, bias_prior_a, orders,
                                          solve_points, W, rig2)
        return st, points

    st, points = phase(st, points, obs.valid, True, n_iters)
    _, _, _, chi2, _, ok, _ = _visual_eval(cam, st, calib, points, obs, obs.valid, True, bf, rig2)
    th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(chi2.dtype)
    active = obs.valid & ok & (chi2 <= th)
    st, points = phase(st, points, active, False, n_iters_final)
    _, _, _, chi2, _, ok, vcost = _visual_eval(cam, st, calib, points, obs, obs.valid, False, bf,
                                               rig2)
    icost = _inertial_eval(st, prob.edges, prob.prior, huber_inertial, bias_prior_g,
                           bias_prior_a, W, jacobians=False)[-1]
    inlier = obs.valid & ok & (chi2 <= th)
    return VIBAResult(state=st, points=points, chi2=chi2, inlier=inlier, cost=vcost + icost)


class VIPoseOptResult(NamedTuple):
    Rwb: torch.Tensor
    twb: torch.Tensor
    vel: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def vi_pose_optimization(cam: cam_mod.Camera, calib: Calib, anchor: VIState, frame: VIState,
                         preint: Preintegrated, points: torch.Tensor, obs,
                         anchor_prior: VIPrior | None = None, bf: float = 0.0,
                         cam2: cam_mod.Camera | None = None, Rrl: torch.Tensor | None = None,
                         trl: torch.Tensor | None = None) -> VIPoseOptResult:
    """Motion-only visual-inertial pose optimisation
    (``PoseInertialOptimizationLastKeyFrame``: the anchor state fixed, pass
    ``anchor_prior=None``; ``...LastFrame``: the anchor free but held by its
    15-dim prior).  ``anchor`` and ``frame`` are single states (no K dim),
    ``preint`` the anchor -> frame preintegration, ``points`` (N, 3) the
    matched landmarks (fixed), ``obs`` a ``PoseObs``-like table (with
    ``uv2``/``is_right`` rows for ``cam2``)."""
    dtype, dev = frame.twb.dtype, frame.twb.device
    st = VIState(*(torch.stack([a, b]) for a, b in zip(anchor, frame)))
    N = points.shape[0]
    robs = factors.ReprojObs(
        pose_idx=torch.ones(N, dtype=torch.int32, device=dev),
        point_idx=torch.arange(N, dtype=torch.int32, device=dev),
        uv=obs.uv, uv_r=obs.uv_r, inv_sigma2=obs.inv_sigma2, is_stereo=obs.is_stereo,
        valid=obs.valid, uv2=getattr(obs, "uv2", None), is_right=getattr(obs, "is_right", None),
    )
    edges = InertialEdges(
        i=torch.zeros(1, dtype=torch.int32, device=dev),
        j=torch.ones(1, dtype=torch.int32, device=dev),
        preint=stack([preint]), valid=torch.ones(1, dtype=torch.bool, device=dev))
    fixed = anchor_prior is None
    prob = VIBAProblem(
        state=st, points=points, obs=robs, edges=edges,
        pose_fixed=const_tensor((fixed, False), torch.bool, dev),
        point_fixed=torch.ones(N, dtype=torch.bool, device=dev),
        prior=None if fixed else anchor_prior)
    res = visual_inertial_ba(cam, calib, prob, bf=bf, n_iters=4, n_iters_final=4,
                             huber_inertial=False, solve_points=False, cam2=cam2, Rrl=Rrl,
                             trl=trl)
    s = res.state
    return VIPoseOptResult(Rwb=s.Rwb[1], twb=s.twb[1], vel=s.vel[1], bg=s.bg[1], ba=s.ba[1],
                           inliers=res.inlier,
                           n_inliers=torch.sum(res.inlier.to(torch.int32)))
