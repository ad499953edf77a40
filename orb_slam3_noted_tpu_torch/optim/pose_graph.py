"""Sim(3) pose-graph (essential graph) optimisation (port of the Sim(3) half
of :mod:`orb_slam3_noted_tpu.optim.pose_graph`).

``Optimizer::OptimizeEssentialGraph``: after a loop is found, every
keyframe pose is re-optimised as a Sim(3) vertex against relative-pose
edges (spanning tree, strong covisibility, loop edges), which absorbs the
accumulated drift, monocular scale drift included.

All edge residuals r_e = log(S_meas S_i S_j^-1) and their 7x14 Jacobians
are evaluated in one batch (central differences in float64 along the 14
tangent directions, where the JAX package runs ``jacfwd``); the dense (7K, 7K)
normal system is assembled with one-hot products over the K keyframe slots,
so its sums run in a fixed order on every device, and solved whole (by
Cholesky: it is positive definite once damped).  The LM
accept test is a ``torch.where``: nothing is read back inside the loop.

The 4-DoF graph of the inertial maps waits for the inertial slice and the
mesh-sharded graph for the distribution slice (ROADMAP, next steps 3 and 7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry import sim3


class Sim3Edges(NamedTuple):
    """Static-shape edge table. Measurement: S_ji = S_j S_i^-1 at build time."""

    i: torch.Tensor       # (E,) int32 "from" vertex
    j: torch.Tensor       # (E,) int32 "to" vertex
    R: torch.Tensor       # (E, 3, 3) measured relative rotation (j <- i)
    t: torch.Tensor       # (E, 3)
    s: torch.Tensor       # (E,)
    weight: torch.Tensor  # (E,) information scale
    valid: torch.Tensor   # (E,) bool


def _edge_residual(Sm, Si, Sj):
    """r = log(S_meas S_i S_j^-1) (..., 7)."""
    return sim3.log(sim3.compose(Sm, sim3.compose(Si, sim3.inverse(Sj))))


def _residual_tangent(Sm, Si, Sj, di, dj):
    return _edge_residual(Sm, sim3.compose(sim3.exp(di), Si), sim3.compose(sim3.exp(dj), Sj))


def _edge_jacobians(Sm, Si, Sj, h: float = 1e-6):
    """(Ji, Jj), (E, 7, 7) each: d r / d(di, dj) at 0, by central differences
    in float64 along the 14 unit tangents, all 28 evaluations in one batch
    (error ~1e-10; the JAX package's float32 ``jacfwd`` rounds at ~1e-7).
    Forward-mode autodiff of the same residual decomposes into ~8,700
    operations for 64 keyframes, this into ~800."""
    E = Sm[2].shape[0]
    dev = Sm[2].device
    S64 = [tuple(x.to(torch.float64) for x in S) for S in (Sm, Si, Sj)]
    step = h * torch.eye(14, dtype=torch.float64, device=dev)
    step = torch.cat([step, -step])[:, None, :].expand(28, E, 14)
    r = _residual_tangent(*S64, step[..., :7], step[..., 7:])  # (28, E, 7)
    J = ((r[:14] - r[14:]) / (2.0 * h)).permute(1, 2, 0).to(Sm[2].dtype)
    return J[..., :7], J[..., 7:]  # (E, 7 residual rows, 7 tangent columns) each


def _cost(R, t, s, edges, w):
    Sm = (edges.R, edges.t, edges.s)
    i, j = edges.i.long(), edges.j.long()
    r = _edge_residual(Sm, (R[i], t[i], s[i]), (R[j], t[j], s[j]))
    return r, torch.sum(w * torch.sum(r * r, dim=-1))


def optimize_pose_graph_sim3(
    R: torch.Tensor,       # (K, 3, 3) S_iw rotations (world -> kf)
    t: torch.Tensor,       # (K, 3)
    s: torch.Tensor,       # (K,)
    edges: Sim3Edges,
    fixed: torch.Tensor,   # (K,) bool (e.g. the loop keyframe / map origin)
    n_iters: int = 12,
    lam: float = 1e-6,
    fix_scale: bool = False,
):
    """Damped Gauss-Newton over the Sim(3) pose graph. Returns (R, t, s, cost).

    ``fix_scale=True`` zeroes the log-scale part of every update: the 6-DoF
    essential graph the reference runs where scale is observable
    (stereo/RGB-D, ``OptimizeEssentialGraph6DoF``)."""
    K = R.shape[0]
    dtype, dev = t.dtype, t.device
    i, j = edges.i.long(), edges.j.long()
    ks = torch.arange(K, device=dev)
    Oi = (ks[:, None] == i[None, :]).to(dtype)  # (K, E) one-hot of each edge's vertices
    Oj = (ks[:, None] == j[None, :]).to(dtype)
    w = torch.where(edges.valid, edges.weight.to(dtype), 0.0)
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    free = (~fixed).to(dtype)[:, None]
    if fix_scale:
        free = free * torch.tensor([1.0] * 6 + [0.0], dtype=dtype, device=dev)
    lam_c = torch.tensor(lam, dtype=dtype, device=dev)
    Sm = (edges.R, edges.t, edges.s)
    # the residuals and cost at the current estimate: an accepted step's
    # candidate evaluation carries over, a rejected one keeps the old
    r, cost_old = _cost(R, t, s, edges, w)
    cost = cost_old
    for _ in range(n_iters):
        Si, Sj = (R[i], t[i], s[i]), (R[j], t[j], s[j])
        Ji, Jj = _edge_jacobians(Sm, Si, Sj)
        wJi = w[:, None, None] * Ji
        wJj = w[:, None, None] * Jj
        Hii = torch.einsum("eai,eaj->eij", wJi, Ji)
        Hjj = torch.einsum("eai,eaj->eij", wJj, Jj)
        Hij = torch.einsum("eai,eaj->eij", wJi, Jj)
        gi = torch.einsum("eai,ea->ei", Ji, w[:, None] * r)
        gj = torch.einsum("eai,ea->ei", Jj, w[:, None] * r)
        H = (torch.einsum("ae,be,exy->axby", Oi, Oi, Hii)
             + torch.einsum("ae,be,exy->axby", Oj, Oj, Hjj)
             + torch.einsum("ae,be,exy->axby", Oi, Oj, Hij)
             + torch.einsum("ae,be,eyx->axby", Oj, Oi, Hij))
        g = Oi @ gi + Oj @ gj
        # gauge + free-vertex damping on the block diagonal
        bump = torch.where(fixed, 1e12, lam_c + 1e-8)
        H[ks, :, ks, :] += bump[:, None, None] * eye7
        g = g * (~fixed).to(dtype)[:, None]
        # H is symmetric positive definite once damped: a Cholesky solve,
        # whose first call on the card costs ~20 ms where an LU's costs ~130;
        # a failed factorisation (info > 0) rejects its step like a worse cost
        L, info = torch.linalg.cholesky_ex(H.reshape(K * 7, K * 7))
        d = torch.cholesky_solve(-g.reshape(K * 7, 1), L).reshape(K, 7) * free
        Rn, tn, sn = sim3.compose(sim3.exp(d), (R, t, s))
        r_new, cost_new = _cost(Rn, tn, sn, edges, w)
        better = (info == 0) & (cost_new < cost_old)
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        s = torch.where(better, sn, s)
        r = torch.where(better, r_new, r)
        lam_c = torch.where(better, lam_c * 0.5, lam_c * 10.0)
        cost = cost_new
        cost_old = torch.where(better, cost_new, cost_old)
    return R, t, s, cost
