"""Pose-graph (essential graph) optimisation (port of
:mod:`orb_slam3_noted_tpu.optim.pose_graph`): the Sim(3) graph and the
4-DoF graph of gravity-aligned inertial maps.

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

:func:`optimize_pose_graph_4dof` (``OptimizeEssentialGraph4DoF``) moves
each keyframe by a yaw about the gravity axis and a translation only, so a
loop correction cannot tilt the gravity direction the IMU made
observable; its Jacobians are central differences in float64 too.

:func:`distributed_pose_graph_sim3` splits the Sim(3) graph's edge table
over a mesh of ranks (``parallel/dist_ba.py``): each rank evaluates its
edges, the normal equations and every cost the LM step compares are
summed over the mesh, and every rank solves the same system.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry import se3, sim3


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
    psum=None,
):
    """Damped Gauss-Newton over the Sim(3) pose graph. Returns (R, t, s, cost).

    ``fix_scale=True`` zeroes the log-scale part of every update: the 6-DoF
    essential graph the reference runs where scale is observable
    (stereo/RGB-D, ``OptimizeEssentialGraph6DoF``).  ``psum``: the sum over
    a mesh where ``edges`` is this rank's share of the table; it reduces the
    assembled normal equations and every cost."""
    if psum is None:
        psum = lambda x: x
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
    cost_old = psum(cost_old)
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
        H, g = psum(H), psum(Oi @ gi + Oj @ gj)
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
        cost_new = psum(cost_new)
        better = (info == 0) & (cost_new < cost_old)
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        s = torch.where(better, sn, s)
        r = torch.where(better, r_new, r)
        lam_c = torch.where(better, lam_c * 0.5, lam_c * 10.0)
        cost = cost_new
        cost_old = torch.where(better, cost_new, cost_old)
    return R, t, s, cost


def distributed_pose_graph_sim3(
    mesh,
    R: torch.Tensor,
    t: torch.Tensor,
    s: torch.Tensor,
    edges: Sim3Edges,
    fixed: torch.Tensor,
    n_iters: int = 12,
    lam: float = 1e-6,
    fix_scale: bool = False,
):
    """:func:`optimize_pose_graph_sim3` with the edge table split over
    ``mesh`` (``parallel.dist_ba.make_mesh``): padded to a multiple of the
    mesh size with identity edges of weight 0 that are not valid, rank s
    takes the s-th contiguous slice.  Every rank passes the whole graph.
    Returns (R, t, s, cost), the same on every rank."""
    n = mesh.size
    E = edges.i.shape[0]
    pad = (-E) % n
    if pad:
        dev = edges.R.device
        edges = Sim3Edges(
            i=torch.cat([edges.i, torch.zeros(pad, dtype=edges.i.dtype, device=dev)]),
            j=torch.cat([edges.j, torch.zeros(pad, dtype=edges.j.dtype, device=dev)]),
            R=torch.cat([edges.R, torch.eye(3, dtype=edges.R.dtype, device=dev).expand(pad, 3, 3)]),
            t=torch.cat([edges.t, torch.zeros((pad, 3), dtype=edges.t.dtype, device=dev)]),
            s=torch.cat([edges.s, torch.ones(pad, dtype=edges.s.dtype, device=dev)]),
            weight=torch.cat([edges.weight,
                              torch.zeros(pad, dtype=edges.weight.dtype, device=dev)]),
            valid=torch.cat([edges.valid, torch.zeros(pad, dtype=torch.bool, device=dev)]))
    per = (E + pad) // n
    mine = Sim3Edges(*(x[mesh.rank * per:(mesh.rank + 1) * per] for x in edges))
    return optimize_pose_graph_sim3(R, t, s, mine, fixed, n_iters, lam, fix_scale,
                                    psum=mesh.psum)


# ---------------------------------------------------------------------------
# 4-DoF pose graph (yaw + translation) for the gravity-aligned inertial case
# ---------------------------------------------------------------------------


class SE3Edges(NamedTuple):
    """Relative SE(3) edge table: measurement T_ji = T_j T_i^-1."""

    i: torch.Tensor       # (E,) int32
    j: torch.Tensor       # (E,) int32
    R: torch.Tensor       # (E, 3, 3)
    t: torch.Tensor       # (E, 3)
    weight: torch.Tensor  # (E,)
    valid: torch.Tensor   # (E,) bool


def _rz(psi: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation by ``psi`` about the world z (gravity) axis."""
    c, s = torch.cos(psi), torch.sin(psi)
    z, o = torch.zeros_like(psi), torch.ones_like(psi)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _apply_4dof(Ti, d):
    """World-side 4-DoF update of a world -> keyframe pose, d = (yaw, dt):
    the keyframe's centre moves to Rz(yaw) c + dt, its orientation yaws
    (``VertexPose4DoF``)."""
    Ri, ti = Ti
    Rn = Ri @ _rz(d[..., 0]).transpose(-1, -2)
    return Rn, ti - torch.einsum("...ij,...j->...i", Rn, d[..., 1:])


def _edge_residual_se3(Tm, Ti, Tj):
    return se3.log(se3.compose(Tm, se3.compose(Ti, se3.inverse(Tj))))


def _residual_tangent_4dof(Tm, Ti, Tj, di, dj):
    return _edge_residual_se3(Tm, _apply_4dof(Ti, di), _apply_4dof(Tj, dj))


def _edge_jacobians_4dof(Tm, Ti, Tj, h: float = 1e-6):
    """(Ji, Jj), (E, 6, 4) each, by central differences in float64 along the
    8 tangent directions of the edge's two vertices, in one batch."""
    E = Tm[1].shape[0]
    dev = Tm[1].device
    T64 = [tuple(x.to(torch.float64) for x in T) for T in (Tm, Ti, Tj)]
    step = h * torch.eye(8, dtype=torch.float64, device=dev)
    step = torch.cat([step, -step])[:, None, :].expand(16, E, 8)
    r = _residual_tangent_4dof(*T64, step[..., :4], step[..., 4:])  # (16, E, 6)
    J = ((r[:8] - r[8:]) / (2.0 * h)).permute(1, 2, 0).to(Tm[1].dtype)
    return J[..., :4], J[..., 4:]


def optimize_pose_graph_4dof(
    R: torch.Tensor,       # (K, 3, 3) T_iw rotations (world -> kf)
    t: torch.Tensor,       # (K, 3)
    edges: SE3Edges,
    fixed: torch.Tensor,   # (K,) bool
    n_iters: int = 12,
    lam: float = 1e-6,
):
    """Damped Gauss-Newton over the yaw + translation pose graph. Returns
    (R, t, cost)."""
    K = R.shape[0]
    dtype, dev = t.dtype, t.device
    i, j = edges.i.long(), edges.j.long()
    ks = torch.arange(K, device=dev)
    Oi = (ks[:, None] == i[None, :]).to(dtype)
    Oj = (ks[:, None] == j[None, :]).to(dtype)
    w = torch.where(edges.valid, edges.weight.to(dtype), 0.0)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    free = (~fixed).to(dtype)[:, None]
    lam_c = torch.full((), lam, dtype=dtype, device=dev)
    Tm = (edges.R, edges.t)

    def evaluate(R, t):
        r = _edge_residual_se3(Tm, (R[i], t[i]), (R[j], t[j]))
        return r, torch.sum(w * torch.sum(r * r, dim=-1))

    r, cost_old = evaluate(R, t)
    cost = cost_old
    for _ in range(n_iters):
        Ji, Jj = _edge_jacobians_4dof(Tm, (R[i], t[i]), (R[j], t[j]))
        wJi = w[:, None, None] * Ji
        wJj = w[:, None, None] * Jj
        Hij = torch.einsum("eai,eaj->eij", wJi, Jj)
        H = (torch.einsum("ae,be,exy->axby", Oi, Oi, torch.einsum("eai,eaj->eij", wJi, Ji))
             + torch.einsum("ae,be,exy->axby", Oj, Oj, torch.einsum("eai,eaj->eij", wJj, Jj))
             + torch.einsum("ae,be,exy->axby", Oi, Oj, Hij)
             + torch.einsum("ae,be,eyx->axby", Oj, Oi, Hij))
        g = (Oi @ torch.einsum("eai,ea->ei", Ji, w[:, None] * r)
             + Oj @ torch.einsum("eai,ea->ei", Jj, w[:, None] * r))
        bump = torch.where(fixed, 1e12, lam_c + 1e-8)
        H[ks, :, ks, :] += bump[:, None, None] * eye4
        g = g * free
        # positive definite once damped: Cholesky, a failed factorisation
        # rejects its step as a worse cost does
        L, info = torch.linalg.cholesky_ex(H.reshape(K * 4, K * 4))
        d = torch.cholesky_solve(-g.reshape(K * 4, 1), L).reshape(K, 4) * free
        Rn, tn = _apply_4dof((R, t), d)
        r_new, cost_new = evaluate(Rn, tn)
        better = (info == 0) & (cost_new < cost_old)
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        r = torch.where(better, r_new, r)
        lam_c = torch.where(better, lam_c * 0.5, lam_c * 10.0)
        cost = cost_new
        cost_old = torch.where(better, cost_new, cost_old)
    return R, t, cost
