"""Inertial optimisation: IMU initialisation and the inertial residual
(port of :mod:`orb_slam3_noted_tpu.optim.inertial`).

- :func:`imu_residual`: the 9-dim preintegration residual (er, ev, ep) of
  ``EdgeInertial``, batched over leading dims.
- :func:`inertial_init`: ``Optimizer::InertialOptimization`` with keyframe
  poses fixed from the visual map: scale, gravity direction, per-keyframe
  velocities and a shared gyro/acc bias from the preintegrated segments,
  seeded in closed form (:func:`_linear_seed`).
- :func:`apply_scaled_rotation`: ``Map::ApplyScaledRotation``.

The JAX package takes the Jacobian of the initialisation's residual with
``jax.jacfwd``; here it is central differences in float64 along every
parameter, all of them in one batched evaluation (the solve runs a few
times a lap).  Dense solves are Cholesky factorisations
(``cholesky_ex``): a failed factorisation rejects its step, or carries NaN
where there is no step to reject, as the JAX package's solves return NaN.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry import so3
from orb_slam3_noted_tpu_torch.imu.preintegration import GRAVITY, Preintegrated
from orb_slam3_noted_tpu_torch.utils.interop import const_tensor, set_scalar


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _gravity_down(like: torch.Tensor) -> torch.Tensor:
    return const_tensor((0.0, 0.0, -GRAVITY), like.dtype, like.device)


def gravity_vec(gdir: torch.Tensor) -> torch.Tensor:
    """g = Rwg(gdir) @ (0, 0, -G) with a 2-dof rotation (VertexGDir);
    batched over ``gdir``'s leading dims."""
    w = torch.cat([gdir, torch.zeros_like(gdir[..., :1])], dim=-1)
    return _mv(so3.exp(w), _gravity_down(gdir))


def imu_residual(Ri, pi, vi, Rj, pj, vj, bg, ba, p: Preintegrated, g):
    """(..., 9) preintegration residual between body states i and j:
    er = Log(dR(bg)^T Ri^T Rj), ev = Ri^T (vj - vi - g dt) - dV(bg, ba),
    ep = Ri^T (pj - pi - vi dt - 0.5 g dt^2) - dP(bg, ba)."""
    dbg = bg - p.bias.bg
    dba = ba - p.bias.ba
    dR = p.dR @ so3.exp(_mv(p.JRg, dbg))
    dV = p.dV + _mv(p.JVg, dbg) + _mv(p.JVa, dba)
    dP = p.dP + _mv(p.JPg, dbg) + _mv(p.JPa, dba)
    dt = p.dT[..., None]
    RiT = Ri.transpose(-1, -2)
    er = so3.log(dR.transpose(-1, -2) @ RiT @ Rj)
    ev = _mv(RiT, vj - vi - g * dt) - dV
    ep = _mv(RiT, pj - pi - vi * dt - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep], dim=-1)


def whitener(preints: Preintegrated, eps: float = 1e-12) -> torch.Tensor:
    """(E, 9, 9) upper-triangular whitening W with r^T C^-1 r = |W r|^2:
    W = chol(C^-1)^T, C = C[0:9, 0:9] of each preintegration (the reference
    weights ``EdgeInertial`` by Info = C^-1).  An edge whose covariance does
    not factor carries NaN."""
    C9 = preints.C[..., :9, :9]
    C9 = C9 + eps * torch.eye(9, dtype=C9.dtype, device=C9.device)
    L0, info0 = torch.linalg.cholesky_ex(C9)
    info = torch.cholesky_inverse(L0)
    # symmetrise for numerical safety before the Cholesky
    info = 0.5 * (info + info.transpose(-1, -2))
    L, info1 = torch.linalg.cholesky_ex(info)
    bad = ((info0 != 0) | (info1 != 0))[..., None, None]
    return torch.where(bad, torch.nan, L.transpose(-1, -2))


def _spd_solve(H: torch.Tensor, b: torch.Tensor):
    """(x, ok): x = H^-1 b by Cholesky, ok false where H did not factor."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.cholesky_solve(b[..., None], L)[..., 0], info == 0


def _nan_unless(ok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, x, torch.nan)


def _linear_seed(Rwb, twb, preints: Preintegrated, valid):
    """Closed-form seed for the IMU-init Gauss-Newton (avoids the
    scale/gravity local minimum of the coupled problem started from s = 1,
    g = -z): the gyro bias from the rotation residuals through JRg, then
    with rotations fixed the linear least squares of (ev, ep) in metric
    scale s, gravity g and metric velocities u_k, refined with |g| = G (the
    VINS-Mono "RefineGravity" step).  Returns (log_s, gdir2, bg, v_visual)."""
    K = Rwb.shape[0]
    dtype, dev = twb.dtype, twb.device
    E = K - 1
    vm = valid.to(dtype)

    # 1. gyro bias from er(bg) ~ Log(dR^T Ri^T Rj) - JRg (bg - b0) = 0
    eRs = so3.log(preints.dR.transpose(-1, -2) @ Rwb[:E].transpose(-1, -2) @ Rwb[1:])
    A = preints.JRg * vm[:, None, None]
    b = eRs * vm[:, None]
    AtA = torch.einsum("eij,eik->jk", A, A) + 1e-9 * torch.eye(3, dtype=dtype, device=dev)
    dbg_ls, ok = _spd_solve(AtA, torch.einsum("eij,ei->j", A, b))
    bg = _nan_unless(ok, preints.bias.bg[0] + dbg_ls)

    # 2. linear LS for [s, g(3), u_0..u_{K-1}]
    dbg = bg - preints.bias.bg
    dV = preints.dV + _mv(preints.JVg, dbg)
    dP = preints.dP + _mv(preints.JPg, dbg)
    dt = preints.dT
    n_u = 4 + 3 * K
    RiT = Rwb[:E].transpose(-1, -2)
    dt3 = dt[:, None, None]
    ks = torch.arange(K, device=dev)
    on_k = (ks[None, :] == torch.arange(E, device=dev)[:, None]).to(dtype)        # (E, K)
    on_k1 = (ks[None, :] == torch.arange(1, K, device=dev)[:, None]).to(dtype)
    # velocity columns: u_k and u_{k+1} blocks scattered by one-hot rows
    ev_u = (-RiT[:, :, None, :] * on_k[:, None, :, None]
            + RiT[:, :, None, :] * on_k1[:, None, :, None]).reshape(E, 3, 3 * K)
    ep_u = (-RiT * dt3)[:, :, None, :] * on_k[:, None, :, None]
    ep_u = ep_u.reshape(E, 3, 3 * K)
    ep_s = _mv(RiT, twb[1:] - twb[:E])[..., None]
    rows_v = torch.cat([torch.zeros_like(ep_s), -RiT * dt3, ev_u], dim=-1)
    rows_p = torch.cat([ep_s, -0.5 * RiT * dt3 * dt3, ep_u], dim=-1)
    A2 = (torch.cat([rows_v, rows_p], dim=1) * vm[:, None, None]).reshape(-1, n_u)
    b2 = (torch.cat([dV, dP], dim=-1) * vm[:, None]).reshape(-1)
    H = A2.T @ A2 + 1e-8 * torch.eye(n_u, dtype=dtype, device=dev)
    x, ok2 = _spd_solve(H, A2.T @ b2)
    g = x[1:4]
    ok = ok & ok2

    # refine with |g| = G: g = G gn0 + B dg, B a tangent basis of gn0
    A_g = A2[:, 1:4]
    eye_r = 1e-8 * torch.eye(n_u - 1, dtype=dtype, device=dev)
    e_x = const_tensor((1.0, 0.0, 0.0), dtype, dev)
    e_y = const_tensor((0.0, 1.0, 0.0), dtype, dev)
    for _ in range(4):
        gn0 = g / torch.clamp(torch.linalg.vector_norm(g), min=1e-9)
        tmp = torch.where(gn0[0].abs() < 0.9, e_x, e_y)
        b1v = torch.linalg.cross(gn0, tmp)
        b1v = b1v / torch.clamp(torch.linalg.vector_norm(b1v), min=1e-9)
        b2v = torch.linalg.cross(gn0, b1v)
        Bt = torch.stack([b1v, b2v], dim=1)  # (3, 2)
        rhs = b2 - A_g @ (GRAVITY * gn0)
        A_r = torch.cat([A2[:, 0:1], A_g @ Bt, A2[:, 4:]], dim=1)
        xr, okr = _spd_solve(A_r.T @ A_r + eye_r, A_r.T @ rhs)
        ok = ok & okr
        g = GRAVITY * gn0 + Bt @ xr[1:3]
    s = torch.clamp(xr[0], 1e-3, 1e4)
    u = xr[3:].reshape(K, 3)

    # gravity direction -> 2-dof tangent: Rwg @ (0, 0, -G) = G g / |g|
    gn = g / torch.clamp(torch.linalg.vector_norm(g), min=1e-9)
    gI = const_tensor((0.0, 0.0, -1.0), dtype, dev)
    axis = torch.linalg.cross(gI, gn)
    sin_a = torch.linalg.vector_norm(axis)
    ang = torch.atan2(sin_a, torch.dot(gI, gn))
    w = axis / torch.clamp(sin_a, min=1e-9) * ang
    gdir = torch.where(sin_a < 1e-9, torch.zeros_like(w), w)[:2]
    return (_nan_unless(ok, torch.log(s)), _nan_unless(ok, gdir), bg, _nan_unless(ok, u / s))


class InertialInitResult(NamedTuple):
    scale: torch.Tensor       # ()
    gdir: torch.Tensor        # (2,) tangent of the gravity rotation
    g_world: torch.Tensor     # (3,) gravity in the (unscaled) visual world
    bg: torch.Tensor          # (3,)
    ba: torch.Tensor          # (3,)
    velocities: torch.Tensor  # (K, 3) body velocities at the visual scale
    cost: torch.Tensor
    scale_sigma: torch.Tensor  # () marginal std of log-scale (observability gate)


def _init_residuals(th, Rwb, twb, preints: Preintegrated, W, vm, sq_g, sq_a, fix_scale: bool):
    """Residual vector(s) of the initialisation at parameters ``th`` (...,
    n_par) = [log_s, gdir (2), bg, ba, v (K x 3)]: the whitened segment
    residuals at metric scale, then the bias priors."""
    K = Rwb.shape[0]
    lead = th.shape[:-1]
    s = torch.ones_like(th[..., 0]) if fix_scale else torch.exp(th[..., 0])
    g = gravity_vec(th[..., 1:3])
    bg, ba = th[..., 3:6], th[..., 6:9]
    v = th[..., 9:].reshape(*lead, K, 3)
    s1 = s[..., None, None]
    pos = s1 * twb
    vel = s1 * v
    r = imu_residual(Rwb[:-1], pos[..., :-1, :], vel[..., :-1, :], Rwb[1:], pos[..., 1:, :],
                     vel[..., 1:, :], bg[..., None, :], ba[..., None, :], preints,
                     g[..., None, :])
    r = _mv(W, r) * vm[:, None]
    return torch.cat([r.reshape(*lead, -1), sq_g * bg, sq_a * ba], dim=-1)


def _jacobian(fn, th: torch.Tensor, h: float = 1e-6) -> torch.Tensor:
    """(R, n) Jacobian of ``fn`` at ``th`` by central differences in float64,
    the 2n evaluations in one batch (``fn`` evaluates a leading batch)."""
    n = th.shape[0]
    step = h * torch.eye(n, dtype=torch.float64, device=th.device)
    r = fn(th.to(torch.float64) + torch.cat([step, -step]))
    return ((r[:n] - r[n:]) / (2.0 * h)).T.to(th.dtype)


def inertial_init(Rwb, twb, preints: Preintegrated, valid, prior_g: float = 1e2,
                  prior_a: float = 1e6, n_iters: int = 20,
                  fix_scale: bool = False) -> InertialInitResult:
    """Scale, gravity, biases and velocities with poses fixed (Levenberg-
    Marquardt from the closed-form seed).  The metric state is
    twb_metric = scale * twb, v_metric = scale * v.  ``prior_g`` and
    ``prior_a`` are the reference's staged bias priors."""
    K = Rwb.shape[0]
    dtype, dev = twb.dtype, twb.device
    n_par = 9 + 3 * K
    W = whitener(preints)
    vm = valid.to(dtype)
    sq_g, sq_a = float(prior_g) ** 0.5, float(prior_a) ** 0.5
    f32 = lambda th: _init_residuals(th, Rwb, twb, preints, W, vm, sq_g, sq_a, fix_scale)
    p64 = Preintegrated(*(f.to(torch.float64) for f in preints[:-1]),
                        bias=type(preints.bias)(*(b.to(torch.float64) for b in preints.bias)))
    args64 = (Rwb.to(torch.float64), twb.to(torch.float64), p64, W.to(torch.float64),
              vm.to(torch.float64), sq_g, sq_a, fix_scale)
    f64 = lambda th: _init_residuals(th, *args64)

    log_s0, gdir0, bg0, v0 = _linear_seed(Rwb, twb, preints, valid)
    zero = torch.zeros(1, dtype=dtype, device=dev)
    th = torch.cat([zero if fix_scale else log_s0[None], gdir0, bg0, torch.zeros(3, dtype=dtype,
                                                                                   device=dev),
                    v0.reshape(-1)]).to(dtype)
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    eye = 1e-10 * torch.eye(n_par, dtype=dtype, device=dev)
    r = f32(th)
    for _ in range(n_iters):
        J = _jacobian(f64, th)
        H = J.T @ J
        Hd = H + lam * torch.diag(torch.diagonal(H)) + eye
        d, ok = _spd_solve(Hd, -(J.T @ r))
        th_new = th + d
        r_new = f32(th_new)
        better = ok & (torch.sum(r_new ** 2) < torch.sum(r ** 2))
        th = torch.where(better, th_new, th)
        r = torch.where(better, r_new, r)
        lam = torch.where(better, lam * 0.5, lam * 10.0)
    cost = torch.sum(r ** 2)
    # marginal covariance of log_s from the Gauss-Newton Hessian, scaled by
    # the residual variance factor
    Jf = _jacobian(f64, th)
    Hf = Jf.T @ Jf + eye
    e0 = torch.zeros(n_par, dtype=dtype, device=dev)
    set_scalar(e0, 0, 1.0)
    col0, ok = _spd_solve(Hf, e0)
    dof = max(Jf.shape[0] - n_par, 1)
    var_factor = torch.clamp(cost / dof, min=1.0)
    scale_sigma = _nan_unless(ok, torch.sqrt(torch.clamp(col0[0] * var_factor, min=0.0)))
    s = torch.ones_like(th[0]) if fix_scale else torch.exp(th[0])
    gdir = th[1:3]
    return InertialInitResult(
        scale=s, gdir=gdir, g_world=gravity_vec(gdir), bg=th[3:6], ba=th[6:9],
        velocities=th[9:].reshape(K, 3), cost=cost, scale_sigma=scale_sigma,
    )


def apply_scaled_rotation(kf_Rcw, kf_tcw, mp_pos, Ryw, scale):
    """Gravity-align (rotate the world by Ryw) and rescale
    (``Map::ApplyScaledRotation``): x_w' = scale Ryw x_w; Rcw' = Rcw Ryw^T,
    tcw' = scale tcw.  Returns (kf_Rcw', kf_tcw', mp_pos')."""
    return (torch.einsum("kij,lj->kil", kf_Rcw, Ryw), scale * kf_tcw,
            scale * torch.einsum("ij,nj->ni", Ryw, mp_pos))
