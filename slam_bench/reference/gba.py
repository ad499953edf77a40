"""Plain reference of the full-map bundle adjustment: Levenberg-Marquardt on
the pinhole reprojection error of every observation, with the landmarks
eliminated by an exact Schur complement and the reduced camera system
(6 K x 6 K) formed densely and solved by Cholesky, in float64.

The same problem as ``optim/gba.py`` ``global_bundle_adjust`` ends on: plain
least squares over the observations whose chi2 after the first phase is at
most 5.991 (the mono gate), keyframes marked fixed held.  Departures: no
Huber phase (it shapes the path, not the final least-squares optimum, for a
given set of inliers), no PCG (an exact solve), iterations until the cost
stops falling.  It imports torch and numpy only; ``dtype`` float32 with
TF32 on gives its lower-precision control.
"""

from __future__ import annotations

import torch

CHI2_MONO = 5.991


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    K = _skew(w)
    ths = torch.where(th < 1e-12, torch.ones_like(th), th)
    a = torch.where(th < 1e-12, 1.0 - th ** 2 / 6, torch.sin(ths) / ths)
    b = torch.where(th < 1e-12, 0.5 - th ** 2 / 24, (1 - torch.cos(ths)) / ths ** 2)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * K + b * (K @ K)


class Problem:
    """The observations (pose index, point index, pixel) and the camera."""

    def __init__(self, params, pose_idx, point_idx, uv, pose_fixed, dtype):
        self.fx, self.fy, self.cx, self.cy = (float(p) for p in params[:4])
        self.pi = pose_idx.long()
        self.li = point_idx.long()
        self.uv = uv.to(dtype)
        self.fixed = pose_fixed.bool()
        self.K = int(pose_fixed.shape[0])
        self.dtype = dtype

    def residuals(self, R, t, X):
        """(r (O, 2), xc (O, 3)): projection minus measurement.  Every point
        goes into every camera in one (3K, 4) x (4, M) product, from which
        the observed pairs are read."""
        P = torch.cat([R, t[:, :, None]], dim=2).reshape(3 * self.K, 4)
        Xh = torch.cat([X, torch.ones_like(X[:, :1])], dim=1)
        allc = (P @ Xh.T).reshape(self.K, 3, -1)
        xc = allc[self.pi, :, self.li]
        z = xc[:, 2]
        proj = torch.stack([self.fx * xc[:, 0] / z + self.cx, self.fy * xc[:, 1] / z + self.cy], -1)
        return proj - self.uv, xc

    def cost(self, R, t, X, active) -> torch.Tensor:
        r, _ = self.residuals(R, t, X)
        return torch.sum(torch.where(active[:, None], r, 0.0) ** 2)


def lm_step(p: Problem, R, t, X, active, lam):
    """One damped Gauss-Newton step; returns the candidate (R, t, X)."""
    dt, dev = p.dtype, p.uv.device
    r, xc = p.residuals(R, t, X)
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    zero = torch.zeros_like(z)
    Jproj = torch.stack([torch.stack([p.fx / z, zero, -p.fx * x / z ** 2], -1),
                         torch.stack([zero, p.fy / z, -p.fy * y / z ** 2], -1)], -2)
    # left perturbation of the pose: xc' = exp(phi) xc + rho
    Jxi = torch.cat([torch.eye(3, dtype=dt, device=dev).expand(len(z), 3, 3), -_skew(xc)], -1)
    Jp = Jproj @ Jxi                                   # (O, 2, 6)
    Jl = Jproj @ R[p.pi]                               # (O, 2, 3)
    m = (active & ~p.fixed[p.pi]).to(dt)[:, None, None]
    a = active.to(dt)[:, None, None]
    Jp, Jl, r = Jp * m, Jl * a, r * active.to(dt)[:, None]
    K, M = p.K, X.shape[0]
    Hpp = torch.zeros(K, 6, 6, dtype=dt, device=dev).index_add_(0, p.pi, Jp.mT @ Jp)
    Hll = torch.zeros(M, 3, 3, dtype=dt, device=dev).index_add_(0, p.li, Jl.mT @ Jl)
    gp = torch.zeros(K, 6, dtype=dt, device=dev).index_add_(0, p.pi, (Jp.mT @ r[..., None])[..., 0])
    gl = torch.zeros(M, 3, dtype=dt, device=dev).index_add_(0, p.li, (Jl.mT @ r[..., None])[..., 0])
    W = Jp.mT @ Jl                                     # (O, 6, 3)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hpp = Hpp + lam * Hpp * eye6 + p.fixed.to(dt)[:, None, None] * eye6
    Hll = Hll + lam * Hll * eye3 + 1e-9 * eye3
    Cinv = torch.linalg.inv(Hll)
    # dense W (6K, M, 3) and W C^-1
    Wd = torch.zeros(K, 6, M, 3, dtype=dt, device=dev)
    Wd[p.pi, :, p.li, :] = W
    Wd = Wd.reshape(6 * K, M, 3)
    WC = torch.einsum("kmi,mij->kmj", Wd, Cinv)
    S = torch.block_diag(*Hpp) - WC.reshape(6 * K, 3 * M) @ Wd.reshape(6 * K, 3 * M).T
    rhs = -gp.reshape(-1) + WC.reshape(6 * K, 3 * M) @ gl.reshape(-1)
    S = 0.5 * (S + S.T)
    L, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        dp = torch.linalg.lstsq(S, rhs[:, None]).solution[:, 0]
    else:
        dp = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    dp = dp.reshape(K, 6)
    utdp = torch.zeros(M, 3, dtype=dt, device=dev).index_add_(
        0, p.li, (W.mT @ dp[p.pi][..., None])[..., 0])
    dl = torch.einsum("mij,mj->mi", Cinv, -gl - utdp)
    dR = _exp_so3(dp[:, 3:])
    R_new = dR @ R
    t_new = torch.einsum("kij,kj->ki", dR, t) + dp[:, :3]
    return R_new, t_new, X + dl


def solve(p: Problem, R, t, X, active, max_iters: int = 20, tol: float = 1e-12):
    """LM until the relative cost decrease falls under ``tol``."""
    lam = 1e-4
    cost = float(p.cost(R, t, X, active))
    for _ in range(max_iters):
        R1, t1, X1 = lm_step(p, R, t, X, active, lam)
        c1 = float(p.cost(R1, t1, X1, active))
        if c1 < cost:
            done = (cost - c1) <= tol * cost
            R, t, X, cost, lam = R1, t1, X1, c1, lam * 0.5
            if done:
                break
        else:
            lam *= 5.0
    return R, t, X


def global_ba(params, pose_idx, point_idx, uv, pose_fixed, R0, t0, X0, dtype=torch.float64):
    """(R, t, X, active): the optimum over every observation, then over the
    observations whose chi2 there is at most 5.991."""
    p = Problem(params, pose_idx, point_idx, uv, pose_fixed, dtype)
    R, t, X = R0.to(dtype), t0.to(dtype), X0.to(dtype)
    active = torch.ones(len(p.pi), dtype=torch.bool, device=uv.device)
    R, t, X = solve(p, R, t, X, active)
    r, _ = p.residuals(R, t, X)
    active = (r ** 2).sum(-1) <= CHI2_MONO
    R, t, X = solve(p, R, t, X, active)
    return R, t, X, active
