"""On-manifold IMU preintegration (port of :mod:`orb_slam3_noted_tpu.imu.preintegration`).

Forster et al. 2016 as the reference's ``Preintegrated::
IntegrateNewMeasurement``: the state {dT, dR, dV, dP}, the bias Jacobians
{JRg, JVg, JVa, JPg, JPa}, the 15x15 covariance propagated with the A/B
matrices of Forster's appendix, and the first-order bias-correction getters.

:func:`integrate_measurements` takes a leading batch of segments, (S, N, 3)
samples with dt = 0 for padding (an exact no-op of the recursion, as in the
JAX package), and steps only as far as the longest real segment: the JAX
package scans every padded sample.  The state-independent parts of each
step (the bias-corrected samples, Exp and the right Jacobian of each gyro
increment) are computed for all samples at once; the recursion itself is a
Python loop over samples with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry import so3
from orb_slam3_noted_tpu_torch.utils.interop import const_tensor

GRAVITY = 9.81  # reference: include/ImuTypes.h:40 (GRAVITY_VALUE)


class Bias(NamedTuple):
    """Gyro + accelerometer bias (reference ``IMU::Bias``)."""

    bg: torch.Tensor  # (..., 3) gyro bias
    ba: torch.Tensor  # (..., 3) accel bias

    @staticmethod
    def zero(dtype=torch.float32, device=None) -> "Bias":
        return Bias(torch.zeros(3, dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device))


class Calib(NamedTuple):
    """IMU calibration (reference ``IMU::Calib``): camera-to-body transform
    and discrete-time noise and random-walk variances."""

    Rbc: torch.Tensor
    tbc: torch.Tensor
    cov_ng: torch.Tensor      # scalar or (3,)
    cov_na: torch.Tensor
    cov_walk_g: torch.Tensor
    cov_walk_a: torch.Tensor


class Preintegrated(NamedTuple):
    """Preintegration state between two frames/keyframes (leading batch
    dims allowed on every field)."""

    dT: torch.Tensor   # () total time
    dR: torch.Tensor   # (3, 3)
    dV: torch.Tensor   # (3,)
    dP: torch.Tensor   # (3,)
    JRg: torch.Tensor  # (3, 3) d(dR)/d(bg)
    JVg: torch.Tensor  # (3, 3)
    JVa: torch.Tensor  # (3, 3)
    JPg: torch.Tensor  # (3, 3)
    JPa: torch.Tensor  # (3, 3)
    C: torch.Tensor    # (15, 15) covariance [dR dV dP bg ba]
    bias: Bias         # bias used during integration


def init_preintegrated(bias: Bias, batch: tuple = ()) -> Preintegrated:
    """The empty preintegration (identity rotation, zero covariance) with
    leading dims ``batch``, on ``bias``' device and dtype."""
    dt, dev = bias.bg.dtype, bias.bg.device
    z33 = torch.zeros((*batch, 3, 3), dtype=dt, device=dev)
    z3 = torch.zeros((*batch, 3), dtype=dt, device=dev)
    return Preintegrated(
        dT=torch.zeros(batch, dtype=dt, device=dev),
        dR=torch.eye(3, dtype=dt, device=dev).expand(*batch, 3, 3).clone(),
        dV=z3, dP=z3.clone(),
        JRg=z33, JVg=z33.clone(), JVa=z33.clone(), JPg=z33.clone(), JPa=z33.clone(),
        C=torch.zeros((*batch, 15, 15), dtype=dt, device=dev),
        bias=Bias(bias.bg.expand(*batch, 3), bias.ba.expand(*batch, 3)),
    )


def _diag3(v, like: torch.Tensor) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(v, dtype=like.dtype, device=like.device), (3,))


def integrate_measurements(
    bias: Bias,
    acc: torch.Tensor,
    gyr: torch.Tensor,
    dts: torch.Tensor,
    calib: Calib,
    n_steps: int | None = None,
) -> Preintegrated:
    """Integrate (S, N, 3) accelerometer/gyro samples with (S, N) time steps
    (0 for padding) per segment; ``bias`` is shared or (S, 3) per segment.
    Steps through the first ``n_steps`` samples (default N): the caller
    passes the longest real count, which it knows on the host.  Equivalent
    to calling the reference's ``IntegrateNewMeasurement`` once per sample.
    Unbatched (N, 3) input gives an unbatched result."""
    if acc.dim() == 2:
        p = integrate_measurements(Bias(bias.bg[None], bias.ba[None]), acc[None], gyr[None],
                                   dts[None], calib, n_steps)
        return Preintegrated(*(f[0] for f in p[:-1]), bias=Bias(bias.bg, bias.ba))
    S, N = dts.shape
    n = N if n_steps is None else min(int(n_steps), N)
    dtype, dev = acc.dtype, acc.device
    bg = bias.bg.expand(S, 3)
    ba = bias.ba.expand(S, 3)
    state = init_preintegrated(Bias(bg, ba), (S,))
    dT, dR, dV, dP = state.dT, state.dR, state.dV, state.dP
    JRg, JVg, JVa, JPg, JPa, C = state.JRg, state.JVg, state.JVa, state.JPg, state.JPa, state.C
    if n == 0:
        return state
    # the state-independent parts of every step, for all samples at once
    a_all = acc[:, :n] - ba[:, None, :]                 # (S, n, 3)
    w_all = gyr[:, :n] - bg[:, None, :]
    d_all = dts[:, :n]
    phi = w_all * d_all[..., None]
    dRi_all = so3.exp(phi)                              # (S, n, 3, 3)
    Jr_all = so3.right_jacobian(phi)
    W_all = so3.hat(a_all)
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(S, 3, 3)
    z33 = torch.zeros((S, 3, 3), dtype=dtype, device=dev)
    n_ga = torch.cat([_diag3(calib.cov_ng, acc), _diag3(calib.cov_na, acc)])  # (6,)
    walk = torch.cat([_diag3(calib.cov_walk_g, acc), _diag3(calib.cov_walk_a, acc)])
    ii = torch.arange(9, 15, device=dev)
    for k in range(n):
        a, dt, dRi, rightJ, Wacc = a_all[:, k], d_all[:, k], dRi_all[:, k], Jr_all[:, k], W_all[:, k]
        dt1 = dt[:, None]
        dt2 = dt[:, None, None]
        dRa = torch.einsum("sij,sj->si", dR, a)
        # position/velocity first (with the pre-update dR), as the reference
        dP_new = dP + dV * dt1 + 0.5 * dRa * dt1 * dt1
        dV_new = dV + dRa * dt1
        dRW = dR @ Wacc
        dRWJ = dRW @ JRg
        JPa_new = JPa + JVa * dt2 - 0.5 * dR * dt2 * dt2
        JPg_new = JPg + JVg * dt2 - 0.5 * dt2 * dt2 * dRWJ
        JVa_new = JVa - dR * dt2
        JVg_new = JVg - dt2 * dRWJ
        dR_new = so3.normalize(dR @ dRi)
        JRg_new = dRi.transpose(-1, -2) @ JRg - rightJ * dt2
        # covariance: x = [dR dV dP], A (9x9), B (9x6)
        A = torch.cat([
            torch.cat([dRi.transpose(-1, -2), z33, z33], dim=-1),
            torch.cat([-(dR * dt2) @ Wacc, eye3, z33], dim=-1),
            torch.cat([-0.5 * dt2 * dt2 * dRW, eye3 * dt2, eye3], dim=-1),
        ], dim=-2)
        B = torch.cat([
            torch.cat([rightJ * dt2, z33], dim=-1),
            torch.cat([z33, dR * dt2], dim=-1),
            torch.cat([z33, 0.5 * dR * dt2 * dt2], dim=-1),
        ], dim=-2)
        C9 = A @ C[:, :9, :9] @ A.transpose(-1, -2) + (B * n_ga) @ B.transpose(-1, -2)
        C = C.clone()
        C[:, :9, :9] = C9
        C[:, ii, ii] += walk * (dt > 0).to(dtype)[:, None]
        dT = dT + dt
        dR, dV, dP = dR_new, dV_new, dP_new
        JRg, JVg, JVa, JPg, JPa = JRg_new, JVg_new, JVa_new, JPg_new, JPa_new
    return Preintegrated(dT=dT, dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg,
                         JPa=JPa, C=C, bias=Bias(bg, ba))


def stack(pres: list) -> Preintegrated:
    """Stack unbatched (or equally batched) preintegrations along a new
    leading dim."""
    return Preintegrated(*(torch.stack(f) for f in zip(*(p[:-1] for p in pres))),
                         bias=Bias(torch.stack([p.bias.bg for p in pres]),
                                   torch.stack([p.bias.ba for p in pres])))


def index(p: Preintegrated, i) -> Preintegrated:
    """Row(s) ``i`` of a batched preintegration."""
    return Preintegrated(*(f[i] for f in p[:-1]), bias=Bias(p.bias.bg[i], p.bias.ba[i]))


# --- first-order bias-corrected getters (reference GetDelta*) -------------

def delta_rotation(p: Preintegrated, b: Bias) -> torch.Tensor:
    dbg = b.bg - p.bias.bg
    return so3.normalize(p.dR @ so3.exp(torch.einsum("...ij,...j->...i", p.JRg, dbg)))


def delta_velocity(p: Preintegrated, b: Bias) -> torch.Tensor:
    dbg = b.bg - p.bias.bg
    dba = b.ba - p.bias.ba
    mv = lambda M, v: torch.einsum("...ij,...j->...i", M, v)
    return p.dV + mv(p.JVg, dbg) + mv(p.JVa, dba)


def delta_position(p: Preintegrated, b: Bias) -> torch.Tensor:
    dbg = b.bg - p.bias.bg
    dba = b.ba - p.bias.ba
    mv = lambda M, v: torch.einsum("...ij,...j->...i", M, v)
    return p.dP + mv(p.JPg, dbg) + mv(p.JPa, dba)


def predict_state(Rwb1: torch.Tensor, twb1: torch.Tensor, v1: torch.Tensor, p: Preintegrated,
                  b: Bias):
    """Dead-reckon the body state across the preintegrated interval
    (``Tracking::PredictStateIMU``): R2 = R1 dR, v2 = v1 + g t + R1 dV,
    t2 = t1 + v1 t + 0.5 g t^2 + R1 dP; batched over ``p``'s leading dims."""
    g = const_tensor((0.0, 0.0, -GRAVITY), twb1.dtype, twb1.device)
    t = p.dT[..., None]
    mv = lambda M, v: torch.einsum("...ij,...j->...i", M, v)
    R2 = so3.normalize(Rwb1 @ delta_rotation(p, b))
    v2 = v1 + g * t + mv(Rwb1, delta_velocity(p, b))
    t2 = twb1 + v1 * t + 0.5 * g * t * t + mv(Rwb1, delta_position(p, b))
    return R2, t2, v2
