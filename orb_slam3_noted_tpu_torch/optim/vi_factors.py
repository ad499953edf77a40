"""Visual-inertial factor library (port of :mod:`orb_slam3_noted_tpu.optim.vi_factors`).

The reference's inertial factor graph types, batched:

- body-frame reprojection residuals (``EdgeMono/EdgeStereo`` on a
  ``VertexPose``), with the update-in-body-frame parameterisation of
  ``ImuCamPose::Update``: ``twb += Rwb dt; Rwb = Rwb Exp(dphi)``;
- :func:`inertial_edge_residuals` = ``EdgeInertial``, whitened by the
  preintegration information;
- :func:`bias_rw_residuals` = ``EdgeGyroRW``/``EdgeAccRW``;
- :func:`prior_residuals` = ``EdgePriorPoseImu``.

The JAX package differentiates the inertial edge and the prior with
``jax.jacfwd``; here their Jacobians are the analytic ones of on-manifold
preintegration (Forster et al. 2016, the derivatives of ORB-SLAM3's
``EdgeInertial::linearizeOplus``), so a tracked frame's pose optimisation
needs no autodiff.

State tangent layout per keyframe/frame (15): ``[dt(3), dphi(3), dv(3),
dbg(3), dba(3)]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry import so3
from orb_slam3_noted_tpu_torch.imu.preintegration import Calib, Preintegrated
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.optim import factors
from orb_slam3_noted_tpu_torch.optim.inertial import _gravity_down, _mv, whitener


class VIState(NamedTuple):
    """Body states of K keyframes/frames (SoA)."""

    Rwb: torch.Tensor  # (K, 3, 3)
    twb: torch.Tensor  # (K, 3)
    vel: torch.Tensor  # (K, 3)
    bg: torch.Tensor   # (K, 3)
    ba: torch.Tensor   # (K, 3)


class InertialEdges(NamedTuple):
    """Temporal preintegration chain: edge e connects states i[e] -> j[e]."""

    i: torch.Tensor           # (E,) int32
    j: torch.Tensor           # (E,) int32
    preint: Preintegrated     # stacked over E
    valid: torch.Tensor       # (E,) bool


def retract(st: VIState, d: torch.Tensor) -> VIState:
    """Apply a (K, 15) tangent update (reference ``ImuCamPose::Update``)."""
    dt, dphi, dv, dbg, dba = d[:, 0:3], d[:, 3:6], d[:, 6:9], d[:, 9:12], d[:, 12:15]
    return VIState(Rwb=so3.normalize(st.Rwb @ so3.exp(dphi)), twb=st.twb + _mv(st.Rwb, dt),
                   vel=st.vel + dv, bg=st.bg + dbg, ba=st.ba + dba)


def cam_from_body(st: VIState, calib: Calib):
    """(Rcw, tcw) per state: Tcw = Tcb Tbw with Tcb = Tbc^-1."""
    Rcb = calib.Rbc.T
    tcb = -Rcb @ calib.tbc
    Rcw = Rcb @ st.Rwb.transpose(-1, -2)
    return Rcw, -_mv(Rcw, st.twb) + tcb


def body_from_cam(Rcw: torch.Tensor, tcw: torch.Tensor, calib: Calib):
    """Inverse of :func:`cam_from_body`: Rwb = Rcw^T Rbc^T,
    twb = Rcw^T (-Rbc^T tbc - tcw) (``KeyFrame::GetImuRotation/Position``)."""
    tcb = -calib.Rbc.T @ calib.tbc
    Rwc = Rcw.transpose(-1, -2)
    return Rwc @ calib.Rbc.T, _mv(Rwc, tcb - tcw)


def body_reproj_residuals(cam: cam_mod.Camera, st: VIState, calib: Calib, points: torch.Tensor,
                          obs: factors.ReprojObs, bf: float = 0.0,
                          cam2: cam_mod.Camera | None = None, Rrl: torch.Tensor | None = None,
                          trl: torch.Tensor | None = None):
    """Reprojection residuals with Jacobians in the body tangent: r (O, R),
    Jp (O, R, 6) w.r.t. [dt, dphi] of the observing state, Jl (O, R, 3),
    chi2 (O,), ok (O,); R = 3, or 5 with a second camera (``cam2``, ``Rrl``,
    ``trl``: a fisheye rig, the reference's two-camera ``EdgeMono``).  The
    other 9 tangent rows have zero reprojection Jacobian."""
    Rcw, tcw = cam_from_body(st, calib)
    r, _, Jl, chi2, ok, _ = factors.reproj_residuals(cam, Rcw, tcw, points, obs, bf, cam2, Rrl,
                                                     trl)
    # x_b = Rwb^T (x_w - twb), x_c = Rcb x_b + tcb: d x_b / d dt = -I,
    # d x_b / d dphi = hat(x_b); Jl = -Jproj Rcw, so -Jproj Rcb = Jl Rwb
    pi = obs.pose_idx.long()
    Rwb = st.Rwb[pi]
    JRcb = Jl @ Rwb
    xb = torch.einsum("oji,oj->oi", Rwb, points[obs.point_idx.long()] - st.twb[pi])
    return r, torch.cat([-JRcb, JRcb @ so3.hat(xb)], dim=-1), Jl, chi2, ok


def _edge_parts(st: VIState, edges: InertialEdges, jacobians: bool = True):
    """Unwhitened residual (E, 9) and analytic Jacobians (E, 9, 15) of
    every edge w.r.t. the tangents of its states i and j (None, None
    without ``jacobians``: an LM step's accept test needs the cost only)."""
    i, j = edges.i.long(), edges.j.long()
    p = edges.preint
    Ri, ti, vi, bg, ba = st.Rwb[i], st.twb[i], st.vel[i], st.bg[i], st.ba[i]
    Rj, tj, vj = st.Rwb[j], st.twb[j], st.vel[j]
    g = _gravity_down(ti)
    dbg = bg - p.bias.bg
    dba = ba - p.bias.ba
    w_bg = _mv(p.JRg, dbg)
    dR = p.dR @ so3.exp(w_bg)
    dV = p.dV + _mv(p.JVg, dbg) + _mv(p.JVa, dba)
    dP = p.dP + _mv(p.JPg, dbg) + _mv(p.JPa, dba)
    dt = p.dT[:, None]
    RiT = Ri.transpose(-1, -2)
    eR = dR.transpose(-1, -2) @ RiT @ Rj
    er = so3.log(eR)
    a_v = _mv(RiT, vj - vi - g * dt)
    a_p = _mv(RiT, tj - ti - vi * dt - 0.5 * g * dt * dt)
    r = torch.cat([er, a_v - dV, a_p - dP], dim=-1)
    if not jacobians:
        return r, None, None

    JrInv = so3.inverse_right_jacobian(er)
    E = r.shape[0]
    z = torch.zeros((E, 3, 3), dtype=r.dtype, device=r.device)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(E, 3, 3)
    dt3 = p.dT[:, None, None]
    # state i: [dt, dphi, dv, dbg, dba]
    Ji = torch.cat([
        torch.cat([z, -JrInv @ Rj.transpose(-1, -2) @ Ri, z,
                   -JrInv @ eR.transpose(-1, -2) @ so3.right_jacobian(w_bg) @ p.JRg, z], dim=-1),
        torch.cat([z, so3.hat(a_v), -RiT, -p.JVg, -p.JVa], dim=-1),
        torch.cat([-eye, so3.hat(a_p), -RiT * dt3, -p.JPg, -p.JPa], dim=-1),
    ], dim=-2)
    # state j: position, rotation, velocity (the edge holds no bias of j)
    Jj = torch.cat([
        torch.cat([z, JrInv, z, z, z], dim=-1),
        torch.cat([z, z, RiT, z, z], dim=-1),
        torch.cat([RiT @ Rj, z, z, z, z], dim=-1),
    ], dim=-2)
    return r, Ji, Jj


def inertial_edge_residuals(st: VIState, edges: InertialEdges, W: torch.Tensor | None = None,
                            jacobians: bool = True):
    """Whitened inertial residuals and Jacobians: r (E, 9), Ji (E, 9, 15)
    w.r.t. state i's tangent, Jj (E, 9, 15) w.r.t. state j's (its bias
    columns zero: ``EdgeInertial`` connects the bias vertices of i only).
    ``W`` is :func:`whitener` of the edges' preintegrations where the caller
    keeps it (it does not change while the states move); without
    ``jacobians`` the Jacobians are None."""
    if W is None:
        W = whitener(edges.preint)
    r, Ji, Jj = _edge_parts(st, edges, jacobians)
    v = edges.valid.to(r.dtype)
    if not jacobians:
        return _mv(W, r) * v[:, None], None, None
    return _mv(W, r) * v[:, None], (W @ Ji) * v[:, None, None], (W @ Jj) * v[:, None, None]


def bias_rw_residuals(st: VIState, edges: InertialEdges):
    """Whitened bias random-walk residuals r = b_j - b_i (E, 6), and the
    per-edge whitening diagonal (E, 6) from the walk block C[9:15, 9:15]."""
    walk_var = torch.clamp(torch.diagonal(edges.preint.C[:, 9:15, 9:15], dim1=-2, dim2=-1),
                           min=1e-18)
    w = torch.rsqrt(walk_var)
    i, j = edges.i.long(), edges.j.long()
    db = torch.cat([st.bg[j] - st.bg[i], st.ba[j] - st.ba[i]], dim=-1)
    v = edges.valid.to(db.dtype)
    return db * w * v[:, None], w * v[:, None]


class VIPrior(NamedTuple):
    """15-dim prior on one body state (``ConstraintPoseImu``)."""

    idx: torch.Tensor        # () int32
    Rwb: torch.Tensor        # (3, 3)
    twb: torch.Tensor        # (3,)
    vel: torch.Tensor        # (3,)
    bg: torch.Tensor         # (3,)
    ba: torch.Tensor         # (3,)
    sqrt_info: torch.Tensor  # (15, 15) upper-triangular whitening
    valid: torch.Tensor      # () bool


def prior_residuals(st: VIState, pr: VIPrior):
    """Whitened prior residual (15,) and its analytic Jacobian (15, 15)
    w.r.t. the state's tangent.  Residual (``EdgePriorPoseImu``):
    er = Log(Rp^T R), et = Rp^T (t - tp), ev = v - vp, eb = b - bp, in the
    order [et, er, ev, ebg, eba]."""
    k = pr.idx.long()
    R, t = st.Rwb[k], st.twb[k]
    RpT = pr.Rwb.T
    er = so3.log(RpT @ R)
    r = torch.cat([RpT @ (t - pr.twb), er, st.vel[k] - pr.vel, st.bg[k] - pr.bg,
                   st.ba[k] - pr.ba])
    J = torch.zeros((15, 15), dtype=r.dtype, device=r.device)
    J[0:3, 0:3] = RpT @ R
    J[3:6, 3:6] = so3.inverse_right_jacobian(er)
    J[6:15, 6:15] = torch.eye(9, dtype=r.dtype, device=r.device)
    v = pr.valid.to(r.dtype)
    return (pr.sqrt_info @ r) * v, (pr.sqrt_info @ J) * v
