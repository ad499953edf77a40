"""Batched reprojection residuals and analytic Jacobians.

Port of :mod:`orb_slam3_noted_tpu.optim.factors` for pinhole mono and
rectified-stereo rows; the two-camera (fisheye) rows wait for the fisheye
slice.

Conventions: Tcw = (Rcw, tcw), x_c = Rcw x_w + tcw; left-multiplicative
update Tcw <- exp(xi) Tcw with xi = (rho, phi), so d(x_c)/d(xi) =
[I3 | -hat(x_c)]; residual r = uv_obs - project(x_c); the stereo row is
u_right = u - bf/z.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry import so3
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod


class ReprojObs(NamedTuple):
    """Static-shape observation table for reprojection factors."""

    pose_idx: torch.Tensor    # (O,) int32 into the pose table
    point_idx: torch.Tensor   # (O,) int32 into the landmark table
    uv: torch.Tensor          # (O, 2) pixel measurement
    uv_r: torch.Tensor        # (O,) right-image u coordinate (stereo only)
    inv_sigma2: torch.Tensor  # (O,) information scale (1 / level sigma^2)
    is_stereo: torch.Tensor   # (O,) bool
    valid: torch.Tensor       # (O,) bool
    uv2: torch.Tensor | None = None       # fisheye second camera (not ported)
    is_right: torch.Tensor | None = None


def reproj_residuals(
    cam: cam_mod.Camera,
    Rcw: torch.Tensor,     # (K, 3, 3)
    tcw: torch.Tensor,     # (K, 3)
    points: torch.Tensor,  # (M, 3)
    obs: ReprojObs,
    bf: float = 0.0,
    cam2: cam_mod.Camera | None = None,
):
    """Residuals r (O, 3), Jacobians Jp (O, 3, 6), Jl (O, 3, 3), chi2 (O,),
    ok (O,), rdim (O,).  The third row is active only for stereo
    observations; chi2 includes inv_sigma2 and is 0 where not ok."""
    if cam2 is not None or obs.is_right is not None:
        raise NotImplementedError(
            "two-camera residual rows wait for the fisheye slice (ROADMAP, next steps 4)"
        )
    if cam.kind != cam_mod.PINHOLE:
        raise NotImplementedError(
            "Kannala-Brandt residuals wait for the fisheye slice (ROADMAP, next steps 4)"
        )
    R = Rcw[obs.pose_idx.long()]        # (O, 3, 3)
    t = tcw[obs.pose_idx.long()]        # (O, 3)
    xw = points[obs.point_idx.long()]   # (O, 3)
    xc = torch.einsum("oij,oj->oi", R, xw) + t
    z = xc[:, 2]
    z_safe = torch.where(z.abs() < 1e-6, 1e-6, z)

    params = cam.params_array(xc.dtype, xc.device)
    uv_hat = cam_mod.pinhole_project(params, xc)
    Jproj = cam_mod.pinhole_project_jac(params, xc)  # (O, 2, 3)

    r2 = obs.uv - uv_hat
    ur_hat = uv_hat[:, 0] - bf / z_safe
    r3 = torch.where(obs.is_stereo, obs.uv_r - ur_hat, 0.0)

    O = xc.shape[0]
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(O, 3, 3)
    dxc_dxi = torch.cat([eye, -so3.hat(xc)], dim=-1)  # (O, 3, 6)

    zero = torch.zeros_like(z)
    row3 = Jproj[:, 0, :] + torch.stack([zero, zero, bf / (z_safe * z_safe)], dim=-1)
    row3 = torch.where(obs.is_stereo[:, None], row3, 0.0)

    r = torch.cat([r2, r3[:, None]], dim=-1)                # (O, 3)
    Jfull = torch.cat([Jproj, row3[:, None, :]], dim=1)    # (O, 3, 3)
    Jp = -torch.einsum("oab,obc->oac", Jfull, dxc_dxi)    # (O, 3, 6)
    Jl = -torch.einsum("oab,obc->oac", Jfull, R)          # (O, 3, 3)

    ok = obs.valid & (torch.sum(xc * xc, dim=-1) > 1e-10) & (z > 1e-4)
    # zero masked rows and clamp magnitudes: padding rows can produce
    # inf/nan, and NaN * 0-weight would poison the normal equations
    okm = ok[:, None, None]
    Jp = torch.clamp(torch.nan_to_num(Jp * okm, nan=0.0, posinf=0.0, neginf=0.0), -1e6, 1e6)
    Jl = torch.clamp(torch.nan_to_num(Jl * okm, nan=0.0, posinf=0.0, neginf=0.0), -1e6, 1e6)
    r = torch.clamp(
        torch.nan_to_num(r * ok[:, None], nan=0.0, posinf=0.0, neginf=0.0), -1e6, 1e6
    )
    rdim = torch.where(obs.is_stereo, 3.0, 2.0)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    chi2 = torch.where(ok, chi2, 0.0)
    return r, Jp, Jl, chi2, ok, rdim
