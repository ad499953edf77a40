"""SE(3): rigid transforms as (R, t) pairs (port of :mod:`orb_slam3_noted_tpu.geometry.se3`).

A camera pose ``Tcw = (Rcw, tcw)`` maps world points into the camera frame,
``x_c = Rcw @ x_w + tcw``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from orb_slam3_noted_tpu_torch.geometry import so3

SE3 = Tuple[torch.Tensor, torch.Tensor]  # (R (...,3,3), t (...,3))


def inverse(T: SE3) -> SE3:
    R, t = T
    Rinv = R.transpose(-1, -2)
    return Rinv, -torch.einsum("...ij,...j->...i", Rinv, t)


def compose(T1: SE3, T2: SE3) -> SE3:
    """T1 * T2 (apply T2 first)."""
    R1, t1 = T1
    R2, t2 = T2
    return R1 @ R2, torch.einsum("...ij,...j->...i", R1, t2) + t1


def exp(xi: torch.Tensor) -> SE3:
    """Exponential map; xi = (rho, phi): translation first, rotation last.

    R = exp(phi), t = Jl(phi) rho.
    """
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3.exp(phi), torch.einsum("...ij,...j->...i", so3.left_jacobian(phi), rho)


def log(T: SE3) -> torch.Tensor:
    """Logarithm map; returns (rho, phi)."""
    R, t = T
    phi = so3.log(R)
    rho = torch.einsum("...ij,...j->...i", so3.inverse_left_jacobian(phi), t)
    return torch.cat([rho, phi], dim=-1)


def normalize(T: SE3) -> SE3:
    R, t = T
    return so3.normalize(R), t
