"""SE(3): rigid transforms as (R, t) pairs (port of :mod:`orb_slam3_noted_tpu.geometry.se3`).

A camera pose ``Tcw = (Rcw, tcw)`` maps world points into the camera frame,
``x_c = Rcw @ x_w + tcw``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from orb_slam3_noted_tpu_torch.geometry import so3

SE3 = Tuple[torch.Tensor, torch.Tensor]  # (R (...,3,3), t (...,3))


def identity(dtype=torch.float32, batch_shape: tuple = (), device=None) -> SE3:
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    return R, torch.zeros(*batch_shape, 3, dtype=dtype, device=device)


def inverse(T: SE3) -> SE3:
    R, t = T
    Rinv = R.transpose(-1, -2)
    return Rinv, -torch.einsum("...ij,...j->...i", Rinv, t)


def compose(T1: SE3, T2: SE3) -> SE3:
    """T1 * T2 (apply T2 first)."""
    R1, t1 = T1
    R2, t2 = T2
    return R1 @ R2, torch.einsum("...ij,...j->...i", R1, t2) + t1


def apply(T: SE3, x: torch.Tensor) -> torch.Tensor:
    """Transform points x (..., 3)."""
    R, t = T
    return torch.einsum("...ij,...j->...i", R, x) + t


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


def to_matrix(T: SE3) -> torch.Tensor:
    """(..., 4, 4) homogeneous matrix."""
    R, t = T
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom.expand(*R.shape[:-2], 1, 4)], dim=-2)


def from_matrix(M: torch.Tensor) -> SE3:
    return M[..., :3, :3], M[..., :3, 3]


def retract(T: SE3, xi: torch.Tensor) -> SE3:
    """Right-multiplicative update used by the optimisers: T <- T * exp(xi)."""
    return compose(T, exp(xi))


def normalize(T: SE3) -> SE3:
    R, t = T
    return so3.normalize(R), t
