"""Sim(3): similarity transforms (R, t, s) (port of :mod:`orb_slam3_noted_tpu.geometry.sim3`).

Representation: (R (..., 3, 3), t (..., 3), s (...,)) with action
x -> s R x + t, for loop closing and the essential graph.
"""

from __future__ import annotations

from typing import Tuple

import torch

from orb_slam3_noted_tpu_torch.geometry import so3
from orb_slam3_noted_tpu_torch.geometry.linalg3 import solve3

Sim3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (R, t, s)

_EPS = 1e-5


def _mv(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", R, x)


def identity(dtype=torch.float32, device=None) -> Sim3:
    return (torch.eye(3, dtype=dtype, device=device), torch.zeros(3, dtype=dtype, device=device),
            torch.ones((), dtype=dtype, device=device))


def apply(S: Sim3, x: torch.Tensor) -> torch.Tensor:
    R, t, s = S
    return s[..., None] * _mv(R, x) + t


def compose(S1: Sim3, S2: Sim3) -> Sim3:
    """S1 * S2 (apply S2 first)."""
    R1, t1, s1 = S1
    R2, t2, s2 = S2
    return R1 @ R2, s1[..., None] * _mv(R1, t2) + t1, s1 * s2


def inverse(S: Sim3) -> Sim3:
    R, t, s = S
    Rinv = R.transpose(-1, -2)
    sinv = 1.0 / s
    return Rinv, -sinv[..., None] * _mv(Rinv, t), sinv


def from_se3(R: torch.Tensor, t: torch.Tensor) -> Sim3:
    return R, t, torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)


def _v_matrix(phi: torch.Tensor, sigma: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """V = C0 I + A1 W + B1 W^2 of the Sim(3) exponential (Strasdat's closed
    form), with the JAX package's small-angle and small-scale branches."""
    t2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(t2)
    W = so3.hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    small_s = torch.abs(sigma) < _EPS
    small_t = theta < _EPS
    sig = torch.where(small_s, 1.0, sigma)
    th = torch.where(small_t, 1.0, theta)
    C0 = torch.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = t2 + sigma * sigma
    c_safe = torch.where(c < 1e-12, 1.0, c)
    A1_gen = (a * sigma + (1.0 - b) * theta) / (th * c_safe)
    B1_gen = (C0 - ((b - 1.0) * sigma + a * theta) / c_safe) / torch.where(small_t, 1.0, t2)
    A1_small_t = torch.where(small_s, 0.5 + sigma / 3.0, (s * (sig - 1.0) + 1.0) / (sig * sig))
    B1_small_t = torch.where(
        small_s, 1.0 / 6.0 + sigma / 8.0,
        (s * (sig * sig / 2.0 - sig + 1.0) - 1.0) / (sig * sig * sig),
    )
    A1 = torch.where(small_t, A1_small_t, A1_gen)
    B1 = torch.where(small_t, B1_small_t, B1_gen)
    return C0[..., None, None] * eye + A1[..., None, None] * W + B1[..., None, None] * W2


def exp(xi: torch.Tensor) -> Sim3:
    """Exponential map; xi = (rho(3), phi(3), sigma(1)) -> (R, t, s) with
    s = e^sigma, R = exp(phi), t = V rho."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    return so3.exp(phi), _mv(_v_matrix(phi, sigma, s), rho), s


def log(S: Sim3) -> torch.Tensor:
    """Logarithm map -> (rho, phi, sigma), the inverse of :func:`exp`: V from
    (phi, sigma) as in :func:`exp`, then V rho = t (an adjugate 3x3 solve,
    where the JAX package factors V)."""
    R, t, s = S
    phi = so3.log(R)
    sigma = torch.log(s)
    rho = solve3(_v_matrix(phi, sigma, s), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
