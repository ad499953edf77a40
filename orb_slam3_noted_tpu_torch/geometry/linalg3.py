"""Closed-form small-matrix linear algebra (port of :mod:`orb_slam3_noted_tpu.geometry.linalg3`).

Adjugate 3x3 inverse and the 6x6 solve by 3x3 block elimination, kept from
the JAX package so that the pose update rounds the same way in both; the
cofactor 3x3 determinant for PnP.
"""

from __future__ import annotations

import torch


def det3(A: torch.Tensor) -> torch.Tensor:
    """Batched determinant of (..., 3, 3) by cofactors along the first row:
    elementwise on the device, where ``torch.linalg.det`` factors each
    matrix (and its first call on the card initialises the LU backend,
    0.2-1.2 s on an H100)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (..., 3, 3) via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() < 1e-20, torch.where(det < 0, -1e-20, 1e-20), det)
    inv_det = (1.0 / det)[..., None, None]
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve of (..., 3, 3) x = (..., 3)."""
    return torch.einsum("...ij,...j->...i", inv3(A), b)


def solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve of (..., 6, 6) x = (..., 6) via 3x3 block elimination.

    Assumes the top-left 3x3 block is invertible (true for damped normal
    equations).
    """
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    R = A[..., 3:, :3]
    S = A[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    Pinv = inv3(P)
    RPinv = torch.einsum("...ij,...jk->...ik", R, Pinv)
    schur = S - torch.einsum("...ij,...jk->...ik", RPinv, Q)
    x2 = solve3(schur, b2 - torch.einsum("...ij,...j->...i", RPinv, b1))
    x1 = torch.einsum(
        "...ij,...j->...i", Pinv, b1 - torch.einsum("...ij,...j->...i", Q, x2)
    )
    return torch.cat([x1, x2], dim=-1)
