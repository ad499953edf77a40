"""Two-view triangulation (batched DLT; port of :mod:`orb_slam3_noted_tpu.geometry.triangulation`).

Instead of a 4x4 SVD per point, the 3x3 normal equations of the
inhomogeneous DLT system are solved in closed form for the whole batch.
"""

from __future__ import annotations

import torch

from orb_slam3_noted_tpu_torch.geometry.linalg3 import solve3


def _two_rows(ray: torch.Tensor, P_R: torch.Tensor, P_t: torch.Tensor):
    """DLT rows x * P[2] - z * P[0] and y * P[2] - z * P[1] of ray = (x, y, z)."""
    x, y, z = ray[..., 0], ray[..., 1], ray[..., 2]
    r0 = x[..., None] * P_R[..., 2, :] - z[..., None] * P_R[..., 0, :]
    c0 = x * P_t[..., 2] - z * P_t[..., 0]
    r1 = y[..., None] * P_R[..., 2, :] - z[..., None] * P_R[..., 1, :]
    c1 = y * P_t[..., 2] - z * P_t[..., 1]
    return torch.stack([r0, r1], dim=-2), torch.stack([c0, c1], dim=-1)


def triangulate_dlt(
    ray1: torch.Tensor, ray2: torch.Tensor, R21: torch.Tensor, t21: torch.Tensor
) -> torch.Tensor:
    """Triangulate from (..., 3) bearing rays in two cameras, with the pose of
    camera 1 in camera 2 (x2 = R21 x1 + t21).  Returns (..., 3) points in the
    camera-1 frame; depth may be negative for bad pairs (callers gate on
    cheirality)."""
    batch = ray1.shape[:-1]
    eyeR = torch.eye(3, dtype=ray1.dtype, device=ray1.device).expand(*batch, 3, 3)
    zt = torch.zeros((*batch, 3), dtype=ray1.dtype, device=ray1.device)
    A1, b1 = _two_rows(ray1, eyeR, zt)
    A2, b2 = _two_rows(ray2, R21.expand(*batch, 3, 3), t21.expand(*batch, 3))
    A = torch.cat([A1, A2], dim=-2)   # (..., 4, 3)
    b = -torch.cat([b1, b2], dim=-1)  # (..., 4)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    Atb = torch.einsum("...ki,...k->...i", A, b)
    # regularise so the solve stays defined for parallel rays
    AtA = AtA + 1e-9 * torch.eye(3, dtype=A.dtype, device=A.device)
    return solve3(AtA, Atb)


def parallax_cos(ray1: torch.Tensor, ray2_in_1: torch.Tensor) -> torch.Tensor:
    """Cosine of the angle between bearing rays expressed in a common frame."""
    n1 = torch.linalg.vector_norm(ray1, dim=-1)
    n2 = torch.linalg.vector_norm(ray2_in_1, dim=-1)
    return torch.sum(ray1 * ray2_in_1, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
