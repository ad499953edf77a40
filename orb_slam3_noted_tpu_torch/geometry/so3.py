"""SO(3): rotation group operations (port of :mod:`orb_slam3_noted_tpu.geometry.so3`).

Rodrigues exponential, logarithm with a near-pi branch, Jacobians and the
quaternion round-trip re-orthonormalisation, all branch-free with
``torch.where`` over a leading batch shape.

Conventions: rotation matrices are (3, 3) tensors mapping body -> world when
used as a pose; tangent vectors are (3,) axis-angle vectors.
"""

from __future__ import annotations

import math

import torch

# Below this angle (radians) the closed forms are replaced by their
# 2nd-order Taylor expansions to avoid 0/0.
_EPS = 1e-5


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w = (x, y, z): hat(w) @ v == cross(w, v)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat` (assumes W skew-symmetric)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map R = exp(hat(w)) via the Rodrigues formula.

    R = I + sin(t)/t * W + (1-cos(t))/t^2 * W^2,  t = |w|.
    """
    t2 = torch.sum(w * w, dim=-1)
    t = torch.sqrt(t2)
    W = hat(w)
    W2 = W @ W
    small = t < _EPS
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / torch.where(small, 1.0, t))
    b = torch.where(
        small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / torch.where(small, 1.0, t2)
    )
    return _eye(w) + a[..., None, None] * W + b[..., None, None] * W2


def log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map w = vee(log(R)); handles angles up to pi (exclusive)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    v = vee(R - R.transpose(-1, -2))  # = 2 sin(t) * axis
    sin_t = 0.5 * torch.sqrt(torch.sum(v * v, dim=-1) + 1e-30)
    t = torch.atan2(sin_t, cos_t)
    small = t < _EPS
    near_pi = t > math.pi - 1e-3

    scale = torch.where(
        small, 0.5 + t * t / 12.0, t / torch.where(small, 1.0, 2.0 * sin_t + 1e-30)
    )
    w_generic = scale[..., None] * v

    # Near pi: B = (S - cos_t I)/(1 - cos_t) = a a^T; the axis is the
    # normalised column with the largest diagonal, signed by v.
    S = 0.5 * (R + R.transpose(-1, -2))
    denom = torch.where(near_pi, 1.0 - cos_t, 1.0)
    B = (S - cos_t[..., None, None] * _eye(R)) / denom[..., None, None]
    diagB = torch.diagonal(B, dim1=-2, dim2=-1)
    k = torch.argmax(diagB, dim=-1)
    col = torch.take_along_dim(B, k[..., None, None].expand(*k.shape, 3, 1), dim=-1)[..., 0]
    norm = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
    axis_pi = col / torch.where(norm < 1e-12, 1.0, norm)
    dv = torch.sum(axis_pi * v, dim=-1, keepdim=True)
    axis_pi = axis_pi * torch.where(dv < 0.0, -1.0, 1.0)
    w_pi = t[..., None] * axis_pi
    return torch.where(near_pi[..., None], w_pi, w_generic)


def right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w) = I - (1-cos t)/t^2 W + (t - sin t)/t^3 W^2."""
    t2 = torch.sum(w * w, dim=-1)
    t = torch.sqrt(t2)
    W = hat(w)
    W2 = W @ W
    small = t < _EPS
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / torch.where(small, 1.0, t2))
    c = torch.where(
        small, 1.0 / 6.0 - t2 / 120.0,
        (t - torch.sin(t)) / torch.where(small, 1.0, t2 * t),
    )
    return _eye(w) - b[..., None, None] * W + c[..., None, None] * W2


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian Jl(w) = Jr(-w)."""
    return right_jacobian(-w)


def inverse_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian Jr^-1(w) = I + 1/2 W + (1/t^2 - (1+cos t)/(2 t sin t)) W^2."""
    t2 = torch.sum(w * w, dim=-1)
    t = torch.sqrt(t2)
    W = hat(w)
    W2 = W @ W
    small = t < _EPS
    denom = torch.where(small, 1.0, 2.0 * t * torch.sin(t))
    c = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        1.0 / torch.where(small, 1.0, t2) - (1.0 + torch.cos(t)) / denom,
    )
    return _eye(w) + 0.5 * W + c[..., None, None] * W2


def inverse_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian Jl^-1(w) = Jr^-1(-w)."""
    return inverse_right_jacobian(-w)


def normalize(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalise a drifting rotation matrix (quaternion round-trip)."""
    return from_quat(to_quat(R))


def from_quat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from quaternion (w, x, y, z), not necessarily unit."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def to_quat(R: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) from a rotation matrix, branch-free (Shepperd):
    all four candidates, the one with the largest pivot selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    idx = torch.argmax(pivots, dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    q = q * torch.sign(torch.where(q[..., :1].abs() < 1e-30, 1.0, q[..., :1]))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
