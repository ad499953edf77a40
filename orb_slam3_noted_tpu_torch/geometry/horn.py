"""Closed-form Sim(3)/SE(3) alignment (port of :mod:`orb_slam3_noted_tpu.geometry.horn`).

The SVD form of Horn's method (Umeyama): least-squares similarity between
two corresponding point sets, with optional weights, batched over any
leading shape.
"""

from __future__ import annotations

import torch

from orb_slam3_noted_tpu_torch.geometry.linalg3 import det3


def horn_sim3(
    x: torch.Tensor,
    y: torch.Tensor,
    weights: torch.Tensor | None = None,
    fix_scale: bool = False,
):
    """Least-squares similarity aligning x -> y:  y ~= s R x + t.

    x, y: (..., N, 3) corresponding points; weights: optional (..., N)
    nonnegative weights (0/1 as a validity mask); ``fix_scale`` returns
    s = 1 (SE(3) alignment).  Returns (R (..., 3, 3), t (..., 3), s (...)).
    """
    if weights is None:
        weights = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    w = (weights / wsum)[..., None]
    mx = torch.sum(w * x, dim=-2)
    my = torch.sum(w * y, dim=-2)
    xc = x - mx[..., None, :]
    yc = y - my[..., None, :]
    S = (yc * w).transpose(-1, -2) @ xc  # (..., 3, 3), maps the x frame to the y frame
    U, D, Vt = torch.linalg.svd(S)
    d = torch.sign(det3(U @ Vt))
    e = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = U @ (e[..., :, None] * Vt)
    var_x = torch.sum(w * xc * xc, dim=(-2, -1))
    s_opt = torch.sum(D * e, dim=-1) / torch.clamp(var_x, min=1e-12)
    s = torch.ones_like(s_opt) if fix_scale else s_opt
    t = my - s[..., None] * torch.einsum("...ij,...j->...i", R, mx)
    return R, t, s
