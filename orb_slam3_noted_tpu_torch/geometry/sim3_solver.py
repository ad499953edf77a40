"""Sim(3) RANSAC from 3D-3D map-point correspondences (port of
:mod:`orb_slam3_noted_tpu.geometry.sim3_solver`).

``Sim3Solver``: Horn's closed form on every minimal set at once, a
depth-scaled 3D inlier gate, then two IRLS rounds of weighted Horn on the
inliers.  The minimal sets are an argument, (n_hyp, 3) indices of valid
pairs: torch cannot replay the JAX package's ``jax.random.choice`` stream,
so the caller draws them (``LoopCloser._sim3_sets``) and tests hand in the
JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry.horn import horn_sim3

N_HYP = 128  # ``sim3_ransac``'s default, which the loop closer keeps


class Sim3Result(NamedTuple):
    success: torch.Tensor   # () bool
    R: torch.Tensor         # (3, 3) maps frame-1 coords to frame-2 coords
    t: torch.Tensor         # (3,)
    s: torch.Tensor         # ()
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor  # () int32


def sim3_ransac(
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    sets: torch.Tensor,
    inlier_thresh: float = 0.05,
    fix_scale: bool = False,
    min_inliers: int = 20,
) -> Sim3Result:
    """Estimate x2 ~= s R x1 + t from padded correspondences.

    x1/x2: (N, 3) matched points in the two keyframes' camera frames;
    ``sets``: (n_hyp, 3) indices of the minimal sets.  A pair is an inlier
    when |s R x1 + t - x2| < ``inlier_thresh`` x max(|x2|, 1).  Nothing is
    read back: the verdict stays on the device."""
    dtype = x1.dtype
    sets = sets.long()
    R_h, t_h, s_h = horn_sim3(x1[sets], x2[sets], fix_scale=fix_scale)
    pred = s_h[:, None, None] * torch.einsum("hij,nj->hni", R_h, x1) + t_h[:, None, :]
    err = torch.linalg.vector_norm(pred - x2[None], dim=-1)
    scale_gate = inlier_thresh * torch.clamp(torch.linalg.vector_norm(x2, dim=-1), min=1.0)
    inl = (err < scale_gate[None, :]) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)  # the first maximum, as jnp.argmax

    # refine: weighted Horn on the inliers, 2 IRLS rounds
    w = inl[best].to(dtype)
    R, t, s = horn_sim3(x1, x2, weights=w, fix_scale=fix_scale)
    for _ in range(2):
        err = torch.linalg.vector_norm(s * (x1 @ R.T) + t - x2, dim=-1)
        w = ((err < scale_gate) & valid).to(dtype)
        R, t, s = horn_sim3(x1, x2, weights=w, fix_scale=fix_scale)
    err = torch.linalg.vector_norm(s * (x1 @ R.T) + t - x2, dim=-1)
    inliers = (err < scale_gate) & valid
    n_in = torch.sum(inliers).to(torch.int32)
    return Sim3Result(success=n_in >= min_inliers, R=R, t=t, s=s, inliers=inliers,
                      n_inliers=n_in)
