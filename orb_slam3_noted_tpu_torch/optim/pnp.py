"""Batched PnP RANSAC for relocalisation (port of
:mod:`orb_slam3_noted_tpu.optim.pnp`).

All hypotheses at once: 6-point minimal sets -> batched DLT (SVD null vector
of the 12 x 12 system) -> orthonormality repair -> bearing-angle inlier
scoring of every hypothesis against every match in one pass.  The minimal
sets are an argument, (n_hyp, 6) indices: the caller draws them (the facade
from a ``torch.Generator`` seeded with the frame id,
``MonoSLAM._pnp_sets``), and tests replay the JAX package's draws.

The null vector's sign is whatever the SVD backend returns (LAPACK on the
CPU, cuSOLVER on the card).  The DLT fixes it before anything else, so that
the 3x3 block of the projection matrix has a positive determinant: then R
and t do not depend on it.  The JAX package does not, and on exact data
about half its hypotheses come out as a rotation 180 deg off (ROADMAP
Queue 3, "Faults in the reference"); where its sign was the positive one
the two agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry.linalg3 import det3

N_HYP = 128           # hypotheses per attempt (``pnp_ransac``'s default)
COS_THRESH = 0.99996  # ~0.5 deg bearing error


class PnPResult(NamedTuple):
    success: torch.Tensor    # () bool
    Rcw: torch.Tensor        # (3, 3)
    tcw: torch.Tensor        # (3,)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """(..., 12) right singular vector of the smallest singular value."""
    return torch.linalg.svd(A)[2][..., -1, :]


def _dlt_p6p(X: torch.Tensor, rays: torch.Tensor):
    """Batched DLT from 6 points. X (H, 6, 3) world; rays (H, 6, 3) z=1.

    Returns (H, 3, 3) R and (H, 3) t with orthonormality repair.
    """
    x = rays[..., 0]
    y = rays[..., 1]
    Xh = torch.cat([X, torch.ones_like(x)[..., None]], dim=-1)  # (H, 6, 4)
    z4 = torch.zeros_like(Xh)
    # rows: [X 0 -x*X], [0 X -y*X]
    r1 = torch.cat([Xh, z4, -x[..., None] * Xh], dim=-1)  # (H, 6, 12)
    r2 = torch.cat([z4, Xh, -y[..., None] * Xh], dim=-1)
    P = _null_vector(torch.cat([r1, r2], dim=-2)).reshape(-1, 3, 4)
    # the null vector's sign: the one whose rotation block has det > 0
    P = P * torch.where(det3(P[..., :3]) < 0, -1.0, 1.0)[..., None, None]
    Rraw = P[..., :3]
    traw = P[..., 3]
    # scale and orthonormalise: R = U D Vt, scale = trace(S D) / 3
    U, S, Vt2 = torch.linalg.svd(Rraw)
    det = det3(U @ Vt2)
    ones = torch.ones_like(det)
    R = U @ torch.diag_embed(torch.stack([ones, ones, det], dim=-1)) @ Vt2
    scale = (S[..., 0] + S[..., 1] + S[..., 2] * det) / 3.0
    t = traw / torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)[..., None]
    # sign: the one putting more of the sampled points in front
    z = torch.einsum("hij,hnj->hni", R, X)[..., 2] + t[..., None, 2]
    flip = torch.sum(torch.where(z > 0, 1, -1), dim=-1) < 0
    R = torch.where(flip[..., None, None], -R, R)
    t = torch.where(flip[..., None], -t, t)
    # after flipping both, det may be -1: back to SO(3)
    R = torch.where(det3(R)[..., None, None] < 0, -R, R)
    return R, t


def pnp_hypotheses(Xw: torch.Tensor, rays: torch.Tensor, valid: torch.Tensor, sets: torch.Tensor,
                   cos_thresh: float = COS_THRESH):
    """Every hypothesis of :func:`pnp_ransac`: (R (H, 3, 3), t (H, 3),
    inliers (H, N) bool)."""
    idx = sets.long()
    R, t = _dlt_p6p(Xw[idx], rays[idx])
    # score: the angle between predicted and observed bearings
    xc = torch.einsum("hij,nj->hni", R, Xw) + t[:, None, :]
    nrm = torch.linalg.vector_norm(xc, dim=-1) * torch.linalg.vector_norm(rays, dim=-1)[None, :]
    cosa = torch.einsum("hni,ni->hn", xc, rays) / torch.clamp(nrm, min=1e-12)
    return R, t, (cosa > cos_thresh) & (xc[..., 2] > 0) & valid[None, :]


def pnp_ransac(Xw: torch.Tensor, rays: torch.Tensor, valid: torch.Tensor, sets: torch.Tensor,
               cos_thresh: float = COS_THRESH, min_inliers: int = 12) -> PnPResult:
    """RANSAC pose from 3D-2D matches. Xw (N, 3), rays (N, 3) on z = 1,
    valid (N,) bool, sets (n_hyp, 6) indices of distinct valid matches."""
    R, t, inl = pnp_hypotheses(Xw, rays, valid, sets, cos_thresh)
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)  # the first best, as jnp.argmax
    n_in = counts[best]
    return PnPResult(success=n_in >= min_inliers, Rcw=R[best], tcw=t[best], inliers=inl[best],
                     n_inliers=n_in.to(torch.int32))
