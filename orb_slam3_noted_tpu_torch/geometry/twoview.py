"""Two-view relative pose (monocular bootstrap) as batched RANSAC.

Port of :mod:`orb_slam3_noted_tpu.geometry.twoview` (``TwoViewReconstruction``:
essential and homography hypotheses on calibrated rays, model selection by
score ratio, motion recovery, triangulation with cheirality and parallax
gates).  All hypotheses are built and scored in one batch: (n_hyp, 8)
minimal sets -> batched 9x9 Gram eigenproblems -> (n_hyp, N) error matrices
-> argmax.  Every function also takes a leading batch of pairs (the
candidate frames of one initialisation attempt).

The minimal sets are an argument of :func:`reconstruct_two_views`, drawn by
:func:`sample_minimal_sets` (a Gumbel top-k, the draw ``jax.random.choice``
makes without replacement) from an explicit ``torch.Generator``, so a test
can feed both packages the same hypotheses.  Nothing here reads a value back
to the host: degenerate hypotheses give non-finite or huge errors that fail
every comparison (the 3x3 inverse is the adjugate, the 5x5 solve unchecked).
The eigen- and singular-vector signs may differ from the JAX package's; the
scores do not depend on them, and the candidate motions form the same set.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.geometry import so3
from orb_slam3_noted_tpu_torch.geometry.linalg3 import inv3
from orb_slam3_noted_tpu_torch.geometry.triangulation import triangulate_dlt
from orb_slam3_noted_tpu_torch.ops.fast import topk_stable


class TwoViewResult(NamedTuple):
    success: torch.Tensor      # (...) bool
    R21: torch.Tensor          # (..., 3, 3) rotation cam1 -> cam2
    t21: torch.Tensor          # (..., 3) unit-norm translation
    points1: torch.Tensor      # (..., N, 3) triangulated points in the cam-1 frame
    is_inlier: torch.Tensor    # (..., N) bool (good triangulation + epipolar inlier)
    n_inliers: torch.Tensor    # (...) int32
    vote_best: torch.Tensor    # (...) int32, best candidate's good count
    vote_second: torch.Tensor  # (...) int32, runner-up count
    n_dis: torch.Tensor        # (...) int32, disagreement-set size
    used_h: torch.Tensor       # (...) bool, homography model chosen


def _det3(A: torch.Tensor) -> torch.Tensor:
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def _diag110(like: torch.Tensor) -> torch.Tensor:
    return torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=like.dtype, device=like.device))


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """(..., 9) eigenvector of the smallest eigenvalue of A^T A, A (..., K, 9)."""
    G = torch.einsum("...ki,...kj->...ij", A, A)
    return torch.linalg.eigh(G)[1][..., :, 0]


def sample_minimal_sets(valid: torch.Tensor, n_hyp: int, generator: torch.Generator,
                        size: int = 8) -> torch.Tensor:
    """(..., n_hyp, size) int64 indices: per hypothesis ``size`` distinct
    entries drawn with probability mass on ``valid`` (..., N), by a Gumbel
    top-k over ``log p`` (``jax.random.choice(..., replace=False, p=p)``).
    With fewer than ``size`` valid entries the rest are invalid ones, lowest
    index first."""
    p = valid.to(torch.float32)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1.0)
    u = torch.rand((*valid.shape[:-1], n_hyp, valid.shape[-1]), generator=generator,
                   device=valid.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-30)))
    return topk_stable(torch.log(p)[..., None, :] + gumbel, size)[1]


def _eight_point_essential(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched 8-point essential matrices from z=1 rays (..., 8, 3), projected
    to singular values (1, 1, 0); x2^T E x1 = 0."""
    a1, b1 = x1[..., 0], x1[..., 1]
    a2, b2 = x2[..., 0], x2[..., 1]
    A = torch.stack([a2 * a1, a2 * b1, a2, b2 * a1, b2 * b1, b2, a1, b1, torch.ones_like(a1)],
                    dim=-1)
    E = _null_vector(A).reshape(*A.shape[:-2], 3, 3)
    U, _, Vt = torch.linalg.svd(E)
    return U @ _diag110(E) @ Vt


def _epipolar_parts(E, x1, x2):
    """(E x1, E^T x2, x2^T E x1) of E (..., H, 3, 3) and rays (..., N, 3)."""
    Ex1 = torch.einsum("...hij,...nj->...hni", E, x1)
    Etx2 = torch.einsum("...hji,...nj->...hni", E, x2)
    return Ex1, Etx2, torch.einsum("...ni,...hni->...hn", x2, Ex1)


def _sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Sampson epipolar error; E (..., H, 3, 3), rays (..., N, 3) -> (..., H, N)."""
    Ex1, Etx2, x2Ex1 = _epipolar_parts(E, x1, x2)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return x2Ex1 * x2Ex1 / torch.clamp(denom, min=1e-12)


def _epipolar_errors(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Directional point-to-epipolar-line errors (d1: x2 to E x1, d2: x1 to
    E^T x2), each (..., H, N); the reference scores the fundamental model
    with both directions (``CheckFundamental``)."""
    Ex1, Etx2, x2Ex1 = _epipolar_parts(E, x1, x2)
    num = x2Ex1 * x2Ex1
    d1 = num / torch.clamp(Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2, min=1e-12)
    d2 = num / torch.clamp(Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2, min=1e-12)
    return d1, d2


def _homography_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., 2K, 9) DLT rows of x2 ~ H x1 for rays (..., K, 3)."""
    u2, v2 = x2[..., 0:1], x2[..., 1:2]
    z = torch.zeros_like(x1)
    r1 = torch.cat([z, -x1, v2 * x1], dim=-1)
    r2 = torch.cat([x1, z, -u2 * x1], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def _four_point_homography(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched 4-point DLT homographies from z=1 rays (..., 4, 3), x2 ~ H x1."""
    A = _homography_rows(x1, x2)
    return _null_vector(A).reshape(*A.shape[:-2], 3, 3)


def _transfer_errors(Hm: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Symmetric transfer errors: Hm (..., H, 3, 3), rays (..., N, 3) ->
    (e12, e21) each (..., H, N), squared distances of H x1 to x2 and of
    H^-1 x2 to x1 in normalised coordinates."""
    Hx1 = torch.einsum("...bij,...nj->...bni", Hm, x1)
    Hx2 = torch.einsum("...bij,...nj->...bni", inv3(Hm), x2)
    z12 = torch.where(Hx1[..., 2:].abs() < 1e-12, 1e-12, Hx1[..., 2:])
    z21 = torch.where(Hx2[..., 2:].abs() < 1e-12, 1e-12, Hx2[..., 2:])
    e12 = torch.sum((Hx1[..., :2] / z12 - x2[..., None, :, :2]) ** 2, dim=-1)
    e21 = torch.sum((Hx2[..., :2] / z21 - x1[..., None, :, :2]) ** 2, dim=-1)
    return e12, e21


def _rot_y_candidates(c, s, pos: bool):
    """(..., 4, 3, 3): [[c, 0, -s], [0, 1, 0], [s, 0, c]] for d' = +d2, or
    [[c, 0, s], [0, -1, 0], [s, 0, -c]] for d' = -d2, one per sign pair."""
    c = c[..., None].expand_as(s)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    if pos:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    else:
        rows = [[c, zero, s], [zero, -one, zero], [s, zero, -c]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _decompose_homography(Hm: torch.Tensor):
    """Faugeras SVD decomposition of calibrated homographies (..., 3, 3) ->
    8 motions: (R (..., 8, 3, 3), t (..., 8, 3) unit, degenerate (...))."""
    U, D, Vt = torch.linalg.svd(Hm)
    s = _det3(U) * _det3(Vt)
    d1, d2, d3 = D[..., 0], D[..., 1], D[..., 2]
    # d1 ~ d2 ~ d3 means pure rotation / conic degeneracy
    degenerate = (d1 / d2 < 1.00001) | (d2 / d3 < 1.00001)
    eps = 1e-12
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + eps), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + eps), min=0.0))
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=Hm.dtype, device=Hm.device)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=Hm.dtype, device=Hm.device)
    x1v = aux1[..., None] * e1
    x3v = aux3[..., None] * e3
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    # case d' = +d2: rotation about y by theta
    st = (root / ((d1 + d3) * d2 + eps))[..., None] * e1 * e3
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2 + eps)
    # case d' = -d2: rotation about y by phi composed with diag(1, -1, -1)
    sp = (root / ((d1 - d3) * d2 + eps))[..., None] * e1 * e3
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2 + eps)
    Rp = torch.cat([_rot_y_candidates(ct, st, True), _rot_y_candidates(cp, sp, False)], dim=-3)
    zero = torch.zeros_like(x1v)
    tp = torch.cat([torch.stack([x1v, zero, -x3v], dim=-1),
                    torch.stack([x1v, zero, x3v], dim=-1)], dim=-2)       # (..., 8, 3)
    R = (s[..., None, None] * U)[..., None, :, :] @ Rp @ Vt[..., None, :, :]
    t = torch.einsum("...ij,...kj->...ki", U, tp)
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return R, t, degenerate


def _decompose_essential(E: torch.Tensor):
    """E (..., 3, 3) -> the 4 candidate motions (R1, t), (R1, -t), (R2, t),
    (R2, -t) as (R (..., 4, 3, 3), t (..., 4, 3)), det(R) = +1, |t| = 1."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(_det3(U))[..., None, None]
    Vt = Vt * torch.sign(_det3(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([R1, R1, R2, R2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def _t_basis(t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 2) orthonormal basis of the tangent plane of unit t (..., 3)."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    tmp = torch.where((t[..., 0:1].abs() < 0.9), ex, ey)
    b1 = torch.linalg.cross(t, tmp)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1, keepdim=True), min=1e-12)
    b2 = torch.linalg.cross(t, b1)
    return torch.stack([b1, b2], dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def _sampson_residuals(E, rays1, rays2, w):
    """Weighted signed Sampson residuals (..., N) and their parts."""
    Ex1 = torch.einsum("...ij,...nj->...ni", E, rays1)
    Etx2 = torch.einsum("...ji,...nj->...ni", E, rays2)
    num = torch.sum(rays2 * Ex1, dim=-1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    s = torch.sqrt(torch.clamp(denom, min=1e-18))
    return w * num / s, (Ex1, Etx2, num, denom, s)


def _refine_rt_sampson(R0, t0, rays1, rays2, w, n_iters: int = 8):
    """Gold-standard (R, t) polish: damped Gauss-Newton on the weighted
    Sampson error over the 5-dof essential manifold (so3 on the left of R,
    the tangent plane of the unit t).  The Jacobian at the current estimate
    is written out (the derivative the JAX package takes with
    ``jax.jacfwd``): d exp(d_w) R = hat(e_k) R at 0, and the unit-vector map
    t + B d_t -> its normalisation."""
    dtype = rays1.dtype
    eye3 = torch.eye(3, dtype=dtype, device=rays1.device)
    basis3 = so3.hat(eye3)                                             # (3, 3, 3)
    lam = torch.full(R0.shape[:-2], 1e-6, dtype=dtype, device=rays1.device)
    R, t = R0, t0
    for _ in range(n_iters):
        B = _t_basis(t)
        tn = _unit(t)
        nt = torch.clamp(torch.linalg.vector_norm(t, dim=-1), min=1e-12)[..., None, None]
        dt = (eye3 - tn[..., :, None] * tn[..., None, :]) @ B / nt      # (..., 3, 2)
        E = so3.hat(tn) @ R
        dE = torch.cat([
            so3.hat(tn)[..., None, :, :] @ basis3 @ R[..., None, :, :],
            so3.hat(dt.transpose(-1, -2)) @ R[..., None, :, :],
        ], dim=-3)                                                     # (..., 5, 3, 3)
        r, (Ex1, Etx2, num, denom, s) = _sampson_residuals(E, rays1, rays2, w)
        dEx1 = torch.einsum("...kij,...nj->...kni", dE, rays1)
        dEtx2 = torch.einsum("...kji,...nj->...kni", dE, rays2)
        dnum = torch.sum(rays2[..., None, :, :] * dEx1, dim=-1)
        dden = 2.0 * (Ex1[..., None, :, 0] * dEx1[..., 0] + Ex1[..., None, :, 1] * dEx1[..., 1]
                      + Etx2[..., None, :, 0] * dEtx2[..., 0]
                      + Etx2[..., None, :, 1] * dEtx2[..., 1])
        dden = torch.where((denom > 1e-18)[..., None, :], dden, 0.0)
        J = (w[..., None, :] * (dnum / s[..., None, :]
                                - num[..., None, :] * dden / (2.0 * s ** 3)[..., None, :]))
        J = J.transpose(-1, -2)                                        # (..., N, 5)
        H = J.transpose(-1, -2) @ J + lam[..., None, None] * torch.eye(5, dtype=dtype,
                                                                        device=J.device)
        d = torch.linalg.solve_ex(H, -(J.transpose(-1, -2) @ r[..., None]))[0][..., 0]
        Rn = so3.exp(d[..., :3]) @ R
        tn_new = _unit(t + (B @ d[..., 3:, None])[..., 0])
        r_new = _sampson_residuals(so3.hat(tn_new) @ Rn, rays1, rays2, w)[0]
        better = torch.sum(r ** 2, dim=-1) > torch.sum(r_new ** 2, dim=-1)
        R = torch.where(better[..., None, None], Rn, R)
        t = torch.where(better[..., None], tn_new, t)
        lam = torch.where(better, lam * 0.5, lam * 10.0)
    return R, t


def _check_motions(R21, t21, rays1, rays2, valid, err_thresh, min_parallax_cos):
    """Triangulate every match under each motion R21 (..., C, 3, 3), t21
    (..., C, 3): (good (..., C, N), points (..., C, N, 3), parallax cosine
    (..., C, N)).  Good: valid, in front of both cameras, enough parallax,
    reprojection within 4 x ``err_thresh`` in both views."""
    C, N = R21.shape[-3], rays1.shape[-2]
    shape = (*rays1.shape[:-2], C, N, 3)
    r1 = rays1[..., None, :, :].expand(shape)
    r2 = rays2[..., None, :, :].expand(shape)
    pts1 = triangulate_dlt(r1, r2, R21[..., None, :, :], t21[..., None, :])
    z1 = pts1[..., 2]
    p2 = torch.einsum("...nj,...ij->...ni", pts1, R21) + t21[..., None, :]
    z2 = p2[..., 2]
    # reprojection gate in normalised coordinates, deliberately 4x the model
    # threshold so off-plane points survive the vote (they separate the two
    # Faugeras conjugate solutions of a dominant-plane scene)
    z1s = torch.where(z1.abs() < 1e-9, 1e-9, z1)
    z2s = torch.where(z2.abs() < 1e-9, 1e-9, z2)
    e1 = torch.sum((pts1[..., :2] / z1s[..., None] - r1[..., :2]) ** 2, dim=-1)
    e2 = torch.sum((p2[..., :2] / z2s[..., None] - r2[..., :2]) ** 2, dim=-1)
    reproj_ok = (e1 < 4.0 * err_thresh) & (e2 < 4.0 * err_thresh)
    centre2 = -torch.einsum("...ji,...j->...i", R21, t21)       # camera 2's centre in frame 1
    v2 = pts1 - centre2[..., None, :]
    cosp = torch.sum(pts1 * v2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(pts1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1), min=1e-12)
    good = (valid[..., None, :] & (z1 > 1e-6) & (z2 > 1e-6) & (cosp < min_parallax_cos)
            & reproj_ok)
    return good, pts1, cosp


def _take(x: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """x indexed by k (one index per batch entry) along ``dim``."""
    shape = list(x.shape)
    shape[dim] = 1
    idx = k.reshape(k.shape + (1,) * (x.dim() - k.dim())).expand(shape)
    return torch.gather(x, dim, idx).squeeze(dim)


def reconstruct_two_views(
    rays1: torch.Tensor,
    rays2: torch.Tensor,
    valid: torch.Tensor,
    idx: torch.Tensor,
    err_thresh: float = 1e-5,
    min_parallax_cos: float = 0.99998,
) -> TwoViewResult:
    """Relative pose + structure from matched bearing rays.

    rays1/rays2: (..., N, 3) z=1 rays of matched features (padded; see
    ``valid`` (..., N)); ``idx``: (..., n_hyp, 8) minimal sets
    (:func:`sample_minimal_sets`); the first 4 of each also seed a
    homography.  ``err_thresh``: Sampson threshold in normalised
    coordinates; ``min_parallax_cos``: triangulated points need parallax
    below this cosine.
    """
    dtype = rays1.dtype
    N = rays1.shape[-2]
    # thresholds rounded as the JAX package's float32 scalars are
    th = float(np.float32(err_thresh))
    # model-selection score offset: both models scored with the 2-dof chi2
    # (5.991) while the F inliers are gated at 3.841
    th_score = float(np.float32(th) * np.float32(5.991 / 3.841))
    vm = valid[..., None, :]

    def gather_rays(rays, sel):  # (..., H, k, 3) rows of (..., N, 3)
        flat = sel.reshape(*sel.shape[:-2], -1)
        out = torch.gather(rays, -2, flat[..., None].expand(*flat.shape, 3))
        return out.reshape(*sel.shape, 3)

    # ===== essential hypotheses, scored over both epipolar directions =====
    E = _eight_point_essential(gather_rays(rays1, idx), gather_rays(rays2, idx))
    d1, d2 = _epipolar_errors(E, rays1, rays2)
    inl = (d1 < th) & (d2 < th) & vm
    score = torch.sum(torch.where(vm & (d1 < th), th_score - d1, 0.0)
                      + torch.where(vm & (d2 < th), th_score - d2, 0.0), dim=-1)
    # every score is finite (a non-finite error fails its comparison), so
    # argmax (first maximum, as in JAX) sees no nan
    best = torch.argmax(score, dim=-1)

    # ===== homography hypotheses (planar / low-parallax scene) =====
    Hh = _four_point_homography(gather_rays(rays1, idx[..., :4]), gather_rays(rays2, idx[..., :4]))
    e12, e21 = _transfer_errors(Hh, rays1, rays2)
    inl_h = (e12 < th_score) & (e21 < th_score) & vm
    score_h = torch.sum(torch.where(vm & (e12 < th_score), th_score - e12, 0.0)
                        + torch.where(vm & (e21 < th_score), th_score - e21, 0.0), dim=-1)
    best_h = torch.argmax(score_h, dim=-1)

    # ===== model selection: RH = SH / (SH + SF) > 0.40 =====
    SF = _take(score, best, -1)
    SH = _take(score_h, best_h, -1)
    use_H = SH / torch.clamp(SH + SF, min=1e-12) > 0.40

    # --- refit E on the inliers (refit -> reclassify -> refit) ---
    inl_best_e = _take(inl, best, -2)
    a1, b1 = rays1[..., 0], rays1[..., 1]
    a2, b2 = rays2[..., 0], rays2[..., 1]
    A_full = torch.stack(
        [a2 * a1, a2 * b1, a2, b2 * a1, b2 * b1, b2, a1, b1, torch.ones_like(a1)], dim=-1)
    D = _diag110(rays1)
    for _ in range(2):
        Aw = A_full * inl_best_e.to(dtype)[..., None]
        E_ls = _null_vector(Aw).reshape(*Aw.shape[:-2], 3, 3)
        U, _, Vt2 = torch.linalg.svd(E_ls)
        E_best = U @ D @ Vt2
        err_best = _sampson_error(E_best[..., None, :, :], rays1, rays2)[..., 0, :]
        inl_best_e = (err_best < th) & valid

    # --- refit H on the inliers (iterated DLT least squares) ---
    inl_best_h = _take(inl_h, best_h, -2)
    rows = _homography_rows(rays1, rays2)                               # (..., 2N, 9)
    for _ in range(2):
        wh = inl_best_h.to(dtype)
        Ah = rows * torch.cat([wh, wh], dim=-1)[..., None]
        H_best = _null_vector(Ah).reshape(*Ah.shape[:-2], 3, 3)
        e12b, e21b = _transfer_errors(H_best[..., None, :, :], rays1, rays2)
        inl_best_h = (e12b[..., 0, :] < th_score) & (e21b[..., 0, :] < th_score) & valid

    # --- candidate motions: 8 from H (Faugeras), 4 from E (padded to 8) ---
    Rs_h, ts_h, h_degenerate = _decompose_homography(H_best)
    Re, te = _decompose_essential(E_best)
    cand_R = torch.where(use_H[..., None, None, None], Rs_h, torch.cat([Re, Re], dim=-3))
    cand_t = torch.where(use_H[..., None, None], ts_h, torch.cat([te, te], dim=-2))
    # the duplicate E candidates are kept out of the vote
    cand_valid = use_H[..., None] | (torch.arange(8, device=rays1.device) < 4)

    goods, _, cosps = _check_motions(cand_R, cand_t, rays1, rays2, valid, th, min_parallax_cos)
    goods = goods & cand_valid[..., None]
    counts = torch.sum(goods, dim=-1)                                   # (..., 8)
    kbest = torch.argmax(counts, dim=-1)
    n_good = _take(counts, kbest, -1)
    n_second = torch.sort(counts, dim=-1).values[..., -2]
    ksec = torch.argmax(torch.where(torch.arange(8, device=counts.device) == kbest[..., None],
                                    -1, counts), dim=-1)
    # pairwise disambiguation on the disagreement set: under a dominant
    # plane both Faugeras conjugates explain every plane point; the
    # off-plane points that only one explains decide
    g_best, g_sec = _take(goods, kbest, -2), _take(goods, ksec, -2)
    n_a = torch.sum(g_best & ~g_sec, dim=-1)
    n_dis = n_a + torch.sum(g_sec & ~g_best, dim=-1)
    decisive = (n_a >= 0.8 * n_dis) & (n_dis >= 20)

    # enough well-triangulated points, a clear cheirality winner, and real
    # parallax at the 50th-best point (reference minTriangulated = 50,
    # minParallax = 1 deg)
    cosp_best = torch.where(g_best, _take(cosps, kbest, -2), 1.0)
    parallax_50 = torch.sort(cosp_best, dim=-1).values[..., min(49, N - 1)]
    cos1 = torch.cos(torch.deg2rad(torch.tensor(1.0, dtype=dtype)))
    success = (
        (n_good >= 50)
        & ((n_second < 0.75 * n_good) | decisive)
        & (parallax_50 < cos1.to(rays1.device))
        & ~(use_H & h_degenerate)
    )

    # polish the winning motion on its inliers, then triangulate with it;
    # success gates on the post-polish inliers too
    R_w, t_w = _take(cand_R, kbest, -3), _take(cand_t, kbest, -2)
    R_w, t_w = _refine_rt_sampson(R_w, t_w, rays1, rays2, g_best.to(dtype))
    good_f, pts_f, _ = _check_motions(R_w[..., None, :, :], t_w[..., None, :], rays1, rays2,
                                      valid, th, min_parallax_cos)
    good_f, pts_f = good_f[..., 0, :], pts_f[..., 0, :, :]
    n_inl = torch.sum(good_f, dim=-1)
    i32 = torch.int32
    return TwoViewResult(
        success=success & (n_inl >= 40), R21=R_w, t21=t_w, points1=pts_f, is_inlier=good_f,
        n_inliers=n_inl.to(i32), vote_best=n_good.to(i32), vote_second=n_second.to(i32),
        n_dis=n_dis.to(i32), used_h=use_H,
    )

