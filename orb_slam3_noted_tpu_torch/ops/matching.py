"""Binary-descriptor matching (port of :mod:`orb_slam3_noted_tpu.ops.matching`).

Hamming distances come from one float32 product of unpacked bits,
``popA + popB - 2 A B^T``: the products are 0/1 and the sums at most 256,
so every term is exact in float32 (TF32 is off).  Nearest neighbours with
the reference's gates, window-gated projection matching and the
duplicate-target resolution follow the JAX package step for step; argmin
returns the first minimum and top-k is a stable sort, as in XLA.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.ops.fast import topk_stable

TH_HIGH = 100  # reference ORBmatcher::TH_HIGH
TH_LOW = 50    # reference ORBmatcher::TH_LOW
HISTO_LENGTH = 30
BIG = 1 << 20


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) int32 -> (..., N, 256) float32 0/1 bit matrix (bit order =
    pack order)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], 256).to(torch.float32)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., Na, 8) x (..., Nb, 8) packed descriptors -> (..., Na, Nb) int32
    Hamming distances (leading dimensions broadcast)."""
    return hamming_bits(unpack_bits(a), unpack_bits(b))


def hamming_bits(ba: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """:func:`hamming_matrix` of descriptors already unpacked to (..., N,
    256) 0/1 float32 bits."""
    dot = ba @ bb.transpose(-1, -2)
    pa = ba.sum(-1)
    pb = bb.sum(-1)
    return (pa[..., :, None] + pb[..., None, :] - 2.0 * dot).to(torch.int32)


class Matches(NamedTuple):
    idx: torch.Tensor   # (Na,) int32 index into B, -1 if unmatched
    dist: torch.Tensor  # (Na,) int32 Hamming distance (BIG if unmatched)


def _best_two(masked: torch.Tensor):
    """(best, second, argbest) along the last axis."""
    best = torch.amin(masked, dim=-1)
    idx = torch.argmin(masked, dim=-1).to(torch.int32)  # first minimum
    cols = torch.arange(masked.shape[-1], device=masked.device, dtype=torch.int32)
    masked2 = torch.where(cols == idx[..., None], BIG, masked)
    second = torch.amin(masked2, dim=-1)
    return best, second, idx


def _rotation_consistency(ang_a, ang_b, idx, matched):
    """Keep only matches whose angle difference falls in the 3 modal bins
    (one histogram per leading batch entry)."""
    d = ang_a - torch.gather(ang_b, -1, idx.clamp(min=0).long())
    d = torch.remainder(d, 2 * math.pi)
    bins = torch.clamp((d * (HISTO_LENGTH / (2 * math.pi))).to(torch.int32), 0, HISTO_LENGTH - 1)
    hist = torch.zeros((*bins.shape[:-1], HISTO_LENGTH), dtype=torch.int32, device=idx.device)
    hist = hist.scatter_add(-1, bins.long(), matched.to(torch.int32))
    top3 = topk_stable(hist, 3)[1]
    keep_bin = torch.zeros(hist.shape, dtype=torch.bool, device=idx.device).scatter(-1, top3, True)
    keep_bin = keep_bin & (hist > 0.1 * torch.amax(hist, dim=-1, keepdim=True))
    return matched & torch.gather(keep_bin, -1, bins.long())


def match_nn(
    dist: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
    mutual: bool = True,
    ang_a: torch.Tensor | None = None,
    ang_b: torch.Tensor | None = None,
) -> Matches:
    """Gated nearest-neighbour matching on a precomputed (..., Na, Nb)
    distance matrix (a leading batch of pairs is matched pair by pair)."""
    masked = torch.where(valid_a[..., :, None] & valid_b[..., None, :], dist, BIG)
    best, second, idx = _best_two(masked)
    ok = (best <= max_dist) & valid_a
    if ratio < 1.0:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    if mutual:
        best_for_b = torch.argmin(masked, dim=-2)
        ok = ok & (torch.gather(best_for_b, -1, idx.long())
                   == torch.arange(dist.shape[-2], device=dist.device))
    if ang_a is not None and ang_b is not None:
        ok = _rotation_consistency(ang_a, ang_b, idx, ok)
    return Matches(idx=torch.where(ok, idx, -1), dist=torch.where(ok, best, BIG))


def search_by_projection(
    uv_pred: torch.Tensor,
    radius: torch.Tensor,
    level_pred: torch.Tensor,
    desc_q: torch.Tensor,
    valid_q: torch.Tensor,
    feat_xy: torch.Tensor,
    feat_level: torch.Tensor,
    feat_desc: torch.Tensor,
    feat_valid: torch.Tensor,
    max_dist: int = TH_HIGH,
    ratio: float = 1.0,
    level_window: tuple = (-1, 1),
) -> Matches:
    """Window-gated projection matching (query points -> frame features),
    ``ORBmatcher::SearchByProjection``.  Returns (Nq,) Matches into the frame
    features."""
    d = hamming_matrix(desc_q, feat_desc)  # (Nq, Nf)
    du = uv_pred[:, None, 0] - feat_xy[None, :, 0]
    dv = uv_pred[:, None, 1] - feat_xy[None, :, 1]
    inside = (du * du + dv * dv) <= (radius[:, None] ** 2)
    lvl_ok = (feat_level[None, :] >= level_pred[:, None] + level_window[0]) & (
        feat_level[None, :] <= level_pred[:, None] + level_window[1]
    )
    gate = inside & lvl_ok & feat_valid[None, :] & valid_q[:, None]
    masked = torch.where(gate, d, BIG)
    best, second, idx = _best_two(masked)
    ok = (best <= max_dist) & valid_q
    if ratio < 1.0:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return Matches(idx=torch.where(ok, idx, -1), dist=torch.where(ok, best, BIG))


def resolve_duplicates(matches: Matches, n_targets: int) -> Matches:
    """Keep only the lowest-distance query per target feature, ties to the
    smallest query index (a segment-min over target indices)."""
    idx = matches.idx
    dist = matches.dist
    tgt = idx.clamp(min=0).long()
    best_per_tgt = torch.full((n_targets,), BIG, dtype=torch.int32, device=idx.device)
    best_per_tgt = best_per_tgt.scatter_reduce(
        0, tgt, torch.where(idx >= 0, dist, BIG), reduce="amin"
    )
    is_best = (idx >= 0) & (dist == best_per_tgt[tgt])
    qidx = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    first_q = torch.full((n_targets,), 1 << 30, dtype=torch.int32, device=idx.device)
    first_q = first_q.scatter_reduce(
        0, tgt, torch.where(is_best, qidx, 1 << 30), reduce="amin"
    )
    keep = is_best & (first_q[tgt] == qidx)
    return Matches(idx=torch.where(keep, idx, -1), dist=torch.where(keep, dist, BIG))
