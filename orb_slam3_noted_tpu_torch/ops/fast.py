"""FAST-9/16 corner detection as dense whole-image operations.

Port of :mod:`orb_slam3_noted_tpu.ops.fast`: the dense score map (the plain
version of kernel K1, ``ops/cuda_kernels.py``), 3x3 NMS, the per-cell dual
threshold, per-cell top-k and a global top-N, over a leading batch shape.

Top-k is a stable descending sort everywhere: ``lax.top_k`` returns equal
scores lowest index first, ``torch.topk`` does not, and level-0 FAST scores
are integers that tie often.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, in ring order (dy, dx).
CIRCLE_16 = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC = 9  # contiguous arc length for FAST-9/16


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 corner score map, (..., H, W) float32 -> same.

    score(p) = max over the 16 contiguous 9-arcs of min(margin), margin =
    (ring - center) for bright arcs and (center - ring) for dark arcs.  The
    ring wraps at the image edges (``torch.roll``); callers mask a border.
    """
    rolled = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1)) for dy, dx in CIRCLE_16],
        dim=0,
    )  # ring[k][y, x] = img[y + dy_k, x + dx_k]
    d = rolled - img[None]  # (16, ..., H, W)

    def windowed_min(x, window):
        # circular windowed min over `window` consecutive ring positions
        m = x
        covered = 1
        while covered < window:
            s = min(covered, window - covered)
            m = torch.minimum(m, torch.roll(m, -s, dims=0))
            covered += s
        return m

    bright = torch.amax(windowed_min(d, ARC), dim=0)
    dark = torch.amax(windowed_min(-d, ARC), dim=0)
    return torch.maximum(bright, dark)


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties lowest
    index first, as ``lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Keypoints(NamedTuple):
    """Fixed-size keypoint set for one pyramid level."""

    xy: torch.Tensor      # (..., K, 2) float32, (x, y) at this level's resolution
    score: torch.Tensor   # (..., K) float32 FAST score
    valid: torch.Tensor   # (..., K) bool


def detect_level(
    score_map: torch.Tensor,
    n_out: int,
    cell: int = 32,
    th_high: float = 20.0,
    th_low: float = 7.0,
    border: int = 16,
) -> Keypoints:
    """Select up to n_out spatially-distributed corners from a (..., H, W)
    score map: border and low-threshold mask, 3x3 NMS, per-cell dual
    threshold, per-cell top-k, then a global top-n_out."""
    batch = score_map.shape[:-2]
    h, w = score_map.shape[-2:]
    dev = score_map.device
    s_in = score_map.reshape(-1, h, w)
    nb = s_in.shape[0]
    neg = -1e30

    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    in_border = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    s = torch.where((s_in > th_low) & in_border, s_in, neg)
    pooled = F.max_pool2d(s_in[:, None], 3, stride=1, padding=1)[:, 0]
    s = torch.where(s_in >= pooled, s, neg)

    ph = (h + cell - 1) // cell * cell
    pw = (w + cell - 1) // cell * cell
    s_pad = torch.full((nb, ph, pw), neg, dtype=s.dtype, device=dev)
    s_pad[:, :h, :w] = s
    ncy, ncx = ph // cell, pw // cell
    cells = s_pad.reshape(nb, ncy, cell, ncx, cell).permute(0, 1, 3, 2, 4).reshape(
        nb, ncy * ncx, cell * cell
    )

    cell_max = torch.amax(cells, dim=2, keepdim=True)
    cell_th = torch.where(cell_max > th_high, th_high, th_low)
    cells = torch.where(cells > cell_th, cells, neg)

    k_per_cell = max(1, min(cell * cell, 4 * n_out // max(ncy * ncx, 1) + 2))
    cand_s, cand_i = topk_stable(cells, k_per_cell)  # (nb, nc, k)
    cidx = torch.arange(ncy * ncx, device=dev)
    iy = (cidx // ncx)[:, None] * cell + cand_i // cell
    ix = (cidx % ncx)[:, None] * cell + cand_i % cell

    top_s, top_idx = topk_stable(cand_s.reshape(nb, -1), n_out)
    ky = torch.gather(iy.reshape(nb, -1), 1, top_idx)
    kx = torch.gather(ix.reshape(nb, -1), 1, top_idx)
    valid = top_s > neg / 2
    xy = torch.stack([kx, ky], dim=-1).to(torch.float32)
    return Keypoints(
        xy=xy.reshape(*batch, n_out, 2),
        score=torch.where(valid, top_s, 0.0).reshape(*batch, n_out),
        valid=valid.reshape(*batch, n_out),
    )


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    """Per-level feature budgets, geometric with ratio 1/scale_factor; the
    last level absorbs the remainder (reference ``mnFeaturesPerLevel``)."""
    factor = 1.0 / scale_factor
    n_desired = n_features * (1.0 - factor) / (1.0 - factor ** n_levels)
    budgets = []
    total = 0
    for _ in range(n_levels - 1):
        b = int(round(n_desired))
        budgets.append(b)
        total += b
        n_desired *= factor
    budgets.append(max(n_features - total, 0))
    return budgets
