"""FAST-9/16 corner detection as dense whole-image operations.

Port of :mod:`orb_slam3_noted_tpu.ops.fast`: the dense score map (the plain
version of kernel K1's scoring, ``ops/cuda_kernels.py``), then selection in
two steps: :func:`cell_candidates` (3x3 NMS, the per-cell dual threshold,
per-cell top-k; what kernel K1 does on the card for a whole pyramid atlas)
and :func:`select_from_cells` (the global top-N), over a leading batch shape.

Top-k is a stable descending sort everywhere: ``lax.top_k`` returns equal
scores lowest index first, ``torch.topk`` does not, and level-0 FAST scores
are integers that tie often.
"""

from __future__ import annotations

import functools
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


NEG = -1e30  # score of a masked pixel and of an empty candidate slot


def cell_grid(h: int, w: int, cell: int = 32) -> tuple[int, int]:
    """(rows, columns) of the ``cell`` x ``cell`` grid over an (h, w) level;
    the last row and column of cells may be partial."""
    return (h + cell - 1) // cell, (w + cell - 1) // cell


def candidates_per_cell(n_out: int, n_cells: int, cell: int = 32) -> int:
    """Candidates kept in every cell so that ``n_cells`` cells offer about
    four times the ``n_out`` corners asked for."""
    return max(1, min(cell * cell, 4 * n_out // max(n_cells, 1) + 2))


def cell_candidates(
    score_map: torch.Tensor,
    n_out: int,
    cell: int = 32,
    th_high: float = 20.0,
    th_low: float = 7.0,
    border: int = 16,
):
    """Per-cell corner candidates of a (..., H, W) score map: border and
    low-threshold mask, 3x3 NMS on the raw score, per-cell dual threshold,
    then each cell's k best.  Returns (cand_s, cand_i), both (..., cells, k):
    scores (``NEG`` in empty slots) and in-cell indices ``cy * cell + cx``,
    cells in row-major order."""
    batch = score_map.shape[:-2]
    h, w = score_map.shape[-2:]
    dev = score_map.device
    s_in = score_map.reshape(-1, h, w)
    nb = s_in.shape[0]

    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    in_border = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    s = torch.where((s_in > th_low) & in_border, s_in, NEG)
    pooled = F.max_pool2d(s_in[:, None], 3, stride=1, padding=1)[:, 0]
    s = torch.where(s_in >= pooled, s, NEG)

    ncy, ncx = cell_grid(h, w, cell)
    s_pad = torch.full((nb, ncy * cell, ncx * cell), NEG, dtype=s.dtype, device=dev)
    s_pad[:, :h, :w] = s
    cells = s_pad.reshape(nb, ncy, cell, ncx, cell).permute(0, 1, 3, 2, 4).reshape(
        nb, ncy * ncx, cell * cell
    )

    cell_max = torch.amax(cells, dim=2, keepdim=True)
    cell_th = torch.where(cell_max > th_high, th_high, th_low)
    cells = torch.where(cells > cell_th, cells, NEG)

    cand_s, cand_i = topk_stable(cells, candidates_per_cell(n_out, ncy * ncx, cell))
    return cand_s.reshape(*batch, *cand_s.shape[1:]), cand_i.reshape(*batch, *cand_i.shape[1:])


@functools.lru_cache(maxsize=64)
def _cell_origins(nc: int, ncx: int, cell: int, device: torch.device):
    """(y, x) of the first pixel of each of ``nc`` cells of a grid with
    ``ncx`` columns, (nc, 1) int64 each; made once per grid and device."""
    cidx = torch.arange(nc, device=device)
    return (cidx // ncx)[:, None] * cell, (cidx % ncx)[:, None] * cell


def select_from_cells(
    cand_s: torch.Tensor, cand_i: torch.Tensor, ncx: int, n_out: int, cell: int = 32
) -> Keypoints:
    """The n_out best of the (..., cells, k) candidates of a level whose
    cell grid has ``ncx`` columns; equal scores go by (cell, rank)."""
    batch = cand_s.shape[:-2]
    nc = cand_s.shape[-2]
    flat = lambda t: t.reshape(-1, nc * t.shape[-1])
    oy, ox = _cell_origins(nc, ncx, cell, cand_s.device)
    iy = oy + cand_i // cell
    ix = ox + cand_i % cell

    top_s, top_idx = topk_stable(flat(cand_s), n_out)
    ky = torch.gather(flat(iy), 1, top_idx)
    kx = torch.gather(flat(ix), 1, top_idx)
    valid = top_s > NEG / 2
    xy = torch.stack([kx, ky], dim=-1).to(torch.float32)
    return Keypoints(
        xy=xy.reshape(*batch, n_out, 2),
        score=torch.where(valid, top_s, 0.0).reshape(*batch, n_out),
        valid=valid.reshape(*batch, n_out),
    )


def detect_level(
    score_map: torch.Tensor,
    n_out: int,
    cell: int = 32,
    th_high: float = 20.0,
    th_low: float = 7.0,
    border: int = 16,
) -> Keypoints:
    """Select up to n_out spatially-distributed corners from a (..., H, W)
    score map: :func:`cell_candidates`, then :func:`select_from_cells`."""
    cand_s, cand_i = cell_candidates(score_map, n_out, cell, th_high, th_low, border)
    ncx = cell_grid(*score_map.shape[-2:], cell)[1]
    return select_from_cells(cand_s, cand_i, ncx, n_out, cell)


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
