"""Plain reference of the rectified stereo front end: ORB extraction (image
pyramid, FAST-9/16 per-cell candidates, intensity-centroid angles, 7-tap
blur, steered BRIEF) and the stereo matcher (Hamming candidates under the
row, octave and disparity gates, 11x11 SAD over +-5 px, parabola fit,
median SAD filter).

Frozen copies of the port's plain versions, at the port's commit this
benchmark was written against, one function each, with the source they came
from beside it:

- ``orb_slam3_noted_tpu_torch/ops/image.py``: ``gaussian_kernel1d``,
  ``gaussian_blur``, ``resize_weights``, ``resize_bilinear``,
  ``pyramid_sizes``, ``build_pyramid``, ``level_offsets``, ``build_atlas``
- ``ops/fast.py``: ``CIRCLE_16``, ``fast_score``, ``topk_stable``,
  ``cell_grid``, ``candidates_per_cell``, ``cell_candidates``,
  ``select_from_cells``, ``level_budgets``
- ``ops/cuda_kernels.py``: ``candidate_layout``, ``fast_candidates_plain``,
  ``gaussian_blur7_plain``, ``rotated_pattern``, ``brief_sample_plain``,
  ``brief_sample_atlas_plain``, ``sad_stereo_plain`` (the plain versions of
  kernels K1-K4)
- ``ops/orb.py``: ``_umax_table``, ``ic_angles_atlas``, ``detect_from_atlas``,
  ``describe``
- ``ops/matching.py``: ``unpack_bits``, ``hamming_matrix``
- ``ops/stereo.py``: ``level_centres``, ``hamming_candidates``,
  ``match_stereo``
- ``pipeline/tracking.py``: ``stereo_frontend_batch``; ``pipeline/system.py``
  ``StereoSLAM.process``'s front end

Departures: no profiler ranges, no kernel dispatch, no caches of device
tables; and every floating-point step takes the image's ``dtype``, so the
same code computes the reference (float32) and its lower-precision control
(bfloat16).  It imports torch and numpy only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from slam_bench.reference.orb_pattern import BIT_PATTERN_31

NEG = -1e30
CELL = 32
HALF_PATCH = 15
SAD_HALF, SAD_SLIDE = 5, 5
SAD_SHIFTS = 2 * SAD_SLIDE + 1
TH_HIGH, TH_LOW = 100, 50
BIG = 1 << 20
BLUR_SIGMA = 2.0
CIRCLE_16 = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)], dtype=np.int32)
ARC = 9
PATTERN_XY = np.ascontiguousarray(np.concatenate(
    [BIT_PATTERN_31[:, 0:2], BIT_PATTERN_31[:, 2:4]], 0).astype(np.float32))


class Features(NamedTuple):
    xy: torch.Tensor        # (..., N, 2) level-0 coordinates
    level: torch.Tensor     # (..., N) int32
    angle: torch.Tensor     # (..., N) radians
    response: torch.Tensor  # (..., N) FAST score
    desc: torch.Tensor      # (..., N, 8) int32 packed bits
    valid: torch.Tensor     # (..., N) bool


class Atlas(NamedTuple):
    image: torch.Tensor
    off: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor
    sizes: tuple


# --- image.py -----------------------------------------------------------------

def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    k = torch.as_tensor(gaussian_kernel1d(ksize, sigma), dtype=img.dtype, device=img.device)
    r = ksize // 2
    H, W = img.shape[-2], img.shape[-1]
    x = F.pad(img.reshape(-1, H, W), (r, r, r, r), mode="reflect")
    out = torch.zeros_like(x[..., r:-r])
    for i in range(ksize):
        out = out + k[i] * x[..., :, i: i + W]
    out2 = torch.zeros_like(out[..., r:-r, :])
    for i in range(ksize):
        out2 = out2 + k[i] * out[..., i: i + H, :]
    return out2.reshape(img.shape)


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
              * np.float64(inv_scale) - 0.5).astype(f32)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - dist * (f32(1.0) / kernel_scale))
    total = np.zeros((1, out_size), f32)
    for row in w:
        total = total + row
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    wh = torch.from_numpy(resize_weights(img.shape[-2], out_h)).to(img.device, img.dtype)
    ww = torch.from_numpy(resize_weights(img.shape[-1], out_w)).to(img.device, img.dtype)
    return torch.matmul(torch.matmul(wh.T, img), ww)


def pyramid_sizes(h: int, w: int, n_levels: int, scale_factor: float):
    sizes = [(h, w)]
    fh, fw = float(h), float(w)
    for _ in range(1, n_levels):
        fh, fw = fh / scale_factor, fw / scale_factor
        sizes.append((int(round(fh)), int(round(fw))))
    return sizes


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float) -> list:
    sizes = pyramid_sizes(img.shape[-2], img.shape[-1], n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], *sizes[lvl]))
    return levels


def level_offsets(sizes: tuple) -> list:
    return [int(o) for o in np.concatenate([[0], np.cumsum([h for h, _ in sizes])])[:len(sizes)]]


def level_views(image: torch.Tensor, sizes: tuple) -> list:
    return [image[..., o:o + h, :w] for o, (h, w) in zip(level_offsets(sizes), sizes)]


def build_atlas(pyr: tuple) -> Atlas:
    W0 = pyr[0].shape[-1]
    sizes = tuple((int(p.shape[-2]), int(p.shape[-1])) for p in pyr)
    image = torch.cat([F.pad(p, (0, W0 - w)) for p, (_, w) in zip(pyr, sizes)], dim=-2).contiguous()
    dev = image.device
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return Atlas(image, i32(level_offsets(sizes)), i32([h for h, _ in sizes]),
                 i32([w for _, w in sizes]), sizes)


# --- fast.py ------------------------------------------------------------------

def fast_score(img: torch.Tensor) -> torch.Tensor:
    rolled = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1)) for dy, dx in CIRCLE_16], dim=0)
    d = rolled - img[None]

    def windowed_min(x, window):
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
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cell_grid(h: int, w: int, cell: int = CELL) -> tuple:
    return (h + cell - 1) // cell, (w + cell - 1) // cell


def candidates_per_cell(n_out: int, n_cells: int, cell: int = CELL) -> int:
    return max(1, min(cell * cell, 4 * n_out // max(n_cells, 1) + 2))


def cell_candidates(score_map, n_out, cell=CELL, th_high=20.0, th_low=7.0, border=16):
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
        nb, ncy * ncx, cell * cell)
    cell_max = torch.amax(cells, dim=2, keepdim=True)
    cell_th = torch.where(cell_max > th_high, th_high, th_low)
    cells = torch.where(cells > cell_th, cells, NEG)
    cand_s, cand_i = topk_stable(cells, candidates_per_cell(n_out, ncy * ncx, cell))
    return cand_s.reshape(*batch, *cand_s.shape[1:]), cand_i.reshape(*batch, *cand_i.shape[1:])


def select_from_cells(cand_s, cand_i, ncx, n_out, cell=CELL):
    batch = cand_s.shape[:-2]
    nc = cand_s.shape[-2]
    flat = lambda t: t.reshape(-1, nc * t.shape[-1])
    cidx = torch.arange(nc, device=cand_s.device)
    oy, ox = (cidx // ncx)[:, None] * cell, (cidx % ncx)[:, None] * cell
    iy = oy + cand_i // cell
    ix = ox + cand_i % cell
    top_s, top_idx = topk_stable(flat(cand_s), n_out)
    ky = torch.gather(flat(iy), 1, top_idx)
    kx = torch.gather(flat(ix), 1, top_idx)
    valid = top_s > NEG / 2
    xy = torch.stack([kx, ky], dim=-1).to(torch.float32)
    return (xy.reshape(*batch, n_out, 2),
            torch.where(valid, top_s, 0.0).reshape(*batch, n_out),
            valid.reshape(*batch, n_out))


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> list:
    factor = 1.0 / scale_factor
    n_desired = n_features * (1.0 - factor) / (1.0 - factor ** n_levels)
    budgets, total = [], 0
    for _ in range(n_levels - 1):
        b = int(round(n_desired))
        budgets.append(b)
        total += b
        n_desired *= factor
    budgets.append(max(n_features - total, 0))
    return budgets


# --- cuda_kernels.py: the plain versions of K1-K4 ----------------------------------

def candidate_layout(sizes: tuple, budgets: tuple):
    first, per_row, k = [0], [], []
    for (h, w), n_out in zip(sizes, budgets):
        ncy, ncx = cell_grid(h, w, CELL)
        live = n_out > 0
        per_row.append(ncx)
        k.append(candidates_per_cell(n_out, ncy * ncx, CELL) if live else 0)
        first.append(first[-1] + (ncy * ncx if live else 0))
    return tuple(first), tuple(per_row), tuple(k), first[-1], max(k)


def fast_candidates_plain(atlas, sizes, budgets, th_high=20.0, th_low=7.0, border=16):
    first, _, k, n_cells, k_max = candidate_layout(sizes, tuple(budgets))
    batch = atlas.shape[:-2]
    cand_s = torch.full((*batch, n_cells, k_max), NEG, dtype=atlas.dtype, device=atlas.device)
    cand_i = torch.zeros((*batch, n_cells, k_max), dtype=torch.int32, device=atlas.device)
    for l, (view, n_out) in enumerate(zip(level_views(atlas, sizes), budgets)):
        if k[l] == 0:
            continue
        s, i = cell_candidates(fast_score(view), n_out, CELL, th_high, th_low, border)
        cand_s[..., first[l]:first[l + 1], :k[l]] = s
        cand_i[..., first[l]:first[l + 1], :k[l]] = i
    return cand_s, cand_i


def gaussian_blur7_plain(img: torch.Tensor, sizes: tuple) -> torch.Tensor:
    out = torch.zeros_like(img)
    for src, dst in zip(level_views(img, sizes), level_views(out, sizes)):
        dst.copy_(gaussian_blur(src, 7, BLUR_SIGMA))
    return out


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64) << shifts, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def rotated_pattern(angle: torch.Tensor):
    a = torch.cos(angle)[..., None]
    b = torch.sin(angle)[..., None]
    pall = torch.from_numpy(PATTERN_XY).to(angle.device, angle.dtype)
    px, py = pall[:, 0], pall[:, 1]
    rx = torch.round(px * a - py * b).to(torch.int32)
    ry = torch.round(px * b + py * a).to(torch.int32)
    return rx, ry


def brief_sample_plain(img_blur, gy, gx):
    H, W = img_blur.shape[-2:]
    flat = img_blur.reshape(*img_blur.shape[:-2], H * W)
    idx = (gy * W + gx).reshape(*gy.shape[:-2], -1).to(torch.int64)
    vals = torch.gather(flat, -1, idx).reshape(gy.shape)
    return _pack_words(vals[..., :256] < vals[..., 256:])


def brief_sample_atlas_plain(atlas_blur, atlas: Atlas, xy, angle, level):
    lv = torch.clamp(level.long(), 0, len(atlas.sizes) - 1)
    rx, ry = rotated_pattern(angle)
    zero = torch.zeros((), dtype=torch.int32, device=atlas_blur.device)
    gx = torch.clamp(xy[..., 0:1] + rx, zero, atlas.w[lv][..., None] - 1)
    gy = torch.clamp(xy[..., 1:2] + ry, zero, atlas.h[lv][..., None] - 1) + atlas.off[lv][..., None]
    return brief_sample_plain(atlas_blur, gy, gx)


def sad_stereo_plain(atlas_l, atlas_r, cv, cu, cur, lvl, off_t, h_t, w_t):
    dev = atlas_l.device
    lv = lvl.long()
    h = h_t.long()[lv][..., None]
    w = w_t.long()[lv][..., None]
    off = off_t.long()[lv][..., None]
    d = torch.arange(-SAD_HALF, SAD_HALF + 1, device=dev)
    dr = torch.arange(-(SAD_HALF + SAD_SLIDE), SAD_HALF + SAD_SLIDE + 1, device=dev)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    yy = torch.clamp(cv.long()[..., None] + d, zero, h - 1) + off
    xxl = torch.clamp(cu.long()[..., None] + d, zero, w - 1)
    xxr = torch.clamp(cur.long()[..., None] + dr, zero, w - 1)
    W = atlas_l.shape[-1]

    def gather(atlas, xx):
        flat = atlas.reshape(*atlas.shape[:-2], -1)
        idx = yy[..., :, None] * W + xx[..., None, :]
        return torch.gather(flat, -1, idx.reshape(*idx.shape[:-3], -1)).reshape(idx.shape)

    patch = gather(atlas_l, xxl)
    strip = gather(atlas_r, xxr)
    n = 2 * SAD_HALF + 1
    return torch.stack([torch.sum(torch.abs(patch - strip[..., s:s + n]), dim=(-2, -1))
                        for s in range(SAD_SHIFTS)], dim=-1)


# --- orb.py -------------------------------------------------------------------

def _umax_table() -> np.ndarray:
    umax = np.zeros(HALF_PATCH + 2, dtype=np.int64)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: HALF_PATCH + 1]


def ic_angles_atlas(atlas: Atlas, xy, level, runs: tuple):
    P = HALF_PATCH + 1
    img = atlas.image
    dev = img.device
    W0 = img.shape[-1]
    WP = W0 + 2 * P
    inside = torch.cat([(torch.arange(W0) < w).expand(h, W0) for h, w in atlas.sizes]).to(dev)
    dy = torch.arange(-HALF_PATCH, HALF_PATCH + 1)
    span = torch.from_numpy(_umax_table())[dy.abs()]
    dy, span, span_f, dy_f = (t.to(dev) for t in (dy, span, span.to(img.dtype),
                                                   dy.to(img.dtype)))
    C1 = torch.cumsum(F.pad(torch.where(inside, img - 128.0, 0.0), (P, P)), dim=-1)
    C2 = torch.cumsum(C1, dim=-1)
    lv = level.long()
    h, w, off = atlas.h.long()[lv], atlas.w.long()[lv], atlas.off.long()[lv]
    flat = torch.clamp(xy[..., 1].long() * w + xy[..., 0].long(), max=h * w - 1)
    y, x = flat // w, flat % w
    rows = y[..., None] + dy
    in_level = (rows >= 0) & (rows < h[..., None])
    base = (off[..., None] + torch.clamp(rows, min=0)).clamp(max=img.shape[-2] - 1) * WP \
        + (x[..., None] + P)

    def at(C, k):
        return torch.gather(C.flatten(-2), -1, (base + k).flatten(-2)).reshape(base.shape)

    c1p, c1m = at(C1, span), at(C1, -span - 1)
    zero = torch.zeros((), dtype=img.dtype, device=dev)
    Bw = torch.where(in_level, dy_f * (c1p - c1m), zero)
    Tw = torch.where(in_level, span_f * (c1p + c1m) - at(C2, span - 1) + at(C2, -span - 1), zero)
    m10 = torch.zeros(flat.shape, dtype=img.dtype, device=dev)
    m01 = torch.zeros_like(m10)
    for r in range(2 * HALF_PATCH + 1):
        m10 = m10 + Tw[..., r]
        if r != HALF_PATCH:
            m01 = m01 + Bw[..., r]
    angle = torch.empty_like(m10)
    N = m10.shape[-1]
    for a, b, out in zip(m01.reshape(-1, N), m10.reshape(-1, N), angle.view(-1, N)):
        o = 0
        for n in runs:
            torch.atan2(a[o:o + n], b[o:o + n], out=out[o:o + n])
            o += n
    return angle


def extract_from_atlas(atlas: Atlas, n_features, n_levels, scale_factor, th_high, th_low):
    """``detect_from_atlas`` then ``describe``."""
    sizes = atlas.sizes
    batch = atlas.image.shape[:-2]
    budgets = tuple(max(b, 0) for b in level_budgets(n_features, n_levels, scale_factor)[:len(sizes)])
    cand_s, cand_i = fast_candidates_plain(atlas.image, sizes, budgets, th_high, th_low, 16)
    first, per_row, k, _, _ = candidate_layout(sizes, budgets)
    kps = [select_from_cells(cand_s[..., first[l]:first[l + 1], :k[l]],
                             cand_i[..., first[l]:first[l + 1], :k[l]], per_row[l], n_out, CELL)
           for l, n_out in enumerate(budgets) if n_out > 0]
    n = len(batch)
    xy, response, valid = (torch.cat(parts, dim=n) for parts in zip(*kps))
    lvl = torch.from_numpy(np.repeat(np.arange(len(budgets), dtype=np.int32), budgets)).to(xy.device)
    level = lvl.expand(*batch, -1).contiguous() if batch else lvl
    angle = ic_angles_atlas(atlas, xy, level, runs=tuple(b for b in budgets if b > 0))
    blur = gaussian_blur7_plain(atlas.image, sizes)
    desc = brief_sample_atlas_plain(blur, atlas, xy.to(torch.int32), angle, level)
    h0, w0 = sizes[0]
    ax = torch.tensor(tuple((w0 / w, h0 / h) for h, w in sizes), dtype=xy.dtype,
                      device=xy.device)[level.long()]
    return Features(xy=(xy + 0.5) * ax - 0.5, level=level, angle=angle, response=response,
                    desc=desc, valid=valid)


# --- matching.py, stereo.py ---------------------------------------------------------

def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=a.device)
    ba = ((a[..., None] >> shifts) & 1).reshape(*a.shape[:-1], 256).to(torch.float32)
    bb = ((b[..., None] >> shifts) & 1).reshape(*b.shape[:-1], 256).to(torch.float32)
    dot = ba @ bb.transpose(-1, -2)
    return (ba.sum(-1)[..., :, None] + bb.sum(-1)[..., None, :] - 2.0 * dot).to(torch.int32)


def match_stereo(left: Features, right: Features, pyr_left: tuple, al: Atlas, ar: Atlas,
                 bf: float, baseline: float, n_levels: int, scale_factor: float):
    """(u_right, depth, valid) of the left keypoints on a rectified pair."""
    NL = left.xy.shape[-2]
    dtype, dev = left.xy.dtype, left.xy.device
    max_d = bf / baseline
    # hamming_candidates
    sf = torch.tensor(tuple((scale_factor ** np.arange(n_levels, dtype=np.float64)).tolist()),
                      dtype=dtype, device=dev)
    th_orb = (TH_HIGH + TH_LOW) // 2
    d = hamming_matrix(left.desc, right.desc)
    row_tol = 2.0 * sf[right.level.long()]
    dv = torch.abs(left.xy[..., :, None, 1] - right.xy[..., None, :, 1])
    row_ok = dv <= row_tol[..., None, :]
    lvl_ok = torch.abs(left.level[..., :, None] - right.level[..., None, :]) <= 1
    disp = left.xy[..., :, None, 0] - right.xy[..., None, :, 0]
    disp_ok = (disp >= 0.0) & (disp <= max_d)
    gate = row_ok & lvl_ok & disp_ok & left.valid[..., :, None] & right.valid[..., None, :]
    masked = torch.where(gate, d, BIG)
    idx_r = torch.argmin(masked, dim=-1)
    have = torch.amin(masked, dim=-1) < th_orb
    # level_centres
    H0, W0 = pyr_left[0].shape[-2], pyr_left[0].shape[-1]
    sx_t = torch.tensor(tuple(W0 / p.shape[-1] for p in pyr_left), dtype=dtype, device=dev)
    sy_t = torch.tensor(tuple(H0 / p.shape[-2] for p in pyr_left), dtype=dtype, device=dev)
    lvl = left.level.long()
    sx, sy = sx_t[lvl], sy_t[lvl]
    uR0 = torch.gather(right.xy[..., 0], -1, idx_r.long())
    cu = torch.round((left.xy[..., 0] + 0.5) / sx - 0.5).to(torch.int32)
    cv = torch.round((left.xy[..., 1] + 0.5) / sy - 0.5).to(torch.int32)
    cur = torch.round((uR0 + 0.5) / sx - 0.5).to(torch.int32)
    # match_stereo
    uL0 = left.xy[..., 0]
    sads = sad_stereo_plain(al.image, ar.image, cv, cu, cur, left.level, al.off, al.h, al.w)
    k = torch.argmin(sads, dim=-1)
    interior = (k > 0) & (k < 2 * SAD_SLIDE)
    km = torch.clamp(k, 1, 2 * SAD_SLIDE - 1)
    d1 = torch.gather(sads, -1, (km - 1)[..., None])[..., 0]
    d2 = torch.gather(sads, -1, km[..., None])[..., 0]
    d3 = torch.gather(sads, -1, (km + 1)[..., None])[..., 0]
    denom = d1 + d3 - 2.0 * d2
    delta = torch.where(torch.abs(denom) > 1e-9, (d1 - d3) / (2.0 * denom), 0.0)
    good_delta = (delta >= -1.0) & (delta <= 1.0) & interior
    u_lvl = cur.to(dtype) + (km - SAD_SLIDE) + delta
    uR_best = (u_lvl + 0.5) * sx - 0.5
    inf = float("inf")
    ok_all = have & good_delta
    u_best = torch.where(ok_all, uR_best, -1.0)
    sad_best = torch.where(ok_all, d2, inf)
    disparity = uL0 - u_best
    in_range = (disparity >= 0.0) & (disparity < max_d)
    disparity = torch.where(disparity <= 0.0, 0.01, disparity)
    u_final = torch.where(disparity <= 0.01, uL0 - 0.01, u_best)
    ok = ok_all & in_range
    sadv = torch.where(ok, sad_best, inf)
    n_ok = torch.sum(ok, dim=-1, keepdim=True)
    sorted_sad = torch.sort(sadv, dim=-1).values
    med = torch.gather(sorted_sad, -1, torch.clamp(n_ok // 2, 0, NL - 1))
    keep = ok & (sad_best < 1.5 * 1.4 * med)
    return (torch.where(keep, u_final, -1.0), torch.where(keep, bf / disparity, -1.0), keep)


# --- the front end of the stereo facade --------------------------------------------

def _orb(orb: dict) -> dict:
    return dict(n_features=orb["n_features"], n_levels=orb["n_levels"],
                scale_factor=orb["scale_factor"], th_high=orb["ini_th_fast"],
                th_low=orb["min_th_fast"])


def stereo_batch(imgs_u8: torch.Tensor, orb: dict, bf: float, fx: float,
                 dtype=torch.float32):
    """``tracking.stereo_frontend_batch``: (2B, H, W) uint8, the B left images
    then the B right ones -> (left features (leading B), uvr (B, N), depth
    (B, N)), -1 where a keypoint has no stereo match."""
    B = imgs_u8.shape[0] // 2
    pyr = tuple(build_pyramid(imgs_u8.to(dtype), orb["n_levels"], orb["scale_factor"]))
    atlas = build_atlas(pyr)
    f2 = extract_from_atlas(atlas, **_orb(orb))
    fl = Features(*(f[:B] for f in f2))
    fr = Features(*(f[B:] for f in f2))
    u, depth, keep = match_stereo(fl, fr, tuple(p[:B] for p in pyr),
                                  atlas._replace(image=atlas.image[:B]),
                                  atlas._replace(image=atlas.image[B:]),
                                  bf, bf / fx, orb["n_levels"], orb["scale_factor"])
    return fl, u, depth


def stereo_pair(left_u8: torch.Tensor, right_u8: torch.Tensor, orb: dict, bf: float,
                fx: float, dtype=torch.float32):
    """``StereoSLAM.process``'s front end on one pair: the stacked pair's
    atlas, then the matcher on one pair's unbatched features."""
    pair = torch.stack([left_u8.to(dtype), right_u8.to(dtype)])
    pyr = tuple(build_pyramid(pair, orb["n_levels"], orb["scale_factor"]))
    atlas = build_atlas(pyr)
    both = extract_from_atlas(atlas, **_orb(orb))
    fl, fr = (Features(*(f[i] for f in both)) for i in range(2))
    u, depth, keep = match_stereo(fl, fr, tuple(p[0] for p in pyr),
                                  atlas._replace(image=atlas.image[0]),
                                  atlas._replace(image=atlas.image[1]),
                                  bf, bf / fx, orb["n_levels"], orb["scale_factor"])
    return fl, u, depth
