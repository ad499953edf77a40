"""Hand-written Hopper kernels K1-K3 of the ORB front end and K4 of the
stereo matcher, their wrappers, their plain PyTorch versions, and the build
helper.

Port of :mod:`orb_slam3_noted_tpu.ops.pallas_kernels`:

========================  ==============================  ===============================
wrapper                   CUDA source (``csrc/``)          plain version
========================  ==============================  ===============================
:func:`fast_candidates`   ``fast_score.cu``                :func:`fast_candidates_plain`
:func:`fast_score`        ``fast_score.cu``                :func:`fast_score_plain`
:func:`gaussian_blur7`    ``gaussian_blur7.cu``            :func:`gaussian_blur7_plain`
:func:`brief_sample`      ``brief_sample.cu``              :func:`brief_sample_plain`
:func:`sad_stereo`        ``sad_stereo.cu``                :func:`sad_stereo_plain`
========================  ==============================  ===============================

K1 to K3 work on a pyramid atlas (:class:`..image.PyramidAtlas`: the levels
of one pyramid stacked along the rows of one image) and take its level
sizes as host integers, so one launch serves every level of every image of
a batch; a single image is the one-level atlas.  K1 on the extraction path
is :func:`fast_candidates` (atlas in, per-cell corner candidates out);
:func:`fast_score`, the dense score map of one image, is its single-level
form over the same scoring function.  :func:`launch_floor` launches an empty
kernel: the least a launch lasts on the card.

Dispatch is by the tensor's device: a CPU tensor goes to the plain version,
a CUDA tensor launches the kernel, or raises if the build or the launch
fails.  There is no fallback from the card to the plain version.  Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, on first use, under ``build/torch_kernels``
at the repository root (named by a hash of the sources, so an edit rebuilds),
and loaded with ``ctypes``.  Nothing is built or imported when this module
is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.ops import fast as fast_ops
from orb_slam3_noted_tpu_torch.ops import image as image_ops
from orb_slam3_noted_tpu_torch.ops.orb_pattern import BIT_PATTERN_31

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME/bin/nvcc or PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the header they share
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liborb_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    Returns (path, compiler log); the log holds ``ptxas -v``'s registers and
    shared memory per kernel, empty when nothing was compiled.
    """
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
    return so, res.stdout + res.stderr


@functools.cache
def _library() -> ctypes.CDLL:
    so, _ = build_library()
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    f = ctypes.c_float
    lib.orb_launch_floor.argtypes = [p]
    lib.orb_fast_score.argtypes = [p, p, i, i, i, p]
    lib.orb_fast_candidates.argtypes = [p, p, p, i, i, i, i, p, p, i, i, f, f, i, p]
    lib.orb_gaussian_blur7.argtypes = [p, p, p, i, i, i, i, p, p]
    lib.orb_brief_set_pattern.argtypes = [p]
    lib.orb_brief_sample.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p]
    lib.orb_sad_stereo.argtypes = [p] * 10 + [i] * 5 + [p]
    for fn in (lib.orb_launch_floor, lib.orb_fast_score, lib.orb_fast_candidates,
               lib.orb_gaussian_blur7, lib.orb_brief_set_pattern, lib.orb_brief_sample,
               lib.orb_sad_stereo):
        fn.restype = ctypes.c_int
    return lib


def _on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    kind = x.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, lo: int, hi: int, device=None):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``lo`` to
    ``hi`` dimensions (on ``device``, where one is given)."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if not lo <= x.dim() <= hi:
        raise ValueError(f"{name}: expected {lo}-{hi} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: tensors on {x.device} and {device}")


def _launch(fn, name: str, device: torch.device, *args):
    """Run a C entry on ``device``'s current stream; raise on its error code.
    Pointers and the stream go in as plain integers (the entries' argtypes
    convert them)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


MAX_LEVELS = 16  # kMaxLevels of csrc/atlas_levels.cuh


@functools.lru_cache(maxsize=64)
def _level_sizes(sizes: tuple, H: int, W: int, min_side: int):
    """The ``(h_l, w_l)`` pairs of an atlas as the C array the entries read,
    checked once per (sizes, atlas shape): the levels fill the ``H`` rows
    and fit the ``W`` columns."""
    if not 1 <= len(sizes) <= MAX_LEVELS:
        raise ValueError(f"atlas: {len(sizes)} levels, supported 1 to {MAX_LEVELS}")
    if sum(h for h, _ in sizes) != H or any(w > W for _, w in sizes):
        raise ValueError(f"atlas: levels {sizes} do not fit an image of {H} x {W}")
    if any(min(h, w) < min_side for h, w in sizes):
        raise ValueError(f"atlas: every level needs h, w >= {min_side}, got {sizes}")
    return (ctypes.c_int * (2 * len(sizes)))(*(int(v) for hw in sizes for v in hw))


# ---------------------------------------------------------------------------
# the least a launch lasts
# ---------------------------------------------------------------------------

def launch_floor(device: torch.device) -> None:
    """Launch the empty kernel (one block, one thread) on ``device``."""
    _launch(_library().orb_launch_floor, "launch_floor", torch.device(device))


# ---------------------------------------------------------------------------
# K1: FAST-9/16 corner candidates over an atlas; the dense score of one image
# ---------------------------------------------------------------------------

fast_score_plain = fast_ops.fast_score
CELL = 32  # kCell of csrc/fast_score.cu: side of a selection cell


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 score map of (H, W) or (B, H, W) float32 images."""
    if not _on_card(img, "fast_score"):
        return fast_score_plain(img)
    _check(img, "fast_score", torch.float32, 2, 3)
    x = img if img.dim() == 3 else img[None]
    B, H, W = x.shape
    out = torch.empty_like(x)
    _launch(_library().orb_fast_score, "fast_score", x.device,
            x.data_ptr(), out.data_ptr(), B, H, W)
    fast_score.launches += 1
    return out if img.dim() == 3 else out[0]


fast_score.launches = 0


class CandidateLayout(NamedTuple):
    """Where each level's cells lie in the (NC, KC) candidate arrays of
    :func:`fast_candidates`: level l owns cells ``first[l]:first[l + 1]``, a
    grid with ``per_row[l]`` columns, and the slots ``:k[l]`` of each.  A
    level with budget 0 has k = 0 and no cells."""

    first: tuple
    per_row: tuple
    k: tuple
    n_cells: int
    k_max: int


@functools.lru_cache(maxsize=64)
def candidate_layout(sizes: tuple, budgets: tuple) -> CandidateLayout:
    """The layout for levels of these ``sizes`` ((h_l, w_l), ...) and
    per-level corner ``budgets`` (the ``n_out`` of ``fast.detect_level``)."""
    if len(budgets) != len(sizes):
        raise ValueError(f"fast_candidates: {len(budgets)} budgets for {len(sizes)} levels")
    first, per_row, k = [0], [], []
    for (h, w), n_out in zip(sizes, budgets):
        ncy, ncx = fast_ops.cell_grid(h, w, CELL)
        live = n_out > 0
        per_row.append(ncx)
        k.append(fast_ops.candidates_per_cell(n_out, ncy * ncx, CELL) if live else 0)
        first.append(first[-1] + (ncy * ncx if live else 0))
    return CandidateLayout(tuple(first), tuple(per_row), tuple(k), first[-1], max(k))


def fast_candidates_plain(atlas, sizes, budgets, th_high=20.0, th_low=7.0, border=16):
    """Level by level: :func:`fast_score_plain` on the level's window of the
    atlas, then :func:`..fast.cell_candidates`; the levels' cells side by
    side, slots from a level's k on filled with ``NEG`` and index 0."""
    lay = candidate_layout(sizes, tuple(budgets))
    batch = atlas.shape[:-2]
    cand_s = torch.full((*batch, lay.n_cells, lay.k_max), fast_ops.NEG, dtype=torch.float32,
                        device=atlas.device)
    cand_i = torch.zeros((*batch, lay.n_cells, lay.k_max), dtype=torch.int32, device=atlas.device)
    for l, (view, n_out) in enumerate(zip(image_ops.level_views(atlas, sizes), budgets)):
        if lay.k[l] == 0:
            continue
        s, i = fast_ops.cell_candidates(fast_score_plain(view), n_out, CELL, th_high, th_low, border)
        cand_s[..., lay.first[l]:lay.first[l + 1], :lay.k[l]] = s
        cand_i[..., lay.first[l]:lay.first[l + 1], :lay.k[l]] = i
    return cand_s, cand_i


def fast_candidates(atlas, sizes, budgets, th_high=20.0, th_low=7.0, border=16):
    """Corner candidates of every 32 x 32 cell of every level of an (HA, W0)
    or (B, HA, W0) float32 pyramid atlas with level ``sizes``, in one launch:
    (cand_s, cand_i), both (..., NC, KC) as :func:`candidate_layout` lays them
    out for the per-level corner ``budgets``: float32 scores, best first,
    equal scores lowest index first (``NEG`` = -1e30 in empty slots), and
    int32 in-cell indices ``cy * 32 + cx``.  What
    :func:`..fast.cell_candidates` gives for each level's FAST score map."""
    if not _on_card(atlas, "fast_candidates"):
        return fast_candidates_plain(atlas, sizes, budgets, th_high, th_low, border)
    _check(atlas, "fast_candidates", torch.float32, 2, 3)
    if border < 4:  # ring radius 3 + the peak test's 1: no ring may leave its level
        raise ValueError(f"fast_candidates: border {border} < 4")
    B = atlas.shape[0] if atlas.dim() == 3 else 1
    HA, W = atlas.shape[-2:]
    hw = _level_sizes(sizes, HA, W, 2 * border + 1)
    lay = candidate_layout(sizes, tuple(budgets))
    shape = (*atlas.shape[:-2], lay.n_cells, lay.k_max)
    cand_s = torch.empty(shape, dtype=torch.float32, device=atlas.device)
    cand_i = torch.empty(shape, dtype=torch.int32, device=atlas.device)
    if B and lay.n_cells:
        _launch(_library().orb_fast_candidates, "fast_candidates", atlas.device,
                atlas.data_ptr(), cand_s.data_ptr(), cand_i.data_ptr(), B, HA, W,
                len(sizes), hw, (ctypes.c_int * len(lay.k))(*lay.k), lay.n_cells, lay.k_max,
                float(th_high), float(th_low), int(border))
        fast_candidates.launches += 1
    return cand_s, cand_i


fast_candidates.launches = 0


# ---------------------------------------------------------------------------
# K2: 7-tap Gaussian blur, sigma 2, reflect-101 edges, over an atlas
# ---------------------------------------------------------------------------

BLUR_SIGMA = 2.0


def gaussian_blur7_plain(img: torch.Tensor, sizes: tuple | None = None) -> torch.Tensor:
    """:func:`..image.gaussian_blur` of the image, or of each level's window
    of an atlas with these level ``sizes`` (zero outside the windows)."""
    if sizes is None:
        return image_ops.gaussian_blur(img, 7, BLUR_SIGMA)
    out = torch.zeros_like(img)
    for src, dst in zip(image_ops.level_views(img, sizes), image_ops.level_views(out, sizes)):
        dst.copy_(image_ops.gaussian_blur(src, 7, BLUR_SIGMA))
    return out


@functools.lru_cache(maxsize=8)
def _blur_taps(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(image_ops.gaussian_kernel1d(7, BLUR_SIGMA)).to(device)


def gaussian_blur7(img: torch.Tensor, sizes: tuple | None = None) -> torch.Tensor:
    """7x7 separable Gaussian blur (sigma 2) of (H, W) or (B, H, W) float32.

    With ``sizes = ((h_0, w_0), ...)`` the image is a pyramid atlas and each
    level is blurred inside its own window, reflecting at the window's
    edges; on the card the columns right of a level's ``w_l`` are left
    unwritten (the plain version zeroes them)."""
    if not _on_card(img, "gaussian_blur7"):
        return gaussian_blur7_plain(img, sizes)
    _check(img, "gaussian_blur7", torch.float32, 2, 3)
    x = img if img.dim() == 3 else img[None]
    B, H, W = x.shape
    # reflect-101 over 3 px needs 4
    hw = _level_sizes(((H, W),) if sizes is None else sizes, H, W, 4)
    out = torch.empty_like(x)
    if B:
        _launch(_library().orb_gaussian_blur7, "gaussian_blur7", x.device,
                x.data_ptr(), _blur_taps(x.device).data_ptr(), out.data_ptr(),
                B, H, W, len(hw) // 2, hw)
        gaussian_blur7.launches += 1
    return out if img.dim() == 3 else out[0]


gaussian_blur7.launches = 0


# ---------------------------------------------------------------------------
# K3: rBRIEF over an atlas, pattern rotation inside the sampler
# ---------------------------------------------------------------------------

# Pattern points as float (x, y): the 256 first points, then the 256 second.
PATTERN_XY = np.ascontiguousarray(
    np.concatenate([BIT_PATTERN_31[:, 0:2], BIT_PATTERN_31[:, 2:4]], 0).astype(np.float32)
)  # (512, 2)


@functools.lru_cache(maxsize=8)
def _pattern_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(PATTERN_XY).to(device)


@functools.lru_cache(maxsize=8)
def _upload_pattern(index: int) -> bool:
    """Fill device ``index``'s ``__constant__`` pattern table, once."""
    with torch.cuda.device(index):
        err = _library().orb_brief_set_pattern(PATTERN_XY.ctypes.data)
    if err != 0:
        raise RuntimeError(f"brief_sample: pattern upload failed with cudaError {err}")
    return True


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32; bit b of word w is pair 32w + b."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64) << shifts, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def rotated_pattern(angle: torch.Tensor):
    """(rx, ry) int32 (..., K, 512): the pattern rotated by each keypoint's
    angle and rounded half to even (``orb.py`` of the JAX package, ahead of
    its sampler)."""
    a = torch.cos(angle)[..., None]
    b = torch.sin(angle)[..., None]
    pall = _pattern_on(angle.device)
    px, py = pall[:, 0], pall[:, 1]
    rx = torch.round(px * a - py * b).to(torch.int32)
    ry = torch.round(px * b + py * a).to(torch.int32)
    return rx, ry


def brief_coords(h: int, w: int, xy: torch.Tensor, angle: torch.Tensor):
    """(gy, gx) int32 (..., K, 512): the rotated pattern offset to each
    keypoint ``xy`` (..., K, 2) and clipped to the (h, w) level."""
    rx, ry = rotated_pattern(angle)
    gx = torch.clamp(xy[..., 0:1].to(torch.int32) + rx, 0, w - 1)
    gy = torch.clamp(xy[..., 1:2].to(torch.int32) + ry, 0, h - 1)
    return gy.contiguous(), gx.contiguous()


def brief_sample_plain(img_blur: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """Flat gather of the 512 samples per keypoint and the packed
    comparison bits; (..., H, W) with (..., K, 512) -> (..., K, 8) int32."""
    H, W = img_blur.shape[-2:]
    flat = img_blur.reshape(*img_blur.shape[:-2], H * W)
    idx = (gy * W + gx).reshape(*gy.shape[:-2], -1).to(torch.int64)
    vals = torch.gather(flat, -1, idx).reshape(gy.shape)
    return _pack_words(vals[..., :256] < vals[..., 256:])


def brief_sample_atlas_plain(atlas_blur, sizes, xy, angle, level) -> torch.Tensor:
    """:func:`brief_coords` of every keypoint at its own level's (h, w),
    then :func:`brief_sample_plain`'s gather on that level's window of the
    atlas; (..., HA, W0) with (..., N, 2), (..., N), (..., N) -> (..., N, 8)."""
    off_t, h_t, w_t = image_ops.level_tables(sizes, atlas_blur.device)
    lv = torch.clamp(level.long(), 0, len(sizes) - 1)
    rx, ry = rotated_pattern(angle)
    zero = torch.zeros((), dtype=torch.int32, device=atlas_blur.device)
    gx = torch.clamp(xy[..., 0:1] + rx, zero, w_t[lv][..., None] - 1)
    gy = torch.clamp(xy[..., 1:2] + ry, zero, h_t[lv][..., None] - 1) + off_t[lv][..., None]
    return brief_sample_plain(atlas_blur, gy, gx)


def brief_sample(atlas_blur, sizes, xy, angle, level) -> torch.Tensor:
    """(N, 8) int32 rBRIEF words of N keypoints on a blurred (HA, W0) pyramid
    atlas with level ``sizes``: ``xy`` (N, 2) int32 coordinates at the
    keypoint's own level, ``angle`` (N,) float32 radians, ``level`` (N,)
    int32; or (B, N, 8) from (B, HA, W0), (B, N, 2), (B, N), (B, N).  The
    pattern is rotated by the angle, rounded, offset and clipped to the
    level inside the kernel."""
    if not _on_card(atlas_blur, "brief_sample"):
        return brief_sample_atlas_plain(atlas_blur, sizes, xy, angle, level)
    _check(atlas_blur, "brief_sample", torch.float32, 2, 3)
    nd = atlas_blur.dim()  # keypoints carry the same batch dims
    dev = atlas_blur.device
    _check(xy, "brief_sample xy", torch.int32, nd, nd, dev)
    _check(angle, "brief_sample angle", torch.float32, nd - 1, nd - 1, dev)
    _check(level, "brief_sample level", torch.int32, nd - 1, nd - 1, dev)
    if (xy.shape[-1] != 2 or xy.shape[:-1] != angle.shape or level.shape != angle.shape
            or angle.shape[:-1] != atlas_blur.shape[:-2]):
        raise ValueError(
            f"brief_sample: keypoints {tuple(xy.shape)}/{tuple(angle.shape)}/"
            f"{tuple(level.shape)} do not fit atlas {tuple(atlas_blur.shape)}"
        )
    B = atlas_blur.shape[0] if nd == 3 else 1
    HA, W = atlas_blur.shape[-2:]
    N = angle.shape[-1]
    hw = _level_sizes(sizes, HA, W, 1)
    out = torch.empty((*angle.shape, 8), dtype=torch.int32, device=dev)
    if N and B:
        _upload_pattern(dev.index)
        _launch(_library().orb_brief_sample, "brief_sample", dev,
                atlas_blur.data_ptr(), xy.data_ptr(), angle.data_ptr(), level.data_ptr(),
                out.data_ptr(), B, N, HA, W, len(hw) // 2, hw)
        brief_sample.launches += 1
    return out


brief_sample.launches = 0


# ---------------------------------------------------------------------------
# K4: stereo SAD over level-stacked pyramid atlases
# ---------------------------------------------------------------------------

SAD_HALF = 5    # half SAD window (11x11)
SAD_SLIDE = 5   # max slide (+-5 px)
SAD_SHIFTS = 2 * SAD_SLIDE + 1


def sad_stereo_plain(atlas_l, atlas_r, cv, cu, cur, lvl, off_t, h_t, w_t) -> torch.Tensor:
    """The gather form: 11x11 left patches and 11x21 right strips at each
    keypoint's level, rows and columns clamped to that level with the
    unclamped centres, then the 11 shifted sums.  Atlases (..., HA, W),
    centres and levels (..., K) -> (..., K, 11) float32."""
    dev = atlas_l.device
    lv = lvl.long()
    h = h_t.long()[lv][..., None]
    w = w_t.long()[lv][..., None]
    off = off_t.long()[lv][..., None]
    d = torch.arange(-SAD_HALF, SAD_HALF + 1, device=dev)
    dr = torch.arange(-(SAD_HALF + SAD_SLIDE), SAD_HALF + SAD_SLIDE + 1, device=dev)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    yy = torch.clamp(cv.long()[..., None] + d, zero, h - 1) + off     # (..., K, 11)
    xxl = torch.clamp(cu.long()[..., None] + d, zero, w - 1)
    xxr = torch.clamp(cur.long()[..., None] + dr, zero, w - 1)         # (..., K, 21)
    W = atlas_l.shape[-1]

    def gather(atlas, xx):
        flat = atlas.reshape(*atlas.shape[:-2], -1)
        idx = yy[..., :, None] * W + xx[..., None, :]                  # (..., K, 11, n)
        return torch.gather(flat, -1, idx.reshape(*idx.shape[:-3], -1)).reshape(idx.shape)

    patch = gather(atlas_l, xxl)
    strip = gather(atlas_r, xxr)
    n = 2 * SAD_HALF + 1
    return torch.stack(
        [torch.sum(torch.abs(patch - strip[..., s:s + n]), dim=(-2, -1))
         for s in range(SAD_SHIFTS)], dim=-1,
    )


def sad_stereo(atlas_l, atlas_r, cv, cu, cur, lvl, off_t, h_t, w_t) -> torch.Tensor:
    """(K, 11) float32 SADs of K left keypoints against the 11 shifts of
    their right strips, from (HA, W) float32 atlases, (K,) int32 centres
    ``cv, cu, cur`` and levels, and the (n_levels,) int32 level tables
    (first atlas row, height, width); or (B, K, 11) from (B, HA, W) and
    (B, K)."""
    if not _on_card(atlas_l, "sad_stereo"):
        return sad_stereo_plain(atlas_l, atlas_r, cv, cu, cur, lvl, off_t, h_t, w_t)
    _check(atlas_l, "sad_stereo atlas_l", torch.float32, 2, 3)
    nd = atlas_l.dim()
    dev = atlas_l.device
    _check(atlas_r, "sad_stereo atlas_r", torch.float32, nd, nd, dev)
    if atlas_r.shape != atlas_l.shape:
        raise ValueError(f"sad_stereo: atlases {tuple(atlas_l.shape)} and {tuple(atlas_r.shape)}")
    for t, n in ((cv, "cv"), (cu, "cu"), (cur, "cur"), (lvl, "lvl")):
        _check(t, f"sad_stereo {n}", torch.int32, nd - 1, nd - 1, dev)
        if t.shape != cv.shape or t.shape[:-1] != atlas_l.shape[:-2]:
            raise ValueError(f"sad_stereo {n}: shape {tuple(t.shape)} does not fit")
    for t, n in ((off_t, "off_t"), (h_t, "h_t"), (w_t, "w_t")):
        _check(t, f"sad_stereo {n}", torch.int32, 1, 1, dev)
        if t.shape != off_t.shape:
            raise ValueError(f"sad_stereo {n}: {tuple(t.shape)} levels, expected {tuple(off_t.shape)}")
    B = atlas_l.shape[0] if nd == 3 else 1
    HA, W = atlas_l.shape[-2:]
    K = cv.shape[-1]
    out = torch.empty((*cv.shape, SAD_SHIFTS), dtype=torch.float32, device=dev)
    if K and B and off_t.shape[0]:
        _launch(_library().orb_sad_stereo, "sad_stereo", dev,
                atlas_l.data_ptr(), atlas_r.data_ptr(), cv.data_ptr(), cu.data_ptr(),
                cur.data_ptr(), lvl.data_ptr(), off_t.data_ptr(), h_t.data_ptr(),
                w_t.data_ptr(), out.data_ptr(), B, K, HA, W, off_t.shape[0])
        sad_stereo.launches += 1
    return out


sad_stereo.launches = 0

# K1 to K4 as the frame path launches them, then K1's single-level form
KERNELS = (fast_candidates, gaussian_blur7, brief_sample, sad_stereo, fast_score)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}

