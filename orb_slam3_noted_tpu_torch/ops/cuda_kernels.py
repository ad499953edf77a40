"""Hand-written Hopper kernels K1-K3 of the ORB front end, their wrappers,
their plain PyTorch versions, and the build helper.

Port of :mod:`orb_slam3_noted_tpu.ops.pallas_kernels`:

========================  ==============================  =======================
wrapper                   CUDA source (``csrc/``)          plain version
========================  ==============================  =======================
:func:`fast_score`        ``fast_score.cu``                :func:`fast_score_plain`
:func:`gaussian_blur7`    ``gaussian_blur7.cu``            :func:`gaussian_blur7_plain`
:func:`brief_sample`      ``brief_sample.cu``              :func:`brief_sample_plain`
========================  ==============================  =======================

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

import torch

from orb_slam3_noted_tpu_torch.ops import fast as fast_ops
from orb_slam3_noted_tpu_torch.ops import image as image_ops

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
    for src in _sources():
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
    lib.orb_fast_score.argtypes = [p, p, i, i, i, p]
    lib.orb_gaussian_blur7.argtypes = [p, p, p, i, i, i, p]
    lib.orb_brief_sample.argtypes = [p, p, p, p, i, i, i, i, p]
    for fn in (lib.orb_fast_score, lib.orb_gaussian_blur7, lib.orb_brief_sample):
        fn.restype = ctypes.c_int
    return lib


def _on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, ndim: tuple, device=None):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() not in ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: tensors on {x.device} and {device}")


def _launch(fn, name: str, device: torch.device, *args):
    """Run a C entry on ``device``'s current stream; raise on its error code."""
    with torch.cuda.device(device):
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


# ---------------------------------------------------------------------------
# K1: FAST-9/16 score
# ---------------------------------------------------------------------------

fast_score_plain = fast_ops.fast_score


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 score map of (H, W) or (B, H, W) float32 images."""
    if not _on_card(img, "fast_score"):
        return fast_score_plain(img)
    _check(img, "fast_score", torch.float32, (2, 3))
    x = img if img.dim() == 3 else img[None]
    B, H, W = x.shape
    out = torch.empty_like(x)
    _launch(_library().orb_fast_score, "fast_score", x.device, _ptr(x), _ptr(out), B, H, W)
    fast_score.launches += 1
    return out if img.dim() == 3 else out[0]


fast_score.launches = 0


# ---------------------------------------------------------------------------
# K2: 7-tap Gaussian blur, sigma 2, reflect-101 edges
# ---------------------------------------------------------------------------

BLUR_SIGMA = 2.0


def gaussian_blur7_plain(img: torch.Tensor) -> torch.Tensor:
    return image_ops.gaussian_blur(img, 7, BLUR_SIGMA)


@functools.lru_cache(maxsize=8)
def _blur_taps(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(image_ops.gaussian_kernel1d(7, BLUR_SIGMA)).to(device)


def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """7x7 separable Gaussian blur (sigma 2) of (H, W) or (B, H, W) float32."""
    if not _on_card(img, "gaussian_blur7"):
        return gaussian_blur7_plain(img)
    _check(img, "gaussian_blur7", torch.float32, (2, 3))
    x = img if img.dim() == 3 else img[None]
    B, H, W = x.shape
    if H < 4 or W < 4:
        raise ValueError("gaussian_blur7: reflect-101 needs H, W >= 4")
    out = torch.empty_like(x)
    _launch(_library().orb_gaussian_blur7, "gaussian_blur7", x.device,
            _ptr(x), _ptr(_blur_taps(x.device)), _ptr(out), B, H, W)
    gaussian_blur7.launches += 1
    return out if img.dim() == 3 else out[0]


gaussian_blur7.launches = 0


# ---------------------------------------------------------------------------
# K3: rBRIEF sampling
# ---------------------------------------------------------------------------

def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32; bit b of word w is pair 32w + b."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64) << shifts, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def brief_sample_plain(img_blur: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """Flat gather of the 512 samples per keypoint and the packed
    comparison bits; (..., H, W) with (..., K, 512) -> (..., K, 8) int32."""
    H, W = img_blur.shape[-2:]
    flat = img_blur.reshape(*img_blur.shape[:-2], H * W)
    idx = (gy * W + gx).reshape(*gy.shape[:-2], -1).to(torch.int64)
    vals = torch.gather(flat, -1, idx).reshape(gy.shape)
    return _pack_words(vals[..., :256] < vals[..., 256:])


def brief_sample(img_blur: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """(K, 8) int32 rBRIEF words of a blurred (H, W) level from (K, 512)
    int32 sample coordinates; or (B, K, 8) from (B, H, W) and (B, K, 512)."""
    if not _on_card(img_blur, "brief_sample"):
        return brief_sample_plain(img_blur, gy, gx)
    _check(img_blur, "brief_sample", torch.float32, (2, 3))
    nd = img_blur.dim()  # coordinates carry the same batch dims
    for t, n in ((gy, "gy"), (gx, "gx")):
        _check(t, f"brief_sample {n}", torch.int32, (nd,), img_blur.device)
    if gy.shape != gx.shape or gy.shape[-1] != 512 or gy.shape[:-2] != img_blur.shape[:-2]:
        raise ValueError(
            f"brief_sample: coordinates {tuple(gy.shape)}/{tuple(gx.shape)} do not "
            f"fit image {tuple(img_blur.shape)}"
        )
    x = img_blur if nd == 3 else img_blur[None]
    cy = gy if nd == 3 else gy[None]
    cx = gx if nd == 3 else gx[None]
    B, H, W = x.shape
    K = cy.shape[1]
    out = torch.empty((B, K, 8), dtype=torch.int32, device=x.device)
    if K:
        _launch(_library().orb_brief_sample, "brief_sample", x.device,
                _ptr(x), _ptr(cy), _ptr(cx), _ptr(out), B, K, H, W)
        brief_sample.launches += 1
    return out if nd == 3 else out[0]


brief_sample.launches = 0

KERNELS = (fast_score, gaussian_blur7, brief_sample)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}

