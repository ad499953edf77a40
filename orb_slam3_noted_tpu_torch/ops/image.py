"""Image primitives: antialiased bilinear resize, Gaussian blur, pyramids.

Port of :mod:`orb_slam3_noted_tpu.ops.image`.  Images are float32
(..., H, W) tensors in [0, 255].

The JAX pyramid calls ``jax.image.resize(..., "linear")``, which
antialiases on downscale: per axis it builds a triangle-kernel weight matrix
(kernel widened by the scale) and contracts the image with both matrices.
:func:`resize_weights` rebuilds those matrices in numpy, rounding as the JAX
package's compiled CPU code does (the sample position is one fused
multiply-add, the kernel argument a multiply by the reciprocal width), and
:func:`resize_bilinear` applies them as two plain ``torch.matmul``\\ s in the
JAX order (rows first).  ``F.interpolate(antialias=True)`` differs from
JAX by about 2e-3; this form by about 5e-4 at most.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """Matches cv::getGaussianKernel for odd ksize."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with BORDER_REFLECT_101 edges, (..., H, W).

    Taps are summed in order, ``out = out + k[i] * x_i``, horizontal pass
    first, exactly as the JAX package's CPU path writes it.
    """
    k = torch.as_tensor(gaussian_kernel1d(ksize, sigma), dtype=img.dtype, device=img.device)
    r = ksize // 2
    H, W = img.shape[-2], img.shape[-1]
    # reflect-101: edge pixel not duplicated (F.pad's "reflect")
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
    """(in_size, out_size) float32 weights of JAX's antialiased linear resize."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    # (i + 0.5) * inv_scale - 0.5 rounded once, as a fused multiply-add
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
              * np.float64(inv_scale) - 0.5).astype(f32)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - dist * (f32(1.0) / kernel_scale))
    total = np.zeros((1, out_size), f32)
    for row in w:
        total = total + row
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)), f32(0.0),
    ).astype(f32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_weights(in_size, out_size)).to(device)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(img, (..., out_h, out_w), "linear")``: antialiased
    bilinear with half-pixel centres, (..., H, W) -> (..., out_h, out_w)."""
    wh = _resize_weights_on(img.shape[-2], out_h, img.device)  # (H, out_h)
    ww = _resize_weights_on(img.shape[-1], out_w, img.device)  # (W, out_w)
    return torch.matmul(torch.matmul(wh.T, img), ww)


def pyramid_sizes(h: int, w: int, n_levels: int, scale_factor: float):
    """Per-level (h, w) with OpenCV-style rounding (level-from-level)."""
    sizes = [(h, w)]
    fh, fw = float(h), float(w)
    for _ in range(1, n_levels):
        fh, fw = fh / scale_factor, fw / scale_factor
        sizes.append((int(round(fh)), int(round(fw))))
    return sizes


def build_pyramid(
    img: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2
) -> list[torch.Tensor]:
    """List of (..., Hl, Wl) float32 levels; level 0 is the input."""
    h, w = img.shape[-2], img.shape[-1]
    sizes = pyramid_sizes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        hl, wl = sizes[lvl]
        levels.append(resize_bilinear(levels[-1], hl, wl))
    return levels


class PyramidAtlas(NamedTuple):
    """The levels of one pyramid stacked into one (sum h_l, W0) image, each
    level left-aligned and zero-padded to the level-0 width.  The blur and
    rBRIEF kernels take ``sizes`` (host integers); the SAD kernel indexes
    the device tables by keypoint level."""

    image: torch.Tensor  # (..., HA, W0) float32
    off: torch.Tensor    # (n_levels,) int32 first row of each level
    h: torch.Tensor      # (n_levels,) int32
    w: torch.Tensor      # (n_levels,) int32
    sizes: tuple         # ((h_l, w_l), ...) as Python ints


def level_offsets(sizes: tuple) -> list[int]:
    """First atlas row of each level."""
    return [int(o) for o in np.concatenate([[0], np.cumsum([h for h, _ in sizes])])[:len(sizes)]]


@functools.lru_cache(maxsize=32)
def level_tables(sizes: tuple, device: torch.device):
    """(off, h, w) int32 tensors of an atlas with these level sizes, made
    once per (sizes, device): no frame pays a host-to-device copy for them."""
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return i32(level_offsets(sizes)), i32([h for h, _ in sizes]), i32([w for _, w in sizes])


def level_views(image: torch.Tensor, sizes: tuple) -> list[torch.Tensor]:
    """Each level's (..., h_l, w_l) window of an (..., HA, W0) atlas image."""
    return [image[..., o:o + h, :w] for o, (h, w) in zip(level_offsets(sizes), sizes)]


def build_atlas(pyr: tuple) -> PyramidAtlas:
    W0 = pyr[0].shape[-1]
    sizes = tuple((int(p.shape[-2]), int(p.shape[-1])) for p in pyr)
    image = torch.cat([F.pad(p, (0, W0 - w)) for p, (_, w) in zip(pyr, sizes)], dim=-2).contiguous()
    return PyramidAtlas(image, *level_tables(sizes, image.device), sizes)


def stack_atlases(atlases: list) -> PyramidAtlas:
    """Atlases of equal level sizes as one with a leading batch dimension."""
    first = atlases[0]
    if any(a.sizes != first.sizes for a in atlases):
        raise ValueError("stack_atlases: level sizes differ")
    return first._replace(image=torch.stack([a.image for a in atlases]))


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) in [0, 255] to (H, W), with the BT.601 weights that
    ``cv::cvtColor`` uses."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return img @ w
