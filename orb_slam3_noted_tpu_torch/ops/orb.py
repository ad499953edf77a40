"""ORB extraction: IC-angle orientation, rBRIEF descriptors, full pyramid.

Port of :mod:`orb_slam3_noted_tpu.ops.orb`.  Per level: the FAST score map
(kernel K1), corner selection (:mod:`.fast`), intensity-centroid angles
from row prefix sums, the 7-tap blur (kernel K2), and rBRIEF sampling
(kernel K3) at pattern coordinates rotated in PyTorch, exactly as the JAX
package rotates them before its Pallas sampler.

Every function takes an optional leading batch dimension; a (B, H, W) image
batch gives FrameFeatures with a leading B, as the JAX package's ``vmap``
does.  Descriptors are (N, 8) int32 holding the JAX package's uint32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
from orb_slam3_noted_tpu_torch.ops import fast as fast_ops
from orb_slam3_noted_tpu_torch.ops import image as image_ops
from orb_slam3_noted_tpu_torch.ops.orb_pattern import BIT_PATTERN_31
from orb_slam3_noted_tpu_torch.utils import interop

HALF_PATCH = 15


def _umax_table() -> np.ndarray:
    """OpenCV's quarter-circle span table for the IC-angle patch (symmetrised
    Bresenham circle of radius 15)."""
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


def ic_angle_maps(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense intensity moments (m10, m01) of (..., H, W) via row prefix sums.

    Per row, ``B_w(x) = sum_{|dx|<=w} I(x+dx)`` and
    ``T_w(x) = sum_{|dx|<=w} dx * I(x+dx)`` follow from two x-cumsums, and
    ``m01 = sum_dy dy*B_u(y+dy)``, ``m10 = sum_dy T_u(y+dy)`` are 61 shifted
    adds.  The image is centred (-128) so the prefix sums stay small.
    """
    H, W = img.shape[-2], img.shape[-1]
    P = HALF_PATCH + 1
    umax = _umax_table()
    p = F.pad(img - 128.0, (P, P, P, P))
    C1 = torch.cumsum(p, dim=-1)
    C2 = torch.cumsum(C1, dim=-1)

    def shx(A, k):  # out(y, x) = A(y, x+k); full padded height, x in [0, W)
        return A[..., :, P + k: P + k + W]

    Bw, Tw = {}, {}
    for w in sorted({int(v) for v in umax}):
        c1p, c1m = shx(C1, w), shx(C1, -w - 1)
        Bw[w] = c1p - c1m
        Tw[w] = w * (c1p + c1m) - shx(C2, w - 1) + shx(C2, -w - 1)

    m10 = torch.zeros(img.shape, dtype=img.dtype, device=img.device)
    m01 = torch.zeros_like(m10)
    for dy in range(-HALF_PATCH, HALF_PATCH + 1):
        w = int(umax[abs(dy)])
        m10 = m10 + Tw[w][..., P + dy: P + dy + H, :]
        if dy:
            m01 = m01 + dy * Bw[w][..., P + dy: P + dy + H, :]
    return m10, m01


def _at(maps: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample (..., H, W) maps at integer-valued (..., K, 2) level coords."""
    W = maps.shape[-1]
    idx = xy[..., 1].to(torch.int64) * W + xy[..., 0].to(torch.int64)
    return torch.gather(maps.flatten(-2), -1, idx)


def ic_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Orientation (radians) for keypoints xy (..., K, 2) at this level."""
    m10, m01 = ic_angle_maps(img)
    return torch.atan2(_at(m01, xy), _at(m10, xy))


# Pattern points as float (x, y): the 256 first points, then the 256 second.
_PALL = np.concatenate(
    [BIT_PATTERN_31[:, 0:2], BIT_PATTERN_31[:, 2:4]], 0
).astype(np.float32)  # (512, 2)


def brief_coords(h: int, w: int, xy: torch.Tensor, angle: torch.Tensor):
    """(gy, gx) int32 (..., K, 512): the pattern rotated by each keypoint's
    angle, rounded, offset to the keypoint and clipped to the (h, w) level
    (``orb.py`` of the JAX package, ahead of its sampler)."""
    a = torch.cos(angle)[..., None]
    b = torch.sin(angle)[..., None]
    pall = torch.from_numpy(_PALL).to(xy.device)
    px, py = pall[:, 0], pall[:, 1]
    rx = torch.round(px * a - py * b).to(torch.int32)
    ry = torch.round(px * b + py * a).to(torch.int32)
    gx = torch.clamp(xy[..., 0:1].to(torch.int32) + rx, 0, w - 1)
    gy = torch.clamp(xy[..., 1:2].to(torch.int32) + ry, 0, h - 1)
    return gy.contiguous(), gx.contiguous()


def brief_descriptors(img_blur: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF: (..., K, 8) int32 descriptors of keypoints xy (..., K, 2)
    with angles (..., K) on the blurred level (..., H, W)."""
    gy, gx = brief_coords(img_blur.shape[-2], img_blur.shape[-1], xy, angle)
    return ck.brief_sample(img_blur, gy, gx)


class FrameFeatures(NamedTuple):
    """Fixed-size multi-level feature set for one image, at level-0 coords."""

    xy: torch.Tensor        # (N, 2) float32
    level: torch.Tensor     # (N,) int32 pyramid octave
    angle: torch.Tensor     # (N,) float32 radians
    response: torch.Tensor  # (N,) float32 FAST score
    desc: torch.Tensor      # (N, 8) int32 packed rBRIEF (uint32 bits)
    valid: torch.Tensor     # (N,) bool


def to_numpy(f: FrameFeatures) -> dict:
    """FrameFeatures -> {field: ndarray}, descriptors as uint32."""
    return interop.to_numpy(f, uint32_fields=("desc",))


def from_numpy(d: dict, device=None) -> FrameFeatures:
    """{field: array} (e.g. ``jax.device_get(f)._asdict()``) -> FrameFeatures."""
    return interop.from_numpy(FrameFeatures, d, device)


def scale_factors(n_levels: int = 8, scale_factor: float = 1.2) -> np.ndarray:
    return scale_factor ** np.arange(n_levels, dtype=np.float64)


def level_sigma2(n_levels: int = 8, scale_factor: float = 1.2) -> np.ndarray:
    """Per-level variance weights (reference ``mvLevelSigma2``)."""
    return (scale_factors(n_levels, scale_factor) ** 2).astype(np.float32)


def extract_orb(
    img: torch.Tensor,
    n_features: int = 1200,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: float = 20.0,
    th_low: float = 7.0,
) -> FrameFeatures:
    """Full ORB pipeline for one grayscale image (H, W) float32 [0, 255]
    (or a (B, H, W) batch)."""
    levels = image_ops.build_pyramid(img, n_levels, scale_factor)
    return extract_from_pyramid(
        tuple(levels), n_features=n_features, n_levels=n_levels,
        scale_factor=scale_factor, th_high=th_high, th_low=th_low,
    )


def extract_from_pyramid(
    levels: tuple,
    n_features: int = 1200,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: float = 20.0,
    th_low: float = 7.0,
) -> FrameFeatures:
    """ORB extraction from a prebuilt pyramid of (..., Hl, Wl) levels."""
    img = levels[0]
    batch = img.shape[:-2]
    budgets = fast_ops.level_budgets(n_features, n_levels, scale_factor)
    h0, w0 = img.shape[-2], img.shape[-1]

    outs = []
    for lvl, (level_img, budget) in enumerate(zip(levels, budgets)):
        if budget <= 0:
            continue
        level_img = level_img.contiguous()
        score = ck.fast_score(level_img)
        kps = fast_ops.detect_level(
            score, n_out=budget, th_high=th_high, th_low=th_low, border=16
        )
        ang = ic_angles(level_img, kps.xy)
        blur = ck.gaussian_blur7(level_img)
        desc = brief_descriptors(blur, kps.xy, ang)
        # exact level->0 mapping with half-pixel centres and the actual
        # per-axis ratio of the rounded level sizes
        hl, wl = level_img.shape[-2], level_img.shape[-1]
        ax = torch.tensor([w0 / wl, h0 / hl], dtype=img.dtype, device=img.device)
        outs.append(
            FrameFeatures(
                xy=(kps.xy + 0.5) * ax - 0.5,
                level=torch.full((*batch, budget), lvl, dtype=torch.int32, device=img.device),
                angle=ang,
                response=kps.score,
                desc=desc,
                valid=kps.valid,
            )
        )
    n = len(batch)  # features concatenate along the axis after the batch
    return FrameFeatures(*(torch.cat(parts, dim=n) for parts in zip(*outs)))


def extract_orb_batch(
    imgs: torch.Tensor,
    n_features: int = 1200,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: float = 20.0,
    th_low: float = 7.0,
) -> FrameFeatures:
    """ORB extraction for a (B, H, W) image batch: every kernel runs once per
    level over the whole batch.  Fields carry a leading B."""
    if imgs.dim() != 3:
        raise ValueError(f"extract_orb_batch: expected (B, H, W), got {tuple(imgs.shape)}")
    return extract_orb(
        imgs, n_features=n_features, n_levels=n_levels,
        scale_factor=scale_factor, th_high=th_high, th_low=th_low,
    )
