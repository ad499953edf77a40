"""ORB extraction: IC-angle orientation, rBRIEF descriptors, full pyramid.

Port of :mod:`orb_slam3_noted_tpu.ops.orb`, in two steps over the pyramid
atlas (:class:`..image.PyramidAtlas`), each once for all levels (and for
both images of a stereo pair).  Detection (:func:`detect_from_atlas`):
per-cell FAST corner candidates (kernel K1), the per-level selection of
:mod:`.fast`, and intensity-centroid angles from row prefix sums, read at
the keypoints only (:func:`ic_angles_atlas`).  Description
(:func:`describe`): the 7-tap blur of the atlas (kernel K2) and rBRIEF
sampling of every keypoint on it (kernel K3), which rotates the pattern by
the keypoint's angle as the JAX package does ahead of its Pallas sampler.
:func:`detect_from_pyramid`, :func:`ic_angle_maps` and :func:`ic_angles` are
the level-by-level forms of the JAX package, which the atlas forms equal
bit for bit on the CPU.

Every function takes an optional leading batch dimension; a (B, H, W) image
batch gives FrameFeatures with a leading B, as the JAX package's ``vmap``
does.  Descriptors are (N, 8) int32 holding the JAX package's uint32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
from orb_slam3_noted_tpu_torch.ops import fast as fast_ops
from orb_slam3_noted_tpu_torch.ops import image as image_ops
from orb_slam3_noted_tpu_torch.utils import interop
from orb_slam3_noted_tpu_torch.utils.timing import span

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


@functools.lru_cache(maxsize=8)
def _angle_tables(sizes: tuple, W0: int, device: torch.device):
    """Constants of :func:`ic_angles_atlas` for an atlas of these level
    ``sizes`` and width: the (HA, W0) mask of the levels' own pixels, and per
    patch row dy = -15..15 the row offset (31,) int64, the half span
    ``umax[|dy|]`` as int64 and as float32, and dy as float32."""
    inside = torch.cat([(torch.arange(W0) < w).expand(h, W0) for h, w in sizes])
    dy = torch.arange(-HALF_PATCH, HALF_PATCH + 1)
    span = torch.from_numpy(_umax_table())[dy.abs()]
    return tuple(t.to(device) for t in (inside, dy, span, span.to(torch.float32),
                                        dy.to(torch.float32)))


def ic_angles_atlas(atlas: image_ops.PyramidAtlas, xy: torch.Tensor, level: torch.Tensor,
                    runs: tuple) -> torch.Tensor:
    """Orientation (radians) of keypoints ``xy`` (..., N, 2), integer-valued
    coordinates at their own ``level`` (..., N), on a (..., HA, W0) atlas.
    ``runs``: lengths that add up to N, a level's keypoints each; the
    arctangent is taken run by run and image by image, because the CPU's
    vectorised ``atan2`` rounds an element by its place in the call.

    The arithmetic of :func:`ic_angle_maps`, evaluated only where it is
    read: the two prefix sums run once over the whole centred atlas (zero
    outside every level's width, 16 zero columns on each side), the four
    prefix values per patch row are gathered at the keypoints, and the 31
    rows are added one at a time in the map's order, rows outside the level
    adding zero.  On the CPU this is ``ic_angles`` of each level bit for bit.
    """
    P = HALF_PATCH + 1
    img = atlas.image
    W0 = img.shape[-1]
    WP = W0 + 2 * P
    inside, dy, span, span_f, dy_f = _angle_tables(atlas.sizes, W0, img.device)
    C1 = torch.cumsum(F.pad(torch.where(inside, img - 128.0, 0.0), (P, P)), dim=-1)
    C2 = torch.cumsum(C1, dim=-1)

    lv = level.long()
    h, w, off = atlas.h.long()[lv], atlas.w.long()[lv], atlas.off.long()[lv]
    # a slot's position as the level's flat index gives it (``_at``): a
    # column past the level's width, which only an empty slot has, wraps
    flat = torch.clamp(xy[..., 1].long() * w + xy[..., 0].long(), max=h * w - 1)
    y, x = flat // w, flat % w
    rows = y[..., None] + dy                                    # (..., N, 31)
    in_level = (rows >= 0) & (rows < h[..., None])
    base = (off[..., None] + torch.clamp(rows, min=0)).clamp(max=img.shape[-2] - 1) * WP \
        + (x[..., None] + P)

    def at(C, k):  # C(row, x + k) for every keypoint and patch row
        return torch.gather(C.flatten(-2), -1, (base + k).flatten(-2)).reshape(base.shape)

    c1p, c1m = at(C1, span), at(C1, -span - 1)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    Bw = torch.where(in_level, dy_f * (c1p - c1m), zero)
    Tw = torch.where(in_level, span_f * (c1p + c1m) - at(C2, span - 1) + at(C2, -span - 1), zero)
    m10 = torch.zeros(flat.shape, dtype=img.dtype, device=img.device)
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


brief_coords = ck.brief_coords


def brief_descriptors(img_blur: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF: (..., K, 8) int32 descriptors of keypoints xy (..., K, 2)
    with angles (..., K) on the blurred level (..., H, W)."""
    H, W = img_blur.shape[-2:]
    level = torch.zeros(angle.shape, dtype=torch.int32, device=angle.device)
    return ck.brief_sample(img_blur, ((H, W),), xy.to(torch.int32), angle, level)


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


# spans inside extraction (``utils.timing.span``: with nothing recording, a
# flag check and no profiler event): the pyramid and its atlas, then the rest
PYRAMID_RANGE = "pyramid"
SELECT_RANGE = "fast_select"
ANGLE_RANGE = "ic_angle"
DESCRIBE_RANGE = "describe"


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
    with span(PYRAMID_RANGE):
        atlas = image_ops.build_atlas(tuple(image_ops.build_pyramid(img, n_levels, scale_factor)))
    return extract_from_atlas(
        atlas, n_features=n_features, n_levels=n_levels,
        scale_factor=scale_factor, th_high=th_high, th_low=th_low,
    )


class Detections(NamedTuple):
    """Keypoints of all levels of one image before description, level after
    level, each at its own level's resolution."""

    xy: torch.Tensor        # (N, 2) float32, integer-valued level coordinates
    level: torch.Tensor     # (N,) int32
    angle: torch.Tensor     # (N,) float32 radians
    response: torch.Tensor  # (N,) float32 FAST score
    valid: torch.Tensor     # (N,) bool


@functools.lru_cache(maxsize=32)
def _level_of_feature(budgets: tuple, device: torch.device) -> torch.Tensor:
    """(N,) int32 level of each feature slot: ``budgets[l]`` slots of level
    l, in level order.  Made once per device; shared, never written."""
    lv = np.repeat(np.arange(len(budgets), dtype=np.int32), budgets)
    return torch.from_numpy(lv).to(device)


def _level_to_image_scale(sizes: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(n_levels, 2) per-axis ratios (W0 / w_l, H0 / h_l) of the rounded
    level sizes."""
    h0, w0 = sizes[0]
    return interop.const_tensor(tuple((w0 / w, h0 / h) for h, w in sizes), dtype, device)


def detect_from_pyramid(
    levels: tuple,
    n_features: int = 1200,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: float = 20.0,
    th_low: float = 7.0,
) -> Detections:
    """FAST corners and their angles on every (..., Hl, Wl) level, level by
    level as the JAX package goes: dense score map, ``detect_level``,
    ``ic_angles``."""
    batch = levels[0].shape[:-2]
    budgets = _budgets(n_features, n_levels, scale_factor, len(levels))
    outs = []
    for level_img, budget in zip(levels, budgets):
        if budget <= 0:
            continue
        level_img = level_img.contiguous()
        score = ck.fast_score(level_img)
        kps = fast_ops.detect_level(
            score, n_out=budget, th_high=th_high, th_low=th_low, border=16
        )
        outs.append((kps.xy, ic_angles(level_img, kps.xy), kps.score, kps.valid))
    n = len(batch)  # keypoints concatenate along the axis after the batch
    xy, angle, response, valid = (torch.cat(parts, dim=n) for parts in zip(*outs))
    return Detections(xy, _levels_for(budgets, batch, xy.device), angle, response, valid)


def _budgets(n_features: int, n_levels: int, scale_factor: float, n_present: int) -> tuple:
    budgets = fast_ops.level_budgets(n_features, n_levels, scale_factor)
    return tuple(max(b, 0) for b in budgets[:n_present])


def _levels_for(budgets: tuple, batch: tuple, device: torch.device) -> torch.Tensor:
    level = _level_of_feature(budgets, device)
    return level.expand(*batch, -1).contiguous() if batch else level


def detect_from_atlas(
    atlas: image_ops.PyramidAtlas,
    n_features: int = 1200,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: float = 20.0,
    th_low: float = 7.0,
) -> Detections:
    """FAST corners and their angles on every level of a (..., HA, W0)
    atlas: one K1 launch for the per-cell candidates of all levels and
    images, the per-level selection, one pass for the angles."""
    sizes = atlas.sizes
    batch = atlas.image.shape[:-2]
    budgets = _budgets(n_features, n_levels, scale_factor, len(sizes))
    with span(SELECT_RANGE):
        cand_s, cand_i = ck.fast_candidates(atlas.image, sizes, budgets, th_high, th_low, 16)
        lay = ck.candidate_layout(sizes, budgets)
        kps = [
            fast_ops.select_from_cells(
                cand_s[..., lay.first[l]:lay.first[l + 1], :lay.k[l]],
                cand_i[..., lay.first[l]:lay.first[l + 1], :lay.k[l]],
                lay.per_row[l], n_out, ck.CELL)
            for l, n_out in enumerate(budgets) if n_out > 0
        ]
        n = len(batch)  # keypoints concatenate along the axis after the batch
        xy, response, valid = (torch.cat(parts, dim=n) for parts in zip(*kps))
        level = _levels_for(budgets, batch, xy.device)
    with span(ANGLE_RANGE):
        angle = ic_angles_atlas(atlas, xy, level, runs=tuple(b for b in budgets if b > 0))
    return Detections(xy, level, angle, response, valid)


def describe(atlas: image_ops.PyramidAtlas, det: Detections) -> FrameFeatures:
    """Blur the atlas once and sample every keypoint's rBRIEF on it; the
    features come out in ``det``'s order, at level-0 coordinates.  A leading
    batch dimension on both (a stereo pair) goes through the same two
    launches."""
    with span(DESCRIBE_RANGE):
        blur = ck.gaussian_blur7(atlas.image, atlas.sizes)
        desc = ck.brief_sample(blur, atlas.sizes, det.xy.to(torch.int32), det.angle, det.level)
        # exact level->0 mapping with half-pixel centres and the actual
        # per-axis ratio of the rounded level sizes
        ax = _level_to_image_scale(atlas.sizes, det.xy.dtype, det.xy.device)[det.level.long()]
        return FrameFeatures(
            xy=(det.xy + 0.5) * ax - 0.5, level=det.level, angle=det.angle,
            response=det.response, desc=desc, valid=det.valid,
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
    return extract_from_atlas(
        image_ops.build_atlas(levels), n_features=n_features, n_levels=n_levels,
        scale_factor=scale_factor, th_high=th_high, th_low=th_low,
    )


def extract_from_atlas(atlas: image_ops.PyramidAtlas, **kw) -> FrameFeatures:
    """ORB extraction from a pyramid atlas: K1, K2 and K3 once each, whatever
    the number of levels and images; ``kw`` as :func:`detect_from_atlas`."""
    return describe(atlas, detect_from_atlas(atlas, **kw))


def extract_orb_batch(
    imgs: torch.Tensor,
    n_features: int = 1200,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: float = 20.0,
    th_low: float = 7.0,
) -> FrameFeatures:
    """ORB extraction for a (B, H, W) image batch: every kernel runs once
    over the whole batch.  Fields carry a leading B."""
    if imgs.dim() != 3:
        raise ValueError(f"extract_orb_batch: expected (B, H, W), got {tuple(imgs.shape)}")
    return extract_orb(
        imgs, n_features=n_features, n_levels=n_levels,
        scale_factor=scale_factor, th_high=th_high, th_low=th_low,
    )
