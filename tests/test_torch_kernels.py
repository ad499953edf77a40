"""Parity of the port's kernel modules with the JAX package on the CPU.

The plain PyTorch versions of kernels K1 (FAST score), K2 (7-tap blur) and
K3 (rBRIEF sampling) -- what the wrappers in
``orb_slam3_noted_tpu_torch/ops/cuda_kernels.py`` run for CPU tensors --
against the JAX package's CPU fallbacks at every pyramid level of a
320x240 frame, plus the pyramid itself.  Inputs are made once with numpy
and handed to both sides; JAX runs in its default float32 mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.ops import fast as jfast
from orb_slam3_noted_tpu.ops import image as jimage
from orb_slam3_noted_tpu.ops import orb as jorb
from orb_slam3_noted_tpu.ops import pallas_kernels as jpk
from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
from orb_slam3_noted_tpu_torch.ops import fast as tfast
from orb_slam3_noted_tpu_torch.ops import image as timage
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom

W, H = 320, 240
N_LEVELS, SCALE = 8, 1.2
BUDGETS = tfast.level_budgets(600, N_LEVELS, SCALE)
# JAX's compiled CPU resize fuses multiply-adds and sums the weights in
# another order; the port's matmuls differ from it by at most ~5e-4 (752x480)
PYRAMID_ATOL = 1e-3
# JAX's compiled blur contracts some taps into FMAs; the plain version (and
# the CUDA kernel) rounds every multiply and add
BLUR_JIT_ATOL = 1e-4

# compiled once per level shape (op-by-op dispatch compiles every op anew)
_jfast_score = jax.jit(jpk.fast_score)
_jic_angles = jax.jit(jorb.ic_angles)


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """JAX in float32 as in use; torch on one thread: the test workers run
    side by side, and the port's many small operations only lose to threads
    that fight over the same cores."""
    prev, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def frame():
    img = BoxRoom(seed=5).render(np.eye(3), np.zeros(3), (260.0, 260.0, 160.0, 120.0), W, H)
    return np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)


@pytest.fixture(scope="module")
def jax_levels(frame):
    build = jax.jit(lambda x: jimage.build_pyramid(x, N_LEVELS, SCALE))
    return [np.array(lv) for lv in build(jnp.asarray(frame))]  # writable copies


def test_level_sizes_and_budgets():
    assert timage.pyramid_sizes(H, W, N_LEVELS, SCALE) == jimage.pyramid_sizes(H, W, N_LEVELS, SCALE)
    assert BUDGETS == jfast.level_budgets(600, N_LEVELS, SCALE)


@pytest.mark.parametrize("size", [(480, 400), (752, 627), (240, 200), (627, 522)])
def test_resize_weights_match_jax(size):
    import jax._src.image.scale as S

    m, n = size
    wj = np.asarray(jax.jit(
        lambda: S.compute_weight_mat(m, n, n / m, 0.0, S._fill_triangle_kernel, True)
    )())
    # a handful of weights round one ulp apart (weight-sum order)
    np.testing.assert_allclose(timage.resize_weights(m, n), wj, rtol=0, atol=2e-7)


def test_build_pyramid(frame, jax_levels):
    levels = timage.build_pyramid(torch.from_numpy(frame), N_LEVELS, SCALE)
    assert len(levels) == N_LEVELS
    np.testing.assert_array_equal(levels[0].numpy(), jax_levels[0])
    for lv, ref in zip(levels[1:], jax_levels[1:]):
        assert lv.shape == ref.shape
        np.testing.assert_allclose(lv.numpy(), ref, rtol=0, atol=PYRAMID_ATOL)


@pytest.mark.parametrize("lvl", range(N_LEVELS))
def test_fast_score_plain_exact(jax_levels, lvl):
    lv = jax_levels[lvl]
    ref = np.asarray(_jfast_score(jnp.asarray(lv)))
    out = ck.fast_score(torch.from_numpy(lv))  # CPU tensor -> plain version
    np.testing.assert_array_equal(out.numpy(), ref)


def test_fast_score_batched(jax_levels):
    lv = torch.from_numpy(jax_levels[2])
    batch = torch.stack([lv, lv.flip(-1), lv * 0.5])
    out = ck.fast_score(batch)
    for b in range(3):
        np.testing.assert_array_equal(out[b].numpy(), ck.fast_score(batch[b].contiguous()).numpy())


@pytest.mark.parametrize("lvl", range(N_LEVELS))
def test_gaussian_blur7_plain(jax_levels, lvl):
    lv = jax_levels[lvl]
    out = ck.gaussian_blur7(torch.from_numpy(lv)).numpy()
    # bit-exact with the JAX CPU path run op by op ...
    np.testing.assert_array_equal(out, np.asarray(jimage.gaussian_blur(jnp.asarray(lv), 7, 2.0)))
    # ... and within BLUR_JIT_ATOL of it compiled, as extraction runs it
    ref = np.asarray(jax.jit(jpk.gaussian_blur7)(jnp.asarray(lv)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=BLUR_JIT_ATOL)


@pytest.mark.parametrize("lvl", range(N_LEVELS))
def test_brief_sample_plain_exact(jax_levels, lvl, monkeypatch):
    """K3's plain version on the JAX package's own sample coordinates,
    against the JAX CPU gather they feed (``orb.py:164-170``)."""
    lv = jnp.asarray(jax_levels[lvl])
    blur = jax.jit(jpk.gaussian_blur7)(lv)
    kps = jfast.detect_level(_jfast_score(lv), n_out=BUDGETS[lvl])
    ang = _jic_angles(lv, kps.xy)
    ref = np.asarray(jax.jit(lambda b, xy, a: jorb.brief_descriptors(b, xy, a))(blur, kps.xy, ang))

    # the JAX package hands its sample coordinates to ``brief_sample_tpu``
    # (None off the TPU, then its CPU gather runs); a stand-in that returns
    # them instead makes brief_descriptors hand them back
    monkeypatch.setattr(jpk, "brief_sample_tpu", lambda img, gy, gx: jnp.stack([gy, gx]))
    coords = jax.jit(lambda b, xy, a: jorb.brief_descriptors(b, xy, a))(blur, kps.xy, ang)
    seen = {"gy": np.asarray(coords[0]), "gx": np.asarray(coords[1])}
    gy = torch.from_numpy(seen["gy"].astype(np.int32))
    gx = torch.from_numpy(seen["gx"].astype(np.int32))
    out = ck.brief_sample_plain(torch.from_numpy(np.array(blur)), gy, gx)
    assert out.dtype == torch.int32 and out.shape == (BUDGETS[lvl], 8)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)
    # the port's own rotated coordinates: cos/sin differ from XLA's in the
    # last ulp, which can move a rounded sample; measured 100% equal here
    tgy, tgx = torb.brief_coords(lv.shape[0], lv.shape[1], torch.from_numpy(np.array(kps.xy)),
                                 torch.from_numpy(np.array(ang)))
    same = np.all((tgy.numpy() == seen["gy"]) & (tgx.numpy() == seen["gx"]), axis=1)
    assert same.mean() >= 0.99
    # the wrapper on a CPU tensor: the level as a one-level atlas, the
    # rotation inside; equal to the gather on the port's own coordinates
    h, w = lv.shape
    words = ck.brief_sample(torch.from_numpy(np.array(blur)), ((h, w),),
                            torch.from_numpy(np.array(kps.xy)).to(torch.int32),
                            torch.from_numpy(np.array(ang)),
                            torch.zeros(BUDGETS[lvl], dtype=torch.int32))
    assert torch.equal(words, ck.brief_sample_plain(torch.from_numpy(np.array(blur)), tgy, tgx))


def _atlas_inputs(seed, batch):
    """A 3-level atlas with odd widths from numpy noise: (atlas (*batch, HA,
    W0) float32, sizes, the levels as (*batch, h, w) arrays)."""
    rng = np.random.default_rng(seed)
    sizes = ((37, 61), (31, 51), (26, 43))
    levels = [rng.uniform(0, 255, (*batch, h, w)).astype(np.float32) for h, w in sizes]
    atlas = np.concatenate(
        [np.pad(lv, [(0, 0)] * (lv.ndim - 1) + [(0, sizes[0][1] - lv.shape[-1])]) for lv in levels],
        axis=-2)
    return atlas, sizes, levels


@pytest.mark.parametrize("batch", [(), (1,), (2,)])
def test_atlas_blur_plain_matches_jax_level_by_level(batch):
    """K2's plain version over an atlas: each level's window equals the JAX
    package's CPU blur of that level alone -- bit-exact op by op, within
    BLUR_JIT_ATOL compiled -- and the padding stays zero."""
    atlas, sizes, levels = _atlas_inputs(11, batch)
    before = ck.gaussian_blur7.launches
    out = ck.gaussian_blur7(torch.from_numpy(atlas), sizes)  # CPU tensor -> plain version
    assert ck.gaussian_blur7.launches == before
    assert out.shape == atlas.shape and out.dtype == torch.float32
    jit_blur = jax.jit(jpk.gaussian_blur7)
    for view, lv in zip(timage.level_views(out, sizes), levels):
        for idx in np.ndindex(*batch):
            np.testing.assert_array_equal(
                view[idx].numpy(), np.asarray(jimage.gaussian_blur(jnp.asarray(lv[idx]), 7, 2.0)))
            np.testing.assert_allclose(
                view[idx].numpy(), np.asarray(jit_blur(jnp.asarray(lv[idx]))), rtol=0,
                atol=BLUR_JIT_ATOL)
    for (h, w), o in zip(sizes, timage.level_offsets(sizes)):
        assert float(out[..., o:o + h, w:].abs().sum()) == 0.0


@pytest.mark.parametrize("change", ["padding", "neighbour_above", "neighbour_below"])
def test_atlas_blur_level_sees_only_itself(change):
    """Reflection happens inside a level's window: neither the padding
    columns nor a neighbouring level's pixels reach a level's result."""
    atlas, sizes, _ = _atlas_inputs(12, ())
    offs = timage.level_offsets(sizes)
    (h1, w1), o1 = sizes[1], offs[1]
    other = atlas.copy()
    if change == "padding":
        other[o1:o1 + h1, w1:] = 1e6
        other[offs[2]:, sizes[2][1]:] = -1e6
    elif change == "neighbour_above":
        other[:o1] = 255.0 - other[:o1]
    else:
        other[o1 + h1:] = 255.0 - other[o1 + h1:]
    a = timage.level_views(ck.gaussian_blur7(torch.from_numpy(atlas), sizes), sizes)[1]
    b = timage.level_views(ck.gaussian_blur7(torch.from_numpy(other), sizes), sizes)[1]
    assert torch.equal(a, b)
    assert not np.array_equal(atlas, other)


def test_single_level_blur_is_the_one_level_atlas(jax_levels):
    lv = torch.from_numpy(jax_levels[3])
    assert torch.equal(ck.gaussian_blur7(lv), ck.gaussian_blur7(lv, (tuple(lv.shape),)))
    batch = torch.stack([lv, lv.flip(-1)])
    assert torch.equal(ck.gaussian_blur7(batch)[1], ck.gaussian_blur7(batch[1].contiguous()))


TIE_ANGLE = np.float32(np.pi / 6)  # sin is exactly 0.5 in float32, in JAX and in torch


@pytest.mark.parametrize("batch", [(), (2,)])
def test_atlas_sampler_plain_matches_jax_brief_descriptors(batch):
    """K3's plain version over an atlas against the JAX package's
    ``brief_descriptors`` (its CPU gather) level by level, exactly: with
    keypoints on the 16-px border of the smallest level and nearer still
    (samples clip to the level, not to the atlas), and angles of +-pi/6
    whose sine is exactly one half, so odd pattern offsets land on .5 and
    the rounding (half to even) decides the sample."""
    atlas, sizes, levels = _atlas_inputs(13, batch)
    rng = np.random.default_rng(14)
    n_per = 24
    xy, ang, lvl = [], [], []
    for l, (h, w) in enumerate(sizes):
        pts = rng.integers([0, 0], [w, h], size=(*batch, n_per, 2))
        corners = np.array([[16, 16], [w - 17, 16], [16, h - 17], [w - 17, h - 17],
                            [0, 0], [w - 1, h - 1], [2, h - 3], [w - 2, 5]])
        pts[..., :8, :] = corners
        a = rng.uniform(-np.pi, np.pi, size=(*batch, n_per)).astype(np.float32)
        a[..., 0:8:2] = TIE_ANGLE
        a[..., 1:8:2] = -TIE_ANGLE
        a[..., 8] = 0.0
        xy.append(pts.astype(np.int32)); ang.append(a); lvl.append(np.full((*batch, n_per), l, np.int32))
    xy, ang, lvl = (np.concatenate(v, axis=len(batch)) for v in (xy, ang, lvl))

    # the premise: both packages take the same sine and cosine of the tie
    # angle, and rotated pattern points do land on .5 and outside the level
    t = torch.tensor([TIE_ANGLE, -TIE_ANGLE])
    j = jnp.asarray([TIE_ANGLE, -TIE_ANGLE])
    np.testing.assert_array_equal(torch.sin(t).numpy(), np.asarray(jnp.sin(j)))
    np.testing.assert_array_equal(torch.cos(t).numpy(), np.asarray(jnp.cos(j)))
    assert abs(float(torch.sin(t)[0])) == 0.5
    px, py = ck.PATTERN_XY[:, 0], ck.PATTERN_XY[:, 1]
    rx = px * np.float32(np.cos(TIE_ANGLE)) - py * np.float32(0.5)
    assert (np.abs(rx - np.floor(rx)) == 0.5).sum() >= 4
    assert (16 + np.round(rx)).min() < 0  # a border keypoint's samples clip

    before = ck.brief_sample.launches
    out = ck.brief_sample(torch.from_numpy(atlas), sizes, torch.from_numpy(xy),
                          torch.from_numpy(ang), torch.from_numpy(lvl))
    assert ck.brief_sample.launches == before
    assert out.shape == (*batch, 3 * n_per, 8) and out.dtype == torch.int32
    got = out.numpy().view(np.uint32)
    for l, lv in enumerate(levels):
        rows = slice(l * n_per, (l + 1) * n_per)
        for idx in np.ndindex(*batch):
            ref = jorb.brief_descriptors(jnp.asarray(lv[idx]),
                                         jnp.asarray(xy[idx][rows].astype(np.float32)),
                                         jnp.asarray(ang[idx][rows]))
            np.testing.assert_array_equal(got[idx][rows], np.asarray(ref))


def test_atlas_sampler_plain_is_brief_coords_per_level():
    """The atlas form is ``brief_coords`` at each level's (h, w) followed by
    the gather on that level's window, whatever the order of the levels."""
    atlas, sizes, _ = _atlas_inputs(15, ())
    rng = np.random.default_rng(16)
    n = 40
    lvl = rng.integers(0, 3, n).astype(np.int32)
    hw = np.asarray(sizes)[lvl]
    xy = (rng.uniform(size=(n, 2)) * hw[:, ::-1]).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    at = torch.from_numpy(atlas)
    out = ck.brief_sample(at, sizes, torch.from_numpy(xy), torch.from_numpy(ang), torch.from_numpy(lvl))
    for l, (view, (h, w)) in enumerate(zip(timage.level_views(at, sizes), sizes)):
        m = lvl == l
        gy, gx = torb.brief_coords(h, w, torch.from_numpy(xy[m]), torch.from_numpy(ang[m]))
        assert torch.equal(out[torch.from_numpy(m)], ck.brief_sample_plain(view.contiguous(), gy, gx))


def _tie_levels(seed=21):
    """Integer-valued images of few grey values at the level shapes: FAST
    scores are small integers, so cells are full of equal scores."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 4, size=shape) * 40).astype(np.float32)
            for shape in timage.pyramid_sizes(H, W, N_LEVELS, SCALE)]


@pytest.fixture(scope="module")
def candidate_levels(jax_levels):
    """Per kind of input: the levels, and K1's plain candidates over their
    atlas with its layout."""
    out = {}
    for kind, levels in (("frame", jax_levels), ("ties", _tie_levels())):
        atlas = timage.build_atlas(tuple(torch.from_numpy(lv) for lv in levels))
        cand = ck.fast_candidates(atlas.image, atlas.sizes, BUDGETS)  # CPU -> plain version
        out[kind] = (levels, atlas, cand, ck.candidate_layout(atlas.sizes, tuple(BUDGETS)))
    return out


@pytest.mark.parametrize("kind", ["frame", "ties"])
@pytest.mark.parametrize("lvl", range(N_LEVELS))
def test_fast_candidates_plain_then_select_is_jax_detect_level(candidate_levels, kind, lvl):
    """K1's plain version over the atlas, then ``select_from_cells`` on the
    level's slice, against the JAX package's ``detect_level`` of that level's
    score map: coordinates, scores and validity of every slot, exactly."""
    levels, atlas, (cand_s, cand_i), lay = candidate_levels[kind]
    assert cand_s.shape == (lay.n_cells, lay.k_max) and cand_i.dtype == torch.int32
    c0, c1, k = lay.first[lvl], lay.first[lvl + 1], lay.k[lvl]
    ncy, ncx = tfast.cell_grid(*atlas.sizes[lvl])
    assert c1 - c0 == ncy * ncx and lay.per_row[lvl] == ncx
    assert k == tfast.candidates_per_cell(BUDGETS[lvl], ncy * ncx)
    assert bool((cand_s[c0:c1, k:] == tfast.NEG).all()) and bool((cand_i[c0:c1, k:] == 0).all())
    kps = tfast.select_from_cells(cand_s[c0:c1, :k], cand_i[c0:c1, :k], ncx, BUDGETS[lvl])
    lv = jnp.asarray(levels[lvl])
    ref = jfast.detect_level(_jfast_score(lv), n_out=BUDGETS[lvl])
    np.testing.assert_array_equal(kps.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(kps.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(kps.xy.numpy(), np.asarray(ref.xy))
    assert int(kps.valid.sum()) > 0
    if kind == "ties":  # the premise: equal scores inside cells, decided by index
        s = cand_s[c0:c1, :k]
        assert int(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] > tfast.NEG / 2)).sum()) > 10
    # the composition the JAX counterpart is held to keeps its signature
    whole = tfast.detect_level(ck.fast_score(torch.from_numpy(levels[lvl])), n_out=BUDGETS[lvl])
    for a, b in zip(whole, kps):
        assert torch.equal(a, b)


def test_fast_candidates_rejects_what_the_kernel_cannot_take():
    """Checked ahead of the launch, on any device: the layout needs a budget
    per level; the card's wrapper needs border >= 4 and levels that hold a
    kept pixel (the checks sit behind the device test, so the CPU's plain
    version, which needs neither, is not held to them)."""
    img = torch.zeros(94, 61)
    sizes = ((37, 61), (31, 51), (26, 43))
    with pytest.raises(ValueError):
        ck.fast_candidates(img, sizes, (10, 10))
    s, i = ck.fast_candidates(img, sizes, (10, 0, 10), border=2)
    lay = ck.candidate_layout(sizes, (10, 0, 10))
    assert lay.first == (0, 4, 4, 6) and lay.k[1] == 0 and s.shape == (6, lay.k_max)
    assert bool((s == tfast.NEG).all())


@pytest.mark.parametrize("batch", [(), (1,), (2,)])
def test_detect_from_atlas_equals_detect_from_pyramid(frame, batch):
    """One candidate pass over the atlas, the padding columns filled with
    noise, gives the level-by-level detections exactly; with a batch every
    image gets the detections it gets alone."""
    rng = np.random.default_rng(22)
    imgs = np.stack([frame, frame[::-1].copy()])[: max(batch[0], 1) if batch else 1]
    img = torch.from_numpy(imgs if batch else imgs[0])
    pyr = tuple(timage.build_pyramid(img, N_LEVELS, SCALE))
    atlas = timage.build_atlas(pyr)
    noisy = atlas.image.clone()
    for (h, w), o in zip(atlas.sizes, timage.level_offsets(atlas.sizes)):
        pad = noisy[..., o:o + h, w:]
        pad.copy_(torch.from_numpy(rng.uniform(0, 255, pad.shape).astype(np.float32)))
    kw = dict(n_features=600, n_levels=N_LEVELS, scale_factor=SCALE)
    got = torb.detect_from_atlas(atlas._replace(image=noisy), **kw)
    assert got.xy.shape == (*batch, 600, 2) and int(got.valid.sum()) > 400 * len(imgs)
    for idx in np.ndindex(*batch):
        alone = torb.detect_from_pyramid(tuple(p[idx] for p in pyr), **kw)
        for name, a, b in zip(alone._fields, got, alone):
            assert torch.equal(a[idx], b), (name, idx)
    # the batched level-by-level form takes one arctangent per level over
    # the whole batch, which rounds an element by its place in the call
    whole = torb.detect_from_pyramid(pyr, **kw)
    for name, a, b in zip(whole._fields, got, whole):
        if name == "angle":
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_atlas_detection_level_sees_only_itself(lvl):
    """Neither the padding nor a neighbouring level reaches a level's
    corners and angles: overwrite everything else with noise."""
    atlas_np, sizes, levels = _atlas_inputs(23, ())
    big = [np.kron(lv, np.ones((3, 3), np.float32)) for lv in levels]  # 111x183, 93x153, 78x129
    rng = np.random.default_rng(24)
    pyr = tuple(torch.from_numpy(np.round(b + rng.uniform(-20, 20, b.shape)).astype(np.float32))
                for b in big)
    atlas = timage.build_atlas(pyr)
    other = torch.from_numpy(rng.uniform(0, 255, atlas.image.shape).astype(np.float32))
    (h, w), o = atlas.sizes[lvl], timage.level_offsets(atlas.sizes)[lvl]
    other[o:o + h, :w] = atlas.image[o:o + h, :w]
    kw = dict(n_features=120, n_levels=3, scale_factor=SCALE)
    a = torb.detect_from_atlas(atlas, **kw)
    b = torb.detect_from_atlas(atlas._replace(image=other), **kw)
    rows = a.level == lvl
    assert int((a.valid & rows).sum()) > 10
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x[rows], y[rows]), name
    assert not torch.equal(a.xy[~rows], b.xy[~rows])


@pytest.mark.parametrize("batch", [(), (2,)])
def test_ic_angles_atlas_is_ic_angles_per_level(jax_levels, batch):
    """Angles read at the keypoints of an atlas against the dense moment
    maps of each level: bit for bit, keypoints on the 16-px border and in
    the corners of the kept area included; and against the JAX package's
    ``ic_angles`` within the float32 prefix sums' last-ulp differences."""
    rng = np.random.default_rng(25)
    levels = [np.stack([lv, lv[::-1]])[: batch[0]] if batch else lv for lv in jax_levels]
    atlas = timage.build_atlas(tuple(torch.from_numpy(np.ascontiguousarray(lv)) for lv in levels))
    n_per = 40
    xy, lvl = [], []
    for l, (h, w) in enumerate(atlas.sizes):
        pts = rng.integers([16, 16], [w - 16, h - 16], size=(*batch, n_per, 2))
        pts[..., :4, :] = [[16, 16], [w - 17, 16], [16, h - 17], [w - 17, h - 17]]
        xy.append(pts.astype(np.float32))
        lvl.append(np.full((*batch, n_per), l, np.int32))
    xy, lvl = (torch.from_numpy(np.concatenate(v, axis=len(batch))) for v in (xy, lvl))
    got = torb.ic_angles_atlas(atlas, xy, lvl, runs=(n_per,) * N_LEVELS)
    assert got.shape == (*batch, N_LEVELS * n_per)
    for l, lv in enumerate(levels):
        rows = slice(l * n_per, (l + 1) * n_per)
        for idx in np.ndindex(*batch):
            pts = xy[idx][rows]
            ref = torb.ic_angles(torch.from_numpy(np.ascontiguousarray(lv[idx])), pts)
            assert torch.equal(got[idx][rows], ref), (l, idx)
            jref = _jic_angles(jnp.asarray(lv[idx]), jnp.asarray(pts.numpy()))
            np.testing.assert_allclose(got[idx][rows].numpy(), np.asarray(jref), rtol=0, atol=1e-4)
    # one arctangent over all keypoints of an image: the same to an ulp
    whole = torb.ic_angles_atlas(atlas, xy, lvl, runs=(N_LEVELS * n_per,))
    torch.testing.assert_close(whole, got, rtol=0, atol=1e-6)


def test_atlas_tables_are_cached_and_stack():
    """``build_atlas`` lives in ``ops/image.py`` (``ops/stereo.py`` keeps the
    name); its device tables are made once per level sizes and device."""
    from orb_slam3_noted_tpu_torch.ops import stereo as tstereo

    assert tstereo.build_atlas is timage.build_atlas and tstereo.PyramidAtlas is timage.PyramidAtlas
    _, sizes, levels = _atlas_inputs(17, ())
    a = timage.build_atlas(tuple(torch.from_numpy(lv) for lv in levels))
    b = timage.build_atlas(tuple(torch.from_numpy(lv * 0.5) for lv in levels))
    assert a.sizes == sizes and a.off is b.off and a.h is b.h and a.w is b.w
    assert a.off.tolist() == timage.level_offsets(sizes) == [0, 37, 68]
    pair = timage.stack_atlases([a, b])
    assert pair.image.shape == (2, 94, 61) and pair.sizes == sizes
    assert torch.equal(pair.image[1], b.image)
    with pytest.raises(ValueError):
        timage.stack_atlases([a, timage.build_atlas((torch.zeros(8, 9),))])


def test_wrappers_run_plain_on_cpu_and_count_nothing(jax_levels):
    ck.reset_launch_counts()
    lv = torch.from_numpy(jax_levels[0])
    ck.fast_score(lv)
    blur = ck.gaussian_blur7(lv)
    ck.brief_sample(blur, (tuple(lv.shape),), torch.zeros((4, 2), dtype=torch.int32),
                    torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    torb.extract_orb(lv, n_features=300)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    sads = ck.sad_stereo(lv, blur, i32(20, 30), i32(40, 50), i32(35, 48), i32(0, 0),
                         i32(0), i32(lv.shape[0]), i32(lv.shape[1]))
    assert sads.shape == (2, 11)
    atlas = timage.build_atlas(tuple(timage.build_pyramid(lv, 3, SCALE)))
    cand_s, cand_i = ck.fast_candidates(atlas.image, atlas.sizes, (40, 30, 20))
    assert cand_s.shape == cand_i.shape and cand_i.dtype == torch.int32
    assert ck.launch_counts() == {"fast_candidates": 0, "gaussian_blur7": 0, "brief_sample": 0,
                                  "sad_stereo": 0, "fast_score": 0}


def test_build_dir_is_gitignored():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = os.path.relpath(ck.BUILD_DIR, root).split(os.sep)[0]
    with open(os.path.join(root, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert rel in ignored
    assert ck.library_path().parent == ck.BUILD_DIR
    assert sorted(p.name for p in ck.CSRC.glob("*.cu")) == [
        "brief_sample.cu", "fast_score.cu", "gaussian_blur7.cu", "launch_floor.cu",
        "sad_stereo.cu",
    ]
