"""CUDA kernels K1-K4 against their plain PyTorch versions, on the card, and
the batched front end, two-view solver, place recognition and PnP around
them.

Marked ``cuda``: every test here skips where ``torch.cuda.is_available()``
is false (decided inside the fixture, so every worker collects the same
tests).  On a machine with an NVIDIA GPU (``sm_90a``) and ``nvcc``:

    python -m pytest tests/test_torch_cuda.py -q
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
from orb_slam3_noted_tpu_torch.ops import fast as fast_ops
from orb_slam3_noted_tpu_torch.ops import image as image_ops
from orb_slam3_noted_tpu_torch.ops import orb as O

pytestmark = pytest.mark.cuda

# the 8 levels of a 752x480 frame and the per-level keypoints of 1200 features
SHAPES = image_ops.pyramid_sizes(480, 752, 8, 1.2)
BUDGETS = fast_ops.level_budgets(1200, 8, 1.2)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _image(shape, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) * 255).round().to(dev)


@pytest.mark.parametrize("lvl", range(8))
def test_fast_score_kernel_exact(dev, lvl):
    img = _image(SHAPES[lvl], dev, lvl)
    before = ck.fast_score.launches
    out = ck.fast_score(img)
    assert ck.fast_score.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, ck.fast_score_plain(img))


ODD_SHAPES = ((97, 131), (81, 109), (67, 91))  # last cells 1 to 27 px wide or high


def _candidate_atlas(dev, kind, n_levels, batch):
    """An atlas whose levels end in partial cells: ``frame`` a rendered room
    and its resized levels, ``ties`` integer images of four grey values
    (equal scores all over every cell)."""
    sizes = ODD_SHAPES if n_levels == 3 else tuple(SHAPES[:n_levels])
    if kind == "frame":
        from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom

        h, w = sizes[0]
        img = BoxRoom(seed=3).render(np.eye(3), np.zeros(3), (0.6 * w, 0.6 * w, w / 2, h / 2), w, h)
        img = torch.from_numpy(np.clip(img, 0, 255).astype(np.float32))
        imgs = torch.stack([img.roll(17 * b, -1) for b in range(batch[0])]) if batch else img
        pyr = image_ops.build_pyramid(imgs.to(dev), n_levels, 1.2)
        assert tuple(tuple(p.shape[-2:]) for p in pyr) == sizes
    else:
        g = torch.Generator().manual_seed(7)
        pyr = [(torch.randint(0, 4, (*batch, h, w), generator=g) * 40.0).to(dev) for h, w in sizes]
    return image_ops.build_atlas(tuple(pyr))


@pytest.mark.parametrize("kind", ["frame", "ties"])
@pytest.mark.parametrize("n_levels", [1, 3, 8])
@pytest.mark.parametrize("batch", [(), (1,), (2,)])
def test_fast_candidates_kernel_exact(dev, batch, n_levels, kind):
    """One launch for every cell of every level of every image: scores and
    indices of every slot equal to the plain version's (per level the dense
    score map, then ``cell_candidates``), twice the same bits, and the
    padding columns filled with noise change nothing."""
    atlas = _candidate_atlas(dev, kind, n_levels, batch)
    budgets = tuple(fast_ops.level_budgets(1200 if n_levels == 8 else 150, n_levels, 1.2))
    lay = ck.candidate_layout(atlas.sizes, budgets)
    before = ck.fast_candidates.launches
    cand_s, cand_i = ck.fast_candidates(atlas.image, atlas.sizes, budgets)
    assert ck.fast_candidates.launches == before + 1
    torch.cuda.synchronize()
    assert cand_s.shape == cand_i.shape == (*batch, lay.n_cells, lay.k_max)
    assert cand_s.dtype == torch.float32 and cand_i.dtype == torch.int32
    plain_s, plain_i = ck.fast_candidates_plain(atlas.image, atlas.sizes, budgets)
    assert int((plain_s > fast_ops.NEG / 2).sum()) > 20 * max(n_levels, 2)
    assert torch.equal(cand_s, plain_s)
    assert torch.equal(cand_i, plain_i)
    if kind == "ties":
        filled = plain_s[..., 1:] > fast_ops.NEG / 2
        assert int(((plain_s[..., 1:] == plain_s[..., :-1]) & filled).sum()) > 50
    noisy = atlas.image.clone()
    for (h, w), o in zip(atlas.sizes, image_ops.level_offsets(atlas.sizes)):
        noisy[..., o:o + h, w:] = torch.rand_like(noisy[..., o:o + h, w:]) * 255
    again_s, again_i = ck.fast_candidates(noisy, atlas.sizes, budgets)
    assert torch.equal(again_s, cand_s) and torch.equal(again_i, cand_i)


def test_fast_candidates_thresholds_border_and_skipped_levels(dev):
    """Other thresholds, a narrower border, and a level with no budget."""
    atlas = _candidate_atlas(dev, "frame", 3, (2,))
    for budgets, kw in (((80, 0, 40), {}), ((60, 50, 40), dict(th_high=35.0, th_low=12.0)),
                        ((60, 50, 40), dict(border=4)), ((60, 50, 40), dict(border=19))):
        got = ck.fast_candidates(atlas.image, atlas.sizes, budgets, **kw)
        want = ck.fast_candidates_plain(atlas.image, atlas.sizes, budgets, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (budgets, kw)


def test_detect_from_atlas_on_card_matches_cpu(dev):
    """Candidates from the kernel, selection and angles in PyTorch on the
    card, against the same on the CPU: the same corners exactly; angles to
    the prefix sums' rounding."""
    atlas = _candidate_atlas(dev, "frame", 8, (2,))
    on_card = O.detect_from_atlas(atlas)
    on_cpu = O.detect_from_atlas(image_ops.build_atlas(tuple(
        v.cpu().contiguous() for v in image_ops.level_views(atlas.image, atlas.sizes))))
    for name in ("xy", "level", "response", "valid"):
        assert torch.equal(getattr(on_card, name).cpu(), getattr(on_cpu, name)), name
    assert int(on_cpu.valid.sum()) > 1500
    torch.testing.assert_close(on_card.angle.cpu(), on_cpu.angle, rtol=0, atol=1e-3)


@pytest.mark.parametrize("lvl", range(8))
def test_gaussian_blur7_kernel_exact(dev, lvl):
    """The single-level form: a one-level table over the atlas kernel."""
    img = image_ops.build_pyramid(_image(SHAPES[0], dev, 1))[lvl].contiguous()
    before = ck.gaussian_blur7.launches
    out = ck.gaussian_blur7(img)
    assert ck.gaussian_blur7.launches == before + 1
    torch.cuda.synchronize()
    # __fmul_rn/__fadd_rn round each tap as the plain multiply and add do
    assert torch.equal(out, ck.gaussian_blur7_plain(img))


def _atlas(dev, seed, batch=(), n_levels=8):
    """A noise atlas over the first ``n_levels`` level shapes."""
    sizes = tuple(SHAPES[:n_levels])
    pyr = tuple(_image((*batch, h, w), dev, seed + i) for i, (h, w) in enumerate(sizes))
    return image_ops.build_atlas(pyr)


def _levels_equal(a, b, sizes):
    """Over the level windows: the card leaves the padding unwritten."""
    return all(torch.equal(x, y) for x, y in
               zip(image_ops.level_views(a, sizes), image_ops.level_views(b, sizes)))


@pytest.mark.parametrize("n_levels", [1, 8])
@pytest.mark.parametrize("batch", [(), (1,), (2,)])
def test_gaussian_blur7_atlas_kernel_exact(dev, batch, n_levels):
    """One launch over every level of every image: bit-equal with the
    per-level plain version, twice the same bits, and the input's padding
    and neighbouring levels never reach a level."""
    atlas = _atlas(dev, 20, batch, n_levels)
    before = ck.gaussian_blur7.launches
    out = ck.gaussian_blur7(atlas.image, atlas.sizes)
    assert ck.gaussian_blur7.launches == before + 1
    torch.cuda.synchronize()
    assert out.shape == atlas.image.shape
    assert _levels_equal(out, ck.gaussian_blur7_plain(atlas.image, atlas.sizes), atlas.sizes)
    assert _levels_equal(out, ck.gaussian_blur7(atlas.image, atlas.sizes), atlas.sizes)
    if n_levels > 1:
        other = atlas.image.clone()
        o1, (h1, w1) = image_ops.level_offsets(atlas.sizes)[1], atlas.sizes[1]
        other[..., o1:o1 + h1, w1:] = 1e6      # level 1's padding
        other[..., :o1, :] = 0.0               # the level above it
        other[..., o1 + h1:, :] = 0.0          # every level below it
        a = image_ops.level_views(out, atlas.sizes)[1]
        b = image_ops.level_views(ck.gaussian_blur7(other, atlas.sizes), atlas.sizes)[1]
        assert torch.equal(a, b)


def _keypoints(dev, seed, sizes, n, batch=()):
    """Random keypoints over all levels, some on and past the 16-px border so
    samples clip, some with the angles whose sine is exactly one half."""
    g = torch.Generator().manual_seed(seed)
    hs = torch.tensor([h for h, _ in sizes])
    ws = torch.tensor([w for _, w in sizes])
    lvl = torch.randint(0, len(sizes), (*batch, n), generator=g)
    u = torch.rand((*batch, n, 2), generator=g)
    xy = (u * torch.stack([ws[lvl], hs[lvl]], -1)).floor()
    xy[..., 0, :] = 0.0
    xy[..., 1, :] = 16.0
    ang = (torch.rand((*batch, n), generator=g) * 2 - 1) * torch.pi
    ang[..., 1:n:7] = torch.pi / 6
    ang[..., 2:n:7] = -torch.pi / 6
    return xy.to(torch.int32).to(dev), ang.to(dev), lvl.to(torch.int32).to(dev)


@pytest.mark.parametrize("n_levels", [1, 8])
@pytest.mark.parametrize("batch", [(), (1,), (2,)])
def test_brief_sample_atlas_kernel_exact(dev, batch, n_levels):
    """One launch over the keypoints of every level and image, the rotation
    inside the kernel: bit-equal with ``brief_coords`` + gather, and twice
    the same bits."""
    atlas = _atlas(dev, 30, batch, n_levels)
    blur = ck.gaussian_blur7_plain(atlas.image, atlas.sizes)
    xy, ang, lvl = _keypoints(dev, 31, atlas.sizes, 1200, batch)
    before = ck.brief_sample.launches
    out = ck.brief_sample(blur, atlas.sizes, xy, ang, lvl)
    assert ck.brief_sample.launches == before + 1
    torch.cuda.synchronize()
    assert out.shape == (*batch, 1200, 8) and out.dtype == torch.int32
    assert torch.equal(out, ck.brief_sample_atlas_plain(blur, atlas.sizes, xy, ang, lvl))
    assert torch.equal(out, ck.brief_sample(blur, atlas.sizes, xy, ang, lvl))


@pytest.mark.parametrize("lvl", range(8))
def test_brief_sample_kernel_exact(dev, lvl):
    """Detected keypoints of one level, as extraction describes them: the
    level is a one-level atlas, against ``brief_coords`` + gather."""
    img = _image(SHAPES[lvl], dev, 2)
    blur = ck.gaussian_blur7(img)
    kps = fast_ops.detect_level(ck.fast_score(img), n_out=BUDGETS[lvl])
    ang = O.ic_angles(img, kps.xy)
    gy, gx = O.brief_coords(img.shape[0], img.shape[1], kps.xy, ang)
    out = O.brief_descriptors(blur, kps.xy, ang)
    torch.cuda.synchronize()
    assert out.shape == (BUDGETS[lvl], 8) and out.dtype == torch.int32
    assert torch.equal(out, ck.brief_sample_plain(blur, gy, gx))


def test_brief_sample_pattern_is_the_tables(dev):
    """The ``__constant__`` pattern is filled from ``orb_pattern.py``: at
    angle 0 the samples are the table's offsets themselves."""
    from orb_slam3_noted_tpu_torch.ops.orb_pattern import BIT_PATTERN_31

    img = _image((64, 64), dev, 4)
    xy = torch.tensor([[32, 32]], dtype=torch.int32, device=dev)
    out = ck.brief_sample(img, ((64, 64),), xy, torch.zeros(1, device=dev),
                          torch.zeros(1, dtype=torch.int32, device=dev))
    p = torch.from_numpy(BIT_PATTERN_31.astype("int64")).to(dev) + 32
    bits = img[p[:, 1], p[:, 0]] < img[p[:, 3], p[:, 2]]
    assert torch.equal(out[0], ck._pack_words(bits))


def _sad_inputs(dev, seed, K, batch=()):
    """Random atlases over the 8 level shapes, centres that reach past every
    border of their level, so each clamp is exercised."""
    g = torch.Generator().manual_seed(seed)
    hs = torch.tensor([s[0] for s in SHAPES])
    ws = torch.tensor([s[1] for s in SHAPES])
    HA, W0 = int(hs.sum()), int(ws[0])
    atlases = [(torch.rand((*batch, HA, W0), generator=g) * 255).to(dev) for _ in range(2)]
    lvl = torch.randint(0, 8, (*batch, K), generator=g)
    rnd = lambda lo, hi: (lo + (torch.rand((*batch, K), generator=g) * (hi - lo)).floor()).to(torch.int32)
    cv, cu, cur = rnd(-8, hs[lvl] + 8), rnd(-8, ws[lvl] + 8), rnd(-12, ws[lvl] + 12)
    i32 = lambda t: t.to(torch.int32).to(dev)
    off = torch.cumsum(hs, 0) - hs
    return (*atlases, i32(cv), i32(cu), i32(cur), i32(lvl), i32(off), i32(hs), i32(ws))


@pytest.mark.parametrize("seed", range(4))
def test_sad_stereo_kernel(dev, seed):
    """121 float32 terms summed in another order than the plain version's:
    1e-2 on sums of order 1e4, the best of the 11 shifts the same on 99.9%."""
    args = _sad_inputs(dev, seed, K=1200)
    before = ck.sad_stereo.launches
    out = ck.sad_stereo(*args)
    assert ck.sad_stereo.launches == before + 1
    torch.cuda.synchronize()
    plain = ck.sad_stereo_plain(*args)
    assert out.shape == (1200, 11) and out.dtype == torch.float32
    assert float((out - plain).abs().max()) <= 1e-2
    assert float((out.argmin(1) == plain.argmin(1)).float().mean()) >= 0.999
    assert torch.equal(out, ck.sad_stereo(*args))  # fixed reduction order
    assert ck.sad_stereo.launches == before + 2


def _sad_inputs_numpy(dev, seed, K=1200):
    """As ``_sad_inputs``, from numpy's generator (the same values on every
    installation)."""
    rng = np.random.default_rng(seed)
    hs, ws = (np.array([s[i] for s in SHAPES]) for i in (0, 1))
    atlases = [rng.uniform(0, 255, (int(hs.sum()), int(ws[0]))).astype(np.float32) for _ in range(2)]
    lvl = rng.integers(0, 8, K)
    cv, cu, cur = (rng.integers(-m, n[lvl] + m) for m, n in ((8, hs), (8, ws), (12, ws)))
    off = np.cumsum(hs) - hs
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in atlases) + tuple(
        torch.from_numpy(a.astype(np.int32)).to(dev) for a in (cv, cu, cur, lvl, off, hs, ws))


@pytest.mark.parametrize("seed", range(4))
def test_sad_stereo_kernel_keeps_the_block_per_keypoint_kernel_sums(dev, seed):
    """A warp per keypoint adds each sum's 121 terms in the order the
    earlier kernel (a block per keypoint, a warp per shift) did: the digests
    in the fixture were taken from that kernel's output on these inputs, on
    an H100."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "sad_stereo_sums.json")
    with open(path) as f:
        want = json.load(f)["sha256"][str(seed)]
    out = ck.sad_stereo(*_sad_inputs_numpy(dev, seed))
    torch.cuda.synchronize()
    assert hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest() == want


def test_sad_stereo_kernel_batched(dev):
    args = _sad_inputs(dev, 9, K=200, batch=(3,))
    out = ck.sad_stereo(*args)
    torch.cuda.synchronize()
    assert out.shape == (3, 200, 11)
    assert float((out - ck.sad_stereo_plain(*args)).abs().max()) <= 1e-2
    for b in range(3):
        one = ck.sad_stereo(*(a[b].contiguous() for a in args[:6]), *args[6:])
        assert torch.equal(out[b], one)


def test_match_stereo_on_card_matches_cpu(dev):
    """The matcher on the card (kernel K4) against the matcher on the CPU
    (plain version) on the same features and pyramids of a rendered pair."""
    from orb_slam3_noted_tpu_torch.ops import stereo as S
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

    params, base = (458.654, 457.296, 367.215, 248.375), 0.11
    R, t = orbit_trajectory(48, forward=0.03, yaw0=0.45)[0]
    left, right, _ = stereo_pair(BoxRoom(seed=0), R, t, params, 752, 480, base)
    pyrs = [tuple(image_ops.build_pyramid(torch.as_tensor(x.astype(np.uint8), dtype=torch.float32).to(dev)))
            for x in (left, right)]
    fl, fr = (O.extract_from_pyramid(p) for p in pyrs)
    kw = dict(bf=base * params[0], baseline=base)
    before = ck.sad_stereo.launches
    on_card = S.to_numpy(S.match_stereo(fl, fr, pyrs[0], pyrs[1], **kw))
    assert ck.sad_stereo.launches == before + 1
    cpu = lambda tup: type(tup)(*(x.cpu() for x in tup)) if hasattr(tup, "_fields") else tuple(x.cpu() for x in tup)
    on_cpu = S.to_numpy(S.match_stereo(cpu(fl), cpu(fr), cpu(pyrs[0]), cpu(pyrs[1]), **kw))
    assert ck.sad_stereo.launches == before + 1
    assert on_cpu["valid"].sum() > 600
    assert (on_card["valid"] == on_cpu["valid"]).mean() >= 0.99
    both = on_card["valid"] & on_cpu["valid"]
    np.testing.assert_allclose(on_card["u_right"][both], on_cpu["u_right"][both], rtol=0, atol=1e-3)


def test_batched_kernels(dev):
    imgs = torch.stack([_image(SHAPES[3], dev, s) for s in range(3)])
    assert torch.equal(ck.fast_score(imgs), ck.fast_score_plain(imgs))
    assert torch.equal(ck.gaussian_blur7(imgs), ck.gaussian_blur7_plain(imgs))
    sizes = (SHAPES[3],)
    xy, ang, lvl = _keypoints(dev, 0, sizes, 50, (3,))
    assert torch.equal(ck.brief_sample(imgs, sizes, xy, ang, lvl),
                       ck.brief_sample_atlas_plain(imgs, sizes, xy, ang, lvl))


def test_extract_orb_on_card_matches_cpu(dev):
    img = np.asarray(_image(SHAPES[0], torch.device("cpu"), 3))
    ck.reset_launch_counts()
    ft = O.to_numpy(O.extract_orb(torch.from_numpy(img).to(dev)))
    assert ck.launch_counts() == {"fast_candidates": 1, "gaussian_blur7": 1, "brief_sample": 1,
                                  "sad_stereo": 0, "fast_score": 0}
    fc = O.to_numpy(O.extract_orb(torch.from_numpy(img)))
    np.testing.assert_array_equal(ft["valid"], fc["valid"])
    assert np.mean(np.all(ft["desc"] == fc["desc"], axis=1)) >= 0.99


def test_stereo_pair_description_is_one_launch_each(dev):
    """The stereo facade's order on the card: K1, K2 and K3 once each over
    the atlas of the stacked pair; each image's features equal those of its
    own atlas.  The level-by-level detection (the dense K1 per level and
    image) followed by one description of the pair gives them too."""
    imgs = [_image(SHAPES[0], dev, s) for s in (5, 6)]
    pyrs = [tuple(image_ops.build_pyramid(im)) for im in imgs]
    atlases = [image_ops.build_atlas(p) for p in pyrs]
    ck.reset_launch_counts()
    pair = O.extract_from_atlas(image_ops.stack_atlases(atlases))
    assert ck.launch_counts() == {"fast_candidates": 1, "gaussian_blur7": 1, "brief_sample": 1,
                                  "sad_stereo": 0, "fast_score": 0}
    ck.reset_launch_counts()
    dets = [O.detect_from_pyramid(p) for p in pyrs]
    by_level = O.describe(image_ops.stack_atlases(atlases),
                          O.Detections(*(torch.stack(f) for f in zip(*dets))))
    assert ck.launch_counts() == {"fast_candidates": 0, "gaussian_blur7": 1, "brief_sample": 1,
                                  "sad_stereo": 0, "fast_score": 16}
    for b, atlas in enumerate(atlases):
        single = O.extract_from_atlas(atlas)
        for name, x, y, z in zip(single._fields, pair, single, by_level):
            assert torch.equal(x[b], y), name
            if name in ("angle", "desc"):  # prefix sums over a level's rows or the atlas's
                continue
            assert torch.equal(z[b], y), name
        assert float((by_level.angle[b] - single.angle).abs().max()) <= 1e-3
        assert float((by_level.desc[b] == single.desc).all(dim=-1).float().mean()) >= 0.98


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(TypeError):
        ck.fast_score(torch.zeros(64, 64, dtype=torch.float64, device=dev))
    level = torch.zeros(64, 64, device=dev)
    with pytest.raises(ValueError):  # the ring and the peak test reach 4 pixels
        ck.fast_candidates(level, ((64, 64),), (50,), border=3)
    with pytest.raises(ValueError):  # a level with no pixel inside its border
        ck.fast_candidates(level, ((64, 64),), (50,), border=32)
    with pytest.raises(ValueError):  # a budget per level
        ck.fast_candidates(level, ((64, 64),), (50, 40))
    with pytest.raises(ValueError):  # the levels do not fill the rows
        ck.fast_candidates(level, ((48, 64),), (50,))
    with pytest.raises(TypeError):
        ck.fast_candidates(level.double(), ((64, 64),), (50,))
    with pytest.raises(ValueError):
        ck.fast_candidates(torch.zeros(64, 128, device=dev)[:, ::2], ((64, 64),), (50,))
    cand_s, cand_i = ck.fast_candidates(level, ((64, 64),), (0,))  # nothing asked for
    assert cand_s.shape == cand_i.shape == (0, 0)
    with pytest.raises(ValueError):
        ck.gaussian_blur7(torch.zeros(64, 128, device=dev)[:, ::2])
    img = torch.zeros(64, 64, device=dev)
    with pytest.raises(ValueError):  # reflect-101 over 3 px needs 4
        ck.gaussian_blur7(torch.zeros(3, 64, device=dev))
    with pytest.raises(ValueError):  # the levels do not fill the image's rows
        ck.gaussian_blur7(img, ((32, 64), (16, 32)))
    with pytest.raises(ValueError):  # a level wider than the image
        ck.gaussian_blur7(img, ((32, 64), (32, 65)))
    with pytest.raises(ValueError):  # more levels than the kernels' tables hold
        ck.gaussian_blur7(torch.zeros(68, 64, device=dev), ((4, 64),) * 17)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    one = ((64, 64),)
    with pytest.raises(TypeError):  # float coordinates
        ck.brief_sample(img, one, torch.zeros(4, 2, device=dev), torch.zeros(4, device=dev), i32(4))
    with pytest.raises(TypeError):  # float64 angles
        ck.brief_sample(img, one, i32(4, 2), torch.zeros(4, dtype=torch.float64, device=dev), i32(4))
    with pytest.raises(ValueError):  # (gy, gx) tables are no longer an input
        ck.brief_sample(img, one, i32(4, 512), torch.zeros(4, device=dev), i32(4))
    with pytest.raises(ValueError):  # one level short
        ck.brief_sample(img, one, i32(4, 2), torch.zeros(4, device=dev), i32(3))
    with pytest.raises(ValueError):  # keypoints on another device
        ck.brief_sample(img, one, i32(4, 2).cpu(), torch.zeros(4, device=dev), i32(4))
    with pytest.raises(ValueError):  # level sizes of another atlas
        ck.brief_sample(img, ((32, 64),), i32(4, 2), torch.zeros(4, device=dev), i32(4))
    args = list(_sad_inputs(dev, 0, K=16))
    with pytest.raises(TypeError):
        ck.sad_stereo(*args[:2], args[2].long(), *args[3:])
    with pytest.raises(ValueError):
        ck.sad_stereo(args[0], args[1][:-1], *args[2:])
    with pytest.raises(ValueError):  # an atlas on another device
        ck.sad_stereo(args[0], args[1].cpu(), *args[2:])


def _rendered_pairs(n):
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

    params, base = (458.654, 457.296, 367.215, 248.375), 0.11
    room = BoxRoom(seed=0)
    pairs = [stereo_pair(room, R, t, params, 752, 480, base)[:2]
             for R, t in orbit_trajectory(48, forward=0.03, yaw0=0.45)[:n]]
    return [(a.astype(np.uint8), b.astype(np.uint8)) for a, b in pairs], params, base


def test_stereo_front_end_batch_is_one_launch_each(dev):
    """B pairs through the batched front end: K1, K2 and K3 once over the 2B
    images, K4 once over the B pairs; each pair gets the features it gets
    alone on the card, and its stereo rows to the limits of
    ``test_match_stereo_on_card_matches_cpu`` (the pyramid's resize products
    of 2B images and of 2 need not round alike on the card, and the SAD
    sums follow their last bits)."""
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu_torch.ops import stereo as S
    from orb_slam3_noted_tpu_torch.pipeline import tracking as T

    pairs, params, base = _rendered_pairs(4)
    cfg = SlamConfig(camera=Camera(PINHOLE, params), bf=base * params[0])
    L = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    R = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    ck.reset_launch_counts()
    feats, uvr, depth = T.stereo_frontend_batch(torch.cat([L, R]), cfg.camera, cfg, cfg.bf)
    assert ck.launch_counts() == {"fast_candidates": 1, "gaussian_blur7": 1, "brief_sample": 1,
                                  "sad_stereo": 1, "fast_score": 0}
    for b in range(4):
        pyr = tuple(image_ops.build_pyramid(torch.stack([L[b], R[b]]).to(torch.float32)))
        both = O.extract_from_pyramid(pyr)
        fl, fr = (O.FrameFeatures(*(f[i] for f in both)) for i in range(2))
        sm = S.match_stereo(fl, fr, tuple(p[0] for p in pyr), tuple(p[1] for p in pyr),
                            bf=cfg.bf, baseline=base)
        assert torch.equal(fl.desc, feats.desc[b]) and torch.equal(fl.xy, feats.xy[b])
        valid = uvr[b] >= 0
        assert (valid == sm.valid).float().mean() >= 0.99 and int(sm.valid.sum()) > 600
        both = valid & sm.valid
        assert float((uvr[b][both] - sm.u_right[both]).abs().max()) <= 1e-3


def test_two_view_reconstruction_on_card_matches_cpu(dev):
    """The two-view solver with the same minimal sets on the card (cuSOLVER
    eigenproblems and SVDs, whose vector signs may differ) and on the CPU."""
    from orb_slam3_noted_tpu_torch.geometry import twoview as TV

    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, size=(3, 400, 3)) + np.array([0, 0, 5.0])
    c, s = np.cos(0.08), np.sin(0.08)
    R21 = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    p2 = pts @ R21.T + np.array([-0.35, 0.04, 0.06])
    r1 = pts / pts[..., 2:3]
    r2 = p2 / p2[..., 2:3]
    r2[..., :2] += rng.normal(0, 5e-4, size=r2[..., :2].shape)
    r1, r2 = (torch.from_numpy(x.astype(np.float32)) for x in (r1, r2))
    valid = torch.ones(3, 400, dtype=torch.bool)
    valid[1, 50:] = False
    sets = TV.sample_minimal_sets(valid, 256, torch.Generator().manual_seed(0))
    cpu = TV.reconstruct_two_views(r1, r2, valid, sets)
    card = TV.reconstruct_two_views(r1.to(dev), r2.to(dev), valid.to(dev), sets.to(dev))
    assert torch.equal(card.success.cpu(), cpu.success) and bool(cpu.success[0])
    torch.testing.assert_close(card.R21.cpu(), cpu.R21, atol=1e-4, rtol=0)
    torch.testing.assert_close(card.t21.cpu(), cpu.t21, atol=1e-4, rtol=0)
    assert (card.is_inlier.cpu() == cpu.is_inlier).float().mean() >= 0.99
    # the draw itself on the card's generator: 8 distinct valid entries each
    g = torch.Generator(device=dev).manual_seed(1)
    idx = TV.sample_minimal_sets(valid.to(dev), 256, g)
    assert idx.device.type == "cuda" and idx.shape == (3, 256, 8)
    assert bool(torch.gather(valid.to(dev), 1, idx.reshape(3, -1)).all())
    assert bool((idx.sort(dim=-1).values.diff(dim=-1) > 0).all())


def test_place_recognition_counts_above_256_on_card(dev):
    """Covisibility and common-word counts are float32 products of 0/1
    matrices: exact above 256 on the card too (TF32 off; a bf16 product
    would round 399 to 400 and 1101 to 1104)."""
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
    from orb_slam3_noted_tpu_torch.place import database as D

    m = MS.empty_map(SlamConfig(max_keyframes=8, max_map_points=2048), device=dev)
    obs = torch.zeros(m.obs_mat.shape, dtype=torch.bool, device=dev)
    obs[0, :1201] = True
    obs[1, :301] = True
    obs[2, 100:1299] = True
    cv = MS.covisibility_matrix(m._replace(obs_mat=obs, kf_valid=torch.arange(8, device=dev) < 3))
    assert cv.device.type == "cuda"
    assert (cv[0, 1], cv[0, 2], cv[1, 2]) == (301, 1101, 201) and float(cv.diagonal().abs().sum()) == 0
    W = 2048
    q = torch.zeros(W, device=dev)
    q[:500] = 1.0 / 500
    bow = torch.zeros(4, W, device=dev)
    for k, n in enumerate((500, 400, 399, 10)):
        bow[k, :n] = 1.0
        bow[k, 1500:1500 + (500 - n)] = 1.0
    bow = bow / bow.sum(-1, keepdim=True)
    slots, _ = D._detect_nbest(bow, torch.ones(4, dtype=torch.bool, device=dev), q,
                               torch.zeros(4, dtype=torch.bool, device=dev),
                               torch.zeros(4, 4, device=dev), 0.75, 3)
    assert sorted(s for s in slots.cpu().tolist() if s >= 0) == [0, 1]


def test_vocabulary_and_database_on_card_match_cpu(dev):
    """The 32k-word transform of 1200 descriptors (words and distances
    equal), their BoW vector (1e-6) and a database query (the same slots)
    on the card and on the CPU."""
    from orb_slam3_noted_tpu_torch.place.database import KeyFrameDatabase
    from orb_slam3_noted_tpu_torch.place.pretrained import load_default_vocabulary

    vocab, idf = load_default_vocabulary()
    assert vocab is not None, "the shipped vocabulary is missing"
    rng = np.random.default_rng(0)
    dbs = [KeyFrameDatabase(vocab, 16, idf=idf, device=d) for d in (torch.device("cpu"), dev)]
    scenes = [rng.integers(0, 2**32, size=(1200, 8), dtype=np.uint32).view(np.int32)
              for _ in range(6)]
    valid = torch.from_numpy(rng.uniform(size=1200) < 0.95)
    for s, d in enumerate(scenes):
        (wc, bc), (wg, bg) = (db.compute_bow(torch.from_numpy(d).to(db.device),
                                             valid.to(db.device)) for db in dbs)
        assert torch.equal(wg.cpu(), wc)
        torch.testing.assert_close(bg.cpu(), bc, atol=1e-6, rtol=0)
        for db, b in zip(dbs, (bc, bg)):
            db.add(s, b)
    q = torch.from_numpy(scenes[3].copy())
    q[:300] = torch.from_numpy(rng.integers(0, 2**31, size=(300, 8), dtype=np.int32))
    got = [db.detect_candidates(db.compute_bow(q.to(db.device), valid.to(db.device))[1],
                                np.zeros(16, bool), n_best=3) for db in dbs]
    assert got[1][0] == got[0][0] and got[0][0][0] == 3
    np.testing.assert_allclose(got[1][1], got[0][1], atol=1e-5)


def test_pnp_on_card_matches_cpu(dev):
    """PnP RANSAC on the same minimal sets on the card (cuSOLVER SVDs, whose
    null-vector signs may differ from LAPACK's) and on the CPU: the same
    verdict, inlier counts within 1, the pose within 1e-3."""
    from orb_slam3_noted_tpu_torch.optim import pnp as P

    rng = np.random.default_rng(0)
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t = np.array([0.4, -0.2, 0.6], np.float32)
    Xw = (rng.uniform(-2, 2, size=(400, 3)) + [0, 0, 5.0]).astype(np.float32)
    xc = Xw @ R.T + t
    rays = xc / xc[:, 2:3]
    rays[:, :2] += rng.normal(0, 2e-4, size=(400, 2))
    rays[:80, :2] = rng.uniform(-0.5, 0.5, size=(80, 2))
    valid = torch.from_numpy(np.arange(400) < 380)
    sets = torch.from_numpy(np.stack([rng.choice(380, 6, replace=False) for _ in range(P.N_HYP)]))
    args = [torch.from_numpy(Xw), torch.from_numpy(rays.astype(np.float32)), valid, sets]
    cpu = P.pnp_ransac(*args)
    card = P.pnp_ransac(*(a.to(dev) for a in args))
    assert bool(card.success.cpu()) == bool(cpu.success) is True
    assert abs(int(card.n_inliers) - int(cpu.n_inliers)) <= 1
    torch.testing.assert_close(card.Rcw.cpu(), cpu.Rcw, atol=1e-3, rtol=0)
    torch.testing.assert_close(card.tcw.cpu(), cpu.tcw, atol=1e-3, rtol=0)


def _scaffold():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "scripts"))
    import loop_scaffold

    return loop_scaffold


def _as_tensor(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32 else a))


def _loop_graph(K=30):
    """A keyframe circle with exact odometry edges, a loop edge and estimates
    integrated with noise and 1% scale creep a step (``tests/test_loop_opt.py``)."""
    from orb_slam3_noted_tpu_torch.geometry import sim3
    from orb_slam3_noted_tpu_torch.optim.pose_graph import Sim3Edges

    rng = np.random.default_rng(0)
    a = 2 * np.pi * np.arange(K) / K
    xi_wk = np.zeros((K, 7), np.float32)
    xi_wk[:, 4] = a
    Rw, _, _ = sim3.exp(torch.from_numpy(xi_wk))
    twk = torch.from_numpy(np.stack([2 * np.sin(a), 0 * a, 2 - 2 * np.cos(a)], 1).astype(np.float32))
    Rg = Rw.transpose(1, 2)
    tg = -torch.einsum("kij,kj->ki", Rg, twk)
    sg = torch.ones(K)
    i = torch.tensor(list(range(K - 1)) + [K - 1])
    j = torch.tensor(list(range(1, K)) + [0])
    eR, et, es = sim3.compose((Rg[j], tg[j], sg[j]), sim3.inverse((Rg[i], tg[i], sg[i])))
    edges = Sim3Edges(i=i.int(), j=j.int(), R=eR, t=et, s=es, weight=torch.ones(K),
                      valid=torch.ones(K, dtype=torch.bool))
    R, t, s = [Rg[0]], [tg[0]], [torch.ones(())]
    for k in range(K - 1):
        noise = sim3.exp(torch.from_numpy(np.concatenate(
            [rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3), [0.01]]).astype(np.float32)))
        Sn = sim3.compose(noise, sim3.compose((eR[k], et[k], es[k]), (R[-1], t[-1], s[-1])))
        R.append(Sn[0])
        t.append(Sn[1])
        s.append(Sn[2])
    return edges, (torch.stack(R), torch.stack(t), torch.stack(s))


def test_pose_graph_on_card_matches_cpu(dev):
    """The Sim(3) pose graph on the card and on the CPU: poses within 1e-4
    (rotation entries, scale) and 1e-3 m; two runs on the card bit for bit
    the same (its normal equations are one-hot products, in a fixed order)."""
    from orb_slam3_noted_tpu_torch.optim.pose_graph import optimize_pose_graph_sim3

    edges, est = _loop_graph()
    fixed = torch.zeros(len(est[0]), dtype=torch.bool)
    fixed[0] = True
    cpu = optimize_pose_graph_sim3(*est, edges, fixed)
    to = lambda x: type(x)(*(f.to(dev) for f in x)) if isinstance(x, tuple) and hasattr(
        x, "_fields") else tuple(f.to(dev) for f in x)
    card = [optimize_pose_graph_sim3(*to(est), to(edges), fixed.to(dev)) for _ in range(2)]
    for a, b, tol in zip(card[0][:3], cpu[:3], (1e-4, 1e-3, 1e-4)):
        torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=0)
    for a, b in zip(card[0], card[1]):
        assert torch.equal(a, b)
    assert float(card[0][3]) < 1e-3


def test_gba_step_on_card_matches_cpu(dev):
    """One LM step of the matrix-free GBA (48 PCG iterations) on a stereo
    map, on the card and on the CPU: poses and points within 1e-4 (m).  Its
    sums run in a fixed order (pose side one-hot products, landmark side
    segment sums over the observations sorted by point), so five runs on the
    card give the same step bit for bit (with ``index_add_``'s atomics they
    spread by 7e-6 m to 1.2e-5 m on an H100).  Prints the spread."""
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu_torch.optim import gba
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS

    LS = _scaffold()
    inp = LS.stereo_map_inputs(K=8, M=600)
    cfg = SlamConfig(camera=Camera(PINHOLE, LS.PIN), width=752, height=480, n_features=600,
                     max_keyframes=10, max_map_points=1024, bf=inp["bf"])
    m = LS.build_stereo_map(MS, MS.empty_map(cfg, device=torch.device("cpu")), inp, _as_tensor)

    def step(mm):
        prob = gba.full_map_problem(mm, cfg)
        lam = torch.tensor(1e-4, device=mm.mp_pos.device)
        return gba.gba_step(cfg.camera, prob.Rcw, prob.tcw, prob.points, prob.obs, prob,
                            prob.obs.valid, True, lam, bf=cfg.bf, cg_iters=48)

    cpu = step(m)
    m_dev = MS.MapArrays(*(f.to(dev) for f in m))
    runs = [step(m_dev) for _ in range(5)]
    spread_pts = max(float((r[2] - runs[0][2]).abs().max()) for r in runs)
    spread_pose = max(float((r[1] - runs[0][1]).abs().max()) for r in runs)
    vs_cpu = [float((a.cpu() - b).abs().max()) for a, b in zip(runs[0][:3], cpu[:3])]
    print(f"GBA step, 5 runs on the card: landmark spread {spread_pts:.3g} m, pose spread "
          f"{spread_pose:.3g} m; card vs CPU max |diff| R {vs_cpu[0]:.3g}, t {vs_cpu[1]:.3g} m, "
          f"points {vs_cpu[2]:.3g} m; cost {float(runs[0][4]):.6g} (CPU {float(cpu[4]):.6g})")
    assert max(vs_cpu) <= 1e-4, vs_cpu
    assert spread_pts == 0.0 and spread_pose == 0.0


def test_sim3_refine_on_card_matches_cpu(dev):
    """The verification ladder on the full-width drifted map (1200 features a
    keyframe, the tail 0.3/-0.1/0.2 m from keyframe 0): pairs, RANSAC on the
    same minimal sets, ``sim3_refine``, on the card and on the CPU: R and s
    within 1e-4, t within 1e-3 m, inliers within 1."""
    from orb_slam3_noted_tpu_torch.geometry.sim3_solver import sim3_ransac
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu_torch.optim.sim3_opt import sim3_refine
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
    from orb_slam3_noted_tpu_torch.pipeline.loop_closing import LoopCloser, _matched_point_pairs

    LS = _scaffold()
    full = LS.FULL
    inp = LS.drifted_map_inputs(seed=0, baseline=LS.BASELINE, **full)
    cfg = SlamConfig(camera=Camera(PINHOLE, full["cam"]), width=full["width"],
                     height=full["height"], n_features=full["n_pts"],
                     max_keyframes=full["max_keyframes"], max_map_points=full["max_map_points"])
    tail = inp["n_kf"] - 1
    cpu_dev = torch.device("cpu")
    vocab = np.random.default_rng(0).integers(0, 2 ** 32, size=(64, 8), dtype=np.uint32)
    sets = LoopCloser(vocab, 4, device=cpu_dev)._sim3_sets(
        _matched_point_pairs(LS.build_map(MS, MS.empty_map(cfg, device=cpu_dev), inp,
                                          _as_tensor), tail, 0)[2], tail)
    out = []
    for d in (cpu_dev, dev):
        m = LS.build_map(MS, MS.empty_map(cfg, device=d), inp, lambda a: _as_tensor(a).to(d))
        x_cand, x_cur, ok, idx = _matched_point_pairs(m, tail, 0)
        res = sim3_ransac(x_cand, x_cur, ok, sets.to(d))
        ref = sim3_refine(m, tail, 0, res.R, res.t, res.s, cfg.camera, cfg, seed_idx=idx,
                          seed_ok=ok & res.inliers)
        out.append((res, ref))
    (rc, fc), (rg, fg) = out
    assert int(rc.n_inliers) == int(rg.n_inliers.cpu()) == full["n_pts"]
    for a, b, tol in ((fg.R, fc.R, 1e-4), (fg.s, fc.s, 1e-4), (fg.t, fc.t, 1e-3)):
        torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=0)
    assert abs(int(fg.n_inliers.cpu()) - int(fc.n_inliers)) <= 1
    assert abs(float(fc.s) - LS.DRIFT_SCALE) < 1e-3


def _vi_dispatch(d):
    """One visual-inertial tracking dispatch (``vi_track_batch``) on device
    ``d``: the stereo scaffold map of ``scripts/loop_scaffold.py`` (6
    keyframes, 120 points, every keyframe sees every point), keyframe 0 the
    anchor at rest, two frames seeing keyframe 0's view with IMU spans of 0.1
    s at rest and 0.2 s under a small push (the prediction drifts off, the
    pose optimisation pulls it back)."""
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
    from orb_slam3_noted_tpu_torch.pipeline.inertial_system import vi_track_batch

    LS = _scaffold()
    inp = LS.stereo_map_inputs(K=6, M=120)
    M = inp["M"]
    cfg = SlamConfig(camera=Camera(PINHOLE, LS.PIN), width=752, height=480, n_features=M,
                     max_keyframes=8, max_map_points=256, bf=inp["bf"], local_window=5)
    m = LS.build_stereo_map(MS, MS.empty_map(cfg, device=d), inp, lambda a: _as_tensor(a).to(d))
    m = MS.update_point_stats(m, m.mp_valid, n_levels=cfg.n_levels,
                              scale_factor=cfg.scale_factor)
    R0 = torch.from_numpy(inp["R"][0]).to(d)
    g_body = R0 @ torch.tensor([0.0, 0.0, 9.81], device=d)  # Rbw g: the reaction at rest
    B, N = 2, 41
    acc = g_body.expand(B, N, 3).clone()
    acc[1, :, 0] += 0.5
    gyr = torch.zeros(B, N, 3, device=d)
    dts = torch.full((B, N), 0.005, device=d)
    dts[0, 20:] = 0.0
    lvl = torch.from_numpy(inp["level"][0]).to(d)
    feats = O.FrameFeatures(
        xy=torch.from_numpy(inp["uv"][0]).to(d).expand(B, M, 2),
        level=lvl.expand(B, M), angle=torch.zeros(B, M, device=d),
        response=torch.ones(B, M, device=d), desc=_as_tensor(inp["desc"]).to(d).expand(B, M, 8),
        valid=torch.ones(B, M, dtype=torch.bool, device=d))
    uvr = torch.from_numpy(inp["uvr"][0]).to(d).expand(B, M)
    z = torch.zeros(3, device=d)
    calib = cfg.imu_calib(device=d)
    return vi_track_batch(m, feats, uvr, 0, z, z, z, acc, gyr, dts, N, calib, cfg.camera, cfg,
                          cfg.bf, torch.ones(B, dtype=torch.bool, device=d))


def test_vi_dispatch_on_card_matches_cpu(dev):
    """A visual-inertial tracking dispatch (preintegration of the batch's
    spans, prediction, local-map matching, visual-inertial pose
    optimisation) on the card and on the CPU: poses and velocities within
    1e-4, the same inliers, bindings and counters."""
    cpu = _vi_dispatch(torch.device("cpu"))
    card = _vi_dispatch(dev)
    m_c, m_g = cpu[0], card[0]
    for a, b in zip(card[1:3] + card[5:6], cpu[1:3] + cpu[5:6]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    assert torch.equal(card[3].cpu(), cpu[3]) and int(cpu[3].min()) >= 40
    assert torch.equal(card[4].cpu(), cpu[4])
    assert torch.equal(m_g.mp_found.cpu(), m_c.mp_found)
    assert torch.equal(m_g.mp_visible.cpu(), m_c.mp_visible)


def test_kb8_camera_on_card_matches_cpu(dev):
    """The Kannala-Brandt projection, its Jacobian and the Newton
    unprojection on the card against the CPU: points 0 to 100 deg off the
    axis and every pixel of a 512x512 image (TUM_512's left camera).  Below
    80 deg the z = 1 rays within 1e-5 relative; the corners, where rd is
    clipped to pi/2, by their unit bearings."""
    from orb_slam3_noted_tpu_torch.models import cameras as C

    cam = C.Camera(C.KANNALA_BRANDT8, (190.97847715128717, 190.9733070521226, 254.93170605935475,
                                       256.8974428996504, 0.0034823894022493434,
                                       0.0007150348452162257, -0.0020532361418706202,
                                       0.00020293673591811182))
    rng = np.random.default_rng(0)
    th, ph = rng.uniform(0, np.deg2rad(100), 500), rng.uniform(-np.pi, np.pi, 500)
    x = torch.from_numpy((np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)],
                                   1) * rng.uniform(0.5, 5, (500, 1))).astype(np.float32))
    torch.testing.assert_close(C.project(cam, x.to(dev)).cpu(), C.project(cam, x), atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(C.project_jac(cam, x.to(dev)).cpu(), C.project_jac(cam, x),
                               atol=1e-2, rtol=1e-5)
    uu, vv = np.meshgrid(np.arange(512), np.arange(512))
    uv = torch.from_numpy(np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32))
    rc, rg = C.unproject(cam, uv).double(), C.unproject(cam, uv.to(dev)).cpu().double()
    inner = torch.atan(torch.linalg.vector_norm(rc[:, :2], dim=1)) < np.deg2rad(80.0)
    rel = (rg - rc).abs().amax(1) / rc.abs().amax(1)
    assert float(rel[inner].max()) <= 1e-5
    unit = lambda r: r / torch.linalg.vector_norm(r, dim=1, keepdim=True)
    assert float((unit(rg) - unit(rc)).abs().max()) <= 1e-3


def test_fisheye_stereo_on_card_matches_cpu(dev):
    """``match_fisheye_stereo`` on the card against the CPU on the same
    features of a rendered 512x512 fisheye pair (the right camera rotated
    against the left): the same verdict for >= 99% of the left features
    (the card's and the CPU's float32 ``tan`` and ``atan2`` differ in last
    bits, which moves a pair across a gate), the same right feature where
    both match, depths within 5e-3 relative there and 5e-4 at the median
    (the DLT's squared system amplifies last bits by the inverse parallax;
    measured 2.3e-3 at most on an H100)."""
    from orb_slam3_noted_tpu_torch.geometry import so3
    from orb_slam3_noted_tpu_torch.models import cameras as C
    from orb_slam3_noted_tpu_torch.ops.fisheye_stereo import match_fisheye_stereo
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom

    cam = C.Camera(C.KANNALA_BRANDT8, (190.97847715128717, 190.9733070521226,
                                       254.93170605935475, 256.8974428996504,
                                       0.0034823894022493434, 0.0007150348452162257,
                                       -0.0020532361418706202, 0.00020293673591811182))
    cam2 = C.Camera(C.KANNALA_BRANDT8, (190.44236969414825, 190.4344384721956,
                                        252.59949716835982, 254.91723064636983,
                                        0.0034003170790442797, 0.001766278153469831,
                                        -0.00266312569781606, 0.0003299517423931039))
    Rlr = so3.exp(torch.tensor([0.003, -0.005, 0.002]))
    tlr = torch.tensor([0.101, 0.0, 0.0])
    room = BoxRoom(seed=5, depth=2.5, h=0.9, w=1.4)
    left = room.render_fisheye(np.eye(3), np.zeros(3), cam, 512, 512)
    right = room.render_fisheye(Rlr.double().numpy(), tlr.double().numpy(), cam2, 512, 512)
    pair = torch.from_numpy(np.stack([left, right]).astype(np.uint8)).to(dev, torch.float32)
    both = O.extract_from_atlas(image_ops.build_atlas(tuple(image_ops.build_pyramid(pair))),
                                n_features=1500)
    fl, fr = (O.FrameFeatures(*(f[i] for f in both)) for i in range(2))
    sig = tuple(1.2 ** (2 * i) for i in range(8))
    on_card = match_fisheye_stereo(fl, fr, cam, cam2, Rlr.to(dev), tlr.to(dev),
                                   lap_l=(0.0, 512.0), lap_r=(0.0, 512.0), level_sigma2=sig)
    cpu = lambda f: O.FrameFeatures(*(x.cpu() for x in f))
    on_cpu = match_fisheye_stereo(cpu(fl), cpu(fr), cam, cam2, Rlr, tlr, lap_l=(0.0, 512.0),
                                  lap_r=(0.0, 512.0), level_sigma2=sig)
    assert int(on_cpu.valid.sum()) > 300
    assert float((on_card.valid.cpu() == on_cpu.valid).float().mean()) >= 0.99
    v = on_cpu.valid & on_card.valid.cpu()
    assert torch.equal(on_card.idx_r.cpu()[v], on_cpu.idx_r[v])
    rel = (on_card.depth.cpu()[v] / on_cpu.depth[v] - 1).abs()
    assert float(rel.max()) <= 5e-3 and float(rel.median()) <= 5e-4


def _atlas_maps(seed, KF=8, NF=96, MP=320):
    """Two maps on the CPU (the port's ``MapArrays``): random keyframes that
    see random subsets of the same points, the new map's descriptors with a
    few flipped bits and its points moved by a similarity."""
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS

    rng = np.random.default_rng(seed)
    cfg = SlamConfig(n_features=NF, max_keyframes=KF, max_map_points=MP)
    pos = rng.uniform(-2, 2, (MP, 3)) + np.array([0, 0, 4.0])
    desc = rng.integers(0, 2 ** 32, (MP, 8), dtype=np.uint64).astype(np.uint32)

    def one(p):
        d = MS.to_numpy(MS.empty_map(cfg, device=torch.device("cpu")))
        d["kf_tcw"] = rng.normal(0, 0.3, (KF, 3)).astype(np.float32)
        d["kf_valid"][:] = True
        mp = np.stack([rng.permutation(MP)[:NF] for _ in range(KF)]).astype(np.int32)
        mp[rng.uniform(size=mp.shape) < 0.2] = -1
        flips = (rng.uniform(size=(KF, NF, 8, 32)) < 0.03).astype(np.uint32)
        d["kf_mp"], d["kf_feat_valid"] = mp, rng.uniform(size=(KF, NF)) > 0.1
        d["kf_desc"] = desc[np.maximum(mp, 0)] ^ (flips << np.arange(32, dtype=np.uint32)).sum(
            -1, dtype=np.uint32)
        d["kf_parent"] = np.array([-1] + list(rng.integers(-1, 3, KF - 1)), np.int32)
        d["mp_pos"], d["mp_valid"], d["mp_desc"] = p.astype(np.float32), rng.uniform(
            size=MP) > 0.1, desc
        d["mp_normal"] = rng.normal(size=(MP, 3)).astype(np.float32)
        d["obs_mat"] = rng.uniform(size=(KF, MP)) < 0.2
        return MS.from_numpy(d)

    return one(pos), one(1.3 * pos + 0.2)


def test_atlas_merge_on_card_matches_cpu(dev):
    """``_cross_map_pairs`` and ``merge_map_arrays`` on the card against the
    CPU: masks and integer fields exact, floats within 1e-5."""
    from orb_slam3_noted_tpu_torch.pipeline import atlas as A
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS

    old, new = _atlas_maps(0)
    on = lambda m: MS.MapArrays(*(x.to(dev) for x in m))  # noqa: E731
    for sn, so in ((0, 1), (3, 5), (7, 2)):
        c = A._cross_map_pairs(new, sn, old, so)
        g = A._cross_map_pairs(on(new), sn, on(old), so)
        assert torch.equal(g[2].cpu(), c[2]) and int(c[2].sum()) >= 3
        for a, b in zip(g[:2], c[:2]):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    R = torch.linalg.matrix_exp(torch.tensor([[0.0, -0.3, 0.1], [0.3, 0.0, -0.2],
                                              [-0.1, 0.2, 0.0]]))
    S = (R, torch.tensor([0.3, -0.1, 0.2]), torch.tensor(1.17))
    st_c = A.StoredMap(m=old, n_kf=4, n_mp=150, db=None, trajectory=[])
    st_g = A.StoredMap(m=on(old), n_kf=4, n_mp=150, db=None, trajectory=[])
    c = A.merge_map_arrays(st_c, new, 4, 160, S)
    g = A.merge_map_arrays(st_g, on(new), 4, 160, tuple(x.to(dev) for x in S))
    assert g[1:] == c[1:] == (4, 8, 310)
    for name, a, b in zip(MS.MapArrays._fields, g[0], c[0]):
        if b.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5, msg=name)
        else:
            assert torch.equal(a.cpu(), b), name
    assert A.merge_map_arrays(st_g, on(new), 5, 10, S) is None
