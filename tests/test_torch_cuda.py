"""CUDA kernels K1-K4 against their plain PyTorch versions, on the card.

Marked ``cuda``: every test here skips where ``torch.cuda.is_available()``
is false (decided inside the fixture, so every worker collects the same
tests).  On a machine with an NVIDIA GPU (``sm_90a``) and ``nvcc``:

    python -m pytest tests/test_torch_cuda.py -q
"""

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


@pytest.mark.parametrize("lvl", range(8))
def test_gaussian_blur7_kernel_exact(dev, lvl):
    img = image_ops.build_pyramid(_image(SHAPES[0], dev, 1))[lvl].contiguous()
    out = ck.gaussian_blur7(img)
    torch.cuda.synchronize()
    # __fmul_rn/__fadd_rn round each tap as the plain multiply and add do
    assert torch.equal(out, ck.gaussian_blur7_plain(img))


@pytest.mark.parametrize("lvl", range(8))
def test_brief_sample_kernel_exact(dev, lvl):
    img = _image(SHAPES[lvl], dev, 2)
    blur = ck.gaussian_blur7(img)
    kps = fast_ops.detect_level(ck.fast_score(img), n_out=BUDGETS[lvl])
    ang = O.ic_angles(img, kps.xy)
    gy, gx = O.brief_coords(img.shape[0], img.shape[1], kps.xy, ang)
    out = ck.brief_sample(blur, gy, gx)
    torch.cuda.synchronize()
    assert out.shape == (BUDGETS[lvl], 8) and out.dtype == torch.int32
    assert torch.equal(out, ck.brief_sample_plain(blur, gy, gx))


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
    g = torch.Generator().manual_seed(0)
    gy = torch.randint(0, SHAPES[3][0], (3, 50, 512), generator=g, dtype=torch.int32).to(dev)
    gx = torch.randint(0, SHAPES[3][1], (3, 50, 512), generator=g, dtype=torch.int32).to(dev)
    assert torch.equal(ck.brief_sample(imgs, gy, gx), ck.brief_sample_plain(imgs, gy, gx))


def test_extract_orb_on_card_matches_cpu(dev):
    img = np.asarray(_image(SHAPES[0], torch.device("cpu"), 3))
    ft = O.to_numpy(O.extract_orb(torch.from_numpy(img).to(dev)))
    fc = O.to_numpy(O.extract_orb(torch.from_numpy(img)))
    np.testing.assert_array_equal(ft["valid"], fc["valid"])
    assert np.mean(np.all(ft["desc"] == fc["desc"], axis=1)) >= 0.99


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(TypeError):
        ck.fast_score(torch.zeros(64, 64, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        ck.gaussian_blur7(torch.zeros(64, 128, device=dev)[:, ::2])
    img = torch.zeros(64, 64, device=dev)
    with pytest.raises(ValueError):
        ck.brief_sample(img, torch.zeros(4, 256, dtype=torch.int32, device=dev),
                        torch.zeros(4, 256, dtype=torch.int32, device=dev))
    args = list(_sad_inputs(dev, 0, K=16))
    with pytest.raises(TypeError):
        ck.sad_stereo(*args[:2], args[2].long(), *args[3:])
    with pytest.raises(ValueError):
        ck.sad_stereo(args[0], args[1][:-1], *args[2:])
