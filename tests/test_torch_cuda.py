"""CUDA kernels K1-K3 against their plain PyTorch versions, on the card.

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
