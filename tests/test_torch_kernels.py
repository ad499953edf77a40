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
    out = ck.brief_sample(torch.from_numpy(np.array(blur)), gy, gx)
    assert out.dtype == torch.int32 and out.shape == (BUDGETS[lvl], 8)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)
    # the port's own rotated coordinates: cos/sin differ from XLA's in the
    # last ulp, which can move a rounded sample; measured 100% equal here
    tgy, tgx = torb.brief_coords(lv.shape[0], lv.shape[1], torch.from_numpy(np.array(kps.xy)),
                                 torch.from_numpy(np.array(ang)))
    same = np.all((tgy.numpy() == seen["gy"]) & (tgx.numpy() == seen["gx"]), axis=1)
    assert same.mean() >= 0.99


def test_wrappers_run_plain_on_cpu_and_count_nothing(jax_levels):
    ck.reset_launch_counts()
    lv = torch.from_numpy(jax_levels[0])
    ck.fast_score(lv)
    blur = ck.gaussian_blur7(lv)
    zeros = torch.zeros((4, 512), dtype=torch.int32)
    ck.brief_sample(blur, zeros, zeros)
    torb.extract_orb(lv, n_features=300)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    sads = ck.sad_stereo(lv, blur, i32(20, 30), i32(40, 50), i32(35, 48), i32(0, 0),
                         i32(0), i32(lv.shape[0]), i32(lv.shape[1]))
    assert sads.shape == (2, 11)
    assert ck.launch_counts() == {"fast_score": 0, "gaussian_blur7": 0, "brief_sample": 0,
                                  "sad_stereo": 0}


def test_build_dir_is_gitignored():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = os.path.relpath(ck.BUILD_DIR, root).split(os.sep)[0]
    with open(os.path.join(root, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert rel in ignored
    assert ck.library_path().parent == ck.BUILD_DIR
    assert sorted(p.name for p in ck.CSRC.glob("*.cu")) == [
        "brief_sample.cu", "fast_score.cu", "gaussian_blur7.cu", "sad_stereo.cu"
    ]
