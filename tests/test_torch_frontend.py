"""Parity of the port's ORB extraction and matching with the JAX package.

``extract_orb`` end to end on a rendered 320x240 frame (keypoints, angles,
descriptors), the batched form, and the Hamming / projection-matching /
duplicate-resolution steps of tracking on shared inputs.  Inputs come from
numpy and reach both sides as the same float32 / int32 / uint32 arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.ops import matching as jm
from orb_slam3_noted_tpu.ops import orb as jorb
from orb_slam3_noted_tpu_torch.ops import matching as tm
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom

W, H, NF = 320, 240, 600


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
def frames():
    room = BoxRoom(seed=4)
    out = []
    for yaw in (0.0, 0.02):
        c, s = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        img = room.render(Rwc, np.array([0.05 * yaw, 0.0, 0.0]), (260.0, 260.0, 160.0, 120.0), W, H)
        out.append(img.astype(np.uint8).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def features(frames):
    """(JAX, port) feature dicts of frame 0, descriptors as uint32."""
    fj = jax.device_get(jorb.extract_orb(jnp.asarray(frames[0]), n_features=NF))._asdict()
    ft = torb.to_numpy(torb.extract_orb(torch.from_numpy(frames[0]), n_features=NF))
    return {k: np.asarray(v) for k, v in fj.items()}, ft


def test_extract_orb_fields(features):
    fj, ft = features
    assert set(fj) == set(ft)
    for k in fj:
        assert ft[k].shape == fj[k].shape and ft[k].dtype == fj[k].dtype, k
    np.testing.assert_array_equal(ft["level"], fj["level"])
    np.testing.assert_array_equal(ft["valid"], fj["valid"])
    assert fj["valid"].sum() > 500


def test_extract_orb_keypoints(features):
    """Selected keypoints agree: level-0 corners exactly, the others to the
    last ulp of the level->0 rescale (JAX fuses it into an FMA)."""
    fj, ft = features
    np.testing.assert_allclose(ft["xy"], fj["xy"], rtol=0, atol=1e-4)
    lvl0 = fj["level"] == 0
    np.testing.assert_array_equal(ft["xy"][lvl0], fj["xy"][lvl0])
    # FAST responses: exact at level 0 (integer image); resized levels carry
    # the pyramid's <=1e-3 resize difference
    np.testing.assert_array_equal(ft["response"][lvl0], fj["response"][lvl0])
    np.testing.assert_allclose(ft["response"], fj["response"], rtol=0, atol=2e-3)
    # IC angles from float32 prefix sums and atan2: last-ulp differences
    np.testing.assert_allclose(ft["angle"], fj["angle"], rtol=0, atol=1e-4)


def test_extract_orb_descriptors_bit_identical_on_shared_keypoints(features):
    fj, ft = features
    shared = np.all(np.abs(ft["xy"] - fj["xy"]) < 1e-4, axis=1) & (ft["level"] == fj["level"])
    assert shared.mean() == 1.0
    same = np.all(ft["desc"] == fj["desc"], axis=1)
    # an angle one ulp apart can round one rotated sample to the next pixel
    # (last-ulp IC angles); measured: every descriptor bit-identical here
    assert same[shared].mean() >= 0.99, same[shared].mean()
    assert ft["desc"].dtype == np.uint32


def test_extract_orb_batch_matches_single(frames):
    batch = torch.from_numpy(np.stack(frames))
    fb = torb.extract_orb_batch(batch, n_features=NF)
    assert fb.desc.shape == (2, NF, 8) and fb.desc.dtype == torch.int32
    for b in range(2):
        fs = torb.extract_orb(torch.from_numpy(frames[b]), n_features=NF)
        for name, x, y in zip(fs._fields, fb, fs):
            if name == "angle":  # batched prefix sums round in another order
                torch.testing.assert_close(x[b], y, rtol=0, atol=1e-6)
            else:
                assert torch.equal(x[b], y), name


def test_features_numpy_roundtrip(features):
    _, ft = features
    back = torb.to_numpy(torb.from_numpy(ft))
    for k in ft:
        np.testing.assert_array_equal(back[k], ft[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_hamming_matrix_exact(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, size=(37, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=(53, 8), dtype=np.uint32)
    b[:5] = a[:5]
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    out = tm.hamming_matrix(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(out.numpy(), ref)


def _projection_inputs(seed):
    """Query points scattered near frame features, descriptors sharing bits."""
    rng = np.random.default_rng(seed)
    nq, nf = 300, 200
    feat_xy = rng.uniform([0, 0], [W, H], size=(nf, 2)).astype(np.float32)
    feat_desc = rng.integers(0, 2 ** 32, size=(nf, 8), dtype=np.uint32)
    src = rng.integers(0, nf, size=nq)
    uv = (feat_xy[src] + rng.normal(0, 4, size=(nq, 2))).astype(np.float32)
    flips = rng.integers(0, 2 ** 32, size=(nq, 8), dtype=np.uint32) & rng.integers(
        0, 2 ** 32, size=(nq, 8), dtype=np.uint32) & rng.integers(0, 2 ** 32, size=(nq, 8), dtype=np.uint32)
    return dict(
        uv_pred=uv,
        radius=rng.uniform(5, 20, size=nq).astype(np.float32),
        level_pred=rng.integers(0, 8, size=nq).astype(np.int32),
        desc_q=feat_desc[src] ^ flips,
        valid_q=rng.uniform(size=nq) < 0.9,
        feat_xy=feat_xy,
        feat_level=rng.integers(0, 8, size=nf).astype(np.int32),
        feat_desc=feat_desc,
        feat_valid=rng.uniform(size=nf) < 0.95,
    )


@pytest.mark.parametrize("seed,ratio", [(0, 1.0), (1, 0.9), (2, 0.9)])
def test_search_by_projection_and_resolve_duplicates(seed, ratio):
    d = _projection_inputs(seed)
    mj = jm.search_by_projection(**{k: jnp.asarray(v) for k, v in d.items()}, ratio=ratio)
    mt = tm.search_by_projection(
        **{k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v) for k, v in d.items()},
        ratio=ratio,
    )
    np.testing.assert_array_equal(mt.idx.numpy(), np.asarray(mj.idx))
    np.testing.assert_array_equal(mt.dist.numpy(), np.asarray(mj.dist))
    assert (np.asarray(mj.idx) >= 0).sum() > 50
    rj = jm.resolve_duplicates(mj, d["feat_xy"].shape[0])
    rt = tm.resolve_duplicates(mt, d["feat_xy"].shape[0])
    np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
    kept = rt.idx.numpy()[rt.idx.numpy() >= 0]
    assert len(kept) == len(np.unique(kept))


@pytest.mark.parametrize("mutual,with_angles", [(True, True), (False, False)])
def test_match_nn(mutual, with_angles):
    rng = np.random.default_rng(3)
    dist = rng.integers(0, 120, size=(80, 90)).astype(np.int32)
    va = rng.uniform(size=80) < 0.9
    vb = rng.uniform(size=90) < 0.9
    ang_a = rng.uniform(-np.pi, np.pi, size=80).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, size=90).astype(np.float32)
    kw = dict(max_dist=50, ratio=0.9, mutual=mutual)
    aj = dict(ang_a=jnp.asarray(ang_a), ang_b=jnp.asarray(ang_b)) if with_angles else {}
    at = dict(ang_a=torch.from_numpy(ang_a), ang_b=torch.from_numpy(ang_b)) if with_angles else {}
    mj = jm.match_nn(jnp.asarray(dist), jnp.asarray(va), jnp.asarray(vb), **kw, **aj)
    mt = tm.match_nn(torch.from_numpy(dist), torch.from_numpy(va), torch.from_numpy(vb), **kw, **at)
    np.testing.assert_array_equal(mt.idx.numpy(), np.asarray(mj.idx))
    np.testing.assert_array_equal(mt.dist.numpy(), np.asarray(mj.dist))
