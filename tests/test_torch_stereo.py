"""Parity of the port's stereo front end with the JAX package on the CPU:
the SAD kernel's plain version, the matcher's integer centres and
candidates, ``match_stereo`` on rendered 320x240 pairs, ``stereo_from_depth``
and a short ``StereoSLAM`` run in localisation mode.

JAX runs on the CPU in float32, where its matcher takes the gather path
that the CUDA kernel K4 and its plain version compute.  Inputs are rendered
or drawn from a seed with numpy and cross as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.ops import image as jimg
from orb_slam3_noted_tpu.ops import matching as jmatch
from orb_slam3_noted_tpu.ops import orb as jorb
from orb_slam3_noted_tpu.ops import stereo as jst
from orb_slam3_noted_tpu.pipeline import system as jsys
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
from orb_slam3_noted_tpu_torch.ops import image as timg
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.ops import stereo as tst
from orb_slam3_noted_tpu_torch.pipeline.system import OK, StereoSLAM
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

W, H = 320, 240
FX = 260.0
BASELINE = 0.12
PARAMS = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
BF = FX * BASELINE
ORB_KW = dict(n_features=600, n_levels=8, scale_factor=1.2, th_high=20.0, th_low=7.0)
CFG_KW = dict(
    width=W, height=H, n_features=600, bf=BF, th_depth=35.0,
    max_keyframes=32, max_map_points=4096, local_window=5, kf_max_interval=10,
)
N_FRAMES = 6


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
def pairs():
    room = BoxRoom(seed=0)
    poses = orbit_trajectory(48, forward=0.03, yaw0=0.45)[:N_FRAMES]
    return [
        tuple(x.astype(np.uint8) for x in stereo_pair(room, R, t, PARAMS, W, H, BASELINE)[:2])
        for R, t in poses
    ]


@pytest.fixture(scope="module")
def jax_frames(pairs):
    """Per pair: the JAX package's features, pyramids and stereo matches."""
    out = []
    for left, right in pairs[:3]:
        iml, imr = jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32)
        fl, fr = jorb.extract_orb(iml, **ORB_KW), jorb.extract_orb(imr, **ORB_KW)
        pl, pr = tuple(jimg.build_pyramid(iml, 8, 1.2)), tuple(jimg.build_pyramid(imr, 8, 1.2))
        sm = jst.match_stereo(fl, fr, pl, pr, bf=BF, baseline=BASELINE, n_levels=8, scale_factor=1.2)
        out.append((fl, fr, pl, pr, sm))
    return out


def _carry(jf):
    """The JAX features and pyramids of one pair as the port's tensors."""
    fl, fr, pl, pr, _ = jf
    return (
        torb.from_numpy(jax.device_get(fl)._asdict()), torb.from_numpy(jax.device_get(fr)._asdict()),
        tuple(torch.from_numpy(np.array(p)) for p in pl),
        tuple(torch.from_numpy(np.array(p)) for p in pr),
    )


def _jax_sads(atlas_l, atlas_r, cv, cu, cur, lvl, off_t, h_t, w_t):
    """The gather path of the JAX package's ``match_stereo`` (its lines
    after ``if sads is None``), evaluated by JAX on the same inputs."""
    atlas_l, atlas_r = jnp.asarray(atlas_l), jnp.asarray(atlas_r)
    cv, cu, cur, lvl = (jnp.asarray(x) for x in (cv, cu, cur, lvl))
    off_t, h_t, w_t = (jnp.asarray(x) for x in (off_t, h_t, w_t))
    _W, _L = 5, 5
    dy = jnp.arange(-_W, _W + 1)
    yy = jnp.clip(cv[:, None] + dy[None, :], 0, h_t[lvl][:, None] - 1) + off_t[lvl][:, None]
    xxl = jnp.clip(cu[:, None] + dy[None, :], 0, w_t[lvl][:, None] - 1)
    dxr = jnp.arange(-(_W + _L), _W + _L + 1)
    xxr = jnp.clip(cur[:, None] + dxr[None, :], 0, w_t[lvl][:, None] - 1)
    patch = atlas_l[yy[:, :, None], xxl[:, None, :]]
    strip = atlas_r[yy[:, :, None], xxr[:, None, :]]
    return np.asarray(jnp.stack(
        [jnp.sum(jnp.abs(patch - strip[:, :, i:i + 2 * _W + 1]), axis=(1, 2))
         for i in range(2 * _L + 1)], axis=1))


def _random_sad_inputs(seed, K=300):
    rng = np.random.default_rng(seed)
    hs, ws = [60, 50, 42, 35], [80, 67, 56, 46]
    mk = lambda: np.concatenate([
        np.pad(rng.uniform(0, 255, (h, w)).astype(np.float32), ((0, 0), (0, ws[0] - w)))
        for h, w in zip(hs, ws)])
    lvl = rng.integers(0, 4, K).astype(np.int32)
    # centres reach past every border, so each clamp is exercised
    cv = rng.integers(-8, np.asarray(hs)[lvl] + 8).astype(np.int32)
    cu = rng.integers(-8, np.asarray(ws)[lvl] + 8).astype(np.int32)
    cur = rng.integers(-12, np.asarray(ws)[lvl] + 12).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(hs)])[:4].astype(np.int32)
    return (mk(), mk(), cv, cu, cur, lvl, off, np.asarray(hs, np.int32), np.asarray(ws, np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sad_stereo_plain_matches_jax_gather(seed):
    """Float32 sums of 121 terms in another order: relative 1e-5."""
    args = _random_sad_inputs(seed)
    before = ck.sad_stereo.launches
    out = ck.sad_stereo(*(torch.from_numpy(a) for a in args))  # CPU tensors -> plain version
    assert ck.sad_stereo.launches == before
    assert out.shape == (300, 11) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _jax_sads(*args), rtol=1e-5, atol=0)


def test_sad_stereo_plain_batched():
    """A leading batch dimension gives each item's own result."""
    items = [_random_sad_inputs(s, K=64) for s in (3, 4)]
    t = lambda i: torch.from_numpy(np.stack([it[i] for it in items]))
    tables = [torch.from_numpy(items[0][i]) for i in (6, 7, 8)]
    out = ck.sad_stereo_plain(*(t(i) for i in range(6)), *tables)
    assert out.shape == (2, 64, 11)
    for b, it in enumerate(items):
        one = ck.sad_stereo_plain(*(torch.from_numpy(a) for a in it))
        assert torch.equal(out[b], one)


def test_launch_counts_name_all_four_kernels():
    ck.reset_launch_counts()
    assert ck.launch_counts() == {
        "fast_score": 0, "gaussian_blur7": 0, "brief_sample": 0, "sad_stereo": 0}


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_candidates_and_level_centres(jax_frames, frame):
    """The Hamming candidate (first index on ties) and the rounded level
    centres: equal to JAX's on every feature.  ``round((u + 0.5) / sx -
    0.5)`` could round the other way near .5 if a compiler fused it; the
    share that differs is asserted to be zero."""
    fl, fr, pl, _, _ = jax_frames[frame]
    tl, tr, tpl, _ = _carry(jax_frames[frame])
    idx_r, have = tst.hamming_candidates(tl, tr, BF, BASELINE)
    cv, cu, cur, _ = tst.level_centres(tl, tr, idx_r, tpl)

    sf = jnp.asarray(jorb.scale_factors(8, 1.2), jnp.float32)
    d = jmatch.hamming_matrix(fl.desc, fr.desc)
    gate = (
        (jnp.abs(fl.xy[:, None, 1] - fr.xy[None, :, 1]) <= (2.0 * sf[fr.level])[None, :])
        & (jnp.abs(fl.level[:, None] - fr.level[None, :]) <= 1)
        & ((fl.xy[:, None, 0] - fr.xy[None, :, 0]) >= 0.0)
        & ((fl.xy[:, None, 0] - fr.xy[None, :, 0]) <= BF / BASELINE)
        & fl.valid[:, None] & fr.valid[None, :]
    )
    masked = jnp.where(gate, d, jmatch.BIG)
    # integer distances tie often: at least one row must have a tie at its minimum
    best = np.asarray(jnp.min(masked, axis=1))
    ties = (np.asarray(masked) == best[:, None]).sum(1)
    assert (ties[best < jmatch.BIG] > 1).any()
    jidx = jnp.argmin(masked, axis=1)
    np.testing.assert_array_equal(idx_r.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(have.numpy(), best < (jmatch.TH_HIGH + jmatch.TH_LOW) // 2)

    W0, H0 = pl[0].shape[1], pl[0].shape[0]
    sx = jnp.asarray([W0 / p.shape[1] for p in pl], jnp.float32)[fl.level]
    sy = jnp.asarray([H0 / p.shape[0] for p in pl], jnp.float32)[fl.level]
    jcu = jnp.round((fl.xy[:, 0] + 0.5) / sx - 0.5).astype(jnp.int32)
    jcv = jnp.round((fl.xy[:, 1] + 0.5) / sy - 0.5).astype(jnp.int32)
    jcur = jnp.round((fr.xy[jidx, 0] + 0.5) / sx - 0.5).astype(jnp.int32)
    for a, b in ((cu, jcu), (cv, jcv), (cur, jcur)):
        assert (a.numpy() != np.asarray(b)).mean() == 0.0


def test_build_atlas_layout(jax_frames):
    _, _, tpl, _ = _carry(jax_frames[0])
    at = tst.build_atlas(tpl)
    hs = [p.shape[0] for p in tpl]
    assert at.image.shape == (sum(hs), W) and at.image.is_contiguous()
    assert at.h.tolist() == hs and at.w.tolist() == [p.shape[1] for p in tpl]
    assert at.off.tolist() == [sum(hs[:i]) for i in range(8)]
    for o, p in zip(at.off.tolist(), tpl):
        assert torch.equal(at.image[o:o + p.shape[0], :p.shape[1]], p)
        assert float(at.image[o:o + p.shape[0], p.shape[1]:].abs().sum()) == 0.0


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_match_stereo_on_carried_features(jax_frames, frame):
    """``match_stereo`` on the JAX package's own features and pyramids: the
    same valid mask on >= 99% of features (an off-by-one in the median
    filter's count would move many at once), u_right within 1e-3 px and
    depth within 1e-4 relative where both are valid."""
    sm = jax_frames[frame][4]
    st = tst.match_stereo(*_carry(jax_frames[frame]), bf=BF, baseline=BASELINE)
    vj, vt = np.asarray(sm.valid), st.valid.numpy()
    assert vj.sum() > 300
    assert (vj == vt).mean() >= 0.99
    both = vj & vt
    np.testing.assert_allclose(st.u_right.numpy()[both], np.asarray(sm.u_right)[both], rtol=0, atol=1e-3)
    np.testing.assert_allclose(st.depth.numpy()[both], np.asarray(sm.depth)[both], rtol=1e-4, atol=0)
    assert np.all(st.u_right.numpy()[~vt] == -1.0) and np.all(st.depth.numpy()[~vt] == -1.0)
    d = tst.to_numpy(st)
    back = tst.from_numpy(d)
    assert all(torch.equal(a, b) for a, b in zip(back, st))


def test_match_stereo_from_images(pairs, jax_frames):
    """The port's own extraction and pyramids (built once, shared with the
    matcher): features as ``extract_orb``'s, and the same matches as the
    JAX package on >= 99% of features."""
    left, right = pairs[0]
    pyrs = [tuple(timg.build_pyramid(torch.from_numpy(x.astype(np.float32)), 8, 1.2))
            for x in (left, right)]
    fl, fr = (torb.extract_from_pyramid(p, **ORB_KW) for p in pyrs)
    whole = torb.extract_orb(torch.from_numpy(left.astype(np.float32)), **ORB_KW)
    assert all(torch.equal(a, b) for a, b in zip(fl, whole))
    st = tst.match_stereo(fl, fr, pyrs[0], pyrs[1], bf=BF, baseline=BASELINE)
    sm = jax_frames[0][4]
    vj, vt = np.asarray(sm.valid), st.valid.numpy()
    assert (vj == vt).mean() >= 0.99
    both = vj & vt
    # keypoints can differ in the last ulp between the packages' extractors
    assert np.median(np.abs(st.depth.numpy()[both] - np.asarray(sm.depth)[both])) < 1e-4


def test_stereo_from_depth(jax_frames):
    fl = jax_frames[0][0]
    tl = _carry(jax_frames[0])[0]
    rng = np.random.default_rng(5)
    depth = np.where(rng.uniform(size=(H, W)) < 0.8, rng.uniform(0.3, 9.0, (H, W)), 0.0).astype(np.float32)
    sj = jst.stereo_from_depth(fl, jnp.asarray(depth), BF)
    st = tst.stereo_from_depth(tl, torch.from_numpy(depth), BF)
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(sj.valid))
    np.testing.assert_allclose(st.depth.numpy(), np.asarray(sj.depth), rtol=0, atol=0)
    np.testing.assert_allclose(st.u_right.numpy(), np.asarray(sj.u_right), rtol=1e-6, atol=1e-5)


def test_stereo_localization_lap(pairs):
    """``StereoSLAM.process`` with the mapper frozen: the stereo front end,
    single-frame initialisation and tracking alone.  States equal, inliers
    within 5, camera centres within 2 mm (float32 sums round in other
    orders; measured below 0.2 mm) except frame 1 within 5 mm: it starts
    from frame 0's pose with no motion model, the 12 Gauss-Newton steps
    stop short of convergence from that far, and last-bit differences show
    as millimetres (measured 3.2 mm)."""
    js = jsys.StereoSLAM(JConfig(camera=JCamera(0, PARAMS), **CFG_KW))
    ts = StereoSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW), device=torch.device("cpu"))
    for s in (js, ts):
        s.set_localization_mode(True)
    for i, (left, right) in enumerate(pairs):
        js.process(left, right, i)
        ts.process(left, right, i)
    assert [r.state for r in ts.trajectory] == [r.state for r in js.trajectory] == [OK] * N_FRAMES
    assert ts.n_kf == js.n_kf == 1 and ts.n_mp == js.n_mp > 300
    for rt, rj in zip(ts.trajectory, js.trajectory):
        assert abs(rt.n_inliers - rj.n_inliers) <= 5
    pt, pj = ts.positions(), js.positions()
    np.testing.assert_allclose(pt[1], pj[1], rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.delete(pt, 1, 0), np.delete(pj, 1, 0), rtol=0, atol=2e-3)
    assert ck.launch_counts()["sad_stereo"] == 0  # CPU tensors take the plain version
