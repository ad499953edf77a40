"""Parity of the port's two-view initialisation, Sim(3) alignment and
trajectory files with the JAX package on the CPU.

Both packages get the same minimal sets: the JAX package draws them inside
``reconstruct_two_views`` from its key, and :func:`jax_minimal_sets` repeats
that draw so the port can take the indices as an argument.  Tolerances:
``success`` equal, ``R21``/``t21`` within 1e-4, ``is_inlier`` >= 99% equal,
the points of common inliers within 1e-3 of their distance.  JAX runs in
float32; inputs cross as numpy arrays.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import horn as jhorn
from orb_slam3_noted_tpu.geometry import twoview as jtv
from orb_slam3_noted_tpu.io import trajectory as jtraj
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.ops import orb as jorb
from orb_slam3_noted_tpu.pipeline import tracking as jtr
from orb_slam3_noted_tpu.pipeline.system import FrameRecord as JRecord
from orb_slam3_noted_tpu.utils import evaluation as jeval
from orb_slam3_noted_tpu_torch.geometry import horn as thorn
from orb_slam3_noted_tpu_torch.geometry import twoview as ttv
from orb_slam3_noted_tpu_torch.io import trajectory as ttraj
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.pipeline import tracking as ttr
from orb_slam3_noted_tpu_torch.pipeline.system import FrameRecord
from orb_slam3_noted_tpu_torch.utils import evaluation as teval
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory

W, H = 320, 240
FX = 260.0
PARAMS = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
R_ATOL, T_ATOL, PTS_RTOL, INLIER_SHARE = 1e-4, 1e-4, 1e-3, 0.99
# on extracted features the baselines are short and some rays nearly
# parallel: the same triangulation from the same R, t differs between the
# packages by up to 5.2e-3 of the distance there (measured on lap frames
# 0 and 4), so the points are held to a median of PTS_RTOL and a maximum of
# PTS_RTOL_MAX (measured: 9.3e-3 for lap frame 3, 3.6e-3 for frame 4,
# 9.4e-5 for frame 12; medians 3.9e-4, 1.0e-4, 1.7e-5)
PTS_RTOL_MAX = 2e-2
# a lap frame's t21 after the Sampson polish of a hypothesis whose float32
# Gram eigenproblem rounds differently in MKL and XLA: 1.88e-4 apart on an
# AMD EPYC with AVX-512 (within 1e-4 on another x86 CPU)
T_ATOL_LAP = 2e-4
# inlier counts of a candidate with fewer matches than a minimal set
FEW_MATCHES_SPREAD = 1


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """JAX in float32 as in use; torch on one thread (the test workers run
    side by side)."""
    prev, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", prev)


@partial(jax.jit, static_argnames=("n_hyp",))
def _jax_draw(valid, key, n_hyp=256):
    """The minimal sets ``reconstruct_two_views`` draws from ``key``."""
    n = valid.shape[0]
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    keys = jax.random.split(key, n_hyp)
    return jax.vmap(lambda k: jax.random.choice(k, n, shape=(8,), replace=False, p=p))(keys)


def jax_minimal_sets(valid, key) -> torch.Tensor:
    """(n_hyp, 8) for a (N,) mask; for (B, N) the batch's keys are split
    from ``key`` as ``init_attempt_batch`` splits them."""
    valid = np.asarray(valid)
    if valid.ndim == 1:
        return torch.from_numpy(np.asarray(_jax_draw(jnp.asarray(valid), key))).long()
    keys = jax.random.split(key, valid.shape[0])
    return torch.stack([jax_minimal_sets(v, k) for v, k in zip(valid, keys)])


def make_pair(seed, n=300, n_out=40, noise=5e-4):
    """``tests/test_twoview.py``'s pair: 300 points 3-7 m ahead, a small
    rotation and a 0.35 m baseline, 40 corrupted matches, float32 rays."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(n, 3)) + np.array([0, 0, 5.0])
    R21 = torch.linalg.matrix_exp(torch.tensor(
        [[0.0, -0.03, -0.1], [0.03, 0.0, -0.02], [0.1, 0.02, 0.0]], dtype=torch.float64)).numpy()
    t21 = np.array([-0.35, 0.04, 0.06])
    p2 = pts @ R21.T + t21
    r1 = pts / pts[:, 2:3]
    r2 = p2 / p2[:, 2:3]
    r1[:, :2] += rng.normal(0, noise, size=(n, 2))
    r2[:, :2] += rng.normal(0, noise, size=(n, 2))
    bad = rng.choice(n, size=n_out, replace=False)
    r2[bad, :2] = rng.uniform(-0.5, 0.5, size=(n_out, 2))
    return r1.astype(np.float32), r2.astype(np.float32), bad


def compare(resj, rest, inlier_share=INLIER_SHARE):
    """Hold the port's result to the JAX package's (unbatched)."""
    assert bool(rest.success) == bool(resj.success)
    np.testing.assert_allclose(rest.R21.numpy(), np.asarray(resj.R21), atol=R_ATOL)
    np.testing.assert_allclose(rest.t21.numpy(), np.asarray(resj.t21), atol=T_ATOL)
    inl_j, inl_t = np.asarray(resj.is_inlier), rest.is_inlier.numpy()
    assert (inl_j == inl_t).mean() >= inlier_share
    common = inl_j & inl_t
    pj, pt = np.asarray(resj.points1)[common], rest.points1.numpy()[common]
    rel = np.linalg.norm(pj - pt, axis=1) / np.linalg.norm(pj, axis=1)
    assert rel.size == 0 or rel.max() <= PTS_RTOL
    for f in ("vote_best", "vote_second", "used_h"):
        assert int(getattr(rest, f)) == int(getattr(resj, f)), f


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reconstruct_two_views_matches_jax(seed):
    r1, r2, bad = make_pair(seed)
    valid = np.ones(r1.shape[0], bool)
    valid[::7] = False
    key = jax.random.PRNGKey(seed)
    resj = jtv.reconstruct_two_views(jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(valid), key)
    rest = ttv.reconstruct_two_views(torch.from_numpy(r1), torch.from_numpy(r2),
                                     torch.from_numpy(valid), jax_minimal_sets(valid, key))
    assert bool(resj.success)
    compare(resj, rest)
    assert rest.is_inlier.numpy()[bad].mean() < 0.2


def test_pure_rotation_fails_in_both():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, size=(200, 3)) + np.array([0, 0, 5.0])
    c, s = np.cos(0.1), np.sin(0.1)
    R21 = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    p2 = pts @ R21.T  # no translation, no parallax
    r1 = (pts / pts[:, 2:3]).astype(np.float32)
    r2 = (p2 / p2[:, 2:3]).astype(np.float32)
    valid = np.ones(200, bool)
    key = jax.random.PRNGKey(1)
    resj = jtv.reconstruct_two_views(jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(valid), key)
    rest = ttv.reconstruct_two_views(torch.from_numpy(r1), torch.from_numpy(r2),
                                     torch.from_numpy(valid), jax_minimal_sets(valid, key))
    assert not bool(resj.success) and not bool(rest.success)


@pytest.mark.parametrize("n_valid", [0, 5, 12])
def test_few_matches_run_and_fail(n_valid):
    """A candidate with a handful of matches still runs through (the facade
    gates on the match count afterwards): no exception, no success, finite
    outputs; with the JAX package's draws its inlier count."""
    r1, r2, _ = make_pair(0)
    valid = np.zeros(r1.shape[0], bool)
    valid[:n_valid] = True
    key = jax.random.PRNGKey(2)
    resj = jtv.reconstruct_two_views(jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(valid), key)
    assert not bool(resj.success)
    g = torch.Generator().manual_seed(2)
    for sets in (jax_minimal_sets(valid, key), ttv.sample_minimal_sets(torch.from_numpy(valid), 256, g)):
        rest = ttv.reconstruct_two_views(torch.from_numpy(r1), torch.from_numpy(r2),
                                         torch.from_numpy(valid), sets)
        assert not bool(rest.success) and int(rest.n_inliers) <= n_valid
        assert torch.isfinite(rest.R21).all() and torch.isfinite(rest.t21).all()
    rest = ttv.reconstruct_two_views(torch.from_numpy(r1), torch.from_numpy(r2),
                                     torch.from_numpy(valid), jax_minimal_sets(valid, key))
    # under 8 matches every minimal set repeats the same 8 rays, and the
    # winning hypothesis is a near-tie of scores from the float32 Gram
    # eigenproblems (ROADMAP Queue 3, "minimal solvers"): at 5 matches the
    # count is 3 (JAX) against 4 (port) on an AMD EPYC with AVX-512, equal
    # on another x86 CPU, and 4 against 5 with both packages in float64
    spread = FEW_MATCHES_SPREAD if n_valid < 8 else 0
    assert abs(int(rest.n_inliers) - int(resj.n_inliers)) <= spread


def test_degenerate_input_neither_raises_nor_succeeds():
    """Every match on one ray: singular 8-point systems (whose null spaces
    the two eigensolvers span differently) and homographies; no exception,
    no success in either package.  A singular homography's errors are
    non-finite or huge and fail every comparison, so scores stay finite
    (``argmax`` would pick the first nan in both packages; none reaches it)."""
    assert int(jnp.argmax(jnp.asarray([1.0, np.nan, 2.0]))) == int(
        torch.argmax(torch.tensor([1.0, float("nan"), 2.0]))) == 1
    r = np.tile(np.array([[0.1, -0.2, 1.0]], np.float32), (50, 1))
    valid = np.ones(50, bool)
    key = jax.random.PRNGKey(4)
    resj = jtv.reconstruct_two_views(jnp.asarray(r), jnp.asarray(r), jnp.asarray(valid), key)
    rest = ttv.reconstruct_two_views(torch.from_numpy(r), torch.from_numpy(r),
                                     torch.from_numpy(valid), jax_minimal_sets(valid, key))
    assert not bool(resj.success) and not bool(rest.success)
    assert torch.isfinite(rest.R21).all() and torch.isfinite(rest.t21).all()
    Hs = torch.zeros(2, 3, 3)
    Hs[1, 0, 0] = 1.0  # singular: the adjugate inverse is huge or inf, not an exception
    e12, e21 = ttv._transfer_errors(Hs, torch.from_numpy(r), torch.from_numpy(r))
    assert not bool(((e12 < 1e-3) & (e21 < 1e-3)).any())


def test_batch_of_pairs_equals_pair_by_pair():
    """In float64: batched and single products round differently in the
    last bit (MKL takes other code paths for them), and near-parallel rays
    amplify that in float32 to 0.11 of a point's distance (AMD EPYC with
    AVX-512); batching is what is held here, not float32 rounding."""
    pairs = [make_pair(s) for s in range(3)]
    r1 = torch.stack([torch.from_numpy(p[0]) for p in pairs]).double()
    r2 = torch.stack([torch.from_numpy(p[1]) for p in pairs]).double()
    valid = torch.ones(r1.shape[:2], dtype=torch.bool)
    valid[1, 100:] = False
    sets = ttv.sample_minimal_sets(valid, 256, torch.Generator().manual_seed(3))
    batch = ttv.reconstruct_two_views(r1, r2, valid, sets)
    for b in range(3):
        one = ttv.reconstruct_two_views(r1[b], r2[b], valid[b], sets[b])
        for f in one._fields:
            a, c = getattr(batch, f)[b], getattr(one, f)
            if a.is_floating_point():
                # measured in float64: 1.2e-8 relative at most
                torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-4)
            else:
                assert torch.equal(a, c), f


def test_sample_minimal_sets():
    valid = torch.zeros(2, 500, dtype=torch.bool)
    valid[0, ::3] = True
    valid[1, :5] = True
    a = ttv.sample_minimal_sets(valid, 256, torch.Generator().manual_seed(7))
    b = ttv.sample_minimal_sets(valid, 256, torch.Generator().manual_seed(7))
    assert a.shape == (2, 256, 8) and torch.equal(a, b)
    rows = a.reshape(-1, 8)
    assert all(len(set(r.tolist())) == 8 for r in rows)  # without replacement
    assert bool(valid[0][a[0]].all())                     # mass on the valid entries only
    # fewer than 8 valid: all of them, then the lowest invalid indices
    assert all(set(r[:5].tolist()) == set(range(5)) and r[5:].tolist() == [5, 6, 7]
               for r in a[1])
    # every valid entry is drawn about equally often
    many = ttv.sample_minimal_sets(valid[0], 4096, torch.Generator().manual_seed(8))
    counts = torch.bincount(many.reshape(-1), minlength=500)[valid[0]].float()
    assert counts.min() > 0.6 * counts.mean() and counts.max() < 1.4 * counts.mean()


@pytest.fixture(scope="module")
def two_frames():
    """JAX features of lap frames 0 (the reference) and 3, 4 and 12 of the
    small monocular lap, and the port's copies."""
    room = BoxRoom(seed=0)
    poses = orbit_trajectory(48, forward=0.03, yaw0=0.45)
    imgs = [room.render(*poses[i], PARAMS, W, H).astype(np.float32) for i in (0, 3, 4, 12)]
    feats = jax.jit(jax.vmap(partial(jorb.extract_orb, n_features=600)))(jnp.asarray(np.stack(imgs)))
    return jax.device_get(feats)


def test_init_attempt_batch_matches_jax(two_frames):
    jf = two_frames
    cam_j = JCamera(0, PARAMS)
    ref_j = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jf)
    cand_j = jax.tree_util.tree_map(lambda x: jnp.asarray(x[1:]), jf)
    key = jax.random.PRNGKey(3)
    outj = jax.device_get(jtr.init_attempt_batch(ref_j, cand_j, cam_j, key))
    tf = torb.from_numpy(jf._asdict())
    ref_t = torb.FrameFeatures(*(f[0] for f in tf))
    cand_t = torb.FrameFeatures(*(f[1:] for f in tf))
    matched = outj[6] >= 0
    outt = ttr.init_attempt_batch(ref_t, cand_t, Camera(PINHOLE, PARAMS),
                                  lambda _: jax_minimal_sets(matched, key))
    n_m, succ, good, pts1, R21, t21, idx = (x.numpy() for x in outt)
    np.testing.assert_array_equal(idx, outj[6])
    np.testing.assert_array_equal(n_m, outj[0])
    np.testing.assert_array_equal(succ, outj[1])
    assert outj[1].any()  # at least one candidate initialises
    for b in range(3):
        np.testing.assert_allclose(R21[b], outj[4][b], atol=R_ATOL)
        np.testing.assert_allclose(t21[b], outj[5][b], atol=T_ATOL_LAP)
        assert (good[b] == outj[2][b]).mean() >= INLIER_SHARE
        common = good[b] & outj[2][b]
        rel = (np.linalg.norm(pts1[b][common] - outj[3][b][common], axis=1)
               / np.linalg.norm(outj[3][b][common], axis=1))
        assert rel.size == 0 or (np.median(rel) <= PTS_RTOL and rel.max() <= PTS_RTOL_MAX)
    # the generator draw runs the same path and needs no host value
    g = torch.Generator().manual_seed(3)
    outg = ttr.init_attempt_batch(ref_t, cand_t, Camera(PINHOLE, PARAMS),
                                  lambda v: ttv.sample_minimal_sets(v, ttr.N_HYP, g))
    assert torch.equal(outg[0], outt[0]) and outg[1].shape == (3,)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_and_ate_match_jax(fix_scale):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(60, 3)).astype(np.float32)
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    y = (2.5 * x @ R.T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.01, x.shape)).astype(np.float32)
    w = (rng.uniform(size=60) > 0.2).astype(np.float32)
    Rj, tj, sj = jhorn.horn_sim3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), fix_scale=fix_scale)
    Rt, tt, st = thorn.horn_sim3(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
                                 fix_scale=fix_scale)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
    ej, aj, _ = jeval.ate_rmse(x, y, with_scale=not fix_scale)
    et, at, _ = teval.ate_rmse(x, y, with_scale=not fix_scale)
    np.testing.assert_allclose(et, ej, rtol=1e-4)
    np.testing.assert_allclose(at, aj, atol=1e-4)


def _records(n=40):
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        w = rng.normal(size=3) * rng.uniform(0, 3)
        R = torch.linalg.matrix_exp(torch.tensor(
            [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])).numpy().astype(np.float32)
        out.append((i, R, rng.normal(size=3).astype(np.float32)))
    return ([JRecord(i, R, t, "OK", 1) for i, R, t in out],
            [FrameRecord(i, R, t, "OK", 1) for i, R, t in out])


def _fields(path):
    with open(path) as f:
        return [line.split() for line in f]


def test_trajectory_files_match_jax(tmp_path):
    """Timestamps, positions and KITTI matrices byte for byte; quaternions
    digit for digit except where the JAX package's fused norm rounds the
    last float32 bit another way (XLA's CPU square root inside the fused
    reduction is within 2 ulp of the correctly rounded one): there the
    printed value may move by 1e-7 (measured: 3 of 50 rotations differ in
    a bit, at most 6e-8)."""
    recs_j, recs_t = _records()
    for name, quat in (("save_tum", slice(4, 8)), ("save_euroc", slice(4, 8)), ("save_kitti", None)):
        pj, pt = tmp_path / f"{name}_jax.txt", tmp_path / f"{name}_torch.txt"
        getattr(jtraj, name)(str(pj), recs_j)
        getattr(ttraj, name)(str(pt), recs_t)
        fj, ft = _fields(pj), _fields(pt)
        assert len(fj) == len(ft) == len(recs_j)
        for a, b in zip(fj, ft):
            if quat is None:
                assert a == b
                continue
            assert a[:4] == b[:4]
            np.testing.assert_allclose(np.float64(b[quat]), np.float64(a[quat]), atol=1.5e-7)
    # load_tum reads back what save_tum wrote, from either package's file
    tj, posj, qj = jtraj.load_tum(str(tmp_path / "save_tum_jax.txt"))
    for path in (tmp_path / "save_tum_jax.txt", tmp_path / "save_tum_torch.txt"):
        t, pos, q = ttraj.load_tum(str(path))
        np.testing.assert_array_equal(t, tj)
        np.testing.assert_array_equal(pos, posj)
        np.testing.assert_allclose(q, qj, atol=1.5e-7)
    twc = np.stack([-R.T @ t for _, R, t in ((r.frame_id, r.Rcw, r.tcw) for r in recs_t)])
    np.testing.assert_allclose(pos, twc, atol=1e-6)


def test_save_keyframes_tum(tmp_path):
    """Keyframes in frame-id order with their final poses, from a map."""
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS

    cfg = SlamConfig(max_keyframes=8, max_map_points=64, n_features=4)
    m = MS.empty_map(cfg, device=torch.device("cpu"))
    _, recs = _records(3)
    kf_valid = m.kf_valid.clone()
    kf_valid[[1, 4, 6]] = True
    fid = m.kf_frame_id.clone()
    fid[[1, 4, 6]] = torch.tensor([30, 10, 20], dtype=fid.dtype)
    R, t = m.kf_Rcw.clone(), m.kf_tcw.clone()
    for slot, rec in zip((4, 6, 1), recs):
        R[slot], t[slot] = torch.from_numpy(rec.Rcw), torch.from_numpy(rec.tcw)
    slam = type("S", (), {"m": m._replace(kf_valid=kf_valid, kf_frame_id=fid, kf_Rcw=R, kf_tcw=t)})
    path = ttraj.save_keyframes_tum(str(tmp_path / "kf.txt"), slam)
    ttraj.save_tum(str(tmp_path / "ref.txt"), [FrameRecord(f, r.Rcw, r.tcw, "OK", 0)
                                                for f, r in zip((10, 20, 30), recs)])
    assert open(path).read() == open(tmp_path / "ref.txt").read()
    assert os.path.getsize(path) > 0
