"""Parity of the port's keyframe mapper with the JAX package on the CPU, on
the size of ``tests/test_e2e_stereo.py``: 320x240, 600 features, 32
keyframes, 4096 map points.

One JAX ``StereoSLAM`` run of 16 frames is shared by the module; it records
every ``insert_keyframe_step`` call.  From the state of the third call the
JAX package's mapper functions are applied one by one, and each port
function starts from the JAX state before it.  Ints and masks must be
equal; float tolerances are stated where they are used.  JAX runs on the
CPU in float32; states cross as numpy arrays.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import triangulation as jtri
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.optim import window_ba as jwba
from orb_slam3_noted_tpu.pipeline import map_state as jms
from orb_slam3_noted_tpu.pipeline import system as jsys
from orb_slam3_noted_tpu.pipeline import tracking as jtr
from orb_slam3_noted_tpu_torch.geometry import triangulation as ttri
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.optim import window_ba as twba
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from orb_slam3_noted_tpu_torch.pipeline import tracking as ttr
from orb_slam3_noted_tpu_torch.pipeline.system import OK, RGBDSLAM, StereoSLAM
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair
from test_torch_tracking import _RecordingDatabase

W, H = 320, 240
FX = 260.0
BASELINE = 0.12
PARAMS = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
CFG_KW = dict(
    width=W, height=H, n_features=600, bf=FX * BASELINE, th_depth=35.0,
    max_keyframes=32, max_map_points=4096, local_window=5, kf_max_interval=10,
    # a keyframe every 4 frames whatever the inlier count: the default policy
    # inserts when inliers fall below 90% of the last keyframe's, a threshold
    # that one flipped inlier moves to the next frame, after which two runs
    # can only be compared in aggregate
    kf_tracked_ratio=2.0, kf_min_interval=4,
)
NF, KF, MP = 600, 32, 4096
N_FRAMES = 16
CPU = torch.device("cpu")


def jcfg():
    return JConfig(camera=JCamera(0, PARAMS), **CFG_KW)


def tcfg(**kw):
    return SlamConfig(camera=Camera(PINHOLE, PARAMS), **dict(CFG_KW, **kw))


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
    room = BoxRoom(seed=0)
    poses = orbit_trajectory(48, forward=0.03, yaw0=0.45)[:N_FRAMES]
    out = []
    for R, t in poses:
        left, right, depth = stereo_pair(room, R, t, PARAMS, W, H, BASELINE)
        out.append((left.astype(np.uint8), right.astype(np.uint8), depth.astype(np.float32)))
    return poses, out


@pytest.fixture(scope="module")
def runs(frames):
    """(JAX system, port system, recorded JAX ``insert_keyframe_step`` calls)
    after the 16 frames."""
    js = jsys.StereoSLAM(jcfg())
    ts = StereoSLAM(tcfg(), device=CPU)
    calls = []
    orig = jtr.insert_keyframe_step

    def recording(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out

    jtr.insert_keyframe_step = recording
    try:
        for i, (left, right, _) in enumerate(frames[1]):
            js.process(left, right, i)
            ts.process(left, right, i)
    finally:
        jtr.insert_keyframe_step = orig
    return js, ts, calls


def to_t(mj) -> tms.MapArrays:
    return tms.from_numpy(jax.device_get(mj)._asdict())


def tn(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def compare_maps(mj, mt, float_atol=1e-4, skip=()):
    """Field by field; the scratch map-point slot MP-1 is never compared."""
    mj, mt = jax.device_get(mj)._asdict(), tms.to_numpy(mt)
    for k in mj:
        if k in skip:
            continue
        a, b = np.asarray(mj[k]), mt[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == "obs_mat":
            a, b = a[:, :-1], b[:, :-1]
        elif k.startswith("mp_"):
            a, b = a[:-1], b[:-1]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=float_atol, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.fixture(scope="module")
def stages(runs):
    """The JAX mapper applied function by function to the state of the
    third keyframe insertion (three keyframes in the map, so triangulation
    and the BA window are not empty)."""
    js, _, calls = runs
    assert len(calls) >= 3
    args, kw, _ = calls[2]
    m, slot, Rcw, tcw, fid, feats, mpf, uvr, depth, n_mp, cam, cfg = args
    nn = kw["n_neighbors"]
    st = {"cam": cam, "cfg": cfg, "slot": slot, "bf": kw["bf"], "nn": nn}
    m = jms.add_keyframe(m, slot, Rcw, tcw, fid, feats.xy, feats.level, feats.angle,
                         feats.desc, feats.valid, mpf, uvr)
    m, n_mp = jtr._add_candidates_dev(
        m, slot, jtr.stereo_points_from_depth(m, slot, depth, cam, cfg, bf=kw["bf"]), n_mp)
    st["seeded"] = m
    w = jms.covisibility_weights(m, slot)
    nbs = jax.lax.top_k(w, nn)[1].astype(jnp.int32)
    st["nbs"] = nbs
    tri = [jtr.triangulate_between(m, slot, nb, cam, cfg) for nb in nbs]
    st["tri"] = tri
    out = [jnp.stack([t[i] for t in tri]) for i in range(8)]
    acc = out[7] & (w[nbs] > 0)[:, None]
    keep = acc & (jnp.arange(nn)[:, None] == jnp.argmax(acc, axis=0)[None, :])
    flat = tuple(out[i].reshape((-1,) + out[i].shape[2:]) for i in range(7)) + (keep.reshape(-1),)
    m, n_mp = jtr._add_candidates_dev(m, slot, flat, n_mp, kf_b_override=jnp.repeat(nbs, NF))
    st["triangulated"], st["n_mp"] = m, n_mp
    st["mp_mask"], st["kf_mask"] = jms.local_map_mask(m, slot, n_neighbors=cfg.local_window)
    st["fused"] = jtr.fuse_map_points(m, slot, st["mp_mask"], cam, cfg)
    st["culled"] = jms.cull_map_points(st["fused"], slot)
    st["stats"] = jms.update_point_stats(
        st["culled"], st["mp_mask"], n_levels=cfg.n_levels, scale_factor=cfg.scale_factor)
    st["ba"] = jtr.local_ba(st["stats"], slot, cam, cfg, window=cfg.local_window, bf=kw["bf"])
    return st


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_dlt(seed):
    """Closed-form 3x3 normal equations in float32.  The squared system
    amplifies last-bit differences by the inverse parallax, so the port is
    held to the JAX result within 2e-3 of the point's distance (as both are
    to the true point) and within 1e-4 of it at the median."""
    rng = np.random.default_rng(seed)
    n = 256
    X1 = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(2, 8, n)].astype(np.float32)
    w = rng.normal(size=3) * 0.1
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R21 = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)
    t21 = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    X2 = X1 @ R21.T + t21
    r1, r2 = X1 / X1[:, 2:], X2 / X2[:, 2:]
    pj = np.asarray(jtri.triangulate_dlt(jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(R21), jnp.asarray(t21)))
    pt = ttri.triangulate_dlt(tn(r1), tn(r2), tn(R21), tn(t21)).numpy()
    err = np.linalg.norm(pt - pj, axis=1) / np.linalg.norm(X1, axis=1)
    assert err.max() <= 2e-3 and np.median(err) <= 1e-4
    np.testing.assert_allclose(pt, X1, rtol=2e-3, atol=2e-3)
    cj = np.asarray(jtri.parallax_cos(jnp.asarray(r1), jnp.asarray(r2 @ R21)))
    ct = ttri.parallax_cos(tn(r1), tn(r2 @ R21)).numpy()
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the mapper, function by function, from one JAX-built map
# ---------------------------------------------------------------------------

def _compare_candidates(outj, outt):
    """Ints and masks exact; directions 1e-5; positions and scale ranges
    of accepted pairs to 2e-3 of the distance: the normal equations of
    near-parallel rays amplify float32 rounding."""
    accj = np.asarray(outj[7])
    np.testing.assert_array_equal(outt[7].numpy(), accj)
    np.testing.assert_array_equal(outt[5].numpy(), np.asarray(outj[5]))
    np.testing.assert_array_equal(outt[6].numpy()[accj], np.asarray(outj[6])[accj])
    np.testing.assert_array_equal(outt[1].numpy().view(np.uint32), np.asarray(outj[1]))
    dist = np.linalg.norm(np.asarray(outj[0])[accj], axis=1)
    assert np.all(np.linalg.norm(outt[0].numpy()[accj] - np.asarray(outj[0])[accj], axis=1) <= 2e-3 * dist)
    np.testing.assert_allclose(outt[2].numpy()[accj], np.asarray(outj[2])[accj], rtol=0, atol=1e-5)
    for i in (3, 4):
        np.testing.assert_allclose(outt[i].numpy()[accj], np.asarray(outj[i])[accj], rtol=2e-3, atol=0)


def test_triangulate_between(stages):
    st = stages
    mt, s = to_t(st["seeded"]), int(st["slot"])
    accepted = 0
    batch = ttr.triangulate_between(mt, s, tn(st["nbs"]).long(), tcfg().camera, tcfg())
    for k, (nb, outj) in enumerate(zip(np.asarray(st["nbs"]), st["tri"])):
        outt = ttr.triangulate_between(mt, s, int(nb), tcfg().camera, tcfg())
        _compare_candidates(outj, outt)
        # the batched pass over all neighbours decides as the single one
        # does; batched and single matrix products round in other orders and
        # the normal equations amplify that: accepted candidates' positions
        # and scale ranges to 1e-4 of their size (measured 1.6e-5), normals 1e-5
        acc = outt[7]
        assert torch.equal(acc, batch[7][k])
        for i in (1, 5):
            assert torch.equal(outt[i], batch[i][k])
        assert torch.equal(outt[6][acc], batch[6][k][acc])
        for i in (0, 2, 3, 4) if acc.any() else ():
            a, b = outt[i][acc], batch[i][k][acc]
            tol = 1e-5 if i == 2 else 1e-4 * float(a.abs().max())
            assert float((a - b).abs().max()) <= tol
        accepted += int(outt[7].sum())
    assert accepted > 10  # the comparison is not empty (17 on this map)


def test_add_triangulated_points(stages):
    """Candidates of all neighbours in one table: a feature accepted by
    several keeps its first hit, and the bindings come out as the JAX
    package's scatter leaves them (rows that name the same feature resolve
    to the last row)."""
    st = stages
    mt, s = to_t(st["seeded"]), int(st["slot"])
    n0 = int(jnp.sum(st["seeded"].mp_valid))
    # the JAX candidates (floats equal on both sides), the port's allocation
    out = [tn(jnp.stack([t[i] for t in st["tri"]])) for i in range(8)]
    out[1] = out[1].view(torch.int32)
    nbs = tn(st["nbs"]).long()
    w = tms.covisibility_weights(mt, s)
    acc = out[7] & (w[nbs] > 0)[:, None]
    keep = acc & (torch.arange(st["nn"])[:, None] == torch.argmax(acc.to(torch.uint8), dim=0)[None, :])
    flat = tuple(x.reshape(-1, *x.shape[2:]) for x in out[:7]) + (keep.reshape(-1),)
    n_before = int(st["n_mp"]) - int(keep.sum())
    m2, n_mp = ttr._add_candidates_dev(mt, s, flat, n_before, kf_b_override=nbs.repeat_interleave(NF))
    assert int(n_mp) == int(st["n_mp"]) and int(m2.mp_valid.sum()) > n0
    compare_maps(st["triangulated"], m2, float_atol=0.0)


def test_fuse_map_points(stages):
    st = stages
    mt = ttr.fuse_map_points(to_t(st["triangulated"]), int(st["slot"]), tn(st["mp_mask"]),
                             tcfg().camera, tcfg())
    compare_maps(st["fused"], mt, float_atol=0.0)
    changed = np.asarray(st["fused"].mp_nobs) != np.asarray(st["triangulated"].mp_nobs)
    assert changed.any()  # the call bound or merged something


def _duplicate_loser_map():
    """One keyframe whose features 0 and 1 are both bound to point 2; points
    0 and 1 project onto those features with their descriptors and are
    better observed, so both merges name point 2 as the loser."""
    rng = np.random.default_rng(7)
    m = jax.device_get(jms.empty_map(jcfg()))._asdict()
    m = {k: np.array(v) for k, v in m.items()}
    uv = np.array([[100.0, 120.0], [220.0, 100.0]], np.float32)
    desc = rng.integers(0, 2 ** 32, (3, 8), dtype=np.uint32)
    m["kf_valid"][0] = True
    m["kf_xy"][0, :2] = uv
    m["kf_level"][0, :2] = 7
    m["kf_desc"][0, :2] = desc[:2]
    m["kf_feat_valid"][0, :2] = True
    m["kf_mp"][0, :2] = 2
    z = 4.0
    m["mp_pos"][:2] = np.c_[(uv - np.array(PARAMS[2:])) / FX * z, [z, z]]
    m["mp_pos"][2] = [0.0, 0.0, z]
    m["mp_valid"][:3] = True
    m["mp_desc"][:3] = desc
    m["mp_normal"][:3] = m["mp_pos"][:3] / np.linalg.norm(m["mp_pos"][:3], axis=1, keepdims=True)
    m["mp_dmin"][:3] = 0.1
    m["mp_dmax"][:3] = 100.0
    m["mp_nobs"][:3] = [5, 6, 2]
    m["obs_mat"][0, 2] = True
    m["obs_mat"][1, :2] = True  # the sources are seen from another keyframe
    return m


def test_fuse_two_merges_name_one_loser():
    """JAX leaves the order of its scatter undefined when two sources name
    the same loser; the port lets the higher source index count.  What is
    defined must agree: the loser goes, both sources survive, the features
    bind to a survivor and no observation count is lost."""
    m = _duplicate_loser_map()
    src = np.zeros(MP, bool)
    src[:2] = True
    mj = jtr.fuse_map_points(jms.MapArrays(**{k: jnp.asarray(v) for k, v in m.items()}),
                             jnp.int32(0), jnp.asarray(src), jcfg().camera, jcfg())
    mt = ttr.fuse_map_points(tms.from_numpy(m), 0, tn(src), tcfg().camera, tcfg())
    for out in (jax.device_get(mj)._asdict(), tms.to_numpy(mt)):
        assert out["mp_valid"][:3].tolist() == [True, True, False]
        assert set(out["kf_mp"][0, :2].tolist()) <= {0, 1} and out["kf_mp"][0, 0] == out["kf_mp"][0, 1]
        assert int(out["mp_nobs"][:2].sum()) == 5 + 6 + 2
        assert not out["obs_mat"][:, 2].any()
    assert tms.to_numpy(mt)["kf_mp"][0, 0] == 1  # the last row naming point 2
    twice = ttr.fuse_map_points(tms.from_numpy(m), 0, tn(src), tcfg().camera, tcfg())
    assert all(torch.equal(a, b) for a, b in zip(mt, twice))


def test_scatter_set_last():
    dst = torch.arange(6, dtype=torch.int32)
    out = tms.scatter_set_last(dst, torch.tensor([1, 4, 1, 5, 1]), torch.tensor([7, 8, 9, 5, 11], dtype=torch.int32))
    assert out.tolist() == [0, 11, 2, 3, 8, 5] and dst.tolist() == list(range(6))
    ref = jnp.arange(6).at[jnp.asarray([1, 4, 1, 5, 1])].set(jnp.asarray([7, 8, 9, 5, 11]))
    assert out.tolist() == np.asarray(ref).tolist()  # the CPU backend runs its scatter in row order


def test_cull_map_points(stages):
    st = stages
    compare_maps(st["culled"], tms.cull_map_points(to_t(st["fused"]), int(st["slot"])), float_atol=0.0)
    # and with counters that make the cull bite
    rng = np.random.default_rng(1)
    m = st["fused"]._replace(
        mp_found=jnp.asarray(rng.integers(0, 3, MP).astype(np.int32)),
        mp_visible=jnp.asarray(rng.integers(1, 12, MP).astype(np.int32)),
        mp_nobs=jnp.asarray(rng.integers(1, 5, MP).astype(np.int32)),
    )
    mj = jms.cull_map_points(m, jnp.int32(4))
    assert int(jnp.sum(m.mp_valid)) > int(jnp.sum(mj.mp_valid)) > 0
    compare_maps(mj, tms.cull_map_points(to_t(m), 4), float_atol=0.0)


def test_update_point_stats(stages):
    """Descriptors (logical shifts on int32 bit patterns, ties to the lowest
    row) exact; normals and scale ranges 1e-5 relative (float sums)."""
    st = stages
    mt = tms.update_point_stats(to_t(st["culled"]), tn(st["mp_mask"]), n_levels=8, scale_factor=1.2)
    assert (np.asarray(st["stats"].mp_desc) != np.asarray(st["culled"].mp_desc)).any()
    compare_maps(st["stats"], mt, float_atol=1e-4, skip=("mp_dmin", "mp_dmax"))
    for k in ("mp_dmin", "mp_dmax"):
        np.testing.assert_allclose(tms.to_numpy(mt)[k][:-1], np.asarray(getattr(st["stats"], k))[:-1],
                                   rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize("boost", [0, 3])
def test_cull_keyframes(stages, boost):
    """On the map as it is, and with every point's observation count raised
    so that keyframes become redundant and the joint re-check decides."""
    st = stages
    m = st["ba"]._replace(mp_nobs=st["ba"].mp_nobs + boost)
    protect = np.zeros(KF, bool)
    protect[[0, int(st["slot"])]] = True
    mj = jms.cull_keyframes(m, st["kf_mask"], jnp.asarray(protect))
    mt = tms.cull_keyframes(to_t(m), tn(st["kf_mask"]), tn(protect))
    if boost:
        assert int(jnp.sum(m.kf_valid)) > int(jnp.sum(mj.kf_valid))
    compare_maps(mj, mt, float_atol=0.0)


def test_compact_map_points(stages):
    st = stages
    rng = np.random.default_rng(2)
    m = jms.cull_map_points(st["culled"]._replace(
        mp_found=jnp.asarray(rng.integers(0, 4, MP).astype(np.int32)),
        mp_visible=jnp.asarray(rng.integers(1, 9, MP).astype(np.int32))), jnp.int32(3))
    mj, nj, invj = jms.compact_map_points(m)
    mt, nt, invt = tms.compact_map_points(to_t(m))
    assert int(nt) == int(nj) < int(st["n_mp"])
    np.testing.assert_array_equal(invt.numpy(), np.asarray(invj))
    mj, mt = jax.device_get(mj)._asdict(), tms.to_numpy(mt)
    for k in mj:  # every slot compared: compaction moves the scratch slot too
        np.testing.assert_array_equal(mt[k], np.asarray(mj[k]), err_msg=k)
    bind = rng.integers(-1, MP, NF).astype(np.int32)
    np.testing.assert_array_equal(
        tms.remap_point_bindings(tn(bind), invt).numpy(),
        np.asarray(jms.remap_point_bindings(jnp.asarray(bind), invj)))
    _, _, inv2j = jms.compact_map_points(jms.MapArrays(**{k: jnp.asarray(v) for k, v in mj.items()}))
    _, _, inv2t = tms.compact_map_points(tms.from_numpy(mt))
    np.testing.assert_array_equal(
        tms.compose_point_remaps(invt, inv2t).numpy(),
        np.asarray(jms.compose_point_remaps(invj, inv2j)))


def _ba_problem(seed=0, KW=3, n_anchor=2, M=160):
    """A small window: KW free poses (the first fixes the gauge), anchors,
    points seen by all, pixel noise and a few gross outliers."""
    rng = np.random.default_rng(seed)
    K = KW + n_anchor
    pts = np.c_[rng.uniform(-2, 2, (M, 2)), rng.uniform(3, 7, M)].astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (K + 1, 1, 1))
    t = np.r_[rng.uniform(-0.2, 0.2, (K, 3)), np.zeros((1, 3))].astype(np.float32)
    t[0] = 0
    pose_idx = np.repeat(np.arange(K), M).astype(np.int32)
    point_idx = np.tile(np.arange(M), K).astype(np.int32)
    xc = pts[point_idx] + t[pose_idx]
    uv = np.c_[FX * xc[:, 0] / xc[:, 2] + PARAMS[2], FX * xc[:, 1] / xc[:, 2] + PARAMS[3]]
    uv = uv + rng.normal(0, 0.5, uv.shape)
    uv[rng.uniform(size=len(uv)) < 0.03] += 25.0
    bf = FX * BASELINE
    is_st = rng.uniform(size=len(uv)) < 0.6
    obs = dict(
        pose_idx=pose_idx, wpose_idx=np.minimum(pose_idx, KW).astype(np.int32), point_idx=point_idx,
        uv=uv.astype(np.float32), uv_r=(uv[:, 0] - bf / xc[:, 2]).astype(np.float32),
        inv_sigma2=rng.choice([1.0, 1 / 1.44], len(uv)).astype(np.float32),
        is_stereo=is_st, valid=rng.uniform(size=len(uv)) < 0.95,
    )
    t_noisy = t + np.r_[np.zeros((1, 3)), rng.normal(0, 0.02, (KW - 1, 3)), np.zeros((n_anchor + 1, 3))].astype(np.float32)
    pts_noisy = pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)
    fixed = np.zeros(KW, bool)
    fixed[0] = True
    return R, t_noisy.astype(np.float32), pts_noisy, obs, np.arange(KW, dtype=np.int32), fixed, bf


@pytest.mark.parametrize("seed", [0, 1])
def test_window_bundle_adjust(seed):
    """The dense-Schur LM solve on a synthetic window: poses R 1e-4, t 1e-3,
    points 1e-3 median, inlier count within 1%."""
    R, t, pts, obs, slots, fixed, bf = _ba_problem(seed)
    rj = jwba.window_bundle_adjust(
        jcfg().camera, jnp.asarray(R), jnp.asarray(t), jnp.asarray(pts),
        jwba.WindowObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
        jnp.asarray(slots), jnp.asarray(fixed), jnp.zeros(len(pts), bool), bf=bf, n_iters=4, n_iters_final=3)
    tobs = twba.from_numpy(obs)
    assert {k: v.dtype for k, v in twba.to_numpy(tobs).items()} == {k: v.dtype for k, v in obs.items()}
    rt = twba.window_bundle_adjust(
        tcfg().camera, tn(R), tn(t), tn(pts), tobs, tn(slots), tn(fixed),
        torch.zeros(len(pts), dtype=torch.bool), bf=bf, n_iters=4, n_iters_final=3)
    np.testing.assert_allclose(rt.Rcw.numpy(), np.asarray(rj.Rcw), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.tcw.numpy(), np.asarray(rj.tcw), rtol=0, atol=1e-3)
    assert np.median(np.linalg.norm(rt.points.numpy() - np.asarray(rj.points), axis=1)) < 1e-3
    nj, nt_ = int(jnp.sum(rj.inlier)), int(rt.inlier.sum())
    assert abs(nt_ - nj) <= 0.01 * nj and nj < int(obs["valid"].sum())  # outliers were found
    assert float(rt.cost) == pytest.approx(float(rj.cost), rel=1e-3)
    assert np.abs(np.asarray(rj.tcw) - t).max() > 5e-3  # the solve moved the poses
    np.testing.assert_array_equal(rt.Rcw.numpy()[[0, 3, 4, 5]], R[[0, 3, 4, 5]])  # gauge, anchors, scratch


def test_local_ba(stages):
    """Poses R 1e-4, t 1e-3, points 1e-3 median; bindings, observation
    rows and the inlier classification behind them equal on >= 99%."""
    st = stages
    mt = ttr.local_ba(to_t(st["stats"]), int(st["slot"]), tcfg().camera, tcfg(),
                      window=tcfg().local_window, bf=st["bf"])
    a, b = jax.device_get(st["ba"])._asdict(), tms.to_numpy(mt)
    before = jax.device_get(st["stats"])
    assert np.abs(np.asarray(a["kf_tcw"]) - np.asarray(before.kf_tcw)).max() > 1e-3  # BA moved a pose
    np.testing.assert_allclose(b["kf_Rcw"], a["kf_Rcw"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(b["kf_tcw"], a["kf_tcw"], rtol=0, atol=1e-3)
    v = np.asarray(a["mp_valid"])
    assert np.median(np.linalg.norm(b["mp_pos"] - np.asarray(a["mp_pos"]), axis=1)[v]) < 1e-3
    for k in ("kf_mp", "obs_mat"):
        assert (b[k] == np.asarray(a[k])).mean() >= 0.99, k
    bound = lambda m: int((m["kf_mp"] >= 0).sum())
    assert abs(bound(b) - bound(a)) <= 0.01 * bound(a)
    for k in a:
        if k not in ("kf_Rcw", "kf_tcw", "mp_pos", "kf_mp", "obs_mat"):
            np.testing.assert_array_equal(b[k], np.asarray(a[k]), err_msg=k)


@pytest.mark.parametrize("call", [0, 1, 2])
def test_insert_keyframe_step(runs, call):
    """The whole mapper pass from the JAX package's state and arguments:
    the same allocation pointer (+-2), keyframes, bindings on >= 99% of
    features; poses R 1e-4, t 1e-3."""
    _, _, calls = runs
    args, kw, (mj, nj) = calls[call]
    m, slot, Rcw, tcw, fid, feats, mpf, uvr, depth, n_mp = args[:10]
    mt, nt_ = ttr.insert_keyframe_step(
        to_t(m), int(slot), tn(Rcw), tn(tcw), int(fid),
        torb.from_numpy(jax.device_get(feats)._asdict()), tn(mpf), tn(uvr), tn(depth), int(n_mp),
        tcfg().camera, tcfg(), n_neighbors=kw["n_neighbors"], bf=kw["bf"], has_depth=kw["has_depth"])
    assert nt_.dim() == 0 and abs(int(nt_) - int(nj)) <= 2
    a, b = jax.device_get(mj)._asdict(), tms.to_numpy(mt)
    for k in ("kf_valid", "kf_frame_id", "kf_parent"):
        np.testing.assert_array_equal(b[k], np.asarray(a[k]), err_msg=k)
    for k in ("kf_mp", "mp_valid", "mp_nobs", "obs_mat"):
        assert (b[k] == np.asarray(a[k])).mean() >= 0.99, k
    np.testing.assert_allclose(b["kf_Rcw"], a["kf_Rcw"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(b["kf_tcw"], a["kf_tcw"], rtol=0, atol=1e-3)


def test_insert_keyframe_step_inertial_caller_raises(runs):
    args, kw, _ = runs[2][0]
    m, slot, Rcw, tcw, fid, feats, mpf, uvr, depth, n_mp = args[:10]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.insert_keyframe_step(
            to_t(m), int(slot), tn(Rcw), tn(tcw), int(fid),
            torb.from_numpy(jax.device_get(feats)._asdict()), tn(mpf), tn(uvr), tn(depth), int(n_mp),
            tcfg().camera, tcfg(), visual_ba=False)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_stereo_slam_slice(runs, frames):
    """16 stereo frames of full SLAM: states equal, keyframes on the same
    frames, allocation pointer within 2%, metric accuracy no worse than the
    JAX run's, camera centres within 2 mm (measured below 0.01 mm) except
    frame 1 within 5 mm: it starts from frame 0's pose with no motion
    model, the 12 Gauss-Newton steps stop short of convergence from that
    far, and last-bit differences show as millimetres (measured 3.5 mm)."""
    js, ts, calls = runs
    assert [r.state for r in ts.trajectory] == [r.state for r in js.trajectory] == [OK] * N_FRAMES
    assert ts.n_kf == js.n_kf >= 3 and ts.kf_inserted == len(calls) == js.kf_inserted
    np.testing.assert_array_equal(ts.kf_frame_ids, js.kf_frame_ids)
    assert abs(ts.n_mp - js.n_mp) <= 0.02 * js.n_mp and ts.n_mp > 400
    pt, pj = ts.positions(), js.positions()
    assert pt.shape == (N_FRAMES, 3) and np.all(np.isfinite(pt))
    np.testing.assert_allclose(pt[1], pj[1], rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.delete(pt, 1, 0), np.delete(pj, 1, 0), rtol=0, atol=2e-3)
    poses = frames[0]
    gt = (np.asarray([t for _, t in poses]) - poses[0][1]) @ poses[0][0]
    rmse = lambda p: float(np.sqrt((np.linalg.norm(p - gt, axis=1) ** 2).mean()))
    assert rmse(pt) <= rmse(pj) + 1e-3
    assert abs(int(ts.m.mp_valid.sum()) - int(jnp.sum(js.m.mp_valid))) <= 0.02 * ts.n_mp


def test_rgbd_slam_outside_localisation_mode(runs, frames):
    """``RGBDSLAM`` with the mapper on, over the first 9 frames (left image
    and its depth): it inserts keyframes where the JAX package does."""
    js = jsys.RGBDSLAM(jcfg())
    ts = RGBDSLAM(tcfg(), device=CPU)
    for i, (left, _, depth) in enumerate(frames[1][:9]):
        js.process(left, depth, i)
        ts.process(left, depth, i)
    assert [r.state for r in ts.trajectory] == [r.state for r in js.trajectory]
    assert ts.n_kf == js.n_kf >= 2
    np.testing.assert_array_equal(ts.kf_frame_ids, js.kf_frame_ids)
    assert abs(ts.n_mp - js.n_mp) <= 0.02 * js.n_mp
    np.testing.assert_allclose(ts.positions(), js.positions(), rtol=0, atol=5e-3)


def test_refill_free_slots_reanchors_records(runs):
    """Host bookkeeping of a culled keyframe: records anchored to it move to
    its spanning-tree parent, the slot becomes free, and the next
    allocation at capacity recycles it - as in the JAX package."""
    js, ts, _ = runs
    dead = int(js.trajectory[5].ref_slot)
    assert dead not in (0, js.last_kf_slot)
    snap = lambda s: [(r.ref_slot, None if r.rel_R is None else r.rel_R.copy(),
                       None if r.rel_t is None else r.rel_t.copy()) for r in s.trajectory]
    before = [snap(js), snap(ts)]
    try:
        for s in (js, ts):
            kf_valid = np.array(s.m.kf_valid.cpu() if isinstance(s.m.kf_valid, torch.Tensor) else s.m.kf_valid)
            kf_valid[dead] = False
            s._refill_free_slots(kf_valid)
        # the mapper may have culled keyframes of its own during the run
        want = [int(s) for s in np.flatnonzero(~kf_valid[: js.n_kf]) if s != js.last_kf_slot]
        assert dead in want
        assert ts.free_kf_slots == js.free_kf_slots == want and ts._dead_slots == js._dead_slots
        pos_t, pos_j = ts.positions(), js.positions()
        np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=5e-3)
        for rt, rj in zip(ts.trajectory, js.trajectory):
            assert rt.ref_slot == rj.ref_slot != dead
        n_kf = ts.n_kf
        ts.n_kf = ts.cfg.max_keyframes
        assert ts._can_insert_kf()
        assert [ts._alloc_kf_slot() for _ in want] == want and ts._alloc_kf_slot() is None
        ts.n_kf = n_kf
    finally:
        for s, snp in zip((js, ts), before):
            for r, (slot, R, t) in zip(s.trajectory, snp):
                r.ref_slot, r.rel_R, r.rel_t = slot, R, t
            s.free_kf_slots, s._dead_slots = [], set()


def test_compaction_and_reset(frames):
    """A point table small enough that the allocator passes 85% within the
    run: the facade compacts it, remaps the bindings in flight, and goes on
    tracking; ``reset`` then drops map and state."""
    ts = StereoSLAM(tcfg(max_map_points=560), device=CPU)
    compactions = []
    orig = tms.compact_map_points
    tms.compact_map_points = lambda m: compactions.append(1) or orig(m)
    try:
        for i, (left, right, _) in enumerate(frames[1]):
            ts.process(left, right, i)
    finally:
        tms.compact_map_points = orig
    assert compactions and ts.n_kf >= 3
    assert all(r.state == OK for r in ts.trajectory)
    assert ts.n_mp <= 560 and int(ts.m.mp_valid.sum()) <= ts.n_mp
    bound = ts.m.kf_mp[ts.m.kf_mp >= 0].long()
    assert bool(ts.m.mp_valid[bound].all())  # no binding points at a freed slot
    gt = (np.asarray([t for _, t in frames[0]]) - frames[0][0][1]) @ frames[0][0][0]
    assert float(np.sqrt((np.linalg.norm(ts.positions() - gt, axis=1) ** 2).mean())) < 0.03
    ts.reset()
    assert ts.state == "NOT_INITIALIZED" and ts.n_kf == ts.n_mp == 0
    assert not bool(ts.m.kf_valid.any()) and ts.free_kf_slots == []
    ts.process(frames[1][0][0], frames[1][0][1], 100)
    assert ts.state == OK and ts.n_kf == 1


def test_unported_entry_points_name_their_step(frames):
    # loop closing (step 2b) is ported: with it on, a stereo system builds,
    # and a keyframe's detection is queued at insertion and finished at the
    # next frame boundary; only a correction of an inertial map raises, naming
    # step 3
    lc = StereoSLAM(tcfg(enable_loop_closing=True), device=CPU)
    left, right, _ = frames[1][0]
    lc.process(left, right, 0)
    lc._maybe_close_loop(0, None)
    assert lc._pending_loops and lc.process_batch([(left, right)], [1]) is not None
    assert not lc._pending_loops and bool(lc.loop_closer.db.present[0])
    lc.imu_stage = 1
    with pytest.raises(NotImplementedError, match="next steps 3"):
        lc.loop_closer._correct(lc, 0, 0, None)
    ts = StereoSLAM(tcfg(), device=CPU)
    assert ts.process_batch([], []) is None  # batch mode is ported (step 1)
    # relocalisation (step 2a) is ported: no result without a database, and a
    # database is queried
    assert ts._try_relocalize(None, 0) is None
    ts.reloc_db = db = _RecordingDatabase()
    assert ts._try_relocalize(SimpleNamespace(desc="desc", valid="valid"), 0) is None
    assert db.calls[0] == ("desc", "valid") and db.calls[1]["min_rel_score"] == 0.75
