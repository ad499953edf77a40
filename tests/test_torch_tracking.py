"""Parity of the port's map state, tracking step and RGB-D slice with the
JAX package, on the size of ``tests/test_rgbd.py``: 320x240, 600 features,
2048 map points, frames rendered from ``BoxRoom`` with exact depth.

States cross between the packages as dicts of numpy arrays
(``map_state.to_numpy`` / ``from_numpy``); descriptors as uint32 <-> int32
views.  The scratch map-point slot MP-1 is never compared.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.pipeline import map_state as jms
from orb_slam3_noted_tpu.pipeline import system as jsys
from orb_slam3_noted_tpu.pipeline import tracking as jtr
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from orb_slam3_noted_tpu_torch.pipeline import tracking as ttr
from orb_slam3_noted_tpu_torch.pipeline.system import OK, RGBDSLAM
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory

W, H = 320, 240
PARAMS = (260.0, 260.0, 160.0, 120.0)
N_FRAMES = 8
CFG_KW = dict(
    width=W, height=H, n_features=600, max_keyframes=32, max_map_points=2048,
    local_window=4, kf_max_interval=6, bf=0.08 * PARAMS[0], th_depth=40.0,
)
# per-frame camera centres: the two packages round float32 sums in other
# orders, so a borderline match or inlier can flip; measured <= 0.7 mm
POS_TOL_M = 2e-3
INLIER_TOL = 5
# the first tracked frame is predicted at keyframe 0's own pose, where the
# octave prediction ceil(log(d_max / d) / log 1.2) lands on integers and the
# last bit of ``log`` decides it (ROADMAP Queue 3): 4 of 600 bindings differ
# on an AMD EPYC with AVX-512 (R 1.51e-4, t 1.18e-3 apart; within 1e-4 and
# 1e-3 on another x86 CPU); every later frame agrees to 1e-7
FIRST_R_ATOL, FIRST_T_ATOL = 2e-4, 1.5e-3


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
    for Rwc, twc in orbit_trajectory(N_FRAMES, forward=0.03):
        img, depth = room.render(Rwc, twc, PARAMS, W, H, return_depth=True)
        out.append((img.astype(np.uint8), depth.astype(np.float32)))
    return out


def _jax_slam():
    s = jsys.RGBDSLAM(JConfig(camera=JCamera(0, PARAMS), **CFG_KW))
    s.set_localization_mode(True)
    return s


def _torch_slam():
    s = RGBDSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW), device=torch.device("cpu"))
    s.set_localization_mode(True)
    return s


@pytest.fixture(scope="module")
def laps(frames):
    """Both packages over the same frames; the JAX run also records every
    ``track_frame`` call's inputs and outputs."""
    js, ts = _jax_slam(), _torch_slam()
    calls = []
    orig = jtr.track_frame

    def recording(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out

    maps_after_init = None
    jtr.track_frame = recording
    try:
        for i, (img, depth) in enumerate(frames):
            js.process(img, depth, i)
            ts.process(img, depth, i)
            if i == 0:
                maps_after_init = (jax.device_get(js.m)._asdict(), tms.to_numpy(ts.m))
    finally:
        jtr.track_frame = orig
    return js, ts, calls, maps_after_init


def _compare_maps(mj: dict, mt: dict, float_atol: float, desc_share: float):
    assert set(mj) == set(mt)
    for k in mj:
        a, b = np.asarray(mj[k]), mt[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == "obs_mat":  # skip the scratch map-point slot MP-1
            a, b = a[:, :-1], b[:, :-1]
        elif k.startswith("mp_"):
            a, b = a[:-1], b[:-1]
        if k.endswith("_desc"):
            assert np.all(a == b, axis=-1).mean() >= desc_share, k
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=float_atol, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_map_numpy_roundtrip_and_empty_map():
    cfg = SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW)
    mt = tms.to_numpy(tms.empty_map(cfg, device=torch.device("cpu")))
    mj = jax.device_get(jms.empty_map(JConfig(camera=JCamera(0, PARAMS), **CFG_KW)))._asdict()
    _compare_maps(mj, mt, 0.0, 1.0)
    back = tms.to_numpy(tms.from_numpy(mj))
    for k in mj:
        np.testing.assert_array_equal(back[k], np.asarray(mj[k]))


@pytest.mark.parametrize("start", [0, 9])
def test_add_map_points_at_capacity(start):
    """Dense packing from ``start``; past the table's end the accepted
    candidates are dropped and counted (``report_saturation``)."""
    from orb_slam3_noted_tpu_torch.utils import timing

    kw = dict(CFG_KW, n_features=32, max_keyframes=4, max_map_points=16)
    rng = np.random.default_rng(start)
    n = 20
    args = dict(
        pos=rng.normal(size=(n, 3)).astype(np.float32),
        desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
        dmin=rng.uniform(0.5, 1, n).astype(np.float32),
        dmax=rng.uniform(2, 5, n).astype(np.float32),
        accept=rng.uniform(size=n) < 0.7,
        feat_a=rng.permutation(32)[:n].astype(np.int32),
        feat_b=rng.permutation(32)[:n].astype(np.int32),
    )
    mj = jms.add_map_points(
        jms.empty_map(JConfig(camera=JCamera(0, PARAMS), **kw)), jnp.int32(start),
        *(jnp.asarray(args[k]) for k in ("pos", "desc", "normal", "dmin", "dmax")),
        jnp.int32(1), jnp.asarray(args["accept"]), jnp.int32(1), jnp.asarray(args["feat_a"]),
        jnp.int32(2), jnp.asarray(args["feat_b"]),
    )
    before = timing.SATURATION["map_point_capacity"]
    t = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v) for k, v in args.items()}
    mt = tms.add_map_points(
        tms.empty_map(SlamConfig(camera=Camera(PINHOLE, PARAMS), **kw), device=torch.device("cpu")),
        start, t["pos"], t["desc"], t["normal"], t["dmin"], t["dmax"], 1, t["accept"],
        1, t["feat_a"], 2, t["feat_b"],
    )
    _compare_maps(jax.device_get(mj)._asdict(), tms.to_numpy(mt), 0.0, 1.0)
    dropped = max(0, start + int(args["accept"].sum()) - 15)
    assert timing.SATURATION["map_point_capacity"] - before == dropped
    assert (dropped > 0) == (start > 0)


def test_stereo_initialisation_map(laps):
    """Frame 0: keyframe from depth, every valid-depth feature a point."""
    js, ts, _, (mj, mt) = laps
    assert js.n_mp == ts.n_mp > 300
    # float fields: keypoint rescale and IC angles differ in the last ulp
    _compare_maps(mj, mt, float_atol=1e-4, desc_share=0.99)


def test_track_frame_on_carried_map(laps):
    """The port's track_frame on the JAX package's own map, features and
    prediction for every tracked frame of the lap."""
    js, _, calls, _ = laps
    assert len(calls) == N_FRAMES - 1
    for k, (args, kw, out) in enumerate(calls):
        m, feats, Rp, tp, mask = args[:5]
        cfg = SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW)
        res = ttr.track_frame(
            tms.from_numpy(jax.device_get(m)._asdict()),
            torb.from_numpy(jax.device_get(feats)._asdict()),
            torch.from_numpy(np.array(Rp)), torch.from_numpy(np.array(tp)),
            torch.from_numpy(np.array(mask)), cfg.camera, cfg,
            feat_uvr=torch.from_numpy(np.array(kw["feat_uvr"])), bf=kw["bf"],
        )
        Rj, tj, nj, mpj, visj, keepj = (np.asarray(x) for x in out)
        Rt, tt, nt, mpt, vist, keept = (x.numpy() for x in res)
        np.testing.assert_allclose(Rt, Rj, rtol=0, atol=FIRST_R_ATOL if k == 0 else 1e-4)
        np.testing.assert_allclose(tt, tj, rtol=0, atol=FIRST_T_ATOL if k == 0 else 1e-3)
        assert abs(int(nt) - int(nj)) <= INLIER_TOL
        np.testing.assert_array_equal(vist, visj)
        assert (mpt == mpj).mean() >= 0.99
        assert (keept == keepj).mean() >= 0.99


def test_rgbd_localization_slice(laps, frames):
    """The slice end to end: same states every frame, camera centres within
    POS_TOL_M, inlier counts within INLIER_TOL, and metric accuracy."""
    js, ts, _, _ = laps
    assert [r.state for r in ts.trajectory] == [r.state for r in js.trajectory]
    assert all(r.state == OK for r in ts.trajectory)
    for rt, rj in zip(ts.trajectory, js.trajectory):
        assert abs(rt.n_inliers - rj.n_inliers) <= INLIER_TOL
    pt, pj = ts.positions(), js.positions()
    assert pt.shape == (N_FRAMES, 3) and np.all(np.isfinite(pt))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POS_TOL_M)
    poses = orbit_trajectory(N_FRAMES, forward=0.03)
    gt = np.asarray([t for _, t in poses])
    gt_c0 = (gt - poses[0][1]) @ poses[0][0]
    rmse = lambda p: float(np.sqrt((np.linalg.norm(p - gt_c0, axis=1) ** 2).mean()))
    # 8 frames spread over the whole orbit move ~4 cm each: both packages
    # land ~1 cm off ground truth (measured 1.2 cm rmse for both)
    assert rmse(pt) <= rmse(pj) + 1e-3 and rmse(pt) < 0.03
    # the localisation map is frozen: keyframes and points as after init
    assert ts.n_kf == js.n_kf == 1 and ts.n_mp == js.n_mp
    # visibility counters carried across frames
    mt, mj = tms.to_numpy(ts.m), jax.device_get(js.m)._asdict()
    for k in ("mp_visible", "mp_found"):
        assert (mt[k][:-1] == np.asarray(mj[k])[:-1]).mean() >= 0.97, k
    assert ck.launch_counts() == {"fast_candidates": 0, "gaussian_blur7": 0, "brief_sample": 0,
                                  "sad_stereo": 0, "fast_score": 0}


def test_shared_constant_tensors_survive_a_lap(laps):
    """The camera parameters, the level tables and the per-slot levels are
    one cached tensor each, shared by every frame (and aliased by
    ``FrameFeatures.level``): after the lap each still holds the values a
    fresh one gets, so nothing on the path wrote into one in place."""
    from orb_slam3_noted_tpu_torch.ops import fast as tfast
    from orb_slam3_noted_tpu_torch.ops import image as timage

    ts = laps[1]
    cfg, cpu = ts.cfg, torch.device("cpu")
    sizes = tuple(timage.pyramid_sizes(H, W, cfg.n_levels, cfg.scale_factor))
    budgets = tuple(tfast.level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor))
    hits = torb._level_of_feature.cache_info().hits
    pairs = [
        (ts.cam.params_array(torch.float32, cpu), torch.tensor(PARAMS, dtype=torch.float32)),
        (ttr._scale_table(cfg, ts.m.mp_pos),
         torch.tensor(torb.scale_factors(cfg.n_levels, cfg.scale_factor), dtype=torch.float32)),
        (torb._level_of_feature(budgets, cpu), torb._level_of_feature.__wrapped__(budgets, cpu)),
        (torb._level_to_image_scale(sizes, torch.float32, cpu),
         torch.tensor([(W / w, H / h) for h, w in sizes], dtype=torch.float32)),
        *zip(timage.level_tables(sizes, cpu), timage.level_tables.__wrapped__(sizes, cpu)),
    ]
    # the lap made these very entries: the lookups above were cache hits
    assert torb._level_of_feature.cache_info().hits == hits + 1
    for cached, fresh in pairs:
        assert cached.data_ptr() != fresh.data_ptr() and torch.equal(cached, fresh)


def test_unported_paths_raise(frames):
    from orb_slam3_noted_tpu_torch.geometry.sim3_solver import Sim3Result
    from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM, StereoSLAM

    ts = _torch_slam()
    cpu = torch.device("cpu")
    # the reference's RGB-D facade inherits the stereo batch hooks, which
    # SAD-match the depth map as a right image: the keyframes its batch mode
    # inserts keep other rows than u - bf / d.  The port's batch mode (which
    # used to raise here) reads the depth map as process does.
    jcfg = JConfig(camera=JCamera(0, PARAMS), **CFG_KW)
    jb, tb = jsys.RGBDSLAM(jcfg), RGBDSLAM(ts.cfg, device=cpu)
    share = []
    for s in (jb, tb):
        s.process(frames[0][0], frames[0][1], 0)
        s.process_batch(frames[1:], list(range(1, len(frames))))
        assert len(s.trajectory) == len(frames) and s.trajectory[-1].state == OK
        share.append(_depth_rule_share(s, frames))
    assert share[0] < 0.5 and share[1] == 1.0, share
    # monocular SLAM is ported: its first frame becomes the reference frame
    mono = MonoSLAM(ts.cfg, device=cpu)
    rec = mono.process(frames[0][0], 0)
    assert rec.state == "NOT_INITIALIZED" and mono.ref_frame_id == 0
    # loop closing is ported (step 2b): an RGB-D system with it on builds,
    # queues each keyframe's detection on the device and finishes it at
    # flush(); a correction of an inertial map (step 3) runs the 4-DoF graph
    lc = RGBDSLAM(dataclasses.replace(ts.cfg, enable_loop_closing=True), device=cpu)
    assert lc.loop_closer is None
    lc.process(frames[0][0], frames[0][1], 0)
    lc._maybe_close_loop(0, None)
    assert len(lc._pending_loops) == 1 and lc.loop_closer.device == cpu
    assert lc.flush() is lc and not lc._pending_loops
    assert lc.loop_closer.db.present[0] and lc.loop_closer.loops_closed == 0
    assert lc._reloc_database() is lc.loop_closer.db
    lc.imu_stage = 1
    R0 = lc.m.kf_Rcw.clone()
    lc.loop_closer._correct(lc, 0, 0, Sim3Result(
        success=torch.tensor(True), R=torch.eye(3), t=torch.zeros(3), s=torch.tensor(1.0),
        inliers=None, n_inliers=torch.tensor(30)))
    assert torch.equal(lc.m.kf_Rcw, R0) and lc.loop_closer.active_gba is not None
    # the two-camera (fisheye) rig is ported (step 4): a rig with a second
    # camera gets its rows' camera and extrinsic, a single camera none
    from orb_slam3_noted_tpu_torch.pipeline.tracking import _second_camera
    assert _second_camera(ts.cfg, cpu) == (None, None, None)
    cam2, Rrl, trl = _second_camera(dataclasses.replace(ts.cfg, camera2=ts.cfg.camera), cpu)
    assert cam2 == ts.cfg.camera and torch.equal(Rrl, torch.eye(3)) and not trl.any()
    assert StereoSLAM(dataclasses.replace(ts.cfg, enable_loop_closing=True),
                      device=cpu).loop_closer is None
    # relocalisation is ported: without a database there is no result, and a
    # database is queried (the full candidate policy, with covisibility)
    assert ts.reloc_db is None and ts._try_relocalize(None, 0) is None
    ts.reloc_db = db = _RecordingDatabase()
    assert ts._try_relocalize(SimpleNamespace(desc="desc", valid="valid"), 0) is None
    assert db.calls[0] == ("desc", "valid") and db.calls[1]["n_best"] == 3
    assert db.calls[1]["covis"].shape == (ts.cfg.max_keyframes,) * 2


def _depth_rule_share(slam, frames) -> float:
    """Share of the depth-rule rows (``u - bf / d`` from the frame's depth
    map, where it gives a value) that the keyframes ``process_batch``
    inserted keep in ``kf_uvr``, within 1e-3 px; either package's facade."""
    m = (tms.to_numpy(slam.m) if isinstance(slam.m, tms.MapArrays)
         else jax.device_get(slam.m)._asdict())
    slots = np.flatnonzero(np.asarray(slam.kf_frame_ids) > 0)
    assert len(slots) > 0  # a keyframe inserted by the batch walk
    n_rule = n_same = 0
    for s in slots:
        feats = SimpleNamespace(xy=torch.tensor(m["kf_xy"][s]),
                                valid=torch.tensor(m["kf_feat_valid"][s]))
        dmap = torch.from_numpy(frames[int(slam.kf_frame_ids[s])][1])
        _, want = ttr.rgbd_depth_rows(feats, dmap, slam.cfg.bf)
        ok = want.numpy() >= 0
        n_rule += int(ok.sum())
        n_same += int((np.abs(m["kf_uvr"][s] - want.numpy())[ok] <= 1e-3).sum())
    assert n_rule > 100
    return n_same / n_rule


class _RecordingDatabase:
    """Stands in for a keyframe database: records the queries, finds no
    candidate."""

    def __init__(self):
        self.calls = []

    def compute_bow(self, desc, valid):
        self.calls.append((desc, valid))
        return None, None

    def detect_candidates(self, bow, exclude, **kw):
        self.calls.append(kw)
        return [], []


def test_stereo_points_from_depth(laps, frames):
    """Candidates from depth on the JAX package's init keyframe."""
    js, _, _, (mj, _) = laps
    cfg = SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW)
    rng = np.random.default_rng(0)
    depth = np.where(rng.uniform(size=600) < 0.8, rng.uniform(0.5, 9.0, 600), -1.0).astype(np.float32)
    mj_empty = dict(mj, kf_mp=np.full_like(np.asarray(mj["kf_mp"]), -1))
    outj = jtr.stereo_points_from_depth(
        jms.MapArrays(**{k: jnp.asarray(v) for k, v in mj_empty.items()}), jnp.int32(0),
        jnp.asarray(depth), js.cam, js.cfg, bf=js.cfg.bf,
    )
    outt = ttr.stereo_points_from_depth(
        tms.from_numpy(mj_empty), 0, torch.from_numpy(depth), cfg.camera, cfg, bf=cfg.bf,
    )
    for a, b in zip(outj, outt):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(b.view(a.dtype) if a.dtype == np.uint32 else b, a)
