"""Parity of the port's visual-inertial facades (``pipeline/inertial_system.py``)
and the 4-DoF pose graph with the JAX package on the CPU.

``StereoInertialSLAM.process_batch`` on the 320x240 lap of
``tests/test_vi_batch.py`` (32 frames at 10 fps, batches of 8, exact IMU at
200 Hz; the same renders and IMU samples in both packages): every batched
VI tracking dispatch of the JAX run replayed through the port's
``vi_track_batch`` on the JAX run's map, features and IMU spans (poses,
velocities, inliers, bindings, counters), the IMU initialisation solve
replayed on the JAX run's chain, and the lap held on aggregates: tracked >=
JAX - 2, ``imu_stage`` equal, keyframes +-2, metric ATE <= 2 x JAX + 2 mm,
per-frame positions within ``POS_TOL_M``.

The monocular-inertial lap is ``tests/test_torch_vi_mono.py``'s.

``optimize_pose_graph_4dof`` on the drifted map of ``scripts/loop_scaffold.py``
against the JAX run stored in ``tests/fixtures/loop_4dof_full.json``: poses
within 1e-4, roll and pitch of every keyframe unchanged to 1e-5 rad.
"""

import base64
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera, PINHOLE as JPINHOLE
from orb_slam3_noted_tpu.optim import pose_graph as jpg
from orb_slam3_noted_tpu.pipeline import inertial_system as jis
from orb_slam3_noted_tpu_torch.imu import preintegration as P
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.optim import pose_graph as tpg
from orb_slam3_noted_tpu_torch.optim.inertial import inertial_init
from orb_slam3_noted_tpu_torch.pipeline import inertial_system as tis
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from orb_slam3_noted_tpu_torch.pipeline.system import OK
from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, stereo_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import loop_scaffold as LS  # noqa: E402

import test_vi_batch as VIB  # noqa: E402

CPU = torch.device("cpu")
W, H = 320, 240
BATCH = 8
TRACKED_MARGIN, ATE_FACTOR, ATE_SLACK_M, KF_MARGIN = 2, 2.0, 0.002, 2
POS_TOL_M = 0.01
GRAPH_TOL, TILT_TOL = 1e-4, 1e-5


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


def vi_cfg_kw():
    return dict(width=W, height=H, fps=VIB.FPS, n_features=600, bf=VIB.FX * VIB.BASELINE,
                th_depth=35.0, max_keyframes=32, max_map_points=4096, local_window=5,
                kf_max_interval=4, min_tracked_points=12, imu_init_time=1.0,
                imu_viba1_time=1e9, imu_viba2_time=1e9, imu_init_min_kfs=4, inertial_window=6,
                imu_noise_gyro=1e-4, imu_noise_acc=1e-3, imu_walk_gyro=1e-6,
                imu_walk_acc=1e-5, imu_freq=VIB.IMU_HZ)


@pytest.fixture(scope="module")
def vi_inputs():
    """The stereo pairs, frame times, ground-truth centres and the IMU chunk
    of each batch of ``tests/test_vi_batch.py``'s lap."""
    room = BoxRoom(seed=0, depth=2.5, h=1.2, w=1.8)
    n = 32
    frames, times, gt = [], [], []
    for i in range(n):
        t = i / VIB.FPS
        Rwc, twc = VIB.cam_pose(t)
        left, right, _ = stereo_pair(room, Rwc, twc, VIB.CAM.params, W, H, VIB.BASELINE)
        frames.append((left.astype(np.uint8), right.astype(np.uint8)))
        times.append(t)
        gt.append(twc)
    chunks, t_prev = [], -1.0 / VIB.FPS
    for s0 in range(0, n, BATCH):
        parts = []
        for j in range(s0, min(s0 + BATCH, n)):
            parts.append(VIB.imu_between(t_prev, times[j]))
            t_prev = times[j]
        chunks.append(tuple(np.concatenate(x) for x in zip(*parts)))
    return frames, times, np.asarray(gt), chunks


def drive_vi(slam, inp):
    frames, times, _, chunks = inp
    for c, s0 in enumerate(range(0, len(frames), BATCH)):
        s1 = min(s0 + BATCH, len(frames))
        a, g, ts = chunks[c]
        slam.process_batch(frames[s0:s1], list(range(s0, s1)), ts=times[s0:s1], acc=a, gyr=g,
                           imu_t=ts)
    return slam


@pytest.fixture(scope="module")
def vi_laps(vi_inputs):
    """(JAX system, its vi_track_batch calls, its inertial_init calls, port
    system)."""
    js = jis.StereoInertialSLAM(JConfig(camera=JCamera(JPINHOLE, VIB.CAM.params), **vi_cfg_kw()))
    calls, inits = [], []
    orig_tb, orig_init = jis.vi_track_batch, jis.inertial_init

    def recording_tb(*args, **kw):
        out = orig_tb(*args, **kw)
        calls.append(jax.device_get((args, kw, out)))
        return out

    def recording_init(*args, **kw):
        out = orig_init(*args, **kw)
        inits.append(jax.device_get((args, kw, out)))
        return out

    jis.vi_track_batch, jis.inertial_init = recording_tb, recording_init
    try:
        drive_vi(js, vi_inputs)
    finally:
        jis.vi_track_batch, jis.inertial_init = orig_tb, orig_init
    ts = tis.StereoInertialSLAM(SlamConfig(camera=Camera(PINHOLE, VIB.CAM.params), **vi_cfg_kw()),
                                device=CPU)
    return js, calls, inits, drive_vi(ts, vi_inputs)


def _metric_ate(slam, gt):
    ok = np.asarray([r.state == OK for r in slam.trajectory])
    return ate_rmse(slam.positions()[ok], gt[ok], with_scale=False)[0]


def test_stereo_inertial_lap_matches_jax(vi_laps, vi_inputs):
    js, calls, _, ts = vi_laps
    gt = vi_inputs[2]
    assert js.imu_stage >= 1 and len(calls) >= 2  # the batched VI path ran
    assert ts.imu_stage == js.imu_stage
    tracked = [sum(r.state == OK for r in s.trajectory) for s in (js, ts)]
    assert len(ts.trajectory) == len(js.trajectory) == 32
    assert tracked[1] >= tracked[0] - TRACKED_MARGIN, tracked
    ate_j, ate_t = _metric_ate(js, gt), _metric_ate(ts, gt)
    assert ate_t <= ATE_FACTOR * ate_j + ATE_SLACK_M, (ate_t, ate_j)
    assert abs(ts.kf_inserted - js.kf_inserted) <= KF_MARGIN
    assert abs(len(ts.kf_order) - len(js.kf_order)) <= KF_MARGIN
    d = np.linalg.norm(ts.positions() - js.positions(), axis=1)
    assert d.max() <= POS_TOL_M, d
    # the chain's bookkeeping: one segment per link, every chain slot a
    # live keyframe, the bias on the device
    assert len(ts.kf_segments) == len(ts.seg_preints) == len(ts.kf_order) - 1
    assert bool(ts.m.kf_valid[torch.tensor(ts.kf_order)].all())


def test_vi_track_batch_matches_jax(vi_laps):
    """Every batched tracking dispatch of the JAX lap, replayed on its own
    map, features, stereo rows and IMU spans (the JAX package pads each
    span to 512 samples; the port steps to the longest)."""
    _, calls, _, ts = vi_laps
    for args, kw, out in calls:
        (m, feats, uvr, slot, vel, bg, ba, acc, gyr, dts, calib) = args[:11]
        n_steps = int(max((np.asarray(dts) > 0).sum(axis=1).max(), 1))
        t = lambda a: torch.from_numpy(np.array(a))
        mt, Rs, tcw, n_inl, mp_feats, vels = tis.vi_track_batch(
            tms.from_numpy(m._asdict()), torb.from_numpy(feats._asdict()), t(uvr), int(slot),
            t(vel), t(bg), t(ba), t(acc), t(gyr), t(dts), n_steps,
            P.Calib(*(t(x) for x in calib)), ts.cam, ts.cfg, ts.cfg.bf, t(kw["count_mask"]))
        mjo, Rj, tj, nj, mpj, vj = out
        np.testing.assert_array_equal(n_inl.numpy(), nj)
        np.testing.assert_allclose(Rs.numpy(), Rj, rtol=0, atol=1e-4)
        np.testing.assert_allclose(tcw.numpy(), tj, rtol=0, atol=1e-4)
        np.testing.assert_allclose(vels.numpy(), vj, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(mp_feats.numpy(), mpj)
        np.testing.assert_array_equal(mt.mp_found.numpy(), mjo.mp_found)
        np.testing.assert_array_equal(mt.mp_visible.numpy(), mjo.mp_visible)


def test_imu_init_solve_of_the_lap_matches_jax(vi_laps):
    """The lap's IMU initialisation (scale fixed, the chain padded to a
    power of two) on the JAX run's body poses and preintegrations."""
    _, _, inits, _ = vi_laps
    assert inits
    for args, kw, res in inits:
        Rwb, twb, pre, valid = args
        t = lambda a: torch.from_numpy(np.array(a))
        tpre = P.Preintegrated(*(t(f) for f in pre[:-1]), bias=P.Bias(t(pre.bias.bg),
                                                                      t(pre.bias.ba)))
        out = inertial_init(t(Rwb), t(twb), tpre, t(valid), **kw)
        g_j, g_t = np.asarray(res.g_world, np.float64), out.g_world.numpy().astype(np.float64)
        ang = np.arccos(np.clip(g_j @ g_t / np.linalg.norm(g_j) / np.linalg.norm(g_t), -1, 1))
        assert ang <= 1e-3 and abs(float(out.scale) - float(res.scale)) <= 1e-3
        np.testing.assert_allclose(out.bg.numpy(), res.bg, atol=1e-4)
        np.testing.assert_allclose(out.ba.numpy(), res.ba, atol=1e-3)


# ---------------------------------------------------------------------------
# the 4-DoF pose graph

def test_pose_graph_4dof_matches_jax_and_keeps_gravity():
    with open(os.path.join(ROOT, "tests", "fixtures", "loop_4dof_full.json")) as f:
        ref = json.load(f)
    inp = LS.drifted_map_inputs(seed=0, baseline=LS.BASELINE, **LS.FULL)
    gr = LS.inertial_loop_graph(inp)
    E = len(gr["i"])
    t = lambda a: torch.from_numpy(np.array(a))
    edges = tpg.SE3Edges(t(gr["i"]), t(gr["j"]), t(gr["eR"]), t(gr["et"]), t(gr["weight"]),
                         torch.ones(E, dtype=torch.bool))
    R, tt, cost = tpg.optimize_pose_graph_4dof(t(gr["R"]), t(gr["t"]), edges, t(gr["fixed"]))
    K = ref["n_kf"]
    Rj = np.frombuffer(base64.b64decode(ref["kf_Rcw"]), "<f4").reshape(K, 3, 3)
    tj = np.frombuffer(base64.b64decode(ref["kf_tcw"]), "<f4").reshape(K, 3)
    np.testing.assert_allclose(R.numpy(), Rj, rtol=0, atol=GRAPH_TOL)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=0, atol=GRAPH_TOL)
    assert abs(float(cost) - ref["cost"]) <= 1e-3 * ref["cost"]
    # the graph moved the tail (a loop was corrected) but no keyframe's
    # gravity direction: Rcw z is the world's up in the camera frame
    assert float(np.abs(tt.numpy() - gr["t"]).max()) > 0.05
    up_new, up_old = R.numpy()[:, :, 2], gr["R"][:, :, 2]
    # the angle from the chord |u - v| = 2 sin(a / 2) (arccos of a dot
    # product near 1 rounds to ~3e-4 in float32)
    tilt = 2 * np.arcsin(np.clip(np.linalg.norm(up_new - up_old, axis=1) / 2, 0, 1))
    assert tilt.max() <= TILT_TOL, tilt


def test_pose_graph_4dof_small_matches_jax_run():
    """The SMALL scaffold through both packages' 4-DoF graph, live."""
    inp = LS.drifted_map_inputs(seed=1, baseline=LS.BASELINE)
    gr = LS.inertial_loop_graph(inp)
    E = len(gr["i"])
    je = jpg.SE3Edges(*(jnp.asarray(gr[k]) for k in ("i", "j", "eR", "et", "weight")),
                      valid=jnp.ones(E, bool))
    Rj, tj, cj = jax.device_get(jpg.optimize_pose_graph_4dof(
        jnp.asarray(gr["R"]), jnp.asarray(gr["t"]), je, jnp.asarray(gr["fixed"])))
    t = lambda a: torch.from_numpy(np.array(a))
    te = tpg.SE3Edges(t(gr["i"]), t(gr["j"]), t(gr["eR"]), t(gr["et"]), t(gr["weight"]),
                      torch.ones(E, dtype=torch.bool))
    R, tt, c = tpg.optimize_pose_graph_4dof(t(gr["R"]), t(gr["t"]), te, t(gr["fixed"]))
    np.testing.assert_allclose(R.numpy(), Rj, rtol=0, atol=GRAPH_TOL)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=0, atol=GRAPH_TOL)


def test_stage0_keyframe_at_capacity_repeats_the_chain_slot():
    """A fault of the reference's inertial facade, kept by the port (ROADMAP
    Queue 3): before the IMU is initialised, a keyframe decision at full
    capacity with no slot to recycle inserts nothing, yet the chain hook
    still runs on the last keyframe's slot, which enters the temporal
    chain a second time with a segment of its own."""
    kw = dict(vi_cfg_kw(), max_keyframes=4)
    facades = (jis.StereoInertialSLAM(JConfig(camera=JCamera(JPINHOLE, VIB.CAM.params), **kw)),
               tis.StereoInertialSLAM(SlamConfig(camera=Camera(PINHOLE, VIB.CAM.params), **kw),
                                      device=CPU))
    for s in facades:
        s.kf_order, s.kf_times, s.last_kf_slot = [3], [0.0], 3
        s.n_kf, s.free_kf_slots, s._cur_time = kw["max_keyframes"], [], 0.6
        s.since_kf = (np.zeros((2, 3)), np.zeros((2, 3)), np.full(2, 0.005))
        assert s._alloc_kf_slot() is None
        s._insert_keyframe(None, 6, None, None, None, 20)
        assert s.kf_order == [3, 3] and len(s.kf_segments) == 1 and s.kf_inserted == 0
