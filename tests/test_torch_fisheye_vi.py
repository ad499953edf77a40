"""Parity of the port's fisheye stereo-inertial slice with the JAX package on
the CPU, float32: the two-camera visual rows of the visual-inertial
residual (analytic in the port, ``jax.jacfwd`` of the JAX package's
residual here), ``vi_pose_optimization`` with right-camera rows, and
``FisheyeStereoInertialSLAM`` on a 12-frame lap at 10 frames/s (to the
IMU init) in both packages, on the same IMU samples.

The window of ``tests/test_vi_ba.py`` (6 body states along an analytic
trajectory, 96 landmarks) is observed here through a Kannala-Brandt pair
whose right camera is rotated against the left.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models import cameras as jcam
from orb_slam3_noted_tpu.optim import factors as JF
from orb_slam3_noted_tpu.optim import inertial_ba as JBA
from orb_slam3_noted_tpu.optim import vi_factors as JV
from orb_slam3_noted_tpu.optim.pose_opt import PoseObs as JPoseObs
from orb_slam3_noted_tpu.io import checkpoint as jck
from orb_slam3_noted_tpu.pipeline import inertial_system as jis
from orb_slam3_noted_tpu.pipeline import map_state as jms
from orb_slam3_noted_tpu.pipeline import tracking as jtr
from orb_slam3_noted_tpu.utils.synthetic import BoxRoom
from orb_slam3_noted_tpu_torch.imu import preintegration as P
from orb_slam3_noted_tpu_torch.io import checkpoint as tck
from orb_slam3_noted_tpu_torch.io.config import config_from
from orb_slam3_noted_tpu_torch.models import cameras as tcam
from orb_slam3_noted_tpu_torch.optim import factors as TF
from orb_slam3_noted_tpu_torch.optim import inertial_ba as TBA
from orb_slam3_noted_tpu_torch.optim import vi_factors as TV
from orb_slam3_noted_tpu_torch.optim.pose_opt import PoseObs
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.pipeline import inertial_system as tis
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from orb_slam3_noted_tpu_torch.pipeline import tracking as ttr
from test_fisheye_inertial import cam_pose, imu_between
from test_torch_fisheye import BASELINE, KB, KB2, rlr, rows_close
from test_torch_vi_ba import assert_states_close, t, tcalib, tpre, tstate
from test_vi_ba import make_problem

CPU = torch.device("cpu")
JAC_REL = 1e-4        # Jacobians, relative to each residual row's largest entry
RES_TOL_PX = 1e-3     # residuals, px
W = H = 384
FPS = 10.0
LAP_FRAMES = 12       # 1.1 s: the IMU init runs at the last frame
# the lap's camera centres: cam_pose moves the camera up to 7.6 cm between
# frames.  The packages part at frame 1, whose pose is predicted at keyframe
# 0's own pose: there the predicted octave ceil(log(d_max / d) / log 1.2)
# is an integer up to the last bit of float32, and 79 of 304 points take
# the other octave (test_lap_parts_at_the_keyframe_pose below); the
# difference grows along the lap to 12.8-13.4 mm (measured on two CPUs),
# while each package is 1-3 cm off the truth
LAP_POS_TOL_M = 0.02
OCTAVE_POSE_TOL_M = 1e-5  # frame 1's pose with the JAX package's octaves
LAP_GRAVITY_DEG = 0.5  # the IMU init's gravity (measured 0.15 deg apart)


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


def rig():
    Rrl = rlr().T
    return Rrl, (-Rrl @ np.array([BASELINE, 0, 0], np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def kb_window():
    """The window of tests/test_vi_ba.py seen through the fisheye pair: left
    pixels by KB8, right pixels (where the right camera sees the point) by
    the second camera through Rrl, trl; a perturbed start."""
    calib, st_true, pts, obs, edges = make_problem(dtype=jnp.float32)
    Rrl, trl = rig()
    Rcw, tcw = JV.cam_from_body(st_true, calib)
    xc = jnp.einsum("oij,oj->oi", Rcw[obs.pose_idx], pts[obs.point_idx]) + tcw[obs.pose_idx]
    xr = np.asarray(xc) @ Rrl.T + trl
    uv = jcam.project(jcam.Camera(1, KB), xc)
    uv2 = np.asarray(jcam.project(jcam.Camera(1, KB2), jnp.asarray(xr)))
    rng = np.random.default_rng(5)
    is_right = (xr[:, 2] > 0.2) & (rng.uniform(size=len(xr)) < 0.7)
    obs = obs._replace(uv=uv, uv2=jnp.asarray(np.where(is_right[:, None], uv2, -1.0)),
                       is_right=jnp.asarray(is_right))
    n_kf = st_true.twb.shape[0]
    dR = jnp.stack([jso3.exp(jnp.asarray(rng.normal(0, 0.02 if k >= 2 else 0.0, 3), jnp.float32))
                    for k in range(n_kf)])
    st0 = st_true._replace(Rwb=jnp.einsum("kij,kjl->kil", st_true.Rwb, dR),
                           twb=st_true.twb + jnp.asarray(
                               rng.normal(0, 0.03, (n_kf, 3)) * (np.arange(n_kf) >= 2)[:, None],
                               jnp.float32))
    return calib, st_true, st0, pts, obs, edges


def tobs(o) -> TF.ReprojObs:
    return TF.ReprojObs(*(None if x is None else t(np.asarray(x)) for x in o))


def test_two_camera_vi_rows_match_jacfwd(kb_window):
    """The port's analytic body-tangent Jacobians of the 5-row visual
    residual against ``jax.jacfwd`` of the JAX package's residual, through
    its ``retract``; residuals, chi2, ok and the landmark Jacobians against
    the JAX package's."""
    calib, _, st0, pts, obs, _ = kb_window
    Rrl, trl = rig()
    cam, cam2 = jcam.Camera(1, KB), jcam.Camera(1, KB2)
    K = st0.twb.shape[0]
    res = lambda st, p: JV.body_reproj_residuals(cam, st, calib, p, obs, cam2=cam2,
                                                 Rrl=jnp.asarray(Rrl), trl=jnp.asarray(trl))
    rj, _, Jlj, chi2j, okj = res(st0, pts)
    Jd = jax.jacfwd(lambda d: res(JV.retract(st0, d), pts)[0])(jnp.zeros((K, 15), jnp.float32))
    r, Jp, Jl, chi2, ok = TV.body_reproj_residuals(
        tcam.Camera(1, KB), tstate(st0), tcalib(calib), t(np.asarray(pts)), tobs(obs),
        cam2=tcam.Camera(1, KB2), Rrl=t(Rrl), trl=t(trl))
    assert r.shape[1] == 5
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=0, atol=RES_TOL_PX)
    np.testing.assert_allclose(chi2.numpy(), np.asarray(chi2j), rtol=1e-4, atol=1e-4)
    o = np.arange(r.shape[0])
    Jd_own = np.asarray(Jd)[o, :, np.asarray(obs.pose_idx), :6]  # the observing state's
    live = ok.numpy() & np.asarray(obs.is_right)
    assert live.sum() > 100
    rows_close(Jd_own[live], Jp.numpy()[live], JAC_REL, "Jp")
    rows_close(np.asarray(Jlj)[live], Jl.numpy()[live], JAC_REL, "Jl")
    # the right rows are live (not zero) where a right pixel is
    assert np.abs(Jp.numpy()[live, 3:]).max(axis=(1, 2)).min() > 0


def test_vi_pose_optimization_with_right_rows(kb_window):
    calib, st_true, _, pts, obs, edges = kb_window
    Rrl, trl = rig()
    anchor = jax.tree_util.tree_map(lambda x: x[0], st_true)
    ftrue = jax.tree_util.tree_map(lambda x: x[1], st_true)
    frame0 = JV.VIState(Rwb=ftrue.Rwb @ jso3.exp(jnp.asarray([0.02, -0.03, 0.01], jnp.float32)),
                        twb=ftrue.twb + jnp.asarray([0.05, -0.04, 0.06], jnp.float32),
                        vel=ftrue.vel, bg=ftrue.bg, ba=ftrue.ba)
    pre1 = jax.tree_util.tree_map(lambda x: x[0], edges.preint)
    sel = np.asarray(obs.pose_idx) == 1
    N = int(sel.sum())
    uv = np.asarray(obs.uv)[sel].copy()
    uv[::17] += 40.0  # gross outliers, so the inlier masks have something to decide
    z = np.zeros(N, np.float32)
    fields = dict(uv=uv, uv_r=z - 1.0, inv_sigma2=np.ones(N, np.float32),
                  is_stereo=np.zeros(N, bool), valid=np.asarray(obs.valid)[sel],
                  uv2=np.asarray(obs.uv2)[sel], is_right=np.asarray(obs.is_right)[sel])
    P3 = np.asarray(pts)[np.asarray(obs.point_idx)[sel]]
    jres = JBA.vi_pose_optimization(
        jcam.Camera(1, KB), calib, anchor, frame0, pre1, jnp.asarray(P3),
        JPoseObs(**{k: jnp.asarray(v) for k, v in fields.items()}), cam2=jcam.Camera(1, KB2),
        Rrl=jnp.asarray(Rrl), trl=jnp.asarray(trl))
    tres = TBA.vi_pose_optimization(
        tcam.Camera(1, KB), tcalib(calib), tstate(anchor), tstate(frame0),
        P.index(tpre(edges.preint), 0), t(P3), PoseObs(**{k: t(v) for k, v in fields.items()}),
        cam2=tcam.Camera(1, KB2), Rrl=t(Rrl), trl=t(trl))
    js = jax.tree_util.tree_map(lambda x: x[None], JV.VIState(*jres[:5]))
    assert_states_close(js, TV.VIState(*(x[None] for x in tres[:5])))
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert int(tres.n_inliers) == int(jres.n_inliers) > 80
    np.testing.assert_allclose(tres.twb.numpy(), np.asarray(ftrue.twb), atol=5e-3)


# ---------------------------------------------------------------------------
# FisheyeStereoInertialSLAM: a short lap in both packages

def lap_config() -> JConfig:
    """tests/test_fisheye_inertial.py's configuration, with the second
    camera and the rotated right camera of tests/test_torch_fisheye.py."""
    return JConfig(
        camera=jcam.Camera(1, KB), camera2=jcam.Camera(1, KB2), width=W, height=H, fps=FPS,
        n_features=700, bf=BASELINE * KB[0], th_depth=60.0,
        tlr_r=tuple(float(x) for x in rlr().reshape(-1)), tlr_t=(BASELINE, 0.0, 0.0),
        lapping_l=(0.0, float(W)), lapping_r=(0.0, float(W)),
        max_keyframes=32, max_map_points=8192, local_window=5, kf_max_interval=4,
        min_tracked_points=12, imu_init_time=0.8, imu_viba1_time=2.0, imu_viba2_time=1e9,
        imu_init_min_kfs=4, inertial_window=6, imu_noise_gyro=1e-4, imu_noise_acc=1e-3,
        imu_walk_gyro=1e-6, imu_walk_acc=1e-5, imu_freq=200.0)


@pytest.fixture(scope="module")
def lap_inputs():
    return make_lap_inputs()


def make_lap_inputs():
    """(pairs, frame times, IMU chunk per frame, camera centres), rendered
    and sampled by the JAX package; the right camera at Rwc Rlr."""
    room = BoxRoom(seed=5, depth=2.5, h=0.9, w=1.4)
    R = rlr().astype(np.float64)
    pairs, times, chunks, gt = [], [], [], []
    t_prev = -1.0 / FPS
    for i in range(LAP_FRAMES):
        tt = i / FPS
        Rwc, twc = cam_pose(tt)
        Rwc = np.asarray(Rwc, np.float64)
        left = room.render_fisheye(Rwc, twc, jcam.Camera(1, KB), W, H)
        right = room.render_fisheye(Rwc @ R, twc + Rwc @ np.array([BASELINE, 0.0, 0.0]),
                                    jcam.Camera(1, KB2), W, H)
        pairs.append((left.astype(np.uint8), right.astype(np.uint8)))
        chunks.append(imu_between(t_prev, tt))
        times.append(tt)
        gt.append(twc)
        t_prev = tt
    return pairs, times, chunks, np.stack(gt)


def run_lap(slam, inputs, n=LAP_FRAMES):
    pairs, times, chunks, _ = inputs
    for i in range(n):
        a, g, ts = chunks[i]
        slam.process(pairs[i][0], pairs[i][1], i, t=times[i], acc=a, gyr=g, imu_t=ts)
    return slam


@pytest.fixture(scope="module")
def laps(lap_inputs):
    """Both packages over the lap, each IMU init's gravity recorded."""
    jcfg = lap_config()
    inits = {"jax": [], "port": []}
    solve_j, solve_t = jis.inertial_init, tis.inertial_init

    def recording(solve, key):
        def run(*args, **kw):
            res = solve(*args, **kw)
            inits[key].append(np.asarray(res.g_world, np.float64))
            return res
        return run

    jis.inertial_init, tis.inertial_init = recording(solve_j, "jax"), recording(solve_t, "port")
    try:
        js = run_lap(jis.FisheyeStereoInertialSLAM(jcfg), lap_inputs)
        ts = run_lap(tis.FisheyeStereoInertialSLAM(config_from(jcfg), device=CPU), lap_inputs)
    finally:
        jis.inertial_init, tis.inertial_init = solve_j, solve_t
    return js, ts, inits


def test_fisheye_inertial_lap(laps, lap_inputs):
    js, ts, inits = laps
    gt = lap_inputs[3]
    assert js.imu_stage >= 1 and ts.imu_stage == js.imu_stage
    assert len(inits["port"]) == len(inits["jax"]) >= 1
    gj, gp = (v[0] / np.linalg.norm(v[0]) for v in (inits["jax"], inits["port"]))
    assert np.degrees(np.arccos(np.clip(gj @ gp, -1, 1))) <= LAP_GRAVITY_DEG
    assert [r.state for r in ts.trajectory] == [r.state for r in js.trajectory]
    np.testing.assert_allclose(ts.positions(), js.positions(), rtol=0, atol=LAP_POS_TOL_M)
    assert ts.kf_inserted == js.kf_inserted and ts.kf_order == js.kf_order
    # metric, unaligned up to the first pose (stereo fixes the scale)
    est = ts.positions()
    err = np.linalg.norm((est - est[0]) - (gt - gt[0]), axis=1)
    assert np.median(err) < 0.08 * np.ptp(gt, axis=0).max() + 0.02
    # the right camera's observations entered the map
    assert (ts.m.kf_xy_r[: ts.n_kf, :, 0].numpy() >= 0).sum() > 50


def test_fisheye_inertial_batch_is_a_loop_over_process(laps, lap_inputs):
    """``process_batch`` runs its pairs through ``process``, the IMU samples
    fed first: the records of the lap's first frames, bit for bit."""
    pairs, times, chunks, _ = lap_inputs
    one = laps[1]
    n = 6
    many = tis.FisheyeStereoInertialSLAM(config_from(lap_config()), device=CPU)
    acc, gyr, ts = (np.concatenate([c[k] for c in chunks[:n]]) for k in range(3))
    many.process_batch(pairs[:n], list(range(n)), ts=times[:n], acc=acc, gyr=gyr, imu_t=ts)
    assert len(many.trajectory) == n
    for a, b in zip(many.trajectory, one.trajectory[:n]):
        assert a.state == b.state and a.n_inliers == b.n_inliers
        np.testing.assert_array_equal(a.Rcw, b.Rcw)
        np.testing.assert_array_equal(a.tcw, b.tcw)


def test_lap_parts_at_the_keyframe_pose(lap_inputs, tmp_path, monkeypatch):
    """Where the lap's two runs part: from the JAX run's state after frame 0
    (its checkpoint, restored into the port) and on the JAX run's frame-1
    features, frame 1 is predicted at keyframe 0's own pose.  There each
    point's predicted octave ``ceil(log(d_max / d) / log 1.2)`` is an
    integer up to float32's last bit (``d_max`` is the creation distance
    times 1.2 to the octave), so the packages' ``log`` decides it, and some
    points take the other octave.  With the JAX package's octaves in the
    port, frame 1 matches the same features and lands on the same pose."""
    pairs, times, chunks, _ = lap_inputs
    jcfg = lap_config()
    js = jis.FisheyeStereoInertialSLAM(jcfg)
    a, g, ts = chunks[0]
    js.process(pairs[0][0], pairs[0][1], 0, t=times[0], acc=a, gyr=g, imu_t=ts)
    ck = str(tmp_path / "frame0.npz")
    jck.save_map(ck, js)
    port = tis.FisheyeStereoInertialSLAM(config_from(jcfg), device=CPU)
    tck.load_map(ck, port)
    feats, _, uv2 = js._fisheye_frontend(pairs[1][0], pairs[1][1])
    ft = torb.from_numpy(jax.device_get(feats)._asdict(), device=CPU)
    uv2t = torch.from_numpy(np.array(uv2))
    I3, z3 = jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)
    I3t, z3t = torch.eye(3), torch.zeros(3)
    proj = (W, H, jcfg.n_levels, jcfg.scale_factor)
    _, lj, vj = jtr.project_map_points(js.m, I3, z3, js.cam, *proj)
    _, lt, vt = ttr.project_map_points(port.m, I3t, z3t, port.cam, *proj)
    vis = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), vis)
    differ = vis & (np.asarray(lj) != lt.numpy())
    assert 0 < differ.sum() < vis.sum() // 2
    d = np.linalg.norm(np.asarray(js.m.mp_pos, np.float64)[differ], axis=1)
    x = np.log(np.asarray(js.m.mp_dmax, np.float64)[differ] / d) / np.log(1.2)
    assert np.abs(x - np.round(x)).max() < 1e-5

    mask_j = jms.local_map_mask(js.m, js.last_kf_slot, n_neighbors=jcfg.local_window)[0]
    mask_t = tms.local_map_mask(port.m, port.last_kf_slot, n_neighbors=jcfg.local_window)[0]
    rj = jtr.track_frame(js.m, feats, I3, z3, mask_j, js.cam, jcfg, bf=jcfg.bf, feat_uv2=uv2)
    plain = ttr.project_map_points

    def jax_octaves(m, Rcw, tcw, cam, *args):
        uv, _, visible = plain(m, Rcw, tcw, cam, *args)
        lvl = jtr.project_map_points(js.m, jnp.asarray(Rcw.numpy()), jnp.asarray(tcw.numpy()),
                                     js.cam, *args)[1]
        return uv, torch.from_numpy(np.array(lvl)), visible

    monkeypatch.setattr(ttr, "project_map_points", jax_octaves)
    rt = ttr.track_frame(port.m, ft, I3t, z3t, mask_t, port.cam, port.cfg, bf=jcfg.bf,
                         feat_uv2=uv2t)
    assert int(rt[2]) == int(rj[2]) > 100
    np.testing.assert_array_equal(rt[3].numpy(), np.asarray(rj[3]))
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), rtol=0, atol=OCTAVE_POSE_TOL_M)
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]), rtol=0, atol=OCTAVE_POSE_TOL_M)
