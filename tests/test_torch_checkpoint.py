"""Parity of the port's map checkpoints (``io/checkpoint.py``) with the JAX
package on the CPU: one file format, read and written by both.

The maps of ``tests/test_checkpoint.py``: the monocular one (320x240, 14
frames) and the stereo-inertial one (22 frames, 200 Hz IMU, its chain
segments and place-recognition database).  The JAX package's file is read
by the port's ``load_map``; the port's ``save_map`` of that system is read
back by the JAX package's; the two files hold the same keys, dtypes and
shapes and the same arrays (the inertial chain's preintegrations, which
each package re-integrates on load, within 1e-5).  Each restored system
tracks the next frames as the JAX package's restored system does (states
equal, positions within ``POS_TOL_M``).  The shape check refuses a
mismatched configuration; an ``AtlasSLAM`` is refused with a ``TypeError``
(the JAX package fails on a missing attribute: ROADMAP Queue 3).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.imu.preintegration import GRAVITY
from orb_slam3_noted_tpu.io import checkpoint as jck
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.pipeline import atlas as jatlas
from orb_slam3_noted_tpu.pipeline import inertial_system as jis
from orb_slam3_noted_tpu.pipeline import system as jsys
from orb_slam3_noted_tpu.utils.synthetic import stereo_pair
from orb_slam3_noted_tpu_torch.io import checkpoint as tck
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.pipeline import atlas as tatlas
from orb_slam3_noted_tpu_torch.pipeline import inertial_system as tis
from orb_slam3_noted_tpu_torch.pipeline import system as tsys
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory
from test_torch_twoview import jax_minimal_sets

W, H = 320, 240
PARAMS = (260.0, 260.0, 160.0, 120.0)
CPU = torch.device("cpu")
MONO_KW = dict(width=W, height=H, n_features=600, max_keyframes=32, max_map_points=4096,
               local_window=4, kf_max_interval=6)
FX, BL, FPS, IMU_HZ = 260.0, 0.12, 10.0, 200.0
VI_KW = dict(width=W, height=H, fps=FPS, n_features=500, bf=FX * BL, th_depth=35.0,
             max_keyframes=32, max_map_points=4096, local_window=4, kf_max_interval=4,
             min_tracked_points=12, imu_init_time=0.8, imu_viba1_time=1e9, imu_viba2_time=1e9,
             imu_init_min_kfs=4, inertial_window=5, imu_noise_gyro=1e-4, imu_noise_acc=1e-3,
             imu_walk_gyro=1e-6, imu_walk_acc=1e-5, imu_freq=IMU_HZ)
N1, N2 = 22, 30
# restored systems tracking the next frames: float32 sums in other orders
POS_TOL_M = 2e-3
INLIER_TOL = 8


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


def _schema(path) -> dict:
    z = np.load(path)
    return {k: (str(z[k].dtype), z[k].shape) for k in z.files}


def _same_files(pa, pb):
    """Two checkpoints: the same keys, dtypes, shapes and values (the json
    blocks equal as data)."""
    za, zb = np.load(pa), np.load(pb)
    assert _schema(pa) == _schema(pb)
    for k in za.files:
        a, b = za[k], zb[k]
        if a.dtype.kind == "U":
            assert json.loads(str(a)) == json.loads(str(b)), k
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def _track_both(js, ts, frames, ids, **kw_of):
    """Process the same frames in a JAX and a port system; their states
    equal, positions within POS_TOL_M, inliers within INLIER_TOL."""
    for k, fid in enumerate(ids):
        kw = kw_of.get("kw", lambda k: {})(k)
        rj = js.process(*frames[k], fid, **kw)
        rt = ts.process(*frames[k], fid, **kw)
        assert rt.state == rj.state, fid
        assert abs(rt.n_inliers - rj.n_inliers) <= INLIER_TOL, fid
    n = len(ids)
    np.testing.assert_allclose(ts.positions()[-n:], js.positions()[-n:], rtol=0, atol=POS_TOL_M)


# ---------------------------------------------------------------------------
# the monocular map


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    room = BoxRoom(seed=2)
    poses = orbit_trajectory(20, forward=0.03)
    frames = [room.render(R, t, PARAMS, W, H) for R, t in poses]
    js = jsys.MonoSLAM(JConfig(camera=JCamera(0, PARAMS), **MONO_KW))
    for i in range(14):
        js.process(frames[i], i)
    d = tmp_path_factory.mktemp("mono")
    jpath, tpath, back = str(d / "jax.npz"), str(d / "port.npz"), str(d / "back.npz")
    jck.save_map(jpath, js)
    ts = tsys.MonoSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **MONO_KW), device=CPU)
    tck.load_map(jpath, ts)
    tck.save_map(tpath, ts)
    jb = jsys.MonoSLAM(JConfig(camera=JCamera(0, PARAMS), **MONO_KW))
    jck.load_map(tpath, jb)
    jck.save_map(back, jb)
    return frames, js, ts, jpath, tpath, back, jb


def test_mono_checkpoint_crosses_both_ways(mono):
    _, js, ts, jpath, tpath, back, jb = mono
    assert js.n_kf >= 2
    _same_files(jpath, tpath)
    _same_files(jpath, back)
    assert (ts.n_kf, ts.n_mp, ts.state, ts.last_kf_slot) == (js.n_kf, js.n_mp, js.state,
                                                             js.last_kf_slot)
    np.testing.assert_array_equal(ts.m.mp_pos.numpy(), np.asarray(js.m.mp_pos))
    np.testing.assert_array_equal(ts.m.kf_desc.numpy().view(np.uint32), np.asarray(js.m.kf_desc))
    # the records as saved (their poses at track time), in both restored systems
    assert len(ts.trajectory) == len(jb.trajectory) == len(js.trajectory)
    assert [r.state for r in ts.trajectory] == [r.state for r in js.trajectory]
    np.testing.assert_allclose(ts.positions(), jb.positions(), rtol=0, atol=1e-6)


def test_mono_restored_systems_track_alike(mono):
    """The JAX file restored in both packages tracks frames 14-19 alike (and
    as the JAX package's own test asks, mostly OK)."""
    frames, _, _, jpath, _, _, _ = mono
    jr = jsys.MonoSLAM(JConfig(camera=JCamera(0, PARAMS), **MONO_KW))
    jck.load_map(jpath, jr)
    tr = tsys.MonoSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **MONO_KW), device=CPU)
    tck.load_map(jpath, tr)
    tr._minimal_sets = lambda valid, seed: jax_minimal_sets(valid.numpy(),
                                                            jax.random.PRNGKey(int(seed)))
    _track_both(jr, tr, [(f,) for f in frames[14:20]], list(range(14, 20)))
    assert sum(r.state == "OK" for r in tr.trajectory[-6:]) >= 4


def test_shape_mismatch_rejected(tmp_path):
    cfg = SlamConfig(camera=Camera(PINHOLE, PARAMS), **MONO_KW)
    path = str(tmp_path / "map.npz")
    tck.save_map(path, tsys.MonoSLAM(cfg, device=CPU))
    other = SlamConfig(camera=Camera(PINHOLE, PARAMS), width=W, height=H, n_features=500,
                       max_keyframes=32, max_map_points=4096)
    with pytest.raises(ValueError, match="n_features"):
        tck.load_map(path, tsys.MonoSLAM(other, device=CPU))
    # the JAX package's empty map, too
    jpath = str(tmp_path / "jax.npz")
    jck.save_map(jpath, jsys.MonoSLAM(JConfig(camera=JCamera(0, PARAMS), **MONO_KW)))
    with pytest.raises(ValueError, match="n_features"):
        tck.load_map(jpath, tsys.MonoSLAM(other, device=CPU))


def test_atlas_checkpoint_is_refused(tmp_path):
    """Fault: the JAX package's CLI hands an ``AtlasSLAM`` to ``save_map``
    (``cli.py:289-292``), which reads ``slam.state`` and fails on a missing
    attribute.  The port refuses it with a TypeError that names the cause;
    the active system saves as any other."""
    jcfg = JConfig(camera=JCamera(0, PARAMS), **MONO_KW)
    with pytest.raises(AttributeError, match="state"):
        jck.save_map(str(tmp_path / "jax.npz"), jatlas.AtlasSLAM(jcfg, jsys.MonoSLAM))
    atlas = tatlas.AtlasSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **MONO_KW),
                             tsys.MonoSLAM, device=CPU)
    with pytest.raises(TypeError, match="AtlasSLAM.*atlas.active"):
        tck.save_map(str(tmp_path / "port.npz"), atlas)
    tck.save_map(str(tmp_path / "active.npz"), atlas.active)
    assert _schema(str(tmp_path / "active.npz"))["map_kf_desc"] == ("uint32", (32, 600, 8))


# ---------------------------------------------------------------------------
# the stereo-inertial map


def vi_pose(t):
    twc = np.array([0.22 * np.sin(3.8 * t), 0.15 * np.cos(4.6 * t) - 0.15,
                    0.18 * np.sin(1.9 * t) + 0.08 * t])
    Rwc = np.asarray(jso3.exp(jnp.asarray([0.06 * np.sin(1.1 * t), 0.08 * np.sin(0.7 * t),
                                           0.04 * np.cos(1.3 * t)])))
    return Rwc, twc


def imu_between(t0, t1):
    g = np.array([0.0, 0.0, -GRAVITY])
    eps = 1e-4
    ts = np.arange(np.ceil(t0 * IMU_HZ), np.floor(t1 * IMU_HZ) + 1) / IMU_HZ
    ts = ts[(ts > t0 + 1e-12) & (ts <= t1 + 1e-12)]
    acc, gyr = [], []
    for t in ts:
        Rwb, p = vi_pose(t)
        Rwb_p, pp = vi_pose(t + eps)
        _, pm = vi_pose(t - eps)
        acc.append(Rwb.T @ ((pp - 2 * p + pm) / (eps * eps) - g))
        gyr.append(np.asarray(jso3.log(jnp.asarray(Rwb.T @ Rwb_p))) / eps)
    return np.asarray(acc).reshape(-1, 3), np.asarray(gyr).reshape(-1, 3), ts


@pytest.fixture(scope="module")
def inertial(tmp_path_factory):
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom as JRoom

    room = JRoom(seed=0, depth=2.5, h=1.2, w=1.8)
    frames = [stereo_pair(room, *vi_pose(i / FPS), PARAMS, W, H, BL)[:2] for i in range(N2)]
    imu = [imu_between((i - 1) / FPS, i / FPS) for i in range(N2)]
    kw = lambda i: dict(t=i / FPS, acc=imu[i][0], gyr=imu[i][1], imu_t=imu[i][2])  # noqa: E731
    count = jax.device_count
    jax.device_count = lambda *a, **k: 1
    try:
        js = jis.StereoInertialSLAM(JConfig(camera=JCamera(0, PARAMS), **VI_KW))
        for i in range(N1):
            js.process(frames[i][0], frames[i][1], i, **kw(i))
    finally:
        jax.device_count = count
    d = tmp_path_factory.mktemp("vi")
    jpath, tpath = str(d / "jax.npz"), str(d / "port.npz")
    jck.save_map(jpath, js)
    ts = tis.StereoInertialSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **VI_KW), device=CPU)
    tck.load_map(jpath, ts)
    tck.save_map(tpath, ts)
    return frames, kw, js, ts, jpath, tpath


def test_inertial_checkpoint_crosses_both_ways(inertial):
    _, _, js, ts, jpath, tpath = inertial
    assert js.imu_stage >= 1 and len(js.kf_segments) >= 3
    _same_files(jpath, tpath)
    jb = jis.StereoInertialSLAM(JConfig(camera=JCamera(0, PARAMS), **VI_KW))
    jck.load_map(tpath, jb)
    assert jb.imu_stage == ts.imu_stage == js.imu_stage
    assert ts.seg_ok == js.seg_ok and ts.kf_order == js.kf_order
    assert len(ts.seg_preints) == len(ts.kf_segments) == len(js.kf_segments)
    # each package re-integrates the raw segments on load
    for pt, pj in zip(ts.seg_preints, js.seg_preints):
        for f in ("dR", "dV", "dP"):
            np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                                       rtol=0, atol=1e-5, err_msg=f)
    db_j, db_t = js._reloc_database(), ts._reloc_database()
    np.testing.assert_array_equal(db_t.present, db_j.present)
    np.testing.assert_allclose(db_t.bow_mat.numpy(), np.asarray(db_j.bow_mat), rtol=0, atol=1e-6)
    for f in ("vel", "bg", "ba"):
        np.testing.assert_array_equal(getattr(ts.ki, f).numpy(), np.asarray(getattr(js.ki, f)))


def test_inertial_restored_systems_track_alike(inertial):
    """The JAX file restored in both packages tracks frames 22-29 alike,
    with its inertial factors (stage kept), mostly OK."""
    frames, kw, _, _, jpath, _ = inertial
    jr = jis.StereoInertialSLAM(JConfig(camera=JCamera(0, PARAMS), **VI_KW))
    jck.load_map(jpath, jr)
    tr = tis.StereoInertialSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **VI_KW), device=CPU)
    tck.load_map(jpath, tr)
    count = jax.device_count
    jax.device_count = lambda *a, **k: 1
    try:
        _track_both(jr, tr, frames[N1:N2], list(range(N1, N2)),
                    kw=lambda k: kw(N1 + k))
    finally:
        jax.device_count = count
    assert tr.imu_stage >= 1
    assert sum(r.state == "OK" for r in tr.trajectory[-(N2 - N1):]) >= N2 - N1 - 2
