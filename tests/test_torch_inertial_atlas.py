"""Parity of the port's inertial Atlas (``pipeline/inertial_atlas.py``) with
the JAX package on the CPU.

``yaw_only`` in float64 (within 1e-12).  The inertial weld of
``InertialAtlasSLAM._do_merge`` on two hand-built chains, the visual merge
underneath stubbed in both packages: the world transform it applies, the
joined order, times, raw
segments, preintegrations and ``seg_ok`` (one invalid junction), the
velocity and bias tables in the merged slot space (within 1e-6), the bias,
velocity and stage, and the welding chain BA's window; between two metric
maps the world transform (the JAX package projects the wrong rotation:
ROADMAP Queue 3).

The lap of ``tests/test_inertial_atlas.py`` (320x240, 10 fps, 200 Hz IMU) in
both packages, on the same IMU samples and the JAX run's two-view and merge
draws: the IMU stage map A reaches and when, the switch, the merge, the
junction, whether the weld was 4-DoF, finite velocities after it.

The JAX package's fault kept by the port (ROADMAP Queue 3): an inertial reset
on a timestamp jump calls a ``_store_active_map`` hook that no class defines,
so the map is dropped, not stored in the Atlas.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import sim3 as jsim3
from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.geometry.sim3_solver import Sim3Result as JRes
from orb_slam3_noted_tpu.imu.preintegration import GRAVITY, Bias as JBias
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.pipeline import atlas as jatlas
from orb_slam3_noted_tpu.pipeline import inertial_atlas as jia
from orb_slam3_noted_tpu.pipeline.inertial_mapping import KFInertial as JKI
from orb_slam3_noted_tpu_torch.geometry.sim3_solver import Sim3Result as TRes
from orb_slam3_noted_tpu_torch.imu.preintegration import Bias as TBias
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.pipeline import atlas as tatlas
from orb_slam3_noted_tpu_torch.pipeline import inertial_atlas as tia
from orb_slam3_noted_tpu_torch.pipeline.inertial_mapping import KFInertial as TKI
from orb_slam3_noted_tpu_torch.pipeline.inertial_system import MonoInertialSLAM
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom
from test_torch_sim3 import jax_sim3_sets
from test_torch_twoview import jax_minimal_sets

W, H = 320, 240
PARAMS = (260.0, 260.0, 160.0, 120.0)
FPS, IMU_HZ = 10.0, 200.0
CFG_KW = dict(width=W, height=H, fps=FPS, n_features=600, max_keyframes=64, max_map_points=8192,
              local_window=5, kf_max_interval=3, min_tracked_points=12, imu_init_time=1.2,
              imu_viba1_time=1e9, imu_viba2_time=1e9, imu_init_min_kfs=5, inertial_window=6,
              imu_noise_gyro=1e-4, imu_noise_acc=1e-3, imu_walk_gyro=1e-6, imu_walk_acc=1e-5,
              imu_freq=IMU_HZ, vocab_words=256)
CPU = torch.device("cpu")
TABLE_TOL = 1e-6


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


def _rot(v) -> np.ndarray:
    return np.asarray(torch.linalg.matrix_exp(torch.tensor(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]], dtype=torch.float64)))


@pytest.mark.parametrize("v", [(0.05, -0.03, 0.7), (0.2, 0.1, -2.5), (0.0, 0.0, 3.1)])
def test_yaw_only(v):
    R = _rot(v)
    Rj, Rt = jia.yaw_only(R), tia.yaw_only(R)
    assert Rt.dtype == np.float64
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Rt[2], [0, 0, 1], atol=1e-12)
    np.testing.assert_allclose(Rt @ Rt.T, np.eye(3), atol=1e-12)
    assert abs(np.arctan2(Rt[1, 0], Rt[0, 0]) - v[2]) < 0.06


# ---------------------------------------------------------------------------
# the inertial weld on hand-built chains


KF = 16
N_OLD, N_NEW = 5, 4


def _chains(seed: int, new_stage: int):
    """(stored chain, incoming chain, the two maps' keyframe poses, the
    RANSAC result) as numpy."""
    rng = np.random.default_rng(seed)

    def chain(order, t0, stage):
        segs = [(rng.normal(size=(n, 3)), rng.normal(size=(n, 3)), np.full(n, 0.005))
                for n in rng.integers(3, 9, len(order) - 1)]
        return dict(order=order, times=[t0 + 0.3 * k for k in range(len(order))], segs=segs,
                    ok=[bool(x) for x in rng.uniform(size=len(segs)) > 0.2], stage=stage,
                    vel=rng.normal(size=(KF, 3)).astype(np.float32),
                    bg=rng.normal(0, 1e-3, (KF, 3)).astype(np.float32),
                    ba=rng.normal(0, 1e-2, (KF, 3)).astype(np.float32))

    old = chain([0, 1, 3, 4, 2], 0.0, 1)
    new = chain([0, 1, 2, 3], 5.0, new_stage)
    poses = [(np.stack([_rot(rng.normal(0, 0.2, 3)) for _ in range(KF)]).astype(np.float32),
              rng.normal(0, 0.5, (KF, 3)).astype(np.float32)) for _ in range(2)]
    res = dict(R=_rot((0.04, -0.02, 0.6)).astype(np.float32),
               t=np.array([0.3, -0.1, 0.2], np.float32), s=np.float32(1.17))
    return old, new, poses, res


def _run_weld(pkg, old, new, poses, res, monkeypatch):
    """One package's inertial ``_do_merge`` on the hand-built state, its
    visual merge stubbed (it puts the merged last keyframe behind the
    stored map's, as the real one does); returns (active, the result the
    visual merge was handed, the chain BA's window)."""
    J = pkg == "jax"
    arr = (lambda x: jnp.asarray(x)) if J else (lambda x: torch.from_numpy(np.asarray(x)))
    seen = {}

    def base_do_merge(self, st, si, slot, cand, r):
        seen["res"] = r
        if J:  # the world transform the JAX package's base merge applies
            m, one = self.active.m, jnp.asarray(1.0, jnp.float32)
            seen["S"] = jsim3.compose(jsim3.inverse((st.m.kf_Rcw[cand], st.m.kf_tcw[cand], one)),
                                      jsim3.compose(jsim3.inverse((r.R, r.t, r.s)),
                                                    (m.kf_Rcw[slot], m.kf_tcw[slot], one)))
        else:
            seen["S"] = self._merge_transform(st, slot, cand, r)
        self.active.last_kf_slot = N_OLD + slot
        return True

    monkeypatch.setattr((jatlas if J else tatlas).AtlasSLAM, "_do_merge", base_do_merge)
    KI, Bias_ = (JKI, JBias) if J else (TKI, TBias)
    ki = lambda c: KI(vel=arr(c["vel"]), bg=arr(c["bg"]), ba=arr(c["ba"]))  # noqa: E731
    preint = lambda tag, k: (tag, k)  # noqa: E731  stand-ins: the weld only moves them
    stored = types.SimpleNamespace(
        m=types.SimpleNamespace(kf_Rcw=arr(poses[0][0]), kf_tcw=arr(poses[0][1])),
        n_kf=N_OLD, inertial=dict(
            ki=ki(old), kf_order=list(old["order"]), kf_times=list(old["times"]),
            kf_segments=list(old["segs"]), seg_preints=[preint("old", k) for k in
                                                        range(len(old["segs"]))],
            seg_ok=list(old["ok"]), imu_stage=old["stage"],
            bias=Bias_(arr(old["bg"][0]), arr(old["ba"][0]))))
    a = types.SimpleNamespace(
        m=types.SimpleNamespace(kf_Rcw=arr(poses[1][0]), kf_tcw=arr(poses[1][1])),
        ki=ki(new), kf_order=list(new["order"]), kf_times=list(new["times"]),
        kf_segments=list(new["segs"]), seg_preints=[preint("new", k) for k in
                                                    range(len(new["segs"]))],
        seg_ok=list(new["ok"]), imu_stage=new["stage"], last_kf_slot=3)
    a._chain_ba = lambda window=None: seen.setdefault("window", window)
    cls = jia.InertialAtlasSLAM if J else tia.InertialAtlasSLAM
    atlas = cls.__new__(cls)
    atlas.active = a
    atlas.cfg = types.SimpleNamespace(inertial_window=6)
    Res = JRes if J else TRes
    r = Res(success=arr(True), R=arr(res["R"]), t=arr(res["t"]), s=arr(res["s"]),
            inliers=arr(np.ones(4, bool)), n_inliers=arr(np.int32(40)))
    assert atlas._do_merge(stored, 0, 3, 2, r)
    return a, seen


@pytest.mark.parametrize("new_stage", [1, 0], ids=["both_metric", "new_map_not_initialised"])
def test_inertial_weld_on_hand_built_chains(new_stage, monkeypatch):
    """The joined chain and tables as the JAX package's.  Between two
    metric maps the JAX package projects the RANSAC's camera-to-camera
    rotation onto the camera's z axis, so the world transform it applies
    stays tilted (a fault: ROADMAP Queue 3); the port projects the world
    transform onto yaw, scale 1, and rotates the velocities with that."""
    old, new, poses, res = _chains(0, new_stage)
    aj, sj = _run_weld("jax", old, new, poses, res, monkeypatch)
    at, st = _run_weld("port", old, new, poses, res, monkeypatch)
    Rj, Rt = np.asarray(sj["S"][0], np.float64), st["S"][0].numpy().astype(np.float64)
    tilt = lambda R: float(np.hypot(R[2, 0], R[2, 1]))  # noqa: E731
    if new_stage:
        # the port: the unprojected world transform's yaw, scale 1
        full = tatlas.AtlasSLAM._merge_transform(types.SimpleNamespace(active=at_pre(
            poses)), types.SimpleNamespace(m=types.SimpleNamespace(
                kf_Rcw=torch.from_numpy(poses[0][0]), kf_tcw=torch.from_numpy(poses[0][1]))),
            3, 2, types.SimpleNamespace(**{k: torch.from_numpy(np.asarray(v))
                                           for k, v in res.items()}))
        np.testing.assert_allclose(Rt, tia.yaw_only(full[0].numpy()), rtol=0, atol=1e-6)
        assert tilt(Rt) <= 1e-6 and float(st["S"][2]) == 1.0
        np.testing.assert_array_equal(st["S"][1].numpy(), full[1].numpy())
        # JAX: the camera-frame projection leaves the world tilted
        assert tilt(Rj) > 1e-2 and float(sj["S"][2]) == 1.0
        assert float(sj["res"].s) == 1.0
        np.testing.assert_allclose(np.asarray(sj["res"].R)[2], [0, 0, 1], atol=1e-7)
    else:
        np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(st["S"][2]), float(sj["S"][2]), rtol=1e-6)
    # the joined chain: one invalid junction segment
    assert at.kf_order == aj.kf_order == old["order"] + [N_OLD + s for s in new["order"]]
    assert at.kf_times == aj.kf_times
    assert at.seg_ok == aj.seg_ok == old["ok"] + [False] + new["ok"]
    assert at.seg_preints == aj.seg_preints
    assert len(at.seg_preints) == len(at.kf_order) - 1
    assert len(at.kf_segments) == len(aj.kf_segments)
    for x, y in zip(at.kf_segments, aj.kf_segments):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert at.imu_stage == aj.imu_stage == 1
    # the tables in the merged slot space: the old map's entries and the
    # biases as JAX's; the new map's velocities rotated (and scaled) by the
    # world transform each package applies
    for f in ("bg", "ba"):
        np.testing.assert_allclose(getattr(at.ki, f).numpy(), np.asarray(getattr(aj.ki, f)),
                                   rtol=0, atol=TABLE_TOL, err_msg=f)
    vt, vj = at.ki.vel.numpy(), np.asarray(aj.ki.vel)
    np.testing.assert_array_equal(vt[old["order"]], old["vel"][old["order"]])
    moved = [N_OLD + s for s in new["order"]]
    sw = float(st["S"][2])
    np.testing.assert_allclose(vt[moved], sw * new["vel"][new["order"]] @ Rt.T, rtol=0,
                               atol=TABLE_TOL)
    if not new_stage:
        np.testing.assert_allclose(vt, vj, rtol=0, atol=TABLE_TOL)
    for x, y in ((at.bias.bg, aj.bias.bg), (at.bias.ba, aj.bias.ba)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=TABLE_TOL)
    np.testing.assert_allclose(at.cur_vel.numpy(), vt[at.kf_order[-1]], rtol=0, atol=0)
    assert st["window"] == sj["window"] == 6


def at_pre(poses):
    """The incoming map's keyframe poses as the port's active system holds
    them before the merge."""
    return types.SimpleNamespace(m=types.SimpleNamespace(
        kf_Rcw=torch.from_numpy(poses[1][0]), kf_tcw=torch.from_numpy(poses[1][1])))


# ---------------------------------------------------------------------------
# tests/test_inertial_atlas.py's lap in both packages


def cam_pose(t):
    twc = np.array([0.25 * np.sin(0.95 * t) + 0.2 * np.sin(3.8 * t),
                    0.15 * np.cos(4.6 * t) - 0.15, 0.18 * np.sin(1.9 * t)])
    Rwc = np.asarray(jso3.exp(jnp.asarray([0.06 * np.sin(1.1 * t), 0.08 * np.sin(0.7 * t),
                                           0.04 * np.cos(1.3 * t)])))
    return Rwc, twc


def imu_between(t0, t1):
    """tests/test_inertial_atlas.py's exact samples (the JAX package's
    float32 ``so3.log``; both packages get these)."""
    g = np.array([0.0, 0.0, -GRAVITY])
    eps = 1e-4
    ts = np.arange(np.ceil(t0 * IMU_HZ), np.floor(t1 * IMU_HZ) + 1) / IMU_HZ
    ts = ts[(ts > t0 + 1e-12) & (ts <= t1 + 1e-12)]
    acc, gyr = [], []
    for t in ts:
        Rwb, p = cam_pose(t)
        Rwb_p, pp = cam_pose(t + eps)
        _, pm = cam_pose(t - eps)
        acc.append(Rwb.T @ ((pp - 2 * p + pm) / (eps * eps) - g))
        gyr.append(np.asarray(jso3.log(jnp.asarray(Rwb.T @ Rwb_p))) / eps)
    return np.asarray(acc).reshape(-1, 3), np.asarray(gyr).reshape(-1, 3), ts


class _Drawn(MonoInertialSLAM):
    def _minimal_sets(self, valid, seed):
        return jax_minimal_sets(valid.numpy(), jax.random.PRNGKey(int(seed)))


def _lap(atlas, inputs, snap):
    """tests/test_inertial_atlas.py's schedule on pre-made inputs: map A
    for 30 frames, blind until the switch, map B until the merge, 5 more."""
    k = 0

    def feed(blind=False):
        nonlocal k
        img, t, acc, gyr, ts = inputs(k, blind)
        atlas.process(img, k, t=t, acc=acc, gyr=gyr, imu_t=ts)
        snap.setdefault("stages", []).append(int(atlas.active.imu_stage))
        k += 1

    for _ in range(30):
        feed()
    snap["stage_a"] = atlas.active.imu_stage
    while atlas.maps_created == 1 and k < 60:
        feed(blind=True)
    snap["switch_frame"] = k - 1
    snap["stored_stage"] = atlas.stored[0].inertial["imu_stage"] if atlas.stored else None
    for _ in range(60):
        feed()
        if atlas.merges:
            break
    snap["merge_frame"] = k - 1
    a = atlas.active
    snap["chain"] = (a.seg_ok.count(False), len(a.seg_preints), len(a.kf_order), list(a.seg_ok))
    for _ in range(5):
        feed()


@pytest.fixture(scope="module")
def laps():
    room = BoxRoom(seed=3)
    cache = {}

    def inputs(k, blind):
        if (k, blind) not in cache:
            t, t_prev = (k + 1) / FPS, k / FPS
            Rwc, twc = cam_pose(t)
            img = (np.zeros((H, W), np.float32) if blind
                   else room.render(Rwc, twc, PARAMS, W, H))
            cache[(k, blind)] = (img, t, *imu_between(t_prev, t))
        return cache[(k, blind)]

    jsnap, tsnap = {}, {}
    merges = {"jax": [], "port": []}
    jdo, tdo = jatlas.AtlasSLAM._do_merge, tatlas.AtlasSLAM._do_merge

    def spy(pkg, orig):
        def do_merge(self, st, si, slot, cand, res):
            merges[pkg].append((int(slot), int(cand), np.asarray(res.R).copy(), float(res.s)))
            return orig(self, st, si, slot, cand, res)
        return do_merge

    count = jax.device_count
    jax.device_count = lambda *a, **k: 1
    jatlas.AtlasSLAM._do_merge, tatlas.AtlasSLAM._do_merge = spy("jax", jdo), spy("port", tdo)
    try:
        ja = jia.InertialAtlasSLAM(JConfig(camera=JCamera(0, PARAMS), **CFG_KW))
        _lap(ja, inputs, jsnap)
        ta = tia.InertialAtlasSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW),
                                   base_cls=_Drawn, device=CPU)
        ta._merge_sets = lambda valid, slot: jax_sim3_sets(valid.numpy(), slot)
        _lap(ta, inputs, tsnap)
    finally:
        jax.device_count = count
        jatlas.AtlasSLAM._do_merge, tatlas.AtlasSLAM._do_merge = jdo, tdo
    return ja, ta, jsnap, tsnap, merges


def test_inertial_atlas_lap_as_jax(laps):
    ja, ta, js, ts, merges = laps
    # map A initialises its IMU, at the same frame (+-1)
    assert ts["stage_a"] >= 1 and js["stage_a"] >= 1
    first = lambda st: next(i for i, s in enumerate(st) if s >= 1)  # noqa: E731
    assert abs(first(ts["stages"]) - first(js["stages"])) <= 1
    # the switch stores map A with its chain
    assert ts["switch_frame"] == js["switch_frame"]
    assert ts["stored_stage"] == js["stored_stage"] >= 1
    # one merge, at the same frame (+-1), the same kind of weld
    assert ja.maps_created == ta.maps_created == 2 and ja.merges == ta.merges == 1
    assert abs(ts["merge_frame"] - js["merge_frame"]) <= 1
    (sj, cj, Rj, s_j), (st_, ct, Rt, s_t) = merges["jax"][-1], merges["port"][-1]
    assert st_ == sj
    assert (s_t == 1.0) == (s_j == 1.0)
    if s_j == 1.0:  # both maps metric: a 4-DoF weld
        np.testing.assert_allclose(Rt[2], [0, 0, 1], atol=1e-6)
        yaw = lambda R: np.arctan2(R[1, 0], R[0, 0])  # noqa: E731
        assert abs(yaw(Rt) - yaw(Rj)) < np.deg2rad(0.5)
    # the junction: one invalid segment, one fewer segment than keyframes
    assert ts["chain"][0] == js["chain"][0] == 1
    assert ts["chain"][1] == ts["chain"][2] - 1 and js["chain"][1] == js["chain"][2] - 1
    assert abs(ts["chain"][2] - js["chain"][2]) <= 2
    assert np.isfinite(ta.active.cur_vel.numpy()).all()
    assert ta.trajectory[-1].state in ("OK", "RECENTLY_LOST")
    assert sum(r.state == "OK" for r in ta.trajectory) >= sum(
        r.state == "OK" for r in ja.trajectory) - 2


# ---------------------------------------------------------------------------
# the JAX package's fault, kept


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_timestamp_reset_drops_the_map(pkg):
    """``inertial_system.py:189`` stores the map before a reset on a gap
    over 1 s after VIBA2 only if the facade defines ``_store_active_map``;
    no class does, so the Atlas loses the map.  Kept in the port."""
    if pkg == "jax":
        atlas = jia.InertialAtlasSLAM(JConfig(camera=JCamera(0, PARAMS), **CFG_KW))
    else:
        atlas = tia.InertialAtlasSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW),
                                      device=CPU)
    a = atlas.active
    assert not hasattr(a, "_store_active_map") and not hasattr(atlas, "_store_active_map")
    a.state, a.imu_stage, a.last_t, a.n_kf = "OK", 3, 2.0, 7
    assert a._check_timestamps(3.5)  # a gap over 1 s after VIBA2: reset, meant to store
    assert a.n_kf == 0 and a.imu_stage == 0
    assert atlas.stored == [] and atlas.maps_created == 1
