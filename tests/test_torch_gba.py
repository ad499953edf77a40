"""Parity of the port's bundle adjustment engines with the JAX package on the
CPU: ``optim/ba.py`` (the dense engine) and ``optim/gba.py`` (matrix-free
Schur + PCG, ``full_map_problem``, ``SlicedGBA``, ``apply_gba_deltas``,
``run_global_ba``), and ``map_state.apply_ba_result``.

- the scenes of ``tests/test_ba.py`` and ``tests/test_gba.py`` go through
  both packages from the same numpy arrays; the port passes the reference
  tests' own checks, and its poses and points are within 1e-3 (m) of the
  JAX package's;
- the port's GBA against the port's dense ``bundle_adjust``, as
  ``tests/test_gba.py:84`` holds the JAX engines;
- ``full_map_problem`` exactly equal to the JAX package's on a stereo map;
- ``SlicedGBA`` step by step within 1e-3 (m), ``finish`` on a live map in
  which local BA moved a point and a keyframe slot was recycled (the
  recycled slot keeps its pose, the moved point keeps its move);
- ``apply_ba_result`` within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.optim import ba as jba
from orb_slam3_noted_tpu.optim import factors as jfac
from orb_slam3_noted_tpu.optim import gba as jgba
from orb_slam3_noted_tpu.pipeline import map_state as jms
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.optim import ba as tba
from orb_slam3_noted_tpu_torch.optim import factors as tfac
from orb_slam3_noted_tpu_torch.optim import gba as tgba
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from test_torch_sim3 import LS, t_asarray

CPU = torch.device("cpu")
TOL_M = 1e-3
PARAMS = (400.0, 400.0, 320.0, 240.0)
PIN = (458.654, 457.296, 367.215, 248.375)


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


def _rot_y(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])


def scene(rng, K=6, M=120, noise=0.0, params=PARAMS, depth=(4, 8), spread=0.3):
    """K cameras on an arc looking at M points: (R, t, points, obs arrays),
    float32, every point seen by every camera (``tests/test_gba.py``)."""
    pts = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                    rng.uniform(*depth, M)], axis=1)
    Rs = np.stack([_rot_y(0.05 * (k - K / 2)) for k in range(K)])
    ts = np.stack([np.array([spread * k, 0.02 * k, 0.0]) for k in range(K)])
    pose_idx = np.repeat(np.arange(K), M).astype(np.int32)
    point_idx = np.tile(np.arange(M), K).astype(np.int32)
    xc = np.einsum("oij,oj->oi", Rs[pose_idx], pts[point_idx]) + ts[pose_idx]
    fx, fy, cx, cy = params
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx, fy * xc[:, 1] / xc[:, 2] + cy], axis=1)
    uv = uv + noise * rng.standard_normal(uv.shape)
    O = len(uv)
    obs = dict(pose_idx=pose_idx, point_idx=point_idx, uv=uv.astype(np.float32),
               uv_r=np.full(O, -1.0, np.float32), inv_sigma2=np.ones(O, np.float32),
               is_stereo=np.zeros(O, bool), valid=np.ones(O, bool))
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(Rs), f32(ts), f32(pts), obs


def problems(R, t, pts, obs, pose_fixed, point_fixed):
    """(JAX BAProblem, port BAProblem) from the same arrays."""
    jp = jba.BAProblem(Rcw=jnp.asarray(R), tcw=jnp.asarray(t), points=jnp.asarray(pts),
                       obs=jfac.ReprojObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
                       pose_fixed=jnp.asarray(pose_fixed), point_fixed=jnp.asarray(point_fixed))
    tp = tba.BAProblem(Rcw=torch.from_numpy(R), tcw=torch.from_numpy(t),
                       points=torch.from_numpy(pts),
                       obs=tfac.ReprojObs(**{k: torch.from_numpy(v) for k, v in obs.items()}),
                       pose_fixed=torch.from_numpy(pose_fixed),
                       point_fixed=torch.from_numpy(point_fixed))
    return jp, tp


def _close(a, b, tol, what):
    err = float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
    assert err <= tol, (what, err)


def _hold(jr, tr, tol=TOL_M):
    _close(jr.Rcw, tr.Rcw.numpy(), tol, "R")
    _close(jr.tcw, tr.tcw.numpy(), tol, "t")
    _close(jr.points, tr.points.numpy(), tol, "points")


# ---------------------------------------------------------------------------
# tests/test_gba.py through both packages

def test_gba_recovers_perturbed_map(rng):
    R, t, pts, obs = scene(rng)
    K, M = len(R), len(pts)
    t_p = (t + 0.03 * rng.standard_normal(t.shape)).astype(np.float32)
    t_p[:2] = t[:2]
    p_p = (pts + 0.05 * rng.standard_normal(pts.shape)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    jp, tp = problems(R, t_p, p_p, obs, fixed, np.zeros(M, bool))
    jr = jgba.global_bundle_adjust(JCamera(0, PARAMS), jp, n_iters=10, n_iters_final=5)
    tr = tgba.global_bundle_adjust(Camera(PINHOLE, PARAMS), tp, n_iters=10, n_iters_final=5)
    _hold(jr, tr)
    assert np.abs(tr.tcw.numpy() - t).max() < 1e-3
    assert np.abs(tr.points.numpy() - pts).max() < 1e-3
    assert bool(tr.inlier.all())
    assert tr.inlier.numpy().tolist() == np.asarray(jr.inlier).tolist()


def test_gba_matches_dense_engine(rng):
    R, t, pts, obs = scene(rng, noise=0.5)
    K, M = len(R), len(pts)
    t_p = (t + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    t_p[0] = t[0]
    p_p = (pts + 0.03 * rng.standard_normal(pts.shape)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    jp, tp = problems(R, t_p, p_p, obs, fixed, np.zeros(M, bool))
    cam = Camera(PINHOLE, PARAMS)
    dense = tba.bundle_adjust(cam, tp, n_iters=5, n_iters_final=5)
    pcg = tgba.global_bundle_adjust(cam, tp, n_iters=5, n_iters_final=5)
    assert np.abs(dense.tcw.numpy() - pcg.tcw.numpy()).max() < 5e-3
    assert float(pcg.cost) <= 1.05 * float(dense.cost) + 1e-3
    jdense = jba.bundle_adjust(JCamera(0, PARAMS), jp, n_iters=5, n_iters_final=5)
    jpcg = jgba.global_bundle_adjust(JCamera(0, PARAMS), jp, n_iters=5, n_iters_final=5)
    _hold(jdense, dense)
    _hold(jpcg, pcg)


def test_gba_fixed_entries_do_not_move(rng):
    R, t, pts, obs = scene(rng)
    K, M = len(R), len(pts)
    point_fixed = np.zeros(M, bool)
    point_fixed[:10] = True
    jp, tp = problems(R, (t + 0.05).astype(np.float32), pts, obs, np.ones(K, bool), point_fixed)
    tr = tgba.global_bundle_adjust(Camera(PINHOLE, PARAMS), tp, n_iters=3, n_iters_final=2)
    jr = jgba.global_bundle_adjust(JCamera(0, PARAMS), jp, n_iters=3, n_iters_final=2)
    assert np.abs(tr.tcw.numpy() - (t + 0.05)).max() < 1e-6
    assert np.abs(tr.points.numpy()[:10] - pts[:10]).max() < 1e-6
    _hold(jr, tr)


# ---------------------------------------------------------------------------
# tests/test_ba.py through both packages

def _ba_scene(rng, n_poses=6, n_points=120, pix_noise=0.3):
    """``tests/test_ba.py``'s ``make_ba_scene``: cameras on an arc, points
    around 8 m ahead, every point seen by every camera, 0.3 px noise."""
    pts = (rng.uniform(-2, 2, size=(n_points, 3)) + np.array([0, 0, 8.0])).astype(np.float32)
    R = np.stack([_rot_y(0.05 * (k - n_poses / 2)) for k in range(n_poses)]).astype(np.float32)
    t = np.stack([[0.4 * k - 1.0, 0.02 * k, 0.1 * k] for k in range(n_poses)]).astype(np.float32)
    pose_idx = np.repeat(np.arange(n_poses), n_points).astype(np.int32)
    point_idx = np.tile(np.arange(n_points), n_poses).astype(np.int32)
    xc = np.einsum("oij,oj->oi", R[pose_idx], pts[point_idx]) + t[pose_idx]
    fx, fy, cx, cy = PIN
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx, fy * xc[:, 1] / xc[:, 2] + cy], axis=1)
    uv = (uv + rng.normal(0, pix_noise, size=uv.shape)).astype(np.float32)
    O = len(uv)
    obs = dict(pose_idx=pose_idx, point_idx=point_idx, uv=uv, uv_r=np.zeros(O, np.float32),
               inv_sigma2=np.ones(O, np.float32), is_stereo=np.zeros(O, bool),
               valid=np.ones(O, bool))
    return R, t, pts, obs


def test_bundle_adjust_recovers_scene(rng):
    R, t, pts, obs = _ba_scene(rng)
    K, M = len(R), len(pts)
    R0, t0 = R.copy(), t.copy()
    from orb_slam3_noted_tpu.geometry import so3 as jso3

    for k in range(2, K):
        R0[k] = np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.01, 3).astype(np.float32)))) @ R[k]
        t0[k] = t[k] + rng.normal(0, 0.05, 3)
    p0 = (pts + rng.normal(0, 0.08, size=pts.shape)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    jp, tp = problems(R0.astype(np.float32), t0.astype(np.float32), p0, obs, fixed,
                      np.zeros(M, bool))
    jr = jba.bundle_adjust(JCamera(0, PIN), jp)
    tr = tba.bundle_adjust(Camera(PINHOLE, PIN), tp)
    _hold(jr, tr)
    np.testing.assert_allclose(tr.Rcw.numpy()[:2], R[:2], atol=1e-6)
    np.testing.assert_allclose(tr.Rcw.numpy()[2:], R[2:], atol=2e-3)
    np.testing.assert_allclose(tr.tcw.numpy()[2:], t[2:], atol=2e-2)
    assert np.median(np.linalg.norm(tr.points.numpy() - pts, axis=1)) < 0.03
    assert tr.inlier.numpy().mean() > 0.97


def test_bundle_adjust_rejects_outliers(rng):
    R, t, pts, obs = _ba_scene(rng, n_poses=4, n_points=80)
    K, M = len(R), len(pts)
    bad = rng.choice(len(obs["uv"]), size=40, replace=False)
    obs["uv"][bad] += rng.uniform(25, 80, size=(40, 2)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    jp, tp = problems(R, t, pts, obs, fixed, np.zeros(M, bool))
    jr = jba.bundle_adjust(JCamera(0, PIN), jp)
    tr = tba.bundle_adjust(Camera(PINHOLE, PIN), tp)
    _close(jr.Rcw, tr.Rcw.numpy(), TOL_M, "R")
    _close(jr.tcw, tr.tcw.numpy(), TOL_M, "t")
    # a point left with fewer than three inlier views is not determined: its
    # damped updates wander in both packages (one with none moved ~1.3 km,
    # 11 m apart); the points held are the ones the scene determines
    views = tr.inlier.numpy().reshape(K, M).sum(axis=0)
    held = views >= 3
    assert held.mean() > 0.9
    _close(np.asarray(jr.points)[held], tr.points.numpy()[held], TOL_M, "points")
    inl = tr.inlier.numpy()
    assert inl[bad].sum() == 0
    assert inl.tolist() == np.asarray(jr.inlier).tolist()
    np.testing.assert_allclose(tr.tcw.numpy(), t, atol=2e-2)


# ---------------------------------------------------------------------------
# full-map GBA on a map

@pytest.fixture(scope="module")
def stereo_maps():
    inp = LS.stereo_map_inputs()
    kw = dict(width=752, height=480, n_features=inp["M"], max_keyframes=8, max_map_points=256,
              bf=inp["bf"])
    jcfg = JConfig(camera=JCamera(0, PIN), **kw)
    tcfg = SlamConfig(camera=Camera(PINHOLE, PIN), **kw)
    jm = LS.build_stereo_map(jms, jms.empty_map(jcfg), inp, jnp.asarray)
    tm = LS.build_stereo_map(tms, tms.empty_map(tcfg, device=CPU), inp, t_asarray)
    return inp, jcfg, jm, tcfg, tm


def test_full_map_problem_is_exact(stereo_maps):
    inp, jcfg, jm, tcfg, tm = stereo_maps
    jp = jax.device_get(jgba.full_map_problem(jm, jcfg))
    tp = tgba.full_map_problem(tm, tcfg)
    for f in ("pose_idx", "point_idx", "uv", "uv_r", "inv_sigma2", "is_stereo", "valid"):
        np.testing.assert_array_equal(getattr(tp.obs, f).numpy(), np.asarray(getattr(jp.obs, f)),
                                      err_msg=f)
    for f in ("Rcw", "tcw", "points", "pose_fixed", "point_fixed"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    assert int(tp.obs.valid.sum()) == inp["K"] * inp["M"]
    # the gauge: keyframe 0 (earliest frame id) and the empty slots
    assert tp.pose_fixed.numpy().tolist() == [True] + [False] * (inp["K"] - 1) + [True] * 2
    # a sampled problem keeps every stride-th observation
    jp2 = jgba.full_map_problem(jm, jcfg, sample_stride=3)
    tp2 = tgba.full_map_problem(tm, tcfg, sample_stride=3)
    np.testing.assert_array_equal(tp2.obs.valid.numpy(), np.asarray(jp2.obs.valid))
    np.testing.assert_array_equal(tp2.point_fixed.numpy(), np.asarray(jp2.point_fixed))


def test_run_global_ba_matches_jax(stereo_maps):
    inp, jcfg, jm, tcfg, tm = stereo_maps
    jm2, jcost = jgba.run_global_ba(jm, jcfg.camera, jcfg, bf=inp["bf"])
    tm2, tcost = tgba.run_global_ba(tm, tcfg.camera, tcfg, bf=inp["bf"])
    _close(jm2.kf_Rcw, tm2.kf_Rcw.numpy(), TOL_M, "R")
    _close(jm2.kf_tcw, tm2.kf_tcw.numpy(), TOL_M, "t")
    _close(jm2.mp_pos, tm2.mp_pos.numpy(), TOL_M, "points")
    # and the drift is gone: metric (stereo) map back on the truth
    K, M = inp["K"], inp["M"]
    assert np.abs(tm2.kf_tcw.numpy()[:K] - inp["t_true"]).max() < 5e-3
    assert np.median(np.linalg.norm(tm2.mp_pos.numpy()[:M] - inp["pts_true"], axis=1)) < 5e-3


def test_sliced_gba_step_by_step(stereo_maps):
    inp, jcfg, jm, tcfg, tm = stereo_maps
    jg = jgba.SlicedGBA(jm, jcfg.camera, jcfg, bf=inp["bf"], n_iters=3, n_iters_final=2)
    tg = tgba.SlicedGBA(tm, tcfg.camera, tcfg, bf=inp["bf"], n_iters=3, n_iters_final=2)
    for i in range(5):
        assert not tg.done and not jg.done
        jg.step()
        tg.step()
        _close(jg.Rcw, tg.Rcw.numpy(), TOL_M, f"R after step {i}")
        _close(jg.tcw, tg.tcw.numpy(), TOL_M, f"t after step {i}")
        _close(jg.points, tg.points.numpy(), TOL_M, f"points after step {i}")
        _close(jg.lam, tg.lam.numpy(), 1e-12, f"lambda after step {i}")
    assert tg.done and jg.done
    np.testing.assert_array_equal(tg.active.numpy(), np.asarray(jg.active))


def test_sliced_gba_finish_with_a_recycled_slot(stereo_maps):
    """The live map moved on while GBA ran: local BA moved point 3, and slot
    2 was recycled for another keyframe (another frame id).  The merge adds
    the deltas only where the snapshot's keyframe is still in its slot."""
    inp, jcfg, jm, tcfg, tm = stereo_maps
    jg = jgba.SlicedGBA(jm, jcfg.camera, jcfg, bf=inp["bf"], n_iters=2, n_iters_final=1)
    tg = tgba.SlicedGBA(tm, tcfg.camera, tcfg, bf=inp["bf"], n_iters=2, n_iters_final=1)
    shift = np.float32(0.01)
    jlive = jm._replace(kf_frame_id=jm.kf_frame_id.at[2].set(999),
                        kf_tcw=jm.kf_tcw.at[2].add(0.5), mp_pos=jm.mp_pos.at[3].add(shift))
    tlive = tm._replace(kf_frame_id=tms._set(tm.kf_frame_id, 2, 999),
                        kf_tcw=tms._set(tm.kf_tcw, 2, tm.kf_tcw[2] + 0.5),
                        mp_pos=tms._set(tm.mp_pos, 3, tm.mp_pos[3] + shift))
    jout = jg.finish(jlive)
    tout = tg.finish(tlive)
    _close(jout.kf_Rcw, tout.kf_Rcw.numpy(), TOL_M, "R")
    _close(jout.kf_tcw, tout.kf_tcw.numpy(), TOL_M, "t")
    _close(jout.mp_pos, tout.mp_pos.numpy(), TOL_M, "points")
    # the recycled slot keeps the live pose; the others take GBA's deltas
    np.testing.assert_array_equal(tout.kf_tcw.numpy()[2], tlive.kf_tcw.numpy()[2])
    np.testing.assert_array_equal(tout.kf_Rcw.numpy()[2], tlive.kf_Rcw.numpy()[2])
    moved = np.abs(tout.kf_tcw.numpy()[3] - tm.kf_tcw.numpy()[3]).max()
    assert moved > 1e-3, moved
    # local BA's move of point 3 survives the merge
    _close(tout.mp_pos.numpy()[3] - tg.points.numpy()[3], shift, 1e-5, "point 3 keeps its move")


def test_apply_ba_result():
    rng = np.random.default_rng(4)
    KF, MP = 6, 40
    cfg_kw = dict(n_features=8, max_keyframes=KF, max_map_points=MP)
    jm = jms.empty_map(JConfig(**cfg_kw))
    tm = tms.empty_map(SlamConfig(**cfg_kw), device=CPU)
    base = dict(kf_Rcw=rng.normal(size=(KF, 3, 3)), kf_tcw=rng.normal(size=(KF, 3)),
                mp_pos=rng.normal(size=(MP, 3)))
    base = {k: v.astype(np.float32) for k, v in base.items()}
    jm = jm._replace(**{k: jnp.asarray(v) for k, v in base.items()})
    tm = tm._replace(**{k: torch.from_numpy(v) for k, v in base.items()})
    # a padded window: slots 4, 1, 1 (the second 1 is padding), points with repeats
    kf_slots = np.array([4, 1, 1], np.int32)
    kf_mask = np.array([True, True, False])
    Rw = rng.normal(size=(3, 3, 3)).astype(np.float32)
    tw = rng.normal(size=(3, 3)).astype(np.float32)
    mp_slots = np.array([0, 5, 7, 5, 39], np.int32)
    mp_mask = np.array([True, True, True, False, True])
    pw = rng.normal(size=(5, 3)).astype(np.float32)
    args = (kf_slots, kf_mask, Rw, tw, mp_slots, mp_mask, pw)
    jo = jms.apply_ba_result(jm, *(jnp.asarray(a) for a in args))
    to = tms.apply_ba_result(tm, *(torch.from_numpy(a) for a in args))
    for f in ("kf_Rcw", "kf_tcw", "mp_pos"):
        _close(np.asarray(getattr(jo, f)), getattr(to, f).numpy(), 1e-6, f)
    np.testing.assert_allclose(to.kf_tcw.numpy()[1], tw[1], atol=1e-6)
    np.testing.assert_allclose(to.mp_pos.numpy()[5], pw[1], atol=1e-6)
    np.testing.assert_array_equal(to.kf_tcw.numpy()[0], base["kf_tcw"][0])


@pytest.mark.parametrize("shape", [(3,), (3, 3), (4, 6, 3)])
def test_segment_sum_in_fixed_order(shape):
    """``ops/segsum.py``: float rows summed segment by segment in their
    order, padding rows (zero data) dealt round-robin over the segments:
    bit for bit ``index_add_``'s sums on the CPU, empty segments 0, the
    integer path exact; the JAX package's one-hot form within 1e-5."""
    from orb_slam3_noted_tpu.ops.segsum import segment_sum_mxu as jseg
    from orb_slam3_noted_tpu_torch.ops.segsum import segment_order, segment_sum

    rng = np.random.default_rng(len(shape))
    O, M = 500, 37
    seg = rng.integers(0, M - 3, O)           # the last three segments stay empty
    valid = rng.random(O) > 0.3
    data = rng.normal(size=(O, *shape)).astype(np.float32)
    data[~valid] = 0.0
    seg[~valid] = 0                           # padding all names one segment
    t_seg, t_data = torch.from_numpy(seg), torch.from_numpy(data)
    want = torch.zeros((M, *shape)).index_add_(0, t_seg, t_data)
    order = segment_order(t_seg, M, torch.from_numpy(valid))
    assert int(order[1].max()) < int(valid.sum())  # no segment holds all the padding
    got = segment_sum(t_data, t_seg, M, order)
    assert torch.equal(got, want) and not got[-3:].any()
    assert torch.equal(segment_sum(t_data, t_seg, M), want)
    ints = torch.from_numpy(rng.integers(0, 5, O).astype(np.int32))
    assert torch.equal(segment_sum(ints, t_seg, M),
                       torch.zeros(M, dtype=torch.int32).index_add_(0, t_seg, ints))
    j = np.asarray(jseg(jnp.asarray(data.reshape(O, -1)), jnp.asarray(seg.astype(np.int32)), M))
    np.testing.assert_allclose(got.reshape(M, -1).numpy(), j, atol=1e-5)
