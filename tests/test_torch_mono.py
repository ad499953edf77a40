"""Parity of the port's monocular SLAM with the JAX package on the CPU, at
320x240 with 600 features: frames 0-5 through ``process`` (two-view
initialisation, then per-frame tracking), the rest through
``process_batch`` in batches of 6.

One JAX ``MonoSLAM`` run is shared by the module; it records every
``track_batch`` call and the initial map.  ``track_batch`` and
``track_batch_feats`` are held to it call by call (per frame R 1e-4, t 1e-3
as ``track_frame``; inliers equal), the whole lap on aggregates (the same
initialisation frame, tracked >= JAX - 2, Sim(3)-aligned ATE <= 2 x JAX +
2 mm, keyframes +-1), since the port draws its own RANSAC hypotheses.  With
the JAX package's draws substituted (``MonoSLAM._minimal_sets``) the
initial map itself is compared.
"""

import jax
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.pipeline import system as jsys
from orb_slam3_noted_tpu.pipeline import tracking as jtr
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from orb_slam3_noted_tpu_torch.pipeline import tracking as ttr
from orb_slam3_noted_tpu_torch.pipeline.system import OK, MonoSLAM
from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory
from test_torch_twoview import jax_minimal_sets

W, H = 320, 240
FX = 260.0
PARAMS = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
CFG_KW = dict(width=W, height=H, n_features=600, max_keyframes=32, max_map_points=4096,
              local_window=5, kf_max_interval=10)
N_FRAMES, N_PER_FRAME, BATCH = 18, 6, 6
CPU = torch.device("cpu")
R_ATOL, T_ATOL = 1e-4, 1e-3
TRACKED_MARGIN, ATE_FACTOR, ATE_SLACK_M, KF_MARGIN = 2, 2.0, 0.002, 1


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


def tcfg():
    return SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW)


@pytest.fixture(scope="module")
def frames():
    room = BoxRoom(seed=0)
    poses = orbit_trajectory(48, forward=0.03, yaw0=0.45)[:N_FRAMES]
    return poses, [room.render(R, t, PARAMS, W, H).astype(np.uint8) for R, t in poses]


def drive(slam, imgs, n=N_FRAMES):
    for i in range(min(N_PER_FRAME, n)):
        slam.process(imgs[i], i)
    for i in range(N_PER_FRAME, n, BATCH):
        j = min(i + BATCH, n)
        slam.process_batch(imgs[i:j], list(range(i, j)))
    return slam


def jax_draws(valid, seed):
    """The JAX package's minimal sets for the port's seam."""
    return jax_minimal_sets(valid.numpy(), jax.random.PRNGKey(int(seed)))


@pytest.fixture(scope="module")
def laps(frames):
    """(JAX system, its recorded track_batch calls, its initial map, port
    system)."""
    js = jsys.MonoSLAM(JConfig(camera=JCamera(0, PARAMS), **CFG_KW))
    calls, init = [], {}
    orig_tb, orig_fin = jtr.track_batch, js._finish_initialize

    def recording(*args, **kw):
        out = orig_tb(*args, **kw)
        calls.append(jax.device_get((args[:6], kw, out)))
        return out

    def finish(feats, frame_id, *rest):
        orig_fin(feats, frame_id, *rest)
        init.update(frame=frame_id, n_mp=js.n_mp, record=js.trajectory[-1],
                    m=jax.device_get(js.m))

    jtr.track_batch = recording
    js._finish_initialize = finish
    try:
        drive(js, frames[1])
    finally:
        jtr.track_batch = orig_tb
    ts = drive(MonoSLAM(tcfg(), device=CPU), frames[1])
    return js, calls, init, ts


def _mono_ate(slam, poses):
    states = [r.state for r in slam.trajectory]
    kf0 = min(int(f) for f in slam.kf_frame_ids if f >= 0)
    first = states.index(OK)
    use = [kf0] + list(range(first, len(states)))
    gt = np.asarray([t for _, t in poses])
    return ate_rmse(slam.positions()[use], gt[use])[0], first


def test_mono_lap_matches_jax_in_aggregate(laps, frames):
    js, calls, _, ts = laps
    assert calls, "the lap ran no batch"
    ate_j, init_j = _mono_ate(js, frames[0])
    ate_t, init_t = _mono_ate(ts, frames[0])
    tracked = [sum(r.state == OK for r in s.trajectory) for s in (js, ts)]
    kfs = [sorted(int(f) for f in s.kf_frame_ids if f >= 0) for s in (js, ts)]
    assert len(ts.trajectory) == N_FRAMES
    assert init_t == init_j
    assert tracked[1] >= tracked[0] - TRACKED_MARGIN
    assert ate_t <= ATE_FACTOR * ate_j + ATE_SLACK_M, (ate_t, ate_j)
    assert abs(ts.n_kf - js.n_kf) <= KF_MARGIN, kfs
    assert np.all(np.isfinite(ts.positions()))
    # the pre-initialisation frames sit at the origin, then the keyframes
    assert [r.state for r in ts.trajectory[:init_t]] == ["NOT_INITIALIZED"] * init_t
    assert kfs[1][:2] == kfs[0][:2]


def test_initial_map_with_the_jax_draws(laps, frames):
    """The RANSAC seam: with the JAX package's hypotheses the port builds
    the same initial map (point count equal, keyframe 1's pose after the
    initial BA within 1e-4 / 1e-3, bindings equal, points within a median
    1e-3 of their distance; a few near-parallel rays amplify last-bit
    differences of the triangulation, as in ``tests/test_torch_twoview.py``:
    at most 2e-2, measured 9.0e-3)."""
    _, _, init, _ = laps
    ts = MonoSLAM(tcfg(), device=CPU)
    ts._minimal_sets = jax_draws
    for i in range(init["frame"] + 1):
        ts.process(frames[1][i], i)
    assert ts.state == OK and ts.n_mp == int(init["n_mp"])
    rec_j, rec_t = init["record"], ts.trajectory[-1]
    np.testing.assert_allclose(rec_t.Rcw, np.asarray(rec_j.Rcw), atol=R_ATOL)
    np.testing.assert_allclose(rec_t.tcw, np.asarray(rec_j.tcw), atol=T_ATOL)
    mj, mt = init["m"], tms.to_numpy(ts.m)
    np.testing.assert_allclose(mt["kf_Rcw"][1], mj.kf_Rcw[1], atol=R_ATOL)
    np.testing.assert_allclose(mt["kf_tcw"][1], mj.kf_tcw[1], atol=T_ATOL)
    np.testing.assert_array_equal(mt["kf_mp"][:2], mj.kf_mp[:2])
    n = ts.n_mp
    pj, pt = mj.mp_pos[:n], mt["mp_pos"][:n]
    rel = np.linalg.norm(pj - pt, axis=1) / np.linalg.norm(pj, axis=1)
    assert np.median(rel) <= 1e-3 and rel.max() <= 2e-2, (np.median(rel), rel.max())


def _port_args(call):
    (mj, imgs, slot, R0, t0, vel), kw, out = call
    m = tms.from_numpy(mj._asdict())
    vel = tuple(torch.from_numpy(np.asarray(v, np.float32)) for v in vel)
    cm = None if kw.get("count_mask") is None else torch.from_numpy(np.asarray(kw["count_mask"]))
    return m, imgs, int(slot), torch.from_numpy(R0), torch.from_numpy(t0), vel, cm, out


def _compare_scan(outj, outt):
    mj, Rs, ts_, n_inl, _, mp_feats = outj
    mt, Rt, tt, nt, _, mpt = outt
    np.testing.assert_array_equal(nt.numpy(), n_inl)
    np.testing.assert_allclose(Rt.numpy(), Rs, atol=R_ATOL)
    np.testing.assert_allclose(tt.numpy(), ts_, atol=T_ATOL)
    np.testing.assert_array_equal(mpt.numpy(), mp_feats)
    np.testing.assert_array_equal(mt.mp_visible.numpy(), mj.mp_visible)
    np.testing.assert_array_equal(mt.mp_found.numpy(), mj.mp_found)


@pytest.mark.parametrize("call", [0, 1])
def test_track_batch_feats_matches_jax(laps, call):
    """The scan on the JAX package's map and features of each batch."""
    _, calls, _, ts = laps
    m, _, slot, R0, t0, vel, cm, outj = _port_args(calls[call])
    feats = torb.from_numpy(outj[4]._asdict())
    outt = ttr.track_batch_feats(m, feats, slot, R0, t0, vel, ts.cam, ts.cfg, bf=0.0,
                                 count_mask=cm)
    _compare_scan(outj, outt)


@pytest.mark.parametrize("call", [0, 1])
def test_track_batch_matches_jax(laps, call):
    """The whole batch step from the images: the port's own extraction,
    then the scan, on the JAX package's map."""
    _, calls, _, ts = laps
    m, imgs, slot, R0, t0, vel, cm, outj = _port_args(calls[call])
    ck.reset_launch_counts()
    outt = ttr.track_batch(m, torch.from_numpy(imgs), slot, R0, t0, vel, ts.cam, ts.cfg,
                           bf=0.0, count_mask=cm)
    _compare_scan(outj, outt)
    # a CPU tensor runs the plain versions, which count no launch
    assert ck.launch_counts()["fast_candidates"] == 0


def test_count_mask_keeps_padded_frames_out(laps):
    """Padding and committed frames track but never count: a batch whose
    last frames are masked adds exactly what the unmasked head adds alone,
    and an all-False mask adds nothing; poses are the same either way."""
    _, calls, _, ts = laps
    m, _, slot, R0, t0, vel, _, outj = _port_args(calls[0])
    feats = torb.from_numpy(outj[4]._asdict())
    head = torb.FrameFeatures(*(f[:3] for f in feats))
    args = (slot, R0, t0, vel, ts.cam, ts.cfg)
    masked = ttr.track_batch_feats(m, feats, *args, bf=0.0,
                                   count_mask=torch.arange(BATCH) < 3)
    alone = ttr.track_batch_feats(m, head, *args, bf=0.0)
    none = ttr.track_batch_feats(m, feats, *args, bf=0.0,
                                 count_mask=torch.zeros(BATCH, dtype=torch.bool))
    for field in ("mp_visible", "mp_found"):
        assert torch.equal(getattr(masked[0], field), getattr(alone[0], field))
        assert torch.equal(getattr(none[0], field), getattr(m, field))
        assert bool((getattr(masked[0], field) > getattr(m, field)).any())
    assert torch.equal(masked[1][:3], alone[1]) and torch.equal(masked[1], none[1])


def test_batch_walk_copies_once_per_dispatch(laps, frames, monkeypatch):
    """``process_batch`` reads the host's values back in one copy per
    dispatch (the bulk pull), whatever the number of frames."""
    from orb_slam3_noted_tpu_torch.pipeline import system

    ts = MonoSLAM(tcfg(), device=CPU)
    for i in range(N_PER_FRAME):
        ts.process(frames[1][i], i)
    pulls = []
    orig = system._pull
    monkeypatch.setattr(system, "_pull", lambda *xs: pulls.append(len(xs)) or orig(*xs))
    ts.process_batch(frames[1][N_PER_FRAME:N_PER_FRAME + BATCH],
                     list(range(N_PER_FRAME, N_PER_FRAME + BATCH)))
    assert len(pulls) == 1 + ts.cfg.retrack_after_kf * ts.kf_inserted
    assert len(ts.trajectory) == N_PER_FRAME + BATCH


def test_batched_initialisation(frames):
    """``process_batch`` from frame 0: the batched attempts of
    ``_init_consume`` against frame 0 initialise where the per-frame path
    does, and the rest of the batch is tracked (padded to the batch)."""
    imgs = frames[1]
    ts = MonoSLAM(tcfg(), device=CPU)
    ts._minimal_sets = jax_draws
    ts.process_batch(imgs[:BATCH], list(range(BATCH)))
    assert ts.n_kf >= 2 and ts.state == OK
    assert len(ts.trajectory) == BATCH
    first = [r.state for r in ts.trajectory].index(OK)
    assert 1 <= first <= 5
    assert all(r.state == OK for r in ts.trajectory[first:])


def test_mono_fixture_draws_are_the_jax_package_draws():
    """``chip_smoke.py`` runs the mono lap on the JAX run's RANSAC minimal
    sets, stored in the fixture: they are what ``jax.random.choice`` draws
    from the stored seed on the stored match masks, every index a match,
    and the smoke's stand-in for ``MonoSLAM._minimal_sets`` hands them out
    for that seed and mask shape only.  The stored camera rotations are the
    JAX package's trajectory's."""
    import base64
    import importlib.util
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    with open(cs.MONO_FIXTURE) as f:
        ref = json.load(f)
    assert ref["init_draws"]
    draws = cs.fixture_draws(ref)
    for d in ref["init_draws"]:
        sets = np.frombuffer(base64.b64decode(d["sets"]), "<i2").reshape(d["shape"])
        packed = np.frombuffer(base64.b64decode(d["matched"]), np.uint8).reshape(d["shape"][0], -1)
        masks = np.unpackbits(packed, axis=-1, count=d["n"]).astype(bool)
        want = jax_minimal_sets(masks, jax.random.PRNGKey(d["seed"])).numpy()
        np.testing.assert_array_equal(sets, want)
        assert np.take_along_axis(masks, sets.reshape(len(masks), -1), axis=1).all()
        got = draws(torch.from_numpy(masks), d["seed"])
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), sets)
        assert cs.match_mask_agreement(ref, draws.asked[-1:]) == (len(masks), len(masks), 0,
                                                                    masks.size)
        with pytest.raises(AssertionError):
            draws(torch.from_numpy(masks[1:]), d["seed"])
        with pytest.raises(AssertionError):
            draws(torch.from_numpy(masks), d["seed"] + 1)
    # the lap renders from the JAX package's camera rotations, bit for bit
    from orb_slam3_noted_tpu.utils.synthetic import orbit_trajectory as jax_orbit

    rwc = np.frombuffer(base64.b64decode(ref["rwc_f32"]), "<f4").reshape(-1, 3, 3)
    jp = jax_orbit(ref["frames"], forward=ref["forward"], yaw0=ref["yaw0"])
    np.testing.assert_array_equal(rwc, np.stack([R for R, _ in jp]))
