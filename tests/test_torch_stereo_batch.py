"""Parity of the port's batched stereo front end and stereo batch mode with
the JAX package on the CPU, at the size of ``tests/test_torch_mapping.py``
(320x240, 600 features, 4096 map points).

``StereoSLAM`` runs ``process`` until initialised, then ``process_batch``
in batches of 6, in both packages; one JAX run is shared by the module and
records every ``stereo_track_batch`` call.  The batched matcher must give
each pair what the pair alone gives, the re-track scan on the JAX package's
features and stereo rows must give its poses (R 1e-4, t 1e-3) and inliers,
and the lap is held on aggregates (tracked >= JAX - 2, metric RMSE <= 2 x
JAX + 2 mm, keyframes +-1).
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
from orb_slam3_noted_tpu_torch.ops import image as image_ops
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.ops.stereo import match_stereo
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from orb_slam3_noted_tpu_torch.pipeline import tracking as ttr
from orb_slam3_noted_tpu_torch.pipeline.system import OK, StereoSLAM
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

W, H = 320, 240
FX = 260.0
BASELINE = 0.12
PARAMS = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
CFG_KW = dict(width=W, height=H, n_features=600, bf=FX * BASELINE, th_depth=35.0,
              max_keyframes=32, max_map_points=4096, local_window=5, kf_max_interval=10)
N_FRAMES, BATCH = 16, 6
CPU = torch.device("cpu")
TRACKED_MARGIN, RMSE_FACTOR, RMSE_SLACK_M, KF_MARGIN = 2, 2.0, 0.002, 1


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
    pairs = []
    for R, t in poses:
        left, right, _ = stereo_pair(room, R, t, PARAMS, W, H, BASELINE)
        pairs.append((left.astype(np.uint8), right.astype(np.uint8)))
    return poses, pairs


def drive(slam, pairs):
    i = 0
    while i < len(pairs) and slam.state == "NOT_INITIALIZED":
        slam.process(pairs[i][0], pairs[i][1], i)
        i += 1
    while i < len(pairs):
        j = min(i + BATCH, len(pairs))
        slam.process_batch(pairs[i:j], list(range(i, j)))
        i = j
    return slam


@pytest.fixture(scope="module")
def laps(frames):
    js = jsys.StereoSLAM(JConfig(camera=JCamera(0, PARAMS), **CFG_KW))
    calls = []
    orig = jtr.stereo_track_batch

    def recording(*args, **kw):
        out = orig(*args, **kw)
        calls.append(jax.device_get((args[:7], kw, out)))
        return out

    jtr.stereo_track_batch = recording
    try:
        drive(js, frames[1])
    finally:
        jtr.stereo_track_batch = orig
    return js, calls, drive(StereoSLAM(tcfg(), device=CPU), frames[1])


def _rmse(slam, poses):
    gt = np.asarray([t for _, t in poses])
    Rwc0, twc0 = poses[0]
    err = np.linalg.norm(slam.positions() - (gt - twc0) @ Rwc0, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def test_stereo_batch_lap_matches_jax_in_aggregate(laps, frames):
    js, calls, ts = laps
    assert len(calls) == 3  # frame 0 initialises, then 15 frames in batches of 6
    tracked = [sum(r.state == OK for r in s.trajectory) for s in (js, ts)]
    assert len(ts.trajectory) == N_FRAMES
    assert tracked[1] >= tracked[0] - TRACKED_MARGIN
    rmse_j, rmse_t = _rmse(js, frames[0]), _rmse(ts, frames[0])
    assert rmse_t <= RMSE_FACTOR * rmse_j + RMSE_SLACK_M, (rmse_t, rmse_j)
    assert abs(ts.n_kf - js.n_kf) <= KF_MARGIN


def test_batched_front_end_equals_pair_by_pair(frames):
    """One extraction over the 2B images and one matcher call over the B
    pairs give every pair what it gets alone."""
    cfg = tcfg()
    pairs = frames[1][:3]
    L = torch.from_numpy(np.stack([p[0] for p in pairs]))
    R = torch.from_numpy(np.stack([p[1] for p in pairs]))
    featsL, uvr, depth = ttr.stereo_frontend_batch(torch.cat([L, R]), cfg.camera, cfg, cfg.bf)
    assert uvr.shape == depth.shape == (3, cfg.n_features)
    for b, (left, right) in enumerate(pairs):
        pair = torch.from_numpy(np.stack([left, right])).to(torch.float32)
        pyr = tuple(image_ops.build_pyramid(pair, cfg.n_levels, cfg.scale_factor))
        both = torb.extract_from_pyramid(pyr, n_features=cfg.n_features)
        fl, fr = (torb.FrameFeatures(*(f[i] for f in both)) for i in range(2))
        for a, c in zip(fl, torb.FrameFeatures(*(f[b] for f in featsL))):
            assert torch.equal(a, c)
        sm = match_stereo(fl, fr, tuple(p[0] for p in pyr), tuple(p[1] for p in pyr),
                          bf=cfg.bf, baseline=BASELINE, n_levels=cfg.n_levels,
                          scale_factor=cfg.scale_factor)
        assert torch.equal(torch.where(sm.valid, sm.u_right, -1.0), uvr[b])
        assert torch.equal(torch.where(sm.valid, sm.depth, -1.0), depth[b])
        assert int(sm.valid.sum()) > 0.3 * cfg.n_features


# The first batch after initialisation predicts its first frame at keyframe
# 0's own pose, where every depth point's distance ratio is a power of the
# scale factor and its predicted octave ceil(log(d_max / d) / log 1.2) lands
# on an integer: the last bit of ``log`` (XLA's and torch's differ) decides
# it.  That frame is held to what this costs (measured: 3 of 388 matches,
# R 5.6e-4, t 3.2e-3, inliers 379 against 376 on one x86 CPU, 380 against
# 376 on an AMD EPYC with AVX-512); every other frame exactly.
AT_KF_R, AT_KF_T, AT_KF_SHARE, AT_KF_INLIERS = 1e-3, 5e-3, 0.99, 4


@pytest.mark.parametrize("call", [0, 1, 2])
def test_stereo_track_batch_feats_matches_jax(laps, call):
    """The stereo scan on the JAX package's map, features and stereo rows."""
    _, calls, ts = laps
    (mj, _, _, slot, R0, t0, vel), kw, out = calls[call]
    mjo, Rs, tss, n_inl, feats, mp_feats, uvr, _ = out
    cm = torch.from_numpy(np.asarray(kw["count_mask"]))
    mt, Rt, tt, nt, _, mpt = ttr.track_batch_feats(
        tms.from_numpy(mj._asdict()), torb.from_numpy(feats._asdict()),
        int(slot), torch.from_numpy(R0), torch.from_numpy(t0),
        tuple(torch.from_numpy(np.asarray(v, np.float32)) for v in vel),
        ts.cam, ts.cfg, bf=ts.cfg.bf, count_mask=cm, uvr_all=torch.from_numpy(uvr),
    )
    at_kf = call == 0
    k = 1 if at_kf else 0
    np.testing.assert_array_equal(nt.numpy()[k:], n_inl[k:])
    np.testing.assert_allclose(Rt.numpy()[k:], Rs[k:], atol=1e-4)
    np.testing.assert_allclose(tt.numpy()[k:], tss[k:], atol=1e-3)
    np.testing.assert_array_equal(mpt.numpy()[k:], mp_feats[k:])
    if at_kf:
        assert abs(int(nt[0]) - int(n_inl[0])) <= AT_KF_INLIERS
        np.testing.assert_allclose(Rt.numpy()[0], Rs[0], atol=AT_KF_R)
        np.testing.assert_allclose(tt.numpy()[0], tss[0], atol=AT_KF_T)
        assert (mpt.numpy()[0] == mp_feats[0]).mean() >= AT_KF_SHARE
        assert (mt.mp_found.numpy() == mjo.mp_found).mean() >= AT_KF_SHARE
    else:
        np.testing.assert_array_equal(mt.mp_found.numpy(), mjo.mp_found)
        np.testing.assert_array_equal(mt.mp_visible.numpy(), mjo.mp_visible)


def test_stereo_track_batch_matches_jax_front_end(laps):
    """The whole stereo batch step from the images on the JAX package's map
    (the second batch: the first starts at a keyframe's pose, see above).
    The port's own extraction and matcher give stereo rows that agree on
    >= 99% of the features with the JAX package's (``match_stereo``'s
    limit), so the poses are held to R 5e-4, t 5e-3 and the inliers to 1%
    (measured: 99.8% of the rows, R 1.8e-4, t 1.5e-3, one inlier of 300)."""
    _, calls, ts = laps
    (mj, L, R, slot, R0, t0, vel), kw, out = calls[1]
    mt, Rt, tt, nt, _, _, uvr, depth = ttr.stereo_track_batch(
        tms.from_numpy(mj._asdict()), torch.from_numpy(np.concatenate([L, R])), int(slot),
        torch.from_numpy(R0), torch.from_numpy(t0),
        tuple(torch.from_numpy(np.asarray(v, np.float32)) for v in vel),
        ts.cam, ts.cfg, bf=ts.cfg.bf, count_mask=torch.from_numpy(np.asarray(kw["count_mask"])),
    )
    valid_j, valid_t = out[6] >= 0, uvr.numpy() >= 0
    assert (valid_j == valid_t).mean() >= 0.99
    np.testing.assert_allclose(Rt.numpy(), out[1], atol=5e-4)
    np.testing.assert_allclose(tt.numpy(), out[2], atol=5e-3)
    assert np.all(np.abs(nt.numpy() - out[3]) <= 0.01 * out[3])
