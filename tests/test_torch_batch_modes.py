"""Parity of the port's RGB-D and fisheye stereo batch modes with the JAX
package on the CPU, at the size of ``tests/test_torch_stereo_batch.py``
(320x240 RGB-D, 600 features, 16 frames, batches of 6) and on the rotated
rig of ``tests/test_torch_fisheye.py`` (384x384 KB8 pairs, 800 features).

The JAX package's ``RGBDSLAM`` and ``FisheyeStereoSLAM`` inherit the
rectified stereo batch hooks: the depth map goes through SAD matching as if
it were a right image, and fisheye pairs go through rectified SAD with no
second-camera rows (shown in both packages by
``tests/test_torch_tracking.py::test_unported_paths_raise`` and
``tests/test_torch_fisheye.py::test_fisheye_batch_mode_raises``).  The port
runs the documented front ends in batch mode (the bilinear depth rule, the
lapping-area matcher and its right pixels), so its batch laps are held to
the JAX package's frame-by-frame laps (tracked >= JAX - 2, RMSE <= 2 x JAX +
2 mm, keyframes +-1), and the keyframes they insert carry the documented
rows.  The batched front ends must give every frame what it gets alone,
exactly, and the batched scan with right pixels must give the JAX package's
chained ``track_frame`` poses (R 1e-4, t 1e-3) and inliers.  Every input is
made with numpy from a seed.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import se3 as jse3
from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.pipeline import map_state as jms
from orb_slam3_noted_tpu.pipeline import system as jsys
from orb_slam3_noted_tpu.pipeline import tracking as jtr
from orb_slam3_noted_tpu_torch.io.config import config_from
from orb_slam3_noted_tpu_torch.geometry import so3 as tso3
from orb_slam3_noted_tpu_torch.models.cameras import Camera, KANNALA_BRANDT8
from orb_slam3_noted_tpu_torch.ops import orb as torb
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from orb_slam3_noted_tpu_torch.pipeline import tracking as ttr
from orb_slam3_noted_tpu_torch.pipeline.system import OK, FisheyeStereoSLAM, RGBDSLAM
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

CPU = torch.device("cpu")
N_FRAMES, BATCH = 16, 6
TRACKED_MARGIN, RMSE_FACTOR, RMSE_SLACK_M, KF_MARGIN = 2, 2.0, 0.002, 1
R_TOL, T_TOL = 1e-4, 1e-3

# RGB-D: tests/test_torch_stereo_batch.py's camera and configuration
W, H = 320, 240
FX = 260.0
BASELINE = 0.12
PARAMS = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
CFG_KW = dict(width=W, height=H, n_features=600, bf=FX * BASELINE, th_depth=35.0,
              max_keyframes=32, max_map_points=4096, local_window=5, kf_max_interval=10)
HOLES = 6  # invalid 16x16 blocks a depth map: the nearest-pixel fallback's edges

# fisheye: tests/test_torch_fisheye.py's rig (the right camera rotated
# against the left) and its 10-frame lap's motion, carried on to 16 frames
FW = FH = 384
KB = (160.0, 160.0, 191.5, 191.5, 0.0034, 0.00077, -0.0025, 0.00069)
KB2 = (161.0, 159.5, 190.0, 192.5, 0.0031, 0.0011, -0.0022, 0.0004)
FE_BASELINE = 0.101
RLR_AXIS = (0.003, -0.005, 0.002)
FE_CHAIN = (3, 3 + BATCH)  # the frames of the chained scan, from frame 3's map


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


def drive(slam, frames):
    """``process`` until initialised, then ``process_batch`` in batches."""
    i = 0
    while i < len(frames) and slam.state == "NOT_INITIALIZED":
        slam.process(frames[i][0], frames[i][1], i)
        i += 1
    while i < len(frames):
        j = min(i + BATCH, len(frames))
        slam.process_batch(frames[i:j], list(range(i, j)))
        i = j
    return slam


def frame_by_frame(slam, frames):
    for i, (a, b) in enumerate(frames):
        slam.process(a, b, i)
    return slam


def rmse(slam, gt_world) -> float:
    err = np.linalg.norm(slam.positions() - gt_world, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def hold_lap(js, ts, gt_world):
    """The port's batch lap against the JAX package's frame-by-frame lap."""
    tracked = [sum(r.state == OK for r in s.trajectory) for s in (js, ts)]
    assert len(ts.trajectory) == N_FRAMES
    assert tracked[1] >= tracked[0] - TRACKED_MARGIN, tracked
    rj, rt = rmse(js, gt_world), rmse(ts, gt_world)
    assert rt <= RMSE_FACTOR * rj + RMSE_SLACK_M, (rt, rj)
    assert abs(ts.n_kf - js.n_kf) <= KF_MARGIN, (ts.n_kf, js.n_kf)


def batch_slots(slam) -> list:
    """Keyframe slots inserted by ``process_batch`` (frame 0 initialised)."""
    return [int(s) for s in np.flatnonzero(np.asarray(slam.kf_frame_ids) > 0)]


def depth_rule_agreement(slam, frames) -> tuple[int, int]:
    """Over the keyframes ``process_batch`` inserted: (rows where ``u - bf /
    d`` from the frame's depth map gives a value, rows whose ``kf_uvr``
    equals it within 1e-3 px)."""
    m = slam.m
    n_rule = n_same = 0
    for s in batch_slots(slam):
        dmap = torch.from_numpy(frames[int(slam.kf_frame_ids[s])][1])
        _, want = ttr.rgbd_depth_rows(SimpleNamespace(xy=m.kf_xy[s], valid=m.kf_feat_valid[s]),
                                      dmap, slam.cfg.bf)
        ok = want >= 0
        n_rule += int(ok.sum())
        n_same += int(((m.kf_uvr[s] - want).abs()[ok] <= 1e-3).sum())
    return n_rule, n_same


# ---------------------------------------------------------------------------
# RGB-D

def tcfg():
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE

    return SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW)


@pytest.fixture(scope="module")
def rgbd():
    """(world-frame camera centres, [(image uint8, depth float32)]): depth
    maps with holes (0 = no reading) from a seeded generator."""
    rng = np.random.default_rng(14)
    room = BoxRoom(seed=0)
    poses = orbit_trajectory(48, forward=0.03, yaw0=0.45)[:N_FRAMES]
    frames = []
    for R, t in poses:
        left, _, depth = stereo_pair(room, R, t, PARAMS, W, H, BASELINE)
        depth = depth.astype(np.float32)
        for y, x in zip(rng.integers(0, H - 16, HOLES), rng.integers(0, W - 16, HOLES)):
            depth[y:y + 16, x:x + 16] = 0.0
        frames.append((left.astype(np.uint8), depth))
    gt = np.asarray([t for _, t in poses])
    Rwc0, twc0 = poses[0]
    return (gt - twc0) @ Rwc0, frames


@pytest.fixture(scope="module")
def rgbd_laps(rgbd):
    """JAX frame by frame, the port in batches."""
    _, frames = rgbd
    js = frame_by_frame(jsys.RGBDSLAM(JConfig(camera=JCamera(0, PARAMS), **CFG_KW)), frames)
    return js, drive(RGBDSLAM(tcfg(), device=CPU), frames)


def test_rgbd_frontend_batch_equals_frame_by_frame(rgbd):
    """One extraction over the B images and the depth rule over (B, NF)
    give every frame what ``RGBDSLAM.process`` computes for it alone."""
    _, frames = rgbd
    cfg = tcfg()
    slam = RGBDSLAM(cfg, device=CPU)
    imgs, depths = slam._prep_batch(frames[:BATCH], 0)
    assert imgs.dtype == torch.uint8 and depths.dtype == torch.float32
    feats, uvr, depth = ttr.rgbd_frontend_batch(imgs, depths, cfg)
    assert uvr.shape == depth.shape == (BATCH, cfg.n_features)
    fell_back = 0
    for b, (img, dmap) in enumerate(frames[:BATCH]):
        f1 = slam._extract(torch.from_numpy(img).to(torch.float32))
        for a, c in zip(f1, torb.FrameFeatures(*(f[b] for f in feats))):
            assert torch.equal(a, c)
        d1, u1 = ttr.rgbd_depth_rows(f1, torch.from_numpy(dmap), cfg.bf)
        assert torch.equal(d1, depth[b]) and torch.equal(u1, uvr[b])
        ok = d1 > 0
        assert int(ok.sum()) > 0.5 * cfg.n_features
        np.testing.assert_allclose(u1.numpy()[ok], (f1.xy[:, 0] - cfg.bf / d1).numpy()[ok],
                                   rtol=0, atol=1e-4)
        # a keypoint next to a hole reads its nearest pixel
        x, y = f1.xy[:, 0].numpy(), f1.xy[:, 1].numpy()
        x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
        quad = np.stack([dmap[y0, x0], dmap[y0, x0 + 1], dmap[y0 + 1, x0], dmap[y0 + 1, x0 + 1]])
        edge = f1.valid.numpy() & (quad <= 0).any(0) & ok.numpy()
        near = dmap[np.round(y).astype(int), np.round(x).astype(int)]
        np.testing.assert_array_equal(d1.numpy()[edge], near[edge])
        fell_back += int(edge.sum())
    assert fell_back > 0


def test_rgbd_batch_lap_matches_jax_in_aggregate(rgbd, rgbd_laps):
    js, ts = rgbd_laps
    hold_lap(js, ts, rgbd[0])


def test_rgbd_batch_keyframes_carry_the_depth_rule(rgbd, rgbd_laps):
    """Keyframes inserted in batch mode keep ``u - bf / d`` from their
    frame's depth map, row for row."""
    _, ts = rgbd_laps
    assert batch_slots(ts)
    n_rule, n_same = depth_rule_agreement(ts, rgbd[1])
    assert n_rule > 100 and n_same == n_rule


# ---------------------------------------------------------------------------
# fisheye stereo

def rlr() -> np.ndarray:
    return np.array(jso3.exp(jnp.asarray(RLR_AXIS, jnp.float32)))


def fe_jcfg():
    return JConfig(
        camera=JCamera(1, KB), camera2=JCamera(1, KB2), width=FW, height=FH,
        n_features=800, bf=FE_BASELINE * KB[0], th_depth=60.0,
        tlr_r=tuple(float(x) for x in rlr().reshape(-1)), tlr_t=(FE_BASELINE, 0.0, 0.0),
        lapping_l=(0.0, float(FW)), lapping_r=(0.0, float(FW)),
        max_keyframes=32, max_map_points=8192, local_window=5, kf_max_interval=6,
    )


@pytest.fixture(scope="module")
def fisheye():
    """(camera centres, [(left, right) uint8]): the scene, rig and motion of
    tests/test_torch_fisheye.py's lap, 16 frames, rendered by the port."""
    room = BoxRoom(seed=5, depth=2.5, h=0.8, w=1.2)
    R = rlr().astype(np.float64)
    pairs, gt = [], []
    for i in range(N_FRAMES):
        twc = np.array([0.02 * i, 0.005 * i, 0.015 * i])
        Rwc = tso3.exp(torch.tensor([0.0, 0.01 * i, 0.0])).double().numpy()
        left = room.render_fisheye(Rwc, twc, Camera(KANNALA_BRANDT8, KB), FW, FH)
        right = room.render_fisheye(Rwc @ R, twc + Rwc @ np.array([FE_BASELINE, 0.0, 0.0]),
                                    Camera(KANNALA_BRANDT8, KB2), FW, FH)
        pairs.append((left.astype(np.uint8), right.astype(np.uint8)))
        gt.append(twc)
    return np.stack(gt), pairs


@pytest.fixture(scope="module")
def fe_laps(fisheye):
    """JAX frame by frame (its ``_track`` calls recorded: the map, the
    features, the right pixels and the prediction's inputs), the port in
    batches."""
    _, pairs = fisheye
    js = jsys.FisheyeStereoSLAM(fe_jcfg())
    calls = {}
    orig = js._track

    def recording(feats, frame_id, uvr=None, depth=None, xy_r=None):
        vel = js.vel if js.vel is not None else (jnp.eye(3, dtype=jnp.float32),
                                                 jnp.zeros(3, jnp.float32))
        calls[frame_id] = jax.device_get(dict(
            m=js.m, feats=feats, uv2=xy_r, slot=js.last_kf_slot, R=js.last_Rcw, t=js.last_tcw,
            vel=vel))
        return orig(feats, frame_id, uvr=uvr, depth=depth, xy_r=xy_r)

    js._track = recording
    frame_by_frame(js, pairs)
    return js, calls, drive(FisheyeStereoSLAM(config_from(fe_jcfg()), device=CPU), pairs)


def test_fisheye_frontend_batch_equals_pair_by_pair(fisheye):
    """One atlas over the 2B images and one matcher call over the B pairs
    give every pair what ``_fisheye_frontend`` gives it alone."""
    _, pairs = fisheye
    slam = FisheyeStereoSLAM(config_from(fe_jcfg()), device=CPU)
    n = 3
    prep = slam._prep_batch(pairs[:n], 0)
    assert prep.shape == (2 * n, FH, FW)
    feats, depth, uv2 = ttr.fisheye_frontend_batch(prep, slam.cfg, slam.Rlr, slam.tlr)
    assert depth.shape == (n, slam.cfg.n_features) and uv2.shape == (*depth.shape, 2)
    for b, (left, right) in enumerate(pairs[:n]):
        f1, d1, u1 = slam._fisheye_frontend(left, right)
        for a, c in zip(f1, torb.FrameFeatures(*(f[b] for f in feats))):
            assert torch.equal(a, c)
        assert torch.equal(d1, depth[b]) and torch.equal(u1, uv2[b])
        assert int((d1 > 0).sum()) > 150
        np.testing.assert_array_equal((u1[:, 0] >= 0).numpy(), (d1 > 0).numpy())


def test_track_batch_feats_with_right_pixels_matches_jax(fe_laps):
    """The batched scan with ``uv2_all`` on the JAX run's map, features and
    right pixels (frames 3-8, from frame 3's map; frame 1 starts at
    keyframe 0's own pose, see tests/test_torch_stereo_batch.py), against
    the JAX package's ``track_frame`` chained with the same constant-velocity
    prediction."""
    js, calls, ts = fe_laps
    a, b = FE_CHAIN
    first = calls[a]
    cfg = js.cfg
    jm = jms.MapArrays(**{k: jnp.asarray(v) for k, v in first["m"]._asdict().items()})
    mask, _ = jms.local_map_mask(jm, jnp.int32(first["slot"]), n_neighbors=cfg.local_window)
    Rprev, tprev = jnp.asarray(first["R"]), jnp.asarray(first["t"])
    Rv, tv = (jnp.asarray(x) for x in first["vel"])
    want = []
    for f in range(a, b):
        Rp, tp = jse3.compose((Rv, tv), (Rprev, tprev))
        feats = jax.tree_util.tree_map(jnp.asarray, calls[f]["feats"])
        R, t, n, _, _, _ = jtr.track_frame(
            jm, feats, Rp, tp, mask, js.cam, cfg, feat_uvr=jnp.full((cfg.n_features,), -1.0),
            bf=cfg.bf, feat_uv2=jnp.asarray(calls[f]["uv2"]))
        ok = n >= cfg.min_tracked_points
        Rv2, tv2 = jse3.compose((R, t), jse3.inverse((Rprev, tprev)))
        Rv, tv = jnp.where(ok, Rv2, Rv), jnp.where(ok, tv2, tv)
        Rprev, tprev = jnp.where(ok, R, Rp), jnp.where(ok, t, tp)
        want.append(jax.device_get((Rprev, tprev, n)))
    stack = lambda k: {f: np.stack([np.asarray(calls[i]["feats"]._asdict()[f])
                                    for i in range(a, b)]) for f in k}
    feats_t = torb.from_numpy(stack(torb.FrameFeatures._fields))
    uv2 = torch.from_numpy(np.stack([calls[i]["uv2"] for i in range(a, b)]))
    _, Rt, tt, nt, _, _ = ttr.track_batch_feats(
        tms.from_numpy(first["m"]._asdict()), feats_t, int(first["slot"]),
        torch.from_numpy(np.asarray(first["R"])), torch.from_numpy(np.asarray(first["t"])),
        tuple(torch.from_numpy(np.asarray(v, np.float32)) for v in first["vel"]),
        ts.cam, ts.cfg, bf=ts.cfg.bf, uv2_all=uv2)
    n_right = int((uv2[..., 0] >= 0).sum())
    assert n_right > 6 * 150
    np.testing.assert_array_equal(nt.numpy(), [int(w[2]) for w in want])
    np.testing.assert_allclose(Rt.numpy(), np.stack([w[0] for w in want]), rtol=0, atol=R_TOL)
    np.testing.assert_allclose(tt.numpy(), np.stack([w[1] for w in want]), rtol=0, atol=T_TOL)
    # without the right pixels the scan is another one (the rows count)
    _, R0, t0, n0, _, _ = ttr.track_batch_feats(
        tms.from_numpy(first["m"]._asdict()), feats_t, int(first["slot"]),
        torch.from_numpy(np.asarray(first["R"])), torch.from_numpy(np.asarray(first["t"])),
        tuple(torch.from_numpy(np.asarray(v, np.float32)) for v in first["vel"]),
        ts.cam, ts.cfg, bf=ts.cfg.bf)
    assert not torch.equal(t0, tt)


def test_fisheye_batch_lap_matches_jax_in_aggregate(fisheye, fe_laps):
    js, _, ts = fe_laps
    hold_lap(js, ts, fisheye[0])
    # the right camera's observations entered the map
    xyr = ts.m.kf_xy_r[: ts.n_kf].numpy()
    assert (xyr[..., 0] >= 0).sum() > 50


def test_fisheye_batch_keyframes_carry_right_rows(fe_laps):
    """Every keyframe inserted in batch mode carries its second-camera rows:
    the right pixels of the features the lapping-area matcher paired."""
    _, _, ts = fe_laps
    slots = batch_slots(ts)
    assert slots
    rows = ts.m.kf_xy_r.numpy()[slots][..., 0] >= 0
    assert rows.sum(axis=1).min() > 50
