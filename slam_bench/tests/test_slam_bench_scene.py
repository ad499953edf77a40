"""The card renderer against the port's numpy ``BoxRoom``, the path's form
against ``smooth_pose`` where the fold does not act, and the mixes' path at
EuRoC's speeds."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, smooth_pose, stereo_pair
from slam_bench import scene

ROOT = Path(__file__).resolve().parents[2]
CAM = (200.0, 200.0, 160.0, 120.0)
W, H = 320, 240


def test_render_equals_boxroom():
    room = BoxRoom(seed=4, tex_size=256)
    tex = torch.tensor(np.stack(room.tex))
    rays = scene.pinhole_rays(CAM, W, H, "cpu")
    for t in (0.0, 1.7, 6.3):
        R, tw = smooth_pose(t)
        ref, dref = room.render(R, tw, CAM, W, H, return_depth=True)
        img, d = scene.render(tex, torch.tensor(R)[None], torch.tensor(tw)[None], rays,
                              with_depth=True)
        assert np.abs(img[0].numpy() - ref).max() < 1e-3
        assert np.allclose(d[0].numpy(), dref, rtol=1e-6, equal_nan=True)


def test_render_stereo_equals_stereo_pair():
    room = BoxRoom(seed=5, tex_size=256)
    tex = torch.tensor(np.stack(room.tex))
    R, tw = smooth_pose(2.0)
    left, right, _ = stereo_pair(room, R, tw, CAM, W, H, 0.11)
    cam = {"params": list(CAM), "width": W, "height": H}
    L, Rr = scene.render_stereo(tex, torch.tensor(R)[None], torch.tensor(tw)[None], cam, 0.11)
    # the ray directions are rotated in another summation order than numpy's:
    # a pixel whose value lies within an ulp of an integer may truncate apart
    for got, ref in ((L[0], left), (Rr[0], right)):
        diff = np.abs(got.numpy().astype(int) - ref.astype(np.uint8).astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999


def test_textures_from_seed():
    a = scene.room_textures(scene.seed_generator(7, "cpu"), "cpu", 256)
    b = scene.room_textures(scene.seed_generator(7, "cpu"), "cpu", 256)
    c = scene.room_textures(scene.seed_generator(8, "cpu"), "cpu", 256)
    assert a.shape == (3, 256, 256) and torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) == 0.0 and abs(float(a.max()) - 255.0) < 1e-3


def test_patrol_is_smooth_pose_with_the_drift_folded():
    # smooth_pose's own amplitudes and rates, its 0.14 m/s drift folded into 1.5 m
    motion = {"centre_m": [0.0, 0.0, 0.0], "fold_m": 1.5, "fold_rad_s": 0.14 / 1.5, "sway_m": [0.45, 0.12, 0.05],
              "sway_rad_s": [0.55, 1.1, 0.9], "yaw0": 0.45, "turn_rad": [0.05, 0.10, 0.03],
              "turn_rad_s": [0.5, 0.7, 0.8]}
    Rw, tw = scene.patrol_poses(400, 20.0, torch.zeros(4), motion, "cpu")
    for i in (0, 3, 7):
        R, t = smooth_pose(i / 20.0)
        assert np.abs(Rw[i].numpy() - R).max() < 1e-6
        assert np.abs(tw[i, :2].numpy() - t[:2]).max() < 1e-12
        assert abs(float(tw[i, 2]) - t[2]) < 1e-3  # 1.5 sin(t / 10.7) against 0.14 t
    z = tw[:, 2].numpy()
    assert z.max() < 1.6 and np.all(np.abs(np.diff(z)) < 0.012)


@pytest.mark.parametrize("mix", ["replay_b16", "live_f1"])
def test_path_moves_at_euroc_mh01_speeds(mix):
    """The mixes' path moves at EuRoC MH_01_easy's mean speed and turn
    rate (0.44 m/s, 0.22 rad/s; Burri et al., IJRR 2016) within 3%, over
    ten minutes, and keeps between x = -12 and x = 0 m: the back wall seen
    along the way spans some 20 m, under one texture period (2048 / 80 =
    25.6 m), so that no texture seen repeats."""
    motion = json.loads((ROOT / "slam_bench" / "traffic" / f"{mix}.json").read_text())["motion"]
    fps = 20.0
    Rw, tw = scene.patrol_poses(12000, fps, torch.zeros(4), motion, "cpu")
    Rw, tw = Rw.numpy(), tw.numpy()
    speed = np.linalg.norm(np.diff(tw, axis=0), axis=1) * fps
    rel = np.einsum("nij,nkj->nik", Rw[1:], Rw[:-1])
    turn = np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)) * fps
    assert abs(speed.mean() / 0.44 - 1) < 0.03 and abs(turn.mean() / 0.22 - 1) < 0.03
    assert np.abs(tw[:, 2]).max() < 1.6 and tw[:, 0].max() < 1e-9 and tw[:, 0].min() > -12.1
