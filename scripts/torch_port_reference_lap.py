"""Reference lap for the PyTorch port: JAX ``RGBDSLAM`` in localisation mode.

Runs the JAX package's RGB-D system on the CPU over the lap that
``chip_smoke.py`` drives through the port: the stereo bench configuration
(``bench.py``: EuRoC-sized pinhole camera, 752x480, 1200 features, 8 levels,
``bf = 0.11 * fx``, ``th_depth = 45``, 64 keyframes, 16384 map points, loop
closing off), frames and depth rendered from ``BoxRoom(seed=0)`` along
``orbit_trajectory(n, forward=0.03, yaw0=0.45)``.  The map is the one built
from frame 0's depth; localisation mode never inserts another keyframe.

Writes per-frame states, inlier counts and ``positions()`` to a small JSON
file (default ``tests/fixtures/rgbd_localization_lap.json``)::

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

W, H = 752, 480
CAM_PARAMS = (458.654, 457.296, 367.215, 248.375)
BASELINE = 0.11


def lap_inputs(n_frames: int):
    """(poses, uint8 images, float32 depth maps) of the lap, numpy only."""
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory

    room = BoxRoom(seed=0)
    poses = orbit_trajectory(n_frames, forward=0.03, yaw0=0.45)
    imgs, depths = [], []
    for Rwc, twc in poses:
        img, depth = room.render(Rwc, twc, CAM_PARAMS, W, H, return_depth=True)
        imgs.append(img.astype(np.uint8))
        depths.append(depth.astype(np.float32))
    return poses, imgs, depths


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument(
        "--out",
        default=os.path.join(ROOT, "tests", "fixtures", "rgbd_localization_lap.json"),
    )
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.pipeline.system import RGBDSLAM

    cam = Camera(PINHOLE, CAM_PARAMS)
    cfg = SlamConfig(
        camera=cam, width=W, height=H, n_features=1200, n_levels=8,
        scale_factor=1.2, bf=BASELINE * cam.fx, th_depth=45.0,
        max_keyframes=64, max_map_points=16384,
        local_window=5, kf_max_interval=10, enable_loop_closing=False,
    )
    poses, imgs, depths = lap_inputs(args.frames)
    slam = RGBDSLAM(cfg)
    slam.set_localization_mode(True)
    t0 = time.perf_counter()
    for i in range(args.frames):
        slam.process(imgs[i], depths[i], i)
        rec = slam.trajectory[-1]
        print(f"frame {i:3d} {rec.state:<14} inliers {rec.n_inliers}",
              file=sys.stderr)
    wall = time.perf_counter() - t0

    est = slam.positions()
    gt = np.asarray([t for _, t in poses])
    Rwc0, twc0 = poses[0]
    gt_c0 = (gt - twc0) @ Rwc0
    err = np.linalg.norm(est - gt_c0, axis=1)
    states = [r.state for r in slam.trajectory]
    out = {
        "source": "JAX RGBDSLAM, localisation mode, CPU",
        "frames": args.frames,
        "width": W, "height": H, "camera": list(CAM_PARAMS),
        "n_features": 1200, "bf": BASELINE * cam.fx, "th_depth": 45.0,
        "room_seed": 0, "forward": 0.03, "yaw0": 0.45,
        "states": states,
        "n_inliers": [int(r.n_inliers) for r in slam.trajectory],
        "positions": est.astype(float).tolist(),
        "tracked": int(sum(s == "OK" for s in states)),
        "rmse_m": float(np.sqrt((err ** 2).mean())),
        "max_err_m": float(err.max()),
        "n_mp": int(slam.n_mp),
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: out[k] for k in ("frames", "tracked", "rmse_m",
                                          "max_err_m", "n_mp")}))
    print(f"wall {wall:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
