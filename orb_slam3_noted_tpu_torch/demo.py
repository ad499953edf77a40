"""End-to-end demo: monocular SLAM on a synthetic rendered sequence (port
of :mod:`orb_slam3_noted_tpu.demo`).

Usage: ``python -m orb_slam3_noted_tpu_torch.demo [n_frames] [--small]
[--device cpu]``

Renders a camera sweep through a textured room (752x480, 1200 features;
``--small``: 320x240, 600), runs ``MonoSLAM`` frame by frame on the device
(the card unless ``--device`` names another), prints each frame's tracking
state and the Sim(3)-aligned ATE.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM
from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory


def run(n_frames: int = 60, small: bool = False, verbose: bool = True, device=None):
    if small:
        W, H, nfeat = 320, 240, 600
        cam = Camera(PINHOLE, (260.0, 260.0, W / 2 - 0.5, H / 2 - 0.5))
    else:
        W, H, nfeat = 752, 480, 1200
        cam = Camera(PINHOLE, (458.654, 457.296, 367.215, 248.375))
    cfg = SlamConfig(
        camera=cam, width=W, height=H, n_features=nfeat,
        max_keyframes=64, max_map_points=8192,
        local_window=5, kf_max_interval=10,
    )
    slam = MonoSLAM(cfg, device=device)
    room = BoxRoom(seed=0)
    poses = orbit_trajectory(n_frames, forward=0.025)
    frames = [room.render(R, t, cam.params, W, H) for R, t in poses]

    t0 = time.time()
    for i, img in enumerate(frames):
        rec = slam.process(img, i)
        if verbose:
            print(f"frame {i:3d} state={slam.state:15s} inliers={rec.n_inliers:4d} "
                  f"kf={slam.n_kf} mp={slam.n_mp}", flush=True)
    if slam.device.type == "cuda":
        torch.cuda.synchronize(slam.device)
    wall = time.time() - t0

    est = slam.positions()
    gt = np.stack([p[1] for p in poses])
    ok = np.array([r.state == "OK" for r in slam.trajectory])
    rmse, _, (_, _, s) = ate_rmse(est[ok], gt[ok], with_scale=True)
    span = float(np.linalg.norm(gt[ok].max(0) - gt[ok].min(0)))
    fps = n_frames / wall
    print(
        f"tracked {int(ok.sum())}/{n_frames} frames | {slam.n_kf} KFs, "
        f"{slam.n_mp} map points | ATE {rmse * 100:.2f} cm over {span:.2f} m "
        f"({100 * rmse / max(span, 1e-9):.1f}%) | {fps:.1f} fps on {slam.device}"
    )
    return dict(rmse=rmse, span=span, fps=fps, tracked=int(ok.sum()), slam=slam)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_frames", nargs="?", type=int, default=60)
    p.add_argument("--small", action="store_true", help="320x240, 600 features")
    p.add_argument("--device", default="cuda", help="torch device of the SLAM state")
    args = p.parse_args(argv)
    return run(args.n_frames, args.small, device=torch.device(args.device))


if __name__ == "__main__":
    main()
