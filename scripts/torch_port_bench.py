"""Tracked frames/s of the PyTorch port on one NVIDIA GPU, on ``bench.py``'s laps.

    python3 scripts/torch_port_bench.py [--laps mono,stereo,loop,inertial]

The JAX package's ``bench.py`` laps, driven through the port on ``cuda``
with loop closing on, as ``bench.py`` runs them: every keyframe the mapper
inserts is queued for loop detection (one 32k-word BoW transform and one
``DetectNBestCandidates`` each), drained at the next batch:

- mono: ``MonoSLAM.process_batch`` in batches of 16 from frame 0 over 120
  frames of ``orbit_trajectory(120, forward=0.03, yaw0=0.45)`` in
  ``BoxRoom(seed=0)``, 752x480, 1200 features, 64 keyframes, 8192 map
  points, local window 5, a keyframe at least every 10 frames;
- stereo: 96 rectified pairs (baseline 0.11 m, ``bf = 0.11 fx``,
  ``th_depth`` 45, 16384 map points), ``process`` until initialised, then
  ``process_batch`` in batches of 16;
- loop: the 400-frame accuracy lap (``bench.py:215-309``, frames rendered
  from the camera poses stored in ``tests/fixtures/mono_loop_lap.json``),
  once with loop closing off and once on, on the port's own RANSAC draws;
  its line is ``mono_400f_loop_ate``: the Sim(3)-aligned ATE over the
  tracked frames with loop closing on, ``vs_baseline`` = ATE off / ATE on;
- inertial: the stereo-inertial lap (``bench.py:146-212``, its first line):
  ``StereoInertialSLAM.process_batch`` in batches of 16 from frame 0 over
  240 pairs of ``smooth_pose`` at 20 fps with 200 Hz IMU, ``cfg_vi``'s
  values, frames rendered from the camera poses and fed the IMU samples
  stored in ``tests/fixtures/stereo_inertial_lap.json``; its line is
  ``stereo_inertial_tracked_fps_752x480_1200feat`` with ``tracked_frames``,
  ``n_frames`` and ``imu_stage``.

Frames are staged on the card once, before the laps, as ``bench.py`` stages
them.  The mono, stereo and inertial laps run once to warm up (the kernels'
build included), then once timed on the host clock with the card synchronised at
the end (``vs_baseline`` = frames/s / 20, the reference's camera rate).
Each lap prints its JSON line as soon as it ends, under ``bench.py``'s
metric names, with the card's name and power limit as ``nvidia-smi`` gives
them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (torch and the port load inside main)

N_MONO, N_STEREO = 120, 96


def report(metric: str, slam, frames, per_frame_until_init: bool, smi: str, **extra) -> None:
    ids = list(range(len(frames)))
    cs.drive_batches(slam(), frames, ids, per_frame_until_init)  # warm-up: build, allocations
    s = slam()
    wall = cs.drive_batches(s, frames, ids, per_frame_until_init)
    fps = len(frames) / wall
    print(json.dumps({
        "metric": metric, "value": round(fps, 2), "unit": "frames/s",
        "vs_baseline": round(fps / 20.0, 3),
        "tracked_frames": sum(r.state == "OK" for r in s.trajectory), "n_frames": len(frames),
        "n_kf": s.n_kf, "n_mp": s.n_mp, "wall_s": wall, "batch": cs.BATCH,
        "loop_closing": True, "loops_closed": s.loop_closer.loops_closed if s.loop_closer else 0,
        "card": smi, **extra,
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--laps", default="mono,stereo,loop,inertial")
    args = ap.parse_args()
    laps = args.laps.split(",")

    import torch

    from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM, StereoSLAM
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

    if not torch.cuda.is_available():
        print("torch_port_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    room = BoxRoom(seed=0)
    if "mono" in laps:
        _, imgs = cs.mono_inputs()
        staged = torch.from_numpy(imgs).to(dev)
        frames = [staged[i] for i in range(N_MONO)]
        report("mono_tracked_fps_752x480_1200feat",
               lambda: MonoSLAM(cs.mono_config(loop_closing=True), device=dev), frames, False, smi)
    if "stereo" in laps:
        cfg = dataclasses.replace(cs.lap_config(), enable_loop_closing=True)
        pairs = [stereo_pair(room, R, t, cs.CAM_PARAMS, cs.W, cs.H, cs.BASELINE)[:2]
                 for R, t in orbit_trajectory(N_STEREO, forward=0.03, yaw0=0.45)]
        staged = torch.from_numpy(np.stack([p[0] for p in pairs] + [p[1] for p in pairs])
                                  .astype(np.uint8)).to(dev)
        frames = [(staged[i], staged[N_STEREO + i]) for i in range(N_STEREO)]
        report("stereo_tracked_fps_752x480_1200feat", lambda: StereoSLAM(cfg, device=dev),
               frames, True, smi)
    if "loop" in laps:
        poses, imgs = cs.loop_inputs(cs.load_fixture(cs.LOOP_FIXTURE, cs.LOOP_FRAMES))
        staged = torch.from_numpy(imgs).to(dev)
        frames = [staged[i] for i in range(len(imgs))]
        arms = [cs.run_loop_arm(frames, poses, on, dev)[1] for on in (False, True)]
        print(json.dumps({**cs.loop_metric_line(*arms),
                          **{f"{k}_{'on' if a['loop_closing'] else 'off'}": a[k] for a in arms
                             for k in ("fps", "batch_ms_p50", "batch_ms_max", "kf_inserted")},
                          "card": smi}), flush=True)
    if "inertial" in laps:
        inertial(dev, smi)
    return 0


def inertial(dev, smi: str) -> None:
    """``bench.py``'s stereo-inertial lap: a warm-up pass, then one timed
    pass on the host clock with the card synchronised at the end."""
    import time

    import torch

    from orb_slam3_noted_tpu_torch.pipeline.inertial_system import StereoInertialSLAM

    ref = cs.load_fixture(cs.SI_FIXTURE, cs.SI_FRAMES)
    _, times, pairs, chunks = cs.si_inputs(ref)
    n = len(pairs)
    staged = torch.from_numpy(np.stack([p[0] for p in pairs] + [p[1] for p in pairs])).to(dev)
    frames = [(staged[i], staged[n + i]) for i in range(n)]

    def run():
        sv = StereoInertialSLAM(cs.si_config(ref), device=dev)
        for c, s0 in enumerate(range(0, n, cs.BATCH)):
            s1 = min(s0 + cs.BATCH, n)
            a, g, ts = chunks[c]
            sv.process_batch(frames[s0:s1], list(range(s0, s1)), ts=times[s0:s1], acc=a, gyr=g,
                             imu_t=ts)
        return sv

    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sv = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fps = n / wall
    print(json.dumps({
        "metric": "stereo_inertial_tracked_fps_752x480_1200feat", "value": round(fps, 2),
        "unit": "frames/s", "vs_baseline": round(fps / 20.0, 3),
        "tracked_frames": sum(r.state == "OK" for r in sv.trajectory), "n_frames": n,
        "imu_stage": sv.imu_stage, "n_kf": sv.n_kf, "n_mp": sv.n_mp, "wall_s": wall,
        "batch": cs.BATCH, "loop_closing": True,
        "loops_closed": sv.loop_closer.loops_closed if sv.loop_closer else 0, "card": smi,
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
