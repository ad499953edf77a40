"""Where the time of the port's smoke laps goes, on one NVIDIA GPU.

    python3 scripts/torch_port_profile_lap.py [--mode stereo|rgbd] [--runs 2] [--out-dir DIR]

Drives the lap of ``chip_smoke.py`` (same configuration, same rendered
frames) through the port on ``cuda``:

1. ``--runs`` plain laps, each timed per frame on the host clock with one
   ``cuda.synchronize`` a frame: median ms/frame with and without a keyframe
   insertion, tracked frames, metric RMSE, keyframes and map points.  Two
   or more runs show the run-to-run spread (``index_add_`` adds with
   atomics on the card, so local BA's sums differ in their last bits);
2. one more lap with ``torch.profiler`` over 16 frames from
   ``--profile-from`` (default 16; the stereo lap inserts keyframes at
   frames 1, 8, 14 and 37, so the default window holds none and a window
   from 30 holds one): device-busy ms
   per frame, kernel launches per frame, the ten operations with the most
   device time, and the device's idle share against the median unprofiled
   frame of the same kind;
3. peak device memory of the whole process.

Prints one JSON object last, and the card's name and power limit before it;
writes the operations by device time to ``<out-dir>/profile_<mode>_<from>.txt``
(default ``build/profile``, which git ignores).
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

PROFILE_FRAMES = 16


def run_lap(mode, cfg, frames, dev, profile_range=None):
    """One lap; returns (slam, per-frame ms, per-frame keyframe flag, profiler or None)."""
    import torch

    from orb_slam3_noted_tpu_torch.pipeline.system import RGBDSLAM, StereoSLAM

    if mode == "stereo":
        slam = StereoSLAM(cfg, device=dev)
    else:
        slam = RGBDSLAM(cfg, device=dev)
        slam.set_localization_mode(True)
    prof = None
    ms, is_kf = [], []
    for i, (left, right, depth) in enumerate(frames):
        if profile_range and i == profile_range[0]:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        before = slam.kf_inserted
        t0 = time.perf_counter()
        slam.process(left, right if mode == "stereo" else depth, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        is_kf.append(slam.kf_inserted > before)
        if profile_range and i == profile_range[1] - 1:
            prof.__exit__(None, None, None)
    return slam, np.asarray(ms), np.asarray(is_kf), prof


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("stereo", "rgbd"), default="stereo")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--profile-from", type=int, default=16)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    cfg = cs.lap_config()
    poses, frames = cs.lap_inputs(cs.N_FRAMES)
    n = len(frames)
    steady = np.arange(n) > 0

    laps = []
    for run in range(args.runs):
        slam, ms, kf, _ = run_lap(args.mode, cfg, frames, dev)
        _, rmse, tracked = cs.lap_errors(slam, poses)
        laps.append({
            "rmse_m": rmse, "tracked": tracked, "n_kf": slam.n_kf, "n_mp": slam.n_mp,
            "kf_frames": sorted(int(f) for f in slam.kf_frame_ids if f >= 0),
            "median_ms_no_kf": float(np.median(ms[steady & ~kf])),
            "median_ms_kf": float(np.median(ms[steady & kf])) if (steady & kf).any() else None,
        })
        print(f"[lap {run}] {laps[-1]}", flush=True)

    first, last = args.profile_from, args.profile_from + PROFILE_FRAMES
    slam, ms_p, kf_p, prof = run_lap(args.mode, cfg, frames, dev, (first, last))
    n_prof = PROFILE_FRAMES
    from torch.autograd import DeviceType

    keys = prof.key_averages()
    dev_us = lambda k: k.self_device_time_total
    # device rows are the kernels and copies themselves; host rows (aten::...)
    # carry the device time of what they launched, so each sum takes one kind
    on_device = [k for k in keys if k.device_type == DeviceType.CUDA]
    on_host = [k for k in keys if k.device_type != DeviceType.CUDA]
    busy_ms = sum(dev_us(k) for k in on_device) / 1e3
    launches = sum(k.count for k in on_host if k.key.startswith("cudaLaunchKernel"))
    top = sorted(on_host, key=dev_us, reverse=True)[:10]
    kf_in_window = int(kf_p[first:last].sum())
    # idle share against unprofiled frames: the profiler slows the host down
    plain_ms = float(np.mean([
        l["median_ms_no_kf"] * (n_prof - kf_in_window) / n_prof
        + (l["median_ms_kf"] or 0.0) * kf_in_window / n_prof for l in laps]))
    out = {
        "mode": args.mode, "card": smi, "laps": laps,
        "rmse_spread_m": float(np.ptp([l["rmse_m"] for l in laps])),
        "profile": {
            "frames": [first, last], "keyframe_insertions": kf_in_window,
            "device_busy_ms_per_frame": busy_ms / n_prof,
            "kernel_launches_per_frame": launches / n_prof,
            "device_kernels_per_frame": sum(k.count for k in on_device) / n_prof,
            "profiled_wall_ms_per_frame": float(ms_p[first:last].mean()),
            "unprofiled_ms_per_frame": plain_ms,
            "idle_share": 1.0 - (busy_ms / n_prof) / plain_ms,
            "top_device_ops": [[k.key[:60], dev_us(k) / 1e3 / n_prof] for k in top],
        },
        "peak_device_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
    }
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"profile_{args.mode}_{first}.txt"), "w") as f:
        f.write(f"{smi}\n{'operation':<70} {'calls':>8} {'device ms':>12}\n")
        for rows in (on_host, on_device):
            for k in sorted(rows, key=dev_us, reverse=True)[:40]:
                f.write(f"{k.key[:70]:<70} {k.count:>8} {dev_us(k) / 1e3:>12.3f}\n")
            f.write("\n")
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
