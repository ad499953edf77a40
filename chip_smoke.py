#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, ``sm_90a``).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: ``nvcc`` compiles ``orb_slam3_noted_tpu_torch/csrc/*.cu`` for
   ``sm_90a`` (time and ``ptxas -v`` output);
3. kernels: K1 FAST score, K2 7-tap blur and K3 rBRIEF sampling against
   their plain PyTorch versions on the card, at the 8 pyramid levels of a
   752x480 frame with the per-level keypoint counts of 1200 features; K1
   and K3 must agree exactly, K2 within ``K2_ATOL``; median times (CUDA
   events) of kernel and plain version;
4. the lap: ``RGBDSLAM`` in localisation mode on ``cuda`` over 48 frames of
   the stereo bench configuration, every kernel's launch count equal to
   8 x frames, tracked frames and metric RMSE against ground truth within
   the thresholds derived from the JAX package's run of the same lap
   (``tests/fixtures/rgbd_localization_lap.json``), and every frame's state
   and position within ``POS_TOL_M`` of that run;

then one JSON line of per-kernel results, the ``nvidia-smi`` line again,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with 1 before any of this.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "rgbd_localization_lap.json")

W, H = 752, 480
CAM_PARAMS = (458.654, 457.296, 367.215, 248.375)
BASELINE = 0.11
N_FRAMES = 48

K2_ATOL = 1e-4          # blur kernel vs plain; both round every tap the same way
POS_TOL_M = 0.005       # per-frame camera centre vs the JAX run
TRACKED_MARGIN = 2      # frames below the JAX run's tracked count
RMSE_FACTOR, RMSE_SLACK_M = 2.0, 0.002  # rmse <= 2 x JAX rmse + 2 mm

KERNEL_SOURCES = {
    "fast_score": ("orb_slam3_noted_tpu_torch/csrc/fast_score.cu",
                   "orb_slam3_noted_tpu/ops/pallas_kernels.py:55"),
    "gaussian_blur7": ("orb_slam3_noted_tpu_torch/csrc/gaussian_blur7.cu",
                       "orb_slam3_noted_tpu/ops/pallas_kernels.py:189"),
    "brief_sample": ("orb_slam3_noted_tpu_torch/csrc/brief_sample.cu",
                     "orb_slam3_noted_tpu/ops/pallas_kernels.py:292"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of per-call times (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def lap_config():
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE

    cam = Camera(PINHOLE, CAM_PARAMS)
    return SlamConfig(
        camera=cam, width=W, height=H, n_features=1200, n_levels=8,
        scale_factor=1.2, bf=BASELINE * cam.fx, th_depth=45.0,
        max_keyframes=64, max_map_points=16384,
        local_window=5, kf_max_interval=10, enable_loop_closing=False,
    )


def lap_inputs(n_frames: int):
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory

    room = BoxRoom(seed=0)
    poses = orbit_trajectory(n_frames, forward=0.03, yaw0=0.45)
    frames = []
    for Rwc, twc in poses:
        img, depth = room.render(Rwc, twc, CAM_PARAMS, W, H, return_depth=True)
        frames.append((img.astype(np.uint8), depth.astype(np.float32)))
    return poses, frames


def check_kernels(cfg, img_u8, dev) -> dict:
    """Each kernel against its plain version at the lap's level shapes."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import fast as fast_ops
    from orb_slam3_noted_tpu_torch.ops import image as image_ops
    from orb_slam3_noted_tpu_torch.ops import orb as O

    levels = image_ops.build_pyramid(
        torch.as_tensor(img_u8, dtype=torch.float32, device=dev), cfg.n_levels, cfg.scale_factor
    )
    budgets = fast_ops.level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    res = {n: {"max_abs_err": 0.0, "mismatches": 0, "ms": 0.0, "plain_ms": 0.0}
           for n in KERNEL_SOURCES}

    def add(name, err, mism, ms, plain_ms):
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["mismatches"] += mism
        r["ms"] += ms
        r["plain_ms"] += plain_ms

    for lvl, (lv, budget) in enumerate(zip(levels, budgets)):
        lv = lv.contiguous()
        score = ck.fast_score(lv)
        plain = ck.fast_score_plain(lv)
        add("fast_score", float((score - plain).abs().max()), int((score != plain).sum()),
            cuda_time_ms(lambda: ck.fast_score(lv)),
            cuda_time_ms(lambda: ck.fast_score_plain(lv)))

        blur = ck.gaussian_blur7(lv)
        bplain = ck.gaussian_blur7_plain(lv)
        add("gaussian_blur7", float((blur - bplain).abs().max()), int((blur != bplain).sum()),
            cuda_time_ms(lambda: ck.gaussian_blur7(lv)),
            cuda_time_ms(lambda: ck.gaussian_blur7_plain(lv)))

        kps = fast_ops.detect_level(score, n_out=budget, th_high=cfg.ini_th_fast,
                                    th_low=cfg.min_th_fast, border=16)
        ang = O.ic_angles(lv, kps.xy)
        gy, gx = O.brief_coords(lv.shape[-2], lv.shape[-1], kps.xy, ang)
        desc = ck.brief_sample(blur, gy, gx)
        dplain = ck.brief_sample_plain(blur, gy, gx)
        bits = lambda d: (d[..., None] >> torch.arange(32, device=dev, dtype=torch.int32)) & 1
        add("brief_sample", float((bits(desc) - bits(dplain)).abs().max()),
            int((desc != dplain).any(dim=-1).sum()),
            cuda_time_ms(lambda: ck.brief_sample(blur, gy, gx)),
            cuda_time_ms(lambda: ck.brief_sample_plain(blur, gy, gx)))
        log(f"  level {lvl}: {tuple(lv.shape)} K={budget}")
    torch.cuda.synchronize()
    for name, r in res.items():
        log(f"  {name:<15} mismatches {r['mismatches']:>6}  max_abs_err {r['max_abs_err']:.3g}"
            f"  kernel {r['ms']:.4f} ms/frame  plain {r['plain_ms']:.4f} ms/frame")
    if res["fast_score"]["mismatches"] or res["brief_sample"]["mismatches"]:
        raise AssertionError("K1/K3 must match their plain versions exactly")
    if res["gaussian_blur7"]["max_abs_err"] > K2_ATOL:
        raise AssertionError(f"K2 differs from its plain version by more than {K2_ATOL}")
    return res


def run_lap(cfg, frames, dev):
    import torch

    from orb_slam3_noted_tpu_torch.pipeline.system import RGBDSLAM

    slam = RGBDSLAM(cfg, device=dev)
    slam.set_localization_mode(True)
    ms = []
    for i, (img, depth) in enumerate(frames):
        t0 = time.perf_counter()
        slam.process(img, depth, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return slam, ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")

    t0 = time.perf_counter()
    so, build_log = ck.build_library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "Compiling entry" in line or "registers" in line:
            log(f"[build]   {line.strip()}")

    with open(FIXTURE) as f:
        ref = json.load(f)
    if ref["frames"] != N_FRAMES:
        raise AssertionError(f"fixture has {ref['frames']} frames, expected {N_FRAMES}")
    cfg = lap_config()
    t0 = time.perf_counter()
    poses, frames = lap_inputs(N_FRAMES)
    log(f"[lap] rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s")

    log("[kernels] kernel vs plain version on the card, lap frame 0 pyramid")
    kres = check_kernels(cfg, frames[0][0], dev)

    ck.reset_launch_counts()
    slam, ms = run_lap(cfg, frames, dev)
    launches = ck.launch_counts()

    states = [r.state for r in slam.trajectory]
    est = slam.positions()
    if est.shape != (N_FRAMES, 3) or not np.all(np.isfinite(est)):
        raise AssertionError(f"positions: shape {est.shape}, finite {np.isfinite(est).all()}")
    gt = np.asarray([t for _, t in poses])
    Rwc0, twc0 = poses[0]
    err = np.linalg.norm(est - (gt - twc0) @ Rwc0, axis=1)
    rmse = float(np.sqrt((err ** 2).mean()))
    tracked = sum(s == "OK" for s in states)
    pos_diff = np.linalg.norm(est - np.asarray(ref["positions"]), axis=1)
    state_diff = [i for i, (a, b) in enumerate(zip(states, ref["states"])) if a != b]
    for i in range(N_FRAMES):
        log(f"[lap] frame {i:2d} {states[i]:<8} inliers {slam.trajectory[i].n_inliers:4d} "
            f"(JAX {ref['n_inliers'][i]:4d})  {ms[i]:8.2f} ms  |dp| vs JAX {pos_diff[i]:.2e} m")
    log(f"[lap] tracked {tracked}/{N_FRAMES} (JAX {ref['tracked']}), rmse {rmse:.5f} m "
        f"(JAX {ref['rmse_m']:.5f}), max |dp| vs JAX {pos_diff.max():.3e} m, "
        f"median {np.median(ms[1:]):.2f} ms/frame after the initialisation frame")
    log(f"[lap] launches {launches}")

    want = 8 * N_FRAMES
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launch counts {launches}, expected {want} each")
    if tracked < ref["tracked"] - TRACKED_MARGIN:
        raise AssertionError(f"tracked {tracked} < {ref['tracked']} - {TRACKED_MARGIN}")
    rmse_max = RMSE_FACTOR * ref["rmse_m"] + RMSE_SLACK_M
    if rmse > rmse_max:
        raise AssertionError(f"rmse {rmse:.5f} m > {rmse_max:.5f} m")
    if state_diff:
        raise AssertionError(f"states differ from the JAX run at frames {state_diff}")
    if pos_diff.max() > POS_TOL_M:
        raise AssertionError(f"positions differ from the JAX run by {pos_diff.max():.4f} m")

    kernels = [
        {
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
            "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
            "plain_ms": kres[name]["plain_ms"],
        }
        for name in KERNEL_SOURCES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
