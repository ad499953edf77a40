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
   and K3 must agree exactly, K2 within ``K2_ATOL``.  K4 stereo SAD against
   its plain version on frame 0's pair: the atlases of both pyramids, the
   1200 left keypoints and their Hamming candidates, and again with those
   centres on atlases of uniform noise; within ``K4_ATOL`` and the same
   best shift for ``K4_ARGMIN_SHARE`` of the keypoints.  Median
   times (CUDA events) of kernel and plain version, the time of the one
   PyTorch library call that computes the same function where there is one
   (K2: reflect pad + two ``conv2d``), and each kernel's bound on this card
   from the bytes it must move and the operations it must do;
4. the RGB-D lap: ``RGBDSLAM`` in localisation mode on ``cuda`` over 48
   frames of the stereo bench configuration, launch counts 8 x frames for
   K1-K3 and 0 for K4, tracked frames and metric RMSE against ground truth
   within the thresholds derived from the JAX package's run of the same lap
   (``tests/fixtures/rgbd_localization_lap.json``), and every frame's state
   and position within ``POS_TOL_M`` of that run;
5. the stereo lap: ``StereoSLAM`` on ``cuda`` over the 48 rectified pairs
   of the same trajectory, full SLAM (keyframe insertion, local BA), launch
   counts 16 x frames for K1-K3 and 1 x frames for K4, and tracked frames,
   RMSE, keyframe count and the initial map's size within the thresholds
   derived from the JAX package's run
   (``tests/fixtures/stereo_slam_lap.json``);

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
STEREO_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "stereo_slam_lap.json")

W, H = 752, 480
CAM_PARAMS = (458.654, 457.296, 367.215, 248.375)
BASELINE = 0.11
N_FRAMES = 48

K2_ATOL = 1e-4          # blur kernel vs plain; both round every tap the same way
# SAD kernel vs plain: 121 float32 terms summed in another order, on sums
# of order 1e3-1e4 (one float32 ulp there is ~1e-3)
K4_ATOL = 1e-2
K4_ARGMIN_SHARE = 0.999  # keypoints whose best of the 11 shifts is the same
POS_TOL_M = 0.005       # per-frame camera centre vs the JAX run
TRACKED_MARGIN = 2      # frames below the JAX run's tracked count
RMSE_FACTOR, RMSE_SLACK_M = 2.0, 0.002  # rmse <= 2 x JAX rmse + 2 mm
KF_MARGIN, KF_MIN = 1, 3  # stereo lap: keyframes within +-1 of the JAX run's, at least 3
INIT_MAP_RTOL = 0.01      # stereo lap: frame 0's map size vs the JAX run's

# NVIDIA H100 SXM data sheet: device memory rate, float32 rate outside the
# tensor cores (every kernel here is float32 or integer arithmetic)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

KERNEL_SOURCES = {
    "fast_score": ("orb_slam3_noted_tpu_torch/csrc/fast_score.cu",
                   "orb_slam3_noted_tpu/ops/pallas_kernels.py:55"),
    "gaussian_blur7": ("orb_slam3_noted_tpu_torch/csrc/gaussian_blur7.cu",
                       "orb_slam3_noted_tpu/ops/pallas_kernels.py:189"),
    "brief_sample": ("orb_slam3_noted_tpu_torch/csrc/brief_sample.cu",
                     "orb_slam3_noted_tpu/ops/pallas_kernels.py:292"),
    "sad_stereo": ("orb_slam3_noted_tpu_torch/csrc/sad_stereo.cu",
                   "orb_slam3_noted_tpu/ops/pallas_kernels.py:448"),
}


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the float32 rate, and which of the two."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    """(poses, [(left uint8, right uint8, left depth float32)]): the RGB-D
    lap takes left and depth, the stereo lap left and right."""
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

    room = BoxRoom(seed=0)
    poses = orbit_trajectory(n_frames, forward=0.03, yaw0=0.45)
    frames = []
    for Rwc, twc in poses:
        left, right, depth = stereo_pair(room, Rwc, twc, CAM_PARAMS, W, H, BASELINE)
        frames.append((left.astype(np.uint8), right.astype(np.uint8), depth.astype(np.float32)))
    return poses, frames


def check_kernels(cfg, img_u8, dev) -> dict:
    """K1-K3 against their plain versions at the lap's level shapes; times
    and bounds are sums over the 8 levels (one image)."""
    import torch
    import torch.nn.functional as F

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import fast as fast_ops
    from orb_slam3_noted_tpu_torch.ops import image as image_ops
    from orb_slam3_noted_tpu_torch.ops import orb as O

    levels = image_ops.build_pyramid(
        torch.as_tensor(img_u8, dtype=torch.float32, device=dev), cfg.n_levels, cfg.scale_factor
    )
    budgets = fast_ops.level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    names = ("fast_score", "gaussian_blur7", "brief_sample")
    res = {n: {"max_abs_err": 0.0, "mismatches": 0, "ms": 0.0, "plain_ms": 0.0,
               "bytes": 0.0, "ops": 0.0, "library_ms": None} for n in names}
    res["gaussian_blur7"]["library_ms"] = 0.0

    def add(name, err, mism, ms, plain_ms, n_bytes, n_ops):
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["mismatches"] += mism
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bytes"] += n_bytes
        r["ops"] += n_ops

    taps = torch.from_numpy(image_ops.gaussian_kernel1d(7, ck.BLUR_SIGMA)).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the yardstick computes in float32 too

    def blur_library(x):
        y = F.pad(x[None, None], (3, 3, 3, 3), mode="reflect")
        return F.conv2d(F.conv2d(y, taps.view(1, 1, 1, 7)), taps.view(1, 1, 7, 1))[0, 0]

    for lvl, (lv, budget) in enumerate(zip(levels, budgets)):
        lv = lv.contiguous()
        px = lv.numel()
        score = ck.fast_score(lv)
        plain = ck.fast_score_plain(lv)
        # read + write one float per pixel; 16 ring differences, 2 x 16 arcs
        # of 8 min each, 2 x 15 max, 1 max
        add("fast_score", float((score - plain).abs().max()), int((score != plain).sum()),
            cuda_time_ms(lambda: ck.fast_score(lv)),
            cuda_time_ms(lambda: ck.fast_score_plain(lv)), 8 * px, (16 + 256 + 31) * px)

        blur = ck.gaussian_blur7(lv)
        bplain = ck.gaussian_blur7_plain(lv)
        lib = blur_library(lv)
        if float((lib - bplain).abs().max()) > 1e-3:
            raise AssertionError("the library blur computes another function")
        # read + write one float per pixel; two passes of 7 multiplies and 6 adds
        add("gaussian_blur7", float((blur - bplain).abs().max()), int((blur != bplain).sum()),
            cuda_time_ms(lambda: ck.gaussian_blur7(lv)),
            cuda_time_ms(lambda: ck.gaussian_blur7_plain(lv)), 8 * px, 26 * px)
        res["gaussian_blur7"]["library_ms"] += cuda_time_ms(lambda: blur_library(lv))

        kps = fast_ops.detect_level(score, n_out=budget, th_high=cfg.ini_th_fast,
                                    th_low=cfg.min_th_fast, border=16)
        ang = O.ic_angles(lv, kps.xy)
        gy, gx = O.brief_coords(lv.shape[-2], lv.shape[-1], kps.xy, ang)
        desc = ck.brief_sample(blur, gy, gx)
        dplain = ck.brief_sample_plain(blur, gy, gx)
        bits = lambda d: (d[..., None] >> torch.arange(32, device=dev, dtype=torch.int32)) & 1
        # per keypoint: 512 coordinate pairs read, the 512 samples they name
        # read, 8 words written; 256 comparisons
        add("brief_sample", float((bits(desc) - bits(dplain)).abs().max()),
            int((desc != dplain).any(dim=-1).sum()),
            cuda_time_ms(lambda: ck.brief_sample(blur, gy, gx)),
            cuda_time_ms(lambda: ck.brief_sample_plain(blur, gy, gx)),
            budget * (512 * 8 + 512 * 4 + 32), budget * 256)
        log(f"  level {lvl}: {tuple(lv.shape)} K={budget}")
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = tf32
    if res["fast_score"]["mismatches"] or res["brief_sample"]["mismatches"]:
        raise AssertionError("K1/K3 must match their plain versions exactly")
    if res["gaussian_blur7"]["max_abs_err"] > K2_ATOL:
        raise AssertionError(f"K2 differs from its plain version by more than {K2_ATOL}")
    return res


def check_sad(cfg, left_u8, right_u8, dev) -> dict:
    """K4 against its plain version at the stereo lap's shapes: frame 0's
    two pyramids as atlases, its 1200 left keypoints and the right
    candidates the Hamming gate gives them."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import image as image_ops
    from orb_slam3_noted_tpu_torch.ops import orb as O
    from orb_slam3_noted_tpu_torch.ops import stereo as S

    kw = dict(n_features=cfg.n_features, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
              th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast)
    pyrs, feats = [], []
    for img in (left_u8, right_u8):
        im = torch.as_tensor(img, dtype=torch.float32, device=dev)
        pyrs.append(tuple(image_ops.build_pyramid(im, cfg.n_levels, cfg.scale_factor)))
        feats.append(O.extract_from_pyramid(pyrs[-1], **kw))
    idx_r, have = S.hamming_candidates(feats[0], feats[1], cfg.bf, BASELINE,
                                       cfg.n_levels, cfg.scale_factor)
    cv, cu, cur, _ = S.level_centres(feats[0], feats[1], idx_r, pyrs[0])
    al, ar = S.build_atlas(pyrs[0]), S.build_atlas(pyrs[1])
    args = (al.image, ar.image, cv, cu, cur, feats[0].level.contiguous(), al.off, al.h, al.w)
    sads = ck.sad_stereo(*args)
    torch.cuda.synchronize()
    plain = ck.sad_stereo_plain(*args)
    K = cv.shape[0]
    use = have & feats[0].valid  # the rows whose SADs the matcher reads
    # the same centres on atlases of uniform noise: no two neighbouring
    # pixels alike, so every one of the 121 terms is a float of its own
    g = torch.Generator(device=dev).manual_seed(0)
    noise = [torch.rand(al.image.shape, generator=g, device=dev) * 255.0 for _ in range(2)]
    sads_n = ck.sad_stereo(*noise, *args[2:])
    plain_n = ck.sad_stereo_plain(*noise, *args[2:])
    err_lap, err_noise = float((sads - plain).abs().max()), float((sads_n - plain_n).abs().max())
    log(f"  sad_stereo: lap inputs max_abs_err {err_lap:.3g} ({int((sads != plain).sum())} of "
        f"{sads.numel()} sums differ), noise atlases max_abs_err {err_noise:.3g} "
        f"({int((sads_n != plain_n).sum())} differ, sums up to {float(plain_n.max()):.0f})")
    err = max(err_lap, err_noise)
    same = float((sads.argmin(1) == plain.argmin(1))[use].float().mean())
    # per keypoint: 121 + 231 gathered floats, 3 centres and a level read,
    # 11 sums written; 11 shifts x 121 x (subtract, abs, add)
    n_bytes = K * ((121 + 231) * 4 + 4 * 4 + 11 * 4)
    res = {
        "max_abs_err": err, "mismatches": int((sads.argmin(1) != plain.argmin(1))[use].sum()),
        "ms": cuda_time_ms(lambda: ck.sad_stereo(*args)),
        "plain_ms": cuda_time_ms(lambda: ck.sad_stereo_plain(*args)),
        "bytes": n_bytes, "ops": K * 11 * 121 * 3, "library_ms": None,
    }
    log(f"  sad_stereo: atlas {tuple(al.image.shape)}, K={K}, candidates {int(use.sum())}, "
        f"SAD range {float(plain[use].min()):.0f}..{float(plain[use].max()):.0f}, "
        f"same best shift {same:.5f}")
    if err > K4_ATOL:
        raise AssertionError(f"K4 differs from its plain version by {err} > {K4_ATOL}")
    if same < K4_ARGMIN_SHARE:
        raise AssertionError(f"K4 best shift agrees on {same:.5f} < {K4_ARGMIN_SHARE}")
    return res


def lap_errors(slam, poses):
    """(positions, metric RMSE against ground truth, tracked frames)."""
    n = len(poses)
    est = slam.positions()
    if est.shape != (n, 3) or not np.all(np.isfinite(est)):
        raise AssertionError(f"positions: shape {est.shape}, finite {np.isfinite(est).all()}")
    gt = np.asarray([t for _, t in poses])
    Rwc0, twc0 = poses[0]
    err = np.linalg.norm(est - (gt - twc0) @ Rwc0, axis=1)
    tracked = sum(r.state == "OK" for r in slam.trajectory)
    return est, float(np.sqrt((err ** 2).mean())), tracked


def check_common(tag, ref, launches, want, tracked, rmse):
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches}, expected {want}")
    if tracked < ref["tracked"] - TRACKED_MARGIN:
        raise AssertionError(f"{tag}: tracked {tracked} < {ref['tracked']} - {TRACKED_MARGIN}")
    rmse_max = RMSE_FACTOR * ref["rmse_m"] + RMSE_SLACK_M
    if rmse > rmse_max:
        raise AssertionError(f"{tag}: rmse {rmse:.5f} m > {rmse_max:.5f} m")


def run_rgbd_lap(cfg, poses, frames, ref, dev) -> dict:
    """``RGBDSLAM`` in localisation mode over the lap, held to the JAX run."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.system import RGBDSLAM

    n = len(frames)
    slam = RGBDSLAM(cfg, device=dev)
    slam.set_localization_mode(True)
    ms = []
    ck.reset_launch_counts()
    for i, (img, _, depth) in enumerate(frames):
        t0 = time.perf_counter()
        slam.process(img, depth, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = ck.launch_counts()

    states = [r.state for r in slam.trajectory]
    est, rmse, tracked = lap_errors(slam, poses)
    pos_diff = np.linalg.norm(est - np.asarray(ref["positions"]), axis=1)
    state_diff = [i for i, (a, b) in enumerate(zip(states, ref["states"])) if a != b]
    for i in range(n):
        log(f"[rgbd] frame {i:2d} {states[i]:<8} inliers {slam.trajectory[i].n_inliers:4d} "
            f"(JAX {ref['n_inliers'][i]:4d})  {ms[i]:8.2f} ms  |dp| vs JAX {pos_diff[i]:.2e} m")
    log(f"[rgbd] tracked {tracked}/{n} (JAX {ref['tracked']}), rmse {rmse:.5f} m "
        f"(JAX {ref['rmse_m']:.5f}), max |dp| vs JAX {pos_diff.max():.3e} m, "
        f"median {np.median(ms[1:]):.2f} ms/frame after the initialisation frame")
    log(f"[rgbd] launches {launches}")
    want = {"fast_score": 8 * n, "gaussian_blur7": 8 * n, "brief_sample": 8 * n, "sad_stereo": 0}
    check_common("rgbd lap", ref, launches, want, tracked, rmse)
    if state_diff:
        raise AssertionError(f"rgbd lap: states differ from the JAX run at frames {state_diff}")
    if pos_diff.max() > POS_TOL_M:
        raise AssertionError(f"rgbd lap: positions differ from the JAX run by {pos_diff.max():.4f} m")
    return launches


def run_stereo_lap(cfg, poses, frames, ref, dev) -> dict:
    """``StereoSLAM`` over the lap's rectified pairs, full SLAM, held to the
    JAX run's aggregates: with a mapper one flipped inlier decision moves a
    keyframe to another frame, so frames are not compared one by one."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.system import StereoSLAM

    n = len(frames)
    slam = StereoSLAM(cfg, device=dev)
    ms, is_kf, n_mp0 = [], [], 0
    ck.reset_launch_counts()
    for i, (left, right, _) in enumerate(frames):
        before = slam.kf_inserted
        t0 = time.perf_counter()
        slam.process(left, right, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        is_kf.append(slam.kf_inserted > before)
        if i == 0:
            n_mp0 = slam.n_mp
    launches = ck.launch_counts()

    est, rmse, tracked = lap_errors(slam, poses)
    pos_diff = np.linalg.norm(est - np.asarray(ref["positions"]), axis=1)
    kf_frames = sorted(int(f) for f in slam.kf_frame_ids if f >= 0)
    for i, rec in enumerate(slam.trajectory):
        log(f"[stereo] frame {i:2d} {rec.state:<8} inliers {rec.n_inliers:4d} "
            f"(JAX {ref['n_inliers'][i]:4d}) {'KF' if is_kf[i] else '  '} {ms[i]:8.2f} ms  "
            f"|dp| vs JAX {pos_diff[i]:.2e} m")
    ms = np.asarray(ms)
    kf = np.asarray(is_kf)
    steady = np.arange(n) > 0
    log(f"[stereo] tracked {tracked}/{n} (JAX {ref['tracked']}), rmse {rmse:.5f} m "
        f"(JAX {ref['rmse_m']:.5f}), keyframes {slam.n_kf} at {kf_frames} "
        f"(JAX {ref['n_kf']} at {ref['kf_frame_ids']}), map points {slam.n_mp} "
        f"(JAX {ref['n_mp']}), after frame 0 {n_mp0} (JAX {ref['n_mp_frame0']}), "
        f"max |dp| vs JAX {pos_diff.max():.3e} m")
    log(f"[stereo] median {np.median(ms[steady & ~kf]):.2f} ms/frame without a keyframe "
        f"insertion ({int((steady & ~kf).sum())} frames), "
        f"{np.median(ms[steady & kf]):.2f} ms/frame with one ({int((steady & kf).sum())} frames)")
    log(f"[stereo] launches {launches}")
    want = {"fast_score": 16 * n, "gaussian_blur7": 16 * n, "brief_sample": 16 * n,
            "sad_stereo": n}
    check_common("stereo lap", ref, launches, want, tracked, rmse)
    if abs(slam.n_kf - ref["n_kf"]) > KF_MARGIN or slam.n_kf < KF_MIN:
        raise AssertionError(f"stereo lap: {slam.n_kf} keyframes, JAX run {ref['n_kf']}")
    if abs(n_mp0 - ref["n_mp_frame0"]) > INIT_MAP_RTOL * ref["n_mp_frame0"]:
        raise AssertionError(f"stereo lap: initial map {n_mp0} points, JAX run {ref['n_mp_frame0']}")
    return launches


def load_fixture(path: str) -> dict:
    with open(path) as f:
        ref = json.load(f)
    if ref["frames"] != N_FRAMES:
        raise AssertionError(f"{path}: {ref['frames']} frames, expected {N_FRAMES}")
    return ref


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

    ref_rgbd, ref_stereo = load_fixture(FIXTURE), load_fixture(STEREO_FIXTURE)
    cfg = lap_config()
    t0 = time.perf_counter()
    poses, frames = lap_inputs(N_FRAMES)
    log(f"[lap] rendered {N_FRAMES} stereo pairs with depth in {time.perf_counter() - t0:.1f} s")

    log("[kernels] kernel vs plain version on the card, lap frame 0")
    kres = check_kernels(cfg, frames[0][0], dev)
    kres["sad_stereo"] = check_sad(cfg, frames[0][0], frames[0][1], dev)
    for r in kres.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"])
    for name, r in kres.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"  {name:<15} mismatches {r['mismatches']:>6}  max_abs_err {r['max_abs_err']:.3g}"
            f"  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library {lib}"
            f"  bound {r['bound_ms']:.5f} ms ({r['bound_by']})")

    launches_rgbd = run_rgbd_lap(cfg, poses, frames, ref_rgbd, dev)
    launches = run_stereo_lap(cfg, poses, frames, ref_stereo, dev)

    # `launches` are the stereo lap's (the path that runs all four kernels);
    # K1-K3 times are sums over one image's 8 levels
    kernels = [
        {
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
            "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
            "plain_ms": kres[name]["plain_ms"], "bound_ms": kres[name]["bound_ms"],
            "bound_by": kres[name]["bound_by"], "library_ms": kres[name]["library_ms"],
            "launches_rgbd_lap": launches_rgbd[name],
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
