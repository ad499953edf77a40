#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, ``sm_90a``).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: ``nvcc`` compiles ``orb_slam3_noted_tpu_torch/csrc/*.cu`` for
   ``sm_90a`` (time and ``ptxas -v`` output);
3. kernels against their plain PyTorch versions on the card, on lap frame
   0's pair: K1 FAST corner candidates, K2 7-tap blur and K3 rBRIEF, one
   launch each over the pyramid atlas of a 752x480 frame (8 levels, 1,182
   cells, the 1200 detected keypoints), for one image (B = 1) and the
   stacked pair (B = 2), plus their single-level forms (K1's is the dense
   score map of each level); K1 and K3 must agree exactly, K2 within
   ``K2_ATOL``.  K4 stereo SAD on the atlases of both pyramids, the 1200
   left keypoints and their Hamming candidates, and again with those
   centres on atlases of uniform noise; within ``K4_ATOL`` and the same
   best shift for ``K4_ARGMIN_SHARE`` of the keypoints.  Every kernel gets
   three times: its device time (the kernel's own duration from
   ``torch.profiler``; this is ``ms``), its per-call time (CUDA events
   around one wrapper call: the host path with the device waiting) and its
   host enqueue time; the plain version and the one PyTorch library call
   that computes the same function where there is one (K2: reflect pad +
   two ``conv2d`` per level) get device and per-call times; each kernel's
   bound on this card follows from the bytes it must move and the
   operations it must do, and stands beside ``launch_floor_ms``, the device
   time of an empty kernel timed the same way (the least any launch lasts);
4. the RGB-D lap: ``RGBDSLAM`` in localisation mode on ``cuda`` over 48
   frames of the stereo bench configuration, launch counts per frame 1 for
   K1, K2 and K3, 0 for K4, tracked frames and metric RMSE against
   ground truth
   within the thresholds derived from the JAX package's run of the same lap
   (``tests/fixtures/rgbd_localization_lap.json``), and every frame's state
   and position within ``POS_TOL_M`` of that run;
5. the stereo lap: ``StereoSLAM`` on ``cuda`` over the 48 rectified pairs
   of the same trajectory, full SLAM (keyframe insertion, local BA), launch
   counts per frame 1 for each of K1 to K4 (the pair is one batch of two), and tracked frames,
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
    "fast_candidates": ("orb_slam3_noted_tpu_torch/csrc/fast_score.cu",
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


def device_time_ms(fn, match: str | None = None, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the durations of the kernels it
    launches, as ``torch.profiler`` records them on the card, summed over
    ``reps`` calls and divided by ``reps``.  With ``match`` only the kernels
    whose name contains it count (a hand-written kernel's own body)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [k for k in prof.key_averages() if k.device_type == DeviceType.CUDA
            and (match is None or match in k.key)]
    if not rows:
        raise AssertionError(f"the profiler saw no device kernel matching {match!r}")
    return sum(k.self_device_time_total for k in rows) / 1e3 / reps


def host_time_ms(fn, reps: int = 200) -> float:
    """Host time of one call of ``fn``: the host clock over ``reps`` calls
    that only enqueue (no synchronise inside the loop), divided by ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


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


def kernel_times(fn, name: str) -> dict:
    """Times of one wrapper call in ms: ``ms`` the kernel's own duration on
    the device, ``per_call_ms`` CUDA events around one call (the wrapper's
    host path with the device waiting), ``host_ms`` the enqueue alone."""
    return {"ms": device_time_ms(fn, name + "_kernel"), "per_call_ms": cuda_time_ms(fn),
            "host_ms": host_time_ms(fn)}


def reference_times(fn, prefix: str) -> dict:
    """Device time (all the kernels the call launches) and per-call time of
    a plain version or a library call."""
    return {f"{prefix}_ms": device_time_ms(fn), f"{prefix}_per_call_ms": cuda_time_ms(fn)}


def extraction_args(cfg) -> dict:
    return dict(n_features=cfg.n_features, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
                th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast)


def pair_atlas(cfg, left_u8, right_u8, dev):
    """(pyramid, atlas) of the stacked pair, as the stereo facade builds them."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import image as image_ops

    im = torch.as_tensor(np.stack([left_u8, right_u8]), dtype=torch.float32).to(dev)
    pyr = tuple(image_ops.build_pyramid(im, cfg.n_levels, cfg.scale_factor))
    return pyr, image_ops.build_atlas(pyr)


def compass_pass_count(levels, th_low: float, border: int) -> int:
    """Pixels of the scored area (the kept area and one pixel around it) of
    these levels whose FAST score can exceed ``th_low``: two neighbouring
    compass points of the ring both brighter than the centre by more than
    ``th_low``, or both darker.  K1 takes the full score of these alone."""
    import torch

    n = 0
    for lv in levels:
        h, w = lv.shape
        d = [torch.roll(lv, (-dy, -dx), (0, 1)) - lv for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
        ok = torch.zeros_like(lv, dtype=torch.bool)
        for side in ([x > th_low for x in d], [x < -th_low for x in d]):
            for a in range(4):
                ok |= side[a] & side[(a + 1) % 4]
        n += int(ok[border - 1:h - border + 1, border - 1:w - border + 1].sum())
    return n


def check_launch_floor(dev) -> float:
    """Device time of the empty kernel, timed as every kernel here is."""
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck

    return device_time_ms(lambda: ck.launch_floor(dev), "launch_floor_kernel")


def check_kernels(cfg, left_u8, right_u8, dev) -> dict:
    """K1-K3 against their plain versions at the lap's shapes, each one
    launch over the pyramid atlas: the main numbers are for one image
    (B = 1, the RGB-D lap's shape), the ``*_pair`` ones for the stacked
    stereo pair (B = 2); the single-level forms are checked too."""
    import torch
    import torch.nn.functional as F

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import fast as fast_ops
    from orb_slam3_noted_tpu_torch.ops import image as image_ops
    from orb_slam3_noted_tpu_torch.ops import orb as O

    kw = extraction_args(cfg)
    pyr, pair = pair_atlas(cfg, left_u8, right_u8, dev)
    one = pair._replace(image=pair.image[0])
    pyrs = [tuple(lv[b].contiguous() for lv in pyr) for b in range(2)]
    det_pair = O.detect_from_atlas(pair, **kw)
    dets = [O.Detections(*(f[b] for f in det_pair)) for b in range(2)]
    sizes = one.sizes
    px = sum(h * w for h, w in sizes)
    K = dets[0].xy.shape[0]
    log(f"  atlas {tuple(one.image.shape)}, levels {sizes}, {K} keypoints an image")
    res = {}

    # --- K1 over the atlas, and its dense single-level form --------------------
    budgets = tuple(fast_ops.level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor))
    th, border = (cfg.ini_th_fast, cfg.min_th_fast), 16
    lay = ck.candidate_layout(sizes, budgets)

    def cand_diff(image):
        (s, i), (ps, pi) = (ck.fast_candidates(image, sizes, budgets, *th, border),
                            ck.fast_candidates_plain(image, sizes, budgets, *th, border))
        torch.cuda.synchronize()
        filled = ps > fast_ops.NEG / 2
        return (float((s - ps).abs().max()), int((s != ps).sum()) + int(((i != pi) & filled).sum()),
                int((i != pi).sum()), int(filled.sum()))

    err, mism, idx_all, n_cand = cand_diff(one.image)
    err2, mism2, idx_all2, n_cand2 = cand_diff(pair.image)
    dense = [(ck.fast_score(lv), ck.fast_score_plain(lv)) for lv in pyrs[0]]
    mism1 = sum(int((a != b).sum()) for a, b in dense)
    log(f"  fast_candidates: {lay.n_cells} cells x {lay.k_max} slots (k per level {lay.k}); B=1 "
        f"{mism} of {n_cand} candidates differ ({idx_all} indices over all slots), B=2 {mism2} of "
        f"{n_cand2} ({idx_all2}); dense score map, 8 levels: {mism1} of {px} pixels differ")

    def replaced():  # the per-level route this launch replaces: K1 dense + selection's first half
        return [fast_ops.cell_candidates(ck.fast_score(lv), n, ck.CELL, *th, border)
                for lv, n in zip(pyrs[0], budgets)]

    scored = sum((h - 2 * border + 2) * (w - 2 * border + 2) for h, w in sizes)
    n_full = compass_pass_count(pyrs[0], th[1], border)
    log(f"  fast_candidates: {n_full} of {scored} scored pixels pass the compass test and get "
        f"the full score")
    r = {"max_abs_err": max(err, err2), "mismatches": mism + mism2 + mism1,
         **kernel_times(lambda: ck.fast_candidates(one.image, sizes, budgets, *th, border),
                        "fast_candidates"),
         **reference_times(
             lambda: ck.fast_candidates_plain(one.image, sizes, budgets, *th, border), "plain"),
         **reference_times(replaced, "replaced"),
         "dense_ms": sum(device_time_ms(lambda: ck.fast_score(lv), "fast_score_kernel")
                         for lv in pyrs[0]),
         "library_ms": None,
         # every level pixel read once, scores and indices written; per scored
         # pixel (the kept area and one pixel around it) the compass test (4
         # differences, 8 comparisons, 15 logical operations) and the peak
         # test's 8 maxima and 3 comparisons; per pixel of this frame that
         # passes the compass test the other 12 ring differences, 4 x 16
         # minima and as many maxima, 2 x 15 + 1 to reduce them
         "bytes": 4 * px + 8 * lay.n_cells * lay.k_max,
         "ops": (27 + 11) * scored + (12 + 128 + 31) * n_full}
    r.update({k + "_pair": v for k, v in kernel_times(
        lambda: ck.fast_candidates(pair.image, sizes, budgets, *th, border),
        "fast_candidates").items()})
    res["fast_candidates"] = r

    # --- K2 over the atlas ---------------------------------------------------
    def blur_diff(out, ref):
        """Over the level windows (the padding is unwritten on the card)."""
        pairs = list(zip(image_ops.level_views(out, sizes), image_ops.level_views(ref, sizes)))
        return (max(float((a - b).abs().max()) for a, b in pairs),
                sum(int((a != b).sum()) for a, b in pairs))

    taps = torch.from_numpy(image_ops.gaussian_kernel1d(7, ck.BLUR_SIGMA)).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the yardstick computes in float32 too

    def blur_library(x):
        y = F.pad(x[None, None], (3, 3, 3, 3), mode="reflect")
        return F.conv2d(F.conv2d(y, taps.view(1, 1, 1, 7)), taps.view(1, 1, 7, 1))[0, 0]

    def blur_library_all():
        return [blur_library(lv) for lv in pyrs[0]]

    plain_one = ck.gaussian_blur7_plain(one.image, sizes)
    for lib, ref in zip(blur_library_all(), image_ops.level_views(plain_one, sizes)):
        if float((lib - ref).abs().max()) > 1e-3:
            raise AssertionError("the library blur computes another function")
    err, mism = blur_diff(ck.gaussian_blur7(one.image, sizes), plain_one)
    err2, mism2 = blur_diff(ck.gaussian_blur7(pair.image, sizes),
                            ck.gaussian_blur7_plain(pair.image, sizes))
    lv0 = pyrs[0][0]
    single = ck.gaussian_blur7(lv0)
    err1 = float((single - ck.gaussian_blur7_plain(lv0)).abs().max())
    log(f"  gaussian_blur7: atlas B=1 max_abs_err {err:.3g} ({mism} differ), B=2 {err2:.3g} "
        f"({mism2} differ), single level {tuple(lv0.shape)} {err1:.3g}")
    r = {"max_abs_err": max(err, err2, err1), "mismatches": mism + mism2 + int(err1 != 0),
         **kernel_times(lambda: ck.gaussian_blur7(one.image, sizes), "gaussian_blur7"),
         **reference_times(lambda: ck.gaussian_blur7_plain(one.image, sizes), "plain"),
         **reference_times(blur_library_all, "library"),
         # read + write one float per level pixel; two passes of 7 multiplies and 6 adds
         "bytes": 8 * px, "ops": 26 * px}
    r.update({k + "_pair": v for k, v in
              kernel_times(lambda: ck.gaussian_blur7(pair.image, sizes), "gaussian_blur7").items()})
    torch.backends.cudnn.allow_tf32 = tf32
    res["gaussian_blur7"] = r

    # --- K3 over the blurred atlas ------------------------------------------
    def brief_args(atlas, det):
        blur = ck.gaussian_blur7_plain(atlas.image, sizes)
        return blur, sizes, det.xy.to(torch.int32), det.angle, det.level

    def brief_diff(args):
        out = ck.brief_sample(*args)
        torch.cuda.synchronize()
        ref = ck.brief_sample_atlas_plain(*args)
        bits = lambda d: (d[..., None] >> torch.arange(32, device=dev, dtype=torch.int32)) & 1
        return float((bits(out) - bits(ref)).abs().max()), int((out != ref).any(dim=-1).sum())

    args_one, args_pair = brief_args(one, dets[0]), brief_args(pair, det_pair)
    err, mism = brief_diff(args_one)
    err2, mism2 = brief_diff(args_pair)
    # the single-level form on level 0: its keypoints are the first ones
    k0 = int((dets[0].level == 0).sum())
    blur0 = ck.gaussian_blur7(lv0)
    d0 = O.brief_descriptors(blur0, dets[0].xy[:k0], dets[0].angle[:k0])
    gy, gx = O.brief_coords(lv0.shape[0], lv0.shape[1], dets[0].xy[:k0], dets[0].angle[:k0])
    mism1 = int((d0 != ck.brief_sample_plain(blur0, gy, gx)).any(dim=-1).sum())
    log(f"  brief_sample: atlas B=1 {mism} of {K} descriptors differ, B=2 {mism2} of {2 * K}, "
        f"single level {mism1} of {k0}")
    r = {"max_abs_err": max(err, err2), "mismatches": mism + mism2 + mism1,
         **kernel_times(lambda: ck.brief_sample(*args_one), "brief_sample"),
         **reference_times(lambda: ck.brief_sample_atlas_plain(*args_one), "plain"),
         "library_ms": None,
         # per keypoint: the 512 samples read, its coordinates, angle and
         # level read, 8 words written; 512 rotations (4 multiplies, 2 sums,
         # 2 roundings each) and 256 comparisons
         "bytes": K * (512 * 4 + 16 + 32), "ops": K * (512 * 8 + 256)}
    r.update({k + "_pair": v for k, v in
              kernel_times(lambda: ck.brief_sample(*args_pair), "brief_sample").items()})
    res["brief_sample"] = r

    torch.cuda.synchronize()
    if res["fast_candidates"]["mismatches"] or res["brief_sample"]["mismatches"]:
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
    from orb_slam3_noted_tpu_torch.ops import orb as O
    from orb_slam3_noted_tpu_torch.ops import stereo as S

    pyr, pair = pair_atlas(cfg, left_u8, right_u8, dev)
    both = O.extract_from_atlas(pair, **extraction_args(cfg))
    feats = [O.FrameFeatures(*(f[b] for f in both)) for b in range(2)]
    idx_r, have = S.hamming_candidates(feats[0], feats[1], cfg.bf, BASELINE,
                                       cfg.n_levels, cfg.scale_factor)
    cv, cu, cur, _ = S.level_centres(feats[0], feats[1], idx_r, tuple(p[0] for p in pyr))
    al, ar = (pair._replace(image=pair.image[b]) for b in range(2))
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
        **kernel_times(lambda: ck.sad_stereo(*args), "sad_stereo"),
        **reference_times(lambda: ck.sad_stereo_plain(*args), "plain"),
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
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": 0,
            "fast_score": 0}
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
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": n,
            "fast_score": 0}
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
    floor = check_launch_floor(dev)
    log(f"  launch floor: an empty kernel lasts {floor:.5f} ms on the device")
    kres = check_kernels(cfg, frames[0][0], frames[0][1], dev)
    kres["sad_stereo"] = check_sad(cfg, frames[0][0], frames[0][1], dev)
    for r in kres.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"])
        # each kernel is one launch: it cannot end sooner than an empty one
        r["launch_floor_ms"] = floor
        r["bound_or_launch_floor_ms"] = max(r["bound_ms"], floor)
    ms = lambda v: "none" if v is None else f"{v:.4f}"
    log("  times in ms: device (the kernels' own durations, torch.profiler) / per call "
        "(CUDA events around one call); K1-K3 one image's atlas")
    for name, r in kres.items():
        log(f"  {name:<15} mismatches {r['mismatches']:>4}  max_abs_err {r['max_abs_err']:.3g}  "
            f"kernel {ms(r['ms'])} / {ms(r['per_call_ms'])} (host {ms(r['host_ms'])})  "
            f"plain {ms(r['plain_ms'])} / {ms(r['plain_per_call_ms'])}  "
            f"library {ms(r['library_ms'])} / {ms(r.get('library_per_call_ms'))}  "
            f"bound {r['bound_ms']:.5f} ({r['bound_by']}), with the launch floor "
            f"{r['bound_or_launch_floor_ms']:.5f}")
        if "replaced_ms" in r:
            log(f"  {'':<15} the 8 dense launches and 8 PyTorch cell_candidates it replaces: "
                f"{ms(r['replaced_ms'])} / {ms(r['replaced_per_call_ms'])}, of which the dense "
                f"kernel {ms(r['dense_ms'])}")
        if "ms_pair" in r:
            log(f"  {'':<15} stereo pair (B=2): kernel {ms(r['ms_pair'])} / "
                f"{ms(r['per_call_ms_pair'])} (host {ms(r['host_ms_pair'])})")

    launches_rgbd = run_rgbd_lap(cfg, poses, frames, ref_rgbd, dev)
    launches = run_stereo_lap(cfg, poses, frames, ref_stereo, dev)

    # `launches` are the stereo lap's (the path that runs all four kernels).
    # `ms`, `plain_ms` and `library_ms` are device times; every other time
    # the kernel phase measured rides along under its own key.
    timed = lambda r: {k: v for k, v in r.items()
                       if k.endswith("_ms") or "ms_" in k or k in ("ms", "bound_by", "max_abs_err")}
    kernels = [
        {
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
            "launches_rgbd_lap": launches_rgbd[name], **timed(kres[name]),
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
