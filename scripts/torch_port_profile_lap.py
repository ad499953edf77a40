"""Where the time of the port's smoke laps goes, on one NVIDIA GPU.

    python3 scripts/torch_port_profile_lap.py [--mode stereo|rgbd|mono|mono_reloc] [--runs 2]
                                              [--out-dir DIR] [--tree DIR]

Drives the lap of ``chip_smoke.py`` (same configuration, same rendered
frames) through the port on ``cuda``:

1. ``--runs`` plain laps, each timed per frame on the host clock with one
   ``cuda.synchronize`` a frame: median ms/frame with and without a keyframe
   insertion, tracked frames, metric RMSE, keyframes and map points.  Two
   or more runs show the run-to-run spread (none is expected: float
   segment sums take a fixed order, ``ops/segsum.py``);
2. one more lap with ``torch.profiler`` over 16 frames from
   ``--profile-from`` (default 16; the stereo lap inserts keyframes at
   frames 1, 8, 14 and 37, so the default window holds none and a window
   from 30 holds one): device-busy ms
   per frame, kernel launches per frame, the ten operations with the most
   device time, and the device's idle share against the median unprofiled
   frame of the same kind.  Kernel launches, host-to-device copies and
   host time per frame are also split by the facade's ranges -- ORB
   extraction, stereo matching, the rest (tracking and the mapper) --,
   extraction once more by the ranges inside it (``pyramid``,
   ``fast_select``, ``ic_angle``, ``describe``), and the hand-written
   kernels' own device time is listed by name;
3. peak device memory of the whole process.

``--mode mono`` drives ``chip_smoke.py``'s mono lap instead (``bench.py``'s
monocular configuration, 120 frames staged on the card,
``MonoSLAM.process_batch`` in batches of 16 from frame 0): ``--runs`` plain
laps (frames/s, tracked frames, Sim(3) ATE, keyframes), then one more lap
with ``torch.profiler`` over its first ``--profile-batches`` batches (default
2: the initialisation, the first tracking batch and the first keyframes;
a whole lap is millions of events), with kernel launches, host-to-device
copies and host ms split across the facade's stages (``initialize``,
``track_batch``, ``track_batch_feats``, ``insert_keyframe``,
``place_recognition`` -- each keyframe's BoW vector --, the rest), per
profiled window and per frame.

``--mode mono_reloc`` drives ``chip_smoke.py``'s kidnapped monocular lap
(``MonoSLAM.process`` frame by frame: 36 mapped frames, 3 blank ones, a
rolled revisit that relocalises), ``--runs`` plain laps (frames/s, the
frames relocalised), then one more lap with ``torch.profiler`` over the 10
frames from the last 3 mapped ones to the revisit's 4th, split as for
``mono`` with the ``relocalize`` and ``place_recognition`` stages (a
relocalisation attempt's matching, PnP and re-track; its BoW query and each
keyframe's BoW vector).

Prints one JSON object last, and the card's name and power limit before it;
writes the operations by device time to ``<out-dir>/profile_<mode>_<from>.txt``
(default ``build/profile``, which git ignores).  ``--tree DIR`` profiles the
port of another checkout (say the parent commit, unpacked with ``git
archive`` into git-ignored ``build/``) with this script and this lap, so two
trees can be compared inside one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROFILE_FRAMES = 16
RELOC_WINDOW = 10  # mono_reloc: 3 mapped frames, 3 blank ones, 4 of the revisit


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


def split_by_range(prof, ranges: tuple, n_frames: int) -> dict:
    """Per frame and per facade range (and ``rest`` for what lies outside
    them): kernel launches (``cudaLaunchKernel*`` calls), host-to-device
    copies (operations whose linked device record is a ``Memcpy HtoD``,
    listed by the chain of operations that issued them), both placed by the
    host time of the call, and the host time of the range itself."""
    from torch.autograd import DeviceType

    events = prof.events()
    spans = {r: sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.name == r and e.device_type == DeviceType.CPU) for r in ranges}

    def where(t):
        for r, ivs in spans.items():
            if any(a <= t <= b for a, b in ivs):
                return r
        return "rest"

    out = {r: {"launches": 0, "h2d_copies": 0, "h2d_from": {},
               "host_ms": sum(b - a for a, b in spans.get(r, ())) / 1e3 / n_frames}
           for r in (*ranges, "rest")}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("cudaLaunchKernel"):
            out[where(e.time_range.start)]["launches"] += 1
        elif (e.device_type == DeviceType.CPU
              and any(k.name.startswith("Memcpy HtoD") for k in e.kernels)):
            r = out[where(e.time_range.start)]
            r["h2d_copies"] += 1
            chain, up = [], e
            while up is not None and len(chain) < 4:
                chain.append(up.name)
                up = up.cpu_parent
            r["h2d_from"][" < ".join(chain)] = r["h2d_from"].get(" < ".join(chain), 0) + 1
    for r in out.values():
        r["launches"] /= n_frames
        r["h2d_copies"] /= n_frames
        r["h2d_from"] = {k: v / n_frames for k, v in r["h2d_from"].items()}
    return out


def profile_summary(prof, n_frames: int, wall_ms: float, skip: tuple) -> dict:
    """Device-busy ms, launches, kernels, idle share and the ten operations
    with the most device time, per frame, from a profile of ``n_frames``
    frames that took ``wall_ms`` unprofiled; ``skip``: the facade's ranges
    (the profiler mirrors them onto the device timeline)."""
    from torch.autograd import DeviceType

    keys = prof.key_averages()
    dev_us = lambda k: k.self_device_time_total
    on_device = [k for k in keys if k.device_type == DeviceType.CUDA and k.key not in skip]
    on_host = [k for k in keys if k.device_type != DeviceType.CUDA and k.key not in skip]
    busy_ms = sum(dev_us(k) for k in on_device) / 1e3
    return {
        "device_busy_ms_per_frame": busy_ms / n_frames,
        "kernel_launches_per_frame": sum(
            k.count for k in on_host if k.key.startswith("cudaLaunchKernel")) / n_frames,
        "device_kernels_per_frame": sum(k.count for k in on_device) / n_frames,
        "h2d_copies_per_frame": sum(
            k.count for k in on_device if k.key.startswith("Memcpy HtoD")) / n_frames,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "top_device_ops": [[k.key[:60], dev_us(k) / 1e3 / n_frames]
                           for k in sorted(on_host, key=dev_us, reverse=True)[:10]],
    }


def main_mono(args, cs, system) -> int:
    import torch

    from orb_slam3_noted_tpu_torch.ops.cuda_kernels import KERNELS, build_library
    from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    build_library()  # nvcc before the timed laps, not inside the first one
    poses, imgs = cs.mono_inputs()
    n = len(imgs)
    staged = torch.from_numpy(imgs).to(dev)
    frames = [staged[i] for i in range(n)]
    gt = np.asarray([t for _, t in poses])

    def lap(prof=None, window=0):
        """One lap; with ``prof``, profiled over its first ``window`` frames
        (returns their wall seconds too)."""
        slam = MonoSLAM(cs.mono_config(), device=dev)
        if prof is None:
            return slam, cs.drive_batches(slam, frames, list(range(n)), False), None
        prof.__enter__()
        wall_p = cs.drive_batches(slam, frames[:window], list(range(window)), False)
        prof.__exit__(None, None, None)
        wall = wall_p + cs.drive_batches(slam, frames[window:], list(range(window, n)), False)
        return slam, wall, wall_p

    laps = []
    for run in range(args.runs):
        slam, wall, _ = lap()
        states = [r.state for r in slam.trajectory]
        kf = sorted(int(f) for f in slam.kf_frame_ids if f >= 0)
        init = states.index("OK")
        use = [kf[0]] + list(range(init, n))
        laps.append({"fps": n / wall, "wall_s": wall, "tracked": states.count("OK"),
                     "init_frame": init, "ate_m": ate_rmse(slam.positions()[use], gt[use])[0],
                     "n_kf": slam.n_kf, "kf_frames": kf, "n_mp": slam.n_mp})
        print(f"[lap {run}] {laps[-1]}", flush=True)

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    window = args.profile_batches * cs.BATCH
    slam, _, wall_p = lap(prof, window)
    stages = system.STAGES
    inner = (system.EXTRACTION_RANGE, *system.EXTRACTION_PARTS)
    by_stage = split_by_range(prof, stages, window)
    # the rest's host time: the profiled window less the stages
    by_stage["rest"]["host_ms"] = wall_p * 1e3 / window - sum(
        r["host_ms"] for k, r in by_stage.items() if k != "rest")
    # the idle share against the same frames unprofiled (the plain laps'
    # share of their wall, by frames: the window holds the initialisation)
    plain_ms = float(np.mean([l["wall_s"] for l in laps])) * 1e3 * window / n
    summary = profile_summary(prof, window, plain_ms, stages + inner)
    names = "|".join(fn.__name__ + "_kernel" for fn in KERNELS)
    from torch.autograd import DeviceType

    hand = {}
    for k in prof.key_averages():
        m = re.search(names, k.key) if k.device_type == DeviceType.CUDA else None
        if m:
            hand[m.group(0)] = [k.count, k.self_device_time_total / 1e3]
    out = {
        "mode": "mono", "card": smi, "laps": laps, "frames": n, "batch": cs.BATCH,
        "profile": {
            "frames": [0, window], "profiled_wall_s": wall_p,
            **summary,
            "per_frame_by_stage": by_stage,
            "per_window_by_stage": {k: {f: (v * window if isinstance(v, float) else v)
                                        for f, v in r.items() if f != "h2d_from"}
                                    for k, r in by_stage.items()},
            "hand_kernels_launches_and_device_ms_per_window": hand,
        },
        "peak_device_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
    }
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "profile_mono.txt"), "w") as f:
        f.write(f"{smi}\nper frame by stage: {json.dumps(by_stage)}\n")
    print(smi)
    print(json.dumps(out))
    return 0


def main_reloc(args, cs, system) -> int:
    """``chip_smoke.py``'s kidnapped monocular lap, frame by frame: plain
    laps, then one under ``torch.profiler`` over ``RELOC_WINDOW`` frames
    from the last mapped ones through the blank frames to the first
    relocalisations, split by the facade's stages."""
    import torch

    from orb_slam3_noted_tpu_torch.ops.cuda_kernels import build_library
    from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM

    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    build_library()
    ref = cs.load_fixture(cs.RELOC_FIXTURE, cs.RELOC_FRAMES)
    _, frames = cs.reloc_inputs(ref)
    ids = [f for f, _ in frames]
    staged = torch.from_numpy(np.stack([img for _, img in frames])).to(dev)
    start = ids.index(ref["frame_ids"][ref["pose_index"].index(None)]) - 3
    window = range(start, start + RELOC_WINDOW)

    def lap(prof=None):
        slam = MonoSLAM(cs.mono_config(), device=dev)
        relocs, reloc = [], slam._try_relocalize

        def noted(feats, frame_id):
            out = reloc(feats, frame_id)
            if out is not None:
                relocs.append(int(frame_id))
            return out

        slam._try_relocalize = noted
        torch.cuda.synchronize()
        t0, t_win = time.perf_counter(), 0.0
        for i, fid in enumerate(ids):
            if prof is not None and i == window.start:
                prof.__enter__()
                t_win = time.perf_counter()
            slam.process(staged[i], fid)
            if prof is not None and i == window.stop - 1:
                torch.cuda.synchronize()
                t_win = time.perf_counter() - t_win
                prof.__exit__(None, None, None)
        torch.cuda.synchronize()
        return slam, time.perf_counter() - t0, t_win, relocs

    laps = []
    for run in range(args.runs):
        slam, wall, _, relocs = lap()
        laps.append({"fps": len(ids) / wall, "wall_s": wall, "relocalised": relocs,
                     "tracked": sum(r.state == "OK" for r in slam.trajectory), "n_kf": slam.n_kf})
        print(f"[lap {run}] {laps[-1]}", flush=True)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    _, _, wall_p, relocs = lap(prof)
    n = len(window)
    by_stage = split_by_range(prof, system.STAGES, n)
    by_stage["rest"]["host_ms"] = wall_p * 1e3 / n - sum(
        r["host_ms"] for k, r in by_stage.items() if k != "rest")
    plain_ms = float(np.mean([l["wall_s"] for l in laps])) * 1e3 * n / len(ids)
    out = {
        "mode": "mono_reloc", "card": smi, "laps": laps, "frames": len(ids),
        "profile": {"frames": [ids[window.start], ids[window.stop - 1]], "profiled_wall_s": wall_p,
                    "relocalised": relocs,
                    **profile_summary(prof, n, plain_ms,
                                      system.STAGES + (system.EXTRACTION_RANGE,
                                                       *system.EXTRACTION_PARTS)),
                    "per_window_by_stage": {k: {f: (v * n if isinstance(v, float) else v)
                                                for f, v in r.items() if f != "h2d_from"}
                                            for k, r in by_stage.items()}},
        "peak_device_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
    }
    print(smi)
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("stereo", "rgbd", "mono", "mono_reloc"), default="stereo")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--profile-from", type=int, default=16)
    ap.add_argument("--profile-batches", type=int, default=2, help="mono: batches profiled")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("--tree", default=None, help="checkout whose port is profiled (default: this one)")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    import chip_smoke as cs
    from orb_slam3_noted_tpu_torch.ops.cuda_kernels import KERNELS
    from orb_slam3_noted_tpu_torch.pipeline import system

    if args.mode == "mono":
        return main_mono(args, cs, system)
    if args.mode == "mono_reloc":
        return main_reloc(args, cs, system)
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
    # carry the device time of what they launched, so each sum takes one kind.
    # The facade's ranges are neither: the profiler mirrors them onto the
    # device timeline with the range's whole span as their "device time".
    ranges = (system.EXTRACTION_RANGE, system.STEREO_RANGE)
    parts = tuple(getattr(system, "EXTRACTION_PARTS", ()))  # the ranges inside extraction
    on_device = [k for k in keys if k.device_type == DeviceType.CUDA and k.key not in ranges + parts]
    on_host = [k for k in keys if k.device_type != DeviceType.CUDA and k.key not in ranges + parts]
    busy_ms = sum(dev_us(k) for k in on_device) / 1e3
    launches = sum(k.count for k in on_host if k.key.startswith("cudaLaunchKernel"))
    top = sorted(on_host, key=dev_us, reverse=True)[:10]
    by_range = split_by_range(prof, ranges, n_prof)
    by_part = split_by_range(prof, parts, n_prof)
    by_part.pop("rest")  # everything outside extraction, and its few calls between the parts
    h2d_rows = sum(k.count for k in on_device if k.key.startswith("Memcpy HtoD")) / n_prof
    # the rest's host time: the profiled frame less the ranges
    by_range["rest"]["host_ms"] = float(ms_p[first:last].mean()) - sum(
        r["host_ms"] for k, r in by_range.items() if k != "rest")
    names = "|".join(fn.__name__ + "_kernel" for fn in KERNELS)
    hand = {re.search(names, k.key).group(0): [k.count / n_prof, dev_us(k) / 1e3 / n_prof]
            for k in on_device if re.search(names, k.key)}
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
            "per_frame_by_range": by_range,
            "extraction_per_frame_by_part": by_part,
            "h2d_copies_per_frame": h2d_rows,
            "hand_kernels_launches_and_device_ms_per_frame": hand,
        },
        "peak_device_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
    }
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"profile_{args.mode}_{first}.txt"), "w") as f:
        f.write(f"{smi}\nper frame by range: {json.dumps(by_range)}\n"
                f"extraction per frame by part: {json.dumps(by_part)}\n"
                f"hand-written kernels (launches, device ms per frame): {json.dumps(hand)}\n"
                f"{'operation':<70} {'calls':>8} {'device ms':>12}\n")
        for rows in (on_host, on_device):
            for k in sorted(rows, key=dev_us, reverse=True)[:40]:
                f.write(f"{k.key[:70]:<70} {k.count:>8} {dev_us(k) / 1e3:>12.3f}\n")
            f.write("\n")
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
