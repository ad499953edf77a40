"""Dataset driver: the reference's ``Examples/`` mains as one CLI (port of
:mod:`orb_slam3_noted_tpu.cli`).

Reads the settings YAML, loads a EuRoC / TUM-VI / TUM RGB-D / KITTI
sequence, rectifies stereo pairs on the device when the settings carry
LEFT./RIGHT. blocks, feeds the SLAM facade frame by frame or in batches
(the IMU samples since the last frame with each, as the reference drivers
batch them), writes the trajectory in TUM / EuRoC / KITTI format and, with
``--eval``, the ATE against the sequence's ground truth.  The result, one
JSON object with the JAX CLI's keys, is the last line printed.

Usage::

    python -m orb_slam3_noted_tpu_torch.cli \\
        --dataset euroc --seq /data/MH_01_easy --settings EuRoC.yaml \\
        --mode stereo-inertial --out traj_tum.txt --eval \\
        --checkpoint-out map.npz

The state lives on ``--device`` (default ``cuda``; ``--device cpu`` runs
the kernels' plain versions).  Where the JAX CLI is at fault, this one
does what its flags document:

- an unreadable rectification block raises (the JAX CLI drops it and runs
  unrectified);
- ``fisheye-stereo --batch > 1`` goes to ``process_batch`` as in the JAX CLI,
  whose facade then runs the rectified batch hooks on the fisheye pairs;
  this one's runs the lapping-area matcher and keeps the second-camera rows;
- ``--eval`` over several ``--seq`` holds each frame to its own sequence's
  ground truth (the JAX CLI uses the last sequence's for every frame).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

MODES = ["mono", "stereo", "rgbd", "fisheye-stereo", "mono-inertial", "stereo-inertial",
         "fisheye-stereo-inertial"]
GT_MAX_DT = 0.02  # s: a frame's ground-truth sample (reference evaluation/associate.py)


def resolve_mode(cfg, mode):
    """Route the stereo modes to the fisheye facades when the settings
    carry a second camera (the reference switches on Camera.type and
    Camera2, ``Tracking::ParseCamParamFile``)."""
    if cfg.camera2 is not None:
        if mode == "stereo":
            return "fisheye-stereo"
        if mode == "stereo-inertial":
            return "fisheye-stereo-inertial"
    return mode


def build_system(cfg, mode, atlas=False, device=None):
    """The facade for ``mode``, or an Atlas over it (multi-session), with
    its state on ``device`` (the card unless named)."""
    from orb_slam3_noted_tpu_torch.pipeline.inertial_system import (
        FisheyeStereoInertialSLAM,
        MonoInertialSLAM,
        StereoInertialSLAM,
    )
    from orb_slam3_noted_tpu_torch.pipeline.system import (
        FisheyeStereoSLAM,
        MonoSLAM,
        RGBDSLAM,
        StereoSLAM,
    )

    device = torch.device("cuda" if device is None else device)
    cls = {
        "mono": MonoSLAM,
        "stereo": StereoSLAM,
        "rgbd": RGBDSLAM,
        "fisheye-stereo": FisheyeStereoSLAM,
        "mono-inertial": MonoInertialSLAM,
        "stereo-inertial": StereoInertialSLAM,
        "fisheye-stereo-inertial": FisheyeStereoInertialSLAM,
    }[mode]
    if atlas:
        # the multi-session driver (reference Examples/euroc_examples.sh:
        # MH01 to MH05 into one Atlas)
        if mode.endswith("inertial"):
            from orb_slam3_noted_tpu_torch.pipeline.inertial_atlas import InertialAtlasSLAM

            return InertialAtlasSLAM(cfg, base_cls=cls, device=device)
        from orb_slam3_noted_tpu_torch.pipeline.atlas import AtlasSLAM

        return AtlasSLAM(cfg, base_cls=cls, fix_scale=cfg.bf > 0, device=device)
    return cls(cfg, device=device)


def frame_batch(mode: str, batch: int, atlas: bool) -> int:
    """Frames per dispatch: ``batch``, but 1 where the JAX CLI forces one
    frame at a time (mono-inertial, RGB-D and the Atlas)."""
    batch = max(batch, 1)
    if mode in ("mono-inertial", "rgbd") or atlas:
        return 1
    return batch


def evaluate(slam, stamps, seq_of_frame, seqs, mono: bool):
    """ATE of the tracked frames: each frame against the nearest ground
    truth sample of its own sequence within ``GT_MAX_DT``, one alignment
    (Sim(3) for monocular modes, else SE(3)) over all of them.  Returns
    the result keys, or {} with fewer than 3 associated frames."""
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    pos_all = slam.positions()  # relative records follow BA refinements
    est, gt = [], []
    for k, r in enumerate(slam.trajectory):
        if r.state != "OK":
            continue
        f = min(r.frame_id, len(stamps) - 1)
        seq = seqs[seq_of_frame[f]]
        if seq.gt_pos is None:
            continue
        gt_t = np.asarray(seq.gt_t)
        gi = int(np.clip(np.searchsorted(gt_t, stamps[f]), 1, len(gt_t) - 1))
        if abs(gt_t[gi - 1] - stamps[f]) < abs(gt_t[gi] - stamps[f]):
            gi -= 1
        if abs(gt_t[gi] - stamps[f]) < GT_MAX_DT:
            est.append(pos_all[k])
            gt.append(np.asarray(seq.gt_pos)[gi])
    if len(est) < 3:
        return {}
    rmse, _, (_, _, s) = ate_rmse(np.stack(est), np.stack(gt), with_scale=mono)
    return {"ate_rmse_m": round(float(rmse), 4), "align_scale": round(float(s), 4),
            "eval_frames": len(est)}


class _Rec:
    __slots__ = ("timestamp", "Rcw", "tcw")

    def __init__(self, timestamp, Rcw, tcw):
        self.timestamp, self.Rcw, self.tcw = timestamp, Rcw, tcw


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["euroc", "tumvi", "kitti", "tum-rgbd"], default="euroc")
    p.add_argument("--seq", required=True, action="append",
                   help="sequence directory (repeat for multi-session)")
    p.add_argument("--settings", required=True, help="reference-format YAML")
    p.add_argument("--mode", default="stereo", choices=MODES)
    p.add_argument("--atlas", action="store_true",
                   help="multi-map Atlas driver (on with more than one --seq)")
    p.add_argument("--out", default="trajectory.txt")
    p.add_argument("--format", default="tum", choices=["tum", "euroc", "kitti"])
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--batch", type=int, default=1,
                   help="frames per dispatch (throughput mode; mono, stereo, fisheye-stereo "
                        "and the stereo-inertial modes)")
    p.add_argument("--eval", action="store_true",
                   help="evaluate ATE against the sequence ground truth")
    p.add_argument("--checkpoint-out", default=None)
    p.add_argument("--checkpoint-in", default=None)
    p.add_argument("--times", action="store_true",
                   help="print the port's spans by name (REGISTER_TIMES) and the saturation "
                        "counters")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append a JSONL metric record per dispatch (span and counter "
                        "deltas, saturation, map gauges)")
    p.add_argument("--device", default="cuda", help="torch device of the SLAM state")
    args = p.parse_args(argv)

    from orb_slam3_noted_tpu_torch.io import datasets as D
    from orb_slam3_noted_tpu_torch.io import trajectory as TRJ
    from orb_slam3_noted_tpu_torch.io.yaml_compat import load_settings, load_stereo_rectification
    from orb_slam3_noted_tpu_torch.utils.timing import (
        GLOBAL_TIMER,
        MetricsStream,
        StageTimer,
        print_saturation,
    )

    device = torch.device(args.device)
    if args.times or args.metrics:
        StageTimer.enabled = True  # the recorder: spans and counters from here on
    metrics = MetricsStream(args.metrics) if args.metrics else None

    cfg, _ = load_settings(args.settings)
    mode = resolve_mode(cfg, args.mode)
    stereo = mode in ("stereo", "stereo-inertial", "fisheye-stereo", "fisheye-stereo-inertial")
    rgbd = mode == "rgbd"
    inertial = mode.endswith("inertial")

    def load_seq(seq_dir):
        if args.dataset in ("euroc", "tumvi"):
            return D.load_euroc(seq_dir, stereo=stereo, with_imu=inertial)
        if args.dataset == "tum-rgbd":
            return D.load_tum_rgbd(seq_dir)
        return D.load_kitti(seq_dir, stereo=stereo)

    seqs = [load_seq(sd) for sd in args.seq]
    use_atlas = args.atlas or len(seqs) > 1

    # the LEFT./RIGHT. blocks apply to the rectified stereo modes (the
    # reference's example drivers); fisheye pairs run raw
    maps = None
    if mode in ("stereo", "stereo-inertial"):
        r = load_stereo_rectification(args.settings)
        if r:
            maps = [tuple(torch.from_numpy(m).to(device) for m in side)
                    for side in D.make_rectify_maps(r)]

    slam = build_system(cfg, mode, atlas=use_atlas, device=device)
    if args.checkpoint_in:
        from orb_slam3_noted_tpu_torch.io.checkpoint import load_map

        load_map(args.checkpoint_in, slam)
    batch = frame_batch(mode, args.batch, use_atlas)

    t_start = time.time()
    stamps, seq_of_frame = [], []   # per global frame id, across sequences
    n_total = 0
    budget = args.max_frames if args.max_frames > 0 else 10**9
    try:
        for si, seq in enumerate(seqs):
            n = min(len(seq), budget - n_total)
            if n <= 0:
                break
            off = n_total   # global frame id of this sequence's first frame
            seq_stamps = [float(t) for t in seq.timestamps[:n]]
            stamps.extend(seq_stamps)
            seq_of_frame.extend([si] * n)

            def read_frame(i):
                with GLOBAL_TIMER.stage("read"):
                    imgs = seq.read(i)
                if maps is None:
                    return imgs
                with GLOBAL_TIMER.stage("rectify", block=True):
                    return tuple(D.rectify(torch.from_numpy(im).to(device, torch.float32), m)
                                 for im, m in zip(imgs, maps))

            t_prev = None
            i = 0
            while i < n:
                j = min(i + batch, n)
                kw = {}
                if inertial and seq.imu is not None:
                    lo = t_prev if t_prev is not None else seq_stamps[i] - 1.0
                    chunk = seq.imu.between(lo, seq_stamps[j - 1])
                    kw = dict(acc=chunk.acc, gyr=chunk.gyr, imu_t=chunk.t)
                if batch == 1:
                    imgs = read_frame(i)
                    if kw:
                        kw["t"] = seq_stamps[i]
                    with GLOBAL_TIMER.stage("frame_total"):
                        if stereo or rgbd:
                            slam.process(imgs[0], imgs[1], off + i, **kw)
                        else:
                            slam.process(imgs, off + i, **kw)
                else:
                    frames = [read_frame(k) for k in range(i, j)]
                    if kw:
                        kw["ts"] = seq_stamps[i:j]
                    with GLOBAL_TIMER.stage("frame_total"):
                        slam.process_batch(frames, list(range(off + i, off + j)), **kw)
                t_prev = seq_stamps[j - 1]
                if metrics is not None:
                    metrics.emit("dispatch", seq_idx=si, frame=off + i, **metrics.gauges_for(slam))
                if (i // batch) % max(50 // batch, 1) == 0:
                    ok = slam.trajectory[-1].state if slam.trajectory else "-"
                    print(f"[seq{si} {i}/{n}] state={ok} kf={slam.n_kf} mp={slam.n_mp}",
                          file=sys.stderr)
                i = j
            n_total += n
            if si + 1 < len(seqs) and hasattr(slam, "on_sequence_end"):
                # multi-session boundary: the next sequence starts a fresh
                # map that merges on revisit
                slam.on_sequence_end()
    finally:
        for seq in seqs:
            seq.close()
    if hasattr(slam, "flush"):
        slam.flush()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t_start

    records = [_Rec(stamps[min(r.frame_id, len(stamps) - 1)], R, t)
               for r, (R, t) in zip(slam.trajectory, slam.final_poses())]
    saver = {"tum": TRJ.save_tum, "euroc": TRJ.save_euroc, "kitti": TRJ.save_kitti}[args.format]
    saver(args.out, records)

    result = {
        "frames": n_total, "wall_s": round(wall, 2),
        "fps": round(n_total / max(wall, 1e-9), 2),
        "keyframes": slam.n_kf, "map_points": slam.n_mp,
        "tracked": sum(1 for r in slam.trajectory if r.state == "OK"),
    }
    if args.eval:
        result.update(evaluate(slam, stamps, seq_of_frame, seqs, mode.startswith("mono")))

    if args.checkpoint_out:
        from orb_slam3_noted_tpu_torch.io.checkpoint import save_map

        save_map(args.checkpoint_out, slam)

    if args.times:
        GLOBAL_TIMER.print_stats(file=sys.stderr)
        print_saturation(file=sys.stderr)
    if metrics is not None:
        metrics.emit("final", **metrics.gauges_for(slam),
                     **{k: v for k, v in result.items() if not isinstance(v, dict)})
        metrics.close()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
