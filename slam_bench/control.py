"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision below the configuration's
float32, which the comparison has to judge not correct.

    python3 slam_bench/control.py --workload euroc_stereo.replay_b16 \\
        --seeds 11,12,13 [--frames 300] [--faults stale_pose,predicted_pose \\
        --seconds 30]

prints one JSON line per seed with each number the cell compares and its
limit.  Stereo cells: the reference front end in bfloat16 on the pairs a run
checks, against the float32 reference; the true poses of ``--frames``
window frames rounded to bfloat16, against the true poses.  The GBA cell:
the reference in float32 with TF32 matmuls, against the float64 reference.
With ``--faults``, each named fault of ``faults.py`` instead: a whole run
of the cell (a ``--seconds`` window) with the fault planted under its timed
path, one line per fault and seed.  Runs on the card at the cell's own
size; the tests in ``tests/`` run both on the CPU at a small one.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def stereo_readings(cell, seed: int, n_window: int, device) -> dict:
    import numpy as np
    import torch

    from slam_bench import checks
    from slam_bench.drivers import stereo
    from slam_bench.reference import frontend as RF
    from slam_bench.reference import poses as RP

    conf, traffic = cell.config, cell.traffic
    B = traffic.get("batch", 1)
    first = 1 + traffic["warm_frames"]
    n_frames = B * math.ceil((first + n_window + 1) / B) + 1
    left, right, Rwc, twc = stereo.make_inputs(conf, traffic, seed, n_frames, device)
    orb = conf["orb"]
    fx = conf["camera"]["params"][0]
    bf = conf["baseline_m"] * fx
    orb_parts, st_parts = [], []
    replay = traffic["mode"] == "replay"
    for k in stereo.sample_indices(seed, traffic["checked"], traffic["checked_span"]):
        f0 = first + k * B
        if f0 + B > n_frames:
            continue
        with torch.no_grad():
            if replay:
                imgs = torch.cat([left[f0:f0 + B], right[f0:f0 + B]])
                ref = RF.stereo_batch(imgs, orb, bf, fx)
                ctl = RF.stereo_batch(imgs, orb, bf, fx, torch.bfloat16)
            else:
                ref = RF.stereo_pair(left[f0], right[f0], orb, bf, fx)
                ctl = RF.stereo_pair(left[f0], right[f0], orb, bf, fx, torch.bfloat16)
        orb_parts.append(checks.orb_mismatch(ctl[0], ref[0]))
        st_parts.append(checks.stereo_mismatch(ctl[0], ctl[2], ref[0], ref[2]))
    ids = np.arange(first, first + n_window)
    Rt, tt = RP.true_tcw(Rwc[ids], twc[ids])
    Rm, tm = RP.in_first_camera(Rt, tt, Rwc[0], twc[0])
    ok = np.ones(len(ids), bool)
    lag = stereo.rpe_lag(conf, traffic)
    return {"orb_mismatch": checks.share(orb_parts), "stereo_mismatch": checks.share(st_parts),
            "rpe_deg": RP.rpe_deg(RP.bf16(Rm), Rt, ok, lag),
            "rpe_mm": RP.rpe_mm(RP.bf16(Rm), RP.bf16(tm), Rt, tt, ok, lag),
            "poses_missing": 0, "sequence_end_reached": 0}


def gba_readings(cell, seed: int, device) -> dict:
    import torch

    from slam_bench import scene
    from slam_bench.drivers import gba
    from slam_bench.reference import gba as RG

    params = cell.config["camera"]["params"]
    mp = gba.capacity_map(scene.seed_generator(seed, device), device, cell.traffic, params)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        R, t, X, _ = RG.global_ba(params, mp["pose_idx"], mp["point_idx"], mp["uv"],
                                  mp["pose_fixed"], mp["Rcw"], mp["tcw"], mp["points"],
                                  torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return gba.compare(mp, params, [(R, t, X)])


def readings(cell, seed: int, n_window: int, device) -> dict:
    if cell.traffic["driver"] == "gba":
        return gba_readings(cell, seed, device)
    return stereo_readings(cell, seed, n_window, device)


def fault_readings(cell, seed: int, seconds: float, fault: str, device) -> tuple:
    """(the numbers compared, the run's notes) of a run of ``cell`` with
    ``fault`` planted under its timed path."""
    import types

    from slam_bench import faults, harness

    patcher = faults.Patcher()
    faults.plant(patcher, cell, fault)
    try:
        args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0)
        out = harness.driver(cell).run(cell, args, harness.Spans(), device=device)
    finally:
        patcher.undo()
    notes = {k: out.notes[k] for k in ("frames", "keyframes") if k in out.notes}
    return out.compared, dict(notes, failed=out.failed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from slam_bench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in args.faults.split(",") if args.faults else [None]:
            line = {"workload": cell.name, "seed": seed}
            if fault is None:
                got = readings(cell, seed, args.frames, dev)
            else:
                got, line["notes"] = fault_readings(cell, seed, args.seconds, fault, dev)
                line["fault"] = fault
            ok, rows = harness.judge(got, cell.limits)
            line.update(correct=ok,
                        readings={n: {"value": v, "limit": lim} for n, v, lim in rows})
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
