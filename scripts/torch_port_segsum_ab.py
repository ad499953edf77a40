"""Time the port's float segment sums two ways on one NVIDIA GPU: the
fixed-order sums of ``ops/segsum.py`` (rows sorted by segment once,
``torch.segment_reduce``) against the ``index_add_`` they replaced.

    python3 scripts/torch_port_segsum_ab.py [--order index_add,segment,segment,index_add]

Drives three laps of ``chip_smoke.py`` with loop closing off, once per entry
of ``--order``, all in one process on one card: the mono lap (120 frames,
``MonoSLAM.process_batch`` in batches of 16), the stereo batch lap (48
pairs, ``process`` until initialised, then batches of 16) and the kidnapped
mono lap (79 frames, ``MonoSLAM.process`` frame by frame), after one
warm-up pass of each.  ``index_add``
puts the old sums back where the laps use them (local BA's landmark side,
``map_state.update_point_stats``) for that run only.  Per lap and variant:
frames/s (host clock, the card synchronised at the end), keyframe
insertions, tracked frames and the median and total ms of the
``insert_keyframe`` stage (``tracking.insert_keyframe_step``: triangulation
and local BA, timed with the card synchronised before and after).  Prints
the card's name and power limit, then one JSON object.
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

# the modules whose float segment sums the three laps run
SUM_USERS = ("orb_slam3_noted_tpu_torch.optim.window_ba",
             "orb_slam3_noted_tpu_torch.pipeline.map_state")


def index_add_sum(data, seg, num_segments, order=None):
    """The parent's ``segment_sum``: one ``index_add_`` (atomics on the card)."""
    import torch

    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, seg.long(), data)


def use_sums(variant: str) -> None:
    import importlib

    from orb_slam3_noted_tpu_torch.ops import segsum

    for name in SUM_USERS:
        mod = importlib.import_module(name)
        if variant == "index_add":
            mod.segment_sum, mod.segment_order = index_add_sum, lambda *a, **k: None
        else:
            mod.segment_sum, mod.segment_order = segsum.segment_sum, segsum.segment_order


def timed_insertions(ms: list):
    """Wrap ``tracking.insert_keyframe_step`` so each call appends its ms
    (card synchronised before and after) to ``ms``; returns the undo."""
    import torch

    from orb_slam3_noted_tpu_torch.pipeline import tracking as T

    step = T.insert_keyframe_step

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*a, **k)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    T.insert_keyframe_step = timed
    return lambda: setattr(T, "insert_keyframe_step", step)


def run(lap: str, inputs: dict, dev) -> dict:
    import torch

    import chip_smoke as cs
    from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM, StereoSLAM

    ms: list = []
    undo = timed_insertions(ms)
    try:
        if lap == "mono":
            frames = inputs["mono"]
            slam = MonoSLAM(cs.mono_config(), device=dev)
            wall = cs.drive_batches(slam, frames, list(range(len(frames))), False)
        elif lap == "stereo_batch":
            frames = inputs["stereo"]
            slam = StereoSLAM(cs.lap_config(), device=dev)
            wall = cs.drive_batches(slam, frames, list(range(len(frames))), True)
        else:
            frames = inputs["reloc"]
            slam = MonoSLAM(cs.mono_config(), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for fid, img in frames:
                slam.process(img, fid)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        undo()
    return {"fps": len(frames) / wall, "kf_inserted": len(ms),
            "tracked": sum(r.state == "OK" for r in slam.trajectory),
            "insert_ms_median": float(np.median(ms)) if ms else None,
            "insert_ms_total": float(np.sum(ms))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", default="index_add,segment,segment,index_add")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    _, mono = cs.mono_inputs()
    _, stereo = cs.lap_inputs(cs.N_FRAMES)
    _, reloc = cs.reloc_inputs(cs.load_fixture(cs.RELOC_FIXTURE, cs.RELOC_FRAMES))
    staged = torch.from_numpy(mono).to(dev)
    pairs = torch.from_numpy(np.stack([f[0] for f in stereo] + [f[1] for f in stereo])).to(dev)
    n = len(stereo)
    inputs = {"mono": [staged[i] for i in range(len(mono))],
              "stereo": [(pairs[i], pairs[n + i]) for i in range(n)],
              "reloc": [(fid, torch.from_numpy(img).to(dev)) for fid, img in reloc]}
    use_sums("segment")
    for lap in ("mono", "stereo_batch", "kidnapped"):  # warm-up: kernels built, solvers started
        run(lap, inputs, dev)
    out = []
    for variant in args.order.split(","):
        use_sums(variant)
        for lap in ("mono", "stereo_batch", "kidnapped"):
            row = {"sums": variant, "lap": lap, **run(lap, inputs, dev)}
            print(json.dumps(row), file=sys.stderr)
            out.append(row)
    use_sums("segment")
    print(cs.nvidia_smi())
    print(json.dumps({"runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
