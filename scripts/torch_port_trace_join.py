"""Run one benchmark cell traced, with the port's recorder on, and put the
profiled sub-window's device time and idle gaps down to the program's own
spans.

    python3 scripts/torch_port_trace_join.py --workload euroc_stereo.replay_b16 \\
        --seed 7 --seconds 30 [--out-dir build/trace_join]

from the root of a checkout, on the card.  The cell runs as
``slam_bench/run.py ... --trace 1`` runs it (its result line is printed
first), with ``orb_slam3_noted_tpu_torch.utils.timing.Recorder`` on from
set-up, so that its counters cover the whole run.
The benchmark's breakdown puts each idle gap down to the innermost of its
drivers' named ranges; here the profiler's window is kept and joined with
the recorder's spans on their shared clock (the profiler's Unix-epoch
nanoseconds):

- each device record (kernel, copy, set) goes to the innermost program span
  open around its host launch, which the profiler's correlation id names;
- each gap between device records goes to the innermost program span open
  at its middle, or to ``outside_spans``.

The JSON written to ``--out-dir`` (and its summary, the last line printed)
holds, by span name: device seconds, launches, idle-gap seconds (every gap,
and the 200 longest as the benchmark's breakdown takes them), the spans'
host seconds in the sub-window; the recorder's counters over the whole run;
the device ms a traced GBA call spends in kernels launched inside
``gba_pcg``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


def innermost_timeline(spans) -> tuple:
    """(starts, names) of the segments of time, each labelled with the
    innermost span open over it ('' where none is): spans nest within a
    thread, so the innermost is the one that began last."""
    edges = sorted([(s.start_ns, 1, -s.end_ns, s.name) for s in spans]
                   + [(s.end_ns, 0, 0, s.name) for s in spans])
    stack, starts, names = [], [], []
    for t, opening, _, name in edges:
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        starts.append(t)
        names.append(stack[-1] if stack else "")
    return starts, names


def label_at(timeline, t: int) -> str:
    starts, names = timeline
    i = bisect.bisect_right(starts, t) - 1
    return (names[i] if i >= 0 else "") or "outside_spans"


def join(prof, spans, n_longest: int = 200) -> dict:
    """Device seconds, launches and idle-gap seconds by program span."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    annotations = {e.name() for e in events if e.is_user_annotation()}
    launch_at, device = {}, []
    t0, t1 = None, None
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name() in annotations or e.end_ns() <= e.start_ns():
                continue
            device.append(e)
        else:
            t0 = e.start_ns() if t0 is None else min(t0, e.start_ns())
            t1 = e.end_ns() if t1 is None else max(t1, e.end_ns())
            if e.name().startswith(LAUNCHES):
                launch_at[e.correlation_id()] = e.start_ns()
    inside = [s for s in spans if t0 is not None and s.end_ns >= t0 and s.start_ns <= t1]
    line = innermost_timeline(inside)
    dev_s, launches, unmatched = defaultdict(float), defaultdict(int), 0
    for e in device:
        at = launch_at.get(e.correlation_id(), launch_at.get(e.linked_correlation_id()))
        if at is None:
            unmatched += 1
            continue
        name = label_at(line, at)
        dev_s[name] += (e.end_ns() - e.start_ns()) / 1e9
        launches[name] += 1
    merged = []
    for s, t in sorted((e.start_ns(), e.end_ns()) for e in device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) // 2) for a, b in zip(merged, merged[1:])),
                  reverse=True)
    idle_all, idle_longest = defaultdict(float), defaultdict(float)
    for k, (length, mid) in enumerate(gaps):
        name = label_at(line, mid)
        idle_all[name] += length / 1e9
        if k < n_longest:
            idle_longest[name] += length / 1e9
    host = defaultdict(float)
    for s in inside:
        host[s.name] += (s.end_ns - s.start_ns) / 1e9
    order = lambda d: dict(sorted(d.items(), key=lambda x: -x[1]))
    return {"device_s": order(dev_s), "launches": order(launches),
            "idle_s": order(idle_all), "idle_s_longest": order(idle_longest),
            "host_s": order(host), "device_records": len(device),
            "device_records_unmatched": unmatched,
            "busy_s": sum(t - s for s, t in merged) / 1e9,
            "gba_calls": sum(1 for s in inside if s.name == "global_ba")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out-dir", default=str(ROOT / "build" / "trace_join"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from slam_bench import run, trace

    from orb_slam3_noted_tpu_torch.utils import timing

    timing.Recorder.enabled = True
    kept = {}
    reduce_profile = trace.reduce_profile

    def keeping(prof, ranges, window_s, n_gaps=200):
        kept["join"] = join(prof, timing.RECORDER.spans, n_gaps)
        return reduce_profile(prof, ranges, window_s, n_gaps)

    trace.reduce_profile = keeping
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or "join" not in kept:
        return rc or 1
    out = dict(kept["join"], workload=args.workload, seed=args.seed,
               counters=dict(timing.RECORDER.counters))
    calls = out["gba_calls"]
    if calls:
        out["pcg_device_ms_per_call"] = 1e3 * out["device_s"].get("gba_pcg", 0.0) / calls
    path = Path(args.out_dir) / f"{args.workload}.{args.seed}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    top = lambda d: [[k, round(v, 6)] for k, v in list(d.items())[:8]]
    print(json.dumps({"join": args.workload, "seed": args.seed, "idle_s": top(out["idle_s"]),
                      "idle_s_longest": top(out["idle_s_longest"]),
                      "device_s": top(out["device_s"]), "counters": out["counters"],
                      "unmatched": out["device_records_unmatched"],
                      "pcg_device_ms_per_call": out.get("pcg_device_ms_per_call")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
