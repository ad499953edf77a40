"""Run one cell of the benchmark of ``orb_slam3_noted_tpu_torch`` on the card.

    python3 slam_bench/run.py --workload euroc_stereo.replay_b16 --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which are also the last lines of standard error.  Exits 2
without a result where no card, or fewer cards than the cell asks for, is
present, and 3 where a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def quiet_host() -> None:
    """One host thread for the port's CPU-side math: the run is one process
    whose host path paces the card, and idle pool threads spinning beside
    it on a shared host make its clock spread."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def cache_dirs() -> None:
    """Every compile cache inside the checkout, at fixed paths; the port's
    own kernels build under ``build/torch_kernels`` there already."""
    base = ROOT / "build" / "slam_bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(cell, out) -> dict:
    from slam_bench.harness import metric_reader

    ctx = {"trace": out.trace, "notes": out.notes, "cell": cell.name}
    metrics = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def result_line(cell, out, device: dict, traced: int) -> tuple:
    """(the result's JSON object, the rows of numbers compared): ``checks``
    comes last."""
    from slam_bench import harness
    from slam_bench.trace import breakdown

    correct, rows = harness.judge(out.compared, cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if traced:
        metrics = per_layer(cell, out)
        device = dict(device, busy_s=out.trace["busy_s"], window_s=out.trace["window_s"])
    else:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out.metrics.items()}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if traced:
        result["breakdown"] = breakdown(out.trace)
    result["notes"] = {k: v for k, v in out.notes.items()
                       if k not in ("latencies_ms", "mapper_ms", "window_start")}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, rows


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    quiet_host()
    sys.path.insert(0, str(ROOT))
    import torch

    from slam_bench import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slam_bench: {cell.name} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    spans = harness.Spans()
    out = harness.driver(cell).run(cell, args, spans)
    out.metrics["setup_s"] = out.notes["window_start"] - T_START

    bad = harness.loaded_forbidden()
    if bad:
        print(f"slam_bench: modules loaded that the port may not load: {bad}", file=sys.stderr)
        return 3

    device = harness.device_info(torch, cell.chips, out.memory_peak_bytes)
    spans.dump(ROOT / "build" / "slam_bench" / f"spans.{cell.name}.json")
    result, rows = result_line(cell, out, device, args.trace)
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
