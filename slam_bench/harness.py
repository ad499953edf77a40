"""What every cell shares: finding a cell's files by name, the device and
the result line, the benchmark's own spans, the check that no JAX module
was loaded, and the per-layer metric readers.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files, found
by name alone so that a new cell needs only new files:

- ``slam_bench/configs/<config>.json`` (the ``file`` of its configuration),
- ``slam_bench/traffic/<traffic>.json``: the mix's parameters, with
  ``driver`` naming the general driver ``slam_bench/drivers/<driver>.py``,
- ``slam_bench/limits/<cell>.json``: the limit of each number compared,
- ``slam_bench/metrics/<metric>.py``: a reader per per-layer metric, which
  ``BENCHMARK.json`` lists with the ``workloads`` that report it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam3_noted_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    per_layer: list  # the BENCHMARK.json entries this cell reports
    end_to_end: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    here = root / "slam_bench"
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, int(w["chips"]), config, traffic, limits, per_layer, e2e)


def driver(cell: Cell):
    return importlib.import_module(f"slam_bench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``slam_bench/metrics/<name>.py``: a value, or
    None where the traced window holds nothing for it to read."""
    path = root / "slam_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """The benchmark's own spans around its calls into the port, kept in
    memory: (name, start_s, end_s, attributes) on the host clock."""

    def __init__(self):
        self.items: list = []

    def add(self, name: str, start: float, end: float, **attrs) -> None:
        self.items.append((name, start, end, attrs))

    def dump(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps([[n, s, e, a] for n, s, e, a in self.items]))


@dataclass
class Outcome:
    """What a driver hands back: the end-to-end metrics of the window, the
    counts, the numbers compared (name -> value) and, for a traced run, what
    the per-layer readers read."""

    metrics: dict
    attempted: int
    failed: int
    compared: dict
    memory_peak_bytes: int
    trace: dict | None = None
    notes: dict = field(default_factory=dict)


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100) of ``values`` by the inclusive method."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")[int(q) - 1])


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, each compared whole (the port's name only begins with the
    JAX package's)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_info(torch, chips: int, memory_peak_bytes: int) -> dict:
    """The result's ``device``: the peak is the one the driver read when the
    window closed, before the reference ran."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": memory_peak_bytes}


def judge(compared: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its limit;
    a number without a limit, or not finite, or a limit without its number,
    fails."""
    rows = []
    ok = True
    for name, value in compared.items():
        lim = limits.get(name)
        good = lim is not None and value == value and value <= lim
        ok = ok and good
        rows.append((name, value, lim))
    missing = [n for n in limits if n not in compared]
    rows += [(n, None, limits[n]) for n in missing]
    return ok and bool(rows) and not missing, rows


def now() -> float:
    return time.perf_counter()
