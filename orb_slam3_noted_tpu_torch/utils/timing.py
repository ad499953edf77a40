"""Per-stage timing and saturation counters (port of :mod:`orb_slam3_noted_tpu.utils.timing`).

``StageTimer`` keeps the reference's REGISTER_TIMES taxonomy.  PyTorch
launches asynchronously on the card, so a stage given ``block`` waits with
``torch.cuda.synchronize()`` before its span closes (the counterpart of
``jax.block_until_ready``); without it a span measures the enqueue.

The saturation counters are plain host counters: the port's code calls
:func:`report_saturation` with the overflow count directly instead of from
inside a compiled function.  :class:`MetricsStream` writes one JSON line per
pipeline beat: the stage spans since the last line, the saturation counters
and the facade's gauges (the CLI's ``--metrics``).
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch


class StageTimer:
    enabled = bool(int(os.environ.get("ORB_TPU_TIMES", "0")))

    def __init__(self):
        self.spans = defaultdict(list)

    @contextmanager
    def stage(self, name: str, block=None):
        if not StageTimer.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block is not None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.spans[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, v in self.spans.items():
            a = np.asarray(v)
            out[name] = {
                "n": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "std_ms": float(a.std() * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def print_stats(self, file=None):
        """Reference ``Tracking::PrintTimeStats`` analogue."""
        rows = self.summary()
        lines = ["stage                     n    mean ms     std ms    total s"]
        for name in sorted(rows):
            r = rows[name]
            lines.append(
                f"{name:<22} {r['n']:>5} {r['mean_ms']:>10.3f}"
                f" {r['std_ms']:>10.3f} {r['total_s']:>10.3f}"
            )
        text = "\n".join(lines)
        print(text, file=file)
        return text

    def save(self, path: str):
        """Dump per-stage means to a file (reference ``ExecTimeMean.txt``)."""
        with open(path, "w") as f:
            self.print_stats(file=f)


GLOBAL_TIMER = StageTimer()

# Static-capacity truncations (map-point allocator, ...) report their
# overflow here instead of silently dropping data.
SATURATION = defaultdict(int)


def report_saturation(name: str, overflow) -> None:
    """Count ``overflow`` (an int or a one-element tensor; 0 = no
    truncation) under ``name`` and warn on its first occurrence."""
    a = int(overflow)
    if a > 0:
        if SATURATION[name] == 0:
            print(
                f"[saturation] {name}: capacity exceeded by {a} "
                "(first occurrence)",
                file=sys.stderr,
            )
        SATURATION[name] += a


def print_saturation(file=None):
    if not SATURATION:
        return
    lines = ["saturated cap              dropped (total)"]
    for name in sorted(SATURATION):
        lines.append(f"{name:<26} {SATURATION[name]:>10}")
    print("\n".join(lines), file=file)


class MetricsStream:
    """Structured JSONL metric stream.  Each :meth:`emit` appends a line
    holding a sequence number and the wall-clock time, the stage spans
    recorded since the previous emit (count and total ms, only stages that
    ran), the cumulative saturation counters and the caller's gauges.
    Deltas come from the timer's span lists, so the stream composes with
    ``--times`` without a second bookkeeping."""

    def __init__(self, path: str, timer: StageTimer | None = None):
        self._f = open(path, "a", buffering=1)
        self._timer = timer if timer is not None else GLOBAL_TIMER
        self._seq = 0
        self._seen: dict = {}  # stage -> span count at the last emit

    def emit(self, event: str, **gauges):
        stages = {}
        for name, spans in self._timer.spans.items():
            k0 = self._seen.get(name, 0)
            if len(spans) > k0:
                new = spans[k0:]
                stages[name] = {"n": len(new), "total_ms": round(sum(new) * 1e3, 3)}
                self._seen[name] = len(spans)
        rec = dict(gauges)
        # reserved keys win over the caller's gauges
        rec.update({"seq": self._seq, "ts": time.time(), "event": event})
        if stages:
            rec["stages"] = stages
        if SATURATION:
            rec["saturation"] = dict(SATURATION)
        self._seq += 1
        self._f.write(json.dumps(rec) + "\n")

    @staticmethod
    def gauges_for(slam) -> dict:
        """The standard gauges of any SLAM facade."""
        g = {
            "n_kf": int(getattr(slam, "n_kf", 0)),
            "n_mp": int(getattr(slam, "n_mp", 0)),
            "state": getattr(slam, "state", "?"),
            "frames_total": int(getattr(slam, "frames_total", 0)),
        }
        stage = getattr(slam, "imu_stage", None)
        if stage is not None:
            g["imu_stage"] = int(stage)
        return g

    def close(self):
        self._f.close()
