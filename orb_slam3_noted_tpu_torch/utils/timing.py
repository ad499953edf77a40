"""Per-stage timing and saturation counters (port of :mod:`orb_slam3_noted_tpu.utils.timing`).

``StageTimer`` keeps the reference's REGISTER_TIMES taxonomy.  PyTorch
launches asynchronously on the card, so a stage given ``block`` waits with
``torch.cuda.synchronize()`` before its span closes (the counterpart of
``jax.block_until_ready``); without it a span measures the enqueue.

The saturation counters are plain host counters: the port's code calls
:func:`report_saturation` with the overflow count directly instead of from
inside a compiled function.
"""

from __future__ import annotations

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
