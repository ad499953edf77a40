"""The port's spans and counters, and the per-stage timers, the saturation
counters and the metric stream built on them (port of
:mod:`orb_slam3_noted_tpu.utils.timing`).

One recorder (:data:`RECORDER`) keeps every span and counter of the
process.  :func:`span` decides, each time it is entered, between three
states:

- a ``torch.profiler`` is recording: the span enters
  ``torch.profiler.record_function(name)``, so the range is in the device
  trace, and is also kept by the recorder, with the attributes the
  profiler's ranges cannot carry;
- the recorder is on (``Recorder.enabled``: ``ORB_TPU_TIMES=1`` in the
  environment, the CLI's ``--times`` or ``--metrics``, or set by the
  caller): the span is kept as a :class:`Span`;
- both off: one flag check and ``torch.autograd._profiler_enabled()``;
  nothing is kept and no profiler event is made.

A span's stamps are ``time.time_ns()``, the Unix-epoch nanoseconds that the
profiler stamps its host events with, so kept spans can be laid beside a
device trace.  Each thread has its own stack of open spans: a span's parent
is the innermost span open in its thread when it began, and it inherits
that parent's attributes (the frame id of a ``process`` call, the index of
a GBA call).

:func:`count` adds to a counter while a span would be kept; it counts only
what the host already holds.  Neither a span nor a counter adds a device
read, a synchronisation or a launch, with one exception that the caller asks
for: ``StageTimer.stage(name, block=True)`` waits with
``torch.cuda.synchronize()`` before its span closes (the counterpart of
``jax.block_until_ready``), so that it times the device work it enqueued.

``StageTimer`` is the recorder under the reference's REGISTER_TIMES name.
The saturation counters are the recorder's ``saturation.<cap>`` counters,
counted whether or not the recorder is on: the port's code calls
:func:`report_saturation` with the overflow count directly instead of from
inside a compiled function.  :class:`MetricsStream` writes one JSON line per
pipeline beat: the spans and counters since the last line, the saturation
counters and the facade's gauges (the CLI's ``--metrics``).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict
from collections.abc import MutableMapping
from typing import NamedTuple

import numpy as np
import torch

_profiling = torch.autograd._profiler_enabled
_clock = time.time_ns

DEVICE_READ = "device_read"  # the span around a blocking device-to-host read
_SATURATION = "saturation."  # the prefix of the saturation counters


class Span(NamedTuple):
    """One kept span: ``parent`` is the ``id`` of the span open around it in
    its thread, or None; ``attrs`` its own attributes over its parent's."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    attrs: dict


class _Off:
    """The span while nothing records: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        """Attributes known only inside the span; dropped here."""


_OFF = _Off()


class _Open:
    """A span that records: kept by its recorder when it closes, and a
    profiler range while a profiler records."""

    __slots__ = ("_rec", "_name", "_block", "_range", "_stack", "_t0", "id", "parent", "attrs")

    def __init__(self, rec, name: str, block: bool, attrs: dict):
        self._rec, self._name, self._block, self.attrs = rec, name, block, attrs

    def __enter__(self):
        # stamped around the profiler's range, whose own stamps then lie
        # within some microseconds inside these
        self._t0 = _clock()
        rec = self._rec
        self._stack = stack = rec._stack()
        up = stack[-1] if stack else None
        self.parent = None if up is None else up.id
        if up is not None and up.attrs:
            self.attrs = {**up.attrs, **self.attrs} if self.attrs else up.attrs
        self.id = next(rec._ids)
        stack.append(self)
        self._range = (torch.profiler.record_function(self._name).__enter__()
                       if _profiling() else None)
        return self

    def __exit__(self, *exc):
        if self._block and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._stack.pop()
        self._rec.spans.append(Span(self.id, self._name, self._t0, _clock(), self.parent,
                                    self.attrs))
        return False

    def set(self, **attrs):
        """Add attributes known only inside the span (a search widened)."""
        self.attrs = {**self.attrs, **attrs}


class Recorder:
    """Spans and counters kept in memory: ``spans`` (:class:`Span`, in the
    order they closed) and ``counters`` (name -> int).  ``enabled`` is
    shared by every recorder; a profiler that records turns every recorder
    on for as long as it records."""

    enabled = bool(int(os.environ.get("ORB_TPU_TIMES", "0")))

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict = defaultdict(int)
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()  # counters are read-modify-write

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, block=None, **attrs):
        """A span named ``name`` with ``attrs``, as a context manager whose
        ``set(**attrs)`` adds attributes before it closes.  ``block``: wait
        for the device before the span closes (see the module's note)."""
        if not (self.enabled or _profiling()):
            return _OFF
        return _Open(self, name, bool(block), attrs)

    stage = span  # the REGISTER_TIMES name

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` while the recorder is on."""
        if self.enabled or _profiling():
            with self._lock:
                self.counters[name] += n

    def add(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        """Keep a span timed by the caller (``native.StageTimer``), inside
        the span open in this thread; whether or not the recorder is on."""
        stack = self._stack()
        up = stack[-1] if stack else None
        if up is not None and up.attrs:
            attrs = {**up.attrs, **attrs}
        self.spans.append(Span(next(self._ids), name, start_ns, end_ns,
                               None if up is None else up.id, attrs))

    def reset(self) -> None:
        """Drop every kept span and counter, the saturation counters too."""
        self.spans = []
        with self._lock:
            self.counters.clear()

    def durations_ms(self, spans=None) -> dict:
        """{name: [ms of each span]} of ``spans`` (default: every kept one)."""
        out = defaultdict(list)
        for s in self.spans if spans is None else spans:
            out[s.name].append((s.end_ns - s.start_ns) / 1e6)
        return out

    def summary(self) -> dict:
        out = {}
        for name, v in self.durations_ms().items():
            a = np.asarray(v)
            out[name] = {
                "n": int(a.size),
                "mean_ms": float(a.mean()),
                "std_ms": float(a.std()),
                "total_s": float(a.sum() / 1e3),
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


StageTimer = Recorder
RECORDER = GLOBAL_TIMER = Recorder()


def span(name: str, **attrs):
    """A span of :data:`RECORDER` (see the module's note on its cost)."""
    # the check of ``Recorder.span`` inline: every range of the port pays it
    if not (Recorder.enabled or _profiling()):
        return _OFF
    return _Open(RECORDER, name, False, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to :data:`RECORDER`'s counter ``name`` while it is on."""
    RECORDER.count(name, n)


def device_read():
    """The span around a blocking device-to-host read, counted in
    ``device_reads``: ``with device_read(): n = int(t)``."""
    if not (Recorder.enabled or _profiling()):
        return _OFF
    RECORDER.count("device_reads")
    return _Open(RECORDER, DEVICE_READ, False, {})


class _Saturation(MutableMapping):
    """The recorder's ``saturation.<cap>`` counters under their cap names; a
    cap never reported reads 0."""

    def __init__(self, rec: Recorder):
        self._rec = rec

    def __getitem__(self, cap):
        return self._rec.counters.get(_SATURATION + cap, 0)

    def __setitem__(self, cap, value):
        self._rec.counters[_SATURATION + cap] = value

    def __delitem__(self, cap):
        del self._rec.counters[_SATURATION + cap]

    def __contains__(self, cap):
        return _SATURATION + cap in self._rec.counters

    def pop(self, cap, *default):
        return self._rec.counters.pop(_SATURATION + cap, *default)

    def __iter__(self):
        n = len(_SATURATION)
        return iter([k[n:] for k in list(self._rec.counters) if k.startswith(_SATURATION)])

    def __len__(self):
        return sum(1 for _ in self)


# Static-capacity truncations (map-point allocator, ...) report their
# overflow here instead of silently dropping data.
SATURATION = _Saturation(RECORDER)


def report_saturation(name: str, overflow) -> None:
    """Count ``overflow`` (an int or a one-element tensor; 0 = no
    truncation) under ``name`` and warn on its first occurrence."""
    if isinstance(overflow, torch.Tensor):
        with device_read():
            a = int(overflow)
    else:
        a = int(overflow)
    if a > 0:
        if SATURATION[name] == 0:
            print(
                f"[saturation] {name}: capacity exceeded by {a} "
                "(first occurrence)",
                file=sys.stderr,
            )
        with RECORDER._lock:
            RECORDER.counters[_SATURATION + name] += a


def print_saturation(file=None):
    if not SATURATION:
        return
    lines = ["saturated cap              dropped (total)"]
    for name in sorted(SATURATION):
        lines.append(f"{name:<26} {SATURATION[name]:>10}")
    print("\n".join(lines), file=file)


class MetricsStream:
    """Structured JSONL metric stream.  Each :meth:`emit` appends a line
    holding a sequence number and the wall-clock time, the spans the
    recorder kept since the previous emit (``stages``: count and total ms
    per name, only names that ran), the counters that moved since then
    (``counters``), the cumulative saturation counters and the caller's
    gauges.  It reads the recorder, so it composes with ``--times``."""

    def __init__(self, path: str, timer: Recorder | None = None):
        self._f = open(path, "a", buffering=1)
        self._rec = timer if timer is not None else RECORDER
        self._seq = 0
        self._k = len(self._rec.spans)  # spans already written
        self._counters = self._counts()  # counters at the last emit

    def _counts(self) -> dict:
        return {k: v for k, v in list(self._rec.counters.items())
                if not k.startswith(_SATURATION)}

    def emit(self, event: str, **gauges):
        new = self._rec.spans[self._k:]
        self._k += len(new)
        stages = {name: {"n": len(v), "total_ms": round(sum(v), 3)}
                  for name, v in self._rec.durations_ms(new).items()}
        now = self._counts()
        moved = {k: v - self._counters.get(k, 0) for k, v in now.items()
                 if v != self._counters.get(k, 0)}
        self._counters = now
        rec = dict(gauges)
        # reserved keys win over the caller's gauges
        rec.update({"seq": self._seq, "ts": time.time(), "event": event})
        if stages:
            rec["stages"] = stages
        if moved:
            rec["counters"] = moved
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
