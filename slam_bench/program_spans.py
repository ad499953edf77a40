"""What the readers of the program's own spans and counters share.

The port keeps its spans and counters in
``orb_slam3_noted_tpu_torch.utils.timing.RECORDER``, which records while a
``torch.profiler`` records: in a ``--trace 1`` run, over the profiled
sub-window that follows the window (its frames counted by the program's
``frames`` counter).  Each span carries the attributes of the spans around
it: a batch's spans ``frames``, the size of its ``process_batch`` call.  A
program without the recorder (an older commit), or a run without a trace,
gives None, and the metric is left out of the line.
"""

from __future__ import annotations


def recorder(ctx):
    """The port's recorder holding what the traced sub-window kept, or None."""
    if not ctx.get("trace"):
        return None
    try:
        from orb_slam3_noted_tpu_torch.utils import timing
    except ImportError:
        return None
    rec = getattr(timing, "RECORDER", None)
    return rec if rec is not None and rec.counters.get("frames") else None


def span_ms(rec, name: str, batch: bool = False) -> list:
    """Host ms of each kept span named ``name``; with ``batch``, only those
    inside a ``process_batch`` call of more than one frame."""
    return [(s.end_ns - s.start_ns) / 1e6 for s in rec.spans
            if s.name == name and (not batch or s.attrs.get("frames", 1) > 1)]


def ms_per_frame(ctx, name: str, batch: bool = False) -> float | None:
    """Host ms in the spans ``name`` per frame the sub-window handed over."""
    rec = recorder(ctx)
    return None if rec is None else sum(span_ms(rec, name, batch)) / rec.counters["frames"]


def share(ctx, part: str, whole: str) -> float | None:
    """% of counter ``whole`` that counter ``part`` is (0 where ``part``
    never counted), or None where ``whole`` is 0."""
    rec = recorder(ctx)
    if rec is None or not rec.counters.get(whole):
        return None
    return 100.0 * rec.counters.get(part, 0) / rec.counters[whole]
