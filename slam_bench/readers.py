"""The arithmetic the per-layer readers in ``metrics/`` share.  Each reader
takes the run's context: ``trace`` (``trace.reduce_profile``'s dict with the
traced ``frames`` or GBA ``calls`` and the kernels' ``expected`` counts),
``notes`` (the untraced window's own readings) and ``cell``.  A reader that
finds nothing to read returns None, and the metric is left out of the line.
"""

from __future__ import annotations

from slam_bench.harness import percentile
from slam_bench.roofline import roofline_share


def idle_share(ctx) -> float | None:
    """% of the traced window in which no kernel, copy or set ran on the card."""
    t = ctx["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - min(t["busy_s"], t["window_s"]) / t["window_s"])


def kernels_roofline(ctx) -> float | None:
    t = ctx["trace"]
    return roofline_share(t["kernels"], t["expected"]) if t and t.get("expected") else None


def range_ms_per_frame(ctx, names: tuple) -> float | None:
    """Host ms in the port's ranges ``names`` per traced frame."""
    t = ctx["trace"]
    if not t:
        return None
    ivs = [s for n in names for s in t["ranges"].get(n, [])]
    return 1e3 * sum(ivs) / t["frames"] if ivs else None


def count_per(ctx, key: str, per: str = "frames") -> float | None:
    t = ctx["trace"]
    return t[key] / t[per] if t and t.get(per) else None


def mapper_ms(ctx) -> float | None:
    """Host ms a mapper pass (``_insert_keyframe``: point compaction, the
    keyframe step, the loop detection it queues), the benchmark's spans over
    the run's warm-up and window."""
    ms = ctx["notes"].get("mapper_ms")
    return sum(ms) / len(ms) if ms else None


def note(ctx, key: str) -> float | None:
    return ctx["notes"].get(key)


def latency_pct(ctx, q: float) -> float | None:
    lat = ctx["notes"].get("latencies_ms")
    return percentile(lat, q) if lat and len(lat) >= 2 else None
