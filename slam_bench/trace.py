"""The reduction of a ``torch.profiler`` window to what the per-layer
readers read.

The arithmetic is a frozen copy of ``chip_smoke.py``'s ``split_by_range``
(launches are the host's ``cudaLaunchKernel*`` / ``cuLaunchKernel*`` calls,
device-to-host copies the device's ``Memcpy DtoH`` records, a range's host
time the sum of its intervals) and of ``scripts/torch_port_profile_lap.py``'s
device busy time (the union of the device's kernel, copy and set records),
read from the profiler's raw event list rather than its function-event tree,
which costs seconds per thousand launches to build.
"""

from __future__ import annotations

from collections import defaultdict


def _ns(e, end: bool = False) -> int:
    if hasattr(e, "start_ns"):
        return e.end_ns() if end else e.start_ns()
    return int((e.start_us() + (e.duration_us() if end else 0)) * 1000)


def _union(intervals: list) -> tuple:
    """(total length, merged intervals) of (start, end) pairs."""
    total, merged = 0, []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        total += e - s
    return total, merged


def reduce_profile(prof, ranges: tuple, window_s: float, n_gaps: int = 200) -> dict:
    """The window's events as the readers want them.

    Returns ``window_s``; ``busy_s`` (the union of device records);
    ``ranges``: {name: [host seconds of each interval]} for ``ranges``;
    ``launches`` and ``d2h_copies`` (counts); ``kernels``: {device op name:
    [seconds of each record]}; ``idle_gaps``: [(innermost host range around
    the gap, seconds)] of the ``n_gaps`` longest gaps between device
    records, longest first."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    annotations = {e.name() for e in events if e.is_user_annotation()}
    dev_iv, host = [], defaultdict(list)
    kernels = defaultdict(list)
    launches = d2h = 0
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the device's own records; a range's copy on the device's
            # timeline (``gpu_user_annotation``) is no device work
            if e.is_user_annotation() or name in annotations:
                continue
            s, t = _ns(e), _ns(e, True)
            if t <= s:
                continue
            dev_iv.append((s, t))
            kernels[name].append((t - s) / 1e9)
            if name.startswith("Memcpy DtoH"):
                d2h += 1
        else:
            if name.startswith("cudaLaunchKernel") or name.startswith("cuLaunchKernel"):
                launches += 1
            elif name in ranges:
                host[name].append((_ns(e), _ns(e, True)))
    busy_ns, merged = _union(dev_iv)
    raw = sorted(((s1 - e0, (e0 + s1) / 2) for (_, e0), (s1, _) in zip(merged, merged[1:])),
                 reverse=True)[:n_gaps]
    gaps = []
    for length, mid in raw:
        around = [(b - a, n) for n, ivs in host.items() for a, b in ivs if a <= mid <= b]
        gaps.append((min(around)[1] if around else "outside_ranges", length / 1e9))
    return {
        "window_s": window_s,
        "busy_s": busy_ns / 1e9,
        "ranges": {n: [(b - a) / 1e9 for a, b in host.get(n, [])] for n in ranges},
        "launches": launches,
        "d2h_copies": d2h,
        "kernels": dict(kernels),
        "idle_gaps": gaps,
    }


def breakdown(red: dict, top: int = 10) -> dict:
    """The ``--trace 1`` line's breakdown: the device operations that took
    most time, and the idle time between device records summed by the
    innermost host range around each gap."""
    ops = sorted(((n, sum(v)) for n, v in red["kernels"].items()), key=lambda x: -x[1])
    by_range = defaultdict(float)
    for n, s in red["idle_gaps"]:
        by_range[n] += s
    gaps = sorted(by_range.items(), key=lambda x: -x[1])
    return {"device_ops": [[n[:120], s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
