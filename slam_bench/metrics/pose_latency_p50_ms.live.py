"""Median of every window frame's latency, hand-off to pose on the host."""

from slam_bench import readers


def read(ctx):
    return readers.latency_pct(ctx, 50)
