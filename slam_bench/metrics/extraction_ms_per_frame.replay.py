"""Host ms per frame in ORB extraction's ranges (fast_select, ic_angle, describe)."""

from slam_bench import readers


def read(ctx):
    return readers.range_ms_per_frame(ctx, ("fast_select", "ic_angle", "describe"))
