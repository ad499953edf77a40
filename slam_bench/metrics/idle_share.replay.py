"""Device idle share of the traced replay window, %."""

from slam_bench import readers


def read(ctx):
    return readers.idle_share(ctx)
