"""Device idle share of the traced live window, %."""

from slam_bench import readers


def read(ctx):
    return readers.idle_share(ctx)
