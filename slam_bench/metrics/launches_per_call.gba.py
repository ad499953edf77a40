"""CUDA kernel launches per traced GBA call."""

from slam_bench import readers


def read(ctx):
    return readers.count_per(ctx, "launches", per="calls")
