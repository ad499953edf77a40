"""CUDA kernel launches per traced replay frame."""

from slam_bench import readers


def read(ctx):
    return readers.count_per(ctx, "launches")
