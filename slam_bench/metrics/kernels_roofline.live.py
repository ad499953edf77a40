"""K1-K4: summed least time over summed device time of their launches in the traced live window, %."""

from slam_bench import readers


def read(ctx):
    return readers.kernels_roofline(ctx)
