"""Host ms a mapper pass of the live cell (the benchmark's spans around _insert_keyframe, warm-up and window)."""

from slam_bench import readers


def read(ctx):
    return readers.mapper_ms(ctx)
