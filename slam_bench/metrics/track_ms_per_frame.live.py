"""Host ms per traced frame in the program's track_frame spans (local-map matching, pose optimisation, the wide retry)."""

from slam_bench import program_spans


def read(ctx):
    return program_spans.ms_per_frame(ctx, "track_frame")
