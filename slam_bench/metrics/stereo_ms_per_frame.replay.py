"""Host ms per traced frame in the batch front end's stereo_matching spans (K4 over the batch's pairs)."""

from slam_bench import program_spans


def read(ctx):
    return program_spans.ms_per_frame(ctx, "stereo_matching", batch=True)
