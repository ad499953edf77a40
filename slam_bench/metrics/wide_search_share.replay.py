"""% of the traced track_frame calls that ran the 3x-radius retry (counter track_wide_search over track_calls)."""

from slam_bench import program_spans


def read(ctx):
    return program_spans.share(ctx, "track_wide_search", "track_calls")
