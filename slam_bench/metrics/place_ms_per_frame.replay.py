"""Host ms a window frame in place recognition and loop detection (spans around _maybe_close_loop and flush)."""

from slam_bench import readers


def read(ctx):
    return readers.note(ctx, "place_ms_per_frame")
