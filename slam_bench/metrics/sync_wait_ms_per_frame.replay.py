"""Host ms per traced frame in the program's device_read spans: the time the host waits on the card."""

from slam_bench import program_spans


def read(ctx):
    return program_spans.ms_per_frame(ctx, "device_read")
