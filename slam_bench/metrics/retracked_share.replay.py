"""% of the traced frames that a mid-batch keyframe sent back to be tracked again (counter frames_retracked over frames)."""

from slam_bench import program_spans


def read(ctx):
    return program_spans.share(ctx, "frames_retracked", "frames")
