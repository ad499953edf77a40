"""Host ms per frame in the batch tracking ranges (track_batch, track_batch_feats)."""

from slam_bench import readers


def read(ctx):
    return readers.range_ms_per_frame(ctx, ("track_batch", "track_batch_feats"))
