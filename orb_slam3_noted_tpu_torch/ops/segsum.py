"""Segment sums (port of :mod:`orb_slam3_noted_tpu.ops.segsum`).

The JAX package sums segments with one-hot matrix products, a TPU idiom;
here it is one ``index_add_``.  On a CUDA device that adds with atomics:
integer sums are exact in any order, float sums can differ in their last
bits from run to run.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments, ...) sums of the rows of ``data`` by ``seg``."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, seg.long(), data)
