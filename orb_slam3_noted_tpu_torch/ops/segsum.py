"""Segment sums (port of :mod:`orb_slam3_noted_tpu.ops.segsum`).

The JAX package sums segments with one-hot matrix products, a TPU idiom.
Here float rows are sorted by segment once (:func:`segment_order`, stable,
so each segment keeps its rows' order) and summed with
``torch.segment_reduce``, which adds each segment's rows one after another:
the same sums in every run on the card (``index_add_`` adds with atomics,
in an order that changes from run to run) and bit for bit ``index_add_``'s
on the CPU.  Integer sums, exact in any order, stay ``index_add_``.
"""

from __future__ import annotations

import torch


def segment_order(seg: torch.Tensor, num_segments: int, valid: torch.Tensor | None = None):
    """(permutation sorting the rows by segment, rows per segment): computed
    once where many sums share one segmentation.  Rows where ``valid`` is
    false must carry zero data in every sum: they are dealt round-robin over
    the segments (adding a zero leaves a sum as it was), so that no segment
    holds all the padding (``segment_reduce`` adds a segment's rows in one
    thread, and one 74,000-row segment made a GBA step 7x slower)."""
    seg = seg.long()
    if valid is not None:
        spread = torch.arange(seg.shape[0], device=seg.device) % num_segments
        seg = torch.where(valid, seg, spread)
    lengths = torch.zeros(num_segments, dtype=torch.long, device=seg.device)
    lengths.index_add_(0, seg, torch.ones_like(seg))
    return torch.argsort(seg, stable=True), lengths


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int,
                order=None) -> torch.Tensor:
    """(num_segments, ...) sums of the rows of ``data`` by ``seg``; ``order``
    is :func:`segment_order` of ``seg`` where the caller keeps it (float
    data is then summed by ``order``'s segmentation)."""
    if not data.is_floating_point():
        out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype, device=data.device)
        return out.index_add_(0, seg.long(), data)
    perm, lengths = segment_order(seg, num_segments) if order is None else order
    return torch.segment_reduce(data[perm], "sum", lengths=lengths, unsafe=True)
