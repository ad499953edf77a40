"""Binary visual vocabulary (port of :mod:`orb_slam3_noted_tpu.place.vocab`).

The vocabulary is a flat bank of W binary centroids (W = 32,767 for the
shipped one).  ``transform`` assigns every descriptor of a frame to its
nearest word with one float32 product of unpacked bits, ``popA + popB -
2 A B^T`` as in :func:`..ops.matching.hamming_matrix`: the products are 0/1
and the sums at most 256, so the distances are exact (TF32 is off).  The
(N, W) distance matrix is the only large temporary (157 MB at N = 1200 on
the shipped bank); no (N, W, 8) XOR tensor is built.

Training is binary k-means ("k-majority": a cluster's centroid is the
per-bit majority vote), numpy on the host around the same distance product.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.ops import matching as M


def _majority_centroids(bits: np.ndarray, assign: np.ndarray, k: int) -> np.ndarray:
    """Per-cluster per-bit majority vote. bits (N, 256) uint8, assign (N,)."""
    cent = np.zeros((k, bits.shape[1]), np.uint8)
    for c in range(k):
        sel = bits[assign == c]
        if len(sel) == 0:
            continue
        cent[c] = (sel.mean(axis=0) >= 0.5).astype(np.uint8)
    return cent


def train_vocabulary(descriptors: np.ndarray, n_words: int = 4096, n_iters: int = 8,
                     seed: int = 0, device=None) -> np.ndarray:
    """Binary k-means over packed descriptors -> (W, 8) uint32 centroid bank.

    descriptors: (N, 8) uint32 packed ORB descriptors (N >> n_words).  The
    distances are computed on ``device`` (the card unless the caller names
    another); the clustering itself is numpy.
    """
    dev = torch.device("cuda" if device is None else device)
    rng = np.random.default_rng(seed)
    desc = np.ascontiguousarray(descriptors, np.uint32)
    n = len(desc)
    bits_t = M.unpack_bits(torch.from_numpy(desc.view(np.int32)).to(dev))
    bits = bits_t.to(torch.uint8).cpu().numpy()
    k = min(n_words, n)
    cent_idx = rng.choice(n, size=k, replace=False)
    cent_bits = bits[cent_idx].copy()

    for _ in range(n_iters):
        cent_t = torch.from_numpy(cent_bits).to(dev, torch.float32)
        d = M.hamming_bits(bits_t, cent_t).cpu().numpy()
        assign = d.argmin(axis=1)
        new_cent = _majority_centroids(bits, assign, k)
        # re-seed empty clusters from the farthest points
        empty = np.flatnonzero(np.bincount(assign, minlength=k) == 0)
        if len(empty):
            far = d.min(axis=1).argsort()[::-1][: len(empty)]
            new_cent[empty] = bits[far]
        if np.array_equal(new_cent, cent_bits):
            break
        cent_bits = new_cent

    shifts = np.arange(32, dtype=np.uint32)
    w = cent_bits.reshape(k, 8, 32).astype(np.uint32) << shifts[None, None, :]
    return w.sum(axis=2, dtype=np.uint32)


def transform(vocab: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor):
    """Assign every descriptor to its nearest word (the first on ties).

    vocab: (W, 8) int32 (uint32 bits); desc: (N, 8); valid: (N,) bool.
    Returns (word (N,) int32, -1 where invalid; dist (N,) int32).
    """
    bv = M.unpack_bits(vocab)
    bd = M.unpack_bits(desc)
    # popA is the same along a row, so the argmin over words needs popB - 2AB^T
    # alone; one (N, W) buffer, updated in place
    d = (bd @ bv.T).mul_(-2.0).add_(bv.sum(-1))
    word = torch.argmin(d, dim=1)  # the first minimum, as jnp.argmin
    dist = (d.gather(1, word[:, None])[:, 0] + bd.sum(-1)).to(torch.int32)
    return torch.where(valid, word.to(torch.int32), -1), dist


def bow_vector(word: torch.Tensor, n_words: int, idf: torch.Tensor | None = None) -> torch.Tensor:
    """L1-normalised (tf-idf) dense BoW vector from word assignments: the
    histogram counts integers, so ``index_add_`` is exact in any order."""
    ok = word >= 0
    hist = torch.zeros(n_words, dtype=torch.float32, device=word.device)
    hist.index_add_(0, word.clamp(min=0).long(), ok.to(torch.float32))
    if idf is not None:
        hist = hist * idf
    return hist / torch.clamp(torch.sum(hist), min=1e-9)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity: 1 - 0.5 |v1 - v2|_1 (both L1-normalised)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)
