"""Shipped pretrained vocabulary loader (port of
:mod:`orb_slam3_noted_tpu.place.pretrained`).

The JAX package ships a 32k-word bank, ``orb_slam3_noted_tpu/assets/
vocab32k.npz`` (``vocab`` (32767, 8) uint32, ``idf`` (32767,) float32),
trained offline by ``scripts/train_vocab.py``.  The port reads the same file
by path with numpy; it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

_ASSET = os.path.join(os.path.dirname(__file__), "..", "..", "orb_slam3_noted_tpu", "assets",
                      "vocab32k.npz")


@lru_cache(maxsize=1)
def load_default_vocabulary():
    """((W, 8) uint32 packed centroid bank, (W,) float32 idf or None), or
    (None, None) when the asset is absent (relocalisation is then
    unavailable).  The arrays are shared between callers: read them only."""
    path = os.path.abspath(_ASSET)
    if not os.path.exists(path):
        return None, None
    with np.load(path) as f:
        vocab = f["vocab"]
        idf = f["idf"].astype(np.float32) if "idf" in f.files else None
    return vocab, idf
