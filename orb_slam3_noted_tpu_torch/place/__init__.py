"""Place recognition (port of :mod:`orb_slam3_noted_tpu.place`).

A flat bank of W binary words: a frame's transform is one product of
unpacked bits (descriptor bits x word bits -> Hamming argmin), and scoring a
query against every keyframe is one pass over a dense (KF, W) matrix of BoW
vectors that lives on the device.
"""

from orb_slam3_noted_tpu_torch.place.vocab import (  # noqa: F401
    train_vocabulary,
    transform,
    bow_vector,
)
from orb_slam3_noted_tpu_torch.place.database import KeyFrameDatabase  # noqa: F401
