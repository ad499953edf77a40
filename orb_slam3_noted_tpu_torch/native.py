"""Runtime support under the JAX package's ``native`` names (port of
:mod:`orb_slam3_noted_tpu.native`): stage timers, and the port's image
reader and prefetcher.

The JAX package keeps these in C++ (``native/slamrt.cpp``) beside its
compute path.  Here a ``StageTimer`` keeps a span of the port's recorder
(:mod:`.utils.timing`) from each ``start`` to its ``stop``, and the reader
and prefetcher are :mod:`.io.images`' (``read_gray`` and ``Prefetcher``)
under the names ``load_image_gray`` and ``PrefetchingLoader``.
"""

from __future__ import annotations

import numpy as np

from orb_slam3_noted_tpu_torch.io.images import Prefetcher, read_gray
from orb_slam3_noted_tpu_torch.utils.timing import Recorder, _clock

__all__ = ["StageTimer", "load_image_gray", "PrefetchingLoader"]


def load_image_gray(path: str, max_hw=(2048, 2048)) -> np.ndarray:
    """A PNG (gray, GA, RGB, RGBA) or binary PGM as (H, W) uint8 gray;
    larger than ``max_hw`` (height, width) raises, as the native decoder's
    buffer does."""
    img = read_gray(path)
    if img.shape[0] * img.shape[1] > max_hw[0] * max_hw[1]:
        raise IOError(f"{path}: {img.shape} does not fit a {max_hw} buffer")
    return img


class PrefetchingLoader(Prefetcher):
    """Ordered multi-threaded frame prefetcher over a path list, every frame
    (``height``, ``width``) uint8 gray (a frame of another size raises)."""

    def __init__(self, paths, width, height, n_buffers=8, n_threads=2):
        super().__init__(paths, n_buffers=n_buffers, n_threads=n_threads)
        self.width, self.height, self.n = width, height, len(self.paths)

    def get(self, idx: int) -> np.ndarray:
        img = super().get(idx)
        if img.shape != (self.height, self.width):
            raise IOError(f"frame {idx}: {img.shape}, expected {(self.height, self.width)}")
        return img


class StageTimer:
    """Per-stage wall timers (REGISTER_TIMES): a span of a recorder of its
    own from each ``start`` to its ``stop``, kept whether or not recorders
    are on; dumpable to a file in the native library's format."""

    def __init__(self):
        self.recorder = Recorder()
        self._open: dict = {}  # name -> start stamp of the open span

    def start(self, name: str):
        self._open[name] = _clock()

    def stop(self, name: str):
        now = _clock()
        t0 = self._open.pop(name, None)
        if t0 is None:
            raise ValueError(f"timer {name!r} stopped before it started")
        self.recorder.add(name, t0, now)

    def dump(self, path: str):
        """Writes ``name mean_ms max_ms count`` lines, names in order
        (``slamrt_timer_dump``'s format)."""
        lines = [f"{name} {sum(ms) / len(ms):.3f} {max(ms):.3f} {len(ms)}\n"
                 for name, ms in sorted(self.recorder.durations_ms().items())]
        with open(path, "w") as f:
            f.writelines(lines)
