"""Runtime support under the JAX package's ``native`` names (port of
:mod:`orb_slam3_noted_tpu.native`): stage timers, and the port's image
reader and prefetcher.

The JAX package keeps these in C++ (``native/slamrt.cpp``) beside its
compute path.  Here each ``StageTimer`` is a Python object, thread-safe
under its own lock, and the reader and prefetcher are :mod:`.io.images`'
(``read_gray`` and ``Prefetcher``) under the names ``load_image_gray`` and
``PrefetchingLoader``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from orb_slam3_noted_tpu_torch.io.images import Prefetcher, read_gray

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
    """Per-stage wall timers (REGISTER_TIMES), thread-safe, dumpable to a
    file in the native library's format."""

    def __init__(self):
        self._lock = threading.Lock()
        self._acc: dict = {}  # name -> [total_ms, max_ms, count, start]

    def start(self, name: str):
        with self._lock:
            self._acc.setdefault(name, [0.0, 0.0, 0, None])[3] = time.perf_counter()

    def stop(self, name: str):
        now = time.perf_counter()
        with self._lock:
            a = self._acc.get(name)
            if a is None or a[3] is None:
                raise ValueError(f"timer {name!r} stopped before it started")
            ms = (now - a[3]) * 1e3
            a[0] += ms
            a[1] = max(a[1], ms)
            a[2] += 1

    def dump(self, path: str):
        """Writes ``name mean_ms max_ms count`` lines, names in order
        (``slamrt_timer_dump``'s format)."""
        with self._lock:
            lines = [f"{name} {total / count if count else 0.0:.3f} {mx:.3f} {count}\n"
                     for name, (total, mx, count, _) in sorted(self._acc.items())]
        with open(path, "w") as f:
            f.writelines(lines)
