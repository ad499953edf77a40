"""Image files: the port's PNG / PGM reader and writer and an ordered
prefetcher.

Takes the place of the JAX package's native decoder and prefetcher
(``native/slamrt.cpp``, ``native/__init__.py``) and of its ``cv2``
fallbacks, so that the port reads datasets on a machine without ``cv2``:

- :func:`read_gray`: 8-bit gray, gray+alpha, RGB and RGBA PNG, and binary
  PGM (P5), to (H, W) uint8 gray; colour goes to gray by BT.601 luma in
  integers, as the native decoder does (within one grey level of
  ``cv2.imread(..., IMREAD_GRAYSCALE)``);
- :func:`read_depth16`: a 16-bit gray PNG (TUM RGB-D depth) to (H, W)
  uint16;
- :func:`decode_png`: the bytes of a PNG to its samples, colour kept;
- :func:`encode_png` / :func:`write_png`: 8-bit gray or RGB, or 16-bit
  gray, to bytes or to a file;
- :class:`Prefetcher`: frames decoded ahead in a thread pool, handed out in
  order.

The IDAT stream is inflated with the standard library's ``zlib``; the row
work (unfiltering, colour to gray, the 16-bit byte order) is host C++,
``csrc/png_rows.cpp``, compiled with ``g++`` into ``build/`` at the
repository root at first use and called through ``ctypes``.  A failed build
or a malformed file raises: there is no second reader.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import functools
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "png_rows.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libpng_rows_{h.hexdigest()[:16]}.so"


@functools.cache
def _library() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
    lib = ctypes.CDLL(str(so))
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.png_unfilter.argtypes = [p, l, i, l, i, p]
    lib.pixels_to_gray8.argtypes = [p, l, i, p]
    lib.be16_to_u16.argtypes = [p, l, p]
    for f in (lib.png_unfilter, lib.pixels_to_gray8, lib.be16_to_u16):
        f.restype = ctypes.c_int
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------------------------------------------------------------------
# reading

def _png_pixels(data: bytes, path) -> tuple[np.ndarray, int, int]:
    """(H, W * channels * bytes) unfiltered sample bytes, channels, bit depth."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, hdr, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if hdr is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace != 0 or w == 0 or h == 0:
        raise ValueError(f"{path}: unsupported PNG (colour type {ctype}, bit depth {depth}, "
                         f"interlace {interlace}); 8/16-bit gray, GA, RGB, RGBA only")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt IDAT stream ({e})") from None
    out = np.empty((h, w * bpp), np.uint8)
    rc = _library().png_unfilter(_ptr(raw), raw.size, h, w * bpp, bpp, _ptr(out))
    if rc != 0:
        raise ValueError(f"{path}: bad PNG rows (code {rc})")
    return out, ch, depth


def _read_pgm(data: bytes, path) -> np.ndarray:
    """Binary 8-bit PGM (P5), comments allowed in the header."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: truncated PGM header")
        fields.append(int(data[start:pos]))
    w, h, maxval = fields
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PGM is not supported")
    pix = np.frombuffer(data, np.uint8, count=w * h, offset=pos + 1)
    return pix.reshape(h, w).copy()


def read_gray(path) -> np.ndarray:
    """An 8-bit PNG (gray, GA, RGB, RGBA) or a binary PGM as (H, W) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P5":
        return _read_pgm(data, path)
    pix, ch, depth = _png_pixels(data, path)
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; read_gray takes 8-bit images")
    h, w = pix.shape[0], pix.shape[1] // ch
    out = np.empty((h, w), np.uint8)
    _library().pixels_to_gray8(_ptr(pix), h * w, ch, _ptr(out))
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The samples of an 8-bit PNG as they are stored, (H, W) for gray and
    (H, W, channels) uint8 otherwise (no conversion to gray), or of a
    16-bit gray PNG as (H, W) uint16."""
    pix, ch, depth = _png_pixels(data, "PNG bytes")
    h = pix.shape[0]
    if depth == 16:
        if ch != 1:
            raise ValueError(f"decode_png: 16-bit PNG with {ch} channels; 16-bit gray only")
        out = np.empty((h, pix.shape[1] // 2), np.uint16)
        _library().be16_to_u16(_ptr(pix), out.size, _ptr(out))
        return out
    return pix.reshape(h, -1) if ch == 1 else pix.reshape(h, -1, ch)


def read_depth16(path) -> np.ndarray:
    """A 16-bit gray PNG (TUM RGB-D depth) as (H, W) uint16."""
    with open(path, "rb") as f:
        data = f.read()
    pix, ch, depth = _png_pixels(data, path)
    if ch != 1 or depth != 16:
        raise ValueError(f"{path}: read_depth16 takes 16-bit gray PNG ({ch} channels, "
                         f"{depth} bits)")
    out = np.empty((pix.shape[0], pix.shape[1] // 2), np.uint16)
    _library().be16_to_u16(_ptr(pix), out.size, _ptr(out))
    return out


# ---------------------------------------------------------------------------
# writing

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W) uint8 gray, (H, W, 3) uint8 RGB or (H, W) uint16 gray as the
    bytes of a PNG file (filter 0 on every row, zlib ``level``)."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth, rows = 0, 8, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth, rows = 2, 8, img.reshape(img.shape[0], -1)
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth, rows = 0, 16, img.astype(">u2").view(np.uint8)
    else:
        raise ValueError(f"encode_png: {img.dtype} {img.shape}; uint8 gray or RGB, or uint16 gray")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return b"".join((
        PNG_SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(np.ascontiguousarray(raw).tobytes(), level)),
        _chunk(b"IEND", b""),
    ))


def write_png(path, img: np.ndarray, level: int = 1) -> None:
    """Write ``img`` to ``path`` as PNG (see :func:`encode_png`)."""
    data = encode_png(img, level)
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# prefetching

class Prefetcher:
    """Decode ``read(paths[i])`` ahead of the caller in ``n_threads``
    threads, at most ``n_buffers`` frames ahead, and hand the frames out in
    order (``get(i)``).  A ``get`` out of order restarts the window there.
    zlib and the row library release the interpreter lock, so the threads
    decode side by side.  Close it (or use it as a context manager) to stop
    its threads."""

    def __init__(self, paths, read=read_gray, n_buffers: int = 8, n_threads: int = 2):
        self.paths = list(paths)
        self._read = read
        self._n_buffers = n_buffers
        self._pool = cf.ThreadPoolExecutor(max_workers=n_threads,
                                           thread_name_prefix="prefetch")
        self._pending: dict = {}
        self._next = 0
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.paths)

    def get(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self.paths):
            raise IndexError(f"frame {i} of {len(self.paths)}")
        with self._lock:
            if i not in self._pending:
                for fut in self._pending.values():
                    fut.cancel()
                self._pending.clear()
                self._next = i
            for k in [k for k in self._pending if k < i]:  # frames skipped over
                self._pending.pop(k).cancel()
            while self._next < min(i + self._n_buffers, len(self.paths)):
                self._pending[self._next] = self._pool.submit(self._read, self.paths[self._next])
                self._next += 1
            fut = self._pending.pop(i)
        return fut.result()

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._pending.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
