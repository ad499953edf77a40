"""Dataset loaders (EuRoC, TUM-VI, TUM RGB-D, KITTI) and stereo
rectification (port of :mod:`orb_slam3_noted_tpu.io.datasets`).

The loaders are the JAX package's, in numpy: timestamps from the datasets'
csv / txt files (EuRoC ``int(ns) * 1e-9`` in float64), image paths, IMU
rows, ground truth and the RGB-D association.  :meth:`Sequence.read`
decodes through the port's reader and prefetcher (:mod:`.images`) only:
8-bit gray images as uint8, TUM RGB-D depth in metres as float32.

Rectification follows the stereo example drivers: :func:`make_rectify_maps`
is the arithmetic of ``cv2.initUndistortRectifyMap`` in float64 numpy (the
inverse of ``P[:3, :3] @ R``, rad-tan distortion, then ``K``), cast to
float32; :func:`rectify` is ``cv2.remap(..., INTER_LINEAR)`` on the device,
with OpenCV 5's arithmetic and 0 outside the image.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.io import images


@dataclass
class ImuData:
    t: np.ndarray    # (N,) seconds
    gyr: np.ndarray  # (N, 3)
    acc: np.ndarray  # (N, 3)

    def between(self, t0: float, t1: float) -> "ImuData":
        """Measurements with t0 < t <= t1 (the reference batches (prev, cur])."""
        m = (self.t > t0) & (self.t <= t1)
        return ImuData(self.t[m], self.gyr[m], self.acc[m])


@dataclass
class Sequence:
    timestamps: np.ndarray            # (F,) seconds, float64
    left_paths: list
    right_paths: list | None = None
    imu: ImuData | None = None
    gt_t: np.ndarray | None = None    # ground-truth timestamps
    gt_pos: np.ndarray | None = None  # (G, 3)
    depth_paths: list | None = None   # RGB-D: the registered depth image per frame
    depth_factor: float = 5000.0      # TUM RGB-D 16-bit depth scale (m = value / factor)
    _loaders: dict = field(default_factory=dict, repr=False)

    def __len__(self):
        return len(self.timestamps)

    def _loader(self, name, paths, read):
        if name not in self._loaders:
            self._loaders[name] = images.Prefetcher(paths, read, n_buffers=8, n_threads=2)
        return self._loaders[name]

    def read(self, i: int):
        """Frame i: (H, W) uint8 gray; a stereo sequence gives (left, right),
        an RGB-D one (gray, depth in metres as float32)."""
        left = self._loader("left", self.left_paths, images.read_gray).get(i)
        if self.depth_paths is not None:
            d = self._loader("depth", self.depth_paths, images.read_depth16).get(i)
            return left, d.astype(np.float32) / self.depth_factor
        if self.right_paths is not None:
            return left, self._loader("right", self.right_paths, images.read_gray).get(i)
        return left

    def close(self):
        """Stop the prefetchers' threads."""
        for pf in self._loaders.values():
            pf.close()
        self._loaders.clear()


def _load_euroc_cam(seq_dir: str, cam: str):
    ts, paths = [], []
    with open(os.path.join(seq_dir, "mav0", cam, "data.csv")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.strip().split(",")
            ts.append(int(parts[0]) * 1e-9)
            paths.append(os.path.join(seq_dir, "mav0", cam, "data", parts[1].strip()))
    return np.asarray(ts), paths


def load_euroc(seq_dir: str, stereo: bool = True, with_imu: bool = True) -> Sequence:
    """EuRoC MAV layout: mav0/cam0, cam1, imu0, state_groundtruth_estimate0."""
    ts, left = _load_euroc_cam(seq_dir, "cam0")
    right = None
    if stereo:
        ts1, right = _load_euroc_cam(seq_dir, "cam1")
        # the frames both cameras have (the reference assumes synchronised streams)
        common = np.intersect1d(ts, ts1)
        keep0, keep1 = np.isin(ts, common), np.isin(ts1, common)
        left = [p for p, k in zip(left, keep0) if k]
        right = [p for p, k in zip(right, keep1) if k]
        ts = ts[keep0]

    imu = None
    imu_csv = os.path.join(seq_dir, "mav0", "imu0", "data.csv")
    if with_imu and os.path.exists(imu_csv):
        raw = np.loadtxt(imu_csv, delimiter=",", comments="#", ndmin=2)
        imu = ImuData(t=raw[:, 0] * 1e-9, gyr=raw[:, 1:4], acc=raw[:, 4:7])

    gt_t = gt_pos = None
    gt_csv = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        raw = np.loadtxt(gt_csv, delimiter=",", comments="#", ndmin=2)
        gt_t, gt_pos = raw[:, 0] * 1e-9, raw[:, 1:4]
    return Sequence(ts, left, right, imu, gt_t, gt_pos)


def load_tum_vi(seq_dir: str, stereo: bool = True, with_imu: bool = True) -> Sequence:
    """TUM-VI has the same mav0/ layout as EuRoC."""
    return load_euroc(seq_dir, stereo=stereo, with_imu=with_imu)


def _read_tum_list(path):
    """A TUM RGB-D index file: ``timestamp filename`` per line."""
    ts, files = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.strip().split()
            ts.append(float(parts[0]))
            files.append(parts[1])
    return np.asarray(ts), files


def associate(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-neighbour timestamp association within ``max_dt``
    (reference ``evaluation/associate.py``); (idx_a, idx_b) of the pairs."""
    ia, ib = [], []
    used = np.zeros(len(t_b), bool)
    for i, ta in enumerate(t_a):
        j = int(np.searchsorted(t_b, ta))
        best, bd = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(t_b) and not used[k]:
                d = abs(t_b[k] - ta)
                if d < bd:
                    best, bd = k, d
        if best >= 0:
            used[best] = True
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, int), np.asarray(ib, int)


def load_tum_rgbd(seq_dir: str, depth_factor: float = 5000.0) -> Sequence:
    """TUM RGB-D layout: rgb.txt, depth.txt, groundtruth.txt; the rgb and
    depth streams are associated by timestamp."""
    t_rgb, rgb_files = _read_tum_list(os.path.join(seq_dir, "rgb.txt"))
    t_d, d_files = _read_tum_list(os.path.join(seq_dir, "depth.txt"))
    ia, ib = associate(t_rgb, t_d)
    gt_t = gt_pos = None
    gt_file = os.path.join(seq_dir, "groundtruth.txt")
    if os.path.exists(gt_file):
        raw = np.loadtxt(gt_file, comments="#", ndmin=2)
        gt_t, gt_pos = raw[:, 0], raw[:, 1:4]
    return Sequence(
        t_rgb[ia], [os.path.join(seq_dir, rgb_files[i]) for i in ia], None, None, gt_t, gt_pos,
        depth_paths=[os.path.join(seq_dir, d_files[i]) for i in ib], depth_factor=depth_factor,
    )


def load_kitti(seq_dir: str, stereo: bool = True) -> Sequence:
    """KITTI odometry layout: image_0/, image_1/, times.txt."""
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"), ndmin=1)

    def pngs(d):
        return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".png")]

    left = pngs(os.path.join(seq_dir, "image_0"))
    right_dir = os.path.join(seq_dir, "image_1")
    right = pngs(right_dir) if stereo and os.path.isdir(right_dir) else None
    return Sequence(times, left, right)


# ---------------------------------------------------------------------------
# rectification

def make_rectify_maps(rect: dict, size_hw=None):
    """((map1x, map1y), (map2x, map2y)) float32 from the LEFT/RIGHT blocks of
    :func:`..yaml_compat.load_stereo_rectification`: for each rectified
    pixel, the raw pixel it samples (``cv2.initUndistortRectifyMap`` with
    ``P[:3, :3]`` as the new camera matrix, computed in float64)."""
    out = []
    for side in ("LEFT", "RIGHT"):
        blk = rect[side]
        h = size_hw[0] if size_hw else blk["height"]
        w = size_hw[1] if size_hw else blk["width"]
        K = np.asarray(blk["K"], np.float64).reshape(3, 3)
        d = np.zeros(8)
        dist = np.asarray(blk["D"], np.float64).reshape(-1)
        d[:min(dist.size, 8)] = dist[:8]
        k1, k2, p1, p2, k3, k4, k5, k6 = d
        iR = np.linalg.inv(np.asarray(blk["P"], np.float64)[:3, :3]
                           @ np.asarray(blk["R"], np.float64).reshape(3, 3))
        j, i = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        X = j * iR[0, 0] + i * iR[0, 1] + iR[0, 2]
        Y = j * iR[1, 0] + i * iR[1, 1] + iR[1, 2]
        Wh = j * iR[2, 0] + i * iR[2, 1] + iR[2, 2]
        x, y = X / Wh, Y / Wh
        x2, y2, r2, xy2 = x * x, y * y, x * x + y * y, 2 * x * y
        kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
        u = K[0, 0] * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + K[0, 2]
        v = K[1, 1] * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + K[1, 2]
        out.append((u.astype(np.float32), v.astype(np.float32)))
    return out


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def rectify(img: torch.Tensor, maps) -> torch.Tensor:
    """``cv2.remap(img, mapx, mapy, INTER_LINEAR)`` with a constant 0 border,
    on ``img``'s device.  ``img``: (H, W) uint8 or float32; ``maps``:
    (mapx, mapy) float32 tensors of the output's shape.

    OpenCV 5's arithmetic: the sample at its exact position, two fused
    multiply-adds along x and one along y in float32 (a uint8 image is
    interpolated so and rounded half to even), neighbours outside the image
    read as 0.  (OpenCV 4 rounded positions to 1/32 px with fixed-point
    weights; the JAX package's CLI runs whatever ``cv2`` is installed.)"""
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"rectify: uint8 or float32 images, not {img.dtype}")
    mapx, mapy = maps
    H, W = img.shape
    fx0, fy0 = torch.floor(mapx), torch.floor(mapy)
    wx, wy = mapx - fx0, mapy - fy0
    x0, y0 = fx0.to(torch.int64), fy0.to(torch.int64)
    flat = img.reshape(-1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)

    def tap(dy, dx):
        xx, yy = x0 + dx, y0 + dy
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        return torch.where(inside, flat[yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)], zero)

    s00, s01, s10, s11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = _fma(s01 - s00, wx, s00)
    bottom = _fma(s11 - s10, wx, s10)
    out = _fma(bottom - top, wy, top)
    if img.dtype == torch.uint8:
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    return out
