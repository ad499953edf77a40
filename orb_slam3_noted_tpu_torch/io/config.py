"""Typed SLAM configuration (port of :mod:`orb_slam3_noted_tpu.io.config`).

The same frozen dataclass as the JAX package, with the port's ``Camera``;
``imu_calib`` builds the port's IMU calibration from the IMU fields, and
:func:`config_from` takes any configuration with the same fields (the JAX
package's, for the parity tests), its cameras rebuilt as the port's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE


@dataclass(frozen=True)
class SlamConfig:
    # --- camera ---
    camera: Camera = Camera(PINHOLE, (458.654, 457.296, 367.215, 248.375))
    width: int = 752
    height: int = 480
    fps: float = 20.0
    bf: float = 0.0                  # baseline x fx (stereo), reference "Camera.bf"
    th_depth: float = 35.0           # close/far stereo point threshold ("ThDepth")
    dist_coeffs: tuple = ()          # rad-tan (k1,k2,p1,p2[,k3]); empty = none

    # --- second camera (non-rectified fisheye stereo) ---
    camera2: Camera | None = None    # right camera model (KB8 for TUM-VI)
    tlr_r: tuple = ()                # 9 floats row-major Rlr (right in left)
    tlr_t: tuple = (0.0, 0.0, 0.0)   # tlr (right cam origin in left frame)
    lapping_l: tuple = (0.0, 1e9)    # (Camera.lappingBegin, Camera.lappingEnd)
    lapping_r: tuple = (0.0, 1e9)    # (Camera2.lappingBegin, Camera2.lappingEnd)

    # --- ORB extractor (reference YAML ORBextractor.*) ---
    n_features: int = 1200
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0

    # --- map capacities (static shapes) ---
    max_keyframes: int = 256
    max_map_points: int = 16384

    # --- tracking policy ---
    min_tracked_points: int = 15     # lost below this
    kf_min_interval: int = 0         # min frames between KFs
    kf_max_interval: int = 30        # force KF after this many frames
    kf_tracked_ratio: float = 0.9    # new KF when tracked < ratio * ref visible
    local_window: int = 10           # covisible KFs for local map / local BA
    triangulate_neighbors: int = 10  # covisible KFs matched for new points
    retrack_after_kf: bool = False
    ba_iters: int = 4                # robust LM iterations in local BA
    ba_iters_final: int = 3          # post-outlier-reclassify iterations

    # --- matching ---
    nn_ratio_track: float = 0.9
    search_radius_px: float = 15.0

    # --- loop closing ---
    enable_loop_closing: bool = False
    vocab_words: int = 1024
    loop_min_inliers: int = 25

    # --- IMU (reference YAML IMU.*) ---
    imu_rbc: tuple = ()              # 9 floats row-major Rbc; empty = identity
    imu_tbc: tuple = (0.0, 0.0, 0.0)
    imu_noise_gyro: float = 1.7e-4   # continuous noise densities
    imu_noise_acc: float = 2.0e-3
    imu_walk_gyro: float = 1.9e-5
    imu_walk_acc: float = 3.0e-3
    imu_freq: float = 200.0
    imu_init_time: float = 2.0       # seconds of KFs before first init
    imu_viba1_time: float = 5.0      # VIBA1 refinement
    imu_viba2_time: float = 15.0     # VIBA2 refinement
    imu_init_min_kfs: int = 6
    inertial_window: int = 10        # temporal KFs in LocalInertialBA (Nd)

    @property
    def level_sigma2(self):
        return tuple(
            (self.scale_factor ** (2 * i)) for i in range(self.n_levels)
        )

    def imu_calib(self, dtype=torch.float32, device=None):
        """The IMU calibration with discrete per-sample variances, on
        ``device`` (the CPU unless named).

        The reference multiplies continuous densities by sqrt(freq) when
        constructing ``IMU::Calib`` (`src/Tracking.cc:1186-1192`), i.e. the
        per-sample variance is density^2 * freq.
        """
        from orb_slam3_noted_tpu_torch.imu.preintegration import Calib

        t = lambda v: torch.tensor(v, dtype=dtype, device=device)
        Rbc = t(self.imu_rbc).reshape(3, 3) if self.imu_rbc else torch.eye(
            3, dtype=dtype, device=device)
        f = self.imu_freq
        return Calib(
            Rbc=Rbc,
            tbc=t(self.imu_tbc),
            cov_ng=t(self.imu_noise_gyro ** 2 * f),
            cov_na=t(self.imu_noise_acc ** 2 * f),
            cov_walk_g=t(self.imu_walk_gyro ** 2 / f),
            cov_walk_a=t(self.imu_walk_acc ** 2 / f),
        )


def config_from(other) -> SlamConfig:
    """A :class:`SlamConfig` with every field of ``other``, a configuration
    of the same fields (the second camera, its extrinsic and the lapping
    areas included); a camera is rebuilt from its ``kind`` and ``params``."""
    def field(name):
        v = getattr(other, name)
        if name in ("camera", "camera2") and v is not None:
            return Camera(int(v.kind), tuple(float(p) for p in v.params))
        return v

    return SlamConfig(**{f.name: field(f.name) for f in dataclasses.fields(SlamConfig)})
