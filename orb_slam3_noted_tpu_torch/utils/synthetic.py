"""Synthetic textured-room renderer (port of :mod:`orb_slam3_noted_tpu.utils.synthetic`).

The reference validates only on recorded datasets (EuRoC/TUM-VI); this
repository additionally needs hermetic end-to-end tests (SURVEY §4), so we
render a camera moving inside a texture-mapped box room: three visible
planes (back wall, floor, side wall) with high-frequency random textures,
ray-cast per pixel with bilinear texture sampling.  Non-planar scene
geometry keeps two-view initialization well-conditioned.

Pure numpy (host-side test harness); only the pose helpers call the port's
``so3`` on CPU float32 tensors, as the JAX package calls its own.  The
Kannala-Brandt renderer waits for the fisheye slice (ROADMAP, next steps 4).
"""

from __future__ import annotations

import numpy as np


class BoxRoom:
    """Axis-aligned textured room. World frame: x right, y down, z forward.

    Planes: back wall z = depth; floor y = +h; side wall x = +w.
    """

    def __init__(self, seed=0, depth=8.0, h=1.5, w=3.0, tex_size=2048, tex_scale=80.0):
        rng = np.random.default_rng(seed)
        self.depth, self.h, self.w = depth, h, w
        self.tex_scale = tex_scale  # texels per world unit

        def make_tex():
            # multi-octave noise: realistic image statistics (power at several
            # scales) so descriptors stay stable under view-dependent
            # resampling — pure white noise aliases badly and kills matching
            t = np.zeros((tex_size, tex_size), np.float32)
            for octave, amp in [(4, 0.2), (16, 0.5), (64, 1.0), (256, 0.6)]:
                coarse = rng.uniform(-1, 1, size=(octave, octave)).astype(np.float32)
                reps = tex_size // octave
                up = np.kron(coarse, np.ones((reps, reps), np.float32))
                # smooth the blocky upsample
                k = max(reps // 2, 1)
                for ax in (0, 1):
                    up = (
                        np.roll(up, k, ax) + 2.0 * up + np.roll(up, -k, ax)
                    ) * 0.25
                t += amp * up
            t -= t.min()
            t *= 255.0 / max(t.max(), 1e-6)
            return t

        self.tex = [make_tex() for _ in range(3)]

    def _sample(self, tex, u, v):
        ts = tex.shape[0]
        u = np.mod(u * self.tex_scale, ts - 1.001)
        v = np.mod(v * self.tex_scale, ts - 1.001)
        u0 = np.floor(u).astype(np.int64)
        v0 = np.floor(v).astype(np.int64)
        fu = u - u0
        fv = v - v0
        return (
            tex[v0, u0] * (1 - fu) * (1 - fv)
            + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv
            + tex[v0 + 1, u0 + 1] * fu * fv
        )

    def render(
        self, Rwc: np.ndarray, twc: np.ndarray, cam_params, width, height,
        return_depth: bool = False,
    ):
        """Render a grayscale image for camera-to-world pose (Rwc, twc).

        cam_params = (fx, fy, cx, cy) pinhole.  With ``return_depth``, also
        returns the per-pixel camera-frame z depth (rays have z_c = 1, so the
        plane-intersection parameter is the depth).
        """
        fx, fy, cx, cy = cam_params[:4]
        xs = (np.arange(width, dtype=np.float64) - cx) / fx
        ys = (np.arange(height, dtype=np.float64) - cy) / fy
        gx, gy = np.meshgrid(xs, ys)
        dirs_c = np.stack([gx, gy, np.ones_like(gx)], axis=-1)  # (H, W, 3)
        return self._render_dirs(Rwc, twc, dirs_c, return_depth)

    def _render_dirs(self, Rwc, twc, dirs_c, return_depth):
        height, width = dirs_c.shape[:2]
        dirs_w = dirs_c @ Rwc.T  # rotate to world
        o = twc

        best_t = np.full((height, width), np.inf)
        img = np.zeros((height, width), np.float32)

        planes = [
            # (axis, value, texture, uv axes)
            (2, self.depth, self.tex[0], (0, 1)),  # back wall: uv = (x, y)
            (1, self.h, self.tex[1], (0, 2)),      # floor: uv = (x, z)
            (0, self.w, self.tex[2], (1, 2)),      # side wall: uv = (y, z)
        ]
        for axis, val, tex, (ua, va) in planes:
            d_ax = dirs_w[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (val - o[axis]) / d_ax
            valid = (t > 0.05) & np.isfinite(t) & (t < best_t)
            # rays parallel to the plane give t = +-inf -> inf * 0 = nan in
            # the hit coordinates; clamp them before texture sampling
            t_safe = np.where(valid, t, 0.0)
            hitu = o[ua] + t_safe * dirs_w[..., ua]
            hitv = o[va] + t_safe * dirs_w[..., va]
            shade = self._sample(tex, hitu, hitv)
            img = np.where(valid, shade, img)
            best_t = np.where(valid, t, best_t)
        if return_depth:
            return img.astype(np.float32), best_t.astype(np.float32)
        return img.astype(np.float32)


def stereo_pair(room: BoxRoom, Rwc, twc, cam_params, width, height, baseline):
    """Render a rectified stereo pair: right camera shifted by +baseline in x."""
    left, depth = room.render(Rwc, twc, cam_params, width, height, return_depth=True)
    twc_r = twc + Rwc @ np.array([baseline, 0.0, 0.0])
    right = room.render(Rwc, twc_r, cam_params, width, height)
    return left, right, depth


def orbit_trajectory(n_frames, radius=0.8, forward=0.015, seed=1, yaw0=0.0):
    """Camera-to-world poses: gentle lateral arc + forward motion + yaw.

    ``yaw0`` aims the camera off the room axis (toward a corner) so several
    planes share the view — a plane-dominated view is a known-degenerate
    monocular initialization case (Faugeras conjugate ambiguity).
    """
    import torch

    from orb_slam3_noted_tpu_torch.geometry import so3

    poses = []
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        twc = np.array(
            [radius * np.sin(0.8 * s), 0.15 * np.sin(1.7 * s), forward * i]
        )
        yaw = yaw0 + 0.12 * np.sin(2.1 * s)
        pitch = 0.04 * np.sin(1.3 * s + 0.5)
        Rwc = so3.exp(torch.tensor([pitch, yaw, 0.0], dtype=torch.float32)).numpy()
        poses.append((Rwc, twc))
    return poses


def smooth_pose(t, yaw0=0.45):
    """Twice-differentiable camera-to-world pose at time ``t`` (seconds).

    Used to synthesize consistent frames AND inertial measurements
    (:func:`synth_imu`) for visual-inertial benchmarks/tests — the analogue
    of an EuRoC hand-held trajectory segment.  The world is gravity-aligned
    (gravity = -z); the body frame coincides with the camera frame.
    """
    import torch

    from orb_slam3_noted_tpu_torch.geometry import so3

    twc = np.array([
        0.45 * np.sin(0.55 * t),
        0.12 * np.sin(1.1 * t),
        0.14 * t + 0.05 * np.sin(0.9 * t),
    ])
    yaw = yaw0 + 0.10 * np.sin(0.7 * t)
    pitch = 0.05 * np.sin(0.5 * t + 0.5)
    roll = 0.03 * np.sin(0.8 * t)
    Rwc = so3.exp(torch.tensor([pitch, yaw, roll], dtype=torch.float32)).numpy()
    return Rwc, twc


def synth_imu(t0, t1, hz=200.0, yaw0=0.45, gravity=9.81):
    """Exact body-frame IMU samples for :func:`smooth_pose` over (t0, t1].

    Central finite differences of the analytic trajectory; accelerometer
    includes the reaction to gravity (the estimator must discover the
    world's gravity direction).  Returns (acc (M, 3), gyr (M, 3), ts (M,)).
    """
    import torch

    from orb_slam3_noted_tpu_torch.geometry import so3

    g = np.array([0.0, 0.0, -gravity])
    eps = 1e-4
    ts = np.arange(np.ceil(t0 * hz), np.floor(t1 * hz) + 1) / hz
    ts = ts[(ts > t0 + 1e-12) & (ts <= t1 + 1e-12)]
    acc, gyr = [], []
    for t in ts:
        Rwb, p = smooth_pose(t, yaw0)
        _, pp = smooth_pose(t + eps, yaw0)
        _, pm = smooth_pose(t - eps, yaw0)
        a_w = (pp - 2 * p + pm) / (eps * eps)
        Rwb_p, _ = smooth_pose(t + eps, yaw0)
        w_b = so3.log(torch.from_numpy(Rwb.T @ Rwb_p)).numpy() / eps
        acc.append(Rwb.T @ (a_w - g))
        gyr.append(w_b)
    return (np.asarray(acc).reshape(-1, 3), np.asarray(gyr).reshape(-1, 3),
            ts)
