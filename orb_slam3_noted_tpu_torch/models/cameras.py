"""Pin-hole and Kannala-Brandt fisheye camera models (port of
:mod:`orb_slam3_noted_tpu.models.cameras`).

Batched projection, unprojection and the analytic projection Jacobian on
tensors with a leading batch shape.  ``KannalaBrandt8`` is the equidistant
fisheye r(theta) = theta + k0 theta^3 + k1 theta^5 + k2 theta^7 + k3 theta^9;
its unprojection is a fixed-iteration Newton solve, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from orb_slam3_noted_tpu_torch.utils.interop import const_tensor

PINHOLE = 0
KANNALA_BRANDT8 = 1

# Newton iterations for KB8 unprojection (the reference iterates to 1e-6;
# 10 fixed iterations reach that for any realistic fisheye field of view)
_KB8_NEWTON_ITERS = 10


@dataclass(frozen=True)
class Camera:
    """Static camera description (hashable).

    params layout:
      PINHOLE:          (fx, fy, cx, cy)
      KANNALA_BRANDT8:  (fx, fy, cx, cy, k0, k1, k2, k3)
    """

    kind: int
    params: tuple  # python floats, static

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[1]

    @property
    def cx(self):
        return self.params[2]

    @property
    def cy(self):
        return self.params[3]

    def params_array(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The parameters on ``device``: one shared read-only tensor."""
        return const_tensor(tuple(self.params), dtype, torch.device("cpu" if device is None else device))


def pinhole_project(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels. No cheirality check."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = x[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-12, 1e-12, z)
    u = fx * x[..., 0] * inv_z + cx
    v = fy * x[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels -> (..., 3) z=1 bearing rays."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    return torch.stack([mx, my, torch.ones_like(mx)], dim=-1)


def pinhole_project_jac(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(x): (..., 2, 3) analytic Jacobian."""
    fx, fy = params[0], params[1]
    z = x[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-12, 1e-12, z)
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(z)
    row0 = torch.stack([fx * inv_z, zero, -fx * x[..., 0] * inv_z2], dim=-1)
    row1 = torch.stack([zero, fy * inv_z, -fy * x[..., 1] * inv_z2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _kb8_poly(k, t2):
    """(1 + k0 t2 + k1 t2^2 + k2 t2^3 + k3 t2^4, its theta-derivative factor
    1 + 3 k0 t2 + 5 k1 t2^2 + 7 k2 t2^3 + 9 k3 t2^4), Horner form."""
    poly = 1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))
    dpoly = 1.0 + t2 * (3.0 * k[0] + t2 * (5.0 * k[1] + t2 * (7.0 * k[2] + t2 * 9.0 * k[3])))
    return poly, dpoly


def kb8_project(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels through the fisheye;
    points with z <= 0 project too (theta > 90 deg)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    r = torch.sqrt(X * X + Y * Y)
    theta = torch.atan2(r, Z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    inv_r = 1.0 / torch.where(r < 1e-12, 1e-12, r)
    # on the optical axis d / r -> 1 / Z; both branches are evaluated
    scale = torch.where(r < 1e-12, 1.0 / torch.where(Z.abs() < 1e-12, 1e-12, Z), d * inv_r)
    return torch.stack([fx * X * scale + cx, fy * Y * scale + cy], dim=-1)


def kb8_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels -> (..., 3) z=1 rays: Newton on d(theta) = rd from
    theta = rd, with rd clipped to pi/2 (the reference's theta-d bound)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    rd = torch.clamp(torch.sqrt(mx * mx + my * my), max=math.pi / 2.0)
    theta = rd
    for _ in range(_KB8_NEWTON_ITERS):
        poly, dpoly = _kb8_poly(k, theta * theta)
        theta = theta - (theta * poly - rd) / torch.where(dpoly.abs() < 1e-12, 1e-12, dpoly)
    scale = torch.tan(theta) / torch.where(rd < 1e-12, 1e-12, rd)
    scale = torch.where(rd < 1e-12, 1.0, scale)
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Analytic (..., 2, 3) Jacobian of :func:`kb8_project`:
    u = fx X d(theta) / r + cx with r^2 = X^2 + Y^2, theta = atan2(r, Z)."""
    fx, fy = params[0], params[1]
    k = params[4:8]
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    r2 = X * X + Y * Y
    r = torch.sqrt(torch.clamp(r2, min=1e-24))
    R2 = r2 + Z * Z
    theta = torch.atan2(r, Z)
    poly, dd = _kb8_poly(k, theta * theta)
    d = theta * poly
    # dtheta/dX = X Z / (r R2), dtheta/dY = Y Z / (r R2), dtheta/dZ = -r / R2
    inv_rR2 = 1.0 / (r * R2)
    inv_r = 1.0 / r
    g = d * inv_r
    inv_r2 = inv_r * inv_r
    dg_dX = (dd * (X * Z * inv_rR2) * r - d * (X * inv_r)) * inv_r2
    dg_dY = (dd * (Y * Z * inv_rR2) * r - d * (Y * inv_r)) * inv_r2
    dg_dZ = dd * (-r / R2) * inv_r
    row0 = torch.stack([fx * (g + X * dg_dX), fx * X * dg_dY, fx * X * dg_dZ], dim=-1)
    row1 = torch.stack([fy * Y * dg_dX, fy * (g + Y * dg_dY), fy * Y * dg_dZ], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def undistort_points_radtan(params: torch.Tensor, dist: torch.Tensor, uv: torch.Tensor,
                            iters: int = 8) -> torch.Tensor:
    """Undistort (..., 2) pixels under the rad-tan model, ``dist`` = (k1, k2,
    p1, p2, k3): ``iters`` fixed-point iterations, as ``cv::undistortPoints``
    in the reference's ``Frame::UndistortKeyPoints``."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


_PROJECT = {PINHOLE: pinhole_project, KANNALA_BRANDT8: kb8_project}
_UNPROJECT = {PINHOLE: pinhole_unproject, KANNALA_BRANDT8: kb8_unproject}
_PROJECT_JAC = {PINHOLE: pinhole_project_jac, KANNALA_BRANDT8: kb8_project_jac}


def project(cam: Camera, x: torch.Tensor) -> torch.Tensor:
    return _PROJECT[cam.kind](cam.params_array(x.dtype, x.device), x)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    return _UNPROJECT[cam.kind](cam.params_array(uv.dtype, uv.device), uv)


def project_jac(cam: Camera, x: torch.Tensor) -> torch.Tensor:
    return _PROJECT_JAC[cam.kind](cam.params_array(x.dtype, x.device), x)
