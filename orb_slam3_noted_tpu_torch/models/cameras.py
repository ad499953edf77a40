"""Pin-hole camera model (port of :mod:`orb_slam3_noted_tpu.models.cameras`).

Batched projection, unprojection and the analytic projection Jacobian on
tensors with a leading batch shape.  The Kannala-Brandt model waits for the
fisheye slice (ROADMAP, next steps 4); asking for it raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

PINHOLE = 0
KANNALA_BRANDT8 = 1


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
        return torch.tensor(self.params, dtype=dtype, device=device)


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


def _pinhole_only(cam: Camera):
    if cam.kind != PINHOLE:
        raise NotImplementedError(
            "Kannala-Brandt cameras wait for the fisheye slice "
            "(ROADMAP, next steps 4)"
        )


def project(cam: Camera, x: torch.Tensor) -> torch.Tensor:
    _pinhole_only(cam)
    return pinhole_project(cam.params_array(x.dtype, x.device), x)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    _pinhole_only(cam)
    return pinhole_unproject(cam.params_array(uv.dtype, uv.device), uv)


def project_jac(cam: Camera, x: torch.Tensor) -> torch.Tensor:
    _pinhole_only(cam)
    return pinhole_project_jac(cam.params_array(x.dtype, x.device), x)
