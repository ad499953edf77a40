"""Robust kernels (Huber) in IRLS form (port of :mod:`orb_slam3_noted_tpu.optim.robust`).

Thresholds as the reference passes them: sqrt(5.991) for 2-dof mono edges,
sqrt(7.815) for 3-dof stereo edges.
"""

from __future__ import annotations

import torch

CHI2_MONO = 5.991    # 95% quantile, chi2 with 2 dof
CHI2_STEREO = 7.815  # 95% quantile, chi2 with 3 dof
CHI2_TWOCAM = 9.488  # 95% quantile, chi2 with 4 dof (left+right fisheye pair)


def chi2_threshold(obs) -> torch.Tensor:
    """Per-observation chi2 gate: mono 2-dof, rectified-stereo 3-dof,
    two-camera 4-dof."""
    th = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(torch.float32)
    ir = getattr(obs, "is_right", None)
    if ir is not None:
        th = torch.where(ir, CHI2_TWOCAM, th)
    return th


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight rho'(chi2): 1 inside the threshold, delta/sqrt(chi2) outside."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / safe))


def huber_cost(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """Huber rho(chi2): quadratic inside, linear outside (g2o convention)."""
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = torch.sqrt(torch.as_tensor(delta2, dtype=chi2.dtype, device=chi2.device))
    return torch.where(chi2 <= delta2, chi2, 2.0 * d * s - delta2)
