"""Trajectory evaluation: Sim(3)-aligned RMS ATE (port of
:mod:`orb_slam3_noted_tpu.utils.evaluation`).

Horn alignment of the estimated positions to ground truth (with scale for
monocular runs, without for stereo and RGB-D), then the RMS of the
translational residuals.  Runs on the CPU in float32, as the JAX package
does with its default dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.geometry.horn import horn_sim3


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, with_scale: bool = True):
    """RMS ATE after Sim(3) (or SE(3)) alignment of matched position
    sequences (N, 3).  Returns (rmse, aligned_est, (R, t, s))."""
    est = torch.as_tensor(np.asarray(est_pos, np.float32))
    gt = torch.as_tensor(np.asarray(gt_pos, np.float32))
    R, t, s = horn_sim3(est, gt, fix_scale=not with_scale)
    aligned = (s * (est @ R.T) + t).numpy()
    err = aligned - np.asarray(gt_pos, np.float32)
    rmse = float(np.sqrt((err ** 2).sum(axis=1).mean()))
    return rmse, aligned, (R.numpy(), t.numpy(), float(s))
