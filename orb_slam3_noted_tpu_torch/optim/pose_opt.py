"""Motion-only pose optimisation (port of :mod:`orb_slam3_noted_tpu.optim.pose_opt`).

``Optimizer::PoseOptimization`` with the JAX package's schedule: 3 rounds x
4 damped Gauss-Newton iterations, accept-always inside a round, revert the
round if it raised the robust cost, re-classify outliers by chi2 after each
round; Huber in the first two rounds, least squares in the last.

The revert and the outlier masks stay on the device (``torch.where``), so
the whole optimisation runs without a host round trip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.geometry import se3, so3
from orb_slam3_noted_tpu_torch.geometry.linalg3 import solve6
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.optim import factors
from orb_slam3_noted_tpu_torch.optim.robust import chi2_threshold, huber_cost, huber_weight
from orb_slam3_noted_tpu_torch.utils import interop

N_ROUNDS = 3
N_ITERS = 4


class PoseObs(NamedTuple):
    """Per-landmark observation table for motion-only optimisation."""

    uv: torch.Tensor          # (N, 2)
    uv_r: torch.Tensor        # (N,)
    inv_sigma2: torch.Tensor  # (N,)
    is_stereo: torch.Tensor   # (N,) bool
    valid: torch.Tensor       # (N,) bool
    uv2: torch.Tensor | None = None       # (N, 2) right-camera obs (fisheye)
    is_right: torch.Tensor | None = None  # (N,) bool


class PoseOptResult(NamedTuple):
    Rcw: torch.Tensor
    tcw: torch.Tensor
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor       # (N,) final per-observation chi2


def to_numpy(o: PoseObs) -> dict:
    return interop.to_numpy(o)


def from_numpy(d: dict, device=None) -> PoseObs:
    """{field: array} (e.g. ``jax.device_get(obs)._asdict()``) -> PoseObs."""
    return interop.from_numpy(PoseObs, d, device)


def _evaluate(cam, Rcw, tcw, points, obs: PoseObs, active, use_huber: bool, bf, rig2=()):
    """Residuals/Jacobian/IRLS weights/robust cost for the single pose;
    ``rig2`` = (cam2, Rrl, trl) of a second camera, or empty."""
    n = points.shape[0]
    o = factors.ReprojObs(
        pose_idx=torch.zeros(n, dtype=torch.int32, device=points.device),
        point_idx=torch.arange(n, dtype=torch.int32, device=points.device),
        uv=obs.uv, uv_r=obs.uv_r, inv_sigma2=obs.inv_sigma2,
        is_stereo=obs.is_stereo, valid=active, uv2=obs.uv2, is_right=obs.is_right,
    )
    r, Jp, _, chi2, ok, _ = factors.reproj_residuals(cam, Rcw[None], tcw[None], points, o, bf,
                                                     *rig2)
    delta2 = chi2_threshold(obs)
    w_rob = huber_weight(chi2, delta2) if use_huber else 1.0
    w = torch.where(ok, obs.inv_sigma2 * w_rob, 0.0)
    rob = huber_cost(chi2, delta2) if use_huber else chi2
    rob_cost = torch.sum(torch.where(ok, rob, 0.0))
    return r, Jp, chi2, w, ok, rob_cost


def _one_round(cam, Rcw, tcw, points, obs, active, use_huber, bf, rig2=()):
    Rcw0, tcw0 = Rcw, tcw
    cost0 = _evaluate(cam, Rcw, tcw, points, obs, active, use_huber, bf, rig2)[5]
    eye6 = torch.eye(6, dtype=points.dtype, device=points.device)
    for _ in range(N_ITERS):
        r, Jp, _, w, _, _ = _evaluate(cam, Rcw, tcw, points, obs, active, use_huber, bf, rig2)
        H = torch.einsum("oai,oaj->ij", Jp * w[:, None, None], Jp)
        g = torch.einsum("oai,oa->i", Jp, w[:, None] * r)
        Hd = H + 1e-3 * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
        # residual r = obs - h(x) and J = dr/dx  =>  normal equations H dx = -g
        dx = solve6(Hd, -g)
        R_new, t_new = se3.compose(se3.exp(dx), (Rcw, tcw))
        Rcw, tcw = so3.normalize(R_new), t_new
    cost1 = _evaluate(cam, Rcw, tcw, points, obs, active, use_huber, bf, rig2)[5]
    better = cost1 < cost0  # per-round safety: revert if the round diverged
    Rcw = torch.where(better, Rcw, Rcw0)
    tcw = torch.where(better, tcw, tcw0)
    # re-classify outliers over ALL valid observations
    _, _, chi2, _, ok, _ = _evaluate(cam, Rcw, tcw, points, obs, obs.valid, use_huber, bf, rig2)
    active_new = obs.valid & ok & (chi2 <= chi2_threshold(obs))
    return Rcw, tcw, active_new


def pose_optimization(
    cam: cam_mod.Camera,
    Rcw0: torch.Tensor,
    tcw0: torch.Tensor,
    points: torch.Tensor,
    obs: PoseObs,
    bf: float = 0.0,
    cam2: cam_mod.Camera | None = None,
    Rrl: torch.Tensor | None = None,
    trl: torch.Tensor | None = None,
) -> PoseOptResult:
    """Optimise one camera pose against fixed landmarks; pose + inliers.
    ``cam2``/``Rrl``/``trl``: the second camera of a fisheye rig, whose
    rows ``obs.uv2``/``obs.is_right`` carry."""
    rig2 = (cam2, Rrl, trl)
    Rcw, tcw, active = Rcw0, tcw0, obs.valid
    for rnd in range(N_ROUNDS):
        Rcw, tcw, active = _one_round(cam, Rcw, tcw, points, obs, active, rnd < 2, bf, rig2)
    _, _, chi2, _, _, _ = _evaluate(cam, Rcw, tcw, points, obs, obs.valid, False, bf, rig2)
    return PoseOptResult(
        Rcw=Rcw, tcw=tcw, inliers=active,
        n_inliers=torch.sum(active.to(torch.int32)), chi2=chi2,
    )
