"""Global bundle adjustment: matrix-free Schur complement + block-Jacobi PCG
(port of :mod:`orb_slam3_noted_tpu.optim.gba`, one device).

``Optimizer::GlobalBundleAdjustemnt`` and the GBA the loop closer spawns
(``LoopClosing::RunGlobalBundleAdjustment``).  The reduced camera system

    S dp = -gp + U Hll^-1 gl,   S = Hpp - U Hll^-1 U^T

is solved by preconditioned conjugate gradients, every product with U or
U^T evaluated observation by observation, so memory stays O(O + K + M).
The LM outer loop accepts or rejects each step on the cost (lambda x0.5 /
x5) with a ``torch.where``: nothing is read back inside the LM or PCG loops.

Sums over the K keyframe slots (Hpp, gp, the preconditioner blocks, U y in
every PCG iteration) are one-hot products; sums over landmarks are segment
sums over the observations sorted once by point (``ops/segsum.py``).  Both
run in a fixed order, so a step gives the same result in every run on the
card (``tests/test_torch_cuda.py``).

``SlicedGBA`` is the single-device stand-in for the reference's GBA thread:
one LM step per frame boundary against a snapshot of the map, the deltas
merged into the live map at the end.  The mesh-sharded variants
(``distributed_global_ba``, ``run_global_ba_mesh``, the point-block step)
wait for the distribution slice (ROADMAP, next steps 7).
"""

from __future__ import annotations

import torch

from orb_slam3_noted_tpu_torch.geometry import se3, so3
from orb_slam3_noted_tpu_torch.geometry.linalg3 import inv3
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops.segsum import segment_order, segment_sum
from orb_slam3_noted_tpu_torch.optim import factors
from orb_slam3_noted_tpu_torch.optim.ba import BAProblem, BAResult
from orb_slam3_noted_tpu_torch.optim.robust import chi2_threshold, huber_cost, huber_weight

# profiler range around the merge of a finished GBA into the live map
MERGE_RANGE = "gba_merge"


def pose_onehot(obs: factors.ReprojObs, K: int) -> torch.Tensor:
    """(K, O) float32 one-hot of each observation's pose: the pose-side
    segment sums as products, in a fixed order."""
    ks = torch.arange(K, device=obs.pose_idx.device)
    return (ks[:, None] == obs.pose_idx.long()[None, :]).to(torch.float32)


def _eval_blocks(cam, Rcw, tcw, points, obs, prob, active, use_huber: bool, bf, oh_pose,
                 pt_order):
    """Residual blocks at one linearisation point: (W (O, 6, 3), Hpp (K, 6,
    6), gp (K, 6), Hll (M, 3, 3), gl (M, 3), cost).  Fixed poses and points
    get zeroed Jacobians, so their updates are exactly 0."""
    K, M = Rcw.shape[0], points.shape[0]
    dtype = tcw.dtype
    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, obs._replace(valid=active), bf=bf)
    delta2 = chi2_threshold(obs)
    w_rob = huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
    w = torch.where(ok, obs.inv_sigma2 * w_rob, 0.0)
    cost = torch.sum(torch.where(ok, huber_cost(chi2, delta2) if use_huber else chi2, 0.0))
    pi, li = obs.pose_idx.long(), obs.point_idx.long()
    Jp = Jp * (~prob.pose_fixed).to(dtype)[pi][:, None, None]
    Jl = Jl * (~prob.point_fixed).to(dtype)[li][:, None, None]
    wJp = w[:, None, None] * Jp
    wr = w[:, None] * r
    W = torch.einsum("oai,oaj->oij", wJp, Jl)
    n_obs = r.shape[0]
    pose_side = oh_pose @ torch.cat([torch.einsum("oai,oaj->oij", wJp, Jp).reshape(n_obs, 36),
                                     torch.einsum("oai,oa->oi", Jp, wr)], dim=1)
    Hpp = pose_side[:, :36].reshape(K, 6, 6)
    gp = pose_side[:, 36:]
    Hll = segment_sum(torch.einsum("oai,oaj->oij", w[:, None, None] * Jl, Jl), li, M, pt_order)
    gl = segment_sum(torch.einsum("oai,oa->oi", Jl, wr), li, M, pt_order)
    return W, Hpp, gp, Hll, gl, cost


def _schur_matvec(x, W, Hpp_d, Cinv, pose_idx, point_idx, M, oh_pose, pt_order):
    """S @ x without materialising S or U; O(O) per call."""
    utx = segment_sum(torch.einsum("oij,oi->oj", W, x[pose_idx]), point_idx, M, pt_order)
    y = torch.einsum("mij,mj->mi", Cinv, utx)                                     # Hll^-1 U^T x
    uy = oh_pose @ torch.einsum("oij,oj->oi", W, y[point_idx])                    # U y
    return torch.einsum("kij,kj->ki", Hpp_d, x) - uy


def _pcg(matvec, Pinv, b, n_iters: int):
    """Block-Jacobi preconditioned CG on the (K, 6) pose system."""
    def precond(r):
        return torch.einsum("kij,kj->ki", Pinv, r)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(n_iters):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(torch.abs(pAp) > 1e-20, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
    return x


def _schur_rhs_coupling(W, Cinv, gl, point_idx, oh_pose):
    """U Hll^-1 gl, observation by observation."""
    y = torch.einsum("mij,mj->mi", Cinv, gl)
    return oh_pose @ torch.einsum("oij,oj->oi", W, y[point_idx])


def _gba_lm_step(cam, Rcw, tcw, points, obs, prob, active, use_huber: bool, lam, bf,
                 cg_iters: int, oh_pose=None, pt_order=None):
    """One LM step; returns (Rcw, tcw, points, lam, cost).  ``oh_pose`` and
    ``pt_order`` (the observations' pose one-hot and point order) are made
    here unless the caller keeps them."""
    K, M = Rcw.shape[0], points.shape[0]
    dtype, dev = tcw.dtype, tcw.device
    if oh_pose is None:
        oh_pose = pose_onehot(obs, K)
    pi, li = obs.pose_idx.long(), obs.point_idx.long()
    if pt_order is None:
        pt_order = segment_order(li, M, obs.valid)
    W, Hpp, gp, Hll, gl, cost_old = _eval_blocks(cam, Rcw, tcw, points, obs, prob, active,
                                                 use_huber, bf, oh_pose, pt_order)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hpp_d = Hpp + lam * Hpp * eye6 + (1e-8 + prob.pose_fixed.to(dtype))[:, None, None] * eye6
    Hll_d = Hll + lam * Hll * eye3 + (1e-8 + prob.point_fixed.to(dtype))[:, None, None] * eye3
    Cinv = inv3(Hll_d)

    # block-Jacobi preconditioner: P_k = Hpp_k - sum_o W_o Cinv_m W_o^T
    wc = torch.einsum("oij,ojk->oik", W, Cinv[li])
    Pk = Hpp_d - (oh_pose @ torch.einsum("oik,ojk->oij", wc, W).reshape(-1, 36)).reshape(K, 6, 6)
    Pk = 0.5 * (Pk + Pk.transpose(1, 2)) + 1e-6 * eye6
    Pinv = torch.linalg.solve_ex(Pk, eye6.expand(K, 6, 6)).result

    rhs = -gp + _schur_rhs_coupling(W, Cinv, gl, li, oh_pose)
    dp = _pcg(lambda x: _schur_matvec(x, W, Hpp_d, Cinv, pi, li, M, oh_pose, pt_order), Pinv,
              rhs, cg_iters)
    # back-substitute the landmarks: dl = Hll^-1 (-gl - U^T dp)
    utdp = segment_sum(torch.einsum("oij,oi->oj", W, dp[pi]), li, M, pt_order)
    dl = torch.einsum("mij,mj->mi", Cinv, -gl - utdp)

    R_new, t_new = se3.compose(se3.exp(dp), (Rcw, tcw))
    R_new = so3.normalize(R_new)
    p_new = points + dl
    cost_new = _eval_blocks(cam, R_new, t_new, p_new, obs, prob, active, use_huber, bf,
                            oh_pose, pt_order)[-1]
    better = cost_new < cost_old
    return (torch.where(better, R_new, Rcw), torch.where(better, t_new, tcw),
            torch.where(better, p_new, points), torch.where(better, lam * 0.5, lam * 5.0),
            torch.where(better, cost_new, cost_old))


def _one_camera(cfg) -> None:
    if cfg is not None and getattr(cfg, "camera2", None) is not None:
        raise NotImplementedError(
            "two-camera global BA waits for the fisheye slice (ROADMAP, next steps 4)")


def global_bundle_adjust(cam: cam_mod.Camera, prob: BAProblem, bf: float = 0.0,
                         n_iters: int = 8, n_iters_final: int = 5,
                         cg_iters: int = 64) -> BAResult:
    """Full-map LM with the two-phase robust schedule of
    :func:`..optim.ba.bundle_adjust` (Huber, chi2 reclassification, plain
    least squares), with the matrix-free Schur/PCG inner solver."""
    obs = prob.obs
    oh_pose = pose_onehot(obs, prob.Rcw.shape[0])
    pt_order = segment_order(obs.point_idx, prob.points.shape[0], obs.valid)

    def phase(Rcw, tcw, points, active, use_huber, n):
        lam = torch.tensor(1e-4, dtype=tcw.dtype, device=tcw.device)
        for _ in range(n):
            Rcw, tcw, points, lam, _ = _gba_lm_step(cam, Rcw, tcw, points, obs, prob, active,
                                                    use_huber, lam, bf, cg_iters, oh_pose,
                                                    pt_order)
        return Rcw, tcw, points

    Rcw, tcw, points = phase(prob.Rcw, prob.tcw, prob.points, obs.valid, True, n_iters)
    active = gba_reclassify(cam, Rcw, tcw, points, obs, bf=bf)
    Rcw, tcw, points = phase(Rcw, tcw, points, active, False, n_iters_final)
    _, _, _, chi2, ok, _ = factors.reproj_residuals(cam, Rcw, tcw, points, obs, bf=bf)
    inlier = obs.valid & ok & (chi2 <= chi2_threshold(obs))
    cost = torch.sum(torch.where(inlier, chi2, 0.0))
    return BAResult(Rcw=Rcw, tcw=tcw, points=points, chi2=chi2, inlier=inlier, cost=cost)


def full_map_problem(m, cfg, sample_stride: int = 1) -> BAProblem:
    """A ``BAProblem`` over every valid keyframe/point binding of the map.
    Gauge: the earliest valid keyframe by frame id is fixed (the reference
    fixes keyframe 0)."""
    _one_camera(cfg)
    KF, NF = m.kf_xy.shape[0], m.kf_xy.shape[1]
    MP = m.mp_pos.shape[0]
    dev = m.mp_pos.device
    k_idx = torch.arange(KF, dtype=torch.int32, device=dev).repeat_interleave(NF)
    f_idx = torch.arange(NF, dtype=torch.int32, device=dev).repeat(KF)
    if sample_stride > 1:
        k_idx, f_idx = k_idx[::sample_stride], f_idx[::sample_stride]
    kl, fl = k_idx.long(), f_idx.long()
    mp_id = m.kf_mp[kl, fl]
    mp_idx = mp_id.clamp(min=0)
    valid = m.kf_valid[kl] & (mp_id >= 0) & m.kf_feat_valid[kl, fl] & m.mp_valid[mp_idx.long()]
    sigma2 = torch.tensor(cfg.level_sigma2, dtype=m.mp_pos.dtype, device=dev)
    uvr = m.kf_uvr[kl, fl]
    obs = factors.ReprojObs(
        pose_idx=k_idx, point_idx=mp_idx, uv=m.kf_xy[kl, fl], uv_r=uvr,
        inv_sigma2=1.0 / sigma2[m.kf_level[kl, fl].long()], is_stereo=uvr >= 0, valid=valid)
    fids = torch.where(m.kf_valid, m.kf_frame_id, 1 << 30)
    anchor = torch.argmin(fids)  # the first minimum, as jnp.argmin
    pose_fixed = ~m.kf_valid
    pose_fixed = pose_fixed | (torch.arange(KF, device=dev) == anchor)
    seen = torch.zeros(MP, dtype=torch.int32, device=dev).scatter_reduce(
        0, mp_idx.long(), valid.to(torch.int32), reduce="amax") > 0
    return BAProblem(Rcw=m.kf_Rcw, tcw=m.kf_tcw, points=m.mp_pos, obs=obs,
                     pose_fixed=pose_fixed, point_fixed=~seen)


def gba_step(cam, Rcw, tcw, points, obs, prob, active, use_huber: bool, lam, bf: float = 0.0,
             cg_iters: int = 64, oh_pose=None, pt_order=None):
    """One LM step of the matrix-free engine (the JAX package's
    ``gba_step_jit``): the slice ``SlicedGBA`` runs at a frame boundary."""
    return _gba_lm_step(cam, Rcw, tcw, points, obs, prob, active, use_huber, lam, bf, cg_iters,
                        oh_pose, pt_order)


def gba_reclassify(cam, Rcw, tcw, points, obs, bf: float = 0.0):
    """Outlier reclassification between the Huber and the plain phase."""
    _, _, _, chi2, ok, _ = factors.reproj_residuals(cam, Rcw, tcw, points, obs, bf=bf)
    return obs.valid & ok & (chi2 <= chi2_threshold(obs))


def apply_gba_deltas(m, snapR, snapt, snapp, Rcw, tcw, points, kf_live, mp_live):
    """Merge a GBA run on a snapshot into the live map: delta = result -
    snapshot, added onto the live values, so keyframes and points that local
    BA refined since the snapshot keep those refinements.  ``kf_live`` /
    ``mp_live`` mask to what existed at snapshot time and is still valid."""
    dR = torch.where(kf_live[:, None, None], Rcw - snapR, 0.0)
    dt = torch.where(kf_live[:, None], tcw - snapt, 0.0)
    dp = torch.where(mp_live[:, None], points - snapp, 0.0)
    Rn = torch.where(kf_live[:, None, None], so3.normalize(m.kf_Rcw + dR), m.kf_Rcw)
    return m._replace(kf_Rcw=Rn, kf_tcw=m.kf_tcw + dt, mp_pos=m.mp_pos + dp)


class SlicedGBA:
    """Time-sliced global BA over a map snapshot.

    ``g = SlicedGBA(m, cam, cfg, bf)``; ``g.step()`` at frame boundaries (one
    LM step each, enqueued without a host read); when ``g.done``,
    ``m = g.finish(m_live)`` merges the deltas."""

    def __init__(self, m, cam, cfg, bf=0.0, n_iters=6, n_iters_final=4, cg_iters=48):
        self.cam, self.bf, self.cg_iters = cam, bf, cg_iters
        self.n_iters, self.n_iters_final = n_iters, n_iters_final
        self.prob = full_map_problem(m, cfg)
        self.oh_pose = pose_onehot(self.prob.obs, m.kf_Rcw.shape[0])
        self.pt_order = segment_order(self.prob.obs.point_idx, m.mp_pos.shape[0],
                                      self.prob.obs.valid)
        self.snapR, self.snapt, self.snapp = m.kf_Rcw, m.kf_tcw, m.mp_pos
        self.snap_kf_valid, self.snap_mp_valid = m.kf_valid, m.mp_valid
        self.snap_kf_fid = m.kf_frame_id  # recycled-slot guard
        self.Rcw, self.tcw, self.points = m.kf_Rcw, m.kf_tcw, m.mp_pos
        self.active = self.prob.obs.valid
        self.lam = torch.tensor(1e-4, dtype=m.kf_tcw.dtype, device=m.kf_tcw.device)
        self.i = 0
        self.done = False

    def step(self):
        """Enqueue one LM slice."""
        if self.done:
            return
        self.Rcw, self.tcw, self.points, self.lam, _ = gba_step(
            self.cam, self.Rcw, self.tcw, self.points, self.prob.obs, self.prob, self.active,
            self.i < self.n_iters, self.lam, bf=self.bf, cg_iters=self.cg_iters,
            oh_pose=self.oh_pose, pt_order=self.pt_order)
        self.i += 1
        if self.i == self.n_iters:
            self.active = gba_reclassify(self.cam, self.Rcw, self.tcw, self.points,
                                         self.prob.obs, bf=self.bf)
            self.lam = torch.full_like(self.lam, 1e-4)
        if self.i >= self.n_iters + self.n_iters_final:
            self.done = True

    def finish(self, m_live):
        """Run the remaining slices, then merge the deltas into the live map.
        A slot recycled since the snapshot holds another keyframe: its delta
        applies only where the frame id still matches."""
        while not self.done:
            self.step()
        with torch.profiler.record_function(MERGE_RANGE):
            kf_live = (self.snap_kf_valid & m_live.kf_valid
                       & (m_live.kf_frame_id == self.snap_kf_fid))
            mp_live = self.snap_mp_valid & m_live.mp_valid & ~self.prob.point_fixed
            return apply_gba_deltas(m_live, self.snapR, self.snapt, self.snapp, self.Rcw,
                                    self.tcw, self.points, kf_live, mp_live)


def run_global_ba(m, cam, cfg, bf: float = 0.0, n_iters: int = 8, n_iters_final: int = 5,
                  cg_iters: int = 64):
    """GBA over the whole map, written back (``LoopClosing::
    RunGlobalBundleAdjustment`` without keyframes created during it).
    Returns (m, cost)."""
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS

    prob = full_map_problem(m, cfg)
    res = global_bundle_adjust(cam, prob, bf=bf, n_iters=n_iters, n_iters_final=n_iters_final,
                               cg_iters=cg_iters)
    KF, MP = m.kf_Rcw.shape[0], m.mp_pos.shape[0]
    dev = m.mp_pos.device
    m = MS.apply_ba_result(m, torch.arange(KF, device=dev), m.kf_valid, res.Rcw, res.tcw,
                           torch.arange(MP, device=dev), ~prob.point_fixed, res.points)
    return m, res.cost
