"""Global bundle adjustment: matrix-free Schur complement + block-Jacobi PCG
(port of :mod:`orb_slam3_noted_tpu.optim.gba`).

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

A fisheye rig's second camera adds its two rows to every observation that
has a right-camera pixel (``kf_xy_r``).

``SlicedGBA`` is the single-device stand-in for the reference's GBA thread:
one LM step per frame boundary against a snapshot of the map, the deltas
merged into the live map at the end.

``distributed_global_ba`` shards the problem over a mesh of ranks
(``parallel/dist_ba.py``): rank s owns the landmark block [s Mb, (s+1) Mb)
and every observation of it, and keeps the point-sized state (Hll, its
inverse, gl, dl) for that block only.  Pose-side sums are reduced over the
mesh, one (K, 6) reduction a PCG iteration; the landmark update is
gathered once a step.  ``run_global_ba_mesh`` is the loop closer's GBA
inside a group of more than one rank.
"""

from __future__ import annotations

import itertools

import torch

from orb_slam3_noted_tpu_torch.geometry import se3, so3
from orb_slam3_noted_tpu_torch.geometry.linalg3 import inv3
from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.ops.segsum import segment_order, segment_sum
from orb_slam3_noted_tpu_torch.optim import factors
from orb_slam3_noted_tpu_torch.optim.ba import BAProblem, BAResult
from orb_slam3_noted_tpu_torch.optim.robust import chi2_threshold, huber_cost, huber_weight
from orb_slam3_noted_tpu_torch.utils.timing import count, span

# spans (``utils.timing.span``): the merge of a finished GBA into the live
# map; a whole GBA call; each LM step, and in it the linearisation, the
# reduced camera system and its right-hand side, the PCG solve and the
# update (back-substitution, the new cost, the accept test); the outlier
# reclassification between the two phases
MERGE_RANGE = "gba_merge"
GBA_RANGE = "global_ba"
LM_STEP_RANGE = "gba_lm_step"
LINEARIZE_RANGE = "gba_linearize"
SCHUR_RANGE = "gba_schur"
PCG_RANGE = "gba_pcg"
UPDATE_RANGE = "gba_update"
RECLASSIFY_RANGE = "gba_reclassify"
_CALLS = itertools.count()  # the index a GBA call's spans carry


def pose_onehot(obs: factors.ReprojObs, K: int) -> torch.Tensor:
    """(K, O) float32 one-hot of each observation's pose: the pose-side
    segment sums as products, in a fixed order."""
    ks = torch.arange(K, device=obs.pose_idx.device)
    return (ks[:, None] == obs.pose_idx.long()[None, :]).to(torch.float32)


def _eval_blocks(cam, Rcw, tcw, points, obs, prob, active, use_huber: bool, bf, oh_pose,
                 pt_order, rig2=()):
    """Residual blocks at one linearisation point: (W (O, 6, 3), Hpp (K, 6,
    6), gp (K, 6), Hll (M, 3, 3), gl (M, 3), cost).  Fixed poses and points
    get zeroed Jacobians, so their updates are exactly 0.  ``rig2`` =
    (cam2, Rrl, trl) of a second camera, or empty."""
    K, M = Rcw.shape[0], points.shape[0]
    dtype = tcw.dtype
    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, obs._replace(valid=active), bf, *rig2)
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
                 cg_iters: int, oh_pose=None, pt_order=None, rig2=()):
    """One LM step on one device; returns (Rcw, tcw, points, lam, cost).
    ``oh_pose`` and ``pt_order`` (the observations' pose one-hot and point
    order) are made here unless the caller keeps them.  It is the
    point-block step on a mesh of this process alone, whose sums are the
    identity."""
    from orb_slam3_noted_tpu_torch.parallel.dist_ba import Mesh

    if oh_pose is None:
        oh_pose = pose_onehot(obs, Rcw.shape[0])
    if pt_order is None:
        pt_order = segment_order(obs.point_idx.long(), points.shape[0], obs.valid)
    return _gba_lm_step_ptblock(cam, Rcw, tcw, points, obs, prob, active, use_huber, lam, bf,
                                cg_iters, Mesh(1, 0, tcw.device), oh_pose, pt_order, rig2)


def global_bundle_adjust(cam: cam_mod.Camera, prob: BAProblem, bf: float = 0.0,
                         n_iters: int = 8, n_iters_final: int = 5, cg_iters: int = 64,
                         cam2: cam_mod.Camera | None = None, Rrl: torch.Tensor | None = None,
                         trl: torch.Tensor | None = None) -> BAResult:
    """Full-map LM with the two-phase robust schedule of
    :func:`..optim.ba.bundle_adjust` (Huber, chi2 reclassification, plain
    least squares), with the matrix-free Schur/PCG inner solver;
    ``cam2``/``Rrl``/``trl`` the second camera of a fisheye rig."""
    with span(GBA_RANGE, call=next(_CALLS)):
        rig2 = (cam2, Rrl, trl)
        obs = prob.obs
        oh_pose = pose_onehot(obs, prob.Rcw.shape[0])
        pt_order = segment_order(obs.point_idx, prob.points.shape[0], obs.valid)

        def phase(Rcw, tcw, points, active, use_huber, n):
            lam = torch.tensor(1e-4, dtype=tcw.dtype, device=tcw.device)
            for _ in range(n):
                Rcw, tcw, points, lam, _ = _gba_lm_step(cam, Rcw, tcw, points, obs, prob, active,
                                                        use_huber, lam, bf, cg_iters, oh_pose,
                                                        pt_order, rig2)
            return Rcw, tcw, points

        Rcw, tcw, points = phase(prob.Rcw, prob.tcw, prob.points, obs.valid, True, n_iters)
        active = gba_reclassify(cam, Rcw, tcw, points, obs, bf, *rig2)
        Rcw, tcw, points = phase(Rcw, tcw, points, active, False, n_iters_final)
        _, _, _, chi2, ok, _ = factors.reproj_residuals(cam, Rcw, tcw, points, obs, bf, *rig2)
        inlier = obs.valid & ok & (chi2 <= chi2_threshold(obs))
        cost = torch.sum(torch.where(inlier, chi2, 0.0))
        return BAResult(Rcw=Rcw, tcw=tcw, points=points, chi2=chi2, inlier=inlier, cost=cost)


def _gba_lm_step_ptblock(cam, Rcw, tcw, points, obs, prob, active, use_huber: bool, lam, bf,
                         cg_iters: int, mesh, oh_pose, pt_order, rig2=()):
    """One LM step of this rank's shard with the landmark table
    block-partitioned over ``mesh``: the rank owns points [s Mb, (s+1) Mb)
    and every observation of them (``shard_obs_by_point_block``), and its
    Hll, Cinv, gl and dl cover that block only.  Reduced over the mesh:
    Hpp, gp, the preconditioner's and the right-hand side's coupling
    terms, U y in every PCG iteration, and both costs, so the accept test
    is the same on every rank; the landmark update is gathered once.
    ``oh_pose`` is the shard's pose one-hot, ``pt_order`` the segment order
    of its local point ids.  Returns (Rcw, tcw, points, lam, cost)."""
    count("gba_lm_steps")
    with span(LM_STEP_RANGE):
        return _lm_step(cam, Rcw, tcw, points, obs, prob, active, use_huber, lam, bf, cg_iters,
                        mesh, oh_pose, pt_order, rig2)


def _lm_step(cam, Rcw, tcw, points, obs, prob, active, use_huber, lam, bf, cg_iters, mesh,
             oh_pose, pt_order, rig2):
    K, M = Rcw.shape[0], points.shape[0]
    dtype, dev = tcw.dtype, tcw.device
    Mb = M // mesh.size
    base = mesh.rank * Mb
    pi = obs.pose_idx.long()
    li = (obs.point_idx.long() - base).clamp(0, Mb - 1)  # local point ids
    obs_l = obs._replace(point_idx=li)
    pts_l = points[base:base + Mb]
    prob_l = prob._replace(point_fixed=prob.point_fixed[base:base + Mb])
    with span(LINEARIZE_RANGE):
        W, Hpp, gp, Hll, gl, cost_old = _eval_blocks(cam, Rcw, tcw, pts_l, obs_l, prob_l, active,
                                                     use_huber, bf, oh_pose, pt_order, rig2)
        Hpp, gp, cost_old = mesh.psum(Hpp), mesh.psum(gp), mesh.psum(cost_old)
    with span(SCHUR_RANGE):
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        Hpp_d = Hpp + lam * Hpp * eye6 + (1e-8 + prob.pose_fixed.to(dtype))[:, None, None] * eye6
        Hll_d = (Hll + lam * Hll * eye3
                 + (1e-8 + prob_l.point_fixed.to(dtype))[:, None, None] * eye3)
        Cinv = inv3(Hll_d)  # (Mb, 3, 3): the owned block only

        wc = torch.einsum("oij,ojk->oik", W, Cinv[li])
        Pk_sub = (oh_pose @ torch.einsum("oik,ojk->oij", wc, W).reshape(-1, 36)).reshape(K, 6, 6)
        Pk = Hpp_d - mesh.psum(Pk_sub)
        Pk = 0.5 * (Pk + Pk.transpose(1, 2)) + 1e-6 * eye6
        Pinv = torch.linalg.solve_ex(Pk, eye6.expand(K, 6, 6)).result

        rhs = -gp + mesh.psum(_schur_rhs_coupling(W, Cinv, gl, li, oh_pose))

    def mv(x):
        utx = segment_sum(torch.einsum("oij,oi->oj", W, x[pi]), li, Mb, pt_order)
        y = torch.einsum("mij,mj->mi", Cinv, utx)
        uy = mesh.psum(oh_pose @ torch.einsum("oij,oj->oi", W, y[li]))
        return torch.einsum("kij,kj->ki", Hpp_d, x) - uy

    with span(PCG_RANGE):
        dp = _pcg(mv, Pinv, rhs, cg_iters)
    with span(UPDATE_RANGE):
        utdp = segment_sum(torch.einsum("oij,oi->oj", W, dp[pi]), li, Mb, pt_order)
        dl_l = torch.einsum("mij,mj->mi", Cinv, -gl - utdp)
        dl = mesh.gather_rows(dl_l)  # (M, 3), every rank's block

        R_new, t_new = se3.compose(se3.exp(dp), (Rcw, tcw))
        R_new = so3.normalize(R_new)
        p_new = points + dl
        cost_new = mesh.psum(_eval_blocks(cam, R_new, t_new, pts_l + dl_l, obs_l, prob_l, active,
                                          use_huber, bf, oh_pose, pt_order, rig2)[-1])
        better = cost_new < cost_old
        return (torch.where(better, R_new, Rcw), torch.where(better, t_new, tcw),
                torch.where(better, p_new, points), torch.where(better, lam * 0.5, lam * 5.0),
                torch.where(better, cost_new, cost_old))


def distributed_global_ba(cam: cam_mod.Camera, mesh, prob: BAProblem, bf: float = 0.0,
                          n_iters: int = 8, n_iters_final: int = 4, cg_iters: int = 32,
                          cam2: cam_mod.Camera | None = None, Rrl: torch.Tensor | None = None,
                          trl: torch.Tensor | None = None):
    """Matrix-free GBA with the problem sharded over ``mesh``
    (``parallel.dist_ba.make_mesh``), the two-phase schedule of
    :func:`global_bundle_adjust`.  Every rank passes the whole problem, on
    ``mesh.device``; M is padded to n Mb with fixed points, and rank s
    takes the observations of its block (``shard_obs_by_point_block``).
    The second camera's rows (``cam2``, ``Rrl``, ``trl``) stay on every
    shard.  Returns (Rcw, tcw, points, cost), the same on every rank."""
    with span(GBA_RANGE, call=next(_CALLS)):
        return _distributed_global_ba(cam, mesh, prob, bf, n_iters, n_iters_final, cg_iters,
                                      (cam2, Rrl, trl))


def _distributed_global_ba(cam, mesh, prob, bf, n_iters, n_iters_final, cg_iters, rig2):
    from orb_slam3_noted_tpu_torch.parallel.dist_ba import shard_obs_by_point_block

    n = mesh.size
    M0 = prob.points.shape[0]
    Mb = -(-M0 // n)
    pad = n * Mb - M0
    dev = prob.points.device
    points = torch.cat([prob.points, torch.zeros((pad, 3), dtype=prob.points.dtype, device=dev)])
    prob = prob._replace(points=points, point_fixed=torch.cat(
        [prob.point_fixed, torch.ones(pad, dtype=torch.bool, device=dev)]))
    table = shard_obs_by_point_block(prob.obs, n, Mb)
    cap = table.valid.shape[0] // n
    rows = slice(mesh.rank * cap, (mesh.rank + 1) * cap)
    obs = factors.ReprojObs(*(None if x is None else x[rows] for x in table))
    oh_pose = pose_onehot(obs, prob.Rcw.shape[0])
    pt_order = segment_order(obs.point_idx.long() - mesh.rank * Mb, Mb, obs.valid)

    def phase(Rcw, tcw, points, active, use_huber, n_steps):
        lam = torch.tensor(1e-4, dtype=tcw.dtype, device=tcw.device)
        for _ in range(n_steps):
            Rcw, tcw, points, lam, _ = _gba_lm_step_ptblock(
                cam, Rcw, tcw, points, obs, prob, active, use_huber, lam, bf, cg_iters, mesh,
                oh_pose, pt_order, rig2)
        return Rcw, tcw, points

    Rcw, tcw, points = phase(prob.Rcw, prob.tcw, prob.points, obs.valid, True, n_iters)
    # the reclassification is row by row: no collective
    active = gba_reclassify(cam, Rcw, tcw, points, obs, bf, *rig2)
    Rcw, tcw, points = phase(Rcw, tcw, points, active, False, n_iters_final)
    _, _, _, chi2, ok, _ = factors.reproj_residuals(cam, Rcw, tcw, points, obs, bf, *rig2)
    inlier = obs.valid & ok & (chi2 <= chi2_threshold(obs))
    cost = mesh.psum(torch.sum(torch.where(inlier, chi2, 0.0)))
    return Rcw, tcw, points[:M0], cost


def full_map_problem(m, cfg, sample_stride: int = 1) -> BAProblem:
    """A ``BAProblem`` over every valid keyframe/point binding of the map.
    Gauge: the earliest valid keyframe by frame id is fixed (the reference
    fixes keyframe 0).  With a second camera (``cfg.camera2``) its rows
    come from ``kf_xy_r``."""
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
    uv2 = m.kf_xy_r[kl, fl] if cfg.camera2 is not None else None
    obs = factors.ReprojObs(
        pose_idx=k_idx, point_idx=mp_idx, uv=m.kf_xy[kl, fl], uv_r=uvr,
        inv_sigma2=1.0 / sigma2[m.kf_level[kl, fl].long()], is_stereo=uvr >= 0, valid=valid,
        uv2=uv2, is_right=None if uv2 is None else uv2[:, 0] >= 0)
    fids = torch.where(m.kf_valid, m.kf_frame_id, 1 << 30)
    anchor = torch.argmin(fids)  # the first minimum, as jnp.argmin
    pose_fixed = ~m.kf_valid
    pose_fixed = pose_fixed | (torch.arange(KF, device=dev) == anchor)
    seen = torch.zeros(MP, dtype=torch.int32, device=dev).scatter_reduce(
        0, mp_idx.long(), valid.to(torch.int32), reduce="amax") > 0
    return BAProblem(Rcw=m.kf_Rcw, tcw=m.kf_tcw, points=m.mp_pos, obs=obs,
                     pose_fixed=pose_fixed, point_fixed=~seen)


def gba_step(cam, Rcw, tcw, points, obs, prob, active, use_huber: bool, lam, bf: float = 0.0,
             cg_iters: int = 64, oh_pose=None, pt_order=None, cam2=None, Rrl=None, trl=None):
    """One LM step of the matrix-free engine (the JAX package's
    ``gba_step_jit``): the slice ``SlicedGBA`` runs at a frame boundary."""
    return _gba_lm_step(cam, Rcw, tcw, points, obs, prob, active, use_huber, lam, bf, cg_iters,
                        oh_pose, pt_order, (cam2, Rrl, trl))


gba_step_jit = gba_step  # the JAX package's name for it (jitted there)


def gba_reclassify(cam, Rcw, tcw, points, obs, bf: float = 0.0, cam2=None, Rrl=None, trl=None):
    """Outlier reclassification between the Huber and the plain phase."""
    with span(RECLASSIFY_RANGE):
        _, _, _, chi2, ok, _ = factors.reproj_residuals(cam, Rcw, tcw, points, obs, bf, cam2,
                                                        Rrl, trl)
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
        from orb_slam3_noted_tpu_torch.pipeline.tracking import _second_camera

        self.cam, self.bf, self.cg_iters = cam, bf, cg_iters
        self.n_iters, self.n_iters_final = n_iters, n_iters_final
        self.rig2 = _second_camera(cfg, m.mp_pos.device)
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
            self.i < self.n_iters, self.lam, self.bf, self.cg_iters, self.oh_pose,
            self.pt_order, *self.rig2)
        self.i += 1
        if self.i == self.n_iters:
            self.active = gba_reclassify(self.cam, self.Rcw, self.tcw, self.points,
                                         self.prob.obs, self.bf, *self.rig2)
            self.lam = torch.full_like(self.lam, 1e-4)
        if self.i >= self.n_iters + self.n_iters_final:
            self.done = True

    def finish(self, m_live):
        """Run the remaining slices, then merge the deltas into the live map.
        A slot recycled since the snapshot holds another keyframe: its delta
        applies only where the frame id still matches."""
        while not self.done:
            self.step()
        with span(MERGE_RANGE):
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
    from orb_slam3_noted_tpu_torch.pipeline.tracking import _second_camera

    prob = full_map_problem(m, cfg)
    res = global_bundle_adjust(cam, prob, bf, n_iters, n_iters_final, cg_iters,
                               *_second_camera(cfg, m.mp_pos.device))
    KF, MP = m.kf_Rcw.shape[0], m.mp_pos.shape[0]
    dev = m.mp_pos.device
    m = MS.apply_ba_result(m, torch.arange(KF, device=dev), m.kf_valid, res.Rcw, res.tcw,
                           torch.arange(MP, device=dev), ~prob.point_fixed, res.points)
    return m, res.cost


def run_global_ba_mesh(m, cam, cfg, mesh, bf: float = 0.0, n_iters: int = 6,
                       n_iters_final: int = 4, cg_iters: int = 32):
    """:func:`run_global_ba` sharded over ``mesh``: the whole map's problem
    through :func:`distributed_global_ba`, written back on every rank.
    Returns (m, cost)."""
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
    from orb_slam3_noted_tpu_torch.pipeline.tracking import _second_camera

    prob = full_map_problem(m, cfg)
    Rf, tf, pf, cost = distributed_global_ba(cam, mesh, prob, bf, n_iters, n_iters_final,
                                             cg_iters, *_second_camera(cfg, m.mp_pos.device))
    KF, MP = m.kf_Rcw.shape[0], m.mp_pos.shape[0]
    dev = m.mp_pos.device
    m = MS.apply_ba_result(m, torch.arange(KF, device=dev), m.kf_valid, Rf, tf,
                           torch.arange(MP, device=dev), ~prob.point_fixed, pf)
    return m, cost
