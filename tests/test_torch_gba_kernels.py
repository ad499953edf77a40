"""The global BA's reduced camera system on the CPU (``ops/gba_kernels.py``,
``optim/gba.py``): the plain versions behind the card's kernels give the
port's first code for these sums bit for bit.

- a frozen copy of that code (the LM step with its one-hot pose sums, its
  matrix-free product ``mv`` and its PCG, as ``optim/gba.py`` had them)
  against the moved plain functions, piece by piece and for a whole step,
  on a pinhole mono problem, a problem with stereo rows and one rank's
  shard of a 2-rank mesh, which carries pad rows;
- the card's slot order (``pose_order``): stable, rows that are not valid
  dealt round-robin over the slots, as ``segment_order`` deals them;
- the counter ``gba_pcg_iters`` on the CPU path, where no kernel launches.

No JAX here: ``tests/test_torch_cuda.py`` builds its card inputs with
:func:`capacity_problem` and :func:`seed_system`.
"""

import os
import sys

import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu_torch.geometry import se3, so3
from orb_slam3_noted_tpu_torch.geometry.linalg3 import inv3
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.ops import gba_kernels as gk
from orb_slam3_noted_tpu_torch.ops.segsum import segment_order, segment_sum
from orb_slam3_noted_tpu_torch.optim import factors
from orb_slam3_noted_tpu_torch.optim import gba
from orb_slam3_noted_tpu_torch.optim.robust import chi2_threshold, huber_cost, huber_weight
from orb_slam3_noted_tpu_torch.parallel.dist_ba import shard_obs_by_point_block
from orb_slam3_noted_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("mono", "stereo", "shard")
BF = 40.0  # stereo baseline x fx (px m) of the stereo rows
CG_ITERS = 12


def _dist():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_port_dist

    return torch_port_dist


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ShardMesh:
    """Rank ``rank`` of a ``size``-rank mesh, alone: its sums are its own
    partials (the identity of a one-rank mesh, on a shard's rows)."""

    def __init__(self, size: int, rank: int):
        self.size, self.rank = size, rank

    def psum(self, x):
        return x

    def gather_rows(self, x):
        buf = torch.zeros((self.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[self.rank * x.shape[0]:(self.rank + 1) * x.shape[0]] = x
        return buf


def capacity_problem(device, K=12, M=300, per_kf=60, stereo=False):
    """``scripts/torch_port_dist.py``'s capacity GBA (256 keyframes, 16,384
    points, 307,200 rows at its defaults) on ``device``; with ``stereo``,
    every other row gets a right-image column at baseline ``BF``."""
    TD = _dist()
    prob = TD.to_device(TD.capacity_gba_problem(K=K, M=M, per_kf=per_kf), device)
    if stereo:
        obs = prob.obs
        pi, li = obs.pose_idx.long(), obs.point_idx.long()
        z = (torch.einsum("oij,oj->oi", prob.Rcw[pi], prob.points[li]) + prob.tcw[pi])[:, 2]
        st = torch.arange(obs.uv.shape[0], device=device) % 2 == 0
        prob = prob._replace(obs=obs._replace(
            uv_r=torch.where(st, obs.uv[:, 0] - BF / z, -1.0), is_stereo=st))
    return Camera(PINHOLE, TD.PIN), prob


def shard(prob, n: int, rank: int):
    """(problem padded to n Mb points, rank's rows, Mb) as
    ``gba._distributed_global_ba`` makes them."""
    M0 = prob.points.shape[0]
    Mb = -(-M0 // n)
    pad = n * Mb - M0
    dev = prob.points.device
    prob = prob._replace(
        points=torch.cat([prob.points, torch.zeros((pad, 3), device=dev)]),
        point_fixed=torch.cat([prob.point_fixed, torch.ones(pad, dtype=torch.bool, device=dev)]))
    table = shard_obs_by_point_block(prob.obs, n, Mb)
    cap = table.valid.shape[0] // n
    rows = slice(rank * cap, (rank + 1) * cap)
    return prob, factors.ReprojObs(*(None if x is None else x[rows] for x in table)), Mb


def case(kind: str, device=torch.device("cpu"), **size):
    """(cam, prob, obs, mesh, bf) of one of ``KINDS``: a shard's rows on the
    rank of a 2-rank mesh whose rows carry padding."""
    cam, prob = capacity_problem(device, stereo=kind == "stereo", **size)
    if kind != "shard":
        return cam, prob, prob.obs, ShardMesh(1, 0), BF if kind == "stereo" else 0.0
    for rank in (0, 1):
        p, obs, _ = shard(prob, 2, rank)
        if not bool(obs.valid.all()):
            return cam, p, obs, ShardMesh(2, rank), 0.0
    raise AssertionError("no rank of the shard holds pad rows")


# ---------------------------------------------------------------------------
# the port's first code for the LM step, frozen: the reference

def seed_eval_blocks(cam, Rcw, tcw, points, obs, prob, active, use_huber, bf, oh_pose, pt_order):
    K, M = Rcw.shape[0], points.shape[0]
    dtype = tcw.dtype
    r, Jp, Jl, chi2, ok, _ = factors.reproj_residuals(
        cam, Rcw, tcw, points, obs._replace(valid=active), bf)
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


def seed_pcg(matvec, Pinv, b, n_iters):
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


def seed_system(cam, prob, obs, mesh, bf, lam=1e-4, use_huber=True):
    """The LM step's reduced camera system as the port first built it, with
    its one-hot ``oh`` and its product ``mv``; a dict of every piece."""
    K, M = prob.Rcw.shape[0], prob.points.shape[0]
    dtype, dev = prob.tcw.dtype, prob.tcw.device
    Mb = M // mesh.size
    base = mesh.rank * Mb
    pi = obs.pose_idx.long()
    li = (obs.point_idx.long() - base).clamp(0, Mb - 1)
    obs_l = obs._replace(point_idx=li)
    pts_l = prob.points[base:base + Mb]
    prob_l = prob._replace(point_fixed=prob.point_fixed[base:base + Mb])
    oh = gba.pose_onehot(obs, K)
    pt_order = segment_order(li, Mb, obs.valid)
    lam = torch.tensor(lam, dtype=dtype, device=dev)
    W, Hpp, gp, Hll, gl, cost_old = seed_eval_blocks(cam, prob.Rcw, prob.tcw, pts_l, obs_l,
                                                     prob_l, obs.valid, use_huber, bf, oh,
                                                     pt_order)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hpp_d = Hpp + lam * Hpp * eye6 + (1e-8 + prob.pose_fixed.to(dtype))[:, None, None] * eye6
    Hll_d = Hll + lam * Hll * eye3 + (1e-8 + prob_l.point_fixed.to(dtype))[:, None, None] * eye3
    Cinv = inv3(Hll_d)
    wc = torch.einsum("oij,ojk->oik", W, Cinv[li])
    pk_rows = torch.einsum("oik,ojk->oij", wc, W).reshape(-1, 36)
    Pk_sub = (oh @ pk_rows).reshape(K, 6, 6)
    Pk = Hpp_d - mesh.psum(Pk_sub)
    Pk = 0.5 * (Pk + Pk.transpose(1, 2)) + 1e-6 * eye6
    Pinv = torch.linalg.solve_ex(Pk, eye6.expand(K, 6, 6)).result
    y_gl = torch.einsum("mij,mj->mi", Cinv, gl)
    coupling = oh @ torch.einsum("oij,oj->oi", W, y_gl[li])
    rhs = -gp + mesh.psum(coupling)

    def mv(x):
        utx = segment_sum(torch.einsum("oij,oi->oj", W, x[pi]), li, Mb, pt_order)
        y = torch.einsum("mij,mj->mi", Cinv, utx)
        uy = mesh.psum(oh @ torch.einsum("oij,oj->oi", W, y[li]))
        return torch.einsum("kij,kj->ki", Hpp_d, x) - uy

    return dict(K=K, Mb=Mb, pi=pi, li=li, obs_l=obs_l, pts_l=pts_l, prob_l=prob_l, oh=oh,
                pt_order=pt_order, lam=lam, W=W, Hpp=Hpp, gp=gp, Hll=Hll, gl=gl,
                cost_old=cost_old, Hpp_d=Hpp_d, Cinv=Cinv, pk_rows=pk_rows, Pk_sub=Pk_sub,
                Pinv=Pinv, y_gl=y_gl, coupling=coupling, rhs=rhs, mv=mv)


def seed_step(cam, prob, obs, mesh, bf, cg_iters, use_huber=True):
    """The whole LM step as the port first ran it: (Rcw, tcw, points, lam, cost)."""
    s = seed_system(cam, prob, obs, mesh, bf, use_huber=use_huber)
    dp = seed_pcg(s["mv"], s["Pinv"], s["rhs"], cg_iters)
    utdp = segment_sum(torch.einsum("oij,oi->oj", s["W"], dp[s["pi"]]), s["li"], s["Mb"],
                       s["pt_order"])
    dl_l = torch.einsum("mij,mj->mi", s["Cinv"], -s["gl"] - utdp)
    dl = mesh.gather_rows(dl_l)
    R_new, t_new = se3.compose(se3.exp(dp), (prob.Rcw, prob.tcw))
    R_new = so3.normalize(R_new)
    p_new = prob.points + dl
    cost_new = mesh.psum(seed_eval_blocks(cam, R_new, t_new, s["pts_l"] + dl_l, s["obs_l"],
                                          s["prob_l"], obs.valid, use_huber, bf, s["oh"],
                                          s["pt_order"])[-1])
    better = cost_new < s["cost_old"]
    lam = s["lam"]
    return (torch.where(better, R_new, prob.Rcw), torch.where(better, t_new, prob.tcw),
            torch.where(better, p_new, prob.points), torch.where(better, lam * 0.5, lam * 5.0),
            torch.where(better, cost_new, s["cost_old"]))


# ---------------------------------------------------------------------------
# the moved plain functions against it

@pytest.fixture(scope="module")
def systems():
    out = {}
    for kind in KINDS:
        cam, prob, obs, mesh, bf = case(kind)
        out[kind] = (cam, prob, obs, mesh, bf, seed_system(cam, prob, obs, mesh, bf))
    return out


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("piece", ["eval_blocks", "pk", "rhs", "mv", "pcg", "lm_step"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_are_the_first_code(systems, kind, piece):
    """Each pose-side sum of the LM step, as the CPU path now computes it,
    gives the one-hot code's bits exactly."""
    cam, prob, obs, mesh, bf, s = systems[kind]
    seg = gba.pose_segments(obs, s["K"])
    assert seg.perm is None and torch.equal(seg.onehot, s["oh"])
    if piece == "eval_blocks":
        got = gba._eval_blocks(cam, prob.Rcw, prob.tcw, s["pts_l"], s["obs_l"], s["prob_l"],
                               obs.valid, True, bf, seg, s["pt_order"])
        assert _same(got, (s["W"], s["Hpp"], s["gp"], s["Hll"], s["gl"], s["cost_old"]))
    elif piece == "pk":
        assert torch.equal(gk.pose_sum(s["pk_rows"], seg).reshape(-1, 6, 6), s["Pk_sub"])
    elif piece == "rhs":
        got = gba._schur_rhs_coupling(s["W"], s["Cinv"], s["gl"], s["li"], seg)
        assert torch.equal(got, s["coupling"])
    elif piece == "mv":
        x = torch.from_numpy(np.random.default_rng(3).normal(size=(s["K"], 6)).astype(np.float32))
        y = gk.schur_point_pass(s["W"], s["Cinv"], x, s["pi"], s["li"], s["pt_order"])
        uy = mesh.psum(gk.schur_pose_pass(s["W"], y, s["li"], seg))
        assert torch.equal(torch.einsum("kij,kj->ki", s["Hpp_d"], x) - uy, s["mv"](x))
    elif piece == "pcg":
        got = gk.schur_pcg(s["W"], s["Cinv"], s["Hpp_d"], s["Pinv"], s["rhs"], s["pi"], s["li"],
                           s["pt_order"], seg, CG_ITERS, mesh.psum)
        assert torch.equal(got, seed_pcg(s["mv"], s["Pinv"], s["rhs"], CG_ITERS))
    else:
        lam = torch.tensor(1e-4)
        got = gba._gba_lm_step_ptblock(cam, prob.Rcw, prob.tcw, prob.points, obs, prob,
                                       obs.valid, True, lam, bf, CG_ITERS, mesh, seg,
                                       segment_order(s["li"], s["Mb"], obs.valid))
        assert _same(got, seed_step(cam, prob, obs, mesh, bf, CG_ITERS))


@pytest.mark.parametrize("kind", KINDS)
def test_pose_order_deals_invalid_rows_round_robin(systems, kind):
    """The card's slot order: each slot's valid rows in their order, then
    (mixed in by row) the rows that are not valid, row o to slot o mod K."""
    _, _, obs, _, _, s = systems[kind]
    K, O = s["K"], obs.valid.shape[0]
    seg = gk.pose_order(obs.pose_idx, K, obs.valid)
    assert seg.onehot is None and seg.perm.dtype == seg.starts.dtype == torch.int64
    assert seg.starts.shape == (K + 1,) and int(seg.starts[0]) == 0 and int(seg.starts[-1]) == O
    assert torch.equal(torch.sort(seg.perm).values, torch.arange(O))
    dealt = torch.where(obs.valid, obs.pose_idx.long(), torch.arange(O) % K)
    for k in range(K):
        rows = seg.perm[seg.starts[k]:seg.starts[k + 1]]
        assert torch.equal(rows, torch.nonzero(dealt == k)[:, 0])
    assert torch.equal(seg.perm, segment_order(obs.pose_idx, K, obs.valid)[0])
    if kind == "shard":
        assert not bool(obs.valid.all())
        pads = torch.nonzero(~obs.valid)[:, 0]
        lengths = seg.starts.diff()
        assert int(lengths.max()) < int(obs.valid.sum())  # no slot holds all the padding
        assert len(set((pads % K).tolist())) == min(K, len(pads))


@pytest.mark.parametrize("kind", KINDS)
def test_pcg_counters_on_the_cpu(systems, kind):
    """Every PCG iteration counts in ``gba_pcg_iters``, and on the CPU no
    kernel launches."""
    cam, prob, obs, mesh, bf, s = systems[kind]
    rec = timing.RECORDER
    saved, enabled = dict(rec.counters), timing.Recorder.enabled
    rec.counters.clear()
    timing.Recorder.enabled = True
    gk.reset_launch_counts()
    try:
        gba._gba_lm_step_ptblock(cam, prob.Rcw, prob.tcw, prob.points, obs, prob, obs.valid,
                                 True, torch.tensor(1e-4), bf, CG_ITERS, mesh,
                                 gba.pose_segments(obs, s["K"]), s["pt_order"])
        gk.schur_pcg(s["W"], s["Cinv"], s["Hpp_d"], s["Pinv"], s["rhs"], s["pi"], s["li"],
                     s["pt_order"], gba.pose_segments(obs, s["K"]), 5)
        assert rec.counters["gba_pcg_iters"] == CG_ITERS + 5
        assert rec.counters["gba_lm_steps"] == 1
        assert set(gk.launch_counts().values()) == {0}
    finally:
        timing.Recorder.enabled = enabled
        rec.counters.clear()
        rec.counters.update(saved)
