"""What the ranks of a mesh run for the port's distributed paths, and the
problems they run on (numpy, torch and the port only: a rank starts from a
fresh interpreter on a machine that may have no JAX).

``parallel.dist_ba.spawn_mesh`` pickles a rank's function by its module
and name, so a caller puts this directory on ``sys.path`` and imports the
module as ``torch_port_dist``::

    sys.path.insert(0, "scripts")
    import torch_port_dist as TD
    from orb_slam3_noted_tpu_torch.parallel.dist_ba import spawn_mesh
    outs = spawn_mesh(2, TD.run_jobs, {"pg": ("pose_graph", args, {})}, device="cpu")

``run_jobs`` runs named jobs one after another on every rank, each with
the card synchronised around it, and returns each job's output, its ms a
call and the collectives a call made.  ``tests/test_torch_dist.py`` and
``chip_smoke.py``'s phase 16 drive it.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

import loop_scaffold as LS
from orb_slam3_noted_tpu_torch.optim.ba import BAProblem
from orb_slam3_noted_tpu_torch.optim.factors import ReprojObs
from orb_slam3_noted_tpu_torch.optim.pose_graph import Sim3Edges


def to_device(x, dev):
    """numpy arrays and tensors anywhere in tuples, lists, dicts and
    NamedTuples as tensors on ``dev`` (uint32 as int32 bits)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x.view(np.int32) if x.dtype == np.uint32 else x))
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, dev) for v in x)
    return x


# ---------------------------------------------------------------------------
# the jobs: each takes the mesh first, its inputs on the host

def bundle_adjust(mesh, cam, R, t, points, obs, pose_fixed, point_fixed, n_iters=10):
    from orb_slam3_noted_tpu_torch.parallel.dist_ba import distributed_bundle_adjust

    args = to_device((R, t, points, obs, pose_fixed, point_fixed), mesh.device)
    return distributed_bundle_adjust(cam, mesh, *args, n_iters=n_iters)


def global_ba(mesh, cam, prob, **kw):
    from orb_slam3_noted_tpu_torch.optim.gba import distributed_global_ba

    kw = {k: to_device(v, mesh.device) for k, v in kw.items()}
    return distributed_global_ba(cam, mesh, to_device(prob, mesh.device), **kw)


def pose_graph(mesh, R, t, s, edges, fixed, **kw):
    from orb_slam3_noted_tpu_torch.optim.pose_graph import distributed_pose_graph_sim3

    return distributed_pose_graph_sim3(mesh, *to_device((R, t, s, edges, fixed), mesh.device),
                                       **kw)


def loop_closer(mesh, inp, cfg, vocab, idf=None, sim3_table=None, **closer_kw):
    """The drifted map of ``loop_scaffold`` on the rank's device, a loop
    closer with every keyframe but the tail in its database, and the tail's
    detection and correction.  ``sim3_table``: (valid mask, (128, 3) sets)
    pairs that replace the closer's RANSAC draws for those masks; else its
    own generator's.  Returns the loop, the calls of the sharded pose graph
    and GBA, the collectives of the closer's meshes, the keyframe poses and
    points the GBA started from, and the map after the correction (a sliced
    GBA, where one started, not run)."""
    from orb_slam3_noted_tpu_torch.pipeline import loop_closing as LC
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS

    dev = mesh.device
    m = LS.build_map(MS, MS.empty_map(cfg, device=dev), inp, lambda a: to_device(a, dev))
    lc = LC.LoopCloser(vocab, cfg.max_keyframes, idf=idf, device=dev, **closer_kw)
    if sim3_table is not None:
        def table_sets(valid, slot):
            hits = [s for v, s in sim3_table if torch.equal(v, valid.cpu())]
            if len(hits) != 1:
                raise LookupError(f"no RANSAC draws for this mask of slot {slot}")
            return hits[0].to(dev)
        lc._sim3_sets = table_sets
    tail = inp["n_kf"] - 1
    for k in range(tail):
        lc.db.add(k, lc.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])[1])
    slam = LS.ScaffoldSlam(m, inp["n_kf"], cfg)
    calls, before_gba, meshes = {"pose_graph": 0, "gba": 0}, {}, []
    pg, gba, make = LC.distributed_pose_graph_sim3, LC.run_global_ba_mesh, LC.make_mesh

    def kept_mesh(*args, **kw):  # the closer's own meshes, for their collectives
        meshes.append(make(*args, **kw))
        return meshes[-1]

    def counted_pg(*args, **kw):
        calls["pose_graph"] += 1
        return pg(*args, **kw)

    def counted_gba(m_, *args, **kw):
        calls["gba"] += 1
        before_gba.update(R=m_.kf_Rcw.clone(), t=m_.kf_tcw.clone(), points=m_.mp_pos.clone())
        return gba(m_, *args, **kw)

    LC.distributed_pose_graph_sim3, LC.run_global_ba_mesh, LC.make_mesh = (
        counted_pg, counted_gba, kept_mesh)
    closed = lc.on_keyframe(slam, tail)
    LC.distributed_pose_graph_sim3, LC.run_global_ba_mesh, LC.make_mesh = pg, gba, make
    return {"closed": closed, "loop_edges": lc.loop_edges, "calls": calls,
            "collectives": sum(x.collectives for x in meshes),
            "post_fuse": list(lc._post_fuse), "sliced_gba": lc.active_gba is not None,
            "before_gba": before_gba, "map": slam.m}


def raise_on_rank(mesh, rank: int, message: str):
    """Rank ``rank`` raises ``message``; the others wait in a collective."""
    if mesh.rank == rank:
        raise RuntimeError(message)
    return mesh.psum(torch.ones(1, device=mesh.device))


def imported(mesh, roots: tuple) -> list:
    """The modules this rank has loaded whose top-level name is in ``roots``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in roots)


JOBS = {"bundle_adjust": bundle_adjust, "global_ba": global_ba, "pose_graph": pose_graph,
        "loop_closer": loop_closer, "raise_on_rank": raise_on_rank, "imported": imported}


def run_jobs(mesh, jobs: dict, reps: int = 1):
    """Every job of ``jobs`` ({name: (job, args, kwargs)}) ``reps`` times in
    order on this rank: {name: {"out": the last call's output, "ms": ms a
    call (the card synchronised before and after), "collectives": a call's
    reductions}}."""
    cuda = mesh.device.type == "cuda"
    res = {}
    for name, (job, args, kw) in jobs.items():
        ms = []
        for _ in range(reps):
            if cuda:
                torch.cuda.synchronize(mesh.device)
            n0, t0 = mesh.collectives, time.perf_counter()
            out = JOBS[job](mesh, *args, **kw)
            if cuda:
                torch.cuda.synchronize(mesh.device)
            ms.append((time.perf_counter() - t0) * 1e3)
        res[name] = {"out": out, "ms": ms, "collectives": mesh.collectives - n0}
    return res


# ---------------------------------------------------------------------------
# the problems of the JAX package's multi-device dry run, in numpy

PIN = LS.FULL["cam"]  # EuRoC-sized pinhole (fx, fy, cx, cy)


def _project(cam, xc):
    fx, fy, cx, cy = cam
    return np.stack([fx * xc[:, 0] / xc[:, 2] + cx, fy * xc[:, 1] / xc[:, 2] + cy], -1)


def capacity_gba_problem(seed: int = 0, K: int = 256, M: int = 16384, per_kf: int = 1200,
                         pix_noise: float = 0.5, orbit_m: float = 14.0):
    """The full-capacity GBA of ``__graft_entry__.py:104-150`` (256
    keyframes, 16,384 points, 1,200 observations a keyframe, 307,200 in
    all), drawn from the same generator in the same order: after the dry
    run's first draw, the points in [-4, 4]^2 x [6, 14] m, then each
    keyframe's 1,200 points; keyframe k turned 0.01 k rad about y, every
    point moved by 0.01 m.  Three changes make it a map whose optimum two
    summation orders share.  The dry run moves keyframe k 0.1 k m along x,
    so that 39% of its observations lie behind their camera and 85% outside
    the 752x480 image (193 keyframes see no point in it); here keyframe k
    sits ``orbit_m`` from the cloud's centre and looks at it, turned as in
    the dry run.  It fixes keyframes 0 and 1, 0.14 m apart 14 m from the
    cloud, which leaves the scale to a weak mode (two summation orders put
    the last keyframe 8e-4 m apart); here keyframes 0 and K/2 are fixed.
    Its projections are exact, so its optimum costs nothing and no two
    costs compare; here each pixel gets ``pix_noise`` px of normal noise
    (the same generator, last).  Returns a ``BAProblem`` of numpy arrays."""
    rng = np.random.default_rng(seed)
    rng.uniform(-2, 2, size=(64, 3))  # the dry run's small problem comes first
    centre = np.array([0, 0, 10.0])
    pts = (rng.uniform(-4, 4, size=(M, 3)) + centre).astype(np.float32)
    th = 0.01 * np.arange(K)
    Rs = np.stack([LS.rodrigues([0.0, a, 0.0]) for a in th])
    # the camera centre on the orbit, on the cloud's side that its axis faces
    c = centre + orbit_m * np.stack([np.sin(th), np.zeros(K), -np.cos(th)], -1)
    ts = -np.einsum("kij,kj->ki", Rs.astype(np.float64), c).astype(np.float32)
    sel = np.stack([rng.choice(M, size=per_kf, replace=False) for _ in range(K)])
    pose_idx = np.repeat(np.arange(K), per_kf)
    point_idx = sel.reshape(-1)
    xc = (np.einsum("oij,oj->oi", Rs[pose_idx], pts[point_idx]) + ts[pose_idx]).astype(np.float32)
    O = K * per_kf
    obs = ReprojObs(pose_idx=pose_idx.astype(np.int32), point_idx=point_idx.astype(np.int32),
                    uv=(_project(PIN, xc) + rng.normal(0, pix_noise, (O, 2))).astype(np.float32),
                    uv_r=np.full(O, -1.0, np.float32), inv_sigma2=np.ones(O, np.float32),
                    is_stereo=np.zeros(O, bool), valid=np.ones(O, bool))
    fixed = np.zeros(K, bool)
    fixed[[0, K // 2]] = True
    return BAProblem(Rcw=Rs, tcw=ts, points=pts + np.float32(0.01), obs=obs, pose_fixed=fixed,
                     point_fixed=np.zeros(M, bool))


def capacity_pose_graph(prob: BAProblem, seed: int = 1, drift_m: float = 0.05):
    """The sharded essential graph of ``__graft_entry__.py:184-216`` on the
    capacity problem's keyframes: the chain, edges 5 apart and 1,200 random
    pairs (seed 1) less self-loops, measured from the poses, weight 1;
    keyframe 0 fixed.  The dry run starts at the optimum; here every free
    keyframe's translation starts ``drift_m`` (normal, the same generator
    after the pairs) off it, so the optimiser has work.  Returns (R, t, s,
    Sim3Edges, fixed) in numpy."""
    K = prob.Rcw.shape[0]
    ei = list(range(K - 1)) + list(range(K - 5))
    ej = list(range(1, K)) + list(range(5, K))
    rng = np.random.default_rng(seed)
    extra = rng.integers(0, K, size=(1200, 2))
    ei += list(extra[:, 0])
    ej += list(extra[:, 1])
    keep = [a != b for a, b in zip(ei, ej)]
    i = np.asarray([a for a, k in zip(ei, keep) if k], np.int32)
    j = np.asarray([b for b, k in zip(ej, keep) if k], np.int32)
    R, t = prob.Rcw.astype(np.float64), prob.tcw.astype(np.float64)
    # S_ji = S_j S_i^-1 at scale 1: R_j R_i^T, t_j - R_j R_i^T t_i
    Rr = np.einsum("eab,ecb->eac", R[j], R[i])
    tr = t[j] - np.einsum("eab,eb->ea", Rr, t[i])
    E = len(i)
    edges = Sim3Edges(i=i, j=j, R=Rr.astype(np.float32), t=tr.astype(np.float32),
                      s=np.ones(E, np.float32), weight=np.ones(E, np.float32),
                      valid=np.ones(E, bool))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    t0 = (prob.tcw + np.where(fixed[:, None], 0.0, rng.normal(0, drift_m, (K, 3)))).astype(
        np.float32)
    return prob.Rcw, t0, np.ones(K, np.float32), edges, fixed
