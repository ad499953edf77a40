"""Parity of the port's distribution slice with the JAX package on the CPU:
``parallel/dist_ba.py``, ``optim/gba.py``'s ``distributed_global_ba``,
``optim/pose_graph.py``'s ``distributed_pose_graph_sim3`` and the loop
closer's two sharded branches.

The port's mesh is n processes in a ``torch.distributed`` group over gloo,
started by ``spawn_mesh`` (spawn start method, a ``FileStore`` in a
temporary directory), one torch thread each; the ranks run
``scripts/torch_port_dist.py``'s jobs, which import numpy, torch and the
port only.  The JAX package runs on ``make_mesh`` of the same n over
conftest's 8 virtual devices, float32.  Its mesh calls cost 30-40 s each
here, nearly all compiling, so the four of them (distributed BA, GBA and
pose graph on 4 devices, the loop closer on 2) run in threads side by side
with the port's ranks, once for the module.  The tolerances are
``tests/test_dist_ba.py``'s:

- every public name of the JAX package's ``parallel/``, ``optim/gba.py``
  and ``optim/pose_graph.py`` exists in the port's;
- the three observation layouts for n in {1, 2, 3, 8} equal JAX's exactly;
- ``distributed_bundle_adjust`` on 4 ranks: rotations within 6e-3 and
  translations within 5e-2 of the truth, median point error under 0.05,
  and JAX's ``make_mesh(4)`` run within 1e-3; 1 rank against 4 at 14
  iterations within 5e-4 (translations) and 2e-3 (points);
- ``distributed_global_ba`` (8 poses, 200 points) on 4 ranks against the
  port's ``global_bundle_adjust`` and JAX's on 4 devices within 1e-3; again
  with a second camera, whose rows the cost shows on every shard;
- ``distributed_pose_graph_sim3`` on the 12-keyframe circle of
  ``tests/test_dist_ba.py:97-149``, on 4 ranks against the port's one-device
  graph and the JAX package's within 1e-4, scale free and fixed;
- the loop closer in a 2-rank group against JAX's ``LoopCloser`` with
  ``parallel.dist_ba.make_mesh`` patched to two devices: both take their
  sharded pose graph and GBA once, and the corrected keyframe poses agree
  within 1e-3;
- every rank returns the same tensors bit for bit and has loaded neither
  JAX nor the JAX package, and a rank that raises makes ``spawn_mesh``
  raise with its message.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import sim3 as jsim3
from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.optim import ba as jba
from orb_slam3_noted_tpu.optim import factors as jfac
from orb_slam3_noted_tpu.optim import gba as jgba
from orb_slam3_noted_tpu.optim import pose_graph as jpg
from orb_slam3_noted_tpu.parallel import dist_ba as jdist
from orb_slam3_noted_tpu.pipeline import loop_closing as jlc
from orb_slam3_noted_tpu.place import train_vocabulary
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.optim import ba as tba
from orb_slam3_noted_tpu_torch.optim import factors as tfac
from orb_slam3_noted_tpu_torch.optim import gba as tgba
from orb_slam3_noted_tpu_torch.optim import pose_graph as tpg
from orb_slam3_noted_tpu_torch.parallel import dist_ba as tdist
from orb_slam3_noted_tpu_torch.pipeline import loop_closing as tlc
from test_ba import PIN as JPIN
from test_ba import make_ba_scene
from test_torch_sim3 import LS, jax_sim3_sets, scaffold_maps

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import torch_port_dist as TD  # noqa: E402

CPU = torch.device("cpu")
PIN = Camera(PINHOLE, tuple(JPIN.params))
N_RANKS = 4
CLOSER_KW = dict(min_inliers=20, exclude_recent=3, consistency_th=0)
JAX_ROOTS = ("jax", "jaxlib", "orb_slam3_noted_tpu")
# a second pinhole camera 11 cm to the right, turned 0.02 rad about y
RRL = LS.rodrigues([0.0, 0.02, 0.0])
TRL = np.array([-0.11, 0.0, 0.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """JAX in float32 as in use; torch on one thread (the test workers run
    side by side)."""
    prev, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", prev)


def np_obs(obs) -> tfac.ReprojObs:
    """A JAX ``ReprojObs`` as the port's, fields as numpy arrays."""
    return tfac.ReprojObs(*(None if x is None else np.asarray(x) for x in obs))


def _close(a, b, tol, what):
    err = float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
    assert err <= tol, (what, err)


# ---------------------------------------------------------------------------
# the problems, from numpy (the scenes of tests/test_dist_ba.py)

def ba_problem():
    """``test_eight_device_mesh_matches_ground_truth``'s scene and start."""
    rng = np.random.default_rng(0)
    Rs, ts, pts, obs = make_ba_scene(rng, n_poses=6, n_points=100)
    K, M = len(Rs), len(pts)
    R0, t0 = Rs.copy(), ts.copy()
    for k in range(2, K):
        R0[k] = np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.01, 3).astype(np.float32)))) @ Rs[k]
        t0[k] = ts[k] + rng.normal(0, 0.05, 3)
    p0 = (pts + rng.normal(0, 0.05, size=pts.shape)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    start = (R0.astype(np.float32), t0.astype(np.float32), p0, obs, fixed, np.zeros(M, bool))
    return (Rs, ts, pts), start


def small_ba_problem():
    """``test_matches_single_device_result``'s scene and start."""
    rng = np.random.default_rng(0)
    Rs, ts, pts, obs = make_ba_scene(rng, n_poses=4, n_points=60)
    fixed = np.zeros(len(Rs), bool)
    fixed[:2] = True
    p0 = (pts + rng.normal(0, 0.03, size=pts.shape)).astype(np.float32)
    return (Rs, ts, p0, np_obs(obs), fixed, np.zeros(len(pts), bool))


def gba_problem(second_camera: bool):
    """``TestDistributedGBA``'s scene (8 poses, 200 points); with a second
    camera every observation also has its right pixel (0.5 px noise).
    Returns (truth, JAX problem, port problem of numpy arrays, rig)."""
    rng = np.random.default_rng(0)
    Rs, ts, pts, obs = make_ba_scene(rng, n_poses=8, n_points=200)
    K, M = len(Rs), len(pts)
    p0 = (pts + rng.normal(0, 0.04, size=pts.shape)).astype(np.float32)
    t0 = ts.copy()
    t0[2:] += rng.normal(0, 0.03, size=(K - 2, 3)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    rig = None
    if second_camera:
        pi, li = np.asarray(obs.pose_idx), np.asarray(obs.point_idx)
        xc = np.einsum("oij,oj->oi", Rs[pi], pts[li]) + ts[pi]
        uv2 = TD._project(JPIN.params, xc @ RRL.T + TRL) + rng.normal(0, 0.5, (len(pi), 2))
        obs = obs._replace(uv2=jnp.asarray(uv2.astype(np.float32)),
                           is_right=jnp.ones(len(pi), bool))
        rig = (RRL, TRL)
    jp = jba.BAProblem(Rcw=jnp.asarray(Rs), tcw=jnp.asarray(t0.astype(np.float32)),
                       points=jnp.asarray(p0), obs=obs, pose_fixed=jnp.asarray(fixed),
                       point_fixed=jnp.zeros(M, bool))
    tp = tba.BAProblem(Rcw=Rs, tcw=t0.astype(np.float32), points=p0, obs=np_obs(obs),
                       pose_fixed=fixed, point_fixed=np.zeros(M, bool))
    return (Rs, ts, pts), jp, tp, rig


def circle_graph():
    """``TestDistributedPoseGraph``'s 12-keyframe circle: the chain and one
    loop edge measured from the truth, translations drifted, keyframe 0
    fixed.  Returns (truth t, (R, t0, s, edges, fixed) in numpy)."""
    rng = np.random.default_rng(0)
    K = 12
    R_gt = np.stack([np.asarray(jso3.exp(jnp.asarray([0.0, 0.25 * k, 0.0], jnp.float32)))
                     for k in range(K)])
    t_gt = np.stack([np.array([0.4 * k, 0.0, 0.05 * k], np.float32) for k in range(K)])
    s_gt = np.ones(K, np.float32)
    i = np.asarray(list(range(K - 1)) + [0], np.int32)
    j = np.asarray(list(range(1, K)) + [K - 1], np.int32)
    Rr, tr, sr = jax.vmap(lambda a, b: jsim3.compose(b, jsim3.inverse(a)))(
        (jnp.asarray(R_gt[i]), jnp.asarray(t_gt[i]), jnp.asarray(s_gt[i])),
        (jnp.asarray(R_gt[j]), jnp.asarray(t_gt[j]), jnp.asarray(s_gt[j])))
    E = len(i)
    edges = tpg.Sim3Edges(i=i, j=j, R=np.asarray(Rr), t=np.asarray(tr), s=np.asarray(sr),
                          weight=np.ones(E, np.float32), valid=np.ones(E, bool))
    drift = rng.normal(0, 0.05, size=(K, 3)).astype(np.float32)
    drift[0] = 0.0
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return t_gt, (R_gt, t_gt + drift, s_gt, edges, fixed)


def j_graph(graph):
    R, t, s, e, fixed = graph
    return (jnp.asarray(R), jnp.asarray(t), jnp.asarray(s),
            jpg.Sim3Edges(*(jnp.asarray(x) for x in e)), jnp.asarray(fixed))


@pytest.fixture(scope="module")
def vocab():
    """``tests/test_loop_closing.py``'s 256-word vocabulary (the JAX package trains it)."""
    desc = LS.drifted_map_inputs(seed=0)["desc"]
    rng = np.random.default_rng(1)
    train = np.concatenate([desc, rng.integers(0, 2 ** 32, size=(2000, 8), dtype=np.uint32)])
    return np.asarray(train_vocabulary(train, n_words=256, n_iters=4))


def jax_loop(vocab):
    """The JAX loop closer on the drifted map with a mesh of two devices:
    (map after the correction, calls of its sharded pose graph and GBA)."""
    inp, jcfg, jm, _, _ = scaffold_maps(baseline=LS.BASELINE)
    tail = inp["n_kf"] - 1
    jl = jlc.LoopCloser(vocab, max_keyframes=32, **CLOSER_KW)
    for k in range(tail):
        jl.db.add(k, jl.db.compute_bow(jm.kf_desc[k], jm.kf_feat_valid[k])[1])
    js = LS.ScaffoldSlam(jm, inp["n_kf"], jcfg)
    assert jl.on_keyframe(js, tail)
    return js.m, jl


@pytest.fixture(scope="module")
def runs(_jax_float32, vocab):
    """Every mesh run of the module, side by side: the JAX package's four
    mesh calls (and its one-device references) in threads, the port's 4-rank
    jobs and 2-rank loop closer in spawned groups."""
    ba_truth, ba_start = ba_problem()
    small = small_ba_problem()
    gba = {cam2: gba_problem(cam2) for cam2 in (False, True)}
    circle_t, graph = circle_graph()
    m4 = jdist.make_mesh(4)
    # the functions themselves: the loop closer's calls go through counters
    mesh_fn, pg_fn = jdist.make_mesh, jpg.distributed_pose_graph_sim3
    gba_fn = jgba.run_global_ba_mesh

    def rig_kw(rig, lib):
        if rig is None:
            return {}
        if lib == "jax":
            return dict(cam2=JPIN, Rrl=jnp.asarray(rig[0]), trl=jnp.asarray(rig[1]))
        return dict(cam2=PIN, Rrl=torch.from_numpy(rig[0]), trl=torch.from_numpy(rig[1]))

    jax_jobs = {
        "ba": lambda: jdist.distributed_bundle_adjust(
            JPIN, m4, *(jnp.asarray(x) for x in ba_start[:3]), ba_start[3],
            jnp.asarray(ba_start[4]), jnp.asarray(ba_start[5]), n_iters=10),
        "gba": lambda: jgba.distributed_global_ba(JPIN, m4, gba[False][1], n_iters=6,
                                                  n_iters_final=3),
        # the second camera: the JAX package's one-device engine
        "gba_cam2": lambda: jgba.global_bundle_adjust(JPIN, gba[True][1], n_iters=6,
                                                      n_iters_final=3,
                                                      **rig_kw(gba[True][3], "jax")),
        "pg_free": lambda: pg_fn(m4, *j_graph(graph)),
        "pg_fixed": lambda: jpg.optimize_pose_graph_sim3(*j_graph(graph), fix_scale=True),
        "loop": lambda: jax_loop(vocab),
    }
    jcalls = {"pose_graph": 0, "gba": 0}

    def counted(key, fn):
        def call(*a, **k):
            jcalls[key] += 1
            return fn(*a, **k)
        return call

    port_jobs = {
        "ba": ("bundle_adjust", (PIN, *ba_start[:3], np_obs(ba_start[3]), *ba_start[4:]),
               dict(n_iters=10)),
        "ba14": ("bundle_adjust", (PIN, *small), dict(n_iters=14)),
        **{f"gba{'_cam2' if c else ''}": ("global_ba", (PIN, gba[c][2]),
                                          dict(n_iters=6, n_iters_final=3,
                                               **rig_kw(gba[c][3], "port")))
           for c in (False, True)},
        "pg_free": ("pose_graph", graph, {}),
        "pg_fixed": ("pose_graph", graph, dict(fix_scale=True)),
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdist, "make_mesh", lambda *a, **k: mesh_fn(2))
        mp.setattr(jpg, "distributed_pose_graph_sim3", counted("pose_graph", pg_fn))
        mp.setattr(jgba, "run_global_ba_mesh", counted("gba", gba_fn))
        with ThreadPoolExecutor(len(jax_jobs) + 2) as ex:
            futs = {k: ex.submit(f) for k, f in jax_jobs.items()}
            port4 = ex.submit(tdist.spawn_mesh, N_RANKS, TD.run_jobs, port_jobs, device=CPU)
            # meanwhile the port's one-device loop closer on the JAX
            # package's RANSAC draws, recorded by mask for the ranks
            inp, _, _, tcfg, tm = scaffold_maps(baseline=LS.BASELINE)
            table = []

            def recorded(valid, slot):
                sets = jax_sim3_sets(valid.numpy(), slot)
                table.append((valid.clone(), sets))
                return sets

            tl = tlc.LoopCloser(vocab, max_keyframes=32, device=CPU, **CLOSER_KW)
            tl._sim3_sets = recorded
            tail = inp["n_kf"] - 1
            for k in range(tail):
                tl.db.add(k, tl.db.compute_bow(tm.kf_desc[k], tm.kf_feat_valid[k])[1])
            assert tl.on_keyframe(LS.ScaffoldSlam(tm, inp["n_kf"], tcfg), tail)
            port2 = ex.submit(tdist.spawn_mesh, 2, TD.run_jobs, {
                "loop": ("loop_closer", (inp, tcfg, vocab, None, table), CLOSER_KW),
                "imported": ("imported", (JAX_ROOTS,), {})}, device=CPU)
            out = {k: f.result() for k, f in futs.items()}
            port4, port2 = port4.result(), port2.result()
    return dict(ba_truth=ba_truth, small=small, gba=gba, circle_t=circle_t, graph=graph,
                jax=out, jcalls=jcalls, port4=port4, port2=port2, tl=tl)


# ---------------------------------------------------------------------------
# layouts and the mesh

def _random_obs(rng, O=203, K=7, M=57, right=False):
    obs = dict(pose_idx=rng.integers(0, K, O).astype(np.int32),
               point_idx=rng.integers(0, M, O).astype(np.int32),
               uv=rng.uniform(0, 600, (O, 2)).astype(np.float32),
               uv_r=rng.uniform(0, 600, O).astype(np.float32),
               inv_sigma2=rng.uniform(0.2, 1, O).astype(np.float32),
               is_stereo=rng.uniform(size=O) < 0.5, valid=rng.uniform(size=O) < 0.9)
    if right:
        obs.update(uv2=rng.uniform(0, 600, (O, 2)).astype(np.float32),
                   is_right=rng.uniform(size=O) < 0.7)
    return obs


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_layouts_equal_jax(n):
    """``pad_obs_for_mesh``, ``shard_obs_by_point`` and
    ``shard_obs_by_point_block`` (pad rows with their shard's point id
    included), field by field, with and without right-camera rows."""
    rng = np.random.default_rng(n)
    for right in (False, True):
        obs = _random_obs(rng, right=right)
        jo = jfac.ReprojObs(**{k: jnp.asarray(v) for k, v in obs.items()})
        to = tfac.ReprojObs(**{k: torch.from_numpy(v) for k, v in obs.items()})
        block = -(-57 // n)
        for name, args in (("pad_obs_for_mesh", ()), ("shard_obs_by_point", ()),
                           ("shard_obs_by_point_block", (block,))):
            jr = getattr(jdist, name)(jo, n, *args)
            tr = getattr(tdist, name)(to, n, *args)
            for field, a, b in zip(tfac.ReprojObs._fields, jr, tr):
                assert (a is None) == (b is None), (name, field)
                if a is not None:
                    assert b.dtype == torch.from_numpy(np.array(a)).dtype, (name, field)
                    assert np.array_equal(np.asarray(a), b.numpy()), (name, field)


@pytest.mark.parametrize("name", ["parallel", "parallel.dist_ba", "optim.gba",
                                  "optim.pose_graph"])
def test_every_public_name_ported(name):
    """Each public function and class of the JAX package's module has a
    counterpart of the same name in the port's."""
    import importlib

    jmod = importlib.import_module(f"orb_slam3_noted_tpu.{name}")
    tmod = importlib.import_module(f"orb_slam3_noted_tpu_torch.{name}")
    public = [n for n in dir(jmod) if not n.startswith("_")
              and getattr(getattr(jmod, n), "__module__", "").startswith("orb_slam3_noted_tpu.")]
    assert public
    assert [n for n in public if not hasattr(tmod, n)] == []


def test_mesh_without_a_group():
    """Outside a group the mesh is the calling process alone: its
    collectives are the identity; a larger mesh needs a group."""
    mesh = tdist.make_mesh(1, device=CPU)
    assert (mesh.size, mesh.rank, mesh.axis_names, tdist.group_size()) == (1, 0, ("obs",), 1)
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.psum(x) is x and mesh.gather_rows(x) is x and mesh.collectives == 0
    with pytest.raises(ValueError):
        tdist.make_mesh(2, device=CPU)


def test_failing_rank_raises_in_the_caller():
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="rank 1 fails"):
        tdist.spawn_mesh(2, TD.run_jobs, {"x": ("raise_on_rank", (1, "rank 1 fails"), {})},
                         device=CPU, timeout_s=60)


def test_ranks_import_no_jax(runs):
    """A rank starts from a fresh interpreter and loads neither JAX nor the
    JAX package, though this process has both."""
    assert all(r["imported"]["out"] == [] for r in runs["port2"])
    assert "jax" in TD.imported(None, JAX_ROOTS)


def test_ranks_agree_bit_for_bit(runs):
    """Every job's every output tensor, on every rank, equal to rank 0's."""
    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            return [t for v in x.values() for t in tensors(v)]
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in tensors(v)]
        return []

    for group in (runs["port4"], runs["port2"]):
        first = tensors({k: v["out"] for k, v in group[0].items()})
        assert first
        for other in group[1:]:
            got = tensors({k: v["out"] for k, v in other.items()})
            assert len(got) == len(first)
            assert all(torch.equal(a, b) for a, b in zip(first, got))


# ---------------------------------------------------------------------------
# the solvers

def test_distributed_bundle_adjust(runs):
    """On 4 ranks: the truth within ``tests/test_dist_ba.py``'s limits, and
    JAX's ``make_mesh(4)`` run within 1e-3."""
    Rs, ts, pts = runs["ba_truth"]
    Rf, tf, pf, cost = runs["port4"][0]["ba"]["out"]
    np.testing.assert_allclose(Rf[2:].numpy(), Rs[2:], atol=6e-3)
    np.testing.assert_allclose(tf[2:].numpy(), ts[2:], atol=5e-2)
    assert np.median(np.linalg.norm(pf.numpy() - pts, axis=1)) < 0.05
    jR, jt, jp, jcost = runs["jax"]["ba"]
    _close(jR, Rf, 1e-3, "R")
    _close(jt, tf, 1e-3, "t")
    _close(jp, pf, 1e-3, "points")
    assert np.isfinite(float(cost))


def test_one_rank_against_four(runs):
    """``test_matches_single_device_result``: 14 iterations on the one-rank
    mesh of this process and on 4 ranks."""
    mesh1 = tdist.make_mesh(1, device=CPU)
    out1 = tdist.distributed_bundle_adjust(PIN, mesh1, *TD.to_device(runs["small"], CPU),
                                           n_iters=14)
    out4 = runs["port4"][0]["ba14"]["out"]
    _close(out1[1], out4[1], 5e-4, "t")
    _close(out1[2], out4[2], 2e-3, "points")


@pytest.mark.parametrize("second_camera", [False, True], ids=["mono", "two_cameras"])
def test_distributed_global_ba(runs, second_camera):
    """On 4 ranks against the port's one-device engine and the JAX
    package's (4 devices; one with a second camera) within 1e-3; the truth
    within ``tests/test_dist_ba.py``'s limits.  With a second camera the
    final cost counts the right rows on every shard: within 1% of the
    one-device engine's, and above the cost of the left rows alone."""
    (Rs, ts, pts), jp, tp, rig = runs["gba"][second_camera]
    kw = {} if rig is None else dict(cam2=PIN, Rrl=torch.from_numpy(rig[0]),
                                      trl=torch.from_numpy(rig[1]))
    prob = TD.to_device(tp, CPU)
    single = tgba.global_bundle_adjust(PIN, prob, n_iters=6, n_iters_final=3, **kw)
    R4, t4, p4, cost4 = runs["port4"][0]["gba_cam2" if second_camera else "gba"]["out"]
    np.testing.assert_allclose(t4[2:].numpy(), ts[2:], atol=5e-2)
    assert np.median(np.linalg.norm(p4.numpy() - pts, axis=1)) < 0.05
    _close(single.tcw, t4, 1e-3, "t vs one device")
    _close(single.points, p4, 1e-3, "points vs one device")
    j = runs["jax"]["gba_cam2" if second_camera else "gba"]
    jt, jpts = (j.tcw, j.points) if second_camera else (j[1], j[2])
    _close(jt, t4, 1e-3, "t vs JAX")
    _close(jpts, p4, 1e-3, "points vs JAX")
    assert abs(float(cost4) - float(single.cost)) <= 0.01 * float(single.cost)
    if second_camera:
        left = tgba.global_bundle_adjust(PIN, prob._replace(obs=prob.obs._replace(
            uv2=None, is_right=None)), n_iters=6, n_iters_final=3)
        assert float(cost4) > 1.5 * float(left.cost), (float(cost4), float(left.cost))


@pytest.mark.parametrize("fix_scale", [False, True], ids=["sim3", "scale_fixed"])
def test_distributed_pose_graph(runs, fix_scale):
    """On 4 ranks (13 edges padded to 16) against the port's one-device graph
    and the JAX package's (4 devices; scale fixed on one) within 1e-4; the
    truth within 5e-3, as ``tests/test_dist_ba.py``."""
    key = "pg_fixed" if fix_scale else "pg_free"
    R4, t4, s4, cost4 = runs["port4"][0][key]["out"]
    single = tpg.optimize_pose_graph_sim3(*TD.to_device(runs["graph"], CPU), fix_scale=fix_scale)
    for a, b, what in zip(single[:3], (R4, t4, s4), "Rts"):
        _close(a, b, 1e-4, what + " vs one device")
    for a, b, what in zip(runs["jax"][key][:3], (R4, t4, s4), "Rts"):
        _close(a, b, 1e-4, what + " vs JAX")
    _close(t4, runs["circle_t"], 5e-3, "t vs truth")
    if fix_scale:
        assert torch.equal(s4, torch.ones_like(s4))


def test_loop_closer_sharded_branches(runs):
    """The loop closer in a 2-rank group and JAX's with a 2-device mesh:
    each runs its sharded pose graph once and its sharded GBA once, at once
    (no sliced GBA), with the fuses queued; the corrected keyframe poses
    within 1e-3 of each other, and the tail's points within 1e-3 m of the
    truth.  In this process (no group) the port takes the one-device
    branches."""
    got = runs["port2"][0]["loop"]["out"]
    jm, jl = runs["jax"]["loop"]
    assert got["closed"] and got["loop_edges"] == jl.loop_edges == [(LS.SMALL["n_kf"] - 1, 0)]
    assert got["calls"] == runs["jcalls"] == {"pose_graph": 1, "gba": 1}
    assert not got["sliced_gba"] and jl.active_gba is None
    assert got["post_fuse"] == jl._post_fuse == [0, LS.SMALL["n_kf"] - 1]
    _close(jm.kf_Rcw, got["map"].kf_Rcw, 1e-3, "R")
    _close(jm.kf_tcw, got["map"].kf_tcw, 1e-3, "t")
    inp = LS.drifted_map_inputs(seed=0, baseline=LS.BASELINE, **LS.SMALL)
    err, _ = LS.corrected_point_errors(got["map"].mp_pos.numpy(), inp)
    assert np.median(err) < 1e-3, np.median(err)
    assert runs["tl"].active_gba is not None  # the one-device branch here
