"""Parity of the port's Sim(3) geometry and loop verification with the JAX
package on the CPU: ``geometry/sim3.py``, ``geometry/sim3_solver.py`` and
``optim/sim3_opt.py``.

- the group operations (exp, log, compose, inverse, apply, from_se3,
  identity) within 1e-5;
- ``sim3_ransac`` on the JAX package's minimal sets, replayed here from the
  same key (``sim3_solver.py:54-56``), on the cases of
  ``tests/test_loop_opt.py:17-52``: R and s within 1e-4, t within 1e-4 m,
  the same inliers;
- ``search_by_sim3`` on the drifted map of ``scripts/loop_scaffold.py``
  built from the same numpy arrays in both packages: >= 99% of the pairs
  equal;
- ``optimize_sim3`` and ``sim3_refine`` on that map with a baseline between
  the loop's two views (at zero baseline the refinement's scale is a free
  gauge, ROADMAP Queue 3): R and s within 1e-4, t within 1e-3 m, inliers
  +-1.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import sim3 as jsim3
from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.geometry.sim3_solver import sim3_ransac as jransac
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.optim import sim3_opt as jopt
from orb_slam3_noted_tpu.pipeline import map_state as jms
from orb_slam3_noted_tpu.pipeline.loop_closing import _matched_point_pairs as jpairs
from orb_slam3_noted_tpu_torch.geometry import sim3 as tsim3
from orb_slam3_noted_tpu_torch.geometry.sim3_solver import N_HYP, sim3_ransac as transac
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.optim import sim3_opt as topt
from orb_slam3_noted_tpu_torch.pipeline import map_state as tms
from orb_slam3_noted_tpu_torch.pipeline.loop_closing import _matched_point_pairs as tpairs

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import loop_scaffold as LS  # noqa: E402

CPU = torch.device("cpu")
GROUP_TOL = 1e-5
RANSAC_TOL = 1e-4
REFINE_R_TOL, REFINE_T_TOL = 1e-4, 1e-3


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


def jax_sim3_sets(valid, slot: int, n_hyp: int = N_HYP) -> torch.Tensor:
    """(n_hyp, 3) minimal sets as ``sim3_ransac`` draws them from
    ``PRNGKey(slot)`` (``sim3_solver.py:54-56``)."""
    valid = jnp.asarray(np.asarray(valid))
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    sets = jax.vmap(lambda k: jax.random.choice(k, valid.shape[0], shape=(3,), replace=False,
                                                p=p))(jax.random.split(jax.random.PRNGKey(slot),
                                                                       n_hyp))
    return torch.from_numpy(np.asarray(sets)).long()


def t_asarray(a):
    """numpy -> CPU tensor, uint32 descriptors as int32 bits (the port's layout)."""
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32 else a))


def scaffold_maps(size=LS.SMALL, baseline=LS.BASELINE, seed=0):
    """(inputs, JAX config, JAX map, port config, port map) of the drifted
    map, the same numpy arrays written by each package's map_state."""
    inp = LS.drifted_map_inputs(seed=seed, baseline=baseline, **size)
    kw = dict(width=size["width"], height=size["height"], n_features=size["n_pts"],
              max_keyframes=size["max_keyframes"], max_map_points=size["max_map_points"])
    jcfg = JConfig(camera=JCamera(0, size["cam"]), **kw)
    tcfg = SlamConfig(camera=Camera(PINHOLE, size["cam"]), **kw)
    jm = LS.build_map(jms, jms.empty_map(jcfg), inp, jnp.asarray)
    tm = LS.build_map(tms, tms.empty_map(tcfg, device=CPU), inp, t_asarray)
    return inp, jcfg, jm, tcfg, tm


def _close(a, b, tol, what):
    err = float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
    assert err <= tol, (what, err)


# ---------------------------------------------------------------------------
# the group

def _xi(seed=0, n=24):
    xi = np.random.default_rng(seed).normal(0, 0.4, (n, 7)).astype(np.float32)
    xi[:4, 3:6] = 0.0      # no rotation: the small-angle branch
    xi[4:8, 6] = 0.0       # no scale: the small-scale branch
    xi[8:10, 3:] = 0.0     # neither
    return xi


def test_sim3_exp_log():
    xi = _xi()
    js, ts = jsim3.exp(jnp.asarray(xi)), tsim3.exp(torch.from_numpy(xi))
    for a, b, what in zip(js, ts, "Rts"):
        _close(a, b.numpy(), GROUP_TOL, what)
    _close(jsim3.log(js), tsim3.log(ts).numpy(), GROUP_TOL, "log")
    # log inverts exp
    _close(tsim3.log(ts).numpy(), xi, 1e-4, "log(exp)")


def test_sim3_compose_inverse_apply():
    a, b = _xi(1), _xi(2)
    x = np.random.default_rng(3).normal(0, 2, (24, 3)).astype(np.float32)
    ja, jb = jsim3.exp(jnp.asarray(a)), jsim3.exp(jnp.asarray(b))
    ta, tb = tsim3.exp(torch.from_numpy(a)), tsim3.exp(torch.from_numpy(b))
    for jr, tr in ((jsim3.compose(ja, jb), tsim3.compose(ta, tb)),
                   (jsim3.inverse(ja), tsim3.inverse(ta))):
        for u, v in zip(jr, tr):
            _close(u, v.numpy(), GROUP_TOL, "compose/inverse")
    _close(jsim3.apply(ja, jnp.asarray(x)), tsim3.apply(ta, torch.from_numpy(x)).numpy(),
           GROUP_TOL, "apply")
    # S S^-1 = identity
    R, t, s = tsim3.compose(ta, tsim3.inverse(ta))
    I = tsim3.identity()
    _close(R.numpy(), np.broadcast_to(I[0].numpy(), R.shape), GROUP_TOL, "S S^-1")
    _close(t.numpy(), 0.0, 1e-4, "S S^-1 t")
    _close(s.numpy(), 1.0, GROUP_TOL, "S S^-1 s")
    Rj = np.array(ja[0])
    jr = jsim3.from_se3(jnp.asarray(Rj), jnp.asarray(x))
    tr = tsim3.from_se3(torch.from_numpy(Rj), torch.from_numpy(x))
    for u, v in zip(jr, tr):
        _close(u, v.numpy(), 0.0, "from_se3")


# ---------------------------------------------------------------------------
# RANSAC (tests/test_loop_opt.py:17-52)

def _ransac_case(rng, n=120, outliers=40, scale=1.4):
    x1 = (rng.uniform(-2, 2, size=(n, 3)) + np.array([0, 0, 5.0])).astype(np.float32)
    R = np.asarray(jso3.exp(jnp.asarray([0.1, 0.3, -0.2], jnp.float32)))
    t = np.asarray([0.5, -1.0, 0.3], np.float32)
    x2 = (scale * (x1 @ R.T) + t + rng.normal(0, 0.005, size=(n, 3))).astype(np.float32)
    bad = rng.choice(n, size=outliers, replace=False)
    x2[bad] += rng.uniform(1, 3, size=(outliers, 3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, size=5, replace=False)] = False
    return x1, x2, valid, bad, R, t


@pytest.mark.parametrize("fix_scale", [False, True])
@pytest.mark.parametrize("slot", [0, 7])
def test_sim3_ransac_on_jax_sets(fix_scale, slot):
    rng = np.random.default_rng(slot)
    x1, x2, valid, bad, R, t = _ransac_case(rng, scale=1.0 if fix_scale else 1.4)
    jr = jransac(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), jax.random.PRNGKey(slot),
                 fix_scale=fix_scale)
    tr = transac(torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(valid),
                 jax_sim3_sets(valid, slot), fix_scale=fix_scale)
    assert bool(tr.success) == bool(jr.success) and bool(tr.success)
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    assert int(tr.n_inliers) == int(jr.n_inliers)
    assert not tr.inliers.numpy()[bad].any() and not tr.inliers.numpy()[~valid].any()
    _close(tr.R.numpy(), jr.R, RANSAC_TOL, "R")
    _close(tr.s.numpy(), jr.s, RANSAC_TOL, "s")
    _close(tr.t.numpy(), jr.t, RANSAC_TOL, "t")
    _close(tr.R.numpy(), R, 5e-3, "R vs truth")
    if fix_scale:
        assert float(tr.s) == 1.0


def test_sim3_ransac_draws_are_minimal_sets_of_valid_pairs():
    """The port's own draws (``LoopCloser._sim3_sets``): 128 sets of three
    distinct valid pairs, the same for the same slot."""
    from orb_slam3_noted_tpu_torch.pipeline.loop_closing import LoopCloser

    vocab = np.random.default_rng(0).integers(0, 2 ** 32, size=(64, 8), dtype=np.uint32)
    lc = LoopCloser(vocab, 8, device=CPU)
    valid = torch.from_numpy(np.random.default_rng(1).random(300) < 0.3)
    sets = lc._sim3_sets(valid, 5)
    assert sets.shape == (N_HYP, 3) and bool(valid[sets].all())
    assert all(len(set(r)) == 3 for r in sets.tolist())
    assert torch.equal(sets, lc._sim3_sets(valid, 5))
    assert not torch.equal(sets, lc._sim3_sets(valid, 6))


# ---------------------------------------------------------------------------
# the ladder on the drifted map

@pytest.fixture(scope="module")
def maps():
    return scaffold_maps()


def _ransac_both(maps):
    inp, jcfg, jm, tcfg, tm = maps
    tail = inp["n_kf"] - 1
    jx = jpairs(jm, jnp.int32(tail), jnp.int32(0))
    tx = tpairs(tm, tail, 0)
    np.testing.assert_array_equal(tx[2].numpy(), np.asarray(jx[2]))
    np.testing.assert_array_equal(tx[3].numpy()[tx[2].numpy()], np.asarray(jx[3])[tx[2].numpy()])
    jr = jransac(jx[0], jx[1], jx[2], jax.random.PRNGKey(tail))
    tr = transac(tx[0], tx[1], tx[2], jax_sim3_sets(tx[2].numpy(), tail))
    return tail, jx, tx, jr, tr


def test_matched_point_pairs_and_ransac_on_the_map(maps):
    inp = maps[0]
    _, jx, tx, jr, tr = _ransac_both(maps)
    for a, b in zip(jx[:2], tx[:2]):
        _close(a, b.numpy(), 1e-5, "pairs")
    assert int(tr.n_inliers) == int(jr.n_inliers) == inp["n_pts"]
    _close(tr.s.numpy(), jr.s, RANSAC_TOL, "s")
    _close(tr.R.numpy(), jr.R, RANSAC_TOL, "R")
    _close(tr.t.numpy(), jr.t, RANSAC_TOL, "t")
    _close(tr.s.numpy(), LS.DRIFT_SCALE, 1e-3, "s vs the drift")


def test_search_by_sim3(maps):
    inp, jcfg, jm, tcfg, tm = maps
    tail, jx, tx, jr, tr = _ransac_both(maps)
    # a perturbed guess, so both directions must find the pairs by projection
    dR = np.asarray(jso3.exp(jnp.asarray([0.002, -0.001, 0.001], jnp.float32)))
    R0 = (dR @ np.asarray(jr.R)).astype(np.float32)
    t0 = (np.asarray(jr.t) + np.float32(0.01)).astype(np.float32)
    s0 = np.float32(jr.s)
    jc, jok = jopt.search_by_sim3(jm, jnp.int32(tail), jnp.int32(0), jnp.asarray(R0),
                                  jnp.asarray(t0), jnp.asarray(s0), jcfg.camera, jcfg)
    tc, tok = topt.search_by_sim3(tm, tail, 0, torch.from_numpy(R0), torch.from_numpy(t0),
                                  torch.tensor(s0), tcfg.camera, tcfg)
    jc, jok = np.asarray(jc), np.asarray(jok)
    same = np.mean((tc.numpy() == jc) & (tok.numpy() == jok))
    assert same >= 0.99, same
    assert tok.numpy().sum() > 0.5 * inp["n_pts"]
    # the seeded form keeps the RANSAC pairs where the growth found none
    seed_ok = jx[2] & jr.inliers
    jc2, jok2 = jopt.search_by_sim3(jm, jnp.int32(tail), jnp.int32(0), jr.R, jr.t, jr.s,
                                    jcfg.camera, jcfg, seed_idx=jx[3], seed_ok=seed_ok)
    tc2, tok2 = topt.search_by_sim3(tm, tail, 0, tr.R, tr.t, tr.s, tcfg.camera, tcfg,
                                    seed_idx=tx[3], seed_ok=tx[2] & tr.inliers)
    same = np.mean((tc2.numpy() == np.asarray(jc2)) & (tok2.numpy() == np.asarray(jok2)))
    assert same >= 0.99, same


def test_sim3_refine_with_a_baseline(maps):
    inp, jcfg, jm, tcfg, tm = maps
    tail, jx, tx, jr, tr = _ransac_both(maps)
    jref = jopt.sim3_refine(jm, jnp.int32(tail), jnp.int32(0), jr.R, jr.t, jr.s, jcfg.camera,
                            jcfg, seed_idx=jx[3], seed_ok=jx[2] & jr.inliers)
    tref = topt.sim3_refine(tm, tail, 0, tr.R, tr.t, tr.s, tcfg.camera, tcfg,
                            seed_idx=tx[3], seed_ok=tx[2] & tr.inliers)
    _close(tref.R.numpy(), jref.R, REFINE_R_TOL, "R")
    _close(tref.s.numpy(), jref.s, REFINE_R_TOL, "s")
    _close(tref.t.numpy(), jref.t, REFINE_T_TOL, "t")
    assert abs(int(tref.n_inliers) - int(jref.n_inliers)) <= 1
    assert int(tref.n_matches) == int(jref.n_matches)
    _close(tref.s.numpy(), LS.DRIFT_SCALE, 1e-3, "s vs the drift")


def test_optimize_sim3_from_a_perturbed_guess(maps):
    """``optimize_sim3`` alone on the true pairs, from a guess 0.01 rad,
    2 cm and 2% off, unscaled and with ``fix_scale``."""
    inp, jcfg, jm, tcfg, tm = maps
    tail = inp["n_kf"] - 1
    n = inp["n_pts"]
    Xc_cur, _ = topt._cam_points(tm, tail)
    Xc_cand, _ = topt._cam_points(tm, 0)
    uv_cur, uv_cand = tm.kf_xy[tail], tm.kf_xy[0]
    inv = torch.ones(n)
    ok = torch.ones(n, dtype=torch.bool)
    Rd, td, sd = inp["S_drift"]
    # S_cur_cand maps keyframe 0's camera frame into the tail's
    S = tsim3.compose((tm.kf_Rcw[tail], tm.kf_tcw[tail], torch.ones(())),
                      tsim3.compose((torch.from_numpy(Rd), torch.from_numpy(td),
                                     torch.tensor(sd)),
                                    tsim3.inverse((tm.kf_Rcw[0], tm.kf_tcw[0], torch.ones(())))))
    dR = torch.from_numpy(np.asarray(jso3.exp(jnp.asarray([0.01, 0.0, -0.005], jnp.float32))))
    R0, t0, s0 = dR @ S[0], S[1] + 0.02, S[2] * 1.02
    for fix_scale in (False, True):
        args = (Xc_cand, Xc_cur, uv_cur, uv_cand, inv, inv, ok)
        jres = jopt.optimize_sim3(jcfg.camera, *(jnp.asarray(x.numpy()) for x in (R0, t0, s0)),
                                  *(jnp.asarray(x.numpy()) for x in args), fix_scale=fix_scale)
        tres = topt.optimize_sim3(tcfg.camera, R0, t0, s0, *args, fix_scale=fix_scale)
        _close(tres.R.numpy(), jres.R, REFINE_R_TOL, "R")
        _close(tres.s.numpy(), jres.s, REFINE_R_TOL, "s")
        _close(tres.t.numpy(), jres.t, REFINE_T_TOL, "t")
        assert abs(int(tres.n_inliers) - int(jres.n_inliers)) <= 1
        if fix_scale:
            assert float(tres.s) == pytest.approx(float(s0))
        else:
            _close(tres.s.numpy(), S[2].numpy(), 1e-3, "s vs the truth")
