"""Parity of the port's Sim(3) pose graph (``optim/pose_graph.py``) with the
JAX package on the CPU.

The loop-drift case of ``tests/test_loop_opt.py:54-138`` (a 30-keyframe
circle, exact odometry edges, one loop edge, estimates integrated with
noise and scale creep) goes through both packages from the same numpy
arrays: poses within 1e-4 (rotation entries, scale) and 1e-3 m
(translation); the port must also pass the reference test's own checks.
The same with ``fix_scale`` (the stereo / RGB-D 6-DoF graph), with an
invalid edge and a second fixed vertex, and the edge Jacobians (forward-mode
derivatives here, ``jax.jacfwd`` there) within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import sim3 as jsim3
from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.optim import pose_graph as jpg
from orb_slam3_noted_tpu_torch.geometry import sim3 as tsim3
from orb_slam3_noted_tpu_torch.optim import pose_graph as tpg

R_TOL, T_TOL, JAC_TOL = 1e-4, 1e-3, 1e-5


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


def loop_graph(seed=0, K=30, scale_creep=0.01):
    """(ground truth (R, t, s), edge arrays, drifted estimates (R, t, s)) as
    numpy float32, built as ``TestPoseGraph.test_loop_drift_correction``."""
    rng = np.random.default_rng(seed)
    Rg, tg = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        Rwk = np.asarray(jso3.exp(jnp.asarray([0.0, a, 0.0], jnp.float32)))
        twk = np.array([2 * np.sin(a), 0.0, 2 - 2 * np.cos(a)])
        Rg.append(Rwk.T)
        tg.append(-Rwk.T @ twk)
    Rg = np.stack(Rg).astype(np.float32)
    tg = np.stack(tg).astype(np.float32)
    sg = np.ones(K, np.float32)

    def rel(i, j):
        Si = (jnp.asarray(Rg[i]), jnp.asarray(tg[i]), jnp.asarray(sg[i]))
        Sj = (jnp.asarray(Rg[j]), jnp.asarray(tg[j]), jnp.asarray(sg[j]))
        return jsim3.compose(Sj, jsim3.inverse(Si))

    pairs = [(k, k + 1) for k in range(K - 1)] + [(K - 1, 0)]
    eR, et, es = zip(*(tuple(np.asarray(x) for x in rel(i, j)) for i, j in pairs))
    edges = dict(i=np.asarray([p[0] for p in pairs], np.int32),
                 j=np.asarray([p[1] for p in pairs], np.int32),
                 R=np.stack(eR).astype(np.float32), t=np.stack(et).astype(np.float32),
                 s=np.asarray(es, np.float32), weight=np.ones(len(pairs), np.float32),
                 valid=np.ones(len(pairs), bool))
    R0, t0, s0 = [Rg[0]], [tg[0]], [np.float32(1.0)]
    for k in range(K - 1):
        noise = jsim3.exp(jnp.asarray(np.concatenate([
            rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3), [scale_creep]]).astype(np.float32)))
        Sk = (jnp.asarray(R0[-1]), jnp.asarray(t0[-1]), jnp.asarray(s0[-1], jnp.float32))
        Sm = (jnp.asarray(edges["R"][k]), jnp.asarray(edges["t"][k]), jnp.asarray(edges["s"][k]))
        Sn = jsim3.compose(noise, jsim3.compose(Sm, Sk))
        R0.append(np.asarray(Sn[0]))
        t0.append(np.asarray(Sn[1]))
        s0.append(np.float32(Sn[2]))
    est = (np.stack(R0).astype(np.float32), np.stack(t0).astype(np.float32),
           np.asarray(s0, np.float32))
    return (Rg, tg, sg), edges, est


def run_both(edges, est, fixed, **kw):
    jres = jpg.optimize_pose_graph_sim3(
        *(jnp.asarray(x) for x in est), jpg.Sim3Edges(**{k: jnp.asarray(v) for k, v in edges.items()}),
        jnp.asarray(fixed), **kw)
    tres = tpg.optimize_pose_graph_sim3(
        *(torch.from_numpy(x) for x in est),
        tpg.Sim3Edges(**{k: torch.from_numpy(v) for k, v in edges.items()}),
        torch.from_numpy(fixed), **kw)
    return [np.asarray(x) for x in jres], [x.numpy() for x in tres]


def centres(R, t, s):
    return np.stack([-(R[k].T @ t[k]) / s[k] for k in range(len(R))])


def _hold(jr, tr):
    for a, b, tol, what in zip(jr[:3], tr[:3], (R_TOL, T_TOL, R_TOL), "Rts"):
        err = float(np.abs(a - b).max())
        assert err <= tol, (what, err)


def test_loop_drift_correction_matches_jax():
    gt, edges, est = loop_graph()
    K = len(gt[0])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    jr, tr = run_both(edges, est, fixed)
    _hold(jr, tr)
    # the reference test's own checks, on the port
    err = np.linalg.norm(centres(*tr[:3]) - centres(*gt), axis=1)
    assert float(tr[3]) < 1e-3, float(tr[3])
    assert err.max() < 0.05, err.max()
    np.testing.assert_allclose(tr[2], 1.0, atol=0.02)
    assert np.linalg.norm(est[1][-1] - gt[1][-1]) > 0.2
    # the fixed vertex does not move
    np.testing.assert_array_equal(tr[0][0], est[0][0])
    np.testing.assert_array_equal(tr[1][0], est[1][0])


def test_fix_scale_graph_matches_jax():
    gt, edges, est = loop_graph(seed=1, scale_creep=0.0)
    fixed = np.zeros(len(gt[0]), bool)
    fixed[0] = True
    jr, tr = run_both(edges, est, fixed, fix_scale=True)
    _hold(jr, tr)
    np.testing.assert_array_equal(tr[2], est[2])  # no scale update at all


def test_invalid_edges_and_fixed_vertices():
    gt, edges, est = loop_graph(seed=2)
    K = len(gt[0])
    edges["valid"][5] = False
    edges["weight"][-1] = 8.5  # the loop edge weighs n/4 + 1, as the loop closer sets it
    fixed = np.zeros(K, bool)
    fixed[[0, 20]] = True
    jr, tr = run_both(edges, est, fixed, n_iters=8)
    _hold(jr, tr)
    np.testing.assert_array_equal(tr[1][20], est[1][20])


def test_edge_jacobians_match_jacfwd():
    rng = np.random.default_rng(3)
    E = 9
    xs = [rng.normal(0, 0.4, (E, 7)).astype(np.float32) for _ in range(3)]
    xs[2][:3] = 0.0  # an edge whose residual is exactly zero (an odometry edge at build time)
    S = [tsim3.exp(torch.from_numpy(x)) for x in xs]
    S[0] = tuple(torch.cat([a[:3], b[3:]]) for a, b in zip(
        tsim3.compose(S[2], tsim3.inverse(S[1])), S[0]))
    Ji, Jj = tpg._edge_jacobians(*S)
    SJ = [tuple(jnp.asarray(x.numpy()) for x in s) for s in S]
    z7 = jnp.zeros(7, jnp.float32)

    def jac(*a):
        f = lambda di, dj: jpg._residual_tangent(a[0:3], a[3:6], a[6:9], di, dj)
        return jax.jacfwd(f, 0)(z7, z7), jax.jacfwd(f, 1)(z7, z7)

    jJi, jJj = jax.vmap(jac)(*SJ[0], *SJ[1], *SJ[2])
    assert np.isfinite(Ji.numpy()).all() and np.isfinite(Jj.numpy()).all()
    assert float(np.abs(np.asarray(jJi) - Ji.numpy()).max()) <= JAC_TOL
    assert float(np.abs(np.asarray(jJj) - Jj.numpy()).max()) <= JAC_TOL
