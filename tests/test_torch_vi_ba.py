"""Parity of the port's visual-inertial factors and BA (``optim/vi_factors.py``,
``optim/inertial_ba.py``, ``pipeline/inertial_mapping.py``) with the JAX
package on the CPU, float32.

The inertial edge's and the prior's Jacobians are analytic in the port and
``jax.jacfwd`` in the JAX package: held to 1e-4 of each residual row's
largest entry, at random states and preintegrations.  The window of
``tests/test_vi_ba.py`` (6 body states along an analytic trajectory, 96
landmarks, exact reprojections and IMU) runs through ``visual_inertial_ba``,
``vi_pose_optimization`` and, written into a map, ``chain_inertial_ba``
(LocalInertialBA over a padded window, FullInertialBA with bias priors) in
both packages: poses within 1e-4 m / rad, velocities within 1e-4, inlier
masks and bindings equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.imu import preintegration as J
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.optim import inertial_ba as JBA
from orb_slam3_noted_tpu.optim import vi_factors as JV
from orb_slam3_noted_tpu.optim.pose_opt import PoseObs as JPoseObs
from orb_slam3_noted_tpu.pipeline import inertial_mapping as JIM
from orb_slam3_noted_tpu.pipeline import map_state as JMS
from orb_slam3_noted_tpu_torch.imu import preintegration as P
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.optim import factors as TF
from orb_slam3_noted_tpu_torch.optim import inertial_ba as TBA
from orb_slam3_noted_tpu_torch.optim import vi_factors as TV
from orb_slam3_noted_tpu_torch.optim.pose_opt import PoseObs
from orb_slam3_noted_tpu_torch.pipeline import inertial_mapping as TIM
from orb_slam3_noted_tpu_torch.pipeline import map_state as TMS
from test_vi_ba import CAM as JCAM, make_problem

JAC_REL = 1e-4
POSE_TOL, VEL_TOL = 1e-4, 1e-4
CAM = Camera(PINHOLE, JCAM.params)


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


def t(a):
    a = np.array(a)
    return torch.from_numpy(a.astype(np.float32) if a.dtype.kind == "f" else a)


def tpre(p) -> P.Preintegrated:
    p = jax.device_get(p)
    return P.Preintegrated(*(t(f) for f in p[:-1]), bias=P.Bias(t(p.bias.bg), t(p.bias.ba)))


def tcalib(c) -> P.Calib:
    return P.Calib(*(t(x) for x in jax.device_get(c)))


def tstate(s) -> TV.VIState:
    return TV.VIState(*(t(x) for x in jax.device_get(s)))


def rows_close(a, b, rel=JAC_REL, err=""):
    """|a - b| within ``rel`` of each row's largest |a| (rows: the last axis
    but one for Jacobians, the last axis for residual vectors)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a).max(axis=-1, keepdims=True) if a.ndim >= 2 else np.abs(a).max()
    assert np.all(np.abs(a - b) <= rel * np.maximum(scale, 1e-6)), (err, np.abs(a - b).max())


@pytest.fixture(scope="module")
def window():
    """The window of tests/test_vi_ba.py in float32, and a perturbed start."""
    calib, st_true, pts, obs, edges = make_problem(dtype=jnp.float32)
    n_kf = st_true.twb.shape[0]
    rng = np.random.default_rng(0)

    def perturb(x, s, lo=2):
        n = np.zeros(x.shape, np.float32)
        n[lo:] = rng.normal(0, s, n[lo:].shape)
        return x + jnp.asarray(n)

    dR = jnp.stack([jso3.exp(jnp.asarray(rng.normal(0, 0.02 if k >= 2 else 0.0, 3), jnp.float32))
                    for k in range(n_kf)])
    st0 = JV.VIState(Rwb=jnp.einsum("kij,kjl->kil", st_true.Rwb, dR),
                     twb=perturb(st_true.twb, 0.05), vel=perturb(st_true.vel, 0.1),
                     bg=perturb(st_true.bg, 0.002), ba=perturb(st_true.ba, 0.02))
    pts0 = pts + jnp.asarray(rng.normal(0, 0.03, pts.shape), jnp.float32)
    return calib, st_true, st0, pts, pts0, obs, edges


def random_states(rng, K):
    R = np.stack([np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 1, 3), jnp.float32)))
                  for _ in range(K)])
    return JV.VIState(Rwb=jnp.asarray(R), twb=jnp.asarray(rng.normal(0, 1, (K, 3)), jnp.float32),
                      vel=jnp.asarray(rng.normal(0, 1, (K, 3)), jnp.float32),
                      bg=jnp.asarray(rng.normal(0, 0.01, (K, 3)), jnp.float32),
                      ba=jnp.asarray(rng.normal(0, 0.1, (K, 3)), jnp.float32))


def random_preints(rng, E, calib, n=40):
    b0 = J.Bias(jnp.asarray(rng.normal(0, 0.01, 3), jnp.float32),
                jnp.asarray(rng.normal(0, 0.1, 3), jnp.float32))
    ps = [J.integrate_measurements(
        b0, jnp.asarray(rng.normal(0, 1, (n, 3)) + [0, 0, 9.81], jnp.float32),
        jnp.asarray(rng.normal(0, 0.5, (n, 3)), jnp.float32),
        jnp.asarray(rng.uniform(0.004, 0.006, n), jnp.float32), calib) for _ in range(E)]
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *ps)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inertial_edge_jacobians_match_jacfwd(seed):
    rng = np.random.default_rng(seed)
    calib = JConfig().imu_calib()
    E = 5
    st = random_states(rng, E + 1)
    pre = random_preints(rng, E, calib)
    i = np.arange(E, dtype=np.int32)
    je = JV.InertialEdges(jnp.asarray(i), jnp.asarray(i + 1), pre, jnp.ones(E, bool))
    te = TV.InertialEdges(t(i), t(i + 1), tpre(pre), torch.ones(E, dtype=torch.bool))
    jr, jJi, jJj = JV.inertial_edge_residuals(st, je)
    tr, tJi, tJj = TV.inertial_edge_residuals(tstate(st), te)
    rows_close(jr, tr.numpy(), err="r")
    rows_close(jJi, tJi.numpy(), err="Ji")
    rows_close(jJj, tJj.numpy(), err="Jj")
    jb, jw = JV.bias_rw_residuals(st, je)
    tb, tw = TV.bias_rw_residuals(tstate(st), te)
    rows_close(jb, tb.numpy(), rel=1e-6, err="bias rw")
    rows_close(jw, tw.numpy(), rel=1e-6, err="bias rw whitening")


@pytest.mark.parametrize("valid", [True, False])
def test_prior_residuals_match_jacfwd(valid):
    rng = np.random.default_rng(4)
    st = random_states(rng, 3)
    Rp = jso3.exp(jnp.asarray(rng.normal(0, 0.05, 3), jnp.float32)) @ st.Rwb[1]
    sq = np.triu(rng.normal(0, 1, (15, 15))).astype(np.float32) + 3 * np.eye(15, dtype=np.float32)
    vec = lambda s: jnp.asarray(rng.normal(0, s, 3), jnp.float32)
    jp = JV.VIPrior(idx=jnp.asarray(1, jnp.int32), Rwb=Rp, twb=st.twb[1] + vec(0.1),
                    vel=st.vel[1] + vec(0.1), bg=st.bg[1] + vec(1e-3), ba=st.ba[1] + vec(1e-2),
                    sqrt_info=jnp.asarray(sq), valid=jnp.asarray(valid))
    tp = TV.VIPrior(*(t(x) for x in jax.device_get(jp)))
    jr, jJ = JV.prior_residuals(st, jp)
    tr, tJ = TV.prior_residuals(tstate(st), tp)
    rows_close(jr, tr.numpy(), err="r")
    rows_close(jJ, tJ.numpy(), err="J")


def tobs(o) -> TF.ReprojObs:
    o = jax.device_get(o)
    return TF.ReprojObs(*(t(x) for x in o[:7]))


def assert_states_close(js, ts, err=""):
    js = jax.device_get(js)
    np.testing.assert_allclose(ts.twb.numpy(), js.twb, rtol=0, atol=POSE_TOL, err_msg=err)
    # the angle between the rotations, from the chord |Ra - Rb|_F = 2 sqrt(2) sin(a / 2)
    chord = np.linalg.norm(np.asarray(js.Rwb, np.float64) - ts.Rwb.numpy(), axis=(1, 2))
    ang = 2 * np.arcsin(np.clip(chord / (2 * np.sqrt(2)), 0, 1))
    assert ang.max() <= POSE_TOL, (err, ang)
    np.testing.assert_allclose(ts.vel.numpy(), js.vel, rtol=0, atol=VEL_TOL, err_msg=err)
    np.testing.assert_allclose(ts.bg.numpy(), js.bg, rtol=0, atol=1e-5, err_msg=err)
    np.testing.assert_allclose(ts.ba.numpy(), js.ba, rtol=0, atol=1e-4, err_msg=err)


def test_visual_inertial_ba_matches_jax(window):
    calib, st_true, st0, pts, pts0, obs, edges = window
    n_kf = st_true.twb.shape[0]
    fixed = np.array([True, True] + [False] * (n_kf - 2))
    jprob = JBA.VIBAProblem(state=st0, points=pts0, obs=obs, edges=edges,
                            pose_fixed=jnp.asarray(fixed),
                            point_fixed=jnp.zeros(pts.shape[0], bool),
                            prior=JBA.no_prior(jnp.float32))
    jres = JBA.visual_inertial_ba(JCAM, calib, jprob, n_iters=6, n_iters_final=6)
    te = TV.InertialEdges(t(edges.i), t(edges.j), tpre(edges.preint), t(edges.valid))
    tprob = TBA.VIBAProblem(state=tstate(st0), points=t(pts0), obs=tobs(obs), edges=te,
                            pose_fixed=t(fixed), point_fixed=torch.zeros(pts.shape[0],
                                                                         dtype=torch.bool),
                            prior=TBA.no_prior())
    tres = TBA.visual_inertial_ba(CAM, tcalib(calib), tprob, n_iters=6, n_iters_final=6)
    assert_states_close(jres.state, tres.state)
    np.testing.assert_allclose(tres.points.numpy(), np.asarray(jres.points), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tres.inlier.numpy(), np.asarray(jres.inlier))
    assert int(tres.inlier.sum()) > 0.9 * obs.uv.shape[0]
    # the reference test's own accuracy holds in the port
    np.testing.assert_allclose(tres.state.twb.numpy(), np.asarray(st_true.twb), atol=5e-3)


def test_vi_pose_optimization_matches_jax(window):
    calib, st_true, _, pts, _, obs, edges = window
    anchor = jax.tree_util.tree_map(lambda x: x[0], st_true)
    ftrue = jax.tree_util.tree_map(lambda x: x[1], st_true)
    rng = np.random.default_rng(1)
    frame0 = JV.VIState(Rwb=ftrue.Rwb @ jso3.exp(jnp.asarray([0.02, -0.03, 0.01], jnp.float32)),
                        twb=ftrue.twb + jnp.asarray([0.05, -0.04, 0.06], jnp.float32),
                        vel=ftrue.vel + jnp.asarray(rng.normal(0, 0.1, 3), jnp.float32),
                        bg=ftrue.bg, ba=ftrue.ba)
    pre1 = jax.tree_util.tree_map(lambda x: x[0], edges.preint)
    sel = np.asarray(obs.pose_idx) == 1
    N = int(sel.sum())
    uv = np.asarray(obs.uv)[sel]
    # a few gross outliers, so the inlier masks have something to decide
    uv[::17] += 40.0
    z = np.zeros(N, np.float32)
    jobs = JPoseObs(uv=jnp.asarray(uv), uv_r=jnp.asarray(z), inv_sigma2=jnp.ones(N),
                    is_stereo=jnp.zeros(N, bool), valid=jnp.asarray(np.asarray(obs.valid)[sel]))
    P3 = np.asarray(pts)[np.asarray(obs.point_idx)[sel]]
    jres = JBA.vi_pose_optimization(JCAM, calib, anchor, frame0, pre1, jnp.asarray(P3), jobs)
    tobs_ = PoseObs(uv=t(uv), uv_r=t(z), inv_sigma2=torch.ones(N), is_stereo=torch.zeros(
        N, dtype=torch.bool), valid=t(np.asarray(obs.valid)[sel]))
    tres = TBA.vi_pose_optimization(CAM, tcalib(calib), tstate(anchor), tstate(frame0),
                                    P.index(tpre(edges.preint), 0), t(P3), tobs_)
    js = jax.tree_util.tree_map(lambda x: x[None], JV.VIState(*jres[:5]))
    assert_states_close(js, TV.VIState(*(x[None] for x in tres[:5])))
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert int(tres.n_inliers) == int(jres.n_inliers) and int(tres.n_inliers) > 80


def window_map(window, ms, asarray, cfg):
    """The window written into a map: keyframe k at the start state's camera
    pose, one feature per landmark at its exact projection, bound to it."""
    calib, st_true, st0, pts, pts0, obs, edges = window
    Rcw, tcw = (np.asarray(x) for x in JV.cam_from_body(st0, calib))
    n_kf, M = Rcw.shape[0], pts.shape[0]
    uv = np.asarray(obs.uv).reshape(n_kf, M, 2)
    valid = np.asarray(obs.valid).reshape(n_kf, M)
    desc = np.random.default_rng(2).integers(0, 2 ** 32, size=(M, 8), dtype=np.uint32)
    f32 = lambda a: asarray(np.asarray(a, np.float32))
    i32 = lambda a: asarray(np.asarray(a, np.int32))
    bind = np.arange(M, dtype=np.int32)
    m = ms.empty_map(cfg)
    for k in range(n_kf):
        m = ms.add_keyframe(m, k, f32(Rcw[k]), f32(tcw[k]), 10 * k, f32(uv[k]), i32(np.zeros(M)),
                            f32(np.zeros(M)), asarray(desc), asarray(valid[k]),
                            i32(bind if k else np.full(M, -1)), f32(np.full(M, -1.0)))
        if k == 0:
            ones = asarray(np.ones(M, bool))
            m = ms.add_map_points(m, 0, f32(pts0), asarray(desc), f32(np.zeros((M, 3))),
                                  f32(np.zeros(M)), f32(np.full(M, 100.0)), 0, ones, 0, i32(bind),
                                  0, i32(bind))
    return m


@pytest.mark.parametrize("mode", ["local", "full"])
def test_chain_inertial_ba_matches_jax(window, mode):
    """LocalInertialBA: the 6 keyframes in a window padded to 9 entries;
    FullInertialBA: the chain padded to 8, with bias priors."""
    calib, st_true, st0, pts, pts0, obs, edges = window
    kw = dict(width=640, height=480, n_features=pts.shape[0], max_keyframes=8,
              max_map_points=256)
    jcfg, tcfg = JConfig(camera=JCAM, **kw), SlamConfig(camera=CAM, **kw)
    jm = window_map(window, JMS, jnp.asarray, jcfg)
    n_kf = int(st0.twb.shape[0])
    K = 9 if mode == "local" else 8
    slots = np.full(K, 0, np.int32)
    slots[:n_kf] = np.arange(n_kf)
    mask = np.arange(K) < n_kf
    dummy = J.init_preintegrated(J.Bias(jnp.zeros(3), jnp.zeros(3)))
    pres = [jax.tree_util.tree_map(lambda x: x[e], edges.preint) for e in range(n_kf - 1)]
    jpre = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *(pres + [dummy] * (K - n_kf)))
    seg_valid = np.arange(K - 1) < n_kf - 1
    jki = JIM.empty_inertial(jcfg)
    jki = JIM.KFInertial(vel=jki.vel.at[:n_kf].set(st0.vel), bg=jki.bg.at[:n_kf].set(st0.bg),
                         ba=jki.ba.at[:n_kf].set(st0.ba))
    prior = dict(bias_prior_g=1.0, bias_prior_a=1e5) if mode == "full" else {}
    jm2, jki2 = JIM.chain_inertial_ba(jm, jki, jnp.asarray(slots), jnp.asarray(mask), jpre,
                                      jnp.asarray(seg_valid), JCAM, calib, jcfg, n_iters=4,
                                      **prior)
    tm = TMS.from_numpy(jax.device_get(jm)._asdict())
    tki = TIM.KFInertial(*(t(x) for x in jax.device_get(jki)))
    tm2, tki2 = TIM.chain_inertial_ba(tm, tki, t(slots), t(mask), tpre(jpre), t(seg_valid), CAM,
                                      tcalib(calib), tcfg, n_iters=4, **prior)
    jm2, jki2 = jax.device_get((jm2, jki2))
    np.testing.assert_allclose(tm2.kf_tcw.numpy(), jm2.kf_tcw, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(tm2.kf_Rcw.numpy(), jm2.kf_Rcw, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(tm2.mp_pos.numpy(), jm2.mp_pos, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tki2.vel.numpy(), jki2.vel, rtol=0, atol=VEL_TOL)
    np.testing.assert_allclose(tki2.bg.numpy(), jki2.bg, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tki2.ba.numpy(), jki2.ba, rtol=0, atol=1e-4)
    for name in ("kf_mp", "obs_mat"):
        np.testing.assert_array_equal(getattr(tm2, name).numpy(), np.asarray(getattr(jm2, name)),
                                      err_msg=name)
    # the slots the window did not hold are untouched
    np.testing.assert_array_equal(tm2.kf_Rcw.numpy()[n_kf:], jm.kf_Rcw[n_kf:])
