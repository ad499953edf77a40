"""Parity of the port's inertial optimisation (``optim/inertial.py``) and
``map_state.apply_scaled_rotation_map`` with the JAX package on the CPU,
float32.

The chains are those of ``tests/test_inertial.py`` (a strongly excited
analytic trajectory with exact IMU samples), preintegrated by the JAX
package and handed to both packages as the same numbers.  ``imu_residual``,
``whitener`` and ``_linear_seed`` are held to 1e-4 relative;
``inertial_init`` (the port's Jacobian is central differences in float64,
the JAX package's ``jacfwd``) to scale within 1e-3 (relative), gravity
within 1e-3 rad, biases within 1e-4, with ``fix_scale`` False and True.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.imu import preintegration as J
from orb_slam3_noted_tpu.optim import inertial as JI
from orb_slam3_noted_tpu.pipeline import map_state as JMS
from orb_slam3_noted_tpu_torch.imu import preintegration as P
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.optim import inertial as TI
from orb_slam3_noted_tpu_torch.pipeline import map_state as TMS
from test_inertial import synth_trajectory

REL = 1e-4
_CHAINS = {}
SCALE_REL, GRAVITY_RAD, BIAS_ABS = 1e-3, 1e-3, 1e-4


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


def jcalib():
    f = lambda v: jnp.asarray(v, jnp.float32)
    return J.Calib(Rbc=jnp.eye(3), tbc=jnp.zeros(3), cov_ng=f(1e-6), cov_na=f(1e-4),
                   cov_walk_g=f(1e-9), cov_walk_a=f(1e-6))


def to_torch_preint(p) -> P.Preintegrated:
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return P.Preintegrated(*(t(f) for f in p[:-1]), bias=P.Bias(t(p.bias.bg), t(p.bias.ba)))


def chain(n_kf=14, bg=None, ba=None):
    """(Rwb, positions, velocities, JAX preints (stacked, float32), port
    preints); the trajectory is made once per module (its samples come from
    the JAX package's ``so3`` one at a time)."""
    key = (n_kf, None if bg is None else tuple(bg), None if ba is None else tuple(ba))
    if key not in _CHAINS:
        _CHAINS[key] = synth_trajectory(n_kf=n_kf, bg=bg, ba=ba)
    kf_R, kf_p, kf_v, segs = _CHAINS[key]
    zero = J.Bias(jnp.zeros(3), jnp.zeros(3))
    ps = [J.integrate_measurements(zero, *(jnp.asarray(np.asarray(x, np.float32)) for x in s),
                                   jcalib()) for s in segs]
    pre = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *ps)
    return (kf_R.astype(np.float32), kf_p.astype(np.float32), kf_v.astype(np.float32), pre,
            to_torch_preint(jax.device_get(pre)))


def close(a, b, rel=REL, err="", floor=1e-6):
    a = np.asarray(a)
    np.testing.assert_allclose(np.asarray(b), a, rtol=0, atol=rel * max(np.abs(a).max(), floor),
                               err_msg=err)


def test_imu_residual_and_whitener_match_jax():
    R, p, v, jpre, tpre = chain(n_kf=12)
    R, p, v = R[:6], p[:6], v[:6]
    jpre = jax.tree_util.tree_map(lambda x: x[:5], jpre)
    tpre = P.index(tpre, slice(0, 5))
    rng = np.random.default_rng(0)
    bg, ba = (rng.normal(0, s, 3).astype(np.float32) for s in (0.003, 0.05))
    g = np.array([0.1, -0.2, -9.8], np.float32)
    jR, jp_, jv = (jnp.asarray(x) for x in (R, p, v))
    jr = jax.vmap(lambda k: JI.imu_residual(
        jR[k], jp_[k], jv[k], jR[k + 1], jp_[k + 1], jv[k + 1], bg, ba,
        jax.tree_util.tree_map(lambda x: x[k], jpre), g))(jnp.arange(5))
    t = torch.from_numpy
    tr = TI.imu_residual(t(R[:-1]), t(p[:-1]), t(v[:-1]), t(R[1:]), t(p[1:]), t(v[1:]), t(bg),
                         t(ba), tpre, t(g))
    close(jr, tr.numpy(), err="imu_residual")
    close(JI.whitener(jpre), TI.whitener(tpre).numpy(), err="whitener")
    # a covariance that does not factor carries NaN, as the JAX solve's does
    bad = tpre._replace(C=-tpre.C)
    Wb = TI.whitener(bad)
    assert torch.isnan(Wb).all() and not torch.isnan(TI.whitener(tpre)).any()


def test_gravity_vec_matches_jax():
    gd = np.array([0.12, -0.3], np.float32)
    close(JI.gravity_vec(jnp.asarray(gd)), TI.gravity_vec(torch.from_numpy(gd)).numpy())


@pytest.mark.parametrize("tilt", [False, True])
def test_linear_seed_matches_jax(tilt):
    R, p, v, jpre, tpre = chain(n_kf=12)
    if tilt:
        Rt = np.asarray(jso3.exp(jnp.asarray([0.17, -0.05, 0.0])))
        R = np.einsum("ij,kjl->kil", Rt, R).astype(np.float32)
        p = (p @ Rt.T / 1.8).astype(np.float32)
    valid = np.ones(11, bool)
    js = JI._linear_seed(jnp.asarray(R), jnp.asarray(p), jpre, jnp.asarray(valid))
    ts = TI._linear_seed(torch.from_numpy(R), torch.from_numpy(p), tpre, torch.from_numpy(valid))
    for name, a, b in zip(("log_s", "gdir", "bg", "v"), js, ts):
        close(a, b.numpy(), rel=1e-3, err=name, floor=1e-2)


def _gravity_angle(ga, gb):
    ga, gb = np.asarray(ga, np.float64), np.asarray(gb, np.float64)
    c = ga @ gb / np.linalg.norm(ga) / np.linalg.norm(gb)
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.mark.parametrize("case", ["scale", "tilt", "fix_scale"])
def test_inertial_init_matches_jax(case):
    bg_true = np.array([0.004, -0.006, 0.003])
    ba_true = np.array([0.05, -0.03, 0.08])
    R, p, v, jpre, tpre = chain(n_kf=14 if case == "scale" else 12,
                                bg=bg_true if case == "scale" else None,
                                ba=ba_true if case == "scale" else None)
    if case == "scale":
        twb = p / 2.7
    elif case == "tilt":
        Rt = np.asarray(jso3.exp(jnp.asarray([0.17, -0.05, 0.0])))
        R = np.einsum("ij,kjl->kil", Rt, R)
        twb = p @ Rt.T / 1.8
    else:
        twb = p  # metric: stereo-inertial initialises with the scale fixed
    R, twb = R.astype(np.float32), twb.astype(np.float32)
    valid = np.ones(len(R) - 1, bool)
    kw = dict(prior_g=1.0, prior_a=1.0, n_iters=30, fix_scale=case == "fix_scale")
    jr = JI.inertial_init(jnp.asarray(R), jnp.asarray(twb), jpre, jnp.asarray(valid), **kw)
    tr = TI.inertial_init(torch.from_numpy(R), torch.from_numpy(twb), tpre,
                          torch.from_numpy(valid), **kw)
    assert abs(float(tr.scale) - float(jr.scale)) <= SCALE_REL * float(jr.scale)
    assert _gravity_angle(jr.g_world, tr.g_world.numpy()) <= GRAVITY_RAD
    np.testing.assert_allclose(tr.bg.numpy(), np.asarray(jr.bg), atol=BIAS_ABS)
    np.testing.assert_allclose(tr.ba.numpy(), np.asarray(jr.ba), atol=BIAS_ABS)
    close(jr.velocities, tr.velocities.numpy(), rel=1e-3, err="velocities")
    if case == "scale":  # the reference test's own checks hold in the port
        assert abs(float(tr.scale) - 2.7) / 2.7 < 0.03
        np.testing.assert_allclose(tr.bg.numpy(), bg_true, atol=2e-3)
    if case == "fix_scale":
        assert float(tr.scale) == 1.0
    else:
        assert abs(float(tr.scale_sigma) - float(jr.scale_sigma)) <= 0.05 * float(jr.scale_sigma)


def test_apply_scaled_rotation_and_map_match_jax():
    rng = np.random.default_rng(5)
    K, M = 5, 40
    Rcw = np.stack([np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32)))
                    for _ in range(K)])
    tcw = rng.normal(size=(K, 3)).astype(np.float32)
    pts = rng.normal(size=(M, 3)).astype(np.float32)
    Ryw = np.asarray(jso3.exp(jnp.asarray([0.1, 0.2, -0.05], jnp.float32)))
    s = np.float32(2.0)
    jo = JI.apply_scaled_rotation(jnp.asarray(Rcw), jnp.asarray(tcw), jnp.asarray(pts),
                                  jnp.asarray(Ryw), jnp.asarray(s))
    to = TI.apply_scaled_rotation(*(torch.from_numpy(x) for x in (Rcw, tcw, pts, Ryw)),
                                  torch.tensor(s))
    for a, b in zip(jo, to):
        close(a, b.numpy(), rel=1e-6)
    # the map form on a small map: poses, points, normals, depth ranges
    from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig

    kw = dict(max_keyframes=8, max_map_points=64, n_features=16)
    jm = JMS.empty_map(JConfig(**kw))
    jm = jm._replace(kf_Rcw=jm.kf_Rcw.at[:K].set(Rcw), kf_tcw=jm.kf_tcw.at[:K].set(tcw),
                     mp_pos=jm.mp_pos.at[:M].set(pts), mp_normal=jm.mp_normal.at[:M].set(pts),
                     mp_dmin=jm.mp_dmin.at[:M].set(0.5), mp_dmax=jm.mp_dmax.at[:M].set(4.0))
    tm = TMS.from_numpy(jax.device_get(jm)._asdict())
    assert tm.kf_Rcw.shape[0] == SlamConfig(**kw).max_keyframes
    ja = jax.device_get(JMS.apply_scaled_rotation_map(jm, jnp.asarray(Ryw), jnp.asarray(s)))
    ta = TMS.apply_scaled_rotation_map(tm, torch.from_numpy(Ryw), torch.tensor(s))
    for name in ("kf_Rcw", "kf_tcw", "mp_pos", "mp_normal", "mp_dmin", "mp_dmax"):
        close(getattr(ja, name), getattr(ta, name).numpy(), rel=1e-6, err=name)
