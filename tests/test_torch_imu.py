"""Parity of the port's IMU preintegration (``imu/preintegration.py``) and
``SlamConfig.imu_calib`` with the JAX package on the CPU, float32.

The port integrates a leading batch of segments and steps only as far as
the longest real one; each segment must equal the JAX package's scan over
the full pad (1, 37 and 1024 samples, and segments of different lengths in
one call).  Tolerances: 1e-5 relative on dR, dV, dP and the bias
Jacobians, 1e-4 relative on the covariance C.  The cases of
``tests/test_imu.py`` run in both packages against its numpy golden model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.imu import preintegration as J
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu_torch.imu import preintegration as P
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from test_imu import numpy_preintegrate

REL, REL_C = 1e-5, 1e-4
PAD = 1024  # the JAX package's keyframe pad (inertial_system._KF_PAD)
FIELDS = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C")


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


def calibs(**kw):
    return JConfig(**kw).imu_calib(), SlamConfig(**kw).imu_calib()


def samples(rng, n, spin=0.5):
    acc = (rng.normal(size=(n, 3)) * 2 + np.array([0, 0, 9.81])).astype(np.float32)
    gyr = (rng.normal(size=(n, 3)) * spin).astype(np.float32)
    dts = rng.uniform(0.004, 0.006, size=n).astype(np.float32)
    return acc, gyr, dts


def padded(a, w, d, n=PAD):
    out = [np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32), np.zeros(n, np.float32)]
    for o, x in zip(out, (a, w, d)):
        o[:len(x)] = x
    return out


def jax_preint(bias, a, w, d, calib):
    return J.integrate_measurements(J.Bias(*(jnp.asarray(b) for b in bias)),
                                    *(jnp.asarray(x) for x in padded(a, w, d)), calib)


def assert_preint_close(jp, tp, err=""):
    for name in FIELDS:
        a, b = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        tol = (REL_C if name == "C" else REL) * max(float(np.abs(a).max()), 1e-6)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=f"{err} {name}")


def test_imu_calib_matches_jax():
    kw = dict(imu_rbc=tuple(np.eye(3)[[1, 2, 0]].ravel()), imu_tbc=(0.1, -0.2, 0.03),
              imu_noise_gyro=1e-4, imu_walk_acc=2e-3, imu_freq=400.0)
    for jc, tc in (calibs(), calibs(**kw)):
        for name, a, b in zip(tc._fields, jc, tc):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
            assert b.dtype == torch.float32


@pytest.mark.parametrize("n", [1, 37, 1024])
def test_integrate_matches_jax_full_pad(n):
    rng = np.random.default_rng(n)
    jc, tc = calibs()
    a, w, d = samples(rng, n)
    bias = (np.array([0.01, -0.02, 0.005], np.float32), np.array([-0.05, 0.1, 0.02], np.float32))
    jp = jax_preint(bias, a, w, d, jc)
    tp = P.integrate_measurements(P.Bias(*(torch.from_numpy(b) for b in bias)),
                                  torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(d), tc)
    assert_preint_close(jp, tp, f"n={n}")


def test_batched_segments_equal_separate_full_pad_scans():
    """One call over segments of 3, 58, 120 and 0 samples (padded to the
    longest, stepped to it) equals four JAX scans over 1024 samples each."""
    rng = np.random.default_rng(7)
    jc, tc = calibs()
    lens = [3, 58, 120, 0]
    segs = [samples(rng, n) for n in lens]
    n_max = max(lens)
    batch = [np.stack(x) for x in zip(*(padded(*s, n=n_max) for s in segs))]
    bias = (np.array([0.002, 0.001, -0.003], np.float32), np.array([0.02, -0.01, 0.05], np.float32))
    tp = P.integrate_measurements(P.Bias(*(torch.from_numpy(b) for b in bias)),
                                  *(torch.from_numpy(x) for x in batch), tc, n_steps=n_max)
    assert tp.dR.shape == (4, 3, 3) and tp.C.shape == (4, 15, 15)
    for s, seg in enumerate(segs):
        assert_preint_close(jax_preint(bias, *seg, jc), P.index(tp, s), f"segment {s}")
    # an empty segment is the identity preintegration
    assert torch.equal(tp.dR[3], torch.eye(3)) and float(tp.C[3].abs().max()) == 0.0


def test_getters_under_a_bias_change_and_predict_state():
    rng = np.random.default_rng(3)
    jc, tc = calibs()
    a, w, d = samples(rng, 50, spin=0.3)
    zero = (np.zeros(3, np.float32), np.zeros(3, np.float32))
    jp = jax_preint(zero, a, w, d, jc)
    tp = P.integrate_measurements(P.Bias.zero(), torch.from_numpy(a), torch.from_numpy(w),
                                  torch.from_numpy(d), tc)
    b1 = (np.array([1e-3, -2e-3, 5e-4], np.float32), np.array([-0.02, 0.01, 0.03], np.float32))
    jb, tb = J.Bias(*(jnp.asarray(b) for b in b1)), P.Bias(*(torch.from_numpy(b) for b in b1))
    for jf, tf in ((J.delta_rotation, P.delta_rotation), (J.delta_velocity, P.delta_velocity),
                   (J.delta_position, P.delta_position)):
        a_, b_ = np.asarray(jf(jp, jb)), tf(tp, tb).numpy()
        np.testing.assert_allclose(b_, a_, rtol=0, atol=REL * np.abs(a_).max())
    R1 = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    t1, v1 = np.array([0.3, -1.0, 2.0], np.float32), np.array([0.5, 0.2, -0.1], np.float32)
    jout = J.predict_state(jnp.asarray(R1), jnp.asarray(t1), jnp.asarray(v1), jp, jb)
    tout = P.predict_state(torch.from_numpy(R1), torch.from_numpy(t1), torch.from_numpy(v1), tp, tb)
    for a_, b_ in zip(jout, tout):
        np.testing.assert_allclose(b_.numpy(), np.asarray(a_), rtol=0,
                                   atol=REL * max(np.abs(np.asarray(a_)).max(), 1.0))
    # batched over frames: each row as its own call
    pb = P.stack([tp, tp])
    Rb, tb2, vb = P.predict_state(torch.from_numpy(R1), torch.from_numpy(t1),
                                  torch.from_numpy(v1), pb, tb)
    assert torch.equal(Rb[1], tout[0]) and torch.equal(tb2[0], tout[1])


# --- the cases of tests/test_imu.py, in both packages ------------------------

def _golden_calib():
    return dict(imu_noise_gyro=1.7e-4, imu_noise_acc=2e-3, imu_walk_gyro=1.9e-5,
                imu_walk_acc=3e-3, imu_freq=100.0)


def _both(a, w, d, bias=None):
    jc, tc = calibs(**_golden_calib())
    bias = bias or (np.zeros(3, np.float32), np.zeros(3, np.float32))
    jp = J.integrate_measurements(J.Bias(*(jnp.asarray(b) for b in bias)),
                                  *(jnp.asarray(np.asarray(x, np.float32)) for x in (a, w, d)), jc)
    tp = P.integrate_measurements(P.Bias(*(torch.from_numpy(b) for b in bias)),
                                  *(torch.from_numpy(np.asarray(x, np.float32)) for x in (a, w, d)),
                                  tc)
    return jp, tp, tc


def test_constant_gyro():
    w = np.array([0.1, -0.2, 0.3])
    jp, tp, _ = _both(np.zeros((100, 3)), np.tile(w, (100, 1)), np.full(100, 0.005))
    assert_preint_close(jp, tp)
    from orb_slam3_noted_tpu_torch.geometry import so3
    np.testing.assert_allclose(tp.dR.numpy(), so3.exp(torch.tensor(w * 0.5)).numpy(), atol=1e-6)
    assert abs(float(tp.dT) - 0.5) < 1e-6


def test_matches_numpy_golden():
    rng = np.random.default_rng(0)
    a, w, d = samples(rng, 57)
    bias = (np.array([0.01, -0.02, 0.005], np.float32), np.array([-0.05, 0.1, 0.02], np.float32))
    jp, tp, tc = _both(a, w, d, bias)
    assert_preint_close(jp, tp)
    g = numpy_preintegrate(a.astype(np.float64), w.astype(np.float64), d.astype(np.float64),
                           *(b.astype(np.float64) for b in bias),
                           *(float(x) for x in (tc.cov_ng, tc.cov_na, tc.cov_walk_g, tc.cov_walk_a)))
    for name in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C"):
        ref = g[name]
        np.testing.assert_allclose(getattr(tp, name).numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-6), err_msg=name)


def test_padding_noop():
    rng = np.random.default_rng(1)
    a, w, d = samples(rng, 20)
    jc, tc = calibs()
    p1 = P.integrate_measurements(P.Bias.zero(), *(torch.from_numpy(x) for x in (a, w, d)), tc)
    ap = np.concatenate([a, np.ones((13, 3), np.float32)])
    wp = np.concatenate([w, np.ones((13, 3), np.float32)])
    dp = np.concatenate([d, np.zeros(13, np.float32)])
    p2 = P.integrate_measurements(P.Bias.zero(), *(torch.from_numpy(x) for x in (ap, wp, dp)), tc)
    for name in FIELDS:
        a_, b_ = getattr(p1, name).numpy(), getattr(p2, name).numpy()
        np.testing.assert_allclose(b_, a_, rtol=0, atol=1e-6 * max(np.abs(a_).max(), 1e-6),
                                   err_msg=name)
    # the JAX package pads the same samples to 1024
    assert_preint_close(jax_preint((np.zeros(3, np.float32),) * 2, ap, wp, dp, jc), p2)


@pytest.mark.parametrize("case", ["free_fall", "stationary"])
def test_predict_state_cases(case):
    n = 40
    acc = np.zeros((n, 3)) if case == "free_fall" else np.tile([0.0, 0.0, P.GRAVITY], (n, 1))
    jp, tp, _ = _both(acc, np.zeros((n, 3)), np.full(n, 0.01))
    v1 = np.array([1.0, 0.0, 0.0] if case == "free_fall" else [0.0, 0.0, 0.0], np.float32)
    z = np.zeros(3, np.float32)
    jo = J.predict_state(jnp.eye(3), jnp.asarray(z), jnp.asarray(v1), jp,
                         J.Bias(jnp.asarray(z), jnp.asarray(z)))
    to = P.predict_state(torch.eye(3), torch.from_numpy(z), torch.from_numpy(v1), tp,
                         P.Bias.zero())
    T = 0.4
    if case == "free_fall":
        want = (np.eye(3), [T, 0.0, -0.5 * P.GRAVITY * T * T], [1.0, 0.0, -P.GRAVITY * T])
    else:
        want = (np.eye(3), np.zeros(3), np.zeros(3))
    for a_, b_, w_ in zip(jo, to, want):
        np.testing.assert_allclose(b_.numpy(), np.asarray(a_), atol=1e-5)
        np.testing.assert_allclose(b_.numpy(), w_, atol=1e-4)
