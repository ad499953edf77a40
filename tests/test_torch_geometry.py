"""Parity of the port's geometry, camera, factor and pose-optimisation code
with the JAX package, on shared float32 inputs made with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import linalg3 as jl3
from orb_slam3_noted_tpu.geometry import se3 as jse3
from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.models import cameras as jcam
from orb_slam3_noted_tpu.optim import pose_opt as jpo
from orb_slam3_noted_tpu.utils import synthetic as jsyn
from orb_slam3_noted_tpu_torch.geometry import linalg3 as tl3
from orb_slam3_noted_tpu_torch.geometry import se3 as tse3
from orb_slam3_noted_tpu_torch.geometry import so3 as tso3
from orb_slam3_noted_tpu_torch.models import cameras as tcam
from orb_slam3_noted_tpu_torch.optim import pose_opt as tpo
from orb_slam3_noted_tpu_torch.utils import synthetic as tsyn

PARAMS = (260.0, 260.0, 160.0, 120.0)
# float32 elementwise math: libm/SLEEF vs XLA's own sin/cos/atan2
ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """JAX in float32 as in use; torch on one thread: the test workers run
    side by side, and the port's many small operations only lose to threads
    that fight over the same cores."""
    prev, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", prev)


def _both(fn_j, fn_t, *arrays):
    out_j = fn_j(*[jnp.asarray(a) for a in arrays])
    out_t = fn_t(*[torch.from_numpy(a) for a in arrays])
    return out_j, out_t


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5, 3.0])
def test_so3_exp_log(scale):
    w = (np.random.default_rng(0).normal(size=(64, 3)) * scale).astype(np.float32)
    Rj, Rt = _both(jso3.exp, tso3.exp, w)
    _close(Rt, Rj)
    R = np.asarray(Rj)
    _close(tso3.log(torch.from_numpy(R)), jso3.log(jnp.asarray(R)), atol=1e-5)
    _close(tso3.normalize(torch.from_numpy(R)), jso3.normalize(jnp.asarray(R)))
    _close(tso3.hat(torch.from_numpy(w)), jso3.hat(jnp.asarray(w)), atol=0)


def test_se3_exp_compose_inverse():
    rng = np.random.default_rng(1)
    xi = (rng.normal(size=(16, 6)) * 0.3).astype(np.float32)
    (Rj, tj), (Rt, tt) = _both(jse3.exp, tse3.exp, xi)
    _close(Rt, Rj)
    _close(tt, tj)
    T1 = (np.asarray(Rj), np.asarray(tj))
    T2 = (np.asarray(Rj)[::-1].copy(), np.asarray(tj)[::-1].copy())
    cj = jse3.compose(tuple(map(jnp.asarray, T1)), tuple(map(jnp.asarray, T2)))
    ct = tse3.compose(tuple(map(torch.from_numpy, T1)), tuple(map(torch.from_numpy, T2)))
    _close(ct[0], cj[0])
    _close(ct[1], cj[1])
    ij = jse3.inverse(tuple(map(jnp.asarray, T1)))
    it = tse3.inverse(tuple(map(torch.from_numpy, T1)))
    _close(it[1], ij[1])


def _se3_pair(batch: int):
    rng = np.random.default_rng(11)
    xi = (rng.normal(size=(batch, 6)) * 0.4).astype(np.float32)
    R, t = jse3.exp(jnp.asarray(xi))
    return (np.asarray(R), np.asarray(t)), rng


@pytest.mark.parametrize("helper", ["identity", "apply", "to_matrix", "from_matrix", "retract"])
def test_se3_helpers(helper):
    """The five helpers against the JAX package's on the same float32
    inputs (ATOL: float32 elementwise math; identity, to_matrix and
    from_matrix are exact)."""
    (R, t), rng = _se3_pair(8)
    Tj, Tt = (jnp.asarray(R), jnp.asarray(t)), (torch.from_numpy(R), torch.from_numpy(t))
    if helper == "identity":
        for shape in [(), (4,), (2, 3)]:
            Rj, tj = jse3.identity(jnp.float32, shape)
            Rt, tt = tse3.identity(torch.float32, shape, device="cpu")
            assert Rt.shape == Rj.shape and tt.shape == tj.shape and Rt.dtype == torch.float32
            _close(Rt, Rj, atol=0)
            _close(tt, tj, atol=0)
    elif helper == "apply":
        x = rng.normal(size=(8, 3)).astype(np.float32) * 3.0
        _close(tse3.apply(Tt, torch.from_numpy(x)), jse3.apply(Tj, jnp.asarray(x)), atol=1e-5)
    elif helper == "to_matrix":
        Mj, Mt = jse3.to_matrix(Tj), tse3.to_matrix(Tt)
        assert Mt.shape == (8, 4, 4)
        _close(Mt, Mj, atol=0)
    elif helper == "from_matrix":
        M = np.asarray(jse3.to_matrix(Tj))
        (Rj, tj), (Rt, tt) = jse3.from_matrix(jnp.asarray(M)), tse3.from_matrix(torch.from_numpy(M))
        _close(Rt, Rj, atol=0)
        _close(tt, tj, atol=0)
    else:
        xi = (rng.normal(size=(8, 6)) * 0.1).astype(np.float32)
        (Rj, tj), (Rt, tt) = jse3.retract(Tj, jnp.asarray(xi)), tse3.retract(Tt, torch.from_numpy(xi))
        _close(Rt, Rj)
        _close(tt, tj, atol=1e-5)


def test_solve6_block_elimination():
    rng = np.random.default_rng(2)
    J = rng.normal(size=(32, 40, 6)).astype(np.float32)
    A = (np.einsum("bki,bkj->bij", J, J) + np.eye(6, dtype=np.float32)).astype(np.float32)
    b = rng.normal(size=(32, 6)).astype(np.float32)
    xj, xt = _both(jl3.solve6, tl3.solve6, A, b)
    _close(xt, xj, atol=1e-4)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, xt.numpy()), b, atol=1e-3)


def test_pinhole_camera():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-2, 2, (50, 2)), rng.uniform(0.5, 8, (50, 1))], 1).astype(np.float32)
    cj, ct = jcam.Camera(jcam.PINHOLE, PARAMS), tcam.Camera(tcam.PINHOLE, PARAMS)
    uv_t = tcam.project(ct, torch.from_numpy(x))
    _close(uv_t, jcam.project(cj, jnp.asarray(x)), atol=1e-4)
    _close(tcam.project_jac(ct, torch.from_numpy(x)), jcam.project_jac(cj, jnp.asarray(x)), atol=1e-3)
    uv = uv_t.numpy()
    _close(tcam.unproject(ct, torch.from_numpy(uv)), jcam.unproject(cj, jnp.asarray(uv)))
    # a Kannala-Brandt camera dispatches to its own model (with k = 0 it is
    # the equidistant fisheye, not the pinhole; tests/test_torch_fisheye.py)
    kb = tcam.Camera(tcam.KANNALA_BRANDT8, PARAMS + (0.0,) * 4)
    assert torch.equal(tcam.project(kb, torch.from_numpy(x)),
                       tcam.kb8_project(kb.params_array(), torch.from_numpy(x)))
    assert not torch.allclose(tcam.project(kb, torch.from_numpy(x)), uv_t)


def test_orbit_trajectory_poses():
    for (Rj, tj), (Rt, tt) in zip(jsyn.orbit_trajectory(12, forward=0.03, yaw0=0.45),
                                  tsyn.orbit_trajectory(12, forward=0.03, yaw0=0.45)):
        np.testing.assert_allclose(Rt, np.asarray(Rj), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tt, tj)


@pytest.mark.parametrize("t0", [0.0, 1.7])
def test_smooth_pose_and_synth_imu(t0):
    Rj, tj = jsyn.smooth_pose(t0 + 0.3)
    Rt, tt = tsyn.smooth_pose(t0 + 0.3)
    np.testing.assert_allclose(Rt, np.asarray(Rj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tt, tj)
    (aj, gj, sj), (at, gt, st) = jsyn.synth_imu(t0, t0 + 0.1), tsyn.synth_imu(t0, t0 + 0.1)
    np.testing.assert_array_equal(st, sj)
    # the gyro is log(R^T R') / 1e-4 s of float32 rotations, so one ulp of
    # R (6e-8) moves it by ~6e-4 rad/s (measured <= 4e-4)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=2e-3)
    np.testing.assert_allclose(at, aj, rtol=0, atol=1e-5)


def test_stereo_pair():
    room_j, room_t = jsyn.BoxRoom(seed=3, tex_size=256), tsyn.BoxRoom(seed=3, tex_size=256)
    Rwc, twc = tsyn.orbit_trajectory(2)[1]
    outs_j = jsyn.stereo_pair(room_j, Rwc, twc, PARAMS, 64, 48, 0.1)
    outs_t = tsyn.stereo_pair(room_t, Rwc, twc, PARAMS, 64, 48, 0.1)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_array_equal(a, b)


def _pose_problem(seed, n=400, stereo=True, outliers=0.1):
    """A camera 1 m off the origin seeing n points, pixel noise + outliers,
    and a perturbed starting pose."""
    rng = np.random.default_rng(seed)
    cam = tcam.Camera(tcam.PINHOLE, PARAMS)
    R_true = tso3.exp(torch.tensor([0.02, -0.05, 0.01])).numpy()
    t_true = np.array([0.1, -0.05, 0.2], np.float32)
    xc = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(1.5, 7, (n, 1))], 1)
    pw = ((xc - t_true) @ R_true).astype(np.float32)
    fx, fy, cx, cy = PARAMS
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx, fy * xc[:, 1] / xc[:, 2] + cy], 1)
    uv = uv + rng.normal(0, 0.7, uv.shape)
    bad = rng.uniform(size=n) < outliers
    uv[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    bf = 0.08 * fx
    uvr = uv[:, 0] - bf / xc[:, 2] + rng.normal(0, 0.5, n)
    obs = dict(
        uv=uv.astype(np.float32), uv_r=uvr.astype(np.float32),
        inv_sigma2=(1.0 / 1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32),
        is_stereo=(rng.uniform(size=n) < 0.7) if stereo else np.zeros(n, bool),
        valid=rng.uniform(size=n) < 0.95,
    )
    R0 = (tso3.exp(torch.tensor([0.01, 0.01, -0.01])) @ torch.from_numpy(R_true)).numpy()
    t0 = (t_true + np.array([0.03, -0.02, 0.05])).astype(np.float32)
    return cam, R0, t0, pw, obs, bf


@pytest.mark.parametrize("seed,stereo", [(0, True), (1, False), (2, True)])
def test_pose_optimization(seed, stereo):
    cam, R0, t0, pw, obs, bf = _pose_problem(seed, stereo=stereo)
    bf = bf if stereo else 0.0
    rj = jpo.pose_optimization(
        jcam.Camera(jcam.PINHOLE, PARAMS), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pw),
        jpo.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}), bf=bf,
    )
    rt = tpo.pose_optimization(
        cam, torch.from_numpy(R0), torch.from_numpy(t0), torch.from_numpy(pw),
        tpo.from_numpy(obs), bf=bf,
    )
    # float32 sums in another order over 12 Gauss-Newton steps
    _close(rt.Rcw, rj.Rcw, atol=2e-5)
    _close(rt.tcw, rj.tcw, atol=2e-4)
    inl_j = np.asarray(rj.inliers)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert (rt.inliers.numpy() == inl_j).mean() >= 0.995
    assert int(rj.n_inliers) > 250


def test_pose_obs_roundtrip():
    _, _, _, _, obs, _ = _pose_problem(0)
    back = tpo.to_numpy(tpo.from_numpy(obs))
    for k, v in obs.items():
        np.testing.assert_array_equal(back[k], v)
