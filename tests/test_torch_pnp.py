"""Parity of the port's PnP RANSAC (``optim/pnp.py``) with the JAX package
on the CPU.

``_dlt_p6p``: R and t within 1e-3 of the truth on exact 6-point sets, for
every hypothesis; on exact and on noisy sets (~0.1 px) the same poses with
the SVD's null vector negated (the port fixes its sign: LAPACK and cuSOLVER
return either).  Against the JAX
package within 1e-3 on the hypotheses where the JAX package's null vector
came out with the positive sign; where it did not, the JAX package's
rotation is 180 deg off (a fault of the reference, ROADMAP Queue 3).

``pnp_ransac`` on the JAX package's minimal sets, replayed here from the
same key (``pnp.py:86-88``): the same verdict and inlier counts within 1
(the bearing threshold, cos > 0.99996, is tight enough that a point at it
can go either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.geometry import so3 as jso3
from orb_slam3_noted_tpu.optim import pnp as jpnp
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.optim import pnp as tpnp
from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM

TOL = 1e-3


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


def jax_pnp_sets(valid, key, n_hyp: int = tpnp.N_HYP) -> torch.Tensor:
    """(n_hyp, 6) minimal sets as ``pnp_ransac`` draws them from ``key``."""
    valid = jnp.asarray(np.asarray(valid))
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    sets = jax.vmap(lambda k: jax.random.choice(k, valid.shape[0], shape=(6,), replace=False,
                                                p=p))(jax.random.split(key, n_hyp))
    return torch.from_numpy(np.asarray(sets)).long()


def _pose(seed):
    rng = np.random.default_rng(seed)
    R = np.asarray(jso3.exp(jnp.asarray(rng.uniform(-0.4, 0.4, 3), jnp.float32)))
    t = rng.uniform(-0.6, 0.6, 3).astype(np.float32)
    return rng, R, t


def six_point_sets(seed, n_hyp=64, noise=0.0):
    """(X (H, 6, 3), rays (H, 6, 3), R, t): world points 3-7 m ahead of a
    random pose, their z = 1 rays with ``noise`` on x and y."""
    rng, R, t = _pose(seed)
    X = (rng.uniform(-2, 2, size=(n_hyp, 6, 3)) + [0, 0, 5.0]).astype(np.float32)
    xc = X @ R.T + t
    rays = xc / xc[..., 2:3]
    rays[..., :2] += rng.normal(0, noise, size=rays[..., :2].shape)
    return X, rays.astype(np.float32), R, t


def _rot_err(Ra, Rb):
    return np.abs(np.asarray(Ra) - np.asarray(Rb)).max(axis=(-2, -1))


@pytest.mark.parametrize("noise", [0.0, 2e-4])
def test_dlt_p6p(noise, monkeypatch):
    X, rays, R, t = six_point_sets(1, noise=noise)
    Rt, tt = tpnp._dlt_p6p(torch.from_numpy(X), torch.from_numpy(rays))
    if noise == 0:  # the truth, on every hypothesis
        assert _rot_err(Rt.numpy(), R).max() <= TOL
        assert np.abs(tt.numpy() - t).max() <= TOL
    # the null vector negated: the same poses
    null = tpnp._null_vector
    monkeypatch.setattr(tpnp, "_null_vector", lambda A: -null(A))
    Rn, tn = tpnp._dlt_p6p(torch.from_numpy(X), torch.from_numpy(rays))
    np.testing.assert_allclose(Rn.numpy(), Rt.numpy(), atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), tt.numpy(), atol=1e-6)
    # the JAX package, where its null vector has the positive sign
    Rj, tj = (np.asarray(a) for a in jpnp._dlt_p6p(jnp.asarray(X), jnp.asarray(rays)))
    x, y = rays[..., 0], rays[..., 1]
    Xh = np.concatenate([X, np.ones_like(x)[..., None]], -1)
    z4 = np.zeros_like(Xh)
    A = np.concatenate([np.concatenate([Xh, z4, -x[..., None] * Xh], -1),
                        np.concatenate([z4, Xh, -y[..., None] * Xh], -1)], -2)
    P = np.asarray(jnp.linalg.svd(jnp.asarray(A))[2][..., -1, :]).reshape(-1, 3, 4)
    pos = np.linalg.det(P[..., :3]) > 0
    assert 0 < pos.sum() < len(pos)  # both signs occur: the repair is exercised
    assert _rot_err(Rt.numpy()[pos], Rj[pos]).max() <= TOL
    assert np.abs(tt.numpy()[pos] - tj[pos]).max() <= TOL


def pnp_problem(seed, n=200, n_out=60, noise=2e-4):
    """``tests/test_place_pnp.py``'s problem: 200 points, a random pose, 60
    matches replaced by random rays, ~0.1 px noise; the last 20 rows invalid."""
    rng, R, t = _pose(seed)
    Xw = (rng.uniform(-2, 2, size=(n, 3)) + [0, 0, 5.0]).astype(np.float32)
    xc = Xw @ R.T + t
    rays = xc / xc[:, 2:3]
    rays[:, :2] += rng.normal(0, noise, size=(n, 2))
    bad = rng.choice(n, size=n_out, replace=False)
    rays[bad, :2] = rng.uniform(-0.5, 0.5, size=(n_out, 2))
    valid = np.arange(n) < n - 20
    return Xw, rays.astype(np.float32), valid, R, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_on_jax_draws(seed):
    Xw, rays, valid, R, t = pnp_problem(seed)
    key = jax.random.PRNGKey(100 + seed)
    rj = jpnp.pnp_ransac(jnp.asarray(Xw), jnp.asarray(rays), jnp.asarray(valid), key)
    sets = jax_pnp_sets(valid, key)
    assert bool(torch.from_numpy(valid)[sets].all())
    rt = tpnp.pnp_ransac(torch.from_numpy(Xw), torch.from_numpy(rays), torch.from_numpy(valid),
                         sets)
    assert bool(rt.success) == bool(rj.success) is True
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 1, (int(rt.n_inliers), int(rj.n_inliers))
    assert int(rt.inliers.sum()) == int(rt.n_inliers)
    assert _rot_err(rt.Rcw.numpy(), R) <= 1e-2 and np.abs(rt.tcw.numpy() - t).max() <= 5e-2


def test_pnp_ransac_fails_without_support():
    """Random rays: no hypothesis reaches 12 inliers, in either package."""
    Xw, rays, valid, _, _ = pnp_problem(3, n_out=200)
    key = jax.random.PRNGKey(7)
    rj = jpnp.pnp_ransac(jnp.asarray(Xw), jnp.asarray(rays), jnp.asarray(valid), key)
    rt = tpnp.pnp_ransac(torch.from_numpy(Xw), torch.from_numpy(rays), torch.from_numpy(valid),
                         jax_pnp_sets(valid, key))
    assert not bool(rj.success) and not bool(rt.success)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 1


def test_facade_pnp_sets():
    """``MonoSLAM._pnp_sets``: (128, 6) distinct valid matches per
    hypothesis, the same for the same frame id, others for another."""
    slam = MonoSLAM(SlamConfig(), device=torch.device("cpu"))
    valid = torch.from_numpy(np.random.default_rng(0).uniform(size=300) < 0.3)
    a, b, c = slam._pnp_sets(valid, 5), slam._pnp_sets(valid, 5), slam._pnp_sets(valid, 6)
    assert a.shape == (tpnp.N_HYP, 6) and torch.equal(a, b) and not torch.equal(a, c)
    assert bool(valid[a].all())
    assert all(len(set(row.tolist())) == 6 for row in a)


def test_det3_matches_jax_det():
    """The cofactor 3x3 determinant the DLT uses, against ``jnp.linalg.det``
    (LU): the same signs, values within 1e-5 of their scale, on random
    matrices and on rotations and reflections."""
    from orb_slam3_noted_tpu_torch.geometry.linalg3 import det3

    rng = np.random.default_rng(5)
    A = rng.normal(size=(256, 3, 3)).astype(np.float32)
    R = np.stack([np.asarray(jso3.exp(jnp.asarray(v, jnp.float32)))
                  for v in rng.uniform(-3, 3, size=(16, 3))])
    for M in (A, R, -R):
        want = np.asarray(jnp.linalg.det(jnp.asarray(M)))
        got = det3(torch.from_numpy(M)).numpy()
        np.testing.assert_array_equal(np.sign(got), np.sign(want))
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(M).max() ** 3)
