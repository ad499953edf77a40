"""Parity of the port's ``MonoInertialSLAM`` (``pipeline/inertial_system.py``)
with the JAX package on the CPU.

``MonoInertialSLAM.process`` on the lap of ``tests/test_e2e_inertial.py``
(36 frames at 10 fps, exact IMU at 200 Hz, the same renders and samples in
both packages, the two-view draws of the JAX package substituted through
``MonoSLAM._minimal_sets``): the IMU initialised in both, the metric scale
of the post-init tail within 0.05 of the JAX run's (and within the
reference test's 0.25 of 1), the camera-frame gravity direction of the last
frame within 2 degrees of the JAX run's.
"""

import jax
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera, PINHOLE as JPINHOLE
from orb_slam3_noted_tpu.pipeline import inertial_system as jis
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.pipeline import inertial_system as tis
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom
from test_torch_twoview import jax_minimal_sets

import test_e2e_inertial as E2E

CPU = torch.device("cpu")
W, H = 320, 240


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


def mono_cfg_kw():
    return dict(width=W, height=H, fps=E2E.FPS, n_features=600, max_keyframes=32,
                max_map_points=4096, local_window=5, kf_max_interval=3, min_tracked_points=12,
                imu_init_time=1.5, imu_viba1_time=2.5, imu_viba2_time=1e9, imu_init_min_kfs=5,
                inertial_window=6, imu_noise_gyro=1e-4, imu_noise_acc=1e-3, imu_walk_gyro=1e-6,
                imu_walk_acc=1e-5, imu_freq=E2E.IMU_HZ)


def _tail_scale(est, gt, n_tail=12):
    E = est[-n_tail:] - est[-n_tail:].mean(0)
    G = gt[-n_tail:] - gt[-n_tail:].mean(0)
    _, sv, _ = np.linalg.svd(G.T @ E)
    return sv.sum() / (E * E).sum()


@pytest.fixture(scope="module")
def mono_laps():
    room = BoxRoom(seed=0, depth=2.5, h=1.2, w=1.8)
    inputs, t_prev = [], -1.0 / E2E.FPS
    for i in range(36):
        t = i / E2E.FPS
        Rcw, _, Rwc, twc = E2E.cam_pose(t)
        img = room.render(Rwc, twc, E2E.CAM.params, W, H).astype(np.float32)
        inputs.append((img, i, t, *E2E.imu_between(t_prev, t), Rcw, twc))
        t_prev = t
    js = jis.MonoInertialSLAM(JConfig(camera=JCamera(JPINHOLE, E2E.CAM.params), **mono_cfg_kw()))
    ts = tis.MonoInertialSLAM(SlamConfig(camera=Camera(PINHOLE, E2E.CAM.params), **mono_cfg_kw()),
                              device=CPU)
    ts._minimal_sets = lambda valid, seed: jax_minimal_sets(valid.numpy(),
                                                            jax.random.PRNGKey(int(seed)))
    for img, i, t, a, g, imu_t, *_ in inputs:
        js.process(img, i, t=t, acc=a, gyr=g, imu_t=imu_t)
        ts.process(img, i, t=t, acc=a, gyr=g, imu_t=imu_t)
    return js, ts, np.asarray([x[-1] for x in inputs]), inputs[-1][-2]


def test_mono_inertial_lap_matches_jax(mono_laps):
    js, ts, gt, last_Rcw = mono_laps
    assert js.imu_stage >= 1 and ts.imu_stage >= 1
    s_j, s_t = _tail_scale(js.positions(), gt), _tail_scale(ts.positions(), gt)
    assert abs(s_t - s_j) <= 0.05, (s_t, s_j)
    assert abs(s_t - 1.0) < 0.25  # the reference test's own bound
    down = np.array([0.0, 0.0, -1.0])
    g_j, g_t = (np.asarray(s.final_poses()[-1][0]) @ down for s in (js, ts))
    assert np.degrees(2 * np.arcsin(min(np.linalg.norm(g_j - g_t) / 2, 1.0))) <= 2.0
    assert float(g_t @ (last_Rcw @ down)) > 0.98
