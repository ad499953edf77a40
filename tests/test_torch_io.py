"""Parity of the port's settings reader, metric stream, colour conversion
and rad-tan undistortion with the JAX package on the CPU.

The settings files are hand-written fixtures in the schemas of the
reference's ``EuRoC.yaml`` (stereo-inertial, with rectification blocks),
``TUM_512.yaml`` (two Kannala-Brandt cameras, Tlr, lapping areas),
``Monocular/EuRoC.yaml`` (pinhole with distortion) and ``TUM1.yaml``
(RGB-D).  The JAX package reads them through ``cv2.FileStorage``, the port
through its own parser; every ``SlamConfig`` field and the IMU dict must be
equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.io import yaml_compat as jyaml
from orb_slam3_noted_tpu.models import cameras as jcam
from orb_slam3_noted_tpu.ops import image as jimage
from orb_slam3_noted_tpu.utils import timing as jtiming
from orb_slam3_noted_tpu_torch.io import yaml_compat as tyaml
from orb_slam3_noted_tpu_torch.models import cameras as tcam
from orb_slam3_noted_tpu_torch.ops import image as timage
from orb_slam3_noted_tpu_torch.utils import timing as ttiming

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SETTINGS = ["settings_euroc_stereo_inertial.yaml", "settings_tum_512.yaml",
            "settings_mono_pinhole.yaml", "settings_tum_rgbd.yaml"]
# undistorted pixels: 1e-4 px, or two float32 spacings where the value is
# above 512 px (the spacing there is 6.1e-5 px: the packages' expressions
# round in another order)
UNDISTORT_TOL_PX, UNDISTORT_RTOL = 1e-4, 2 * 2.0 ** -23
GRAY_TOL = 1e-4       # float32 products of three weights, summed in another order


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


def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("camera", "camera2") and v is not None:
            v = (int(v.kind), tuple(float(p) for p in v.params))
        out[f.name] = v
    return out


@pytest.mark.parametrize("name", SETTINGS)
def test_load_settings_matches_cv2(name):
    path = os.path.join(FIXTURES, name)
    (cj, ij), (cp, ip) = jyaml.load_settings(path), tyaml.load_settings(path)
    fj, fp = _fields(cj), _fields(cp)
    assert fj.keys() == fp.keys()
    for k in fj:
        assert fp[k] == fj[k], (k, fp[k], fj[k])
    assert (ij is None) == (ip is None)
    if ij is not None:
        assert ij.keys() == ip.keys()
        for k in ij:
            np.testing.assert_array_equal(np.asarray(ip[k]), np.asarray(ij[k]), err_msg=k)


@pytest.mark.parametrize("name", SETTINGS)
def test_load_stereo_rectification_matches_cv2(name):
    path = os.path.join(FIXTURES, name)
    rj, rp = jyaml.load_stereo_rectification(path), tyaml.load_stereo_rectification(path)
    assert (rj is None) == (rp is None)
    if rj is None:
        assert name != "settings_euroc_stereo_inertial.yaml"
        return
    assert rj.keys() == rp.keys() == {"LEFT", "RIGHT"}
    for side in rj:
        assert rj[side].keys() == rp[side].keys()
        for k, v in rj[side].items():
            np.testing.assert_array_equal(np.asarray(rp[side][k]), np.asarray(v), err_msg=(side, k))
            assert np.asarray(rp[side][k]).dtype == np.asarray(v).dtype


def test_euroc_settings_values():
    """What ``tests/test_io.py`` asserts of the reference's EuRoC.yaml, on
    the port's reader and the hand-written fixture."""
    cfg, imu = tyaml.load_settings(os.path.join(FIXTURES, "settings_euroc_stereo_inertial.yaml"))
    assert cfg.camera.kind == tcam.PINHOLE
    np.testing.assert_allclose(cfg.camera.fx, 435.2046959714599, rtol=1e-6)
    assert cfg.n_features == 1200 and cfg.n_levels == 8
    assert abs(cfg.scale_factor - 1.2) < 1e-9
    assert cfg.width == 752 and cfg.height == 480
    assert cfg.bf > 0 and cfg.dist_coeffs == ()
    assert imu["Tbc"].shape == (4, 4) and imu["freq"] == 200.0
    assert imu["noise_gyro"] == 1.7e-4  # raw; SlamConfig.imu_calib discretises it
    assert cfg.imu_noise_gyro == 1.7e-4 and cfg.imu_freq == 200.0


def test_tumvi_and_mono_settings_values():
    cfg, imu = tyaml.load_settings(os.path.join(FIXTURES, "settings_tum_512.yaml"))
    assert cfg.camera.kind == tcam.KANNALA_BRANDT8 and len(cfg.camera.params) == 8
    assert cfg.camera2.kind == tcam.KANNALA_BRANDT8 and cfg.width == 512
    assert cfg.lapping_l == (0.0, 511.0) and cfg.lapping_r == (0.0, 511.0)
    # Tlr is float32 in the file: its entries read as float32 values
    assert cfg.tlr_t[0] == float(np.float32(0.101063427414194))
    assert imu is not None
    mono, _ = tyaml.load_settings(os.path.join(FIXTURES, "settings_mono_pinhole.yaml"))
    # the distortion is parsed (and, as in the JAX package, applied nowhere)
    assert mono.dist_coeffs == (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
    assert mono.fps == 20.0 and mono.bf == 0.0 and mono.th_depth == 35.0


def test_parser_reads_the_opencv_subset():
    fs = tyaml.parse_opencv_yaml(
        '%YAML:1.0\n---\n# comment\nA.b: 3  # trailing\nA.c: 1.0e-3\nA.d: "Kannala # not"\n'
        "A.e: PinHole\nA.f: -.5\nM: !!opencv-matrix\n  rows: 2\n  cols: 2\n  dt: f\n"
        "  data: [ 1, 2.5,\n    # a comment line\n    -3e1, 4 ]\nN:  !!opencv-matrix\n"
        "   rows: 1\n   cols: 1\n   dt: d\n   data:[7]\n")
    assert fs["A.b"] == 3 and isinstance(fs["A.b"], int)
    assert fs["A.c"] == 1.0e-3 and fs["A.d"] == "Kannala # not" and fs["A.e"] == "PinHole"
    assert fs["A.f"] == -0.5
    assert fs["M"].dtype == np.float32 and fs["M"].tolist() == [[1.0, 2.5], [-30.0, 4.0]]
    assert fs["N"].dtype == np.float64 and fs["N"].tolist() == [[7.0]]
    assert tyaml._read(fs, "A.b") == 3.0 and isinstance(tyaml._read(fs, "A.b"), float)
    assert tyaml._read(fs, "missing", 9) == 9


@pytest.mark.parametrize("text,key", [
    ("M: !!opencv-matrix\n  rows: 2\n  cols: 2\n  dt: d\n  data: [1, 2, 3]\n", "M"),
    ("M: !!opencv-matrix\n  rows: 1\n  cols: 2\n  dt: d\n  data: [1, 2\n", "M"),
    ("M: !!opencv-matrix\n  rows: 1\n  cols: 1\n  data: [1]\n", "M"),
    ("M: !!opencv-matrix\n  rows: 1\n  cols: 1\n  dt: q\n  data: [1]\n", "M"),
    ("Camera.fx: [1, 2]\n", "Camera.fx"),
    ("  indented: 1\n", "line 1"),
])
def test_parser_refuses_malformed_files(text, key):
    with pytest.raises(ValueError, match=key):
        tyaml.parse_opencv_yaml(text)


def test_missing_required_key_names_it(tmp_path):
    path = tmp_path / "s.yaml"
    path.write_text("%YAML:1.0\nCamera.fx: 400.0\nCamera.fy: 400.0\nCamera.cx: 100.0\n")
    with pytest.raises(ValueError, match="Camera.cy"):
        tyaml.load_settings(str(path))
    path.write_text("%YAML:1.0\nCamera.fx: 1\nCamera.fy: 1\nCamera.cx: 1\nCamera.cy: 1\n"
                    "Tbc: !!opencv-matrix\n  rows: 3\n  cols: 3\n  dt: d\n"
                    "  data: [1, 0, 0, 0, 1, 0, 0, 0, 1]\n")
    with pytest.raises(ValueError, match="Tbc"):
        tyaml.load_settings(str(path))


# ---------------------------------------------------------------------------
# the metric stream: tests/test_metrics.py's cases on both packages

@pytest.mark.parametrize("mod", [jtiming, ttiming], ids=["jax", "port"])
def test_metrics_stream_deltas(mod, tmp_path):
    timer = mod.StageTimer()
    old = mod.StageTimer.enabled
    mod.StageTimer.enabled = True
    try:
        path = str(tmp_path / "metrics.jsonl")
        ms = mod.MetricsStream(path, timer=timer)
        for _ in range(2):
            with timer.stage("track_batch"):
                pass
        ms.emit("dispatch", frame=0, n_kf=2)
        with timer.stage("loop_drain"):
            pass
        mod.SATURATION["test_cap"] += 7
        ms.emit("dispatch", frame=16, n_kf=3, seq=99)
        ms.close()
        recs = [json.loads(x) for x in open(path)]
        assert [r["seq"] for r in recs] == [0, 1]  # reserved keys win over gauges
        assert recs[0]["stages"]["track_batch"]["n"] == 2
        assert "loop_drain" not in recs[0]["stages"] and "saturation" not in recs[0]
        assert "track_batch" not in recs[1]["stages"]
        assert recs[1]["stages"]["loop_drain"]["n"] == 1
        assert recs[1]["saturation"]["test_cap"] == 7
        assert recs[1]["n_kf"] == 3 and recs[1]["event"] == "dispatch"
    finally:
        mod.StageTimer.enabled = old
        mod.SATURATION.pop("test_cap", None)


@pytest.mark.parametrize("mod", [jtiming, ttiming], ids=["jax", "port"])
def test_metrics_gauges_for(mod, tmp_path):
    class FakeSlam:
        n_kf, n_mp, state, frames_total, imu_stage = 5, 100, "OK", 42, 2

    class Visual:
        n_kf, n_mp, state = 1, 2, "LOST"

    ms = mod.MetricsStream(str(tmp_path / "m.jsonl"))
    g, v = ms.gauges_for(FakeSlam()), ms.gauges_for(Visual())
    ms.close()
    assert g == {"n_kf": 5, "n_mp": 100, "state": "OK", "frames_total": 42, "imu_stage": 2}
    assert v == {"n_kf": 1, "n_mp": 2, "state": "LOST", "frames_total": 0}


@pytest.mark.parametrize("mod", [jtiming, ttiming], ids=["jax", "port"])
def test_stage_timer_save(mod, tmp_path):
    timer = mod.StageTimer()
    old = mod.StageTimer.enabled
    mod.StageTimer.enabled = True
    try:
        with timer.stage("extract"):
            pass
        path = tmp_path / "ExecTimeMean.txt"
        timer.save(str(path))
    finally:
        mod.StageTimer.enabled = old
    lines = path.read_text().splitlines()
    assert lines[0].split()[:2] == ["stage", "n"] and lines[1].split()[:2] == ["extract", "1"]


# ---------------------------------------------------------------------------
# rgb_to_gray and undistort_points_radtan

def test_rgb_to_gray():
    rgb = np.random.default_rng(3).uniform(0, 255, (37, 53, 3)).astype(np.float32)
    want = np.asarray(jimage.rgb_to_gray(jnp.asarray(rgb)))
    got = timage.rgb_to_gray(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAY_TOL)


def test_undistort_points_radtan():
    params = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
    dist = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0], np.float32)
    uv = np.random.default_rng(4).uniform([0, 0], [752, 480], (500, 2)).astype(np.float32)
    want = np.asarray(jcam.undistort_points_radtan(jnp.asarray(params), jnp.asarray(dist),
                                                   jnp.asarray(uv)))
    got = tcam.undistort_points_radtan(torch.from_numpy(params), torch.from_numpy(dist),
                                       torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=UNDISTORT_RTOL, atol=UNDISTORT_TOL_PX)
    # distorting the result again comes back near the input in the centre
    c = np.linalg.norm(uv - params[2:], axis=1) < 150
    x = (got[c] - params[2:]) / params[:2]
    r2 = (x ** 2).sum(1, keepdims=True)
    k1, k2, p1, p2, k3 = dist.astype(np.float64)
    xd = x * (1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3)
    xd[:, 0] += 2 * p1 * x[:, 0] * x[:, 1] + p2 * (r2[:, 0] + 2 * x[:, 0] ** 2)
    xd[:, 1] += p1 * (r2[:, 0] + 2 * x[:, 1] ** 2) + 2 * p2 * x[:, 0] * x[:, 1]
    np.testing.assert_allclose(xd * params[:2] + params[2:], uv[c], atol=1e-2)


def test_native_stage_timer_dump_matches_the_native_library(tmp_path):
    """``native.StageTimer`` writes the native library's ``name mean_ms
    max_ms count`` lines: the same names in the same order, the same counts
    and number format, mean <= max, and durations within 20 ms of the JAX
    package's timers run side by side (the sleeps are 5 and 2 ms)."""
    import re
    import time

    from orb_slam3_noted_tpu import native as jnative
    from orb_slam3_noted_tpu_torch import native as tnative

    names = ["torch_io_timer_b", "torch_io_timer_a", "torch_io_timer_c"]
    jt, tt = jnative.StageTimer(), tnative.StageTimer()
    for k, name in enumerate(names):
        for _ in range(k + 1):
            jt.start(name)
            tt.start(name)
            time.sleep(0.005 if k % 2 == 0 else 0.002)
            jt.stop(name)
            tt.stop(name)
    rows = {}
    for tag, timer in (("jax", jt), ("port", tt)):
        path = str(tmp_path / f"{tag}.txt")
        timer.dump(path)
        text = open(path).read()
        assert text.endswith("\n")
        lines = [ln for ln in text.splitlines() if ln.startswith("torch_io_timer_")]
        for ln in lines:
            assert re.fullmatch(r"\S+ \d+\.\d{3} \d+\.\d{3} \d+", ln), ln
        rows[tag] = [ln.split() for ln in lines]
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]] == sorted(names)
    for (_, jm, jx, jn), (_, tm, tx, tn) in zip(rows["jax"], rows["port"]):
        assert int(tn) == int(jn)
        assert float(tm) <= float(tx) and float(tm) >= 1.0
        assert abs(float(tm) - float(jm)) < 20.0
    with pytest.raises(ValueError):
        tnative.StageTimer().stop("torch_io_timer_never_started")


def test_native_reader_and_prefetcher_names(tmp_path):
    """``native.load_image_gray`` and ``PrefetchingLoader`` under the JAX
    package's names read what its native decoder reads, exactly."""
    from orb_slam3_noted_tpu import native as jnative
    from orb_slam3_noted_tpu_torch import native as tnative
    from orb_slam3_noted_tpu_torch.io.images import write_png

    rng = np.random.default_rng(3)
    paths = []
    for i in range(5):
        p = str(tmp_path / f"{i}.png")
        write_png(p, rng.integers(0, 256, (24, 31), dtype=np.uint8))
        paths.append(p)
    np.testing.assert_array_equal(tnative.load_image_gray(paths[0]),
                                  jnative.load_image_gray(paths[0]))
    loader = tnative.PrefetchingLoader(paths, 31, 24, n_buffers=2, n_threads=2)
    try:
        for i, p in enumerate(paths):
            np.testing.assert_array_equal(loader.get(i), jnative.load_image_gray(p))
    finally:
        loader.close()
    with tnative.PrefetchingLoader(paths, 30, 24) as wrong, pytest.raises(IOError):
        wrong.get(0)
