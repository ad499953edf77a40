"""The port's viewer (``orb_slam3_noted_tpu_torch.utils.viewer``) and the
facades' FrameDrawer overlay against the JAX package on the CPU, on
``tests/test_frame_drawer.py``'s layout: ``map_snapshot`` and
``export_map_html`` on one map built from numpy in both packages,
``draw_frame`` against the JAX package's ``cv2`` drawing pixel for pixel,
the status bar, ``save_map_png``, ``LiveViewer``'s endpoints, and the
overlay a stereo lap records in both packages.  The port sets
``last_image`` in the inertial facades and after ``process_batch``; the
JAX package's inertial facades never do (ROADMAP Queue 3), shown here.

Inputs are drawn from seeds with numpy or rendered at 320x240, uint8.
"""

import json
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.pipeline import inertial_system as jis
from orb_slam3_noted_tpu.pipeline import system as jsys
from orb_slam3_noted_tpu.utils import viewer as jviewer
from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.io.images import decode_png
from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
from orb_slam3_noted_tpu_torch.pipeline import inertial_system as tis
from orb_slam3_noted_tpu_torch.pipeline import system as tsys
from orb_slam3_noted_tpu_torch.utils import viewer as tviewer
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

W, H = 320, 240
FX = 260.0
PARAMS = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
BASELINE = 0.12
CPU = torch.device("cpu")
CFG_KW = dict(width=W, height=H, n_features=600, bf=FX * BASELINE, th_depth=35.0,
              max_keyframes=32, max_map_points=4096, local_window=5, kf_max_interval=10,
              enable_loop_closing=False)
N_LAP = 6
POINT_TOL_M = 1e-5        # snapshot points and centres: float32 products, same order
MATCHED_RTOL = 0.02       # the overlay's matched count a frame against the JAX run's
OVERLAY_KEYS = {"xy", "valid", "matched", "frame_id", "state", "n_kf", "n_mp"}


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


@pytest.fixture(scope="module")
def pairs():
    room = BoxRoom(seed=0)
    return [tuple(x.astype(np.uint8) for x in stereo_pair(room, R, t, PARAMS, W, H, BASELINE)[:2])
            for R, t in orbit_trajectory(48, forward=0.03, yaw0=0.45)[:N_LAP]]


# ---- the map snapshot and the HTML page -------------------------------

def _snapshot_inputs(seed=0, KF=12, MP=400):
    """One map's snapshot fields as numpy, some keyframes and points
    invalid, keyframe pairs sharing 10-100 points."""
    rng = np.random.default_rng(seed)
    ang = rng.normal(0, 0.3, (KF, 3)).astype(np.float32)
    R = np.stack([np.asarray(jax.scipy.linalg.expm(jnp.asarray(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]))) for a in ang]).astype(np.float32)
    density = rng.uniform(0.05, 0.6, KF)
    return {
        "obs_mat": rng.uniform(size=(KF, MP)) < density[:, None],
        "mp_valid": rng.uniform(size=MP) > 0.1,
        "mp_pos": rng.normal(0, 2, (MP, 3)).astype(np.float32),
        "kf_valid": rng.uniform(size=KF) > 0.2,
        "kf_Rcw": R,
        "kf_tcw": rng.normal(0, 0.5, (KF, 3)).astype(np.float32),
        "trajectory": rng.normal(0, 1, (20, 3)),
    }


def _facades(d: dict):
    """Stand-ins with the attributes ``map_snapshot`` reads, one a package."""
    fields = ("obs_mat", "mp_valid", "mp_pos", "kf_valid", "kf_Rcw", "kf_tcw")
    j = types.SimpleNamespace(m=types.SimpleNamespace(**{k: jnp.asarray(d[k]) for k in fields}),
                              trajectory=[None], positions=lambda: d["trajectory"].copy())
    t = types.SimpleNamespace(m=types.SimpleNamespace(**{k: torch.from_numpy(d[k])
                                                          for k in fields}),
                              trajectory=[None], positions=lambda: d["trajectory"].copy())
    return j, t


def test_map_snapshot_matches_jax():
    d = _snapshot_inputs()
    sj, st = (f(s) for f, s in zip((jviewer.map_snapshot, tviewer.map_snapshot), _facades(d)))
    assert list(st) == list(sj)
    assert st["n_kf"] == sj["n_kf"] == int(d["kf_valid"].sum())
    assert st["n_mp"] == sj["n_mp"] == int(d["mp_valid"].sum())
    assert st["covis_edges"] == sj["covis_edges"] and 0 < len(st["covis_edges"])
    assert len(st["covis_edges"]) < sj["n_kf"] * (sj["n_kf"] - 1) // 2  # the >= 30 rule bites
    for k in ("points", "kf_centers", "kf_Rcw", "trajectory"):
        np.testing.assert_allclose(np.asarray(st[k]), np.asarray(sj[k]), rtol=0, atol=POINT_TOL_M)
    # plain Python values all the way down: json round trip is the identity
    assert json.loads(json.dumps(st)) == st


def test_export_map_html_matches_jax(tmp_path):
    """The page embeds exactly ``map_snapshot``'s dict; the rest of it, and
    the live page's polling shim, are the JAX package's bytes."""
    d = _snapshot_inputs(seed=1)
    j, t = _facades(d)
    pj = jviewer.export_map_html(j, str(tmp_path / "j.html"))
    pt = tviewer.export_map_html(t, str(tmp_path / "t.html"))
    hj, ht = open(pj).read(), open(pt).read()
    head, tail = jviewer._HTML_TEMPLATE.split("__DATA__")
    assert ht.startswith(head) and ht.endswith(tail)
    assert json.loads(ht[len(head):len(ht) - len(tail)]) == tviewer.map_snapshot(t)
    assert hj.startswith(head) and hj.endswith(tail)
    assert tviewer._HTML_TEMPLATE == jviewer._HTML_TEMPLATE
    assert tviewer._LIVE_SHIM == jviewer._LIVE_SHIM


# ---- the FrameDrawer overlay: pixels --------------------------------------

def _overlay(seed=0, n=400):
    """Keypoints over the whole frame and past its edges, on half pixels
    (rounding ties), crowded so that boxes and dots overlap."""
    rng = np.random.default_rng(seed)
    xy = np.concatenate([rng.uniform(-3, W + 3, (n - 40, 2)),
                         rng.integers(0, 20, (40, 2)) + 0.5]).astype(np.float32)
    xy[:, 1] = np.clip(xy[:, 1] * H / W, -3, H + 3)
    return {"xy": xy, "valid": rng.uniform(size=n) > 0.1, "matched": rng.uniform(size=n) > 0.5,
            "frame_id": 7, "state": "RECENTLY_LOST", "n_kf": 12, "n_mp": 3456}


@pytest.mark.parametrize("kind", ["gray_u8", "gray_f32", "bgr"])
def test_draw_frame_matches_cv2(kind):
    """Every pixel above the status bar equals the JAX package's ``cv2``
    drawing, uint8 exact (a filled radius-1 circle is a plus, not a 3x3
    square; later keypoints paint over earlier ones)."""
    rng = np.random.default_rng(3)
    img = {"gray_u8": rng.integers(0, 256, (H, W), dtype=np.uint8),
           "gray_f32": rng.uniform(0, 255, (H, W)).astype(np.float32),
           "bgr": rng.integers(0, 256, (H, W, 3), dtype=np.uint8)}[kind]
    ov = _overlay()
    out_j, out_t = jviewer.draw_frame(img, ov), tviewer.draw_frame(img, ov)
    assert out_t.shape == out_j.shape == (H + tviewer.STATUS_ROWS, W, 3)
    assert out_t.dtype == np.uint8
    np.testing.assert_array_equal(out_t[:H], out_j[:H])
    blank = tviewer.draw_frame(img, dict(ov, valid=np.zeros_like(ov["valid"])))
    assert (out_t[:H] != blank[:H]).any(-1).sum() > 1000  # the keypoints were drawn


def test_status_bar():
    """22 rows under the frame, black, the JAX package's text in white from
    column 6 on baseline 15, in the port's 5x7 font (every character of it
    has a glyph of its own)."""
    ov = _overlay(seed=1)
    n_match = int((ov["valid"] & ov["matched"]).sum())
    text = f"{ov['state']}  KFs: {ov['n_kf']}  MPs: {ov['n_mp']}  matches: {n_match}"
    assert tviewer.status_text(ov) == text
    assert all(ch in tviewer.GLYPHS for ch in text)
    bar = tviewer.draw_frame(np.zeros((H, W), np.uint8), ov)[H:]
    assert bar.shape == (22, W, 3)
    want = tviewer.draw_text(np.zeros((22, W, 3), np.uint8), text, 6, 15, (255, 255, 255))
    np.testing.assert_array_equal(bar, want)
    lit = np.flatnonzero(bar.any(axis=(1, 2)))
    assert lit.min() >= 9 and lit.max() <= 15 and set(np.unique(bar)) == {0, 255}
    cols = np.flatnonzero(bar.any(axis=(0, 2)))
    assert cols.min() >= 6 and cols.max() < 6 + 6 * len(text)


# ---- laps: the overlay in both packages, the viewer on the port ----------

@pytest.fixture(scope="module")
def laps(pairs):
    """The pairs through ``StereoSLAM.process`` with the overlay on in
    both packages (localisation mode: the front end and tracking), each
    frame's overlay and ``last_image`` kept."""
    js = jsys.StereoSLAM(JConfig(camera=JCamera(0, PARAMS), **CFG_KW))
    ts = tsys.StereoSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW), device=CPU)
    out = {"jax": [], "port": []}
    for s, tag in ((js, "jax"), (ts, "port")):
        s.set_localization_mode(True)
        s.keep_frame_overlay = True
        for i, (left, right) in enumerate(pairs):
            s.process(left, right, i)
            out[tag].append((s.last_overlay, s.last_image))
    return out


def test_overlay_matches_jax_on_stereo_lap(laps, pairs):
    """Keys and dtypes as the JAX package's, the frame's own id and image,
    the state and map counts, and the matched counts within 2%."""
    for i, ((oj, ij), (ot, it)) in enumerate(zip(laps["jax"], laps["port"])):
        np.testing.assert_array_equal(it, pairs[i][0])
        np.testing.assert_array_equal(ij, pairs[i][0])
        if i == 0:  # the stereo initialisation records none, in either package
            assert oj is None and ot is None
            continue
        assert set(ot) == set(oj) == OVERLAY_KEYS
        for k in ("xy", "valid", "matched"):
            assert ot[k].dtype == np.asarray(oj[k]).dtype and ot[k].shape == np.asarray(oj[k]).shape
        assert (ot["frame_id"], ot["state"], ot["n_kf"]) == (oj["frame_id"], oj["state"],
                                                             oj["n_kf"]) == (i, "OK", 1)
        assert ot["n_mp"] == int(oj["n_mp"])
        mj, mt = (int((o["valid"] & o["matched"]).sum()) for o in (oj, ot))
        assert abs(mt - mj) <= MATCHED_RTOL * mj and mj > 100, (i, mt, mj)


@pytest.fixture(scope="module")
def inertial_run(pairs):
    """``StereoInertialSLAM`` with the overlay on, mapper on, vision-only
    stage: frames 0-2 through ``process`` in both packages, then (the port)
    frames 3-5 through ``process_batch``."""
    kw = dict(CFG_KW, fps=20.0)
    js = jis.StereoInertialSLAM(JConfig(camera=JCamera(0, PARAMS), **kw))
    ts = tis.StereoInertialSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **kw), device=CPU)
    for s in (js, ts):
        s.keep_frame_overlay = True
        for i in range(3):
            s.process(pairs[i][0], pairs[i][1], i, t=i / 20.0)
    after_process = (ts.last_overlay, ts.last_image)
    ts.process_batch(pairs[3:], [3, 4, 5], ts=[0.15, 0.2, 0.25])
    return js, ts, after_process


def test_inertial_facade_sets_last_image(inertial_run, pairs):
    """The port's inertial facade keeps the frame the overlay is drawn on,
    after ``process`` and after a batch (its last tracked frame, one copy
    a dispatch); the JAX package's records the overlay but leaves
    ``last_image`` at None, so its ``/frame.png`` answers 404."""
    js, ts, (ov_p, img_p) = inertial_run
    assert js.last_overlay is not None and js.last_overlay["frame_id"] == 2
    assert js.last_image is None
    assert ov_p["frame_id"] == 2 and set(ov_p) == OVERLAY_KEYS
    np.testing.assert_array_equal(img_p, pairs[2][0])
    assert ts.last_overlay["frame_id"] == 5 and ts.trajectory[-1].state == "OK"
    np.testing.assert_array_equal(ts.last_image, pairs[5][0])
    viewer = jviewer.LiveViewer(js, port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/frame.png", timeout=10)
        assert e.value.code == 404
    finally:
        viewer.close()


def test_stereo_batch_records_overlay(pairs):
    """``StereoSLAM.process_batch`` records its last tracked frame: the
    overlay of frame 5, its left image."""
    ts = tsys.StereoSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW), device=CPU)
    ts.keep_frame_overlay = True
    ts.process(pairs[0][0], pairs[0][1], 0)
    assert ts.last_overlay is None
    ts.process_batch(pairs[1:], list(range(1, N_LAP)))
    assert ts.last_overlay["frame_id"] == N_LAP - 1 and ts.last_overlay["state"] == "OK"
    np.testing.assert_array_equal(ts.last_image, pairs[N_LAP - 1][0])
    assert int(ts.last_overlay["matched"].sum()) > 100


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}", timeout=10).read()


def test_live_viewer_endpoints(inertial_run):
    """On the port's inertial facade: ``/state.json`` is the snapshot,
    ``/frame.png`` decodes to ``draw_frame`` of the last frame (RGB in the
    file, as ``cv2.imencode`` writes the BGR drawing), ``/`` the JAX
    package's live page; 404 for the frame before any overlay."""
    _, ts, _ = inertial_run
    viewer = tviewer.LiveViewer(ts, port=0, host="127.0.0.1")
    try:
        assert json.loads(_get(viewer.port, "state.json")) == tviewer.map_snapshot(ts)
        png = _get(viewer.port, "frame.png")
        frame = decode_png(png)
        assert frame.shape == (H + 22, W, 3) and frame.dtype == np.uint8
        np.testing.assert_array_equal(frame, tviewer.draw_frame(ts.last_image,
                                                                ts.last_overlay)[:, :, ::-1])
        page = _get(viewer.port, "").decode()
        assert page == jviewer._HTML_TEMPLATE.replace("const DATA = __DATA__;", jviewer._LIVE_SHIM)
    finally:
        viewer.close()
    fresh = tsys.StereoSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW), device=CPU)
    viewer = tviewer.LiveViewer(fresh, port=0, host="127.0.0.1")
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(viewer.port, "frame.png")
        assert e.value.code == 404
    finally:
        viewer.close()


def test_save_map_png(inertial_run, tmp_path):
    """Two 600x600 panels, decoded by the port's reader as drawn; each
    keyframe's projected pixel keyframe green in both, the points' grey in
    both and the trajectory's blue (the keyframes' squares cover the short
    lap's polyline in the front panel)."""
    _, ts, _ = inertial_run
    path = tviewer.save_map_png(ts, str(tmp_path / "map.png"))
    img = decode_png(open(path, "rb").read())
    snap = tviewer.map_snapshot(ts)
    want, projectors = tviewer.render_map(snap)
    assert img.shape == (tviewer.PANEL, 2 * tviewer.PANEL, 3)
    np.testing.assert_array_equal(img, want)
    assert snap["n_kf"] >= 2
    for k, proj in enumerate(projectors):
        panel = img[:, k * tviewer.PANEL:(k + 1) * tviewer.PANEL]
        for u, v in proj(np.asarray(snap["kf_centers"])):
            assert tuple(panel[v, u]) == tviewer.KF_RGB
        assert (panel == tviewer.POINT_RGB).all(-1).any()
    assert (img == tviewer.TRAJ_RGB).all(-1).any()
