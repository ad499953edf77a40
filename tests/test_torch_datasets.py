"""Parity of the port's image reader and writer, prefetcher, dataset loaders
and stereo rectification with the JAX package and ``cv2`` on the CPU.

The PNGs are written here by hand with ``zlib``, each row with one of the
five PNG filter types in turn (so Paeth is certain), in every format the
reader takes; the dataset layouts are small EuRoC, TUM-VI, TUM RGB-D and
KITTI directories under ``tmp_path``.
"""

import os
import struct
import sys
import zlib

import cv2
import jax
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu import native as jnative
from orb_slam3_noted_tpu.io import datasets as jds
from orb_slam3_noted_tpu_torch.io import datasets as tds
from orb_slam3_noted_tpu_torch.io import images
from orb_slam3_noted_tpu_torch.io import yaml_compat as tyaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import cli_layouts  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
MAP_TOL_PX = 1e-3      # rectification maps against cv2.initUndistortRectifyMap
REMAP_TOL_U8 = 1       # grey levels, uint8 remap against cv2.remap
REMAP_TOL_F32 = 1e-3   # float remap against cv2.remap
GRAY_TOL_CV2 = 1       # colour to gray: integer BT.601 against libpng's weights


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


# ---------------------------------------------------------------------------
# PNG written by hand, every filter type

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> bytes:
    out = bytearray([kind])
    r, p = row.astype(int), prev.astype(int)
    for x in range(len(r)):
        a = r[x - bpp] if x >= bpp else 0
        b = p[x]
        c = p[x - bpp] if x >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out.append((r[x] - pred) & 0xFF)
    return bytes(out)


def write_filtered_png(path, img: np.ndarray, ctype: int, depth: int = 8):
    """``img`` (H, W[, C]) as a PNG of colour type ``ctype``, row y filtered
    with type y % 5."""
    h, w = img.shape[:2]
    rows = (img.astype(">u2").view(np.uint8) if depth == 16 else img).reshape(h, -1)
    bpp = rows.shape[1] // w
    raw = b"".join(_filter_row(y % 5, rows[y], rows[y - 1] if y else np.zeros_like(rows[0]), bpp)
                   for y in range(h))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(images.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                                   0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    h, w = 23, 31
    smooth = lambda c: np.clip(np.cumsum(rng.integers(-9, 10, (h, w, c)), axis=1) + 128, 0,
                               255).astype(np.uint8)
    imgs = {"gray": (smooth(1)[..., 0], 0), "ga": (smooth(2), 4), "rgb": (smooth(3), 2),
            "rgba": (smooth(4), 6)}
    out = {}
    for name, (img, ctype) in imgs.items():
        p = str(d / f"{name}.png")
        write_filtered_png(p, img, ctype)
        out[name] = (p, img)
    d16 = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    p = str(d / "depth16.png")
    write_filtered_png(p, d16, 0, depth=16)
    out["depth16"] = (p, d16)
    pgm = rng.integers(0, 256, (h, w), dtype=np.uint8)
    p = str(d / "img.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# a comment\n%d %d\n255\n" % (w, h) + pgm.tobytes())
    out["pgm"] = (p, pgm)
    return out


def test_gray_png_every_filter(pngs):
    p, img = pngs["gray"]
    got = images.read_gray(p)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(got, jnative.load_image_gray(p))


@pytest.mark.parametrize("name", ["ga", "rgb", "rgba"])
def test_colour_png_to_gray(pngs, name):
    """GA keeps its gray; RGB and RGBA go through integer BT.601 luma, as
    the JAX package's native decoder: equal to it, and within a grey level
    of ``cv2.imread(..., IMREAD_GRAYSCALE)``."""
    p, img = pngs[name]
    got = images.read_gray(p)
    np.testing.assert_array_equal(got, jnative.load_image_gray(p))
    ref = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= GRAY_TOL_CV2
    if name == "ga":
        np.testing.assert_array_equal(got, img[..., 0])
    else:
        c = img.astype(int)
        np.testing.assert_array_equal(got, (299 * c[..., 0] + 587 * c[..., 1] + 114 * c[..., 2])
                                      // 1000)


def test_depth16_png(pngs):
    p, d16 = pngs["depth16"]
    got = images.read_depth16(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, d16)
    np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_UNCHANGED))
    with pytest.raises(ValueError, match="8-bit"):
        images.read_gray(p)
    with pytest.raises(ValueError, match="16-bit gray"):
        images.read_depth16(pngs["rgb"][0])


def test_pgm(pngs):
    p, img = pngs["pgm"]
    np.testing.assert_array_equal(images.read_gray(p), img)
    np.testing.assert_array_equal(images.read_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(images.read_gray(p), jnative.load_image_gray(p))


def test_reader_refuses_malformed_files(tmp_path, pngs):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    with pytest.raises(ValueError, match="not a PNG"):
        images.read_gray(str(bad))
    data = open(pngs["gray"][0], "rb").read()
    bad.write_bytes(data[:60])
    with pytest.raises(ValueError):
        images.read_gray(str(bad))


@pytest.mark.parametrize("kind", ["gray", "rgb", "depth16"])
def test_write_png_reads_back_in_cv2(tmp_path, kind):
    rng = np.random.default_rng(1)
    img = {"gray": rng.integers(0, 256, (40, 57), dtype=np.uint8),
           "rgb": rng.integers(0, 256, (40, 57, 3), dtype=np.uint8),
           "depth16": rng.integers(0, 65536, (40, 57)).astype(np.uint16)}[kind]
    p = str(tmp_path / f"{kind}.png")
    images.write_png(p, img)
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    if kind == "rgb":
        back = cv2.cvtColor(back, cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(back, img)
    read = images.read_depth16 if kind == "depth16" else images.read_gray
    if kind != "rgb":
        np.testing.assert_array_equal(read(p), img)
    with pytest.raises(ValueError):
        images.write_png(p, img.astype(np.float32))


def test_prefetcher_hands_frames_out_in_order(tmp_path):
    paths, imgs = [], []
    for i in range(21):
        img = np.full((8, 9), i * 7, np.uint8)
        img[i % 8, i % 9] = 255
        p = str(tmp_path / f"{i:03d}.png")
        images.write_png(p, img)
        paths.append(p)
        imgs.append(img)
    with images.Prefetcher(paths, n_buffers=4, n_threads=3) as pf:
        assert len(pf) == 21
        for i in range(21):
            np.testing.assert_array_equal(pf.get(i), imgs[i])
        # out of order: the window restarts there
        for i in (5, 2, 17, 18, 3):
            np.testing.assert_array_equal(pf.get(i), imgs[i])
        with pytest.raises(IndexError):
            pf.get(21)


# ---------------------------------------------------------------------------
# the loaders on small layouts

def _euroc(root, stereo_drop=None, n=12):
    rng = np.random.default_rng(2)
    pairs = [(rng.integers(0, 256, (24, 32), dtype=np.uint8),
              rng.integers(0, 256, (24, 32), dtype=np.uint8)) for _ in range(n)]
    ns = cli_layouts.frame_ns(n, 20.0)
    gt = rng.normal(size=(n, 3))
    t_imu = cli_layouts.T0_NS - 10_000_000 + np.arange(3 * 40) * 5_000_000
    imu = (t_imu, rng.normal(size=(len(t_imu), 3)), rng.normal(size=(len(t_imu), 3)))
    cli_layouts.write_euroc(str(root), pairs, ns, gt, images.write_png, imu=imu)
    if stereo_drop is not None:
        csv = root / "mav0" / "cam1" / "data.csv"
        lines = csv.read_text().splitlines()
        csv.write_text("\n".join(lines[:1 + stereo_drop] + lines[2 + stereo_drop:]) + "\n")
    return pairs


def _same_sequence(sj, st):
    np.testing.assert_array_equal(st.timestamps, sj.timestamps)
    assert st.timestamps.dtype == np.float64
    assert st.left_paths == sj.left_paths and st.right_paths == sj.right_paths
    assert st.depth_paths == sj.depth_paths and st.depth_factor == sj.depth_factor
    for k in ("gt_t", "gt_pos"):
        a, b = getattr(sj, k), getattr(st, k)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)
    assert (sj.imu is None) == (st.imu is None)
    if sj.imu is not None:
        for k in ("t", "gyr", "acc"):
            np.testing.assert_array_equal(getattr(st.imu, k), getattr(sj.imu, k))
        lo, hi = sj.timestamps[2], sj.timestamps[5]
        np.testing.assert_array_equal(st.imu.between(lo, hi).t, sj.imu.between(lo, hi).t)
    for i in range(len(sj)):
        a, b = sj.read(i), st.read(i)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(np.asarray(y, np.float32), x)
    st.close()


@pytest.mark.parametrize("loader", ["load_euroc", "load_tum_vi"])
@pytest.mark.parametrize("stereo,with_imu", [(True, True), (False, False)])
def test_euroc_layout(tmp_path, loader, stereo, with_imu):
    _euroc(tmp_path, stereo_drop=4)
    sj = getattr(jds, loader)(str(tmp_path), stereo=stereo, with_imu=with_imu)
    st = getattr(tds, loader)(str(tmp_path), stereo=stereo, with_imu=with_imu)
    assert len(st) == (11 if stereo else 12)  # cam1 lacks frame 4
    _same_sequence(sj, st)


def test_tum_rgbd_layout_and_association(tmp_path):
    rng = np.random.default_rng(3)
    n = 24
    grays = [rng.integers(0, 256, (20, 28), dtype=np.uint8) for _ in range(n)]
    depths = [rng.uniform(0.3, 6.0, (20, 28)).astype(np.float32) for _ in range(n)]
    for d in depths:
        d[0, :3] = 0.0
    cli_layouts.write_tum_rgbd(str(tmp_path), grays, depths, rng.normal(size=(n, 3)),
                               images.write_png)
    sj, st = jds.load_tum_rgbd(str(tmp_path)), tds.load_tum_rgbd(str(tmp_path))
    assert len(st) == n - 1  # the dropped depth frame has no partner within 20 ms
    _same_sequence(sj, st)
    t_rgb, t_d = cli_layouts.tum_stamps(n)
    t_d = np.delete(t_d, cli_layouts.DEPTH_DROPPED)
    for pair in zip(jds.associate(t_rgb, t_d), tds.associate(t_rgb, t_d)):
        np.testing.assert_array_equal(pair[1], pair[0])
    # greedy: a depth stamp pairs once, the nearer RGB stamp first
    ta, tb = np.array([0.0, 0.011, 0.05]), np.array([0.006, 0.049])
    for a, b in zip(jds.associate(ta, tb), tds.associate(ta, tb)):
        np.testing.assert_array_equal(b, a)


def test_kitti_layout(tmp_path):
    rng = np.random.default_rng(4)
    for cam in ("image_0", "image_1"):
        os.makedirs(tmp_path / cam)
        for i in range(6):
            images.write_png(str(tmp_path / cam / f"{i:06d}.png"),
                             rng.integers(0, 256, (10, 14), dtype=np.uint8))
    np.savetxt(tmp_path / "times.txt", np.arange(6) * 0.1036)
    for stereo in (True, False):
        _same_sequence(jds.load_kitti(str(tmp_path), stereo=stereo),
                       tds.load_kitti(str(tmp_path), stereo=stereo))


# ---------------------------------------------------------------------------
# rectification

@pytest.fixture(scope="module")
def euroc_rect():
    return tyaml.load_stereo_rectification(
        os.path.join(FIXTURES, "settings_euroc_stereo_inertial.yaml"))


def test_rectify_maps_match_cv2(euroc_rect):
    ours = tds.make_rectify_maps(euroc_rect)
    for (mx, my), side in zip(ours, ("LEFT", "RIGHT")):
        b = euroc_rect[side]
        cx, cy = cv2.initUndistortRectifyMap(b["K"], b["D"], b["R"], b["P"][:3, :3],
                                             (b["width"], b["height"]), cv2.CV_32F)
        assert mx.dtype == np.float32 and mx.shape == (480, 752)
        assert np.abs(mx - cx).max() <= MAP_TOL_PX and np.abs(my - cy).max() <= MAP_TOL_PX
    # the JAX package's maps (cv2 underneath) and a smaller size
    for (a, b), (c, d) in zip(tds.make_rectify_maps(euroc_rect, (120, 188)),
                              jds.make_rectify_maps(euroc_rect, (120, 188))):
        assert np.abs(a - c).max() <= MAP_TOL_PX and np.abs(b - d).max() <= MAP_TOL_PX


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_rectify_matches_cv2_remap(euroc_rect, dtype):
    rng = np.random.default_rng(5)
    img = cv2.GaussianBlur(rng.integers(0, 256, (480, 752)).astype(np.uint8), (5, 5), 1.5)
    if dtype == "float32":
        img = img.astype(np.float32) + rng.uniform(0, 1, img.shape).astype(np.float32)
    (mx, my), _ = tds.make_rectify_maps(euroc_rect)
    # maps that also sample outside the image (the constant 0 border)
    mx = mx * 1.25 - 100.0
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    got = tds.rectify(torch.from_numpy(img), (torch.from_numpy(mx), torch.from_numpy(my))).numpy()
    assert got.dtype == img.dtype and (ref == 0).any()
    tol = REMAP_TOL_U8 if dtype == "uint8" else REMAP_TOL_F32
    assert np.abs(got.astype(np.float64) - ref.astype(np.float64)).max() <= tol
    # the JAX package's rectify is cv2.remap
    np.testing.assert_array_equal(jds.rectify(img, (mx, my)), ref)
    with pytest.raises(TypeError):
        tds.rectify(torch.from_numpy(img).double(), (torch.from_numpy(mx), torch.from_numpy(my)))


def test_raw_layout_rectifies_back(euroc_rect):
    """``scripts/cli_layouts.py`` warps a rectified render to the raw
    camera; the port's rectification brings it back (inside a margin, up
    to the two bilinear resamplings)."""
    rect = cli_layouts.euroc_rectification((458.654, 457.296, 367.215, 248.375), 0.11, 752, 480)
    rng = np.random.default_rng(6)
    img = cv2.GaussianBlur(rng.integers(0, 256, (480, 752)).astype(np.uint8), (0, 0), 4.0)
    raw = cli_layouts.raw_from_rectified(img, rect["LEFT"])
    (mx, my), _ = tds.make_rectify_maps(rect)
    back = tds.rectify(torch.from_numpy(raw), (torch.from_numpy(mx), torch.from_numpy(my)))
    inner = (slice(20, -20), slice(20, -20))
    err = np.abs(back.numpy()[inner].astype(int) - img[inner].astype(int))
    assert np.median(err) <= 1 and err.max() <= 8
