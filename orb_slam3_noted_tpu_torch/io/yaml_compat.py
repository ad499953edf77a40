"""Loader for the reference's per-sequence YAML settings files (port of
:mod:`orb_slam3_noted_tpu.io.yaml_compat`).

Parses the schema that ``Tracking::Parse{Cam,ORB,IMU}ParamFile`` reads
(examples: ``Examples/Stereo-Inertial/EuRoC.yaml``, ``TUM_512.yaml``) into a
:class:`SlamConfig` and the IMU calibration.  The JAX package reads the file
through ``cv2.FileStorage``; the port has a parser of its own for the subset
of OpenCV's YAML that those files use:

- the ``%YAML:1.0`` header and ``---``;
- ``#`` comments;
- top-level ``Key.sub: value`` scalars: ints, floats (``1.0e-3``), quoted or
  bare strings;
- ``!!opencv-matrix`` blocks with ``rows``, ``cols``, ``dt`` and a
  ``data: [ ... ]`` that may run over several lines.

Anything else raises ``ValueError`` naming the line or the key.  Values are
read with ``cv::FileNode``'s semantics: a missing key gives the default, an
int reads as a float, a matrix as an array of its ``dt``.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import Camera, KANNALA_BRANDT8, PINHOLE

_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")
_KEY = re.compile(r"([A-Za-z_][\w.]*)\s*:(.*)")
_DTYPES = {"d": np.float64, "f": np.float32, "i": np.int32, "s": np.int16,
           "w": np.uint16, "u": np.uint8, "c": np.int8}


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if ch in "\"'" and quote in (None, ch):
            quote = None if quote else ch
        elif ch == "#" and quote is None:
            return line[:i]
    return line


def _scalar(text: str, key: str):
    v = text.strip()
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "\"'":
        return v[1:-1]
    if _INT.fullmatch(v):
        return int(v)
    if _FLOAT.fullmatch(v):
        return float(v)
    if not v or v[0] in "[{!&*|>" or ": " in v:
        raise ValueError(f"settings key {key!r}: unsupported value {text.strip()!r}")
    return v


def _matrix(key: str, fields: dict) -> np.ndarray:
    try:
        rows, cols, dt, data = (fields[k] for k in ("rows", "cols", "dt", "data"))
    except KeyError as e:
        raise ValueError(f"settings key {key!r}: opencv-matrix without {e.args[0]!r}") from None
    if dt not in _DTYPES:
        raise ValueError(f"settings key {key!r}: unknown matrix type {dt!r}")
    if len(data) != rows * cols:
        raise ValueError(f"settings key {key!r}: {len(data)} values for a {rows}x{cols} matrix")
    return np.asarray(data, np.float64).astype(_DTYPES[dt]).reshape(rows, cols)


def parse_opencv_yaml(text: str) -> dict:
    """Top-level keys of an OpenCV YAML settings file: int, float, str or a
    (rows, cols) array for an ``!!opencv-matrix``."""
    out: dict = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        raw = _strip_comment(lines[i])
        i += 1
        if not raw.strip() or raw.startswith("%YAML") or raw.strip() == "---":
            continue
        m = _KEY.fullmatch(raw.rstrip())
        if raw[0].isspace() or m is None:
            raise ValueError(f"settings line {i}: cannot parse {lines[i - 1]!r}")
        key, rest = m.group(1), m.group(2).strip()
        if rest != "!!opencv-matrix":
            out[key] = _scalar(rest, key)
            continue
        fields: dict = {}
        while i < len(lines):
            sub = _strip_comment(lines[i])
            if sub.strip() and not sub[0].isspace():
                break
            i += 1
            if not sub.strip():
                continue
            sm = _KEY.fullmatch(sub.strip())
            if sm is None:
                raise ValueError(f"settings key {key!r}: cannot parse {sub.strip()!r}")
            name, val = sm.group(1), sm.group(2).strip()
            if name != "data":
                fields[name] = _scalar(val, f"{key}.{name}")
                continue
            while "]" not in val:
                if i >= len(lines):
                    raise ValueError(f"settings key {key!r}: unterminated data list")
                val += " " + _strip_comment(lines[i]).strip()
                i += 1
            body = val.strip()
            if not (body.startswith("[") and body.endswith("]")):
                raise ValueError(f"settings key {key!r}: data must be one [ ... ] list")
            items = [x for x in body[1:-1].replace(",", " ").split()]
            try:
                fields["data"] = [float(x) for x in items]
            except ValueError:
                raise ValueError(f"settings key {key!r}: non-numeric matrix data") from None
        out[key] = _matrix(key, fields)
    return out


def read_settings_file(path: str) -> dict:
    with open(path) as f:
        return parse_opencv_yaml(f.read())


def _read(fs: dict, key: str, default=None):
    """``cv::FileNode`` semantics: missing -> default, int -> float."""
    v = fs.get(key, default)
    if isinstance(v, int) and not isinstance(v, bool):
        return float(v)
    return v


def _num(fs: dict, key: str) -> float:
    """A required number."""
    v = _read(fs, key)
    if not isinstance(v, float):
        raise ValueError(f"settings key {key!r}: expected a number, found {v!r}")
    return v


def load_settings(path: str):
    """Parse a reference YAML file.

    Returns (SlamConfig, imu_params | None); imu_params holds ``Tbc`` (4, 4),
    the raw noise and walk densities and the frequency when the file has an
    IMU section (``SlamConfig.imu_calib`` discretises the densities).
    """
    fs = read_settings_file(path)

    cam_type = _read(fs, "Camera.type", "PinHole")
    fx, fy, cx, cy = (_num(fs, f"Camera.{k}") for k in ("fx", "fy", "cx", "cy"))

    if cam_type == "KannalaBrandt8":
        ks = [float(_read(fs, f"Camera.k{i + 1}", 0.0)) for i in range(4)]
        camera = Camera(KANNALA_BRANDT8, (fx, fy, cx, cy, *ks))
        dist = ()
    else:
        camera = Camera(PINHOLE, (fx, fy, cx, cy))
        d = [float(_read(fs, f"Camera.{k}", 0.0) or 0.0) for k in ("k1", "k2", "p1", "p2", "k3")]
        dist = tuple(d) if any(abs(x) > 0 for x in d) else ()

    # the second camera of non-rectified fisheye stereo (Camera2.*, Tlr and
    # the lapping areas; reference ``Tracking::ParseCamParamFile``)
    cam2 = None
    tlr_r: tuple = ()
    tlr_t = (0.0, 0.0, 0.0)
    lap_l = (0.0, 1e9)
    lap_r = (0.0, 1e9)
    if _read(fs, "Camera2.fx") is not None:
        p2 = [_num(fs, f"Camera2.{k}") for k in ("fx", "fy", "cx", "cy")]
        if cam_type == "KannalaBrandt8":
            p2 += [float(_read(fs, f"Camera2.k{i + 1}", 0.0) or 0.0) for i in range(4)]
            cam2 = Camera(KANNALA_BRANDT8, tuple(p2))
        else:
            cam2 = Camera(PINHOLE, tuple(p2))
        tlr = _read(fs, "Tlr")
        if tlr is not None:
            tlr = np.asarray(tlr, np.float64)
            if tlr.size not in (12, 16):
                raise ValueError(f"settings key 'Tlr': {tlr.size} values, expected 3x4 or 4x4")
            tlr = tlr.reshape(4, 4) if tlr.size == 16 else tlr.reshape(3, 4)
            tlr_r = tuple(tlr[:3, :3].reshape(-1).tolist())
            tlr_t = tuple(tlr[:3, 3].tolist())
        lb, le = _read(fs, "Camera.lappingBegin"), _read(fs, "Camera.lappingEnd")
        if lb is not None and le is not None:
            lap_l = (float(lb), float(le))
        lb2, le2 = _read(fs, "Camera2.lappingBegin"), _read(fs, "Camera2.lappingEnd")
        if lb2 is not None and le2 is not None:
            lap_r = (float(lb2), float(le2))

    cfg = SlamConfig(
        camera=camera,
        camera2=cam2,
        tlr_r=tlr_r, tlr_t=tlr_t,
        lapping_l=lap_l, lapping_r=lap_r,
        width=int(_read(fs, "Camera.width", 752)),
        height=int(_read(fs, "Camera.height", 480)),
        fps=float(_read(fs, "Camera.fps", 30.0)),
        bf=float(_read(fs, "Camera.bf", 0.0) or 0.0),
        th_depth=float(_read(fs, "ThDepth", 35.0) or 35.0),
        dist_coeffs=dist,
        n_features=int(_read(fs, "ORBextractor.nFeatures", 1200)),
        n_levels=int(_read(fs, "ORBextractor.nLevels", 8)),
        scale_factor=float(_read(fs, "ORBextractor.scaleFactor", 1.2)),
        ini_th_fast=float(_read(fs, "ORBextractor.iniThFAST", 20)),
        min_th_fast=float(_read(fs, "ORBextractor.minThFAST", 7)),
    )

    imu = None
    tbc = _read(fs, "Tbc")
    if tbc is not None:
        tbc = np.asarray(tbc, np.float64)
        if tbc.size != 16:
            raise ValueError(f"settings key 'Tbc': {tbc.size} values, expected 4x4")
        freq = float(_read(fs, "IMU.Frequency", 200.0))
        imu = dict(
            Tbc=tbc.reshape(4, 4),
            freq=freq,
            noise_gyro=_num(fs, "IMU.NoiseGyro"),
            noise_acc=_num(fs, "IMU.NoiseAcc"),
            walk_gyro=_num(fs, "IMU.GyroWalk"),
            walk_acc=_num(fs, "IMU.AccWalk"),
        )
        # the IMU section in the typed config too, so imu_calib() works
        cfg = dataclasses.replace(
            cfg,
            imu_rbc=tuple(imu["Tbc"][:3, :3].reshape(-1).tolist()),
            imu_tbc=tuple(imu["Tbc"][:3, 3].tolist()),
            imu_noise_gyro=imu["noise_gyro"],
            imu_noise_acc=imu["noise_acc"],
            imu_walk_gyro=imu["walk_gyro"],
            imu_walk_acc=imu["walk_acc"],
            imu_freq=freq,
        )
    return cfg, imu


def load_stereo_rectification(path: str):
    """The LEFT./RIGHT. K, D, R, P blocks of the stereo example drivers
    (``stereo_inertial_euroc.cc``), float64, with each side's size; None
    when the file has none.  A block that lacks one of the four raises."""
    fs = read_settings_file(path)
    out = {}
    for side in ("LEFT", "RIGHT"):
        blk = {}
        for key in ("K", "D", "R", "P"):
            v = _read(fs, f"{side}.{key}")
            if v is not None:
                if not isinstance(v, np.ndarray):
                    raise ValueError(f"settings key '{side}.{key}': expected an opencv-matrix")
                blk[key] = np.asarray(v, np.float64)
        if blk:
            missing = [k for k in ("K", "D", "R", "P") if k not in blk]
            if missing:
                raise ValueError(f"settings block {side}: no {', '.join(missing)}")
            blk["height"] = int(_read(fs, f"{side}.height", 0))
            blk["width"] = int(_read(fs, f"{side}.width", 0))
            out[side] = blk
    return out or None
