"""Dataset layouts for the CLI runs of ``chip_smoke.py`` (phase 14) and of
``scripts/torch_port_reference_lap.py --mode cli_*``: the same numpy code
writes the directory that each package's CLI reads, so the two runs see the
same files.  Numpy and the standard library only; the PNG writer is passed
in (both sides pass the port's ``io.images.write_png``).

- :func:`write_euroc`: the EuRoC MAV layout (``mav0/cam0``, ``cam1``,
  ``imu0``, ``state_groundtruth_estimate0``), also TUM-VI's.  With a
  rectification, each rendered (rectified) image is first warped back to
  the raw camera: rad-tan distortion and the rectifying rotation of
  :func:`euroc_rectification`, so that the CLI's rectification does real work.
- :func:`write_tum_rgbd`: the TUM RGB-D layout (``rgb.txt``, ``depth.txt``,
  ``groundtruth.txt``), RGB PNGs and 16-bit depth PNGs at scale 5000, the
  depth stamps ~10 ms off the RGB stamps and one depth frame missing, so
  the association does work.
- :func:`euroc_yaml`, :func:`tum_rgbd_yaml`, :func:`tumvi_yaml`: settings
  files in the schema of the reference's ``EuRoC.yaml``, ``TUM1.yaml`` and
  ``TUM_512.yaml``.
"""

from __future__ import annotations

import os

import numpy as np

T0_NS = 1_000_000_000      # first stamp of a layout: 1 s
DEPTH_FACTOR = 5000.0      # TUM RGB-D: metres = value / 5000
TUM_FPS = 30.0
DEPTH_DROPPED = 20         # the RGB-D layout's frame whose depth image is missing


def _rot(axis) -> np.ndarray:
    """Rodrigues rotation of the axis-angle vector ``axis`` (float64)."""
    w = np.asarray(axis, np.float64)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def euroc_rectification(cam_params, baseline: float, width: int, height: int) -> dict:
    """LEFT/RIGHT blocks of a stereo rig whose rectified cameras are the
    rendered pinhole ``cam_params`` (``P``) at ``baseline``: raw cameras
    with EuRoC-like intrinsics and rad-tan distortion (``K``, ``D``; the
    raw focal length is larger, so the rectified image is covered) and a
    small rectifying rotation per side (``R``: rectified ray = R raw ray)."""
    fx, fy, cx, cy = cam_params
    P = np.array([[fx, 0.0, cx, 0.0], [0.0, fy, cy, 0.0], [0.0, 0.0, 1.0, 0.0]])
    Pr = P.copy()
    Pr[0, 3] = -fx * baseline
    return {
        "LEFT": dict(K=np.array([[470.2, 0.0, 369.4], [0.0, 469.3, 246.1], [0.0, 0.0, 1.0]]),
                     D=np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]),
                     R=_rot((0.0060, -0.0081, 0.0014)), P=P, width=width, height=height),
        "RIGHT": dict(K=np.array([[469.6, 0.0, 372.9], [0.0, 468.5, 251.0], [0.0, 0.0, 1.0]]),
                      D=np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]),
                      R=_rot((-0.0071, -0.0077, 0.0036)), P=Pr, width=width, height=height),
    }


def raw_from_rectified(rect: np.ndarray, blk: dict) -> np.ndarray:
    """The raw (distorted, unrectified) uint8 image whose rectification is
    ``rect``: each raw pixel undistorted (20 fixed-point iterations of the
    rad-tan model), rotated by ``R`` into the rectified camera, projected
    by ``P`` and sampled bilinearly from ``rect`` (0 outside), in float64."""
    h, w = rect.shape
    K, (k1, k2, p1, p2, k3) = blk["K"], blk["D"][:5]
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    xd, yd = (u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(20):
        r2 = x * x + y * y
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    ray = np.stack([x, y, np.ones_like(x)], -1) @ blk["R"].T
    pix = ray @ blk["P"][:3, :3].T
    px, py = pix[..., 0] / pix[..., 2], pix[..., 1] / pix[..., 2]
    x0, y0 = np.floor(px).astype(np.int64), np.floor(py).astype(np.int64)
    ax, ay = px - x0, py - y0
    src = rect.astype(np.float64)

    def tap(dy_, dx_):
        xx, yy = x0 + dx_, y0 + dy_
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return np.where(ok, src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], 0.0)

    val = ((1 - ay) * ((1 - ax) * tap(0, 0) + ax * tap(0, 1))
           + ay * ((1 - ax) * tap(1, 0) + ax * tap(1, 1)))
    return np.clip(np.rint(val), 0, 255).astype(np.uint8)


def _f(x) -> str:
    """A number as YAML / csv text, every digit of its float64."""
    return repr(float(x))


def _matrix(name: str, a: np.ndarray, dt: str = "d") -> str:
    a = np.atleast_2d(np.asarray(a, np.float64))
    data = ", ".join(repr(float(x)) for x in a.reshape(-1))
    return (f"{name}: !!opencv-matrix\n   rows: {a.shape[0]}\n   cols: {a.shape[1]}\n"
            f"   dt: {dt}\n   data: [{data}]\n")


def _orb(n_features: int) -> str:
    return (f"ORBextractor.nFeatures: {n_features}\nORBextractor.scaleFactor: 1.2\n"
            "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n")


def _imu(tbc: np.ndarray, noise_gyro, noise_acc, walk_gyro, walk_acc, freq) -> str:
    return (_matrix("Tbc", tbc, "f") + f"IMU.NoiseGyro: {_f(noise_gyro)}\n"
            f"IMU.NoiseAcc: {_f(noise_acc)}\nIMU.GyroWalk: {_f(walk_gyro)}\n"
            f"IMU.AccWalk: {_f(walk_acc)}\nIMU.Frequency: {_f(freq)}\n")


def euroc_yaml(rect: dict, fps: float, bf: float, th_depth: float, n_features: int,
               imu: dict) -> str:
    """``EuRoC.yaml`` (Stereo-Inertial): the rectified camera (``LEFT.P``),
    no distortion on it, the LEFT/RIGHT rectification blocks, Tbc and the
    IMU densities (``imu``: the keywords of :func:`_imu`)."""
    P = rect["LEFT"]["P"]
    out = ["%YAML:1.0\n", "# EuRoC.yaml schema, rectified stereo with an IMU\n",
           'Camera.type: "PinHole"\n',
           f"Camera.fx: {_f(P[0, 0])}\nCamera.fy: {_f(P[1, 1])}\nCamera.cx: {_f(P[0, 2])}\n"
           f"Camera.cy: {_f(P[1, 2])}\n",
           "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n",
           f"Camera.width: {rect['LEFT']['width']}\nCamera.height: {rect['LEFT']['height']}\n",
           f"Camera.fps: {_f(fps)}\nCamera.bf: {_f(bf)}\nCamera.RGB: 1\nThDepth: {_f(th_depth)}\n",
           _imu(**imu)]
    for side in ("LEFT", "RIGHT"):
        blk = rect[side]
        out.append(f"{side}.height: {blk['height']}\n{side}.width: {blk['width']}\n")
        out += [_matrix(f"{side}.D", blk["D"]), _matrix(f"{side}.K", blk["K"]),
                _matrix(f"{side}.R", blk["R"]), _matrix(f"{side}.P", blk["P"])]
    out.append(_orb(n_features))
    return "".join(out)


TUM1_PINHOLE = (517.306408, 516.469215, 318.643040, 255.313989)
TUM1_DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)


def tum_rgbd_yaml(width: int, height: int, n_features: int) -> str:
    """``TUM1.yaml`` (RGB-D): fr1's intrinsics and distortion (the CLI
    parses the distortion and, as the reference's does, never applies it),
    bf 40, ThDepth 40, DepthMapFactor 5000."""
    fx, fy, cx, cy = TUM1_PINHOLE
    k1, k2, p1, p2, k3 = TUM1_DIST
    return ("%YAML:1.0\n# TUM1.yaml schema, RGB-D\n" 'Camera.type: "PinHole"\n'
            f"Camera.fx: {fx}\nCamera.fy: {fy}\nCamera.cx: {cx}\nCamera.cy: {cy}\n"
            f"Camera.k1: {k1}\nCamera.k2: {k2}\nCamera.p1: {p1}\nCamera.p2: {p2}\n"
            f"Camera.k3: {k3}\nCamera.width: {width}\nCamera.height: {height}\n"
            f"Camera.fps: {TUM_FPS}\nCamera.bf: 40.0\nCamera.RGB: 1\nThDepth: 40.0\n"
            f"DepthMapFactor: {DEPTH_FACTOR}\n" + _orb(n_features))


def tumvi_yaml(cam1, cam2, rlr: np.ndarray, tlr, lapping, width: int, height: int, fps: float,
               bf: float, th_depth: float, n_features: int, imu: dict) -> str:
    """``TUM_512.yaml`` (Stereo-Inertial): two Kannala-Brandt cameras, Tlr
    (3x4), the lapping areas, Tbc and the IMU densities."""
    out = ["%YAML:1.0\n# TUM_512.yaml schema, fisheye stereo with an IMU\n",
           'Camera.type: "KannalaBrandt8"\n']
    for pre, c in (("Camera", cam1), ("Camera2", cam2)):
        out.append("".join(f"{pre}.{k}: {_f(float(v))}\n" for k, v in
                           zip(("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"), c)))
    tlr34 = np.concatenate([np.asarray(rlr, np.float64).reshape(3, 3),
                            np.asarray(tlr, np.float64).reshape(3, 1)], 1)
    out += [_matrix("Tlr", tlr34, "f"),
            f"Camera.lappingBegin: {_f(lapping[0])}\nCamera.lappingEnd: {_f(lapping[1])}\n"
            f"Camera2.lappingBegin: {_f(lapping[0])}\nCamera2.lappingEnd: {_f(lapping[1])}\n",
            f"Camera.width: {width}\nCamera.height: {height}\nCamera.fps: {_f(fps)}\n"
            f"Camera.bf: {_f(bf)}\nThDepth: {_f(th_depth)}\n", _imu(**imu), _orb(n_features)]
    return "".join(out)


def _csv(path: str, header: str, rows) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(header + "\n" + "".join(r + "\n" for r in rows))


def warp_serial(jobs) -> list:
    """:func:`raw_from_rectified` over (image, block) jobs, one by one."""
    return [raw_from_rectified(img, blk) for img, blk in jobs]


def write_euroc(root: str, pairs, frame_ns, gt_pos, write_png, imu=None, rect=None,
                warp=warp_serial) -> None:
    """EuRoC layout at ``root``: ``pairs`` [(left, right) uint8] at stamps
    ``frame_ns`` (int ns), the camera centres ``gt_pos`` (n, 3) as ground
    truth at the same stamps, ``imu`` = (t_ns, gyr, acc) rows; with
    ``rect`` (:func:`euroc_rectification`) the images written are raw,
    warped by ``warp`` (a list of (image, block) jobs to the raw images:
    :func:`warp_serial` or the same over a process pool)."""
    imgs = [img for pair in pairs for img in pair]
    if rect is not None:
        imgs = warp([(img, rect[("LEFT", "RIGHT")[k % 2]]) for k, img in enumerate(imgs)])
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    for k, img in enumerate(imgs):
        write_png(os.path.join(root, "mav0", ("cam0", "cam1")[k % 2], "data",
                               f"{int(frame_ns[k // 2])}.png"), img)
    for cam in ("cam0", "cam1"):
        _csv(os.path.join(root, "mav0", cam, "data.csv"), "#timestamp [ns],filename",
             (f"{int(t)},{int(t)}.png" for t in frame_ns))
    _csv(os.path.join(root, "mav0", "state_groundtruth_estimate0", "data.csv"),
         "#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], q_RS_x [], "
         "q_RS_y [], q_RS_z []",
         (f"{int(t)},{_f(p[0])},{_f(p[1])},{_f(p[2])},1.0,0.0,0.0,0.0"
          for t, p in zip(frame_ns, np.asarray(gt_pos, np.float64))))
    if imu is not None:
        t_ns, gyr, acc = imu
        _csv(os.path.join(root, "mav0", "imu0", "data.csv"),
             "#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],w_RS_S_z [rad s^-1],"
             "a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],a_RS_S_z [m s^-2]",
             (f"{int(t)},{_f(g[0])},{_f(g[1])},{_f(g[2])},{_f(a[0])},{_f(a[1])},{_f(a[2])}"
              for t, g, a in zip(t_ns, np.asarray(gyr, np.float64), np.asarray(acc, np.float64))))


def rgb_from_gray(gray: np.ndarray) -> np.ndarray:
    """An RGB image whose BT.601 luma is within a grey level of ``gray``."""
    g = gray.astype(np.int32)
    return np.stack([np.clip(g + 12, 0, 255), g, np.clip(g - 30, 0, 255)], -1).astype(np.uint8)


def tum_stamps(n: int):
    """(rgb stamps, depth stamps) in seconds: 30 Hz from T0, the depth
    stamps 7-13 ms later."""
    t = T0_NS * 1e-9 + np.arange(n) / TUM_FPS
    return t, t + 0.010 + 0.003 * np.sin(np.arange(n))


def write_tum_rgbd(root: str, grays, depths_m, gt_pos, write_png) -> None:
    """TUM RGB-D layout at ``root``: RGB PNGs from ``grays``, 16-bit depth
    PNGs from ``depths_m`` (0 = no depth), all but frame ``DEPTH_DROPPED``'s
    depth, the camera centres as ground truth 3 ms after each RGB stamp."""
    t_rgb, t_d = tum_stamps(len(grays))
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_rows, d_rows = [], []
    for k, (g, d) in enumerate(zip(grays, depths_m)):
        name = f"{t_rgb[k]:.6f}.png"
        write_png(os.path.join(root, "rgb", name), rgb_from_gray(g))
        rgb_rows.append(f"{t_rgb[k]:.6f} rgb/{name}")
        if k == DEPTH_DROPPED:
            continue
        dv = np.where(np.isfinite(d) & (d > 0), np.rint(d * DEPTH_FACTOR), 0)
        dname = f"{t_d[k]:.6f}.png"
        write_png(os.path.join(root, "depth", dname), np.clip(dv, 0, 65535).astype(np.uint16))
        d_rows.append(f"{t_d[k]:.6f} depth/{dname}")
    _csv(os.path.join(root, "rgb.txt"), "# color images\n# timestamp filename", rgb_rows)
    _csv(os.path.join(root, "depth.txt"), "# depth maps\n# timestamp filename", d_rows)
    _csv(os.path.join(root, "groundtruth.txt"), "# timestamp tx ty tz qx qy qz qw",
         (f"{t + 0.003:.6f} {_f(p[0])} {_f(p[1])} {_f(p[2])} 0 0 0 1"
          for t, p in zip(t_rgb, np.asarray(gt_pos, np.float64))))


# ---------------------------------------------------------------------------
# the three layouts of phase 14, from the poses and IMU samples that the JAX
# reference runs stored

SI_FIXTURE = "stereo_inertial_lap.json"      # bench.py's stereo-inertial lap
FE_FIXTURE = "fisheye_inertial_lap.json"     # the TUM-VI 512x512 fisheye lap
EUROC_FRAMES, TUM_FRAMES, TUMVI_FRAMES = 80, 32, 64
EUROC_BATCH = 16
TUM_W, TUM_H, TUM_FEATURES = 640, 480, 1000
STEREO_BASELINE = 0.11                       # bench.py's stereo rig


def b64_array(text: str, dtype: str, shape) -> np.ndarray:
    import base64

    return np.frombuffer(base64.b64decode(text), dtype).reshape(shape).copy()


def stored_poses(ref: dict, n: int):
    """The first ``n`` (Rwc float32, twc float64) of a fixture."""
    rwc = b64_array(ref["rwc_f32"], "<f4", (ref["frames"], 3, 3))[:n]
    twc = b64_array(ref["twc_f64"], "<f8", (ref["frames"], 3))[:n]
    return rwc, twc


def stored_imu(ref: dict, n_chunks: int):
    """(t_ns, gyr, acc) of the fixture's first ``n_chunks`` IMU chunks."""
    chunks = ref["imu"][:n_chunks]
    get = lambda k, w: np.concatenate([b64_array(c[k], "<f8", (c["n"], w) if w else (c["n"],))
                                       for c in chunks])
    ts = get("ts", 0)
    return T0_NS + np.rint(ts * 1e9).astype(np.int64), get("gyr", 3), get("acc", 3)


def frame_ns(n: int, fps: float) -> np.ndarray:
    return T0_NS + np.rint(np.arange(n) / fps * 1e9).astype(np.int64)


def cases(si_ref: dict, fe_ref: dict) -> dict:
    """What each layout renders and how its CLI runs: {case: dict(kind,
    poses, n, camera, ...)}; ``kind`` names the render: ``stereo`` (a
    rectified pinhole pair at ``camera``, ``BoxRoom(seed=0)``), ``rgbd`` (an
    image and its depth), ``fisheye`` (a KB8 pair in the fixture's room)."""
    si_cfg, fe_cfg = si_ref["config"], fe_ref["config"]
    return {
        "cli_euroc": dict(kind="stereo", n=EUROC_FRAMES, poses=stored_poses(si_ref, EUROC_FRAMES),
                          camera=tuple(si_ref["camera"]), width=si_ref["width"],
                          height=si_ref["height"], baseline=STEREO_BASELINE,
                          imu=stored_imu(si_ref, EUROC_FRAMES // si_ref["batch"]),
                          fps=si_cfg["fps"]),
        "cli_tum_rgbd": dict(kind="rgbd", n=TUM_FRAMES, poses=stored_poses(si_ref, TUM_FRAMES),
                             camera=TUM1_PINHOLE, width=TUM_W, height=TUM_H),
        "cli_tumvi": dict(kind="fisheye", n=TUMVI_FRAMES, poses=stored_poses(fe_ref, TUMVI_FRAMES),
                          room=fe_ref["room"], camera1=tuple(fe_ref["camera1"]),
                          camera2=tuple(fe_ref["camera2"]),
                          rlr=np.asarray(fe_cfg["tlr_r"], np.float32).reshape(3, 3),
                          tlr=tuple(fe_cfg["tlr_t"]), width=fe_ref["width"],
                          height=fe_ref["height"], imu=stored_imu(fe_ref, TUMVI_FRAMES),
                          fps=fe_cfg["fps"]),
    }


def write_case(name: str, case: dict, frames, root: str, si_ref: dict, fe_ref: dict,
               write_png, warp=warp_serial) -> list:
    """Write layout ``name`` under ``root`` from its rendered ``frames``
    ((left, right) uint8 pairs, or (gray uint8, depth float32); ``warp`` as
    for :func:`write_euroc`); returns the CLI's arguments (outputs under
    ``root``)."""
    seq = os.path.join(root, "seq")
    settings = os.path.join(root, "settings.yaml")
    out = ["--seq", seq, "--settings", settings, "--out", os.path.join(root, "traj.txt"),
           "--eval", "--metrics", os.path.join(root, "metrics.jsonl")]
    _, twc = case["poses"]
    if name == "cli_euroc":
        si = si_ref["config"]
        rect = euroc_rectification(case["camera"], case["baseline"], case["width"],
                                   case["height"])
        write_euroc(seq, frames, frame_ns(case["n"], case["fps"]), twc, write_png,
                    imu=case["imu"], rect=rect, warp=warp)
        text = euroc_yaml(rect, fps=case["fps"], bf=float(si_ref["bf"]),
                          th_depth=si["th_depth"], n_features=si["n_features"],
                          imu=dict(tbc=np.eye(4), noise_gyro=si["imu_noise_gyro"],
                                   noise_acc=si["imu_noise_acc"], walk_gyro=si["imu_walk_gyro"],
                                   walk_acc=si["imu_walk_acc"], freq=si["imu_freq"]))
        args = ["--dataset", "euroc", "--mode", "stereo-inertial",
                "--batch", str(EUROC_BATCH), "--times"]
    elif name == "cli_tum_rgbd":
        write_tum_rgbd(seq, [f[0] for f in frames], [f[1] for f in frames], twc, write_png)
        text = tum_rgbd_yaml(case["width"], case["height"], TUM_FEATURES)
        args = ["--dataset", "tum-rgbd", "--mode", "rgbd",
                "--checkpoint-out", os.path.join(root, "map.npz")]
    else:
        fe = fe_ref["config"]
        write_euroc(seq, frames, frame_ns(case["n"], case["fps"]), twc, write_png,
                    imu=case["imu"])
        text = tumvi_yaml(case["camera1"], case["camera2"], case["rlr"], case["tlr"],
                          tuple(fe["lapping_l"]), case["width"], case["height"], case["fps"],
                          float(fe["bf"]), fe["th_depth"], fe["n_features"],
                          imu=dict(tbc=np.eye(4), noise_gyro=fe["imu_noise_gyro"],
                                   noise_acc=fe["imu_noise_acc"], walk_gyro=fe["imu_walk_gyro"],
                                   walk_acc=fe["imu_walk_acc"], freq=fe["imu_freq"]))
        args = ["--dataset", "tumvi", "--mode", "stereo-inertial"]
    with open(settings, "w") as f:
        f.write(text)
    return args + out


def settings_record(cfg, imu) -> dict:
    """A parsed ``SlamConfig`` (either package's) and IMU dict as JSON:
    every field, cameras as kind and parameters, arrays as lists."""
    import dataclasses

    rec = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("camera", "camera2") and v is not None:
            v = {"kind": int(v.kind), "params": [float(p) for p in v.params]}
        elif isinstance(v, tuple):
            v = [float(x) for x in v]
        rec[f.name] = v
    imu_rec = None if imu is None else {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray)
                                            else v) for k, v in imu.items()}
    return {"config": rec, "imu": imu_rec}


def cli_outputs(root: str, result: dict) -> dict:
    """What a CLI run left under ``root``: the trajectory's rows, the
    metric lines (their events and the final line's ``imu_stage``), the
    checkpoint's keys and dtypes."""
    import json

    traj = np.loadtxt(os.path.join(root, "traj.txt"), ndmin=2)
    with open(os.path.join(root, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    out = {"result": result, "traj_rows": int(traj.shape[0]),
           "metric_events": [x["event"] for x in lines],
           "imu_stage": lines[-1].get("imu_stage")}
    ck = os.path.join(root, "map.npz")
    if os.path.exists(ck):
        with np.load(ck, allow_pickle=False) as z:
            out["checkpoint"] = {k: str(z[k].dtype) for k in sorted(z.files)}
    return out
