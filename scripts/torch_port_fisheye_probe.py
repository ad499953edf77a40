"""Where the fisheye stereo-inertial lap of ``tests/test_torch_fisheye_vi.py``
parts between the JAX package and the port, on the CPU.

Runs the 12-frame lap (384x384, 10 frames/s, to the IMU init) in both
packages and prints, frame by frame, the state and inliers of each, whether
the two front ends gave the same features, each package's fisheye stereo
depths against a float64 least-squares DLT on its own rays, and the camera
centres' distance apart.  Then it runs the port's lap again with its DLT in
float64 (``--dlt64``): how far the lap moves when only the DLT's rounding
changes.  ``tests/test_torch_fisheye_vi.py::test_lap_parts_at_the_keyframe_pose``
holds the cause it points to::

    JAX_PLATFORMS=cpu python scripts/torch_port_fisheye_probe.py   # ~1 minute
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def dlt64(rays_l, rays_r, Rrl, trl) -> np.ndarray:
    """Left-frame points from z = 1 rays by a float64 least-squares DLT."""
    out = []
    for a, b in zip(rays_l, rays_r):
        A, y = [], []
        for ray, R, t in ((a, np.eye(3), np.zeros(3)), (b, Rrl, trl)):
            for k in (0, 1):
                A.append(ray[k] * R[2] - ray[2] * R[k])
                y.append(-(ray[k] * t[2] - ray[2] * t[k]))
        out.append(np.linalg.lstsq(np.array(A), np.array(y), rcond=None)[0])
    return np.array(out).reshape(-1, 3)


def main():
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    import test_torch_fisheye_vi as L
    from test_torch_fisheye import BASELINE, KB, KB2

    from orb_slam3_noted_tpu.pipeline import inertial_system as jis
    from orb_slam3_noted_tpu_torch.io.config import config_from
    from orb_slam3_noted_tpu_torch.models import cameras as C
    from orb_slam3_noted_tpu_torch.ops import fisheye_stereo as FS
    from orb_slam3_noted_tpu_torch.pipeline import inertial_system as tis
    from orb_slam3_noted_tpu_torch.pipeline import system as tsys

    rec = {"jax": [], "port": []}
    jf, tf = jis.FisheyeStereoInertialSLAM._fisheye_frontend, tsys.FisheyeStereoSLAM._fisheye_frontend

    def jwrap(self, a, b):
        out = jf(self, a, b)
        rec["jax"].append([np.asarray(out[0].xy), np.asarray(out[1]), np.asarray(out[2])])
        return out

    def twrap(self, a, b):
        out = tf(self, a, b)
        rec["port"].append([out[0].xy.numpy(), out[1].numpy(), out[2].numpy()])
        return out

    jis.FisheyeStereoInertialSLAM._fisheye_frontend = jwrap
    tsys.FisheyeStereoSLAM._fisheye_frontend = twrap
    inputs = L.make_lap_inputs()
    jcfg = L.lap_config()
    js = L.run_lap(jis.FisheyeStereoInertialSLAM(jcfg), inputs)
    ts = L.run_lap(tis.FisheyeStereoInertialSLAM(config_from(jcfg), device=torch.device("cpu")),
                   inputs)
    tsys.FisheyeStereoSLAM._fisheye_frontend = tf
    pj, pt = js.positions(), ts.positions()
    Rlr = L.rlr().astype(np.float64)
    Rrl, trl = Rlr.T, -Rlr.T @ np.array([BASELINE, 0.0, 0.0])
    unp = lambda params, uv: C.kb8_unproject(torch.tensor(params, dtype=torch.float64),
                                             torch.tensor(uv, dtype=torch.float64)).numpy()
    print("frame  state j/p  inliers j/p  same xy  depth vs float64 DLT max mm j/p  "
          "centres apart mm")
    for i in range(len(pj)):
        row = []
        for k in ("jax", "port"):
            xy, depth, uv2 = rec[k][i]
            ok = depth > 0
            p = dlt64(unp(KB, xy[ok]), unp(KB2, uv2[ok]), Rrl, trl)
            row.append(1e3 * np.abs(depth[ok] - p[:, 2]).max())
        same = np.array_equal(rec["jax"][i][0], rec["port"][i][0])
        print(f"{i:5d}  {js.trajectory[i].state}/{ts.trajectory[i].state}  "
              f"{js.trajectory[i].n_inliers:4d}/{ts.trajectory[i].n_inliers:4d}  {same!s:7}  "
              f"{row[0]:.3f}/{row[1]:.3f}  {1e3 * np.linalg.norm(pj[i] - pt[i]):.3f}")
    print(f"camera centres apart, largest coordinate: {1e3 * np.abs(pj - pt).max():.2f} mm")

    plain = FS.triangulate_dlt
    FS.triangulate_dlt = lambda r1, r2, R, t: plain(r1.double(), r2.double(), R.double(),
                                                   t.double()).float()
    try:
        t64 = L.run_lap(tis.FisheyeStereoInertialSLAM(config_from(jcfg),
                                                      device=torch.device("cpu")), inputs)
    finally:
        FS.triangulate_dlt = plain
    p64 = t64.positions()
    print(f"port with a float64 DLT: {1e3 * np.abs(p64 - pt).max():.2f} mm from the port's lap, "
          f"{1e3 * np.abs(p64 - pj).max():.2f} mm from JAX's (largest coordinate)")


if __name__ == "__main__":
    main()
