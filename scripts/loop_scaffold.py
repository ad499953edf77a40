"""A keyframe map with a known Sim(3) drift and a loop to close, in numpy.

The tail keyframe sees the first keyframe's scene again, but its pose and
its map points live in a drifted world ``x' = s Rd x + td``, as after a long
monocular lap: the same descriptors as keyframe 0, the same points moved by
the drift.  The keyframes between have unrelated descriptors and no points.
A loop closer must find keyframe 0 from the tail, verify the Sim(3) and pull
the tail's points back onto keyframe 0's.

``baseline`` puts the tail's true camera centre that far (metres, world
frame) from keyframe 0's.  At zero baseline both views see the points along
the same rays, reprojection in either direction does not observe scale, and
the Sim(3) refinement's scale is a free gauge (ROADMAP Queue 3).

Both packages build their map from the same arrays: ``drifted_map_inputs``
makes them with numpy from a seed, and ``build_map`` writes them with a
package's own ``map_state`` functions::

    inputs = drifted_map_inputs(seed=0)
    m = build_map(MS, MS.empty_map(cfg), inputs, asarray)

``asarray`` turns a numpy array into the package's array type (the port
wants descriptors as int32 views of their uint32 bits).
"""

from __future__ import annotations

import numpy as np

SMALL = dict(cam=(260.0, 260.0, 159.5, 119.5), width=320, height=240, n_kf=12, n_pts=150,
             max_keyframes=32, max_map_points=4096)
# bench.py's monocular configuration: EuRoC-sized pinhole camera, 752x480,
# 1200 features a keyframe, 64 keyframes, 8192 map points
FULL = dict(cam=(458.654, 457.296, 367.215, 248.375), width=752, height=480, n_kf=64,
            n_pts=1200, max_keyframes=64, max_map_points=8192)
DRIFT_ROT = (0.02, 0.08, -0.03)
DRIFT_T = (0.4, -0.2, 0.3)
DRIFT_SCALE = 1.12
BASELINE = (0.3, -0.1, 0.2)


def rodrigues(w) -> np.ndarray:
    """float32 rotation matrix exp(hat(w)), computed in float64."""
    w = np.asarray(w, np.float64)
    t = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if t < 1e-12:
        return (np.eye(3) + W).astype(np.float32)
    return (np.eye(3) + np.sin(t) / t * W + (1 - np.cos(t)) / t ** 2 * W @ W).astype(np.float32)


def _project(cam, pts, R, t):
    fx, fy, cx, cy = cam
    xc = pts.astype(np.float64) @ R.astype(np.float64).T + t
    return np.stack([fx * xc[:, 0] / xc[:, 2] + cx, fy * xc[:, 1] / xc[:, 2] + cy],
                    axis=-1).astype(np.float32)


def drifted_map_inputs(seed: int = 0, cam=SMALL["cam"], n_kf: int = SMALL["n_kf"],
                       n_pts: int = SMALL["n_pts"], baseline=(0.0, 0.0, 0.0),
                       drift_scale: float = DRIFT_SCALE, **_) -> dict:
    """Every array the map is built from (float32, int32, uint32 descriptors),
    plus the true points ``pts`` and the drift ``S_drift`` = (Rd, td, sd)."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-2, 2, size=(n_pts, 3)) + np.array([0, 0, 5.0])).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, size=(n_pts, 8), dtype=np.uint32)
    Rd = rodrigues(DRIFT_ROT)
    td = np.asarray(DRIFT_T, np.float32)
    sd = np.float32(drift_scale)
    poses = [(rodrigues([0.0, 0.03 * k, 0.0]), np.array([0.1 * k, 0.0, 0.05 * k], np.float32))
             for k in range(n_kf)]
    mid_desc = [rng.integers(0, 2 ** 32, size=(n_pts, 8), dtype=np.uint32)
                for _ in range(1, n_kf - 1)]
    # the tail's true pose: keyframe 0's rotation, its centre moved by the
    # baseline; in the drifted world x_c' = sd x_c (mono scale drift)
    R0, t0 = poses[0]
    t_true = (t0 - R0 @ np.asarray(baseline, np.float32)).astype(np.float32)
    pts_drift = (sd * (pts @ Rd.T) + td).astype(np.float32)
    Rcw_tail = (R0 @ Rd.T).astype(np.float32)
    tcw_tail = (sd * t_true - R0 @ Rd.T @ td).astype(np.float32)
    return dict(
        cam=tuple(cam), n_kf=n_kf, n_pts=n_pts, pts=pts, desc=desc, poses=poses,
        mid_desc=mid_desc, pts_drift=pts_drift, Rcw_tail=Rcw_tail, tcw_tail=tcw_tail,
        uv0=_project(cam, pts, *poses[0]), uv_tail=_project(cam, pts_drift, Rcw_tail, tcw_tail),
        S_drift=(Rd, td, sd), baseline=np.asarray(baseline, np.float32),
    )


def build_map(ms, m, inp: dict, asarray):
    """Keyframe 0 with the true points (slots 0..n-1), the middle keyframes,
    the tail (slot n_kf-1) with the drifted points (slots n..2n-1), written
    with ``ms.add_keyframe`` / ``ms.add_map_points``."""
    n, n_kf = inp["n_pts"], inp["n_kf"]
    f32 = lambda a: asarray(np.asarray(a, np.float32))
    i32 = lambda a: asarray(np.asarray(a, np.int32))
    ones = asarray(np.ones(n, bool))
    zi, zf = i32(np.zeros(n)), f32(np.zeros(n))
    no_uvr = f32(np.full(n, -1.0))
    first, second = i32(np.arange(n)), i32(np.arange(n, 2 * n))

    def points(m, start, pos, desc, slot):
        return ms.add_map_points(m, start, f32(pos), asarray(desc), f32(np.zeros((n, 3))), zf,
                                 f32(np.full(n, 100.0)), slot, ones, slot, first, slot, first)

    R0, t0 = inp["poses"][0]
    m = ms.add_keyframe(m, 0, f32(R0), f32(t0), 0, f32(inp["uv0"]), zi, zf, asarray(inp["desc"]),
                        ones, first, no_uvr)
    m = points(m, 0, inp["pts"], inp["desc"], 0)
    for k in range(1, n_kf - 1):
        R, t = inp["poses"][k]
        m = ms.add_keyframe(m, k, f32(R), f32(t), k, f32(np.zeros((n, 2))), zi, zf,
                            asarray(inp["mid_desc"][k - 1]), ones, i32(np.full(n, -1)), no_uvr)
    tail = n_kf - 1
    m = ms.add_keyframe(m, tail, f32(inp["Rcw_tail"]), f32(inp["tcw_tail"]), tail,
                        f32(inp["uv_tail"]), zi, zf, asarray(inp["desc"]), ones, second, no_uvr)
    return points(m, n, inp["pts_drift"], inp["desc"], tail)


class ScaffoldSlam:
    """What ``LoopCloser`` reads of a SLAM system, for either package, around
    a map: the map, the keyframe count, the last tracked pose and, with
    ``cfg``, the camera context (the whole verification ladder, the
    deferred fuses and GBA)."""

    def __init__(self, m, n_kf: int, cfg=None):
        self.m, self.n_kf = m, n_kf
        self.last_Rcw, self.last_tcw = m.kf_Rcw[n_kf - 1], m.kf_tcw[n_kf - 1]
        self.vel = None
        if cfg is not None:
            self.cam, self.cfg = cfg.camera, cfg
        self.loop_closer = None
        self._pending_loops = []


def corrected_point_errors(mp_pos: np.ndarray, inp: dict) -> tuple[np.ndarray, np.ndarray]:
    """(error after, error before) per tail point: its distance from the true
    point it duplicates."""
    n = inp["n_pts"]
    return (np.linalg.norm(np.asarray(mp_pos)[n:2 * n] - inp["pts"], axis=1),
            np.linalg.norm(inp["pts_drift"] - inp["pts"], axis=1))


# ---------------------------------------------------------------------------
# a stereo map for global BA: every keyframe sees every point

PIN = FULL["cam"]


def stereo_map_inputs(seed: int = 0, K: int = 6, M: int = 120, bf: float = 50.0) -> dict:
    """A stereo keyframe map in which every keyframe sees every point, so
    scale is observable: K cameras on an arc (slots 0..K-1, frame ids 0,
    10, ...), M points 5-9 m ahead, exact pixel and right-image
    observations; poses and points perturbed (2 cm, 4 cm) except keyframe
    0's.  ``t_true`` and ``pts_true`` are the truth."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M), rng.uniform(5, 9, M)],
                   axis=1)
    R = np.stack([rodrigues([0.0, 0.05 * (k - K / 2), 0.0]) for k in range(K)]).astype(np.float64)
    t = np.stack([np.array([0.3 * k, 0.02 * k, 0.0]) for k in range(K)])
    xc = np.einsum("kij,mj->kmi", R, pts) + t[:, None, :]
    fx, fy, cx, cy = PIN
    uv = np.stack([fx * xc[..., 0] / xc[..., 2] + cx, fy * xc[..., 1] / xc[..., 2] + cy], axis=-1)
    uvr = (uv[..., 0] - bf / xc[..., 2]).astype(np.float32)
    t = t.astype(np.float32)
    t_p = (t + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    t_p[0] = t[0]
    pts = pts.astype(np.float32)
    p_p = (pts + 0.04 * rng.standard_normal(pts.shape)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, size=(M, 8), dtype=np.uint32)
    level = rng.integers(0, 3, size=(K, M)).astype(np.int32)
    return dict(K=K, M=M, R=R.astype(np.float32), t=t_p, t_true=t, pts=p_p, pts_true=pts,
                uv=uv.astype(np.float32), uvr=uvr, desc=desc, level=level, bf=bf)


def build_stereo_map(ms, m, inp: dict, asarray):
    """Keyframe 0 and the points it makes (``add_map_points``), then the
    other keyframes, each binding every feature to its point."""
    M = inp["M"]
    f32 = lambda a: asarray(np.asarray(a, np.float32))
    i32 = lambda a: asarray(np.asarray(a, np.int32))
    ones = asarray(np.ones(M, bool))
    bind = i32(np.arange(M))
    for k in range(inp["K"]):
        m = ms.add_keyframe(m, k, f32(inp["R"][k]), f32(inp["t"][k]), 10 * k, f32(inp["uv"][k]),
                            i32(inp["level"][k]), f32(np.zeros(M)), asarray(inp["desc"]), ones,
                            bind if k else i32(np.full(M, -1)), f32(inp["uvr"][k]))
        if k == 0:
            m = ms.add_map_points(m, 0, f32(inp["pts"]), asarray(inp["desc"]),
                                  f32(np.zeros((M, 3))), f32(np.zeros(M)), f32(np.full(M, 100.0)),
                                  0, ones, 0, bind, 0, bind)
    return m


# ---------------------------------------------------------------------------
# the drifted map's essential graph as an inertial map has it (4-DoF graph)

def inertial_loop_graph(inp: dict) -> dict:
    """The pose graph of a loop correction on the drifted map of
    :func:`drifted_map_inputs`, as a gravity-aligned (inertial) map builds
    it: the keyframe poses (``R`` (n_kf, 3, 3) world-to-camera, ``t``), the
    temporal chain k-1 -> k (an inertial map's spanning tree) measured from
    those poses, and the loop edge 0 -> tail measured as the true relative
    pose (``T_j T_i^-1``: the tail's true pose is keyframe 0's rotation with
    its centre moved by the baseline); weights as ``LoopCloser._correct``
    gives them (1, the loop edge n/4 + 1) and keyframe 0 fixed.  float32
    arrays, the measurements composed in float64."""
    n_kf = inp["n_kf"]
    R = np.stack([p[0] for p in inp["poses"][: n_kf - 1]] + [inp["Rcw_tail"]]).astype(np.float32)
    t = np.stack([p[1] for p in inp["poses"][: n_kf - 1]] + [inp["tcw_tail"]]).astype(np.float32)
    i = np.arange(n_kf - 1)
    j = i + 1
    R64, t64 = R.astype(np.float64), t.astype(np.float64)
    eR = np.einsum("eab,ecb->eac", R64[j], R64[i])            # R_j R_i^T
    et = t64[j] - np.einsum("eab,eb->ea", eR, t64[i])
    R0, t0 = (np.asarray(x, np.float64) for x in inp["poses"][0])
    t_true = t0 - R0 @ inp["baseline"].astype(np.float64)   # tail: R0, centre moved
    n_real = len(i)
    return dict(
        R=R, t=t, i=np.append(i, 0).astype(np.int32), j=np.append(j, n_kf - 1).astype(np.int32),
        eR=np.concatenate([eR, np.eye(3)[None]]).astype(np.float32),
        et=np.concatenate([et, (t_true - t0)[None]]).astype(np.float32),
        weight=np.append(np.ones(n_real), n_real / 4 + 1.0).astype(np.float32),
        fixed=np.arange(n_kf) == 0,
    )
