"""Reference laps for the PyTorch port, run by the JAX package on the CPU.

Both laps are the ones ``chip_smoke.py`` drives through the port: the stereo
bench configuration (``bench.py``: EuRoC-sized pinhole camera, 752x480, 1200
features, 8 levels, ``bf = 0.11 * fx``, ``th_depth = 45``, 64 keyframes,
16384 map points, loop closing off), rendered from ``BoxRoom(seed=0)`` along
``orbit_trajectory(n, forward=0.03, yaw0=0.45)``.

``--mode rgbd`` (default): ``RGBDSLAM`` in localisation mode on the left
image and its depth; the map is the one built from frame 0's depth.
``--mode stereo``: ``StereoSLAM`` on the rectified pairs, full SLAM frame by
frame (keyframe insertion, local BA).
``--mode stereo_batch``: the same pairs, ``process`` until initialised, then
``process_batch`` in batches of 16 (``bench.py``'s stereo lap).
``--mode mono``: ``bench.py``'s monocular lap with loop closing off: 120
left images (``BoxRoom.render``), 8192 map points, ``MonoSLAM.process_batch``
in batches of 16 from frame 0, two-view initialisation included.

Writes per-frame states, inlier counts and ``positions()``, and for the
SLAM laps the keyframe and map-point counts, to a small JSON file (default
``tests/fixtures/<mode>_....json``, see ``FIXTURES``); the mono lap also
records the initialisation frame, the Sim(3)-aligned ATE, whether any
frame was relocalised, and each batch of initialisation attempts' RANSAC
minimal sets (``init_draws``: the seed, the (B, 256, 8) indices as
little-endian int16 and the (B, N) match masks as packed bits, both in
base64), so that the port can run the lap on the same hypotheses, and
the camera rotations the frames were rendered from (``rwc_f32``, (n, 3, 3)
little-endian float32 in base64: the port's ``orbit_trajectory`` rounds a
few of them 1 ulp otherwise, which moves edge pixels of the renders)::

    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py --mode stereo
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py --mode stereo_batch
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py --mode mono
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

W, H = 752, 480
CAM_PARAMS = (458.654, 457.296, 367.215, 248.375)
BASELINE = 0.11
BATCH = 16
FIXTURES = {
    "rgbd": ("rgbd_localization_lap.json", 48),
    "stereo": ("stereo_slam_lap.json", 48),
    "stereo_batch": ("stereo_batch_lap.json", 48),
    "mono": ("mono_slam_lap.json", 120),
}


def lap_inputs(n_frames: int):
    """(poses, uint8 left images, uint8 right images, float32 left depth
    maps) of the lap, numpy only."""
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

    room = BoxRoom(seed=0)
    poses = orbit_trajectory(n_frames, forward=0.03, yaw0=0.45)
    lefts, rights, depths = [], [], []
    for Rwc, twc in poses:
        left, right, depth = stereo_pair(room, Rwc, twc, CAM_PARAMS, W, H, BASELINE)
        lefts.append(left.astype(np.uint8))
        rights.append(right.astype(np.uint8))
        depths.append(depth.astype(np.float32))
    return poses, lefts, rights, depths


def jax_minimal_sets(matched: np.ndarray, key) -> np.ndarray:
    """(B, n_hyp, 8) minimal sets of a batch of attempts, as the JAX
    package's ``init_attempt_batch`` draws them from ``key`` (one key per
    attempt split from it, then ``reconstruct_two_views``' draw)."""
    import jax
    import jax.numpy as jnp

    n_hyp = 256  # ``reconstruct_two_views``' default, which ``init_attempt_batch`` keeps

    def one(valid, k):
        p = valid.astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        return jax.vmap(lambda kk: jax.random.choice(kk, valid.shape[0], shape=(8,),
                                                     replace=False, p=p))(
            jax.random.split(k, n_hyp))

    keys = jax.random.split(key, matched.shape[0])
    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(matched), keys))


def b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode("ascii")


def ate_frames(states: list, kf0: int, init_frame: int) -> list:
    """Frames a monocular lap is scored on: keyframe 0's frame and every
    frame from the initialisation on (the frames in between carry no pose)."""
    return [kf0] + list(range(init_frame, len(states)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--mode", choices=tuple(FIXTURES), default="rgbd")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    name, n_default = FIXTURES[args.mode]
    n = args.frames or n_default
    mono = args.mode == "mono"
    stereo = args.mode in ("stereo", "stereo_batch")
    if args.out is None:
        args.out = os.path.join(ROOT, "tests", "fixtures", name)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.pipeline.system import MonoSLAM, RGBDSLAM, StereoSLAM
    from orb_slam3_noted_tpu.utils.evaluation import ate_rmse
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory

    cam = Camera(PINHOLE, CAM_PARAMS)
    if mono:
        cfg = SlamConfig(
            camera=cam, width=W, height=H, n_features=1200,
            max_keyframes=64, max_map_points=8192,
            local_window=5, kf_max_interval=10, enable_loop_closing=False,
        )
        room = BoxRoom(seed=0)
        poses = orbit_trajectory(n, forward=0.03, yaw0=0.45)
        lefts = [room.render(R, t, cam.params, W, H).astype(np.uint8) for R, t in poses]
    else:
        cfg = SlamConfig(
            camera=cam, width=W, height=H, n_features=1200, n_levels=8,
            scale_factor=1.2, bf=BASELINE * cam.fx, th_depth=45.0,
            max_keyframes=64, max_map_points=16384,
            local_window=5, kf_max_interval=10, enable_loop_closing=False,
        )
        poses, lefts, rights, depths = lap_inputs(n)
    if mono:
        slam = MonoSLAM(cfg)
    elif stereo:
        slam = StereoSLAM(cfg)
    else:
        slam = RGBDSLAM(cfg)
        slam.set_localization_mode(True)

    # the initialisation frame and relocalisations, seen from the facade
    init_frames, relocs = [], []
    finish, reloc = slam._finish_initialize, slam._try_relocalize

    def finish_initialize(feats, frame_id, *rest):
        finish(feats, frame_id, *rest)
        if slam.state == "OK":
            init_frames.append(int(frame_id))

    def try_relocalize(feats, frame_id):
        out = reloc(feats, frame_id)
        if out is not None:
            relocs.append(int(frame_id))
        return out

    slam._finish_initialize, slam._try_relocalize = finish_initialize, try_relocalize
    # every batch of initialisation attempts: its seed, its draws, its masks
    import jax

    from orb_slam3_noted_tpu.pipeline import tracking as jtr

    init_draws, attempt = [], jtr.init_attempt_batch

    def recording_attempt(ref, cand, cam_, key):
        out = attempt(ref, cand, cam_, key)
        seed = int(np.asarray(key)[1])
        assert np.array_equal(np.asarray(key), np.asarray(jax.random.PRNGKey(seed)))
        matched = np.asarray(out[6]) >= 0
        sets = jax_minimal_sets(matched, key)
        init_draws.append({"seed": seed, "shape": list(sets.shape),
                           "sets": b64(sets.astype("<i2")), "n": int(matched.shape[1]),
                           "matched": b64(np.packbits(matched, axis=-1))})
        return out

    jtr.init_attempt_batch = recording_attempt
    n_mp_frame0 = 0
    t0 = time.perf_counter()
    i = 0
    while i < n:
        if mono or (args.mode == "stereo_batch" and slam.state != "NOT_INITIALIZED"):
            j = min(i + BATCH, n)
            frames = lefts[i:j] if mono else list(zip(lefts[i:j], rights[i:j]))
            slam.process_batch(frames, list(range(i, j)))
        else:
            j = i + 1
            slam.process(lefts[i], rights[i] if stereo else depths[i], i)
        if i == 0:
            n_mp_frame0 = int(slam.n_mp)
        for rec in slam.trajectory[i:j]:
            print(f"frame {rec.frame_id:3d} {rec.state:<16} inliers {rec.n_inliers:4d} "
                  f"keyframes {slam.n_kf} map points {slam.n_mp}", file=sys.stderr)
        i = j
    wall = time.perf_counter() - t0

    est = slam.positions()
    gt = np.asarray([t for _, t in poses])
    states = [r.state for r in slam.trajectory]
    out = {
        "source": {
            "rgbd": "JAX RGBDSLAM, localisation mode, CPU",
            "stereo": "JAX StereoSLAM, full SLAM frame by frame, CPU",
            "stereo_batch": f"JAX StereoSLAM, process until initialised, then "
                            f"process_batch in batches of {BATCH}, CPU",
            "mono": f"JAX MonoSLAM, process_batch in batches of {BATCH} from frame 0, "
                    f"loop closing off, CPU",
        }[args.mode],
        "frames": n,
        "width": W, "height": H, "camera": list(CAM_PARAMS),
        "n_features": 1200, "room_seed": 0, "forward": 0.03, "yaw0": 0.45,
        "states": states,
        "n_inliers": [int(r.n_inliers) for r in slam.trajectory],
        "positions": est.astype(float).tolist(),
        "tracked": int(sum(s == "OK" for s in states)),
        "n_mp": int(slam.n_mp),
        "relocalised_frames": relocs,
    }
    if mono:
        kf_frames = sorted(int(f) for f in slam.kf_frame_ids if f >= 0)
        use = ate_frames(states, kf_frames[0], init_frames[0])
        ate, _, (_, _, scale) = ate_rmse(est[use], gt[use], with_scale=True)
        out.update(
            batch=BATCH, max_map_points=8192, init_frame=init_frames[0],
            ate_frames=use, ate_m=float(ate), ate_scale=float(scale), init_draws=init_draws,
            rwc_f32=b64(np.stack([R for R, _ in poses]).astype("<f4")),
        )
    else:
        Rwc0, twc0 = poses[0]
        err = np.linalg.norm(est - (gt - twc0) @ Rwc0, axis=1)
        out.update(bf=BASELINE * cam.fx, th_depth=45.0, rmse_m=float(np.sqrt((err ** 2).mean())),
                   max_err_m=float(err.max()))
        if args.mode == "stereo_batch":
            out.update(batch=BATCH)
    if mono or stereo:
        out.update(
            n_kf=int(slam.n_kf), n_mp_frame0=n_mp_frame0,
            kf_frame_ids=sorted(int(f) for f in slam.kf_frame_ids if f >= 0),
            n_mp_valid=int(np.asarray(slam.m.mp_valid).sum()),
        )
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("states", "n_inliers", "positions", "ate_frames", "init_draws",
                                   "rwc_f32")}))
    print(f"wall {wall:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
