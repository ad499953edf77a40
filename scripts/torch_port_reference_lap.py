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
``--mode mono``: ``bench.py``'s monocular lap: 120 left images
(``BoxRoom.render``), 8192 map points, ``MonoSLAM.process_batch`` in batches
of 16 from frame 0, two-view initialisation included.  This lap and the
stereo batch lap run with loop closing on, as ``bench.py`` runs them, and
end with ``flush()``; they record ``loops_closed`` and their detections.
``--mode mono_loop``: ``bench.py``'s 400-frame pendulum lap
(``bench.py:215-309``), loop closing off and on, written to
``tests/fixtures/mono_loop_lap.json`` (see :func:`main_mono_loop`).
``--mode loop_correction``: one loop correction on a drifted map at the
bench configuration (``scripts/loop_scaffold.py``), written to
``tests/fixtures/loop_correction_full.json`` (see
:func:`main_loop_correction`).

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
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py --mode mono_loop
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py --mode loop_correction
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
    "mono_reloc": ("mono_reloc_lap.json", 120),
    "mono_loop": ("mono_loop_lap.json", 400),
    "loop_correction": ("loop_correction_full.json", 0),
}
# the kidnapped monocular lap: frames 0-35 of the mono lap's trajectory, three
# blank frames, then a revisit of frames 20-59 under frame ids 2000 + index
# with the camera rolled 90 deg about its optical axis (put back on its side
# while the lens was covered): unrolled, the tracker finds the revisit from
# the last pose before the blank frames by projection alone, and nothing
# relocalises
RELOC_MAPPED, RELOC_BLANK_IDS, RELOC_REVISIT, RELOC_REVISIT_ID0 = 36, (1000, 1001, 1002), (20, 60), 2000
RELOC_ROLL = np.pi / 2
PNP_HYP = 128  # ``pnp_ransac``'s default, which ``_try_relocalize`` keeps


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


def jax_draws_1d(valid: np.ndarray, key, size: int, n_hyp: int) -> np.ndarray:
    """(n_hyp, size) minimal sets for one (N,) mask, drawn from ``key`` as
    ``reconstruct_two_views`` (size 8, 256 hypotheses) and ``pnp_ransac``
    (size 6, 128 hypotheses, ``pnp.py:86-88``) draw them."""
    import jax
    import jax.numpy as jnp

    def draw(v, k):
        p = v.astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        return jax.vmap(lambda kk: jax.random.choice(kk, v.shape[0], shape=(size,),
                                                     replace=False, p=p))(
            jax.random.split(k, n_hyp))

    return np.asarray(jax.jit(draw)(jnp.asarray(valid), key))


def reloc_schedule() -> list:
    """[(frame id, index into the mono lap's trajectory, or None for a blank
    frame)] of the kidnapped lap."""
    return ([(i, i) for i in range(RELOC_MAPPED)] + [(f, None) for f in RELOC_BLANK_IDS]
            + [(RELOC_REVISIT_ID0 + i, i) for i in range(*RELOC_REVISIT)])


def reloc_rotations(poses) -> np.ndarray:
    """(n, 3, 3) float32 camera-to-world rotations the kidnapped lap renders,
    in schedule order: the trajectory's, rolled by ``RELOC_ROLL`` on the
    revisit, zeros for a blank frame (JAX ``so3.exp`` in float32)."""
    import jax.numpy as jnp

    from orb_slam3_noted_tpu.geometry import so3

    roll = np.asarray(so3.exp(jnp.asarray([0.0, 0.0, RELOC_ROLL], jnp.float32)))
    out = []
    for fid, k in reloc_schedule():
        if k is None:
            out.append(np.zeros((3, 3), np.float32))
        else:
            R = np.asarray(poses[k][0], np.float32)
            out.append(R @ roll if fid >= RELOC_REVISIT_ID0 else R)
    return np.stack(out).astype(np.float32)


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
    ap.add_argument("--arms", default="loop_off,loop_on,loop_wide",
                    help="--mode mono_loop: the arms to run")
    args = ap.parse_args()
    name, n_default = FIXTURES[args.mode]
    n = args.frames or n_default
    mono = args.mode == "mono"
    stereo = args.mode in ("stereo", "stereo_batch")
    if args.out is None:
        args.out = os.path.join(ROOT, "tests", "fixtures", name)
    if args.mode == "mono_reloc":
        return main_mono_reloc(args.out)
    if args.mode == "mono_loop":
        return main_mono_loop(args.out, n, tuple(args.arms.split(",")))
    if args.mode == "loop_correction":
        return main_loop_correction(args.out)

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
            local_window=5, kf_max_interval=10, enable_loop_closing=True,
        )
        room = BoxRoom(seed=0)
        poses = orbit_trajectory(n, forward=0.03, yaw0=0.45)
        lefts = [room.render(R, t, cam.params, W, H).astype(np.uint8) for R, t in poses]
    else:
        cfg = SlamConfig(
            camera=cam, width=W, height=H, n_features=1200, n_levels=8,
            scale_factor=1.2, bf=BASELINE * cam.fx, th_depth=45.0,
            max_keyframes=64, max_map_points=16384,
            local_window=5, kf_max_interval=10,
            enable_loop_closing=args.mode == "stereo_batch",
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
    detections = record_detections()
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
    if slam.cfg.enable_loop_closing:
        slam.flush()
    wall = time.perf_counter() - t0

    est = slam.positions()
    gt = np.asarray([t for _, t in poses])
    states = [r.state for r in slam.trajectory]
    out = {
        "source": {
            "rgbd": "JAX RGBDSLAM, localisation mode, CPU",
            "stereo": "JAX StereoSLAM, full SLAM frame by frame, CPU",
            "stereo_batch": f"JAX StereoSLAM, process until initialised, then "
                            f"process_batch in batches of {BATCH}, loop closing on, flush() at "
                            f"the end, CPU",
            "mono": f"JAX MonoSLAM, process_batch in batches of {BATCH} from frame 0, "
                    f"loop closing on, flush() at the end, CPU",
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
        "rwc_f32": b64(np.stack([R for R, _ in poses]).astype("<f4")),
    }
    if slam.cfg.enable_loop_closing:
        out.update(loops_closed=int(slam.loop_closer.loops_closed if slam.loop_closer else 0),
                   kf_inserted=int(slam.kf_inserted), **detections)
    if mono:
        kf_frames = sorted(int(f) for f in slam.kf_frame_ids if f >= 0)
        use = ate_frames(states, kf_frames[0], init_frames[0])
        ate, _, (_, _, scale) = ate_rmse(est[use], gt[use], with_scale=True)
        out.update(
            batch=BATCH, max_map_points=8192, init_frame=init_frames[0],
            ate_frames=use, ate_m=float(ate), ate_scale=float(scale), init_draws=init_draws,
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
                                   "rwc_f32", *detections)}))
    print(f"wall {wall:.1f} s", file=sys.stderr)


def _mat(a) -> list:
    return np.asarray(a, np.float64).tolist()


def record_detections() -> dict:
    """Patch the JAX package's loop closer (in this process only) to record
    every finished detection (the keyframe's slot and frame, the winners,
    the consistency counts after it), every Sim(3) RANSAC call (slot,
    candidate, the pair mask, the (128, 3) sets drawn from ``PRNGKey(slot)``
    and the result), every ``sim3_refine`` call and every accepted loop.
    Returns the dict the records go into."""
    import jax

    import orb_slam3_noted_tpu.optim.sim3_opt as jsim3opt
    from orb_slam3_noted_tpu.pipeline import loop_closing as jlc

    rec = {"detections": [], "sim3_ransac": [], "sim3_refine": [], "accepted": []}
    cur = {}
    finish_one, accept = jlc.LoopCloser._finish_one, jlc.LoopCloser._accept
    pairs, ransac, refine = jlc._matched_point_pairs, jlc.sim3_ransac, jsim3opt.sim3_refine

    def rec_finish_one(self, slam, slot, slots_np, covis_np, kf_valid):
        fids = getattr(slam, "kf_frame_ids", None)
        cur["slot"] = int(slot)
        out = finish_one(self, slam, slot, slots_np, covis_np, kf_valid)
        rec["detections"].append({
            "slot": int(slot), "frame_id": int(fids[slot]) if fids is not None else int(slot),
            "winners": [int(s) for s in np.asarray(slots_np) if s >= 0],
            "counts": [int(c) for _, c in self.consistent_groups],
            "pending": self.pending is not None, "closed": bool(out)})
        return out

    def rec_pairs(m, slot_cur, slot_cand):
        cur["pair"] = (int(slot_cur), int(slot_cand))
        return pairs(m, slot_cur, slot_cand)

    def rec_ransac(x1, x2, valid, key, **kw):
        res = ransac(x1, x2, valid, key, **kw)
        v = np.asarray(valid)
        sets = jax_draws_1d(v, key, 3, 128)
        rec["sim3_ransac"].append({
            "slot": cur["pair"][0], "cand": cur["pair"][1], "seed": int(np.asarray(key)[1]),
            "n": int(v.shape[0]), "valid": b64(np.packbits(v)), "n_valid": int(v.sum()),
            "shape": list(sets.shape), "sets": b64(sets.astype("<i2")),
            "success": bool(res.success), "n_inliers": int(res.n_inliers),
            "R": _mat(res.R), "t": _mat(res.t), "s": float(res.s)})
        return res

    def rec_refine(m, slot_cur, slot_cand, R0, t0, s0, cam, cfg, **kw):
        res = refine(m, slot_cur, slot_cand, R0, t0, s0, cam, cfg, **kw)
        fids = np.asarray(m.kf_frame_id)
        rec["sim3_refine"].append({
            "slot": int(slot_cur), "cand": int(slot_cand), "seeded": kw.get("seed_idx") is not None,
            "frames": [int(fids[slot_cur]), int(fids[slot_cand])],
            "n_inliers": int(res.n_inliers), "n_matches": int(res.n_matches),
            "R": _mat(res.R), "t": _mat(res.t), "s": float(res.s)})
        return res

    def rec_accept(self, slam, slot, cand, res, covis=None):
        fids = getattr(slam, "kf_frame_ids", None)
        rec["accepted"].append({
            "slot": int(slot), "cand": int(cand),
            "frames": [int(fids[slot]), int(fids[cand])] if fids is not None else None,
            "s": float(res.s)})
        return accept(self, slam, slot, cand, res, covis)

    jlc.LoopCloser._finish_one, jlc.LoopCloser._accept = rec_finish_one, rec_accept
    jlc._matched_point_pairs, jlc.sim3_ransac, jsim3opt.sim3_refine = (
        rec_pairs, rec_ransac, rec_refine)
    assert jax is not None
    return rec


# the wide arm of the loop lap: the camera swings 1.4 m each way instead of
# 0.7 m (scripts/torch_port_loop_probe.py --amplitude 1.4), and the JAX
# package closes a loop on it through process_batch (at frame 166, back to
# frame 7); on bench.py's lap it finds the start again by projection and
# closes none
WIDE_AMPLITUDE = 1.4


def pendulum_poses(n: int, amplitude: float = 0.7) -> list:
    """``bench.py``'s 400-frame accuracy lap (``pend_pose``,
    ``bench.py:232-250``): two excursions of ``amplitude`` m, each returning
    to the start, the camera looking away and back; (Rwc float32 from JAX
    ``so3.exp``, twc float64)."""
    import jax.numpy as jnp

    from orb_slam3_noted_tpu.geometry import so3

    out = []
    for i in range(n):
        s = i / n
        ph = 2 * np.pi * 2 * s
        twc = np.array([amplitude * np.sin(ph), 0.10 * np.sin(2 * np.pi * 3.1 * s),
                        0.18 * np.sin(ph + 1.2)])
        yaw = 0.45 + 0.70 * np.sin(ph + 0.4)
        pitch = 0.05 * np.sin(2 * np.pi * 1.3 * s)
        out.append((np.asarray(so3.exp(jnp.asarray([pitch, yaw, 0.0]))), twc))
    return out


def main_mono_loop(out_path: str, n: int, arms=("loop_off", "loop_on", "loop_wide")):
    """``bench.py``'s accuracy lap in both arms, and its wide form with loop
    closing on (``loop_wide``: ``WIDE_AMPLITUDE``): ``MonoSLAM.process_batch``
    in batches of 16 with ``bench.py``'s keyframe override (a keyframe at
    least every 8 tracked frames), ``flush()`` at the end; the loop-off arm
    replaces ``_maybe_close_loop`` by ``_register_reloc_kf``
    (``bench.py:254``).  Per arm: states, inliers, positions, the two-view
    draws, every detection, Sim(3) RANSAC and refine call, the loops closed
    (the accepted pairs' slots and frame ids), keyframe insertions,
    ``bench.py``'s ATE (Sim(3)-aligned over the OK frames) and the batch wall
    times; the wide arm also its camera poses.  Arms not asked for keep
    their record in an existing ``out_path``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.pipeline import tracking as jtr
    from orb_slam3_noted_tpu.pipeline.system import MonoSLAM
    from orb_slam3_noted_tpu.utils.evaluation import ate_rmse
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom

    cam = Camera(PINHOLE, CAM_PARAMS)
    cfg = SlamConfig(camera=cam, width=W, height=H, n_features=1200, max_keyframes=64,
                     max_map_points=8192, local_window=5, kf_max_interval=10,
                     enable_loop_closing=True)
    room = BoxRoom(seed=0)
    attempt = jtr.init_attempt_batch
    loop_rec = record_detections()

    def lap(amplitude):
        poses = pendulum_poses(n, amplitude)
        return poses, [room.render(R, t, cam.params, W, H).astype(np.uint8) for R, t in poses]

    def run(loop_on: bool, poses, frames) -> dict:
        gt = np.stack([t for _, t in poses])
        init_draws, init_frames = [], []
        for v in loop_rec.values():
            v.clear()

        def recording_attempt(ref, cand, cam_, key):
            out = attempt(ref, cand, cam_, key)
            matched = np.asarray(out[6]) >= 0
            sets = jax_minimal_sets(matched, key)
            init_draws.append({"seed": int(np.asarray(key)[1]), "shape": list(sets.shape),
                               "sets": b64(sets.astype("<i2")), "n": int(matched.shape[1]),
                               "matched": b64(np.packbits(matched, axis=-1))})
            return out

        jtr.init_attempt_batch = recording_attempt
        s = MonoSLAM(cfg)
        if not loop_on:
            s._maybe_close_loop = lambda slot, feats: s._register_reloc_kf(slot)
        base_need, finish = s._need_new_kf, s._finish_initialize

        def need_kf(n_inl, **kw):
            if base_need(n_inl, **kw):
                return True
            return s.frames_since_kf >= 8 and n_inl > 15 and s._can_insert_kf()

        def finish_initialize(feats, frame_id, *rest):
            finish(feats, frame_id, *rest)
            if s.state == "OK":
                init_frames.append(int(frame_id))

        s._need_new_kf, s._finish_initialize = need_kf, finish_initialize
        walls = []
        t0 = time.perf_counter()
        for i in range(0, len(frames), BATCH):
            j = min(i + BATCH, len(frames))
            tb = time.perf_counter()
            s.process_batch(frames[i:j], list(range(i, j)))
            walls.append(time.perf_counter() - tb)
            print(f"[{'on' if loop_on else 'off'}] frames {i}-{j - 1}: keyframes {s.n_kf}, "
                  f"inserted {s.kf_inserted}, last {s.trajectory[-1].state}", file=sys.stderr)
        s.flush()
        wall = time.perf_counter() - t0
        states = [r.state for r in s.trajectory]
        idx = [k for k, st in enumerate(states) if st == "OK"]
        est = s.positions()
        ate, _, (_, _, scale) = ate_rmse(est[idx], gt[[s.trajectory[k].frame_id for k in idx]],
                                         with_scale=True)
        arm = {
            "states": states, "n_inliers": [int(r.n_inliers) for r in s.trajectory],
            "positions": est.astype(float).tolist(), "tracked": len(idx),
            "init_frame": init_frames[0], "ate_m": float(ate), "ate_scale": float(scale),
            "n_kf": int(s.n_kf), "kf_inserted": int(s.kf_inserted), "n_mp": int(s.n_mp),
            "kf_frame_ids": sorted(int(f) for f in s.kf_frame_ids if f >= 0),
            "loops_closed": int(s.loop_closer.loops_closed) if s.loop_closer else 0,
            "init_draws": init_draws, "batch_wall_s": walls, "wall_s": wall,
        }
        arm.update({k: list(v) for k, v in loop_rec.items()})
        print(json.dumps({k: v for k, v in arm.items() if not isinstance(v, list)}),
              file=sys.stderr)
        return arm

    out = {
        "source": "JAX MonoSLAM, bench.py's 400-frame accuracy lap (bench.py:215-309): "
                  f"process_batch in batches of {BATCH}, bench.py's keyframe override, flush() "
                  "at the end, loop closing off (_register_reloc_kf) and on, and on with "
                  f"{WIDE_AMPLITUDE} m excursions (loop_wide, its own poses), CPU",
        "frames": n, "width": W, "height": H, "camera": list(CAM_PARAMS), "n_features": 1200,
        "room_seed": 0, "max_map_points": 8192, "max_keyframes": 64, "batch": BATCH,
        "rwc_f32": b64(np.stack([R for R, _ in pendulum_poses(n)]).astype("<f4")),
        "twc_f64": b64(np.stack([t for _, t in pendulum_poses(n)]).astype("<f8")),
    }
    if os.path.exists(out_path):
        with open(out_path) as f:
            old = json.load(f)
        out.update({k: v for k, v in old.items() if k.startswith("loop_")})
    poses, frames = lap(0.7)
    for arm in arms:
        if arm == "loop_wide":
            wide, wide_frames = lap(WIDE_AMPLITUDE)
            out[arm] = run(True, wide, wide_frames)
            out[arm].update(amplitude=WIDE_AMPLITUDE, frames=n,
                            rwc_f32=b64(np.stack([R for R, _ in wide]).astype("<f4")),
                            twc_f64=b64(np.stack([t for _, t in wide]).astype("<f8")))
        else:
            out[arm] = run(arm == "loop_on", poses, frames)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({arm: {k: v for k, v in out[arm].items()
                            if not isinstance(v, (list, str))} for arm in arms}))


def main_loop_correction(out_path: str):
    """One loop correction at the bench configuration: the drifted map of
    ``scripts/loop_scaffold.py`` (64 keyframes, 1200 features a keyframe,
    2400 map points, the tail 0.3/-0.1/0.2 m from keyframe 0), the 32k-word
    vocabulary, ``LoopCloser.on_keyframe`` on the tail with camera context
    (RANSAC, ``sim3_refine``, the pose graph, the deferred fuse and the
    time-sliced GBA), then ``finish_gba``.  Records the RANSAC draws, the
    accepted pair, RANSAC's and the refine's (R, t, s), the keyframe poses
    and points after the pose graph and after GBA."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import loop_scaffold as LS

    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.pipeline import map_state as MS
    from orb_slam3_noted_tpu.pipeline.loop_closing import LoopCloser
    from orb_slam3_noted_tpu.place.pretrained import load_default_vocabulary

    full = LS.FULL
    inp = LS.drifted_map_inputs(seed=0, baseline=LS.BASELINE, **full)
    cfg = SlamConfig(camera=Camera(PINHOLE, full["cam"]), width=full["width"],
                     height=full["height"], n_features=full["n_pts"],
                     max_keyframes=full["max_keyframes"], max_map_points=full["max_map_points"])
    m = LS.build_map(MS, MS.empty_map(cfg), inp, jnp.asarray)
    vocab, idf = load_default_vocabulary()
    lc = LoopCloser(vocab, cfg.max_keyframes, min_inliers=20, consistency_th=0, idf=idf)
    tail = inp["n_kf"] - 1
    for k in range(tail):
        _, bow = lc.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
        lc.db.add(k, bow)
    rec = record_detections()
    slam = LS.ScaffoldSlam(m, inp["n_kf"], cfg)
    t0 = time.perf_counter()
    closed = lc.on_keyframe(slam, tail)
    t_correct = time.perf_counter() - t0
    graph = jax.device_get(slam.m)
    lc.finish_gba(slam)
    t_total = time.perf_counter() - t0
    final = jax.device_get(slam.m)
    err, before = LS.corrected_point_errors(final.mp_pos, inp)
    err_graph, _ = LS.corrected_point_errors(graph.mp_pos, inp)
    n2 = 2 * inp["n_pts"]
    f32 = lambda a: b64(np.asarray(a, "<f4"))
    out = {
        "source": "JAX LoopCloser.on_keyframe with camera context, then finish_gba, CPU; "
                  "scripts/loop_scaffold.py FULL, seed 0, baseline "
                  f"{list(LS.BASELINE)} m, 32k-word vocabulary, consistency_th 0, "
                  "min_inliers 20",
        "seed": 0, **{k: v for k, v in full.items() if k != "cam"}, "camera": list(full["cam"]),
        "baseline": list(LS.BASELINE), "closed": bool(closed), "loops_closed": lc.loops_closed,
        "accepted": rec["accepted"], "detections": rec["detections"],
        "sim3_ransac": rec["sim3_ransac"], "sim3_refine": rec["sim3_refine"],
        "kf_Rcw_graph": f32(graph.kf_Rcw), "kf_tcw_graph": f32(graph.kf_tcw),
        "mp_pos_graph": f32(graph.mp_pos[:n2]),
        "kf_Rcw": f32(final.kf_Rcw), "kf_tcw": f32(final.kf_tcw), "mp_pos": f32(final.mp_pos[:n2]),
        "median_err_m": float(np.median(err)), "median_err_graph_m": float(np.median(err_graph)),
        "median_drift_m": float(np.median(before)),
        "wall_correct_s": t_correct, "wall_total_s": t_total,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("kf_Rcw", "kf_tcw", "mp_pos", "kf_Rcw_graph", "kf_tcw_graph",
                                   "mp_pos_graph", "sim3_ransac")}))


def main_mono_reloc(out_path: str):
    """The kidnapped monocular lap (``reloc_schedule``), frame by frame
    through ``MonoSLAM.process`` with loop closing off, recording every
    two-view draw, every relocalisation query and PnP attempt (the frame, the
    candidate slot, the match mask and the minimal sets ``pnp_ransac`` drew),
    and what each relocalisation gave."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import orb_slam3_noted_tpu.optim.pnp as jpnp
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.pipeline import system as jsys
    from orb_slam3_noted_tpu.pipeline import tracking as jtr
    from orb_slam3_noted_tpu.place.database import KeyFrameDatabase
    from orb_slam3_noted_tpu.utils.evaluation import ate_rmse
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory

    cam = Camera(PINHOLE, CAM_PARAMS)
    n_traj = FIXTURES["mono_reloc"][1]
    cfg = SlamConfig(camera=cam, width=W, height=H, n_features=1200, max_keyframes=64,
                     max_map_points=8192, local_window=5, kf_max_interval=10,
                     enable_loop_closing=False)
    room = BoxRoom(seed=0)
    poses = orbit_trajectory(n_traj, forward=0.03, yaw0=0.45)
    sched = reloc_schedule()
    rwc = reloc_rotations(poses)
    blank = np.full((H, W), 128, np.uint8)
    slam = jsys.MonoSLAM(cfg)

    def seed_of(key) -> int:
        seed = int(np.asarray(key)[1])
        assert np.array_equal(np.asarray(key), np.asarray(jax.random.PRNGKey(seed)))
        return seed

    init_draws, queries, pnp_attempts, relocs, init_frames = [], [], [], [], []
    cur = {"frame": None, "slot": None}
    rtv, pnp, matches = jsys.reconstruct_two_views, jpnp.pnp_ransac, jtr.reloc_matches
    detect, reloc, finish = (KeyFrameDatabase.detect_candidates, slam._try_relocalize,
                             slam._finish_initialize)

    def recording_rtv(rays1, rays2, matched, key, **kw):
        m = np.asarray(matched)
        sets = jax_draws_1d(m, key, 8, 256)
        init_draws.append({"seed": seed_of(key), "shape": list(sets.shape),
                           "sets": b64(sets.astype("<i2")), "n": int(m.shape[0]),
                           "matched": b64(np.packbits(m))})
        return rtv(rays1, rays2, matched, key, **kw)

    def recording_detect(db, bow_q, exclude_mask, **kw):
        slots, scores = detect(db, bow_q, exclude_mask, **kw)
        queries.append({"frame_id": cur["frame"], "slots": slots, "scores": scores})
        return slots, scores

    def recording_matches(m, cand, feats, cam_):
        cur["slot"] = int(cand)
        return matches(m, cand, feats, cam_)

    def recording_pnp(Xw, rays, valid, key, **kw):
        res = pnp(Xw, rays, valid, key, **kw)
        v = np.asarray(valid)
        sets = jax_draws_1d(v, key, 6, PNP_HYP)
        pnp_attempts.append({
            "frame_id": seed_of(key), "slot": cur["slot"], "n": int(v.shape[0]),
            "valid": b64(np.packbits(v)), "n_valid": int(v.sum()), "shape": list(sets.shape),
            "sets": b64(sets.astype("<i2")), "success": bool(res.success),
            "n_inliers": int(res.n_inliers),
            # the replayed draws scored as pnp_ransac scores its own: the same
            # best count shows they are the draws it made
            "replayed_inliers": int(score_sets(Xw, rays, valid, jax.numpy.asarray(sets)))})
        return res

    @jax.jit
    def score_sets(Xw, rays, valid, sets):
        jnp = jax.numpy
        hp = jax.lax.Precision.HIGHEST
        R, t = jpnp._dlt_p6p(Xw[sets], rays[sets])
        xc = jnp.einsum("hij,nj->hni", R, Xw, precision=hp) + t[:, None, :]
        nrm = jnp.linalg.norm(xc, axis=-1) * jnp.linalg.norm(rays, axis=-1)[None, :]
        cosa = jnp.einsum("hni,ni->hn", xc, rays, precision=hp) / jnp.maximum(nrm, 1e-12)
        return jnp.max(jnp.sum((cosa > 0.99996) & (xc[..., 2] > 0) & valid[None, :], axis=-1))

    def recording_reloc(feats, frame_id):
        cur["frame"] = int(frame_id)
        out = reloc(feats, frame_id)
        if out is not None:
            relocs.append({"frame_id": int(frame_id), "slot": int(slam.last_kf_slot),
                           "retrack_inliers": int(out[2]),
                           "pnp_inliers": pnp_attempts[-1]["n_inliers"]})
        return out

    def finish_initialize(feats, frame_id, *rest):
        finish(feats, frame_id, *rest)
        if slam.state == "OK":
            init_frames.append(int(frame_id))

    jsys.reconstruct_two_views, jpnp.pnp_ransac, jtr.reloc_matches = (
        recording_rtv, recording_pnp, recording_matches)
    KeyFrameDatabase.detect_candidates = recording_detect
    slam._try_relocalize, slam._finish_initialize = recording_reloc, finish_initialize
    t0 = time.perf_counter()
    for j, (fid, k) in enumerate(sched):
        rec = slam.process(blank if k is None else
                           room.render(rwc[j], poses[k][1], cam.params, W, H).astype(np.uint8),
                           fid)
        print(f"frame {fid:4d} {rec.state:<16} inliers {rec.n_inliers:4d} keyframes "
              f"{slam.n_kf} map points {slam.n_mp}", file=sys.stderr)
    wall = time.perf_counter() - t0

    ids = [f for f, _ in sched]
    est = slam.positions()
    states = [r.state for r in slam.trajectory]
    kf_frames = sorted(int(f) for f in slam.kf_frame_ids if f >= 0)
    init_at = ids.index(init_frames[0])
    # keyframe 0's frame and every non-blank frame from the initialisation on
    use = [ids.index(kf_frames[0])] + [i for i in range(init_at, len(sched))
                                       if sched[i][1] is not None]
    gt = np.asarray([poses[k][1] if k is not None else np.zeros(3) for _, k in sched])
    ate, _, (_, _, scale) = ate_rmse(est[use], gt[use], with_scale=True)
    db = slam.reloc_db
    out = {
        "source": "JAX MonoSLAM, process frame by frame, loop closing off, CPU; frames 0-35 "
                  "of orbit_trajectory(120, forward=0.03, yaw0=0.45), 3 blank frames, then "
                  "frames 20-59 again rolled 90 deg about the optical axis (ids 2000 + index; "
                  "unrolled, or from frames 0-5, the tracker finds the revisit by projection "
                  "and nothing relocalises)",
        "frames": len(sched), "trajectory_frames": n_traj, "width": W, "height": H,
        "camera": list(CAM_PARAMS),
        "n_features": 1200, "room_seed": 0, "forward": 0.03, "yaw0": 0.45,
        "max_map_points": 8192, "max_keyframes": 64,
        "frame_ids": ids, "pose_index": [k for _, k in sched],
        "states": states, "n_inliers": [int(r.n_inliers) for r in slam.trajectory],
        "positions": est.astype(float).tolist(),
        "tracked": int(sum(s == "OK" for s in states)),
        "init_frame": init_frames[0], "ate_frames": use, "ate_m": float(ate),
        "ate_scale": float(scale),
        "n_kf": int(slam.n_kf), "kf_inserted": int(slam.kf_inserted), "n_mp": int(slam.n_mp),
        "kf_frame_ids": kf_frames,
        "reloc_db_rows": [int(s) for s in np.flatnonzero(db.present)] if db is not None else None,
        "relocalised_frames": [r["frame_id"] for r in relocs], "relocalisations": relocs,
        "reloc_queries": queries, "pnp_attempts": pnp_attempts, "init_draws": init_draws,
        "final_poses_f32": b64(np.stack([np.concatenate([np.asarray(R).reshape(-1), np.asarray(t)])
                                         for R, t in slam.final_poses()]).astype("<f4")),
        "rwc_f32": b64(rwc.astype("<f4")), "roll_rad": float(RELOC_ROLL),
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("states", "n_inliers", "positions", "ate_frames", "init_draws",
                                   "rwc_f32", "pnp_attempts", "final_poses_f32", "frame_ids",
                                   "pose_index")}))
    print(f"wall {wall:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
