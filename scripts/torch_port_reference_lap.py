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
``--mode stereo_inertial``: ``bench.py``'s 240-frame stereo-inertial lap
(``bench.py:146-212``), written to ``tests/fixtures/stereo_inertial_lap.json``
(see :func:`main_stereo_inertial`); it also writes
``tests/fixtures/loop_4dof_full.json``, which ``--mode loop_4dof`` writes
alone: the 4-DoF pose graph of a loop on the drifted 64-keyframe map (see
:func:`main_loop_4dof`).
``--mode cli_euroc|cli_tum_rgbd|cli_tumvi``: the JAX package's CLI on the
dataset layouts of ``chip_smoke.py``'s phase 14, written by
``scripts/cli_layouts.py`` (see :func:`main_cli`).
``--mode node_stereo_inertial|node_rgbd``: the JAX package's live node
(``node.SlamNode``) in this process, frames and IMU samples through its
grab callbacks, then ``stop(drain=True)``: the inputs of ``chip_smoke.py``'s
phases 15a and 15b (see :func:`main_node`).
``--mode fisheye_stereo``: the TUM-VI 512x512 fisheye lap (``TUM_512.yaml``'s
two Kannala-Brandt cameras, a right camera rotated against the left, 1500
features) through ``FisheyeStereoSLAM.process``, written to
``tests/fixtures/fisheye_stereo_lap.json``; ``--mode fisheye_inertial``: the
same 100 pairs with 200 Hz IMU through ``FisheyeStereoInertialSLAM.process``,
written to ``tests/fixtures/fisheye_inertial_lap.json`` (see
:func:`main_fisheye`).

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
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py --mode stereo_inertial
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py --mode fisheye_stereo
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py --mode fisheye_inertial
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py --mode node_stereo_inertial
    JAX_PLATFORMS=cpu python scripts/torch_port_reference_lap.py --mode node_rgbd
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
    "stereo_inertial": ("stereo_inertial_lap.json", 240),
    "loop_4dof": ("loop_4dof_full.json", 0),
    "fisheye_stereo": ("fisheye_stereo_lap.json", 100),
    "fisheye_inertial": ("fisheye_inertial_lap.json", 100),
    "atlas": ("atlas_lap.json", 0),
    "stereo_atlas": ("stereo_atlas_lap.json", 0),
    "inertial_atlas": ("inertial_atlas_lap.json", 0),
    "cli_euroc": ("cli_euroc.json", 0),
    "cli_tum_rgbd": ("cli_tum_rgbd.json", 0),
    "cli_tumvi": ("cli_tumvi.json", 0),
    "node_stereo_inertial": ("node_stereo_inertial.json", 80),
    "node_rgbd": ("node_rgbd.json", 48),
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
    if args.mode == "stereo_inertial":
        main_stereo_inertial(args.out, n)
        return main_loop_4dof(os.path.join(os.path.dirname(args.out), FIXTURES["loop_4dof"][0]))
    if args.mode == "loop_4dof":
        return main_loop_4dof(args.out)
    if args.mode in ("fisheye_stereo", "fisheye_inertial"):
        return main_fisheye(args.out, n, inertial=args.mode == "fisheye_inertial")
    if args.mode in ("atlas", "stereo_atlas", "inertial_atlas"):
        return main_atlas(args.out, args.mode)
    if args.mode.startswith("cli_"):
        return main_cli(args.out, args.mode)
    if args.mode.startswith("node_"):
        return main_node(args.out, args.mode, n)

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
# frames each arm runs, the first of bench.py's 400 (chip_smoke.py's phase
# 10a keeps its run time down): the bench arms one excursion each way and
# back to the start; the wide arm all 400 (cut to 224, the port's map, after
# its earlier loop at frame 133, inserted 57 keyframes to JAX's 52)
LOOP_ARM_FRAMES = {"loop_off": 200, "loop_on": 200, "loop_wide": 400}


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
    closing on (``loop_wide``: ``WIDE_AMPLITUDE``), each arm on the first
    ``LOOP_ARM_FRAMES`` of its poses: ``MonoSLAM.process_batch``
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

    def lap(amplitude, k):
        poses = pendulum_poses(n, amplitude)[:k]
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
        "source": "JAX MonoSLAM, bench.py's 400-frame accuracy lap (bench.py:215-309), each "
                  "arm its first `frames`: process_batch in batches of "
                  f"{BATCH}, bench.py's keyframe override, flush() at the end, loop closing off "
                  "(_register_reloc_kf) and on, and on with "
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
    for arm in arms:
        k = LOOP_ARM_FRAMES[arm]
        if arm == "loop_wide":
            wide, wide_frames = lap(WIDE_AMPLITUDE, k)
            out[arm] = run(True, wide, wide_frames)
            out[arm].update(amplitude=WIDE_AMPLITUDE,
                            rwc_f32=b64(np.stack([R for R, _ in wide]).astype("<f4")),
                            twc_f64=b64(np.stack([t for _, t in wide]).astype("<f8")))
        else:
            out[arm] = run(arm == "loop_on", *lap(0.7, k))
        out[arm]["frames"] = k
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



# bench.py's stereo-inertial configuration (``cfg_vi``, bench.py:151-165)
VI_FPS, VI_IMU_HZ = 20.0, 200.0
VI_CFG = dict(width=W, height=H, n_features=1200, fps=VI_FPS, th_depth=45.0,
              max_keyframes=64, max_map_points=16384, local_window=5, kf_max_interval=10,
              min_tracked_points=15, imu_init_time=0.9, imu_viba1_time=2.5, imu_viba2_time=1e9,
              imu_init_min_kfs=3, inertial_window=8, imu_noise_gyro=1.7e-4, imu_noise_acc=2e-3,
              imu_walk_gyro=1.9e-5, imu_walk_acc=3e-3, imu_freq=VI_IMU_HZ,
              enable_loop_closing=True)


def stereo_inertial_inputs(n: int):
    """(camera rotations (n, 3, 3) float32, centres (n, 3), frame times, the
    IMU chunk of each batch of 16 as ``bench.py:190-196`` cuts them: (acc,
    gyr, ts) of ``synth_imu`` over (last frame before, last frame of the
    batch]) of ``bench.py``'s stereo-inertial lap, JAX package."""
    from orb_slam3_noted_tpu.utils.synthetic import smooth_pose, synth_imu

    times = [k / VI_FPS for k in range(n)]
    poses = [smooth_pose(t) for t in times]
    chunks, t_prev = [], -1.0 / VI_FPS
    for s0 in range(0, n, BATCH):
        s1 = min(s0 + BATCH, n)
        chunks.append(synth_imu(t_prev, times[s1 - 1], hz=VI_IMU_HZ))
        t_prev = times[s1 - 1]
    return (np.stack([R for R, _ in poses]).astype(np.float32),
            np.stack([t for _, t in poses]), times, chunks)


def main_stereo_inertial(out_path: str, n: int):
    """``bench.py``'s stereo-inertial lap, one pass (``StereoInertialSLAM.
    process_batch`` in batches of 16 from frame 0, loop closing on, each
    batch with its IMU chunk), with ``flush()`` at the end.  Records per
    frame the state, inliers, ``positions()`` and ``imu_stage``; the stage
    after each batch and the frame where each stage began; every
    ``inertial_init`` solve (stage, scale, gravity in the visual world,
    biases); tracked frames, keyframe insertions and count, loops and every
    detection and Sim(3) draw; the final biases; ATE over ``positions()``
    after SE(3) and Sim(3) alignment; the camera poses the frames were
    rendered from and the IMU samples (float64, base64), so that the port
    runs on the same input."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.pipeline import inertial_system as jis
    from orb_slam3_noted_tpu.utils.evaluation import ate_rmse
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, stereo_pair

    rwc, twc, times, chunks = stereo_inertial_inputs(n)
    room = BoxRoom(seed=0)
    pairs = [stereo_pair(room, R, t, CAM_PARAMS, W, H, BASELINE)[:2] for R, t in zip(rwc, twc)]
    pairs = [(a.astype(np.uint8), b.astype(np.uint8)) for a, b in pairs]
    cam = Camera(PINHOLE, CAM_PARAMS)
    cfg = SlamConfig(camera=cam, bf=BASELINE * cam.fx, **VI_CFG)
    slam = jis.StereoInertialSLAM(cfg)
    inits, solve = [], jis.inertial_init

    def recording_init(*args, **kw):
        res = solve(*args, **kw)
        inits.append({"stage": int(slam.imu_stage), "scale": float(res.scale),
                      "g_world": _mat(res.g_world), "gdir": _mat(res.gdir), "bg": _mat(res.bg),
                      "ba": _mat(res.ba), "n_kf": int(len(slam.kf_order))})
        return res

    jis.inertial_init = recording_init
    detections = record_detections()
    stage_after_batch, stage_frame = [], {}
    t0 = time.perf_counter()
    for ci, s0 in enumerate(range(0, n, BATCH)):
        s1 = min(s0 + BATCH, n)
        a, g, ts = chunks[ci]
        slam.process_batch(pairs[s0:s1], list(range(s0, s1)), ts=times[s0:s1], acc=a, gyr=g,
                           imu_t=ts)
        stage_after_batch.append(int(slam.imu_stage))
        stage_frame.setdefault(str(slam.imu_stage), s1 - 1)
        print(f"batch {ci:2d} frames {s0}-{s1 - 1} imu_stage {slam.imu_stage} keyframes "
              f"{slam.n_kf} tracked {sum(r.state == 'OK' for r in slam.trajectory)} "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    slam.flush()
    wall = time.perf_counter() - t0
    jis.inertial_init = solve

    est = slam.positions()
    states = [r.state for r in slam.trajectory]
    ok = np.asarray([s == "OK" for s in states])
    ate_se3, _, _ = ate_rmse(est[ok], twc[ok], with_scale=False)
    ate_sim3, _, (_, _, scale) = ate_rmse(est[ok], twc[ok], with_scale=True)
    b64f = lambda x: b64(np.asarray(x, "<f8"))
    out = {
        "source": f"JAX StereoInertialSLAM.process_batch in batches of {BATCH} from frame 0 "
                  "(bench.py:146-212, one pass), loop closing on, flush() at the end, CPU",
        "frames": n, "width": W, "height": H, "camera": list(CAM_PARAMS), "batch": BATCH,
        "config": VI_CFG, "bf": BASELINE * cam.fx,
        "states": states,
        "n_inliers": [int(r.n_inliers) for r in slam.trajectory],
        "positions": est.astype(float).tolist(),
        "tracked": int(ok.sum()),
        "imu_stage": int(slam.imu_stage),
        "stage_after_batch": stage_after_batch,
        # the last frame of the batch after which each stage was first seen
        "stage_frame": stage_frame,
        "inertial_init": inits,
        "bias_bg": _mat(slam.bias.bg), "bias_ba": _mat(slam.bias.ba),
        "n_kf": int(slam.n_kf), "kf_inserted": int(slam.kf_inserted),
        "kf_frame_ids": sorted(int(f) for f in slam.kf_frame_ids if f >= 0),
        "n_mp": int(slam.n_mp),
        "loops_closed": int(slam.loop_closer.loops_closed if slam.loop_closer else 0),
        "ate_se3_m": float(ate_se3), "ate_sim3_m": float(ate_sim3), "ate_sim3_scale": float(scale),
        "span_m": float(np.linalg.norm(twc.max(0) - twc.min(0))),
        "wall_s": wall,
        "rwc_f32": b64(rwc.astype("<f4")), "twc_f64": b64f(twc),
        "imu": [{"acc": b64f(a), "gyr": b64f(g), "ts": b64f(ts), "n": int(len(ts))}
                for a, g, ts in chunks],
        **detections,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("states", "n_inliers", "positions", "rwc_f32", "twc_f64", "imu",
                                   *detections)}))


def main_loop_4dof(out_path: str):
    """The 4-DoF pose graph of a loop correction at the bench configuration:
    the drifted 64-keyframe map of ``scripts/loop_scaffold.py`` (FULL, seed
    0, the tail 0.3 / -0.1 / 0.2 m from keyframe 0) with the essential graph
    an inertial map has (``loop_scaffold.inertial_loop_graph``: the temporal
    chain and the loop edge), through ``optimize_pose_graph_4dof`` with
    keyframe 0 fixed.  Records the corrected poses and the final cost."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import loop_scaffold as LS

    from orb_slam3_noted_tpu.optim.pose_graph import SE3Edges, optimize_pose_graph_4dof

    inp = LS.drifted_map_inputs(seed=0, baseline=LS.BASELINE, **LS.FULL)
    gr = LS.inertial_loop_graph(inp)
    E = len(gr["i"])
    edges = SE3Edges(i=jnp.asarray(gr["i"]), j=jnp.asarray(gr["j"]), R=jnp.asarray(gr["eR"]),
                     t=jnp.asarray(gr["et"]), weight=jnp.asarray(gr["weight"]),
                     valid=jnp.ones(E, bool))
    t0 = time.perf_counter()
    R, t, cost = jax.device_get(optimize_pose_graph_4dof(
        jnp.asarray(gr["R"]), jnp.asarray(gr["t"]), edges, jnp.asarray(gr["fixed"])))
    wall = time.perf_counter() - t0
    f32 = lambda a: b64(np.asarray(a, "<f4"))
    out = {
        "source": "JAX optimize_pose_graph_4dof (n_iters 12, lam 1e-6), CPU; scripts/loop_scaffold.py "
                  f"FULL, seed 0, baseline {list(LS.BASELINE)} m, inertial_loop_graph edges",
        "n_kf": int(inp["n_kf"]), "n_edges": E, "cost": float(cost),
        "kf_Rcw": f32(R), "kf_tcw": f32(t), "wall_s": wall,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k not in ("kf_Rcw", "kf_tcw")}))



# ---------------------------------------------------------------------------
# the TUM-VI fisheye lap (TUM_512.yaml: Camera1, Camera2, 512x512)

FE_W = FE_H = 512
FE_CAM1 = (190.97847715128717, 190.9733070521226, 254.93170605935475, 256.8974428996504,
           0.0034823894022493434, 0.0007150348452162257, -0.0020532361418706202,
           0.00020293673591811182)
FE_CAM2 = (190.44236969414825, 190.4344384721956, 252.59949716835982, 254.91723064636983,
           0.0034003170790442797, 0.001766278153469831, -0.00266312569781606,
           0.0003299517423931039)
FE_BASELINE = 0.101
# the right camera's rotation in the left frame, exp((0.003, -0.005, 0.002)):
# of TUM-VI's order, and not the identity, so a swapped Rlr / Rrl shows
FE_RLR_AXIS = (0.003, -0.005, 0.002)
FE_FPS = 20.0
FE_IMU_HZ = 200.0
FE_ROOM = dict(seed=5, depth=2.5, h=0.9, w=1.4)
FE_CFG = dict(width=FE_W, height=FE_H, fps=FE_FPS, n_features=1500, n_levels=8,
              scale_factor=1.2, ini_th_fast=20.0, min_th_fast=7.0, th_depth=40.0,
              lapping_l=(0.0, float(FE_W)), lapping_r=(0.0, float(FE_W)),
              max_keyframes=64, max_map_points=16384, local_window=5, kf_max_interval=4,
              min_tracked_points=12)
# tests/test_fisheye_inertial.py:72-85
FE_IMU_CFG = dict(imu_init_time=0.8, imu_viba1_time=2.0, imu_viba2_time=1e9,
                  imu_init_min_kfs=4, inertial_window=6, imu_noise_gyro=1e-4,
                  imu_noise_acc=1e-3, imu_walk_gyro=1e-6, imu_walk_acc=1e-5,
                  imu_freq=FE_IMU_HZ)


def fisheye_rlr() -> np.ndarray:
    """Rlr = exp(FE_RLR_AXIS) (Rodrigues in float64), as float32."""
    w = np.asarray(FE_RLR_AXIS, np.float64)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def fisheye_pose(t: float):
    """``cam_pose`` of tests/test_fisheye_inertial.py:33-43 (the JAX
    package's so3.exp): a hand-held motion."""
    import jax.numpy as jnp

    from orb_slam3_noted_tpu.geometry import so3

    twc = np.array([0.20 * np.sin(3.8 * t), 0.12 * np.cos(4.6 * t) - 0.12,
                    0.15 * np.sin(1.9 * t) + 0.06 * t])
    Rwc = np.asarray(so3.exp(jnp.asarray([0.05 * np.sin(1.1 * t), 0.07 * np.sin(0.7 * t),
                                          0.04 * np.cos(1.3 * t)])))
    return Rwc, twc


def fisheye_imu(t0: float, t1: float):
    """``imu_between`` of tests/test_fisheye_inertial.py:46-62: exact
    body-frame samples over (t0, t1] (the body is the left camera)."""
    import jax.numpy as jnp

    from orb_slam3_noted_tpu.geometry import so3
    from orb_slam3_noted_tpu.imu.preintegration import GRAVITY

    g = np.array([0.0, 0.0, -GRAVITY])
    eps = 1e-4
    ts = np.arange(np.ceil(t0 * FE_IMU_HZ), np.floor(t1 * FE_IMU_HZ) + 1) / FE_IMU_HZ
    ts = ts[(ts > t0 + 1e-12) & (ts <= t1 + 1e-12)]
    acc, gyr = [], []
    for t in ts:
        Rwb, p = fisheye_pose(t)
        Rwb_p, pp = fisheye_pose(t + eps)
        _, pm = fisheye_pose(t - eps)
        acc.append(Rwb.T @ ((pp - 2 * p + pm) / (eps * eps) - g))
        gyr.append(np.asarray(so3.log(jnp.asarray(Rwb.T @ Rwb_p))) / eps)
    return np.asarray(acc).reshape(-1, 3), np.asarray(gyr).reshape(-1, 3), ts


def fisheye_pair(room, cam1, cam2, Rlr, Rwc, twc, with_depth: bool = False):
    """A left/right fisheye pair: the right camera at Rwc Rlr, twc + Rwc tlr
    (float64 arithmetic on the float32 rotations, as the port renders)."""
    Rwc = np.asarray(Rwc, np.float64)
    left = room.render_fisheye(Rwc, twc, cam1, FE_W, FE_H, return_depth=with_depth)
    right = room.render_fisheye(Rwc @ Rlr.astype(np.float64),
                                twc + Rwc @ np.array([FE_BASELINE, 0.0, 0.0]), cam2, FE_W, FE_H)
    return left, right


def main_fisheye(out_path: str, n: int, inertial: bool):
    """The TUM-VI 512x512 fisheye lap in the JAX package on the CPU:
    ``FisheyeStereoSLAM.process`` frame by frame (loop closing off), or with
    ``inertial`` ``FisheyeStereoInertialSLAM.process`` with each frame's
    200 Hz IMU samples.  Records per frame the state, inliers and
    ``positions()``; keyframe count and insertions, the initial map's size;
    frame 0's fisheye stereo matches (``idx_r``, the count, the median
    relative depth error against the rendered depth); ATE with the first
    pose's offset removed and after SE(3) alignment; the camera poses
    (rotations float32) and, inertial, the IMU samples (float64, base64),
    the frame each stage was reached at and every ``inertial_init`` solve."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, KANNALA_BRANDT8
    from orb_slam3_noted_tpu.ops import orb as O
    from orb_slam3_noted_tpu.ops.fisheye_stereo import match_fisheye_stereo
    from orb_slam3_noted_tpu.pipeline import inertial_system as jis
    from orb_slam3_noted_tpu.pipeline.system import FisheyeStereoSLAM
    from orb_slam3_noted_tpu.utils.evaluation import ate_rmse
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom

    cam1, cam2 = Camera(KANNALA_BRANDT8, FE_CAM1), Camera(KANNALA_BRANDT8, FE_CAM2)
    Rlr = fisheye_rlr()
    cfg_kw = dict(FE_CFG, bf=FE_BASELINE * FE_CAM1[0], tlr_t=(FE_BASELINE, 0.0, 0.0),
                  tlr_r=tuple(float(x) for x in Rlr.reshape(-1)),
                  **(FE_IMU_CFG if inertial else {}))
    cfg = SlamConfig(camera=cam1, camera2=cam2, **cfg_kw)
    times = [k / FE_FPS for k in range(n)]
    poses = [fisheye_pose(t) for t in times]
    rwc = np.stack([R for R, _ in poses]).astype(np.float32)
    twc = np.stack([t for _, t in poses])
    room = BoxRoom(**FE_ROOM)
    t0 = time.perf_counter()
    pairs, depth0 = [], None
    for k in range(n):
        left, right = fisheye_pair(room, cam1, cam2, Rlr, rwc[k], twc[k], with_depth=k == 0)
        if k == 0:
            left, depth0 = left
        pairs.append((left.astype(np.uint8), right.astype(np.uint8)))
    print(f"rendered {n} pairs in {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    # frame 0's fisheye stereo, as the facade runs it
    kw = dict(n_features=cfg.n_features, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
              th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast)
    fl = O.extract_orb(jnp.asarray(pairs[0][0], jnp.float32), **kw)
    fr = O.extract_orb(jnp.asarray(pairs[0][1], jnp.float32), **kw)
    sm = match_fisheye_stereo(fl, fr, cam1, cam2, jnp.asarray(Rlr),
                              jnp.asarray(cfg.tlr_t, jnp.float32), lap_l=cfg.lapping_l,
                              lap_r=cfg.lapping_r,
                              level_sigma2=jnp.asarray(cfg.level_sigma2, jnp.float32))
    valid = np.asarray(sm.valid)
    rel = fisheye_depth_error(np.asarray(fl.xy)[valid], np.asarray(sm.depth)[valid], depth0)

    chunks, stage_frame, inits = [], {}, []
    if inertial:
        slam = jis.FisheyeStereoInertialSLAM(cfg)
        solve = jis.inertial_init

        def recording_init(*args, **kw):
            res = solve(*args, **kw)
            inits.append({"stage": int(slam.imu_stage), "scale": float(res.scale),
                          "g_world": _mat(res.g_world), "n_kf": int(len(slam.kf_order))})
            return res

        jis.inertial_init = recording_init
        t_prev = -1.0 / FE_FPS
        for t in times:
            chunks.append(fisheye_imu(t_prev, t))
            t_prev = t
    else:
        slam = FisheyeStereoSLAM(cfg)
    n_mp_init = None
    t0 = time.perf_counter()
    for k, (left, right) in enumerate(pairs):
        if inertial:
            a, g, ts = chunks[k]
            slam.process(left, right, k, t=times[k], acc=a, gyr=g, imu_t=ts)
            stage_frame.setdefault(str(slam.imu_stage), k)
        else:
            slam.process(left, right, k)
        if n_mp_init is None and slam.state == "OK":
            n_mp_init = int(slam.n_mp)
        if k % 10 == 9:
            print(f"frame {k} state {slam.state} keyframes {slam.n_kf} map points {slam.n_mp} "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    wall = time.perf_counter() - t0
    if inertial:
        jis.inertial_init = solve

    est = slam.positions()
    states = [r.state for r in slam.trajectory]
    ok = np.asarray([s == "OK" for s in states])
    err0 = np.linalg.norm((est - est[0]) - (twc - twc[0]), axis=1)
    ate_se3 = ate_rmse(est[ok], twc[ok], with_scale=False)[0]
    b64f = lambda x: b64(np.asarray(x, "<f8"))
    out = {
        "source": ("JAX FisheyeStereoInertialSLAM.process with 200 Hz IMU" if inertial else
                   "JAX FisheyeStereoSLAM.process") + ", frame by frame, loop closing off, CPU",
        "frames": n, "width": FE_W, "height": FE_H, "camera1": list(FE_CAM1),
        "camera2": list(FE_CAM2), "rlr_axis": list(FE_RLR_AXIS), "room": FE_ROOM,
        "config": {k: list(v) if isinstance(v, tuple) else v for k, v in cfg_kw.items()},
        "states": states,
        "n_inliers": [int(r.n_inliers) for r in slam.trajectory],
        "positions": est.astype(float).tolist(),
        "tracked": int(ok.sum()),
        "n_kf": int(slam.n_kf), "kf_inserted": int(slam.kf_inserted),
        "n_mp": int(slam.n_mp), "n_mp_init": n_mp_init,
        "frame0_matches": int(valid.sum()),
        "frame0_idx_r": np.asarray(sm.idx_r).astype(int).tolist(),
        "frame0_depth_rel_median": float(np.median(rel)),
        "ate_origin_rmse_m": float(np.sqrt(np.mean(err0[ok] ** 2))),
        "ate_origin_max_m": float(err0[ok].max()),
        "ate_se3_m": float(ate_se3),
        "span_m": float(np.ptp(twc, axis=0).max()),
        "wall_s": wall,
        "rwc_f32": b64(rwc.astype("<f4")), "twc_f64": b64f(twc),
    }
    if inertial:
        out.update({
            "imu_stage": int(slam.imu_stage), "stage_frame": stage_frame,
            "inertial_init": inits,
            "imu": [{"acc": b64f(a), "gyr": b64f(g), "ts": b64f(ts), "n": int(len(ts))}
                    for a, g, ts in chunks],
        })
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("states", "n_inliers", "positions", "rwc_f32", "twc_f64", "imu",
                                   "frame0_idx_r")}))


def fisheye_depth_error(xy: np.ndarray, depth: np.ndarray, depth_map: np.ndarray) -> np.ndarray:
    """Relative error of triangulated depths against the rendered depth map
    at each keypoint's nearest pixel."""
    H, W = depth_map.shape
    gt = depth_map[np.clip(np.round(xy[:, 1]).astype(int), 0, H - 1),
                   np.clip(np.round(xy[:, 0]).astype(int), 0, W - 1)]
    return np.abs(depth - gt) / gt


# ---------------------------------------------------------------------------
# phase 13: the Atlas.  The kidnapped layout of tests/test_atlas.py at full
# width: an orbit, AtlasSLAM.LOST_PATIENCE + 3 featureless frames (the map
# switch), then a revisit that starts a new map and merges it back.
ATLAS_TRAJ = 120                 # bench.py's monocular orbit, poses 0-119
ATLAS_A = (0, 48)                # map A: poses [0, 48)
ATLAS_BLANK = 11                 # AtlasSLAM.LOST_PATIENCE + 3
ATLAS_REVISIT = (16, 72)         # the revisit: poses [16, 72), ids continue
ATLAS_CKPT_FRAMES = 16           # frames run on after the merge's checkpoint
# the stereo multi-session: two sequences of bench.py's stereo configuration
# over the same orbit, on_sequence_end() between them
SA_SEQ1, SA_SEQ2 = (0, 100), (40, 90)
# tests/test_inertial_atlas.py's lap at full width
IA_FPS, IA_IMU_HZ = 10.0, 200.0
IA_CFG = dict(width=W, height=H, fps=IA_FPS, n_features=1200, max_keyframes=64,
              max_map_points=8192, local_window=5, kf_max_interval=3, min_tracked_points=12,
              imu_init_time=1.2, imu_viba1_time=1e9, imu_viba2_time=1e9, imu_init_min_kfs=5,
              inertial_window=6, imu_noise_gyro=1e-4, imu_noise_acc=1e-3, imu_walk_gyro=1e-6,
              imu_walk_acc=1e-5, imu_freq=IA_IMU_HZ, vocab_words=256)
IA_MAP_A, IA_BLIND_MAX, IA_MAP_B, IA_AFTER = 30, 60, 60, 10
# the turn: while the lens is covered the camera pitches IA_TURN_DEG (down,
# toward the floor near it; y points down) over t in IA_TURN_OUT, where map B
# starts and initialises its IMU on views map A never had, then pitches back
# (t in IA_TURN_BACK) and merges with both maps metric;
# tests/test_inertial_atlas.py's own trajectory merges at map B's first
# keyframes, before its IMU init
IA_TURN_DEG, IA_TURN_OUT, IA_TURN_BACK = -60.0, (3.0, 3.9), (6.5, 8.5)


def _smoothstep(u: float) -> float:
    u = min(max(u, 0.0), 1.0)
    return u * u * u * (10.0 - 15.0 * u + 6.0 * u * u)


def ia_turn(t: float) -> float:
    """The pitch offset (rad) at time t: 0, out to IA_TURN_DEG, back to 0."""
    out = _smoothstep((t - IA_TURN_OUT[0]) / (IA_TURN_OUT[1] - IA_TURN_OUT[0]))
    back = _smoothstep((t - IA_TURN_BACK[0]) / (IA_TURN_BACK[1] - IA_TURN_BACK[0]))
    return np.deg2rad(IA_TURN_DEG) * (out - back)


def ia_pose(t: float):
    """``cam_pose`` of tests/test_inertial_atlas.py (a laterally excited
    trajectory that revisits early viewpoints, period ~6.6 s) with the
    pitch offset of ``ia_turn``."""
    import jax.numpy as jnp

    from orb_slam3_noted_tpu.geometry import so3

    twc = np.array([0.25 * np.sin(0.95 * t) + 0.2 * np.sin(3.8 * t),
                    0.15 * np.cos(4.6 * t) - 0.15, 0.18 * np.sin(1.9 * t)])
    Rwc = np.asarray(so3.exp(jnp.asarray([0.06 * np.sin(1.1 * t) + ia_turn(t),
                                          0.08 * np.sin(0.7 * t),
                                          0.04 * np.cos(1.3 * t)])))
    return Rwc, twc


def ia_imu(t0: float, t1: float):
    """``imu_between`` of tests/test_inertial_atlas.py: exact body-frame
    samples over (t0, t1]."""
    import jax.numpy as jnp

    from orb_slam3_noted_tpu.geometry import so3
    from orb_slam3_noted_tpu.imu.preintegration import GRAVITY

    g = np.array([0.0, 0.0, -GRAVITY])
    eps = 1e-4
    ts = np.arange(np.ceil(t0 * IA_IMU_HZ), np.floor(t1 * IA_IMU_HZ) + 1) / IA_IMU_HZ
    ts = ts[(ts > t0 + 1e-12) & (ts <= t1 + 1e-12)]
    acc, gyr = [], []
    for t in ts:
        Rwb, p = ia_pose(t)
        Rwb_p, pp = ia_pose(t + eps)
        _, pm = ia_pose(t - eps)
        acc.append(Rwb.T @ ((pp - 2 * p + pm) / (eps * eps) - g))
        gyr.append(np.asarray(so3.log(jnp.asarray(Rwb.T @ Rwb_p))) / eps)
    return np.asarray(acc).reshape(-1, 3), np.asarray(gyr).reshape(-1, 3), ts


def record_atlas(atlas_mod, records: dict, cur: dict):
    """Patch the JAX package's Atlas (in this process only) to record every
    merge attempt (frame, slot, candidate, the pair mask, the (128, 3) sets
    drawn from ``PRNGKey(slot)``, the result) and every merge (frame, slot,
    candidate, the world transform S_wold_wnew, the slot offset)."""
    pairs, ransac, merge = atlas_mod._cross_map_pairs, atlas_mod.sim3_ransac, \
        atlas_mod.merge_map_arrays

    def rec_pairs(m_new, slot_new, m_old, slot_old):
        cur["pair"] = (int(slot_new), int(slot_old))
        return pairs(m_new, slot_new, m_old, slot_old)

    def rec_ransac(x1, x2, valid, key, **kw):
        res = ransac(x1, x2, valid, key, **kw)
        v = np.asarray(valid)
        sets = jax_draws_1d(v, key, 3, 128)
        records["merge_attempts"].append({
            "frame_id": cur["frame"], "slot": cur["pair"][0], "cand": cur["pair"][1],
            "seed": int(np.asarray(key)[1]), "n": int(v.shape[0]), "valid": b64(np.packbits(v)),
            "n_valid": int(v.sum()), "shape": list(sets.shape), "sets": b64(sets.astype("<i2")),
            "fix_scale": bool(kw.get("fix_scale", False)), "success": bool(res.success),
            "n_inliers": int(res.n_inliers), "s": float(res.s)})
        return res

    def rec_merge(old, new_m, n_kf_new, n_mp_new, S):
        out = merge(old, new_m, n_kf_new, n_mp_new, S)
        if out is not None:
            records["merges"].append({
                "frame_id": cur["frame"], "slot": cur["pair"][0], "cand": cur["pair"][1],
                "cand_frame": int(np.asarray(old.m.kf_frame_id)[cur["pair"][1]]),
                "kf_off": int(out[1]), "n_kf": int(out[2]), "n_mp": int(out[3]),
                "R": _mat(S[0]), "t": _mat(S[1]), "s": float(S[2])})
        return out

    atlas_mod._cross_map_pairs, atlas_mod.sim3_ransac, atlas_mod.merge_map_arrays = (
        rec_pairs, rec_ransac, rec_merge)


def checkpoint_schema(slam) -> dict:
    """{key: [dtype, shape]} of the JAX package's ``save_map`` of ``slam``."""
    import tempfile

    from orb_slam3_noted_tpu.io.checkpoint import save_map

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.npz")
        save_map(path, slam)
        z = np.load(path)
        return {k: [str(z[k].dtype), list(z[k].shape)] for k in z.files}


def main_atlas(out_path: str, mode: str):
    """Phase 13's reference laps, frame by frame, recording the two-view
    draws (``init_draws``, by frame id), every merge attempt and merge
    (:func:`record_atlas`) and per frame the state, inliers, the Atlas's map
    and merge counts (and the ``imu_stage`` on the inertial lap).

    ``atlas``: ``AtlasSLAM(MonoSLAM)`` at ``bench.py``'s monocular
    configuration (loop closing on): poses ``ATLAS_A`` of the 120-frame
    orbit, ``ATLAS_BLANK`` featureless frames, the revisit ``ATLAS_REVISIT``;
    right after the merge the active system's checkpoint schema
    (``checkpoint_schema``), and at the end a query at frame 2's viewpoint
    against the merged database.  ``stereo_atlas``: ``AtlasSLAM(StereoSLAM,
    fix_scale=True)`` at ``bench.py``'s stereo configuration, two sequences
    (``SA_SEQ1``, ``SA_SEQ2``) with ``on_sequence_end()`` between them.
    ``inertial_atlas``: ``InertialAtlasSLAM(MonoInertialSLAM)`` on
    tests/test_inertial_atlas.py's trajectory and settings at 752x480 and
    1200 features with the pitch of ``ia_turn`` (map B starts looking at
    the floor, IMU-initialises, pitches back up and merges with both maps
    metric), with its 200 Hz IMU samples (stored); ``merge_unprojected``
    keeps each merge's world transform before the JAX package's 4-DoF
    projection."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.ops import orb as jorb
    from orb_slam3_noted_tpu.pipeline import atlas as jatlas
    from orb_slam3_noted_tpu.pipeline import system as jsys
    from orb_slam3_noted_tpu.pipeline.inertial_atlas import InertialAtlasSLAM
    from orb_slam3_noted_tpu.utils.evaluation import ate_rmse
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair

    cam = Camera(PINHOLE, CAM_PARAMS)
    records = {"merge_attempts": [], "merges": [], "merge_unprojected": []}
    cur = {"frame": None}
    record_atlas(jatlas, records, cur)
    init_draws = []
    rtv = jsys.reconstruct_two_views

    def recording_rtv(rays1, rays2, matched, key, **kw):
        m = np.asarray(matched)
        sets = jax_draws_1d(m, key, 8, 256)
        init_draws.append({"seed": int(np.asarray(key)[1]), "shape": list(sets.shape),
                           "sets": b64(sets.astype("<i2")), "n": int(m.shape[0]),
                           "matched": b64(np.packbits(m))})
        return rtv(rays1, rays2, matched, key, **kw)

    jsys.reconstruct_two_views = recording_rtv
    per = {"frame_ids": [], "pose_index": [], "states": [], "n_inliers": [], "maps": [],
           "merges": [], "n_kf": [], "imu_stage": []}
    extra = {}

    def watch_merges(atlas):
        """Record each merge's world transform from the RANSAC result as
        it arrives (before the inertial Atlas replaces its rotation)."""
        from orb_slam3_noted_tpu.geometry import sim3 as jsim3

        do = atlas._do_merge

        def rec_do(st, si, slot, cand, res):
            m, one = atlas.active.m, jnp.asarray(1.0, jnp.float32)
            S = jsim3.compose(jsim3.inverse((st.m.kf_Rcw[cand], st.m.kf_tcw[cand], one)),
                              jsim3.compose(jsim3.inverse((res.R, res.t, res.s)),
                                            (m.kf_Rcw[slot], m.kf_tcw[slot], one)))
            records["merge_unprojected"].append({"frame_id": cur["frame"], "R": _mat(S[0]),
                                                 "t": _mat(S[1]), "s": float(S[2])})
            return do(st, si, slot, cand, res)

        atlas._do_merge = rec_do

    def step(atlas, fid, k, *args, **kw):
        cur["frame"] = int(fid)
        rec = atlas.process(*args, **kw)
        per["frame_ids"].append(int(fid))
        per["pose_index"].append(k)
        per["states"].append(rec.state if rec is not None else "NONE")
        per["n_inliers"].append(int(rec.n_inliers) if rec is not None else 0)
        per["maps"].append(int(atlas.maps_created))
        per["merges"].append(int(atlas.merges))
        per["n_kf"].append(int(atlas.active.n_kf))
        per["imu_stage"].append(int(getattr(atlas.active, "imu_stage", 0)))
        print(f"frame {fid:4d} pose {k} {per['states'][-1]:<16} inliers {per['n_inliers'][-1]:4d} "
              f"keyframes {atlas.active.n_kf} maps {atlas.maps_created} merges {atlas.merges} "
              f"stage {per['imu_stage'][-1]}", file=sys.stderr)
        return rec

    t0 = time.perf_counter()
    if mode == "atlas":
        cfg = SlamConfig(camera=cam, width=W, height=H, n_features=1200, max_keyframes=64,
                         max_map_points=8192, local_window=5, kf_max_interval=10,
                         enable_loop_closing=True)
        room = BoxRoom(seed=0)
        poses = orbit_trajectory(ATLAS_TRAJ, forward=0.03, yaw0=0.45)
        sched = ([(i, i) for i in range(*ATLAS_A)]
                 + [(ATLAS_A[1] + j, None) for j in range(ATLAS_BLANK)])
        fid0 = sched[-1][0] + 1
        sched += [(fid0 + j, k) for j, k in enumerate(range(*ATLAS_REVISIT))]
        blank = np.zeros((H, W), np.uint8)
        atlas = jatlas.AtlasSLAM(cfg, jsys.MonoSLAM)
        watch_merges(atlas)
        n_kf_a = None
        ckpt_at = None
        for fid, k in sched:
            img = blank if k is None else room.render(*poses[k], cam.params, W, H).astype(np.uint8)
            merged_before = atlas.merges
            step(atlas, fid, k, img, fid)
            if atlas.stored and n_kf_a is None:
                n_kf_a = int(atlas.stored[0].n_kf)
                extra["n_db_a"] = int(atlas.stored[0].db.present.sum())
            if atlas.merges > merged_before:
                ckpt_at = int(fid)
                extra["checkpoint_schema"] = checkpoint_schema(atlas.active)
        extra["n_kf_a"] = n_kf_a
        extra["checkpoint_after_frame"] = ckpt_at
        atlas.flush()
        lc = atlas.active.loop_closer
        q = jorb.extract_orb(jnp.asarray(room.render(*poses[2], cam.params, W, H).astype(
            np.float32)), n_features=1200)
        _, bow = lc.db.compute_bow(q.desc, q.valid)
        slots, _ = lc.db.detect_candidates(bow, np.zeros(cfg.max_keyframes, bool), n_best=3,
                                           min_rel_score=0.5)
        extra["query_pose"] = 2
        extra["query_slots"] = [int(s) for s in slots]
        extra["db_rows"] = [int(s) for s in np.flatnonzero(lc.db.present)]
        extra["loops_closed"] = int(lc.loops_closed)
        rwc = np.stack([np.asarray(R, np.float32) for R, _ in poses])
        extra["rwc_f32"] = b64(rwc.astype("<f4"))
        twc = np.asarray([poses[k][1] if k is not None else np.full(3, np.nan) for _, k in sched])
        source = (f"JAX AtlasSLAM(MonoSLAM).process frame by frame, bench.py's monocular "
                  f"configuration, loop closing on, CPU; BoxRoom(seed=0), poses {ATLAS_A} of "
                  f"orbit_trajectory({ATLAS_TRAJ}, forward=0.03, yaw0=0.45), {ATLAS_BLANK} blank "
                  f"frames, then poses {ATLAS_REVISIT}")
        cfg_rec = {"local_window": 5, "kf_max_interval": 10, "max_map_points": 8192}
    elif mode == "stereo_atlas":
        cfg = SlamConfig(camera=cam, width=W, height=H, n_features=1200, n_levels=8,
                         scale_factor=1.2, bf=BASELINE * cam.fx, th_depth=45.0,
                         max_keyframes=64, max_map_points=16384, local_window=5,
                         kf_max_interval=10, enable_loop_closing=False)
        room = BoxRoom(seed=0)
        poses = orbit_trajectory(ATLAS_TRAJ, forward=0.03, yaw0=0.45)
        atlas = jatlas.AtlasSLAM(cfg, jsys.StereoSLAM, fix_scale=True)
        watch_merges(atlas)
        sched = []
        fid = 0
        for si, seq in enumerate((SA_SEQ1, SA_SEQ2)):
            for k in range(*seq):
                left, right, _ = stereo_pair(room, *poses[k], cam.params, W, H, BASELINE)
                sched.append((fid, k))
                step(atlas, fid, k, left.astype(np.uint8), right.astype(np.uint8), fid)
                fid += 1
            if si == 0:
                extra["seq1_n_kf"] = int(atlas.active.n_kf)
                atlas.on_sequence_end()
                extra["stored_after_seq1"] = len(atlas.stored)
        atlas.flush()
        rwc = np.stack([np.asarray(R, np.float32) for R, _ in poses])
        extra["rwc_f32"] = b64(rwc.astype("<f4"))
        twc = np.asarray([poses[k][1] for _, k in sched])
        source = (f"JAX AtlasSLAM(StereoSLAM, fix_scale=True).process frame by frame, bench.py's "
                  f"stereo configuration, loop closing off, CPU; BoxRoom(seed=0), "
                  f"orbit_trajectory({ATLAS_TRAJ}, forward=0.03, yaw0=0.45), sequence 1 poses "
                  f"{SA_SEQ1}, on_sequence_end(), sequence 2 poses {SA_SEQ2}")
        cfg_rec = {"local_window": 5, "kf_max_interval": 10, "max_map_points": 16384,
                   "th_depth": 45.0, "bf": BASELINE * cam.fx}
    else:
        cfg = SlamConfig(camera=cam, **IA_CFG)
        room = BoxRoom(seed=3)
        atlas = InertialAtlasSLAM(cfg)
        watch_merges(atlas)
        sched, rwcs, twcs, imu = [], [], [], []
        fid, t_prev = 0, 0.0

        def feed(blind):
            nonlocal fid, t_prev
            t = (fid + 1) / IA_FPS
            Rwc, twc_ = ia_pose(t)
            img = (np.zeros((H, W), np.uint8) if blind
                   else room.render(Rwc, twc_, cam.params, W, H).astype(np.uint8))
            acc, gyr, ts = ia_imu(t_prev, t)
            rwcs.append(np.asarray(Rwc, np.float32))
            twcs.append(twc_)
            imu.append((acc, gyr, ts))
            sched.append((fid, None if blind else fid))
            step(atlas, fid, None if blind else fid, img, fid, t=t, acc=acc, gyr=gyr, imu_t=ts)
            t_prev = t
            fid += 1

        for _ in range(IA_MAP_A):
            feed(False)
        extra["stage_a"] = int(atlas.active.imu_stage)
        while atlas.maps_created == 1 and fid < IA_BLIND_MAX:
            feed(True)
        extra["stored_stage"] = (int(atlas.stored[0].inertial["imu_stage"])
                                 if atlas.stored and atlas.stored[0].inertial else None)
        for _ in range(IA_MAP_B):
            feed(False)
            if atlas.merges:
                break
        a = atlas.active
        extra["merge_chain"] = {
            "seg_ok_false": int(a.seg_ok.count(False)), "n_seg_preints": len(a.seg_preints),
            "n_kf_order": len(a.kf_order), "kf_order": [int(s) for s in a.kf_order],
            "seg_ok": [bool(x) for x in a.seg_ok], "cur_vel": _mat(a.cur_vel),
            "imu_stage": int(a.imu_stage)}
        extra["merge_frame_index"] = len(sched) - 1
        for _ in range(IA_AFTER):
            feed(False)
        extra["rwc_f32"] = b64(np.stack(rwcs).astype("<f4"))
        extra["twc_f64"] = b64(np.asarray(twcs, "<f8"))
        b64f = lambda x: b64(np.asarray(x, "<f8"))  # noqa: E731
        extra["imu"] = [{"acc": b64f(a_), "gyr": b64f(g), "ts": b64f(ts), "n": int(len(ts))}
                        for a_, g, ts in imu]
        extra["times"] = [(f + 1) / IA_FPS for f, _ in sched]
        twc = np.asarray(twcs)
        source = ("JAX InertialAtlasSLAM(MonoInertialSLAM).process frame by frame, "
                  "tests/test_inertial_atlas.py's trajectory and settings at 752x480 and 1200 "
                  f"features, 200 Hz IMU, CPU; BoxRoom(seed=3), {IA_MAP_A} frames, blind until "
                  f"the map switch (pitching {IA_TURN_DEG} deg over t in {IA_TURN_OUT} s), map "
                  f"B on the floor, pitching back over t in {IA_TURN_BACK} s, until the merge "
                  "and 10 frames more")
        cfg_rec = {k: v for k, v in IA_CFG.items()}
    wall = time.perf_counter() - t0

    est = atlas.positions()
    states = per["states"]
    ok = np.asarray([s == "OK" for s in states])
    shown = np.asarray([k is not None for _, k in sched])
    use = ok & shown
    ate_sim3, _, (_, _, scale) = ate_rmse(est[use], twc[use], with_scale=True)
    ate_se3, _, _ = ate_rmse(est[use], twc[use], with_scale=False)
    a = atlas.active
    out = {
        "source": source, "mode": mode, "frames": len(sched), "width": W, "height": H,
        "camera": list(CAM_PARAMS), "n_features": 1200, "config": cfg_rec,
        **per, "positions": est.astype(float).tolist(),
        "tracked": int(ok.sum()), "ate_frames": [int(i) for i in np.flatnonzero(use)],
        "ate_sim3_m": float(ate_sim3), "ate_scale": float(scale), "ate_se3_m": float(ate_se3),
        "maps_created": int(atlas.maps_created), "n_maps": int(atlas.n_maps),
        "merges_total": int(atlas.merges), "n_kf": int(a.n_kf), "n_mp": int(a.n_mp),
        "kf_frame_ids": sorted(int(f) for f in np.asarray(a.m.kf_frame_id)[
            np.asarray(a.m.kf_valid)]),
        "init_draws": init_draws, **records, **extra,
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("states", "n_inliers", "positions", "ate_frames", "init_draws",
                                   "rwc_f32", "twc_f64", "imu", "frame_ids", "pose_index", "maps",
                                   "merges", "n_kf", "imu_stage", "merge_attempts", "times",
                                   "checkpoint_schema", "kf_frame_ids")}))
    print(f"wall {wall:.1f} s", file=sys.stderr)


# ---------------------------------------------------------------------------
# the CLI on dataset layouts (chip_smoke.py phase 14)

def _jax_render(name: str, case: dict) -> list:
    """The frames of layout ``name``, rendered by the JAX package from the
    stored poses: rectified stereo pairs, (image, depth) or fisheye pairs."""
    from orb_slam3_noted_tpu.models.cameras import Camera, KANNALA_BRANDT8
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, stereo_pair

    rwc, twc = case["poses"]
    if case["kind"] == "fisheye":
        room = BoxRoom(**case["room"])
        cam1, cam2 = Camera(KANNALA_BRANDT8, case["camera1"]), Camera(KANNALA_BRANDT8, case["camera2"])
        return [tuple(x.astype(np.uint8) for x in fisheye_pair(room, cam1, cam2, case["rlr"], R, t))
                for R, t in zip(rwc, twc)]
    room = BoxRoom(seed=0)
    W_, H_ = case["width"], case["height"]
    if case["kind"] == "stereo":
        return [tuple(x.astype(np.uint8) for x in stereo_pair(room, R, t, case["camera"], W_, H_,
                                                              case["baseline"])[:2])
                for R, t in zip(rwc, twc)]
    out = []
    for R, t in zip(rwc, twc):
        img, depth = room.render(R, t, case["camera"], W_, H_, return_depth=True)
        out.append((img.astype(np.uint8), depth.astype(np.float32)))
    return out


def main_cli(out_path: str, name: str):
    """The JAX package's CLI on one of phase 14's layouts, in a temporary
    directory: the same files ``chip_smoke.py`` writes for the port (the
    renders are the JAX package's, from the same stored poses).  Records the
    parsed settings, the result line, the trajectory's rows, the metric
    lines' events and the final ``imu_stage``, the checkpoint's keys and
    dtypes, and whether the frames came through the native decoder."""
    import contextlib
    import io
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import cli_layouts as L

    from orb_slam3_noted_tpu import cli
    from orb_slam3_noted_tpu.io import datasets as D
    from orb_slam3_noted_tpu.io.yaml_compat import load_settings, load_stereo_rectification
    from orb_slam3_noted_tpu_torch.io.images import write_png

    fix = lambda n: json.load(open(os.path.join(ROOT, "tests", "fixtures", n)))
    si_ref, fe_ref = fix(L.SI_FIXTURE), fix(L.FE_FIXTURE)
    case = L.cases(si_ref, fe_ref)[name]
    t0 = time.time()
    frames = _jax_render(name, case)
    print(f"[{name}] rendered {len(frames)} frames in {time.time() - t0:.1f} s", flush=True)
    native = []
    read = D.Sequence.read

    def watched_read(self, i):
        out = read(self, i)
        native.append(getattr(self, "_lloader", None) is not None)
        return out

    D.Sequence.read = watched_read
    with tempfile.TemporaryDirectory() as root:
        argv = L.write_case(name, case, frames, root, si_ref, fe_ref, write_png)
        settings = argv[argv.index("--settings") + 1]
        cfg, imu = load_settings(settings)
        rect = load_stereo_rectification(settings)
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        wall = time.time() - t0
        result = json.loads(buf.getvalue().strip().splitlines()[-1])
        rec = L.cli_outputs(root, result)
    D.Sequence.read = read
    rec.update(L.settings_record(cfg, imu))
    rec.update({"mode": name, "frames": case["n"], "argv_tail": [a for a in argv if "/" not in a],
                "rectification": rect is not None, "native_decoder": bool(native) and all(native),
                "wall_s": wall, "source": "scripts/torch_port_reference_lap.py --mode " + name})
    print(f"[{name}] {json.dumps(result)}; {rec['traj_rows']} trajectory rows, "
          f"{len(rec['metric_events'])} metric lines, imu_stage {rec['imu_stage']}, native "
          f"decoder {rec['native_decoder']}, {wall:.1f} s", flush=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1, default=float)


def node_imu_blocks(times, acc, gyr, ts) -> list:
    """The IMU samples of each frame's IMUS block: those after the previous
    frame's block up to and including the frame's time (frame times are
    sample times of the 200 Hz grid), as (acc, gyr, ts) per frame."""
    out, start = [], 0
    for t in times:
        stop = int(np.searchsorted(ts, t + 1e-9, side="right"))
        out.append((acc[start:stop], gyr[start:stop], ts[start:stop]))
        start = stop
    return out


def main_node(out_path: str, mode: str, n: int):
    """The JAX package's ``SlamNode`` in this process on the frames of
    ``chip_smoke.py``'s phase 15: ``node_stereo_inertial`` the first ``n``
    pairs of ``bench.py``'s stereo-inertial lap with their 200 Hz IMU
    samples (both read from ``tests/fixtures/stereo_inertial_lap.json``),
    ``cfg_vi``; ``node_rgbd`` the 48 left images and depth maps of the
    stereo bench lap, its configuration (the mapper on, loop closing off),
    ``keep_frame_overlay`` on.  Every frame and sample goes through
    ``grab_image`` / ``grab_imu`` (images as the node's TCP decoder makes
    them), then ``start()`` and ``stop(drain=True)``: the JAX server cannot
    carry IMU samples over TCP (ROADMAP Queue 3).  Records each published
    record's state and ``twc``, the keyframes, ``imu_stage``, the ATE of
    the published centres, and per frame the overlay's matched count."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.node import SlamNode
    from orb_slam3_noted_tpu.utils.evaluation import ate_rmse
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, stereo_pair

    cam = Camera(PINHOLE, CAM_PARAMS)
    b64f = lambda x: b64(np.asarray(x, "<f8"))
    out = {"frames": n, "width": W, "height": H, "camera": list(CAM_PARAMS)}
    if mode == "node_stereo_inertial":
        si = json.load(open(os.path.join(ROOT, "tests", "fixtures", FIXTURES["stereo_inertial"][0])))
        N = si["frames"]
        dec = lambda k, shape: np.frombuffer(base64.b64decode(si[k]), "<f8" if k != "rwc_f32"
                                             else "<f4").reshape(shape)
        rwc, twc = dec("rwc_f32", (N, 3, 3))[:n], dec("twc_f64", (N, 3))[:n]
        cat = lambda k: np.concatenate([np.frombuffer(base64.b64decode(c[k]), "<f8").reshape(
            (c["n"], 3) if k != "ts" else (c["n"],)) for c in si["imu"]])
        acc, gyr, ts = cat("acc"), cat("gyr"), cat("ts")
        times = [k / si["config"]["fps"] for k in range(n)]
        blocks = node_imu_blocks(times, acc, gyr, ts)
        room = BoxRoom(seed=0)
        frames = [tuple(x.astype(np.uint8) for x in stereo_pair(room, R, t, CAM_PARAMS, W, H,
                                                                 BASELINE)[:2])
                  for R, t in zip(rwc, twc)]
        cfg = SlamConfig(camera=cam, bf=si["bf"], **si["config"])
        node = SlamNode(cfg, "stereo-inertial")
        out.update(config=si["config"], bf=si["bf"], source_fixture=FIXTURES["stereo_inertial"][0],
                   imu_per_frame=[int(len(b[2])) for b in blocks])
        gt = np.asarray(twc, np.float64)
    else:
        poses, lefts, _, depths = lap_inputs(n)
        frames = list(zip(lefts, depths))
        times = [k / 20.0 for k in range(n)]
        blocks = None
        cfg = SlamConfig(
            camera=cam, width=W, height=H, n_features=1200, n_levels=8,
            scale_factor=1.2, bf=BASELINE * cam.fx, th_depth=45.0,
            max_keyframes=64, max_map_points=16384,
            local_window=5, kf_max_interval=10, enable_loop_closing=False,
        )
        node = SlamNode(cfg, "rgbd")
        node.slam.keep_frame_overlay = True
        out.update(bf=BASELINE * cam.fx, rwc_f32=b64(np.stack([R for R, _ in poses]).astype("<f4")))
        gt = np.asarray([t for _, t in poses], np.float64)
    published, matched = [], []

    def on_pose(msg):
        published.append(msg)
        ov = node.slam.last_overlay
        matched.append(None if ov is None or ov["frame_id"] != msg.get("frame_id")
                       else int((np.asarray(ov["valid"]) & np.asarray(ov["matched"])).sum()))

    node.subscribe(on_pose)
    for k, (img, img2) in enumerate(frames):
        if blocks is not None:
            for a, g, tt in zip(*blocks[k]):
                node.grab_imu(tt, a, g)
        # as the TCP decoder hands them over: float32 gray, f32 depth
        node.grab_image(img.astype(np.float32), times[k], img2=img2.astype(np.float32))
    t0 = time.perf_counter()
    node.start()
    node.stop(drain=True)
    wall = time.perf_counter() - t0
    slam = node.slam
    states = [m["state"] for m in published]
    twc_pub = np.asarray([m.get("twc", [np.nan] * 3) for m in published], np.float64)
    ok = np.asarray([s_ == "OK" for s_ in states])
    out.update(
        source=f"JAX SlamNode({'stereo-inertial' if blocks else 'rgbd'}) in process, grab "
               "callbacks, start() and stop(drain=True), CPU; "
               "scripts/torch_port_reference_lap.py --mode " + mode,
        n_published=len(published), states=states, tracked=int(ok.sum()),
        twc=twc_pub.tolist(), n_inliers=[int(m.get("n_inliers", 0)) for m in published],
        n_kf=int(slam.n_kf), kf_inserted=int(slam.kf_inserted), n_mp=int(slam.n_mp),
        kf_frame_ids=sorted(int(f) for f in slam.kf_frame_ids if f >= 0),
        overlay_matched=matched, wall_s=wall)
    if blocks is not None:
        ate, _, _ = ate_rmse(twc_pub[ok], gt[ok], with_scale=False)
        out.update(imu_stage=int(slam.imu_stage), ate_se3_m=float(ate))
    else:
        # metric RMSE of the published centres in the first camera's frame
        Rwc0, twc0 = poses[0]
        err = np.linalg.norm(twc_pub - (gt - twc0) @ Rwc0, axis=1)
        out.update(rmse_m=float(np.sqrt(np.nanmean(err ** 2))))
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("states", "twc", "n_inliers", "overlay_matched", "rwc_f32",
                                   "imu_per_frame", "config")}))


if __name__ == "__main__":
    main()
