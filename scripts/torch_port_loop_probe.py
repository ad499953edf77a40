"""Look for a layout of the monocular loop lap on which a loop closes, in
either package.

    JAX_PLATFORMS=cpu python scripts/torch_port_loop_probe.py --package jax \\
        [--frames 400] [--excursions 2] [--amplitude 0.7] [--yaw-amp 0.7] [--depth-amp 0.18]
    python3 scripts/torch_port_loop_probe.py --package port [the same layout]

The lap is ``bench.py``'s 400-frame accuracy lap (``bench.py:215-309``)
with its shape as arguments: ``--excursions`` swings of the camera centre
along x of ``--amplitude`` m (and ``--depth-amp`` m along z), the view
yawing ``--yaw-amp`` rad away from the start region and back, over
``--frames`` frames; ``bench.py``'s values are the defaults.  Both packages
run ``MonoSLAM.process_batch`` in batches of 16 at ``bench.py``'s
monocular configuration (752x480, 1200 features, 64 keyframes, 8192 map
points) with its keyframe override (a keyframe at least every 8 tracked
frames) and loop closing on, then ``flush()``.

``--package jax`` runs the JAX package on the CPU (about 5 minutes for 400
frames) and records, through the JAX loop closer, every finished detection
(its winners and consistency counts), every Sim(3) RANSAC and refine call
and every accepted loop.  ``--package port`` runs the port on ``--device``
(the card unless another is named) on its own RANSAC draws, with the same
counts.  Prints one JSON object last: tracked frames, Sim(3) ATE, keyframe
insertions, detections with winners, ladder calls, loops closed.

Replaying the ladder of the port's lap in the JAX package:

    python3 scripts/torch_port_loop_probe.py --package port --arm loop_wide --dump DIR
    JAX_PLATFORMS=cpu python scripts/torch_port_loop_probe.py --package jax \
        --arm loop_wide --replay DIR

``--arm`` drives ``chip_smoke.py``'s arm of the 400-frame lap instead (its
frames, the JAX run's draws, ``tests/fixtures/mono_loop_lap.json``);
``--dump`` saves the map and the ladder's inputs and outputs wherever a
Sim(3) refinement kept 20 inliers or a RANSAC 15 (``DIR/call<k>.npz``,
``DIR/calls.json``).  ``--replay`` runs the JAX package's pairs, RANSAC (on
its own draws) and ``sim3_refine`` (from the port's guess) on each saved
state, and prints them beside the port's, with the loop's distance from the
true relative pose and, where RANSAC seeded the step, how many of its
matched pairs see the same surface point of the room.

``--seed-offset N`` draws the two-view RANSAC sets from seed frame id + N
(the JAX package's key, or the port's generator), so the same lap can be
run on other draws in either package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def layout(args):
    """[(yaw, pitch, twc)] of the lap, ``bench.py``'s ``pend_pose`` with its
    shape as arguments."""
    n = args.frames
    out = []
    for i in range(n):
        s = i / n
        ph = 2 * np.pi * args.excursions * s
        twc = np.array([args.amplitude * np.sin(ph), 0.10 * np.sin(2 * np.pi * 3.1 * s),
                        args.depth_amp * np.sin(ph + 1.2)])
        yaw = 0.45 + args.yaw_amp * np.sin(ph + 0.4)
        pitch = 0.05 * np.sin(2 * np.pi * 1.3 * s)
        out.append((yaw, pitch, twc))
    return out


def probe_jax(args) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import torch_port_reference_lap as ref_lap

    from orb_slam3_noted_tpu.geometry import so3
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.pipeline import tracking as jtr
    from orb_slam3_noted_tpu.pipeline.system import MonoSLAM
    from orb_slam3_noted_tpu.utils.evaluation import ate_rmse
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom

    cam = Camera(PINHOLE, ref_lap.CAM_PARAMS)
    cfg = SlamConfig(camera=cam, width=ref_lap.W, height=ref_lap.H, n_features=1200,
                     max_keyframes=64, max_map_points=8192, local_window=5, kf_max_interval=10,
                     enable_loop_closing=True)
    room = BoxRoom(seed=0)
    poses = [(np.asarray(so3.exp(jnp.asarray([p, y, 0.0]))), t) for y, p, t in layout(args)]
    frames = [room.render(R, t, cam.params, ref_lap.W, ref_lap.H).astype(np.uint8)
              for R, t in poses]
    rec = ref_lap.record_detections()
    if args.seed_offset:
        attempt = jtr.init_attempt_batch

        def shifted(ref, cand, cam_, key):
            return attempt(ref, cand, cam_,
                           jax.random.PRNGKey(int(np.asarray(key)[1]) + args.seed_offset))

        jtr.init_attempt_batch = shifted
    s = MonoSLAM(cfg)
    _keyframe_override(s)
    for i in range(0, len(frames), ref_lap.BATCH):
        j = min(i + ref_lap.BATCH, len(frames))
        s.process_batch(frames[i:j], list(range(i, j)))
        print(f"frames {i}-{j - 1}: keyframes {s.n_kf}, inserted {s.kf_inserted}, "
              f"loops {s.loop_closer.loops_closed if s.loop_closer else 0}", file=sys.stderr)
    s.flush()
    idx = [k for k, r in enumerate(s.trajectory) if r.state == "OK"]
    gt = np.stack([t for _, t in poses])
    ate = ate_rmse(s.positions()[idx], gt[[s.trajectory[k].frame_id for k in idx]],
                   with_scale=True)[0]
    out = _summary(s, len(frames), idx, ate, rec["detections"], len(rec["sim3_ransac"]),
                   len(rec["sim3_refine"]), rec["accepted"])
    out["strong_refines"] = strong_refines(rec["sim3_refine"], rec["sim3_ransac"], poses)
    return out


def strong_refines(refines: list, ransacs: list, poses) -> list:
    """The Sim(3) refinements that kept the acceptance gate's 20 inliers:
    frames, inliers, the inliers of the RANSAC that seeded it (None on the
    temporal path), scale and the distance of each from the true relative
    pose (``chip_smoke.loop_truth``)."""
    import chip_smoke as cs

    rwc = np.stack([R for R, _ in poses])
    twc = np.stack([t for _, t in poses])
    ransac = iter(ransacs)  # a seeded refinement follows its RANSAC call
    out = []
    for r in refines:
        n_ransac = next(ransac)["n_inliers"] if r["seeded"] else None
        if r["n_inliers"] >= 20:
            out.append({"frames": r["frames"], "n_inliers": r["n_inliers"],
                        "ransac_inliers": n_ransac, "s": r["s"],
                        **cs.loop_truth((rwc, twc), *r["frames"], np.asarray(r["R"]),
                                        np.asarray(r["t"]))})
    return out


def _keyframe_override(s):
    base_need = s._need_new_kf

    def need_kf(n_inl, **kw):
        if base_need(n_inl, **kw):
            return True
        return s.frames_since_kf >= 8 and n_inl > 15 and s._can_insert_kf()

    s._need_new_kf = need_kf


def _summary(s, n, idx, ate, detections, n_ransac, n_refine, accepted) -> dict:
    return {
        "frames": n, "tracked": len(idx), "ate_m": float(ate), "kf_inserted": int(s.kf_inserted),
        "loops_closed": int(s.loop_closer.loops_closed) if s.loop_closer else 0,
        "accepted": accepted, "ransac_calls": n_ransac, "refine_calls": n_refine,
        "detections_with_winners": [d for d in detections if d["winners"]],
        "n_detections": len(detections),
    }


def dump_port(args) -> dict:
    """The port on ``chip_smoke.py``'s arm ``args.arm``, saving the map and
    the ladder's inputs and outputs at each strong ladder step."""
    import torch

    import chip_smoke as cs
    from orb_slam3_noted_tpu_torch.pipeline import loop_closing as LC
    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS

    os.makedirs(args.dump, exist_ok=True)
    calls, last = [], {}
    ransac, refine = LC.sim3_ransac, LC.sim3_refine

    def rec_ransac(x1, x2, valid, sets, **kw):
        res = ransac(x1, x2, valid, sets, **kw)
        last.update(valid=valid.cpu().numpy(), n=int(res.n_inliers), s=float(res.s))
        return res

    def rec_refine(m, slot, cand, R0, t0, s0, cam, cfg, seed_idx=None, seed_ok=None):
        out = refine(m, slot, cand, R0, t0, s0, cam, cfg, seed_idx=seed_idx, seed_ok=seed_ok)
        seeded = seed_idx is not None
        c = {"k": len(calls), "slot": int(slot), "cand": int(cand), "seeded": seeded,
             "ransac_inliers": last["n"] if seeded else None, "n_inliers": int(out.n_inliers),
             "s": float(out.s)}
        if c["n_inliers"] >= 20 or (seeded and last["n"] >= 15):
            d = {f"m_{k}": v for k, v in MS.to_numpy(m).items()}
            d.update(R0=R0.cpu().numpy(), t0=t0.cpu().numpy(), s0=np.float32(s0.cpu()),
                     R=out.R.cpu().numpy(), t=out.t.cpu().numpy())
            if seeded:
                d.update(seed_idx=seed_idx.cpu().numpy(), seed_ok=seed_ok.cpu().numpy(),
                         ransac_valid=last["valid"])
            np.savez_compressed(os.path.join(args.dump, f"call{c['k']}.npz"), **d)
            c["saved"] = True
        calls.append(c)
        return out

    LC.sim3_ransac, LC.sim3_refine = rec_ransac, rec_refine
    ref = cs.load_fixture(cs.LOOP_FIXTURE, cs.LOOP_FRAMES)
    poses, imgs = cs.loop_inputs(ref, args.arm)
    staged = torch.from_numpy(imgs).to(torch.device(args.device))
    _, got = cs.run_loop_arm([staged[i] for i in range(len(imgs))], poses, args.arm != "loop_off",
                             torch.device(args.device), ref=ref[args.arm])
    with open(os.path.join(args.dump, "calls.json"), "w") as f:
        json.dump(calls, f, indent=1)
    return {"arm": args.arm, **{k: got[k] for k in ("tracked", "ate_m", "kf_inserted",
                                                   "loops_closed", "accepted")},
            "saved": [c for c in calls if c.get("saved")]}


def replay_jax(args) -> dict:
    """The JAX package's ladder on the port's saved map states."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    from orb_slam3_noted_tpu.geometry.sim3_solver import sim3_ransac
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.optim.sim3_opt import sim3_refine
    from orb_slam3_noted_tpu.pipeline import map_state as jms
    from orb_slam3_noted_tpu.pipeline.loop_closing import _matched_point_pairs

    cfg = SlamConfig(camera=Camera(PINHOLE, cs.CAM_PARAMS), width=cs.W, height=cs.H,
                     n_features=1200, max_keyframes=64, max_map_points=8192, local_window=5,
                     kf_max_interval=10)
    poses = _fixture_poses(cs, args.arm)
    with open(os.path.join(args.replay, "calls.json")) as f:
        calls = [c for c in json.load(f) if c.get("saved")]
    out = []
    for c in calls:
        d = np.load(os.path.join(args.replay, f"call{c['k']}.npz"))
        m = jms.MapArrays(**{f: jnp.asarray(d["m_" + f]) for f in jms.MapArrays._fields})
        slot, cand = jnp.int32(c["slot"]), jnp.int32(c["cand"])
        fids = d["m_kf_frame_id"]
        row = {**c, "frames": [int(fids[c["slot"]]), int(fids[c["cand"]])]}
        kw = {}
        if c["seeded"]:
            x_cand, x_cur, ok, idx = _matched_point_pairs(m, slot, cand)
            row["same_pair_mask"] = bool((np.asarray(ok) == d["ransac_valid"]).all())
            jr = sim3_ransac(x_cand, x_cur, ok, jax.random.PRNGKey(c["slot"]))
            row["jax_ransac_inliers"] = int(jr.n_inliers)
            kw = dict(seed_idx=jnp.asarray(d["seed_idx"]), seed_ok=jnp.asarray(d["seed_ok"]))
        jref = sim3_refine(m, slot, cand, jnp.asarray(d["R0"]), jnp.asarray(d["t0"]),
                           jnp.asarray(d["s0"]), cfg.camera, cfg, **kw)
        if c["seeded"]:
            row.update(pair_truth(d, c["slot"], c["cand"], poses))
        row.update(jax_refine_inliers=int(jref.n_inliers), jax_refine_s=float(jref.s),
                   refine_R_diff=float(np.abs(np.asarray(jref.R) - d["R"]).max()),
                   refine_t_diff=float(np.abs(np.asarray(jref.t) - d["t"]).max()),
                   **cs.loop_truth(poses, *row["frames"], d["R"], d["t"]))
        out.append(row)
        print(json.dumps(row), file=sys.stderr)
    return {"arm": args.arm, "replayed": out}


def pair_truth(d, slot: int, cand: int, poses) -> dict:
    """Of a saved ladder step's matched pairs: how many see the same surface
    point of the room (the two keypoints' rays, cast from their frames' true
    poses, meet the walls within 5 cm of each other), and the median
    relative depth error of the pairs' map points in each keyframe (their
    map depth over the true one, against the median ratio)."""
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom

    import chip_smoke as cs

    room, (rwc, twc) = BoxRoom(seed=0), poses
    fx, fy, cx, cy = cs.CAM_PARAMS
    cur = np.flatnonzero(d["ransac_valid"])
    idx = {slot: cur, cand: d["seed_idx"][cur]}
    world, depth_err = {}, {}
    for k, i in idx.items():
        f = int(d["m_kf_frame_id"][k])
        xy = d["m_kf_xy"][k][i].astype(np.float64)
        ray = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy, np.ones(len(i))], -1)
        true_z = room._render_dirs(rwc[f].astype(np.float64), twc[f], ray[:, None], True)[1][:, 0]
        world[k] = (ray * true_z[:, None]) @ rwc[f].T.astype(np.float64) + twc[f]
        pc = d["m_mp_pos"][d["m_kf_mp"][k][i]] @ d["m_kf_Rcw"][k].T + d["m_kf_tcw"][k]
        ratio = pc[:, 2] / true_z
        depth_err[k] = float(np.median(np.abs(ratio / np.median(ratio) - 1.0)))
    gap = np.linalg.norm(world[slot] - world[cand], axis=1)
    return {"pairs": int(len(cur)), "pairs_same_point": int((gap < 0.05).sum()),
            "depth_err_cur": depth_err[slot], "depth_err_cand": depth_err[cand]}


def _fixture_poses(cs, arm):
    """(rwc, twc) of the fixture's arm, without rendering its frames."""
    import base64

    ref = cs.load_fixture(cs.LOOP_FIXTURE, cs.LOOP_FRAMES)
    src = ref[arm] if "rwc_f32" in ref[arm] else ref
    n = src["frames"]
    return (np.frombuffer(base64.b64decode(src["rwc_f32"]), "<f4").reshape(n, 3, 3),
            np.frombuffer(base64.b64decode(src["twc_f64"]), "<f8").reshape(n, 3))


def probe_port(args) -> dict:
    import torch

    import chip_smoke as cs
    from orb_slam3_noted_tpu_torch.geometry import so3
    from orb_slam3_noted_tpu_torch.pipeline import loop_closing as LC
    from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom

    dev = torch.device(args.device)
    room = BoxRoom(seed=0)
    poses = [(so3.exp(torch.tensor([p, y, 0.0], dtype=torch.float32)).numpy(), t)
             for y, p, t in layout(args)]
    staged = torch.from_numpy(np.stack([room.render(R, t, cs.CAM_PARAMS, cs.W, cs.H)
                                        for R, t in poses]).astype(np.uint8)).to(dev)
    detections, calls, accepted = [], {"ransac": 0, "refine": 0}, []
    finish_one, accept = LC.LoopCloser._finish_one, LC.LoopCloser._accept
    ransac, refine = LC.sim3_ransac, LC.sim3_refine

    def rec_finish_one(self, slam, slot, slots_np, covis_np, kf_valid):
        out = finish_one(self, slam, slot, slots_np, covis_np, kf_valid)
        detections.append({"slot": int(slot), "frame_id": int(slam.kf_frame_ids[slot]),
                           "winners": [int(x) for x in slots_np if x >= 0],
                           "counts": [int(c) for _, c in self.consistent_groups],
                           "closed": bool(out)})
        return out

    def rec_accept(self, slam, slot, cand, res, covis=None):
        accepted.append({"slot": int(slot), "cand": int(cand),
                         "frames": [int(slam.kf_frame_ids[slot]), int(slam.kf_frame_ids[cand])]})
        return accept(self, slam, slot, cand, res, covis)

    refines, ransacs = [], []

    def rec_ransac(*a, **k):
        calls["ransac"] += 1
        out = ransac(*a, **k)
        ransacs.append({"n_inliers": int(out.n_inliers)})
        return out

    def rec_refine(m, slot, cand, *a, **k):
        calls["refine"] += 1
        out = refine(m, slot, cand, *a, **k)
        fids = m.kf_frame_id.cpu().numpy()
        refines.append({"frames": [int(fids[int(slot)]), int(fids[int(cand)])],
                        "seeded": k.get("seed_idx") is not None,
                        "n_inliers": int(out.n_inliers), "s": float(out.s),
                        "R": out.R.cpu().numpy(), "t": out.t.cpu().numpy()})
        return out

    LC.LoopCloser._finish_one, LC.LoopCloser._accept = rec_finish_one, rec_accept
    LC.sim3_ransac, LC.sim3_refine = rec_ransac, rec_refine
    s = MonoSLAM(cs.mono_config(loop_closing=True), device=dev)
    if args.seed_offset:
        own = s._minimal_sets
        s._minimal_sets = lambda valid, seed: own(valid, seed + args.seed_offset)
    _keyframe_override(s)
    for i in range(0, len(poses), cs.BATCH):
        j = min(i + cs.BATCH, len(poses))
        s.process_batch([staged[k] for k in range(i, j)], list(range(i, j)))
    s.flush()
    idx = [k for k, r in enumerate(s.trajectory) if r.state == "OK"]
    gt = np.stack([t for _, t in poses])
    ate = ate_rmse(s.positions()[idx], gt[[s.trajectory[k].frame_id for k in idx]],
                   with_scale=True)[0]
    out = _summary(s, len(poses), idx, ate, detections, calls["ransac"], calls["refine"],
                   accepted)
    out["strong_refines"] = strong_refines(refines, ransacs, poses)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--excursions", type=float, default=2.0)
    ap.add_argument("--amplitude", type=float, default=0.7)
    ap.add_argument("--yaw-amp", type=float, default=0.70)
    ap.add_argument("--depth-amp", type=float, default=0.18)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed-offset", type=int, default=0,
                    help="draw the two-view RANSAC sets from seed frame id + this")
    ap.add_argument("--arm", default=None, help="chip_smoke.py's arm of the 400-frame lap")
    ap.add_argument("--dump", default=None, help="--package port --arm: save the ladder here")
    ap.add_argument("--replay", default=None, help="--package jax --arm: replay a --dump")
    args = ap.parse_args()
    if args.dump:
        print(json.dumps(dump_port(args)))
        return 0
    if args.replay:
        print(json.dumps(replay_jax(args)))
        return 0
    out = probe_jax(args) if args.package == "jax" else probe_port(args)
    out["layout"] = {k: getattr(args, k) for k in ("frames", "excursions", "amplitude", "yaw_amp",
                                                  "depth_amp", "seed_offset")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
