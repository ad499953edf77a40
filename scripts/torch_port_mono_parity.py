"""Where the monocular laps of the JAX package and of the port part ways, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_port_mono_parity.py --package port --offsets 0,1000
    JAX_PLATFORMS=cpu python scripts/torch_port_mono_parity.py --package jax --offsets 0,1000
    JAX_PLATFORMS=cpu python scripts/torch_port_mono_parity.py --features
    JAX_PLATFORMS=cpu python scripts/torch_port_mono_parity.py --attempts

``bench.py``'s monocular lap as ``chip_smoke.py`` drives it (120 frames,
752x480, 1200 features, 8192 map points, loop closing off,
``process_batch`` in batches of 16 from frame 0), with the RANSAC seed of
each batch of initialisation attempts moved from the frame id to the frame
id plus an offset (offset 0: the package's own draw).  One JSON line a run:
the initialisation frame, the initial two-view motion's errors against the
ground truth (angle of the translation direction and of the rotation, in
degrees; the motion there is mostly forward, ~0.03 m a frame), the
Sim(3)-aligned ATE in mm and the mean aligned error of frames 0-39, 40-79
and 80-119, keyframes and tracked frames.

``--trajectory port`` renders the frames from the port's own
``orbit_trajectory`` (a few rotations 1 ulp away from the JAX package's)
instead of the JAX run's rotations stored in the mono fixture.

``--features``: how alike the two packages' extractors are on the lap's
frames 0 and 3 (the shares of keypoints at the same pixel and of equal
descriptors, the largest pyramid difference per level).

``--attempts``: the lap's first batch of initialisation attempts (frame 0
against frames 1-15) through both packages' ``init_attempt_batch`` on the
same input, the JAX package's features and its RANSAC draws (the fixture's
``init_draws``): the match masks, and per attempt the outcome, the
cheirality vote and the three best homography hypotheses by score (the
same minimal sets in both packages).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the lap's configuration and frames)


def angle_deg(a: np.ndarray, b: np.ndarray) -> float:
    c = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def rotation_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0))))


def make_slam(package: str, offset: int):
    """A MonoSLAM of ``package`` whose initialisation attempts draw with
    seed frame id + ``offset``, and its evaluation function."""
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from orb_slam3_noted_tpu.io.config import SlamConfig
        from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
        from orb_slam3_noted_tpu.pipeline import system as S
        from orb_slam3_noted_tpu.utils.evaluation import ate_rmse

        cfg = SlamConfig(camera=Camera(PINHOLE, cs.CAM_PARAMS), width=cs.W, height=cs.H,
                         n_features=1200, max_keyframes=64, max_map_points=8192, local_window=5,
                         kf_max_interval=10, enable_loop_closing=False)
        slam = S.MonoSLAM(cfg)
        attempt = S.T.init_attempt_batch

        def shifted(ref, cand, cam, key):
            return attempt(ref, cand, cam, jax.random.PRNGKey(int(np.asarray(key)[1]) + offset))

        S.T.init_attempt_batch = shifted
        return slam, ate_rmse, lambda: setattr(S.T, "init_attempt_batch", attempt)
    import torch

    from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    slam = MonoSLAM(cs.mono_config(), device=torch.device("cpu"))
    own = slam._minimal_sets
    slam._minimal_sets = lambda valid, seed: own(valid, seed + offset)
    return slam, ate_rmse, lambda: None


def run(package: str, offset: int, poses, imgs) -> dict:
    slam, ate_rmse, undo = make_slam(package, offset)
    init = {}
    finish = slam._finish_initialize

    def recording(feats, frame_id, *rest):
        finish(feats, frame_id, *rest)
        if slam.state == "OK":  # rest ends with the host copies of R21, t21
            init.update(frame=int(frame_id), R21=np.asarray(rest[-2]), t21=np.asarray(rest[-1]))

    slam._finish_initialize = recording
    for i in range(0, len(imgs), cs.BATCH):
        j = min(i + cs.BATCH, len(imgs))
        slam.process_batch(list(imgs[i:j]), list(range(i, j)))
    undo()
    states = [r.state for r in slam.trajectory]
    est = slam.positions()
    gt = np.asarray([t for _, t in poses])
    kf = sorted(int(f) for f in np.asarray(slam.kf_frame_ids) if f >= 0)
    use = [kf[0]] + list(range(states.index("OK"), len(states)))
    ate, aligned, _ = ate_rmse(est[use], gt[use], with_scale=True)
    err = np.linalg.norm(np.asarray(aligned) - gt[use], axis=1)
    frame = np.asarray(use)
    by_40 = [float(err[(frame >= a) & (frame < a + 40)].mean() * 1e3) for a in (0, 40, 80)]
    (R0, t0), (Rk, tk) = poses[0], poses[init["frame"]]
    return {"package": package, "offset": offset, "init_frame": init["frame"],
            "init_t_dir_err_deg": angle_deg(init["t21"], Rk.T @ (t0 - tk)),
            "init_R_err_deg": rotation_deg(init["R21"], Rk.T @ R0),
            "true_rotation_deg": rotation_deg(np.eye(3), Rk.T @ R0), "ate_mm": float(ate) * 1e3,
            "mean_err_mm_frames_0_40_80": by_40,
            "n_kf": int(slam.n_kf), "kf_frame_ids": kf, "tracked": sum(s == "OK" for s in states)}


def features(imgs) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_noted_tpu.ops import image as jimage
    from orb_slam3_noted_tpu.ops import orb as jorb
    from orb_slam3_noted_tpu_torch.ops import image as timage
    from orb_slam3_noted_tpu_torch.ops import orb as torb

    for i in (0, 3):
        x = imgs[i].astype(np.float32)
        fj = jax.device_get(jorb.extract_orb(jnp.asarray(x), n_features=1200))
        ft = torb.extract_orb(torch.from_numpy(x), n_features=1200)
        pj = jimage.build_pyramid(jnp.asarray(x), 8, 1.2)
        pt = timage.build_pyramid(torch.from_numpy(x), 8, 1.2)
        print(json.dumps({
            "frame": i,
            "same_xy": float(np.all(np.asarray(fj.xy) == ft.xy.numpy(), axis=1).mean()),
            "same_desc": float(np.all(np.asarray(fj.desc).view(np.uint32)
                                      == ft.desc.numpy().view(np.uint32), axis=1).mean()),
            "pyramid_max_diff": [float(np.abs(np.asarray(a) - b.numpy()).max())
                                 for a, b in zip(pj, pt)],
        }), flush=True)


def attempts(imgs) -> None:
    import base64

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_noted_tpu.geometry import twoview as jtv
    from orb_slam3_noted_tpu.models import cameras as jcam
    from orb_slam3_noted_tpu.ops import orb as jorb
    from orb_slam3_noted_tpu.pipeline import tracking as jtr
    from orb_slam3_noted_tpu_torch.geometry import twoview as ttv
    from orb_slam3_noted_tpu_torch.models import cameras as tcam
    from orb_slam3_noted_tpu_torch.ops import orb as torb
    from orb_slam3_noted_tpu_torch.pipeline import tracking as ttr

    ref = cs.load_fixture(cs.MONO_FIXTURE, cs.MONO_FRAMES)
    d = ref["init_draws"][0]
    sets = np.frombuffer(base64.b64decode(d["sets"]), "<i2").reshape(d["shape"]).astype(np.int64)
    n = d["shape"][0] + 1
    fj = jax.device_get(jorb.extract_orb_batch(jnp.asarray(imgs[:n].astype(np.float32)),
                                               n_features=1200))
    cam_j, cam_t = jcam.Camera(jcam.PINHOLE, cs.CAM_PARAMS), tcam.Camera(tcam.PINHOLE, cs.CAM_PARAMS)
    pick = lambda f, s: jax.tree_util.tree_map(lambda x: jnp.asarray(x[s]), f)
    outj = jax.device_get(jtr.init_attempt_batch(pick(fj, 0), pick(fj, slice(1, None)), cam_j,
                                                 jax.random.PRNGKey(d["seed"])))
    ft = torb.from_numpy(fj._asdict())
    outt = ttr.init_attempt_batch(torb.FrameFeatures(*(f[0] for f in ft)),
                                  torb.FrameFeatures(*(f[1:] for f in ft)), cam_t,
                                  lambda _: torch.from_numpy(sets))
    idx = np.asarray(outj[6])
    print(json.dumps({"masks_equal": bool(np.array_equal(outt[6].numpy(), idx)),
                      "success_jax": np.asarray(outj[1]).astype(int).tolist(),
                      "success_port": outt[1].numpy().astype(int).tolist()}), flush=True)
    err = 3.84 / (cam_t.fx * cam_t.fx)
    th = err * (5.991 / 3.841)
    r1 = np.asarray(jcam.unproject(cam_j, jnp.asarray(fj.xy[0])))
    for b in range(3):
        valid = idx[b] >= 0
        r2 = np.asarray(jcam.unproject(cam_j, jnp.asarray(fj.xy[b + 1][np.clip(idx[b], 0, None)])))
        keys = jax.random.split(jax.random.PRNGKey(d["seed"]), d["shape"][0])
        rj = jtv.reconstruct_two_views(jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(valid),
                                       keys[b], err_thresh=err)
        t1, t2 = torch.from_numpy(r1), torch.from_numpy(r2)
        rt = ttv.reconstruct_two_views(t1, t2, torch.from_numpy(valid), torch.from_numpy(sets[b]),
                                       err_thresh=err)
        four = sets[b][:, :4]
        ej = jtv._transfer_errors(jtv._four_point_homography(jnp.asarray(r1[four]),
                                                             jnp.asarray(r2[four])),
                                  jnp.asarray(r1), jnp.asarray(r2))
        et = ttv._transfer_errors(ttv._four_point_homography(t1[four], t2[four]), t1, t2)

        def top3(e12, e21):
            e12, e21 = np.asarray(e12), np.asarray(e21)
            score = (np.where(valid & (e12 < th), th - e12, 0.0)
                     + np.where(valid & (e21 < th), th - e21, 0.0)).sum(-1)
            order = np.argsort(-score, kind="stable")[:3]
            return [[int(k), float(score[k])] for k in order]

        print(json.dumps({
            "frame": b + 1,
            "jax": {"success": bool(rj.success), "used_h": bool(rj.used_h),
                    "vote_best": int(rj.vote_best), "vote_second": int(rj.vote_second),
                    "best_homographies": top3(*ej)},
            "port": {"success": bool(rt.success), "used_h": bool(rt.used_h),
                     "vote_best": int(rt.vote_best), "vote_second": int(rt.vote_second),
                     "best_homographies": top3(et[0].numpy(), et[1].numpy())},
        }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--offsets", default="0")
    ap.add_argument("--features", action="store_true")
    ap.add_argument("--attempts", action="store_true")
    ap.add_argument("--trajectory", choices=("jax", "port"), default="jax")
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(args.threads)
    poses, imgs = cs.mono_inputs()
    if args.trajectory == "port":
        from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory

        room = BoxRoom(seed=0)
        poses = orbit_trajectory(cs.MONO_FRAMES, forward=0.03, yaw0=0.45)
        imgs = np.stack([room.render(R, t, cs.CAM_PARAMS, cs.W, cs.H)
                         for R, t in poses]).astype(np.uint8)
    if args.features:
        features(imgs)
    elif args.attempts:
        attempts(imgs)
    else:
        for off in (int(o) for o in args.offsets.split(",")):
            print(json.dumps(run(args.package, off, poses, imgs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
