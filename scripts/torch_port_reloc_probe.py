"""Where the kidnapped monocular lap relocalises, in either package, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_port_reloc_probe.py --package jax \\
        [--mapped 36] [--revisit 20,60] [--roll-deg 90]
    python scripts/torch_port_reloc_probe.py --package port

``--package jax`` runs the JAX package's ``MonoSLAM`` frame by frame at
``bench.py``'s monocular configuration (752x480, 1200 features, 8192 map
points, loop closing off) over frames 0 to ``--mapped`` - 1 of
``orbit_trajectory(120, forward=0.03, yaw0=0.45)``, three blank frames,
then the frames ``--revisit`` (from, to) again, rolled ``--roll-deg`` about
the optical axis: the way to try another layout of the lap before writing
it into ``scripts/torch_port_reference_lap.py``.  It prints each revisit
frame's state and inliers and each relocalisation attempt's outcome.

``--package port`` runs the port the same way on the lap that
``chip_smoke.py`` drives (``tests/fixtures/mono_reloc_lap.json``: its
frames, its rotations, the JAX run's two-view draws and, where the match
masks agree, its PnP draws) on the CPU, where the kernels' plain versions
run: the relocalisations, tracked frames, Sim(3) ATE and keyframes, a
rehearsal of the card's lap.

Prints one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def probe_jax(args) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_noted_tpu.geometry import so3
    from orb_slam3_noted_tpu.io.config import SlamConfig
    from orb_slam3_noted_tpu.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu.pipeline import system as jsys
    from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory

    import chip_smoke as cs

    cam = Camera(PINHOLE, cs.CAM_PARAMS)
    cfg = SlamConfig(camera=cam, width=cs.W, height=cs.H, n_features=1200, max_keyframes=64,
                     max_map_points=8192, local_window=5, kf_max_interval=10,
                     enable_loop_closing=False)
    room = BoxRoom(seed=0)
    poses = orbit_trajectory(120, forward=0.03, yaw0=0.45)
    roll = np.asarray(so3.exp(jnp.asarray([0.0, 0.0, np.deg2rad(args.roll_deg)], jnp.float32)))
    slam = jsys.MonoSLAM(cfg)
    attempts = []
    reloc = slam._try_relocalize

    def noted(feats, frame_id):
        out = reloc(feats, frame_id)
        attempts.append([int(frame_id), None if out is None else [int(slam.last_kf_slot),
                                                                  int(out[2])]])
        return out

    slam._try_relocalize = noted
    for i in range(args.mapped):
        slam.process(room.render(*poses[i], cam.params, cs.W, cs.H).astype(np.uint8), i)
    for fid in (1000, 1001, 1002):
        slam.process(np.full((cs.H, cs.W), 128, np.uint8), fid)
    revisit = []
    for k in range(*args.revisit):
        R, t = poses[k]
        img = room.render((R @ roll).astype(np.float32), t, cam.params, cs.W, cs.H)
        rec = slam.process(img.astype(np.uint8), 2000 + k)
        revisit.append([2000 + k, rec.state, int(rec.n_inliers)])
        print(f"frame {2000 + k} {rec.state:<16} inliers {rec.n_inliers}", flush=True)
    return {"package": "jax", "mapped": args.mapped, "revisit": args.revisit,
            "roll_deg": args.roll_deg, "attempts": attempts,
            "relocalised": [a[0] for a in attempts if a[1] is not None], "revisit_frames": revisit,
            "kf_frame_ids": sorted(int(f) for f in slam.kf_frame_ids if f >= 0)}


def probe_port() -> dict:
    import torch

    import chip_smoke as cs
    from orb_slam3_noted_tpu_torch.pipeline import system as S
    from orb_slam3_noted_tpu_torch.pipeline import tracking as T
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    ref = cs.load_fixture(cs.RELOC_FIXTURE, cs.RELOC_FRAMES)
    centres, frames = cs.reloc_inputs(ref)
    ids = [f for f, _ in frames]
    slam = S.MonoSLAM(cs.mono_config(), device=torch.device("cpu"))
    slam._minimal_sets = cs.fixture_draws(ref)
    slam._pnp_sets = draws = cs.fixture_pnp_draws(ref, slam)
    relocs, pnp_counts = [], []
    reloc, pnp = slam._try_relocalize, S.PNP.pnp_ransac

    def noted(feats, frame_id):
        out = reloc(feats, frame_id)
        if out is not None:
            relocs.append([int(frame_id), int(slam.last_kf_slot), int(pnp_counts[-1]),
                           int(out[2])])
        return out

    def counted(*a, **kw):
        res = pnp(*a, **kw)
        pnp_counts.append(res.n_inliers)
        return res

    slam._try_relocalize = noted
    T.reloc_matches, S.PNP.pnp_ransac = draws.reloc_matches, counted
    try:
        for fid, img in frames:
            slam.process(torch.from_numpy(img), fid)
    finally:
        T.reloc_matches, S.PNP.pnp_ransac = draws.original, pnp
    states = [r.state for r in slam.trajectory]
    kf_frames = sorted(int(f) for f in slam.kf_frame_ids if f >= 0)
    init = states.index("OK")
    blank = np.isnan(centres[:, 0])
    use = [ids.index(kf_frames[0])] + [i for i in range(init, len(ids)) if not blank[i]]
    ate = ate_rmse(slam.positions()[use], centres[use], with_scale=True)[0]
    return {"package": "port", "device": "cpu",
            "relocalisations": relocs, "jax_relocalisations": [
                [r["frame_id"], r["slot"], r["pnp_inliers"], r["retrack_inliers"]]
                for r in ref["relocalisations"]],
            "pnp_draws_from_jax": [a[3] for a in draws.asked], "tracked": states.count("OK"),
            "ate_m": float(ate), "jax_ate_m": ref["ate_m"], "kf_frame_ids": kf_frames}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--mapped", type=int, default=36)
    ap.add_argument("--revisit", default="20,60")
    ap.add_argument("--roll-deg", type=float, default=90.0)
    args = ap.parse_args()
    args.revisit = tuple(int(x) for x in args.revisit.split(","))
    out = probe_jax(args) if args.package == "jax" else probe_port()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
