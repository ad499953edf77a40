"""Map checkpoint and resume (port of :mod:`orb_slam3_noted_tpu.io.checkpoint`).

The reference leaves ``System::SaveMap/LoadMap`` as TODO comments; here the
whole SLAM state is a tuple of fixed-shape arrays plus a few host scalars,
so a checkpoint is one compressed npz.  The format (v2) and its schema are
the JAX package's, key for key, with the same dtypes and shapes, so a file
written by either package loads in the other: descriptors and the
vocabulary are stored as uint32 (the port's int32 tensors hold the same
bits).

Saved state:
- every :class:`..pipeline.map_state.MapArrays` field,
- the per-keyframe inertial table (velocities and biases) when present,
- the RAW temporal-chain IMU segments (``kf_segments``, ``seg_ok``), which a
  resumed inertial run re-integrates (``_reintegrate_segments``), so it keeps
  its inertial factors,
- the place-recognition database (vocabulary, BoW rows, idf), so loops and
  relocalisation close against keyframes from before the checkpoint,
- the host counters (keyframe and point allocators, recycled slots, tracking
  state, stage flags), the trajectory so far, and the configuration, whose
  shapes are checked at load time.

An :class:`..pipeline.atlas.AtlasSLAM` holds several maps and is refused
with a ``TypeError``: the JAX package's CLI hands one to ``save_map``, which
then fails on a missing attribute (ROADMAP Queue 3).  Its active system,
``atlas.active``, saves as any other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.pipeline import map_state as MS

_FORMAT_VERSION = 2


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _config_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    cam = d.pop("camera")
    d["camera_kind"] = cam["kind"]
    d["camera_params"] = list(cam["params"])
    cam2 = d.pop("camera2", None)
    if cam2 is not None:
        d["camera2_kind"] = cam2["kind"]
        d["camera2_params"] = list(cam2["params"])
    return d


def save_map(path: str, slam) -> None:
    """Checkpoint a SLAM system (mono, stereo, RGB-D, fisheye or inertial)
    to ``path``."""
    from orb_slam3_noted_tpu_torch.pipeline.atlas import AtlasSLAM

    if isinstance(slam, AtlasSLAM):
        raise TypeError(
            "save_map checkpoints one map, and an AtlasSLAM holds several (the "
            "active one and the stored ones) with no single tracking state; "
            "save its active system, atlas.active, instead")
    arrays = {f"map_{k}": v for k, v in MS.to_numpy(slam.m).items()}
    host = {
        "n_kf": slam.n_kf,
        "n_mp": slam.n_mp,
        "state": slam.state,
        "last_kf_slot": slam.last_kf_slot,
        "frames_since_kf": slam.frames_since_kf,
        "tracked_at_kf": slam.tracked_at_kf,
        "kf_inserted": getattr(slam, "kf_inserted", 0),
        "free_kf_slots": list(map(int, getattr(slam, "free_kf_slots", []))),
    }
    arrays["last_Rcw"] = _np(slam.last_Rcw)
    arrays["last_tcw"] = _np(slam.last_tcw)
    arrays["kf_frame_ids"] = np.asarray(getattr(slam, "kf_frame_ids", np.zeros(0, np.int64)))
    if getattr(slam, "ki", None) is not None:
        arrays["ki_vel"], arrays["ki_bg"], arrays["ki_ba"] = (_np(x) for x in slam.ki)
        host["imu_stage"] = slam.imu_stage
        host["kf_order"] = list(map(int, slam.kf_order))
        host["kf_times"] = list(map(float, slam.kf_times))
        host["seg_ok"] = list(map(bool, slam.seg_ok))
        host["last_t"] = float(slam.last_t) if slam.last_t is not None else None
        arrays["bias_bg"] = _np(slam.bias.bg)
        arrays["bias_ba"] = _np(slam.bias.ba)
        arrays["cur_vel"] = _np(slam.cur_vel)
        # the raw chain segments, concatenated, with their lengths (what a
        # resume needs to re-integrate with a new bias)
        segs = slam.kf_segments
        for k, (key, width) in enumerate((("seg_acc", 3), ("seg_gyr", 3), ("seg_dt", 0))):
            shape = (0, width) if width else (0,)
            arrays[key] = (np.concatenate([s[k] for s in segs]).astype(np.float32) if segs
                           else np.zeros(shape, np.float32))
        arrays["seg_len"] = np.asarray([len(s[2]) for s in segs], np.int64)
    # the place-recognition database (the loop closer's, or the standalone
    # relocalisation one): vocabulary, occupied BoW rows, idf
    db = db_kind = None
    if getattr(slam, "loop_closer", None) is not None:
        db, db_kind = slam.loop_closer.db, "loop"
        host["loop_edges"] = [[int(a), int(b)] for a, b in slam.loop_closer.loop_edges]
    elif getattr(slam, "reloc_db", None) is not None:
        db, db_kind = slam.reloc_db, "reloc"
    if db is not None:
        occ = np.flatnonzero(db.present)
        arrays["db_vocab"] = _np(db.vocab).view(np.uint32)
        arrays["db_slots"] = occ.astype(np.int64)
        arrays["db_rows"] = _np(db.bow_mat)[occ].astype(np.float32)
        if db.idf is not None:
            arrays["db_idf"] = _np(db.idf)
        host["db_kind"] = db_kind
    traj = np.asarray(
        [np.concatenate([[r.frame_id], r.Rcw.reshape(-1), r.tcw.reshape(-1),
                         [float(r.n_inliers)]]) for r in slam.trajectory]
        if slam.trajectory else np.zeros((0, 14)))
    np.savez_compressed(
        path,
        __version__=_FORMAT_VERSION,
        __host__=json.dumps(host),
        __config__=json.dumps(_config_dict(slam.cfg)),
        __traj_states__=json.dumps([r.state for r in slam.trajectory]),
        traj=traj,
        **arrays,
    )


def load_map(path: str, slam) -> None:
    """Restore a checkpoint into a freshly constructed SLAM system, on that
    system's device.  Its configuration's shapes must match the
    checkpoint's (checked here)."""
    from orb_slam3_noted_tpu_torch.imu.preintegration import Bias
    from orb_slam3_noted_tpu_torch.pipeline.inertial_mapping import KFInertial
    from orb_slam3_noted_tpu_torch.pipeline.loop_closing import LoopCloser
    from orb_slam3_noted_tpu_torch.pipeline.system import FrameRecord
    from orb_slam3_noted_tpu_torch.place.database import KeyFrameDatabase

    dev = slam.device
    z = np.load(path, allow_pickle=False)
    ver = int(z["__version__"])
    if ver not in (1, _FORMAT_VERSION):
        raise ValueError(f"checkpoint version {ver} != {_FORMAT_VERSION}")
    saved_cfg = json.loads(str(z["__config__"]))
    for key in ("max_keyframes", "max_map_points", "n_features"):
        have, want = getattr(slam.cfg, key), saved_cfg[key]
        if have != want:
            raise ValueError(f"config mismatch on {key}: checkpoint {want}, system {have}")
    fields = {}
    for k in MS.MapArrays._fields:
        if f"map_{k}" in z:
            fields[k] = z[f"map_{k}"]
        elif k == "kf_xy_r":
            # a v1 checkpoint carries no second-camera observations
            fields[k] = np.full_like(z["map_kf_xy"], -1.0)
        elif k == "kf_parent":
            # nor a spanning tree: every keyframe a root
            fields[k] = np.full(z["map_kf_valid"].shape[0], -1, np.int32)
        else:
            raise KeyError(f"checkpoint missing map field {k}")
    slam.m = MS.from_numpy(fields, device=dev)
    host = json.loads(str(z["__host__"]))
    slam.n_kf = int(host["n_kf"])
    slam.n_mp = int(host["n_mp"])
    slam.state = host["state"]
    slam.last_kf_slot = int(host["last_kf_slot"])
    slam.frames_since_kf = int(host["frames_since_kf"])
    slam.tracked_at_kf = int(host["tracked_at_kf"])
    slam.kf_inserted = int(host.get("kf_inserted", slam.n_kf))
    slam.free_kf_slots = list(host.get("free_kf_slots", []))
    as_dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    slam.last_Rcw = as_dev(z["last_Rcw"])
    slam.last_tcw = as_dev(z["last_tcw"])
    if "kf_frame_ids" in z and len(z["kf_frame_ids"]):
        slam.kf_frame_ids = np.asarray(z["kf_frame_ids"], np.int64)
    slam.vel = None
    if "ki_vel" in z and getattr(slam, "ki", None) is not None:
        slam.ki = KFInertial(vel=as_dev(z["ki_vel"]), bg=as_dev(z["ki_bg"]),
                             ba=as_dev(z["ki_ba"]))
        slam.imu_stage = int(host["imu_stage"])
        slam.kf_order = list(host["kf_order"])
        slam.kf_times = list(host["kf_times"])
        slam.bias = Bias(as_dev(z["bias_bg"]), as_dev(z["bias_ba"]))
        if "cur_vel" in z:
            slam.cur_vel = as_dev(z["cur_vel"])
        if host.get("last_t") is not None:
            slam.last_t = float(host["last_t"])
        # the raw chain segments and their preintegrations (v2); a v1
        # checkpoint has none, and the chain resumes visual-only until new
        # segments accrue
        if "seg_len" in z and len(z["seg_len"]):
            offs = np.concatenate([[0], np.cumsum(z["seg_len"])])
            acc, gyr, dt = z["seg_acc"], z["seg_gyr"], z["seg_dt"]
            slam.kf_segments = [(acc[offs[i]:offs[i + 1]], gyr[offs[i]:offs[i + 1]],
                                 dt[offs[i]:offs[i + 1]]) for i in range(len(offs) - 1)]
            slam.seg_ok = list(host.get("seg_ok", [True] * len(slam.kf_segments)))
            slam._reintegrate_segments()
        else:
            slam.kf_segments, slam.seg_preints, slam.seg_ok = [], [], []
    if "db_vocab" in z and host.get("db_kind"):
        idf = z["db_idf"] if "db_idf" in z else None
        db = KeyFrameDatabase(z["db_vocab"], slam.cfg.max_keyframes, idf=idf, device=dev)
        occ = np.asarray(z["db_slots"], np.int64)
        if len(occ):
            db.bow_mat[torch.from_numpy(occ).to(dev)] = as_dev(z["db_rows"])
            db.present[occ] = True
            db.present_dev = torch.from_numpy(db.present).to(dev)
        if host["db_kind"] == "loop":
            lc = LoopCloser(np.asarray(z["db_vocab"]), slam.cfg.max_keyframes,
                            min_inliers=slam.cfg.loop_min_inliers, idf=idf, device=dev)
            lc.db = db
            lc.loop_edges = [(int(a), int(b)) for a, b in host.get("loop_edges", [])]
            slam.loop_closer = lc
        else:
            slam.reloc_db = db
    states = json.loads(str(z["__traj_states__"]))
    slam.trajectory = [
        FrameRecord(frame_id=int(row[0]), Rcw=row[1:10].reshape(3, 3), tcw=row[10:13],
                    state=states[i], n_inliers=int(row[13]))
        for i, row in enumerate(z["traj"])
    ]
