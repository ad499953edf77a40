"""The rectified stereo cells: a replay in batches through
``StereoSLAM.process_batch`` (``mode: replay``) and a live camera, one pair
at a time through ``StereoSLAM.process`` with each pair copied from pinned
host memory inside its latency (``mode: live``).

Set-up makes the room and the patrol from the seed, renders every pair of
the sequence on the card, initialises on pair 0 and warms up on the next
pairs through the same entry as the window.  The window continues the
sequence until ``--seconds`` have passed, whole batches or frames; a run
that reaches the sequence's end fails.  With ``--trace 1`` a profiled
sub-window of whole batches or frames follows the window.

After the window, the numbers compared (``checks.py``): the ORB features and
stereo depths the timed path produced for sampled dispatches or frames,
against ``reference/frontend.py`` on the same pairs; the tracked poses of
every window frame against the true ones, as the relative pose error over
``rpe_lag_s`` (``reference/poses.py``).
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from slam_bench import checks, roofline, scene
from slam_bench.harness import Outcome, now
from slam_bench.reference import frontend as RF
from slam_bench.reference import poses as RP

RANGES = ("fast_select", "ic_angle", "describe", "orb_extraction", "stereo_matching",
          "track_batch", "track_batch_feats", "insert_keyframe", "place_recognition",
          "loop_drain", "background_slice", "relocalize", "bench.batch", "bench.frame",
          "bench.h2d")


def port_config(conf: dict):
    """The port's ``SlamConfig`` of a configuration file."""
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import PINHOLE, Camera

    c = conf["camera"]
    cam = Camera(PINHOLE, tuple(c["params"]))
    return SlamConfig(camera=cam, width=c["width"], height=c["height"], fps=c["fps"],
                      bf=conf["baseline_m"] * cam.fx, **conf["orb"], **conf["slam"])


def make_inputs(conf: dict, traffic: dict, seed: int, n_frames: int, device):
    """(left, right) (n, H, W) uint8 on the device and the true poses
    (Rwc, twc) float64 numpy, from the seed."""
    gen = scene.seed_generator(seed, device)
    tex = scene.room_textures(gen, device)
    phases = scene.draw_phases(gen, device)
    cam = conf["camera"]
    Rwc, twc = scene.patrol_poses(n_frames, cam["fps"], phases, traffic["motion"], device)
    left, right = scene.render_stereo(tex, Rwc, twc, cam, conf["baseline_m"])
    return left, right, Rwc.cpu().numpy(), twc.cpu().numpy()


def sample_indices(seed: int, count: int, span: int) -> list:
    """Index 0 and ``count - 1`` more drawn from [1, span) by the seed."""
    rng = np.random.default_rng(seed)
    rest = rng.choice(np.arange(1, span), size=min(count - 1, span - 1), replace=False)
    return [0] + sorted(int(i) for i in rest)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Capture:
    """The front-end outputs of chosen dispatches or frames of the window,
    kept as the timed path produced them (no copy, no sync)."""

    def __init__(self, wanted: list):
        self.wanted = set(wanted)
        self.counter = 0
        self.kept = []  # (first frame id, features, depth)
        self.frame = None

    def see(self, feats, depth):
        if self.counter in self.wanted:
            self.kept.append((self.frame, feats, depth))
        self.counter += 1


def run(cell, args, spans, device=None) -> Outcome:
    dev = torch.device(device or "cuda")
    conf, traffic = cell.config, cell.traffic
    cfg = port_config(conf)
    replay = traffic["mode"] == "replay"
    B = traffic.get("batch", 1)
    warm = traffic["warm_frames"]
    traced = traffic["trace_frames"] if args.trace else 0
    n_frames = 1 + warm + math.ceil(args.seconds * traffic["frames_per_s_cap"]) + traced
    n_frames = B * math.ceil(n_frames / B) + 1
    left, right, Rwc, twc = make_inputs(conf, traffic, args.seed, n_frames, dev)

    from orb_slam3_noted_tpu_torch.pipeline import system

    slam = getattr(system, conf["facade"])(cfg, device=dev)
    if not replay:
        left_h, right_h = (x.cpu().pin_memory() if dev.type == "cuda" else x.cpu()
                           for x in (left, right))

    cap = Capture(sample_indices(args.seed, traffic["checked"], traffic["checked_span"]))
    if replay:
        inner = slam._batch_track

        def spy(prep, vel, cm):
            out = inner(prep, vel, cm)
            cap.see(out[3], out[5][1])
            return out

        slam._batch_track = spy
    else:
        inner = slam._track

        def spy(feats, frame_id, uvr=None, depth=None, xy_r=None):
            cap.see(feats, depth)
            return inner(feats, frame_id, uvr=uvr, depth=depth, xy_r=xy_r)

        slam._track = spy

    # the benchmark's spans around the facade's mapper pass and its place
    # recognition and loop detection, over the whole run (a keyframe is
    # rarer than one a traced sub-window)
    def timed(name: str, fn):
        def call(*a, **kw):
            t = now()
            try:
                return fn(*a, **kw)
            finally:
                spans.add(name, t, now())
        return call

    slam._insert_keyframe = timed("mapper_pass", slam._insert_keyframe)
    slam._maybe_close_loop = timed("place_recognition", slam._maybe_close_loop)
    slam.flush = timed("loop_drain", slam.flush)
    latencies = []

    def step(i: int) -> int:
        """Hand frames from ``i`` to the facade; returns the next index."""
        if replay:
            ids = list(range(i, i + B))
            cap.frame = i
            t0 = now()
            with torch.profiler.record_function("bench.batch"):
                slam.process_batch([(left[j], right[j]) for j in ids], ids)
            spans.add("process_batch", t0, now(), frames=ids)
            return i + B
        cap.frame = i
        t0 = now()
        with torch.profiler.record_function("bench.frame"):
            with torch.profiler.record_function("bench.h2d"):
                lf = left_h[i].to(dev, non_blocking=True)
                rf = right_h[i].to(dev, non_blocking=True)
            t1 = now()
            slam.process(lf, rf, i)
        t2 = now()
        spans.add("h2d", t0, t1, frame=i)
        spans.add("process", t0, t2, frame=i)
        latencies.append(t2 - t0)
        return i + 1

    # set-up: initialise on pair 0, warm up through the window's entry
    t_w = now()
    slam.process(left[0], right[0], 0)
    i = 1
    while i < 1 + warm:
        i = step(i)
    sync(dev)
    spans.add("warm_up", t_w, now(), frames=i)
    cap.counter, cap.kept, latencies[:] = 0, [], []
    gc.collect()

    first, kf0 = i, slam.kf_inserted
    t0 = now()
    overran = False
    while now() - t0 < args.seconds:
        if i + B > n_frames - traced:
            overran = True  # the run fails: it reached the sequence's end
            break
        i = step(i)
    sync(dev)
    window_s = now() - t0
    last, kf1 = i, slam.kf_inserted
    map_kf, map_mp = slam.n_kf, slam.n_mp
    lat_ms = [x * 1e3 for x in latencies]

    trace = starts = None
    if args.trace:
        trace, starts = profile_window(step, i, traced, dev)

    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    recs = {r.frame_id: r for r in slam.trajectory}
    del slam, step, inner, spy  # the program's state goes before the reference runs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if trace is not None:
        # counted from the reference's extraction, after the peak was read
        trace["expected"] = kernel_counts(starts, left, right, conf, B)

    # the window's frames and the ``lag`` before them, whose poses the
    # window's first pair with
    lag = rpe_lag(conf, traffic)
    ids = np.arange(max(first - lag, 0), last)
    tracked = np.array([j in recs and recs[j].n_inliers >= cfg.min_tracked_points for j in ids])
    compared = compare(cap, left, right, conf, recs, ids, first, tracked, Rwc, twc, replay, lag)
    compared["sequence_end_reached"] = int(overran)
    n = last - first
    tracked = tracked[ids >= first]
    metrics = {"setup_s": None}
    if replay:
        metrics["frames_per_s"] = n / window_s
    else:
        metrics["pose_latency_mean_ms"] = sum(lat_ms) / max(len(lat_ms), 1)
    in_window = [(nm, b - a) for nm, a, b, _ in spans.items if t0 <= a <= t0 + window_s]
    notes = {"frames": n, "window_s": window_s, "keyframes": kf1 - kf0, "window_start": t0,
             "map_keyframes": map_kf, "map_points": map_mp,
             "latencies_ms": lat_ms,
             "mapper_ms": [1e3 * d for nm, a, b, _ in spans.items if nm == "mapper_pass"
                           for d in (b - a,)],
             "place_ms_per_frame": 1e3 * sum(d for nm, d in in_window
                                             if nm in ("place_recognition", "loop_drain")) / max(n, 1)}
    return Outcome(metrics, attempted=n, failed=int((~tracked).sum()), compared=compared,
                   memory_peak_bytes=memory_peak, trace=trace, notes=notes)


def rpe_lag(conf: dict, traffic: dict) -> int:
    """The relative pose error's lag in frames: ``rpe_lag_s`` at the
    camera's rate."""
    return max(1, round(traffic["rpe_lag_s"] * conf["camera"]["fps"]))


def compare(cap, left, right, conf, recs, ids, first, tracked, Rwc, twc, replay, lag) -> dict:
    """The cell's numbers: ``orb_mismatch`` and ``stereo_mismatch`` over the
    captured dispatches or frames; ``rpe_deg`` and ``rpe_mm`` over the pairs
    of frames ``lag`` apart that end in the window (``ids`` starts ``lag``
    before ``first``); ``poses_missing`` the window frames with no pose (an
    answer that never came)."""
    orb = conf["orb"]
    bf = conf["baseline_m"] * conf["camera"]["params"][0]
    fx = conf["camera"]["params"][0]
    orb_parts, st_parts = [], []
    for f0, feats, depth in cap.kept:
        with torch.no_grad():
            if replay:
                b = feats.xy.shape[0]  # the frames the dispatch extracted
                imgs = torch.cat([left[f0:f0 + b], right[f0:f0 + b]])
                rf, _, rd = RF.stereo_batch(imgs, orb, bf, fx)
            else:
                rf, _, rd = RF.stereo_pair(left[f0], right[f0], orb, bf, fx)
        orb_parts.append(checks.orb_mismatch(feats, rf))
        st_parts.append(checks.stereo_mismatch(feats, depth, rf, rd))
    Rt, tt = RP.true_tcw(Rwc[ids], twc[ids])
    eye, zero = np.eye(3), np.zeros(3)
    Re = np.stack([np.asarray(recs[j].Rcw, np.float64) if j in recs else eye for j in ids])
    te = np.stack([np.asarray(recs[j].tcw, np.float64) if j in recs else zero for j in ids])
    return {"poses_missing": sum(j not in recs for j in ids if j >= first),
            "orb_mismatch": checks.share(orb_parts),
            "stereo_mismatch": checks.share(st_parts),
            "rpe_deg": RP.rpe_deg(Re, Rt, tracked, lag),
            "rpe_mm": RP.rpe_mm(Re, te, Rt, tt, tracked, lag)}


def profile_window(step, i, count, dev) -> tuple:
    """Profile ``count`` frames (whole batches) from frame ``i``; returns the
    reduced trace and the first frame of each dispatch."""
    from slam_bench.trace import reduce_profile

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    starts = []
    with torch.profiler.profile(activities=acts) as prof:
        sync(dev)
        t0 = now()
        j = i
        while j < i + count:
            starts.append(j)
            j = step(j)
        sync(dev)
        window_s = now() - t0
    red = reduce_profile(prof, RANGES, window_s)
    red["frames"] = j - i
    return red, starts


def kernel_counts(starts, left, right, conf, B) -> dict:
    """{kernel: [(bytes, ops)]} of the K1-K4 launches of the dispatches (or
    frames) beginning at ``starts``, from their own images."""
    orb = conf["orb"]
    out = {k: [] for k in roofline.KERNEL_NAMES}
    for s in starts:
        imgs = torch.cat([left[s:s + B], right[s:s + B]]).to(torch.float32)
        pyr = tuple(RF.build_pyramid(imgs, orb["n_levels"], orb["scale_factor"]))
        sizes = tuple((int(p.shape[-2]), int(p.shape[-1])) for p in pyr)
        budgets = tuple(max(b, 0) for b in RF.level_budgets(
            orb["n_features"], orb["n_levels"], orb["scale_factor"]))
        _, _, _, n_cells, k_max = RF.candidate_layout(sizes, budgets)
        feats = RF.extract_from_atlas(RF.build_atlas(pyr), **RF._orb(orb))
        n_valid = int(feats.valid.sum())
        for k, c in roofline.extraction_counts(pyr, sizes, n_cells, k_max, orb["min_th_fast"],
                                               n_valid).items():
            out[k].append(c)
        out["sad_stereo"].append(roofline.sad_counts(int(feats.valid[:B].sum())))
    return out
