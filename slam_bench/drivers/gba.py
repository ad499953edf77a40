"""The full-map global bundle adjustment that ends a loop closure:
``optim/gba.py`` ``global_bundle_adjust`` on a map at the port's full
capacity, called again and again from the same perturbed inputs.

The map is a frozen copy of ``scripts/torch_port_dist.py``
``capacity_gba_problem`` (from ``__graft_entry__.py:104-150``), made on the
card from the seed: points uniform in [-4, 4]^2 x [6, 14] m, keyframe k
turned 0.01 k rad about y on an orbit of ``orbit_m`` around the cloud's
centre, looking at it, ``per_kf`` distinct points seen by each, pixels with
``pix_noise`` px of normal noise, every point moved 0.01 m, keyframes 0 and
K / 2 fixed.  Its geometry is generated, not a map the front end built.

Set-up makes the map and runs the call ``warm_calls`` times.  The window
calls it until ``--seconds`` have passed, each call read back on the host
(its final cost) as a loop closer reads it.  Compared after the window: the
optimised map of sampled calls against ``reference/gba.py``'s optimum.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from slam_bench import scene
from slam_bench.harness import Outcome, now
from slam_bench.reference import gba as RG

RANGES = ("bench.gba_call",)


def capacity_map(gen, device, traffic: dict, params) -> dict:
    """The map's tensors on ``device``: true and perturbed inputs."""
    K, M, n = traffic["keyframes"], traffic["points"], traffic["per_kf"]
    f64 = torch.float64
    centre = torch.tensor([0.0, 0.0, 10.0], dtype=f64, device=device)
    pts = (torch.rand(M, 3, generator=gen, device=device, dtype=f64) * 8 - 4 + centre).float()
    th = 0.01 * torch.arange(K, dtype=f64, device=device)
    Rs = scene.so3_exp(torch.stack([torch.zeros_like(th), th, torch.zeros_like(th)], -1))
    c = centre + traffic["orbit_m"] * torch.stack([torch.sin(th), torch.zeros_like(th),
                                                   -torch.cos(th)], -1)
    ts = -torch.einsum("kij,kj->ki", Rs, c)
    sel = torch.argsort(torch.rand(K, M, generator=gen, device=device), dim=1)[:, :n]
    pose_idx = torch.arange(K, device=device).repeat_interleave(n)
    point_idx = sel.reshape(-1)
    xc = torch.einsum("oij,oj->oi", Rs[pose_idx], pts[point_idx].double()) + ts[pose_idx]
    fx, fy, cx, cy = params[:4]
    proj = torch.stack([fx * xc[:, 0] / xc[:, 2] + cx, fy * xc[:, 1] / xc[:, 2] + cy], -1)
    noise = torch.randn(K * n, 2, generator=gen, device=device, dtype=f64) * traffic["pix_noise"]
    fixed = torch.zeros(K, dtype=torch.bool, device=device)
    fixed[[0, K // 2]] = True
    return dict(Rcw=Rs.float(), tcw=ts.float(), points=pts + 0.01,
                pose_idx=pose_idx.int(), point_idx=point_idx.int(),
                uv=(proj + noise).float(), pose_fixed=fixed)


def port_problem(mp: dict):
    from orb_slam3_noted_tpu_torch.optim.ba import BAProblem
    from orb_slam3_noted_tpu_torch.optim.factors import ReprojObs

    O, dev = mp["uv"].shape[0], mp["uv"].device
    obs = ReprojObs(pose_idx=mp["pose_idx"], point_idx=mp["point_idx"], uv=mp["uv"],
                    uv_r=torch.full((O,), -1.0, device=dev),
                    inv_sigma2=torch.ones(O, device=dev),
                    is_stereo=torch.zeros(O, dtype=torch.bool, device=dev),
                    valid=torch.ones(O, dtype=torch.bool, device=dev))
    return BAProblem(Rcw=mp["Rcw"], tcw=mp["tcw"], points=mp["points"], obs=obs,
                     pose_fixed=mp["pose_fixed"],
                     point_fixed=torch.zeros(mp["points"].shape[0], dtype=torch.bool, device=dev))


def run(cell, args, spans, device=None) -> Outcome:
    dev = torch.device(device or "cuda")
    traffic = cell.traffic
    params = cell.config["camera"]["params"]
    gen = scene.seed_generator(args.seed, dev)
    mp = capacity_map(gen, dev, traffic, params)

    from orb_slam3_noted_tpu_torch.models.cameras import PINHOLE, Camera
    from orb_slam3_noted_tpu_torch.optim.gba import global_bundle_adjust

    cam = Camera(PINHOLE, tuple(params))
    prob = port_problem(mp)
    kw = dict(n_iters=traffic["n_iters"], n_iters_final=traffic["n_iters_final"],
              cg_iters=traffic["cg_iters"])
    kept = {}

    def call(k: int):
        t0 = now()
        with torch.profiler.record_function("bench.gba_call"):
            res = global_bundle_adjust(cam, prob, **kw)
            cost = float(res.cost)
        spans.add("gba_call", t0, now(), call=k, cost=cost)
        return res

    t_w = now()
    for k in range(traffic["warm_calls"]):
        call(-1 - k)
    spans.add("warm_up", t_w, now(), calls=traffic["warm_calls"])
    gc.collect()

    wanted = {0, int(np.random.default_rng(args.seed).integers(1, traffic["checked_span"]))}
    n = 0
    t0 = now()
    while now() - t0 < args.seconds:
        res = call(n)
        if n in wanted:
            kept[n] = (res.Rcw, res.tcw, res.points)
        n += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = now() - t0

    trace = None
    if args.trace:
        trace = profile_calls(call, n, traffic["trace_calls"], dev)

    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    del prob, call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = compare(mp, params, list(kept.values()))
    return Outcome({"setup_s": None, "gba_ms": 1e3 * window_s / n}, attempted=n,
                   failed=0, compared=compared, memory_peak_bytes=memory_peak, trace=trace,
                   notes={"calls": n, "window_s": window_s, "window_start": t0})


def compare(mp: dict, params, results: list) -> dict:
    """``gba_cost_gap``: the worst sampled call's cost over the reference's
    inliers, relative to the reference optimum's; ``gba_pose_gap_m``: its
    largest camera-centre distance from the optimum's."""
    R, t, X, active = RG.global_ba(params, mp["pose_idx"], mp["point_idx"], mp["uv"],
                                   mp["pose_fixed"], mp["Rcw"], mp["tcw"], mp["points"])
    p = RG.Problem(params, mp["pose_idx"], mp["point_idx"], mp["uv"], mp["pose_fixed"],
                   torch.float64)
    R, t, X = R.double(), t.double(), X.double()
    c_ref = float(p.cost(R, t, X, active))
    centre = lambda Rk, tk: -torch.einsum("kji,kj->ki", Rk, tk)
    gaps, dists = [], []
    for Rp, tp, Xp in results:
        Rp, tp, Xp = Rp.double(), tp.double(), Xp.double()
        gaps.append((float(p.cost(Rp, tp, Xp, active)) - c_ref) / c_ref)
        dists.append(float(torch.linalg.norm(centre(Rp, tp) - centre(R, t), dim=-1).max()))
    return {"gba_cost_gap": max(gaps), "gba_pose_gap_m": max(dists)}


def profile_calls(call, k0: int, count: int, dev) -> dict:
    from slam_bench.trace import reduce_profile

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = now()
        for k in range(count):
            call(k0 + k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = now() - t0
    red = reduce_profile(prof, RANGES, window_s)
    red["calls"] = count
    return red
