"""Parity of the port's loop closer (``pipeline/loop_closing.py``) and the
facade's loop-closing hooks with the JAX package on the CPU.

The drifted map of ``tests/test_loop_closing.py:24-134`` comes from
``scripts/loop_scaffold.py``: the same numpy arrays, written by each
package's ``map_state``, and the same vocabulary (trained by the JAX
package, as there).  Its four cases (``:136``, ``:170``, ``:216``,
``:234``) run through both loop closers, on the JAX package's Sim(3) RANSAC
draws (``LoopCloser._sim3_sets``): the same accept or reject, the same
``(slot, cand)``, the same consistency counts.  Where the tail keyframe
sees the scene from a baseline of (0.3, -0.1, 0.2) m, the corrected points
after the pose graph, the deferred fuses and the GBA are within 1e-3 m of
the JAX package's; at zero baseline the ladder's scale is a free gauge
(ROADMAP Queue 3), so there only the reference test's own check applies.
The JAX package runs its single-device branches (``jax.device_count``
reads 1 here), the ones the port takes outside a process group; the
sharded branches of both packages are held in ``tests/test_torch_dist.py``.

``flush`` and ``_service_background`` on a 320x240 monocular lap with loop
closing on (the lap of ``tests/test_torch_mono.py``), against the JAX run:
one detection per keyframe inserted after initialisation, nothing left
queued, the same loops closed, the lap's aggregates as in
``tests/test_torch_mono.py``; and the deferred work of a correction
(two fuses, then ten GBA slices) slice by slice against the JAX package's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.pipeline import loop_closing as jlc
from orb_slam3_noted_tpu.pipeline import system as jsys
from orb_slam3_noted_tpu.place import train_vocabulary
from orb_slam3_noted_tpu_torch.pipeline import loop_closing as tlc
from orb_slam3_noted_tpu_torch.pipeline.system import OK, MonoSLAM
from test_torch_mono import CFG_KW, PARAMS, _mono_ate, drive, frames, jax_draws, tcfg  # noqa: F401
from test_torch_sim3 import LS, jax_sim3_sets, scaffold_maps

CPU = torch.device("cpu")
POINT_TOL_M = 1e-3
TRACKED_MARGIN, ATE_FACTOR, ATE_SLACK_M, KF_MARGIN = 2, 2.0, 0.002, 1


@pytest.fixture(autouse=True, scope="module")
def _jax_float32():
    """JAX in float32 as in use; torch on one thread (the test workers run
    side by side)."""
    prev, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    """The JAX package's single-device branches (the test session has 8
    virtual CPU devices, which would select the mesh-sharded pose graph and
    GBA; the port takes its one-device branches outside a process group)."""
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)


@pytest.fixture(scope="module")
def vocab():
    """A 256-word vocabulary trained on the scene's descriptors, as
    ``tests/test_loop_closing.py`` trains it (by the JAX package)."""
    desc = LS.drifted_map_inputs(seed=0)["desc"]
    rng = np.random.default_rng(1)
    train = np.concatenate([desc, rng.integers(0, 2 ** 32, size=(2000, 8), dtype=np.uint32)])
    return np.asarray(train_vocabulary(train, n_words=256, n_iters=4))


def closers(vocab, **kw):
    """(JAX loop closer, port loop closer on the JAX package's Sim(3) draws)."""
    j = jlc.LoopCloser(vocab, max_keyframes=32, **kw)
    t = tlc.LoopCloser(vocab, max_keyframes=32, device=CPU, **kw)
    t._sim3_sets = lambda valid, slot: jax_sim3_sets(valid.numpy(), slot)
    return j, t


def register(lc, m, n):
    for k in range(n):
        _, bow = lc.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
        lc.db.add(k, bow)


def _points_close(jm, tm, inp):
    n = inp["n_pts"]
    err = np.abs(np.asarray(jm.mp_pos)[: 2 * n] - tm.mp_pos.numpy()[: 2 * n]).max()
    assert err <= POINT_TOL_M, err


@pytest.mark.parametrize("baseline", [(0.0, 0.0, 0.0), LS.BASELINE])
def test_loop_detect_and_correct(vocab, baseline):
    """``tests/test_loop_closing.py:136``: no camera context, accepted on the
    first sight (consistency 0), RANSAC's Sim(3) through the pose graph."""
    inp, jcfg, jm, tcfg, tm = scaffold_maps(baseline=baseline)
    tail = inp["n_kf"] - 1
    jl, tl = closers(vocab, min_inliers=20, exclude_recent=3, consistency_th=0)
    register(jl, jm, tail)
    register(tl, tm, tail)
    js, ts = LS.ScaffoldSlam(jm, inp["n_kf"]), LS.ScaffoldSlam(tm, inp["n_kf"])
    assert jl.on_keyframe(js, tail) and tl.on_keyframe(ts, tail)
    assert tl.loop_edges == jl.loop_edges == [(tail, 0)]
    err, before = LS.corrected_point_errors(ts.m.mp_pos.numpy(), inp)
    assert np.median(err) < 0.15 * np.median(before), (np.median(err), np.median(before))
    _points_close(js.m, ts.m, inp)
    np.testing.assert_allclose(ts.last_Rcw.numpy(), np.asarray(js.last_Rcw), atol=1e-4)
    np.testing.assert_allclose(ts.last_tcw.numpy(), np.asarray(js.last_tcw), atol=1e-3)


def test_temporal_consistency_gates_single_hit(vocab):
    """``tests/test_loop_closing.py:170``: with the 3-hit policy the first
    three detections do not correct, the fourth consistent one does; the
    same verdicts and consistency counts in both packages."""
    inp, jcfg, jm, tcfg, tm = scaffold_maps(baseline=(0.0, 0.0, 0.0))
    tail = inp["n_kf"] - 1
    jl, tl = closers(vocab, min_inliers=20, exclude_recent=3, consistency_th=3)
    register(jl, jm, tail)
    register(tl, tm, tail)
    js, ts = LS.ScaffoldSlam(jm, inp["n_kf"]), LS.ScaffoldSlam(tm, inp["n_kf"])
    verdicts = []
    for k in range(4):
        if k:
            jl.db.erase(tail)
            tl.db.erase(tail)
        verdicts.append((jl.on_keyframe(js, tail), tl.on_keyframe(ts, tail)))
        if k < 3:
            assert [c for _, c in tl.consistent_groups] == [c for _, c in jl.consistent_groups]
            assert [g for g, _ in tl.consistent_groups] == [g for g, _ in jl.consistent_groups]
    assert verdicts == [(False, False)] * 3 + [(True, True)]
    assert tl.loops_closed == jl.loops_closed == 1


@pytest.mark.parametrize("baseline", [(0.0, 0.0, 0.0), LS.BASELINE])
def test_sim3_ladder_accepts_consistent(vocab, baseline):
    """``tests/test_loop_closing.py:216``: with camera context the ladder
    (SearchBySim3 + OptimizeSim3) verifies the loop; the correction's
    deferred fuses and GBA then drain (``finish_gba``)."""
    inp, jcfg, jm, tcfg, tm = scaffold_maps(baseline=baseline)
    tail = inp["n_kf"] - 1
    jl, tl = closers(vocab, min_inliers=20, exclude_recent=3, consistency_th=0)
    register(jl, jm, tail)
    register(tl, tm, tail)
    js, ts = LS.ScaffoldSlam(jm, inp["n_kf"], jcfg), LS.ScaffoldSlam(tm, inp["n_kf"], tcfg)
    assert jl.on_keyframe(js, tail) and tl.on_keyframe(ts, tail)
    assert tl.loop_edges == jl.loop_edges == [(tail, 0)]
    assert tl._post_fuse == jl._post_fuse == [0, tail]
    assert tl.active_gba is not None and jl.active_gba is not None
    assert tl.finish_gba(ts) and jl.finish_gba(js)
    err, before = LS.corrected_point_errors(ts.m.mp_pos.numpy(), inp)
    if any(baseline):
        _points_close(js.m, ts.m, inp)
        assert np.median(err) < 1e-3, np.median(err)
    else:
        assert np.median(err) < np.median(before)


def test_sim3_ladder_rejects_inconsistent_observations(vocab):
    """``tests/test_loop_closing.py:234``: garbage pixel observations in the
    candidate keyframe: RANSAC would accept, the reprojection stage rejects,
    in both packages."""
    inp, jcfg, jm, tcfg, tm = scaffold_maps(baseline=(0.0, 0.0, 0.0))
    tail = inp["n_kf"] - 1
    bad_xy = np.random.default_rng(2).uniform(0.0, 200.0, size=(inp["n_pts"], 2)).astype(np.float32)
    jm = jm._replace(kf_xy=jm.kf_xy.at[0].set(jnp.asarray(bad_xy)))
    tm = tm._replace(kf_xy=tm.kf_xy.clone())
    tm.kf_xy[0] = torch.from_numpy(bad_xy)
    jl, tl = closers(vocab, min_inliers=20, exclude_recent=3, consistency_th=0)
    register(jl, jm, tail)
    register(tl, tm, tail)
    js, ts = LS.ScaffoldSlam(jm, inp["n_kf"], jcfg), LS.ScaffoldSlam(tm, inp["n_kf"], tcfg)
    assert not jl.on_keyframe(js, tail) and not tl.on_keyframe(ts, tail)
    assert tl.loops_closed == jl.loops_closed == 0
    assert tl.pending is None and jl.pending is None


def test_service_background_slice_by_slice(vocab):
    """A correction's deferred work through the facade's
    ``_service_background``: the two queued fuses, then one GBA step per
    frame boundary until the merge, each slice against the JAX package's
    ``service_gba``; ``flush`` then has nothing left."""
    inp, jcfg, jm, tcfg, tm = scaffold_maps()
    tail = inp["n_kf"] - 1
    jl, tl = closers(vocab, min_inliers=20, exclude_recent=3, consistency_th=0)
    register(jl, jm, tail)
    register(tl, tm, tail)
    js, ts = LS.ScaffoldSlam(jm, inp["n_kf"], jcfg), LS.ScaffoldSlam(tm, inp["n_kf"], tcfg)
    assert jl.on_keyframe(js, tail) and tl.on_keyframe(ts, tail)
    ts.loop_closer = tl
    n_slices = 2 + tl.active_gba.n_iters + tl.active_gba.n_iters_final
    for k in range(n_slices):
        merged = jl.service_gba(js, n_steps=1)
        MonoSLAM._service_background(ts)
        assert (tl.active_gba is None) == merged == (k == n_slices - 1)
        _points_close(js.m, ts.m, inp)
        np.testing.assert_array_equal(ts.m.mp_valid.numpy(), np.asarray(js.m.mp_valid))
        np.testing.assert_array_equal(ts.m.kf_mp.numpy(), np.asarray(js.m.kf_mp))
    assert MonoSLAM.flush(ts) is ts and not tl._post_fuse and tl.active_gba is None


def test_correct_of_an_inertial_map_names_its_step(vocab):
    """A correction of a gravity-aligned inertial map (``imu_stage >= 1``,
    step 3) runs the 4-DoF graph in both packages: on the drifted map, with
    the loop edge (tail, 0) the ladder would hand over, the corrected poses
    and points agree within 1e-4, no keyframe's roll or pitch moves, the
    fuses are queued and (the scaffold has no inertial chain) a GBA starts."""
    inp, jcfg, jm, tcfg, tm = scaffold_maps()
    tail = inp["n_kf"] - 1
    tl = tlc.LoopCloser(vocab, max_keyframes=32, device=CPU)
    jl = jlc.LoopCloser(vocab, max_keyframes=32)
    ts = LS.ScaffoldSlam(tm, inp["n_kf"], tcfg)
    js = LS.ScaffoldSlam(jm, inp["n_kf"], jcfg)
    ts.imu_stage = js.imu_stage = 1
    # the loop Sim(3) of the ladder at fixed scale: the tail's true pose
    # relative to keyframe 0's, against its drifted one
    gr = LS.inertial_loop_graph(inp)
    R_loop, t_loop = gr["eR"][-1], gr["et"][-1]
    res_t = tlc.Sim3Result(success=torch.tensor(True), R=torch.from_numpy(R_loop),
                           t=torch.from_numpy(t_loop), s=torch.tensor(1.0), inliers=None,
                           n_inliers=torch.tensor(30))
    res_j = jlc.Sim3Result(success=jnp.asarray(True), R=jnp.asarray(R_loop),
                           t=jnp.asarray(t_loop), s=jnp.asarray(1.0, jnp.float32),
                           inliers=None, n_inliers=jnp.asarray(30))
    tl._correct(ts, tail, 0, res_t)
    jl._correct(js, tail, 0, res_j)
    a = jax.device_get(js.m)
    np.testing.assert_allclose(ts.m.kf_Rcw.numpy(), a.kf_Rcw, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.m.kf_tcw.numpy(), a.kf_tcw, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.m.mp_pos.numpy(), a.mp_pos, rtol=0, atol=1e-4)
    up_new, up_old = ts.m.kf_Rcw.numpy()[:, :, 2], tm.kf_Rcw.numpy()[:, :, 2]
    assert np.linalg.norm(up_new - up_old, axis=1).max() <= 1e-5
    assert float(np.abs(ts.m.kf_tcw.numpy() - tm.kf_tcw.numpy()).max()) > 0.05
    assert tl._post_fuse == jl._post_fuse == [0, tail]
    assert tl.active_gba is not None
    assert tlc._scale_fixed(ts) and tlc._scale_fixed(LS.ScaffoldSlam(tm, 2, dataclasses.replace(
        tcfg, bf=40.0))) and not tlc._scale_fixed(LS.ScaffoldSlam(tm, 2, tcfg))


# ---------------------------------------------------------------------------
# the facade: a monocular lap with loop closing on

@pytest.fixture(scope="module")
def loop_laps(frames):  # noqa: F811
    """(JAX system and its detections, port system and its detections,
    background slices run), loop closing on, ``flush()`` at the end."""
    kw = dict(CFG_KW, enable_loop_closing=True)
    js = jsys.MonoSLAM(JConfig(camera=JCamera(0, PARAMS), **kw))
    ts = MonoSLAM(dataclasses.replace(tcfg(), enable_loop_closing=True), device=CPU)
    ts._minimal_sets = jax_draws
    seen = {"jax": [], "port": [], "slices": 0}
    origs = {"jax": jlc.LoopCloser.start_detect, "port": tlc.LoopCloser.start_detect}

    def counting(pkg):
        def start_detect(self, slam, slot):
            seen[pkg].append(slot)
            return origs[pkg](self, slam, slot)
        return start_detect

    service = ts._service_background

    def counting_service():
        seen["slices"] += 1
        return service()

    ts._service_background = counting_service
    jlc.LoopCloser.start_detect = counting("jax")
    tlc.LoopCloser.start_detect = counting("port")
    try:
        drive(js, frames[1])
        js.flush()
        drive(ts, frames[1])
        ts.flush()
    finally:
        jlc.LoopCloser.start_detect = origs["jax"]
        tlc.LoopCloser.start_detect = origs["port"]
    return js, ts, seen


def test_loop_lap_flush_and_background(loop_laps, frames):  # noqa: F811
    js, ts, seen = loop_laps
    assert ts.loop_closer is not None and js.loop_closer is not None
    # every keyframe the mapper inserted after initialisation was queued for
    # detection and joined the database; flush left nothing queued
    assert seen["port"] and len(seen["port"]) == ts.kf_inserted
    assert len(seen["jax"]) == js.kf_inserted
    assert abs(ts.kf_inserted - js.kf_inserted) <= KF_MARGIN
    # (a keyframe culled since leaves the database at the next drain)
    assert set(np.flatnonzero(ts.loop_closer.db.present)) <= set(seen["port"])
    assert not ts._pending_loops and not js._pending_loops
    assert ts.loop_closer.loops_closed == js.loop_closer.loops_closed
    assert ts.loop_closer.active_gba is None and not ts.loop_closer._post_fuse
    # one background slice per frame boundary: every process and process_batch call
    assert seen["slices"] == 6 + len(range(6, len(frames[1]), 6))
    # relocalisation queries the loop closer's database
    assert ts._reloc_database() is ts.loop_closer.db and ts.reloc_db is None
    ate_j, init_j = _mono_ate(js, frames[0])
    ate_t, init_t = _mono_ate(ts, frames[0])
    tracked = [sum(r.state == OK for r in s.trajectory) for s in (js, ts)]
    assert init_t == init_j
    assert tracked[1] >= tracked[0] - TRACKED_MARGIN
    assert ate_t <= ATE_FACTOR * ate_j + ATE_SLACK_M, (ate_t, ate_j)
    assert abs(ts.n_kf - js.n_kf) <= KF_MARGIN


# ---------------------------------------------------------------------------
# the fixtures chip_smoke.py holds the card to

def _chip_smoke():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _check_sim3_records(cs, records):
    """Each stored Sim(3) RANSAC draw is what ``sim3_ransac`` draws from
    ``PRNGKey(slot)`` on the stored pair mask, sets of three distinct pairs;
    the smoke's stand-in hands them out for that slot and mask only."""
    import base64

    own = lambda valid, slot: torch.zeros((128, 3), dtype=torch.int64)
    draws = cs.fixture_sim3_draws(records, own)
    for r in records:
        mask = np.unpackbits(np.frombuffer(base64.b64decode(r["valid"]), np.uint8),
                             count=r["n"]).astype(bool)
        sets = np.frombuffer(base64.b64decode(r["sets"]), "<i2").reshape(r["shape"])
        np.testing.assert_array_equal(sets, jax_sim3_sets(mask, r["seed"]).numpy())
        assert r["seed"] == r["slot"] and r["n_valid"] == int(mask.sum())
        if r["n_valid"] >= 3:  # with fewer the draw has to name invalid pairs
            assert mask[sets].all()
        assert all(len(set(row)) == 3 for row in sets.tolist())
        assert np.array_equal(draws(torch.from_numpy(mask), r["slot"]).numpy(), sets)
        other = mask.copy()
        other[0] = not other[0]
        assert not draws(torch.from_numpy(other), r["slot"]).any()
    assert draws.stats["same_mask"] == len(records)


def test_loop_lap_fixture_is_the_jax_run():
    """``tests/fixtures/mono_loop_lap.json``: its frames are ``bench.py``'s
    pendulum lap (the wide arm's with 1.4 m excursions), each arm on its
    first ``LOOP_ARM_FRAMES``, its two-view and
    Sim(3) draws the JAX package's, and the JAX run's arms as
    ``chip_smoke.py`` holds them (a loop closed on the wide arm only, one
    detection per keyframe inserted after initialisation)."""
    import base64
    import os
    import sys

    cs = _chip_smoke()
    ref = cs.load_fixture(cs.LOOP_FIXTURE, cs.LOOP_FRAMES)
    sys.path.insert(0, os.path.join(os.path.dirname(cs.__file__), "scripts"))
    import torch_port_reference_lap as ref_lap

    poses = ref_lap.pendulum_poses(ref["frames"])
    rwc = np.frombuffer(base64.b64decode(ref["rwc_f32"]), "<f4").reshape(-1, 3, 3)
    twc = np.frombuffer(base64.b64decode(ref["twc_f64"]), "<f8").reshape(-1, 3)
    np.testing.assert_array_equal(rwc, np.stack([R for R, _ in poses]))
    np.testing.assert_array_equal(twc, np.stack([t for _, t in poses]))
    for arm in ("loop_off", "loop_on", "loop_wide"):
        r = ref[arm]
        assert r["frames"] == ref_lap.LOOP_ARM_FRAMES[arm] == len(r["states"]) <= ref["frames"]
        assert (r["loops_closed"] == 0) == (arm != "loop_wide")
        assert r["tracked"] >= 0.95 * r["frames"] and r["init_draws"]
        draws = cs.fixture_draws(r)
        for d in r["init_draws"]:
            sets = np.frombuffer(base64.b64decode(d["sets"]), "<i2").reshape(d["shape"])
            packed = np.frombuffer(base64.b64decode(d["matched"]), np.uint8).reshape(
                d["shape"][0], -1)
            masks = np.unpackbits(packed, axis=-1, count=d["n"]).astype(bool)
            assert np.array_equal(draws(torch.from_numpy(masks), d["seed"]).numpy(), sets)
    on = ref["loop_on"]
    assert len(on["detections"]) == on["kf_inserted"] and not ref["loop_off"]["detections"]
    assert len(on["sim3_ransac"]) == len(on["sim3_refine"]) > 0
    _check_sim3_records(cs, on["sim3_ransac"])
    # the wide arm: 1.4 m excursions, its own poses, a loop closed
    wide = ref["loop_wide"]
    poses = ref_lap.pendulum_poses(ref["frames"], wide["amplitude"])[:wide["frames"]]
    rwc = np.frombuffer(base64.b64decode(wide["rwc_f32"]), "<f4").reshape(-1, 3, 3)
    twc = np.frombuffer(base64.b64decode(wide["twc_f64"]), "<f8").reshape(-1, 3)
    np.testing.assert_array_equal(rwc, np.stack([R for R, _ in poses]))
    np.testing.assert_array_equal(twc, np.stack([t for _, t in poses]))
    assert wide["loops_closed"] == len(wide["accepted"]) >= 1
    assert len(wide["detections"]) == wide["kf_inserted"]
    _check_sim3_records(cs, wide["sim3_ransac"])
    # every refinement names its keyframes' frames, the current one a
    # detection's; the accepted loop is one of them
    for r in (on, wide):
        current = {h["frames"][0] for h in r["sim3_refine"]}
        assert current <= {d["frame_id"] for d in r["detections"]}
    accepted = [a["frames"] for a in wide["accepted"]]
    assert all(any(r["frames"] == a and r["n_inliers"] >= cs.SIM3_MIN_INLIERS
                   for r in wide["sim3_refine"]) for a in accepted)


def _rot_y(deg: float) -> np.ndarray:
    """A rotation of ``deg`` degrees about the camera's y axis."""
    a = np.radians(deg)
    return np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]])


@pytest.mark.parametrize("case", ["jax_loop", "jax_hypothesis", "turned", "elsewhere", "extra"])
def test_loop_holds(case):
    """``chip_smoke.check_loop_arm`` on the wide arm of the fixture: a loop
    passes where the JAX run's ladder put it forward (its accepted loop, or
    a refinement that kept the gate's inliers) with the same rotation, and
    fails turned 2 degrees away, at a place the ladder never refined, or as
    one loop more than the JAX run closed."""
    cs = _chip_smoke()
    ref = cs.load_fixture(cs.LOOP_FIXTURE, cs.LOOP_FRAMES)["loop_wide"]
    strong = [r for r in ref["sim3_refine"] if r["n_inliers"] >= cs.SIM3_MIN_INLIERS]
    kept = next(r for r in strong if r["frames"] == ref["accepted"][0]["frames"])
    early = min(strong, key=lambda r: r["frames"][0])
    turn = _rot_y(2.0)
    loop = {"jax_loop": kept, "jax_hypothesis": early, "turned": kept, "elsewhere": kept,
            "extra": kept}[case]
    R = np.asarray(loop["R"]) @ (turn if case == "turned" else np.eye(3))
    frames = [loop["frames"][0] - 40, 200] if case == "elsewhere" else loop["frames"]
    got = {"init_frame": ref["init_frame"], "tracked": ref["tracked"], "ate_m": ref["ate_m"],
           "loop_closing": True, "kf_inserted": ref["kf_inserted"],
           "detections": ref["kf_inserted"],
           "accepted": [{"frames": frames, "R": R.tolist()}] * (2 if case == "extra" else 1)}
    got["loops_closed"] = len(got["accepted"])
    if case in ("jax_loop", "jax_hypothesis") and abs(
            loop["frames"][1] - ref["accepted"][0]["frames"][1]) <= cs.LOOP_FRAME_MARGIN:
        cs.check_loop_arm("wide", got, ref)
        assert got["accepted"][0]["jax_hypothesis"]["rot_diff_deg"] < 1e-3
    else:
        with pytest.raises(AssertionError):
            cs.check_loop_arm("wide", got, ref)


def test_loop_correction_fixture_is_the_jax_run():
    """``tests/fixtures/loop_correction_full.json``: the full-width scaffold's
    loop (63, 0) at scale 1.12, its RANSAC draws the JAX package's, points
    corrected to within 1e-6 m of the truth."""
    import base64

    cs = _chip_smoke()
    with open(cs.CORRECTION_FIXTURE) as f:
        ref = json.load(f)
    assert ref["closed"] and [(a["slot"], a["cand"]) for a in ref["accepted"]] == [(63, 0)]
    assert abs(ref["sim3_refine"][0]["s"] - LS.DRIFT_SCALE) < 1e-4
    assert ref["median_err_m"] < 1e-6 < ref["median_drift_m"]
    _check_sim3_records(cs, ref["sim3_ransac"])
    inp = LS.drifted_map_inputs(seed=ref["seed"], baseline=tuple(ref["baseline"]), **LS.FULL)
    pts = np.frombuffer(base64.b64decode(ref["mp_pos"]), "<f4").reshape(-1, 3)
    err, _ = LS.corrected_point_errors(pts, inp)
    assert float(np.median(err)) == pytest.approx(ref["median_err_m"], rel=1e-6)
