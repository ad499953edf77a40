"""The port's span and counter recorder (``orb_slam3_noted_tpu_torch/utils/
timing.py``): its stamps on the profiler's clock, nothing kept and no
profiler event made while it and the profiler are off, parent links and
frame ids per thread, the counters of a CPU stereo batch lap against the
facade's own state (and the lap the same bit for bit with the recorder on),
the GBA's spans, the metric stream and saturation counters that read it,
and the benchmark's readers of what it keeps."""

import json
import sys
import threading
import time
import timeit
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu_torch.io.config import SlamConfig
from orb_slam3_noted_tpu_torch.models.cameras import PINHOLE, Camera
from orb_slam3_noted_tpu_torch.pipeline.system import StereoSLAM
from orb_slam3_noted_tpu_torch.utils import timing
from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair
from orb_slam3_noted_tpu_torch.utils.timing import RECORDER, Recorder, count, span

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CLOCK_TOL_NS = 500_000  # 0.5 ms between a span's stamps and the profiler's

# the lap of tests/test_torch_stereo_batch.py, with the re-track after a
# mid-batch keyframe on and keyframes close together so that it runs
W, H = 320, 240
FX = 260.0
BASELINE = 0.12
PARAMS = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
CFG_KW = dict(width=W, height=H, n_features=600, bf=FX * BASELINE, th_depth=35.0,
              max_keyframes=32, max_map_points=4096, local_window=5, kf_max_interval=4,
              kf_min_interval=1, retrack_after_kf=True)
N_FRAMES, BATCH = 13, 6
CPU = torch.device("cpu")


@pytest.fixture
def recorder():
    """The process's recorder, emptied and on; off and emptied after."""
    old = Recorder.enabled
    RECORDER.reset()
    Recorder.enabled = True
    try:
        yield RECORDER
    finally:
        Recorder.enabled = old
        RECORDER.reset()


def test_span_stamps_lie_on_the_profilers_clock(recorder):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for k in range(3):
            with span("tracing_outer", frame=k):
                with span("tracing_inner"):
                    torch.ones(64).sum()
                time.sleep(0.001)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() in ("tracing_outer", "tracing_inner")),
                    key=lambda e: e.start_ns())
    kept = sorted(recorder.spans, key=lambda s: s.start_ns)
    assert [e.name() for e in events] == [s.name for s in kept] and len(kept) == 6
    for e, s in zip(events, kept):
        assert abs(e.start_ns() - s.start_ns) < CLOCK_TOL_NS
        assert abs(e.end_ns() - s.end_ns) < CLOCK_TOL_NS
        assert s.start_ns <= s.end_ns


def test_nothing_kept_and_no_profiler_event_while_both_are_off(monkeypatch):
    monkeypatch.setattr(Recorder, "enabled", False)
    assert not torch.autograd._profiler_enabled()

    def refuse(*a, **kw):
        raise AssertionError("a profiler range was made")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    n_spans, counters = len(RECORDER.spans), dict(RECORDER.counters)
    with span("tracing_off", frame=1) as s:
        s.set(wide=True)
        count("tracing_off_count")
        with timing.device_read():
            pass
    assert len(RECORDER.spans) == n_spans and dict(RECORDER.counters) == counters
    assert span("tracing_off") is timing._OFF


def test_off_span_costs_less_than_a_bare_profiler_range():
    """With nothing recording, a span costs a flag check: less than a bare
    ``record_function`` (each the best of five rounds)."""
    def off():
        with span("tracing_cost"):
            pass

    def bare():
        with torch.profiler.record_function("tracing_cost"):
            pass

    n = 2000
    t_off = min(timeit.repeat(off, number=n, repeat=5))
    t_bare = min(timeit.repeat(bare, number=n, repeat=5))
    assert t_off < t_bare, (t_off / n, t_bare / n)


def test_parents_and_frame_ids_per_thread(recorder):
    """Two threads track frames at once: each span's parent is the span
    open around it in its own thread, and every span of a frame carries
    that frame's id; the counters lose no update."""
    n_threads, n_frames = 8, 40
    start = threading.Barrier(n_threads)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def track(tid):
        start.wait(timeout=30)
        for f in range(n_frames):
            with span("frame", frame=(tid, f)):
                with span("track_frame") as s:
                    with span("match_local_map"):
                        count("tracing_calls")
                    s.set(wide=f % 2 == 0)
                with span("after_track"):
                    count("tracing_calls")

    try:
        threads = [threading.Thread(target=track, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    by_id = {s.id: s for s in recorder.spans}
    assert len(by_id) == len(recorder.spans) == n_threads * n_frames * 4
    assert recorder.counters["tracing_calls"] == 2 * n_threads * n_frames
    up = {"track_frame": "frame", "after_track": "frame", "match_local_map": "track_frame"}
    for s in recorder.spans:
        if s.name == "frame":
            assert s.parent is None
            continue
        parent = by_id[s.parent]
        assert parent.name == up[s.name]
        assert s.attrs["frame"] == parent.attrs["frame"]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        if s.name == "track_frame":
            assert s.attrs["wide"] == (s.attrs["frame"][1] % 2 == 0)
    assert {s.attrs["frame"] for s in recorder.spans} == {
        (t, f) for t in range(n_threads) for f in range(n_frames)}


@pytest.fixture(scope="module")
def pairs():
    room = BoxRoom(seed=0)
    out = []
    for R, t in orbit_trajectory(48, forward=0.03, yaw0=0.45)[:N_FRAMES]:
        left, right, _ = stereo_pair(room, R, t, PARAMS, W, H, BASELINE)
        out.append((left.astype(np.uint8), right.astype(np.uint8)))
    return out


def lap(pairs):
    """The batch lap with the facade's dispatches spied on: (facade, the
    sizes of the tracking dispatches, the frames each re-track counted)."""
    torch.set_num_threads(1)
    slam = StereoSLAM(SlamConfig(camera=Camera(PINHOLE, PARAMS), **CFG_KW), device=CPU)
    dispatched, retracked = [], []
    batch_track, batch_retrack = slam._batch_track, slam._batch_retrack

    def spy_track(prep, vel, cm):
        dispatched.append(cm.numel())
        return batch_track(prep, vel, cm)

    def spy_retrack(rolled, aux, vel, cm):
        dispatched.append(cm.numel())
        retracked.append(int(cm.sum()))
        return batch_retrack(rolled, aux, vel, cm)

    slam._batch_track, slam._batch_retrack = spy_track, spy_retrack
    slam.process(pairs[0][0], pairs[0][1], 0)
    for i in range(1, N_FRAMES, BATCH):
        ids = list(range(i, min(i + BATCH, N_FRAMES)))
        slam.process_batch([pairs[j] for j in ids], ids)
    return slam, dispatched, retracked


def test_stereo_lap_counters_match_the_facade_and_poses_are_unchanged(pairs):
    old = Recorder.enabled
    Recorder.enabled = False
    try:
        plain, _, _ = lap(pairs)
        RECORDER.reset()
        Recorder.enabled = True
        slam, dispatched, retracked = lap(pairs)
        c = dict(RECORDER.counters)
        spans = list(RECORDER.spans)
    finally:
        Recorder.enabled = old
        RECORDER.reset()
    assert retracked, "no mid-batch keyframe sent frames back: the lap tests nothing"
    assert c["frames"] == len(slam.trajectory) == N_FRAMES
    assert c["keyframes_inserted"] == slam.kf_inserted >= 2
    assert c["frames_retracked"] == sum(retracked)
    assert c["track_calls"] == sum(dispatched)
    wide = sum(1 for s in spans if s.name == "track_frame" and s.attrs.get("wide"))
    assert c.get("track_wide_search", 0) == wide
    assert sum(1 for s in spans if s.name == "track_frame") == c["track_calls"]
    assert sum(1 for s in spans if s.name == "mapper_pass") == slam.kf_inserted
    assert c["device_reads"] == sum(1 for s in spans if s.name == timing.DEVICE_READ)
    # every span of a batch call carries the batch's first frame id and size
    roots = [s for s in spans if s.name == "frame"]
    assert [s.attrs["frame"] for s in roots] == [0, 1, 7]
    assert all(s.attrs["frames"] == (1 if s.attrs["frame"] == 0 else 6)
               for s in spans if s.name in ("local_ba", "stereo_matching"))
    assert len(plain.trajectory) == len(slam.trajectory)
    for a, b in zip(plain.trajectory, slam.trajectory):
        assert (a.frame_id, a.state, a.n_inliers) == (b.frame_id, b.state, b.n_inliers)
        assert np.array_equal(a.Rcw, b.Rcw) and np.array_equal(a.tcw, b.tcw)
    assert torch.equal(plain.m.mp_pos, slam.m.mp_pos)


def test_gba_spans_carry_the_call_index(recorder):
    from slam_bench.drivers import gba as bench_gba

    from orb_slam3_noted_tpu_torch.optim.gba import global_bundle_adjust

    gen = torch.Generator().manual_seed(3)
    traffic = {"keyframes": 8, "points": 200, "per_kf": 60, "orbit_m": 14.0, "pix_noise": 0.5}
    params = PARAMS
    prob = bench_gba.port_problem(bench_gba.capacity_map(gen, CPU, traffic, params))
    for _ in range(2):
        global_bundle_adjust(Camera(PINHOLE, params), prob, n_iters=3, n_iters_final=2,
                             cg_iters=4)
    spans = recorder.spans
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.name == "global_ba"]
    assert len(roots) == 2 and roots[0].attrs["call"] != roots[1].attrs["call"]
    assert recorder.counters["gba_lm_steps"] == 10
    steps = [s for s in spans if s.name == "gba_lm_step"]
    assert len(steps) == 10
    for s in spans:
        if s.name in ("gba_linearize", "gba_schur", "gba_pcg", "gba_update"):
            assert by_id[s.parent].name == "gba_lm_step"
        if s.name in ("gba_lm_step", "gba_reclassify"):
            assert by_id[s.parent].name == "global_ba"
            assert s.attrs["call"] == by_id[s.parent].attrs["call"]
    assert sum(s.name == "gba_pcg" for s in spans) == 10


def test_metrics_stream_lines_carry_the_recorders_spans_and_counters(recorder, tmp_path):
    path = tmp_path / "metrics.jsonl"
    ms = timing.MetricsStream(str(path))
    for _ in range(2):
        with span("track_frame"):
            count("track_calls")
    count("track_wide_search")
    ms.emit("dispatch", frame=0)
    with span("local_ba"):
        pass
    ms.emit("final")
    ms.close()
    recs = [json.loads(x) for x in open(path)]
    assert recs[0]["stages"]["track_frame"]["n"] == 2
    assert recs[0]["counters"] == {"track_calls": 2, "track_wide_search": 1}
    assert list(recs[1]["stages"]) == ["local_ba"] and "counters" not in recs[1]


def test_saturation_counters_are_recorder_counters_counted_while_off(monkeypatch, capsys):
    monkeypatch.setattr(Recorder, "enabled", False)
    try:
        timing.report_saturation("tracing_cap", torch.tensor(3))
        timing.report_saturation("tracing_cap", 2)
        timing.report_saturation("tracing_cap", 0)
        assert RECORDER.counters["saturation.tracing_cap"] == 5
        assert timing.SATURATION["tracing_cap"] == 5 and "tracing_cap" in timing.SATURATION
        assert timing.SATURATION["tracing_never"] == 0
        assert "tracing_never" not in timing.SATURATION
        assert capsys.readouterr().err.count("[saturation] tracing_cap") == 1
    finally:
        timing.SATURATION.pop("tracing_cap", None)
    assert "tracing_cap" not in timing.SATURATION


READERS = {
    # name: the value the synthetic recording below gives
    "track_ms_per_frame.live": (2.0 + 4.0) / 4,
    "stereo_ms_per_frame.replay": 3.0 / 4,
    "retracked_share.replay": 100.0 * 2 / 4,
    "wide_search_share.replay": 100.0 * 1 / 8,
    "sync_wait_ms_per_frame.replay": (0.5 + 1.5) / 4,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_bench_reader_of_the_recorder(recorder, name):
    from slam_bench.harness import metric_reader

    read = metric_reader(name, ROOT)
    traced = {"trace": {"frames": 4}, "notes": {}}
    assert read({"trace": None, "notes": {}}) is None
    assert read(traced) is None  # nothing recorded
    ms = 1_000_000
    for name_, dur, frames in (("track_frame", 2, 6), ("track_frame", 4, 6),
                               ("stereo_matching", 3, 6), ("stereo_matching", 5, 1),
                               ("local_ba", 10, 6), ("local_ba", 30, 6),
                               ("device_read", 0.5, 6), ("device_read", 1.5, 6)):
        recorder.add(name_, 0, int(dur * ms), frames=frames)
    recorder.counters.update(frames=4, frames_retracked=2, track_calls=8, track_wide_search=1)
    assert read(traced) == pytest.approx(READERS[name])
    assert read({"trace": None, "notes": {}}) is None


def test_trace_join_puts_times_down_to_the_innermost_span():
    """``scripts/torch_port_trace_join.py``'s timeline: each instant goes to
    the innermost span open over it, ends before starts at a shared stamp."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_trace_join", ROOT / "scripts" / "torch_port_trace_join.py")
    join = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(join)
    S = timing.Span
    spans = [S(0, "frame", 0, 100, None, {}), S(1, "track_frame", 10, 40, 0, {}),
             S(2, "match_local_map", 12, 20, 1, {}), S(3, "after_track", 40, 90, 0, {}),
             S(4, "device_read", 50, 60, 3, {})]
    line = join.innermost_timeline(spans)
    got = [join.label_at(line, t) for t in (-1, 5, 11, 15, 25, 40, 55, 70, 95, 100)]
    assert got == ["outside_spans", "frame", "track_frame", "match_local_map", "track_frame",
                   "after_track", "device_read", "after_track", "frame", "outside_spans"]
