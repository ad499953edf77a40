"""The result line's keys, the judge, the exit without a card, and that no
module the harness loads is JAX's or the JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

import torch

from slam_bench import harness, run

ROOT = Path(__file__).resolve().parents[2]


def outcome(trace=None):
    return harness.Outcome({"setup_s": 12.5, "frames_per_s": 6.25}, attempted=160, failed=1,
                           compared={"rpe_deg": 0.01, "orb_mismatch": 0.0},
                           memory_peak_bytes=123, trace=trace,
                           notes={"frames": 160, "latencies_ms": [1.0, 2.0]})


def test_result_line_keys():
    cell = harness.load_cell("euroc_stereo.replay_b16", ROOT)
    cell.limits = {"rpe_deg": 0.02, "orb_mismatch": 0.0}
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 123}
    res, rows = run.result_line(cell, outcome(), dev, 0)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "notes",
                         "checks"]
    assert res["correct"] is True and res["attempted"] == 160 and res["failed"] == 1
    assert res["metrics"] == {"setup_s": {"value": 12.5, "unit": "s"},
                              "frames_per_s": {"value": 6.25, "unit": "frames/s"}}
    assert res["checks"] == {"rpe_deg": {"value": 0.01, "limit": 0.02},
                             "orb_mismatch": {"value": 0.0, "limit": 0.0}}
    json.dumps(res)

    trace = {"window_s": 4.0, "busy_s": 0.5, "ranges": {"track_batch": [1.0, 2.0]},
             "launches": 3200, "d2h_copies": 64, "kernels": {"k": [0.25, 0.25]},
             "idle_gaps": [("track_batch", 0.1)], "frames": 32, "expected": {}}
    res, _ = run.result_line(cell, outcome(trace), dev, 1)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "notes", "checks"]
    assert res["device"]["busy_s"] == 0.5 and res["device"]["window_s"] == 4.0
    assert res["metrics"]["idle_share.replay"] == {"value": 87.5, "unit": "%"}
    assert res["metrics"]["launches_per_frame.replay"]["value"] == 100.0
    assert res["metrics"]["track_ms_per_frame.replay"]["value"] == 3000.0 / 32
    assert res["breakdown"] == {"device_ops": [["k", 0.5]], "idle_gaps": [["track_batch", 0.1]]}


def test_judge():
    ok, _ = harness.judge({"a": 0.1, "b": 0}, {"a": 0.2, "b": 0})
    assert ok
    assert not harness.judge({"a": 0.3}, {"a": 0.2})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 0.2})[0]
    assert not harness.judge({"a": float("inf")}, {"a": 0.2})[0]
    assert not harness.judge({"a": 0.1}, {"a": 0.2, "b": 1})[0]  # a limit without its number
    assert not harness.judge({"a": 0.1, "c": 0.0}, {"a": 0.2})[0]  # a number without a limit


def test_no_card_no_result():
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "slam_bench/run.py", "--workload",
                        "euroc_stereo.replay_b16", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_forbidden_names_compared_whole():
    sys.modules["orb_slam3_noted_tpu_torchlike"] = sys
    try:
        assert harness.loaded_forbidden() == []
        sys.modules["orb_slam3_noted_tpu.ops"] = sys
        assert harness.loaded_forbidden() == ["orb_slam3_noted_tpu"]
    finally:
        sys.modules.pop("orb_slam3_noted_tpu_torchlike")
        sys.modules.pop("orb_slam3_noted_tpu.ops", None)


def test_harness_loads_no_jax():
    code = (
        "import sys, importlib; sys.path.insert(0, '.')\n"
        "from slam_bench import harness\n"
        "mods = ['slam_bench.run', 'slam_bench.control', 'slam_bench.drivers.stereo',"
        " 'slam_bench.drivers.gba', 'slam_bench.reference.frontend',"
        " 'slam_bench.reference.gba', 'slam_bench.reference.poses', 'slam_bench.trace',"
        " 'orb_slam3_noted_tpu_torch.pipeline.system', 'orb_slam3_noted_tpu_torch.optim.gba',"
        " 'orb_slam3_noted_tpu_torch.io.config', 'orb_slam3_noted_tpu_torch.optim.ba']\n"
        "[importlib.import_module(m) for m in mods]\n"
        "for w in harness.load_benchmark()['per_layer']: harness.metric_reader(w['name'])\n"
        "print(harness.loaded_forbidden())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
