"""A cell is found from its files by name: a configuration, a traffic mix,
limits and a per-layer metric added as new files and new ``BENCHMARK.json``
entries are run without an edit to any file already there."""

import hashlib
import json
import shutil
from pathlib import Path

from slam_bench import harness

ROOT = Path(__file__).resolve().parents[2]


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_every_cell_loads():
    bench = harness.load_benchmark(ROOT)
    known = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:  # every per-layer metric names the cells that report it
        assert m["workloads"] and set(m["workloads"]) <= known, m["name"]
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        assert cell.chips == w["chips"] and cell.limits and cell.per_layer
        assert harness.driver(cell).run
        for m in cell.per_layer:
            assert harness.metric_reader(m["name"], ROOT)({"trace": None, "notes": {}}) is None


def test_new_files_make_a_new_cell(tmp_path):
    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "slam_bench")
    here = tmp_path / "slam_bench"
    conf = json.loads((here / "configs" / "euroc_stereo.json").read_text())
    conf["name"] = "euroc_stereo_lowfeat"
    conf["orb"]["n_features"] = 1000
    (here / "configs" / "euroc_stereo_lowfeat.json").write_text(json.dumps(conf))
    mix = json.loads((here / "traffic" / "replay_b16.json").read_text())
    mix["batch"] = 8
    (here / "traffic" / "replay_b8.json").write_text(json.dumps(mix))
    (here / "limits" / "euroc_stereo_lowfeat.replay_b8.json").write_text(
        json.dumps({"rpe_deg": 0.1}))
    (here / "metrics" / "frames_traced.replay.py").write_text(
        "def read(ctx):\n    t = ctx['trace']\n    return t['frames'] if t else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "euroc_stereo_lowfeat", "source": "https://example.org",
                             "file": "slam_bench/configs/euroc_stereo_lowfeat.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "euroc_stereo_lowfeat.replay_b8",
                               "config": "euroc_stereo_lowfeat", "traffic": "replay_b8",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("euroc_stereo_lowfeat.replay_b8")
    bench["per_layer"].append({"name": "frames_traced.replay", "unit": "frames",
                               "better": "higher", "source": "program_counter", "layer": "Facade",
                               "moves": "frames_per_s",
                               "workloads": ["euroc_stereo_lowfeat.replay_b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("euroc_stereo_lowfeat.replay_b8", tmp_path)
    assert cell.config["orb"]["n_features"] == 1000 and cell.traffic["batch"] == 8
    assert cell.limits == {"rpe_deg": 0.1}
    assert [m["name"] for m in cell.per_layer] == ["frames_traced.replay"]
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
    reader = harness.metric_reader("frames_traced.replay", tmp_path)
    assert reader({"trace": {"frames": 32}, "notes": {}}) == 32
    after = digest(tmp_path / "slam_bench")
    assert all(after[k] == v for k, v in before.items())
    assert len(after) == len(before) + 4
