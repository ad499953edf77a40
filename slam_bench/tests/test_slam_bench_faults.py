"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and each cell's driver runs on the
CPU, at the configuration's widths with a short sequence (stereo) or a
smaller map (GBA), once sound and once for each fault of ``faults.py`` the
cell can have: a step that returns its state unchanged, a pose reported
stale or as the motion model's prediction, half of the batch left out, an
answer altered where it is produced.  (No cell runs across chips, so none
has an exchange to leave out.)"""

import types
from pathlib import Path

import pytest
import torch

from slam_bench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
# a window of one step after four warm-up frames; the relative pose error
# over 4 frames (0.2 s) pairs the window's frames with the warm-up's
SHORT = {"euroc_stereo.replay_b16": {"batch": 4, "warm_frames": 4, "checked": 1,
                                     "rpe_lag_s": 0.2},
         "euroc_stereo.live_f1": {"warm_frames": 4, "checked": 1, "rpe_lag_s": 0.2},
         "euroc_stereo.gba_256kf": {"keyframes": 16, "points": 1000, "per_kf": 200,
                                    "warm_calls": 1}}
# a stale or predicted pose from the first tracked frame on: in a window this
# short, one from the window's start has not drifted yet (the card's
# readings, PERF.md, plant them at the window's start)
POSE_FAULTS = ("stale_pose", "predicted_pose")


def run_cell(monkeypatch, name: str, fault: str):
    torch.set_num_threads(4)
    cell = harness.load_cell(name, ROOT)
    cell.traffic = dict(cell.traffic, **SHORT[name])
    if fault != "sound":
        faults.plant(monkeypatch, cell, fault, start=1 if fault in POSE_FAULTS else None)
    args = types.SimpleNamespace(seed=2 ** 31 + 17, seconds=0.01, trace=0)
    out = harness.driver(cell).run(cell, args, harness.Spans(), device="cpu")
    return harness.judge(out.compared, cell.limits)[0], out, cell


@pytest.mark.parametrize("fault", ("sound",) + faults.STEREO)
@pytest.mark.parametrize("name", ["euroc_stereo.replay_b16", "euroc_stereo.live_f1"])
def test_stereo_fault(monkeypatch, name, fault):
    correct, out, cell = run_cell(monkeypatch, name, fault)
    assert correct == (fault == "sound"), out.compared
    if fault in POSE_FAULTS:
        # the frames stay tracked: the relative pose error alone catches it
        assert out.failed == 0 and out.compared["poses_missing"] == 0, out.compared
        assert out.compared["rpe_mm"] > cell.limits["rpe_mm"], out.compared
        assert out.compared["rpe_deg"] > cell.limits["rpe_deg"], out.compared


@pytest.mark.parametrize("fault", ("sound",) + faults.GBA)
def test_gba_fault(monkeypatch, fault):
    correct, out, _ = run_cell(monkeypatch, "euroc_stereo.gba_256kf", fault)
    assert correct == (fault == "sound"), out.compared
