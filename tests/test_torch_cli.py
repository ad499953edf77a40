"""The port's CLI against the JAX package's on the CPU: ``resolve_mode`` and
``build_system``, a 16-frame 320x240 EuRoC stereo layout through both CLIs
(``--eval --metrics --times --checkpoint-out``), and the faults of the JAX
CLI that the port does not repeat, each shown in both packages:

- a rectification block the driver cannot use: the JAX CLI drops it and
  runs unrectified (``cli.py:148-156``), the port raises;
- ``--eval`` over several ``--seq``: the JAX CLI holds every frame to the
  last sequence's ground truth (``cli.py:261-282``), the port each frame to
  its own sequence's;

``fisheye-stereo --batch > 1`` goes to ``process_batch`` in both
(``cli.py:163-164``): the fault there is the JAX facade's batch hooks,
which the port's facade does not share.  And ``--atlas --checkpoint-out``, which fails in both (the port with a
``TypeError`` naming the Atlas: ROADMAP Queue 3, fault (c)).  The fault
cases drive a stand-in facade that records its calls.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from orb_slam3_noted_tpu import cli as jcli
from orb_slam3_noted_tpu.io.config import SlamConfig as JConfig
from orb_slam3_noted_tpu.models.cameras import Camera as JCamera
from orb_slam3_noted_tpu.utils.synthetic import BoxRoom, orbit_trajectory, stereo_pair
from orb_slam3_noted_tpu_torch import cli as tcli
from orb_slam3_noted_tpu_torch.io import images
from orb_slam3_noted_tpu_torch.io.config import config_from

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import cli_layouts  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
W, H, FX, BASELINE, FPS, N_FRAMES = 320, 240, 260.0, 0.12, 20.0, 16
TRACKED_SLACK = 1          # tracked frames within 1 of the JAX CLI's
ATE_SLACK_M = 0.002        # ATE <= 2 x JAX + 2 mm


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


def run(cli, argv, capsys, device=True):
    """``cli.main`` in this process; its last stdout line as JSON."""
    extra = ["--device", "cpu"] if cli is tcli and device else []
    capsys.readouterr()
    cli.main(argv + extra)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# resolve_mode and build_system

@pytest.mark.parametrize("mode", tcli.MODES)
@pytest.mark.parametrize("fisheye", [False, True])
def test_resolve_mode(mode, fisheye):
    cam2 = JCamera(1, (190.0, 190.0, 256.0, 256.0, 0.0, 0.0, 0.0, 0.0)) if fisheye else None
    cfg = JConfig(camera2=cam2)
    assert tcli.resolve_mode(config_from(cfg), mode) == jcli.resolve_mode(cfg, mode)


@pytest.mark.parametrize("mode,atlas", [("mono", False), ("stereo", False), ("rgbd", False),
                                        ("mono-inertial", False), ("stereo-inertial", False),
                                        ("fisheye-stereo", False),
                                        ("fisheye-stereo-inertial", False), ("stereo", True),
                                        ("mono-inertial", True)])
def test_build_system(mode, atlas):
    """The same facade class (or Atlas over it) as the JAX CLI builds, on
    the device asked for; ``fix_scale`` where the settings have a baseline."""
    cam2 = JCamera(1, (190.0, 190.0, 256.0, 256.0, 0.0, 0.0, 0.0, 0.0))
    cfg = JConfig(width=64, height=48, n_features=64, max_keyframes=4, max_map_points=64,
                  bf=20.0, camera2=cam2 if mode.startswith("fisheye") else None)
    j = jcli.build_system(cfg, mode, atlas=atlas)
    t = tcli.build_system(config_from(cfg), mode, atlas=atlas, device="cpu")
    assert type(t).__name__ == type(j).__name__
    if atlas:
        assert type(t.active).__name__ == type(j.active).__name__
        assert getattr(t, "fix_scale", None) == getattr(j, "fix_scale", None)
        t = t.active
    assert t.device == torch.device("cpu")


@pytest.mark.parametrize("mode,batch,atlas,want", [
    ("stereo", 8, False, 8), ("stereo-inertial", 16, False, 16), ("mono", 4, False, 4),
    ("mono-inertial", 8, False, 1), ("rgbd", 8, False, 1), ("fisheye-stereo", 8, False, 8),
    ("fisheye-stereo-inertial", 8, False, 8), ("stereo", 8, True, 1), ("stereo", 0, False, 1)])
def test_frame_batch(mode, batch, atlas, want):
    assert tcli.frame_batch(mode, batch, atlas) == want


# ---------------------------------------------------------------------------
# a stereo EuRoC layout through both CLIs

@pytest.fixture(scope="module")
def euroc_layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("euroc")
    room = BoxRoom(seed=3)
    poses = orbit_trajectory(N_FRAMES, forward=0.03)
    cam = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
    pairs = [tuple(x.astype(np.uint8) for x in stereo_pair(room, R, t, cam, W, H, BASELINE)[:2])
             for R, t in poses]
    cli_layouts.write_euroc(str(root / "seq"), pairs, cli_layouts.frame_ns(N_FRAMES, FPS),
                            np.stack([t for _, t in poses]), images.write_png)
    settings = root / "settings.yaml"
    settings.write_text(
        '%YAML:1.0\nCamera.type: "PinHole"\n'
        f"Camera.fx: {FX}\nCamera.fy: {FX}\nCamera.cx: {W / 2 - 0.5}\nCamera.cy: {H / 2 - 0.5}\n"
        f"Camera.width: {W}\nCamera.height: {H}\nCamera.fps: {FPS}\nCamera.bf: {FX * BASELINE}\n"
        "ThDepth: 35.0\nORBextractor.nFeatures: 600\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n")
    return root


@pytest.fixture(scope="module")
def both_runs(euroc_layout):
    """Each CLI once over the layout; (result, trajectory rows, metric
    lines, checkpoint {key: dtype}) per package."""
    import contextlib
    import io

    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        d = euroc_layout / name
        d.mkdir()
        argv = ["--dataset", "euroc", "--seq", str(euroc_layout / "seq"), "--settings",
                str(euroc_layout / "settings.yaml"), "--mode", "stereo", "--out",
                str(d / "traj.txt"), "--eval", "--metrics", str(d / "metrics.jsonl"), "--times",
                "--checkpoint-out", str(d / "map.npz")]
        if cli is tcli:
            argv += ["--device", "cpu"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            cli.main(argv)
        result = json.loads(buf.getvalue().strip().splitlines()[-1])
        with np.load(d / "map.npz") as z:
            ck = {k: str(z[k].dtype) for k in z.files}
        out[name] = (result, np.loadtxt(d / "traj.txt", ndmin=2),
                     [json.loads(x) for x in open(d / "metrics.jsonl")], ck)
    return out


def test_cli_euroc_stereo_layout(both_runs):
    (rj, trj, mj, ckj), (rp, trp, mp, ckp) = both_runs["jax"], both_runs["port"]
    assert rp.keys() == rj.keys() and rp["frames"] == rj["frames"] == N_FRAMES
    assert abs(rp["tracked"] - rj["tracked"]) <= TRACKED_SLACK and rj["tracked"] >= N_FRAMES - 2
    assert rp["ate_rmse_m"] <= 2 * rj["ate_rmse_m"] + ATE_SLACK_M, (rp, rj)
    assert rp["eval_frames"] >= rj["eval_frames"] - TRACKED_SLACK
    assert trp.shape == trj.shape == (N_FRAMES, 8)
    np.testing.assert_array_equal(trp[:, 0], trj[:, 0])  # the frames' stamps
    assert [m["event"] for m in mp] == [m["event"] for m in mj] == ["dispatch"] * N_FRAMES + [
        "final"]
    # the port's lines carry every span and counter of its recorder: the
    # final one also those of the evaluation after the last dispatch (its
    # device reads), the lap the JAX package's stages and more, and one frame
    # counted a dispatch
    assert mp[-1].keys() - {"stages", "counters"} == mj[-1].keys()
    stages = lambda lines: {n for m in lines for n in m.get("stages", {})}
    assert stages(mj) <= stages(mp)
    assert [m.get("counters", {}).get("frames") for m in mp[:-1]] == [1] * N_FRAMES
    assert ckp == ckj


# ---------------------------------------------------------------------------
# the JAX CLI's faults, on a stand-in facade

class _Rec:
    def __init__(self, fid):
        self.frame_id, self.state = fid, "OK"


class FakeSlam:
    """Records how the CLI drives it; each frame's camera sits at ``pos``."""

    def __init__(self, pos):
        self.pos, self.calls, self.trajectory = pos, [], []
        self.n_kf = self.n_mp = 0
        self.state = "OK"

    def process(self, *args, **kw):
        self.calls.append(("process", args[-1]))
        self.trajectory.append(_Rec(args[-1]))

    def process_batch(self, frames, ids, **kw):
        self.calls.append(("process_batch", list(ids)))
        self.trajectory += [_Rec(i) for i in ids]

    def on_sequence_end(self):
        self.calls.append(("on_sequence_end",))

    def flush(self):
        pass

    def positions(self):
        return np.stack([self.pos[r.frame_id] for r in self.trajectory])

    def final_poses(self):
        return [(np.eye(3), -self.pos[r.frame_id]) for r in self.trajectory]


def _tiny_euroc(root, n=6, t0_ns=0, seed=0):
    rng = np.random.default_rng(seed)
    pairs = [(rng.integers(0, 256, (24, 32), dtype=np.uint8),) * 2 for _ in range(n)]
    gt = rng.normal(size=(n, 3))
    cli_layouts.write_euroc(str(root), pairs, cli_layouts.frame_ns(n, FPS) + t0_ns, gt,
                            images.write_png)
    return gt


def _drive(cli, monkeypatch, capsys, argv, pos):
    fakes = []

    def build(cfg, mode, atlas=False, device=None):
        fakes.append(FakeSlam(pos))
        fakes[-1].mode, fakes[-1].atlas = mode, atlas
        return fakes[-1]

    monkeypatch.setattr(cli, "build_system", build)
    return run(cli, argv, capsys), fakes[0]


def test_fisheye_stereo_batch_runs_frame_by_frame(tmp_path, monkeypatch, capsys):
    gt = _tiny_euroc(tmp_path / "seq")
    argv = ["--seq", str(tmp_path / "seq"), "--settings",
            os.path.join(FIXTURES, "settings_tum_512.yaml"), "--mode", "stereo", "--batch", "4",
            "--out", str(tmp_path / "t.txt")]
    _, j = _drive(jcli, monkeypatch, capsys, argv, gt)
    _, t = _drive(tcli, monkeypatch, capsys, argv, gt)
    assert j.mode == t.mode == "fisheye-stereo"
    # both send the batches to process_batch; the JAX facade's batch hooks
    # are the rectified ones (its fault), the port's the fisheye front end
    # (tests/test_torch_fisheye.py::test_fisheye_batch_mode_raises)
    assert j.calls == t.calls == [("process_batch", [0, 1, 2, 3]), ("process_batch", [4, 5])]


def test_unusable_rectification_raises(tmp_path, monkeypatch, capsys):
    gt = _tiny_euroc(tmp_path / "seq")
    good = open(os.path.join(FIXTURES, "settings_euroc_stereo_inertial.yaml")).read()
    start = good.index("LEFT.D:")
    end = good.index("LEFT.K:")
    settings = tmp_path / "no_left_d.yaml"
    settings.write_text(good[:start] + good[end:])  # LEFT without its distortion
    argv = ["--seq", str(tmp_path / "seq"), "--settings", str(settings), "--mode", "stereo",
            "--out", str(tmp_path / "t.txt")]
    result, j = _drive(jcli, monkeypatch, capsys, argv, gt)
    assert result["frames"] == 6 and len(j.calls) == 6  # ran on, unrectified
    with pytest.raises(ValueError, match="LEFT"):
        _drive(tcli, monkeypatch, capsys, argv, gt)


def test_multi_session_eval_uses_each_sequences_ground_truth(tmp_path, monkeypatch, capsys):
    """Two sequences 100 s apart: every frame of both is tracked at its
    ground truth.  The JAX CLI associates all of them with the second
    sequence's ground truth and evaluates only that sequence's frames."""
    g0 = _tiny_euroc(tmp_path / "a", seed=1)
    g1 = _tiny_euroc(tmp_path / "b", t0_ns=100_000_000_000, seed=2)
    pos = np.concatenate([g0, g1])
    argv = ["--seq", str(tmp_path / "a"), "--seq", str(tmp_path / "b"), "--settings",
            os.path.join(FIXTURES, "settings_euroc_stereo_inertial.yaml"), "--mode", "stereo",
            "--out", str(tmp_path / "t.txt"), "--eval"]
    rj, j = _drive(jcli, monkeypatch, capsys, argv, pos)
    rt, t = _drive(tcli, monkeypatch, capsys, argv, pos)
    assert j.atlas and t.atlas and ("on_sequence_end",) in t.calls
    assert rj["frames"] == rt["frames"] == 12
    assert rj["eval_frames"] == 6  # the fault: the first sequence is not evaluated
    assert rt["eval_frames"] == 12 and rt["ate_rmse_m"] < 1e-4


def test_atlas_checkpoint_out_fails_in_both(tmp_path, capsys):
    """``--atlas --checkpoint-out`` on an empty sequence: the JAX CLI fails
    inside ``save_map``; the port raises a ``TypeError`` that names the
    Atlas."""
    os.makedirs(tmp_path / "seq" / "mav0" / "cam0" / "data")
    (tmp_path / "seq" / "mav0" / "cam0" / "data.csv").write_text("#timestamp [ns],filename\n")
    settings = tmp_path / "mono.yaml"
    settings.write_text("%YAML:1.0\nCamera.fx: 100.0\nCamera.fy: 100.0\nCamera.cx: 31.5\n"
                        "Camera.cy: 23.5\nCamera.width: 64\nCamera.height: 48\n"
                        "ORBextractor.nFeatures: 64\n")
    argv = ["--seq", str(tmp_path / "seq"), "--settings", str(settings), "--mode", "mono",
            "--atlas", "--out", str(tmp_path / "t.txt"), "--checkpoint-out",
            str(tmp_path / "map.npz")]
    with pytest.raises(Exception) as ej:
        jcli.main(argv)
    assert not isinstance(ej.value, TypeError) or "Atlas" not in str(ej.value)
    with pytest.raises(TypeError, match="Atlas"):
        tcli.main(argv + ["--device", "cpu"])
