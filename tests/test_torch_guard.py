"""Guards of the PyTorch port: it imports without JAX, its entry points
default to the CUDA device, nothing in it asks whether a GPU is there or
catches a failed launch, and ``chip_smoke.py`` refuses to run (and prints
no result) where there is no GPU."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_WITHOUT_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked")
        return None

sys.meta_path.insert(0, BlockJax())
import orb_slam3_noted_tpu_torch as pkg
names = []
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    names.append(info.name)
assert "jax" not in sys.modules, "jax imported"
assert not any(m.startswith("orb_slam3_noted_tpu.") for m in sys.modules), "JAX package imported"
print(len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_WITHOUT_JAX], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20  # every module imported


def _sources(*parts):
    pattern = os.path.join(ROOT, "orb_slam3_noted_tpu_torch", *parts)
    files = sorted(glob.glob(pattern, recursive=True))
    assert files, pattern
    return files


def test_port_names_neither_jax_nor_the_jax_package():
    """Every module of the port, ``chip_smoke.py`` and the port's bench and
    profile scripts, by their import statements (the stereo matcher, the
    mapper, the windowed BA, the two-view solver and the distributed BA
    included, and the jobs that spawned ranks run)."""
    files = _sources("**", "*.py") + [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "scripts", n) for n in ("torch_port_bench.py", "torch_port_profile_lap.py",
                                                   "loop_scaffold.py", "torch_port_segsum_ab.py",
                                                   "torch_port_dist.py")]
    assert {"stereo.py", "triangulation.py", "window_ba.py", "twoview.py", "horn.py",
            "evaluation.py", "trajectory.py", "sim3.py", "sim3_solver.py", "sim3_opt.py",
            "pose_graph.py", "ba.py", "gba.py", "loop_closing.py", "preintegration.py",
            "inertial.py", "vi_factors.py", "inertial_ba.py", "inertial_mapping.py",
            "inertial_system.py", "fisheye_stereo.py", "cameras.py", "atlas.py",
            "inertial_atlas.py", "checkpoint.py", "cli.py", "demo.py", "yaml_compat.py",
            "datasets.py", "images.py", "node.py", "viewer.py", "native.py", "dist_ba.py",
            "torch_port_dist.py"} <= {
                os.path.basename(f) for f in files}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "orb_slam3_noted_tpu"), (path, n)


def test_port_imports_no_cv2_pil_or_matplotlib():
    """The card's machine has none of them: every module of the port (the
    live node, the viewer that draws and encodes frames and maps with numpy
    and ``zlib``, and ``native.py`` among them), ``chip_smoke.py`` and the
    layout writer it shares with the reference script read and write images
    through ``io/images.py``."""
    files = _sources("**", "*.py") + [os.path.join(ROOT, "chip_smoke.py"),
                                      os.path.join(ROOT, "scripts", "cli_layouts.py")]
    assert {"node.py", "viewer.py", "native.py", "images.py"} <= {os.path.basename(f)
                                                                   for f in files}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("cv2", "PIL", "matplotlib"), (path, n)


def test_port_never_asks_for_a_gpu_or_catches_a_launch():
    """Dispatch is by the tensor's device alone: no module of the port asks
    ``is_available``, and no module under ``ops/`` (the kernel wrappers and
    their callers), ``geometry/`` or ``pipeline/`` (the two-view solver and
    the facades that drive the kernels), ``optim/`` or ``parallel/`` (the
    mesh, its collectives and the launcher of its ranks) holds a ``try``
    that could fall back from a failed build, launch or collective."""
    for path in _sources("**", "*.py"):
        with open(path) as f:
            src = f.read()
        assert "is_available" not in src, path
    paths = (_sources("ops", "*.py") + _sources("geometry", "*.py") + _sources("pipeline", "*.py")
             + _sources("optim", "*.py") + _sources("parallel", "*.py"))
    assert {"twoview.py", "system.py", "tracking.py", "loop_closing.py", "gba.py", "atlas.py",
            "inertial_atlas.py", "dist_ba.py", "pose_graph.py"} <= {
        os.path.basename(p) for p in paths}
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path


@pytest.mark.parametrize("facade", ["MonoSLAM", "StereoSLAM", "RGBDSLAM", "MonoInertialSLAM",
                                    "StereoInertialSLAM", "FisheyeStereoSLAM",
                                    "FisheyeStereoInertialSLAM"])
def test_facades_default_to_the_cuda_device(facade, monkeypatch):
    """Without a ``device`` the state goes to ``cuda``, whether or not a
    card is present: the allocation is intercepted before it happens (the
    inertial facades are ``pipeline/inertial_system.py``'s; the fisheye
    ones get a second camera)."""
    import torch

    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, KANNALA_BRANDT8
    from orb_slam3_noted_tpu_torch.pipeline import inertial_system, map_state
    from orb_slam3_noted_tpu_torch.pipeline import system as visual

    system = inertial_system if "Inertial" in facade else visual

    seen = []

    class Stop(Exception):
        pass

    def empty_map(cfg, device=None):
        seen.append(device)
        raise Stop

    monkeypatch.setattr(map_state, "empty_map", empty_map)
    cam2 = Camera(KANNALA_BRANDT8, (190.0, 190.0, 256.0, 256.0, 0.0, 0.0, 0.0, 0.0))
    cfg = SlamConfig(enable_loop_closing=False, camera2=cam2 if "Fisheye" in facade else None)
    with pytest.raises(Stop):
        getattr(system, facade)(cfg)
    assert seen == [torch.device("cuda")]
    with pytest.raises(Stop):
        getattr(system, facade)(cfg, device="cpu")
    assert seen[1] == torch.device("cpu")


@pytest.mark.parametrize("atlas", ["AtlasSLAM", "InertialAtlasSLAM"])
def test_atlas_defaults_to_the_cuda_device(atlas, monkeypatch):
    """An Atlas puts its systems on ``cuda`` unless a device is named, and
    every map it starts later on the same device."""
    import torch

    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.pipeline import atlas as A
    from orb_slam3_noted_tpu_torch.pipeline import inertial_atlas as IA
    from orb_slam3_noted_tpu_torch.pipeline import map_state

    seen = []

    class Stop(Exception):
        pass

    def empty_map(cfg, device=None):
        seen.append(device)
        raise Stop

    monkeypatch.setattr(map_state, "empty_map", empty_map)
    cls = getattr(A if atlas == "AtlasSLAM" else IA, atlas)
    cfg = SlamConfig(enable_loop_closing=False)
    with pytest.raises(Stop):
        cls(cfg)
    assert seen == [torch.device("cuda")]
    with pytest.raises(Stop):
        cls(cfg, device="cpu")
    assert seen[1] == torch.device("cpu")


def test_loop_closer_defaults_to_the_cuda_device(monkeypatch):
    """The loop closer's database goes to ``cuda`` unless a device is named,
    and a facade with loop closing on hands it its own device."""
    import numpy as np
    import torch

    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.pipeline import loop_closing, system

    seen = []

    class Stop(Exception):
        pass

    def database(vocab, max_keyframes, idf=None, device=None):
        seen.append(torch.device("cuda" if device is None else device))
        raise Stop

    monkeypatch.setattr(loop_closing, "KeyFrameDatabase", database)
    with pytest.raises(Stop):
        loop_closing.LoopCloser(np.zeros((4, 8), np.uint32), 8)
    assert seen == [torch.device("cuda")]
    slam = system.MonoSLAM(SlamConfig(enable_loop_closing=True), device="cpu")
    with pytest.raises(Stop):
        slam._maybe_build_loop_closer(None)
    assert seen[1] == torch.device("cpu")


def test_chip_smoke_fails_without_gpu():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine with one
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """A directory holding only chip_smoke.py cannot pass."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_cli_and_demo_default_to_the_cuda_device(monkeypatch, tmp_path):
    """``cli`` and ``demo`` put the SLAM state on ``cuda`` unless
    ``--device`` names another: the allocation is intercepted before it
    happens.  The CLI reads the frames with the port's reader (host numpy)
    and moves them, and the rectification maps, to that device."""
    import torch

    from orb_slam3_noted_tpu_torch import cli, demo
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.pipeline import map_state

    seen = []

    class Stop(Exception):
        pass

    def empty_map(cfg, device=None):
        seen.append(device)
        raise Stop

    monkeypatch.setattr(map_state, "empty_map", empty_map)
    with pytest.raises(Stop):
        cli.build_system(SlamConfig(), "stereo")
    with pytest.raises(Stop):
        demo.main(["2", "--small"])
    assert seen == [torch.device("cuda")] * 2
    os.makedirs(tmp_path / "mav0" / "cam0" / "data")
    (tmp_path / "mav0" / "cam0" / "data.csv").write_text("#timestamp [ns],filename\n")
    settings = os.path.join(ROOT, "tests", "fixtures", "settings_mono_pinhole.yaml")
    with pytest.raises(Stop):
        cli.main(["--seq", str(tmp_path), "--settings", settings, "--mode", "mono",
                  "--out", str(tmp_path / "t.txt")])
    with pytest.raises(Stop):
        cli.main(["--seq", str(tmp_path), "--settings", settings, "--mode", "mono",
                  "--out", str(tmp_path / "t.txt"), "--device", "cpu"])
    assert seen[2:] == [torch.device("cuda"), torch.device("cpu")]


def test_node_defaults_to_the_cuda_device(monkeypatch):
    """``SlamNode`` and the node's ``main`` put the SLAM state on ``cuda``
    unless a device is named: the allocation is intercepted before it
    happens."""
    import torch

    from orb_slam3_noted_tpu_torch import node
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.pipeline import map_state

    seen = []

    class Stop(Exception):
        pass

    def empty_map(cfg, device=None):
        seen.append(device)
        raise Stop

    monkeypatch.setattr(map_state, "empty_map", empty_map)
    with pytest.raises(Stop):
        node.SlamNode(SlamConfig(), "stereo")
    with pytest.raises(Stop):
        node.SlamNode(SlamConfig(), "stereo-inertial", device="cpu")
    settings = os.path.join(ROOT, "tests", "fixtures", "settings_mono_pinhole.yaml")
    for extra in ([], ["--device", "cpu"]):
        with pytest.raises(Stop):
            node.main(["--settings", settings, "--mode", "mono", "--port", "0", *extra])
    assert seen == [torch.device("cuda"), torch.device("cpu"), torch.device("cuda"),
                    torch.device("cpu")]
