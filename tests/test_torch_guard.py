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
    mapper, the windowed BA and the two-view solver included)."""
    files = _sources("**", "*.py") + [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "scripts", n) for n in ("torch_port_bench.py", "torch_port_profile_lap.py",
                                                   "loop_scaffold.py", "torch_port_segsum_ab.py")]
    assert {"stereo.py", "triangulation.py", "window_ba.py", "twoview.py", "horn.py",
            "evaluation.py", "trajectory.py", "sim3.py", "sim3_solver.py", "sim3_opt.py",
            "pose_graph.py", "ba.py", "gba.py", "loop_closing.py"} <= {
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


def test_port_never_asks_for_a_gpu_or_catches_a_launch():
    """Dispatch is by the tensor's device alone: no module of the port asks
    ``is_available``, and no module under ``ops/`` (the kernel wrappers and
    their callers), ``geometry/`` or ``pipeline/`` (the two-view solver and
    the facades that drive the kernels) holds a ``try`` that could fall back
    from a failed build or launch to the plain version."""
    for path in _sources("**", "*.py"):
        with open(path) as f:
            src = f.read()
        assert "is_available" not in src, path
    paths = (_sources("ops", "*.py") + _sources("geometry", "*.py") + _sources("pipeline", "*.py")
             + _sources("optim", "*.py"))
    assert {"twoview.py", "system.py", "tracking.py", "loop_closing.py", "gba.py"} <= {
        os.path.basename(p) for p in paths}
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path


@pytest.mark.parametrize("facade", ["MonoSLAM", "StereoSLAM", "RGBDSLAM"])
def test_facades_default_to_the_cuda_device(facade, monkeypatch):
    """Without a ``device`` the state goes to ``cuda``, whether or not a
    card is present: the allocation is intercepted before it happens."""
    import torch

    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.pipeline import map_state, system

    seen = []

    class Stop(Exception):
        pass

    def empty_map(cfg, device=None):
        seen.append(device)
        raise Stop

    monkeypatch.setattr(map_state, "empty_map", empty_map)
    with pytest.raises(Stop):
        getattr(system, facade)(SlamConfig(enable_loop_closing=False))
    assert seen == [torch.device("cuda")]
    with pytest.raises(Stop):
        getattr(system, facade)(SlamConfig(enable_loop_closing=False), device="cpu")
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
