"""Guards of the PyTorch port: it imports without JAX, and ``chip_smoke.py``
refuses to run (and prints no result) where there is no GPU."""

import os
import subprocess
import sys

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
