"""The port runs where JAX is absent: with `jax` and `evplp_tpu` blocked in
sys.modules, every module of evplp_tpu_torch, its CLI and chip_smoke.py
import.  A CUDA device that does not exist is refused, never replaced by
the CPU, and chip_smoke.py prints no result without a card or without the
port beside it."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from evplp_tpu_torch import __main__ as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["evplp_tpu"] = None
import evplp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(evplp_tpu_torch.__path__,
                                               "evplp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20   # every module was imported


def test_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([os.path.join(REPO, "configs", "cornell",
                               "cornell_ours.json")])
    assert cli.resolve_device("cpu").type == "cpu"


def _run_smoke(script, cwd):
    # no visible card: torch.cuda.is_available() is false in the child
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_card():
    proc = _run_smoke(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_without_the_port(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
