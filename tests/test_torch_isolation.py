"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on a card that is not there."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

_CHECK = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.time_ms, chip_smoke.bound_ms, chip_smoke.make_paged_case
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 46, names
for sub in ("core", "launch", "hw", "utils", "data", "train"):
    assert any(n == "repro_torch." + sub or n.startswith("repro_torch." + sub + ".")
               for n in names), sub
for mod in ("repro_torch.launch.train", "repro_torch.train.optimizer",
            "repro_torch.train.checkpoint", "repro_torch.train.train_loop",
            "repro_torch.kernels.grad"):
    assert mod in names, mod
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _CHECK.format(src=str(SRC), root=str(ROOT))],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.models.registry import get_model, get_smoke_model
    from repro_torch.runtime import (ContinuousBatchingEngine, FaaSRuntime,
                                     PagedKVCachePool)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("smollm-135m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_smoke_model("smollm-135m", n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaaSRuntime()
    assert FaaSRuntime(device="cpu").device.type == "cpu"
    # pools and engines live on their model's device: CPU only when asked
    m = get_smoke_model("smollm-135m", device="cpu", n_layers=1)
    assert PagedKVCachePool(m, n_slots=1, max_len=8).device.type == "cpu"
    eng = ContinuousBatchingEngine(m, m.init_params(), n_slots=1, max_len=8)
    assert eng.device.type == "cpu"


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else it exits
    non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
