"""Checkpoints with exact resume: one ``.npy`` per leaf and a manifest,
published by an atomic rename, keep-last-k (the port's copy of
``repro.train.checkpoint``, same layout)::

    <dir>/step_000000120/
        manifest.json          # step, extra state, and per leaf: path,
        0000.npy               #   file, shape, dtype (and encoding)
        ...
    <dir>/LATEST               # atomic pointer to the newest step

A leaf's path is its keys and list indices joined by dots
(``params.layers.3.attn.wq``, ``opt.v.layers.3.attn.wq.row``).  numpy has
no bfloat16 that PyTorch can hand it, so a bf16 leaf (an optimizer state
with ``state_dtype='bfloat16'``) is written as its raw bits, a uint16
array, with ``"dtype": "bfloat16", "encoding": "bf16-bits-as-uint16"`` in
the manifest; it reads back bit for bit.  Every other dtype is written as
numpy has it.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils import map_with_path, named_leaves

BF16_ENCODING = "bf16-bits-as-uint16"


def _to_numpy(t: torch.Tensor) -> tuple:
    """(array, manifest fields) of one leaf."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).numpy().view(np.uint16),
                {"dtype": "bfloat16", "encoding": BF16_ENCODING})
    arr = t.numpy()
    return arr, {"dtype": str(arr.dtype)}


def _from_numpy(arr: np.ndarray, entry: dict) -> torch.Tensor:
    if entry.get("encoding") == BF16_ENCODING:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    if entry.get("encoding") is not None:
        raise ValueError(f"unknown leaf encoding {entry['encoding']!r}")
    return torch.from_numpy(arr.copy())


def save_checkpoint(directory: str, step: int, state: Any,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Write ``state`` (a nested dict / list of tensors) as step ``step``,
    publish it with an atomic rename and the ``LATEST`` pointer, and keep
    the newest ``keep`` steps.  Returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_" + name)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(named_leaves(state)):
        arr, fields = _to_numpy(leaf)
        fname = f"{i:04d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": list(arr.shape), **fields})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(directory, name)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None):
    """Restore into the structure of ``like`` (each leaf takes ``like``'s
    device and dtype; a shape that differs raises ``ValueError``).
    Returns (state, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def load(path, leaf):
        entry = by_path[path]
        t = _from_numpy(np.load(os.path.join(d, entry["file"])), entry)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {path}: {tuple(t.shape)} vs "
                             f"{tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return map_with_path(load, like), manifest["step"], manifest["extra"]
