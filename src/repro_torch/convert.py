"""Convert JAX parameters (and optimizer states) into the port's.

The JAX package keeps per-layer parameters stacked on a leading layer
axis (``blocks.attn.wq`` is ``[L, D, H*hd]``; zamba's ``mamba.mixer.in_proj``
is ``[L, D, E]``); the port keeps a list of per-layer dicts
(``layers.3.attn.wq`` is ``[D, H*hd]``, ``mamba.3.mixer.in_proj`` is
``[D, E]``).  A stacked group need not have ``n_layers`` entries: xlstm's
``mlstm`` holds one per mLSTM block (42 of xlstm-1.3b's 48, unit-major)
and ``slstm`` one per unit (6), so each group's length is read from the
leaf's leading axis or from the model's parameter specs
(:func:`group_lengths`): whisper's ``enc_blocks`` holds ``n_layers``
(``enc_layers.i``) and ``dec_blocks`` ``dec_layers`` (``dec_layers.i``).
Names outside the stacked groups (``embed``, zamba's single
``shared_attn`` block, whisper's ``dec_pos``, ``enc_ln``, ``dec_ln``,
...) are the same in both.
:func:`port_names` is the table between the two naming schemes: tracing
and LoRA targets name weights by the JAX path strings
(``repro.utils.path_str``).

The port keeps the JAX ``[in, out]`` layout of every matrix (a projection
is ``x @ w``), so no matrix is transposed.  Were a layout to change, this
module is the one place where the transpose would go.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.models import encdec
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_family, param_specs, to_device
from repro_torch.utils import named_leaves

# JAX subtree stacked on a leading layer axis -> the port's per-layer list
STACKED = {"blocks": "layers", "mamba": "mamba", "mlstm": "mlstm",
           "slstm": "slstm", "enc_blocks": "enc_layers",
           "dec_blocks": "dec_layers"}
UNSTACKED = {v: k for k, v in STACKED.items()}


def group_lengths(port_params: dict) -> dict:
    """``{JAX group: entries}`` of the stacked groups of a port parameter
    dict (or of ``Model.param_specs()``): xlstm-1.3b gives ``{'mlstm': 42,
    'slstm': 6}``."""
    return {UNSTACKED[g]: len(v) for g, v in port_params.items()
            if g in UNSTACKED and isinstance(v, list)}


def port_names(jax_path: str, lengths) -> list:
    """Port parameter names of one JAX leaf path.

    ``'blocks.attn.wq'`` -> ``['layers.0.attn.wq', ..., 'layers.{L-1}.attn.wq']``
    and ``'mlstm.mixer.wq'`` -> ``['mlstm.0.mixer.wq', ...]`` (one per
    unstacked entry); any other path maps to itself.  ``lengths`` is the
    entries of every stacked group: one int for all of them, or a
    ``{JAX group: entries}`` dict (:func:`group_lengths`).
    """
    head, _, rest = jax_path.partition(".")
    if head not in STACKED:
        return [jax_path]
    n = lengths if isinstance(lengths, int) else lengths[head]
    return [f"{STACKED[head]}.{i}.{rest}" for i in range(n)]


def _flatten(tree, prefix: str = "") -> Iterator[tuple]:
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":       # ml_dtypes bf16 has no torch twin
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _set(tree: dict, name: str, value) -> None:
    parts = name.split(".")
    node = tree
    for key in parts[:-1]:
        if key.isdigit():
            node = node[int(key)]
        else:
            node = node.setdefault(key, {})
    node[parts[-1]] = value


def params_from_jax(jax_params: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Port parameters from a JAX parameter tree given as numpy arrays.

    ``jax_params`` is the nested dict of ``repro.models.transformer.
    init_params`` (or ``repro.models.encdec.init_params``, or a checkpoint
    of either) with leaves converted to numpy.  Stacked ``[n, ...]``
    leaves are unstacked into per-layer dicts; each group's ``n`` must be
    the model's (``n_layers``, xlstm's mLSTM blocks and units, whisper's
    encoder and decoder layers).
    """
    check_family(cfg)
    specs = (encdec.param_specs if cfg.is_encdec else param_specs)(cfg)
    lengths = group_lengths(specs)
    params: dict = {STACKED[k]: [{} for _ in range(lengths[k])]
                    for k in STACKED if k in jax_params}
    for path, leaf in _flatten(jax_params):
        t = _to_tensor(leaf)
        head = path.partition(".")[0]
        stacked = head in STACKED
        if stacked and t.shape[0] != lengths.get(head):
            raise ValueError(f"{path}: leading axis {t.shape[0]} != the "
                             f"model's {lengths.get(head)} {head} entries")
        for i, name in enumerate(port_names(path, lengths)):
            _set(params, name, t[i] if stacked else t)
    return to_device(params, device)


def adapter_bank_from_jax(bank: dict, device="cuda") -> dict:
    """A port adapter bank from a JAX one given as numpy arrays
    (``repro.models.adapters.make_adapter_bank`` / ``load_adapter``).
    Both keep the stacked ``{name: {"a": [L, N, in, r], "b": [L, N, r,
    out]}}`` layout, so this is a plain conversion."""
    return {name: {k: _to_tensor(v).to(device) for k, v in slab.items()}
            for name, slab in bank.items()}


def named_parameters(params: dict) -> Iterator[tuple]:
    """``(port name, tensor)`` for every leaf, e.g. ``layers.0.attn.wq``."""
    return named_leaves(params)


def jax_key(port_name: str) -> tuple:
    """A port weight name as the JAX package's weight key (path, layer):
    ``'layers.3.attn.wq'`` -> ``('blocks.attn.wq', (3,))``,
    ``'mamba.3.norm'`` -> ``('mamba.norm', (3,))``, ``'mlstm.9.mixer.wq'``
    -> ``('mlstm.mixer.wq', (9,))``, any other name
    -> ``(name, ())``.  The inverse of :func:`port_names`, key by key."""
    head, _, rest = port_name.partition(".")
    layer, _, leaf = rest.partition(".")
    if head not in UNSTACKED or not layer.isdigit():
        return (port_name, ())
    return (f"{UNSTACKED[head]}.{leaf}", (int(layer),))


def opt_state_from_jax(jax_opt: dict, cfg: ModelConfig, device="cuda") -> dict:
    """A port optimizer state (``train.optimizer.init_opt_state``'s
    layout) from a JAX one given as numpy arrays: ``m`` and ``v``
    unstacked leaf for leaf as :func:`params_from_jax` unstacks the
    parameters (a factored ``v`` leaf's ``row`` [L, ...] and ``col``
    unstacked with it, dtypes kept, bf16 included) and ``step`` a 0-d
    int32 tensor, so a JAX state after k steps continues in the port.
    The JAX optimizer factors a stacked leaf by its trailing two axes, the
    port the per-layer leaf by the same two, so both factor the same
    leaves as long as no stacked group is ``min_factored_size`` layers
    deep with 1-D leaves."""
    return {"m": params_from_jax(jax_opt["m"], cfg, device),
            "v": params_from_jax(jax_opt["v"], cfg, device),
            "step": torch.tensor(int(np.asarray(jax_opt["step"])),
                                 dtype=torch.int32, device=device)}
