#!/usr/bin/env python3
"""How far the port's bf16 logits sit from the JAX package's, with and
without gemma's embedding scale.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/embed_scale_gap.py

``repro.models.layers.embed_tokens`` multiplies gemma's bf16 embedding
rows by a numpy float64 ``sqrt(d_model)``, which JAX promotes to float32:
from there the residual stream of the JAX model is float32.  The port
keeps the embedding's dtype.  This tool runs both packages on the CPU in
bf16, at the smoke width and the full depth of gemma-2b (scaled
embedding) and of smollm-135m (no scale), with the same JAX weights from
one seed carried into the port, and prints per arch: the dtype of the
embedded rows in each package, the largest prefill logit difference
(absolute, and relative to the largest |logit|), the share of prefill
argmaxes that agree, and how many of the greedy tokens of a sequential
decode agree.  One JSON object per arch.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.layers import embed_tokens as jax_embed
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_smoke_model as jax_smoke
from repro.runtime.engine import Engine as JaxEngine
from repro_torch import convert
from repro_torch.models.layers import embed_tokens as torch_embed
from repro_torch.models.registry import get_smoke_model as torch_smoke
from repro_torch.runtime import Engine

B, S, NEW, SEED = 4, 64, 16, 0


def gap(arch: str) -> dict:
    depth = jax_config(arch).n_layers
    jm = jax_smoke(arch, n_layers=depth, dtype="bfloat16")
    tm = torch_smoke(arch, device="cpu", n_layers=depth, dtype="bfloat16")
    jp = jm.init_params(jax.random.PRNGKey(SEED))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    toks = np.random.default_rng(SEED).integers(
        0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                       jm.make_cache(B, S + NEW))
    tl, _ = tm.prefill(tp, {"tokens": toks}, tm.make_cache(B, S + NEW))
    jl = np.asarray(jl.astype(jnp.float32))
    tl = tl.float().numpy()
    diff = np.abs(jl - tl)
    want = JaxEngine(jm, jp).generate(toks, max_new_tokens=NEW).tokens
    got = Engine(tm, tp).generate(toks, max_new_tokens=NEW).tokens
    scaled = jm.cfg.scale_embed
    return {"arch": arch, "layers": depth, "d_model": jm.cfg.d_model,
            "scale_embed": scaled,
            "jax_embed_dtype": str(jax_embed(jp["embed"], jnp.asarray(toks),
                                             scaled).dtype),
            "port_embed_dtype": str(torch_embed(tp["embed"],
                                                torch.from_numpy(toks),
                                                scaled).dtype).replace("torch.", ""),
            "max_abs_logit_diff": float(diff.max()),
            "max_abs_logit": float(np.abs(jl).max()),
            "relative": float(diff.max() / np.abs(jl).max()),
            "argmax_equal": f"{int((jl.argmax(-1) == tl.argmax(-1)).sum())}/{B}",
            "greedy_tokens_equal": f"{int((np.asarray(want) == got).sum())}"
                                   f"/{B * NEW}"}


def main() -> None:
    for arch in ("gemma-2b", "smollm-135m"):
        print(json.dumps(gap(arch)))


if __name__ == "__main__":
    main()
