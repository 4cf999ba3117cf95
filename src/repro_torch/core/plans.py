"""Workload-plan construction for FULL architecture configs: the port's
copy of ``repro.core.plans``.

Traces the real config on ``meta`` tensors (no memory is allocated even
for deepseek-v3-671b, and no device is touched) and builds the cost-model
plan used by the TTFT figures and the scheduler's latency oracles.  The
model is built on ``meta`` too: ``get_model(arch)`` would default to the
card.  Weights are counted at the config's dtype (bf16 for every full
config, as the reference's abstract specs), and the trace runs the
model's prefill over ``meta`` inputs and a ``meta`` cache (enc-dec: over
``meta`` frames, as the template server traces it).  Traces are cached
per (arch, trace_seq).
"""

from __future__ import annotations

import functools

from repro_torch.core import costmodel
from repro_torch.core.tracing import trace_weight_access, weight_sizes
from repro_torch.models.registry import get_model


def _meta_model(arch: str):
    return get_model(arch, device="meta")


def _trace_seq(cfg, trace_seq: int) -> int:
    # recurrent families need seq % chunk == 0 at trace time
    if cfg.ssm_chunk:
        trace_seq = max(trace_seq // cfg.ssm_chunk, 1) * cfg.ssm_chunk
    return trace_seq


@functools.lru_cache(maxsize=64)
def _trace_for(arch: str, trace_seq: int):
    model = _meta_model(arch)
    specs = model.param_specs()
    inputs = model.input_specs("prefill", 1, trace_seq)
    cache = model.make_cache(1, trace_seq, device="meta")
    trace = trace_weight_access(
        lambda p, i, c: model.prefill(p, i, c), specs, inputs, cache)
    sizes = weight_sizes(specs, trace.order)
    return trace, sizes


def plan_for(arch: str, batch: int, seq: int,
             trace_seq: int = 256) -> costmodel.WorkloadPlan:
    """WorkloadPlan for a full config at the given workload shape.

    The access ORDER is shape-independent, so tracing happens once at a
    small sequence length and the per-stage costs are evaluated at the
    requested (batch, seq).
    """
    cfg = _meta_model(arch).cfg
    trace, sizes = _trace_for(arch, _trace_seq(cfg, trace_seq))
    return costmodel.build_plan(cfg, trace.order, sizes, batch, seq,
                                dtype_bytes=2)


def kernel_set_for(arch: str, trace_seq: int = 256):
    cfg = _meta_model(arch).cfg
    trace, _ = _trace_for(arch, _trace_seq(cfg, trace_seq))
    return trace.kernels
