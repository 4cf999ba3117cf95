"""Analytical cost model for cold-start TTFT (the paper's measured
quantity): the port's copy of ``repro.core.costmodel``.

The model combines

  * structural facts from the traced access order (which weight is needed
    when, how many bytes per compute stage), and
  * a hardware profile (host-to-device and HBM bandwidth, peak FLOP/s,
    fixed costs like the 180 ms lazy code-segment load the paper
    measures): ``hw.H100_SXM`` for the port's card, whose host-to-device
    rate ``chip_smoke.py`` measures, or the paper's testbeds.

The same machinery expresses every execution strategy in the paper:

  pytorch-pin      load ALL weights -> cold kernel calls -> inference
  serverlessllm    pinned-pool load -> cold kernel calls -> inference
  execution        weights resident + warm kernels (lower bound)
  tidal            pre-warmed kernels + resident template prefix + streaming
                   the rest in ACCESS order overlapped with inference (Eq. 1)

and the ablations: loading order (traced/default/reverse, Fig. 20a), weight
tensor merging (Table 3), template size sweeps (Fig. 14), workload sweeps
(Fig. 15/16), distributed tensor parallel (Fig. 18).

The port's weight keys are ``(path, ())`` with the layer in the path
(``('layers.3.attn.wq', ())``); a stage is one layer as in the reference,
whose keys carry the layer as ``('blocks.attn.wq', (3,))``.
:func:`layer_of` reads it through ``convert.jax_key``, so both packages
cut an order into the same stages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.convert import jax_key
from repro_torch.hw import HardwareProfile
from repro_torch.models.config import ModelConfig


def layer_of(key) -> tuple:
    """The layer index of a port weight key, as the reference's key holds
    it: ``('layers.3.attn.wq', ())`` -> ``(3,)``, ``('embed', ())`` ->
    ``()``."""
    return jax_key(key[0])[1]


# ---------------------------------------------------------------------------
# stage decomposition from a traced access order
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stage:
    """A contiguous compute stage (embedding / one block / head)."""
    keys: list                   # WeightKeys consumed by this stage
    weight_bytes: int
    flops: float                 # forward flops for this stage
    io_bytes: float              # activation+weight traffic for roofline


@dataclasses.dataclass
class WorkloadPlan:
    """Everything the TTFT simulator needs for one (model, B, S) workload."""
    stages: list
    total_weight_bytes: int
    order: list                  # full access-ordered key list
    sizes: dict                  # key -> bytes

    def compute_time(self, hw: HardwareProfile, tp: int = 1) -> float:
        return sum(stage_time(s, hw, tp) for s in self.stages)


def stage_time(s: Stage, hw: HardwareProfile, tp: int = 1) -> float:
    return max(s.flops / tp / (hw.peak_flops_bf16 * hw.flops_eff),
               s.io_bytes / tp / (hw.hbm_bandwidth * hw.bw_eff))


def _attn_flops(cfg: ModelConfig, B: int, S: int) -> float:
    """Quadratic attention term per layer (causal → /2), QK^T + PV."""
    if cfg.attention_kind == "recurrent":
        # linear-recurrence mixers: ~O(S * d_state * d_head) extra, folded
        # into the weight-matmul estimate; return the chunked SSD term
        return 2.0 * B * S * cfg.ssm_chunk * cfg.d_model
    return 2.0 * 2.0 * B * S * S / 2 * cfg.n_heads * (cfg.head_dim or 64)


def build_plan(cfg: ModelConfig, order: Sequence, sizes: dict,
               batch: int, seq: int, dtype_bytes: int = 2) -> WorkloadPlan:
    """Group the traced order into compute stages and estimate per-stage cost.

    Stage boundary = change of the layer index in the access-ordered keys.
    FLOPs per stage ≈ 2 * stage_params * tokens (weight matmuls) plus the
    attention quadratic term on layer stages.
    """
    tokens = batch * seq
    stages: list[Stage] = []
    cur_keys: list = []
    cur_idx: object = "start"

    def close():
        nonlocal cur_keys
        if not cur_keys:
            return
        wbytes = sum(sizes[k] for k in cur_keys)
        params = wbytes / dtype_bytes
        flops = 2.0 * params * tokens
        is_layer = any(layer_of(k) != () for k in cur_keys)
        if is_layer:
            flops += _attn_flops(cfg, batch, seq)
        act_bytes = 4.0 * tokens * cfg.d_model * dtype_bytes
        stages.append(Stage(keys=list(cur_keys), weight_bytes=wbytes,
                            flops=flops, io_bytes=wbytes + act_bytes))
        cur_keys = []

    for key in order:
        idx = layer_of(key)
        if idx != cur_idx:
            close()
            cur_idx = idx
        cur_keys.append(key)
    close()
    total = sum(sizes[k] for k in order)
    return WorkloadPlan(stages=stages, total_weight_bytes=total,
                        order=list(order), sizes=dict(sizes))


# ---------------------------------------------------------------------------
# Eq. 1 — adaptive template sizing
# ---------------------------------------------------------------------------

def prefetch_bytes(model_bytes: int, ttft_s: float, hw: HardwareProfile) -> int:
    """M_prefetch = max(M_model - T_TTFT * B_PCIe, 0)   (paper Eq. 1)."""
    return int(max(model_bytes - ttft_s * hw.host_to_device_bw, 0))


# ---------------------------------------------------------------------------
# TTFT under each strategy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TTFTBreakdown:
    total: float
    load: float                  # exposed (non-overlapped) weight loading
    compute: float               # inference compute
    cold_kernel: float           # lazy code-segment loading penalty
    dynamic_init: float          # request-specific (LoRA) initialization


def ttft_load_then_infer(plan: WorkloadPlan, hw: HardwareProfile,
                         tp: int = 1, cold_kernels: bool = True,
                         host_factor: float = 1.0) -> TTFTBreakdown:
    """pytorch-pin / serverlessllm: full H2D load, then (cold) inference."""
    load = (plan.total_weight_bytes / tp
            / (hw.host_to_device_bw * hw.bw_eff) * host_factor)
    compute = plan.compute_time(hw, tp)
    cold = hw.kernel_cold_load_s if cold_kernels else 0.0
    return TTFTBreakdown(total=load + compute + cold, load=load,
                         compute=compute, cold_kernel=cold, dynamic_init=0.0)


def ttft_execution(plan: WorkloadPlan, hw: HardwareProfile,
                   tp: int = 1) -> TTFTBreakdown:
    """Lower bound: weights resident, kernels warm."""
    compute = plan.compute_time(hw, tp)
    return TTFTBreakdown(total=compute, load=0.0, compute=compute,
                         cold_kernel=0.0, dynamic_init=0.0)


def ttft_tidal(plan: WorkloadPlan, hw: HardwareProfile,
               template_bytes: int = 0,
               dynamic_bytes: int = 0,
               order: str = "traced",
               n_groups: Optional[int] = None,
               prewarmed: bool = True,
               tp: int = 1) -> TTFTBreakdown:
    """TIDAL: resident prefix + access-order streaming overlapped with
    inference (+ fork of static weights, replay of dynamic ones).

    order: 'traced' streams in access order; 'default' in initialization
    order (embedding last — the tied-embedding pathology of Fig. 20a);
    'reverse' the reverse of traced.
    n_groups: weight tensor merging (Table 3) — fewer groups, less per-copy
    overhead; None = one copy per weight tensor.
    """
    keys = list(plan.order)
    sizes = plan.sizes

    if order == "traced":
        load_order = keys
    elif order == "reverse":
        load_order = keys[::-1]
    elif order == "default":
        # initialization order: tied embedding materializes LAST (it is
        # written by the lm-head tie at the end of init) — model this by
        # rotating the first-accessed weight to the back.
        load_order = keys[1:] + keys[:1]
    else:
        raise ValueError(order)

    # resident prefix: greedily mark weights resident in LOAD order until
    # the template budget is spent (TIDAL keeps the access-order prefix).
    resident = set()
    budget = template_bytes
    for k in load_order:
        if sizes[k] <= budget:
            resident.add(k)
            budget -= sizes[k]
        else:
            break

    # group the remaining loads (tensor merging)
    to_load = [k for k in load_order if k not in resident]
    groups: list[list] = []
    if n_groups is None or n_groups >= len(to_load):
        groups = [[k] for k in to_load]
    elif to_load:
        target = max(sum(sizes[k] for k in to_load) / max(n_groups, 1), 1.0)
        cur, acc = [], 0.0
        for k in to_load:
            cur.append(k)
            acc += sizes[k]
            if acc >= target and len(groups) < n_groups - 1:
                groups.append(cur)
                cur, acc = [], 0.0
        if cur:
            groups.append(cur)

    # dynamic (LoRA) init happens concurrently with streaming; inference
    # cannot start before it finishes (it is on the critical CPU path).
    dyn = (dynamic_bytes / (hw.storage_bw * hw.bw_eff)) if dynamic_bytes else 0.0

    # load completion time per key
    done: dict = {k: 0.0 for k in resident}
    t = 0.0
    for g in groups:
        t += hw.copy_call_overhead_s
        for k in g:
            t += sizes[k] / tp / (hw.host_to_device_bw * hw.bw_eff)
        for k in g:
            done[k] = t

    # compute schedule: stage k starts when stage k-1 done AND its weights
    # arrived (TIDAL's injected sync events); first stage also waits for
    # the dynamic init (fork happens during it).
    cold = 0.0 if prewarmed else hw.kernel_cold_load_s
    t_c = hw.fork_overhead_s + dyn + cold
    exposed = 0.0
    for s in plan.stages:
        ready = max((done.get(k, 0.0) for k in s.keys), default=0.0)
        start = max(t_c, ready)
        exposed += max(ready - t_c, 0.0)
        t_c = start + stage_time(s, hw, tp)
    compute = plan.compute_time(hw, tp)
    return TTFTBreakdown(total=t_c, load=exposed, compute=compute,
                         cold_kernel=cold, dynamic_init=dyn)


def tidal_warm_bytes(plan: WorkloadPlan) -> int:
    return plan.total_weight_bytes
