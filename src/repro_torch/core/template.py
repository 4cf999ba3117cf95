"""Adaptive function templates (TIDAL §4.2, Figure 11).

A template holds, per LLM function:

  1. the deduplicated kernel set traced from inference, what proactive
     code loading warms;
  2. the weight access order with a device-resident prefix whose size
     follows Eq. 1, the rest kept in the host pool and streamed during
     inference;
  3. per-weight init DFG fingerprints, so dynamic components (LoRA) are
     excluded incrementally: one trace cannot prove a weight static.

The port's copy of ``repro.core.template``; Eq. 1 is the cost model's
:func:`~repro_torch.core.costmodel.prefetch_bytes` over the port's H100
profile.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.costmodel import prefetch_bytes
from repro_torch.core.merging import plan_groups
from repro_torch.core.tracing import AccessTrace
from repro_torch.hw import HardwareProfile

# merge threshold: the paper merges when a model initializes "too many"
# tensors (Llama2-70B: 1200 -> 300); the same 4:1 reduction by default
MERGE_THRESHOLD = 512
MERGE_MAX_GROUPS = 300


@dataclasses.dataclass
class FunctionTemplate:
    function_id: str
    order: list                          # WeightKeys, access order
    sizes: dict                          # key -> bytes
    kernels: set                         # deduped (op, shape signature)
    fingerprints: dict                   # path -> init DFG fingerprint
    dynamic: set = dataclasses.field(default_factory=set)   # dynamic paths
    resident_bytes: int = 0              # Eq. 1 prefetch budget
    groups: list = dataclasses.field(default_factory=list)  # merge plan
    observed_ttft_s: Optional[float] = None
    n_observations: int = 0

    # ---- derived ---------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        return sum(self.sizes[k] for k in self.order)

    @property
    def static_order(self) -> list:
        return [k for k in self.order if k[0] not in self.dynamic]

    @property
    def dynamic_bytes(self) -> int:
        return sum(self.sizes[k] for k in self.order if k[0] in self.dynamic)

    def resident_set(self) -> set:
        """Access-order prefix of static weights within the Eq. 1 budget."""
        out, budget = set(), self.resident_bytes
        for k in self.static_order:
            if self.sizes[k] <= budget:
                out.add(k)
                budget -= self.sizes[k]
            else:
                break
        return out

    # ---- incremental refinement (strict-trace diffing) --------------------
    def observe_init(self, fingerprints: dict) -> set:
        """Diff a new invocation's init DFGs against the stored ones; a
        mismatch marks that weight dynamic from now on.  Returns the newly
        excluded paths."""
        new_dynamic = set()
        for path, fp in fingerprints.items():
            old = self.fingerprints.get(path)
            if old is None:
                self.fingerprints[path] = fp
            elif old != fp and path not in self.dynamic:
                new_dynamic.add(path)
        self.dynamic |= new_dynamic
        self.n_observations += 1
        return new_dynamic

    def observe_ttft(self, ttft_s: float, hw: HardwareProfile) -> None:
        """Adapt the template size to the measured TTFT (Eq. 1)."""
        if self.observed_ttft_s is None:
            self.observed_ttft_s = ttft_s
        else:  # EWMA over the function's workload
            self.observed_ttft_s = 0.8 * self.observed_ttft_s + 0.2 * ttft_s
        static_bytes = self.total_bytes - self.dynamic_bytes
        self.resident_bytes = min(
            prefetch_bytes(static_bytes, self.observed_ttft_s, hw), static_bytes)

    def replan_groups(self, max_groups: int = MERGE_MAX_GROUPS,
                      threshold: int = MERGE_THRESHOLD) -> None:
        self.groups = plan_groups(self.static_order, self.sizes,
                                  max_groups=max_groups, threshold=threshold)


def generate_template(function_id: str, trace: AccessTrace, sizes: dict,
                      fingerprints: dict, resident_bytes: int = 0,
                      max_groups: int = MERGE_MAX_GROUPS,
                      threshold: int = MERGE_THRESHOLD) -> FunctionTemplate:
    t = FunctionTemplate(
        function_id=function_id, order=list(trace.order), sizes=dict(sizes),
        kernels=set(trace.kernels), fingerprints=dict(fingerprints),
        resident_bytes=resident_bytes)
    t.replan_groups(max_groups=max_groups, threshold=threshold)
    return t
