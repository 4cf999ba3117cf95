"""Serving runtime of the port.

  errors      — typed-failure taxonomy (RuntimeFailure base)
  faults      — deterministic fault-injection plane (FaultPlan, fault_point)
  engine      — token samplers (sample_greedy, sample_token)
  kv_pool     — PagedKVCachePool: block-paged KV arena with page tables,
                refcounts, copy-on-write PrefixHandles, owner leases and
                an int8 mode
  prefix      — PrefixIndex: page-granular token-hash chain matching
  continuous  — ContinuousBatchingEngine over the paged arena
"""

from repro_torch.runtime.continuous import (ContinuousBatchingEngine, Request,
                                            RequestOutput)
from repro_torch.runtime.engine import sample_greedy, sample_token
from repro_torch.runtime.errors import (AdapterLoadFault, DeadlineExceeded,
                                        DecodeFault, EngineFailure,
                                        EngineStepFault, InjectedFault,
                                        InvocationCancelled, Overloaded,
                                        PartitionViolation, PoolExhausted,
                                        PrefillFault, RuntimeFailure,
                                        WeightFetchFault)
from repro_torch.runtime.faults import (INJECTION_POINTS, FaultPlan, FaultSpec,
                                        fault_point, install_fault_plan,
                                        use_fault_plan)
from repro_torch.runtime.kv_pool import PagedKVCachePool, PrefixHandle
from repro_torch.runtime.prefix import PrefixIndex

__all__ = [
    "AdapterLoadFault", "ContinuousBatchingEngine", "DeadlineExceeded",
    "DecodeFault", "EngineFailure", "EngineStepFault", "FaultPlan",
    "FaultSpec", "INJECTION_POINTS", "InjectedFault", "InvocationCancelled",
    "Overloaded", "PagedKVCachePool", "PartitionViolation", "PoolExhausted",
    "PrefillFault", "PrefixHandle", "PrefixIndex", "Request", "RequestOutput",
    "RuntimeFailure", "WeightFetchFault", "fault_point", "install_fault_plan",
    "sample_greedy", "sample_token", "use_fault_plan",
]
