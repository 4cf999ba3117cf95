"""Serving runtime of the port.

  errors      — typed-failure taxonomy (RuntimeFailure base)
  faults      — deterministic fault-injection plane (FaultPlan, fault_point)
  engine      — sequential Engine (the dense-cache reference) and samplers
  kv_pool     — KVCachePool (dense slots) and PagedKVCachePool: block-paged
                KV arena with page tables, refcounts, copy-on-write
                PrefixHandles, owner leases and an int8 mode
  prefix      — PrefixIndex: page-granular token-hash chain matching
  continuous  — ContinuousBatchingEngine over either pool, serving warm
                params or a forked session with layer-streamed prefill
  gateway     — InvocationGateway: tickets, quanta, deadlines, cancel,
                crash supervision and brown-out
  controlplane — ControlPlane: arrival forecasting, predictive prewarm and
                keep-alive, runtime-learned prefix bakes under a budget
  faas        — FaaSRuntime: deploy, cold/fork/warm invocations, keep-alive,
                shared-base adapter serving, measured service times
"""

from repro_torch.runtime.continuous import (ContinuousBatchingEngine, Request,
                                            RequestOutput)
from repro_torch.runtime.controlplane import (ArrivalPredictor, ControlPlane,
                                              EwmaHistogramPredictor,
                                              PrefixObserver, trace_schedule)
from repro_torch.runtime.engine import (Engine, GenerationResult,
                                        sample_greedy, sample_temperature,
                                        sample_token)
from repro_torch.runtime.errors import (AdapterLoadFault, DeadlineExceeded,
                                        DecodeFault, EngineFailure,
                                        EngineStepFault, InjectedFault,
                                        InvocationCancelled, Overloaded,
                                        PartitionViolation, PoolExhausted,
                                        PrefillFault, RuntimeFailure,
                                        WeightFetchFault)
from repro_torch.runtime.faas import (FaaSRuntime, MeasuredServiceTimes,
                                     measure_service_times)
from repro_torch.runtime.faults import (INJECTION_POINTS, FaultPlan, FaultSpec,
                                        fault_point, install_fault_plan,
                                        use_fault_plan)
from repro_torch.runtime.gateway import (InvocationGateway, InvocationHandle,
                                         InvocationRequest, SubmitResult)
from repro_torch.runtime.kv_pool import (KVCachePool, PagedKVCachePool,
                                         PrefixHandle)
from repro_torch.runtime.prefix import PrefixIndex

__all__ = [
    "AdapterLoadFault", "ArrivalPredictor", "ContinuousBatchingEngine",
    "ControlPlane", "DeadlineExceeded", "DecodeFault", "Engine",
    "EngineFailure", "EngineStepFault", "EwmaHistogramPredictor",
    "FaaSRuntime", "FaultPlan", "FaultSpec", "GenerationResult",
    "INJECTION_POINTS", "InjectedFault", "InvocationCancelled",
    "InvocationGateway", "InvocationHandle", "InvocationRequest",
    "KVCachePool", "MeasuredServiceTimes", "Overloaded", "PagedKVCachePool",
    "PartitionViolation", "PoolExhausted", "PrefillFault", "PrefixHandle",
    "PrefixIndex", "PrefixObserver", "Request", "RequestOutput",
    "RuntimeFailure", "SubmitResult", "WeightFetchFault", "fault_point",
    "install_fault_plan", "measure_service_times", "sample_greedy",
    "sample_temperature",
    "sample_token", "trace_schedule", "use_fault_plan",
]
