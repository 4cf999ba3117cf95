"""Typed failure taxonomy for the serving runtime.

Every failure the runtime raises *on purpose* derives from
:class:`RuntimeFailure`, so callers can write one ``except RuntimeFailure``
arm for "the runtime declined or lost this work" while real bugs
(``TypeError``, assertion failures, ...) still propagate loudly.  The
classes mirror ``repro.runtime.errors`` one for one; ``kv_pool``
re-exports the two it raises (``repro_torch.runtime.kv_pool.PoolExhausted``
*is* ``repro_torch.runtime.errors.PoolExhausted``).

The taxonomy splits into three families:

* **capacity** — :class:`PoolExhausted`, :class:`Overloaded`,
  :class:`DeadlineExceeded`: the work was well-formed but the runtime
  had no room (or no time) for it.  Retryable by the caller.
* **supervision** — :class:`EngineFailure`: an engine crashed
  mid-quantum and its partition lease was retired; the gateway's
  supervisor raises this only after bounded retries are exhausted.
* **injection** — :class:`InjectedFault` and its per-point subclasses,
  raised by the deterministic fault plane (``repro_torch.runtime.faults``)
  to exercise the supervision paths above.

:class:`PartitionViolation` doubles as a ``PermissionError``.
"""

from __future__ import annotations

__all__ = [
    "RuntimeFailure",
    "PoolExhausted",
    "DeadlineExceeded",
    "InvocationCancelled",
    "Overloaded",
    "EngineFailure",
    "PartitionViolation",
    "InjectedFault",
    "WeightFetchFault",
    "PrefillFault",
    "DecodeFault",
    "AdapterLoadFault",
    "EngineStepFault",
]


class RuntimeFailure(RuntimeError):
    """Base class of every typed failure the serving runtime raises."""


class PoolExhausted(RuntimeFailure):
    """No free slot (or free pages) for an allocation.

    Raised by the KV pools when admission would overcommit the arena and
    by handles whose request was dropped for lack of capacity.  Admission
    layers treat it as "defer and retry later", not as a bug.
    """


class DeadlineExceeded(RuntimeFailure):
    """The request's queueing deadline expired before any token was produced.

    Shed requests never prefilled, so retrying them on a warm engine is
    safe and cheap.
    """


class InvocationCancelled(RuntimeFailure):
    """The invocation was cancelled (by the caller or by engine teardown)."""


class Overloaded(RuntimeFailure):
    """Admission rejected: the gateway's bounded in-flight queue is full.

    Raised at ``submit()`` time when ``max_live`` invocations are already
    in flight and the new arrival does not outrank any queued work.  The
    caller should back off and resubmit; nothing was admitted.
    """


class EngineFailure(RuntimeFailure):
    """An engine crashed mid-quantum and its partition lease was retired.

    The supervisor in ``InvocationGateway`` converts a crash into clean
    teardown (all partition pages returned, co-tenants untouched) and
    bounded retry; handles only surface ``EngineFailure`` once retries
    are exhausted or the crash is unrecoverable (e.g. the scheduling
    loop itself died).  ``__cause__`` carries the original exception.
    """


class PartitionViolation(RuntimeFailure, PermissionError):
    """A tenant touched a slot owned by another partition (or by nobody).

    Subclasses ``PermissionError`` so callers that predate the
    consolidated taxonomy (``except PermissionError``) still catch it.
    """


class InjectedFault(RuntimeFailure):
    """Base of the typed faults raised by the deterministic fault plane.

    Attributes:
        point: the named injection point that fired (one of
            ``repro_torch.runtime.faults.INJECTION_POINTS``).
        detail: the site-specific detail string passed to
            ``fault_point`` (request id, chunk cursor, weight key, ...).
    """

    def __init__(self, message: str = "", point: str = "", detail: str = ""):
        """Record the firing site alongside the human-readable message.

        Args:
            message: human-readable description of the scheduled fault.
            point: injection-point name that fired.
            detail: site detail string active at the firing visit.
        """
        super().__init__(message)
        self.point = point
        self.detail = detail


class WeightFetchFault(InjectedFault):
    """Injected failure of one weight-slice fetch inside the streamer."""


class PrefillFault(InjectedFault):
    """Injected crash at admission prefill or between prefill chunks."""


class DecodeFault(InjectedFault):
    """Injected crash immediately before a batched decode step."""


class AdapterLoadFault(InjectedFault):
    """Injected failure of an adapter bank-row load."""


class EngineStepFault(InjectedFault):
    """Injected crash at the top of an engine step (before any work)."""
