"""Deterministic fault-injection plane for the serving runtime.

Production failures (a crashed engine, a torn weight fetch, a wedged
adapter load) are rare and unrepeatable; this module makes them cheap
and *deterministic* so the supervision layer can be tested and gated.
The runtime is instrumented with named injection points — calls to
:func:`fault_point` at the five places work can die:

==================  ====================================================
point               site
==================  ====================================================
``weight_fetch``    per weight-slice fetch (the fork path's streamer)
``prefill_chunk``   admission prefill and each chunked-prefill chunk
``decode_quantum``  immediately before a batched decode step
``adapter_load``    adapter bank-row load (``set_adapter``)
``engine_step``     top of ``ContinuousBatchingEngine.step``
==================  ====================================================

A :class:`FaultPlan` schedules typed :class:`~repro_torch.runtime.errors.
InjectedFault` subclasses against those points by visit count (optionally
filtered by the site's detail string), or by seeded Bernoulli coin flips
(:meth:`FaultPlan.bernoulli`).  With no plan installed every
``fault_point`` call is a near-free no-op, so the hooks stay in
production code paths.

The active plan is process-global (``install_fault_plan`` /
:func:`use_fault_plan`), *not* thread-local, because faults must reach
work executing on the gateway's background pump thread and the weight
streamer's fetch thread.

Under tensor parallelism (``distributed.group``: one process per rank,
rank 0 the controller) installing, uninstalling and resetting a plan are
mirrored ops: every rank of every instance holds a copy of the plan, so
a point visited INSIDE a device op fires at the same visit on every rank
of the instance, the op raises the same type everywhere and the workers
serve on.  The points split so:

==================  ====================================================
point               where it is visited under tensor parallelism
==================  ====================================================
``weight_fetch``    inside an op, on every rank: a fork session's
                    streamer (``core.streaming``), started by the
                    template server's ``fork`` op; its retries run alike
                    on every rank
``prefill_chunk``   on the controller only, before the prefill op is
                    broadcast (``runtime.continuous``)
``decode_quantum``  on the controller only, before the decode op
``adapter_load``    on the controller only, before ``set_adapter``'s op
``engine_step``     on the controller only (the engine loop is host state)
==================  ====================================================

With several instances (``ServingMesh(K, N)``) each instance has a copy
of its own: instance ``i``'s ranks use it, and so does the controller
when it runs instance ``i``'s ops on its shadows, since one shared
counter would count visits that instance ``i``'s ranks never make.  The
installed plan is instance 0's copy and counts the controller-only
points of every instance (one counter, as in one process); its
``fired`` merges the other copies' logs, each entry marked with its
``instance``.  (The reference runs every instance in one process, where
one counter takes the instances' visits in thread order.)
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.distributed.group import current_group, mirrored
from repro_torch.runtime.errors import (
    AdapterLoadFault,
    DecodeFault,
    EngineStepFault,
    InjectedFault,
    PrefillFault,
    WeightFetchFault,
)

__all__ = [
    "INJECTION_POINTS",
    "FaultSpec",
    "FaultPlan",
    "fault_point",
    "install_fault_plan",
    "use_fault_plan",
    "active_fault_plan",
]

INJECTION_POINTS: Tuple[str, ...] = (
    "weight_fetch",
    "prefill_chunk",
    "decode_quantum",
    "adapter_load",
    "engine_step",
)

_FAULT_TYPES = {
    "weight_fetch": WeightFetchFault,
    "prefill_chunk": PrefillFault,
    "decode_quantum": DecodeFault,
    "adapter_load": AdapterLoadFault,
    "engine_step": EngineStepFault,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fail visits ``[at, at + times)`` of a point.

    Visits are counted *per spec* and only over visits whose detail
    string contains ``match`` (when set), so a spec can target e.g. "the
    second chunk of request 3" without counting interleaved decode
    admissions.  ``times > 1`` models a persistent fault (it keeps firing
    across retries until the schedule runs out), which is how transient
    vs permanent fetch failures are distinguished in tests.

    Attributes:
        point: injection-point name (one of :data:`INJECTION_POINTS`).
        at: 0-based index of the first matching visit that fails.
        times: number of consecutive matching visits that fail.
        match: optional substring filter applied to the site detail.
    """

    point: str
    at: int
    times: int = 1
    match: Optional[str] = None

    def __post_init__(self):
        """Validate the point name and schedule bounds."""
        if self.point not in INJECTION_POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r}; "
                f"expected one of {INJECTION_POINTS}")
        if self.at < 0 or self.times < 1:
            raise ValueError(f"need at >= 0 and times >= 1, got {self}")


class FaultPlan:
    """A seeded, deterministic schedule of typed faults.

    The plan is a pure function of its specs (and, for
    :meth:`bernoulli`, the seed): replaying the same workload against
    the same plan fires the same faults at the same visits, which is
    what lets the recovery benchmark compare supervised vs unsupervised
    runs under *identical* fault schedules.  ``check`` is thread-safe;
    visit counters are per spec.

    Attributes:
        specs: the scheduled :class:`FaultSpec` entries.
        seed: seed recorded for provenance (used by :meth:`bernoulli`).
        counts: total visits observed per injection point.
        fired: log of fired faults (dicts with point/detail/spec/visit).
    """

    def __init__(self, specs: Iterable[FaultSpec] = (), seed: int = 0):
        """Build a plan from explicit specs.

        Args:
            specs: fault schedule entries (see :class:`FaultSpec`).
            seed: provenance seed (informational for explicit specs).
        """
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._spec_visits = [0] * len(self.specs)
        self.counts: Dict[str, int] = {p: 0 for p in INJECTION_POINTS}
        self._fired: List[dict] = []
        # the controller's copies for instances 1.. of a ServingMesh(K, N)
        self.instance_copies: Dict[int, "FaultPlan"] = {}

    # a plan crosses a tensor-parallel channel by value (distributed.group)
    mirror_by_value = True

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        del state["_lock"]
        state["instance_copies"] = {}
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def copy(self) -> "FaultPlan":
        """A copy with its own counters and log (at this plan's state)."""
        out = FaultPlan.__new__(FaultPlan)
        out.__setstate__(self.__getstate__())
        out._spec_visits = list(self._spec_visits)
        out.counts = dict(self.counts)
        out._fired = list(self._fired)
        return out

    @property
    def fired(self) -> List[dict]:
        """The fired faults: this plan's, then each instance copy's with
        its ``instance``."""
        out = list(self._fired)
        for i, c in sorted(self.instance_copies.items()):
            out.extend(dict(e, instance=i) for e in c._fired)
        return out

    @classmethod
    def bernoulli(cls, seed: int, rates: Dict[str, float],
                  horizon: int = 2048) -> "FaultPlan":
        """Pre-draw per-visit coin flips into an explicit schedule.

        Deterministic function of ``(seed, rates, horizon)``: the same
        arguments always yield the same schedule, independent of runtime
        timing.  Visits beyond ``horizon`` never fail.

        Args:
            seed: RNG seed for ``numpy.random.default_rng``.
            rates: per-point failure probability in [0, 1]; points not
                listed never fail.
            horizon: number of visits per point to pre-draw.

        Returns:
            A new :class:`FaultPlan` with one single-visit spec per
            losing coin flip.
        """
        import numpy as np

        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []
        for point in INJECTION_POINTS:  # fixed draw order => reproducible
            draws = rng.random(horizon)
            rate = float(rates.get(point, 0.0))
            if rate <= 0.0:
                continue
            for i in np.flatnonzero(draws < rate):
                specs.append(FaultSpec(point, at=int(i)))
        return cls(specs, seed=seed)

    def reset(self) -> "FaultPlan":
        """Zero all visit counters and the fired log; return ``self``.
        The installed plan is reset on every rank (a mirrored op)."""
        if self is _active_plan:
            _reset_active()
        else:
            self._reset_local()
        return self

    def _reset_local(self) -> None:
        with self._lock:
            self._spec_visits = [0] * len(self.specs)
            self.counts = {p: 0 for p in INJECTION_POINTS}
            self._fired = []
        for c in self.instance_copies.values():
            c._reset_local()

    def check(self, point: str, detail: str = "") -> None:
        """Count one visit of ``point``; raise if a spec schedules it.

        Args:
            point: injection-point name being visited.
            detail: site-specific detail string (matched against each
                spec's ``match`` filter and recorded on the fault).

        Raises:
            ValueError: if ``point`` is not a known injection point.
            InjectedFault: the point's typed subclass, when a spec's
                schedule covers this visit.  Even when several specs
                cover the same visit only one fault is raised, but every
                matching spec's counter still advances.
        """
        if point not in INJECTION_POINTS:
            raise ValueError(f"unknown injection point {point!r}")
        hit: Optional[Tuple[int, int]] = None
        with self._lock:
            self.counts[point] += 1
            for i, spec in enumerate(self.specs):
                if spec.point != point:
                    continue
                if spec.match is not None and spec.match not in detail:
                    continue
                visit = self._spec_visits[i]
                self._spec_visits[i] += 1
                if hit is None and spec.at <= visit < spec.at + spec.times:
                    hit = (i, visit)
            if hit is not None:
                self._fired.append({
                    "point": point,
                    "detail": detail,
                    "spec": hit[0],
                    "visit": hit[1],
                })
        if hit is not None:
            raise _FAULT_TYPES[point](
                f"injected {point} fault (spec {hit[0]}, visit {hit[1]})"
                f"{': ' + detail if detail else ''}",
                point=point, detail=detail)


_active_plan: Optional[FaultPlan] = None
_active_lock = threading.Lock()


@mirrored()
def _install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Set the active plan on this rank (every rank of every instance
    under tensor parallelism; the controller keeps a copy per other
    instance for the ops it runs on that instance's shadows); returns
    the old one."""
    global _active_plan
    group = current_group()
    if (plan is not None and group is not None and group.is_controller
            and group.n_instances > 1):
        plan.instance_copies = {i: plan.copy()
                                for i in range(1, group.n_instances)}
    with _active_lock:
        prev, _active_plan = _active_plan, plan
    return prev


@mirrored()
def _reset_active() -> None:
    if _active_plan is not None:
        _active_plan._reset_local()


def install_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` process-wide (``None`` uninstalls); return the old
    one.  Under tensor parallelism every rank installs a copy."""
    return _install(plan)


def active_fault_plan(instance: Optional[int] = None) -> Optional[FaultPlan]:
    """Return the currently installed plan, or ``None``; on a controller
    running another instance's op (or given that ``instance``), that
    instance's copy of it."""
    plan = _active_plan
    if plan is None or not plan.instance_copies:
        return plan
    if instance is None:
        group = current_group()
        instance = None if group is None else group.op_instance()
    return plan.instance_copies.get(instance, plan)


@contextlib.contextmanager
def use_fault_plan(plan: FaultPlan):
    """Install ``plan`` for the duration of a with-block (all threads see it).

    Args:
        plan: the schedule to activate.

    Yields:
        The installed plan (handy for inspecting ``plan.fired`` after).
    """
    prev = install_fault_plan(plan)
    try:
        yield plan
    finally:
        install_fault_plan(prev)


def fault_point(point: str, detail: str = "",
                instance: Optional[int] = None) -> None:
    """Visit a named injection point; no-op unless a plan is installed.

    Args:
        point: injection-point name (one of :data:`INJECTION_POINTS`).
        detail: site-specific context string for matching and logging.
        instance: the serving instance whose copy of the plan counts the
            visit (a thread started inside an op names the op's; None:
            the op running on this thread, else the installed plan).

    Raises:
        InjectedFault: when the active plan schedules this visit.
    """
    plan = active_fault_plan(instance)
    if plan is not None:
        plan.check(point, detail)
