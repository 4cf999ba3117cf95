"""Ranks of the tensor-parallel instances: spawning, process groups, and
the controller/worker channels (the port's counterpart of
``repro.launch.mesh``).

The JAX package is one program over sharded arrays.  The port runs one
process per rank.  Global rank 0 is the CONTROLLER: it alone holds the
host stack (``FaaSRuntime``, the gateway, the engines' queues, sampling
and every clock read).  The other ranks are WORKERS: they hold their
shard of every device object and wait in :meth:`TPGroup.serve` for the
controller's orders.

The unit of an order is a device operation of the layer below the
engines: a model call, a KV pool method, a template-server method, a
fork session's parameters or streamed prefill, an adapter bank's rows.
Those functions carry the :func:`mirrored` decorator.  On the
controller, a top-level call of one broadcasts ``(op, host arguments)``
on a CPU gloo group and then runs locally; each worker runs the same
function with the same arguments on its own objects, and the model
calls meet in their collectives.  Calls nested inside an op run locally
on every rank (each rank runs the same outer op).  Host state below the
engines (page tables, refcounts, residency) is therefore identical on
every rank as long as every op ends alike on every rank, and everything
above it, which reads clocks and threads, exists on the controller
only: it cannot make two ranks diverge.

SEVERAL INSTANCES (``spawn(..., data=K)``, a ``ServingMesh(K, tp)``):
ranks ``[i tp, (i + 1) tp)`` are instance ``i``, with a process group of
their own for their collectives and a control channel of their own,
whose gloo group holds them and the controller.  The controller is rank
0 of instance 0 and ORDERS THE OTHER INSTANCES' GROUPS WITHOUT BEING A
MEMBER OF THEM: for an op of instance ``i > 0`` it runs the op locally on
SHADOWS, its own copies of that instance's objects built on the
``meta`` device (a model, pools, fork sessions, adapter banks of the
rank-0 shapes, with no storage and no kernel launch).  The shadows run
the same host code, so their page tables, refcounts and residency are
the instance's; the one device value the controller reads, a model
call's logits (``mirrored(values=...)``), comes from the instance's first
rank after the op.  An op goes to the instances its arguments belong to:
objects made by an op carry the instances they were filed on, a model
its plan's instance, and ``mirrored(route=...)`` names a plan argument
that picks the instance (``TemplateServer.fork(plan=)``); an op with none
of these (a template server's registration, Eq. 1 feedback) goes to
every instance.  An object of one instance never crosses to another's
ranks: its encoding raises.  With one instance (``data = 1``) there is
one channel and every op runs exactly as it did before instances.

After every op the ranks of each channel exchange its outcome (it
returned, or the type it raised).  An op that raised the same type on
every rank (a request too large for a slot, say) leaves the same state
everywhere: the controller's caller gets the error and the workers
serve on.  Any other outcome (one rank out of memory, the controller
raising after the op was broadcast) raises :class:`DivergenceError` on
every rank of that channel, with the tracebacks of the ranks that
raised; a worker lets it leave :meth:`TPGroup.serve`, so that
:func:`spawn` reports it.  A rank that raises before a collective the
others wait in is seen when that collective times out (``spawn``'s
``collective_timeout_s``).

Arguments cross as host values: ints, numpy arrays, small tensors (a
token batch, a page table), CPU tensors by value (an adapter's factors),
models by their configuration, and device objects by reference.  A
device object (a cache, a parameter tree, a pool, a fork session, a
prefix handle, an adapter bank) made by an op is registered under a
number on every rank of its instances; the controller's handle of it
carries that number (``_mid``), and when the controller drops the handle
the workers drop their object at the next op.  Bulk tensors never cross
the channel.

``guard=True`` (the tests and ``chip_smoke.py`` set it) adds the
divergence guard: before each op every rank hashes the op, its
arguments and the host state of every object it touches (a pool's page
table, refcounts and free lists; a tensor by its shape and dtype, a
cache leaf's head axis left out, since ranks of heads split unevenly
hold other counts of heads), and the outcome the ranks exchange after
it carries the hash of the result's host part.  A mismatch raises
:class:`DivergenceError` on every rank of the channel instead of a hang
inside a later collective.

TRAINING is SPMD: every rank runs the loop and none serves.  A rank
function calls :meth:`TPGroup.training_plan` (its model-axis group, its
data-axis group, the ranks of its model index in every data slice, and
the world), after which no op is broadcast and :meth:`TPGroup.close`
sends nothing.

``spawn(fn, tp, ..., data=K)`` starts ``K tp`` ranks with
``torch.multiprocessing`` over a ``tcp://127.0.0.1`` store, runs
``fn(group, *args)`` on each and returns rank 0's result.  Rank ``r``
uses ``cuda:(r % device_count)``: on one card every rank shares it.  The
backend is an argument, never a fallback: NCCL refuses two ranks on one
device ("Duplicate GPU detected"), so one card takes ``gloo``.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import hashlib
import importlib
import inspect
import os
import pickle
import queue as _queue
import socket
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import (ServingMesh, ShardingPlan,
                                              cache_head_axis, serving_plan)

_GROUP: Optional["TPGroup"] = None
# device tensors at most this many elements cross the channel by value
SMALL_TENSOR = 1 << 16
# where the controller builds its shadows of another instance's objects
SHADOW_DEVICE = torch.device("meta")


class DivergenceError(RuntimeError):
    """Ranks disagreed on an op or its outcome (the divergence guard)."""


def current_group() -> Optional["TPGroup"]:
    """This process's tensor-parallel group (None outside :func:`spawn`)."""
    return _GROUP


# ---------------------------------------------------------------------------
# mirrored ops
# ---------------------------------------------------------------------------

def mirrored(register: tuple = (), gather: Optional[str] = None,
             values: Optional[str] = None, route: Optional[str] = None):
    """Make a function (or method) a device op of the channels.

    ``register`` names the results every rank files under a new number:
    ``'return'``, ``'return.0'`` (a tuple's first item), ``'self'`` and
    ``'self.cache'`` (a constructor's object and its arena).  ``gather``
    names a result whose host value every rank sends to the controller,
    which sets the list on it as ``per_rank``.  ``values`` names a device
    result the controller reads (a model call's logits): when it ran the
    op on shadows, the instance's first rank sends the value's bytes.
    ``route`` names a plan argument whose instance the op goes to."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            group = _GROUP
            if group is None or not group.broadcasts():
                return fn(*args, **kwargs)
            return group.call(fn, wrapper, args, kwargs)
        wrapper._mirror_register = tuple(register)
        wrapper._mirror_gather = gather
        wrapper._mirror_values = values
        wrapper._mirror_route = route
        wrapper._mirror_sig = inspect.signature(fn) if route else None
        return wrapper
    return deco


def _resolve_op(name: str) -> tuple:
    """(the op's wrapper, its owner: the class of a method or the module)."""
    module, _, qual = name.partition(":")
    obj = importlib.import_module(module)
    owner = obj
    for part in qual.split("."):
        owner, obj = obj, getattr(obj, part)
    return obj, owner


class MirrorDict(dict):
    """A registered tree of device tensors on the controller (a plain dict
    cannot carry the number its workers file it under)."""


@dataclasses.dataclass(frozen=True)
class _Ref:
    mid: int


@dataclasses.dataclass(frozen=True)
class _ModelRef:
    cfg: Any


@dataclasses.dataclass(frozen=True)
class _PlanRef:
    """The rank's own sharding plan."""


@dataclasses.dataclass(frozen=True)
class _Small:
    """A small device tensor sent by value (placed on the worker's device)."""
    value: torch.Tensor


_NEW = "__new_object__"
_CLOSE = "__close__"


def _path(path: str, key) -> str:
    return f"{path}.{key}" if path else str(key)


def _digest(obj, path: str = "") -> str:
    """Host state of an op's object (at ``path`` in a tree) for the
    divergence guard."""
    fn = getattr(obj, "mirror_digest", None)
    if fn is not None:
        return fn()
    if isinstance(obj, torch.Tensor):
        # a cache leaf's head axis left out: the ranks of heads split
        # unevenly (``sharding.head_split``) hold other counts of heads
        shape = list(obj.shape)
        axis = cache_head_axis(path, obj.dim())
        if axis is not None:
            shape[axis] = "heads"
        return f"tensor{tuple(shape)}{obj.dtype}"
    if isinstance(obj, dict):
        return "{" + ",".join(f"{k}:{_digest(v, _path(path, k))}"
                              for k, v in obj.items()) + "}"
    return type(obj).__name__


def _host_summary(x) -> Any:
    """The part of a result that must agree across ranks (device values
    differ: each rank holds its shard)."""
    if isinstance(x, (tuple, list)):
        return [_host_summary(v) for v in x]
    if isinstance(x, (int, float, bool, str, type(None))):
        return x
    if isinstance(x, np.ndarray):
        return x.tolist()
    return _digest(x)


def _hash(x) -> str:
    return hashlib.sha1(repr(x).encode()).hexdigest()


def _instances_of(x, depth: int = 0) -> Optional[frozenset]:
    """The instances an op argument belongs to (None: any)."""
    if isinstance(getattr(x, "_mid", None), int):
        return getattr(x, "_chans", None)
    from repro_torch.models.registry import Model
    if isinstance(x, Model):
        return None if x.plan is None else frozenset((x.plan.instance,))
    if depth < 4 and isinstance(x, (dict, list, tuple)):
        out = None
        for v in (x.values() if isinstance(x, dict) else x):
            s = _instances_of(v, depth + 1)
            if s is not None:
                out = s if out is None else out & s
        return out
    return None


class Channel:
    """The control channel of one instance's ranks (see the module doc):
    on a worker its loop, on the controller one per instance."""

    def __init__(self, group: "TPGroup", idx: int, ctrl_group,
                 remote: bool):
        import torch.distributed as dist
        self.group = group
        self.idx = idx                       # the instance it reaches
        self.ctrl_group = ctrl_group
        self.n_members = (dist.get_world_size(ctrl_group)
                          if ctrl_group is not None else 1)
        # the controller is not a rank of this instance: it runs shadows
        # and reads device values from the instance's first rank
        self.remote = remote
        self.lead = idx * group.size         # that first rank (global)
        self.objs: dict = {}                 # worker: number -> object
        self.models: dict = {}               # worker: config -> Model
        self._frees: list = []
        self._seq = 0
        self.broken = False
        self.n_ops = 0
        # worker: the ops that raised here and on the controller alike,
        # with their tracebacks
        self.failures: list = []

    # ---- controller -------------------------------------------------------
    def _encode(self, x):
        mid = getattr(x, "_mid", None)
        if isinstance(mid, int):
            chans = getattr(x, "_chans", None)
            if chans is not None and self.idx not in chans:
                raise ValueError(
                    f"a {type(x).__name__} of instance {sorted(chans)} "
                    f"cannot cross to instance {self.idx}'s ranks")
            return _Ref(mid)
        from repro_torch.models.registry import Model
        if isinstance(x, Model):
            return _ModelRef(x.cfg)
        if isinstance(x, ShardingPlan):
            return _PlanRef()
        if getattr(x, "mirror_by_value", False):
            return x                         # a host object (a FaultPlan)
        if isinstance(x, torch.Tensor):
            if x.device.type == "cpu":
                return x
            if x.is_meta:
                raise TypeError(
                    f"a {tuple(x.shape)} shadow (meta) tensor has no value "
                    "to send: pass host arrays to another instance's ops")
            if x.numel() > SMALL_TENSOR:
                raise TypeError(
                    f"a {tuple(x.shape)} device tensor would cross the "
                    "channel: bulk tensors must be device objects made by "
                    "an op on every rank")
            return _Small(x.cpu())
        if isinstance(x, dict):
            return {k: self._encode(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            out = [self._encode(v) for v in x]
            return out if isinstance(x, list) else tuple(out)
        if isinstance(x, (int, float, bool, str, bytes, type(None),
                          np.ndarray, np.generic, torch.dtype)):
            return x
        raise TypeError(f"{type(x).__name__} cannot cross the channel")

    def _send(self, msg) -> None:
        import torch.distributed as dist
        box = [msg]
        dist.broadcast_object_list(box, src=0, group=self.ctrl_group)

    def send_op(self, op: str, args: tuple, kwargs: dict, mids: list,
                init: bool) -> int:
        """Order one op on this channel's workers; returns its number."""
        enc = ((_NEW,) + tuple(self._encode(a) for a in args[1:]) if init
               else tuple(self._encode(a) for a in args))
        enc_kwargs = self._encode(kwargs)
        frees, self._frees = self._frees, []
        self._seq += 1
        self._send((self._seq, op, enc, enc_kwargs, mids, frees))
        self.n_ops += 1
        return self._seq

    def _gather(self, obj) -> list:
        """Every member's ``obj`` on the controller (its own dropped where
        it ran a shadow); None on a worker."""
        import torch.distributed as dist
        controller = self.group.is_controller
        out = [None] * self.n_members
        dist.gather_object(obj, out if controller else None, dst=0,
                           group=self.ctrl_group)
        if not controller:
            return None
        return out[1:] if self.remote else out

    def _value(self, result, args, sel: str, send: bool):
        """Move the bytes of a result's device value from the instance's
        first rank to the controller, which replaces its shadow's."""
        import torch.distributed as dist
        t = _select(result, args, sel)
        if send:
            buf = t.detach().contiguous().cpu()
            dist.send(buf.reshape(-1).view(torch.uint8), dst=0,
                      group=self.ctrl_group)
            return result
        buf = torch.empty(tuple(t.shape), dtype=t.dtype)
        dist.recv(buf.reshape(-1).view(torch.uint8), src=self.lead,
                  group=self.ctrl_group)
        return _replace(result, args, sel, buf)

    def _check(self, seq, op, *parts) -> None:
        """The divergence guard: every rank's hash of the op (and the host
        state it touches), compared on every rank before it runs."""
        import torch.distributed as dist
        mine = _hash((seq, op, [_digest_args(p) for p in parts]))
        hashes = [None] * self.n_members
        dist.all_gather_object(hashes, mine, group=self.ctrl_group)
        if len(set(hashes)) != 1:
            self.broken = True
            raise DivergenceError(
                f"op {seq} ({op}) diverged before running: rank hashes "
                f"{[h[:12] for h in hashes]}")

    def _outcome(self, seq, op, result=None, error=None) -> None:
        """Every rank's outcome of an op (guard or not), compared on every
        rank: it returned (with its host part's hash under the guard) or
        raised a type.  Any difference raises :class:`DivergenceError`."""
        import torch.distributed as dist
        if error is None:
            mine = ("returned",
                    _hash(_host_summary(result)) if self.group.guard else "")
            tb = ""
        else:
            mine = ("raised", type(error).__name__)
            tb = "".join(traceback.format_exception(error))
        outs = [None] * self.n_members
        dist.all_gather_object(outs, (mine, tb), group=self.ctrl_group)
        if len({o for o, _ in outs}) != 1:
            self.broken = True
            raise DivergenceError(
                f"op {seq} ({op}) ended differently on the ranks: "
                f"{[o for o, _ in outs]}" + "".join(
                    f"\nrank {r} raised:\n{t}" for r, (_, t) in enumerate(outs)
                    if t))

    def close(self) -> None:
        """Stop the workers (the controller's last order)."""
        if not self.broken and self.n_members > 1:
            self._send((0, _CLOSE, (), {}, [], []))

    # ---- worker -----------------------------------------------------------
    def _decode(self, x):
        if isinstance(x, _Ref):
            return self.objs[x.mid]
        if isinstance(x, _ModelRef):
            key = pickle.dumps(x.cfg)
            if key not in self.models:
                from repro_torch.models.registry import Model
                self.models[key] = Model(x.cfg, self.group.device,
                                         plan=self.group.plan)
            return self.models[key]
        if isinstance(x, _PlanRef):
            return self.group.plan
        if isinstance(x, _Small):
            return x.value.to(self.group.device)
        if isinstance(x, dict):
            return {k: self._decode(v) for k, v in x.items()}
        if isinstance(x, list):
            return [self._decode(v) for v in x]
        if isinstance(x, tuple):
            return tuple(self._decode(v) for v in x)
        return x

    def _file(self, result, args, register, mids) -> Any:
        for sel, mid in zip(register, mids):
            obj = _select(result, args, sel)
            if isinstance(obj, dict) and not isinstance(obj, MirrorDict):
                obj = MirrorDict(obj)
                result = _replace(result, args, sel, obj)
            self.objs[mid] = obj
        return result

    def serve(self) -> int:
        """Run the controller's ops until it closes the channel; returns
        the number of ops run."""
        import torch.distributed as dist
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self.ctrl_group)
            seq, op, args, kwargs, mids, frees = box[0]
            for mid in frees:
                self.objs.pop(mid, None)
            if op == _CLOSE:
                return self.n_ops
            self.n_ops += 1
            wrapper, owner = _resolve_op(op)
            fn = wrapper.__wrapped__
            init = bool(args) and isinstance(args[0], str) and args[0] == _NEW
            args, kwargs = self._decode(args[init:]), self._decode(kwargs)
            if init:
                args = (object.__new__(owner),) + args
            if self.group.guard:
                self._check(seq, op, args[init:], kwargs)
            try:
                result = fn(*args, **kwargs)
            except Exception as e:
                # serve on only when the controller raised the same
                self._outcome(seq, op, error=e)
                self.failures.append((seq, op, traceback.format_exc()))
                continue
            self._outcome(seq, op, result=result)
            result = self._file(result, args, wrapper._mirror_register, mids)
            if wrapper._mirror_gather is not None:
                self._gather(_select(result, args, wrapper._mirror_gather))
            if (wrapper._mirror_values is not None and self.remote
                    and self.group.rank == 0):
                self._value(result, args, wrapper._mirror_values, send=True)


def _digest_args(x, path: str = ""):
    if isinstance(x, (list, tuple)):
        return [_digest_args(v, path) for v in x]
    if isinstance(x, dict) and not isinstance(x, MirrorDict):
        return {k: _digest_args(v, _path(path, k))
                for k, v in sorted(x.items())}
    if isinstance(x, (int, float, bool, str, type(None))):
        return x
    if isinstance(x, np.ndarray):
        return x.tolist()
    if (isinstance(x, torch.Tensor) and not x.is_meta
            and x.numel() <= SMALL_TENSOR):
        return x.cpu().tolist()
    return _digest(x, path)


def _select(result, args, sel: str):
    if sel == "return":
        return result
    if sel == "return.0":
        return result[0]
    if sel == "return.1":
        return result[1]
    if sel == "self":
        return args[0]
    if sel == "self.cache":
        return args[0].cache
    raise ValueError(f"unknown selector {sel!r}")


def _replace(result, args, sel: str, obj):
    if sel == "return":
        return obj
    if sel in ("return.0", "return.1"):
        items = list(result)
        items[int(sel[-1])] = obj
        return tuple(items)
    if sel == "self.cache":
        args[0].cache = obj
        return result
    raise ValueError(f"{sel!r} cannot be replaced")


# ---------------------------------------------------------------------------
# the ranks of the instances, as one process sees them
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Gathered:
    value: Any


def _call_named(op: str, args: tuple):
    return _resolve_op(op)[0](*args)


@mirrored(gather="return")
def _on_every_rank(op: str, args: tuple) -> _Gathered:
    return _Gathered(_call_named(op, args))


@mirrored(register=("return",))
def _built_on_every_rank(op: str, args: tuple):
    return _call_named(op, args)


class TPGroup:
    """One process's view of the ranks: its instance's group (``rank`` on
    its model axis of ``size`` ranks, ``instance`` on the data axis of
    ``mesh``) and, on the controller, a channel to every instance."""

    def __init__(self, rank: int, size: int, device, backend: str,
                 data_group=None, ctrl_group=None, guard: bool = False,
                 mesh: Optional[ServingMesh] = None, instance: int = 0,
                 global_rank: Optional[int] = None,
                 remote_ctrl_groups: Optional[dict] = None,
                 data_axis_group=None, world_group=None):
        self.rank, self.size = rank, size
        self.instance = instance
        self.global_rank = rank if global_rank is None else global_rank
        self.device = torch.device(device)
        self.backend = backend
        self.data_group, self.ctrl_group = data_group, ctrl_group
        # training's groups: the ranks of this model index in every data
        # slice, and every rank
        self.data_axis_group, self.world_group = data_axis_group, world_group
        self.spmd = False
        self.guard = guard
        self.mesh = mesh or ServingMesh(1, size)
        self.plan = serving_plan(self.mesh, rank=rank, group=data_group,
                                 instance=instance)
        self.channel = Channel(self, instance, ctrl_group,
                               remote=instance > 0)
        self.channels = [self.channel]
        # the controller's plans per instance: its own, then the shadows'
        # (rank 0 of the instance, no process group: it is no member)
        self.plans = [self.plan]
        if self.is_controller:
            for i in range(1, self.mesh.data):
                self.channels.append(Channel(self, i, remote_ctrl_groups[i],
                                             remote=True))
                self.plans.append(serving_plan(self.mesh, rank=0,
                                               group=None, instance=i))
        self._next = 1
        self._lock = threading.RLock()
        self._local = threading.local()
        self._bound = 0
        self.closed = False

    @property
    def is_controller(self) -> bool:
        return self.global_rank == 0

    @property
    def n_instances(self) -> int:
        return self.mesh.data

    def device_of(self, instance: int) -> torch.device:
        """Where this process holds instance ``instance``'s objects: its
        device for its own, the shadow device for another's."""
        return self.device if instance == self.instance else SHADOW_DEVICE

    # ---- the controller's side of an op ------------------------------------
    def broadcasts(self) -> bool:
        """True for a top-level op on the controller (never once the
        group trains)."""
        return (self.is_controller and self.mesh.size > 1 and not self.spmd
                and not getattr(self._local, "depth", 0))

    def _route(self, fn, wrapper, args, kwargs) -> list:
        """The channels of the instances the op goes to (see the module
        doc)."""
        if len(self.channels) == 1:
            return self.channels
        want = None
        if wrapper._mirror_route is not None:
            plan = wrapper._mirror_sig.bind(*args, **kwargs).arguments.get(
                wrapper._mirror_route)
            if plan is not None:
                want = frozenset((plan.instance,))
        if want is None:
            init = fn.__name__ == "__init__"
            want = _instances_of((tuple(args[init:]), kwargs))
        if want is None:
            return self.channels
        if not want:
            raise ValueError(f"{fn.__qualname__}: its arguments belong to "
                             "different instances")
        return [self.channels[i] for i in sorted(want)]

    def call(self, fn, wrapper, args, kwargs):
        with self._lock:
            chans = self._route(fn, wrapper, args, kwargs)
            for ch in chans:
                if ch.broken:
                    raise DivergenceError(
                        f"instance {ch.idx}'s channel is broken: an earlier "
                        "op diverged")
            self._local.depth = 1
            self._local.instance = chans[0].idx if len(chans) == 1 else None
            try:
                return self._call(fn, wrapper, args, kwargs, chans)
            finally:
                self._local.depth = 0
                self._local.instance = None

    def op_instance(self) -> Optional[int]:
        """The instance of the op this thread runs on the controller (None
        outside an op, on a worker, or for an op sent to every instance)."""
        return getattr(self._local, "instance", None)

    def _call(self, fn, wrapper, args, kwargs, chans):
        op = f"{fn.__module__}:{fn.__qualname__}"
        init = fn.__name__ == "__init__"
        register = wrapper._mirror_register
        mids = list(range(self._next, self._next + len(register)))
        self._next += len(register)
        seqs = [ch.send_op(op, args, kwargs, mids, init) for ch in chans]
        if self.guard:
            for ch, seq in zip(chans, seqs):
                ch._check(seq, op, args[init:], kwargs)
        try:
            result = fn(*args, **kwargs)
        except BaseException as e:
            for ch, seq in zip(chans, seqs):
                ch._outcome(seq, op, error=e)
            raise
        for ch, seq in zip(chans, seqs):
            ch._outcome(seq, op, result=result)
        where = frozenset(ch.idx for ch in chans)
        for sel, mid in zip(register, mids):
            obj = _select(result, args, sel)
            if isinstance(obj, dict) and not isinstance(obj, MirrorDict):
                obj = MirrorDict(obj)
                result = _replace(result, args, sel, obj)
            obj._mid, obj._chans = mid, where
            f = weakref.finalize(obj, self._free, mid, where)
            f.atexit = False
        if wrapper._mirror_gather is not None:
            obj = _select(result, args, wrapper._mirror_gather)
            obj.per_rank = tuple(v for ch in chans for v in ch._gather(obj))
        if wrapper._mirror_values is not None and chans[0].remote:
            result = chans[0]._value(result, args, wrapper._mirror_values,
                                     send=False)
        return result

    def _free(self, mid: int, where) -> None:
        for i in where:
            self.channels[i]._frees.append(mid)

    # ---- API ----------------------------------------------------------------
    def bind(self, obj):
        """File an object every rank built itself (in the same order on
        every rank, before the workers serve) under one number, on every
        instance; returns the controller's handle (a dict becomes a
        :class:`MirrorDict`)."""
        self._bound -= 1
        if isinstance(obj, dict) and not isinstance(obj, MirrorDict):
            obj = MirrorDict(obj)
        if self.is_controller:
            obj._mid, obj._chans = self._bound, None
            f = weakref.finalize(obj, self._free, self._bound,
                                 range(len(self.channels)))
            f.atexit = False
        else:
            self.channel.objs[self._bound] = obj
        return obj

    def serve(self) -> int:
        """A worker's loop: run the controller's ops until it closes."""
        if self.is_controller:
            raise RuntimeError("the controller does not serve a loop")
        return self.channel.serve()

    def gather(self, fn: Callable, *args) -> list:
        """``fn(*args)`` on every rank of the instances ``args`` belong to
        (every rank without such an argument), a module-level function of
        host results; the list of results on the controller, in rank
        order."""
        res = _on_every_rank(f"{fn.__module__}:{fn.__qualname__}", args)
        return [r.value for r in getattr(res, "per_rank", (res,))]

    def build(self, fn: Callable, *args):
        """``fn(*args)`` on every rank of the instances ``args`` belong to
        (a module-level function that makes a device object, such as a
        function over the rank's shard of the weights), filed under one
        number; the controller's result."""
        return _built_on_every_rank(f"{fn.__module__}:{fn.__qualname__}",
                                    args)

    def training_plan(self, fsdp: bool = False, mode: str = "tp"):
        """This rank's plan of the whole mesh for training (SPMD: from
        here on every rank runs its own loop, and no op is broadcast)."""
        from repro_torch.distributed.sharding import training_plan
        self.spmd = True
        return training_plan(self.mesh, rank=self.rank,
                             data_rank=self.instance, group=self.data_group,
                             data_group=self.data_axis_group,
                             world_group=self.world_group, fsdp=fsdp,
                             mode=mode)

    def close(self) -> None:
        """The controller's last order: the workers leave :meth:`serve`."""
        if self.spmd:
            self.closed = True
        if self.is_controller and not self.closed:
            self.closed = True
            with self._lock:
                for ch in self.channels:
                    ch.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, tp, data, port, backend, device, guard, timeout_s, fn,
               args, queue):
    global _GROUP
    import torch.distributed as dist
    try:
        world = data * tp
        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // world)))
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass "
                                   "device='cpu' to run the ranks on the CPU")
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        timeout = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world, timeout=timeout)
        # a control channel waits for the controller's next op for as
        # long as the controller serves: its timeout is a day
        day = datetime.timedelta(days=1)
        instance, local = divmod(rank, tp)
        # every rank makes every group, in the same order
        data_groups, ctrls = [], []
        for i in range(data):
            ranks = list(range(i * tp, (i + 1) * tp))
            data_groups.append(dist.new_group(ranks, backend=backend,
                                              timeout=timeout))
            ctrls.append(dist.new_group(sorted({0, *ranks}),
                                        backend="gloo", timeout=day))
        data_group = data_groups[instance]
        # training's data-axis groups (the ranks of one model index) and
        # the world (every rank makes them, in the same order)
        axis_groups = [dist.new_group(list(range(m, world, tp)),
                                      backend=backend, timeout=timeout)
                       if data > 1 else None for m in range(tp)]
        world_group = (dist.new_group(list(range(world)), backend=backend,
                                      timeout=timeout)
                       if data > 1 else data_group)
        if dev.type == "cuda":
            # one build of the kernel library, before any rank loads it
            from repro_torch.kernels import _build
            if rank == 0:
                _build.build()
            dist.barrier(group=dist.new_group(backend="gloo", timeout=day))
        _GROUP = TPGroup(local, tp, dev, backend, data_group, ctrls[instance],
                         guard=guard, mesh=ServingMesh(data, tp),
                         instance=instance, global_rank=rank,
                         remote_ctrl_groups=dict(enumerate(ctrls)),
                         data_axis_group=axis_groups[local],
                         world_group=world_group)
        out = fn(_GROUP, *args)
        _GROUP.close()
        queue.put(("ok", rank, out if rank == 0 else None))
        dist.destroy_process_group()
    except BaseException:
        queue.put(("err", rank, traceback.format_exc()))
        raise


def spawn(fn: Callable, tp: int, args: tuple = (), *, data: int = 1,
          backend: str = "gloo", device="cuda", guard: bool = False,
          timeout_s: float = 3600.0, collective_timeout_s: float = 600.0):
    """Run ``fn(group, *args)`` on ``data * tp`` new rank processes
    (``data`` instances of ``tp`` ranks) and return rank 0's result
    (``fn`` a module-level function; ``args`` picklable).

    Rank 0 is the controller; a worker's ``fn`` calls ``group.serve()``.
    A rank that fails stops the others and raises here with its
    traceback; so does ``timeout_s``.  A collective that waits longer
    than ``collective_timeout_s`` raises in its rank."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    world = data * tp
    procs = [ctx.Process(target=_rank_main,
                         args=(r, tp, data, port, backend, str(device), guard,
                               collective_timeout_s, fn, args, queue),
                         name=f"tp-rank{r}")
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    t_end = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < world:
            try:
                kind, rank, value = queue.get(timeout=0.2)
                (results if kind == "ok" else errors)[rank] = value
            except _queue.Empty:
                pass
            if errors:
                break
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            if dead:
                time.sleep(0.5)
                while not queue.empty():
                    kind, rank, value = queue.get()
                    (results if kind == "ok" else errors)[rank] = value
                for p in dead:
                    errors.setdefault(procs.index(p),
                                      f"exited with code {p.exitcode}")
                break
            if time.monotonic() > t_end:
                errors[-1] = f"timed out after {timeout_s} s"
                break
    finally:
        if errors:
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("tensor-parallel ranks failed:\n" + "\n".join(
            f"rank {r}: {msg}" for r, msg in sorted(errors.items())))
    return results[0]
