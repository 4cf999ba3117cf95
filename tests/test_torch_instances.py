"""Several serving instances of the port (``ServingMesh(data, 1)``) on the
CPU, held against the JAX package.

The scenarios of the JAX runtime's multi-instance tests
(``tests/test_sharded_runtime.py``, which need a forced multi-device
host): placement of two functions on two instances, greedy tokens equal
to the JAX ``Engine``'s, locality routing of a warm function's new
engine, every instance's pool back at its baseline after ``evict``, the
mesh's axes checked; then resident buffers shared by instances on one
device, ``measure_smoke_service_times`` giving the JAX rig's kinds, and
a mesh with ``data > 1`` and ``model > 1`` refused naming its ROADMAP
item.  Smoke smollm-135m at 2 layers, fp32, the same weights in both
packages (``convert.params_from_jax``).
"""

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.runtime.faas as jax_faas  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro.runtime.engine import Engine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.core.forking import DonationGuard  # noqa: E402
from repro_torch.core.template_server import TemplateServer  # noqa: E402
from repro_torch.distributed import ServingMesh, serving_plan  # noqa: E402
from repro_torch.hw import H100_SXM  # noqa: E402
from repro_torch.models.registry import get_smoke_model  # noqa: E402
from repro_torch.runtime import faas as torch_faas  # noqa: E402
from repro_torch.runtime.faas import FaaSRuntime  # noqa: E402

MAX_LEN = 24


@pytest.fixture(scope="module")
def weights():
    jm = jax_smoke("smollm-135m", n_layers=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = get_smoke_model("smollm-135m", device="cpu", n_layers=2)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def mesh_runtime(weights):
    _, _, m, params = weights
    rt = FaaSRuntime(n_slots=2, max_len=MAX_LEN, trace_seq=8,
                     mesh=ServingMesh(2, 1), device="cpu")
    rt.deploy(tidal.static_function("fn-a", m, params), {}, prewarm_seq=8)
    rt.deploy(tidal.static_function("fn-b", m, params), {}, prewarm_seq=8)
    return m, params, rt


def _jax_tokens(weights, prompt, n):
    jm, jp, _, _ = weights
    return np.asarray(JaxEngine(jm, jp, donate_cache=False).generate(
        prompt[None], max_new_tokens=n, cache_len=MAX_LEN).tokens[0])


def test_instances_spread_functions_and_keep_parity(weights, mesh_runtime):
    m, _, rt = mesh_runtime
    assert [(i.idx, i.device.type) for i in rt.instances] == [(0, "cpu"),
                                                              (1, "cpu")]
    prompt = np.arange(10, dtype=np.int32) % m.cfg.vocab_size
    want = _jax_tokens(weights, prompt, 4)
    ra = rt.submit("fn-a", {}, prompt, 4)
    rb = rt.submit("fn-b", {}, prompt, 4)
    ra2 = rt.submit("fn-a", {}, prompt, 4)
    assert (ra.kind, rb.kind, ra2.kind) == ("cold", "cold", "warm")
    for r in (ra, rb, ra2):
        np.testing.assert_array_equal(r.tokens, want)
    # load-balanced placement: the two functions landed on different instances
    placed = {k[0]: w.instance for k, w in rt._engines.items()}
    assert placed["fn-a"] != placed["fn-b"]
    # one pool per (instance, model), and every instance's entry points
    # warmed at deploy (prefill and pool-shaped decode, once per model)
    assert sorted(k[0] for k in rt._pools) == [0, 1]
    assert rt.exe_cache.stats.misses == 4
    assert [(i["idx"], i["device"], i["engines"])
            for i in rt.stats()["instances"]] == [(0, "cpu", 1), (1, "cpu", 1)]


def test_instances_locality_routes_to_warm_instance(mesh_runtime):
    """A new engine of an already-warm function goes to the instance that
    holds its warm engine (ClusterSim's locality policy, live)."""
    m, _, rt = mesh_runtime
    rt.evict()
    prompt = np.arange(8, dtype=np.int32) % m.cfg.vocab_size
    rt.submit("fn-a", {"v": 0}, prompt, 2)
    rt.submit("fn-a", {"v": 1}, prompt, 2)      # same fn, new engine key
    insts = [w.instance for k, w in rt._engines.items() if k[0] == "fn-a"]
    assert len(insts) == 2 and insts[0] == insts[1]
    # an unrelated function goes to the other (least-loaded) instance
    rt.submit("fn-b", {}, prompt, 2)
    b_inst = [w.instance for k, w in rt._engines.items() if k[0] == "fn-b"]
    assert b_inst[0] != insts[0]


@pytest.mark.parametrize("extra_load, same", [(2, True), (0, False)])
def test_instances_locality_bounded_by_extra_load(weights, extra_load, same):
    """Locality holds while the warm instance is at most
    ``locality_max_extra_load`` engines busier than the least-loaded one."""
    _, _, m, params = weights
    rt = FaaSRuntime(n_slots=2, max_len=MAX_LEN, trace_seq=8,
                     mesh=ServingMesh(2, 1), prewarm=False, device="cpu",
                     locality_max_extra_load=extra_load)
    rt.deploy(tidal.static_function("fn-a", m, params), {})
    prompt = np.arange(8, dtype=np.int32)
    rt.submit("fn-a", {"v": 0}, prompt, 2)
    rt.submit("fn-a", {"v": 1}, prompt, 2)
    insts = [w.instance for k, w in rt._engines.items() if k[0] == "fn-a"]
    assert (insts[0] == insts[1]) is same


def test_instances_evict_restores_pool_baseline(mesh_runtime):
    m, _, rt = mesh_runtime
    rt.evict()
    baseline = rt.kv_pool_stats()
    assert sorted(k[0] for k in baseline) == [0, 1]
    assert all(st["n_free_slots"] == 2 for st in baseline.values())
    prompt = np.arange(6, dtype=np.int32)
    for _ in range(2):
        rt.submit("fn-a", {}, prompt, 2)
        rt.submit("fn-b", {}, prompt, 2)
        assert sorted(w.instance for w in rt._engines.values()) == [0, 1]
        rt.evict()
        assert rt.kv_pool_stats() == baseline


def test_serving_mesh_axes_validated():
    bad = types.SimpleNamespace(axis_names=("model",), shape={"model": 8})
    with pytest.raises(ValueError, match="data"):
        FaaSRuntime(mesh=bad, device="cpu")


def test_tensor_parallel_instances_raise_naming_item_8():
    """Several tensor-parallel instances serve now (test_torch_tp_instances
    .py): each data slice of ``ServingMesh(2, 2)`` has its plan (the
    slice's mesh, the instance on the data axis), and a runtime over the
    mesh asks for the spawned group of 2 x 2 ranks it runs in."""
    for instance in (0, 1):
        plan = serving_plan(ServingMesh(2, 2), rank=1, instance=instance)
        assert (plan.mesh, plan.rank, plan.instance) == (
            ServingMesh(1, 2), 1, instance)
    with pytest.raises(ValueError, match="outside the data axis"):
        serving_plan(ServingMesh(2, 2), rank=0, instance=2)
    with pytest.raises(RuntimeError, match="2 x 2 ranks"):
        FaaSRuntime(mesh=ServingMesh(2, 2), device="cpu")


def test_instances_on_one_device_share_resident_buffers(weights):
    """Two instances on one device fork from ONE set of resident buffers:
    not copied per instance, counted once, and unwritten by either
    instance's invocations (the forking guard)."""
    _, _, m, params = weights
    # no host link to stream over, so that Eq. 1 keeps every weight resident
    server = TemplateServer(hw=H100_SXM.with_h2d(0.0), trace_seq=8)
    rt = FaaSRuntime(server=server, n_slots=2, max_len=MAX_LEN,
                     mesh=ServingMesh(2, 1), prewarm=False, device="cpu")
    rt.deploy(tidal.static_function("fn-a", m, params), {})
    total = rt.server.templates["fn-a"].total_bytes
    rt.server.set_resident_bytes("fn-a", total)
    resident = dict(rt.server.device_cache["fn-a"])
    used = rt.server.device_bytes_used()
    assert len(resident) == len(rt.server.templates["fn-a"].order)
    assert used == total == sum(t.numel() * t.element_size()
                                    for t in resident.values())
    guard = DonationGuard.guard(resident)
    prompt = np.arange(8, dtype=np.int32)
    rt.submit("fn-a", {"v": 0}, prompt, 3)
    rt.submit("fn-a", {"v": 1}, prompt, 3)
    rt.locality_max_extra_load = -1               # force the other instance
    rt.submit("fn-a", {"v": 2}, prompt, 3)
    insts = sorted(w.instance for w in rt._engines.values())
    assert insts == [0, 0, 1]
    for w in rt._engines.values():
        session = w.engine.session
        for path, t in resident.items():
            assert session.leaf(path).data_ptr() == t.data_ptr()
    assert rt.server.device_bytes_used() == used
    assert guard.check(resident) == []


def test_measure_smoke_service_times_kinds_match_jax():
    fns = {"s": "static", "l": "lora"}
    jm = jax_faas.measure_smoke_service_times(fns, n_layers=1, max_len=16,
                                              trace_seq=8, prompt_len=8,
                                              max_new_tokens=2)
    tm = torch_faas.measure_smoke_service_times(fns, n_layers=1, max_len=16,
                                                trace_seq=8, prompt_len=8,
                                                max_new_tokens=2,
                                                device="cpu")

    def kinds(m):
        return {fn: {k: [length for length, _ in v] for k, v in d.items()}
                for fn, d in m.times.items()}

    assert kinds(tm) == kinds(jm)
    assert kinds(tm)["s"] == {"cold": [8], "fork": [8], "warm": [8]}
    assert tm.measured_prompt_len == jm.measured_prompt_len == 8
    assert all(s > 0 for d in tm.times.values() for v in d.values()
               for _, s in v)


def test_resident_buffers_placed_once_per_other_device(weights):
    """On another device than the function's model's, the resident prefix
    is placed once and reused by every later fork there, counted apart,
    and dropped when residency changes (``meta`` stands in for a second
    card)."""
    _, _, m, params = weights
    rt = FaaSRuntime(n_slots=2, max_len=MAX_LEN, trace_seq=8, prewarm=False,
                     device="cpu")
    rt.deploy(tidal.static_function("fn-a", m, params), {})
    server = rt.server
    total = server.templates["fn-a"].total_bytes
    server.set_resident_bytes("fn-a", total // 2)
    base = server.device_bytes_used()
    other = torch.device("meta")
    first = server._resident_for("fn-a", other)
    assert first.keys() == server.device_cache["fn-a"].keys()
    assert all(t.device == other for t in first.values())
    again = server._resident_for("fn-a", other)
    assert all(again[p] is first[p] for p in first)
    assert server.device_bytes_used() == 2 * base
    assert server.model_on("fn-a", other).device == other
    assert server.model_on("fn-a", "cpu") is m
    server.set_resident_bytes("fn-a", total // 4)
    assert server.device_bytes_used() < base
    assert all(server._resident_for("fn-a", other)[p] is not first[p]
               for p in server.device_cache["fn-a"])


def test_serve_cli_serves_two_instances_on_the_cpu():
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--instances", "2", "--layers", "2", "--functions", "3",
         "--requests", "6", "--prompt-len", "16", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=str(root), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "instances: 2 on ['cpu', 'cpu']" in res.stdout
    per = [l for l in res.stdout.splitlines()
           if l.startswith("warm engines per instance")]
    engines = json.loads(per[0].split(":", 1)[1])
    assert len(engines) == 2 and all(n > 0 for n in engines)
    assert len([l for l in res.stdout.splitlines()
                if l.startswith("req")]) == 6
