"""The port's cost model and workload plans, held against the JAX package
on the CPU.

``repro_torch.core.plans.plan_for`` traces each full config on ``meta``
tensors; its access order (mapped through ``convert.jax_key``), sizes and
stages must equal ``repro.core.plans.plan_for``'s, and every TTFT strategy
of the port's cost model over the port's plan must equal the JAX cost
model's over the JAX plan on the paper's A6000 testbed (relative 1e-12).
Then ``tests/test_costmodel.py``'s behavioural claims run on the port.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro.core import costmodel as jax_cm  # noqa: E402
from repro.core import plans as jax_plans  # noqa: E402
from repro.hw import A6000_PCIE4 as JAX_HW  # noqa: E402
from repro_torch import hw as torch_hw  # noqa: E402
from repro_torch.convert import jax_key  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core.plans import kernel_set_for, plan_for  # noqa: E402
from repro_torch.hw import A6000_PCIE4 as HW  # noqa: E402

ARCHS = ["llama3-8b", "zamba2-2.7b", "xlstm-1.3b", "phi3.5-moe-42b-a6.6b",
         "whisper-medium", "deepseek-v3-671b"]
SHAPES = [(1, 2048), (4, 512)]
REL = 1e-12


def _close(a, b) -> bool:
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches_jax(arch):
    for batch, seq in SHAPES:
        port = plan_for(arch, batch, seq)
        ref = jax_plans.plan_for(arch, batch, seq)
        assert [jax_key(k[0]) for k in port.order] == ref.order
        assert {jax_key(k[0]): v for k, v in port.sizes.items()} == ref.sizes
        assert port.total_weight_bytes == ref.total_weight_bytes
        assert len(port.stages) == len(ref.stages)
        for s, r in zip(port.stages, ref.stages):
            assert [jax_key(k[0]) for k in s.keys] == r.keys
            assert s.weight_bytes == r.weight_bytes
            assert _close(s.flops, r.flops) and _close(s.io_bytes, r.io_bytes)


def _strategies(cm_, plan, hw):
    """Every TTFT strategy and option of one cost model over one plan."""
    total = plan.total_weight_bytes
    out = {"execution": cm_.ttft_execution(plan, hw),
           "execution_tp2": cm_.ttft_execution(plan, hw, tp=2),
           "pin": cm_.ttft_load_then_infer(plan, hw),
           "sllm": cm_.ttft_load_then_infer(plan, hw, host_factor=1.02),
           "pin_warm_tp4": cm_.ttft_load_then_infer(plan, hw, tp=4,
                                                    cold_kernels=False)}
    for order in ("traced", "default", "reverse"):
        for n_groups in (None, 300, 4):
            out[f"tidal_{order}_{n_groups}"] = cm_.ttft_tidal(
                plan, hw, order=order, n_groups=n_groups)
    for frac in (0.0, 0.3, 1.0):
        out[f"tidal_tpl{frac}"] = cm_.ttft_tidal(
            plan, hw, template_bytes=int(total * frac),
            dynamic_bytes=int(total * 0.01))
    out["tidal_cold_kernels"] = cm_.ttft_tidal(plan, hw, prewarmed=False)
    out["tidal_tp4"] = cm_.ttft_tidal(plan, hw, tp=4, template_bytes=total // 8)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_ttft_strategies_match_jax(arch):
    port = plan_for(arch, 1, 2048)
    ref = jax_plans.plan_for(arch, 1, 2048)
    got, want = _strategies(cm, port, HW), _strategies(jax_cm, ref, JAX_HW)
    assert got.keys() == want.keys()
    for name in got:
        for field in ("total", "load", "compute", "cold_kernel",
                      "dynamic_init"):
            a, b = getattr(got[name], field), getattr(want[name], field)
            assert _close(a, b), (name, field, a, b)
    assert _close(port.compute_time(HW), ref.compute_time(JAX_HW))
    assert cm.tidal_warm_bytes(port) == jax_cm.tidal_warm_bytes(ref)
    for ttft in (0.0, 0.05, 0.3, 10.0):
        assert (cm.prefetch_bytes(port.total_weight_bytes, ttft, HW)
                == jax_cm.prefetch_bytes(ref.total_weight_bytes, ttft, JAX_HW))


def test_profiles_match_jax():
    """The paper's testbeds carry the reference's numbers; the card's
    profile keeps its data-sheet rates and the reference's fixed costs."""
    import repro.hw as jax_hw
    for name in ("a6000-pcie4", "a100-pcie3"):
        assert (vars(torch_hw.get_profile(name))
                == vars(jax_hw.get_profile(name)))
    h100 = torch_hw.H100_SXM
    assert h100.name in torch_hw.PROFILES and "tpu-v5e" not in torch_hw.PROFILES
    assert (h100.peak_flops_bf16, h100.hbm_bandwidth) == (989e12, 3.35e12)
    assert h100.kernel_cold_load_s == JAX_HW.kernel_cold_load_s
    measured = h100.with_h2d(25e9)
    assert measured.host_to_device_bw == 25e9
    assert measured.interconnect_bw == h100.interconnect_bw


def test_kernel_set_is_traced_on_meta():
    kernels = kernel_set_for("llama3-8b")
    names = {k[0] for k in kernels}
    assert {"flash_attention", "rmsnorm"} <= names


# ---------------------------------------------------------------------------
# tests/test_costmodel.py's claims, on the port
# ---------------------------------------------------------------------------

def _strategy_ordering(p):
    """execution <= tidal-warm <= tidal-0g <= pin <= serverlessllm."""
    exe = cm.ttft_execution(p, HW).total
    warm = cm.ttft_tidal(p, HW, template_bytes=p.total_weight_bytes).total
    t0g = cm.ttft_tidal(p, HW, template_bytes=0).total
    sllm = cm.ttft_load_then_infer(p, HW, host_factor=1.02).total
    pin = cm.ttft_load_then_infer(p, HW).total
    assert exe <= warm <= t0g <= pin <= sllm


def _paper_speedup_range(p):
    """Fig. 13: Tidal-0G ~1.79x-2.11x faster than ServerlessLLM."""
    t0g = cm.ttft_tidal(p, HW, template_bytes=0,
                        dynamic_bytes=int(p.total_weight_bytes * 0.01)).total
    sllm = cm.ttft_load_then_infer(p, HW, host_factor=1.02).total
    assert 1.5 < sllm / t0g < 2.6, sllm / t0g


def _template_size_monotone(p):
    vals = [cm.ttft_tidal(p, HW, template_bytes=g << 30).total
            for g in (0, 2, 4, 8, 16)]
    assert all(a >= b - 1e-9 for a, b in zip(vals, vals[1:]))


def _workload_turning_point(p):
    big = plan_for("llama3-8b", 8, 4096)
    t0 = cm.ttft_tidal(big, HW, template_bytes=0).total
    tw = cm.ttft_tidal(big, HW, template_bytes=big.total_weight_bytes).total
    assert (t0 - tw) / tw < 0.05
    small = plan_for("llama3-8b", 1, 256)
    t0s = cm.ttft_tidal(small, HW, template_bytes=0).total
    tws = cm.ttft_tidal(small, HW,
                        template_bytes=small.total_weight_bytes).total
    assert t0s > tws * 1.2


def _loading_order_ablation(p):
    tr = cm.ttft_tidal(p, HW, order="traced").total
    assert tr < cm.ttft_tidal(p, HW, order="default").total
    assert tr < cm.ttft_tidal(p, HW, order="reverse").total


def _merging_reduces_overhead(p):
    plan = plan_for("qwen2.5-32b", 1, 512)
    assert (cm.ttft_tidal(plan, HW, n_groups=300).total
            <= cm.ttft_tidal(plan, HW, n_groups=None).total)


def _tp_speeds_up(p):
    assert cm.ttft_tidal(p, HW, tp=4).total < cm.ttft_tidal(p, HW, tp=1).total


def _cold_kernel_penalty(p):
    warm = cm.ttft_tidal(p, HW, prewarmed=True).total
    cold = cm.ttft_tidal(p, HW, prewarmed=False).total
    assert 0 < cold - warm <= HW.kernel_cold_load_s + 1e-9


def _tidal_ttft_bounds(p):
    lo = cm.ttft_execution(p, HW).total
    for tb in (0, 1 << 30, 1 << 34, 1 << 36):
        for db in (0, 1 << 20, 1 << 30):
            t = cm.ttft_tidal(p, HW, template_bytes=tb, dynamic_bytes=db)
            hi = (cm.ttft_load_then_infer(p, HW).total + db / HW.storage_bw
                  + 1.0)
            assert lo <= t.total <= hi


def _stage_partition_complete(p):
    assert sum(s.weight_bytes for s in p.stages) == p.total_weight_bytes
    assert all(s.flops > 0 for s in p.stages)
    # one stage per layer between the embedding and the head
    assert len(p.stages) == 32 + 2


CLAIMS = [_strategy_ordering, _paper_speedup_range, _template_size_monotone,
          _workload_turning_point, _loading_order_ablation,
          _merging_reduces_overhead, _tp_speeds_up, _cold_kernel_penalty,
          _tidal_ttft_bounds, _stage_partition_complete]


@pytest.mark.parametrize("claim", CLAIMS, ids=lambda f: f.__name__[1:])
def test_costmodel_claims_on_the_port(claim):
    claim(plan_for("llama3-8b", 1, 2048))
