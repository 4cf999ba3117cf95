"""The port's analytic step counts and roofline terms, held against the
JAX package on the CPU.

``repro_torch.launch.analytic_cost.step_cost`` counts over ``meta``
parameters and caches; it must equal ``repro.launch.analytic_cost``'s for
every (arch, shape) cell of the registry.  ``model_flops_estimate`` and
``terms_from_analytic`` (on the paper's A6000 profile) equal the JAX
ones, and the roofline fraction divides by the profile it was given.
Also ``core.tracing.total_order_bytes`` and ``core.forking.
guarded_paths`` against their JAX counterparts.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.forking as jax_forking  # noqa: E402
import repro.core.tracing as jax_tracing  # noqa: E402
import repro.launch.analytic_cost as jax_cost  # noqa: E402
import repro.launch.roofline as jax_roofline  # noqa: E402
import repro.models.registry as jax_registry  # noqa: E402
from repro.hw import A6000_PCIE4 as JAX_HW  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import forking, tracing  # noqa: E402
from repro_torch.hw import A6000_PCIE4, H100_SXM  # noqa: E402
from repro_torch.launch import analytic_cost, roofline  # noqa: E402
from repro_torch.models import registry  # noqa: E402

CELLS = registry.cells()
MFE_ARCHS = ["llama3-8b", "smollm-135m", "phi3.5-moe-42b-a6.6b",
             "deepseek-v3-671b", "zamba2-2.7b", "whisper-medium"]


def test_cells_and_shapes_match_jax():
    assert CELLS == jax_registry.cells()
    assert registry.SHAPES == jax_registry.SHAPES
    for arch in registry.ARCH_IDS:
        assert (registry.long_context_capable(registry.get_config(arch))
                == jax_registry.long_context_capable(
                    jax_registry.get_config(arch)))


@pytest.mark.parametrize("arch, shape", CELLS)
def test_step_cost_matches_jax(arch, shape):
    got = analytic_cost.step_cost(arch, shape)
    want = jax_cost.step_cost(arch, shape)
    assert got.flops == want.flops and got.hbm_bytes == want.hbm_bytes


@pytest.mark.parametrize("arch", MFE_ARCHS)
def test_model_flops_and_roofline_terms_match_jax(arch):
    for mode, batch, seq in (("train", 256, 4096), ("prefill", 32, 32768),
                             ("decode", 128, 32768)):
        mf = roofline.model_flops_estimate(arch, mode, batch, seq)
        assert mf == jax_roofline.model_flops_estimate(arch, mode, batch, seq)
    shape = "prefill_32k"
    cost = analytic_cost.step_cost(arch, shape)
    mf = roofline.model_flops_estimate(arch, "prefill", 32, 32768)
    for chips, coll in ((1, 0.0), (4, 3e9)):
        got = roofline.terms_from_analytic(cost.flops, cost.hbm_bytes, coll,
                                           chips, mf, hw=A6000_PCIE4)
        want = jax_roofline.terms_from_analytic(cost.flops, cost.hbm_bytes,
                                                coll, chips, mf, hw=JAX_HW)
        for field in ("compute_s", "memory_s", "collective_s", "hlo_flops",
                      "hlo_bytes", "coll_bytes", "model_flops",
                      "useful_ratio"):
            assert getattr(got, field) == getattr(want, field), field
        assert got.dominant == want.dominant and got.total_s == want.total_s
        # the fraction divides by the profile the terms were taken on
        assert math.isclose(got.roofline_fraction,
                            mf / chips / A6000_PCIE4.peak_flops_bf16
                            / got.total_s, rel_tol=1e-12)


def test_roofline_defaults_to_the_card():
    terms = roofline.terms_from_analytic(989e12, 3.35e12, 0.0, 1, 989e12)
    assert terms.hw is H100_SXM
    assert terms.compute_s == terms.memory_s == 1.0
    assert terms.roofline_fraction == 1.0


@pytest.fixture(scope="module")
def smoke_params():
    jm = jax_registry.get_smoke_model("smollm-135m", n_layers=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = registry.get_smoke_model("smollm-135m", device="cpu", n_layers=2)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return jm, jp, tm, tp


def test_total_order_bytes_matches_jax(smoke_params):
    jm, jp, tm, tp = smoke_params
    jspecs = jm.init_params(abstract=True)
    jtrace = jax_tracing.trace_weight_access(
        lambda p, i, c: jm.prefill(p, i, c), jspecs,
        jm.input_specs("prefill", 1, 16), jm.make_cache(1, 16, abstract=True))
    tspecs = tm.param_specs()
    ttrace = tracing.trace_weight_access(
        lambda p, i, c: tm.prefill(p, i, c), tspecs,
        tm.input_specs("prefill", 1, 16), tm.make_cache(1, 16, device="meta"))
    got = tracing.total_order_bytes(tspecs, ttrace)
    assert got == jax_tracing.total_order_bytes(jspecs, jtrace) > 0


def test_guarded_paths_matches_jax(smoke_params):
    _, jp, _, tp = smoke_params
    jax_paths = ["embed", "blocks.attn.wq", "final_norm"]
    port_paths = ["embed", "final_norm"] + convert.port_names(
        "blocks.attn.wq", 2)
    want = jax_forking.guarded_paths(jp, jax_paths)
    got = forking.guarded_paths(tp, port_paths + ["no.such.leaf"])
    assert sorted(got) == sorted(port_paths)
    assert {k: v.shape for k, v in want.items()}["blocks.attn.wq"][0] == 2
    for path in ("embed", "final_norm"):
        np.testing.assert_array_equal(got[path].numpy(),
                                      np.asarray(want[path]))
    for i, name in enumerate(convert.port_names("blocks.attn.wq", 2)):
        assert got[name] is tp["layers"][i]["attn"]["wq"]
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want["blocks.attn.wq"][i]))
