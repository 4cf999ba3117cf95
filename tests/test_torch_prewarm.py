"""The prewarm queries (``k in cache``, ``ExecutableCache.keys()``,
``ProcessPool.is_prewarmed``) of both packages, on the CPU.

The JAX package's own checks (tests/test_prewarm.py and the deploy check
of tests/test_runtime.py) run against ``repro.core.prewarm`` and
``repro_torch.core.prewarm`` alike: the same prewarm gives the same keys,
membership and pool answers, and a deploy through either ``FaaSRuntime``
(the port's with ``device="cpu"``) leaves exactly the prefill and
decode-pool entry points in its executable cache.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.api as jax_api  # noqa: E402
import repro.core.prewarm as jax_prewarm  # noqa: E402
import repro.runtime.faas as jax_faas  # noqa: E402
import repro_torch.core.api as torch_api  # noqa: E402
import repro_torch.core.prewarm as torch_prewarm  # noqa: E402
import repro_torch.runtime.faas as torch_faas  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402

MAX_LEN = 32


@pytest.fixture(scope="module")
def pkgs():
    jm = jax_smoke("smollm-135m", n_layers=2)
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return {
        "jax": types.SimpleNamespace(
            prewarm=jax_prewarm, api=jax_api, model=jm, params=jp,
            pool=lambda size, cache: jax_prewarm.ProcessPool(size, cache),
            runtime=jax_faas.FaaSRuntime),
        "torch": types.SimpleNamespace(
            prewarm=torch_prewarm, api=torch_api, model=tm, params=tp,
            pool=lambda size, cache: torch_prewarm.ProcessPool(
                size, cache, device="cpu"),
            runtime=lambda **kw: torch_faas.FaaSRuntime(device="cpu", **kw)),
    }


@pytest.fixture(scope="module")
def prewarmed(pkgs):
    out = {}
    for name, P in pkgs.items():
        cache = P.prewarm.ExecutableCache()
        keys = P.prewarm.prewarm_function(cache, P.model, "fn", batch=1, seq=16,
                                          max_len=MAX_LEN)
        out[name] = (cache, keys)
    return out


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_prewarmed_keys_are_in_the_cache(prewarmed, pkg):
    cache, keys = prewarmed[pkg]
    assert len(keys) == 2 and cache.stats.misses == 2
    assert all(k in cache for k in keys)
    assert ("other", "prefill", 1, 1, 1) not in cache
    assert sorted(cache.keys()) == sorted(keys)
    assert prewarmed["jax"][1] == prewarmed["torch"][1]   # the same keys


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_pool_is_prewarmed(pkgs, prewarmed, pkg):
    """Workers hold the keys of the functions cached on this host (the
    §5.1 loading policy); a key never loaded, or a worker whose context is
    not up, is not prewarmed."""
    cache, keys = prewarmed[pkg]
    pool = pkgs[pkg].pool(3, cache)
    w = pool.acquire()
    assert w.ctx_ready and not pool.is_prewarmed(w, keys)
    pool.prewarm_for_functions({"fn": keys})
    assert pool.is_prewarmed(w, keys)
    assert pool.is_prewarmed(w, keys[:1])
    assert not pool.is_prewarmed(w, [("other", "prefill", 1, 1, 1)])
    assert not pool.is_prewarmed(w, keys + [("other", "decode", 1, 1)])
    w.ctx_ready = False
    assert not pool.is_prewarmed(w, keys)
    pool.release(w)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_deploy_prewarms_prefill_and_decode_pool(pkgs, pkg):
    """deploy() warms the engine's serve entry points once per model, so
    two functions on one smoke model leave one prefill and one decode-pool
    key, the second deploy hitting the cache."""
    P = pkgs[pkg]
    rt = P.runtime(n_slots=2, max_len=MAX_LEN, trace_seq=8)
    rt.deploy(P.api.static_function("fn-static", P.model, P.params), {},
              prewarm_seq=8)
    rt.deploy(P.api.lora_function("fn-lora", P.model, P.params,
                                  ["blocks.attn.wq"], n_adapters=2),
              {"adapter": "adapter-0"}, prewarm_seq=8)
    keys = rt.exe_cache.keys()
    assert {k[1] for k in keys} == {"prefill", "decode-pool"}
    assert all(k in rt.exe_cache for k in keys)
    assert rt.exe_cache.stats.misses == 2
    assert rt.exe_cache.stats.hits >= 1
