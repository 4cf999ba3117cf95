"""The template server's host pool at exact size (the same layout code
runs on the CPU as on a card, where the buffer is page-locked in place).

Every pool entry is a view into the function's one buffer, laid out in
traced access order at ``HOST_ALIGN``-byte offsets; each view equals its
materialized leaf bit for bit; the buffer holds the static bytes plus at
most the alignment padding; a fork streams the same tensors the old
per-leaf pool held, for smollm-135m, phi3.5-moe and deepseek-v3 (smoke),
static and LoRA.  No card here, so nothing is page-locked.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.core.merging import (HOST_ALIGN, HostBuffer,  # noqa: E402
                                      host_layout)
from repro_torch.core.template_server import TemplateServer  # noqa: E402
from repro_torch.models.registry import get_smoke_model  # noqa: E402
from repro_torch.utils import named_leaves, tensor_nbytes  # noqa: E402

ARCHS = ["smollm-135m", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"]


def _server(arch, lora: bool):
    model = get_smoke_model(arch, device="cpu", n_layers=2)
    params = model.init_params(seed=3)
    fn = (tidal.lora_function("f", model, params, ["blocks.attn.wq_a" if
                                                   model.cfg.use_mla else
                                                   "blocks.attn.wq"],
                              n_adapters=2)
          if lora else tidal.static_function("f", model, params))
    event = {"adapter": "adapter-0"} if lora else {}
    srv = TemplateServer(trace_seq=16)
    srv.register(fn, event)
    return srv, fn, event


def _observe_other_adapter(srv):
    """A fork on another adapter: its LoRA targets turn dynamic and leave
    the pool (their bytes stay in the buffer)."""
    _, stats = srv.fork("f", {"adapter": "adapter-1"})
    assert stats.new_dynamic
    return {"adapter": "adapter-1"}


def _old_pool(fn, event, dynamic) -> dict:
    """The per-leaf pool the server kept before: one contiguous copy of
    every static leaf."""
    traced, _ = fn.run_initializer(event)
    return {p: leaf.materialize().contiguous()
            for p, leaf in named_leaves(traced) if p not in dynamic}


@pytest.mark.parametrize("lora", [False, True], ids=["static", "lora"])
@pytest.mark.parametrize("arch", ARCHS)
def test_pool_is_views_of_one_buffer_in_access_order(arch, lora):
    srv, fn, event = _server(arch, lora)
    pool, hb = srv.host_pool["f"], srv.host_buffers["f"]
    tpl = srv.templates["f"]
    assert not hb.pinned and srv.registered_bytes() == 0
    everything = sum(leaf.nbytes for _, leaf in named_leaves(fn.run_initializer(event)[0]))
    if lora:
        event = _observe_other_adapter(srv)
    assert (len(tpl.dynamic) > 0) == lora
    base = hb.buf.data_ptr()
    static = [p for p in srv._leaf_order["f"] if p not in tpl.dynamic]
    assert list(pool) == static
    offsets = []
    for path in static:
        t = pool[path]
        assert t.untyped_storage().data_ptr() == hb.buf.untyped_storage().data_ptr()
        off = t.data_ptr() - base
        assert off % HOST_ALIGN == 0 and 0 <= off
        assert off + tensor_nbytes(t) <= hb.nbytes
        offsets.append(off)
    assert offsets == sorted(offsets) and len(set(offsets)) == len(offsets)
    old = _old_pool(fn, event, tpl.dynamic)
    assert set(old) == set(pool)
    for path, t in pool.items():
        assert t.dtype == old[path].dtype and t.shape == old[path].shape
        assert torch.equal(t.view(torch.uint8) if t.dim() else t,
                           old[path].view(torch.uint8) if t.dim() else old[path])
    # laid out at register, before any weight turned dynamic
    n = len(srv._leaf_order["f"])
    assert everything <= hb.nbytes <= everything + (HOST_ALIGN - 1) * (n - 1)


@pytest.mark.parametrize("lora", [False, True], ids=["static", "lora"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fork_streams_what_the_per_leaf_pool_held(arch, lora):
    """Every tensor a fork streams equals the per-leaf pool's leaf, and the
    device copy does not alias the pool."""
    srv, fn, event = _server(arch, lora)
    if lora:
        event = _observe_other_adapter(srv)
    tpl = srv.templates["f"]
    old = _old_pool(fn, event, tpl.dynamic)
    sess, stats = srv.fork("f", event)
    sess.streamer.wait_all()
    assert stats.streamed_bytes == sum(tensor_nbytes(t) for t in old.values())
    for key in tpl.static_order:
        got = sess.leaf(key[0])
        assert torch.equal(got, old[key[0]])
        assert got.data_ptr() != srv.host_pool["f"][key[0]].data_ptr()
    assert sess.streamer.completed_order == [k for k in tpl.static_order]


def test_host_layout_and_buffer_views():
    """Offsets are packed in order at HOST_ALIGN multiples; a buffer is
    exactly its byte count; views read back what was written."""
    offsets, total = host_layout([("a", 10), ("b", 256), ("c", 3), ("d", 0),
                                  ("e", 8)])
    assert offsets == {"a": 0, "b": 256, "c": 512, "d": 768, "e": 768}
    assert total == 776
    hb = HostBuffer(total)
    assert hb.buf.numel() == total and hb.buf.dtype == torch.uint8
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    v = hb.view(256, (8, 8), torch.float32)
    v.copy_(x)
    assert torch.equal(hb.view(256, (8, 8), torch.float32), x)
    hb.release()                          # unpinned: nothing to undo
    assert not hb.pinned


def test_a_runtime_adopting_a_shared_servers_function_keeps_its_pool():
    """A second ``FaaSRuntime`` over the same server deploys the same
    function object from the host pool the first packed (one host copy
    for both); a re-deploy on a runtime packs anew, and the adopting
    runtime serves the same tokens."""
    from repro_torch.runtime import FaaSRuntime
    model = get_smoke_model("smollm-135m", device="cpu", n_layers=2)
    fn = tidal.static_function("f", model, model.init_params(seed=3))
    srv = TemplateServer(trace_seq=16)
    prompt = np.arange(1, 10, dtype=np.int32)
    tokens = []
    for _ in range(2):
        rt = FaaSRuntime(server=srv, device="cpu", n_slots=2, max_len=32,
                         page_size=4, prewarm=False)
        before = srv.host_buffers.get("f")
        rt.deploy(fn, {})
        assert (srv.host_buffers["f"] is before) == (before is not None)
        tokens.append(rt.submit("f", {}, prompt, 4).tokens.tolist())
    kept = srv.host_buffers["f"]
    rt.deploy(fn, {})
    assert srv.host_buffers["f"] is not kept
    assert tokens[0] == tokens[1]


def test_reregister_replaces_the_buffer():
    srv, fn, event = _server("smollm-135m", False)
    first = srv.host_buffers["f"]
    srv.register(fn, event)
    assert srv.host_buffers["f"] is not first
    toks = np.zeros((1, 4), np.int32)
    sess, _ = srv.fork("f", event)
    lg, _ = sess.model.prefill(sess.params(), {"tokens": toks},
                               sess.model.make_cache(1, 8))
    assert torch.isfinite(lg).all()
