"""The port's kernels, held against the JAX package on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; the
same numpy inputs go through the JAX Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and ``repro.kernels.ref``.  Attention is
fp32 with TF32 off; tolerance 1e-5 (summation order only).  RMSNorm runs
in fp32 (tolerance 1e-5, summation order only) and bf16 (within one bf16
ulp of the Pallas output: the two round the same fp32 value, whose last
bits may differ by summation order).  The CUDA kernels themselves are
checked on the card by ``chip_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.ops import paged_decode_attention as pallas_paged  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.models import quant as jquant  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.rmsnorm import row_stride  # noqa: E402
from repro_torch.models import quant as tquant  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = dict(atol=1e-5, rtol=1e-5)


def _arena(rng, B, KV, d, ps, NB, lengths):
    """Random arena + shuffled page tables; a row of length 1 and an
    all-null table stands for a free slot (it reads the null page 0)."""
    n_pages = 1 + B * NB
    kp = rng.standard_normal((n_pages, ps, KV, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, KV, d)).astype(np.float32)
    pt = (rng.permutation(n_pages - 1) + 1)[:B * NB].reshape(B, NB)
    pt = pt.astype(np.int32)
    for b, n in enumerate(lengths):
        if n == 1:
            pt[b] = 0
    return kp, vp, pt


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,H,KV,ps,NB,d,lengths", [
    (3, 4, 4, 8, 6, 16, [1, 17, 48]),            # G=1, free slot + ragged
    (4, 9, 3, 8, 8, 64, [64, 1, 9, 33]),         # G=3 (smollm heads)
    (2, 8, 2, 16, 4, 32, [63, 1]),               # G=4
])
def test_paged_decode_matches_pallas_and_ref(B, H, KV, ps, NB, d, lengths, int8):
    rng = np.random.default_rng(B * 100 + H)
    kp, vp, pt = _arena(rng, B, KV, d, ps, NB, lengths)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    ks = vs = None
    if int8:
        kq, ksj = jquant.quantize_rows(jnp.asarray(kp))
        vq, vsj = jquant.quantize_rows(jnp.asarray(vp))
        kp, vp, ks, vs = map(np.asarray, (kq, vq, ksj, vsj))
    jkw = {} if not int8 else {"k_scales": jnp.asarray(ks), "v_scales": jnp.asarray(vs)}
    want_pallas = np.asarray(pallas_paged(jnp.asarray(q), jnp.asarray(kp),
                                          jnp.asarray(vp), jnp.asarray(pt),
                                          jnp.asarray(ln), **jkw))
    want_ref = np.asarray(jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(ln), **jkw))
    tkw = {} if not int8 else {"k_scales": _t(ks), "v_scales": _t(vs)}
    got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(ln),
                                     **tkw).numpy()
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


def test_paged_decode_scalar_length_and_scale_pair():
    rng = np.random.default_rng(3)
    kp, vp, pt = _arena(rng, 2, 2, 16, 8, 3, [20, 20])
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(pt), 20)
    want = jref.paged_decode_attention_ref(jnp.asarray(q), jnp.asarray(kp),
                                           jnp.asarray(vp), jnp.asarray(pt), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kq, ks = tquant.quantize_rows(_t(kp))
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        ops.paged_decode_attention(_t(q), kq, _t(vp), _t(pt), 8, k_scales=ks)


@pytest.mark.parametrize("B,H,KV,S,d", [
    (1, 4, 4, 64, 32),       # MHA
    (2, 9, 3, 64, 64),       # smollm heads, G=3
    (1, 8, 2, 96, 16),       # S = 96: the Pallas path halves its block
])
def test_flash_matches_pallas_square(B, H, KV, S, d):
    rng = np.random.default_rng(S + H)
    q = rng.standard_normal((B, H, S, d)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, d)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, d)).astype(np.float32)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   block_q=32, block_k=32))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("B,H,KV,S,T,d", [
    (2, 4, 4, 64, 64, 16),   # whisper smoke heads, encoder: S = T
    (1, 9, 3, 96, 96, 64),   # GQA, S = T over three blocks
    (2, 4, 4, 32, 96, 16),   # cross-attention: S_dec over T_enc keys
    (1, 16, 16, 4, 64, 64),  # whisper-medium heads, a 4-token prompt
])
def test_flash_noncausal_matches_pallas(B, H, KV, S, T, d):
    """``causal=False`` (whisper's encoder and cross-attention) against
    the Pallas kernel in interpret mode, at sizes its blocks divide."""
    rng = np.random.default_rng(S * T + H)
    q = rng.standard_normal((B, H, S, d)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False,
                                   block_q=min(32, S), block_k=32))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("S,T,softcap", [
    (8, 40, 0.0),            # suffix prefill over a reused prefix
    (33, 97, 0.0),           # ragged lengths
    (24, 24, 30.0),          # softcap, square
    (16, 50, 5.0),           # softcap with T > S
])
def test_flash_matches_ref_offset_and_softcap(S, T, softcap):
    rng = np.random.default_rng(S * T)
    q = rng.standard_normal((2, 6, S, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, T, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, T, 16)).astype(np.float32)
    want = np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), causal=True,
                                               softcap=softcap))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_takes_strided_views():
    """The model hands in transposed views of [B, S, H, d] activations."""
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 12, 4, 16)).astype(np.float32))
    kv = _t(rng.standard_normal((2, 20, 2, 16)).astype(np.float32))
    got = ops.flash_attention(x.transpose(1, 2), kv.transpose(1, 2),
                              kv.transpose(1, 2))
    want = tref.flash_attention_ref(x.transpose(1, 2).contiguous(),
                                    kv.transpose(1, 2).contiguous(),
                                    kv.transpose(1, 2).contiguous())
    torch.testing.assert_close(got, want, **TOL)


def test_decode_attention_ref_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    ln = np.asarray([13, 40], np.int32)
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(ln))
    got = tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(ln))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at each value (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 576, 2048])
@pytest.mark.parametrize("lead", [(130,), (3, 7)])
def test_rmsnorm_ref_matches_pallas(lead, d, dtype):
    """Rows that are no multiple of the Pallas kernel's 128-row tile (it
    pads them), at head-norm, smollm and wide model widths."""
    rng = np.random.default_rng(d + len(lead))
    x = rng.standard_normal(lead + (d,)).astype(np.float32)
    s = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    jx, js = jnp.asarray(x, dtype), jnp.asarray(s, dtype)
    want = np.asarray(pallas_rmsnorm(jx, js, eps=1e-5), np.float32)
    tdt = getattr(torch, dtype)
    got = ops.rmsnorm(_t(np.asarray(jx, np.float32)).to(tdt),
                      _t(np.asarray(js, np.float32)).to(tdt), 1e-5)
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_rmsnorm_scale_dtype_and_strided_rows():
    """A bf16 scale is promoted to fp32 under fp32 rows; the last-row view
    of a prefill (``x[:, -1:]``) normalises without a copy."""
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((2, 9, 64)).astype(np.float32))
    s = _t(rng.standard_normal(64).astype(np.float32)).to(torch.bfloat16)
    want = tref.rmsnorm_ref(x[:, -1:].contiguous(), s.float(), 1e-6)
    torch.testing.assert_close(ops.rmsnorm(x[:, -1:], s), want, **TOL)
    assert row_stride(x[:, -1:]) == 9 * 64
    assert row_stride(x) == 64
    assert row_stride(torch.zeros((1, 1, 64))) == 64
    with pytest.raises(ValueError, match="collapse to one row stride"):
        row_stride(x.transpose(0, 1))
    with pytest.raises(ValueError, match="last axis"):
        row_stride(x.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 576), (3, 7, 64), (130, 2048)])
def test_rmsnorm_residual_form_is_the_add_then_the_norm(shape, dtype):
    """The fused form's plain version (what the CPU runs, and the function
    the kernel's fused launch computes) is ``s = x + r`` then
    ``rmsnorm_ref(s)``, bit for bit, through the wrapper and through
    ``ref``; its norm is the Pallas kernel's on the same sum."""
    rng = np.random.default_rng(len(shape) + shape[-1])
    x, r = (_t(rng.standard_normal(shape).astype(np.float32)).to(dtype)
            for _ in range(2))
    scale = _t((rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)).to(dtype)
    want_s = x + r
    want_y = tref.rmsnorm_ref(want_s, scale, 1e-5)
    for y, s in (ops.rmsnorm(x, scale, 1e-5, residual=r),
                 tref.rmsnorm_ref(x, scale, 1e-5, residual=r)):
        assert s.dtype == y.dtype == dtype and s.shape == y.shape == x.shape
        assert torch.equal(s, want_s) and torch.equal(y, want_y)
    jdt = "float32" if dtype == torch.float32 else "bfloat16"
    pallas = np.asarray(pallas_rmsnorm(jnp.asarray(want_s.float().numpy(), jdt),
                                       jnp.asarray(scale.float().numpy(), jdt),
                                       eps=1e-5), np.float32)
    got = want_y.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, pallas, **TOL)
    else:
        assert (np.abs(got - pallas) <= _bf16_ulp(pallas)).all()


def test_rmsnorm_residual_refuses_a_mismatch_and_counts_nothing_on_the_cpu():
    """A residual of another shape, dtype or device raises before anything
    runs; the fused CPU path counts no launch, fused or not; a strided
    residual view is read through its own row stride."""
    x = torch.ones((2, 3, 16))
    scale = torch.ones(16)
    with pytest.raises(ValueError, match="residual"):
        ops.rmsnorm(x, scale, residual=torch.ones((2, 4, 16)))
    with pytest.raises(ValueError, match="residual"):
        ops.rmsnorm(x, scale, residual=torch.ones((2, 3, 16), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="residual"):
        ops.rmsnorm(x, scale, residual=torch.ones((2, 3, 16), device="meta"))
    ops.reset_launch_counts()
    big = torch.arange(2 * 5 * 16, dtype=torch.float32).reshape(2, 5, 16) / 100
    y, s = ops.rmsnorm(x[:, -1:], scale, residual=big[:, -1:])
    assert torch.equal(s, x[:, -1:] + big[:, -1:])
    assert torch.equal(y, tref.rmsnorm_ref(s, scale))
    assert ops.launch_counts()["rmsnorm"] == ops.launch_counts()["rmsnorm_fused"] == 0


def test_wrappers_refuse_other_devices_and_count_only_launches(monkeypatch):
    """No quiet fallback: a tensor that is neither on the CPU nor on a
    card raises, and the plain CPU path launches (and counts) nothing.
    ``meta`` tensors are the tracer's shape-only path (empty outputs, no
    launch); with that path switched off they stand for any other
    device."""
    from repro_torch.kernels import meta
    ops.reset_launch_counts()
    q = torch.zeros((1, 4, 16), device="meta")
    arena = torch.zeros((3, 8, 2, 16), device="meta")
    pt = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    lens = torch.ones(1, dtype=torch.int32, device="meta")
    cache = torch.zeros((1, 2, 8, 16), device="meta")
    fq = torch.zeros((1, 4, 8, 16), device="meta")
    scale = torch.ones(16, device="meta")
    assert ops.paged_decode_attention(q, arena, arena, pt, lens).shape == q.shape
    assert ops.decode_attention(q, cache, cache, lens).shape == q.shape
    assert ops.flash_attention(fq, cache, cache).shape == fq.shape
    assert ops.rmsnorm(fq, scale).shape == fq.shape
    y, s = ops.rmsnorm(fq, scale, residual=fq)
    assert y.shape == s.shape == fq.shape and y.device.type == "meta"
    monkeypatch.setattr(meta, "is_meta", lambda t: False)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.paged_decode_attention(q, arena, arena, pt, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_attention(q, cache, cache, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(fq, cache, cache)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rmsnorm(fq, scale)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rmsnorm(fq, scale, residual=fq)
    ops.rmsnorm(torch.ones((3, 16)), torch.ones(16))
    ops.rmsnorm(torch.ones((3, 16)), torch.ones(16), residual=torch.ones((3, 16)))
    ops.flash_attention(torch.zeros((1, 4, 8, 16)), torch.zeros((1, 2, 8, 16)),
                        torch.zeros((1, 2, 8, 16)))
    ops.decode_attention(torch.zeros((1, 4, 16)), torch.zeros((1, 2, 8, 16)),
                         torch.zeros((1, 2, 8, 16)), 3)
    assert ops.launch_counts() == {"decode_attention": 0, "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "paged_decode_attention": 0, "rmsnorm": 0,
                                   "rmsnorm_bwd": 0, "rmsnorm_fused": 0,
                                   "ssd_scan": 0}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """An unbuilt kernel raises: without nvcc the build fails loudly."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_cuda_sources_declare_their_entry_points():
    """Each wrapper's C symbol is defined with C linkage in csrc/."""
    sources = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu")}
    assert set(sources) == {"paged_decode_attention.cu", "flash_attention.cu",
                            "decode_attention.cu", "rmsnorm.cu", "ssd_scan.cu",
                            "flash_attention_bwd.cu", "rmsnorm_bwd.cu"}
    # the backward kernels' entry points take what their wrappers pass
    from repro_torch.kernels import flash_attention as flash_wrapper
    for src, name, argtypes in (
            ("flash_attention_bwd.cu", "repro_flash_attention_bwd",
             flash_wrapper._BWD_ARGTYPES),
            ("rmsnorm_bwd.cu", "repro_rmsnorm_bwd", None),
            ("flash_attention.cu", "repro_flash_attention", flash_wrapper._ARGTYPES)):
        if argtypes is None:
            from repro_torch.kernels import rmsnorm as rms_wrapper
            argtypes = rms_wrapper._BWD_ARGTYPES
        head = sources[src].split(f'extern "C" int {name}(')[1].split(")")[0]
        assert head.count(",") + 1 == len(argtypes), name
    assert 'extern "C" int repro_ssd_scan(' in sources["ssd_scan.cu"]
    assert 'extern "C" int repro_rmsnorm(' in sources["rmsnorm.cu"]
    # the C entry points take what the wrappers pass: rmsnorm's residual
    # and second output, ssd_scan's one scratch
    from repro_torch.kernels import rmsnorm as rms_wrapper
    from repro_torch.kernels import ssd_scan as ssd_wrapper
    head = sources["rmsnorm.cu"].split('extern "C" int repro_rmsnorm(')[1].split(")")[0]
    assert head.count(",") + 1 == len(rms_wrapper._ARGTYPES)
    assert "const void* res" in head and "void* s" in head
    head = sources["ssd_scan.cu"].split('extern "C" int repro_ssd_scan(')[1].split(")")[0]
    assert head.count(",") + 1 == len(ssd_wrapper._ARGTYPES)
    assert "void* scratch" in head
    assert 'extern "C" int repro_decode_attention(' in \
        sources["decode_attention.cu"]
    assert 'extern "C" int repro_paged_decode_attention(' in \
        sources["paged_decode_attention.cu"]
    assert 'extern "C" int repro_flash_attention(' in sources["flash_attention.cu"]
    for text in sources.values():
        assert "Replaces the TPU kernel src/repro/kernels/" in text


# ---------------------------------------------------------------------------
# backward plain versions (the backward kernels' references) and the
# refusal of a gradient where a kernel has no backward
# ---------------------------------------------------------------------------

def _vjp_jax(fn, primals, cotangent):
    _, vjp = jax.vjp(fn, *[jnp.asarray(p) for p in primals])
    return [np.asarray(g) for g in vjp(cotangent)]


def _close_to_largest(got, want, tol=1e-5):
    """Within ``tol`` of the largest |value| of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("B,H,KV,S,T,d,causal,softcap", [
    (2, 9, 3, 24, 24, 16, True, 0.0),      # GQA (G = 3), square causal
    (1, 4, 2, 8, 40, 16, True, 0.0),       # causal, bottom-right over T > S
    (2, 4, 4, 12, 30, 16, False, 0.0),     # non-causal, cross-attention shape
    (1, 4, 1, 16, 16, 32, True, 5.0),      # softcap, G = 4
    (1, 2, 2, 10, 25, 16, False, 3.0),     # non-causal with a softcap
])
def test_flash_backward_ref_matches_autograd_and_jax_vjp(B, H, KV, S, T, d,
                                                         causal, softcap):
    """``flash_attention_bwd_ref`` (written step by step) against
    ``torch.autograd.grad`` of the plain forward and ``jax.vjp`` of
    ``repro.kernels.ref.flash_attention_ref``; the forward's saved
    log-sum-exp against ``logsumexp`` of the scores.  Tolerance 1e-5 of
    each gradient's largest |value| (fp32 summation order)."""
    rng = np.random.default_rng(S * T + H)
    q, do = (rng.standard_normal((B, H, S, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, KV, T, d)).astype(np.float32) for _ in range(2))
    o, lse = tref.flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal, softcap)
    np.testing.assert_allclose(o.numpy(), tref.flash_attention_ref(
        _t(q), _t(k), _t(v), causal, softcap).numpy(), **TOL)
    got = tref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do),
                                       causal, softcap)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    want_t = torch.autograd.grad(
        tref.flash_attention_ref(tq, tk, tv, causal, softcap), (tq, tk, tv), _t(do))
    want_j = _vjp_jax(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, softcap=softcap), (q, k, v), jnp.asarray(do))
    for g, wt, wj in zip(got, want_t, want_j):
        _close_to_largest(g.numpy(), wt.numpy())
        _close_to_largest(g.numpy(), wj)
    # the autograd path of the wrapper runs the same plain backward
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, softcap=softcap)
    for g, w in zip(torch.autograd.grad(out, (tq, tk, tv), _t(do)), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape,residual", [
    ((2, 5, 64), False), ((7, 48), True), ((3, 2, 4, 16), False), ((4, 80), True)])
def test_rmsnorm_backward_ref_matches_autograd_and_jax_vjp(shape, residual):
    """``rmsnorm_bwd_ref`` against ``torch.autograd.grad`` and ``jax.vjp``
    of ``repro.kernels.ref.rmsnorm_ref``, plain and in the residual form
    (where ``d_sum``, the gradient at ``s = x + r``, adds to both x's and
    r's gradient).  Tolerance 1e-5 of each gradient's largest |value|."""
    rng = np.random.default_rng(int(np.prod(shape)))
    x, r, dy, ds = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    scale = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)
    eps = 1e-5
    if residual:
        s = x + r
        dx, dsc = tref.rmsnorm_bwd_ref(_t(s), _t(scale), _t(dy), eps, d_sum=_t(ds))
        tx, tr, tsc = (_t(a).requires_grad_(True) for a in (x, r, scale))
        y, s_t = ops.rmsnorm(tx, tsc, eps, residual=tr)
        gx, gr, gsc = torch.autograd.grad((y, s_t), (tx, tr, tsc), (_t(dy), _t(ds)))
        assert torch.equal(gx, gr)
        jx, jr, jsc = _vjp_jax(
            lambda a, b, c: (jref.rmsnorm_ref(a + b, c, eps), a + b), (x, r, scale),
            (jnp.asarray(dy), jnp.asarray(ds)))
        want = [(gx, jx), (gsc, jsc)]
        np.testing.assert_allclose(jx, jr, **TOL)
    else:
        dx, dsc = tref.rmsnorm_bwd_ref(_t(x), _t(scale), _t(dy), eps)
        tx, tsc = (_t(a).requires_grad_(True) for a in (x, scale))
        gx, gsc = torch.autograd.grad(tref.rmsnorm_ref(tx, tsc, eps), (tx, tsc), _t(dy))
        jx, jsc = _vjp_jax(lambda a, c: jref.rmsnorm_ref(a, c, eps), (x, scale),
                           jnp.asarray(dy))
        want = [(gx, jx), (gsc, jsc)]
    for got, (wt, wj) in zip((dx, dsc), want):
        _close_to_largest(got.numpy(), wt.detach().numpy())
        _close_to_largest(got.numpy(), wj)


def test_kernels_without_a_backward_refuse_a_gradient_off_the_cpu():
    """``ssd_scan``, ``decode_attention`` and ``paged_decode_attention``
    have no backward kernel: off the CPU (``meta`` stands in for a card,
    which this machine lacks) an input that requires grad raises instead
    of a detached output; so do flash and rmsnorm in bf16, which have no
    backward kernel yet.  Without grad mode, or on the CPU, they run."""
    m = dict(device="meta")
    q = torch.zeros((1, 4, 16), **m, requires_grad=True)
    cache = torch.zeros((1, 2, 8, 16), **m)
    arena = torch.zeros((3, 8, 2, 16), **m)
    pt = torch.zeros((1, 2), dtype=torch.int32, **m)
    with pytest.raises(NotImplementedError, match="decode_attention.*no backward"):
        ops.decode_attention(q, cache, cache, 3)
    with pytest.raises(NotImplementedError, match="paged_decode_attention"):
        ops.paged_decode_attention(q, arena, arena, pt, 3)
    xb = torch.zeros((1, 8, 2, 32), **m, requires_grad=True)
    bc = torch.zeros((1, 8, 16), **m)
    with pytest.raises(NotImplementedError, match="ssd_scan.*ssd_scan backward"):
        ops.ssd_scan(xb, bc, bc, torch.zeros((1, 8, 2), **m), 4)
    fq = torch.zeros((1, 4, 8, 16), dtype=torch.bfloat16, **m, requires_grad=True)
    fk = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16, **m)
    with pytest.raises(NotImplementedError, match="bf16 tensor-core backward"):
        ops.flash_attention(fq, fk, fk)
    with pytest.raises(NotImplementedError, match="bf16 tensor-core backward"):
        ops.rmsnorm(fq, torch.ones(16, dtype=torch.bfloat16, **m))
    with torch.no_grad():
        assert ops.decode_attention(q, cache, cache, 3).shape == q.shape
        assert ops.flash_attention(fq, fk, fk).shape == fq.shape
    # fp32 on meta carries its gradient shape-only, both kernels counted
    f32 = torch.zeros((1, 4, 8, 16), **m, requires_grad=True)
    out = ops.flash_attention(f32, fk.float(), fk.float())
    assert out.requires_grad and out.shape == f32.shape
    # on the CPU the plain versions carry the gradient
    cq = torch.randn((1, 4, 16), requires_grad=True)
    out = ops.decode_attention(cq, torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16), 5)
    assert out.grad_fn is not None
