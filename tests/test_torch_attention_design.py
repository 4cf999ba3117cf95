"""The arithmetic of the two redesigned attention kernels, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  These tests replay their schedules in plain
torch at small sizes, with inputs made from a numpy seed, and hold the
replays against ``repro_torch.kernels.ref``, ``repro.kernels.ref`` and the
JAX Pallas kernels in interpret mode:

* ``flash_attention`` in bf16: blocks of 64 query rows, key tiles of a
  width fixed per head dim (64; 32 at d = 256) starting at key 0, the
  online softmax per tile in log2 units, P rounded to bf16 before P V,
  the normaliser clamped at 1e-30.  Tolerance 2e-2 (the bf16 tolerance
  of ``chip_smoke.py``; inputs are bf16 values, P is rounded to bf16).
  Every sum runs in a fixed order (one head-dim element or one key at a
  time), so a row's value does not depend on which other rows share the
  product, as on the tensor cores; the invariance tests then show that
  the schedule itself makes a row independent of its block and batch.
* ``decode_attention``'s split-KV: one partial (m, l, un-normalised
  accumulator) per span of ``split_rows(d)`` cache rows, an empty
  partial (m = mask value, l = 0) at or past the length, merged in split
  order.  fp32 throughout; tolerance 1e-5 (summation order only).
"""

import inspect
import math
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

MASK = torch.finfo(torch.float32).min
LOG2E = 1.4426950408889634
BQ = 64                                    # query rows per flash block


def _bf16_values(rng, shape):
    """Standard normals rounded to bf16, held in fp32."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float()


def _exact(fn, x):
    """``fn`` on fp32 values, correctly rounded: evaluated in float64 (the
    CPU's vectorised and scalar float32 paths may differ in the last bit,
    which would make an element's value depend on its position)."""
    return fn(x.double()).float()


def flash_bf16_schedule(q, k, v, causal=True, softcap=0.0):
    """The bf16 flash kernel's arithmetic.  q [B, H, S, d], k, v
    [B, KV, T, d] (bf16 values in fp32); returns fp32 [B, H, S, d]."""
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    BK = 32 if d >= 256 else 64
    scale = 1.0 / math.sqrt(d)
    offset = T - S
    out = torch.zeros((B, H, S, d))
    for q0 in range(0, S, BQ):
        rows = torch.arange(q0, min(q0 + BQ, S))
        last = int(rows[-1])
        kv_end = min(T, last + offset + 1) if causal else T
        qb = q[:, :, q0:q0 + len(rows)]                          # [B, H, r, d]
        m = torch.full((B, H, len(rows)), MASK)
        l = torch.zeros((B, H, len(rows)))
        o = torch.zeros((B, H, len(rows), d))
        for kt in range(0, kv_end, BK):
            cols = torch.arange(kt, kt + BK)
            kk = torch.zeros((B, KV, BK, d))                     # zero past T
            vv = torch.zeros((B, KV, BK, d))
            n = min(BK, T - kt)
            kk[:, :, :n] = k[:, :, kt:kt + n]
            vv[:, :, :n] = v[:, :, kt:kt + n]
            kk = kk.repeat_interleave(G, dim=1)
            vv = vv.repeat_interleave(G, dim=1)
            s = torch.zeros((B, H, len(rows), BK))
            for e in range(d):
                s = s + qb[..., e, None] * kk[:, :, None, :, e]
            s = s * scale
            if softcap > 0:
                s = _exact(torch.tanh, s / softcap) * softcap
            valid = cols[None, :] < T
            if causal:
                valid = valid & (cols[None, :] <= rows[:, None] + offset)
            s = torch.where(valid, s * LOG2E, MASK)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = _exact(torch.exp2, m - m_new)
            p = torch.where(valid, _exact(torch.exp2, s - m_new[..., None]), 0.0)
            pb = p.to(torch.bfloat16).float()
            psum = torch.zeros_like(l)
            pv = torch.zeros_like(o)
            for j in range(BK):
                psum = psum + p[..., j]
                pv = pv + pb[..., j, None] * vv[:, :, None, j]
            l = l * alpha + psum
            o = o * alpha[..., None] + pv
            m = m_new
        out[:, :, q0:q0 + len(rows)] = o / torch.clamp(l, min=1e-30)[..., None]
    return out


def split_kv_schedule(q, k, v, lengths):
    """The split-KV decode's arithmetic.  q [B, H, d], k, v [B, KV, T, d]
    (fp32), lengths [B]; returns fp32 [B, H, d]."""
    B, H, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    split, ns = dec.split_rows(d), dec.n_splits(T, d)
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, KV, G, d)
    part_m = torch.empty((B, KV, ns, G))
    part_l = torch.empty((B, KV, ns, G))
    part_acc = torch.full((B, KV, ns, G, d), float("nan"))   # never read if empty
    for b in range(B):
        n = max(0, min(int(lengths[b]), T))
        for s in range(ns):
            r0 = s * split
            if r0 >= n:                                       # empty partial
                part_m[b, :, s], part_l[b, :, s] = MASK, 0.0
                continue
            ks, vs = k[b, :, r0:min(r0 + split, n)], v[b, :, r0:min(r0 + split, n)]
            sc = torch.einsum("kgd,ktd->kgt", qg[b], ks) * scale
            mx = sc.amax(-1)
            p = torch.exp(sc - mx[..., None])
            part_m[b, :, s], part_l[b, :, s] = mx, p.sum(-1)
            part_acc[b, :, s] = torch.einsum("kgt,ktd->kgd", p, vs)
    out = torch.zeros((B, KV, G, d))
    for b in range(B):
        live = part_l[b] > 0                                  # [KV, ns, G]
        mx = torch.where(live, part_m[b], MASK).amax(1)       # [KV, G]
        lsum = torch.zeros((KV, G))
        acc = torch.zeros((KV, G, d))
        for s in range(ns):                                   # split order
            c = torch.where(live[:, s], torch.exp(part_m[b, :, s] - mx), 0.0)
            lsum = lsum + torch.where(live[:, s], part_l[b, :, s] * c, 0.0)
            acc = acc + torch.where(live[:, s, :, None],
                                    part_acc[b, :, s] * c[..., None], 0.0)
        out[b] = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(B, H, d)


# ---------------------------------------------------------------------------
# flash_attention, bf16 schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,d,S,T,softcap", [
    (1, 4, 2, 16, 96, 96, 0.0),      # GQA, two blocks, ragged second block
    (2, 3, 1, 32, 70, 70, 0.0),      # G = 3, ragged tiles
    (1, 2, 2, 80, 64, 64, 0.0),      # zamba2's head dim
    (1, 2, 1, 64, 128, 128, 30.0),   # softcap, two blocks
    (1, 2, 1, 256, 40, 40, 0.0),     # d = 256: 32-key tiles
])
def test_flash_schedule_matches_ref_and_pallas(B, H, KV, d, S, T, softcap):
    rng = np.random.default_rng(B * 1000 + H * 100 + d)
    q = _bf16_values(rng, (B, H, S, d))
    k = _bf16_values(rng, (B, KV, T, d))
    v = _bf16_values(rng, (B, KV, T, d))
    got = flash_bf16_schedule(q, k, v, softcap=softcap)
    want = tref.flash_attention_ref(q, k, v, causal=True, softcap=softcap)
    assert float((got - want).abs().max()) <= 2e-2
    pallas = np.asarray(pallas_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                     jnp.asarray(v.numpy()), causal=True,
                                     softcap=softcap, interpret=True))
    assert np.abs(got.numpy() - pallas).max() <= 2e-2


@pytest.mark.parametrize("S,T", [(64, 200), (37, 100), (128, 128)])
def test_flash_schedule_suffix_rows_equal_full_prefill_rows(S, T):
    """A suffix prefill over a cached prefix gives bit for bit the last S
    rows of the whole prefill: the rows sit in other blocks and meet other
    numbers of key tiles, but the same keys in the same tiles."""
    rng = np.random.default_rng(S + T)
    q = _bf16_values(rng, (1, 4, T, 32))
    k = _bf16_values(rng, (1, 2, T, 32))
    v = _bf16_values(rng, (1, 2, T, 32))
    full = flash_bf16_schedule(q, k, v)
    suffix = flash_bf16_schedule(q[:, :, T - S:], k, v)
    assert torch.equal(suffix, full[:, :, T - S:])


def test_flash_schedule_sequence_alone_equals_it_in_a_batch():
    rng = np.random.default_rng(7)
    q = _bf16_values(rng, (4, 4, 80, 64))
    k = _bf16_values(rng, (4, 2, 80, 64))
    v = _bf16_values(rng, (4, 2, 80, 64))
    batch = flash_bf16_schedule(q, k, v)
    alone = flash_bf16_schedule(q[2:3], k[2:3], v[2:3])
    assert torch.equal(alone, batch[2:3])


def test_flash_schedule_bf16_rounding_of_p_is_what_the_tolerance_covers():
    """At smollm's head dim and a 384-token prompt the schedule stays well
    inside 2e-2 of the fp32 reference (the chip's bf16 tolerance)."""
    rng = np.random.default_rng(11)
    q = _bf16_values(rng, (1, 3, 192, 64))
    k = _bf16_values(rng, (1, 1, 192, 64))
    v = _bf16_values(rng, (1, 1, 192, 64))
    err = float((flash_bf16_schedule(q, k, v)
                 - tref.flash_attention_ref(q, k, v)).abs().max())
    assert 0 < err <= 5e-3


# ---------------------------------------------------------------------------
# decode_attention, split-KV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV,d,T,lengths", [
    (6, 2, 64, 192, [0, 1, 5, 64, 65, 192]),    # empty, short, split edges
    (4, 4, 80, 128, [127, 3, 0, 64]),           # zamba2's head dim, G = 1
    (8, 1, 256, 96, [96, 31, 32, 33]),          # 32-row spans at d = 256
    (8, 2, 128, 256, [200, 1]),
])
def test_split_kv_schedule_matches_ref_and_pallas(H, KV, d, T, lengths):
    B = len(lengths)
    rng = np.random.default_rng(H * 100 + d)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    got = split_kv_schedule(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(ln)).numpy()
    live = ln > 0
    want = tref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(ln)).numpy()
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=1e-5)
    want_j = np.asarray(jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), jnp.asarray(ln)))
    np.testing.assert_allclose(got[live], want_j[live], atol=1e-5, rtol=1e-5)
    # the Pallas kernel, like the CUDA one, gives zeros at length 0
    pallas = np.asarray(pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(ln), interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    assert (got[~live] == 0).all()


def test_split_kv_schedule_sequence_alone_equals_it_in_a_batch():
    rng = np.random.default_rng(3)
    B, H, KV, d, T = 8, 9, 3, 64, 320
    q = torch.from_numpy(rng.standard_normal((B, H, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, KV, T, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, KV, T, d)).astype(np.float32))
    ln = torch.tensor([300, 1, 64, 0, 129, 320, 17, 250], dtype=torch.int32)
    batch = split_kv_schedule(q, k, v, ln)
    for b in (0, 4, 6):
        alone = split_kv_schedule(q[b:b + 1], k[b:b + 1], v[b:b + 1], ln[b:b + 1])
        assert torch.equal(alone, batch[b:b + 1])


@pytest.mark.parametrize("d", dec.HEAD_DIMS)
def test_split_count_is_fixed_per_head_dim(d):
    """The span is a function of the head dim alone; the count of splits of
    the allocated length alone: neither takes B, KV or the lengths."""
    assert dec.split_rows(d) == (64 if d <= 128 else 32)
    assert list(inspect.signature(dec.split_rows).parameters) == ["d"]
    assert list(inspect.signature(dec.n_splits).parameters) == ["T", "d"]
    for T in (1, 63, 64, 65, 512, 4096):
        assert dec.n_splits(T, d) == math.ceil(T / dec.split_rows(d))


def test_cuda_source_agrees_on_the_split():
    """csrc/decode_attention.cu checks the wrapper's split against its own
    ``split_rows``; both name the same rule."""
    src = (_build.CSRC / "decode_attention.cu").read_text()
    rule = re.search(r"constexpr int split_rows\(int d\) \{ return d <= (\d+) \? (\d+) : (\d+); \}",
                     src)
    assert rule is not None
    limit, small, large = map(int, rule.groups())
    for d in dec.HEAD_DIMS:
        assert dec.split_rows(d) == (small if d <= limit else large)
