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
* the split-KV body of ``csrc/decode_split.cuh`` that ``decode_attention``
  and ``paged_decode_attention`` share: one partial (m, l, un-normalised
  accumulator) per span of ``split_rows(d)`` logical rows, the span's rows
  dealt to lane groups as the CUDA body deals them and merged in group
  order, an empty partial (m = mask value, l = 0) at or past the length,
  the partials merged in split order.  fp32 throughout (an int8 arena
  dequantized as row * scale); tolerance 1e-5 (summation order only).
  The replay runs over a dense cache or walks a page table; the two give
  the same bits over the same rows, as the two kernels do on the card.
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


def decode_cfg(d: int, vec: int, G: int) -> tuple:
    """``DecodeCfg`` of ``csrc/decode_split.cuh``: lane groups per block,
    rows a group loads per round, rounds per span.  ``vec`` is the row
    source's elements per load (4 for fp32, 8 for bf16 and int8)."""
    gmax = 1 if G == 1 else (4 if G <= 4 else 8)
    chunks = d // vec
    lanes = 8 if chunks <= 8 else (16 if chunks <= 16 else 32)
    e = vec * -(-chunks // 32)
    groups = 4 * 32 // lanes
    split = dec.split_rows(d)
    r = min(8 if gmax * e <= 32 else 4, split // groups)
    return groups, r, split // (groups * r)


def _dot(a, b):
    """Sum over the last axis, one element at a time (a fixed order)."""
    out = a[..., 0] * b[..., 0]
    for e in range(1, a.shape[-1]):
        out = out + a[..., e] * b[..., e]
    return out


def _split_kv(q, rows, T, lengths, vec):
    """The split-KV body of ``csrc/decode_split.cuh`` over a row source.

    ``rows(b, r_begin, t)`` gives the K and V rows ([n, KV, d] fp32) of
    the logical rows ``t`` of sequence ``b`` inside the span that starts
    at ``r_begin``.  Per span of ``split_rows(d)`` rows: row ``base + r *
    groups + grp`` of each round goes to lane group ``grp``, whose online
    softmax takes its rows in ``r`` order; the groups merge in group order
    into the span's partial; an empty partial (m = mask value, l = 0) at
    or past the length; the partials merge in split order.  q [B, H, d],
    ``T`` the allocated length; returns fp32 [B, H, d]."""
    B, H, d = q.shape
    KV = rows(0, 0, torch.zeros(1, dtype=torch.long))[0].shape[1]
    G = H // KV
    groups, R, rounds = decode_cfg(d, vec, G)
    split, ns = dec.split_rows(d), dec.n_splits(T, d)
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, KV, G, 1, d)
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
            r_end = min(r0 + split, n)
            m = torch.full((KV, G, groups), MASK)
            l = torch.zeros((KV, G, groups))
            acc = torch.zeros((KV, G, groups, d))
            for rnd in range(rounds):
                base = r0 + rnd * groups * R
                if base >= r_end:
                    break
                t = base + torch.arange(R)[:, None] * groups + torch.arange(groups)
                live = t < r_end                              # [R, groups]
                k, v = rows(b, r0, t.clamp(max=r_end - 1).reshape(-1))
                k = k.reshape(R, groups, KV, d).permute(0, 2, 1, 3)[:, :, None]
                v = v.reshape(R, groups, KV, d).permute(0, 2, 1, 3)[:, :, None]
                sc = torch.stack([_dot(qg[b], k[r]) for r in range(R)]) * scale
                m_new = m
                for r in range(R):
                    m_new = torch.where(live[r], torch.maximum(m_new, sc[r]), m_new)
                alpha = torch.exp(m - m_new)
                l, acc = l * alpha, acc * alpha[..., None]
                for r in range(R):
                    p = torch.exp(sc[r] - m_new)
                    l = torch.where(live[r], l + p, l)
                    acc = torch.where(live[r][:, None], acc + p[..., None] * v[r], acc)
                m = m_new
            mx = m.amax(-1)                                   # groups, in order
            lsum = torch.zeros((KV, G))
            a = torch.zeros((KV, G, d))
            for w in range(groups):
                c = torch.exp(m[..., w] - mx)
                lsum = lsum + l[..., w] * c
                a = a + acc[..., w, :] * c[..., None]
            part_m[b, :, s], part_l[b, :, s], part_acc[b, :, s] = mx, lsum, a
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


def split_kv_schedule(q, k, v, lengths):
    """The split-KV decode's arithmetic over a dense cache (the DenseRows
    source).  q [B, H, d], k, v [B, KV, T, d] (fp32), lengths [B];
    returns fp32 [B, H, d]."""
    def rows(b, r_begin, t):
        return k[b, :, t].transpose(0, 1), v[b, :, t].transpose(0, 1)
    return _split_kv(q, rows, k.shape[2], lengths, vec=4)


def paged_split_kv_schedule(q, k_pages, v_pages, page_table, lengths,
                            k_scales=None, v_scales=None):
    """The same body over a [P, ps, KV, d] arena (PagedRows, or
    PagedInt8Rows with [P, ps, KV] scales): a span's page ids are read
    from ``page_table`` once, then logical row t is row t % ps of page
    ``ids[t // ps - r_begin // ps]``, dequantized as ``row * scale``."""
    ps, NB = k_pages.shape[1], page_table.shape[1]
    d = q.shape[-1]
    T = NB * ps

    def rows(b, r_begin, t):
        r_hi = min(r_begin + dec.split_rows(d), T)
        ids = page_table[b, r_begin // ps:(r_hi - 1) // ps + 1].long()
        page, off = ids[t // ps - r_begin // ps], t % ps
        k, v = k_pages[page, off].float(), v_pages[page, off].float()
        if k_scales is not None:
            k = k * k_scales[page, off][..., None]
            v = v * v_scales[page, off][..., None]
        return k, v
    return _split_kv(q, rows, T, lengths, vec=8 if k_scales is not None else 4)


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
    """csrc/decode_split.cuh, the body both decode kernels run, checks the
    wrapper's split against its own ``split_rows``; both name the same
    rule."""
    src = (_build.CSRC / "decode_split.cuh").read_text()
    rule = re.search(r"constexpr int split_rows\(int d\) \{ return d <= (\d+) \? (\d+) : (\d+); \}",
                     src)
    assert rule is not None
    limit, small, large = map(int, rule.groups())
    for d in dec.HEAD_DIMS:
        assert dec.split_rows(d) == (small if d <= limit else large)
    assert "constexpr int kMaxSplit = {};".format(max(small, large)) in src


# ---------------------------------------------------------------------------
# paged_decode_attention: the split-KV body over a paged arena
# ---------------------------------------------------------------------------

def _paged_arena(rng, B, KV, d, ps, T, lengths):
    """A shuffled arena whose pages hold the dense rows k, v [B, KV, T, d]
    (T a multiple of ps); a sequence of length 1 sits on the null page 0,
    as a free slot does.  Returns the dense view, the arena, the table."""
    NB = T // ps
    n_pages = 1 + B * NB
    kp = rng.standard_normal((n_pages, ps, KV, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, KV, d)).astype(np.float32)
    pt = (rng.permutation(n_pages - 1) + 1)[:B * NB].reshape(B, NB).astype(np.int32)
    for b, n in enumerate(lengths):
        if n == 1:
            pt[b] = 0
    kp, vp, pt = map(torch.from_numpy, (kp, vp, pt))
    k = kp[pt.long()].reshape(B, T, KV, d).transpose(1, 2)
    v = vp[pt.long()].reshape(B, T, KV, d).transpose(1, 2)
    return k, v, kp, vp, pt


@pytest.mark.parametrize("d", dec.HEAD_DIMS)
@pytest.mark.parametrize("ps", [1, 3, 8, 16])
def test_paged_schedule_equals_dense_schedule(ps, d):
    """Paged and dense decode run one body: over the same logical rows the
    page walk gives the dense schedule's bits, for page sizes that divide
    a span, that do not (3), and one row per page, at lengths 0, 1,
    exactly one span and one past it."""
    split = dec.split_rows(d)
    lengths = [0, 1, split, split + 1, 2 * split - 3]
    T = -(-(2 * split) // ps) * ps                # NB * ps, >= every length
    H, KV = (4, 2) if d <= 128 else (2, 1)
    rng = np.random.default_rng(ps * 1000 + d)
    k, v, kp, vp, pt = _paged_arena(rng, len(lengths), KV, d, ps, T, lengths)
    q = torch.from_numpy(rng.standard_normal((len(lengths), H, d)).astype(np.float32))
    ln = torch.tensor(lengths, dtype=torch.int32)
    paged = paged_split_kv_schedule(q, kp, vp, pt, ln)
    dense = split_kv_schedule(q, k, v, ln)
    assert torch.equal(paged, dense)
    assert (paged[0] == 0).all()                  # length 0 gives zeros


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H,KV,d,ps,T,lengths", [
    (9, 3, 64, 8, 192, [0, 1, 5, 64, 65, 192]),    # smollm heads, page size 8
    (4, 4, 80, 3, 129, [128, 3, 0, 64]),           # G = 1, ps not dividing a span
    (8, 1, 256, 16, 96, [96, 31, 32, 33]),         # 32-row spans: 2 pages each
    (8, 2, 128, 1, 130, [130, 1, 77]),             # one row per page
])
def test_paged_schedule_matches_ref_and_pallas(H, KV, d, ps, T, lengths, int8):
    """The paged schedule against the JAX package's plain version and its
    Pallas kernel (interpret mode), for an fp32 and an int8 arena.
    Tolerance 1e-5 (summation order only: both dequantize as row *
    scale in fp32)."""
    from repro.kernels.ops import paged_decode_attention as pallas_paged
    from repro.models import quant as jquant
    B = len(lengths)
    rng = np.random.default_rng(H * 100 + d + ps)
    _, _, kp, vp, pt = _paged_arena(rng, B, KV, d, ps, T, lengths)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    kp, vp, pt = kp.numpy(), vp.numpy(), pt.numpy()
    jkw, tkw = {}, {}
    if int8:
        kq, ksj = jquant.quantize_rows(jnp.asarray(kp))
        vq, vsj = jquant.quantize_rows(jnp.asarray(vp))
        kp, vp, ks, vs = map(np.array, (kq, vq, ksj, vsj))
        jkw = {"k_scales": jnp.asarray(ks), "v_scales": jnp.asarray(vs)}
        tkw = {"k_scales": torch.from_numpy(ks), "v_scales": torch.from_numpy(vs)}
    got = paged_split_kv_schedule(torch.from_numpy(q), torch.from_numpy(kp),
                                  torch.from_numpy(vp), torch.from_numpy(pt),
                                  torch.from_numpy(ln), **tkw).numpy()
    jargs = tuple(map(jnp.asarray, (q, kp, vp, pt, ln)))
    live = ln > 0
    want = np.asarray(jref.paged_decode_attention_ref(*jargs, **jkw))
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=1e-5)
    pallas = np.asarray(pallas_paged(*jargs, **jkw))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    assert (got[~live] == 0).all()


def test_paged_schedule_sequence_alone_equals_it_in_a_batch():
    rng = np.random.default_rng(5)
    lengths = [300, 1, 64, 0, 129, 320, 17, 250]
    B, H, KV, d, ps, T = len(lengths), 9, 3, 64, 8, 320
    _, _, kp, vp, pt = _paged_arena(rng, B, KV, d, ps, T, lengths)
    q = torch.from_numpy(rng.standard_normal((B, H, d)).astype(np.float32))
    ln = torch.tensor(lengths, dtype=torch.int32)
    batch = paged_split_kv_schedule(q, kp, vp, pt, ln)
    for b in (0, 4, 6):
        alone = paged_split_kv_schedule(q[b:b + 1], kp, vp, pt[b:b + 1], ln[b:b + 1])
        assert torch.equal(alone, batch[b:b + 1])


def test_paged_cuda_source_runs_the_shared_body():
    """Both decode kernels take their span, schedule and merge from
    csrc/decode_split.cuh: neither defines a kernel, a split rule or a
    merge of its own, and each hands its row source to the shared launch."""
    shared = (_build.CSRC / "decode_split.cuh").read_text()
    assert "decode_split_kernel" in shared and "decode_merge_kernel" in shared
    for name, source in (("paged_decode_attention.cu", "PagedRows"),
                         ("decode_attention.cu", "DenseRows")):
        src = (_build.CSRC / name).read_text()
        code = "\n".join(line.split("//")[0] for line in src.splitlines())
        assert '#include "decode_split.cuh"' in code
        assert "launch_decode<" in code and source in code
        for own in ("__global__", "split_rows(int", "kMaxSplit =", "SPLIT =",
                    "decode_merge_kernel", "decode_split_kernel", "<<<"):
            assert own not in code, (name, own)
        assert "split != split_rows(d)" not in code    # checked once, shared
        assert "decode_args_ok(" in code
    assert "PagedInt8Rows" in (_build.CSRC / "paged_decode_attention.cu").read_text()
