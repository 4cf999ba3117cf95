"""The arithmetic of the ``ssd_scan`` CUDA kernel's schedule, on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain versions there).  This file replays its three phases in plain torch
at small sizes, with inputs made from a numpy seed, and holds the replay
against the JAX Pallas ``ssd_scan`` in interpret mode and the JAX
sequential reference (``repro.kernels.ref.ssd_scan_ref``), within 1e-4 of
the largest |y| and |h|, the tolerance of ``chip_smoke.py``:

1. chunk states, per (chunk, head, batch): the cumulative log decay A of
   the chunk in row order, A_tot, and dH = X^T (B * exp(A_tot - A_j));
2. the state pass, per (batch, head): h_k = exp(A_tot_k) h_{k-1} + dH_k,
   the state entering chunk k kept for phase 3;
3. chunk outputs, per row group of 16 rows: the accumulator starts at
   C h^T, its row i is scaled by exp(A_i), then for columns j <= i in
   steps of 32 the scores C B^T, masked and decayed by exp(A_i - A_j)
   (both taken as exp2 of log2(e)-scaled decays), times X.

Every product is replayed as the kernel runs it: ``mma.m16n8k8`` steps of
eight along the contracted axis, each adding its exact dot products to
fp32 accumulators, with TF32 operands split as the kernel splits them
(``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties away):
a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, and an operand made of bf16
values taken as exact (its low part zero, its passes dropped).
"""

import math
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as wrapper  # noqa: E402

Q_MAX = 128          # rows of one chunk at most
ROW_TILE = 64        # chunk rows per phase-3 block, 16 per warp
WARP_ROWS = ROW_TILE // 4
J_STEP = 32          # score columns per step of a phase-3 warp
STATE_SLAB = 64      # dh rows per pass of phase 1, 16 per warp pair
MMA_K = 8            # the contracted length of one mma.m16n8k8
RTOL = 1e-4          # of the largest |y| and |h|
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 as ``cvt.rna.tf32.f32`` rounds them:
    the 13 low mantissa bits dropped, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor, exact: bool, passes: int = 3):
    """(hi, lo) of the 3xTF32 split; lo is None for an exact operand (bf16
    values) and for a single pass."""
    if exact:
        return x, None
    hi = tf32(x)
    return hi, (tf32(x - hi) if passes == 3 else None)


def mma_chain(acc, a, b, a_exact=False, b_exact=False, passes=3):
    """acc [..., m, n] fp32 += a [..., m, k] @ b [..., k, n] in steps of
    ``MMA_K`` along k, each step the kernel's passes in its order (a_lo
    b_hi, a_hi b_lo, a_hi b_hi), each pass adding its exact dot products
    (taken in float64, the order of the eight fixed) to the fp32
    accumulator."""
    k = a.shape[-1]
    assert k % MMA_K == 0 and b.shape[-2] == k
    for k0 in range(0, k, MMA_K):
        ah, al = split(a[..., k0:k0 + MMA_K], a_exact, passes)
        bh, bl = split(b[..., k0:k0 + MMA_K, :], b_exact, passes)
        terms = ([(al, bh)] if al is not None else []) + (
            [(ah, bl)] if bl is not None else []) + [(ah, bh)]
        for x, y in terms:
            x, y = x.double(), y.double()
            dot = x[..., :, 0:1] * y[..., 0:1, :]
            for q in range(1, MMA_K):
                dot = dot + x[..., :, q:q + 1] * y[..., q:q + 1, :]
            acc = (acc.double() + dot).float()
    return acc


def _exp(x: torch.Tensor) -> torch.Tensor:
    """expf, correctly rounded (float64), so an element's value does not
    depend on its position in a vectorised call."""
    return torch.exp(x.double()).float()


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """exp2f, correctly rounded (float64)."""
    return torch.exp2(x.double()).float()


def ssd_schedule(xb, Bm, Cm, ld, Q, h0=None, bc_exact=False, passes=3):
    """The kernel's three phases.  xb [B, S, H, dh], Bm / Cm [B, S, ds]
    (bc_exact: bf16 values held in fp32), ld [B, S, H], h0 [B, H, dh, ds]
    or None.  Returns (y [B, S, H, dh], h [B, H, dh, ds]), fp32."""
    Bb, S, H, dh = xb.shape
    ds = Bm.shape[-1]
    assert 1 <= Q <= Q_MAX and dh % 32 == 0 and ds % MMA_K == 0
    K = -(-S // Q)
    # phase 1: per chunk, A in row order, A_tot, dH [B, H, dh, ds]
    acum, d_h = [], []
    for k in range(K):
        c0, n = k * Q, min(Q, S - k * Q)
        npad = -(-n // MMA_K) * MMA_K
        run = torch.zeros((Bb, H))
        A = []
        for i in range(n):
            run = run + ld[:, c0 + i]
            A.append(run)
        A = torch.stack(A, dim=-1)                                  # [B, H, n]
        e = _exp(A[..., -1:] - A)                                   # [B, H, n]
        xs = xb[:, c0:c0 + n].permute(0, 2, 3, 1) * e[:, :, None]   # [B, H, dh, n]
        bs = Bm[:, c0:c0 + n][:, None].expand(Bb, H, n, ds)
        pad = npad - n                                              # zero rows
        xs = torch.nn.functional.pad(xs, (0, pad))
        bs = torch.nn.functional.pad(bs, (0, 0, 0, pad))
        d_h.append(mma_chain(torch.zeros((Bb, H, dh, ds)), xs, bs,
                             b_exact=bc_exact, passes=passes))
        acum.append(A)
    # phase 2: the state entering each chunk, and the final state
    h = torch.zeros((Bb, H, dh, ds)) if h0 is None else h0.clone()
    h_in = []
    for k in range(K):
        h_in.append(h)
        h = _exp(acum[k][..., -1])[..., None, None] * h + d_h[k]
    # phase 3: per chunk, per row group of WARP_ROWS rows; the decays in
    # log2 units, exp(A_i - A_j) = exp2(A2_i - A2_j) with A2 = A log2(e)
    y = torch.zeros((Bb, S, H, dh))
    for k in range(K):
        c0, n = k * Q, min(Q, S - k * Q)
        A = acum[k] * torch.tensor(LOG2E, dtype=torch.float32)     # [B, H, n]
        cols = -(-n // J_STEP) * J_STEP
        bpad = torch.nn.functional.pad(Bm[:, c0:c0 + n], (0, 0, 0, cols - n))
        xpad = torch.nn.functional.pad(xb[:, c0:c0 + n].permute(0, 2, 1, 3),
                                       (0, 0, 0, cols - n))         # [B, H, cols, dh]
        apad = torch.cat([A, A[..., -1:].expand(Bb, H, cols - n)], dim=-1)
        for m0 in range(0, n, WARP_ROWS):
            rows = torch.arange(m0, m0 + WARP_ROWS)
            rows_c = rows.clamp(max=n - 1)
            c = torch.nn.functional.pad(Cm[:, c0 + m0:c0 + min(m0 + WARP_ROWS, n)],
                                        (0, 0, 0, max(0, m0 + WARP_ROWS - n)))
            c = c[:, None].expand(Bb, H, WARP_ROWS, ds)
            acc = torch.zeros((Bb, H, WARP_ROWS, dh))
            if k > 0 or h0 is not None:
                acc = mma_chain(acc, c, h_in[k].transpose(-1, -2),
                                a_exact=bc_exact, passes=passes)
                acc = acc * _exp2(A[..., rows_c])[..., None]
            last = m0 + WARP_ROWS - 1
            for j0 in range(0, last + 1, J_STEP):
                width = min(J_STEP, last + 1 - j0)                  # live 8-col tiles
                width = -(-width // MMA_K) * MMA_K
                bj = bpad[:, None, j0:j0 + width].expand(Bb, H, width, ds)
                sc = mma_chain(torch.zeros((Bb, H, WARP_ROWS, width)), c,
                               bj.transpose(-1, -2), bc_exact, bc_exact, passes)
                j = torch.arange(j0, j0 + width)
                a_i = apad[..., rows_c.clamp(max=cols - 1)][..., :, None]
                a_j = apad[..., j][..., None, :]
                causal = (j[None, :] <= rows[:, None])
                w = torch.where(causal, sc * _exp2(a_i - a_j), torch.zeros(()))
                acc = mma_chain(acc, w, xpad[:, :, j0:j0 + width], passes=passes)
            live = rows < n
            y[:, c0 + m0:c0 + m0 + int(live.sum())] = acc[:, :, :int(live.sum())
                                                          ].permute(0, 2, 1, 3)
    return y, h


def _inputs(B, S, H, dh, ds, seed, with_h0, bf16_bc):
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, ds)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, ds)) * 0.5).astype(np.float32)
    if bf16_bc:                       # bf16 values, held in fp32 for JAX
        Bm = torch.from_numpy(Bm).bfloat16().float().numpy()
        Cm = torch.from_numpy(Cm).bfloat16().float().numpy()
    ld = (-rng.random((B, S, H)) * 0.25).astype(np.float32)
    h0 = rng.standard_normal((B, H, dh, ds)).astype(np.float32) if with_h0 else None
    return xb, Bm, Cm, ld, h0


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_sequential(xb, Bm, Cm, ld, h0):
    return jref.ssd_scan_ref(jnp.asarray(xb), jnp.asarray(Bm), jnp.asarray(Cm),
                             jnp.asarray(ld), None if h0 is None else jnp.asarray(h0))


@pytest.mark.parametrize("B,S,H,dh,ds,Q,with_h0,bf16_bc", [
    (1, 256, 2, 64, 64, 128, False, False),   # zamba2's head and chunk, 2 chunks
    (1, 128, 2, 64, 64, 128, False, True),    # one full chunk, bf16 B / C
    (2, 200, 2, 64, 64, 128, True, True),     # ragged S, h0, bf16 B / C
    (1, 96, 3, 32, 16, 32, True, False),      # narrow heads and state
    (1, 64, 1, 96, 128, 64, False, False),    # dh = 96 (slabs of 32 in phase 3), ds = 128
])
def test_ssd_schedule_matches_pallas_and_sequential(B, S, H, dh, ds, Q, with_h0,
                                                    bf16_bc):
    xb, Bm, Cm, ld, h0 = _inputs(B, S, H, dh, ds, S + dh, with_h0, bf16_bc)
    y, h = ssd_schedule(*map(_t, (xb, Bm, Cm, ld)), Q, _t(h0), bc_exact=bf16_bc)
    jy, jh = _jax_sequential(xb, Bm, Cm, ld, h0)
    assert _rel_err(y, jy) <= RTOL and _rel_err(h, jh) <= RTOL
    if h0 is None and S % Q == 0:     # the Pallas kernel starts from zeros
        py, ph = pallas_ssd_scan(jnp.moveaxis(jnp.asarray(xb), 1, 2),
                                 jnp.asarray(Bm), jnp.asarray(Cm),
                                 jnp.moveaxis(jnp.asarray(ld), 1, 2),
                                 chunk=Q, interpret=True)
        assert _rel_err(y, jnp.moveaxis(py, 1, 2)) <= RTOL
        assert _rel_err(h, ph) <= RTOL


def test_ssd_schedule_sequence_alone_equals_it_in_a_batch():
    """No phase mixes sequences and every sum's order is set by the
    shapes, so a sequence's y and h are the same bits alone or in a batch
    (and the layer-streamed prefill equals the monolithic one)."""
    xb, Bm, Cm, ld, h0 = map(_t, _inputs(3, 150, 2, 64, 64, 4, True, True))
    y, h = ssd_schedule(xb, Bm, Cm, ld, 128, h0, bc_exact=True)
    for b in (0, 2):
        s = slice(b, b + 1)
        ya, ha = ssd_schedule(xb[s], Bm[s], Cm[s], ld[s], 128, h0[s], bc_exact=True)
        assert torch.equal(ya, y[s]) and torch.equal(ha, h[s])


def tf32_split_errors(seed: int = 7) -> dict:
    """Relative errors of the replay against the JAX sequential reference
    at zamba2's head shape (dh = ds = 64, chunk 128, S = 256, fp32 B / C),
    with the 3xTF32 split and with one plain TF32 pass."""
    xb, Bm, Cm, ld, h0 = _inputs(1, 256, 2, 64, 64, seed, True, False)
    jy, jh = _jax_sequential(xb, Bm, Cm, ld, h0)
    out = {}
    for passes in (3, 1):
        y, h = ssd_schedule(*map(_t, (xb, Bm, Cm, ld)), 128, _t(h0), passes=passes)
        out[f"{passes}xTF32"] = {"y": _rel_err(y, jy), "h": _rel_err(h, jh)}
    return out


def test_one_tf32_pass_misses_the_tolerance_the_split_meets():
    """Why the kernel splits its operands: one TF32 pass keeps ~11 bits of
    each operand, and its error at zamba2's shapes exceeds the 1e-4
    tolerance by an order of magnitude; the 3xTF32 split stays well
    inside it."""
    err = tf32_split_errors()
    assert max(err["3xTF32"].values()) <= RTOL / 10
    assert max(err["1xTF32"].values()) > RTOL


def test_tf32_rounding_matches_cvt_rna():
    """The replay's rounding: 10 mantissa bits, to nearest, ties away from
    zero, for both signs; a bf16 value is unchanged."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0])
    assert torch.equal(tf32(x), want)
    b = torch.randn(64, generator=torch.Generator().manual_seed(0)).bfloat16().float()
    assert torch.equal(tf32(b), b)
    hi, lo = split(torch.tensor([math.pi], dtype=torch.float32), False)
    assert torch.equal(tf32(hi), hi) and abs(float(hi + lo) - math.pi) < 1e-6


def test_cuda_source_agrees_on_the_schedule():
    """csrc/ssd_scan.cu runs the replay's tiles and instructions, and the
    wrapper's limits are the kernel's."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    consts = {name: int(v) for name, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kQMax"] == Q_MAX == wrapper.MAX_CHUNK
    assert consts["kRowTile"] == ROW_TILE and consts["kJStep"] == J_STEP
    assert consts["kStateSlab"] == STATE_SLAB
    # phase 3's eight warps: four row groups of WARP_ROWS, two column halves
    assert consts["kOutThreads"] == 2 * (ROW_TILE // WARP_ROWS) * 32
    assert "constexpr float kLog2e = 1.4426950408889634f;" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cvt.rna.tf32.f32" in src
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*\n(\w+)\(", src)
    assert kernels == ["chunk_state_kernel", "state_pass_kernel", "chunk_out_kernel"]
    assert not re.search(r"\batomic[A-Z]", src)
    assert 'extern "C" int repro_ssd_scan(' in src


def test_phase_three_fills_the_card_at_one_chunk():
    """B = 1, S = 128 at zamba2's 80 heads: the output phase alone gives
    more blocks than the H100 has SMs (132)."""
    Q, S, H = 128, 128, 80
    blocks = -(-Q // ROW_TILE) * (-(-S // Q)) * H
    assert blocks >= 132


@pytest.mark.parametrize("Bb,S,H,dh,ds,chunk", [(1, 200, 80, 64, 64, 128),
                                                (4, 256, 3, 32, 16, 16)])
def test_scratch_holds_states_and_decays(Bb, S, H, dh, ds, chunk):
    K = -(-S // chunk)
    assert wrapper.scratch_floats(Bb, S, H, dh, ds, chunk) == (
        Bb * K * H * dh * ds + Bb * H * K * chunk)


if __name__ == "__main__":
    # the replay's error with and without the split (PERF.md quotes it)
    print(tf32_split_errors())
