"""Paged decode attention: wrapper of ``csrc/paged_decode_attention.cu``.

For tensors on a CUDA device the wrapper launches the hand-written kernel
(fp32, bf16, or an int8 arena dequantized on chip) or raises; for tensors
on the CPU it runs the plain version in ``ref.py``.  There is no quiet
fallback from one to the other.

The kernel is ``decode_attention``'s split-KV body with a paged row
source: every block takes ``split_rows(d)`` logical rows of one sequence
and KV head, over ``n_splits(NB * ps, d)`` spans of the allocated length,
and a second launch merges the partials in a fixed order.  One call counts
one launch, and the lengths are never read on the host.  A sequence gets
the bits ``decode_attention`` gives over the same rows in a dense cache.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, grad, meta, ref
from repro_torch.kernels.decode_attention import (HEAD_DIMS, MAX_GROUP, n_splits,
                                                 partials, split_rows)

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ([_P] * 10       # q k v ks vs pt lengths part_acc part_ml out
             + [_I] * 8       # B H KV d ps NB split n_splits
             + [_I, _I, _P])  # q dtype, kv dtype, stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode_attention: {msg}")


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           k_scales=None, v_scales=None):
    """One-token attention against a block-paged KV arena.

    Args:
      q: [B, H, d] query (one decode token per sequence), fp32 or bf16.
      k_pages, v_pages: [P, ps, KV, d] arena in storage layout, q's dtype
        or int8 (then ``k_scales``/``v_scales`` [P, ps, KV] fp32 are given).
      page_table: [B, NB] int32 physical page per logical block.
      lengths: int or [B] valid positions per sequence.

    Returns:
      [B, H, d] in ``q.dtype``.

    Raises ``NotImplementedError`` off the CPU when a gradient is needed:
    the kernel has no backward.
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    grad.refuse("paged_decode_attention", grad.DECODE_BWD, q, k_pages, v_pages,
                k_scales, v_scales)
    if meta.is_meta(q):
        return meta.kernel_call("paged_decode_attention",
                                (q, k_pages, v_pages, page_table),
                                lambda: torch.empty_like(q))
    B, H, d = q.shape
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    lengths = lengths.reshape(-1).expand(B).contiguous()
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                              lengths, k_scales, v_scales)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    P, ps, KV, dk = k_pages.shape
    NB = page_table.shape[1]
    quant = k_scales is not None
    tensors = [q, k_pages, v_pages, page_table, lengths]
    if quant:
        tensors += [k_scales, v_scales]
    _require(all(t.device == q.device for t in tensors),
             "all tensors must be on one device")
    _require(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _require(q.dtype in _Q_DTYPES, f"q dtype {q.dtype}")
    _require(k_pages.dtype == v_pages.dtype, "k and v arenas differ in dtype")
    _require(k_pages.dtype == (torch.int8 if quant else q.dtype),
             f"arena dtype {k_pages.dtype} with q {q.dtype}, scales={quant}")
    _require(v_pages.shape == k_pages.shape and dk == d, "arena shape")
    _require(H % KV == 0 and H // KV <= MAX_GROUP,
             f"H={H}, KV={KV} (G = H / KV must be at most {MAX_GROUP})")
    _require(d in HEAD_DIMS, f"head_dim {d} (one of {HEAD_DIMS})")
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
             "q and the arena must start on 16 bytes")
    _require(page_table.dtype == torch.int32 and page_table.shape[0] == B,
             "page_table must be int32 [B, NB]")
    if quant:
        _require(k_scales.dtype == v_scales.dtype == torch.float32
                 and k_scales.shape == v_scales.shape == (P, ps, KV),
                 "scales must be fp32 [P, ps, KV]")
    out = torch.empty_like(q)
    split, ns = split_rows(d), n_splits(NB * ps, d)
    # ``part`` stays referenced until the launch is queued
    part, acc_ptr, ml_ptr = partials(B, KV, H // KV, d, ns, q.device)
    fn = _build.function("repro_paged_decode_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 k_scales.data_ptr() if quant else None,
                 v_scales.data_ptr() if quant else None,
                 page_table.data_ptr(), lengths.data_ptr(), acc_ptr, ml_ptr,
                 out.data_ptr(),
                 B, H, KV, d, ps, NB, split, ns, _Q_DTYPES[q.dtype],
                 _KV_DTYPES[k_pages.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: launch failed, "
                           f"cudaError_t {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
