"""Decode attention over a dense cache: wrapper of ``csrc/decode_attention.cu``.

For tensors on a CUDA device the wrapper launches the hand-written kernel
or raises; for tensors on the CPU it runs the plain version in ``ref.py``.
k and v may be strided views (the model hands in its [B, T, KV, d] layer
cache transposed to [B, KV, T, d]); only the head-dim axis must be
contiguous (and rows start on 16 bytes), so the cache is read in its
storage layout.

The kernel splits each sequence's cache rows across blocks (split-KV):
every block takes :func:`split_rows` rows, a count fixed per head dim, and
a second launch merges the partials in a fixed order.  One call counts one
launch.  The lengths are never read on the host.

Over a cache whose sequence axis is split over the model ranks (each rank
holds rows ``[r T / tp, (r + 1) T / tp)`` of every KV head),
:func:`decode_attention_slice` runs the same two launches over one rank's
rows and returns the merged output and its log-sum-exp, fp32, and
:func:`decode_merge_ranks` combines the ranks' gathered ``(o, lse)`` in
rank order with the second launch alone (``csrc/decode_split.cuh``'s
``RankParts``).  Together they replace the JAX package's flash-decoding
over a sequence-sharded cache, which GSPMD derives from its cache specs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, grad, meta, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ARGTYPES = ([_P] * 7                             # q k v lengths part_acc part_ml out
             + [_I] * 7                           # B H KV d T split n_splits
             + [_L] * 6                           # k, v (b, t, h) strides
             + [_I, _P])                          # dtype stream
_SLICE_ARGTYPES = [_P] * 8 + _ARGTYPES[7:]        # ... out lse, then as above
_MERGE_ARGTYPES = [_P] * 3 + [_I] * 5 + [_P]      # o lse out R B H d dtype stream
MAX_GROUP = 8                                     # query heads per KV head
HEAD_DIMS = (64, 80, 128, 256)                    # 80: zamba2's shared attention


def split_rows(d: int) -> int:
    """Cache rows one block of the split-KV kernel takes.

    Fixed per head dim (64 up to d = 128, 32 at d = 256, where a row takes
    more registers) and never chosen from the batch, the KV heads or the
    lengths, so a sequence's output does not depend on the batch it
    decodes in.  ``csrc/decode_split.cuh`` holds the same rule, and both
    CUDA entry points refuse another split.
    """
    return 64 if d <= 128 else 32


def n_splits(T: int, d: int) -> int:
    """Blocks per (sequence, KV head): ``ceil(T / split_rows(d))`` over the
    cache's allocated length ``T``."""
    return -(-T // split_rows(d))


def partials(B: int, KV: int, G: int, d: int, ns: int, device) -> tuple:
    """The split-KV partials' scratch of one call, uninitialised (every
    block writes its own): ``[B * KV, splits, G, d]`` fp32 accumulators,
    then ``[B * KV, splits, G, 2]`` (m, l).  Returns the buffer and the
    addresses of the two parts."""
    n_acc = B * KV * ns * G * d
    part = torch.empty(n_acc + B * KV * ns * G * 2, dtype=torch.float32,
                       device=device)
    return part, part.data_ptr(), part.data_ptr() + 4 * n_acc


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention: {msg}")


def decode_attention(q, k, v, length):
    """One-token attention against a dense KV cache.

    Args:
      q: [B, H, d] query (one decode token per sequence), fp32 or bf16.
      k, v: [B, KV, T, d] keys/values in q's dtype (H a multiple of KV,
        H / KV <= 8); any strides with a contiguous head dim.
      length: int or [B] number of valid cache rows per sequence.

    Returns:
      [B, H, d] in ``q.dtype``.

    Raises ``NotImplementedError`` off the CPU when a gradient is needed:
    the kernel has no backward.
    """
    grad.refuse("decode_attention", grad.DECODE_BWD, q, k, v)
    if meta.is_meta(q):
        return meta.kernel_call("decode_attention", (q, k, v),
                                lambda: torch.empty_like(q))
    lengths = _lengths(q, length)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths)
    strides = _check(q, k, v)
    out = torch.empty_like(q)
    _launch("repro_decode_attention", _ARGTYPES, q, k, v, lengths, strides,
            (out.data_ptr(),))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _lengths(q, length) -> torch.Tensor:
    lengths = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    return lengths.reshape(-1).expand(q.shape[0]).contiguous()


def _check(q, k, v) -> list:
    """The CUDA entries' argument checks; returns k's and v's strides
    over the (batch, row, KV head) axes."""
    B, H, d = q.shape
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    KV = k.shape[1]
    _require(k.device == v.device == q.device, "all tensors must be on one device")
    _require(q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype,
             f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    _require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == d,
             f"shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    _require(H > 0 and KV > 0, f"H={H}, KV={KV}: no heads, a zero-sized grid")
    _require(H % KV == 0 and H // KV <= MAX_GROUP,
             f"H={H}, KV={KV} (G = H / KV must be at most {MAX_GROUP})")
    _require(d in HEAD_DIMS, f"head_dim {d} (one of {HEAD_DIMS})")
    _require(q.is_contiguous(), "q must be contiguous")
    _require(k.stride(-1) == 1 and v.stride(-1) == 1,
             "the head-dim axis of k and v must be contiguous")
    # kernel strides are over the (batch, row, KV head) axes
    strides = [t.stride(i) for t in (k, v) for i in (0, 2, 1)]
    vec = 16 // q.element_size()
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v))
             and all(st % vec == 0 for st in strides),
             f"rows must start on 16 bytes (pointers 16-byte aligned, strides "
             f"multiples of {vec} elements)")
    return strides


def _launch(entry: str, argtypes: list, q, k, v, lengths, strides,
            outs: tuple) -> None:
    """Both launches of one call of ``entry`` into the output pointers
    ``outs``, over fresh split-KV partials."""
    B, H, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    split, ns = split_rows(d), n_splits(T, d)
    # ``part`` stays referenced until the launch is queued
    part, acc_ptr, ml_ptr = partials(B, KV, H // KV, d, ns, q.device)
    fn = _build.function(entry, argtypes)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 acc_ptr, ml_ptr, *outs,
                 B, H, KV, d, T, split, ns, *strides, _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: launch failed, cudaError_t {err}")


def decode_attention_slice(q, k, v, length):
    """One-token attention over one rank's rows of a sequence-sharded
    dense cache.

    Args:
      q: [B, H, d] query (every query head), fp32 or bf16.
      k, v: [B, KV, T_r, d] the rank's rows of every KV head, as for
        :func:`decode_attention`.
      length: int or [B] valid rows of each sequence within the slice
        (0 where the slice holds none of its rows).

    Returns:
      (o [B, H, d] fp32, lse [B, H] fp32): the output over the slice's
      rows and its log-sum-exp; a sequence with no rows here gives zeros
      and -inf, which :func:`decode_merge_ranks` skips.

    The meta branch allocates the CUDA call's split-KV scratch too, so a
    shape-only trace holds the bytes a card call holds.
    """
    grad.refuse("decode_attention_slice", grad.DECODE_BWD, q, k, v)
    B, H, d = q.shape
    if meta.is_meta(q):
        def make_out():           # the outputs, then the scratch (freed)
            out = (q.new_empty((B, H, d), dtype=torch.float32),
                   q.new_empty((B, H), dtype=torch.float32))
            partials(B, k.shape[1], H // k.shape[1], d,
                     n_splits(k.shape[2], d), q.device)
            return out
        return meta.kernel_call("decode_attention_slice", (q, k, v), make_out)
    lengths = _lengths(q, length)
    if q.device.type == "cpu":
        return ref.decode_attention_slice_ref(q, k, v, lengths)
    strides = _check(q, k, v)
    out = torch.empty((B, H, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    _launch("repro_decode_attention_slice", _SLICE_ARGTYPES, q, k, v, lengths,
            strides, (out.data_ptr(), lse.data_ptr()))
    decode_attention_slice.launches += 1
    return out, lse


decode_attention_slice.launches = 0


def decode_merge_ranks(o, lse, dtype):
    """The ranks' slice results merged, in rank order.

    Args:
      o: [R, B, H, d] fp32, rank r's :func:`decode_attention_slice` output.
      lse: [R, B, H] fp32, its log-sum-exp (-inf: no rows on that rank).
      dtype: the output dtype (fp32 or bf16).

    Returns:
      [B, H, d] in ``dtype``: zeros for a sequence with no rows anywhere.
    """
    R, B, H, d = o.shape
    if meta.is_meta(o):
        return meta.kernel_call("decode_merge_ranks", (o, lse),
                                lambda: o.new_empty((B, H, d), dtype=dtype))
    if o.device.type == "cpu":
        return ref.decode_merge_ranks_ref(o, lse, dtype)
    _require(o.device.type == "cuda", f"unsupported device {o.device}")
    _require(o.dtype == lse.dtype == torch.float32 and dtype in _DTYPES,
             f"dtypes o={o.dtype} lse={lse.dtype} out={dtype}")
    _require(tuple(lse.shape) == (R, B, H) and lse.device == o.device,
             f"shapes o={tuple(o.shape)} lse={tuple(lse.shape)}")
    o, lse = o.contiguous(), lse.contiguous()
    out = torch.empty((B, H, d), dtype=dtype, device=o.device)
    fn = _build.function("repro_decode_merge_ranks", _MERGE_ARGTYPES)
    with torch.cuda.device(o.device):
        err = fn(o.data_ptr(), lse.data_ptr(), out.data_ptr(), R, B, H, d,
                 _DTYPES[dtype], torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_merge_ranks: launch failed, cudaError_t {err}")
    decode_merge_ranks.launches += 1
    return out


decode_merge_ranks.launches = 0
