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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, meta, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ARGTYPES = ([_P] * 7                             # q k v lengths part_acc part_ml out
             + [_I] * 7                           # B H KV d T split n_splits
             + [_L] * 6                           # k, v (b, t, h) strides
             + [_I, _P])                          # dtype stream
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
    """
    if meta.is_meta(q):
        return meta.kernel_call("decode_attention", (q, k, v),
                                lambda: torch.empty_like(q))
    B, H, d = q.shape
    lengths = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    lengths = lengths.reshape(-1).expand(B).contiguous()
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    KV, T = k.shape[1], k.shape[2]
    _require(k.device == v.device == q.device, "all tensors must be on one device")
    _require(q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype,
             f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    _require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == d,
             f"shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
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
    out = torch.empty_like(q)
    split, ns = split_rows(d), n_splits(T, d)
    # ``part`` stays referenced until the launch is queued
    part, acc_ptr, ml_ptr = partials(B, KV, H // KV, d, ns, q.device)
    fn = _build.function("repro_decode_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 acc_ptr, ml_ptr, out.data_ptr(),
                 B, H, KV, d, T, split, ns, *strides, _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: launch failed, cudaError_t {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
