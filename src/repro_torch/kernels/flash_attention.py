"""Causal flash attention (prefill): wrapper of ``csrc/flash_attention.cu``.

For tensors on a CUDA device the wrapper launches the hand-written kernel
or raises; for tensors on the CPU it runs the plain version in ``ref.py``.
bf16 runs the tensor-core kernel, fp32 the CUDA-core one (the port's
parity dtype).  q, k and v may be strided views (the model hands in its
[B, S, H, d] activations and [B, T, KV, d] cache transposed); only the
head-dim axis must be contiguous, and in bf16 every row must start on 16
bytes (the kernel copies whole 16-byte chunks).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, meta, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ARGTYPES = ([_P, _P, _P, _P]                     # q k v out
             + [_I] * 6                           # B H KV S T d
             + [_L] * 12                          # (b, h, s) strides x4
             + [ctypes.c_float, _I, _I, _P])      # softcap causal dtype stream
HEAD_DIMS = (16, 32, 64, 80, 128, 256)            # compiled instantiations


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def flash_attention(q, k, v, causal: bool = True, softcap: float = 0.0):
    """Multi-token attention, causal by default.

    Args:
      q: [B, H, S, d] queries, fp32 or bf16.
      k, v: [B, KV, T, d] keys/values (H a multiple of KV; T >= S when
        causal, the mask aligned bottom-right: ``col <= row + T - S``).
      softcap: tanh logit soft-capping (0 disables).

    Returns:
      [B, H, S, d] in ``q.dtype`` (on the card, a view of a [B, S, H, d]
      buffer, so the caller's transpose back is free).
    """
    if meta.is_meta(q):
        return meta.kernel_call(
            "flash_attention", (q, k, v),
            lambda: torch.empty(q.shape[:1] + q.shape[2:3] + q.shape[1:2]
                                + q.shape[3:], dtype=q.dtype,
                                device=q.device).transpose(1, 2))
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    _require(k.device == v.device == q.device, "all tensors must be on one device")
    _require(q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype,
             f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    _require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == d,
             f"shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    _require(H % KV == 0, f"H={H} not a multiple of KV={KV}")
    _require(d in HEAD_DIMS, f"head_dim {d} (one of {HEAD_DIMS})")
    _require(not causal or T >= S, f"causal needs T >= S (S={S}, T={T})")
    _require(all(t.stride(-1) == 1 for t in (q, k, v)),
             "the head-dim axis must be contiguous")
    out = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)]
    if q.dtype == torch.bfloat16:
        _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v))
                 and all(st % 8 == 0 for st in strides),
                 "bf16 rows must start on 16 bytes (pointers 16-byte aligned, "
                 "strides multiples of 8 elements)")
    fn = _build.function("repro_flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, KV, S, T, d, *strides, float(softcap), int(causal),
                 _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: launch failed, cudaError_t {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
