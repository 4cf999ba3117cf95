"""Flash attention (prefill and training): wrappers of
``csrc/flash_attention.cu`` and, for the gradient,
``csrc/flash_attention_bwd.cu``.

For tensors on a CUDA device the wrappers launch the hand-written kernels
or raise; for tensors on the CPU they run the plain versions in
``ref.py``.  When a gradient is needed (grad mode on and an input that
requires grad) the call goes through a ``torch.autograd.Function``: the
forward also writes each query row's log-sum-exp, and the backward
launches the backward kernel (fp32 only; a bf16 call raises).
bf16 runs the tensor-core kernel, fp32 the CUDA-core one (the port's
parity dtype).  q, k and v may be strided views (the model hands in its
[B, S, H, d] activations and [B, T, KV, d] cache transposed); only the
head-dim axis must be contiguous, and in bf16 every row must start on 16
bytes (the kernel copies whole 16-byte chunks).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, grad, meta, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ARGTYPES = ([_P, _P, _P, _P]                     # q k v out
             + [_I] * 6                           # B H KV S T d
             + [_L] * 12                          # (b, h, s) strides x4
             + [ctypes.c_float, _I, _I, _P, _P])  # softcap causal dtype lse stream
_BWD_ARGTYPES = ([_P] * 10                        # q k v o lse do D dq dk dv
                 + [_I] * 6                       # B H KV S T d
                 + [_L] * 21                      # (b, h, s) strides x7
                 + [ctypes.c_float, _I, _P])      # softcap causal stream
HEAD_DIMS = (16, 32, 64, 80, 128, 256)            # compiled instantiations


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _check(q, k, v, causal: bool) -> None:
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


def _launch(q, k, v, causal: bool, softcap: float, lse=None):
    """One forward launch; ``lse`` (fp32 [B, H, S], contiguous) receives
    each row's log-sum-exp when given (fp32 only)."""
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    _check(q, k, v, causal)
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
                 _DTYPES[q.dtype], None if lse is None else lse.data_ptr(),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: launch failed, cudaError_t {err}")
    flash_attention.launches += 1
    return out


def _lse_like(q) -> torch.Tensor:
    B, H, S, _ = q.shape
    return torch.empty((B, H, S), dtype=torch.float32, device=q.device)


class _FlashFunction(torch.autograd.Function):
    """Forward: the kernel with its log-sum-exp output (CPU: the plain
    version); backward: :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap):
        if meta.is_meta(q):
            out = meta.kernel_call("flash_attention", (q, k, v),
                                   lambda: _meta_out(q))
            lse = _lse_like(q)
        elif q.device.type == "cpu":
            out, lse = ref.flash_attention_fwd_ref(q, k, v, causal, softcap)
        else:
            _require(q.device.type == "cuda", f"unsupported device {q.device}")
            lse = _lse_like(q)
            out = _launch(q, k, v, causal, softcap, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.softcap = causal, softcap
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.softcap)
        return dq, dk, dv, None, None


def _meta_out(q):
    return torch.empty(q.shape[:1] + q.shape[2:3] + q.shape[1:2] + q.shape[3:],
                       dtype=q.dtype, device=q.device).transpose(1, 2)


def flash_attention(q, k, v, causal: bool = True, softcap: float = 0.0):
    """Multi-token attention, causal by default.

    Args:
      q: [B, H, S, d] queries, fp32 or bf16.
      k, v: [B, KV, T, d] keys/values (H a multiple of KV; T >= S when
        causal, the mask aligned bottom-right: ``col <= row + T - S``).
      softcap: tanh logit soft-capping (0 disables).

    Returns:
      [B, H, S, d] in ``q.dtype`` (on the card, a view of a [B, S, H, d]
      buffer, so the caller's transpose back is free).  When a gradient
      is needed the output carries it (:class:`_FlashFunction`); off the
      CPU that takes fp32, and bf16 raises ``NotImplementedError``.
    """
    if grad.needs_grad(q, k, v):
        if q.device.type != "cpu" and q.dtype != torch.float32:
            raise NotImplementedError(
                f"flash_attention: no {q.dtype} backward kernel on "
                f"{q.device.type} ({grad.BF16_BWD}); train in float32")
        return _FlashFunction.apply(q, k, v, causal, softcap)
    if meta.is_meta(q):
        return meta.kernel_call("flash_attention", (q, k, v),
                                lambda: _meta_out(q))
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    return _launch(q, k, v, causal, softcap)


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        softcap: float = 0.0):
    """Gradients of :func:`flash_attention` (fp32): ``(dq, dk, dv)``.

    Args:
      q, k, v: the forward's inputs (any strides with a contiguous head
        dim); o: its output [B, H, S, d]; lse: its rows' log-sum-exp, fp32
        [B, H, S], contiguous; do: the gradient at ``o``.

    Returns:
      dq [B, H, S, d] (a view of a [B, S, H, d] buffer), dk and dv
      [B, KV, T, d] (views of [B, T, KV, d] buffers), fp32.  On the card
      one call runs three launches (D = rowsum(dO * O), then dK and dV
      per key tile, then dQ per query tile; counted as one); on the CPU
      the plain version.
    """
    if meta.is_meta(q):
        B, H, S, d = q.shape
        KV, T = k.shape[1], k.shape[2]
        return meta.kernel_call(
            "flash_attention_bwd", (q, k, v),
            lambda: (_meta_out(q),
                     *(torch.empty((B, T, KV, d), dtype=k.dtype,
                                   device=k.device).transpose(1, 2)
                       for _ in range(2))))
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, softcap)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    if q.dtype != torch.float32:
        raise NotImplementedError(
            f"flash_attention_bwd: no {q.dtype} kernel ({grad.BF16_BWD})")
    _check(q, k, v, causal)
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    if do.stride(-1) != 1:
        do = do.contiguous()
    _require(o.shape == do.shape == q.shape and o.dtype == do.dtype == q.dtype
             and o.stride(-1) == 1, "o and do must be q's shape and dtype")
    _require(lse.shape == (B, H, S) and lse.dtype == torch.float32
             and lse.is_contiguous(), "lse must be fp32 [B, H, S], contiguous")
    _require(all(t.device == q.device for t in (o, lse, do)),
             "all tensors must be on one device")
    dq = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, T, KV, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, T, KV, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = [t.stride(i) for t in (q, k, v, o, do, dq, dk) for i in (0, 1, 2)]
    fn = _build.function("repro_flash_attention_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), D.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), B, H, KV, S, T, d, *strides,
                 float(softcap), int(causal),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: launch failed, cudaError_t {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
