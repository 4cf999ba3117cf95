"""Row RMSNorm, optionally with the residual add fused in: wrapper of
``csrc/rmsnorm.cu``.

For tensors on a CUDA device the wrapper launches the hand-written kernel
or raises; for tensors on the CPU it runs the plain version in ``ref.py``.
x (and a residual) may be strided views whose last axis is contiguous and
whose leading axes collapse to one row stride (``x[:, -1:]`` of a
contiguous ``[B, S, D]`` does), so no copy is made; the outputs are
contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, meta, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5                # x res scale y s
             + [ctypes.c_int64, ctypes.c_int,     # rows d
                ctypes.c_int64, ctypes.c_int64,   # x and res row strides
                ctypes.c_float]                   # eps
             + [ctypes.c_int] * 3                 # x dtype, scale dtype, vec
             + [ctypes.c_void_p])                 # stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rmsnorm: {msg}")


def row_stride(x: torch.Tensor) -> int:
    """The one element stride between consecutive rows of ``x`` viewed as
    ``[rows, d]``; raises when the leading axes do not collapse to one."""
    _require(x.dim() >= 1 and x.stride(-1) == 1,
             "the last axis of x must be contiguous")
    lead = [(n, s) for n, s in zip(x.shape[:-1], x.stride()[:-1]) if n != 1]
    if not lead:
        return x.shape[-1]
    for (_, outer), (n, inner) in zip(lead, lead[1:]):
        _require(outer == inner * n,
                 f"leading axes of shape {tuple(x.shape)} and strides "
                 f"{tuple(x.stride())} do not collapse to one row stride")
    return lead[-1][1]


def vector_path(x: torch.Tensor, scale: torch.Tensor,
                residual: torch.Tensor | None = None) -> bool:
    """Whether the kernel reads these inputs with 16-byte loads (its
    vector path; fresh outputs are always aligned): rows, row strides and
    addresses in multiples of 16 bytes."""
    per = 16 // x.element_size()          # elements of one 16-byte access
    ins = (x, scale) + (() if residual is None else (residual,))
    return (x.shape[-1] % per == 0
            and all(row_stride(t) % per == 0 for t in ins if t is not scale)
            and all(t.data_ptr() % 16 == 0 for t in ins))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            residual: torch.Tensor | None = None):
    """RMSNorm over the last axis with fp32 statistics.

    Args:
      x: [..., d] fp32 or bf16, last axis contiguous, leading axes
        collapsing to one row stride.
      scale: [d] fp32 or bf16, contiguous (promoted to fp32).
      eps: added to the mean of squares before the rsqrt.
      residual: optional, x's shape and dtype, the same row-stride rules.

    Returns:
      ``x * rsqrt(mean(x**2) + eps) * scale`` in ``x.dtype``, contiguous;
      with ``residual``, ``(y, s)`` where ``s = x + residual`` and ``y`` is
      the norm of ``s``: equal to ``x + residual`` and to ``rmsnorm(x +
      residual, scale, eps)`` bit for bit.
    """
    fused = residual is not None
    if fused:
        _require(residual.device == x.device,
                 f"residual on {residual.device}, x on {x.device}")
        _require(residual.shape == x.shape and residual.dtype == x.dtype,
                 f"residual {tuple(residual.shape)} {residual.dtype} for x "
                 f"{tuple(x.shape)} {x.dtype}")
    if meta.is_meta(x):
        ins = (x, scale) + ((residual,) if fused else ())

        def empty():
            return torch.empty(x.shape, dtype=x.dtype, device=x.device)

        return meta.kernel_call("rmsnorm", ins,
                                (lambda: (empty(), empty())) if fused else empty)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps, residual=residual)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(scale.device == x.device, "x and scale must be on one device")
    _require(x.dtype in _DTYPES and scale.dtype in _DTYPES,
             f"dtypes x={x.dtype} scale={scale.dtype}")
    d = x.shape[-1]
    _require(scale.shape == (d,) and scale.is_contiguous(),
             f"scale of shape {tuple(scale.shape)} for rows of {d}")
    stride = row_stride(x)
    r_stride = row_stride(residual) if fused else 0
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s = torch.empty(x.shape, dtype=x.dtype, device=x.device) if fused else None
    rows = x.numel() // d if d else 0
    if rows == 0:
        return (y, s) if fused else y
    outs = (y, s) if fused else (y,)
    vec = (vector_path(x, scale, residual)
           and all(t.data_ptr() % 16 == 0 for t in outs))
    fn = _build.function("repro_rmsnorm", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), residual.data_ptr() if fused else None,
                 scale.data_ptr(), y.data_ptr(), s.data_ptr() if fused else None,
                 rows, d, stride, r_stride, float(eps),
                 _DTYPES[x.dtype], _DTYPES[scale.dtype], int(vec),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm: launch failed, cudaError_t {err}")
    rmsnorm.launches += 1
    if fused:
        rmsnorm.fused_launches += 1
        return y, s
    return y


rmsnorm.launches = 0          # every launch, fused or not
rmsnorm.fused_launches = 0    # launches with the residual add fused in
