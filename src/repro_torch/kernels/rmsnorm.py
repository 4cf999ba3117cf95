"""Row RMSNorm: wrapper of ``csrc/rmsnorm.cu``.

For tensors on a CUDA device the wrapper launches the hand-written kernel
or raises; for tensors on the CPU it runs the plain version in ``ref.py``.
x may be a strided view whose last axis is contiguous and whose leading
axes collapse to one row stride (``x[:, -1:]`` of a contiguous
``[B, S, D]`` does), so no copy is made; the output is contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, meta, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 3                # x scale y
             + [ctypes.c_int64, ctypes.c_int,     # rows d
                ctypes.c_int64, ctypes.c_float]   # row stride, eps
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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm over the last axis with fp32 statistics.

    Args:
      x: [..., d] fp32 or bf16, last axis contiguous, leading axes
        collapsing to one row stride.
      scale: [d] fp32 or bf16, contiguous (promoted to fp32).
      eps: added to the mean of squares before the rsqrt.

    Returns:
      ``x * rsqrt(mean(x**2) + eps) * scale`` in ``x.dtype``, contiguous.
    """
    if meta.is_meta(x):
        return meta.kernel_call("rmsnorm", (x, scale),
                                lambda: torch.empty(x.shape, dtype=x.dtype,
                                                    device=x.device))
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(scale.device == x.device, "x and scale must be on one device")
    _require(x.dtype in _DTYPES and scale.dtype in _DTYPES,
             f"dtypes x={x.dtype} scale={scale.dtype}")
    d = x.shape[-1]
    _require(scale.shape == (d,) and scale.is_contiguous(),
             f"scale of shape {tuple(scale.shape)} for rows of {d}")
    stride = row_stride(x)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    per = 16 // x.element_size()          # elements of one 16-byte access
    vec = (d % per == 0 and stride % per == 0 and x.data_ptr() % 16 == 0
           and y.data_ptr() % 16 == 0)
    fn = _build.function("repro_rmsnorm", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, stride,
                 float(eps), _DTYPES[x.dtype], _DTYPES[scale.dtype], int(vec),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm: launch failed, cudaError_t {err}")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
