"""Row RMSNorm, optionally with the residual add fused in: wrappers of
``csrc/rmsnorm.cu`` and, for the gradient, ``csrc/rmsnorm_bwd.cu``.

For tensors on a CUDA device the wrappers launch the hand-written kernels
or raise; for tensors on the CPU they run the plain versions in
``ref.py``.  When a gradient is needed (grad mode on and an input that
requires grad) the call goes through a ``torch.autograd.Function``: the
forward also writes each row's rstd, and the backward launches the
backward kernel (fp32 only; another dtype raises).
x (and a residual) may be strided views whose last axis is contiguous and
whose leading axes collapse to one row stride (``x[:, -1:]`` of a
contiguous ``[B, S, D]`` does), so no copy is made; the outputs are
contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, grad, meta, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5                # x res scale y s
             + [ctypes.c_int64, ctypes.c_int,     # rows d
                ctypes.c_int64, ctypes.c_int64,   # x and res row strides
                ctypes.c_float]                   # eps
             + [ctypes.c_int] * 3                 # x dtype, scale dtype, vec
             + [ctypes.c_void_p] * 2)             # rstd stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 8            # x scale dy d_sum rstd dx dscale partial
                 + [ctypes.c_int64, ctypes.c_int,  # rows d
                    ctypes.c_int64,                # x row stride
                    ctypes.c_void_p])              # stream
BWD_CHUNK_ROWS = 64      # rows per partial sum of dscale (csrc/rmsnorm_bwd.cu)


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


def _check_residual(x, residual) -> None:
    _require(residual.device == x.device,
             f"residual on {residual.device}, x on {x.device}")
    _require(residual.shape == x.shape and residual.dtype == x.dtype,
             f"residual {tuple(residual.shape)} {residual.dtype} for x "
             f"{tuple(x.shape)} {x.dtype}")


def _meta_call(x, scale, residual):
    fused = residual is not None
    ins = (x, scale) + ((residual,) if fused else ())

    def empty():
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)

    return meta.kernel_call("rmsnorm", ins,
                            (lambda: (empty(), empty())) if fused else empty)


def _launch(x, scale, eps: float, residual=None, rstd=None):
    """One forward launch: ``y`` or ``(y, s)``; ``rstd`` (fp32, one per
    row, contiguous) receives each row's rsqrt(mean + eps) when given."""
    fused = residual is not None
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
                 None if rstd is None else rstd.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm: launch failed, cudaError_t {err}")
    rmsnorm.launches += 1
    if fused:
        rmsnorm.fused_launches += 1
        return y, s
    return y


def rmsnorm_fwd(x, scale, eps: float = 1e-6, residual=None) -> tuple:
    """The training forward: ``(y, s, rstd)`` with ``s`` the sum ``x +
    residual`` (None without a residual) and ``rstd`` [x's leading
    shape] fp32 each row's rsqrt(mean(s^2) + eps).  On the card one
    launch of the forward kernel, on the CPU the plain versions."""
    if meta.is_meta(x):
        out = _meta_call(x, scale, residual)
        y, s = out if residual is not None else (out, None)
        return y, s, torch.empty(x.shape[:-1], dtype=torch.float32,
                                 device=x.device)
    if x.device.type == "cpu":
        s = None if residual is None else x + residual
        norm_in = x if s is None else s
        return (ref.rmsnorm_ref(norm_in, scale, eps), s,
                ref.rmsnorm_rstd_ref(norm_in, eps))
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    out = _launch(x, scale, eps, residual, rstd)
    y, s = out if residual is not None else (out, None)
    return y, s, rstd


class _RmsnormFunction(torch.autograd.Function):
    """Forward: :func:`rmsnorm_fwd`; backward: :func:`rmsnorm_bwd` over the
    normalised input (x, or the sum s of the residual form), which gives
    the gradient of x and, in the residual form, of the residual."""

    @staticmethod
    def forward(ctx, x, scale, eps, residual):
        y, s, rstd = rmsnorm_fwd(x, scale, eps, residual)
        ctx.save_for_backward(x if s is None else s, scale, rstd)
        ctx.eps, ctx.fused = eps, s is not None
        return (y, s) if ctx.fused else y

    @staticmethod
    def backward(ctx, dy, d_sum=None):
        norm_in, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(norm_in, scale, dy, ctx.eps, d_sum, rstd)
        return dx, dscale, None, (dx if ctx.fused else None)


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
      residual, scale, eps)`` bit for bit.  When a gradient is needed the
      outputs carry it (:class:`_RmsnormFunction`); off the CPU that takes
      fp32 x and scale, and another dtype raises ``NotImplementedError``.
    """
    fused = residual is not None
    if fused:
        _check_residual(x, residual)
    if grad.needs_grad(x, scale, residual):
        if x.device.type != "cpu" and not (x.dtype == scale.dtype == torch.float32):
            raise NotImplementedError(
                f"rmsnorm: no {x.dtype} backward kernel on {x.device.type} "
                f"({grad.BF16_BWD}); train in float32")
        return _RmsnormFunction.apply(x, scale, eps, residual)
    if meta.is_meta(x):
        return _meta_call(x, scale, residual)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps, residual=residual)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    return _launch(x, scale, eps, residual)


rmsnorm.launches = 0          # every launch, fused or not
rmsnorm.fused_launches = 0    # launches with the residual add fused in


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6, d_sum=None, rstd=None) -> tuple:
    """Gradients of :func:`rmsnorm` (fp32): ``(dx, dscale)``.

    Args:
      x: the normalised input [..., d] (the residual form's sum ``s``),
        the forward's row-stride rules; scale: [d]; dy: the gradient at
        ``y``; d_sum: the gradient at the residual form's ``s`` (added to
        dx), or None; rstd: the forward's per-row rstd (fp32, x's leading
        shape; the card needs it, the CPU recomputes it).

    Returns:
      dx (contiguous, x's shape) and dscale [d], fp32.  On the card one
      call runs the dx launch and, for dscale, per-64-row partial sums
      then their sum in a fixed order (no atomics; counted as one); on
      the CPU the plain version.
    """
    if meta.is_meta(x):
        return meta.kernel_call(
            "rmsnorm_bwd", (x, scale, dy),
            lambda: (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                     torch.empty(scale.shape, dtype=scale.dtype,
                                 device=scale.device)))
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd_ref(x, scale, dy, eps, d_sum)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    if not (x.dtype == scale.dtype == dy.dtype == torch.float32):
        raise NotImplementedError(
            f"rmsnorm_bwd: x {x.dtype}, scale {scale.dtype}, dy {dy.dtype}: "
            f"float32 only ({grad.BF16_BWD})")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    _require(scale.shape == (d,) and scale.is_contiguous(),
             f"scale of shape {tuple(scale.shape)} for rows of {d}")
    _require(dy.shape == x.shape, f"dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    _require(d_sum is None or (d_sum.shape == x.shape
                               and d_sum.dtype == torch.float32),
             "d_sum must be fp32 of x's shape")
    _require(rstd is not None and rstd.dtype == torch.float32
             and rstd.numel() == rows and rstd.is_contiguous(),
             "rstd: the forward's fp32 rstd, one per row, contiguous")
    tensors = (scale, dy, rstd) + (() if d_sum is None else (d_sum,))
    _require(all(t.device == x.device for t in tensors),
             "all tensors must be on one device")
    stride = row_stride(x)
    dy = dy.contiguous()
    d_sum = None if d_sum is None else d_sum.contiguous()
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dscale.zero_()
    partial = torch.empty((-(-rows // BWD_CHUNK_ROWS), d), dtype=torch.float32,
                          device=x.device)
    fn = _build.function("repro_rmsnorm_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                 None if d_sum is None else d_sum.data_ptr(), rstd.data_ptr(),
                 dx.data_ptr(), dscale.data_ptr(), partial.data_ptr(),
                 rows, d, stride,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd: launch failed, cudaError_t {err}")
    rmsnorm_bwd.launches += 1
    return dx, dscale


rmsnorm_bwd.launches = 0
