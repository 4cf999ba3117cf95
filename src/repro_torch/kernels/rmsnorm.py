"""Row RMSNorm, optionally with the residual add fused in: wrappers of
``csrc/rmsnorm.cu`` and, for the gradient, ``csrc/rmsnorm_bwd.cu``.
:func:`rmsnorm_split` is the split-row form of the same sources, for a
row that tensor parallelism cuts over ranks: two launches around the
caller's sum over the ranks, forward and backward (the sources' header
notes).

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
_SUMSQ_ARGTYPES = ([ctypes.c_void_p] * 2        # x sums
                   + [ctypes.c_int64, ctypes.c_int,  # rows d
                      ctypes.c_int64,                # x row stride
                      ctypes.c_int, ctypes.c_int,    # x dtype, vec
                      ctypes.c_void_p])              # stream
_APPLY_ARGTYPES = ([ctypes.c_void_p] * 4        # x sums scale y
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # rows d d_global
                      ctypes.c_int64, ctypes.c_float,  # x row stride, eps
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtypes, vec
                      ctypes.c_void_p, ctypes.c_void_p])  # rstd stream
_SPLIT_DOT_ARGTYPES = ([ctypes.c_void_p] * 4    # x scale dy dots
                       + [ctypes.c_int64, ctypes.c_int,  # rows d
                          ctypes.c_int64,                # x row stride
                          ctypes.c_void_p])              # stream
_SPLIT_BWD_ARGTYPES = ([ctypes.c_void_p] * 8    # x scale dy dots rstd dx dscale partial
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # rows d d_global
                          ctypes.c_int64,                # x row stride
                          ctypes.c_void_p])              # stream
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
            grad.refuse_bf16(
                "rmsnorm_bwd",
                f"rmsnorm: no {x.dtype} backward kernel on {x.device.type} "
                f"({grad.BF16_BWD}); train in float32", x)
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
    dy = dy.contiguous()
    rows, d, stride = _bwd_check("rmsnorm_bwd", x, scale, dy)
    _require(d_sum is None or (d_sum.shape == x.shape
                               and d_sum.dtype == torch.float32
                               and d_sum.device == x.device),
             "d_sum must be fp32 of x's shape, on x's device")
    _require(rstd is not None and rstd.dtype == torch.float32
             and rstd.numel() == rows and rstd.is_contiguous()
             and rstd.device == x.device,
             "rstd: the forward's fp32 rstd, one per row, contiguous")
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


def rmsnorm_sumsq(x: torch.Tensor) -> torch.Tensor:
    """The split-row form's first launch: each row's fp32 sum of squares,
    x's leading shape.  x: [..., d] fp32 or bf16 (the row-stride rules of
    :func:`rmsnorm`); on the CPU the plain version."""
    lead = tuple(x.shape[:-1])
    if meta.is_meta(x):
        return meta.kernel_call("rmsnorm_split", (x,), lambda: torch.empty(
            lead, dtype=torch.float32, device=x.device))
    if x.numel() == 0:
        # a rank that holds none of the row (a head split unevenly) adds
        # nothing to the ranks' sums; on every device, with no launch
        return torch.zeros(lead, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return ref.rmsnorm_sumsq_ref(x)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(x.dtype in _DTYPES, f"dtype x={x.dtype}")
    d = x.shape[-1]
    stride = row_stride(x)
    sums = torch.empty(lead, dtype=torch.float32, device=x.device)
    rows = x.numel() // d
    per = 16 // x.element_size()
    vec = d % per == 0 and stride % per == 0 and x.data_ptr() % 16 == 0
    fn = _build.function("repro_rmsnorm_sumsq", _SUMSQ_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), sums.data_ptr(), rows, d, stride,
                 _DTYPES[x.dtype], int(vec),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_sumsq: launch failed, cudaError_t {err}")
    rmsnorm_split.launches += 1
    return sums


def rmsnorm_apply(x: torch.Tensor, sums: torch.Tensor, scale: torch.Tensor,
                  d_global: int, eps: float = 1e-6,
                  rstd: torch.Tensor | None = None) -> torch.Tensor:
    """The split-row form's second launch: ``x * rsqrt(sums / d_global +
    eps) * scale`` over the slice ``x`` [..., d], with ``sums`` the whole
    row's fp32 sum of squares (x's leading shape, contiguous) and
    ``scale`` [d] the slice's scale; x's dtype, contiguous.  ``rstd``
    (fp32, one per row, contiguous) receives each row's rsqrt when given.
    On the CPU the plain version."""
    if meta.is_meta(x):
        return meta.kernel_call("rmsnorm_split", (x, sums, scale), lambda: torch.empty(
            x.shape, dtype=x.dtype, device=x.device))
    if x.device.type == "cpu":
        if rstd is not None:
            rstd.copy_(torch.rsqrt(sums.float() / d_global + eps))
        return ref.rmsnorm_apply_ref(x, sums, scale, d_global, eps)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(scale.device == x.device and sums.device == x.device,
             "x, sums and scale must be on one device")
    _require(x.dtype in _DTYPES and scale.dtype in _DTYPES,
             f"dtypes x={x.dtype} scale={scale.dtype}")
    d = x.shape[-1]
    _require(scale.shape == (d,) and scale.is_contiguous(),
             f"scale of shape {tuple(scale.shape)} for rows of {d}")
    _require(sums.dtype == torch.float32 and sums.is_contiguous()
             and tuple(sums.shape) == tuple(x.shape[:-1]),
             f"sums {tuple(sums.shape)} {sums.dtype} for x {tuple(x.shape)}")
    _require(rstd is None or (rstd.dtype == torch.float32 and rstd.is_contiguous()
                              and rstd.shape == sums.shape
                              and rstd.device == x.device),
             "rstd must be fp32 of the sums' shape, contiguous")
    _require(d_global >= d, f"d_global {d_global} below the slice's {d}")
    stride = row_stride(x)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    vec = vector_path(x, scale) and y.data_ptr() % 16 == 0
    fn = _build.function("repro_rmsnorm_apply", _APPLY_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), sums.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 rows, d, int(d_global), stride, float(eps),
                 _DTYPES[x.dtype], _DTYPES[scale.dtype], int(vec),
                 None if rstd is None else rstd.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_apply: launch failed, cudaError_t {err}")
    rmsnorm_split.launches += 1
    return y


def _bwd_check(name: str, x, scale, dy) -> tuple:
    """(rows, d, row stride) of a backward launch's inputs (fp32, one
    device, dy contiguous of x's shape), for :func:`rmsnorm_bwd` and the
    split-row backward."""
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    if not (x.dtype == scale.dtype == dy.dtype == torch.float32):
        raise NotImplementedError(
            f"{name}: x {x.dtype}, scale {scale.dtype}, dy {dy.dtype}: "
            f"float32 only ({grad.BF16_BWD})")
    d = x.shape[-1]
    _require(scale.shape == (d,) and scale.is_contiguous(),
             f"scale of shape {tuple(scale.shape)} for rows of {d}")
    _require(dy.shape == x.shape and dy.is_contiguous(),
             f"dy {tuple(dy.shape)} for x {tuple(x.shape)}, contiguous")
    _require(scale.device == x.device == dy.device,
             "x, scale and dy must be on one device")
    return x.numel() // d if d else 0, d, row_stride(x)


def rmsnorm_split_dot(x: torch.Tensor, scale: torch.Tensor,
                      dy: torch.Tensor) -> torch.Tensor:
    """The split-row backward's first launch: each row's fp32 dot of
    ``scale * dy`` and ``x`` over the rank's slice, x's leading shape
    (counted under ``rmsnorm_split_bwd``).  On the CPU the plain
    version."""
    lead = tuple(x.shape[:-1])
    if meta.is_meta(x):
        return meta.kernel_call("rmsnorm_split_bwd", (x, scale, dy), lambda: torch.empty(
            lead, dtype=torch.float32, device=x.device))
    if x.numel() == 0:
        # a rank that holds none of the row adds nothing to the ranks'
        # dots (as :func:`rmsnorm_sumsq`)
        return torch.zeros(lead, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return ref.rmsnorm_split_dot_ref(x, scale, dy)
    dy = dy.contiguous()
    rows, d, stride = _bwd_check("rmsnorm_split backward", x, scale, dy)
    dots = torch.empty(lead, dtype=torch.float32, device=x.device)
    fn = _build.function("repro_rmsnorm_bwd_split_dot", _SPLIT_DOT_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dots.data_ptr(),
                 rows, d, stride, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_split_dot: launch failed, cudaError_t {err}")
    rmsnorm_split_bwd.launches += 1
    return dots


def rmsnorm_split_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                      dots: torch.Tensor, rstd: torch.Tensor,
                      d_global: int) -> tuple:
    """The split-row backward's second launch: the slice's ``(dx,
    dscale)`` (fp32) from ``dots`` (the ranks' total of
    :func:`rmsnorm_split_dot`, contiguous) and ``rstd`` (the forward's,
    from the reduced sums; fp32, contiguous), over rows of ``d_global``.
    On the card one call runs the dx launch and dscale's two passes
    (counted as one); on the CPU the plain version."""
    if meta.is_meta(x):
        return meta.kernel_call(
            "rmsnorm_split_bwd", (x, scale, dy, dots, rstd),
            lambda: (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                     torch.empty(scale.shape, dtype=scale.dtype,
                                 device=scale.device)))
    if x.numel() == 0:
        # no element of the row on this rank: no gradient to write
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                torch.zeros(scale.shape, dtype=scale.dtype, device=x.device))
    if x.device.type == "cpu":
        return ref.rmsnorm_split_bwd_ref(x, scale, dy, dots, rstd, d_global)
    dy = dy.contiguous()
    rows, d, stride = _bwd_check("rmsnorm_split backward", x, scale, dy)
    _require(all(t.dtype == torch.float32 and t.is_contiguous() and t.numel() == rows
                 and t.device == x.device for t in (dots, rstd)),
             "dots and rstd: fp32, one per row, contiguous")
    _require(d_global >= d, f"d_global {d_global} below the slice's {d}")
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    partial = torch.empty((-(-rows // BWD_CHUNK_ROWS), d), dtype=torch.float32,
                          device=x.device)
    fn = _build.function("repro_rmsnorm_bwd_split", _SPLIT_BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dots.data_ptr(),
                 rstd.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                 partial.data_ptr(), rows, d, int(d_global), stride,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_split_bwd: launch failed, cudaError_t {err}")
    rmsnorm_split_bwd.launches += 1
    return dx, dscale


rmsnorm_split_bwd.launches = 0   # the split-row backward's launches (two per norm)


class _SplitFunction(torch.autograd.Function):
    """Forward: the split-row form's two launches around ``reduce`` (the
    second also writing each row's rstd); backward: each row's dot, the
    same ``reduce`` over the ranks, then the slice's dx and dscale.
    ``reduce`` is bound to the plan at the forward: the backward runs
    outside the plan's scope (on the card in autograd's own thread)."""

    @staticmethod
    def forward(ctx, x, scale, eps, d_global, reduce):
        sums = reduce(rmsnorm_sumsq(x))
        rstd = torch.empty(sums.shape, dtype=torch.float32, device=x.device)
        y = rmsnorm_apply(x, sums, scale, d_global, eps, rstd=rstd)
        ctx.save_for_backward(x, scale, rstd)
        ctx.d_global, ctx.reduce = d_global, reduce
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dots = ctx.reduce(rmsnorm_split_dot(x, scale, dy))
        dx, dscale = rmsnorm_split_bwd(x, scale, dy, dots, rstd, ctx.d_global)
        return dx, dscale, None, None, None


def rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, eps: float,
                  d_global: int, reduce) -> torch.Tensor:
    """RMSNorm of rows that ranks hold in slices: ``x`` [..., d] is this
    rank's slice of rows of ``d_global``, ``scale`` [d] its slice of the
    scale, and ``reduce`` sums a fp32 ``[rows]`` buffer over the ranks
    (bound to the plan: ``distributed.sharding.rank_sum``).  Two launches
    on the card (:func:`rmsnorm_sumsq`, :func:`rmsnorm_apply`), each
    counted under ``rmsnorm_split``; the plain versions on the CPU.  When
    a gradient is needed the output carries it (:class:`_SplitFunction`:
    two more launches, counted under ``rmsnorm_split_bwd``, around a
    second ``reduce``); off the CPU that takes fp32, and bf16 raises
    ``NotImplementedError``."""
    if grad.needs_grad(x, scale):
        if x.device.type != "cpu" and not (x.dtype == scale.dtype == torch.float32):
            grad.refuse_bf16(
                "rmsnorm_split_bwd",
                f"rmsnorm_split: no {x.dtype} backward kernel on "
                f"{x.device.type} ({grad.BF16_BWD}); train in float32", x)
        return _SplitFunction.apply(x, scale, eps, d_global, reduce)
    return rmsnorm_apply(x, reduce(rmsnorm_sumsq(x)), scale, d_global, eps)


rmsnorm_split.launches = 0    # the split-row form's launches (two per norm)
