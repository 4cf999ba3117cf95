"""Chunked scalar-decay SSD scan (Mamba2 prefill and training): wrappers of
``csrc/ssd_scan.cu`` and, for the gradient, ``csrc/ssd_scan_bwd.cu``.

For tensors on a CUDA device the wrappers launch the hand-written kernels
or raise; for tensors on the CPU they run the plain versions in
``ref.py`` (``ssd_ref``: chunked where the chunk divides S, the exact
recurrence otherwise, as the JAX mixer branches; ``ssd_scan_bwd_ref``
for the gradient).  B and C may be strided views (the mixer hands in
column slices of its conv output); only their state axis must be
contiguous, so nothing is copied.  The kernels read the mixer's ``[B,
S, H, dh]`` layout, so nothing is transposed either.

When a gradient is needed the call goes through a
``torch.autograd.Function`` that keeps the forward's inputs: the backward
launches the backward kernel on the card (fp32 B and C; bf16 raises),
which recomputes the states it needs, and runs the plain backward on the
CPU.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, grad, meta, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ARGTYPES = ([_P] * 8                             # xb B C ld h0 scratch y h_out
             + [_I] * 6                           # B S H dh ds Q
             + [_L] * 4                           # B, C (batch, row) strides
             + [_I, _P])                          # dtype stream
_BWD_ARGTYPES = ([_P] * 13                        # xb B C ld h0 dy dh_final scratch
                 #   dxb dB dC dld dh0
                 + [_I] * 5                       # B S H dh ds
                 + [_L] * 4                       # B, C (batch, row) strides
                 + [_P])                          # stream
STATE_WIDTHS = (16, 32, 64, 128)
DH_MULTIPLE = 32
MAX_CHUNK = 128
BWD_CHUNK = 16          # rows per chunk of the backward (csrc/ssd_scan_bwd.cu)
MAX_BWD_WIDTH = 128     # dh and ds of the backward at most


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_scan: {msg}")


def scratch_floats(Bb: int, S: int, H: int, dh: int, ds: int, chunk: int) -> int:
    """fp32 scratch of one call: the state entering each chunk
    ``[B, K, H, dh, ds]``, then the chunks' cumulative log decays
    ``[B, H, K, chunk]`` (K = ceil(S / chunk))."""
    K = -(-S // chunk)
    return Bb * K * H * dh * ds + Bb * H * K * chunk


def bwd_scratch_floats(Bb: int, S: int, H: int, dh: int, ds: int) -> int:
    """fp32 scratch of one backward call (K = ceil(S / 16) of its own
    chunks): the chunks' cumulative log decays ``[B, H, K, 16]``, the state
    entering and the gradient at the state leaving each chunk ``[B, K, H,
    dh, ds]`` each, then each head's partial dB and dC ``[B, S, H, ds]``
    (summed over heads in a fixed order)."""
    K = -(-S // BWD_CHUNK)
    return Bb * H * K * BWD_CHUNK + 2 * Bb * K * H * dh * ds + 2 * Bb * S * H * ds


def _check(xb, B_mat, C_mat, log_decay, h0) -> None:
    Bb, S, H, dh = xb.shape
    ds = B_mat.shape[-1]
    _require(xb.device.type == "cuda", f"unsupported device {xb.device}")
    tensors = (xb, B_mat, C_mat, log_decay) + (() if h0 is None else (h0,))
    _require(all(t.device == xb.device for t in tensors),
             "all tensors must be on one device")
    _require(xb.dtype == torch.float32 and log_decay.dtype == torch.float32
             and (h0 is None or h0.dtype == torch.float32),
             f"xb, log_decay and h0 must be fp32 (xb={xb.dtype}, "
             f"log_decay={log_decay.dtype})")
    _require(B_mat.dtype in _DTYPES and C_mat.dtype == B_mat.dtype,
             f"B and C must share fp32 or bf16 (B={B_mat.dtype}, C={C_mat.dtype})")
    _require(B_mat.shape == C_mat.shape == (Bb, S, ds)
             and log_decay.shape == (Bb, S, H)
             and (h0 is None or h0.shape == (Bb, H, dh, ds)),
             f"shapes xb={tuple(xb.shape)} B={tuple(B_mat.shape)} "
             f"C={tuple(C_mat.shape)} ld={tuple(log_decay.shape)}")
    _require(ds in STATE_WIDTHS, f"state width {ds} (16, 32, 64 or 128)")
    _require(dh % DH_MULTIPLE == 0, f"head dim {dh} (a multiple of {DH_MULTIPLE})")
    _require(xb.is_contiguous() and log_decay.is_contiguous()
             and (h0 is None or h0.is_contiguous()),
             "xb, log_decay and h0 must be contiguous")
    _require(xb.data_ptr() % 16 == 0 and (h0 is None or h0.data_ptr() % 16 == 0),
             "xb and h0 must be 16-byte aligned")
    _require(B_mat.stride(-1) == 1 and C_mat.stride(-1) == 1,
             "the state axis of B and C must be contiguous")


def _launch(xb, B_mat, C_mat, log_decay, chunk: int, h0):
    """One forward call on the card: (y, h_final)."""
    _check(xb, B_mat, C_mat, log_decay, h0)
    _require(1 <= chunk <= MAX_CHUNK, f"chunk {chunk} (1 to {MAX_CHUNK})")
    Bb, S, H, dh = xb.shape
    ds = B_mat.shape[-1]
    y = torch.empty(xb.shape, dtype=torch.float32, device=xb.device)
    h = torch.empty((Bb, H, dh, ds), dtype=torch.float32, device=xb.device)
    scratch = torch.empty(scratch_floats(Bb, S, H, dh, ds, chunk),
                          dtype=torch.float32, device=xb.device)
    fn = _build.function("repro_ssd_scan", _ARGTYPES)
    strides = [t.stride(i) for t in (B_mat, C_mat) for i in (0, 1)]
    with torch.cuda.device(xb.device):
        err = fn(xb.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
                 log_decay.data_ptr(), None if h0 is None else h0.data_ptr(),
                 scratch.data_ptr(), y.data_ptr(), h.data_ptr(), Bb, S, H, dh, ds,
                 int(chunk),
                 *strides, _DTYPES[B_mat.dtype],
                 torch.cuda.current_stream(xb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: launch failed, cudaError_t {err}")
    ssd_scan.launches += 1
    return y, h


def _meta_call(xb, B_mat, C_mat, log_decay, h0):
    Bb, S, H, dh = xb.shape
    ds = B_mat.shape[-1]
    ins = (xb, B_mat, C_mat, log_decay) + (() if h0 is None else (h0,))
    return meta.kernel_call(
        "ssd_scan", ins,
        lambda: (torch.empty(xb.shape, dtype=torch.float32, device="meta"),
                 torch.empty((Bb, H, dh, ds), dtype=torch.float32,
                             device="meta")))


class _SsdScanFunction(torch.autograd.Function):
    """Forward: the ``ssd_scan`` kernel (the plain version on the CPU);
    backward: :func:`ssd_scan_bwd` from the forward's inputs."""

    @staticmethod
    def forward(ctx, xb, B_mat, C_mat, log_decay, chunk, h0):
        ctx.set_materialize_grads(False)
        if meta.is_meta(xb):
            y, h = _meta_call(xb, B_mat, C_mat, log_decay, h0)
        elif xb.device.type == "cpu":
            y, h = ref.ssd_ref(xb, B_mat, C_mat, log_decay, chunk, h0)
        else:
            y, h = _launch(xb, B_mat, C_mat, log_decay, chunk, h0)
        ctx.save_for_backward(xb, B_mat, C_mat, log_decay, h0)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_final):
        xb, B_mat, C_mat, log_decay, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xb)
        dxb, dB, dC, dld, dh0 = ssd_scan_bwd(xb, B_mat, C_mat, log_decay, dy,
                                             h0, dh_final)
        return dxb, dB, dC, dld, None, dh0


def ssd_scan(xb, B_mat, C_mat, log_decay, chunk: int = 128, h0=None):
    """The SSD recurrence ``h_t = exp(ld_t) h_{t-1} + x_t B_t^T``,
    ``y_t = h_t C_t``, computed chunk by chunk.

    Args:
      xb: [B, S, H, dh] fp32 dt-scaled inputs, contiguous (dh a multiple
        of 32 on the card).
      B_mat, C_mat: [B, S, ds] fp32 or bf16 (one dtype), state axis
        contiguous (ds 16, 32, 64 or 128 on the card).
      log_decay: [B, S, H] fp32 (negative), contiguous.
      chunk: rows per chunk (at most 128 on the card); S need not be a
        multiple of it.
      h0: optional initial state [B, H, dh, ds] fp32, contiguous.

    Returns:
      (y [B, S, H, dh], h_final [B, H, dh, ds]), both fp32 and contiguous.

    When a gradient is needed the outputs carry it
    (:class:`_SsdScanFunction`, the backward kernel on the card); off the
    CPU that takes fp32 B and C, and bf16 raises ``NotImplementedError``.
    """
    if grad.needs_grad(xb, B_mat, C_mat, log_decay, h0):
        if xb.device.type != "cpu" and B_mat.dtype != torch.float32:
            grad.refuse_bf16(
                "ssd_scan_bwd",
                f"ssd_scan: no backward kernel for {B_mat.dtype} B and C on "
                f"{xb.device.type} ({grad.BF16_BWD}); train in float32", xb)
        return _SsdScanFunction.apply(xb, B_mat, C_mat, log_decay, chunk, h0)
    if meta.is_meta(xb):
        return _meta_call(xb, B_mat, C_mat, log_decay, h0)
    if xb.device.type == "cpu":
        return ref.ssd_ref(xb, B_mat, C_mat, log_decay, chunk, h0)
    return _launch(xb, B_mat, C_mat, log_decay, chunk, h0)


ssd_scan.launches = 0


def ssd_scan_bwd(xb, B_mat, C_mat, log_decay, dy, h0=None, dh_final=None):
    """Gradients of :func:`ssd_scan` (fp32): ``(dxb, dB, dC, dlog_decay,
    dh0)``.  They do not depend on the forward's chunk: the card's kernel
    walks chunks of 16 rows of its own.

    Args:
      xb, B_mat, C_mat, log_decay, h0: the forward's inputs (its rules;
        on the card B and C fp32, dh and ds at most 128).
      dy: the gradient at ``y`` [B, S, H, dh]; dh_final: the gradient at
        ``h_final`` [B, H, dh, ds], or None (zeros).

    Returns:
      dxb [B, S, H, dh], dB and dC [B, S, ds] (sums over heads),
      dlog_decay [B, S, H], all fp32 and contiguous, and dh0 [B, H, dh,
      ds] (None without ``h0``).  On the card one call runs four launches
      (counted as one: the chunks' decays and state increments, the scans
      over chunks, the chunks' gradients, the sums over heads); on the
      CPU the plain version.
    """
    if meta.is_meta(xb):
        Bb, S, H, dh = xb.shape
        ds = B_mat.shape[-1]

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device="meta")

        return meta.kernel_call(
            "ssd_scan_bwd", (xb, B_mat, C_mat, log_decay, dy),
            lambda: (empty(Bb, S, H, dh), empty(Bb, S, ds), empty(Bb, S, ds),
                     empty(Bb, S, H), None if h0 is None else empty(Bb, H, dh, ds)))
    if xb.device.type == "cpu":
        return ref.ssd_scan_bwd_ref(xb, B_mat, C_mat, log_decay, dy, h0, dh_final)
    _check(xb, B_mat, C_mat, log_decay, h0)
    if B_mat.dtype != torch.float32:
        raise NotImplementedError(
            f"ssd_scan_bwd: {B_mat.dtype} B and C: float32 only ({grad.BF16_BWD})")
    Bb, S, H, dh = xb.shape
    ds = B_mat.shape[-1]
    _require(dh <= MAX_BWD_WIDTH, f"head dim {dh} (at most {MAX_BWD_WIDTH})")
    _require(dy.shape == xb.shape and dy.dtype == torch.float32,
             "dy must be fp32 of xb's shape")
    _require(dh_final is None or (dh_final.shape == (Bb, H, dh, ds)
                                  and dh_final.dtype == torch.float32),
             "dh_final must be fp32 [B, H, dh, ds]")
    dy = dy.contiguous()
    dh_final = None if dh_final is None else dh_final.contiguous()
    _require(dy.device == xb.device
             and (dh_final is None or dh_final.device == xb.device),
             "all tensors must be on one device")
    f32 = dict(dtype=torch.float32, device=xb.device)
    dxb = torch.empty(xb.shape, **f32)
    dB = torch.empty((Bb, S, ds), **f32)
    dC = torch.empty((Bb, S, ds), **f32)
    dld = torch.empty((Bb, S, H), **f32)
    dh0 = None if h0 is None else torch.empty((Bb, H, dh, ds), **f32)
    scratch = torch.empty(bwd_scratch_floats(Bb, S, H, dh, ds), **f32)
    fn = _build.function("repro_ssd_scan_bwd", _BWD_ARGTYPES)
    strides = [t.stride(i) for t in (B_mat, C_mat) for i in (0, 1)]

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(xb.device):
        err = fn(xb.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
                 log_decay.data_ptr(), ptr(h0), dy.data_ptr(), ptr(dh_final),
                 scratch.data_ptr(), dxb.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                 dld.data_ptr(), ptr(dh0), Bb, S, H, dh, ds, *strides,
                 torch.cuda.current_stream(xb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd: launch failed, cudaError_t {err}")
    ssd_scan_bwd.launches += 1
    return dxb, dB, dC, dld, dh0


ssd_scan_bwd.launches = 0
