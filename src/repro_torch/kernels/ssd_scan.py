"""Chunked scalar-decay SSD scan (Mamba2 prefill): wrapper of ``csrc/ssd_scan.cu``.

For tensors on a CUDA device the wrapper launches the hand-written kernel
or raises; for tensors on the CPU it runs the plain version in ``ref.py``
(``ssd_ref``: chunked where the chunk divides S, the exact recurrence
otherwise, as the JAX mixer branches).  B and C may be strided views (the
mixer hands in column slices of its conv output); only their state axis
must be contiguous, so nothing is copied.  The kernel reads the mixer's
``[B, S, H, dh]`` layout, so nothing is transposed either.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, meta, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ARGTYPES = ([_P] * 8                             # xb B C ld h0 scratch y h_out
             + [_I] * 6                           # B S H dh ds Q
             + [_L] * 4                           # B, C (batch, row) strides
             + [_I, _P])                          # dtype stream
STATE_WIDTHS = (16, 32, 64, 128)
DH_MULTIPLE = 32
MAX_CHUNK = 128


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_scan: {msg}")


def scratch_floats(Bb: int, S: int, H: int, dh: int, ds: int, chunk: int) -> int:
    """fp32 scratch of one call: the state entering each chunk
    ``[B, K, H, dh, ds]``, then the chunks' cumulative log decays
    ``[B, H, K, chunk]`` (K = ceil(S / chunk))."""
    K = -(-S // chunk)
    return Bb * K * H * dh * ds + Bb * H * K * chunk


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
    """
    Bb, S, H, dh = xb.shape
    ds = B_mat.shape[-1]
    if meta.is_meta(xb):
        ins = (xb, B_mat, C_mat, log_decay) + (() if h0 is None else (h0,))
        return meta.kernel_call(
            "ssd_scan", ins,
            lambda: (torch.empty(xb.shape, dtype=torch.float32, device="meta"),
                     torch.empty((Bb, H, dh, ds), dtype=torch.float32,
                                 device="meta")))
    if xb.device.type == "cpu":
        return ref.ssd_ref(xb, B_mat, C_mat, log_decay, chunk, h0)
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
    _require(1 <= chunk <= MAX_CHUNK, f"chunk {chunk} (1 to {MAX_CHUNK})")
    _require(xb.is_contiguous() and log_decay.is_contiguous()
             and (h0 is None or h0.is_contiguous()),
             "xb, log_decay and h0 must be contiguous")
    _require(xb.data_ptr() % 16 == 0 and (h0 is None or h0.data_ptr() % 16 == 0),
             "xb and h0 must be 16-byte aligned")
    _require(B_mat.stride(-1) == 1 and C_mat.stride(-1) == 1,
             "the state axis of B and C must be contiguous")
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


ssd_scan.launches = 0
