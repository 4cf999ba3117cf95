"""Kernel entry points the model layers call, and the launch counts.

Each entry point dispatches on where its tensors live: a CUDA tensor runs
the hand-written kernel (``csrc/``), a CPU tensor its plain PyTorch
version (``ref.py``), a ``meta`` tensor (tracing) an empty output of the
right shape (``meta.py``).  ``flash_attention``, ``rmsnorm``,
``rmsnorm_split`` and ``ssd_scan`` carry a gradient when one is needed:
their backward kernels count under ``flash_attention_bwd``,
``rmsnorm_bwd``, ``rmsnorm_split_bwd`` and ``ssd_scan_bwd``.
``launch_counts`` reads how often each kernel was launched, so a run can
show that its main path went through the kernels.

Under a sharding plan (``distributed.sharding.use_plan``) each rank calls
the same kernels on its own heads, as the JAX package's ``shard_map``
wrappers run the kernel per 'model' shard; the attention entry points
check that the query and KV heads they see are the rank's.  Over a
sequence-sharded cache (a plan's ``prefer_seq``) every rank runs
``decode_attention_slice`` on all heads over its rows and
``decode_merge_ranks`` on the ranks' gathered results.
"""

from __future__ import annotations

import functools

from repro_torch.distributed import sharding
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.decode_attention import (decode_attention_slice,
                                                  decode_merge_ranks)
from repro_torch.kernels.flash_attention import (flash_attention as _flash,
                                                 flash_attention_bwd)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention as _paged)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd, rmsnorm_split,
                                         rmsnorm_split_bwd)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd


def _rank_heads(kernel, kv_axis: int):
    """``kernel`` checking, under a plan, that q's heads (axis 1) and the
    cache's KV heads (``kv_axis`` of k) are the rank's local counts."""
    def call(q, k, *args, **kwargs):
        want = sharding.local_heads()
        if want is not None and (q.shape[1], k.shape[kv_axis]) != want:
            raise ValueError(
                f"{kernel.__name__}: {q.shape[1]} query / {k.shape[kv_axis]} "
                f"KV heads, but this rank holds {want[0]} / {want[1]}")
        return kernel(q, k, *args, **kwargs)
    return functools.update_wrapper(call, kernel, updated=())


flash_attention = _rank_heads(_flash, 1)           # q [B,H,S,d], k [B,KV,T,d]
decode_attention = _rank_heads(_decode, 1)         # q [B,H,d], k [B,KV,T,d]
paged_decode_attention = _rank_heads(_paged, 2)    # k [P,ps,KV,d]

KERNELS = {
    "decode_attention": _decode,
    "decode_attention_slice": decode_attention_slice,
    "decode_merge_ranks": decode_merge_ranks,
    "flash_attention": _flash,
    "flash_attention_bwd": flash_attention_bwd,
    "paged_decode_attention": _paged,
    "rmsnorm": rmsnorm,
    "rmsnorm_bwd": rmsnorm_bwd,
    "rmsnorm_split": rmsnorm_split,
    "rmsnorm_split_bwd": rmsnorm_split_bwd,
    "ssd_scan": ssd_scan,
    "ssd_scan_bwd": ssd_scan_bwd,
}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name, and under
    ``rmsnorm_fused`` the rmsnorm launches with the residual add fused in
    (counted under ``rmsnorm`` too).  ``rmsnorm_split`` counts both
    launches of the split-row form (two per norm), ``rmsnorm_split_bwd``
    both of its backward."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["rmsnorm_fused"] = rmsnorm.fused_launches
    return counts


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    rmsnorm.fused_launches = 0


__all__ = ["KERNELS", "decode_attention", "decode_attention_slice",
           "decode_merge_ranks", "flash_attention",
           "flash_attention_bwd", "launch_counts", "paged_decode_attention",
           "reset_launch_counts", "rmsnorm", "rmsnorm_bwd", "rmsnorm_split",
           "rmsnorm_split_bwd", "ssd_scan", "ssd_scan_bwd"]
