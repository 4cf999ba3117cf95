"""Copy-on-write guarantees for forked template state (TIDAL §5.2
"Efficient overlapping with correctness ensuring", and §7.5 security).

A fork shares the template's resident device buffers with every other
invocation of the function.  PyTorch tensors are mutable: one in-place
write (``add_``, ``copy_``, an indexed assignment, a kernel writing
through ``data_ptr()``) into a shared buffer would corrupt every other
invocation.  That is the exact hazard TIDAL intercepts in CUDA, so the
guard here is a real check, not a formality:

  * ``DonationGuard.guard`` snapshots a checksum of every element of the
    template buffers (integer sums of their bit patterns, on their own
    device, so a write to any row shows);
  * ``check`` reports every buffer changed (or replaced) since;
  * ``copy_for_write`` is the explicit copy-on-write escape hatch for
    code that does need to mutate a forked weight.

The JAX package also has ``safe_jit``, which refuses buffer donation of
guarded arguments.  Eager PyTorch never donates an input buffer to an
output, so the port has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from repro_torch.utils import named_leaves


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_CHUNK = 1 << 24                     # elements per partial sum


def _checksum(t: torch.Tensor) -> tuple:
    """Shape, dtype and the int64 sums of the element bit patterns, one per
    chunk of ``_CHUNK`` elements (every element counts)."""
    bits = t.detach().reshape(-1).view(_BITS[t.element_size()])
    sums = [c.sum(dtype=torch.int64) for c in bits.split(_CHUNK)]
    return (tuple(t.shape), str(t.dtype),
            tuple(torch.stack(sums).tolist()) if sums else ())


@dataclasses.dataclass
class DonationGuard:
    """Tracks template-owned device buffers and detects writes to them."""
    checksums: dict
    ptrs: dict

    @classmethod
    def guard(cls, buffers: dict) -> "DonationGuard":
        return cls(checksums={k: _checksum(v) for k, v in buffers.items()},
                   ptrs={k: v.data_ptr() for k, v in buffers.items()})

    def check(self, buffers: dict) -> list:
        """Paths whose buffer changed content or storage (should be empty)."""
        return [k for k, v in buffers.items() if k in self.checksums and (
            self.ptrs[k] != v.data_ptr() or self.checksums[k] != _checksum(v))]


def guarded_paths(params, template_paths: Iterable[str]) -> dict:
    """``{path: tensor}`` of the leaves of ``params`` a template owns (the
    buffers a :class:`DonationGuard` should watch)."""
    tp = set(template_paths)
    return {path: leaf for path, leaf in named_leaves(params) if path in tp}


def copy_for_write(t: torch.Tensor) -> torch.Tensor:
    """Explicit copy-on-write: a private copy safe to mutate."""
    return t.clone()
