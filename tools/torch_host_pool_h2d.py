#!/usr/bin/env python3
"""Host-to-device copy rates from PyTorch's pinned allocator and from a
registered host-pool buffer, the pool's pages written before they are
page-locked (as ``pack_host_pool`` fills a pool) or never touched.

    python3 tools/torch_host_pool_h2d.py [--trials N] [--reps N]

Per trial a fresh 256 MiB block of each kind; the two are copied in
turn, one copy each per round, on a side stream (``chip_smoke.py``'s
``measure_h2d``), best of ``--reps`` rounds.  Trials alternate between a
written and an untouched pool buffer.  Prints one JSON line per trial
(GB/s) and a last one with the card's name and power limit.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_host_pool_h2d.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core.merging import HOST_ALIGN, HostBuffer
    n = 256 << 20
    rows = []
    for trial in range(args.trials):
        written = trial % 2 == 0
        alloc = torch.empty(n, dtype=torch.uint8).pin_memory()
        hb = HostBuffer(n + HOST_ALIGN)
        if written:
            hb.buf.fill_(1)
        hb.pin()
        view = hb.view(HOST_ALIGN, (n,), torch.uint8)
        a, p = chip_smoke.measure_h2d((alloc, view), reps=args.reps)
        rows.append({"trial": trial, "pool_written_before_pin": written,
                     "allocator_gb_per_s": a / 1e9, "pool_gb_per_s": p / 1e9,
                     "pool_share": p / a})
        print(json.dumps(rows[-1]))
        hb.release()
        del hb, view, alloc
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip(),
                      "pool_share_written": [r["pool_share"] for r in rows
                                             if r["pool_written_before_pin"]],
                      "pool_share_untouched": [r["pool_share"] for r in rows
                                               if not r["pool_written_before_pin"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
