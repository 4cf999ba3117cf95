"""Markdown tables from the dry run's artifacts (the port's counterpart
of ``repro.launch.report``).

    python -m repro_torch.launch.report [16x16 | 2x16x16]
    python -m repro_torch.launch.report --inject FILE

``roofline_md`` lists each cell's roofline terms (``H100_SXM`` data-sheet
rates: bounds, not measurements), ``memory_md`` its bytes per device and
whether they fit the H100's 80 GB.  A cell the port refused shows its
message in place of numbers.  ``--inject`` fills the ``<!--
TORCH_ROOFLINE_TABLE -->``, ``<!-- TORCH_MULTIPOD_TABLE -->`` and ``<!--
TORCH_MEMORY_TABLE -->`` markers of a Markdown file.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.hw import H100_SXM

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                   "dryrun_torch")
ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
HBM_BYTES = 80e9                     # one H100's memory (data sheet)


def load_artifacts(mesh_tag: str, base: str = None) -> list:
    rows = []
    for p in sorted(glob.glob(os.path.join(base or ART, f"*__{mesh_tag}.json"))):
        with open(p) as f:
            rows.append(json.load(f))
    rows.sort(key=lambda a: (ORDER[a["meta"]["shape"]], a["meta"]["arch"]))
    return rows


def _refused(a: dict, width: int) -> str:
    m = a["meta"]
    return (f"| {m['arch']} | {m['shape']} | refused: {a['refused']} |"
            + " |" * (width - 3))


def roofline_md(mesh_tag: str = "16x16", base: str = None) -> str:
    lines = [
        f"| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
        f"dominant | 6ND/flops | roofline frac | state GiB/dev | "
        f"trace (s) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for a in load_artifacts(mesh_tag, base):
        if "refused" in a:
            lines.append(_refused(a, 10))
            continue
        m, r = a["meta"], a["roofline"]
        lines.append(
            f"| {m['arch']} | {m['shape']} | {r['compute_s']*1e3:.2f} | "
            f"{r['memory_s']*1e3:.2f} | {r['collective_s']*1e3:.2f} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | "
            f"{a['memory']['analytic_state_bytes_per_device']/2**30:.2f} | "
            f"{a['timing']['trace_s']:.1f} |")
    return "\n".join(lines)


def memory_md(mesh_tag: str = "16x16", base: str = None) -> str:
    lines = [
        "| arch | shape | args GiB/dev | peak above args GiB/dev | "
        f"state GiB/dev (specs) | fits {H100_SXM.name} 80 GB? |",
        "|---|---|---|---|---|---|",
    ]
    for a in load_artifacts(mesh_tag, base):
        if "refused" in a:
            lines.append(_refused(a, 6))
            continue
        m, mem = a["meta"], a["memory"]
        arg = mem["argument_size_in_bytes"]
        tmp = mem["temp_size_in_bytes"]
        total = arg + tmp
        fits = ("yes" if total < 0.9 * HBM_BYTES
                else "tight" if total < HBM_BYTES else "NO")
        lines.append(f"| {m['arch']} | {m['shape']} | {arg / 2**30:.2f} | "
                     f"{tmp / 2**30:.2f} | "
                     f"{mem['analytic_state_bytes_per_device'] / 2**30:.2f} | "
                     f"{fits} |")
    return "\n".join(lines)


def inject(path: str, base: str = None) -> None:
    """Fill the table markers of the Markdown file at ``path``."""
    with open(path) as f:
        text = f.read()
    tables = {"<!-- TORCH_ROOFLINE_TABLE -->": roofline_md("16x16", base),
              "<!-- TORCH_MULTIPOD_TABLE -->": roofline_md("2x16x16", base),
              "<!-- TORCH_MEMORY_TABLE -->": memory_md("16x16", base)}
    for marker, table in tables.items():
        text = text.replace(marker, table)
    with open(path, "w") as f:
        f.write(text)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--inject":
        inject(sys.argv[2])
        print("injected tables into", sys.argv[2])
    else:
        tag = sys.argv[1] if len(sys.argv) > 1 else "16x16"
        print(roofline_md(tag))
        print()
        print(memory_md(tag))
