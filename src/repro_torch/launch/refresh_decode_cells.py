"""Re-run every decode cell (decode_32k, long_500k) on both meshes with
the reference's decode defaults (the flash-decoding cache split by
sequence, no FSDP), on ``meta``; the port's counterpart of
``repro.launch.refresh_decode_cells``.

    python -m repro_torch.launch.refresh_decode_cells
"""
import json

import repro_torch.launch.dryrun as dr
from repro_torch.models.registry import SHAPES, cells


def main():
    for multi_pod in (False, True):
        for arch, shape in cells():
            if SHAPES[shape]["mode"] != "decode":
                continue
            art = dr.run_cell(arch, shape, multi_pod=multi_pod, verbose=False,
                              device="meta")
            with open(dr.artifact_path(arch, shape, multi_pod), "w") as f:
                json.dump(art, f, indent=1)
            tag = "2pod" if multi_pod else "1pod"
            if "refused" in art:
                print(f"{arch} x {shape} x {tag}: refused: {art['refused']}")
                continue
            r = art["roofline"]
            print(f"{arch} x {shape} x {tag}: mem={r['memory_s']*1e3:.2f}ms "
                  f"coll={r['collective_s']*1e3:.2f}ms dom={r['dominant']}")


if __name__ == "__main__":
    main()
