"""Re-run the cells whose FSDP decision matters (the architectures above
``dryrun.FSDP_THRESHOLD`` per model shard) on both meshes, on ``meta``;
the port's counterpart of ``repro.launch.refresh_fsdp_cells``.

    python -m repro_torch.launch.refresh_fsdp_cells
"""
import json

import repro_torch.launch.dryrun as dr
from repro_torch.models.registry import cells

AFFECTED = {"qwen2.5-32b", "chameleon-34b", "phi3.5-moe-42b-a6.6b",
            "deepseek-v3-671b"}


def main():
    for multi_pod in (False, True):
        for arch, shape in cells():
            if arch not in AFFECTED:
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
            print(f"refreshed {arch} x {shape} x {tag}: "
                  f"coll={r['collective_s']*1e3:.0f}ms dom={r['dominant']}")


if __name__ == "__main__":
    main()
