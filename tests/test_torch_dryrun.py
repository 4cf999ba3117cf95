"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, held
against the JAX package's (``repro.launch.dryrun``).

  * ``cells()``, the meshes and the collective record's keys;
  * every cell's spec-only reckoning at the test meshes (2, 4) and (2, 2,
    2) under ``param_mode='fsdp2d'`` (placed leaf for leaf as the
    reference): the parameter bytes per device, ``param_bytes``, the FSDP
    and factored decisions equal the reference's (its ``build_cell``,
    computed in a subprocess with 8 placeholder devices, compiling
    nothing); ``state_bytes_per_device`` equals the reference's except in
    the cells listed in ``STATE_DIFFERS``, where the port places a cache
    or optimizer leaf otherwise (ROADMAP Queue 3);
  * ``run_cell(device='meta')`` in a subprocess (its fake process group
    is that process's default group, so none outlives it in a test
    worker): the reference's three ``test_dryrun.py`` cells and a
    multi-pod cell give a complete artifact or a refused one with the
    port's message, a bf16 train cell lists the backward kernels the card
    lacks, and chameleon-34b ``decode_32k`` on the production mesh runs
    its rank at full size with the reckoned collectives; the analytic
    counts and the model flops equal the JAX package's;
  * the CLI writes an artifact, refused cells too; the report's tables.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.models.registry import cells  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")

# cells whose state bytes per device differ from the reference's at the
# test meshes, by the port's placement of a cache or optimizer leaf
STATE_DIFFERS = {
    ("xlstm-1.3b", "prefill_32k"): "recurrent states and conv windows",
    ("xlstm-1.3b", "decode_32k"): "recurrent states and conv windows",
    ("xlstm-1.3b", "long_500k"): "recurrent states and conv windows",
    ("gemma-2b", "prefill_32k"): "one KV head kept whole on every rank",
    ("smollm-135m", "prefill_32k"): "9 / 3 heads split unevenly: rank 0's "
                                    "whole KV heads (the reference cuts "
                                    "head_dim)",
    ("zamba2-2.7b", "prefill_32k"): "Mamba2 conv window, B / C whole",
    ("zamba2-2.7b", "decode_32k"): "Mamba2 conv window, B / C whole",
    ("zamba2-2.7b", "long_500k"): "batch 1: no sequence over 'data'",
    ("deepseek-v3-671b", "train_4k"): "factored moments per piece",
    ("deepseek-v3-671b", "prefill_32k"): "MLA latent whole on every rank",
}

_REFERENCE = """
import json
import repro.launch.dryrun as dr
from repro.launch.mesh import make_test_mesh
from repro.models.registry import cells
out = {}
for mp in (False, True):
    mesh = make_test_mesh(multi_pod=mp)
    for a, s in cells():
        with mesh:
            _, args, specs, meta = dr.build_cell(
                a, s, mesh, overrides={"param_mode": "fsdp2d"})
        params = args[0]["params"] if meta["mode"] == "train" else args[0]
        pspecs = specs[0]["params"] if meta["mode"] == "train" else specs[0]
        out[f"{a}|{s}|{int(mp)}"] = {
            "state_bytes_per_device": meta["state_bytes_per_device"],
            "param_bytes_per_device": dr._per_device_bytes(params, pspecs, mesh),
            "param_bytes": meta["param_bytes"], "fsdp": meta["fsdp"],
            "factored": meta.get("optimizer", {}).get("factored")}
print(json.dumps(out))
"""

_ARTIFACTS = """
import json
import repro_torch.launch.dryrun as dr
from repro_torch.launch.mesh import make_test_mesh
out = {}
for key, arch, shape, mp in (
        ("train", "smollm-135m", "train_4k", False),
        ("decode", "qwen3-14b", "decode_32k", False),
        ("long", "xlstm-1.3b", "long_500k", False),
        ("pod", "smollm-135m", "prefill_32k", True),
        ("podrun", "qwen3-14b", "prefill_32k", True),
        ("bf16", "gemma-2b", "train_4k", False)):
    out[key] = dr.run_cell(arch, shape, mesh=make_test_mesh(multi_pod=mp),
                           verbose=False, device="meta")
out["prod"] = dr.run_cell("chameleon-34b", "decode_32k", verbose=False,
                          device="meta")
# a prefill cell under FSDP reckoned as the dry run builds it, and with
# its FSDP layout read before the trace
from repro_torch.distributed import dry
mesh = make_test_mesh(multi_pod=True)
out["layout_temps"] = []
for first in (False, True):
    with dry.fake_world(mesh.size):
        cell = dr.build_cell("qwen3-14b", "prefill_32k", mesh)
        if first:
            cell.model.layout
        out["layout_temps"].append(dr._trace(cell)[0]["temp_size_in_bytes"])
print(json.dumps(out))
"""


def _python(code: str, **env) -> str:
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=SRC, **env))
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def reference():
    return json.loads(_python(_REFERENCE, REPRO_DRYRUN_DEVICES="8",
                              JAX_PLATFORMS="cpu"))


@pytest.fixture(scope="module")
def artifacts():
    return json.loads(_python(_ARTIFACTS))


def test_cells_and_meshes_match_the_reference():
    from repro.models.registry import cells as jax_cells
    assert cells() == jax_cells()
    for mp, shape, names in ((False, (16, 16), ("data", "model")),
                             (True, (2, 16, 16), ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=mp)
        assert tuple(mesh.shape.values()) == shape
        assert mesh.axis_names == names and mesh.size == 256 * (1 + mp)
    assert make_production_mesh(multi_pod=True).placement().shape == {
        "data": 32, "model": 16}
    assert make_test_mesh().tag == "2x4"
    assert make_test_mesh(multi_pod=True).placement().shape == {
        "data": 4, "model": 2}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["2x4", "2x2x2"])
@pytest.mark.parametrize("arch,shape", cells())
def test_spec_reckoning_matches_the_reference(reference, arch, shape,
                                              multi_pod):
    want = reference[f"{arch}|{shape}|{int(multi_pod)}"]
    mesh = make_test_mesh(multi_pod=multi_pod)
    # every cell places (smollm's 9 heads split unevenly over the model
    # axis, sharding.head_split)
    _, meta, _ = dr.cell_meta(arch, shape, mesh, {"param_mode": "fsdp2d"})
    got = {"param_bytes_per_device": meta["param_bytes_per_device"],
           "param_bytes": meta["param_bytes"], "fsdp": meta["fsdp"],
           "factored": meta.get("optimizer", {}).get("factored")}
    assert got == {k: want[k] for k in got}
    if (arch, shape) in STATE_DIFFERS:
        assert meta["state_bytes_per_device"] != want["state_bytes_per_device"]
    else:
        assert meta["state_bytes_per_device"] == want["state_bytes_per_device"]


def _complete(art: dict) -> None:
    for key in ("meta", "timing", "memory", "analytic", "collectives",
                "model_flops_global", "roofline", "card_lacks"):
        assert key in art, key
    r = art["roofline"]
    assert r["hw"] == "h100-sxm"
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert art["memory"]["analytic_state_bytes_per_device"] > 0
    assert art["memory"]["argument_size_in_bytes"] > 0


def test_reference_cells_give_complete_or_refused_artifacts(artifacts):
    """The reference's ``test_dryrun.py`` cells on the test mesh run their
    rank: smollm's 9 query / 3 KV heads split unevenly over 4 ranks (rank
    0 reckoned with 2 / 1; ranks 2 and 3 hold 3), qwen3-14b's decode and
    xlstm-1.3b's long_500k."""
    assert artifacts["train"]["meta"]["rank_heads"] == {
        "query": 2, "kv": 1, "most_query": 3, "even": False}
    for key in ("train", "decode", "long"):
        _complete(artifacts[key])
    dec = artifacts["decode"]
    assert dec["meta"]["cache_prefer_seq"] and not dec["meta"]["fsdp"]
    assert dec["meta"]["rank_batch"] == 64
    L = 40
    assert dec["collectives"]["count"]["all-gather"] == 2 * L
    assert dec["collectives"]["count"]["all-reduce"] == 2 * L + 2


def test_multi_pod_cells_record_the_pod_axis(artifacts):
    assert artifacts["pod"]["meta"]["mesh"] == {"pod": 2, "data": 2,
                                                "model": 2}
    _complete(artifacts["pod"])              # smollm's 9 heads: 6 / 3
    assert artifacts["pod"]["meta"]["rank_heads"]["query"] == 6
    run = artifacts["podrun"]
    _complete(run)
    assert run["meta"]["placement"] == {"data": 4, "model": 2}
    assert run["meta"]["rank_batch"] == 32 // 4


def test_analytic_counts_and_model_flops_match_jax(artifacts):
    from repro.launch import roofline as jrl
    from repro.launch.analytic_cost import step_cost
    for key in ("decode", "long", "podrun", "bf16", "prod"):
        art = artifacts[key]
        m = art["meta"]
        sc = step_cost(m["arch"], m["shape"])
        assert art["analytic"] == {"flops_global": sc.flops,
                                   "hbm_bytes_global": sc.hbm_bytes}
        assert art["model_flops_global"] == jrl.model_flops_estimate(
            m["arch"], m["mode"], m["batch"], m["seq"])


def test_a_bf16_train_cell_lists_what_the_card_lacks(artifacts):
    art = artifacts["bf16"]
    _complete(art)
    assert {"flash_attention_bwd", "rmsnorm_bwd"} <= set(art["card_lacks"])
    assert art["meta"]["optimizer"] == {"state_dtype": "bfloat16",
                                        "factored": False}
    assert art["collectives"]["count"]["all-reduce"] > 0


def test_a_production_rank_of_chameleon_decode(artifacts):
    """chameleon-34b decode_32k at (16, 16): the rank's 1/16 of the
    weights (no FSDP at decode) and 2,048 of 32,768 cache rows of every
    KV head, 2 all_gather and 2 all_reduce per layer; the peak above the
    arguments holds the slice entry's scratch."""
    art = artifacts["prod"]
    _complete(art)
    m = art["meta"]
    assert m["mesh"] == {"data": 16, "model": 16} and not m["fsdp"]
    L = 48
    cache = 2 * L * 8 * 2048 * 8 * 128 * 2
    assert art["memory"]["argument_size_in_bytes"] == pytest.approx(
        m["param_bytes_per_device"] + cache, rel=1e-3)
    assert art["collectives"]["count"]["all-gather"] == 2 * L
    assert art["collectives"]["count"]["all-reduce"] == 2 * L + 2
    assert art["memory"]["temp_size_in_bytes"] > 8 * 8 * 32 * 8 * 130 * 4


def test_collective_bytes_keeps_the_reference_keys():
    got = rl.collective_bytes({"kinds": {"all_gather": 2, "all_reduce": 3},
                               "bytes_by_kind": {"all_gather": 64,
                                                 "all_reduce": 12}})
    assert set(got) == {"bytes", "count", "total_bytes", "total_count"}
    assert got["bytes"]["all-gather"] == 64 and got["count"]["all-reduce"] == 3
    assert got["bytes"]["reduce-scatter"] == 0
    assert (got["total_bytes"], got["total_count"]) == (76, 5)


@pytest.mark.parametrize("override,match", [
    ({"seq_parallel": True}, "item 10"),
    ({"moe_shard_constraints": True}, "GSPMD"),
    ({"attn_sp_prefill": True}, "GSPMD"),
    ({"bogus": 1}, "not a knob")])
def test_overrides_the_port_does_not_take_are_refused_by_name(override, match):
    with pytest.raises(dr.Refused, match=match):
        dr.cell_meta("chameleon-34b", "prefill_32k", make_production_mesh(),
                     override)


def test_honoured_overrides_change_the_reckoning():
    mesh = make_production_mesh()
    _, base, _ = dr.cell_meta("chameleon-34b", "decode_32k", mesh)
    _, flat, _ = dr.cell_meta("chameleon-34b", "decode_32k", mesh,
                              {"cache_prefer_seq": False})
    _, zero3, _ = dr.cell_meta("chameleon-34b", "decode_32k", mesh,
                               {"fsdp": True})
    assert base["cache_prefer_seq"] and not flat["cache_prefer_seq"]
    assert zero3["param_bytes_per_device"] < base["param_bytes_per_device"]
    _, rep, _ = dr.cell_meta("chameleon-34b", "prefill_32k", mesh,
                             {"cache_replicate_model": True})
    _, plain, _ = dr.cell_meta("chameleon-34b", "prefill_32k", mesh)
    assert rep["state_bytes_per_device"] > plain["state_bytes_per_device"]


def test_prefill_peak_does_not_move_when_the_layout_is_built_first(
        artifacts):
    """A prefill cell under FSDP (qwen3-14b prefill_32k on the multi-pod
    test mesh) builds its FSDP layout before the step is traced, so the
    reckoned peak holds the step alone: reading the layout first moves
    nothing (built inside the trace, the full-size parameter specs it is
    built from counted as the step's temporaries)."""
    unread, read = artifacts["layout_temps"]
    assert unread == read > 0


def test_cli_writes_run_and_refused_artifacts(tmp_path):
    for arch, shape in (("chameleon-34b", "decode_32k"),
                        ("gemma-2b", "decode_32k")):
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--device", "meta", "--out", str(tmp_path)],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=SRC))
        assert run.returncode == 0, run.stderr[-3000:]
    done = json.loads((tmp_path / "chameleon-34b__decode_32k__16x16.json")
                      .read_text())
    _complete(done)
    # gemma-2b's 8 heads split unevenly over 16 ranks (one each on ranks
    # 0-7): its cell runs; an override the port refuses still writes a
    # refused artifact, naming its item
    gemma = json.loads((tmp_path / "gemma-2b__decode_32k__16x16.json")
                       .read_text())
    _complete(gemma)
    assert gemma["meta"]["rank_heads"] == {"query": 1, "kv": 1,
                                           "most_query": 1, "even": False}
    path = tmp_path / "chameleon-34b__prefill_32k__16x16.json"
    run = subprocess.run(
        [sys.executable, "-c",
         "import json, sys\n"
         "from repro_torch.launch import dryrun as dr\n"
         "art = dr.run_cell('chameleon-34b', 'prefill_32k', verbose=False,\n"
         "                  device='meta', overrides={'seq_parallel': True})\n"
         "open(sys.argv[1], 'w').write(json.dumps(art))\n", str(path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert run.returncode == 0, run.stderr[-3000:]
    refused = json.loads(path.read_text())
    assert "item 10" in refused["refused"]
    table = report.roofline_md("16x16", base=str(tmp_path))
    assert "| chameleon-34b | decode_32k |" in table and "refused" in table
    assert "| gemma-2b | decode_32k |" in table
    mem = report.memory_md("16x16", base=str(tmp_path))
    assert "| yes |" in mem
    doc = tmp_path / "doc.md"
    doc.write_text("a\n<!-- TORCH_ROOFLINE_TABLE -->\nb\n")
    report.inject(str(doc), base=str(tmp_path))
    assert "chameleon-34b" in doc.read_text()
