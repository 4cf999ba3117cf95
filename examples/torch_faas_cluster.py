"""End-to-end FaaS cluster driver on the PyTorch port (the paper's §7.3
experiment): 16 LLM functions x real-world-style traces on an 8-GPU
cluster, comparing ServerlessLLM against the TIDAL variants, with
keep-alive, early-reject, elastic scaling and straggler hedging.  The
port's counterpart of ``examples/faas_cluster.py``: the plans are the
port's (``repro_torch.core.plans.plan_for``, traced on ``meta``), the
simulator ``repro_torch.core.scheduler.ClusterSim``.

    PYTHONPATH=src python examples/torch_faas_cluster.py
    PYTHONPATH=src python examples/torch_faas_cluster.py --hw h100-sxm
    PYTHONPATH=src python examples/torch_faas_cluster.py --measured \\
        --device cpu

``--hw`` picks the analytic profile: the paper's ``a6000-pcie4`` testbed
(default, to set the result beside the paper's) or ``h100-sxm``.  With
``--measured`` the sim also runs in MEASURED mode: a smoke-scale
``FaaSRuntime`` of the port serves real requests through template forking
and continuous batching (on the card by default, its hand-written
kernels; ``--device cpu`` their plain versions), and its wall-clock
warm/fork/cold service times become the sim's latency oracle (the
analytic model as fallback).
"""

import argparse

from repro_torch.core.plans import plan_for
from repro_torch.core.scheduler import (ClusterSim, FunctionProfile,
                                        SchedulerConfig, make_trace, summarize)
from repro_torch.hw import get_profile

LORA_FRAC = 0.01


def build():
    fns, rates, tasks = {}, {}, {}
    tasklist = ["mail", "conv", "code", "longbench"]
    ratelist = [0.16, 0.31, 0.5]
    i = 0
    for arch in ("llama3-8b", "llama2-13b"):
        plan = plan_for(arch, 1, 2048)
        for lora in (False, True):
            for k in range(4):
                name = f"{arch}{'-lora' if lora else ''}-{k}"
                fns[name] = FunctionProfile(
                    name=name,
                    plan_for_len=lambda L, a=arch: plan_for(a, 1, L),
                    dynamic_bytes=int(plan.total_weight_bytes * LORA_FRAC)
                    if lora else 0,
                    template_bytes=0,
                    model_bytes=plan.total_weight_bytes)
                tasks[name] = tasklist[k % 4]
                rates[name] = ratelist[i % 3]
                i += 1
    return fns, rates, tasks


def measured_mode(hw, device: str) -> None:
    """ClusterSim sourced from the port's live runtime (smoke scale)."""
    from repro_torch.runtime.faas import measure_smoke_service_times

    mst = measure_smoke_service_times({"live-static": "static",
                                       "live-lora": "lora"}, device=device)
    print(f"measured service times (wall-clock, live runtime on {device}):")
    print(mst.summary())

    fns = {}
    for name, dyn in (("live-static", 0), ("live-lora", 1 << 20)):
        plan = plan_for("smollm-135m", 1, 867)
        fns[name] = FunctionProfile(
            name=name,
            plan_for_len=lambda L: plan_for("smollm-135m", 1, L),
            dynamic_bytes=dyn, model_bytes=plan.total_weight_bytes)
    trace = make_trace({"live-static": 1.0, "live-lora": 1.0},
                       duration_s=60.0,
                       fn_tasks={"live-static": "mail", "live-lora": "mail"},
                       seed=3)
    cfg = SchedulerConfig(n_gpus=2, policy="tidal", dk=True, keep_alive_s=5.0,
                          hw=hw, measured=mst)
    s = summarize(ClusterSim(cfg, fns).run(trace))
    print(f"measured-mode sim ({len(trace)} reqs): "
          f"p50={s['p50']*1e3:.1f}ms p95={s['p95']*1e3:.1f}ms "
          f"cold={s['cold']} warm={s['warm']} fork={s['fork']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", default="a6000-pcie4",
                    choices=["a6000-pcie4", "a100-pcie3", "h100-sxm"],
                    help="the analytic oracle's hardware profile")
    ap.add_argument("--measured", action="store_true",
                    help="also run the sim against live-runtime "
                         "measurements (smoke scale)")
    ap.add_argument("--device", default="cuda",
                    help="the live runtime's device for --measured "
                         "(cuda, or cpu)")
    args = ap.parse_args(argv)
    hw = get_profile(args.hw)
    fns, rates, tasks = build()
    trace = make_trace(rates, duration_s=900.0, fn_tasks=tasks, seed=11)
    print(f"trace: {len(trace)} requests over 15 min, 16 functions, "
          f"profile {hw.name}")

    def show(tag, cfg):
        s = summarize(ClusterSim(cfg, fns).run(trace))
        print(f"{tag:28s} p50={s['p50']*1e3:7.0f}ms p95={s['p95']*1e3:8.0f}ms "
              f"cold={s['cold']:5d} warm={s['warm']:5d} fork={s['fork']:5d} "
              f"rej={s['rejected']:4d} hedged={s['hedged']}")
        return s

    show("serverlessllm",
         SchedulerConfig(n_gpus=8, policy="serverlessllm", keep_alive_s=1.0,
                         hw=hw))
    show("tidal",
         SchedulerConfig(n_gpus=8, policy="tidal", keep_alive_s=1.0, hw=hw))
    show("tidal-dk (keepalive 10s)",
         SchedulerConfig(n_gpus=8, policy="tidal", dk=True, keep_alive_s=10.0,
                         hw=hw))
    show("tidal-dk + hedging",
         SchedulerConfig(n_gpus=8, policy="tidal", dk=True, keep_alive_s=10.0,
                         hedge_after=2.0, hw=hw))
    print("\nelastic scaling: 4 GPUs join at t=300s after a burst:")
    show("tidal-dk elastic 8->12",
         SchedulerConfig(n_gpus=8, policy="tidal", dk=True, keep_alive_s=10.0,
                         capacity_events=((300.0, +4),), hw=hw))

    if args.measured:
        print()
        measured_mode(hw, args.device)


if __name__ == "__main__":
    main()
