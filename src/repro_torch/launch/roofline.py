"""Roofline terms from the analytic step counts: the hardware-neutral part
of ``repro.launch.roofline``.

Three terms per (arch x shape x chips), in seconds:

    compute    = FLOPs       / peak FLOP/s per chip
    memory     = HBM bytes   / HBM bandwidth per chip
    collective = coll bytes  / interconnect bandwidth per chip

over a :class:`~repro_torch.hw.HardwareProfile` (``H100_SXM`` by
default: data-sheet rates, not measurements).  The FLOPs and bytes come
from ``launch.analytic_cost``, split evenly over the chips; the
collective bytes per chip from :func:`collective_bytes`, the port's
counterpart of the reference's compiled-HLO parser.
"""

from __future__ import annotations

import dataclasses

from repro_torch.hw import H100_SXM, HardwareProfile


# the reference's collective kinds (XLA's names), and the port's
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
_PORT_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
              "reduce_scatter": "reduce-scatter"}


def collective_bytes(stats: dict) -> dict:
    """Per-kind byte totals of one rank's step from the port's collective
    record (``distributed.sharding.collective_stats()`` after the step),
    under the reference's keys: ``bytes`` and ``count`` by kind,
    ``total_bytes`` and ``total_count``.

    The reference parses the partitioned HLO, where a scan body appears
    once, and scales each collective by its loop's trip count
    (``scan_trips``).  The port's step runs eagerly and records every
    collective every layer makes, so no scaling is needed and
    ``scan_trips`` has no counterpart.  A byte count is this rank's
    buffer: an all_reduce's, an all_gather's gathered output (the HLO's
    result size), a reduce_scatter's input."""
    out = {k: 0.0 for k in COLLECTIVE_KINDS}
    count = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, n in stats["kinds"].items():
        name = _PORT_KIND.get(kind, kind)
        count[name] += n
        out[name] += float(stats["bytes_by_kind"].get(kind, 0))
    return {"bytes": out, "count": count, "total_bytes": sum(out.values()),
            "total_count": sum(count.values())}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    useful_ratio: float           # MODEL_FLOPS / FLOPs (per chip)
    hw: HardwareProfile = H100_SXM   # the profile the terms were taken on

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """How close the useful model FLOPs come to the chip's peak over the
        step's roofline-bound time (an MFU-style score), on the profile
        the terms were taken on."""
        if self.total_s <= 0:
            return 0.0
        return (self.model_flops / self.hw.peak_flops_bf16) / self.total_s


def terms_from_analytic(flops_global: float, hbm_bytes_global: float,
                        coll_bytes_per_chip: float, n_chips: int,
                        model_flops_global: float,
                        hw: HardwareProfile = H100_SXM) -> RooflineTerms:
    """Roofline terms: analytic per-step flops/bytes (global, split evenly
    over chips) and the collective bytes per chip."""
    flops = flops_global / n_chips
    nbytes = hbm_bytes_global / n_chips
    mf = model_flops_global / n_chips
    return RooflineTerms(
        compute_s=flops / hw.peak_flops_bf16,
        memory_s=nbytes / hw.hbm_bandwidth,
        collective_s=coll_bytes_per_chip / hw.interconnect_bw,
        hlo_flops=flops, hlo_bytes=nbytes, coll_bytes=coll_bytes_per_chip,
        model_flops=mf,
        useful_ratio=(mf / flops) if flops else 0.0, hw=hw)


def model_flops_estimate(arch: str, mode: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), D = tokens.

    train: fwd+bwd = 6ND.  prefill: forward only = 2ND.  decode: one token
    per sequence = 2*N*batch."""
    from repro_torch.core.plans import plan_for
    from repro_torch.models.registry import get_config
    cfg = get_config(arch)
    plan = plan_for(arch, 1, 256)
    n_total = plan.total_weight_bytes / 2          # bf16 params
    if cfg.n_experts:
        # active params: everything non-expert + top_k/E of the experts
        expert_bytes = sum(
            v for k, v in plan.sizes.items() if "experts" in k[0])
        active_expert_bytes = expert_bytes * cfg.top_k / cfg.n_experts
        n_active = (plan.total_weight_bytes - expert_bytes
                    + active_expert_bytes) / 2
    else:
        n_active = n_total
    if mode == "train":
        return 6.0 * n_active * batch * seq
    if mode == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch                   # decode: 1 new token
