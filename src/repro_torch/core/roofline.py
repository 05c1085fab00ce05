"""Three-term roofline analysis of a dry-run cell (the port of
``repro/core/roofline.py``).

    compute term    = FLOPs            / (chips x peak FLOP/s)
    memory term     = HBM bytes        / (chips x HBM bandwidth)
    collective term = collective bytes / (chips x link bandwidth)

:class:`RooflineReport` and :func:`roofline` are the reference's, copied
with the imports rewritten; the topology defaults to the port's
``GPU_H100_LIKE`` (989 TFLOP/s bf16, 3.35 TB/s HBM, NVLink4's 50 GB/s a
link) where the reference's defaults to ``TPU_V5E``.

The reference reads its terms out of XLA artifacts: ``cost_analysis_terms``
takes ``compiled.cost_analysis()``, ``parse_collective_bytes`` the
partitioned HLO text.  Neither has a torch counterpart, and neither is
ported.  Their work moves to the dry-run (``launch/dryrun.py``): the FLOPs
are counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
rank's local step on "meta" tensors, the collective bytes by the dry
mesh's groups, by kind (``distributed/collectives.py::DryGroup``), and the
HBM bytes come from the analytic model (``launch/memory.py::
estimate_step_hbm_bytes``), as in the reference.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Mapping

from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.topology import HardwareSpec

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclass(frozen=True)
class RooflineReport:
    arch: str
    shape_name: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float            # 6*N*D (dense) / 6*N_active*D (MoE)
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_flop_ratio: float      # MODEL_FLOPS / counted FLOPs
    roofline_s: float             # max of the three terms
    collectives: Mapping[str, float]
    # Per-level memory rooflines: the bytes pushed through each memory
    # level's port; the outermost level (HBM) is the memory term itself.
    level_seconds: Mapping[str, float] = field(default_factory=dict)

    def as_dict(self) -> Dict:
        d = asdict(self)
        d["collectives"] = dict(self.collectives)
        d["level_seconds"] = dict(self.level_seconds)
        return d


def roofline(
    *,
    arch: str,
    shape_name: str,
    mesh: str,
    chips: int,
    hlo_flops: float,          # PER-DEVICE (one rank's step)
    hlo_bytes: float,
    collectives: Mapping[str, float],   # PER-DEVICE result bytes
    model_flops: float,        # GLOBAL 6·N·D — divided by chips here
    hw: HardwareSpec = GPU_H100_LIKE,
    dtype: str = "bfloat16",
) -> RooflineReport:
    """Three roofline terms on a per-chip basis:
      compute    = flops_dev / peak
      memory     = bytes_dev / HBM_bw
      collective = coll_bytes_dev / link_bw   (one link; ring all-reduce
                   wire bytes ≈ 2x result size — folded in)
    """
    compute_s = hlo_flops / hw.flops(dtype)
    memory_s = hlo_bytes / hw.hbm_bandwidth
    coll_bytes = float(collectives.get("total", 0.0))
    wire = (2.0 * float(collectives.get("all-reduce", 0.0))
            + sum(float(collectives.get(k, 0.0))
                  for k in COLLECTIVES if k != "all-reduce"))
    collective_s = wire / hw.ici_bandwidth
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    model_flops_dev = model_flops / max(chips, 1)
    return RooflineReport(
        arch=arch, shape_name=shape_name, mesh=mesh, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
        collective_bytes=coll_bytes, model_flops=model_flops,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck,
        useful_flop_ratio=(model_flops_dev / hlo_flops) if hlo_flops else 0.0,
        roofline_s=max(terms.values()),
        collectives=dict(collectives),
        level_seconds={lvl.name: hlo_bytes / lvl.bandwidth
                       for lvl in hw.levels[:-1]},
    )
