"""Hardware presets for the analytical model (paper §IV, Table I).

The paper parameterizes its model by "measurable hardware rates (bandwidths,
instruction latencies, and matrix-core shapes)" so it can be retargeted by
calibration alone (paper §V-E / Fig. 5).  We keep exactly that contract,
now expressed through :mod:`repro_torch.core.topology`: a :class:`Topology` is a
frozen dataclass of compute rates plus an ordered :class:`MemoryLevel`
chain.  Retargeting = new preset.

Preset families (DESIGN.md §2):

* **TPU** (v5e primary — the container's roofline constants; v5p, v4): the
  1-level special case ``HBM → VMEM`` with no intermediate cache — cache
  locality is the deterministic Pallas *revisit* model instead.
* **GPU-shaped** (``gpu_mi300x_like``, ``gpu_h100_like``): multi-level
  chains (``HBM → MALL → L2-per-XCD → LDS`` and ``HBM → L2 → SMEM``) that
  exercise the paper's actual Table-I hierarchy.  Constants approximate the
  public datasheets — these presets exist so the model's per-level terms
  (``benchmarks/hierarchy_sweep.py``) have a real shape to bite on, hence
  the ``_like`` suffix; on-silicon calibration would refine them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional

from repro_torch.core.dtypes import DTYPE_BYTES  # re-export (legacy import path)
from repro_torch.core.topology import (
    HardwareSpec,
    MemoryLevel,
    Topology,
    calibration_field_names,
)

__all__ = [
    "DTYPE_BYTES", "HardwareSpec", "MemoryLevel", "Topology",
    "TPU_V5E", "TPU_V5P", "TPU_V4", "GPU_MI300X_LIKE", "GPU_H100_LIKE",
    "PRESETS", "get_hardware", "calibrate", "validate_measured",
]

# ---------------------------------------------------------------------------
# TPU presets.  v5e numbers match the roofline constants mandated for this
# repo: 197 TFLOP/s bf16 / chip, 819 GB/s HBM, ~50 GB/s/link ICI.  VMEM
# bandwidth is modeled at ~22x HBM (scaling-book ratio).
# ---------------------------------------------------------------------------

TPU_V5E = Topology(
    name="tpu_v5e",
    mxu_shape=(128, 128, 128),
    lane_width=128,
    sublane_f32=8,
    peak_flops={
        "bfloat16": 197e12,
        "float16": 197e12,          # modeled at the bf16 rate
        "float32": 197e12 / 4,      # no native f32 matmul path
        "int8": 394e12,
        "float8_e4m3fn": 394e12,
    },
    levels=(
        MemoryLevel(name="hbm", capacity=16 * 1024**3, bandwidth=819e9,
                    latency=1.0e-6, scope="device"),
        MemoryLevel(name="vmem", capacity=128 * 1024**2,
                    bandwidth=22 * 819e9, scope="core",
                    budget_fraction=0.5, holds_accumulator=True),
    ),
    ici_bandwidth=50e9,
    ici_links=4,                    # 2D torus
    dma_fixed=1.0e-7,
    kernel_launch=2.0e-6,
    pipeline_depth=2,
)

TPU_V5P = TPU_V5E.with_calibration(
    name="tpu_v5p",
    peak_flops={
        "bfloat16": 459e12,
        "float16": 459e12,
        "float32": 459e12 / 4,
        "int8": 918e12,
        "float8_e4m3fn": 918e12,
    },
    hbm_bandwidth=2765e9,
    hbm_bytes=95 * 1024**3,
    vmem_bandwidth=22 * 2765e9,
    ici_bandwidth=90e9,
    ici_links=6,                    # 3D torus
)

TPU_V4 = TPU_V5E.with_calibration(
    name="tpu_v4",
    peak_flops={
        "bfloat16": 275e12,
        "float16": 275e12,
        "float32": 275e12 / 4,
        "int8": 275e12,
        "float8_e4m3fn": 275e12,
    },
    hbm_bandwidth=1228e9,
    hbm_bytes=32 * 1024**3,
    vmem_bandwidth=22 * 1228e9,
    ici_bandwidth=50e9,
    ici_links=6,
)

# ---------------------------------------------------------------------------
# GPU-shaped multi-level presets.  Staging (LDS/SMEM) holds only the
# double-buffered input blocks — accumulators live in registers, so
# holds_accumulator=False widens the legal tile space exactly as on silicon.
# Menus are finer than the TPU's: KB-scale staging wants smaller blocks, and
# group_m spans 1..16 because grouped swizzle is priced (L2 residency of the
# re-walked operand), not gated on the Pallas revisit trick.
# partitions x core_count is the Alg. 4 wave denominator (DESIGN.md §2
# occupancy stage): tail-wave shapes on these presets select split_k > 1 or
# the stream_k schedule, which is why schedule_menu carries both.
# ---------------------------------------------------------------------------

GPU_MI300X_LIKE = Topology(
    name="gpu_mi300x_like",
    mxu_shape=(16, 16, 16),         # MFMA macro-atom
    lane_width=32,
    sublane_f32=8,
    peak_flops={
        "bfloat16": 1307e12,
        "float16": 1307e12,
        "float32": 163e12,
        "int8": 2614e12,
        "float8_e4m3fn": 2614e12,
    },
    levels=(
        MemoryLevel(name="hbm", capacity=192 * 1024**3, bandwidth=5.3e12,
                    latency=8.0e-7, scope="device"),
        # Cache levels carry budget_fraction < 1: a shared cache never
        # gives one kernel its full capacity (conflict misses, other
        # streams), so reuse windows within ~25% of nominal capacity are
        # treated as spills — keeps the closed-form ideal-LRU windows and
        # the simulator's byte-clock distance proxy agreeing at the
        # residency boundary (the fidelity harness's marginal cases).
        MemoryLevel(name="mall", capacity=256 * 1024**2, bandwidth=14.0e12,
                    scope="device", budget_fraction=0.75),  # Infinity Cache
        MemoryLevel(name="l2", capacity=4 * 1024**2, bandwidth=25.0e12,
                    scope="partition", budget_fraction=0.75),  # 4MiB per XCD
        MemoryLevel(name="lds", capacity=64 * 1024, bandwidth=80.0e12,
                    scope="core"),                       # 64 KiB per CU
    ),
    partitions=8,                   # XCDs
    core_count=38,                  # CUs per XCD -> 304 chip-wide
    ici_bandwidth=64e9,             # xGMI per link
    ici_links=7,
    dma_fixed=1.0e-9,               # issue cost amortizes over parallel CUs
    kernel_launch=3.0e-6,
    pipeline_depth=2,
    bm_menu=(16, 32, 64, 128, 256),
    bn_menu=(32, 64, 128, 256),
    bk_menu=(32, 64, 128),
    split_k_menu=(1, 2, 4, 8),
    group_m_menu=(1, 2, 4, 8, 16),
    schedule_menu=("data_parallel", "stream_k"),
)

GPU_H100_LIKE = Topology(
    name="gpu_h100_like",
    mxu_shape=(64, 64, 16),         # wgmma macro-atom
    lane_width=32,
    sublane_f32=8,
    peak_flops={
        "bfloat16": 989e12,
        "float16": 989e12,
        "float32": 494e12,          # tf32 tensor-core path
        "int8": 1979e12,
        "float8_e4m3fn": 1979e12,
    },
    levels=(
        MemoryLevel(name="hbm", capacity=80 * 1024**3, bandwidth=3.35e12,
                    latency=7.0e-7, scope="device"),
        # budget_fraction < 1: see the MI300X-like preset note.
        MemoryLevel(name="l2", capacity=50 * 1024**2, bandwidth=12.0e12,
                    scope="device", budget_fraction=0.75),
        MemoryLevel(name="smem", capacity=228 * 1024, bandwidth=30.0e12,
                    scope="core"),                       # 228 KiB per SM
    ),
    partitions=1,
    core_count=132,                 # SMs (one L2 partition modeled)
    ici_bandwidth=50e9,             # NVLink4 per link
    ici_links=18,
    dma_fixed=1.0e-9,               # issue cost amortizes over parallel SMs
    kernel_launch=3.0e-6,
    pipeline_depth=2,
    bm_menu=(32, 64, 128, 256),
    bn_menu=(32, 64, 128, 256),
    bk_menu=(32, 64, 128),
    split_k_menu=(1, 2, 4, 8),
    group_m_menu=(1, 2, 4, 8, 16),
    schedule_menu=("data_parallel", "stream_k"),
)

PRESETS: Dict[str, Topology] = {
    "tpu_v5e": TPU_V5E,
    "tpu_v5p": TPU_V5P,
    "tpu_v4": TPU_V4,
    "gpu_mi300x_like": GPU_MI300X_LIKE,
    "gpu_h100_like": GPU_H100_LIKE,
}


def get_hardware(name: str) -> Topology:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown hardware {name!r}; presets: {sorted(PRESETS)}")


# Numeric calibration fields that must be strictly positive — a measured
# rate/size of zero (or below) means the microbenchmark failed, and feeding
# it onward would either crash MemoryLevel validation with an unhelpful
# message or (worse, e.g. peak_flops) silently poison every selection.
# Everything else numeric (latencies, fixed overheads, ici terms) may
# legitimately measure 0.0 but never negative or NaN.
_POSITIVE_MARKERS = ("bandwidth", "bytes", "capacity", "fraction", "flops")
_POSITIVE_FIELDS = frozenset(
    {"partitions", "core_count", "pipeline_depth", "lane_width",
     "sublane_f32"})


def validate_measured(field_name: str, value) -> None:
    """Reject a non-finite / non-positive measured value with an error that
    names the offending field — shared by :func:`calibrate` (hand-supplied
    microbenchmarks) and the ``repro.calib`` fit pipeline (fitted values).

    Non-numeric calibration payloads (``levels`` tuples, menus, names) pass
    through; ``peak_flops`` mappings are validated per dtype entry."""
    if isinstance(value, Mapping):
        for k, v in value.items():
            validate_measured(f"{field_name}.{k}", v)
        return
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return
    if not math.isfinite(value):
        raise ValueError(
            f"calibration for field {field_name!r} measured a non-finite "
            f"value ({value!r}); the microbenchmark failed — refusing to "
            f"build a topology from it")
    base = field_name.rsplit(".", 1)[-1]
    needs_positive = (base in _POSITIVE_FIELDS
                      or any(m in field_name for m in _POSITIVE_MARKERS))
    if needs_positive and value <= 0:
        raise ValueError(
            f"calibration for field {field_name!r} measured a non-positive "
            f"value ({value!r}); rates, capacities and fractions must be "
            f"> 0 — the microbenchmark failed")
    if not needs_positive and value < 0:
        raise ValueError(
            f"calibration for field {field_name!r} measured a negative "
            f"value ({value!r}); overheads/latencies must be >= 0")


def calibrate(
    base: Topology,
    microbenchmarks: Optional[Mapping[str, Callable[[], float]]] = None,
    *,
    device=None,
    **fit_kwargs,
) -> Topology:
    """Calibration entry point (paper contribution #2 / §V-E retargeting).

    Two modes:

    * ``microbenchmarks`` maps field names — real :class:`Topology` fields
      or the legacy flat aliases (``hbm_bandwidth`` …) — to zero-arg
      callables returning a measured value.  Unknown names raise
      ``KeyError`` listing what is calibratable; non-finite or
      non-positive measurements raise ``ValueError`` naming the field
      (:func:`validate_measured`).
    * ``device`` (a :class:`repro_torch.calib.device.Device`) delegates to the
      full probe → fit pipeline (``repro_torch.calib.fit.fit_topology``), which
      measures per-level stream bandwidths, per-dtype issue rates, and the
      wave/launch/issue overheads, returning the fitted topology.  Pass
      ``fit_kwargs`` (e.g. ``dtypes=...``) through to the fit.  Use
      ``repro_torch.calib.fit.fit_topology`` directly when you also want the
      provenance artifact.
    """
    if device is not None:
        if microbenchmarks:
            raise ValueError(
                "pass either microbenchmarks or device=, not both")
        from repro_torch.calib.fit import fit_topology
        return fit_topology(base, device, **fit_kwargs).topology
    if microbenchmarks is None:
        raise ValueError(
            "calibrate() needs either a microbenchmarks mapping or a "
            "device= to probe; calling it with neither would silently "
            "return the uncalibrated preset")
    known = calibration_field_names(base)
    measured = {}
    for field_name, bench in (microbenchmarks or {}).items():
        if field_name not in known:
            raise KeyError(
                f"not a calibratable field: {field_name!r}; "
                f"known: {sorted(known)}")
        value = bench()
        validate_measured(field_name, value)
        measured[field_name] = value
    return base.with_calibration(**measured)
