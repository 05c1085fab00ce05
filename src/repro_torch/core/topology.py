"""Memory-hierarchy topology model (paper §IV, Table I, generalized).

The paper's claim is that GEMM configs can be picked analytically by
"explicitly modeling the relationship between architectural topology, matrix
shapes, and algorithmic blocking behavior".  The seed encoded that topology
as a *flat* two-level dataclass (HBM + VMEM) which could not express the
LDS + L2 + HBM hierarchies of the paper's actual GPU targets.  This module
is the generalization:

* :class:`MemoryLevel` — one level of the chain: capacity, bandwidth across
  its port, first-access latency, and *scope* (device / partition / core).
* :class:`Topology` — compute rates (MXU shape, peak FLOP/s, lane tiling),
  partition count, fixed overheads, and an ordered ``levels`` chain running
  **outermost → innermost**: ``levels[0]`` is backing memory (HBM),
  ``levels[-1]`` is the kernel's staging memory (VMEM / LDS / SMEM), and
  anything between is a cache (L2 / LLC / MALL) the latency model prices
  via its reuse/footprint recurrence (``core/latency.py::level_traffic``).

The TPU presets are the 1-level special case (no intermediate cache level:
``levels == (hbm, vmem)``) and reproduce the seed/PR-1 model bit-for-bit —
pinned by ``tests/test_topology.py``.  ``HardwareSpec`` remains as an alias
so every existing call site keeps working; the legacy flat field names
(``hbm_bandwidth``, ``vmem_bytes``, …) are derived properties of the chain
ends, and ``with_calibration`` still accepts them (paper §V-E: retarget by
swapping measured constants only).

Candidate menus are per-topology: GPU-shaped presets need smaller staging
tiles (LDS/SMEM is KB-scale where VMEM is MB-scale) and a finer ``group_m``
menu, since grouped swizzle is a *priced* L2-residency decision there, not
a free entry.  All menu entries must stay powers of two — the vectorized
selector turns every ceil-division into a shift.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.dtypes import DTYPE_BYTES

SCOPES = ("device", "partition", "core")

# Grid schedules the model can price (DESIGN.md §2: occupancy stage).
SCHEDULES = ("data_parallel", "stream_k")

# Default candidate menus (the TPU-shaped space of the seed; DESIGN.md §2).
DEFAULT_BM_MENU = (8, 16, 32, 64, 128, 256, 512, 1024)
DEFAULT_BN_MENU = (128, 256, 512, 1024)
DEFAULT_BK_MENU = (128, 256, 512, 1024, 2048)
DEFAULT_SPLIT_K_MENU = (1, 2, 4, 8)
DEFAULT_GROUP_M_MENU = (1, 8)
DEFAULT_SCHEDULE_MENU = ("data_parallel",)


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


@dataclass(frozen=True)
class MemoryLevel:
    """One level of the memory chain.  Sizes in bytes, rates in B/s.

    ``capacity`` is per *scope instance* (per device / per partition / per
    core) — the model runs a kernel on one core of one partition, so the
    capacity a reuse window sees is exactly this number.
    ``bandwidth`` is the byte rate across this level's port toward the
    compute side; traffic served at level ℓ also crosses every port nearer
    than ℓ (inclusive hierarchy).
    ``holds_accumulator`` marks a staging level that must also host the f32
    accumulator block (TPU VMEM scratch: yes; GPU LDS: no — accumulators
    live in registers there).
    """

    name: str
    capacity: int
    bandwidth: float
    latency: float = 0.0
    scope: str = "device"
    budget_fraction: float = 1.0
    holds_accumulator: bool = False

    def __post_init__(self):
        if self.scope not in SCOPES:
            raise ValueError(f"scope {self.scope!r} not in {SCOPES}")
        if self.capacity <= 0 or self.bandwidth <= 0:
            raise ValueError(f"non-positive capacity/bandwidth in {self}")
        if not (0.0 < self.budget_fraction <= 1.0):
            raise ValueError(f"budget_fraction out of (0,1]: {self}")

    def budget(self) -> int:
        """Bytes of this level a kernel may claim (the capacity filter)."""
        return int(self.capacity * self.budget_fraction)


# Legacy flat-field calibration aliases -> (level index, MemoryLevel field).
# Index -1 is the staging level, 0 the backing memory.
_LEVEL_ALIASES: Dict[str, Tuple[int, str]] = {
    "hbm_bandwidth": (0, "bandwidth"),
    "hbm_bytes": (0, "capacity"),
    "hbm_latency": (0, "latency"),
    "vmem_bytes": (-1, "capacity"),
    "vmem_bandwidth": (-1, "bandwidth"),
    "vmem_budget_fraction": (-1, "budget_fraction"),
}


@dataclass(frozen=True)
class Topology:
    """Calibratable machine description: compute rates + the memory chain."""

    name: str
    # MXU / tensor-core macro-atom (M, N, K): instruction-level tile.
    mxu_shape: Tuple[int, int, int]
    # Native sublane tiling (second-minor, minor) per dtype-bytes.
    lane_width: int
    sublane_f32: int
    # Peak matmul throughput per chip, FLOP/s, keyed by input dtype.
    peak_flops: Mapping[str, float]
    # Memory chain, outermost (backing memory) -> innermost (staging).
    levels: Tuple[MemoryLevel, ...]
    # Cores per partition-scope cache domain (XCDs on MI300X; 1 on TPU).
    partitions: int = 1
    # Compute cores (CUs / SMs) per partition.  total_cores() =
    # partitions * core_count is the chip-wide denominator of the Alg. 4
    # wave model; 1 keeps the seed's single-sequential-core behaviour.
    core_count: int = 1
    # Interconnect (per chip).
    ici_bandwidth: float = 0.0
    ici_links: int = 0
    # Fixed overheads (the paper's load/store "issue rate" axis).
    dma_fixed: float = 0.0
    kernel_launch: float = 0.0
    pipeline_depth: int = 2
    # Per-topology candidate menus (powers of two; selector shift trick).
    bm_menu: Tuple[int, ...] = DEFAULT_BM_MENU
    bn_menu: Tuple[int, ...] = DEFAULT_BN_MENU
    bk_menu: Tuple[int, ...] = DEFAULT_BK_MENU
    split_k_menu: Tuple[int, ...] = DEFAULT_SPLIT_K_MENU
    group_m_menu: Tuple[int, ...] = DEFAULT_GROUP_M_MENU
    schedule_menu: Tuple[str, ...] = DEFAULT_SCHEDULE_MENU

    def __post_init__(self):
        if len(self.levels) < 2:
            raise ValueError(
                f"{self.name}: need at least (backing, staging) levels")
        if self.partitions < 1 or self.core_count < 1:
            raise ValueError(
                f"{self.name}: partitions/core_count must be >= 1")
        for menu_name in ("bm_menu", "bn_menu", "bk_menu",
                          "split_k_menu", "group_m_menu"):
            menu = getattr(self, menu_name)
            if not menu or not all(_is_pow2(m) for m in menu):
                raise ValueError(
                    f"{self.name}: {menu_name} must be non-empty powers of "
                    f"two, got {menu}")
        if not self.schedule_menu or not all(
                s in SCHEDULES for s in self.schedule_menu):
            raise ValueError(
                f"{self.name}: schedule_menu entries must be from "
                f"{SCHEDULES}, got {self.schedule_menu}")

    # ---- the chain ------------------------------------------------------
    @property
    def backing(self) -> MemoryLevel:
        """Outermost level: where compulsory traffic is served (HBM)."""
        return self.levels[0]

    @property
    def staging(self) -> MemoryLevel:
        """Innermost level: where the kernel stages blocks (VMEM/LDS)."""
        return self.levels[-1]

    @property
    def cache_levels(self) -> Tuple[MemoryLevel, ...]:
        """Intermediate levels (L2/LLC …), outermost -> innermost.  Empty on
        the TPU 1-level special case."""
        return self.levels[1:-1]

    def total_cores(self) -> int:
        """Chip-wide compute cores — the Alg. 4 wave denominator."""
        return self.partitions * self.core_count

    def placement_levels(self) -> Tuple[MemoryLevel, ...]:
        """Levels whose capacity gates candidate legality: every level the
        kernel *pins* working state in — the staging level, plus any deeper
        core-scoped level a topology might model."""
        return tuple(l for l in self.levels[1:]
                     if l is self.staging or l.scope == "core")

    # ---- legacy flat-field views (the whole repo reads these) -----------
    @property
    def hbm_bandwidth(self) -> float:
        return self.backing.bandwidth

    @property
    def hbm_bytes(self) -> int:
        return self.backing.capacity

    @property
    def hbm_latency(self) -> float:
        return self.backing.latency

    @property
    def vmem_bytes(self) -> int:
        return self.staging.capacity

    @property
    def vmem_bandwidth(self) -> float:
        return self.staging.bandwidth

    @property
    def vmem_budget_fraction(self) -> float:
        return self.staging.budget_fraction

    def vmem_budget(self) -> int:
        return self.staging.budget()

    # ---- derived helpers -------------------------------------------------
    def flops(self, dtype: str) -> float:
        """Peak FLOP/s for ``dtype``.  Unknown dtypes raise (the seed fell
        back to bf16 peak silently, mispricing every unknown-dtype GEMM)."""
        try:
            return self.peak_flops[dtype]
        except KeyError:
            raise KeyError(
                f"{self.name} has no peak-FLOPs entry for dtype {dtype!r}; "
                f"known dtypes: {sorted(self.peak_flops)}") from None

    def sublane(self, dtype: str) -> int:
        # Packing: second-minor native tile scales inversely with dtype width.
        return self.sublane_f32 * (4 // min(DTYPE_BYTES[dtype], 4))

    def ici_bandwidth_total(self) -> float:
        return self.ici_bandwidth * self.ici_links

    def with_calibration(self, **updates) -> "Topology":
        """Paper §V-E: retarget by swapping measured constants only.

        Accepts real ``Topology`` fields, the legacy flat aliases
        (``hbm_bandwidth`` … ``vmem_budget_fraction``) which update the
        chain ends, and ``levels`` itself for whole-chain swaps.
        """
        level_updates: Dict[int, Dict[str, object]] = {}
        direct: Dict[str, object] = {}
        for key, value in updates.items():
            alias = _LEVEL_ALIASES.get(key)
            if alias is not None:
                idx, fname = alias
                idx = idx % len(self.levels)
                level_updates.setdefault(idx, {})[fname] = value
            else:
                direct[key] = value
        if level_updates:
            levels = tuple(
                dataclasses.replace(l, **level_updates[i])
                if i in level_updates else l
                for i, l in enumerate(self.levels))
            direct["levels"] = levels
        return dataclasses.replace(self, **direct)

    # ---- serialization ---------------------------------------------------
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["peak_flops"] = dict(self.peak_flops)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "Topology":
        d = dict(d)
        d["levels"] = tuple(MemoryLevel(**lv) for lv in d["levels"])
        d["mxu_shape"] = tuple(d["mxu_shape"])
        for menu_name in ("bm_menu", "bn_menu", "bk_menu",
                          "split_k_menu", "group_m_menu", "schedule_menu"):
            if menu_name in d:
                d[menu_name] = tuple(d[menu_name])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Topology":
        return cls.from_dict(json.loads(text))


def calibration_field_names(topo: Topology) -> Tuple[str, ...]:
    """Names ``with_calibration``/``calibrate`` accept for this topology."""
    real = tuple(f.name for f in dataclasses.fields(topo))
    return real + tuple(_LEVEL_ALIASES)


def reference_dtype(peak_flops: Mapping[str, float]) -> str:
    """The dtype the wave probe times and the fit's static-share / unit
    sizing divide by: bfloat16 when the topology has it, else the first
    known dtype in sorted order.  One shared rule so probes, fits, and the
    simulator's wave primitive can never disagree on a bf16-less chain."""
    return "bfloat16" if "bfloat16" in peak_flops else sorted(peak_flops)[0]


# Fingerprints are content hashes of immutable Topology objects, so they
# are memoized by identity (Topology holds a dict field and is therefore
# unhashable; id() plus a liveness-checked weakref is the safe key — a
# recycled id after GC fails the ``is`` check and recomputes).  The memo
# keeps the per-selection fingerprint check out of the hot memo path.
_FP_MEMO: Dict[int, Tuple] = {}


def topology_fingerprint(hw: Topology) -> str:
    """Content fingerprint of everything GEMM selection depends on — levels
    (capacities AND rates), compute rates, menus, overheads.  Deliberately
    name-blind: a ``with_calibration`` retarget keeps the preset name but
    changes the fingerprint, which is how the persistent selection table
    invalidates warm starts after recalibration and how calibrated-topology
    artifacts prove which constants a selection was made against."""
    memo = _FP_MEMO.get(id(hw))
    if memo is not None and memo[0]() is hw:
        return memo[1]
    ident = (hw.levels, hw.mxu_shape, tuple(sorted(hw.peak_flops.items())),
             hw.bm_menu, hw.bn_menu, hw.bk_menu, hw.split_k_menu,
             hw.group_m_menu, hw.schedule_menu, hw.partitions,
             hw.core_count, hw.dma_fixed, hw.kernel_launch,
             hw.pipeline_depth, hw.lane_width, hw.sublane_f32)
    fp = hashlib.md5(repr(ident).encode()).hexdigest()[:16]
    try:
        _FP_MEMO[id(hw)] = (
            weakref.ref(hw, lambda _, i=id(hw): _FP_MEMO.pop(i, None)), fp)
    except TypeError:
        pass
    return fp


# ---------------------------------------------------------------------------
# Calibrated-topology artifacts (DESIGN.md §8).
#
# A calibration run (repro.calib: probes -> fit) produces a topology whose
# measured constants replace the hand-estimated preset values, wrapped in a
# JSON document that carries full provenance: which device was probed, the
# raw probe samples, per-fit residuals, and the fingerprint of the fitted
# topology (the same fingerprint the selection cache stores per entry, so a
# served artifact invalidates stale warm starts end-to-end).
# ---------------------------------------------------------------------------

CALIBRATED_TOPOLOGY_SCHEMA = "repro/calibrated-topology/v1"


def calibrated_topology_dict(topo: Topology,
                             provenance: Optional[Mapping] = None) -> Dict:
    """The calibrated-topology artifact document (see DESIGN.md §8 for the
    schema).  ``provenance`` is free-form JSON-serializable metadata from
    the fit pipeline (device, probes, residuals, fitted fields); the
    topology fingerprint is always (re)stamped here so artifacts cannot
    carry a stale one."""
    prov = dict(provenance or {})
    prov["fingerprint"] = topology_fingerprint(topo)
    return {"schema": CALIBRATED_TOPOLOGY_SCHEMA,
            "topology": topo.to_dict(),
            "provenance": prov}


def calibrated_topology_json(topo: Topology,
                             provenance: Optional[Mapping] = None) -> str:
    return json.dumps(calibrated_topology_dict(topo, provenance),
                      indent=1, sort_keys=True)


def load_calibrated_topology(text: str) -> Tuple[Topology, Dict]:
    """Parse a calibrated-topology artifact -> (topology, provenance).

    Validates the schema tag and the provenance fingerprint against the
    recomputed fingerprint of the parsed topology — a hand-edited artifact
    whose constants no longer match its recorded fingerprint is rejected
    (it would silently defeat the selection cache's invalidation)."""
    doc = json.loads(text)
    schema = doc.get("schema")
    if schema != CALIBRATED_TOPOLOGY_SCHEMA:
        raise ValueError(
            f"not a calibrated-topology artifact: schema={schema!r}, "
            f"expected {CALIBRATED_TOPOLOGY_SCHEMA!r}")
    topo = Topology.from_dict(doc["topology"])
    prov = dict(doc.get("provenance", {}))
    recorded = prov.get("fingerprint")
    actual = topology_fingerprint(topo)
    if recorded != actual:
        raise ValueError(
            f"calibrated-topology artifact for {topo.name!r} is corrupt: "
            f"recorded fingerprint {recorded!r} != recomputed {actual!r} "
            f"(constants were edited after the fit)")
    return topo, prov


class DegradedModeWarning(UserWarning):
    """A component fell back to a degraded-but-safe mode (stock preset,
    conservative config, reference kernel) instead of raising.  Emitted as
    a structured warning so serving stacks can count/route it without
    string-matching log lines (DESIGN.md §9)."""


def quarantine_artifact(path: str) -> str:
    """Move a rejected artifact aside to a ``.quarantined`` sidecar (never
    delete evidence: the sidecar is what a post-mortem fits the fault
    from).  An existing sidecar is overwritten — the newest rejection is
    the one worth keeping."""
    sidecar = path + ".quarantined"
    os.replace(path, sidecar)
    return sidecar


def load_calibrated_topology_guarded(
    path: str,
    fallback: Topology,
    *,
    max_residual: Optional[float] = 0.5,
    quarantine: bool = True,
) -> Tuple[Topology, Dict]:
    """Fail-soft artifact loading for serving paths (DESIGN.md §9).

    :func:`load_calibrated_topology` raises on a truncated / tampered /
    wrong-schema artifact — correct for tools, fatal for a server whose
    calibration file rotted on disk.  This wrapper never raises on a bad
    artifact: the file is quarantined to a ``.quarantined`` sidecar, a
    :class:`DegradedModeWarning` is emitted, and the ``fallback`` preset
    is returned so serving continues on stock constants.

    ``max_residual`` additionally rejects artifacts whose recorded fit
    residuals (rel RMS per fitted field) exceed the threshold — a fit that
    barely described its own measurements must not silently steer every
    selection.  Pass ``None`` to skip the residual gate.

    Returns ``(topology, provenance)``; a degraded load's provenance
    carries ``degraded`` (the reason) and ``quarantined`` (sidecar path,
    or None when quarantining was disabled or impossible).
    """
    def _degrade(reason: str) -> Tuple[Topology, Dict]:
        sidecar = None
        if quarantine and os.path.exists(path):
            try:
                sidecar = quarantine_artifact(path)
            except OSError:
                pass
        warnings.warn(
            f"calibrated-topology artifact {path!r} rejected ({reason}); "
            f"serving on stock preset {fallback.name!r}"
            + (f"; artifact quarantined to {sidecar!r}" if sidecar else ""),
            DegradedModeWarning, stacklevel=3)
        return fallback, {"degraded": reason, "quarantined": sidecar}

    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        # Nothing to quarantine — the file is unreadable/absent.
        warnings.warn(
            f"calibrated-topology artifact {path!r} unreadable ({e}); "
            f"serving on stock preset {fallback.name!r}",
            DegradedModeWarning, stacklevel=2)
        return fallback, {"degraded": f"unreadable: {e}", "quarantined": None}
    try:
        topo, prov = load_calibrated_topology(text)
    except (ValueError, KeyError, TypeError) as e:
        return _degrade(str(e) or type(e).__name__)
    if max_residual is not None:
        residuals = prov.get("residuals") or {}
        worst = max(residuals.values(), default=0.0)
        if worst > max_residual:
            worst_field = max(residuals, key=residuals.get)
            return _degrade(
                f"fit residual out of tolerance: {worst_field} = "
                f"{worst:.3g} > {max_residual:.3g}")
    return topo, prov


# Backward-compatible name: the whole repo grew up calling this HardwareSpec.
HardwareSpec = Topology
