"""The analytical GEMM latency model — paper §IV, Algorithms 3-9, TPU-adapted.

The paper decomposes GEMM latency into hierarchical compute and memory stages
and scores a tiling candidate as

    L_total = waves x ( prologue + epilogue + iters x max(L_compute, L_mem) )

On TPU (see DESIGN.md §2) the same structure holds with these substitutions:

* Alg. 3  (compute latency of a shared-memory tile)  ->  MXU-atom count of a
  VMEM block, plus the VMEM<->VREG port term (the paper's "software managed
  memory bandwidth bound").
* Alg. 4  (active CUs / wave quantization)           ->  partial-block padding
  waste within a core (ceil terms) + chip-level wave quantization used by the
  distributed layer (`chip_waves`).
* Alg. 5  (cache hit rate)                           ->  two locality terms:
  the deterministic Pallas *revisit* model (the fetch into staging memory is
  skipped when a block index repeats between consecutive grid steps), plus a
  generic reuse/footprint recurrence over the topology's cache levels
  (``level_traffic``): a re-read whose reuse-window footprint fits in level
  ℓ is served from ℓ, otherwise it spills to ℓ+1 — the paper's Alg. 5-7
  cache-tile factorization.  On a 1-level chain (TPU: no cache between HBM
  and VMEM) the recurrence is inert and the model reduces bit-for-bit to
  the seed's HBM revisit model.
* Alg. 7  (memory latency of a loop iteration)       ->  per-grid-step DMA
  bytes / HBM bandwidth, plus the fixed DMA-issue cost (the "load/store issue
  rate" axis) and first-byte latency at the prologue.
* Alg. 8/9 (pipeline + total)                        ->  Pallas's grid pipeline
  is continuous across output tiles, so total = launch + fill +
  sum over grid steps of max(L_compute, L_mem) + drain.

Everything is closed-form and O(1) per candidate — this is what makes
selection O(P) instead of the autotuner's O(P·M·N·K) (paper §V-B).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dtypes import ACC_BYTES, DTYPE_BYTES
from repro_torch.core.topology import SCHEDULES, HardwareSpec, MemoryLevel, Topology


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


_ACTIVATIONS = (None, "gelu", "silu", "swiglu_gate")


@dataclass(frozen=True)
class Epilogue:
    """Post-GEMM work executed inside the kernel's accumulator flush.

    Flush-order semantics (all in the f32 accumulator, DESIGN.md §3):

        y = acc
        y = y + bias                       (bias:       (N,) operand)
        y = act(y)                         (gelu | silu)
        y = silu(y) * gate                 (swiglu_gate: (M, N) operand)
        y = y + residual                   (residual:   (M, N) operand)
        out = cast(y, out_dtype)

    Fusing these removes one full-output HBM round trip per post-op that XLA
    would otherwise run as a separate elementwise kernel — the cost model
    prices exactly that delta (``epilogue_unfused_extra_bytes``).
    """

    bias: bool = False
    activation: Optional[str] = None     # None | gelu | silu | swiglu_gate
    residual: bool = False

    def __post_init__(self):
        if self.activation not in _ACTIVATIONS:
            raise ValueError(
                f"unknown epilogue activation {self.activation!r}; "
                f"choose from {_ACTIVATIONS}")

    @property
    def is_identity(self) -> bool:
        return not (self.bias or self.activation or self.residual)

    @property
    def n_mn_operands(self) -> int:
        """Extra full (M, N) operands the flush must read (gate, residual)."""
        return int(self.activation == "swiglu_gate") + int(self.residual)

    @property
    def n_ops(self) -> int:
        """Separate XLA elementwise kernels the unfused formulation needs."""
        return (int(self.bias) + int(self.activation is not None)
                + int(self.residual))

    def __str__(self) -> str:
        if self.is_identity:
            return "none"
        parts = ([] if not self.bias else ["bias"]) \
            + ([self.activation] if self.activation else []) \
            + (["residual"] if self.residual else [])
        return "+".join(parts)


EPILOGUE_NONE = Epilogue()


@dataclass(frozen=True)
class GemmProblem:
    """C[M,N] = epilogue(A[M,K] @ B[K,N]), optionally batched (leading dim)."""

    M: int
    N: int
    K: int
    in_dtype: str = "bfloat16"
    out_dtype: str = "float32"
    batch: int = 1
    epilogue: Epilogue = EPILOGUE_NONE

    def __post_init__(self):
        if min(self.M, self.N, self.K, self.batch) < 1:
            raise ValueError(f"degenerate GEMM problem {self}")

    @property
    def flops(self) -> float:
        return 2.0 * self.batch * self.M * self.N * self.K

    @property
    def min_bytes(self) -> float:
        """Compulsory traffic: read A, B and epilogue operands once, write C
        once."""
        bi, bo = DTYPE_BYTES[self.in_dtype], DTYPE_BYTES[self.out_dtype]
        ep = self.epilogue
        e_bytes = (ep.n_mn_operands * self.M * self.N
                   + (self.N if ep.bias else 0)) * bi
        return self.batch * ((self.M * self.K + self.K * self.N) * bi
                             + self.M * self.N * bo + e_bytes)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.min_bytes


@dataclass(frozen=True, eq=False)
class ShapeBatch:
    """Column view of S GEMM problems sharing dtypes/epilogue — the batched
    problem axis ``selector.select_fast_batch`` broadcasts over.

    ``M``/``N``/``K``/``batch`` are (S, 1) int64 columns; broadcast against
    the (P,) candidate menu columns they yield (S, P) scored arrays whose
    rows are elementwise-identical to S scalar scoring passes (every int
    product stays < 2**53, so the int64 -> float64 casts inside the model
    are exact and the IEEE op order is unchanged).  Duck-types the
    ``GemmProblem`` fields the vectorized model functions read."""

    M: np.ndarray
    N: np.ndarray
    K: np.ndarray
    batch: np.ndarray
    in_dtype: str = "bfloat16"
    out_dtype: str = "float32"
    epilogue: Epilogue = EPILOGUE_NONE

    @classmethod
    def from_problems(cls, problems: Sequence["GemmProblem"]) -> "ShapeBatch":
        p0 = problems[0]
        for p in problems:
            if (p.in_dtype, p.out_dtype, p.epilogue) != \
                    (p0.in_dtype, p0.out_dtype, p0.epilogue):
                raise ValueError(
                    "ShapeBatch requires uniform dtypes/epilogue; got "
                    f"{p} vs {p0}")
        cols = np.asarray([(p.M, p.N, p.K, p.batch) for p in problems],
                          np.int64).reshape(len(problems), 4, 1)
        return cls(M=cols[:, 0], N=cols[:, 1], K=cols[:, 2],
                   batch=cols[:, 3], in_dtype=p0.in_dtype,
                   out_dtype=p0.out_dtype, epilogue=p0.epilogue)


@dataclass(frozen=True)
class TileConfig:
    """One point of the candidate space (the paper's tiling hierarchy knobs).

    bm, bn, bk: the VMEM block (paper: workgroup/shared-memory tile).
    split_k   : k-parallel partial-accumulation factor.
    group_m   : grouped grid-iteration order (paper: cache-tile factorization;
                on TPU it controls which operand the revisit-skip applies to).
    schedule  : how work units map onto cores (the occupancy stage):
                ``data_parallel`` — one unit per (output tile, k-shard),
                wave-quantized over ``Topology.total_cores()``;
                ``stream_k`` — persistent kernel, the flattened k-step space
                split into one contiguous strip per core (no tile-granular
                tail wave; strip-boundary tiles pay a partial fixup).
                On single-core chains (TPU) both schedules execute — and are
                priced — identically; the kernel lowers stream_k to the
                existing sequential split-K grid.
    """

    bm: int
    bn: int
    bk: int
    split_k: int = 1
    group_m: int = 1
    schedule: str = "data_parallel"

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {self.schedule!r}; choose from {SCHEDULES}")

    def __str__(self) -> str:
        s = f"{self.bm}x{self.bn}x{self.bk}"
        if self.split_k > 1:
            s += f"/sk{self.split_k}"
        if self.group_m > 1:
            s += f"/g{self.group_m}"
        if self.schedule == "stream_k":
            s += "/streamk"
        return s


@dataclass(frozen=True)
class LatencyBreakdown:
    """Scored candidate with the paper's bottleneck taxonomy (§IV-D)."""

    total: float                  # seconds
    compute: float                # steady-state MXU term per step (summed)
    vmem: float                   # staging<->register port term (summed)
    hbm: float                    # backing-memory DMA term (summed)
    issue: float                  # fixed DMA-issue term (summed)
    fill_drain: float             # prologue + epilogue + launch
    hbm_traffic: float            # bytes served from backing memory
    padded_flops: float           # FLOPs incl. MXU-atom padding
    bottleneck: str               # one of BOTTLENECKS (+ per-level names)
    # Per-level views (topology refactor): bytes served from each memory
    # level of the chain (backing + caches) and the summed bandwidth term
    # of each level's port.  On a 1-level chain these hold the HBM entry
    # only and `hbm`/`hbm_traffic` above are their single values.
    level_bytes: Mapping[str, float] = field(default_factory=dict)
    level_seconds: Mapping[str, float] = field(default_factory=dict)
    # Occupancy stage (Alg. 4 chip-wide): schedulable work units, waves over
    # total_cores, and the tail-wave efficiency units / (waves * cores) in
    # (0, 1].  Single-core chains report units == waves, occupancy == 1.0.
    units: int = 0
    waves: int = 0
    occupancy: float = 1.0
    # Max-plus overlap pricing (multi-core chains): seconds the output /
    # epilogue / partial-accumulator flush cursor adds after the overlapped
    # steady-state loop.  0.0 on single-core chains, where the seed's mean
    # memory-step model is retained bit-for-bit.
    flush: float = 0.0

    @property
    def efficiency(self) -> float:
        """Fraction of total spent in useful MXU compute."""
        return self.compute / self.total if self.total > 0 else 0.0


BOTTLENECKS = (
    "mxu_compute",        # paper: max-parallelism compute bound
    "vmem_bandwidth",     # paper: software-managed memory bandwidth bound
    "hbm_bandwidth",      # paper: cache/memory bandwidth bound
    "dma_issue",          # paper: load/store issue rate bound
    "pipeline_fill",      # paper: under-occupied compute bound
)
# Multi-level topologies additionally report "<level>_bandwidth" (e.g.
# "l2_bandwidth") when an intermediate cache port dominates.


def grid_shape(p: GemmProblem, t: TileConfig) -> Tuple[int, int, int]:
    """(Tm, Tn, Tk) grid; split_k multiplies Tk and divides the k extent."""
    k_per_split = cdiv(p.K, t.split_k)
    return cdiv(p.M, t.bm), cdiv(p.N, t.bn), cdiv(k_per_split, t.bk) * t.split_k


# ---------------------------------------------------------------------------
# Alg. 4 — chip-wide occupancy / wave model.
#
# The paper prices wave quantization over ALL CUs of the chip; until this
# stage the model ran one core of one partition, so GPU presets selected as
# if the chip had a single CU.  Work units are scheduled round-robin over
# ``Topology.total_cores()``: under ``data_parallel`` a unit is one
# (output tile, k-shard) — split-K multiplies units, which is exactly its
# GPU rationale — and under ``stream_k`` the flattened k-step space is cut
# into one contiguous strip per core, erasing the tile-granular tail wave
# at the cost of a partial fixup for strip-boundary tiles.
#
# The quantization factor waves * cores / units >= 1 scales every per-core
# term (MXU, staging port, DMA issue); chip-shared memory ports are not
# scaled — a tail wave leaves bandwidth idle, not busy.  On a single-core
# chain the factor is exactly 1.0, reproducing the single-core model bit-for-bit.
# ---------------------------------------------------------------------------

def wave_model(p: GemmProblem, t: TileConfig, hw: HardwareSpec,
               grid: Optional[Tuple[int, int, int]] = None
               ) -> Tuple[int, int, float]:
    """Returns (units, waves, quantization factor == waves * cores / units).

    ``data_parallel``: units = output tiles x split_k (each k-shard is an
    independently schedulable workgroup on a multi-core chip).
    ``stream_k``: units = total k-steps — occupancy is quantized at k-step
    granularity, so the factor is ~1 for any problem with >= cores steps.
    Single-core chains: units == waves, factor == 1.0 exactly.
    """
    C = hw.total_cores()
    Tm, Tn, Tk = grid or grid_shape(p, t)
    if t.schedule == "stream_k" and C > 1:
        units = Tm * Tn * Tk * p.batch
    else:
        units = Tm * Tn * p.batch * t.split_k
    waves = cdiv(units, C)
    return units, waves, waves * C / units


# ---------------------------------------------------------------------------
# Alg. 3 — compute latency of one VMEM block (per grid step).
# ---------------------------------------------------------------------------

def step_compute_latency(p: GemmProblem, t: TileConfig, hw: HardwareSpec,
                         grid: Optional[Tuple[int, int, int]] = None
                         ) -> Tuple[float, float]:
    """Returns (mxu_seconds, vmem_seconds) for one grid step.

    MXU term: the block is consumed in ceil-padded MXU atoms (Alg. 3's
    N_MI x L_MI, with L_MI expressed through peak FLOP/s).
    VMEM term: bytes the step streams through the VMEM<->VREG port — both
    input blocks once, plus the f32 accumulator read+write (the accumulator
    lives in VMEM scratch across the k loop), plus the epilogue operands
    (read once per output tile at the flush, amortized over the tile's
    k steps).
    """
    mm, mn, mk = hw.mxu_shape
    n_atoms = cdiv(t.bm, mm) * cdiv(t.bn, mn) * cdiv(t.bk, mk)
    atom_flops = 2.0 * mm * mn * mk
    mxu = n_atoms * atom_flops / hw.flops(p.in_dtype)

    bi = DTYPE_BYTES[p.in_dtype]
    in_bytes = (t.bm * t.bk + t.bk * t.bn) * bi
    acc_bytes = 2 * t.bm * t.bn * ACC_BYTES  # f32 accumulator read + write
    ep = p.epilogue
    _, _, Tk = grid or grid_shape(p, t)
    e_bytes = (ep.n_mn_operands * t.bm * t.bn
               + (t.bn if ep.bias else 0)) * bi / Tk
    vmem = (in_bytes + acc_bytes + e_bytes) / hw.vmem_bandwidth
    return mxu, vmem


# ---------------------------------------------------------------------------
# Alg. 5 adaptation — deterministic revisit/locality model.
# ---------------------------------------------------------------------------

def revisit_fractions(p: GemmProblem, t: TileConfig,
                      grid: Optional[Tuple[int, int, int]] = None
                      ) -> Tuple[float, float]:
    """Fraction of grid steps at which the (A, B) block fetch is *skipped*.

    Iteration order is (m outer, n middle, k inner) with group_m swizzling.
    Pallas skips the HBM->VMEM copy when a block index is unchanged between
    consecutive steps:

    * A block index (i_m, i_k): unchanged iff k and m both unchanged — only
      possible when Tk == 1 and we advance n within the same m.
    * B block index (i_k, i_n): unchanged iff k and n both unchanged — only
      possible when Tk == 1 and we advance m within a group (group_m > 1
      walks m innermost within a group of rows).
    """
    Tm, Tn, Tk = grid or grid_shape(p, t)
    if Tk != 1:
        return 0.0, 0.0
    if t.group_m <= 1:
        # n advances innermost: A revisited for Tn-1 of each row's Tn steps.
        a_skip = (Tn - 1) / Tn if Tn > 0 else 0.0
        return a_skip, 0.0
    # grouped: m advances innermost within groups of size group_m.
    g = min(t.group_m, Tm)
    b_skip = (g - 1) / g
    return 0.0, b_skip


def hbm_traffic(p: GemmProblem, t: TileConfig, *, revisit: bool = True,
                grid: Optional[Tuple[int, int, int]] = None) -> float:
    """Exact fetched+written bytes for the whole GEMM (the all-HBM base).

    Without revisits: A is fetched Tn times over, B Tm times over
    (the paper's "uncached reads" U, Alg. 5, with hit rate applied).
    ``revisit=False`` disables the Pallas revisit skip — on multi-core
    chains consecutive grid steps run on *different* cores, so there is no
    staging-persistence to skip into; the re-reads instead become cache-hit
    candidates (one-tile reuse windows) priced by ``level_traffic``.

    Split-K runs *in-kernel* on a single-core chain (one ``pallas_call``,
    grid ``(tiles, sk, Tk)``, k-shards accumulated in VMEM scratch, single
    flush) so it moves no HBM partials there; multi-core partial/combine
    and stream-K fixup traffic is priced by ``schedule_extra_classes``.
    Epilogue operands (bias / gate / residual) are read once per output
    tile; fused, the output is still written exactly once.
    """
    Tm, Tn, Tk = grid or grid_shape(p, t)
    bi, bo = DTYPE_BYTES[p.in_dtype], DTYPE_BYTES[p.out_dtype]
    a_skip, b_skip = (revisit_fractions(p, t, (Tm, Tn, Tk)) if revisit
                      else (0.0, 0.0))
    # Padded fetch sizes: DMA moves whole blocks (edge blocks move real bytes;
    # we model the exact edge in the simulator, the mean here).
    a_bytes = Tn * (p.M * p.K) * bi * (1.0 - a_skip)
    b_bytes = Tm * (p.K * p.N) * bi * (1.0 - b_skip)
    c_bytes = p.M * p.N * bo
    ep = p.epilogue
    e_bytes = (ep.n_mn_operands * p.M * p.N + (p.N if ep.bias else 0)) * bi
    return p.batch * (a_bytes + b_bytes + c_bytes + e_bytes)


# ---------------------------------------------------------------------------
# Alg. 5-7 generalization — per-level reuse/footprint recurrence.
#
# ``hbm_traffic`` above is the 1-level base: every fetch the revisit model
# does not skip is billed to backing memory.  On a multi-level chain, each
# *re-read* (a fetch of bytes touched before) has a deterministic reuse
# window — the bytes streamed between consecutive uses under the kernel's
# (m outer, n middle, k inner; m innermost within a group) iteration order.
# A re-read whose window fits in cache level ℓ is served from ℓ; otherwise
# it spills to the next-farther level, ultimately to backing memory.  This
# is the paper's cache-tile factorization: it prices group_m as L2 residency
# of the re-walked operand instead of a free menu entry.
#
# The recurrence is formulated as a SUBTRACTION from the all-HBM base so
# that a chain with no cache levels reproduces the seed model bit-for-bit.
# ---------------------------------------------------------------------------

def _spill_classes(p: GemmProblem, t: TileConfig, revisit: bool = True,
                   grid: Optional[Tuple[int, int, int]] = None
                   ) -> List[Tuple[float, float]]:
    """Re-read classes not absorbed by the revisit skip, per batch element.

    Returns ``(bytes, window_bytes)`` pairs.  Iteration order determines the
    windows:

    * ungrouped (g<=1): an A row-panel is re-read on each n-advance with a
      one-tile window (A panel + one B panel); a B column-panel is re-read
      on each m-advance with a full-row window (A panel + ALL B panels).
    * grouped (g>1): A re-reads see a group-pass window (g A panels + one
      B panel); B re-reads within a group see the one-tile window; B
      re-reads across groups see a full group-sweep window.

    With ``revisit=True`` (single-core chains) the classes the Pallas
    revisit model already skips (Tk == 1 cases priced by
    ``revisit_fractions``) are omitted — those fetches never leave staging.
    On multi-core chains (``revisit=False``) no fetch is skipped, so those
    classes join the recurrence with their one-tile windows (they become
    near-certain cache hits instead of free revisits).
    """
    Tm, Tn, Tk = grid or grid_shape(p, t)
    bi = DTYPE_BYTES[p.in_dtype]
    g = min(t.group_m, Tm)
    tile_window = (t.bm + t.bn) * p.K * bi
    out: List[Tuple[float, float]] = []
    if g <= 1:
        if Tn > 1 and (Tk != 1 or not revisit):
            out.append(((Tn - 1) * p.M * p.K * bi, tile_window))
        if Tm > 1:
            out.append(((Tm - 1) * p.K * p.N * bi,
                        (t.bm * p.K + p.K * p.N) * bi))
    else:
        if Tn > 1:
            out.append(((Tn - 1) * p.M * p.K * bi,
                        (g * t.bm + t.bn) * p.K * bi))
        if Tk != 1 or not revisit:
            out.append(((g - 1) / g * Tm * p.K * p.N * bi, tile_window))
        if Tm > g:
            out.append(((Tm / g - 1) * p.K * p.N * bi,
                        (g * t.bm * p.K + p.K * p.N) * bi))
    return out


def _window_scale(hw: HardwareSpec, lvl: MemoryLevel) -> float:
    """Fraction of the chip-wide reuse-window byte stream a cache *instance*
    at this level observes.  Work is scheduled partition-blocked (units
    round-robin over cores, cores blocked per partition), so a
    partition-scoped cache (the MI300X per-XCD L2) sees only its
    1/partitions share of the stream — per-partition L2 scoping.  On a
    single-core chain everything flows through one instance: scale 1.0,
    preserving the single-core recurrence bit-for-bit."""
    if hw.total_cores() == 1:
        return 1.0
    if lvl.scope == "partition":
        return 1.0 / hw.partitions
    return 1.0


def _serving_cache(window: float, hw: HardwareSpec
                   ) -> Optional[MemoryLevel]:
    """Nearest cache level whose budget covers the (scope-scaled) reuse
    window, else None (the re-read spills all the way to backing memory)."""
    for lvl in reversed(hw.cache_levels):
        if window * _window_scale(hw, lvl) <= lvl.budget():
            return lvl
    return None


def schedule_extra_classes(p: GemmProblem, t: TileConfig, hw: HardwareSpec,
                           grid: Optional[Tuple[int, int, int]] = None
                           ) -> List[Tuple[float, float]]:
    """Partial-accumulator traffic the schedule adds on multi-core chains,
    as ``(bytes, window)`` pairs for the cache recurrence (whole GEMM,
    batch included).  Empty on single-core chains — split-K is in-kernel
    there and moves no partials.

    * ``data_parallel`` with split_k > 1: a tile's k-shards run on
      different cores, so each shard writes a full f32 block partial and
      the combine re-reads all of them — 2 x split_k x padded-output
      block-bytes.  The combine runs as soon as a tile's last shard lands,
      so the footprint is the tile's split_k partials.
    * ``stream_k``: only tiles split across a strip boundary pay a partial
      write + read.  Strips are ``ceil(steps / cores)`` k-steps; a boundary
      at step ``m*q`` splits a tile iff it is not tile-aligned
      (``m*q % Tk != 0``) — counted exactly via gcd.
    """
    C = hw.total_cores()
    if C == 1:
        return []
    Tm, Tn, Tk = grid or grid_shape(p, t)
    block_acc = t.bm * t.bn * ACC_BYTES
    if t.schedule == "stream_k":
        steps = Tm * Tn * Tk * p.batch
        q = cdiv(steps, C)                       # strip length (k-steps)
        nb = cdiv(steps, q) - 1                  # interior strip boundaries
        aligned = nb // (Tk // math.gcd(q, Tk))  # boundaries at tile edges
        n_split = nb - aligned
        if n_split <= 0:
            return []
        return [(2.0 * n_split * block_acc, float(block_acc))]
    if t.split_k > 1:
        tiles = Tm * Tn * p.batch
        return [(2.0 * t.split_k * tiles * block_acc,
                 float(t.split_k * block_acc))]
    return []


def level_traffic(p: GemmProblem, t: TileConfig, hw: HardwareSpec,
                  grid: Optional[Tuple[int, int, int]] = None
                  ) -> Dict[str, float]:
    """Bytes served from each memory level (backing + caches), whole GEMM:
    the all-HBM base (revisit model on single-core chains) re-routed by the
    reuse/footprint recurrence, plus the schedule's partial/fixup traffic.

    Output writes and epilogue operand reads always go to backing memory
    (write-through; compulsory).  On a 1-level chain the single entry equals
    ``hbm_traffic`` exactly.
    """
    revisit = hw.total_cores() == 1
    served = {lvl.name: 0.0 for lvl in hw.levels[:-1]}
    base = hbm_traffic(p, t, revisit=revisit, grid=grid)
    served[hw.backing.name] = base
    if hw.cache_levels:
        for bytes_, window in _spill_classes(p, t, revisit, grid):
            lvl = _serving_cache(window, hw)
            if lvl is not None:
                b = bytes_ * p.batch
                served[lvl.name] += b
                served[hw.backing.name] -= b
        served[hw.backing.name] = max(served[hw.backing.name], 0.0)
    for bytes_, window in schedule_extra_classes(p, t, hw, grid):
        lvl = _serving_cache(window, hw) if hw.cache_levels else None
        served[lvl.name if lvl is not None else hw.backing.name] += bytes_
    return served


def level_step_seconds(hw: HardwareSpec, served: Mapping[str, float],
                       steps: float) -> Dict[str, float]:
    """Per-grid-step seconds on each level's port.  The hierarchy is
    inclusive: bytes served at level ℓ also cross every port nearer than ℓ,
    so a cache port carries its own hits plus all farther-level traffic."""
    out: Dict[str, float] = {}
    through = 0.0
    for lvl in hw.levels[:-1]:
        through += served.get(lvl.name, 0.0)
        out[lvl.name] = through / lvl.bandwidth / steps
    return out


def epilogue_unfused_extra_bytes(p: GemmProblem) -> float:
    """Extra HBM bytes when the epilogue runs as separate XLA elementwise ops
    after the GEMM instead of inside the flush (DESIGN.md §3).

    Each post-op re-reads and re-writes the full (M, N) output; gate and
    residual ops additionally read their (M, N) operand, bias its (N,) row.
    The fused kernel pays only the operand reads (already in
    ``hbm_traffic``), so the *fusion saving* is exactly this value minus the
    operand reads — i.e. 2*M*N*out_bytes per post-op.
    """
    ep = p.epilogue
    bi, bo = DTYPE_BYTES[p.in_dtype], DTYPE_BYTES[p.out_dtype]
    mn = p.batch * p.M * p.N
    extra = 2.0 * ep.n_ops * mn * bo                 # read + write per op
    extra += ep.n_mn_operands * mn * bi              # gate / residual reads
    if ep.bias:
        extra += p.batch * p.N * bi
    return extra


def reuse_fraction(p: GemmProblem, t: TileConfig,
                   hw: Optional[HardwareSpec] = None) -> float:
    """Paper Alg. 5's hit rate h in [0,1]: 1 - compulsory/actual traffic.

    Pass ``hw`` to price the traffic the selector actually used for that
    chain — the revisit skip is inert on multi-core topologies, and the
    schedule's partial/fixup bytes count as traffic there."""
    if hw is None or hw.total_cores() == 1:
        actual = hbm_traffic(p, t)
    else:
        actual = hbm_traffic(p, t, revisit=False) \
            + sum(b for b, _ in schedule_extra_classes(p, t, hw))
    return max(0.0, min(1.0, 1.0 - p.min_bytes / actual)) if actual else 0.0


# ---------------------------------------------------------------------------
# Alg. 7 — memory latency of a loop iteration (per grid step, averaged).
# ---------------------------------------------------------------------------

def step_memory_latency(p: GemmProblem, t: TileConfig, hw: HardwareSpec,
                        grid: Optional[Tuple[int, int, int]] = None
                        ) -> Tuple[Dict[str, float], float, Dict[str, float]]:
    """Returns (per-level step seconds, issue_seconds, per-level served
    bytes) averaged over grid steps.

    Output writes are folded in amortized: each (m,n) tile writes bm*bn once
    per Tk steps. The fixed DMA-issue cost is the paper's load/store
    issue-rate axis.  Memory levels pipeline against each other, so the
    effective memory-side step time is the max of the per-level entries.
    """
    Tm, Tn, Tk = grid or grid_shape(p, t)
    steps = Tm * Tn * Tk * p.batch
    served = level_traffic(p, t, hw, (Tm, Tn, Tk))
    return level_step_seconds(hw, served, steps), hw.dma_fixed, served


# ---------------------------------------------------------------------------
# Max-plus DMA/compute overlap pricing (multi-core steady state).
#
# The seed model prices the memory side of a grid step as a per-level MEAN:
# all traffic a level serves over the whole GEMM, divided by its bandwidth
# and the step count, with levels pipelining as a max over ports.  That mean
# hides the phase structure of the fetch stream: under the (m outer,
# n middle, k inner; m innermost within a group) iteration order, each
# operand's re-read alternates between a *hit phase* — the reuse window fits
# a cache, the fetch streams at that cache's bandwidth — and a *miss phase*
# at backing-memory bandwidth (the first touch of each panel).  Because the
# grid pipeline double-buffers (the DMA of block i+1 overlaps the compute of
# block i — the same discipline the event simulator prices), the steady
# state is the max-plus recurrence
#
#     t_i = max(t_{i-1} + compute, dma_done_i)
#   => step = max(compute_occ, a_step/bw_A + b_step/bw_B + issue_occ)
#
# evaluated per *phase pair* (which level serves A x which serves B) and
# mixed by the phase frequencies — NOT a single mean over the whole loop.
# The phase classes follow ``_spill_classes``; the reuse windows start from
# its sequential footprints and add the flush bytes the exact-LRU stack in
# the event simulator measures between reuses (see the window block in
# ``overlap_pipeline_arrays``):
#
#   A: hit phase on every n-advance, weight (Tn-1)/Tn, window
#      (g*bm + bn)*K*bi grouped / (bm + bn)*K*bi ungrouped; miss phase
#      (first column of each row-panel pass) weight 1/Tn at backing.
#   B: ungrouped — hit on every m-advance, weight (Tm-1)/Tm, window
#      (bm*K + K*N)*bi; grouped — in-group hit weight (g-1)/g with the
#      one-tile window, cross-group hit weight (Tm/g-1)/Tm with the
#      group-sweep window (g*bm*K + K*N)*bi; miss weight 1/Tm at backing.
#
# Output writes, epilogue operand reads and the schedule's partial/fixup
# bytes ride their own flush cursor: they overlap the fetch pipeline (a
# write posts while the next fetch streams) but their bytes still have to
# drain through their serving port, so they price as an ADDITIVE term at
# the serving level's bandwidth instead of inflating every step.
#
# Single-core chains (TPU) never enter this path — the selector keeps the
# seed's mean model bit-for-bit there (goldens pin this).
# ---------------------------------------------------------------------------

def _serve_bandwidth_arrays(hw: HardwareSpec, win) -> np.ndarray:
    """Bandwidth serving a re-read with reuse-window footprint ``win``: the
    nearest cache level whose (scope-scaled) budget covers the window, else
    backing memory — the array form of ``_serving_cache``.  Accepts scalars
    or any broadcastable window array."""
    caches = hw.cache_levels
    bw = np.full(np.shape(win), float(hw.backing.bandwidth))
    assigned = np.zeros(np.shape(win), bool)
    for li in range(len(caches) - 1, -1, -1):          # nearest cache first
        fit = ~assigned & (win * _window_scale(hw, caches[li])
                           <= caches[li].budget())
        bw = np.where(fit, caches[li].bandwidth, bw)
        assigned |= fit
    return bw


def overlap_pipeline_arrays(p, hw: HardwareSpec, Tm, Tn, bm, bn, gm, steps,
                            cs_occ, issue_occ, a_traffic, b_traffic,
                            flush_base, extra):
    """Price the multi-core steady-state grid loop with the max-plus
    DMA/compute overlap recurrence (see the block comment above).

    ``p`` supplies ``K``/``N``/``in_dtype`` and may be a scalar
    :class:`GemmProblem` or a :class:`ShapeBatch` of columns; all other
    arguments are scalars or mutually broadcastable arrays, so one helper
    serves the scalar, per-candidate-vector and (S, P)-batched scoring
    copies with elementwise-identical arithmetic.

    ``cs_occ``   — occupancy-scaled compute side max(mxu, vmem) * occ.
    ``issue_occ``— occupancy-scaled fixed DMA-issue cost per step.
    ``a_traffic``/``b_traffic`` — whole-GEMM fetched bytes per operand
    (revisit-free: nothing persists in staging across cores).
    ``flush_base`` — compulsory flush bytes (output writes + epilogue
    operand reads), always served by backing memory.
    ``extra`` — ``(bytes, window)`` pairs from ``schedule_extra_classes``
    (or its array form), flushed at their serving level's bandwidth.

    Returns ``(steps_seconds, flush_seconds)``.
    """
    bi = DTYPE_BYTES[p.in_dtype]
    K, N = p.K, p.N
    Kbi = np.asarray(K * bi, np.float64)
    KN = np.asarray(K * N, np.float64)
    g = np.minimum(np.maximum(gm, 1), Tm).astype(np.float64)
    gle1 = g <= 1
    ggt1 = ~gle1
    Tmf = np.asarray(Tm, np.float64)
    Tnf = np.asarray(Tn, np.float64)

    # Phase windows: ``_spill_classes``'s sequential-reuse footprints PLUS
    # the bytes the event simulator's exact LRU stack actually measures
    # between reuses and the seed windows omit — the output/epilogue flush
    # of every tile retired inside the window (``record_use("wb", ...)``
    # keys circulate through the same stack as the panels) and, for the
    # cross-row/cross-band B windows, the NEXT row's A panels (touched
    # before the B panel comes back around).  On the H100-like preset the
    # L2 budget sits inside the gap: a (bm=256, bn=128) sweep measures
    # ~41 MB between B reuses (spills) where the seed window said 35 MB
    # (fits), while (bm=128, bn=256) measures ~35 MB and genuinely fits —
    # the flush-blind windows priced both as hits and flipped the argmin.
    bo = DTYPE_BYTES[p.out_dtype]
    ep = p.epilogue
    wbe = float(bo + ep.n_mn_operands * bi)  # flush bytes per output element
    bias_bi = float(int(ep.bias) * bi)
    wb_tile = bm * bn * wbe + bn * bias_bi   # one tile's flush footprint
    wb_row = bm * N * wbe + N * bias_bi      # a full row-sweep (Tn tiles)
    win_a = np.where(ggt1,
                     (g * bm + bn) * Kbi + g * wb_tile,
                     (bm + bn) * Kbi + wb_tile)
    win_b1 = np.where(gle1,
                      (2.0 * bm * K + K * N) * float(bi) + wb_row,
                      (bm + bn) * Kbi + wb_tile)
    win_b2 = (2.0 * g * bm * K + KN) * bi + g * wb_row
    back_bw = float(hw.backing.bandwidth)
    # (weight, serving bandwidth) per phase; weights sum to 1 per operand.
    a_phases = (((Tnf - 1.0) / Tnf, _serve_bandwidth_arrays(hw, win_a)),
                (1.0 / Tnf, back_bw))
    b_phases = ((np.where(gle1, (Tmf - 1.0) / Tmf, (g - 1.0) / g),
                 _serve_bandwidth_arrays(hw, win_b1)),
                (np.where(gle1, 0.0, (Tmf / g - 1.0) / Tmf),
                 _serve_bandwidth_arrays(hw, win_b2)),
                (1.0 / Tmf, back_bw))
    a_ps = a_traffic / steps
    b_ps = b_traffic / steps
    body = 0.0
    for wa, bw_a in a_phases:
        for wb, bw_b in b_phases:
            body = body + wa * wb * np.maximum(
                cs_occ, a_ps / bw_a + b_ps / bw_b + issue_occ)
    flush = flush_base / back_bw
    for bytes_, win in extra:
        flush = flush + bytes_ / _serve_bandwidth_arrays(hw, win)
    return steps * body, flush


# ---------------------------------------------------------------------------
# Alg. 8 + 9 — pipeline + total latency (continuous grid pipeline).
# ---------------------------------------------------------------------------

def gemm_latency(p: GemmProblem, t: TileConfig, hw: HardwareSpec
                 ) -> LatencyBreakdown:
    grid = Tm, Tn, Tk = grid_shape(p, t)
    steps = Tm * Tn * Tk * p.batch

    mxu_s, vmem_s = step_compute_latency(p, t, hw, grid)
    level_s, issue_s, served = step_memory_latency(p, t, hw, grid)
    hbm_s = level_s[hw.backing.name]
    mem_s = max(level_s.values())

    # Alg. 4 occupancy stage: per-core terms (MXU, staging port, DMA issue)
    # pay the tail-wave quantization factor; chip-shared memory ports do
    # not.  occ == 1.0 exactly on single-core chains (single-core parity).
    units, waves, occ = wave_model(p, t, hw, grid)
    compute_side = max(mxu_s, vmem_s) * occ
    memory_side = mem_s + issue_s * occ
    l_iter = max(compute_side, memory_side)           # software pipeline

    # Prologue: first block fetch cannot be hidden (paper Alg. 8 L_prologue);
    # epilogue: final accumulator flush. Both once per *pipeline*, because the
    # Pallas grid pipeline is continuous across output tiles.
    bi, bo = DTYPE_BYTES[p.in_dtype], DTYPE_BYTES[p.out_dtype]
    prologue = hw.hbm_latency + (t.bm * t.bk + t.bk * t.bn) * bi / hw.hbm_bandwidth
    epilogue = hw.hbm_latency + t.bm * t.bn * bo / hw.hbm_bandwidth
    fill_drain = hw.kernel_launch + prologue + epilogue

    # Steady state: single-core chains keep the seed's mean memory-step
    # model bit-for-bit; multi-core chains price the loop with the max-plus
    # DMA/compute overlap recurrence plus the flush cursor.
    if hw.total_cores() > 1:
        epl = p.epilogue
        a_tr = p.batch * (Tn * (p.M * p.K) * bi)
        b_tr = p.batch * (Tm * (p.K * p.N) * bi)
        flush_base = p.batch * (p.M * p.N * bo
                                + (epl.n_mn_operands * p.M * p.N
                                   + (p.N if epl.bias else 0)) * bi)
        body, flush_s = overlap_pipeline_arrays(
            p, hw, Tm, Tn, t.bm, t.bn, t.group_m, float(steps),
            compute_side, issue_s * occ, a_tr, b_tr, flush_base,
            schedule_extra_classes(p, t, hw, grid))
        flush_s = float(flush_s)
        total = fill_drain + float(body) + flush_s
    else:
        flush_s = 0.0
        total = fill_drain + steps * l_iter

    mm, mn, mk = hw.mxu_shape
    padded_flops = (2.0 * p.batch
                    * round_up(p.M, t.bm) * round_up(p.N, t.bn)
                    * round_up(cdiv(p.K, t.split_k), t.bk) * t.split_k)
    # ^ padding waste: ceil to blocks (blocks then ceil to atoms; blocks are
    # atom-aligned by construction of the candidate space).

    level_seconds = {name: steps * s for name, s in level_s.items()}
    terms = {
        "mxu_compute": steps * mxu_s * occ,
        "vmem_bandwidth": steps * vmem_s * occ,
        "hbm_bandwidth": steps * hbm_s,
        "dma_issue": steps * issue_s * occ,
        "pipeline_fill": fill_drain,
    }
    for lvl in hw.cache_levels:
        terms[f"{lvl.name}_bandwidth"] = level_seconds[lvl.name]
    bottleneck = max(terms, key=terms.get)

    return LatencyBreakdown(
        total=total,
        compute=terms["mxu_compute"],
        vmem=terms["vmem_bandwidth"],
        hbm=terms["hbm_bandwidth"],
        issue=terms["dma_issue"],
        fill_drain=fill_drain,
        hbm_traffic=served[hw.backing.name],
        padded_flops=padded_flops,
        bottleneck=bottleneck,
        level_bytes=served,
        level_seconds=level_seconds,
        units=units,
        waves=waves,
        occupancy=units / (waves * hw.total_cores()),
        flush=flush_s,
    )


def gemm_latency_batch(problems: Sequence[GemmProblem],
                       tiles: Sequence[TileConfig], hw: HardwareSpec
                       ) -> List[LatencyBreakdown]:
    """``gemm_latency`` for S (problem, tile) pairs in one numpy pass —
    the repricing leg of ``selector.select_gemm_config_batch`` (each cold
    winner needs its full breakdown for the :class:`Selection` record).

    Problems must share dtypes and epilogue (the ``ShapeBatch`` contract).
    Every field of every returned breakdown is BIT-IDENTICAL to the scalar
    call: the (S,) int64/float64 columns run the exact elementwise IEEE op
    sequence of ``gemm_latency`` and its helpers — data-dependent branches
    become ``np.where`` selections whose taken values match the scalar
    branch, absent traffic classes contribute exact 0.0 terms, and the
    per-level serve/subtract order of ``level_traffic`` is preserved class
    by class.  ``tests/test_batch_selection.py`` pins hex-exact parity."""
    S = len(problems)
    if S == 0:
        return []
    p0 = problems[0]
    for p in problems:
        if (p.in_dtype, p.out_dtype, p.epilogue) != \
                (p0.in_dtype, p0.out_dtype, p0.epilogue):
            raise ValueError(
                f"gemm_latency_batch requires uniform dtypes/epilogue; "
                f"got {p} vs {p0}")
    cols = np.asarray(
        [(p.M, p.N, p.K, p.batch, t.bm, t.bn, t.bk, t.split_k, t.group_m,
          t.schedule == "stream_k") for p, t in zip(problems, tiles)],
        np.int64).T
    M, N, K, B, bm, bn, bk, sk, gm_ = cols[:9]
    stream = cols[9].astype(bool)
    bi, bo = DTYPE_BYTES[p0.in_dtype], DTYPE_BYTES[p0.out_dtype]
    ep = p0.epilogue
    C = hw.total_cores()

    Tm = -(-M // bm)
    Tn = -(-N // bn)
    kps = -(-K // sk)
    Tk = -(-kps // bk) * sk
    steps = Tm * Tn * Tk * B

    # step_compute_latency
    mm, mn, mk = hw.mxu_shape
    n_atoms = (-(-bm // mm)) * (-(-bn // mn)) * (-(-bk // mk))
    mxu_s = n_atoms * (2.0 * mm * mn * mk) / hw.flops(p0.in_dtype)
    in_bytes = (bm * bk + bk * bn) * bi
    acc_b = 2 * bm * bn * ACC_BYTES
    e_vmem = (ep.n_mn_operands * bm * bn
              + (bn if ep.bias else 0)) * bi / Tk
    vmem_s = (in_bytes + acc_b + e_vmem) / hw.vmem_bandwidth

    # hbm_traffic base (revisit_fractions inert on multi-core chains)
    revisit = C == 1
    if revisit:
        tk1 = Tk == 1
        gmin = np.minimum(gm_, Tm)
        a_skip = np.where(tk1 & (gm_ <= 1), (Tn - 1) / Tn, 0.0)
        b_skip = np.where(tk1 & (gm_ > 1), (gmin - 1) / gmin, 0.0)
    else:
        a_skip = b_skip = 0.0
    a_b = Tn * (M * K) * bi * (1.0 - a_skip)
    b_b = Tm * (K * N) * bi * (1.0 - b_skip)
    c_b = M * N * bo
    e_b = (ep.n_mn_operands * M * N + (N if ep.bias else 0)) * bi
    base = B * (a_b + b_b + c_b + e_b)

    # schedule extras (empty on single-core chains), as zero-padded classes
    extra: List[Tuple[np.ndarray, np.ndarray]] = []
    if C > 1:
        block_acc = (bm * bn * ACC_BYTES).astype(np.float64)
        if stream.any():
            q = -(-steps // C)
            nb = -(-steps // q) - 1
            aligned = nb // (Tk // np.gcd(q, Tk))
            n_split = np.where(stream, nb - aligned, 0)
            extra.append((2.0 * n_split * block_acc, block_acc))
        comb = (~stream) & (sk > 1)
        if comb.any():
            tiles_n = Tm * Tn * B
            extra.append((np.where(comb, 2.0 * sk * tiles_n * block_acc,
                                   0.0), sk * block_acc))

    # level_traffic: serve spill classes nearest-cache-first, subtracting
    # each served class from backing in class order (scalar op order).
    served: Dict[str, np.ndarray] = {
        lvl.name: np.zeros(S, np.float64) for lvl in hw.levels[:-1]}
    backing = hw.backing.name
    served[backing] = base + np.zeros(S, np.float64)
    caches = hw.cache_levels
    if caches:
        gsp = np.minimum(np.maximum(gm_, 1), Tm)     # _spill_classes' g
        gle1 = gsp <= 1
        ggt1 = ~gle1
        tk1s = (Tk == 1) if revisit else np.zeros(S, bool)
        MKbi = np.asarray(M * K * bi, np.float64)
        KNbi = np.asarray(K * N * bi, np.float64)
        Kbi = np.asarray(K * bi, np.float64)
        KN = np.asarray(K * N, np.float64)
        sp_a = np.where(gle1 & tk1s, 0.0, (Tn - 1) * MKbi)
        sp_a_win = np.where(ggt1, (gsp * bm + bn) * Kbi, (bm + bn) * Kbi)
        sp_b1 = np.where(gle1, (Tm - 1) * KNbi,
                         np.where(tk1s, 0.0,
                                  (gsp - 1) / gsp * Tm * K * N * bi))
        sp_b1_win = np.where(gle1, (bm * K + K * N) * float(bi),
                             (bm + bn) * Kbi)
        sp_b2 = np.where(ggt1,
                         np.maximum(Tm / gsp - 1.0, 0.0) * K * N * bi, 0.0)
        sp_b2_win = (gsp * bm * K + KN) * bi
        scales = [_window_scale(hw, lvl) for lvl in caches]
        for bytes_, win in ((sp_a * B, sp_a_win), (sp_b1 * B, sp_b1_win),
                            (sp_b2 * B, sp_b2_win)):
            assigned = np.zeros(S, bool)
            for li in range(len(caches) - 1, -1, -1):  # nearest cache first
                fit = ~assigned & (win * scales[li] <= caches[li].budget())
                served[caches[li].name] = served[caches[li].name] \
                    + np.where(fit, bytes_, 0.0)
                assigned |= fit
            served[backing] = served[backing] \
                - np.where(assigned, bytes_, 0.0)
        served[backing] = np.maximum(served[backing], 0.0)
        for bytes_, win in extra:
            assigned = np.zeros(S, bool)
            for li in range(len(caches) - 1, -1, -1):
                fit = ~assigned & (win * scales[li] <= caches[li].budget())
                served[caches[li].name] = served[caches[li].name] \
                    + np.where(fit, bytes_, 0.0)
                assigned |= fit
            served[backing] = served[backing] \
                + np.where(assigned, 0.0, bytes_)
    else:
        for bytes_, _ in extra:
            served[backing] = served[backing] + bytes_

    # level_step_seconds (inclusive hierarchy) + mem_s = max over ports
    level_s: Dict[str, np.ndarray] = {}
    through = np.zeros(S, np.float64)
    for lvl in hw.levels[:-1]:
        through = through + served[lvl.name]
        level_s[lvl.name] = through / lvl.bandwidth / steps
    hbm_s = level_s[backing]
    mem_s: Optional[np.ndarray] = None
    for v in level_s.values():
        mem_s = v if mem_s is None else np.maximum(mem_s, v)

    # wave_model + pipeline (Alg. 8/9).  On single-core chains occ == 1.0
    # exactly (units == waves), so every ``* occ`` is the float identity
    # x * 1.0 == x and can be elided bit-exactly.
    issue_s = hw.dma_fixed
    if C > 1:
        units = np.where(stream, Tm * Tn * Tk * B, Tm * Tn * B * sk)
        waves = -(-units // C)
        occ = waves * C / units
        compute_side = np.maximum(mxu_s, vmem_s) * occ
        memory_side = mem_s + issue_s * occ
    else:
        units = Tm * Tn * B * sk
        waves = units
        occ = 1.0
        compute_side = np.maximum(mxu_s, vmem_s)
        memory_side = mem_s + issue_s
    l_iter = np.maximum(compute_side, memory_side)
    prologue = hw.hbm_latency + (bm * bk + bk * bn) * bi / hw.hbm_bandwidth
    epilog = hw.hbm_latency + bm * bn * bo / hw.hbm_bandwidth
    fill_drain = hw.kernel_launch + prologue + epilog
    if C > 1:
        # Max-plus overlap steady state + flush cursor (mirrors the scalar
        # ``gemm_latency`` branch op for op — hex parity is pinned).
        pb_view = ShapeBatch(M=M, N=N, K=K, batch=B, in_dtype=p0.in_dtype,
                             out_dtype=p0.out_dtype, epilogue=ep)
        a_tr = B * (Tn * (M * K) * bi)
        b_tr = B * (Tm * (K * N) * bi)
        flush_base = B * (c_b + e_b)
        body, flush_a = overlap_pipeline_arrays(
            pb_view, hw, Tm, Tn, bm, bn, gm_, steps, compute_side,
            issue_s * occ, a_tr, b_tr, flush_base, extra)
        total = fill_drain + body + flush_a
        flush_l = np.broadcast_to(flush_a, (S,)).tolist()
    else:
        total = fill_drain + steps * l_iter
        flush_l = [0.0] * S
    padded_flops = (2.0 * B
                    * (-(-M // bm) * bm) * (-(-N // bn) * bn)
                    * (-(-(-(-K // sk)) // bk) * bk) * sk)

    # Per-row assembly: extract columns once; the bottleneck argmax is
    # vectorized (np.argmax first-max tie-break == dict-insertion-order max
    # of the scalar ``terms`` dict, built in the identical key order).
    cache_names = [lvl.name for lvl in caches]
    lvl_names = [lvl.name for lvl in hw.levels[:-1]]
    served_l = {n: served[n].tolist() for n in lvl_names}
    level_sec = {n: steps * level_s[n] for n in lvl_names}
    level_sec_l = {n: level_sec[n].tolist() for n in lvl_names}
    t_mxu_a = steps * mxu_s * occ if C > 1 else steps * mxu_s
    t_vmem_a = steps * vmem_s * occ if C > 1 else steps * vmem_s
    t_issue_a = steps * issue_s * occ if C > 1 else steps * issue_s
    term_names = ["mxu_compute", "vmem_bandwidth", "hbm_bandwidth",
                  "dma_issue", "pipeline_fill"] \
        + [f"{n}_bandwidth" for n in cache_names]
    term_cols = [t_mxu_a, t_vmem_a, level_sec[backing], t_issue_a,
                 fill_drain] + [level_sec[n] for n in cache_names]
    bot_idx = np.argmax(np.stack(term_cols), axis=0).tolist()
    t_mxu = t_mxu_a.tolist()
    t_vmem = t_vmem_a.tolist()
    t_hbm = level_sec_l[backing]
    t_issue = t_issue_a.tolist()
    fd_l = fill_drain.tolist()
    tot_l = total.tolist()
    pf_l = padded_flops.tolist()
    units_l, waves_l = units.tolist(), waves.tolist()
    occup_l = ((units / (waves * C)).tolist() if C > 1 else [1.0] * S)
    out: List[LatencyBreakdown] = []
    for i in range(S):
        out.append(LatencyBreakdown(
            total=tot_l[i],
            compute=t_mxu[i],
            vmem=t_vmem[i],
            hbm=t_hbm[i],
            issue=t_issue[i],
            fill_drain=fd_l[i],
            hbm_traffic=served_l[backing][i],
            padded_flops=pf_l[i],
            bottleneck=term_names[bot_idx[i]],
            level_bytes={n: served_l[n][i] for n in lvl_names},
            level_seconds={n: level_sec_l[n][i] for n in lvl_names},
            units=units_l[i],
            waves=waves_l[i],
            occupancy=occup_l[i],
            flush=flush_l[i],
        ))
    return out


def score_candidate(p: GemmProblem, t: TileConfig, hw: HardwareSpec) -> float:
    """Fast path of ``gemm_latency`` returning only total seconds.

    Identical arithmetic, no dataclass allocation — used to rank the whole
    candidate space in O(P) with per-candidate cost in the ~µs range (the
    paper's selection-overhead claim, Table II).

    NB: this formula exists in three hand-synced copies — here, the
    vectorized ``score_candidates``/``score_candidate_arrays`` below, and
    the static-term-cached ``selector.select_fast`` — change all three;
    parity is pinned by tests/test_selector.py."""
    bm, bn, bk = t.bm, t.bn, t.bk
    Tm = -(-p.M // bm)
    Tn = -(-p.N // bn)
    k_per_split = -(-p.K // t.split_k)
    Tk = -(-k_per_split // bk) * t.split_k
    steps = Tm * Tn * Tk * p.batch

    mm, mn, mk = hw.mxu_shape
    n_atoms = (-(-bm // mm)) * (-(-bn // mn)) * (-(-bk // mk))
    mxu_s = n_atoms * (2.0 * mm * mn * mk) / hw.flops(p.in_dtype)

    bi = DTYPE_BYTES[p.in_dtype]
    bo = DTYPE_BYTES[p.out_dtype]
    ep = p.epilogue
    n_mn, has_bias = ep.n_mn_operands, int(ep.bias)
    e_vmem = (n_mn * bm * bn + has_bias * bn) * bi / Tk
    vmem_s = ((bm * bk + bk * bn) * bi + 2.0 * ACC_BYTES * bm * bn
              + e_vmem) / hw.vmem_bandwidth

    # revisit fractions (inlined; inert on multi-core chains — consecutive
    # grid steps run on different cores, nothing persists in staging)
    revisit = hw.total_cores() == 1
    if Tk != 1 or not revisit:
        a_skip = b_skip = 0.0
    elif t.group_m <= 1:
        a_skip, b_skip = ((Tn - 1) / Tn if Tn else 0.0), 0.0
    else:
        g = min(t.group_m, Tm)
        a_skip, b_skip = 0.0, (g - 1) / g
    a_bytes = Tn * (p.M * p.K) * bi * (1.0 - a_skip)
    b_bytes = Tm * (p.K * p.N) * bi * (1.0 - b_skip)
    c_bytes = p.M * p.N * bo
    e_bytes = (n_mn * p.M * p.N + has_bias * p.N) * bi
    traffic = p.batch * (a_bytes + b_bytes + c_bytes + e_bytes)

    extra = schedule_extra_classes(p, t, hw)
    _, _, occ = wave_model(p, t, hw)
    prologue = hw.hbm_latency + (bm * bk + bk * bn) * bi / hw.hbm_bandwidth
    epilogue = hw.hbm_latency + bm * bn * bo / hw.hbm_bandwidth
    if hw.total_cores() > 1:
        # Max-plus overlap steady state + flush cursor (multi-core chains).
        body, flush = overlap_pipeline_arrays(
            p, hw, Tm, Tn, bm, bn, t.group_m, float(steps),
            max(mxu_s, vmem_s) * occ, hw.dma_fixed * occ,
            p.batch * a_bytes, p.batch * b_bytes,
            p.batch * (c_bytes + e_bytes), extra)
        return (hw.kernel_launch + prologue + epilogue
                + float(body) + float(flush))
    if hw.cache_levels:
        # reuse/footprint recurrence: cache-served re-reads leave HBM.
        absorbed: Dict[str, float] = {}
        hbm_bytes = traffic
        for bytes_, window in _spill_classes(p, t, revisit):
            lvl = _serving_cache(window, hw)
            if lvl is not None:
                served = bytes_ * p.batch
                absorbed[lvl.name] = absorbed.get(lvl.name, 0.0) + served
                hbm_bytes -= served
        hbm_bytes = max(hbm_bytes, 0.0)
        for bytes_, window in extra:
            lvl = _serving_cache(window, hw)
            if lvl is not None:
                absorbed[lvl.name] = absorbed.get(lvl.name, 0.0) + bytes_
            else:
                hbm_bytes += bytes_
        mem_s = hbm_bytes / hw.hbm_bandwidth / steps
        through = hbm_bytes
        for lvl in hw.cache_levels:
            through += absorbed.get(lvl.name, 0.0)
            mem_s = max(mem_s, through / lvl.bandwidth / steps)
    else:
        traffic += sum(b for b, _ in extra)
        mem_s = traffic / hw.hbm_bandwidth / steps
    l_iter = max(max(mxu_s, vmem_s) * occ, mem_s + hw.dma_fixed * occ)
    return hw.kernel_launch + prologue + epilogue + steps * l_iter


def _schedule_extra_arrays(p: GemmProblem, hw: HardwareSpec,
                           Tm: np.ndarray, Tn: np.ndarray, Tk: np.ndarray,
                           bm: np.ndarray, bn: np.ndarray, sk: np.ndarray,
                           sched: np.ndarray
                           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Vectorized ``schedule_extra_classes``: (bytes, window) column pairs
    for the data-parallel split-K combine and the stream-K strip fixup.
    Empty on single-core chains."""
    C = hw.total_cores()
    if C == 1:
        return []
    block_acc = (bm * bn * ACC_BYTES).astype(np.float64)
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    stream = sched == SCHEDULES.index("stream_k")
    if stream.any():
        steps_i = Tm * Tn * Tk * p.batch
        q = -(-steps_i // C)
        nb = -(-steps_i // q) - 1
        aligned = nb // (Tk // np.gcd(q, Tk))
        n_split = np.where(stream, nb - aligned, 0)
        out.append((2.0 * n_split * block_acc, block_acc))
    comb = (~stream) & (sk > 1)
    if comb.any():
        tiles = Tm * Tn * p.batch
        out.append((np.where(comb, 2.0 * sk * tiles * block_acc, 0.0),
                    sk * block_acc))
    return out


def memory_step_seconds_arrays(p: GemmProblem, hw: HardwareSpec,
                               traffic: np.ndarray, Tm: np.ndarray,
                               Tn: np.ndarray, Tk: np.ndarray,
                               bm: np.ndarray, bn: np.ndarray,
                               gm: np.ndarray, steps: np.ndarray,
                               sk: Optional[np.ndarray] = None,
                               sched: Optional[np.ndarray] = None
                               ) -> np.ndarray:
    """Vectorized memory-side step seconds over candidate column arrays:
    the per-level reuse/footprint recurrence (``_spill_classes`` +
    ``_serving_cache``) plus the schedule's partial/fixup traffic, in one
    numpy pass — shared by ``score_candidate_arrays`` and
    ``selector.select_fast``.

    ``traffic`` is the all-HBM base (revisit model applied by the caller —
    inert on multi-core chains).  ``sk``/``sched`` feed the combine/fixup
    classes; omitted they default to sk=1 data_parallel.  Chains with no
    cache level return the seed's exact expression — bit-for-bit parity on
    1-level topologies.

    ``p`` may be a scalar :class:`GemmProblem` or a :class:`ShapeBatch`
    of (S, 1) columns — with (S, P)-broadcast ``Tm``/``Tn``/... the same
    expressions score S problems in one pass, rows bit-identical to S
    scalar calls (``selector.select_fast_batch``)."""
    if sk is None:
        sk = np.ones_like(Tm)
    if sched is None:
        sched = np.zeros_like(Tm)
    extra = _schedule_extra_arrays(p, hw, Tm, Tn, Tk, bm, bn, sk, sched)
    if not hw.cache_levels:
        if extra:
            traffic = traffic + sum(b for b, _ in extra)
        return traffic / hw.hbm_bandwidth / steps
    revisit = hw.total_cores() == 1
    bi = DTYPE_BYTES[p.in_dtype]
    M, N, K = p.M, p.N, p.K
    # Shape dims may be python ints (GemmProblem) or (S, 1) int64 columns
    # (ShapeBatch).  np.asarray(..., float64) covers both and is exact for
    # either (every product < 2**53), preserving the scalar path's IEEE op
    # order bit-for-bit.
    MKbi = np.asarray(M * K * bi, np.float64)
    KNbi = np.asarray(K * N * bi, np.float64)
    Kbi = np.asarray(K * bi, np.float64)
    KN = np.asarray(K * N, np.float64)
    g = np.minimum(np.maximum(gm, 1), Tm).astype(np.float64)
    gle1 = g <= 1          # clamped, matching _spill_classes' g = min(gm, Tm)
    ggt1 = ~gle1
    # Revisit only suppresses re-read classes on single-core chains.
    tk1 = (Tk == 1) if revisit else np.zeros(np.shape(Tk), bool)
    # Re-read classes: bytes (per batch element) + reuse-window footprints,
    # mirroring _spill_classes.  Revisit-skipped classes zero out.
    a_bytes = np.where(gle1 & tk1, 0.0, (Tn - 1) * MKbi)
    a_win = np.where(ggt1, (g * bm + bn) * Kbi,
                     (bm + bn) * Kbi)
    b1_bytes = np.where(
        gle1, (Tm - 1) * KNbi,
        np.where(tk1, 0.0, (g - 1) / g * Tm * KNbi))
    b1_win = np.where(gle1, (bm * K + K * N) * float(bi),
                      (bm + bn) * Kbi)
    b2_bytes = np.where(ggt1,
                        np.maximum(Tm / g - 1.0, 0.0) * KNbi,
                        0.0)
    b2_win = (g * bm * K + KN) * bi
    caches = hw.cache_levels
    scales = [_window_scale(hw, lvl) for lvl in caches]
    absorbed: List = [0.0] * len(caches)
    # Spill classes: cache-served re-reads LEAVE the all-HBM base.
    for b, win in ((a_bytes * p.batch, a_win), (b1_bytes * p.batch, b1_win),
                   (b2_bytes * p.batch, b2_win)):
        assigned = np.zeros(np.shape(win), bool)
        for li in range(len(caches) - 1, -1, -1):      # nearest cache first
            fit = ~assigned & (win * scales[li] <= caches[li].budget())
            absorbed[li] = absorbed[li] + np.where(fit, b, 0.0)
            assigned |= fit
    hbm_bytes = np.maximum(traffic - sum(ab for ab in absorbed), 0.0)
    # Schedule extras were never in the base: ADD them at the serving level
    # (or to HBM when no cache window fits).
    for b, win in extra:
        assigned = np.zeros(np.shape(win), bool)
        for li in range(len(caches) - 1, -1, -1):
            fit = ~assigned & (win * scales[li] <= caches[li].budget())
            absorbed[li] = absorbed[li] + np.where(fit, b, 0.0)
            assigned |= fit
        hbm_bytes = hbm_bytes + np.where(assigned, 0.0, b)
    mem = hbm_bytes / hw.hbm_bandwidth
    through = hbm_bytes
    for li, lvl in enumerate(caches):
        through = through + absorbed[li]
        mem = np.maximum(mem, through / lvl.bandwidth)
    return mem / steps


def occupancy_arrays(p: GemmProblem, hw: HardwareSpec, Tm: np.ndarray,
                     Tn: np.ndarray, sk: np.ndarray,
                     sched: np.ndarray, steps_i: np.ndarray):
    """Vectorized ``wave_model`` quantization factor (waves*cores/units >= 1)
    over candidate columns.  Returns the scalar 1.0 on single-core chains so
    multiplying by it is bit-exact (single-core parity)."""
    C = hw.total_cores()
    if C == 1:
        return 1.0
    stream = sched == SCHEDULES.index("stream_k")
    units = np.where(stream, steps_i, Tm * Tn * p.batch * sk)
    waves = -(-units // C)
    return waves * C / units


def score_candidates(p: GemmProblem, tiles: Sequence[TileConfig],
                     hw: HardwareSpec) -> np.ndarray:
    """Vectorized ``score_candidate``: one numpy pass over the whole candidate
    array instead of a Python loop — this is what makes *cold* selection cheap
    (the paper's Table II selection-overhead claim; the cached path was always
    ~1 µs).  Returns total seconds per candidate, same arithmetic as the
    scalar path (float64 throughout, identical operation structure)."""
    n = len(tiles)
    bm = np.fromiter((t.bm for t in tiles), np.int64, n)
    bn = np.fromiter((t.bn for t in tiles), np.int64, n)
    bk = np.fromiter((t.bk for t in tiles), np.int64, n)
    sk = np.fromiter((t.split_k for t in tiles), np.int64, n)
    gm = np.fromiter((t.group_m for t in tiles), np.int64, n)
    sched = np.fromiter((SCHEDULES.index(t.schedule) for t in tiles),
                        np.int64, n)
    return score_candidate_arrays(p, bm, bn, bk, sk, gm, hw, sched=sched)


def score_candidate_arrays(p: GemmProblem, bm: np.ndarray, bn: np.ndarray,
                           bk: np.ndarray, sk: np.ndarray, gm: np.ndarray,
                           hw: HardwareSpec,
                           sched: Optional[np.ndarray] = None) -> np.ndarray:
    """``score_candidates`` on raw int64 column arrays (no TileConfig
    objects) — the selector's fully-vectorized cold path feeds the enumerated
    candidate columns straight in.  ``sched`` holds ``SCHEDULES`` indices
    (omitted: all data_parallel)."""
    Tm = -(-p.M // bm)
    Tn = -(-p.N // bn)
    k_per_split = -(-p.K // sk)
    Tk = -(-k_per_split // bk) * sk
    if sched is None:
        sched = np.zeros_like(bm)
    steps_i = Tm * Tn * Tk * p.batch
    steps = steps_i.astype(np.float64)

    mm, mn, mk = hw.mxu_shape
    n_atoms = (-(-bm // mm)) * (-(-bn // mn)) * (-(-bk // mk))
    mxu_s = n_atoms * (2.0 * mm * mn * mk) / hw.flops(p.in_dtype)

    bi = DTYPE_BYTES[p.in_dtype]
    bo = DTYPE_BYTES[p.out_dtype]
    ep = p.epilogue
    n_mn, has_bias = ep.n_mn_operands, int(ep.bias)
    e_vmem = (n_mn * bm * bn + has_bias * bn) * bi / Tk
    vmem_s = ((bm * bk + bk * bn) * bi + 2.0 * ACC_BYTES * bm * bn
              + e_vmem) / hw.vmem_bandwidth

    # revisit fractions (vectorized): A skipped on n-advance (ungrouped),
    # B skipped on m-advance within a group (grouped), both need Tk == 1
    # AND a single-core chain (multi-core: nothing persists in staging).
    rev = hw.total_cores() == 1
    a_skip = np.where(rev & (Tk == 1) & (gm <= 1) & (Tn > 0),
                      (Tn - 1) / np.maximum(Tn, 1), 0.0)
    g = np.minimum(gm, Tm)
    b_skip = np.where(rev & (Tk == 1) & (gm > 1),
                      (g - 1) / np.maximum(g, 1), 0.0)
    a_bytes = Tn * (p.M * p.K) * bi * (1.0 - a_skip)
    b_bytes = Tm * (p.K * p.N) * bi * (1.0 - b_skip)
    c_bytes = p.M * p.N * bo
    e_bytes = (n_mn * p.M * p.N + has_bias * p.N) * bi
    traffic = p.batch * (a_bytes + b_bytes + c_bytes + e_bytes)

    occ = occupancy_arrays(p, hw, Tm, Tn, sk, sched, steps_i)
    prologue = hw.hbm_latency + (bm * bk + bk * bn) * bi / hw.hbm_bandwidth
    epilogue = hw.hbm_latency + bm * bn * bo / hw.hbm_bandwidth
    if hw.total_cores() > 1:
        # Max-plus overlap steady state + flush cursor (multi-core chains).
        extra = _schedule_extra_arrays(p, hw, Tm, Tn, Tk, bm, bn, sk, sched)
        body, flush = overlap_pipeline_arrays(
            p, hw, Tm, Tn, bm, bn, gm, steps,
            np.maximum(mxu_s, vmem_s) * occ, hw.dma_fixed * occ,
            p.batch * a_bytes, p.batch * b_bytes,
            p.batch * (c_bytes + e_bytes), extra)
        return hw.kernel_launch + prologue + epilogue + body + flush
    mem_s = memory_step_seconds_arrays(p, hw, traffic, Tm, Tn, Tk,
                                       bm, bn, gm, steps, sk=sk, sched=sched)
    l_iter = np.maximum(np.maximum(mxu_s, vmem_s) * occ,
                        mem_s + hw.dma_fixed * occ)
    return hw.kernel_launch + prologue + epilogue + steps * l_iter


# ---------------------------------------------------------------------------
# Alg. 4 — chip-level wave quantization (used by the distributed layer).
# ---------------------------------------------------------------------------

def chip_waves(p: GemmProblem, t: TileConfig, n_chips: int
               ) -> Tuple[int, int]:
    """(active_chips_last_wave, n_waves) when output tiles are spread over
    chips — the paper's Alg. 4 verbatim, with CUs -> chips."""
    Tm, Tn, _ = grid_shape(p, t)
    tiles = Tm * Tn * p.batch
    waves = cdiv(tiles, n_chips)
    active = tiles % n_chips or n_chips
    return active, waves


def staging_working_set(t: TileConfig, in_dtype: str,
                        hw: HardwareSpec) -> int:
    """Bytes of staging memory (VMEM / LDS / SMEM) a kernel instance claims:
    pipeline_depth-buffered input blocks, plus one f32 accumulator block on
    topologies whose staging level hosts the accumulator (TPU VMEM scratch;
    GPU accumulators live in registers instead)."""
    bi = DTYPE_BYTES[in_dtype]
    inputs = hw.pipeline_depth * (t.bm * t.bk + t.bk * t.bn) * bi
    acc = t.bm * t.bn * ACC_BYTES if hw.staging.holds_accumulator else 0
    return inputs + acc


# Legacy name (the paper's LDS-capacity filter; on TPU staging == VMEM).
vmem_working_set = staging_working_set


def fits_placement(t: TileConfig, in_dtype: str, hw: HardwareSpec) -> bool:
    """The per-level capacity filter: the kernel's pinned working set must
    fit the budget of every placement level of the chain (the staging level
    plus any deeper core-scoped level).  Generalizes the seed's flat VMEM
    filter."""
    ws = staging_working_set(t, in_dtype, hw)
    return all(ws <= lvl.budget() for lvl in hw.placement_levels())
