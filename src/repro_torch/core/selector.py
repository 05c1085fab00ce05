"""Deterministic, zero-autotuning GEMM config selection (paper contribution #1).

``select_gemm_config`` enumerates the candidate tiling space — the same space
an autotuner would compile-and-benchmark — scores every candidate with the
closed-form latency model (O(1) each, so O(P) total), and returns the argmin.
Results are memoised exactly like the paper's cached selections (§V-B):
first call ~tens of µs, repeat calls ~1 µs.

The candidate space is TPU-shaped (DESIGN.md §2): block dims are MXU/lane
aligned, capped by the VMEM capacity filter (the paper's LDS filter), with
power-of-two sizes mirroring Triton's constraint noted in paper §V-C.
"""
from __future__ import annotations

import atexit
import hashlib
import itertools
import json
import os
import tempfile
import warnings
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.dtypes import ACC_BYTES, DTYPE_BYTES
from repro_torch.core.hardware import TPU_V5E
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.core.topology import (SCHEDULES, HardwareSpec, _is_pow2,
                                 topology_fingerprint)
from repro_torch.core.latency import (
    EPILOGUE_NONE,
    Epilogue,
    GemmProblem,
    LatencyBreakdown,
    ShapeBatch,
    TileConfig,
    _schedule_extra_arrays,
    cdiv,
    fits_placement,
    gemm_latency,
    gemm_latency_batch,
    grid_shape,
    memory_step_seconds_arrays,
    occupancy_arrays,
    overlap_pipeline_arrays,
    round_up,
    score_candidate,
    score_candidates,
    staging_working_set,
)
from repro_torch.core.topology import (
    DEFAULT_BK_MENU as _BK_MENU,
    DEFAULT_BM_MENU as _BM_MENU,
    DEFAULT_BN_MENU as _BN_MENU,
    DEFAULT_GROUP_M_MENU as _GROUP_M_MENU,
    DEFAULT_SPLIT_K_MENU as _SPLIT_K_MENU,
)

# Candidate block-dimension menus are per-topology (Topology.*_menu; the
# defaults above are the TPU-shaped space): bn/bk live on the lane axis; bm
# may drop to the sublane granularity for skinny-M problems (padding waste
# would otherwise dominate — the paper's tile-quantization discussion, §V-C).
# GPU-shaped presets carry finer menus sized to KB-scale staging memory.


@dataclass(frozen=True)
class Selection:
    problem: GemmProblem
    config: TileConfig
    predicted: LatencyBreakdown
    hardware: str
    n_candidates: int
    # Content fingerprint of the topology the prediction was priced against
    # (``topology_fingerprint(hw)``).  Downstream consumers — the drift
    # monitor's JSONL rows, the residual corrector's training-set grouping —
    # key on this, never on ``hardware`` (a preset *name* survives
    # recalibration unchanged and can't be validated against the live
    # topology).  Empty only for hand-built Selections in old tests.
    topo_fingerprint: str = ""

    @property
    def predicted_tflops(self) -> float:
        return self.problem.flops / self.predicted.total / 1e12

    def __str__(self) -> str:
        p, c = self.problem, self.config
        return (f"[{p.M}x{p.N}x{p.K} {p.in_dtype}] -> {c} "
                f"({self.predicted.total*1e6:.1f}us, "
                f"{self.predicted_tflops:.1f} TF/s, "
                f"bound={self.predicted.bottleneck})")


def candidate_tiles(
    p: GemmProblem,
    hw: HardwareSpec = TPU_V5E,
    *,
    allow_split_k: bool = True,
    allow_grouping: bool = True,
) -> List[TileConfig]:
    """Enumerate the legal candidate space for one problem.

    Filters (in order):
      1. alignment — bm multiple of the dtype sublane, bn/bk of the lane width;
      2. usefulness — a block dim at most one menu step beyond the padded
         problem dim (bigger is pure padding waste);
      3. per-level capacity — the pipeline-buffered working set fits the
         budget of every placement level of the topology's chain (the
         paper's LDS filter; on TPU this is the seed's VMEM filter);
      4. model-equivalence pruning — on 1-level chains group_m only changes
         behaviour when the revisit model can trigger (Tk == 1); on
         multi-level chains grouped swizzle is priced via L2 residency, so
         it stays in the space for any Tk.  split_k only while the chip is
         under-occupied: the wave model prices sk>1 as pure combine cost
         once base tiles exceed ~2x total cores (on single-core chains the
         seed's fill/drain threshold of 16), keeping P near the paper's
         50-150.  stream_k enters only on multi-core chains with sk == 1
         (it subsumes split-K; on one core it is the identical twin of the
         sequential grid).

    NB: on a single-core chain (TPU) the in-kernel split-K moves no HBM
    partials and the model scores sk>1 as never better than its sk=1 twin —
    selection returns sk=1 there; on multi-core chains the Alg. 4 wave
    model restores split-K's occupancy rationale and it competes on merit
    (DESIGN.md §2-§3).
    """
    sub = hw.sublane(p.in_dtype)
    lane = hw.lane_width
    priced_grouping = bool(hw.cache_levels)
    n_cores = hw.total_cores()
    sk_gate = 16 if n_cores == 1 else max(16, 2 * n_cores)

    def useful(menu: Sequence[int], extent: int, align: int) -> List[int]:
        padded = round_up(extent, align)
        keep = [m for m in menu if m % align == 0]
        # smallest menu entry >= padded extent, plus everything below it
        cut = next((m for m in keep if m >= padded), keep[-1])
        return [m for m in keep if m <= cut]

    bms = useful(hw.bm_menu, p.M, sub)
    bns = useful(hw.bn_menu, p.N, lane)
    bks = useful(hw.bk_menu, p.K, lane)
    sks = hw.split_k_menu if allow_split_k else (1,)
    gms = hw.group_m_menu if allow_grouping else (1,)

    out: List[TileConfig] = []
    for bm, bn, bk in itertools.product(bms, bns, bks):
        base_tiles = cdiv(p.M, bm) * cdiv(p.N, bn) * p.batch
        tk = cdiv(p.K, bk)
        for sk in sks:
            if sk > 1 and (cdiv(p.K, sk) < bk or base_tiles >= sk_gate):
                continue                  # split finer than a block / no need
            for gm in gms:
                if gm > 1 and cdiv(p.M, bm) < 2:
                    continue              # nothing to group
                if gm > 1 and tk != 1 and not priced_grouping:
                    continue              # revisit can't trigger -> identical
                for sched in hw.schedule_menu:
                    if sched == "stream_k" and (n_cores == 1 or sk > 1):
                        continue          # identical twin / subsumed
                    t = TileConfig(bm=bm, bn=bn, bk=bk, split_k=sk,
                                   group_m=gm, schedule=sched)
                    if not fits_placement(t, p.in_dtype, hw):
                        continue
                    out.append(t)
    return out


_GRID_CACHE: Dict[Tuple, Tuple[np.ndarray, ...]] = {}


def _grid_identity(hw: HardwareSpec) -> Tuple:
    """The Topology fields the cached menu grid bakes in.  Keying on these
    (not just hw.name) keeps same-named ``with_calibration`` retargets from
    reusing a stale candidate filter; MemoryLevel is frozen so the levels
    tuple hashes."""
    return (hw.name, hw.levels, hw.bm_menu, hw.bn_menu, hw.bk_menu,
            hw.split_k_menu, hw.group_m_menu, hw.schedule_menu,
            hw.partitions, hw.core_count, hw.pipeline_depth,
            hw.lane_width, hw.sublane_f32)


def _menu_grid(hw: HardwareSpec, in_dtype: str) -> Tuple[np.ndarray, ...]:
    """Static part of the candidate space for (hardware, dtype): the full
    lexicographic (bm, bn, bk, sk, gm, sched) menu grid plus the
    problem-independent alignment + per-level-capacity + schedule keep-mask.
    Cached — cold selection only pays for the problem-dependent masks and
    the scoring pass."""
    key = (_grid_identity(hw), in_dtype)
    hit = _GRID_CACHE.get(key)
    if hit is not None:
        return hit
    sched_codes = np.asarray([SCHEDULES.index(s) for s in hw.schedule_menu],
                             np.int64)
    bm, bn, bk, sk, gm, sched = (g.ravel() for g in np.meshgrid(
        np.asarray(hw.bm_menu, np.int64), np.asarray(hw.bn_menu, np.int64),
        np.asarray(hw.bk_menu, np.int64),
        np.asarray(hw.split_k_menu, np.int64),
        np.asarray(hw.group_m_menu, np.int64),
        sched_codes, indexing="ij"))
    sub, lane = hw.sublane(in_dtype), hw.lane_width
    bi = DTYPE_BYTES[in_dtype]
    static_keep = (bm % sub == 0) & (bn % lane == 0) & (bk % lane == 0)
    # Per-level capacity filter (vectorized fits_placement).
    acc = bm * bn * ACC_BYTES if hw.staging.holds_accumulator else 0
    working_set = hw.pipeline_depth * (bm * bk + bk * bn) * bi + acc
    for lvl in hw.placement_levels():
        static_keep &= working_set <= lvl.budget()
    # stream_k: multi-core chains only, and only with sk == 1 (it subsumes
    # split-K); on one core it is the identical twin of the sequential grid.
    stream = sched == SCHEDULES.index("stream_k")
    static_keep &= ~(stream & ((sk > 1) | (hw.total_cores() == 1)))
    # All menu entries are powers of two: ceil-divs become shifts, and the
    # split-K / grouping gate masks are grid-static (int64 floordiv is the
    # single most expensive numpy op on the cold path).
    shifts = tuple(np.log2(c).astype(np.int64) for c in (bm, bn, bk, sk))
    masks = (sk > 1, gm > 1, gm <= 1)
    out = (bm, bn, bk, sk, gm, sched, static_keep, shifts, masks)
    _GRID_CACHE[key] = out
    return out


def _menu_cut(menu: Sequence[int], extent: int, align: int) -> int:
    """Largest useful menu entry: the smallest aligned entry >= the padded
    extent (anything above is pure padding waste) — ``useful``'s cut."""
    padded = round_up(extent, align)
    keep = [m for m in menu if m % align == 0]
    return next((m for m in keep if m >= padded), keep[-1])


def _keep_mask(p: GemmProblem, hw: HardwareSpec, allow_split_k: bool,
               allow_grouping: bool) -> np.ndarray:
    """Problem-dependent candidate filter over the full menu grid —
    candidate_tiles' usefulness / split-K / grouping rules, vectorized."""
    (bm, bn, bk, sk, gm, sched, static_keep,
     (bm_sh, bn_sh, bk_sh, sk_sh), (sk_gt1, gm_gt1, _)) = \
        _menu_grid(hw, p.in_dtype)
    sub = hw.sublane(p.in_dtype)
    lane = hw.lane_width
    n_cores = hw.total_cores()
    sk_gate = 16 if n_cores == 1 else max(16, 2 * n_cores)

    keep = static_keep \
        & (bm <= _menu_cut(hw.bm_menu, p.M, sub)) \
        & (bn <= _menu_cut(hw.bn_menu, p.N, lane)) \
        & (bk <= _menu_cut(hw.bk_menu, p.K, lane))
    if not allow_split_k:
        keep = keep & ~sk_gt1
    if not allow_grouping:
        keep = keep & ~gm_gt1

    Tm = (p.M - 1 + bm) >> bm_sh                       # cdiv via shift
    Tn = (p.N - 1 + bn) >> bn_sh
    keep = keep & ~(sk_gt1 & ((((p.K - 1 + sk) >> sk_sh) < bk)
                              | (Tm * Tn * p.batch >= sk_gate)))
    if hw.cache_levels:
        # grouped swizzle is priced (L2 residency) -> keep for any Tk
        keep = keep & ~(gm_gt1 & (Tm < 2))
    else:
        keep = keep & ~(gm_gt1 & ((((p.K - 1 + bk) >> bk_sh) != 1)
                                  | (Tm < 2)))
    return keep


def candidate_arrays(
    p: GemmProblem,
    hw: HardwareSpec = TPU_V5E,
    *,
    allow_split_k: bool = True,
    allow_grouping: bool = True,
) -> Tuple[np.ndarray, ...]:
    """``candidate_tiles`` fully vectorized: returns (bm, bn, bk, split_k,
    group_m, schedule) int64 column arrays (schedule as ``SCHEDULES``
    indices) with the SAME filters and the SAME enumeration order, without
    materializing TileConfig objects — the cold selection path builds only
    the winning config."""
    bm, bn, bk, sk, gm, sched = _menu_grid(hw, p.in_dtype)[:6]
    keep = _keep_mask(p, hw, allow_split_k, allow_grouping)
    return bm[keep], bn[keep], bk[keep], sk[keep], gm[keep], sched[keep]


_STATIC_TERMS: Dict[Tuple, Tuple[np.ndarray, ...]] = {}


def _static_score_terms(hw: HardwareSpec, in_dtype: str,
                        out_dtype: str) -> Tuple[np.ndarray, ...]:
    """Score terms over the full menu grid that don't depend on the problem
    shape: MXU step seconds, the VMEM-port step seconds base, bm*bn, and the
    launch+prologue+epilogue fill/drain seconds.  Cached per (hardware,
    dtypes) — the cold path computes only shape-dependent terms."""
    key = (_grid_identity(hw), in_dtype, out_dtype,
           hw.mxu_shape, hw.flops(in_dtype), hw.kernel_launch)
    hit = _STATIC_TERMS.get(key)
    if hit is not None:
        return hit
    bm, bn, bk = _menu_grid(hw, in_dtype)[:3]
    bi, bo = DTYPE_BYTES[in_dtype], DTYPE_BYTES[out_dtype]
    mm, mn, mk = hw.mxu_shape
    n_atoms = (-(-bm // mm)) * (-(-bn // mn)) * (-(-bk // mk))
    mxu_s = n_atoms * (2.0 * mm * mn * mk) / hw.flops(in_dtype)
    ab_bi = (bm * bk + bk * bn) * bi
    bmn = bm * bn
    vmem_base_s = (ab_bi + 2.0 * ACC_BYTES * bmn) / hw.vmem_bandwidth
    fill_drain = (hw.kernel_launch + 2 * hw.hbm_latency
                  + ab_bi / hw.hbm_bandwidth + bmn * bo / hw.hbm_bandwidth)
    vols = bmn * bk
    out = (mxu_s, vmem_base_s, bmn, fill_drain, vols)
    _STATIC_TERMS[key] = out
    return out


def select_fast(p: GemmProblem, hw: HardwareSpec, *,
                allow_split_k: bool = True,
                allow_grouping: bool = True) -> Tuple[TileConfig, int]:
    """The fully-vectorized cold selection: one numpy pass over the menu grid
    (static terms cached) -> (winning TileConfig, n_candidates).  Same
    model arithmetic as ``score_candidate`` and the same argmin/tie-break as
    the sequential scoring loop.

    NB: the scoring formula is deliberately inlined here (third copy, after
    ``score_candidate`` and ``score_candidate_arrays``) so the static
    per-(hw, dtypes) terms and shift-based ceil-divs can be cached — a model
    change must touch all three; ``tests/test_selector.py`` pins their
    pairwise parity."""
    (bm, bn, bk, sk, gm, sched, _,
     (bm_sh, bn_sh, bk_sh, sk_sh), (_, gm_gt1, gm_le1)) = \
        _menu_grid(hw, p.in_dtype)
    mxu_s, vmem_base_s, bmn, fill_drain, vols = _static_score_terms(
        hw, p.in_dtype, p.out_dtype)
    keep = _keep_mask(p, hw, allow_split_k, allow_grouping)
    n_cands = int(np.count_nonzero(keep))
    if n_cands == 0:
        raise ValueError(f"empty candidate space for {p} on {hw.name}")

    bi, bo = DTYPE_BYTES[p.in_dtype], DTYPE_BYTES[p.out_dtype]
    Tm = (p.M - 1 + bm) >> bm_sh                       # cdiv via shift
    Tn = (p.N - 1 + bn) >> bn_sh
    k_per_split = (p.K - 1 + sk) >> sk_sh
    Tk = ((k_per_split - 1 + bk) >> bk_sh) << sk_sh
    steps = Tm * Tn * Tk * p.batch

    ep = p.epilogue
    if ep.is_identity:
        vmem_s = vmem_base_s
        ce_bytes = float(p.M * p.N * bo)
    else:
        vmem_s = vmem_base_s + (ep.n_mn_operands * bmn
                                + int(ep.bias) * bn) * bi / Tk \
            / hw.vmem_bandwidth
        ce_bytes = float(p.M * p.N * bo
                         + (ep.n_mn_operands * p.M * p.N
                            + int(ep.bias) * p.N) * bi)

    rev = hw.total_cores() == 1
    tk1 = (Tk == 1) if rev else np.zeros(np.shape(Tk), bool)
    a_skip = (tk1 & gm_le1) * ((Tn - 1) / Tn)
    g = np.minimum(gm, Tm)
    b_skip = (tk1 & gm_gt1) * ((g - 1) / g)
    a_bytes = Tn * float(p.M * p.K * bi) * (1.0 - a_skip)
    b_bytes = Tm * float(p.K * p.N * bi) * (1.0 - b_skip)
    traffic = p.batch * (a_bytes + b_bytes + ce_bytes)

    occ = occupancy_arrays(p, hw, Tm, Tn, sk, sched, steps)
    if hw.total_cores() > 1:
        # Max-plus overlap steady state + flush cursor (multi-core chains).
        extra = _schedule_extra_arrays(p, hw, Tm, Tn, Tk, bm, bn, sk, sched)
        body, flush = overlap_pipeline_arrays(
            p, hw, Tm, Tn, bm, bn, gm, steps,
            np.maximum(mxu_s, vmem_s) * occ, hw.dma_fixed * occ,
            p.batch * a_bytes, p.batch * b_bytes, p.batch * ce_bytes, extra)
        scores = np.where(keep, fill_drain + body + flush, np.inf)
    else:
        mem_s = memory_step_seconds_arrays(p, hw, traffic, Tm, Tn, Tk,
                                           bm, bn, gm, steps,
                                           sk=sk, sched=sched)
        l_iter = np.maximum(np.maximum(mxu_s, vmem_s) * occ,
                            mem_s + hw.dma_fixed * occ)
        scores = np.where(keep, fill_drain + steps * l_iter, np.inf)
    idx = np.flatnonzero(scores <= scores.min() + 1e-15)
    i = int(idx[np.argmax(vols[idx])])
    return TileConfig(bm=int(bm[i]), bn=int(bn[i]), bk=int(bk[i]),
                      split_k=int(sk[i]), group_m=int(gm[i]),
                      schedule=SCHEDULES[int(sched[i])]), n_cands


_ALIGNED_MENUS: Dict[Tuple[Tuple[int, ...], int], Optional[np.ndarray]] = {}
_PRUNED_COLS: Dict[Tuple, Tuple[np.ndarray, ...]] = {}


def _cut_col(menu: Sequence[int], ext: np.ndarray, align: int) -> np.ndarray:
    """Vectorized ``_menu_cut`` over an (S, 1) extent column: binary-search
    the (cached) aligned ascending menu for the smallest entry >= the padded
    extent, clamping to the largest.  Falls back to the scalar scan when the
    aligned menu is not strictly ascending (the scan is order-sensitive)."""
    mkey = (tuple(menu), align)
    arr = _ALIGNED_MENUS.get(mkey, False)
    if arr is False:
        a = np.asarray([m for m in menu if m % align == 0], np.int64)
        arr = a if a.size > 1 and bool((a[1:] > a[:-1]).all()) else None
        _ALIGNED_MENUS[mkey] = arr
    if arr is not None:
        padded = (-(-ext // align)) * align
        i = np.minimum(np.searchsorted(arr, padded[:, 0]), arr.size - 1)
        return arr[i][:, None]
    return np.asarray([_menu_cut(menu, int(e), align)
                       for e in ext[:, 0]], np.int64)[:, None]


def select_fast_batch(problems: Sequence[GemmProblem], hw: HardwareSpec, *,
                      allow_split_k: bool = True,
                      allow_grouping: bool = True,
                      ) -> List[Tuple[TileConfig, int]]:
    """``select_fast`` for S problems in ONE numpy pass: the shapes stack as
    an (S, 1) column axis against the cached (P,) menu grid, so every model
    expression broadcasts to (S, P) and the whole sweep costs one scoring
    pass instead of S.  Problems must share dtypes and epilogue (the grid
    and the static score terms are per-(hw, dtypes)).

    Per-row results are BIT-IDENTICAL to S scalar ``select_fast`` calls:
    the int64 -> float64 casts are exact (products < 2**53) and every
    elementwise op runs in the same IEEE order as the scalar path —
    ``tests/test_batch_selection.py`` pins config + hex-exact latency
    parity.  Same argmin/volume tie-break, applied per row."""
    if not problems:
        return []
    pb = ShapeBatch.from_problems(problems)
    (bm, bn, bk, sk, gm, sched, static_keep,
     (bm_sh, bn_sh, bk_sh, sk_sh), (sk_gt1, gm_gt1, gm_le1)) = \
        _menu_grid(hw, pb.in_dtype)
    mxu_s, vmem_base_s, bmn, fill_drain, vols = _static_score_terms(
        hw, pb.in_dtype, pb.out_dtype)
    M, N, K, batch = pb.M, pb.N, pb.K, pb.batch      # (S, 1) int64 columns

    # _keep_mask, broadcast: per-row menu cuts + the split-K/grouping gates.
    sub = hw.sublane(pb.in_dtype)
    lane = hw.lane_width
    n_cores = hw.total_cores()
    sk_gate = 16 if n_cores == 1 else max(16, 2 * n_cores)
    cut_m, cut_n, cut_k = (_cut_col(hw.bm_menu, M, sub),
                           _cut_col(hw.bn_menu, N, lane),
                           _cut_col(hw.bk_menu, K, lane))
    # Column prune: a candidate failing the static mask or the UNION of the
    # per-row cuts (or a disabled sk/gm axis) has keep == False for every
    # row — drop it before broadcasting so the (S, P') temporaries stay
    # small.  Order-preserving compression: per-row counts, scores and the
    # first-max tie-break are untouched.  Cached per cut-maxima triple (a
    # handful of values — cuts are menu entries), so steady-state batches
    # skip the 15 gather passes.
    ckey = (_grid_identity(hw), pb.in_dtype, pb.out_dtype, hw.mxu_shape,
            hw.flops(pb.in_dtype), hw.kernel_launch,
            int(cut_m.max()), int(cut_n.max()), int(cut_k.max()),
            allow_split_k, allow_grouping)
    hit = _PRUNED_COLS.get(ckey)
    if hit is None:
        cols = static_keep & (bm <= ckey[6]) & (bn <= ckey[7]) \
            & (bk <= ckey[8])
        if not allow_split_k:
            cols = cols & ~sk_gt1
        if not allow_grouping:
            cols = cols & ~gm_gt1
        hit = tuple(a[cols] for a in (
            bm, bn, bk, sk, gm, sched, sk_gt1, gm_gt1, gm_le1,
            bm_sh, bn_sh, bk_sh, sk_sh, mxu_s, bmn, fill_drain, vols,
            vmem_base_s))
        _PRUNED_COLS[ckey] = hit
    (bm, bn, bk, sk, gm, sched, sk_gt1, gm_gt1, gm_le1,
     bm_sh, bn_sh, bk_sh, sk_sh, mxu_s, bmn, fill_drain, vols,
     vmem_base_s) = hit
    # The split-K / grouping gates usually resolve from row-scalar bounds:
    # every column has Tm >= cdiv(M, cut_m), so tiles_min >= sk_gate kills
    # ALL sk>1 columns of the row at once, and K > cut_k forces Tk != 1 for
    # every column (the no-cache chains' grouping gate).  A row the bounds
    # fully decide depends only on its (cut_m, cut_n, cut_k) triple, so rows
    # sharing a triple share ONE keep row; only "fine" rows — where a gate
    # needs the elementwise test — key on their full shape.  Each distinct
    # row is computed once on cheap 1-D (P',) columns; the formulas are the
    # scalar ``_keep_mask`` gates verbatim, so keep matches row for row.
    S = M.shape[0]
    sk_any, gm_any = bool(sk_gt1.any()), bool(gm_gt1.any())
    tiles_min = (-(-M // cut_m)) * (-(-N // cut_n)) * batch       # (S, 1)
    sk_kill = ((tiles_min >= sk_gate)[:, 0] if sk_any
               else np.ones(S, bool))
    if gm_any:
        gm_fine = ((M <= cut_m) if hw.cache_levels else (K <= cut_k))[:, 0]
    else:
        gm_fine = np.zeros(S, bool)
    fine = (~sk_kill) | gm_fine
    cm, cn, ck = cut_m[:, 0], cut_n[:, 0], cut_k[:, 0]
    groups: Dict[Tuple, int] = {}
    uidx: List[int] = []
    inv = np.empty(S, np.intp)
    for r in range(S):
        gk = ((int(cm[r]), int(cn[r]), int(ck[r]), int(M[r, 0]),
               int(N[r, 0]), int(K[r, 0]), int(batch[r, 0]))
              if fine[r] else (int(cm[r]), int(cn[r]), int(ck[r])))
        gi = groups.get(gk)
        if gi is None:
            gi = groups[gk] = len(uidx)
            uidx.append(r)
        inv[r] = gi
    keepg = np.empty((len(uidx), bm.size), bool)
    base_rows: Dict[Tuple[int, int, int], np.ndarray] = {}

    def _base(r: int) -> np.ndarray:
        tk_ = (int(cm[r]), int(cn[r]), int(ck[r]))
        b = base_rows.get(tk_)
        if b is None:
            b = base_rows[tk_] = (bm <= tk_[0]) & (bn <= tk_[1]) \
                & (bk <= tk_[2])
        return b

    # Coarse rows (bounds fully decide the gates) all share one extra mask.
    coarse_extra: Optional[np.ndarray] = None
    fidx: List[Tuple[int, int]] = []
    for gi, r in enumerate(uidx):
        r = int(r)
        if fine[r]:
            fidx.append((gi, r))
            continue
        row = _base(r)
        if sk_any or (gm_any and not hw.cache_levels):
            if coarse_extra is None:
                coarse_extra = np.ones(bm.size, bool)
                if sk_any:
                    coarse_extra &= ~sk_gt1
                if gm_any and not hw.cache_levels:
                    coarse_extra &= ~gm_gt1          # K > cut_k => Tk != 1
            row = row & coarse_extra
        keepg[gi] = row
    if fidx:
        # Fine rows: the elementwise gates run as ONE (F, P') broadcast —
        # same formulas as scalar ``_keep_mask``, selected per row by
        # np.where, so each row's booleans match the scalar branch taken.
        gis = [g for g, _ in fidx]
        rs = [r for _, r in fidx]
        rows = np.stack([_base(r) for r in rs])          # (F, P')
        Mf, Nf, Kf, Bf = M[rs, :], N[rs, :], K[rs, :], batch[rs, :]
        Tmr = (Mf - 1 + bm) >> bm_sh
        if sk_any:
            Tnr = (Nf - 1 + bn) >> bn_sh
            gate = sk_gt1 & ((((Kf - 1 + sk) >> sk_sh) < bk)
                             | (Tmr * Tnr * Bf >= sk_gate))
            rows &= ~np.where(sk_kill[rs][:, None], sk_gt1, gate)
        if gm_any:
            gmf = gm_fine[rs][:, None]
            if hw.cache_levels:
                # gate kills only when Tm < 2 — needs M <= cut_m to fire
                rows &= ~(gm_gt1 & (Tmr < 2) & gmf)
            else:
                gate = gm_gt1 & ((((Kf - 1 + bk) >> bk_sh) != 1)
                                 | (Tmr < 2))
                rows &= np.where(gmf, ~gate, ~gm_gt1)
        keepg[gis] = rows
    n_cands = np.count_nonzero(keepg, axis=1)[inv]
    if not n_cands.all():
        bad = problems[int(np.flatnonzero(n_cands == 0)[0])]
        raise ValueError(f"empty candidate space for {bad} on {hw.name}")

    # Second compression: score only columns some row keeps.  For large
    # shapes the split-K / grouping gates kill most of the grid for EVERY
    # row, so the expensive float64 scoring runs on a fraction of P.
    live = keepg.any(axis=0)
    if not live.all():
        bm, bn, bk, sk, gm, sched = (a[live] for a in
                                     (bm, bn, bk, sk, gm, sched))
        bm_sh, bn_sh, bk_sh, sk_sh = (a[live] for a in
                                      (bm_sh, bn_sh, bk_sh, sk_sh))
        gm_gt1, gm_le1 = gm_gt1[live], gm_le1[live]
        mxu_s, bmn, fill_drain, vols = (a[live] for a in
                                        (mxu_s, bmn, fill_drain, vols))
        vmem_base_s = vmem_base_s[live]
        keepg = keepg[:, live]
    keep = keepg[inv]                                     # (S, P_live)

    bi, bo = DTYPE_BYTES[pb.in_dtype], DTYPE_BYTES[pb.out_dtype]
    Tm = (M - 1 + bm) >> bm_sh                  # (S, P_live) cdiv via shift
    Tn = (N - 1 + bn) >> bn_sh
    if bool((sk == 1).all()):
        Tk = (K - 1 + bk) >> bk_sh       # sk == 1: split round-trip is id
    else:
        k_per_split = (K - 1 + sk) >> sk_sh
        Tk = ((k_per_split - 1 + bk) >> bk_sh) << sk_sh
    steps = Tm * Tn * Tk * batch

    ep = pb.epilogue
    if ep.is_identity:
        vmem_s = vmem_base_s
        ce_bytes = np.asarray(M * N * bo, np.float64)
    else:
        vmem_s = vmem_base_s + (ep.n_mn_operands * bmn
                                + int(ep.bias) * bn) * bi / Tk \
            / hw.vmem_bandwidth
        ce_bytes = np.asarray(M * N * bo
                              + (ep.n_mn_operands * M * N
                                 + int(ep.bias) * N) * bi, np.float64)

    MKbi = np.asarray(M * K * bi, np.float64)
    KNbi = np.asarray(K * N * bi, np.float64)
    tk1 = (Tk == 1) if n_cores == 1 else None
    if tk1 is not None and bool(tk1.any()):
        a_skip = (tk1 & gm_le1) * ((Tn - 1) / Tn)
        g = np.minimum(gm, Tm)
        b_skip = (tk1 & gm_gt1) * ((g - 1) / g)
        a_bytes = Tn * MKbi * (1.0 - a_skip)
        b_bytes = Tm * KNbi * (1.0 - b_skip)
    else:                       # skips all 0.0: x * (1.0 - 0.0) == x, elide
        a_bytes = Tn * MKbi
        b_bytes = Tm * KNbi
    traffic = batch * (a_bytes + b_bytes + ce_bytes)

    occ = occupancy_arrays(pb, hw, Tm, Tn, sk, sched, steps)
    if isinstance(occ, float):              # single-core chains: occ == 1.0
        mem_s = memory_step_seconds_arrays(pb, hw, traffic, Tm, Tn, Tk,
                                           bm, bn, gm, steps,
                                           sk=sk, sched=sched)
        l_iter = np.maximum(np.maximum(mxu_s, vmem_s),
                            mem_s + hw.dma_fixed)
        scores = np.where(keep, fill_drain + steps * l_iter, np.inf)
    else:
        # Max-plus overlap steady state + flush cursor (multi-core chains).
        extra = _schedule_extra_arrays(pb, hw, Tm, Tn, Tk, bm, bn, sk, sched)
        body, flush = overlap_pipeline_arrays(
            pb, hw, Tm, Tn, bm, bn, gm, steps,
            np.maximum(mxu_s, vmem_s) * occ, hw.dma_fixed * occ,
            batch * a_bytes, batch * b_bytes, batch * ce_bytes, extra)
        scores = np.where(keep, fill_drain + body + flush, np.inf)
    # Per-row argmin + volume tie-break: argmax returns the FIRST max, which
    # is exactly the scalar path's earliest-in-enumeration-order policy.
    smin = scores.min(axis=1, keepdims=True)
    elig = scores <= smin + 1e-15
    picks = np.argmax(np.where(elig, vols, -1), axis=1)
    return [(TileConfig(bm=a, bn=b, bk=c, split_k=d, group_m=e,
                        schedule=SCHEDULES[f]), n)
            for a, b, c, d, e, f, n in zip(
                bm[picks].tolist(), bn[picks].tolist(), bk[picks].tolist(),
                sk[picks].tolist(), gm[picks].tolist(),
                sched[picks].tolist(), n_cands.tolist())]


def rank_candidates(
    p: GemmProblem,
    hw: HardwareSpec = TPU_V5E,
    **kwargs,
) -> List[Tuple[TileConfig, LatencyBreakdown]]:
    """Score the whole space, best first. Deterministic tie-break: prefer the
    larger block (less issue overhead), then lexicographic config order."""
    cands = candidate_tiles(p, hw, **kwargs)
    scored = [(t, gemm_latency(p, t, hw)) for t in cands]
    scored.sort(key=lambda it: (it[1].total,
                                -(it[0].bm * it[0].bn * it[0].bk),
                                it[0].bm, it[0].bn, it[0].bk,
                                it[0].split_k, it[0].group_m,
                                it[0].schedule))
    return scored


# ---------------------------------------------------------------------------
# Fail-soft selection validation + fallback ladder (DESIGN.md §9).
#
# A Selection reaching a kernel launch may be wrong in ways the happy path
# never produces: a corrupted cache entry rehydrated into nonsense dims, a
# memo poisoned by a buggy hook, a config whose placement no longer fits a
# recalibrated topology.  ``validate_selection`` re-checks the invariants
# the selector guarantees by construction; ``fallback_ladder`` yields the
# deterministic downgrade sequence the launch layer (kernels/ops.py) walks
# when a validated config still fails to compile or launch.
# ---------------------------------------------------------------------------


def validate_selection(p: GemmProblem, t: TileConfig,
                       hw: HardwareSpec) -> Optional[str]:
    """Re-validate a config against the invariants every selector-produced
    candidate satisfies by construction.  Returns a reason string when the
    config must not be launched, None when it is safe."""
    for name, v in (("bm", t.bm), ("bn", t.bn), ("bk", t.bk),
                    ("split_k", t.split_k), ("group_m", t.group_m)):
        if not isinstance(v, int) or not _is_pow2(v):
            return f"{name}={v!r} is not a positive power of two"
    if t.schedule not in SCHEDULES:
        return f"schedule {t.schedule!r} not in {SCHEDULES}"
    if t.bm % hw.sublane(p.in_dtype) or t.bn % hw.lane_width \
            or t.bk % hw.lane_width:
        return (f"{t} misaligned for {p.in_dtype} on {hw.name} "
                f"(sublane {hw.sublane(p.in_dtype)}, lane {hw.lane_width})")
    if not fits_placement(t, p.in_dtype, hw):
        return f"{t} exceeds a placement-level budget on {hw.name}"
    lat = gemm_latency(p, t, hw)
    if not np.isfinite(lat.total) or lat.total <= 0.0:
        return f"{t} prices to a non-finite/non-positive latency on {hw.name}"
    return None


def safe_config(p: GemmProblem, hw: HardwareSpec = TPU_V5E) -> TileConfig:
    """The conservative rung of the fallback ladder: the smallest aligned
    entry of every menu, no split-K, no grouping, the sequential schedule —
    the minimum-working-set config, guaranteed to fit placement whenever
    *any* candidate does."""
    sub, lane = hw.sublane(p.in_dtype), hw.lane_width
    bm = min((m for m in hw.bm_menu if m % sub == 0), default=sub)
    bn = min((m for m in hw.bn_menu if m % lane == 0), default=lane)
    bk = min((m for m in hw.bk_menu if m % lane == 0), default=lane)
    return TileConfig(bm=bm, bn=bn, bk=bk, split_k=1, group_m=1,
                      schedule="data_parallel")


def fallback_ladder(p: GemmProblem, hw: HardwareSpec,
                    primary: TileConfig,
                    ) -> Iterator[Tuple["Selection", str]]:
    """The deterministic downgrade sequence after ``primary`` failed to
    validate or launch: the next-ranked candidate under the model, then
    the conservative :func:`safe_config`.  (The final reference-kernel
    rung is the launch layer's, not a TileConfig.)  Lazily ranks the
    space — the happy path never pays for it."""
    def _sel(t: TileConfig, n: int) -> "Selection":
        return Selection(problem=p, config=t,
                         predicted=gemm_latency(p, t, hw),
                         hardware=hw.name, n_candidates=n,
                         topo_fingerprint=topology_fingerprint(hw))

    tried = [primary]
    ranked = rank_candidates(p, hw)
    nxt = next((t for t, _ in ranked if t not in tried), None)
    if nxt is not None:
        tried.append(nxt)
        yield _sel(nxt, len(ranked)), "next"
    safe = safe_config(p, hw)
    if safe not in tried:
        yield _sel(safe, len(ranked)), "safe"


_CACHE: Dict[Tuple, Selection] = {}

# ---------------------------------------------------------------------------
# Persistent on-disk selection table.  When REPRO_SELECTION_CACHE names a
# JSON file (or load_selection_cache is called with a path), selections
# survive process boundaries: a warm-started server pays zero cold-path
# scoring for every shape any previous process already selected.  Entries
# store only the winning config — rehydration reprices it with the O(1)
# closed-form model, so a stale file can never smuggle in a stale latency.
# ---------------------------------------------------------------------------

_DISK_ENV = "REPRO_SELECTION_CACHE"
_disk_table: Optional[Dict[str, Dict]] = None
_disk_path: Optional[str] = None


def _key_str(key: Tuple) -> str:
    """Deterministic JSON key for a selection cache key (repr is stable:
    ints, strs, bools and the frozen Epilogue dataclass)."""
    return repr(key)


# Persisted with each disk entry so a recalibrated same-name topology
# invalidates the old selections instead of warm-starting from them.  The
# fingerprint function itself lives in core/topology.py (the calibration
# subsystem stamps it into calibrated-topology artifacts); this alias is
# the historical in-module name.
_topo_fingerprint = topology_fingerprint


# ---------------------------------------------------------------------------
# Selection observability hooks (calibration subsystem, DESIGN.md §8).
#
# The oracle/fidelity harness and the calibration tests need to observe
# *where* each selection came from — fresh cold scoring ("cold"), the
# persistent disk table ("disk"), the in-process memo ("memo"), or a
# fail-soft ladder step ("fallback:<rung>", kernels/ops.py) — to prove
# end-to-end that e.g. a recalibrated topology really re-scored instead
# of warm-starting stale configs, and that every degraded launch is
# observable.  A hook that raises is logged and skipped: observability
# must never abort selection (DESIGN.md §9).
# ---------------------------------------------------------------------------

_SELECTION_HOOKS: List[Callable[["Selection", str], None]] = []


def add_selection_hook(fn: Callable[["Selection", str], None]) -> None:
    """Register ``fn(selection, source)``; source in {memo, disk, cold}
    or ``fallback:<rung>`` for fail-soft ladder steps."""
    _SELECTION_HOOKS.append(fn)


def remove_selection_hook(fn: Callable[["Selection", str], None]) -> None:
    _SELECTION_HOOKS.remove(fn)


def _emit_selection(sel: "Selection", source: str) -> None:
    # Telemetry first (DESIGN.md §11): one gated counter per source and —
    # when a tracer is installed — the full selection record as a trace
    # event, including the winning LatencyBreakdown's per-level views.
    obs_metrics.inc("selections_total", labels={"source": source})
    if obs_trace.tracing_enabled():
        p, c, bd = sel.problem, sel.config, sel.predicted
        obs_trace.event(
            "select_gemm_config", cat="selection", track="selection",
            args={"source": source,
                  "shape": [p.M, p.N, p.K, p.batch],
                  "dtype": p.in_dtype,
                  "config": {"bm": c.bm, "bn": c.bn, "bk": c.bk,
                             "split_k": c.split_k, "group_m": c.group_m,
                             "schedule": c.schedule},
                  "n_candidates": sel.n_candidates,
                  "predicted_s": bd.total,
                  "bottleneck": bd.bottleneck,
                  "level_bytes": dict(bd.level_bytes),
                  "level_seconds": dict(bd.level_seconds)})
    for fn in list(_SELECTION_HOOKS):
        try:
            fn(sel, source)
        except Exception as e:                      # noqa: BLE001
            hook_name = getattr(fn, "__name__", str(fn))
            obs_metrics.inc("selection_hook_errors",
                            labels={"hook": hook_name})
            warnings.warn(
                f"selection hook {hook_name!r} raised "
                f"{e!r} on source {source!r}; hook skipped",
                RuntimeWarning, stacklevel=2)


def emit_fallback(sel: "Selection", rung: str) -> None:
    """Report a fail-soft ladder step (``kernels/ops.py``) through the
    selection hooks as source ``fallback:<rung>``; rung in
    {next, safe, reference}."""
    _emit_selection(sel, f"fallback:{rung}")


# ---------------------------------------------------------------------------
# Learned residual corrector — opt-in post-ranking stage (DESIGN.md §12).
#
# The analytical model stays the interpretable prior: with no corrector
# installed every code path above/below is untouched and selections are
# bit-identical.  With one installed (``repro.calib.residual`` fits it on
# the drift stream; core only duck-types it), the scalar path re-prices the
# top-F analytically-ranked candidates with ``corrector.correct(...)`` and
# takes the argmin over the corrected totals — the vectorized menu pass
# still does ALL the enumeration/filter/ranking work, the corrector touches
# F ≈ 8 finalists.  Residual selections memoise under a separate namespace
# (keyed by the corrector's own content fingerprint) and NEVER touch the
# persistent disk table, so analytical warm-starts can't be poisoned by a
# since-retired corrector.  A corrector whose topology fingerprint does not
# match the live topology is ignored (counted metric), exactly like a
# stale calibrated-topology artifact.
# ---------------------------------------------------------------------------

_RESIDUAL = None        # duck-typed: .fingerprint, .content_fingerprint(),
#                         .top_f, .correct(problem, configs, totals, hw)


def set_residual_corrector(res) -> object:
    """Install (or with None remove) the process-wide residual corrector;
    returns the previous one.  Duck-typed — calib owns the implementation,
    core never imports it."""
    global _RESIDUAL
    prev = _RESIDUAL
    _RESIDUAL = res
    return prev


def get_residual_corrector():
    return _RESIDUAL


def _residual_for(hw: HardwareSpec, fp: str):
    """The installed corrector iff it was fit for THIS topology's content
    fingerprint; a mismatch (recalibrated topology, wrong preset) is
    counted and the selection falls back to the pure analytical path."""
    res = _RESIDUAL
    if res is None:
        return None
    if getattr(res, "fingerprint", None) != fp:
        obs_metrics.inc("residual_fingerprint_mismatch",
                        labels={"hardware": hw.name})
        return None
    return res


def select_topk(
    p: GemmProblem,
    hw: HardwareSpec = TPU_V5E,
    k: int = 8,
    *,
    allow_split_k: bool = True,
    allow_grouping: bool = True,
) -> Tuple[List[TileConfig], np.ndarray, int]:
    """The top-``k`` candidates under the analytical model: (configs,
    their predicted totals, total candidate count).  Element 0 is exactly
    the config ``select_fast`` would return (same 1e-15 tie tolerance, same
    max-volume tie-break); the rest follow in (score, -volume, enumeration
    order) rank.  This is the residual corrector's re-pricing slate."""
    cands = candidate_tiles(p, hw, allow_split_k=allow_split_k,
                            allow_grouping=allow_grouping)
    if not cands:
        raise ValueError(f"empty candidate space for {p} on {hw.name}")
    n = len(cands)
    scores = score_candidates(p, cands, hw)
    bm = np.fromiter((t.bm for t in cands), np.int64, n)
    bn = np.fromiter((t.bn for t in cands), np.int64, n)
    bk = np.fromiter((t.bk for t in cands), np.int64, n)
    win = _argmin_index(scores, bm, bn, bk)
    # Rank by (score, -volume, enumeration order); hoist the tie-broken
    # winner to the front so corrected-argmin guards can reference it.
    order = np.lexsort((np.arange(n), -(bm * bn * bk), scores))
    head = [win] + [int(i) for i in order[:k] if int(i) != win]
    idx = head[:max(int(k), 1)]
    return [cands[i] for i in idx], scores[idx], n


def _select_residual(M: int, N: int, K: int, *, in_dtype: str,
                     out_dtype: str, batch: int, ep: Epilogue,
                     hw: HardwareSpec, fp: str, res, key: Tuple,
                     allow_split_k: bool, allow_grouping: bool,
                     ) -> "Selection":
    """The corrector-on scalar selection: memoised under a residual
    namespace, never persisted to disk, emitted as source ``residual``.
    ``predicted`` stays the analytical breakdown of the chosen config —
    drift rows keep measuring the model, not the corrector."""
    memo_key = key + (fp, "residual", res.content_fingerprint())
    hit = _CACHE.get(memo_key)
    if hit is not None:
        _emit_selection(hit, "memo")
        return hit
    p = GemmProblem(M=M, N=N, K=K, in_dtype=in_dtype,
                    out_dtype=out_dtype, batch=batch, epilogue=ep)
    top_f = int(getattr(res, "top_f", 8))
    configs, totals, n_cands = select_topk(
        p, hw, top_f, allow_split_k=allow_split_k,
        allow_grouping=allow_grouping)
    corrected = np.asarray(res.correct(p, configs, totals, hw), np.float64)
    # Switch away from the analytical winner (index 0) only when the
    # corrected advantage clears the corrector's margin — an uncertain
    # residual must not churn selections the model already got right.
    margin = float(getattr(res, "switch_margin", 0.0))
    j = int(np.argmin(corrected))
    if j != 0 and not corrected[j] < corrected[0] * (1.0 - margin):
        j = 0
    best = configs[j]
    sel = Selection(problem=p, config=best,
                    predicted=gemm_latency(p, best, hw),
                    hardware=hw.name, n_candidates=n_cands,
                    topo_fingerprint=fp)
    _CACHE[memo_key] = sel
    _emit_selection(sel, "residual")
    return sel


def load_selection_cache(path: Optional[str] = None) -> int:
    """Load (or re-load) the persistent selection table.  ``path`` resolves
    exactly like ``save_selection_cache``'s: the explicit argument, else the
    path of the last programmatic load, else ``$REPRO_SELECTION_CACHE``.
    (A bare re-load after ``load_selection_cache("/x.json")`` used to
    silently DEACTIVATE persistence when the env var was unset — even
    though save still honored the remembered path.)  With none of the
    three set, persistence deactivates; use ``unload_selection_cache`` to
    deactivate explicitly.  Returns the number of entries available for
    warm-starting."""
    global _disk_table, _disk_path
    path = path or _disk_path or os.environ.get(_DISK_ENV)
    if not path:
        _disk_table, _disk_path = None, None
        return 0
    try:
        with open(path) as f:
            table = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        table = {}
    _disk_table, _disk_path = table, path
    return len(table)


def unload_selection_cache() -> None:
    """Deactivate disk persistence: drop the in-memory disk table AND the
    remembered path.  (Since ``load_selection_cache`` resolves a bare call
    through the remembered path, this is the explicit off switch tests and
    benchmarks need after unsetting ``$REPRO_SELECTION_CACHE``.)"""
    global _disk_table, _disk_path
    _disk_table, _disk_path = None, None


def save_selection_cache(path: Optional[str] = None) -> Optional[str]:
    """Atomically write the in-memory disk table, merged over whatever is
    on disk (so concurrent processes sharing the path accumulate entries
    instead of clobbering each other; ours win on key collisions —
    selections are deterministic, so collisions agree anyway).  Returns the
    path written (None when persistence is inactive)."""
    global _disk_table
    path = path or _disk_path or os.environ.get(_DISK_ENV)
    if not path or _disk_table is None:
        return None
    try:
        with open(path) as f:
            merged = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        merged = {}
    merged.update(_disk_table)
    _disk_table = merged
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _disk_lookup(key: Tuple) -> Optional[Dict]:
    global _disk_table
    if _disk_table is None:
        if not os.environ.get(_DISK_ENV):
            return None
        load_selection_cache()
    if _disk_table is None:
        return None
    return _disk_table.get(_key_str(key))


_FLUSH_EVERY = 32
_atexit_registered = False


def _disk_entry(sel: Selection, hw: HardwareSpec) -> Dict:
    """The persisted form of one selection: winning config + candidate count
    + the topology content fingerprint that invalidates it on recalibration
    (rehydration reprices the latency, so it is never stored)."""
    c = sel.config
    return {
        "config": {"bm": c.bm, "bn": c.bn, "bk": c.bk,
                   "split_k": c.split_k, "group_m": c.group_m,
                   "schedule": c.schedule},
        "n_candidates": sel.n_candidates,
        "topo": _topo_fingerprint(hw),
    }


def _register_atexit_flush() -> None:
    global _atexit_registered
    if not _atexit_registered:
        atexit.register(save_selection_cache)
        _atexit_registered = True


def _disk_record(key: Tuple, sel: Selection, hw: HardwareSpec) -> None:
    """Record a fresh selection.  Flushes eagerly while the table is small
    (a restarted server becomes durable immediately) and every
    ``_FLUSH_EVERY`` entries thereafter — a cold sweep of N shapes pays
    O(N/32) file rewrites, not O(N); an atexit flush catches the tail."""
    if _disk_table is None:
        return
    _disk_table[_key_str(key)] = _disk_entry(sel, hw)
    _register_atexit_flush()
    n = len(_disk_table)
    if n <= _FLUSH_EVERY or n % _FLUSH_EVERY == 0:
        save_selection_cache()


def _disk_record_bulk(items: Sequence[Tuple[Tuple, Selection]],
                      hw: HardwareSpec) -> None:
    """Record N fresh selections with ONE atomic merge-on-write flush —
    the batched cold path's durability step.  N scalar ``_disk_record``
    calls pay up to N read-merge-rewrite cycles while the table is small;
    here the whole batch lands in the in-memory table first and a single
    ``save_selection_cache`` merges it over whatever concurrent writers
    put on disk meanwhile (same last-writer-wins-per-key semantics —
    selections are deterministic, so collisions agree)."""
    if _disk_table is None or not items:
        return
    for key, sel in items:
        _disk_table[_key_str(key)] = _disk_entry(sel, hw)
    _register_atexit_flush()
    save_selection_cache()


def _argmin_index(scores: np.ndarray, bm: np.ndarray, bn: np.ndarray,
                  bk: np.ndarray) -> int:
    """Deterministic tie-break: within 1e-15 s of the minimum prefer the
    larger block volume (less issue overhead), then the earliest candidate in
    enumeration order — the same policy the scalar scoring loop applied."""
    idx = np.flatnonzero(scores <= scores.min() + 1e-15)
    vols = bm[idx] * bn[idx] * bk[idx]
    return int(idx[np.argmax(vols)])


def argmin_candidate(p: GemmProblem, cands: Sequence[TileConfig],
                     hw: HardwareSpec) -> TileConfig:
    """Vectorized argmin over an explicit candidate list."""
    scores = score_candidates(p, cands, hw)
    n = len(cands)
    bm = np.fromiter((t.bm for t in cands), np.int64, n)
    bn = np.fromiter((t.bn for t in cands), np.int64, n)
    bk = np.fromiter((t.bk for t in cands), np.int64, n)
    return cands[_argmin_index(scores, bm, bn, bk)]


def select_gemm_config(
    M: int,
    N: int,
    K: int,
    *,
    in_dtype: str = "bfloat16",
    out_dtype: str = "float32",
    batch: int = 1,
    epilogue: Optional[Epilogue] = None,
    hw: HardwareSpec = TPU_V5E,
    allow_split_k: bool = True,
    allow_grouping: bool = True,
) -> Selection:
    """The paper's API: problem shape in, near-optimal TileConfig out.

    Zero autotuning. Deterministic. Memoised per (problem, hardware).
    ``epilogue`` prices the fused flush work (extra operand reads) so
    candidates are ranked against the *fused* traffic."""
    ep = epilogue or EPILOGUE_NONE
    key = (M, N, K, in_dtype, out_dtype, batch, ep, hw.name,
           allow_split_k, allow_grouping)
    # The in-process memo carries the content fingerprint on top of the
    # disk key: a calibrated topology served under its preset name in the
    # SAME process must cold-rescore, exactly like the disk table's
    # per-entry fingerprint forces across processes.  The fingerprint is
    # identity-memoized on the Topology, so a memo hit stays O(1).
    fp = topology_fingerprint(hw)
    res = _residual_for(hw, fp)
    if res is not None:
        return _select_residual(M, N, K, in_dtype=in_dtype,
                                out_dtype=out_dtype, batch=batch, ep=ep,
                                hw=hw, fp=fp, res=res, key=key,
                                allow_split_k=allow_split_k,
                                allow_grouping=allow_grouping)
    memo_key = key + (fp,)
    hit = _CACHE.get(memo_key)
    if hit is not None:
        _emit_selection(hit, "memo")
        return hit

    p = GemmProblem(M=M, N=N, K=K, in_dtype=in_dtype,
                    out_dtype=out_dtype, batch=batch, epilogue=ep)
    sel = _rehydrate_disk_entry(p, key, hw)
    if sel is not None:
        _CACHE[memo_key] = sel
        _emit_selection(sel, "disk")
        return sel
    # Fast O(P) scoring pass (Table II claim): enumeration, filtering and
    # scoring are all one numpy batch — only the winning TileConfig is ever
    # materialized; full latency breakdown for the winner only.
    best, n_cands = select_fast(p, hw, allow_split_k=allow_split_k,
                                allow_grouping=allow_grouping)
    sel = Selection(problem=p, config=best, predicted=gemm_latency(p, best, hw),
                    hardware=hw.name, n_candidates=n_cands,
                    topo_fingerprint=fp)
    _CACHE[memo_key] = sel
    _disk_record(key, sel, hw)
    _emit_selection(sel, "cold")
    return sel


def _rehydrate_disk_entry(p: GemmProblem, key: Tuple,
                          hw: HardwareSpec) -> Optional[Selection]:
    """Warm start from the persistent table: the winning config persisted by
    a previous process, repriced O(1) — no enumeration, no scoring pass.
    A missing/malformed entry, one recorded under different topology
    constants (the key carries hw.name, the entry a content fingerprint —
    recalibration changes the argmin), or one whose config fails the
    selection invariants (placement budget, alignment, power-of-two dims —
    a tampered-but-parseable cache entry) returns None and the caller falls
    through to cold scoring."""
    entry = _disk_lookup(key)
    if entry is None:
        return None
    try:
        best = TileConfig(**entry["config"])
        n_cands = int(entry["n_candidates"])
        legal = (entry.get("topo") == _topo_fingerprint(hw)
                 and validate_selection(p, best, hw) is None)
    except (KeyError, TypeError, ValueError):
        legal = False
    if not legal:
        return None
    return Selection(problem=p, config=best,
                     predicted=gemm_latency(p, best, hw),
                     hardware=hw.name, n_candidates=n_cands,
                     topo_fingerprint=_topo_fingerprint(hw))


def select_gemm_config_batch(
    shapes: Sequence[Sequence[int]],
    *,
    in_dtype: str = "bfloat16",
    out_dtype: str = "float32",
    batch: int = 1,
    epilogue: Optional[Epilogue] = None,
    hw: HardwareSpec = TPU_V5E,
    allow_split_k: bool = True,
    allow_grouping: bool = True,
) -> List[Selection]:
    """``select_gemm_config`` for many shapes at once — the serving warm-up
    / bucket-pricing entry point.  ``shapes`` is a sequence of ``(M, N, K)``
    or ``(M, N, K, batch)`` tuples sharing dtypes and epilogue.

    Per-shape results are bit-identical to S scalar calls (config AND
    latency — ``select_fast_batch`` broadcasts the same float64 arithmetic).
    The difference is cost, not output: memo/disk hits resolve per shape as
    usual (hooks fire with the same sources), and ALL cold shapes share one
    (S, P) scoring pass plus one bulk merge-on-write disk flush instead of
    S passes and up to S file rewrites.  Duplicate cold shapes are scored
    once and share the resulting Selection (one "cold" hook emission)."""
    ep = epilogue or EPILOGUE_NONE
    fp = topology_fingerprint(hw)
    if _residual_for(hw, fp) is not None:
        # Corrector-on batches route through the scalar path: the residual
        # re-prices per-shape finalists anyway, and the scalar memo
        # namespace keeps hit/miss telemetry consistent with it.
        return [select_gemm_config(int(s[0]), int(s[1]), int(s[2]),
                                   in_dtype=in_dtype, out_dtype=out_dtype,
                                   batch=int(s[3]) if len(s) > 3 else batch,
                                   epilogue=ep, hw=hw,
                                   allow_split_k=allow_split_k,
                                   allow_grouping=allow_grouping)
                for s in shapes]
    out: List[Optional[Selection]] = [None] * len(shapes)
    cold: Dict[Tuple, List[int]] = {}      # key -> indices awaiting scoring
    cold_probs: Dict[Tuple, GemmProblem] = {}
    # One availability probe for the whole batch: ``_disk_lookup`` would
    # re-check the environment per shape only to return None every time.
    disk_on = _disk_table is not None or bool(os.environ.get(_DISK_ENV))
    for i, s in enumerate(shapes):
        M, N, K = int(s[0]), int(s[1]), int(s[2])
        b = int(s[3]) if len(s) > 3 else batch
        key = (M, N, K, in_dtype, out_dtype, b, ep, hw.name,
               allow_split_k, allow_grouping)
        memo_key = key + (fp,)
        hit = _CACHE.get(memo_key)
        if hit is not None:
            _emit_selection(hit, "memo")
            out[i] = hit
            continue
        if key in cold:                    # duplicate cold shape: share it
            cold[key].append(i)
            continue
        p = GemmProblem(M=M, N=N, K=K, in_dtype=in_dtype,
                        out_dtype=out_dtype, batch=b, epilogue=ep)
        sel = _rehydrate_disk_entry(p, key, hw) if disk_on else None
        if sel is not None:
            _CACHE[memo_key] = sel
            _emit_selection(sel, "disk")
            out[i] = sel
            continue
        cold[key] = [i]
        cold_probs[key] = p
    if cold:
        keys = list(cold)
        results = select_fast_batch(
            [cold_probs[k] for k in keys], hw,
            allow_split_k=allow_split_k, allow_grouping=allow_grouping)
        records: List[Tuple[Tuple, Selection]] = []
        breakdowns = gemm_latency_batch(
            [cold_probs[k] for k in keys], [r[0] for r in results], hw)
        for key, (best, n_cands), bd in zip(keys, results, breakdowns):
            p = cold_probs[key]
            sel = Selection(problem=p, config=best, predicted=bd,
                            hardware=hw.name, n_candidates=n_cands,
                            topo_fingerprint=fp)
            _CACHE[key + (fp,)] = sel
            records.append((key, sel))
            for i in cold[key]:
                out[i] = sel
            _emit_selection(sel, "cold")
        _disk_record_bulk(records, hw)
    return out  # type: ignore[return-value]


def clear_selection_cache() -> None:
    _CACHE.clear()


def selection_cache_size() -> int:
    return len(_CACHE)
