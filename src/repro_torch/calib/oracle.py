"""Exhaustive-autotune oracle: the model-fidelity harness (DESIGN.md §8).

The paper's headline claim is that analytical selection reaches >95% of
exhaustive-autotune performance with zero tuning time.  This module
measures that number: for every shape of a sweep it prices the FULL
candidate menu on a :class:`~repro_torch.calib.device.Device` (wall clock on real
hardware, the event simulator through :class:`VirtualDevice` in CI),
records the empirical argmin, and reports the fraction of that optimum the
analytical selection achieves — per preset x shape, with the oracle's rank
under the model as the diagnostic for *why* a miss happened (rank 1 with
fidelity < 1 means a pricing gap between model and device, not a ranking
error).

``fidelity_report`` is the Fig.-style artifact entry point: CSV + markdown
+ JSON under ``experiments/calib/``, registered in ``benchmarks/run.py``
(smoke: scaled-down shapes; the full llama3 sweep is the
``calibration-smoke`` CI job's artifact and the slow nightly's assertion).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.calib.device import Device, VirtualDevice
from repro_torch.core.latency import (GemmProblem, TileConfig, grid_shape,
                                score_candidates, step_compute_latency,
                                wave_model)
from repro_torch.core.selector import candidate_tiles, select_gemm_config
from repro_torch.core.hardware import PRESETS, get_hardware
from repro_torch.core.topology import Topology

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "experiments", "calib")


@dataclass(frozen=True)
class OracleRow:
    """One (preset, shape) cell of the fidelity report."""

    hw: str
    gemm: str
    M: int
    N: int
    K: int
    n_candidates: int
    selected: str            # analytical selection
    oracle: str              # empirical argmin over the same space
    selected_s: float
    oracle_s: float
    fidelity: float          # oracle_s / selected_s  (<= 1.0)
    oracle_model_rank: int   # 1 == model also ranked the oracle first
    # Residual-corrected selection (DESIGN.md §12) — populated only when a
    # corrector was passed to fidelity_row; appended at the END of as_list
    # so existing column indices stay valid.
    corrected: str = ""
    corrected_s: float = 0.0
    corrected_fidelity: float = 0.0

    def as_list(self) -> List:
        out = [self.hw, self.gemm, self.M, self.N, self.K,
               self.n_candidates, self.selected, self.oracle,
               f"{self.selected_s:.6e}", f"{self.oracle_s:.6e}",
               f"{self.fidelity:.4f}", self.oracle_model_rank]
        if self.corrected:
            out += [self.corrected, f"{self.corrected_s:.6e}",
                    f"{self.corrected_fidelity:.4f}"]
        return out


def _compute_lower_bound(p: GemmProblem, t: TileConfig,
                         hw: Topology) -> float:
    """Admissible per-candidate lower bound on any execution of this
    config: launch + (grid steps on the fullest core) x the per-step
    compute floor.  Every grid step occupies its core for at least the
    compute time of one staged block (the simulator's per-step
    ``max(ct, fetch)`` respects this by construction; on real hardware it
    is the roofline compute bound), so a candidate whose bound already
    exceeds the incumbent's measured time cannot be the argmin — the
    pruned exhaustive search stays exact while skipping the tiny-tile
    candidates that are both hopeless and slowest to price."""
    mxu_s, vmem_s = step_compute_latency(p, t, hw)
    Tm, Tn, Tk = grid_shape(p, t)
    steps = Tm * Tn * Tk * p.batch
    _, _, occ = wave_model(p, t, hw)
    # fullest core runs steps*occ/C grid steps, each costing at least the
    # per-core compute floor C*max(mxu, vmem) — the C's cancel.
    return (hw.kernel_launch + hw.hbm_latency
            + steps * occ * max(mxu_s, vmem_s))


def oracle_best(p: GemmProblem, hw: Topology, device: Device,
                candidates: Sequence[TileConfig], *,
                prune: bool = True,
                order: Optional[Sequence[int]] = None,
                ) -> Tuple[TileConfig, float, int]:
    """Price candidates on the device; return (argmin config, its seconds,
    number of candidates pruned by the compute lower bound).

    ``prune`` skips candidates whose :func:`_compute_lower_bound` exceeds
    the incumbent best — exact under the simulator's conventions; pass
    ``prune=False`` to force a fully measured sweep (e.g. wall-clock
    devices where even an admissible analytic bound is unwanted).
    ``order`` visits candidates in the given index order (best model rank
    first makes the bound bite immediately).

    Measurements that are non-finite, non-positive (a NaN-poisoned or
    sign-flipped timer would otherwise *win* the argmin), or that raise a
    runtime error are skipped — the oracle reports the best candidate the
    device measured honestly (DESIGN.md §9).

    An unpruned sweep on a device exposing ``gemm_time_batch`` (the
    vectorized simulator behind :class:`VirtualDevice`) prices the whole
    menu in one batched pass — same per-candidate seconds, same
    argmin/tie-break order (first strict improvement in visit order) —
    which is what makes the nightly full-menu sweep affordable.  Fault-
    injecting or wall-clock devices don't expose it and keep the scalar
    loop."""
    if not candidates:
        raise ValueError("oracle_best: empty candidate menu")
    best_t, best_s = None, float("inf")
    pruned = 0
    idxs = order if order is not None else range(len(candidates))
    if not prune and hasattr(device, "gemm_time_batch"):
        try:
            times = device.gemm_time_batch(p, candidates)
        except RuntimeError:
            times = None
        if times is not None:
            for i in idxs:
                s = times[i]
                if not np.isfinite(s) or s <= 0.0:
                    continue
                if s < best_s:
                    best_t, best_s = candidates[i], s
            return best_t, best_s, 0
    for i in idxs:
        t = candidates[i]
        if prune and best_t is not None \
                and _compute_lower_bound(p, t, hw) >= best_s:
            pruned += 1
            continue
        try:
            s = device.gemm_time(p, t)
        except RuntimeError:
            continue
        if not np.isfinite(s) or s <= 0.0:
            continue
        if s < best_s:
            best_t, best_s = t, s
    return best_t, best_s, pruned


def fidelity_row(hw: Topology, name: str, M: int, N: int, K: int,
                 device: Device, prune: bool = True,
                 residual=None) -> OracleRow:
    """One (preset, shape) fidelity cell.  ``residual`` (a
    :class:`~repro_torch.calib.residual.ResidualCorrector`) additionally prices
    the corrector's pick over the same space — the corrected column is
    evaluated WITHOUT installing the corrector process-wide, so the
    analytical columns (and the goldens they pin) are untouched."""
    p = GemmProblem(M=M, N=N, K=K)
    cands = candidate_tiles(p, hw)
    sel = select_gemm_config(M, N, K, hw=hw)
    scores = score_candidates(p, cands, hw)
    order = list(np.argsort(scores, kind="stable"))
    best_t, best_s, _ = oracle_best(p, hw, device, cands,
                                    prune=prune, order=order)
    sel_s = device.gemm_time(p, sel.config)
    if best_t is None:
        # Every candidate measurement was poisoned/raised: degrade to the
        # analytical selection as its own oracle rather than crash.
        best_t, best_s = sel.config, sel_s
    # Where did the model rank the device's true optimum?
    oracle_i = cands.index(best_t)
    rank = 1 + int(np.sum(scores < scores[oracle_i]))
    corrected, corr_s, corr_fid = "", 0.0, 0.0
    if residual is not None:
        from repro_torch.calib.residual import residual_pick
        pick, _ = residual_pick(residual, p, hw)
        corr_s = device.gemm_time(p, pick)
        corrected = str(pick)
        corr_fid = best_s / corr_s if corr_s else 0.0
    return OracleRow(
        hw=hw.name, gemm=name, M=M, N=N, K=K, n_candidates=len(cands),
        selected=str(sel.config), oracle=str(best_t),
        selected_s=sel_s, oracle_s=best_s,
        fidelity=best_s / sel_s if sel_s else 0.0,
        oracle_model_rank=rank,
        corrected=corrected, corrected_s=corr_s,
        corrected_fidelity=corr_fid)


def scaled_llama3_shapes(sizes: Sequence[str] = ("8b",),
                         tokens: Sequence[int] = (1024,),
                         scale: int = 1) -> List[Tuple[str, int, int, int]]:
    """The llama3 key-GEMM sweep, optionally divided by ``scale`` (rounded
    to the 128-lane grain) — the smoke-size knob for CI."""
    from repro_torch.configs.llama3_shapes import llama3_gemms

    def sc(d: int) -> int:
        return max(128, int(round(d / scale / 128)) * 128)

    out = []
    for size in sizes:
        for (name, M, N, K) in llama3_gemms(size, tuple(tokens)):
            out.append((name if scale == 1 else f"{name}/s{scale}",
                        sc(M), sc(N), sc(K)))
    return out


def fidelity_sweep(hw: Topology, device: Device,
                   shapes: Sequence[Tuple[str, int, int, int]],
                   verbose: bool = False,
                   prune: bool = True,
                   residual=None) -> List[OracleRow]:
    rows = []
    for (name, M, N, K) in shapes:
        row = fidelity_row(hw, name, M, N, K, device, prune=prune,
                           residual=residual)
        rows.append(row)
        if verbose:
            print(f"  [{hw.name}] {name}: fidelity {row.fidelity:.4f} "
                  f"(oracle rank {row.oracle_model_rank}/"
                  f"{row.n_candidates})")
    return rows


def fidelity_report(presets: Sequence[str] = tuple(PRESETS),
                    sizes: Sequence[str] = ("8b",),
                    tokens: Sequence[int] = (1024,),
                    scale: int = 1,
                    devices: Optional[Dict[str, Device]] = None,
                    out_dir: str = OUT_DIR,
                    verbose: bool = True,
                    prune: bool = False,
                    residuals: Optional[Dict] = None) -> Dict:
    """The paper-style fidelity table: % of exhaustive-oracle performance
    achieved by analytical selection, per preset over the llama3 sweep.

    ``devices`` maps preset name -> measuring device; omitted presets get
    the simulator-backed virtual device (the CI path).  The default is the
    FULL unpruned sweep — every candidate priced, through the batched
    simulator pass where the device supports it; ``prune=True`` restores
    the lower-bound-pruned search (handy on slow wall-clock devices, where
    the admissible bound skips hopeless candidates).  Artifacts:
    ``fidelity_report.{json,csv,md}`` in ``out_dir``.

    ``residuals`` maps preset name -> fitted
    :class:`~repro_torch.calib.residual.ResidualCorrector`; presets present in
    the map get the residual-corrected columns (and summary stats)
    alongside the analytical ones."""
    devices = devices or {}
    residuals = residuals or {}
    shapes = scaled_llama3_shapes(sizes, tokens, scale)
    report: Dict = {"scale": scale, "sizes": list(sizes),
                    "tokens": list(tokens), "prune": prune,
                    "presets": {}, "rows": []}
    t0 = time.perf_counter()
    for preset in presets:
        hw = get_hardware(preset)
        device = devices.get(preset) or VirtualDevice(hw)
        res = residuals.get(preset)
        rows = fidelity_sweep(hw, device, shapes, verbose=verbose,
                              prune=prune, residual=res)
        fids = [r.fidelity for r in rows]
        report["presets"][preset] = {
            "device": device.name,
            "n": len(rows),
            "mean_fidelity": sum(fids) / len(fids),
            "worst_fidelity": min(fids),
            "at_95pct": sum(f >= 0.95 for f in fids),
            "oracle_rank1": sum(r.oracle_model_rank == 1 for r in rows),
        }
        if res is not None:
            cfids = [r.corrected_fidelity for r in rows]
            report["presets"][preset].update({
                "mean_corrected_fidelity": sum(cfids) / len(cfids),
                "worst_corrected_fidelity": min(cfids),
            })
        report["rows"] += [r.as_list() for r in rows]
        if verbose:
            s = report["presets"][preset]
            print(f"[oracle:{preset}] mean {100*s['mean_fidelity']:.2f}% "
                  f"worst {100*s['worst_fidelity']:.2f}% of oracle, "
                  f"{s['at_95pct']}/{s['n']} shapes >= 95%, "
                  f"model ranked the oracle first on "
                  f"{s['oracle_rank1']}/{s['n']}")
    report["elapsed_s"] = round(time.perf_counter() - t0, 2)

    os.makedirs(out_dir, exist_ok=True)
    header = ["hw", "gemm", "M", "N", "K", "n_candidates", "selected",
              "oracle", "selected_s", "oracle_s", "fidelity",
              "oracle_model_rank"]
    if residuals:
        header += ["corrected", "corrected_s", "corrected_fidelity"]
    with open(os.path.join(out_dir, "fidelity_report.json"), "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    import csv
    with open(os.path.join(out_dir, "fidelity_report.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(report["rows"])
    md = ["| preset | device | shapes | mean | worst | >=95% | "
          "oracle rank 1 |",
          "|---|---|---|---|---|---|---|"]
    for preset, s in report["presets"].items():
        md.append(f"| {preset} | {s['device']} | {s['n']} "
                  f"| {100*s['mean_fidelity']:.2f}% "
                  f"| {100*s['worst_fidelity']:.2f}% "
                  f"| {s['at_95pct']}/{s['n']} "
                  f"| {s['oracle_rank1']}/{s['n']} |")
    with open(os.path.join(out_dir, "fidelity_report.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    return report
