#!/usr/bin/env python3
"""Time every candidate configuration of the GEMM selector's space on one
card, shape by shape: the selection against the fastest config of the
menu, and the fastest against one PyTorch call.

    python3 tools/gemm_sweep.py [--groups mamba2_decode,qwen3_bwd,...] \
        [--top N] [--out build/gemm_sweep.jsonl]

For each shape of a group it ranks the selector's candidate space on
``GPU_H100_LIKE`` with the latency model (``rank_candidates``), then
launches the GEMM kernel (``csrc/matmul.cu``; the grouped launch for the
expert shapes) at every candidate, on unit-normal operands made from a
seed.  Each output must first agree with the plain product
(``kernels/ref.py::gemm_check``: every element within
``tests/test_kernels.py``'s tolerance and the relative L2 error within
1e-2 in bf16, 1e-5 in f32): a wrong config that ran fast would win the
argmin, so a candidate that disagrees is listed under ``wrong`` and never
timed, one whose launch raises under ``refused``.  Every candidate left is timed with
``chip_smoke.py::time_ms`` (a CUDA graph of 10 calls, the median of 5
replays: the M = 4 kernels run for 0.01-0.06 ms, which CUDA events around
eager calls would spend on the host), as is the library call on the same
operands (``torch.matmul`` on the operands as the layout stores them,
``torch.bmm`` for the experts).

The groups (``GROUPS``): mamba2-370m's six layer projections at decode
(M 4) and prefill (M 474) in bf16; zamba2-7b's six at both, and at decode
in f32 (split TF32); phi4-mini's seven layer GEMMs' backward at T 2048, dX
= dY W^T (W read transposed, ``trans_b``) and dW = X^T dY (X read
transposed, ``trans_a``); qwen3-moe-30b-a3b's expert backward at its
training shape (128 experts of capacity 160, wu and wd, dX and dW).  The
selected config is the one the main path selects for that product (bf16
or f32 in and out, no epilogue).

One JSON line a shape goes to standard output and to ``--out``: the
selected config's time and model rank, the fastest config's time and rank,
the worst relative L2 error of the candidates that agreed, the library's
time, the bound max(bytes / 3.35e12, flops / peak) with
``chip_smoke.py``'s peaks (989e12 bf16, 495e12 / 3 split TF32), the
achieved HBM rate of the bound's bytes, the bytes the selected config's
walk reads under ``kernels/matmul.py::l2_reckoning``, the ``--top``
fastest candidates, and the card's ``nvidia-smi`` name and power limit.
Then one line a group: the sums of those times and the two gaps, the
selection's (selected / fastest) and the kernel's (fastest / library).
It exits non-zero when a candidate disagrees with the plain product.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))
import chip_smoke as cs  # noqa: E402


class Shape(NamedTuple):
    group: str
    gemm: str
    layout: str       # "nn", "nt" (B stored transposed), "tn" (A stored transposed)
    M: int
    N: int
    K: int
    dtype: str        # in and out
    experts: int = 0  # > 0: the grouped launch, one (M, N, K) product each


def _forward(group, M, gemms, dtype="bfloat16"):
    return [Shape(group, name, "nn", M, N, K, dtype)
            for name, N, K, _ in gemms]


def _dense_bwd(group, layout):
    # dX (T, K) = dY (T, N) W^T; dW (K, N) = X^T dY, T = B x S tokens.
    T = cs.TRAIN_T
    return [Shape(group, name, layout,
                  *((T, K, N) if layout == "nt" else (K, N, T)), "bfloat16")
            for name, N, K, _ in cs.PATH_GEMMS]


def _expert_bwd(group, experts=128, capacity=160):
    out = []
    for name, N, K, _ in cs.EXPERT_GEMMS:
        if name == "wg":                 # wu's shapes again
            continue
        out += [Shape(group, f"{name} dX", "nt", capacity, K, N, "bfloat16",
                      experts),
                Shape(group, f"{name} dW", "tn", K, N, capacity, "bfloat16",
                      experts)]
    return out


GROUPS = {
    "mamba2_decode": _forward("mamba2_decode", 4, cs.SSM_GEMMS),
    "mamba2_prefill": _forward("mamba2_prefill", cs.RAGGED_PREFILL_M,
                               cs.SSM_GEMMS),
    "zamba2_decode": _forward("zamba2_decode", 4, cs.MAMBA_GEMMS),
    "zamba2_prefill": _forward("zamba2_prefill", cs.RAGGED_PREFILL_M,
                               cs.MAMBA_GEMMS),
    "zamba2_f32_decode": _forward("zamba2_f32_decode", 4, cs.MAMBA_GEMMS,
                                  "float32"),
    "phi4_dx": _dense_bwd("phi4_dx", "nt"),
    "phi4_dw": _dense_bwd("phi4_dw", "tn"),
    "qwen3_bwd": _expert_bwd("qwen3_bwd"),
}


def _operands(torch, dev, s: Shape, g):
    """A and B as the layout stores them (an expert axis first), unit
    normal: the absolute tolerance of ``gemm_check`` assumes that scale."""
    lead = (s.experts,) if s.experts else ()
    a_shape = (s.K, s.M) if s.layout == "tn" else (s.M, s.K)
    b_shape = (s.N, s.K) if s.layout == "nt" else (s.K, s.N)
    dt = getattr(torch, s.dtype)
    return tuple(torch.randn(lead + shape, generator=g, device=dev).to(dt)
                 for shape in (a_shape, b_shape))


def _library(torch, s: Shape, a, b):
    """One PyTorch call computing the same product."""
    ta = a.transpose(-1, -2) if s.layout == "tn" else a
    tb = b.transpose(-1, -2) if s.layout == "nt" else b
    if s.experts:
        return lambda: torch.bmm(ta, tb)
    return lambda: torch.matmul(ta, tb)


def sweep_shape(torch, dev, kmm, s: Shape, top: int, smi: str) -> dict:
    """Check, then time, every candidate of one shape (module docstring)."""
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import GemmProblem
    from repro_torch.core.selector import (rank_candidates,
                                           select_gemm_config)
    from repro_torch.kernels.ref import gemm_check
    g = torch.Generator(device=dev).manual_seed(31)
    a, b = _operands(torch, dev, s, g)
    dt = getattr(torch, s.dtype)
    ranked = rank_candidates(GemmProblem(s.M, s.N, s.K, in_dtype=s.dtype,
                                         out_dtype=s.dtype), GPU_H100_LIKE)
    configs = [t for t, _ in ranked]
    model_ms = {t: p.total * 1e3 for t, p in ranked}
    sel = select_gemm_config(s.M, s.N, s.K, in_dtype=s.dtype,
                             out_dtype=s.dtype, hw=GPU_H100_LIKE).config
    kw = dict(out_dtype=dt, epilogue=None, bias=None, gate=None,
              residual=None, trans_a=s.layout == "tn",
              trans_b=s.layout == "nt")
    launch, plain = ((kmm._launch_expert_cuda, kmm.expert_matmul_plain)
                     if s.experts else (kmm._launch_cuda, kmm.matmul_plain))
    want = plain(a, b, sel, **kw).float()
    times, wrong, refused = {}, [], []
    worst_rel = 0.0
    for cfg in configs:
        try:
            got = launch(a, b, cfg, **kw)
        except (RuntimeError, ValueError) as e:
            refused.append([str(cfg), repr(e)[:200]])
            continue
        ok, err, rel = gemm_check(got, want, dt, s.K)
        del got
        if not ok:
            wrong.append([str(cfg), err, rel])
            continue
        worst_rel = max(worst_rel, rel)
        times[cfg] = cs.time_ms(lambda: launch(a, b, cfg, **kw))
    lib_ms = cs.time_ms(_library(torch, s, a, b))
    del want
    order = sorted(times, key=times.get)
    best = order[0] if order else None
    elem = 2 if s.dtype == "bfloat16" else 4
    peak = cs.BF16_PEAK if s.dtype == "bfloat16" else cs.TF32X3_PEAK
    nbytes, flops = cs._gemm_bytes_flops(s.M, s.N, s.K, "none", elem)
    nbytes, flops = nbytes * max(s.experts, 1), flops * max(s.experts, 1)
    bound_ms, bound_by = cs._bound(nbytes, flops, peak)
    walk = kmm.l2_reckoning(
        kmm.work_plan(s.M, s.N, s.K, sel, max(s.experts, 1),
                      kmm._sm_count(dev.index or 0)), cs.L2_BYTES,
        elem=elem, out_elem=elem)

    def tbs(ms):            # achieved HBM rate of the bound's bytes
        return nbytes / ms * 1e-9 if ms else None
    sel_ms = times.get(sel)
    best_ms = times[best] if best is not None else None
    return {
        "group": s.group, "gemm": s.gemm, "layout": s.layout,
        "dtype": s.dtype, "experts": s.experts, "M": s.M, "N": s.N,
        "K": s.K, "candidates": len(configs), "timed": len(times),
        "wrong": wrong, "refused": refused, "worst_rel_l2": worst_rel,
        "selected": str(sel), "selected_ms": sel_ms,
        "selected_model_ms": model_ms[sel],
        "selected_model_rank": configs.index(sel) + 1,
        "selected_hbm_tbs": tbs(sel_ms),
        "selected_walk_bytes": walk["a"] + walk["b"] + walk["out"],
        "best": str(best), "best_ms": best_ms,
        "best_model_ms": model_ms[best] if best is not None else None,
        "best_model_rank": configs.index(best) + 1 if best is not None
        else None,
        "best_hbm_tbs": tbs(best_ms),
        "library_ms": lib_ms, "library_hbm_tbs": tbs(lib_ms),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "selection_gap": sel_ms / best_ms if sel_ms and best_ms else None,
        "kernel_gap": best_ms / lib_ms if best_ms else None,
        "top": [[str(c), times[c], configs.index(c) + 1, tbs(times[c])]
                for c in order[:top]],
        "nvidia_smi": smi}


def group_summary(rows: List[dict]) -> dict:
    """A group's sums over its shapes and its two gaps."""
    tot = {k: sum(r[k] or 0.0 for r in rows)
           for k in ("selected_ms", "best_ms", "library_ms", "bound_ms")}
    return {"group": rows[0]["group"], "shapes": len(rows), **tot,
            "selection_gap": tot["selected_ms"] / tot["best_ms"],
            "kernel_gap": tot["best_ms"] / tot["library_ms"],
            "selected_at_best": sum(r["selected"] == r["best"]
                                    for r in rows),
            "wrong": sum(len(r["wrong"]) for r in rows),
            "worst_rel_l2": max(r["worst_rel_l2"] for r in rows),
            "refused": sum(len(r["refused"]) for r in rows),
            "nvidia_smi": rows[0]["nvidia_smi"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help=f"comma-separated, of {', '.join(GROUPS)}")
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="also append every JSON line to this file")
    args = ap.parse_args(argv)
    groups = args.groups.split(",")
    unknown = sorted(set(groups) - set(GROUPS))
    if unknown:
        ap.error(f"unknown groups {unknown}")
    import torch
    if not torch.cuda.is_available():
        print("gemm_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import matmul as kmm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    wrong = 0
    with (open(args.out, "a") if args.out
          else contextlib.nullcontext()) as out:
        def emit(obj):
            line = json.dumps(obj)
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
        for group in groups:
            rows = []
            for s in GROUPS[group]:
                rows.append(sweep_shape(torch, dev, kmm, s, args.top, smi))
                emit(rows[-1])
                wrong += len(rows[-1]["wrong"])
            emit({"summary": group_summary(rows)})
    if wrong:
        print(f"gemm_sweep: {wrong} candidates disagree with the plain "
              f"product", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
