#!/usr/bin/env python3
"""Time the PyTorch port's GEMM wrappers from several checkouts on one card.

    python3 tools/gemm_ab.py [--phases decode,moe_dw,...] ROOT [ROOT ...]

Each ROOT is a checkout of the repository, or an unpacked ``git archive``
of one (a parent commit, or a copy with a changed ``csrc/``).  Name a root
more than once, in the order A B B A, to see the spread between runs.  Each
root runs in a process of its own, one after another: it builds its CUDA
GEMM source (the build seconds are reported), then times at the selector's
configuration for each

- phi4-mini-3.8b's seven decode GEMMs (M = 4) and nine prefill GEMMs
  (M = 512, wk and wv twice),
- qwen3-moe-30b-a3b's three prefill expert GEMMs (E = 128, C = 40),
- mamba2-370m's and zamba2-7b's six mamba GEMMs at M = 4 and 474,
- phi4-mini's seven backward dX (W read transposed) and dW (X read
  transposed) at T = 2048, and qwen3-moe's three expert dX and dW at its
  training shape (E = 128, C = 160),

with ``chip_smoke.py``'s ``time_ms`` (device ms a call, from a CUDA graph)
and ``host_us`` (host microseconds a call, no device sync: the wrapper's
checks, plan, allocations and the launch; the median of five batches),
and ``host_c_us``, the part of it spent in the C entry (``repro_gemm``:
its checks, tensor-map encoding and launch), timed by calling the entry
again with the arguments the wrapper passed it.  One JSON line a root goes to standard output, with the card's
``nvidia-smi`` name and power limit; a root that fails or hangs is
reported with its error and the next runs.  ``--phases`` keeps only the
named groups (decode, prefill, expert_prefill, ssm_decode, ssm_prefill,
hybrid_decode, hybrid_prefill, train_dx, moe_dx, train_dw, moe_dw).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT_TIMEOUT_S = 600
HOST_REPEATS = 5
PHASES = None   # --phases: the phase names to time (None: all)


def measure(root: Path) -> dict:
    import torch
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import Epilogue
    from repro_torch.core.selector import select_gemm_config
    from repro_torch.kernels import build
    from repro_torch.kernels import matmul as kmm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build(("matmul",))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    eps = {"none": Epilogue(), "residual": Epilogue(residual=True),
           "swiglu_gate": Epilogue(activation="swiglu_gate")}
    rows, sums = [], {}

    def record(phase, name, cfg, kern):
        if PHASES is not None and phase not in PHASES:
            return
        row = {"phase": phase, "gemm": name, "config": str(cfg),
               "ms": cs.time_ms(kern),
               "host_us": statistics.median(
                   cs.host_us(torch, kern) for _ in range(HOST_REPEATS))}
        # The C entry alone, on the arguments of one wrapper call.  They
        # point at the call's output and workspace, which the caching
        # allocator keeps mapped after the call; host_us synchronises
        # before anything else allocates.
        lib = build.load("matmul")
        entry = lib.repro_gemm
        rec = _Recorder(entry)
        lib.repro_gemm = rec
        try:
            kern()
        finally:
            lib.repro_gemm = entry
        row["host_c_us"] = statistics.median(
            cs.host_us(torch, lambda: entry(*rec.args))
            for _ in range(HOST_REPEATS))
        rows.append(row)
        tot = sums.setdefault(phase, dict.fromkeys(
            ("ms", "host_us", "host_c_us"), 0.0))
        for key in tot:
            tot[key] += row[key]

    for phase, M, extra in (("decode", 4, ()), ("prefill", 512, ("wk", "wv"))):
        for name, N, K, epn in cs.PATH_GEMMS + [
                g for g in cs.PATH_GEMMS if g[0] in extra]:
            ep = eps[epn]
            a, b, kw = cs._gemm_inputs(torch, dev, M, N, K, ep, bf, seed=7)
            a, b = a * 0.1, b * 0.02
            cfg = select_gemm_config(M, N, K, in_dtype="bfloat16",
                                     out_dtype="bfloat16", epilogue=ep,
                                     hw=GPU_H100_LIKE).config
            record(phase, name, cfg, lambda: kmm._launch_cuda(
                a, b, cfg, out_dtype=bf, epilogue=ep, bias=None,
                gate=kw.get("gate"), residual=kw.get("residual")))
    E, C = 128, 40
    for name, N, K, epn in cs.EXPERT_GEMMS:
        ep = eps[epn]
        x, w, kw = cs._expert_inputs(torch, dev, E, C, N, K, ep, bf, seed=13)
        x, w = x * 0.1, w * 0.02
        cfg = select_gemm_config(C, N, K, in_dtype="bfloat16",
                                 out_dtype="bfloat16", epilogue=ep,
                                 hw=GPU_H100_LIKE).config
        record("expert_prefill", name, cfg, lambda: kmm._launch_expert_cuda(
            x, w, cfg, out_dtype=bf, epilogue=ep, bias=None,
            gate=kw.get("gate"), residual=None))
        del x, w, kw
    for phase, M, gemms in (
            ("ssm_decode", 4, cs.SSM_GEMMS),
            ("ssm_prefill", cs.RAGGED_PREFILL_M, cs.SSM_GEMMS),
            ("hybrid_decode", 4, cs.MAMBA_GEMMS),
            ("hybrid_prefill", cs.RAGGED_PREFILL_M, cs.MAMBA_GEMMS)):
        for name, N, K, epn in gemms:
            a, b, _ = cs._gemm_inputs(torch, dev, M, N, K, eps[epn], bf,
                                      seed=7)
            a, b = a * 0.1, b * 0.02
            cfg = select_gemm_config(M, N, K, in_dtype="bfloat16",
                                     out_dtype="bfloat16",
                                     hw=GPU_H100_LIKE).config
            record(phase, name, cfg, lambda: kmm._launch_cuda(
                a, b, cfg, out_dtype=bf, epilogue=None, bias=None,
                gate=None, residual=None))
    g = torch.Generator(device=dev).manual_seed(31)

    def rnd(*shape, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)
    # The backward: dX = dY W^T (W read transposed), dW = X^T dY (X read
    # transposed), dense at phi4's T and grouped at qwen3's C.
    T, (E, C) = cs.TRAIN_T, (cs.MOE_E, cs.MOE_C)
    for layout in ("nt", "tn"):
        for name, N, K, _ in cs.PATH_GEMMS:
            M_, N_, K_ = (T, K, N) if layout == "nt" else (K, N, T)
            a = rnd(T, N, scale=0.1) if layout == "nt" \
                else rnd(T, K, scale=0.1)
            b = rnd(K, N, scale=0.02) if layout == "nt" \
                else rnd(T, N, scale=0.1)
            cfg = select_gemm_config(M_, N_, K_, in_dtype="bfloat16",
                                     out_dtype="bfloat16",
                                     hw=GPU_H100_LIKE).config
            record(f"train_{'dx' if layout == 'nt' else 'dw'}", name, cfg,
                   lambda: kmm._launch_cuda(
                       a, b, cfg, out_dtype=bf, epilogue=None, bias=None,
                       gate=None, residual=None, trans_a=layout == "tn",
                       trans_b=layout == "nt"))
        for name, K_in, N_out in (("wu", cs.MOE_D, cs.MOE_F),
                                  ("wg", cs.MOE_D, cs.MOE_F),
                                  ("wd", cs.MOE_F, cs.MOE_D)):
            if layout == "nt":
                a, b = rnd(E, C, N_out, scale=0.1), \
                    rnd(E, K_in, N_out, scale=0.02)
                M_, N_, K_ = C, K_in, N_out
            else:
                a, b = rnd(E, C, K_in, scale=0.1), \
                    rnd(E, C, N_out, scale=0.1)
                M_, N_, K_ = K_in, N_out, C
            cfg = select_gemm_config(M_, N_, K_, in_dtype="bfloat16",
                                     out_dtype="bfloat16",
                                     hw=GPU_H100_LIKE).config
            record(f"moe_{'dx' if layout == 'nt' else 'dw'}", name, cfg,
                   lambda: kmm._launch_expert_cuda(
                       a, b, cfg, out_dtype=bf, epilogue=None, bias=None,
                       gate=None, residual=None, trans_a=layout == "tn",
                       trans_b=layout == "nt"))
            del a, b
    return {"nvidia_smi": smi, "build_s": build_s, "sums": sums,
            "rows": rows}


class _Recorder:
    """Stands in for the C entry for one call and keeps its arguments."""

    def __init__(self, entry):
        self.entry = entry
        self.argtypes = entry.argtypes
        self.args = None

    def __call__(self, *args):
        self.args = args
        return self.entry(*args)


def run_roots(argv, script: str, measure_root, doc: str,
              flags=()) -> int:
    """The A/B runner shared with ``tools/flash_ab.py``: ``script --one
    ROOT`` prints ``measure_root(ROOT)`` as one JSON line; without
    ``--one``, each ROOT runs that in a process of its own, in turn, with
    ``flags`` passed on to it."""
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps({"root": argv[1], **measure_root(Path(argv[1]))}),
              flush=True)
        return 0
    if not argv:
        print(doc, file=sys.stderr)
        return 2
    code = 0
    for root in argv:
        try:
            res = subprocess.run(
                [sys.executable, script, *flags, "--one",
                 str(Path(root).resolve())], capture_output=True, text=True,
                timeout=ROOT_TIMEOUT_S)
            out = res.stdout.strip().splitlines()
            if res.returncode == 0 and out:
                print(out[-1], flush=True)
                continue
            err = f"exit {res.returncode}: {res.stderr[-2000:]}"
        except subprocess.TimeoutExpired:
            err = f"timed out after {ROOT_TIMEOUT_S} s"
        print(json.dumps({"root": root, "error": err}), flush=True)
        code = 1
    return code


if __name__ == "__main__":
    argv = sys.argv[1:]
    flags = ()
    if argv and argv[0] == "--phases":
        PHASES = set(argv[1].split(","))
        flags, argv = tuple(argv[:2]), argv[2:]
    sys.exit(run_roots(argv, __file__, measure, __doc__, flags=flags))
