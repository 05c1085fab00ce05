#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sharded-training phases alone on the card.

    python3 tools/train_dp_probe.py [--profiler-check]

Builds the GEMM and flash kernels, then runs ``train_dp_phases``
(``train_dp_f32`` and ``train_dp``: ranks sharing cuda:0 over gloo) with
every check of the full script, in a fraction of its time; prints its
JSON lines, the card's name and power limit, and the seconds taken.
``--profiler-check`` instead asks, step by step, whether torch.profiler
in this process still records device kernels: at the start, after the
one-process f32 reference step of ``train_dp_f32``, after ranks that only
run a gloo ``all_reduce`` on the card, and after ranks that launch a
kernel.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def _kernels_seen(torch, fn) -> int:
    """Device kernel events torch.profiler records over three calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return sum(1 for e in events if str(e.get("cat", "")).lower() == "kernel")


def _rank_collective(rank, world, init_method):
    import torch
    import torch.distributed as dist
    dev, _ = cs._dp_join(rank, world, init_method, 1)
    t = torch.ones(1 << 20, device=dev)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t[0])


def _rank_kernel(rank, world, init_method):
    import torch
    from repro_torch.kernels import ops
    dev, _ = cs._dp_join(rank, world, init_method, 1)
    a = torch.randn(512, 1024, device=dev, dtype=torch.bfloat16)
    ops.matmul(a, a.t().contiguous())
    torch.cuda.synchronize()
    return 0


def _profiler_check(torch) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_ranks
    dev = torch.device("cuda", 0)
    a = torch.randn(512, 1024, device=dev, dtype=torch.bfloat16)
    b = torch.randn(1024, 1024, device=dev, dtype=torch.bfloat16)

    def seen():
        return {"kernel_gemm": _kernels_seen(torch, lambda: ops.matmul(a, b)),
                "library_gemm": _kernels_seen(torch, lambda: a @ b)}

    out = {"start": seen()}
    cs.DP_DIR.mkdir(parents=True, exist_ok=True)
    cs._dp_reference(torch, dev, "phi4-mini-3.8b", cs.DP_DIR / "ref.pt")
    out["after_reference"] = seen()
    spawn_ranks(_rank_collective, 2, timeout=300)
    out["after_gloo_ranks"] = seen()
    spawn_ranks(_rank_kernel, 2, timeout=300)
    out["after_kernel_ranks"] = seen()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiler-check", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_dp_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    t0 = time.perf_counter()
    build.build(("matmul", "flash_attention"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, torch.__version__, flush=True)
    if args.profiler_check:
        cs.emit({"profiler_check": _profiler_check(torch)})
    else:
        rows = cs.train_dp_phases(torch, torch.device("cuda", 0), kmm, kfa)
        cs.emit({"train_dp_launches": rows})
    cs.emit({"seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
