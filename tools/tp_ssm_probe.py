#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s SSM and hybrid tensor-parallel phases and its
dry-run phase alone on the card, with every check of the full script.

    python3 tools/tp_ssm_probe.py [--parts serve,train,dryrun]

``serve``: serve_ssm and serve_hybrid (mamba2-370m and zamba2-7b whole,
bf16, one process), then serve_tp and serve_tp_f32 on those two models
alone (2 ranks sharing cuda:0 over gloo).  ``train``: train_dp_f32 and
train_dp (``train_dp_phases``, the SSM and hybrid cases among the f32
ones).  ``dryrun``: phi4-mini's serve and train phases, then the dryrun
phase beside them.  Builds the GEMM and flash kernels first; prints the
phases' JSON lines, the card's name and power limit, and the seconds
taken.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

PARTS = ("serve", "train", "dryrun")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {PARTS}")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes {PARTS}")
    import torch
    if not torch.cuda.is_available():
        print("tp_ssm_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    dev = torch.device("cuda", 0)
    if "serve" in parts:
        refs = []
        cs.serve_ssm_phase(torch, dev, kmm, kfa, refs)
        cs.serve_hybrid_phase(torch, dev, kmm, kfa, refs)
        cs.TP_SERVE = tuple(r["arch"] for r in refs)   # these two alone
        cs.emit({"serve_tp_launches": cs.serve_tp_phase(torch, refs)})
        cs.serve_tp_f32_phase(torch, refs)
    if "train" in parts:
        cs.emit({"train_dp_launches": cs.train_dp_phases(torch, dev, kmm,
                                                         kfa)})
    if "dryrun" in parts:
        model, params, _, _ = cs.serve_phase(torch, dev, kmm, kfa, [])
        del model, params
        cs._free(torch)
        model, state, batch, _ = cs.train_phase(torch, dev, kmm, kfa)
        del model, state, batch
        cs._free(torch)
        cs.dryrun_phase()
    cs.emit({"seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
