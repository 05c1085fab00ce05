#!/usr/bin/env python3
"""Time the PyTorch port's f32 kernels from several checkouts on one card.

    python3 tools/f32_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository, or an unpacked ``git archive``
of one (a parent commit, or a copy with a changed ``csrc/``).  Name a root
more than once, in the order A B B A, to see the spread between runs.  Each
root runs in a process of its own, one after another: it builds its GEMM
and flash attention sources (the build seconds are reported), then times

- zamba2-7b's six mamba-layer GEMMs in f32 (``chip_smoke.MAMBA_GEMMS``) at
  decode (M = 4) and at the served prefill M (474), each at the selector's
  f32 configuration, beside one ``torch.matmul`` on the same inputs
  (full f32: TF32 off), and
- the f32 flash-attention forward at zamba2-7b's f32 prefill (causal,
  32 heads of 474 x 112, no GQA) and, with lse, at the f32 training shape
  (causal q (2, 24, 512, 128), k/v (2, 8, 512, 128)), v the transposed
  view, each beside one ``F.scaled_dot_product_attention`` in f32, with
  the forward plan's q rows, stage keys and grid, and
- the f32 flash-attention backward at the f32 training shape, from the
  plain forward's o and lse, beside the library's backward
  (``F.scaled_dot_product_attention`` under ``torch.autograd.grad``, its
  kernels' device time under torch.profiler),

with ``chip_smoke.py``'s ``time_ms`` (device ms a call, from a CUDA graph).
One JSON line a root goes to standard output, with the card's
``nvidia-smi`` name and power limit; a root that fails or hangs is reported
with its error and the next runs.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

from gemm_ab import run_roots

HERE = Path(__file__).resolve().parents[1]


def measure(root: Path) -> dict:
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.selector import select_gemm_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build(("matmul", "flash_attention"))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    rows, sums = [], {}
    for phase, M in (("decode", 4), ("prefill", cs.RAGGED_PREFILL_M)):
        tot = sums.setdefault(phase, {"ms": 0.0, "library_ms": 0.0})
        for name, N, K, _ in cs.MAMBA_GEMMS:
            g = torch.Generator(device=dev).manual_seed(7)
            a = torch.randn((M, K), generator=g, device=dev) * 0.1
            b = torch.randn((K, N), generator=g, device=dev) * 0.02
            cfg = select_gemm_config(M, N, K, in_dtype="float32",
                                     out_dtype="float32",
                                     hw=GPU_H100_LIKE).config
            row = {"phase": phase, "gemm": name, "M": M, "N": N, "K": K,
                   "config": str(cfg),
                   "ms": cs.time_ms(lambda: kmm._launch_cuda(
                       a, b, cfg, out_dtype=f32, epilogue=None, bias=None,
                       gate=None, residual=None)),
                   "library_ms": cs.time_ms(lambda: torch.matmul(a, b))}
            rows.append(row)
            for key in tot:
                tot[key] += row[key]

    fwd = []
    for what, B, H, Hkv, S, d, lse in (
            ("zamba2_prefill", 1, 32, 32, cs.RAGGED_PREFILL_M, 112, False),
            ("train_grads", 2, 24, 8, 512, 128, True)):
        q, k, v = cs._attn_inputs(torch, dev, B, H, Hkv, S, True, seed=11,
                                  d=d, dtype="float32")
        plan = kfa.plan_attention_f32(S, d, batch=B, heads=H)
        fwd.append({
            "shape": what, "q": [B, H, S, d], "kv": [B, Hkv, S, d],
            "plan": [plan.q_block, plan.kv_block, plan.ctas],
            "ms": cs.time_ms(lambda: kfa._launch_cuda(
                q, k, v, block_q=64, block_kv=64, causal=True, scale=None,
                return_lse=lse)),
            "library_ms": cs.time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))})

    B, H, Hkv, S, d = 2, 24, 8, 512, 128
    q, k, v = cs._attn_inputs(torch, dev, B, H, Hkv, S, True, seed=29, d=d,
                              dtype="float32")
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(23), device=dev)
    o, lse = kfa.attention_plain(q, k, v, block_q=64, block_kv=64,
                                 causal=True, return_lse=True)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                         enable_gqa=True)
    bwd = {"q": [B, H, S, d], "kv": [B, Hkv, S, d],
           "ms": cs.time_ms(lambda: kfa._launch_bwd_cuda(
               q, k, v, o, lse, do, causal=True, scale=None)),
           "library_ms": cs.device_ms(torch, lambda: torch.autograd.grad(
               out, (ql, kl, vl), do, retain_graph=True))}
    return {"nvidia_smi": smi, "build_s": build_s, "gemm_sums": sums,
            "gemm_rows": rows, "flash_fwd": fwd, "flash_bwd": bwd}


if __name__ == "__main__":
    sys.exit(run_roots(sys.argv[1:], __file__, measure, __doc__))
