#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention kernel from several checkouts on
one card.

    python3 tools/flash_ab.py ROOT [ROOT ...]
    python3 tools/flash_ab.py --bwd ROOT [ROOT ...]

Each ROOT is a checkout of the repository, or an unpacked ``git archive``
of one (a parent commit, or a copy with a changed ``csrc/``).  Name a root
more than once, in the order A B B A, to see the spread between runs.  Each
root runs in a process of its own, one after another: it builds its flash
attention source (the build seconds are reported), then times the causal
prefill attention of

- phi4-mini-3.8b (24 query / 8 kv heads of 128) at its bucket edges 336
  and 474, and
- qwen3-moe-30b-a3b (32 / 4 heads of 128) at 474,

with v as the model passes it (the transposed view of a (B, S, Hkv, d)
tensor), at every (block_q, block_kv) of that root's menu and at the pair
its selector picks, with ``chip_smoke.py``'s ``time_ms`` (device ms a
call, from a CUDA graph).  ``F.scaled_dot_product_attention`` on the same
inputs is timed once per shape as the library yardstick.

With ``--bwd`` each root times the attention backward instead, at
phi4-mini's training shape (causal q (4, 24, 512, 128), k/v (4, 8, 512,
128), bf16, v the transposed view), from the forward's o and lse: the
root's backward as its wrapper launches it (device ms from a CUDA graph;
its plan where the root has one), and the library's backward
(``F.scaled_dot_product_attention`` under ``torch.autograd.grad``, its
kernels' device time under torch.profiler) as the yardstick.

One JSON line a root goes to standard output, with the card's
``nvidia-smi`` name and power limit; a root that fails or hangs is
reported with its error and the next runs.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

from gemm_ab import run_roots

HERE = Path(__file__).resolve().parents[1]
SHAPES = (("phi4-mini-3.8b", 24, 8, 336), ("phi4-mini-3.8b", 24, 8, 474),
          ("qwen3-moe-30b-a3b", 32, 4, 474))


def _setup(root: Path):
    """The root's modules on the path, its flash source built: (torch, the
    chip_smoke helpers, the root's flash wrapper, the card's nvidia-smi
    line, build seconds, the device)."""
    import torch
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build(("flash_attention",))
    return torch, cs, kfa, smi, time.perf_counter() - t0, \
        torch.device("cuda", 0)


def measure(root: Path) -> dict:
    import torch.nn.functional as F
    torch, cs, kfa, smi, build_s, dev = _setup(root)
    rows = []
    for arch, H, Hkv, S in SHAPES:
        q, k, v = cs._attn_inputs(torch, dev, 1, H, Hkv, S, True, seed=11)
        try:
            sel = kfa.select_attention_blocks(S, S, 128, causal=True,
                                              heads=H, kv_heads=Hkv)
        except TypeError:            # a selector that prices no grid
            sel = kfa.select_attention_blocks(S, S, 128, causal=True)
        menu = {}
        for bq in kfa.BLOCK_MENU:
            for bkv in kfa.BLOCK_MENU:
                menu[f"{bq}x{bkv}"] = cs.time_ms(
                    lambda: kfa._launch_cuda(q, k, v, block_q=bq,
                                             block_kv=bkv, causal=True,
                                             scale=None))
        rows.append({"arch": arch, "q": [1, H, S, 128],
                     "kv": [1, Hkv, S, 128], "selected": list(sel),
                     "ms": menu[f"{sel[0]}x{sel[1]}"], "menu_ms": menu,
                     "library_ms": cs.time_ms(
                         lambda: F.scaled_dot_product_attention(
                             q, k, v, is_causal=True, enable_gqa=True))})
    return {"nvidia_smi": smi, "build_s": build_s, "rows": rows}


def measure_bwd(root: Path) -> dict:
    import dataclasses
    import torch.nn.functional as F
    torch, cs, kfa, smi, build_s, dev = _setup(root)
    B, H, Hkv, S, d = 4, 24, 8, 512, 128
    q, k, v = cs._attn_inputs(torch, dev, B, H, Hkv, S, True, seed=29, d=d)
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(23), device=dev).to(q.dtype)
    o, lse = kfa.attention_plain(q, k, v, block_q=64, block_kv=64,
                                 causal=True, return_lse=True)
    plan = getattr(kfa, "plan_attention_bwd", None)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                         enable_gqa=True)
    return {"nvidia_smi": smi, "build_s": build_s,
            "q": [B, H, S, d], "kv": [B, Hkv, S, d],
            "plan": dataclasses.asdict(plan(S, S, d, batch=B, heads=H,
                                            kv_heads=Hkv))
            if plan else None,
            "ms": cs.time_ms(lambda: kfa._launch_bwd_cuda(
                q, k, v, o, lse, do, causal=True, scale=None)),
            "library_ms": cs.device_ms(torch, lambda: torch.autograd.grad(
                out, (ql, kl, vl), do, retain_graph=True))}


if __name__ == "__main__":
    args = sys.argv[1:]
    bwd = "--bwd" in args
    args = [a for a in args if a != "--bwd"]
    sys.exit(run_roots(args, __file__, measure_bwd if bwd else measure,
                       __doc__, flags=("--bwd",) if bwd else ()))
