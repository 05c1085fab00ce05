#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention kernel from several checkouts on
one card.

    python3 tools/flash_ab.py ROOT [ROOT ...]

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
inputs is timed once per shape as the library yardstick.  One JSON line a
root goes to standard output, with the card's ``nvidia-smi`` name and
power limit; a root that fails or hangs is reported with its error and the
next runs.
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


def measure(root: Path) -> dict:
    import torch
    import torch.nn.functional as F
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
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
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


if __name__ == "__main__":
    sys.exit(run_roots(sys.argv[1:], __file__, measure, __doc__))
