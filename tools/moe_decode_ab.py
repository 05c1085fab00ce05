#!/usr/bin/env python3
"""Time the decode MoE's two sparse paths against each other on one card.

    python3 tools/moe_decode_ab.py [--out FILE]

One MoE layer, bf16 weights at std 1/sqrt(fan_in) and a random router, over
a range of decode batches B, at the published widths of qwen3-moe-30b-a3b
(d_model 2,048, expert d_ff 768, top 8; with 128 experts, and with 64 and
32 as a rank of two or four holds them) and of mixtral-8x22b (6,144,
16,384, top 2, 8 experts), then at two cut widths: mixtral's experts at
d_model 1,024 and d_ff 2,048, and at 64 and 128 with 4 experts (the CPU
tests' sizes).  At each point both of ``nn/moe.py``'s sparse decode paths
run on the same inputs:

- ``gather``: the K selected experts' weights copied per token, then the
  einsums (B·K·3·D·F items gathered);
- ``grouped``: the copies dispatched into an (E, B, D) buffer and the three
  grouped GEMMs reading every local expert's weights in place (E·3·D·F
  items read).

Each is timed as ``chip_smoke.py``'s ``time_ms`` times it (device ms a
call, from a CUDA graph), and the two outputs are compared.  A point gives
both times, the faster path, and the path ``decode_path`` chooses there
(``chosen``), whose constants were set from the published widths' points.
One JSON line a point goes to standard output and to ``--out``
(``experiments/moe_decode_ab.jsonl`` by default), with the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (arch, changes to its config, batches)
POINTS = (("qwen3-moe-30b-a3b", {"num_experts": 128},
           (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)),
          ("qwen3-moe-30b-a3b", {"num_experts": 64}, (1, 2, 4, 8, 16)),
          ("qwen3-moe-30b-a3b", {"num_experts": 32}, (1, 2, 4, 8)),
          ("mixtral-8x22b", {}, (1, 2, 3, 4, 8, 16)),
          ("mixtral-8x22b", {"d_model": 1024, "moe_d_ff": 2048},
           (1, 2, 4, 8, 16)),
          ("mixtral-8x22b", {"d_model": 64, "moe_d_ff": 128,
                             "num_experts": 4}, (1, 2, 4, 16)))


def _layer(torch, dev, cfg, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    def rnd(*shape, fan_in):
        return (torch.randn(shape, generator=g, device=dev)
                / math.sqrt(fan_in)).to(torch.bfloat16)
    return {"norm": {"scale": torch.ones(D, device=dev,
                                         dtype=torch.bfloat16)},
            "router": rnd(D, E, fan_in=D), "wg": rnd(E, D, F, fan_in=D),
            "wu": rnd(E, D, F, fan_in=D), "wd": rnd(E, F, D, fan_in=F)}, g


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "experiments"
                                         / "moe_decode_ab.jsonl"))
    args = ap.parse_args()
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.calib.device import graph_time
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.nn import moe

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build(("matmul",))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as fh:
        for arch, changes, batches in POINTS:
            cfg = dataclasses.replace(get_config(arch), **changes)
            p, g = _layer(torch, dev, cfg, seed=cfg.d_model)
            D, F, K = cfg.d_model, cfg.moe_d_ff, cfg.experts_per_token
            E = cfg.num_experts
            per_expert = 3 * D * F * 2
            for B in batches:
                x = torch.randn((B, 1, D), generator=g, device=dev
                                ).to(torch.bfloat16)
                row = {"arch": arch, "d_model": D, "d_ff": F,
                       "experts": E, "top_k": K, "B": B,
                       "copies": B * K, "card": smi,
                       "build_s": round(build_s, 2),
                       "chosen": moe.decode_path(cfg, B, E,
                                                 moe._weight_bytes(p))}
                with torch.inference_mode():
                    ys = {}
                    for path in ("gather", "grouped"):
                        ys[path] = moe._decode(p, x, cfg, path).float()
                        row[f"{path}_ms"] = graph_time(
                            lambda: moe._decode(p, x, cfg, path), 3, 5) * 1e3
                want = ys["gather"]
                row["rel_l2"] = float(torch.linalg.vector_norm(
                    ys["grouped"] - want) / torch.linalg.vector_norm(want))
                gathered = B * K * per_expert
                row["gathered_gb"] = gathered / 1e9
                row["weight_gb"] = E * per_expert / 1e9
                row["faster"] = min(("gather", "grouped"),
                                    key=lambda k: row[f"{k}_ms"])
                line = json.dumps(row)
                print(line, flush=True)
                fh.write(line + "\n")
            del p
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
