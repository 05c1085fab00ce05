#!/usr/bin/env python3
"""Time the collectives of tensor-parallel serving on CUDA tensors.

    python3 tools/tp_collectives_probe.py [--ranks 2] [--shared-card]

Spawns the ranks (``repro_torch.launch.mesh.spawn_ranks``), each joins the
group (``--shared-card``: every rank on cuda:0 over gloo, as
``chip_smoke.py``'s ``serve_tp``; else NCCL, one card a rank), builds the
(1, ranks) mesh and times, on the "model" axis's group, an f32
``all_reduce`` at the sizes ``serve --tp`` sends (a prefill's row-parallel
sum at phi4-mini's 474 tokens and at 1,024, phi4-mini's decode-step sum
and its vocabulary-parallel logits at batch 4) and the int64 token
``broadcast``: host seconds a call, the card synchronised after each, the
first call apart.  Prints one JSON line a rank and the card's name and
power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# (name, shape) of the f32 sums timed.
SIZES = (("prefill_474x3072", (474, 3072)),
         ("prefill_1024x3072", (1024, 3072)),
         ("decode_4x3072", (4, 3072)),
         ("logits_4x200064", (4, 200064)))
CALLS = 5


def _rank(rank, world, init_method, shared_card):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    dev = init_distributed(rank, world, init_method, device="cuda",
                           shared_card=shared_card)
    group = make_local_mesh(world, device_type="cuda").group("model")
    row = {"rank": rank, "backend": dist.get_backend(group)}

    def timed(fn):
        out = []
        for _ in range(CALLS + 1):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            out.append(time.perf_counter() - t0)
        return {"first_s": out[0], "s": out[1:]}

    for name, shape in SIZES:
        x = torch.ones(shape, device=dev)
        row[name] = {"bytes": x.numel() * 4,
                     **timed(lambda: dist.all_reduce(x, group=group))}
        if float(x[0, 0]) != world ** (CALLS + 1):
            raise RuntimeError(f"{name}: wrong sum {float(x[0, 0])}")
    tok = torch.full((4,), rank, dtype=torch.int64, device=dev)
    src = dist.get_global_rank(group, 0)
    row["broadcast_tokens_4"] = timed(
        lambda: dist.broadcast(tok, src=src, group=group))
    if int(tok.sum()) != 0:
        raise RuntimeError("broadcast: rank 0's tokens did not arrive")
    return row


def main() -> int:
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--shared-card", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_collectives_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    for row in spawn_ranks(_rank, args.ranks, (args.shared_card,),
                           timeout=300.0):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
