#!/usr/bin/env python3
"""Train an architecture's first steps on the kernel route and on the plain
route, at several learning rates, on one card.

    python3 tools/train_route_ab.py --arch musicgen-large \\
        --routes plain,kernel --lrs 1e-4,1e-5

Each (route, lr) pair starts from the same random params (seed 0) and
takes ``--steps`` steps of the port's train step (``launch/steps.py``:
AdamW, weight decay 0, global-norm clip 1.0, no warmup) on one repeated
SyntheticLM batch of B 4 x S 512 plus the model's frontend inputs, as
``chip_smoke.py``'s train phases do; ``--layers`` cuts the depth.  The
kernel route launches the Hopper kernels, the plain route replaces every
launch by its plain PyTorch version (``chip_smoke.plain_path``).  When the
two routes' losses agree, a loss that rises is the model's and the
optimizer's, not a kernel's.

One JSON line a (route, lr) pair goes to standard output: the losses of
the steps, the loss after the last, the gradient norms, ms a step; the
card's ``nvidia-smi`` name and power limit come first.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--routes", default="plain,kernel")
    ap.add_argument("--lrs", default="1e-4,1e-5")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("train_route_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.nn.frontends import synth_frontend_inputs
    from repro_torch.nn.model import Model
    from repro_torch.optim import AdamW

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build(("matmul", "flash_attention"))
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = Model(cfg, device=dev)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=cs.TRAIN_S,
                                   global_batch=cs.TRAIN_B)).batch_at(0)
    batch.update(synth_frontend_inputs(
        cfg, torch.Generator(device=dev).manual_seed(1), cs.TRAIN_B,
        cs.TRAIN_S, device=dev))
    tokens = torch.from_numpy(batch["tokens"]).to(dev).long()
    for lr in (float(x) for x in args.lrs.split(",")):
        for route in args.routes.split(","):
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            opt = AdamW(lr=lr, weight_decay=0.0)
            state = TrainState(params=params, opt=opt.init(params), step=0)
            step = make_train_step(model, opt)
            losses, norms, ms = [], [], []
            with (cs.plain_path(kmm, kfa) if route == "plain"
                  else contextlib.nullcontext()):
                for _ in range(args.steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    loss, grads = step.loss_and_grads(state.params, batch)
                    state, met = step.apply(state, loss, grads)
                    del grads
                    losses.append(float(met["loss"]))
                    norms.append(float(met["grad_norm"]))
                    ms.append((time.perf_counter() - t0) * 1e3)
                with torch.no_grad():
                    final = float(model.loss(state.params,
                                             {**batch, "tokens": tokens}))
            print(json.dumps({"arch": cfg.name, "layers": cfg.num_layers,
                              "route": route, "lr": lr, "losses": losses,
                              "loss_after_last_step": final,
                              "grad_norms": norms, "ms_per_step": ms}),
                  flush=True)
            del state, params
            cs._free(torch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
