#!/usr/bin/env python3
"""Hold an architecture's bf16 loss and gradients on the kernel route to
the plain route over several seeds, on one card, and take the distance
apart layer by layer.

    python3 tools/train_grads_seeds.py --arch musicgen-large --layers 2 \\
        --seeds 5,6,7
    python3 tools/train_grads_seeds.py --arch mixtral-8x22b --layers 1 \\
        --batch 1 --seq 4608

For each seed s, params drawn from seed s and the SyntheticLM batch at
index s - (the first seed), B 2 x S 512 by default, plus the model's
frontend inputs (``chip_smoke.py``'s ``train_grads`` phase draws its
params from seed 5 and takes batch index 0).  Three routes: the kernels in
bf16, the plain route in bf16 (every kernel launch replaced by its plain
PyTorch version, ``chip_smoke.plain_path``) and the plain route in f32.
The phase's bf16 criterion is applied as it is: the kernel route's
distance from the plain route, for the loss and for each gradient leaf,
within GRADS_REL_FACTOR x the plain bf16 route's distance from the plain
f32 route.

Then one forward pass a route without autograd, recording the output of
the embedding and of every layer's attention and MLP sub-block: the
relative L2 of kernel vs plain, plain vs plain f32 and kernel vs plain
f32 at each (an MoE layer's output too, and the token copies whose
experts differ between the routes), so that a sub-block whose kernel
route strays further than bf16 rounding (a fault) shows apart from a loss
whose bf16 and f32 values happen to lie close (a near-zero yardstick).

One JSON line a seed goes to standard output; the card's ``nvidia-smi``
name and power limit come first.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seeds", default="5,6,7")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("train_grads_seeds: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn import layers, moe, transformer
    from repro_torch.nn.frontends import synth_frontend_inputs
    from repro_torch.nn.model import Model
    from repro_torch.optim import AdamW

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build(("matmul", "flash_attention"))
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    model = Model(cfg, device=dev)
    step = make_train_step(model, AdamW())
    seeds = [int(x) for x in args.seeds.split(",")]
    B = args.batch or cs.GRADS_B
    S = args.seq or cs.TRAIN_S

    @contextlib.contextmanager
    def recording(out, ids):
        """Record the embedding's and each sub-block's output, in order,
        and each MoE layer's expert ids."""
        def spy(name, fn):
            def call(*a, **kw):
                y = fn(*a, **kw)
                t = y[0] if isinstance(y, tuple) else y
                out.append((name, t.detach().float().clone()))
                return y
            return call

        def route(*a, **kw):
            r = real_route(*a, **kw)
            ids.append(r[2].clone())
            return r
        real_route = moe._route
        with mock.patch.object(transformer, "embed_tokens",
                               spy("embed", transformer.embed_tokens)), \
                mock.patch.object(layers, "attn_forward",
                                  spy("attn", layers.attn_forward)), \
                mock.patch.object(layers, "mlp_forward",
                                  spy("mlp", layers.mlp_forward)), \
                mock.patch.object(moe, "moe_forward",
                                  spy("moe", moe.moe_forward)), \
                mock.patch.object(moe, "_route", route):
            yield

    def route(name):
        return (cs.plain_path(kmm, kfa) if name.startswith("plain")
                else contextlib.nullcontext())

    for seed in seeds:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        p32 = cs._tree_map(params, lambda t: t.float())
        batch = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=S,
            global_batch=B)).batch_at(seed - seeds[0])
        batch.update(synth_frontend_inputs(
            cfg, torch.Generator(device=dev).manual_seed(1), B, S,
            device=dev))
        losses, grads, acts, ids = {}, {}, {}, {}
        for name, p in (("kernel", params), ("plain", params),
                        ("plain_f32", p32)):
            with route(name):
                loss, g = step.loss_and_grads(p, batch)
                losses[name], grads[name] = float(loss), g
                acts[name], ids[name] = [], []
                tokens = torch.from_numpy(batch["tokens"]).to(dev).long()
                with torch.no_grad(), recording(acts[name], ids[name]):
                    model.loss(p, {**batch, "tokens": tokens})
        rel_kp = cs._grad_rel(torch, grads["kernel"], grads["plain"])
        rel_p32 = cs._grad_rel(torch, grads["plain"], grads["plain_f32"])
        d_kp = abs(losses["kernel"] - losses["plain"])
        d_p32 = abs(losses["plain"] - losses["plain_f32"])
        blocks, count = [], {}
        for (name, k_), (_, p_), (_, f_) in zip(acts["kernel"],
                                                acts["plain"],
                                                acts["plain_f32"]):
            count[name] = count.get(name, -1) + 1
            blocks.append({"block": f"{name}{count[name]}"
                           if name != "embed" else name,
                           "kernel_vs_plain": cs._rel(torch, k_, p_),
                           "plain_vs_plain_f32": cs._rel(torch, p_, f_),
                           "kernel_vs_plain_f32": cs._rel(torch, k_, f_)})
        ratio = {leaf: rel_kp[leaf] / max(rel_p32[leaf], 1e-30)
                 for leaf in rel_kp}

        def flips(a, b):   # token copies whose expert set differs
            return sum(int((x.sort(-1).values != y.sort(-1).values)
                           .any(-1).sum()) for x, y in zip(ids[a], ids[b]))
        print(json.dumps({
            "arch": cfg.name, "layers": cfg.num_layers, "seed": seed,
            "batch_index": seed - seeds[0],
            "batch": [B, S], "window": cfg.sliding_window, "loss": losses,
            "loss_abs_diff_kernel_vs_plain": d_kp,
            "loss_abs_diff_plain_vs_plain_f32": d_p32,
            "loss_kernel_vs_plain_f32": abs(losses["kernel"]
                                            - losses["plain_f32"]),
            "loss_ok": d_kp <= cs.GRADS_REL_FACTOR * d_p32,
            "leaves_ok": all(r <= cs.GRADS_REL_FACTOR
                             for r in ratio.values()),
            "worst_leaf_ratio": max(ratio.items(), key=lambda kv: kv[1]),
            "grad_rel_l2_kernel_vs_plain": rel_kp,
            "grad_rel_l2_plain_vs_plain_f32": rel_p32,
            "blocks": blocks,
            **({"route_flips": {
                "kernel_vs_plain": flips("kernel", "plain"),
                "plain_vs_plain_f32": flips("plain", "plain_f32"),
                "kernel_vs_plain_f32": flips("kernel", "plain_f32"),
                "tokens_a_layer": B * S}} if cfg.is_moe else {}),
            "criterion": f"kernel vs plain <= {cs.GRADS_REL_FACTOR} x "
                         f"plain vs plain f32"}), flush=True)
        del params, p32, grads, acts
        cs._free(torch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
