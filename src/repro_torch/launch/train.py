"""Fault-tolerant training driver of the port, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --steps 6 --batch 4 --seq 512

    # the same path on the CPU at smoke size (plain PyTorch versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --smoke --device cpu --steps 4 --ckpt-dir /tmp/ckpt

The reference's features (``repro/launch/train.py``) on one device:
  * checkpoint/restart (atomic, hashed, the reference's on-disk format);
  * preemption hook (SIGTERM -> checkpoint -> clean exit);
  * straggler monitor (z-score step times), bounded retry on transients:
    of a step's loss and gradients only, which mutate nothing, while the
    optimizer's in-place commit runs once (``launch/steps.py``);
  * deterministic restart-safe data stream + background prefetch.
On the card every GEMM of the forward pass, of its recompute (``remat``)
and of the backward runs the hand-written Hopper GEMM (the MoE's expert
GEMMs and their gradients the grouped one), every attention forward and
backward the flash kernels.  Every family of the port trains: dense
(phi4-mini-3.8b, minitron-8b, stablelm-12b, internlm2-20b), MoE
(qwen3-moe-30b-a3b, mixtral-8x22b), SSM (mamba2-370m), hybrid
(zamba2-7b), audio (musicgen-large) and vlm (llava-next-mistral-7b).  A
model with a frontend gets synthetic frontend inputs, drawn once from a
generator seeded 1 (as ``repro/launch/train.py:93-96`` draws them from
PRNGKey(1)), in every batch.  There is no mesh and no ``--compress-dp``:
the distributed slice brings them.  At full size (bf16 params and grads,
f32 AdamW moments: 12 bytes a parameter) phi4-mini-3.8b needs about 46 GB
of the card for its state, musicgen-large about 29 GB and mamba2-370m
about 4.4 GB, plus activations; the others do not fit one card at full
depth (minitron-8b about 119 GB, llava-next-mistral-7b 87 GB,
stablelm-12b 146 GB, internlm2-20b 238 GB, zamba2-7b 81 GB, qwen3-moe
366 GB, mixtral-8x22b 1.7 TB; ROADMAP A5).  A sliding window
(mixtral-8x22b) trains on the card too: the flash forward and backward
kernels take it in both dtypes; on the CPU it trains through the plain
versions.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.nn.frontends import synth_frontend_inputs
from repro_torch.nn.model import Model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime import (MetricLogger, PreemptionGuard,
                                 StragglerMonitor, retry)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log", default=None, help="JSONL metrics path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def run_training(args: argparse.Namespace) -> Dict:
    """Train as the flags say; returns {"records": the logged step
    records, "state": the final TrainState, "stopped": preempted}."""
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg, device=args.device)
    print(f"arch={cfg.name} device={model.device}")

    opt = AdamW(lr=warmup_cosine(args.lr, args.warmup, args.steps))
    train_step = make_train_step(model, opt)

    start_step = 0
    if args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        params = model.abstract_params()
        template = TrainState(params=params, opt=opt.init(params), step=0)
        start_step, state = ckpt_lib.restore(args.ckpt_dir, template,
                                             device=model.device)
        print(f"restored checkpoint at step {start_step}")
    else:
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = model.init(gen)
        state = TrainState(params=params, opt=opt.init(params), step=0)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch,
                                  seed=args.seed))
    stream = Prefetcher(data.iterate(start_step), depth=2)
    extras = synth_frontend_inputs(
        cfg, torch.Generator(device=model.device).manual_seed(1), args.batch,
        args.seq, device=model.device)
    guard = PreemptionGuard()
    monitor = StragglerMonitor()
    logger = MetricLogger(args.log)
    records: List[Dict] = []

    def save(step):
        if args.ckpt_dir:
            path = ckpt_lib.save(args.ckpt_dir, step, state,
                                 extra_meta={"arch": cfg.name})
            print(f"checkpointed step {step} -> {path}")

    try:
        for step in range(start_step, args.steps):
            if guard.should_stop:
                print("preemption signal: checkpointing and exiting")
                save(step)
                return {"records": records, "state": state,
                        "stopped": True}
            batch = {**next(stream), **extras}
            t0 = time.time()
            loss, grads = retry(train_step.loss_and_grads, state.params,
                                batch, retries=2)
            state, metrics = train_step.apply(state, loss, grads)
            del grads
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = time.time() - t0
            warn = monitor.record(dt)
            if warn:
                print(warn)
            rec = logger.log(step + 1, loss=loss, grad_norm=gnorm,
                             lr=metrics["lr"], step_time=dt)
            records.append(rec)
            if (step + 1) % 10 == 0 or step == start_step:
                print(f"step {step+1:5d} loss {rec['loss']:.4f} "
                      f"gnorm {rec['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
    finally:
        stream.close()
        logger.close()
        guard.uninstall()
    save(args.steps)
    print(f"done: {args.steps - start_step} steps, "
          f"{len(monitor.flagged)} straggler events")
    return {"records": records, "state": state, "stopped": False}


def main(argv: Optional[List[str]] = None) -> int:
    run_training(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
