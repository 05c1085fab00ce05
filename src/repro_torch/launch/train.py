"""Fault-tolerant training driver of the port, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --steps 6 --batch 4 --seq 512

    # the same path on the CPU at smoke size (plain PyTorch versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --smoke --device cpu --steps 4 --ckpt-dir /tmp/ckpt

    # data-parallel, FSDP and tensor-parallel over 4 gloo ranks on the CPU
    # (a (data 2, model 2) mesh):
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --smoke --device cpu --tp 2 --ranks 4 --steps 4

The reference's features (``repro/launch/train.py``):
  * sharded state on a ("data", "model") mesh of every rank, (world / tp,
    tp): tensor and expert parallelism on "model", the batch's rows and
    FSDP (``cfg.fsdp``: the "embed" dims) on "data";
  * checkpoint/restart (atomic, hashed, the reference's on-disk format;
    elastic: each rank restores its block, whatever mesh wrote it);
  * preemption hook (SIGTERM -> checkpoint -> clean exit);
  * straggler monitor (z-score step times), bounded retry on transients:
    of a step's loss and gradients only, which mutate nothing, while the
    optimizer's in-place commit runs once (``launch/steps.py``); on a
    mesh the step's collectives span the ranks, so no rank retries alone;
  * deterministic restart-safe data stream + background prefetch: every
    rank reads the global batch and keeps its rows.
On the card every GEMM of the forward pass, of its recompute (``remat``)
and of the backward runs the hand-written Hopper GEMM (the MoE's expert
GEMMs and their gradients the grouped one), every attention forward and
backward the flash kernels, each rank at its local shapes.  Every family
of the port trains: dense (phi4-mini-3.8b, minitron-8b, stablelm-12b,
internlm2-20b), MoE (qwen3-moe-30b-a3b, mixtral-8x22b), SSM (mamba2-370m),
hybrid (zamba2-7b), audio (musicgen-large) and vlm
(llava-next-mistral-7b), every one over both axes (the SSM and hybrid
families split their SSM heads over "model", ``--tp`` dividing them,
``launch/mesh.py::check_tp``).  A model with a frontend gets
synthetic frontend inputs, drawn once from a generator seeded 1 (as
``repro/launch/train.py:93-96`` draws them from PRNGKey(1)), in every
batch, each rank its rows.  There is no ``--compress-dp``: the reference
names it only in its docstring (its parser has none); the int8 functions
are ``optim/compression.py``'s.

The ranks: one a card over NCCL, as many as the host has cards (the
reference's ``jax.device_count()``); ``--shared-card`` puts ``--ranks``
ranks on ``cuda:0`` over gloo (collectives staged through the host, for a
host with one card); ``--device cpu`` runs ``--ranks`` gloo ranks on the
CPU.  ``--ranks`` defaults to ``--tp``.  The ranks are spawned here, or
started by ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set).  Only rank 0
prints and logs.  At full size (bf16 params and grads, f32 AdamW moments:
12 bytes a parameter) phi4-mini-3.8b needs about 46 GB for its state,
musicgen-large about 29 GB and mamba2-370m about 4.4 GB, plus
activations; the others do not fit one card at full depth (minitron-8b
about 119 GB, llava-next-mistral-7b 87 GB, stablelm-12b 146 GB,
internlm2-20b 238 GB, zamba2-7b 81 GB, qwen3-moe 366 GB, mixtral-8x22b
1.7 TB) and need a mesh of cards (ROADMAP A5b).  A sliding window
(mixtral-8x22b) trains on the card too: the flash forward and backward
kernels take it in both dtypes; on the CPU it trains through the plain
versions.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch import meshctx
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.distributed.sharding import local_batch, opt_shardings
from repro_torch.kernels import build
from repro_torch.launch.mesh import (check_tp, init_distributed,
                                     make_local_mesh, spawn_ranks)
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.nn.frontends import synth_frontend_inputs
from repro_torch.nn.model import Model, resolve_device
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
    ap.add_argument("--tp", type=int, default=1, help="model-axis size")
    ap.add_argument("--shared-card", action="store_true",
                    help="every rank on cuda:0 over gloo (one card)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="the rank count of --shared-card and --device cpu "
                         "(default: --tp); on the card without "
                         "--shared-card it is the host's card count")
    return ap


# Spawned ranks must be done within this (seconds).
TRAIN_RANKS_TIMEOUT_S = 24 * 3600.0


def world_size(args: argparse.Namespace) -> int:
    """The ranks the flags ask for: ``--ranks`` (default ``--tp``) on the
    CPU and with ``--shared-card``, else one a card of the host."""
    if resolve_device(args.device).type == "cpu" or args.shared_card:
        return args.ranks or args.tp
    if args.ranks is not None:
        raise ValueError("--ranks is a flag of --shared-card and --device "
                         "cpu; on the card the ranks are the host's cards")
    return torch.cuda.device_count()


def run_training(args: argparse.Namespace) -> Dict:
    """Train as the flags say; returns {"records": the logged step
    records, "state": the final TrainState, "stopped": preempted}.  Flags
    that ask for more than one rank, with no mesh installed, run
    :func:`train_ranks` (rank 0's records, no state)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = meshctx.get_mesh()
    if mesh is None and (args.tp > 1 or world_size(args) > 1):
        return train_ranks(args)
    rank = 0
    if mesh is not None:
        import torch.distributed as dist
        rank = dist.get_rank()
    lead = rank == 0
    say = print if lead else (lambda *a, **k: None)
    model = Model(cfg, device=args.device)
    say(f"arch={cfg.name} device={model.device}"
        + (f" mesh={dict(mesh.shape)}" if mesh is not None else ""))

    opt = AdamW(lr=warmup_cosine(args.lr, args.warmup, args.steps))
    train_step = make_train_step(model, opt)
    specs = train_step.specs
    state_specs = None if specs is None else TrainState(
        params=specs, opt=opt_shardings(specs), step=())

    start_step = 0
    if args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        params = model.abstract_params()
        template = TrainState(params=params, opt=opt.init(params), step=0)
        start_step, state = ckpt_lib.restore(
            args.ckpt_dir, template, device=model.device,
            shardings=state_specs, mesh=mesh, rank=rank)
        say(f"restored checkpoint at step {start_step}")
    else:
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = (model.init(gen) if mesh is None
                  else model.init_shards(gen, mesh, rank))
        state = TrainState(params=params, opt=opt.init(params), step=0)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch,
                                  seed=args.seed))
    stream = Prefetcher(data.iterate(start_step), depth=2)
    extras = synth_frontend_inputs(
        cfg, torch.Generator(device=model.device).manual_seed(1), args.batch,
        args.seq, device=model.device)

    def rows(batch):
        return batch if mesh is None else local_batch(batch, mesh, rank)

    extras = rows(extras)
    guard = PreemptionGuard()
    monitor = StragglerMonitor()
    logger = MetricLogger(args.log if lead else None)
    records: List[Dict] = []

    def save(step):
        if args.ckpt_dir:
            path = ckpt_lib.save(args.ckpt_dir, step, state,
                                 extra_meta={"arch": cfg.name},
                                 shardings=state_specs, mesh=mesh)
            say(f"checkpointed step {step} -> {path}")

    try:
        for step in range(start_step, args.steps):
            if guard.should_stop:
                say("preemption signal: checkpointing and exiting")
                save(step)
                return {"records": records, "state": state,
                        "stopped": True}
            batch = {**rows(next(stream)), **extras}
            t0 = time.time()
            loss, grads = retry(train_step.loss_and_grads, state.params,
                                batch, retries=2 if mesh is None else 0)
            state, metrics = train_step.apply(state, loss, grads)
            del grads
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = time.time() - t0
            warn = monitor.record(dt)
            if warn:
                say(warn)
            rec = logger.log(step + 1, loss=loss, grad_norm=gnorm,
                             lr=metrics["lr"], step_time=dt)
            records.append(rec)
            if (step + 1) % 10 == 0 or step == start_step:
                say(f"step {step+1:5d} loss {rec['loss']:.4f} "
                    f"gnorm {rec['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
    finally:
        stream.close()
        logger.close()
        guard.uninstall()
    save(args.steps)
    say(f"done: {args.steps - start_step} steps, "
        f"{len(monitor.flagged)} straggler events")
    return {"records": records, "state": state, "stopped": False}


def _train_rank(rank: int, world: int, init_method: str,
                args: argparse.Namespace) -> Optional[Dict]:
    """One rank of a sharded run: join the group, install the (data,
    model) mesh, train; rank 0's records (the others' None)."""
    import torch.distributed as dist
    dev = init_distributed(rank, world, init_method, device=args.device,
                           shared_card=args.shared_card)
    if dev.type == "cpu":           # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    meshctx.set_mesh(make_local_mesh(args.tp, device_type=dev.type))
    try:
        rank_args = argparse.Namespace(**vars(args))
        rank_args.device = str(dev)
        out = run_training(rank_args)
    finally:
        meshctx.set_mesh(None)
        dist.destroy_process_group()
    if rank != 0:
        return None
    return {"records": out["records"], "stopped": out["stopped"],
            "world": world}


def train_ranks(args: argparse.Namespace) -> Optional[Dict]:
    """The ranks of a sharded run: spawned here (all done within
    ``TRAIN_RANKS_TIMEOUT_S`` or all killed; on the card the kernels are
    built here first, once), or this process is one rank under
    ``torchrun``.  Returns rank 0's {"records", "stopped", "world"} (None
    on the other ranks under torchrun)."""
    check_tp(get_config(args.arch, smoke=args.smoke), args.tp)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _train_rank(int(os.environ["RANK"]),
                           int(os.environ["WORLD_SIZE"]), "env://", args)
    if resolve_device(args.device).type == "cuda":
        build.build(("matmul", "flash_attention"))   # once, not once a rank
    return spawn_ranks(_train_rank, world_size(args), (args,),
                       timeout=TRAIN_RANKS_TIMEOUT_S)[0]


def main(argv: Optional[List[str]] = None) -> int:
    run_training(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
