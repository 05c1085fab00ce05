"""End-to-end driver on the PyTorch port: train a ~100M-param LM with the
library API.

    PYTHONPATH=src python examples/train_lm_torch.py      # small, the card
    PYTHONPATH=src python examples/train_lm_torch.py --d-model 768 \
        --layers 12 --steps 300                           # ~100M params
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \
        --steps 5 --seq 64                                # plain versions

The twin of ``examples/train_lm.py``: the same model (phi4-mini's smoke
config widened by the flags, remat on), AdamW with warmup-cosine, the
deterministic data stream behind a prefetcher and the straggler monitor,
with the port's train step (``launch/steps.py``).  It runs in one process
with no mesh: the reference's ``make_local_mesh()`` on one device is a
(1, 1) mesh, and the port takes the path ``launch/train.py`` takes at
``--tp 1``.  Params come from a ``torch.Generator`` seeded 0.  On the card
every GEMM of the forward, its recompute and the backward runs the
hand-written Hopper GEMM, attention the flash kernels forward and
backward, and the gated MLP's gradient the epilogue-backward kernel;
without CUDA it raises unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.nn.model import Model, resolve_device
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime import StragglerMonitor


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent CPU run")
    return ap


def example_config(args):
    return dataclasses.replace(
        get_config("phi4-mini-3.8b", smoke=True),
        name="example-lm", num_layers=args.layers, d_model=args.d_model,
        num_heads=args.heads, num_kv_heads=max(1, args.heads // 2),
        head_dim=args.d_model // args.heads, d_ff=4 * args.d_model,
        vocab_size=args.vocab, remat=True)


def data_stream(cfg, args):
    """The batches, as the reference draws them, behind a prefetcher."""
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch))
    return Prefetcher(data.iterate(0), depth=2)


def train(args, params=None):
    """Train as the flags say; ``params`` (default: drawn from a generator
    seeded 0) are updated in place.  Returns every step's loss."""
    device = resolve_device(args.device)
    cfg = example_config(args)
    model = Model(cfg, device=device)
    print(f"params: {model.param_count()/1e6:.1f}M  devices: 1")

    opt = AdamW(lr=warmup_cosine(args.lr, 20, args.steps))
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0))
    state = TrainState(params=params, opt=opt.init(params), step=0)
    step_fn = make_train_step(model, opt)

    stream = data_stream(cfg, args)
    monitor = StragglerMonitor()

    losses = []
    t_start = time.time()
    for step in range(args.steps):
        batch = {"tokens": next(stream)["tokens"]}
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        monitor.record(time.time() - t0)
        losses.append(loss)
        if (step + 1) % 25 == 0:
            toks = args.batch * args.seq * (step + 1)
            print(f"step {step+1:4d}  loss {loss:.4f}  "
                  f"{toks/(time.time()-t_start):,.0f} tok/s")
    stream.close()
    print(f"\nloss {losses[0]:.3f} -> {loss:.3f} over {args.steps} steps "
          f"({len(monitor.flagged)} straggler events)")
    assert loss < losses[0]
    return losses


def main(argv=None):
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
