"""Batched serving on the PyTorch port: prefill a batch of prompts, decode
with a KV cache, sample with temperature — across any of the ten
architectures.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch zamba2-7b]
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The twin of ``examples/serve_lm.py``: the same argv into the port's serve
driver (``repro_torch.launch.serve.main``), smoke-sized, with ``--device``
added.  On the card the layer projections run the hand-written Hopper
GEMM and prefill attention the flash kernel; without CUDA it raises unless
``--device cpu`` is given.
"""
import argparse
import sys

from repro_torch.launch import serve
from repro_torch.nn.model import resolve_device


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent CPU run")
    return ap


def serve_argv(args):
    """The serve driver's flags for this example's settings."""
    return ["--arch", args.arch, "--smoke", "--batch", str(args.batch),
            "--prompt-len", "24", "--gen", str(args.gen),
            "--device", args.device]


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    sys.argv = ["serve", *serve_argv(args)]
    return serve.main()


if __name__ == "__main__":
    raise SystemExit(main())
