"""Quickstart on the PyTorch port: zero-autotuning GEMM — select, run,
verify.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of ``examples/quickstart.py``: the same problem selected against
the port's topology (gpu_h100_like) instead of tpu_v5e, then run at the
selected config through ``repro_torch.kernels.ops.matmul``, which on the
card launches the hand-written Hopper GEMM (``csrc/matmul.cu``: persistent
stream-K, wgmma + TMA), and held to the plain product
(``repro_torch.kernels.ref.matmul_ref``) on the same device.  Without CUDA
it raises unless ``--device cpu`` is given; there the wrapper takes its
plain version, and the error line says so.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import GemmProblem
from repro_torch.core.selector import rank_candidates, select_gemm_config
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul_ref
from repro_torch.nn.model import resolve_device

# 1. A GEMM problem: C[M,N] = A[M,K] @ B[K,N].
M, N, K = 1024, 2048, 512


def select():
    """The selection and the top 5 of the ranking on gpu_h100_like."""
    sel = select_gemm_config(M, N, K, in_dtype="bfloat16", hw=GPU_H100_LIKE)
    top = rank_candidates(GemmProblem(M=M, N=N, K=K), GPU_H100_LIKE)[:5]
    return sel, top


def operands(device):
    """A (M, K) and B (K, N) in bf16 from the reference's numpy draws."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=torch.bfloat16) for shape in ((M, K), (K, N)))


def product(a, b, config):
    """The fused GEMM at ``config``, f32 out: the kernel on a CUDA tensor,
    its plain version on a CPU one."""
    return ops.matmul(a, b, out_dtype=torch.float32, config=config)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent CPU run")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 2. Deterministic analytical selection (microseconds, no autotuning).
    sel, top = select()
    print("selected:", sel)
    print(f"  predicted {sel.predicted.total*1e6:.1f} us on {sel.hardware}, "
          f"bottleneck: {sel.predicted.bottleneck}")
    print(f"  candidate space: {sel.n_candidates} configs "
          f"(an autotuner would compile+benchmark every one)")

    # 3. Top of the ranking — what the model believes about the space.
    print("\ntop-5 candidates by predicted latency:")
    for cfg, pred in top:
        print(f"  {str(cfg):22s} {pred.total*1e6:8.1f} us  {pred.bottleneck}")

    # 4. Run the GEMM with the selected tiling: on the card the Hopper
    #    kernel, on the CPU its plain version.
    a, b = operands(device)
    n0 = kmm.tiled_matmul.launches
    out = product(a, b, sel.config)
    if device.type == "cuda":
        torch.cuda.synchronize()
        assert kmm.tiled_matmul.launches == n0 + 1, "the kernel did not run"
    want = matmul_ref(a, b, out_dtype=torch.float32)
    err = float((out - want).abs().max())
    what = ("Hopper kernel" if device.type == "cuda"
            else "plain version (CPU, no kernel)")
    print(f"\n{what} vs torch oracle: max |err| = {err:.3e}")
    assert err < 0.3 * np.sqrt(K)
    print("OK")
    return err


if __name__ == "__main__":
    main()
