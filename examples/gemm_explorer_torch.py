"""GEMM explorer on the PyTorch port: inspect the analytical model's view
of a problem.

    PYTHONPATH=src python examples/gemm_explorer_torch.py --m 4096 \
        --n 4096 --k 4096 [--dtype bfloat16] [--hw gpu_h100_like] [--top 10]

The twin of ``examples/gemm_explorer.py``, from the port's own copy of the
model (``repro_torch.core``): the ranked candidate table (predicted
latency, bottleneck, reuse), the simulator's cross-check, per-level byte
splits on multi-level topologies (--hw gpu_mi300x_like / gpu_h100_like),
and how the choice changes across hardware presets (paper Fig. 5
portability).  ``--hw`` defaults to the port's topology, gpu_h100_like.
Its lines are the reference's, so the two outputs diff line for line at
the same flags.  It computes nothing on a device.
"""
import argparse

from repro_torch.core.hardware import get_hardware
from repro_torch.core.latency import GemmProblem, reuse_fraction
from repro_torch.core.selector import rank_candidates, select_gemm_config
from repro_torch.core.simulator import simulate_gemm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--hw", default="gpu_h100_like")
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args()

    hw = get_hardware(args.hw)
    p = GemmProblem(M=args.m, N=args.n, K=args.k, in_dtype=args.dtype)
    print(f"problem: {args.m}x{args.n}x{args.k} {args.dtype} on {hw.name}")
    print(f"  {p.flops/1e9:.2f} GFLOP, arithmetic intensity "
          f"{p.arithmetic_intensity:.1f} flops/byte\n")

    ranked = rank_candidates(p, hw)
    print(f"{len(ranked)} candidates; top {args.top}:")
    print(f"{'config':24s} {'model us':>9s} {'sim us':>9s} "
          f"{'TF/s(sim)':>9s} {'reuse':>6s}  bottleneck")
    for cfg, pred in ranked[:args.top]:
        sim = simulate_gemm(p, cfg, hw)
        print(f"{str(cfg):24s} {pred.total*1e6:9.1f} {sim.time*1e6:9.1f} "
              f"{p.flops/sim.time/1e12:9.1f} "
              f"{reuse_fraction(p, cfg, hw):6.2f}  {pred.bottleneck}")

    if hw.cache_levels:
        best_cfg, best_pred = ranked[0]
        sim = simulate_gemm(p, best_cfg, hw)
        print(f"\nper-level bytes for {best_cfg} "
              f"(model | simulator reuse distances):")
        for name_, b in best_pred.level_bytes.items():
            print(f"  {name_:6s} {b/1e6:12.1f} MB | "
                  f"{sim.level_bytes.get(name_, 0.0)/1e6:12.1f} MB")

    print("\nportability (same model, constants swapped — paper Fig. 5):")
    for name in ("tpu_v5e", "tpu_v5p", "tpu_v4", "gpu_mi300x_like",
                 "gpu_h100_like"):
        s = select_gemm_config(args.m, args.n, args.k, in_dtype=args.dtype,
                               hw=get_hardware(name))
        print(f"  {name:16s} -> {str(s.config):20s} "
              f"{s.predicted.total*1e6:9.1f} us  "
              f"{s.predicted_tflops:6.1f} TF/s  {s.predicted.bottleneck}")


if __name__ == "__main__":
    main()
