#!/usr/bin/env python3
"""Time every candidate configuration of the grouped GEMM's backward on one
card: the selection against the best of the menu, and against torch.bmm.

    python3 tools/expert_bwd_sweep.py [--top N]

For qwen3-moe-30b-a3b's expert GEMMs at its training shape (128 experts of
capacity 160, d_model 2048, expert d_ff 768) it takes the gradient products
of wu (wg's are the same shapes) and wd: dX_e = dZ_e W_e^T, w read
transposed ("nt"), and dW_e = X_e^T dZ_e, x read transposed ("tn").  For
each it ranks the selector's candidate space on ``GPU_H100_LIKE`` with the
latency model (``rank_candidates``), then launches the grouped kernel on
every candidate: each output must first agree with the plain product
(``tests/test_kernels.py``'s bf16 tolerance), then it is timed with
``chip_smoke.py``'s ``event_ms`` (CUDA events around back-to-back calls;
the kernels run far longer than the host takes to issue them), as is
``torch.bmm`` on the same operands.  One JSON line a shape goes to standard
output, with the selected config's time, model rank and achieved HBM rate
(each operand read once and the output written once, over the time), the
bytes its walk reads under ``kernels/matmul.py::l2_reckoning``, the
fastest config's time, rank and rate, the library's time and rate, the
bytes bound, the ``--top`` fastest candidates (config, ms, model rank,
TB/s), and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
E, C, D, F = 128, 160, 2048, 768


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("expert_bwd_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    import chip_smoke as cs
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import GemmProblem
    from repro_torch.core.selector import (rank_candidates,
                                           select_gemm_config)
    from repro_torch.kernels import matmul as kmm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(31)

    def rnd(*shape, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)
    for name, K_in, N_out in (("wu", D, F), ("wd", F, D)):
        x, w = rnd(E, C, K_in, scale=0.1), rnd(E, K_in, N_out, scale=0.02)
        dz = rnd(E, C, N_out, scale=0.1)
        for layout in ("nt", "tn"):
            if layout == "nt":
                a, b, (M, N, K) = dz, w, (C, K_in, N_out)
                library = lambda: torch.bmm(dz, w.transpose(1, 2))  # noqa: E731
            else:
                a, b, (M, N, K) = x, dz, (K_in, N_out, C)
                library = lambda: torch.bmm(x.transpose(1, 2), dz)  # noqa: E731
            kw = dict(out_dtype=bf, epilogue=None, bias=None, gate=None,
                      residual=None, trans_a=layout == "tn",
                      trans_b=layout == "nt")
            ranked = [t for t, _ in rank_candidates(
                GemmProblem(M, N, K, in_dtype="bfloat16",
                            out_dtype="bfloat16"), GPU_H100_LIKE)]
            sel = select_gemm_config(M, N, K, in_dtype="bfloat16",
                                     out_dtype="bfloat16",
                                     hw=GPU_H100_LIKE).config
            want = kmm.expert_matmul_plain(a, b, sel, **kw).float()
            rtol, atol = cs.gemm_tol(bf, K)
            times, wrong = {}, []
            for cfg in ranked:
                got = kmm._launch_expert_cuda(a, b, cfg, **kw).float()
                if not bool(((got - want).abs()
                             <= atol + rtol * want.abs()).all()):
                    wrong.append(str(cfg))
                    continue
                del got
                times[cfg] = cs.event_ms(
                    torch, lambda: kmm._launch_expert_cuda(a, b, cfg, **kw),
                    calls=5, reps=3)
            order = sorted(times, key=times.get)
            best = order[0]
            nbytes, _ = cs._gemm_bytes_flops(M, N, K, "none")
            nbytes *= E

            def tbs(ms):   # achieved HBM rate of the bound's bytes
                return nbytes / ms * 1e-9
            lib_ms = cs.event_ms(torch, library, calls=5, reps=3)
            walk = kmm.l2_reckoning(kmm.work_plan(M, N, K, sel, E,
                                                  kmm._sm_count(0)),
                                    cs.L2_BYTES)
            print(json.dumps({
                "gemm": f"{name} {'dX' if layout == 'nt' else 'dW'}",
                "layout": layout, "experts": E, "M": M, "N": N, "K": K,
                "candidates": len(ranked), "wrong": wrong,
                "selected": str(sel), "selected_ms": times.get(sel),
                "selected_model_rank": ranked.index(sel) + 1,
                "selected_hbm_tbs": tbs(times[sel]) if sel in times
                else None,
                "selected_walk_bytes": walk["a"] + walk["b"] + walk["out"],
                "best": str(best), "best_ms": times[best],
                "best_model_rank": ranked.index(best) + 1,
                "best_hbm_tbs": tbs(times[best]),
                "library_ms": lib_ms, "library_hbm_tbs": tbs(lib_ms),
                "bound_ms": nbytes / cs.HBM_BW * 1e3,
                "top": [[str(c), times[c], ranked.index(c) + 1,
                         tbs(times[c])] for c in order[:args.top]],
                "nvidia_smi": smi}), flush=True)
            del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
