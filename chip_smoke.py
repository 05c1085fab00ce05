#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero:

1. build    — compile every CUDA source (one nvcc each, all at once) and
              record the card (``nvidia-smi`` name and power limit).
2. gemm     — the GEMM kernel against its plain version on the card: the
              phi4-mini step shapes at M = 4 and 512 with the path's
              epilogues, gelu/silu/bias at one shape each, forced configs
              at the menu's corners, group_m > 1 on ragged M/N/K, stream-K
              strips and split-K shard ranges that do not line up with
              tiles, and f32 inputs/outputs.  Every case launches twice and
              must repeat bitwise (``deterministic``) with every fixup flag
              down again; one split launch replays in a CUDA graph.
3. flash    — the flash-attention kernel against its plain version:
              (2, 24, S, 128) q over (2, 8, S, 128) k/v, causal and not,
              S in {512, 1000}; the served prefill shapes (phi4-mini 24/8
              heads at S = 336 and 474, qwen3-moe 32/4 at 474) with v as
              the model passes it (a transposed view); S = 40, shorter
              than a q block; every pair of the block menu; bf16.  Every
              case launches twice and must repeat bitwise.
   expert_gemm — the grouped GEMM kernel (the same source, the expert axis
              in the work space) against its plain version: qwen3-moe's
              three prefill expert GEMMs at capacity 40 and 32 with their
              epilogues, bias and residual at one shape each, ragged
              capacity 24, padded ragged K/N, forced corner configs,
              grouped stream-K and split-K, f32; bitwise repeat as above.
4. serve    — ``run_serving`` for phi4-mini-3.8b at full width and depth
              (random weights from a seed), 8 ragged requests of 256-512
              prompt tokens, batch 4, 16 generated tokens each, on the
              priced bucket plan.  Launch counts are zeroed right before
              and read right after; both kernels must have launched, no
              fallback rung or launch retry may have fired, every request
              must finish, and one request's prefill logits must match
              the plain path (the same model code with each kernel launch
              replaced by its plain version) on the card.
   trace    — one prefill and four decode steps under torch.profiler:
              device kernel time by kernel and the device's idle share.
5. serve_moe — phi4-mini's params freed, the same traffic served by
              qwen3-moe-30b-a3b at full width and depth (48 layers, 128
              experts top-8; 61 GB of bf16 random weights from a seed).
              All three kernels must have launched in the run, the grouped
              GEMM exactly 3 x 48 times per prefill and never in decode;
              no fallback rung or retry; every request finishes.  Logits:
              kernel path vs plain path vs plain f32 on the first 4 layers
              (the f32 yardstick as in phase 4), and kernel vs plain at
              full depth within ``MOE_FULL_REL_CAP``.
   moe_trace — the trace phase for qwen3-moe, grouped GEMM time apart.
6. times    — each kernel at the main-path shapes: kernel, plain and
              one-call library times (CUDA graphs and events) and
              the bound max(flop / 989e12, bytes / 3.35e12); each GEMM row
              also gives its grid (``ctas``), its split tiles, the latency
              model's prediction (``model_ms``) and the wrapper's host
              microseconds per call; each attention row (phi4-mini and
              qwen3-moe at their largest edge) its selected blocks, grid
              and ``model_ms``, and every menu pair's time beside its
              price.

The line before the last is the kernels summary; the last line is
``{"ok": true, "device": {...}}``.  With no CUDA device, or run from a
directory without the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

BF16_PEAK = 989e12          # H100 SXM dense bf16 tensor-core flop/s
HBM_BW = 3.35e12            # H100 SXM HBM3 bytes/s
# Prefill logits of the kernel path vs the plain path (relative L2): both
# are bf16 computations, so the yardstick is the plain path's own distance
# from its f32 run; two independent roundings of that size differ by ~1.4x.
LOGITS_REL_FACTOR = 2.0
LOGITS_REL_CAP = 0.1
# qwen3-moe at full depth has no f32 yardstick (an f32 copy of 61 GB of
# params does not fit beside them).  Top-8 of 128 routing flips where bf16
# noise moves a router logit across the 8th/9th gap, and each flip swaps
# an expert out of a token's sum, so the kernel and plain paths drift
# further apart than rounding alone would take them (predicted relative L2
# 0.1-0.3 over all positions' logits; a wrong kernel gives ~1).
MOE_FULL_REL_CAP = 0.5
MOE_CUT_LAYERS = 4
FLASH_ATOL, FLASH_RTOL = 1e-2, 2e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gemm_tol(dtype, K):
    """tests/test_kernels.py:26-27."""
    import torch
    if dtype == torch.float32:
        return 1e-5, 1e-4 * math.sqrt(K)
    return 3e-2, 0.3 * math.sqrt(K)


def time_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph
    (after three warm-up calls), the graph replayed ``reps`` times between
    CUDA events, the median replay divided by ``calls``.  The graph takes
    the host's launch overhead out of the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    report = build.build()
    summary = {}
    for name, (sec, log) in report.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "C75" in ln]
        summary[name] = {"seconds": round(sec, 2), "ptxas": lines}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": summary})

    max_err = {"matmul": gemm_phase(torch, dev, kmm),
               "flash_attention": flash_phase(torch, dev, kfa),
               "expert_matmul": expert_gemm_phase(torch, dev, kmm)}
    model, params, launches, edges = serve_phase(torch, dev, kmm, kfa)
    trace_phase(torch, dev, model, params)
    del model, params
    _free(torch)
    model, params, moe_launches, moe_capacity, moe_edge = serve_moe_phase(
        torch, dev, kmm, kfa)
    trace_phase(torch, dev, model, params, phase="moe_trace")
    del model, params
    _free(torch)
    times = times_phase(torch, dev, kmm, kfa, edges, moe_capacity, moe_edge)
    launches["expert_matmul"] = moe_launches["expert_matmul"]

    entries = []
    for key, base, source, replaces in (
            ("matmul@decode", "matmul", "src/repro_torch/csrc/matmul.cu",
             "src/repro/kernels/matmul.py:108"),
            ("matmul@prefill", "matmul", "src/repro_torch/csrc/matmul.cu",
             "src/repro/kernels/matmul.py:108"),
            ("flash_attention@prefill", "flash_attention",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:136"),
            ("expert_matmul@prefill", "expert_matmul",
             "src/repro_torch/csrc/matmul.cu",
             "src/repro/kernels/ops.py:308")):
        t = times[key]
        entries.append({"name": key, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[base],
                        "max_abs_err": max_err[base],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def _free(torch) -> None:
    """Return a finished model's memory to the card before the next."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 2: the GEMM kernel against its plain version.
# ---------------------------------------------------------------------------

def _gemm_inputs(torch, dev, M, N, K, ep, dt, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(dt)
    kw = {}
    if ep.bias:
        kw["bias"] = rnd(N)
    if ep.activation == "swiglu_gate":
        kw["gate"] = rnd(M, N)
    if ep.residual:
        kw["residual"] = rnd(M, N)
    return rnd(M, K), rnd(K, N), kw


def gemm_phase(torch, dev, kmm) -> float:
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import Epilogue, TileConfig
    from repro_torch.core.selector import select_gemm_config
    from repro_torch.kernels.ops import _dtype_name, _model_dtype_name

    bf, f32 = torch.bfloat16, torch.float32
    none, res = Epilogue(), Epilogue(residual=True)
    swi = Epilogue(activation="swiglu_gate")
    cases = []
    for M in (4, 512):                       # the phi4-mini step GEMMs
        cases += [(M, 3072, 3072, none, bf, bf, None),     # wq
                  (M, 1024, 3072, none, bf, bf, None),     # wk, wv
                  (M, 3072, 3072, res, bf, bf, None),      # wo + residual
                  (M, 8192, 3072, none, bf, bf, None),     # wu
                  (M, 8192, 3072, swi, bf, bf, None),      # wg + swiglu gate
                  (M, 3072, 8192, res, bf, bf, None)]      # wd + residual
    cases += [
        (512, 3072, 3072, Epilogue(activation="gelu"), bf, bf, None),
        (4, 8192, 3072, Epilogue(activation="silu"), bf, bf, None),
        (512, 1024, 3072, Epilogue(bias=True), bf, bf, None),
        # forced configs at the menu's corners
        (100, 300, 77, res, bf, bf, TileConfig(32, 32, 32)),
        (512, 3072, 3072, none, bf, bf, TileConfig(256, 128, 128)),
        (4, 3072, 3072, none, bf, bf, TileConfig(32, 256, 128)),
        (520, 1000, 3072, res, bf, bf, TileConfig(256, 256, 32)),
        # group_m > 1 with a ragged final group, ragged M/N/K
        (333, 200, 264, swi, bf, bf, TileConfig(64, 64, 64, group_m=4)),
        (1000, 1000, 1000, none, bf, bf,
         TileConfig(128, 64, 64, group_m=8, schedule="stream_k")),
        # stream-K strips and split-K shard ranges that do not line up with
        # tiles: several CTAs' partials summed into one tile
        (64, 128, 2048, none, bf, f32, TileConfig(64, 128, 64, split_k=4)),
        (512, 3072, 8192, res, bf, bf,
         TileConfig(256, 128, 128, group_m=2, schedule="stream_k")),
        (300, 1000, 1000, Epilogue(bias=True), bf, bf,
         TileConfig(128, 64, 64, group_m=4, schedule="stream_k")),
        (100, 1000, 1000, Epilogue(activation="gelu"), bf, bf,
         TileConfig(64, 128, 64, split_k=4)),
        (384, 4096, 1024, none, bf, bf, TileConfig(128, 128, 64, split_k=4)),
        (4, 8192, 3072, res, bf, bf, TileConfig(32, 128, 32, split_k=8)),
        (100, 300, 1000, res, f32, f32,
         TileConfig(64, 64, 32, schedule="stream_k")),
        # f32 inputs (SIMT path) and bf16 -> f32 outputs
        (128, 256, 512, none, f32, f32, None),
        (100, 300, 77, Epilogue(bias=True, activation="gelu"), f32, f32,
         TileConfig(64, 64, 32)),
        (512, 3072, 3072, swi, bf, f32, None),
    ]
    worst = 0.0
    rows = []
    for i, (M, N, K, ep, dt, odt, cfg) in enumerate(cases):
        if cfg is None:
            cfg = select_gemm_config(M, N, K, in_dtype=_dtype_name(dt),
                                     out_dtype=_model_dtype_name(odt),
                                     epilogue=ep, hw=GPU_H100_LIKE).config
        a, b, kw = _gemm_inputs(torch, dev, M, N, K, ep, dt, seed=i)
        got = kmm.tiled_matmul(a, b, cfg, out_dtype=odt, epilogue=ep, **kw)
        again = kmm.tiled_matmul(a, b, cfg, out_dtype=odt, epilogue=ep, **kw)
        want = kmm.matmul_plain(a, b, cfg, out_dtype=odt, epilogue=ep, **kw)
        torch.cuda.synchronize()
        rtol, atol = gemm_tol(dt, K)
        err = (got.float() - want.float()).abs()
        bound = atol + rtol * want.float().abs()
        det = _deterministic(torch, dev, kmm, got, again)
        ok = bool((err <= bound).all()) and bool(torch.isfinite(got).all())
        rel = float(torch.linalg.vector_norm(got.float() - want.float())
                    / torch.linalg.vector_norm(want.float()))
        plan = _plan(kmm, dev, M, N, K, cfg, 1)
        rows.append({"shape": [M, N, K], "epilogue": str(ep),
                     "in": str(dt)[6:], "out": str(odt)[6:],
                     "config": str(cfg), "ctas": plan.ctas,
                     "split_tiles": plan.split_tiles,
                     "max_abs_err": float(err.max()), "rel_l2": rel,
                     "deterministic": det, "ok": ok and det})
        if not ok or not det:
            emit({"phase": "gemm", "cases": rows})
            fail(f"gemm {M}x{N}x{K} {ep} {cfg} disagrees with its plain "
                 f"version (max abs err {float(err.max())}, atol {atol}, "
                 f"rtol {rtol}) or does not repeat (deterministic {det})")
        worst = max(worst, float(err.max()))
    graph = _graph_case(torch, dev, kmm)
    emit({"phase": "gemm", "tolerance": "tests/test_kernels.py:26-27: f32 "
          "rtol 1e-5 atol 1e-4*sqrt(K); bf16 rtol 3e-2 atol 0.3*sqrt(K)",
          "deterministic": "two launches bitwise equal, every fixup flag "
          "down after them", "cases": rows, "cuda_graph": graph})
    if not graph["ok"]:
        fail(f"a split GEMM launch replayed in a CUDA graph differs from "
             f"its eager launch ({graph})")
    return worst


def _plan(kmm, dev, M, N, K, cfg, groups):
    """The work plan the wrapper launches (K and N padded to 8)."""
    return kmm.work_plan(M, N + (-N) % 8, K + (-K) % 8, cfg, groups,
                         kmm._sm_count(dev.index))


def _deterministic(torch, dev, kmm, got, again) -> bool:
    """Two launches on the same inputs are bitwise equal and leave every
    fixup flag down."""
    return bool(torch.equal(got, again)) and _flags_down(kmm)


def _flags_down(kmm) -> bool:
    """Every stream's fixup flags are zero again."""
    return all(int(f.abs().sum()) == 0 for _, _, f in kmm._SCRATCH.values())


def _graph_case(torch, dev, kmm):
    """A split stream-K launch (phi4's decode wo + residual) captured in a
    CUDA graph and replayed twice: both replays equal the eager launch."""
    from repro_torch.core.latency import Epilogue, TileConfig
    cfg = TileConfig(32, 256, 128, schedule="stream_k")
    ep = Epilogue(residual=True)
    a, b, kw = _gemm_inputs(torch, dev, 4, 3072, 3072, ep, torch.bfloat16,
                            seed=99)
    bf = torch.bfloat16
    n0 = kmm.tiled_matmul.launches
    eager = kmm.tiled_matmul(a, b, cfg, out_dtype=bf, epilogue=ep, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kmm.tiled_matmul(a, b, cfg, out_dtype=bf, epilogue=ep, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kmm.tiled_matmul(a, b, cfg, out_dtype=bf, epilogue=ep, **kw)
    equal = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        equal.append(bool(torch.equal(out, eager)))
    kmm.tiled_matmul.launches = n0
    down = _flags_down(kmm)
    return {"config": str(cfg), "shape": [4, 3072, 3072],
            "split_tiles": _plan(kmm, dev, 4, 3072, 3072, cfg, 1).split_tiles,
            "replays_equal_eager": equal, "flags_down": down,
            "ok": all(equal) and down}


# ---------------------------------------------------------------------------
# Phase 3: the flash-attention kernel against its plain version.
# ---------------------------------------------------------------------------

# (B, H, Hkv, S, causal, blocks or None for the selector's, v as the model
# passes it: the transposed view of a (B, S, Hkv, d) tensor).
FLASH_CASES = [
    (2, 24, 8, 512, True, None, False),
    (2, 24, 8, 512, False, None, False),
    (2, 24, 8, 1000, True, None, False),
    (2, 24, 8, 1000, False, None, False),
    (2, 24, 8, 1000, True, (64, 64), False),
    (2, 24, 8, 1000, False, (128, 64), False),
    (2, 24, 8, 512, True, (64, 128), False),
    # the served prefill shapes: phi4-mini at both edges, qwen3-moe
    (1, 24, 8, 336, True, None, True),
    (1, 24, 8, 474, True, None, True),
    (1, 24, 8, 474, True, None, False),
    (1, 32, 4, 474, True, None, True),
    # a sequence shorter than one q block
    (1, 24, 8, 40, True, None, True),
    (1, 24, 8, 40, False, (128, 128), False),
] + [(1, 32, 4, 474, True, blocks, True) for blocks in
     ((64, 64), (64, 128), (128, 64), (128, 128))] + [
    (2, 24, 8, 300, False, blocks, False) for blocks in
    ((64, 64), (64, 128), (128, 64), (128, 128))]


def _attn_inputs(torch, dev, B, H, Hkv, S, model_v, seed, d=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, S, d), generator=g, device=dev).bfloat16()
    k = torch.randn((B, Hkv, S, d), generator=g, device=dev).bfloat16()
    if model_v:
        v = torch.randn((B, S, Hkv, d), generator=g,
                        device=dev).bfloat16().transpose(1, 2)
    else:
        v = torch.randn((B, Hkv, S, d), generator=g, device=dev).bfloat16()
    return q, k, v


def flash_phase(torch, dev, kfa) -> float:
    worst = 0.0
    rows = []
    for i, (B, H, Hkv, S, causal, blocks, model_v) in enumerate(FLASH_CASES):
        d = 128
        q, k, v = _attn_inputs(torch, dev, B, H, Hkv, S, model_v, 100 + i)
        plan = kfa.plan_attention(S, S, d, batch=B, heads=H, kv_heads=Hkv,
                                  causal=causal)
        bq, bkv = blocks or (plan.block_q, plan.block_kv)
        n0 = kfa.flash_attention_kernel.launches
        got = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                         causal=causal)
        again = kfa.flash_attention_kernel(q, k, v, block_q=bq,
                                           block_kv=bkv, causal=causal)
        launched = kfa.flash_attention_kernel.launches == n0 + 2
        want = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                                   causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        ok = bool((err <= FLASH_ATOL + FLASH_RTOL * want.float().abs()).all())
        ok = ok and bool(torch.isfinite(got).all()) and launched
        det = bool(torch.equal(got, again))
        rows.append({"q": [B, H, S, d], "kv": [B, Hkv, S, d],
                     "causal": causal, "v_strides": list(v.stride()),
                     "blocks": [bq, bkv], "selected": blocks is None,
                     "ctas": B * H * -(-S // bq),
                     "max_abs_err": float(err.max()),
                     "deterministic": det, "ok": ok and det})
        if not ok or not det:
            emit({"phase": "flash", "cases": rows})
            fail(f"flash attention {rows[-1]} disagrees with its plain "
                 f"version or does not repeat bitwise")
        worst = max(worst, float(err.max()))
    emit({"phase": "flash", "tolerance": f"bf16 out: atol {FLASH_ATOL} + "
          f"rtol {FLASH_RTOL} (the kernel rounds P to bf16 before P V; the "
          f"plain version keeps it f32)", "deterministic": "two launches "
          "bitwise equal", "cases": rows})
    return worst


# ---------------------------------------------------------------------------
# Phase 3b: the grouped (expert) GEMM kernel against its plain version.
# ---------------------------------------------------------------------------

def _expert_inputs(torch, dev, E, M, N, K, ep, dt, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(dt)
    kw = {}
    if ep.bias:
        kw["bias"] = rnd(E, N)
    if ep.activation == "swiglu_gate":
        kw["gate"] = rnd(E, M, N)
    if ep.residual:
        kw["residual"] = rnd(E, M, N)
    return rnd(E, M, K), rnd(E, K, N), kw


def expert_gemm_phase(torch, dev, kmm) -> float:
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import Epilogue, TileConfig
    from repro_torch.core.selector import select_gemm_config
    from repro_torch.kernels.ops import _dtype_name, _model_dtype_name

    bf, f32 = torch.bfloat16, torch.float32
    none, swi = Epilogue(), Epilogue(activation="swiglu_gate")
    cases = []
    for C in (40, 32):                # qwen3-moe prefill capacities
        cases += [(128, C, 768, 2048, none, bf, bf, None),    # wu
                  (128, C, 768, 2048, swi, bf, bf, None),     # wg + gate
                  (128, C, 2048, 768, none, bf, bf, None)]    # wd
    cases += [
        (128, 40, 768, 2048, Epilogue(bias=True), bf, bf, None),
        (128, 32, 2048, 768, Epilogue(residual=True), bf, bf, None),
        (128, 24, 768, 2048, swi, bf, bf, None),              # ragged C
        (4, 17, 100, 77, Epilogue(residual=True), bf, bf, None),  # pads K, N
        # forced configs at the menu's corners
        (16, 40, 768, 2048, swi, bf, bf, TileConfig(256, 256, 32, group_m=4)),
        (128, 40, 2048, 768, none, bf, bf, TileConfig(32, 32, 32)),
        (128, 40, 768, 2048, none, bf, f32,
         TileConfig(128, 128, 128, schedule="stream_k")),
        # grouped stream-K and split-K: strips cross expert boundaries
        (16, 40, 768, 2048, swi, bf, bf,
         TileConfig(64, 128, 128, schedule="stream_k")),
        (16, 40, 768, 2048, swi, bf, bf, TileConfig(64, 128, 128, split_k=8)),
        (16, 40, 2048, 768, none, bf, bf,
         TileConfig(32, 256, 128, schedule="stream_k")),
        # f32 inputs (SIMT path)
        (8, 24, 200, 264, Epilogue(bias=True), f32, f32,
         TileConfig(32, 32, 32)),
        (8, 40, 768, 512, swi, f32, f32, None),
    ]
    worst = 0.0
    rows = []
    for i, (E, M, N, K, ep, dt, odt, cfg) in enumerate(cases):
        if cfg is None:
            cfg = select_gemm_config(M, N, K, in_dtype=_dtype_name(dt),
                                     out_dtype=_model_dtype_name(odt),
                                     epilogue=ep, hw=GPU_H100_LIKE).config
        x, w, kw = _expert_inputs(torch, dev, E, M, N, K, ep, dt, seed=50 + i)
        n0 = kmm.tiled_expert_matmul.launches
        got = kmm.tiled_expert_matmul(x, w, cfg, out_dtype=odt, epilogue=ep,
                                      **kw)
        ok = kmm.tiled_expert_matmul.launches == n0 + 1
        again = kmm.tiled_expert_matmul(x, w, cfg, out_dtype=odt,
                                        epilogue=ep, **kw)
        want = kmm.expert_matmul_plain(x, w, cfg, out_dtype=odt,
                                       epilogue=ep, **kw)
        torch.cuda.synchronize()
        rtol, atol = gemm_tol(dt, K)
        err = (got.float() - want.float()).abs()
        bound = atol + rtol * want.float().abs()
        det = _deterministic(torch, dev, kmm, got, again)
        ok = ok and bool((err <= bound).all()) \
            and bool(torch.isfinite(got).all())
        rel = float(torch.linalg.vector_norm(got.float() - want.float())
                    / torch.linalg.vector_norm(want.float()))
        plan = _plan(kmm, dev, M, N, K, cfg, E)
        rows.append({"shape": [E, M, N, K], "epilogue": str(ep),
                     "in": str(dt)[6:], "out": str(odt)[6:],
                     "config": str(cfg), "ctas": plan.ctas,
                     "split_tiles": plan.split_tiles,
                     "max_abs_err": float(err.max()), "rel_l2": rel,
                     "deterministic": det, "ok": ok and det})
        if not ok or not det:
            emit({"phase": "expert_gemm", "cases": rows})
            fail(f"expert gemm {E}x{M}x{N}x{K} {ep} {cfg} disagrees with "
                 f"its plain version (max abs err {float(err.max())}, atol "
                 f"{atol}, rtol {rtol}) or does not repeat (deterministic "
                 f"{det})")
        worst = max(worst, float(err.max()))
    emit({"phase": "expert_gemm", "tolerance": "tests/test_kernels.py:26-27:"
          " f32 rtol 1e-5 atol 1e-4*sqrt(K); bf16 rtol 3e-2 atol "
          "0.3*sqrt(K)", "deterministic": "two launches bitwise equal, "
          "every fixup flag down after them", "cases": rows})
    return worst


# ---------------------------------------------------------------------------
# Phase 4: serve phi4-mini-3.8b at full width and depth.
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--batch", "4", "--prompt-len", "512", "--gen", "16",
              "--ragged", "--requests", "8", "--temperature", "0", "--seed",
              "0", "--quiet"]


def plain_path(kmm, kfa):
    """Every kernel launch replaced by its plain version, for reference
    runs of the same model code on the card; launch counts do not move."""
    def gemm(a, b, cfg, *, out_dtype, epilogue, bias, gate, residual):
        return kmm.matmul_plain(a, b, cfg, out_dtype=out_dtype,
                                epilogue=epilogue, bias=bias, gate=gate,
                                residual=residual)

    def expert(x, w, cfg, *, out_dtype, epilogue, bias, gate, residual):
        return kmm.expert_matmul_plain(x, w, cfg, out_dtype=out_dtype,
                                       epilogue=epilogue, bias=bias,
                                       gate=gate, residual=residual)

    def attn(q, k, v, *, block_q, block_kv, causal, scale):
        return kfa.attention_plain(q, k, v, block_q=block_q,
                                   block_kv=block_kv, causal=causal,
                                   scale=scale)
    return (mock.patch.object(kmm, "_launch_cuda", gemm),
            mock.patch.object(kmm, "_launch_expert_cuda", expert),
            mock.patch.object(kfa, "_launch_cuda", attn))


def _serve(torch, dev, kmm, kfa, arch):
    """Random params from the seed, then ``run_serving`` on the phase's
    traffic with every launch count zeroed right before and read right
    after.  Fails unless every request finished with in-vocabulary tokens,
    with no fallback rung and no launch retry."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_parser, run_serving
    from repro_torch.nn.model import Model
    from repro_torch.obs import metrics as obs_metrics

    args = build_parser().parse_args(["--arch", arch, *SERVE_ARGS])
    cfg = get_config(args.arch)
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen)
    torch.cuda.synchronize()
    emit({"phase": "serve_init", "arch": cfg.name,
          "params": sum(t.numel() for t in _leaves(params)),
          "param_bytes": sum(t.numel() * t.element_size()
                             for t in _leaves(params)),
          "seconds": time.perf_counter() - t0})

    prev_metrics = obs_metrics.enable_metrics(True)
    obs_metrics.get_registry().clear()
    counters = {"matmul": kmm.tiled_matmul,
                "expert_matmul": kmm.tiled_expert_matmul,
                "flash_attention": kfa.flash_attention_kernel}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = run_serving(args, params=params)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    reg = obs_metrics.get_registry()
    fallback = sum(m.value for m in reg.metrics()
                   if m.name == "fallback_rungs")
    retries = sum(m.value for m in reg.metrics()
                  if m.name == "launch_retries")
    obs_metrics.enable_metrics(prev_metrics)
    results = out["results"]
    emit({"phase": "serve" if not cfg.is_moe else "serve_moe",
          "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "requests": len(results),
          "edges": out["edges"], "bucket_hits": out["bucket_hits"],
          "prompt_lens": [results[r].prompt_len for r in sorted(results)],
          "steps": out["steps"], "tokens_emitted": out["tokens_emitted"],
          "tokens_per_s": out["tokens_per_s"],
          "prefill_ms_total": out["t_prefill_s"] * 1e3,
          "prefill_ms_per_request": out["t_prefill_s"] * 1e3 / len(results),
          "decode_ms_per_step": out["device_step_s_mean"] * 1e3,
          "dispatch_ms_per_step": out["dispatch_s_mean"] * 1e3,
          "t_decode_s": out["t_decode_s"], "wall_s": wall,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
          "launches": launches,
          "fallback_rungs": fallback, "launch_retries": retries,
          "sample": [results[r].tokens[:8].tolist()
                     for r in sorted(results)][:2]})
    if launches["matmul"] <= 0 or launches["flash_attention"] <= 0:
        fail(f"{cfg.name}: main path did not launch the dense GEMM and "
             f"flash kernels ({launches})")
    if fallback or retries:
        fail(f"{cfg.name}: fallback rungs {fallback}, launch retries "
             f"{retries}")
    if len(results) != 8 or not all(r.finished for r in results.values()):
        fail(f"{cfg.name}: not every request finished")
    for r in results.values():
        if len(r.tokens) != 16 or not ((r.tokens >= 0)
                                       & (r.tokens < cfg.vocab_size)).all():
            fail(f"{cfg.name} request {r.rid}: bad tokens "
                 f"{r.tokens.tolist()}")
    return args, model, params, out, launches


def _request_tokens(torch, dev, args, cfg, r):
    """Request ``r``'s prompt as served: right-padded to its bucket edge,
    with its last real position."""
    import numpy as np
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(8, args.prompt_len)).astype(np.int64)
    tokens = torch.zeros((1, r.padded_len), dtype=torch.int64, device=dev)
    tokens[0, :r.prompt_len] = torch.from_numpy(
        prompts[r.rid, :r.prompt_len]).to(dev)
    return tokens, torch.tensor([r.prompt_len - 1], device=dev)


def _rel(torch, x, y) -> float:
    return float(torch.linalg.vector_norm(x - y)
                 / torch.linalg.vector_norm(y))


def serve_phase(torch, dev, kmm, kfa):
    args, model, params, out, launches = _serve(torch, dev, kmm, kfa,
                                                "phi4-mini-3.8b")
    # One request's prefill logits: kernel path vs plain path on the card.
    r0 = out["results"][0]
    tokens, last = _request_tokens(torch, dev, args, model.cfg, r0)
    with torch.inference_mode():
        got, _ = model.prefill(params, tokens, last)
        p1, p2, p3 = plain_path(kmm, kfa)
        with p1, p2, p3:
            want, _ = model.prefill(params, tokens, last)
            # The same plain path in f32: how far bf16 rounding alone moves
            # the logits, the yardstick for the kernel-vs-plain distance.
            params32 = _tree_map(params, lambda t: t.float())
            ref32, _ = model.prefill(params32, tokens, last)
            del params32
    torch.cuda.synchronize()

    d_kp, d_p32 = _rel(torch, got, want), _rel(torch, want, ref32)
    emit({"phase": "serve_logits", "rid": r0.rid,
          "prompt_len": r0.prompt_len, "padded_len": r0.padded_len,
          "rel_l2_kernel_vs_plain": d_kp,
          "rel_l2_plain_bf16_vs_plain_f32": d_p32,
          "rel_l2_kernel_vs_plain_f32": _rel(torch, got, ref32),
          "max_abs_err": float((got - want).abs().max()),
          "plain_absmax": float(want.abs().max()),
          "argmax_equal": int(got.argmax()) == int(want.argmax()),
          "first_token_matches_served":
              int(got.argmax()) == int(r0.tokens[0]),
          "tolerance": f"kernel vs plain relative L2 <= "
                       f"{LOGITS_REL_FACTOR} x (plain bf16 vs plain f32) "
                       f"and <= {LOGITS_REL_CAP}"})
    if not bool(torch.isfinite(got).all()) or d_kp > LOGITS_REL_CAP \
            or d_kp > LOGITS_REL_FACTOR * d_p32:
        fail(f"prefill logits disagree with the plain path (rel {d_kp}, "
             f"bf16 rounding alone {d_p32})")
    return model, params, launches, out["edges"]


# ---------------------------------------------------------------------------
# Phase 5: serve qwen3-moe-30b-a3b at full width and depth.
# ---------------------------------------------------------------------------

def serve_moe_phase(torch, dev, kmm, kfa):
    import dataclasses
    from repro_torch.nn.model import Model
    from repro_torch.nn.moe import _capacity

    args, model, params, out, launches = _serve(torch, dev, kmm, kfa,
                                                "qwen3-moe-30b-a3b")
    cfg = model.cfg
    per_prefill = 3 * cfg.num_layers       # wu, wg + gate, wd in each layer
    n_prefills = len(out["results"])
    if launches["expert_matmul"] != per_prefill * n_prefills:
        fail(f"grouped GEMM launched {launches['expert_matmul']} times, "
             f"expected {per_prefill} per prefill x {n_prefills} prefills "
             f"and none in decode")

    r0 = out["results"][0]
    tokens, _ = _request_tokens(torch, dev, args, cfg, r0)
    tokens = tokens[:, :r0.prompt_len]
    row = {"phase": "serve_moe_logits", "rid": r0.rid,
           "prompt_len": r0.prompt_len}
    with torch.inference_mode():
        # Full depth: kernel path vs plain path over every position.
        got = model.forward(params, tokens)[0]
        p1, p2, p3 = plain_path(kmm, kfa)
        with p1, p2, p3:
            want = model.forward(params, tokens)[0]
        torch.cuda.synchronize()
        d_full = _rel(torch, got, want)
        row.update({
            "full_layers": cfg.num_layers,
            "full_rel_l2_kernel_vs_plain": d_full,
            "full_argmax_agreement": float(
                (got.argmax(-1) == want.argmax(-1)).float().mean()),
            "full_last_argmax_equal":
                int(got[-1].argmax()) == int(want[-1].argmax()),
            "first_token_matches_served":
                int(got[-1].argmax()) == int(r0.tokens[0]),
            "full_tolerance": f"finite, relative L2 <= {MOE_FULL_REL_CAP}"})
        full_ok = bool(torch.isfinite(got).all()) and d_full <= \
            MOE_FULL_REL_CAP
        del got, want

        # The first MOE_CUT_LAYERS layers (views of the served params):
        # the f32 yardstick of phase 4 fits at this depth.
        cut = Model(dataclasses.replace(cfg, num_layers=MOE_CUT_LAYERS),
                    device=dev)
        p_cut = dict(params, layers=_tree_map(
            params["layers"], lambda t: t[:MOE_CUT_LAYERS]))
        got = cut.forward(p_cut, tokens)[0]
        with p1, p2, p3:
            want = cut.forward(p_cut, tokens)[0]
            p32 = _tree_map(p_cut, lambda t: t.float())
            ref32 = cut.forward(p32, tokens)[0]
            del p32
        torch.cuda.synchronize()
    d_kp, d_p32 = _rel(torch, got, want), _rel(torch, want, ref32)
    row.update({
        "cut_layers": MOE_CUT_LAYERS,
        "cut_rel_l2_kernel_vs_plain": d_kp,
        "cut_rel_l2_plain_bf16_vs_plain_f32": d_p32,
        "cut_rel_l2_kernel_vs_plain_f32": _rel(torch, got, ref32),
        "cut_argmax_agreement": float(
            (got.argmax(-1) == want.argmax(-1)).float().mean()),
        "cut_tolerance": f"kernel vs plain relative L2 <= "
                         f"{LOGITS_REL_FACTOR} x (plain bf16 vs plain f32) "
                         f"and <= {LOGITS_REL_CAP}",
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})
    emit(row)
    if not full_ok:
        fail(f"qwen3-moe full-depth logits disagree with the plain path "
             f"(rel {d_full})")
    if not bool(torch.isfinite(got).all()) or d_kp > LOGITS_REL_CAP \
            or d_kp > LOGITS_REL_FACTOR * d_p32:
        fail(f"qwen3-moe {MOE_CUT_LAYERS}-layer logits disagree with the "
             f"plain path (rel {d_kp}, bf16 rounding alone {d_p32})")
    return (model, params, launches, _capacity(cfg, max(out["edges"])),
            max(out["edges"]))


# ---------------------------------------------------------------------------
# Phase 4b / 5b: where a step's time goes (torch.profiler device time).
# ---------------------------------------------------------------------------

def _kernel_ms(prof):
    """Device time (ms) and launch count of every kernel in a profile,
    grouped by kernel name: the dense GEMM's kernels are gemm_dense_*, the
    grouped GEMM's gemm_grouped_* (csrc/matmul.cu)."""
    import os
    import tempfile
    groups = {"matmul": 0.0, "expert_matmul": 0.0, "flash_attention": 0.0,
              "other": 0.0}
    counts = dict.fromkeys(groups, 0)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    for ev in events:
        if str(ev.get("cat", "")).lower() != "kernel":
            continue
        name = ev.get("name", "")
        key = ("flash_attention" if "flash_fwd_kernel" in name else
               "expert_matmul" if "gemm_grouped" in name else
               "matmul" if "gemm_dense" in name else "other")
        groups[key] += ev.get("dur", 0.0) / 1e3
        counts[key] += 1
    if not any(counts.values()):
        fail("the profiler's trace holds no device kernel events")
    return groups, counts


def trace_phase(torch, dev, model, params, phase="trace") -> None:
    """One prefill (the largest served prompt) and four decode steps at
    batch 4 under torch.profiler: device kernel time by kernel against the
    host wall time, so the device's busy and idle shares are measured."""
    from torch.profiler import ProfilerActivity, profile
    B, S, max_len = 4, 474, 528
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, S), generator=g,
                           device=dev)
    cache = model.init_cache(B, max_len)
    tokens = torch.randint(0, model.cfg.vocab_size, (B,), generator=g,
                           device=dev)
    pos = torch.tensor([300, 350, 400, 450], device=dev)
    rows = {}
    with torch.inference_mode():
        for name, fn, n in (
                ("prefill", lambda: model.prefill(params, prompt), 1),
                ("decode_step", lambda: model.decode_step(
                    params, cache, tokens, pos), 4)):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / n
            ms, counts = _kernel_ms(prof)
            groups = {k: v / n for k, v in ms.items()}
            busy = sum(groups.values())
            rows[name] = {"wall_ms": wall, "kernel_ms": groups,
                          "kernels_per_call": {k: v / n
                                               for k, v in counts.items()},
                          "busy_ms": busy, "idle_share": 1 - busy / wall}
    del cache
    emit({"phase": phase, "arch": model.cfg.name,
          "what": "torch.profiler device kernel time per call vs host wall "
          "time per call (profiler on)", "batch": B, "prompt_len": S,
          **rows})


def _tree_map(tree, fn):
    return {k: (_tree_map(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# Phase 6: times at the main-path shapes.
# ---------------------------------------------------------------------------

PATH_GEMMS = [  # (name, N, K, epilogue) of one phi4-mini layer
    ("wq", 3072, 3072, "none"), ("wk", 1024, 3072, "none"),
    ("wv", 1024, 3072, "none"), ("wo", 3072, 3072, "residual"),
    ("wu", 8192, 3072, "none"), ("wg", 8192, 3072, "swiglu_gate"),
    ("wd", 3072, 8192, "residual")]


EXPERT_GEMMS = [  # (name, N, K, epilogue) of one qwen3-moe layer's experts
    ("wu", 768, 2048, "none"), ("wg", 768, 2048, "swiglu_gate"),
    ("wd", 2048, 768, "none")]


def _gemm_bytes_flops(M, N, K, ep):
    extra = M * N * 2 if ep in ("residual", "swiglu_gate") else 0
    return 2 * (M * K + K * N + M * N) + extra, 2.0 * M * N * K


def host_us(torch, fn, calls: int = 50) -> float:
    """Host time of one call: ``calls`` calls issued back to back without a
    device sync (the wrapper's checks, plan, allocations, the ctypes call,
    the tensor-map encoding and the launch), in microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def times_phase(torch, dev, kmm, kfa, edges, moe_capacity, moe_edge):
    """Per-call times of each kernel at the main-path shapes; returns the
    kernels-line numbers keyed matmul@decode, matmul@prefill,
    flash_attention@prefill and expert_matmul@prefill."""
    import torch.nn.functional as F
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import Epilogue, GemmProblem, gemm_latency
    from repro_torch.core.selector import select_gemm_config

    eps = {"none": Epilogue(), "residual": Epilogue(residual=True),
           "swiglu_gate": Epilogue(activation="swiglu_gate")}
    times = {}
    per_shape = []
    for phase, M, extra in (("decode", 4, ()),
                            ("prefill", 512, ("wk", "wv"))):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "model_ms": 0.0, "bytes": 0, "flops": 0.0}
        # A prefill also recomputes wk/wv for the cache (transformer.py:111).
        for name, N, K, epn in PATH_GEMMS + [g for g in PATH_GEMMS
                                             if g[0] in extra]:
            ep = eps[epn]
            a, b, kw = _gemm_inputs(torch, dev, M, N, K, ep, torch.bfloat16,
                                    seed=7)
            a = a * 0.1
            b = b * 0.02
            sel = select_gemm_config(M, N, K, in_dtype="bfloat16",
                                     out_dtype="bfloat16", epilogue=ep,
                                     hw=GPU_H100_LIKE)
            cfg = sel.config
            plan = _plan(kmm, dev, M, N, K, cfg, 1)
            bf = torch.bfloat16

            def kern():
                return kmm._launch_cuda(a, b, cfg, out_dtype=bf, epilogue=ep,
                                        bias=None, gate=kw.get("gate"),
                                        residual=kw.get("residual"))

            def plain():
                return kmm.matmul_plain(a, b, cfg, out_dtype=bf,
                                        epilogue=ep, **kw)

            def library():
                if epn == "residual":
                    return torch.addmm(kw["residual"], a, b)
                y = torch.matmul(a, b)
                return F.silu(y) * kw["gate"] if epn == "swiglu_gate" else y

            n0 = kmm.tiled_matmul.launches
            row = {"phase": phase, "gemm": name, "M": M, "N": N, "K": K,
                   "epilogue": epn, "config": str(cfg), "ctas": plan.ctas,
                   "split_tiles": plan.split_tiles,
                   "model_ms": sel.predicted.total * 1e3,
                   "ms": time_ms(kern), "plain_ms": time_ms(plain),
                   "library_ms": time_ms(library),
                   "host_us": host_us(torch, kern)}
            kmm.tiled_matmul.launches = n0     # timing launches do not count
            nbytes, flops = _gemm_bytes_flops(M, N, K, epn)
            row["bound_ms"] = max(nbytes / HBM_BW, flops / BF16_PEAK) * 1e3
            row["bound_by"] = ("bytes" if nbytes / HBM_BW
                               >= flops / BF16_PEAK else "operations")
            per_shape.append(row)
            for key in ("ms", "plain_ms", "library_ms", "model_ms"):
                tot[key] += row[key]
            tot["bytes"] += nbytes
            tot["flops"] += flops
        t_b, t_f = tot["bytes"] / HBM_BW, tot["flops"] / BF16_PEAK
        times[f"matmul@{phase}"] = {
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "library_ms": tot["library_ms"], "model_ms": tot["model_ms"],
            "bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "what": f"sum over one layer's {phase} GEMMs at M={M}"}

    # Prefill attention at each model's largest bucket edge, v as the model
    # passes it; every pair of the block menu beside the selected one.
    attn_rows = {}
    for arch, H, Hkv, S in (("phi4-mini-3.8b", 24, 8, max(edges)),
                            ("qwen3-moe-30b-a3b", 32, 4, moe_edge)):
        B, d = 1, 128
        q, k, v = _attn_inputs(torch, dev, B, H, Hkv, S, True, seed=11)
        plan = kfa.plan_attention(S, S, d, batch=B, heads=H, kv_heads=Hkv,
                                  causal=True)
        n0 = kfa.flash_attention_kernel.launches

        def kern(bq, bkv):
            return time_ms(lambda: kfa._launch_cuda(
                q, k, v, block_q=bq, block_kv=bkv, causal=True, scale=None))
        menu = []
        for bq in kfa.BLOCK_MENU:
            for bkv in kfa.BLOCK_MENU:
                priced = kfa.price_attention_blocks(
                    S, S, d, bq, bkv, batch=B, heads=H, kv_heads=Hkv,
                    causal=True)
                menu.append({"blocks": [bq, bkv], "ctas": priced.ctas,
                             "ctas_per_sm": priced.ctas_per_sm,
                             "model_ms": priced.predicted * 1e3,
                             "ms": kern(bq, bkv)})
        row = {"phase": "prefill", "kernel": "flash_attention",
               "arch": arch, "q": [B, H, S, d], "kv": [B, Hkv, S, d],
               "v_strides": list(v.stride()),
               "blocks": [plan.block_q, plan.block_kv], "ctas": plan.ctas,
               "ctas_per_sm": plan.ctas_per_sm,
               "model_ms": plan.predicted * 1e3,
               "ms": kern(plan.block_q, plan.block_kv),
               "plain_ms": time_ms(lambda: kfa.attention_plain(
                   q, k, v, block_q=plan.block_q, block_kv=plan.block_kv,
                   causal=True)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True)),
               "menu": menu}
        kfa.flash_attention_kernel.launches = n0   # timing launches
        pairs = S * (S + 1) // 2                # causal (query, key) pairs
        flops = 4.0 * B * H * pairs * d
        nbytes = 2 * d * S * B * (2 * H + 2 * Hkv)
        row["bound_ms"] = max(nbytes / HBM_BW, flops / BF16_PEAK) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BW >= flops / BF16_PEAK \
            else "operations"
        per_shape.append(row)
        attn_rows[arch] = row
    times["flash_attention@prefill"] = {k_: attn_rows["phi4-mini-3.8b"][k_]
                                        for k_ in ("ms", "plain_ms",
                                                   "library_ms", "bound_ms",
                                                   "bound_by")}

    # The three expert GEMMs of one qwen3-moe prefill layer at the capacity
    # of the largest served bucket edge.
    E, C = 128, moe_capacity
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "model_ms", "bytes",
                         "flops"), 0.0)
    for name, N, K, epn in EXPERT_GEMMS:
        ep = eps[epn]
        x, w, kw = _expert_inputs(torch, dev, E, C, N, K, ep, torch.bfloat16,
                                  seed=13)
        x = x * 0.1
        w = w * 0.02
        cfg = select_gemm_config(C, N, K, in_dtype="bfloat16",
                                 out_dtype="bfloat16", epilogue=ep,
                                 hw=GPU_H100_LIKE).config
        plan = _plan(kmm, dev, C, N, K, cfg, E)
        # The selection prices one expert; the model of the whole launch
        # is the same problem at batch E.
        model = gemm_latency(GemmProblem(C, N, K, in_dtype="bfloat16",
                                         out_dtype="bfloat16", batch=E,
                                         epilogue=ep), cfg, GPU_H100_LIKE)
        bf = torch.bfloat16

        def kern():
            return kmm._launch_expert_cuda(x, w, cfg, out_dtype=bf,
                                           epilogue=ep, bias=None,
                                           gate=kw.get("gate"),
                                           residual=None)

        def plain():
            return kmm.expert_matmul_plain(x, w, cfg, out_dtype=bf,
                                           epilogue=ep, **kw)

        def library():
            y = torch.bmm(x, w)
            return F.silu(y) * kw["gate"] if epn == "swiglu_gate" else y

        n0 = kmm.tiled_expert_matmul.launches
        row = {"phase": "prefill", "expert_gemm": name, "E": E, "C": C,
               "N": N, "K": K, "epilogue": epn, "config": str(cfg),
               "ctas": plan.ctas, "split_tiles": plan.split_tiles,
               "model_ms": model.total * 1e3,
               "ms": time_ms(kern), "plain_ms": time_ms(plain),
               "library_ms": time_ms(library),
               "host_us": host_us(torch, kern)}
        kmm.tiled_expert_matmul.launches = n0
        nbytes, flops = _gemm_bytes_flops(C, N, K, epn)
        nbytes, flops = E * nbytes, E * flops
        row["bound_ms"] = max(nbytes / HBM_BW, flops / BF16_PEAK) * 1e3
        row["bound_by"] = ("bytes" if nbytes / HBM_BW >= flops / BF16_PEAK
                           else "operations")
        per_shape.append(row)
        for key in ("ms", "plain_ms", "library_ms", "model_ms"):
            tot[key] += row[key]
        tot["bytes"] += nbytes
        tot["flops"] += flops
    t_b, t_f = tot["bytes"] / HBM_BW, tot["flops"] / BF16_PEAK
    times["expert_matmul@prefill"] = {
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "library_ms": tot["library_ms"], "model_ms": tot["model_ms"],
        "bound_ms": max(t_b, t_f) * 1e3,
        "bound_by": "bytes" if t_b >= t_f else "operations",
        "what": f"sum over one layer's 3 expert GEMMs at E={E}, C={C}"}
    emit({"phase": "times", "timing": "CUDA graph of 10 calls after 3 "
          "warm-up calls, median of 5 replays between CUDA events, per "
          "call", "rows": per_shape,
          "summary": times})
    return times


if __name__ == "__main__":
    sys.exit(main())
