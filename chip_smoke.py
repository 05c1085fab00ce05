#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero:

1. build    — compile every CUDA source (one nvcc each, all at once) and
              record the card (``nvidia-smi`` name and power limit).
2. gemm     — the GEMM kernel against its plain version on the card: the
              phi4-mini step shapes at M = 4 and 512 with the path's
              epilogues, gelu/silu/bias at one shape each, forced configs
              at the menu's corners, group_m > 1 on ragged M/N/K, split-K,
              and f32 inputs/outputs.
3. flash    — the flash-attention kernel against its plain version:
              (B, 24, S, 128) q over (B, 8, S, 128) k/v, causal and not,
              S in {512, 1000}, bf16.
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
5. times    — each kernel at the main-path shapes: kernel, plain and
              one-call library times (CUDA graphs and events) and
              the bound max(flop / 989e12, bytes / 3.35e12).

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
                 if "registers" in ln or "spill" in ln]
        summary[name] = {"seconds": round(sec, 2), "ptxas": lines}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": summary})

    max_err = {"matmul": gemm_phase(torch, dev, kmm),
               "flash_attention": flash_phase(torch, dev, kfa)}
    model, params, launches, edges = serve_phase(torch, dev, kmm, kfa)
    trace_phase(torch, dev, model, params)
    del model, params
    times = times_phase(torch, dev, kmm, kfa, edges)

    entries = []
    for key, base, source, replaces in (
            ("matmul@decode", "matmul", "src/repro_torch/csrc/matmul.cu",
             "src/repro/kernels/matmul.py:108"),
            ("matmul@prefill", "matmul", "src/repro_torch/csrc/matmul.cu",
             "src/repro/kernels/matmul.py:108"),
            ("flash_attention@prefill", "flash_attention",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:136")):
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
        # split_k > 1 lowers to the in-CTA K loop
        (64, 128, 2048, none, bf, f32, TileConfig(64, 128, 64, split_k=4)),
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
        want = kmm.matmul_plain(a, b, cfg, out_dtype=odt, epilogue=ep, **kw)
        torch.cuda.synchronize()
        rtol, atol = gemm_tol(dt, K)
        err = (got.float() - want.float()).abs()
        bound = atol + rtol * want.float().abs()
        ok = bool((err <= bound).all()) and bool(torch.isfinite(got).all())
        rel = float(torch.linalg.vector_norm(got.float() - want.float())
                    / torch.linalg.vector_norm(want.float()))
        rows.append({"shape": [M, N, K], "epilogue": str(ep),
                     "in": str(dt)[6:], "out": str(odt)[6:],
                     "config": str(cfg), "max_abs_err": float(err.max()),
                     "rel_l2": rel, "ok": ok})
        if not ok:
            emit({"phase": "gemm", "cases": rows})
            fail(f"gemm {M}x{N}x{K} {ep} {cfg} disagrees with its plain "
                 f"version (max abs err {float(err.max())}, atol {atol}, "
                 f"rtol {rtol})")
        worst = max(worst, float(err.max()))
    emit({"phase": "gemm", "tolerance": "tests/test_kernels.py:26-27: f32 "
          "rtol 1e-5 atol 1e-4*sqrt(K); bf16 rtol 3e-2 atol 0.3*sqrt(K)",
          "cases": rows})
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the flash-attention kernel against its plain version.
# ---------------------------------------------------------------------------

def flash_phase(torch, dev, kfa) -> float:
    worst = 0.0
    rows = []
    cases = [(S, causal, None) for S in (512, 1000) for causal in (True, False)]
    cases += [(1000, True, (64, 64)), (1000, False, (128, 64)),
              (512, True, (64, 128))]
    for i, (S, causal, blocks) in enumerate(cases):
        B, H, Hkv, d = 2, 24, 8, 128
        g = torch.Generator(device=dev).manual_seed(100 + i)
        q = torch.randn((B, H, S, d), generator=g, device=dev).bfloat16()
        k = torch.randn((B, Hkv, S, d), generator=g, device=dev).bfloat16()
        v = torch.randn((B, Hkv, S, d), generator=g, device=dev).bfloat16()
        bq, bkv = blocks or kfa.select_attention_blocks(S, S, d,
                                                        causal=causal)
        got = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                         causal=causal)
        want = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                                   causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        ok = bool((err <= FLASH_ATOL + FLASH_RTOL * want.float().abs()).all())
        ok = ok and bool(torch.isfinite(got).all())
        rows.append({"q": [B, H, S, d], "kv": [B, Hkv, S, d],
                     "causal": causal, "blocks": [bq, bkv],
                     "max_abs_err": float(err.max()), "ok": ok})
        if not ok:
            emit({"phase": "flash", "cases": rows})
            fail(f"flash attention S={S} causal={causal} blocks "
                 f"({bq},{bkv}) disagrees with its plain version "
                 f"(max abs err {float(err.max())})")
        worst = max(worst, float(err.max()))
    emit({"phase": "flash", "tolerance": f"bf16 out: atol {FLASH_ATOL} + "
          f"rtol {FLASH_RTOL} (the kernel rounds P to bf16 before P V; the "
          f"plain version keeps it f32)", "cases": rows})
    return worst


# ---------------------------------------------------------------------------
# Phase 4: serve phi4-mini-3.8b at full width and depth.
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "phi4-mini-3.8b", "--batch", "4", "--prompt-len",
              "512", "--gen", "16", "--ragged", "--requests", "8",
              "--temperature", "0", "--seed", "0", "--quiet"]


def plain_path(kmm, kfa):
    """Every kernel launch replaced by its plain version, for reference
    runs of the same model code on the card; launch counts do not move."""
    def gemm(a, b, cfg, *, out_dtype, epilogue, bias, gate, residual):
        return kmm.matmul_plain(a, b, cfg, out_dtype=out_dtype,
                                epilogue=epilogue, bias=bias, gate=gate,
                                residual=residual)

    def attn(q, k, v, *, block_q, block_kv, causal, scale):
        return kfa.attention_plain(q, k, v, block_q=block_q,
                                   block_kv=block_kv, causal=causal,
                                   scale=scale)
    return (mock.patch.object(kmm, "_launch_cuda", gemm),
            mock.patch.object(kfa, "_launch_cuda", attn))


def serve_phase(torch, dev, kmm, kfa):
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_parser, run_serving
    from repro_torch.nn.model import Model
    from repro_torch.obs import metrics as obs_metrics

    args = build_parser().parse_args(SERVE_ARGS)
    cfg = get_config(args.arch)
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit({"phase": "serve_init", "params": n_params,
          "param_bytes": sum(t.numel() * t.element_size()
                             for t in _leaves(params)),
          "seconds": time.perf_counter() - t0})

    prev_metrics = obs_metrics.enable_metrics(True)
    obs_metrics.get_registry().clear()
    kmm.tiled_matmul.launches = 0
    kfa.flash_attention_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = run_serving(args, params=params)
    wall = time.perf_counter() - t0
    n_mm = kmm.tiled_matmul.launches
    n_fa = kfa.flash_attention_kernel.launches
    reg = obs_metrics.get_registry()
    fallback = sum(m.value for m in reg.metrics()
                   if m.name == "fallback_rungs")
    retries = sum(m.value for m in reg.metrics()
                  if m.name == "launch_retries")
    obs_metrics.enable_metrics(prev_metrics)
    results = out["results"]
    n_steps = out["steps"]
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "requests": len(results),
          "edges": out["edges"], "bucket_hits": out["bucket_hits"],
          "prompt_lens": [results[r].prompt_len for r in sorted(results)],
          "steps": n_steps, "tokens_emitted": out["tokens_emitted"],
          "tokens_per_s": out["tokens_per_s"],
          "prefill_ms_total": out["t_prefill_s"] * 1e3,
          "prefill_ms_per_request": out["t_prefill_s"] * 1e3 / len(results),
          "decode_ms_per_step": out["device_step_s_mean"] * 1e3,
          "dispatch_ms_per_step": out["dispatch_s_mean"] * 1e3,
          "t_decode_s": out["t_decode_s"], "wall_s": wall,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
          "launches": {"matmul": n_mm, "flash_attention": n_fa},
          "fallback_rungs": fallback, "launch_retries": retries,
          "sample": [results[r].tokens[:8].tolist() for r in sorted(results)][:2]})
    if n_mm <= 0 or n_fa <= 0:
        fail(f"main path did not launch both kernels (matmul {n_mm}, "
             f"flash {n_fa})")
    if fallback or retries:
        fail(f"fallback rungs {fallback}, launch retries {retries}")
    if len(results) != 8 or not all(r.finished for r in results.values()):
        fail("not every request finished")
    for r in results.values():
        if len(r.tokens) != 16 or not ((r.tokens >= 0)
                                       & (r.tokens < cfg.vocab_size)).all():
            fail(f"request {r.rid}: bad tokens {r.tokens.tolist()}")

    # One request's prefill logits: kernel path vs plain path on the card.
    rid = 0
    r0 = results[rid]
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(8, args.prompt_len)).astype(np.int64)
    tokens = torch.zeros((1, r0.padded_len), dtype=torch.int64, device=dev)
    tokens[0, :r0.prompt_len] = torch.from_numpy(
        prompts[rid, :r0.prompt_len]).to(dev)
    last = torch.tensor([r0.prompt_len - 1], device=dev)
    with torch.inference_mode():
        got, _ = model.prefill(params, tokens, last)
        p1, p2 = plain_path(kmm, kfa)
        with p1, p2:
            want, _ = model.prefill(params, tokens, last)
            # The same plain path in f32: how far bf16 rounding alone moves
            # the logits, the yardstick for the kernel-vs-plain distance.
            params32 = _tree_map(params, lambda t: t.float())
            ref32, _ = model.prefill(params32, tokens, last)
            del params32
    torch.cuda.synchronize()

    def rel(x, y):
        return float(torch.linalg.vector_norm(x - y)
                     / torch.linalg.vector_norm(y))

    d_kp, d_p32, d_k32 = rel(got, want), rel(want, ref32), rel(got, ref32)
    emit({"phase": "serve_logits", "rid": rid, "prompt_len": r0.prompt_len,
          "padded_len": r0.padded_len, "rel_l2_kernel_vs_plain": d_kp,
          "rel_l2_plain_bf16_vs_plain_f32": d_p32,
          "rel_l2_kernel_vs_plain_f32": d_k32,
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
    return (model, params, {"matmul": n_mm, "flash_attention": n_fa},
            out["edges"])


# ---------------------------------------------------------------------------
# Phase 4b: where a step's time goes (torch.profiler device kernel time).
# ---------------------------------------------------------------------------

def _kernel_ms(prof):
    """Device time (ms) and launch count of every kernel in a profile,
    grouped by kernel."""
    groups = {"matmul": 0.0, "flash_attention": 0.0, "other": 0.0}
    counts = dict.fromkeys(groups, 0)
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if not us:
            continue
        key = ("matmul" if "gemm_kernel" in ev.key else
               "flash_attention" if "flash_fwd_kernel" in ev.key else "other")
        groups[key] += us / 1e3
        counts[key] += ev.count
    return groups, counts


def trace_phase(torch, dev, model, params) -> None:
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
    emit({"phase": "trace", "what": "torch.profiler device kernel time per "
          "call vs host wall time per call (profiler on)", "batch": B,
          "prompt_len": S, **rows})


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
# Phase 5: times at the main-path shapes.
# ---------------------------------------------------------------------------

PATH_GEMMS = [  # (name, N, K, epilogue) of one phi4-mini layer
    ("wq", 3072, 3072, "none"), ("wk", 1024, 3072, "none"),
    ("wv", 1024, 3072, "none"), ("wo", 3072, 3072, "residual"),
    ("wu", 8192, 3072, "none"), ("wg", 8192, 3072, "swiglu_gate"),
    ("wd", 3072, 8192, "residual")]


def _gemm_bytes_flops(M, N, K, ep):
    extra = M * N * 2 if ep in ("residual", "swiglu_gate") else 0
    return 2 * (M * K + K * N + M * N) + extra, 2.0 * M * N * K


def times_phase(torch, dev, kmm, kfa, edges):
    """Per-call times of each kernel at the main-path shapes; returns the
    kernels-line numbers keyed matmul@decode, matmul@prefill and
    flash_attention@prefill."""
    import torch.nn.functional as F
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import Epilogue
    from repro_torch.core.selector import select_gemm_config

    eps = {"none": Epilogue(), "residual": Epilogue(residual=True),
           "swiglu_gate": Epilogue(activation="swiglu_gate")}
    times = {}
    per_shape = []
    for phase, M, extra in (("decode", 4, ()),
                            ("prefill", 512, ("wk", "wv"))):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
               "flops": 0.0}
        # A prefill also recomputes wk/wv for the cache (transformer.py:111).
        for name, N, K, epn in PATH_GEMMS + [g for g in PATH_GEMMS
                                             if g[0] in extra]:
            ep = eps[epn]
            a, b, kw = _gemm_inputs(torch, dev, M, N, K, ep, torch.bfloat16,
                                    seed=7)
            a = a * 0.1
            b = b * 0.02
            cfg = select_gemm_config(M, N, K, in_dtype="bfloat16",
                                     out_dtype="bfloat16", epilogue=ep,
                                     hw=GPU_H100_LIKE).config
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
                   "epilogue": epn, "config": str(cfg),
                   "ms": time_ms(kern), "plain_ms": time_ms(plain),
                   "library_ms": time_ms(library)}
            kmm.tiled_matmul.launches = n0     # timing launches do not count
            nbytes, flops = _gemm_bytes_flops(M, N, K, epn)
            row["bound_ms"] = max(nbytes / HBM_BW, flops / BF16_PEAK) * 1e3
            row["bound_by"] = ("bytes" if nbytes / HBM_BW
                               >= flops / BF16_PEAK else "operations")
            per_shape.append(row)
            for key in ("ms", "plain_ms", "library_ms"):
                tot[key] += row[key]
            tot["bytes"] += nbytes
            tot["flops"] += flops
        t_b, t_f = tot["bytes"] / HBM_BW, tot["flops"] / BF16_PEAK
        times[f"matmul@{phase}"] = {
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "library_ms": tot["library_ms"], "bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "what": f"sum over one layer's {phase} GEMMs at M={M}"}

    # Prefill attention at the largest bucket edge.
    S = max(edges)
    B, H, Hkv, d = 1, 24, 8, 128
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((B, H, S, d), generator=g, device=dev).bfloat16()
    k = torch.randn((B, Hkv, S, d), generator=g, device=dev).bfloat16()
    v = torch.randn((B, Hkv, S, d), generator=g, device=dev).bfloat16()
    bq, bkv = kfa.select_attention_blocks(S, S, d, causal=True)
    n0 = kfa.flash_attention_kernel.launches
    row = {"phase": "prefill", "kernel": "flash_attention",
           "q": [B, H, S, d], "kv": [B, Hkv, S, d], "blocks": [bq, bkv],
           "ms": time_ms(lambda: kfa._launch_cuda(
               q, k, v, block_q=bq, block_kv=bkv, causal=True, scale=None)),
           "plain_ms": time_ms(lambda: kfa.attention_plain(
               q, k, v, block_q=bq, block_kv=bkv, causal=True)),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True))}
    kfa.flash_attention_kernel.launches = n0
    pairs = S * (S + 1) // 2                    # causal (query, key) pairs
    flops = 4.0 * B * H * pairs * d
    nbytes = 2 * d * S * B * (2 * H + 2 * Hkv)
    row["bound_ms"] = max(nbytes / HBM_BW, flops / BF16_PEAK) * 1e3
    row["bound_by"] = "bytes" if nbytes / HBM_BW >= flops / BF16_PEAK \
        else "operations"
    per_shape.append(row)
    times["flash_attention@prefill"] = {k_: row[k_] for k_ in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    emit({"phase": "times", "timing": "CUDA graph of 10 calls after 3 "
          "warm-up calls, median of 5 replays between CUDA events, per "
          "call", "rows": per_shape,
          "summary": times})
    return times


if __name__ == "__main__":
    sys.exit(main())
