#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero:

1. build    — compile every CUDA source (one nvcc each, all at once: the
              GEMM, flash attention and the calibration probes) and record
              the card (``nvidia-smi`` name and power limit); a spill or a
              wgmma serialisation note of a flash_bwd kernel, the f32 flash
              forward (flash_fwd_tf32x3) or an f32 GEMM kernel fails it.
   examples — the example scripts' port twins as subprocesses
              (``PYTHONPATH=src``, the built kernels reused):
              ``examples/quickstart_torch.py`` (the selected config on the
              GEMM kernel, within 0.3 sqrt(K) of the plain product) and
              ``serve_lm_torch.py --gen 8`` for phi4-mini-3.8b,
              qwen3-moe-30b-a3b, mamba2-370m, zamba2-7b, musicgen-large and
              llava-next-mistral-7b (smoke size) together, then
              ``train_lm_torch.py --d-model 768 --layers 12 --steps 100``
              (about 106 M params; its loss must fall) alone; each must
              exit 0, and the phase end within 120 s.  One row: each
              run's seconds, quickstart's max |err|, train_lm's first and
              last loss and tokens/s, each serve run's tokens/s.
2. gemm     — the GEMM kernel against its plain version on the card: the
              phi4-mini step shapes at M = 4 and 512 with the path's
              epilogues, gelu/silu/bias at one shape each, forced configs
              at the menu's corners, group_m > 1 on ragged M/N/K, stream-K
              strips and split-K shard ranges that do not line up with
              tiles, and f32 inputs/outputs; then the SSM and hybrid main
              paths at their selected configs, at M = 4 (decode) and 474
              (the longest served prompt): mamba2-370m's six projections,
              zamba2-7b's six and its shared block's seven, in bf16 and
              (zamba2-7b, as its f32 serve runs them) in f32.  Every case
              launches twice and must repeat bitwise (``deterministic``)
              with every fixup flag down again; one split launch replays
              in a CUDA graph.
3. flash    — the flash-attention kernels against their plain version:
              (2, 24, S, 128) q over (2, 8, S, 128) k/v, causal and not,
              S in {512, 1000}; the served prefill shapes (phi4-mini 24/8
              heads at S = 336 and 474, qwen3-moe 32/4 at 474) with v as
              the model passes it (a transposed view); S = 40, shorter
              than a q block; every pair of the block menu; then every
              head dim d in {16, 32, 64, 112, 128, 160} in bf16 (the wgmma
              kernel) and f32 (the split-TF32 kernel; also d 8 and 256),
              causal and not, GQA and
              not, and zamba2-7b's served shape (1, 32, 474, 112) with v
              as the model passes it, in both dtypes.  bf16 at atol
              1e-2 + rtol 2e-2, f32 at atol 2e-5 + rtol 1e-4.  Every case
              launches twice and must repeat bitwise.
   probe    — the three calibration probe kernels (``csrc/probes.cu``)
              against their plain versions at the calibration sweeps'
              shapes: the stream read at each level's window and the issue
              sweep's, the wgmma chain in every dtype, the wave grid at
              one wave, the C / C + 1 cliff and two waves.  Checksums must
              be equal and two launches bitwise equal.
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
6. times    — each kernel at the main-path shapes (phi4-mini's layer
              GEMMs, mamba2-370m's and zamba2-7b's mamba layer GEMMs, the
              latter in bf16 and f32, at decode and prefill M; the
              flash kernel at phi4-mini's, qwen3-moe's and zamba2-7b's
              largest prompt, zamba2-7b's again in f32, on the split-TF32
              kernel): kernel, plain and
              one-call library times (CUDA graphs and events) and
              the bound max(flop / peak, bytes / 3.35e12); each GEMM row
              also gives its grid (``ctas``), its split tiles, the latency
              model's prediction (``model_ms``) and the wrapper's host
              microseconds per call; each attention row (phi4-mini and
              qwen3-moe at their largest edge) its selected blocks, grid
              and ``model_ms``, and every menu pair's time beside its
              price.
7. calib    — ``fit_topology(GPU_H100_LIKE, TorchDevice())`` with no
              degraded mode: the probe kernels' sweeps on the card, every
              fitted field beside its preset value with its residual, the
              static share and the C / C + 1 wave cliff (the
              ``calib_constants`` line also gives the latency and wave
              sweeps' intercepts, whose difference is ``hbm_latency``);
              the artifact is
              saved under ``experiments/calib/`` and must reload through
              the guarded loader undegraded.
   fidelity — the exhaustive-autotune oracle (pruned, as the reference's
              default) on phi4-mini's served GEMM shapes, M in {4, 512} x
              (N, K) in {(3072, 3072), (8192, 3072), (3072, 8192)}, bf16 in
              and f32 out, every candidate timed by the GEMM kernel: the
              preset's and the calibrated topology's selections against the
              oracle's argmin.  Every candidate measured must first agree
              with the plain product of its shape.
   residual — ``rows_from_sweep`` (top 12 a shape) on the same shapes, a
              corrector fitted from those rows and its picks against the
              oracle (scored on the shapes it was fitted on).
8. serve_calibrated — phase 4's traffic on phi4-mini-3.8b at full width
              and depth, served against the calibrated artifact with
              ``--trace-dir``: both kernels must launch with no rung or
              retry; the warm and decode drift rows are counted and must
              feed ``rows_from_drift``.
9. serve_ssm — mamba2-370m at full size on phase 4's traffic with no
              bucket plan (a recurrent state would integrate the pad):
              the GEMM launches must equal the reckoning (six a mamba
              layer per prefill and per decode step); logits against the
              plain path as in phase 4; ssm_trace as phase 4b.
   serve_hybrid — zamba2-7b at full width and depth (81 layers, d_model
              3584, shared attention of 32 heads of 112), the same
              traffic: the GEMM launches must equal the reckoning (plus
              nine per shared-block application in a prefill, seven in a
              decode step) and the flash launches 13 a prefill; a trace;
              logits against the plain path; then the same model in f32 (4
              requests of 4 tokens), whose prefill attention runs the
              split-TF32 flash kernel, its logits against the plain path in f32
              within ``F32_LOGITS_REL_CAP``.
10. train_kernels — the training kernels against their plain versions at
              phi4-mini's training shapes (T = B x S = 2048 tokens), each
              launched twice and bitwise equal: the GEMM with W read
              transposed (dX = dY W^T) and with X read transposed (dW =
              X^T dY) for each of the layer's seven projections in bf16 and
              one f32 case of each; the flash forward's lse and the flash
              backward at (4, 24/8, 512, 128) causal, at d in {16, 64,
              112, 160, 256}, at S = 77 and in f32 (d 128 and 112); the
              epilogue backward of each activation in bf16 and f32; the
              grouped GEMM's backward at qwen3-moe's training shapes (128
              experts of capacity 160): dX with w read transposed and dW
              with x read transposed for wu / wg and wd in bf16, one f32
              case of each, and the grouped epilogue backward (dbias an
              expert).  The bf16 backward must take the wgmma route.
    train_grads — phi4-mini, then qwen3-moe-30b-a3b, at full width with 2
              layers, B 2 x S 512: one loss and gradient on the kernel
              route against the plain route on the card, in bf16 (the
              loss, each position's NLL as one vector and each leaf within
              2x the plain bf16 route's distance from the plain f32 route;
              the kernel route twice, bitwise) and in f32 (each leaf within
              1e-4: the f32 backward kernels' path; launches equal to the
              reckoning; the MoE's experts the same for every token copy
              on both routes; the f32 run's forwards and backwards are the
              kernels line's flash_attention_f32@train_grads launches).
    train_grads_f32 — mixtral-8x22b at one layer on one row of 4,608
              tokens (its 4,096-key window binding): train_grads' f32 half
              alone, the kernels line's flash_attention_f32@window and
              flash_attention_bwd_f32@window launches.  Its bf16 half is
              no phase: its loss scalar misses the 2x criterion at this
              seed (ROADMAP C10).
    train   — the driver's step functions (loss and gradients under retry,
              then the in-place AdamW commit) on phi4-mini-3.8b at full
              width and depth with remat: 6 steps on one repeated batch of
              B 4 x S 512, AdamW(lr=1e-3, weight_decay=0); the launches of
              the forward, the remat recompute and the backward each equal
              the reckoning (``_train_reckoning``), the loss falls, the
              norms are finite and no degraded mode fires; tokens/s, ms a
              step and peak memory.
    train_trace — one traced train step: wall time against device-busy
              time, kernel time by kernel; the attention backward must run
              its three wgmma-route kernels a layer and no f32 one.
    train_moe, train_ssm, train_hybrid — the train phase, 3 steps each, for
              qwen3-moe-30b-a3b at full width with 4 of its 48 layers
              (then train_moe_trace), mamba2-370m at full size, zamba2-7b
              at full width with 12 of its 81 layers.
    train_times — the training kernels' times at those shapes beside
              their bounds, plain versions and library calls (the grouped
              backward beside ``torch.bmm``, with each product's achieved
              HBM rate over the bound's bytes and over the bytes its walk
              reads under ``kmm.l2_reckoning``), and the f32 flash forward
              with lse at train_grads' shape beside the library's f32
              attention; the library's attention backward alone is
              captured in a CUDA graph too (``backward_ms``).
11. The rest of the zoo (after serve_hybrid; train_audio after
    train_hybrid):
    flash_window — every flash kernel with a sliding window, in bf16
              and f32, against its plain version: the forward against
              ``chunked_attention`` (and its lse), the backward against
              ``attention_bwd_ref`` (a kv head's group at a time) with
              train_kernels' criteria; mixtral-8x22b's prefill (1, 48/8,
              8192, 128) at window 4096, windows 32, 100 and 128 at S 300
              and d 64, 128 and 160, each kernel twice and bitwise equal; a
              window past S bitwise the causal kernels.
    serve_zoo — musicgen-large (frame embeddings a request),
              llava-next-mistral-7b (the 2,880-position image prefix ahead
              of each text prompt), minitron-8b, stablelm-12b,
              internlm2-20b whole and mixtral-8x22b at 8 of 56 layers, full
              width, on phase 4's traffic, each freed before the next:
              launches equal to the reckoning (``_zoo_launches``) in
              prefills and decode steps apart, request 0's logits against
              the plain path at the served depth and, with the f32
              yardstick, at 2 layers; then mixtral serves one request of
              8,192 tokens (the window binds in prefill and decode).
    serve_tp — tensor- and expert-parallel serving (after serve_zoo, its
              models freed): phi4-mini-3.8b, qwen3-moe-30b-a3b,
              mamba2-370m and zamba2-7b whole (the SSM heads split over
              the ranks, the gated norm's sum of squares summed over
              them) and mixtral-8x22b at 8 layers, each on 2 spawned ranks
              sharing cuda:0 over gloo (collectives staged through the
              host), weights from ``init_shards`` at seed 0, phase 4's
              8 requests in two waves with 4 tokens each (TP_TRAFFIC,
              which keeps the script in its time).  Per rank: every
              request served whole, launches against the reckoning in
              prefills and decode steps apart, every GEMM at the local
              shapes, peak memory; request 0's prefill logits against the
              single-process run's on the same padded tokens (relative L2
              <= LOGITS_REL_CAP dense, MOE_FULL_REL_CAP MoE) and the
              served tokens against its tokens (counted).  The gemm phase
              checks the row-parallel products (f32 out, the residual in
              rank 0's flush) at phi4's local shapes.
    serve_tp_f32 — the same five models at 2 layers (zamba2-7b at 6, the
              least depth at which its shared block runs), full width, in
              f32 (mixtral with its window, which does not bind at these
              prompts): request 0's prefill logits on 2 ranks against one
              process, within TP_F32_REL_CAP (summation order only).
    window_times — the windowed forwards and backwards, bf16 and f32, at
              mixtral's shape beside the causal kernels, the plain
              versions and the library's attention with the window as a
              boolean mask (its backward alone in a CUDA graph,
              ``backward_ms``); the library's causal attention beside the bf16
              causal kernel.
    train_audio — musicgen-large whole, 3 steps of phase 10's train step
              with frame embeddings in the batch, at lr AUDIO_TRAIN_LR.
    train_zoo — the train phase, 3 steps each, for minitron-8b (6 layers),
              stablelm-12b (8), internlm2-20b (6), llava-next-mistral-7b
              (8; rows of its 2,880 patch positions and 512 text tokens) at
              B 4 x S 512, and mixtral-8x22b (1 layer) at B 1 x S 8192,
              where its window binds; full width, each under 45 GB of
              state, lr ZOO_TRAIN_LR; launches equal to the reckoning, the
              loss falls.
    Last, after train_times:
    train_dp_f32 — data-parallel, FSDP and tensor-parallel training on
              ranks sharing cuda:0 over gloo (``--shared-card``'s mode,
              collectives staged through the host): qwen3-moe-30b-a3b at
              full width, 2 layers, f32, on a (data 2, model 2) mesh with
              its FSDP and the default (global) MoE dispatch, zamba2-7b at
              6 layers on (2, 2) with its FSDP, phi4-mini-3.8b at 2 layers
              on (2, 1) and mamba2-370m at 2 layers on (1, 2), weights
              from ``init_shards`` (seed 5), each rank its rows of a
              2 x 512 batch.  The one-process step on the card runs first
              and is freed; its loss, gradients and updated params go to a
              file each rank reads memory-mapped.  One step on the ranks:
              every leaf (gradients and updated params, each rank's blocks,
              the sums of squares added over the shard axes; the SSM
              block's whole in_b, in_c and B / C convs among them) within
              1e-4 relative L2 (the SSM and hybrid cases' gradients; their
              updated params are reported beside the gradients' sign
              flips, ``_dp_f32_report``), the loss within 1e-5; each
              rank's launches equal to the reckoning and its GEMMs at the
              local shapes (rows, heads, SSM heads, experts; FSDP weights
              gathered whole over data).
    train_dp — qwen3-moe-30b-a3b in bf16 on (2, 2) at the depth a printed
              reckoning of the bytes a rank and of the checkpoint allows
              (DP_RANK_BUDGET, DP_CKPT_BUDGET), 3
              steps on a 4 x 512 batch: ms a step, global tokens/s, peak
              GB a rank, host seconds and share of each collective
              (``all_reduce_``, ``all_gather_dim``, ``reduce_scatter_dim``),
              launches against the reckoning, the loss falling; then the
              state saved with its shardings (gathered whole, written once)
              and restored on (1, 2) by 2 other ranks: the (2, 2) blocks of
              every leaf, hashed after the restore, equal the shards' own
              hashes (bit for bit).
    dryrun — the port's dry-run (``launch/dryrun.py``) on a (1, 1) mesh, on
              the host, at the train phase's phi4-mini cell (B 4 x S 512)
              and the serve phase's decode step: the estimated GB beside the
              measured peak, the counted FLOPs beside ``model_flops``,
              ``roofline_s`` beside the measured ms a step; its GEMM calls
              and FLOPs must equal the reckoning of the launches those
              phases check.
Each serve phase counts the launches of every kernel inside the model's
prefills and inside its decode steps apart.  The line before the last is
the kernels summary (a row's launches are those of its own run and step
kind, its max_abs_err the worst of its own shapes' cases in phases 2 and
3; the dense, flash and grouped rows add ``serve_tp_launches``, each
rank's launches in serve_tp, and the training rows ``train_dp_launches``,
each rank's in train_dp), after a line with the script's total
seconds; the last line is
``{"ok": true, "device": {...}}``.  With no CUDA device, or run from a
directory without the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
# Rows of the serve and train phases the dryrun phase reads, by phase.
MEASURED = {}

BF16_PEAK = 989e12          # H100 SXM dense bf16 tensor-core flop/s
HBM_BW = 3.35e12            # H100 SXM HBM3 bytes/s
L2_BYTES = 50 * 1024**2      # H100 L2, for kmm.l2_reckoning
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
# f32 attention: the kernel takes every product in split TF32, the softmax
# and the sums in f32 (tests/test_kernels.py's attention tolerance).
FLASH_F32_ATOL, FLASH_F32_RTOL = 2e-5, 1e-4
F32_PEAK = 67e12            # H100 SXM f32 flop/s outside the tensor cores
# The f32 GEMM and the f32 flash forward and backward take every product as
# three TF32 tensor-core products (split TF32): their rate is a third of the
# TF32 peak.
TF32X3_PEAK = 495e12 / 3
# The kernels-line rows whose kernel computes in split TF32 ("products").
TF32X3_ROWS = ("matmul_f32@hybrid_decode", "matmul_f32@hybrid_prefill",
               "flash_attention_f32@hybrid", "flash_attention_f32@train_grads",
               "flash_attention_bwd_f32@train_grads",
               "flash_attention_f32@window", "flash_attention_bwd_f32@window")
# The f32 serve's prefill logits, kernel path vs plain path (relative L2):
# both run in f32 and differ only in summation order (predicted ~1e-5
# after 81 layers; a kernel that rounds to tf32 or bf16 gives > 1e-2).
F32_LOGITS_REL_CAP = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def ptxas_faults(log: str, marker: str):
    """The ``-Xptxas -v`` lines that fault a kernel whose (mangled) name
    holds ``marker``: a note that ptxas serialised its wgmma (C7514: an
    accumulator read inside an open wgmma stage; C7515, C7520) or spill
    stores or loads.  A note belongs to the entry function being
    compiled."""
    import re
    faults, func = [], ""
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            func = m.group(1)
        if re.search(r"C751[45]|C7520|serializ", ln) \
                and (marker in ln or marker in func):
            faults.append(ln.strip())
        elif marker in func and re.search(r"[1-9]\d* bytes spill", ln):
            faults.append(f"{func}: {ln.strip()}")
    return faults


def time_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph
    (after three warm-up calls), the graph replayed ``reps`` times between
    CUDA events, the median replay divided by ``calls``.  The graph takes
    the host's launch overhead out of the time."""
    from repro_torch.calib.device import graph_time
    return graph_time(fn, calls, reps) * 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import probes as kpr

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
    summary, faults = {}, []
    for name, (sec, log) in report.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "C75" in ln]
        summary[name] = {"seconds": round(sec, 2), "ptxas": lines}
        for marker in ("flash_bwd", "flash_fwd_tf32x3", "gemm_dense_f32",
                       "gemm_grouped_f32"):
            faults += ptxas_faults(log, marker)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": summary, "flash_bwd_faults": faults})
    if faults:
        fail(f"build: ptxas spilled or serialised wgmma in a flash_bwd, "
             f"the f32 flash forward or an f32 GEMM kernel: {faults}")

    examples_phase()
    flash_err = flash_phase(torch, dev, kfa)
    window_err = flash_window_phase(torch, dev, kfa)
    max_err = gemm_phase(torch, dev, kmm)
    max_err.update(window_err)
    max_err.update({
        "flash_attention@prefill": flash_err[("bfloat16", 128)],
        "flash_attention@hybrid": flash_err[("bfloat16", 112)],
        "flash_attention_f32@hybrid": flash_err[("float32", 112)],
        "expert_matmul@prefill": expert_gemm_phase(torch, dev, kmm)})
    probe_times = probe_phase(torch, dev, kpr)
    # the probe phase demands checksums equal to the plain versions'
    max_err.update(dict.fromkeys(("stream_read@calib", "mma_chain@calib",
                                  "wave_grid@calib"), 0.0))
    tp_refs = []              # the single-process runs serve_tp is held to
    model, params, launches, edges = serve_phase(torch, dev, kmm, kfa,
                                                 tp_refs)
    trace_phase(torch, dev, model, params)
    del model, params
    _free(torch)
    model, params, moe_launches, moe_capacity, moe_edge = serve_moe_phase(
        torch, dev, kmm, kfa, tp_refs)
    trace_phase(torch, dev, model, params, phase="moe_trace")
    del model, params
    _free(torch)
    times = times_phase(torch, dev, kmm, kfa, edges, moe_capacity, moe_edge)
    calib, probe_launches = calib_phase(torch, dev, kpr)
    times.update(probe_times)
    memo = fidelity_phase(calib)
    residual_phase(memo, calib)
    serve_calibrated_phase(torch, dev, kmm, kfa, calib)
    ssm_launches = serve_ssm_phase(torch, dev, kmm, kfa, tp_refs)
    hybrid_launches, f32_launches = serve_hybrid_phase(torch, dev, kmm, kfa,
                                                       tp_refs)
    window_launches = serve_zoo_phase(torch, dev, kmm, kfa, tp_refs)
    tp_launches = serve_tp_phase(torch, tp_refs)
    serve_tp_f32_phase(torch, tp_refs)
    times.update(window_times_phase(torch, dev, kfa))
    max_err.update(train_kernels_phase(torch, dev, kmm, kfa))
    grads_launches = train_grads_phase(torch, dev, kmm, kfa)
    train_grads_phase(torch, dev, kmm, kfa, "qwen3-moe-30b-a3b")
    # mixtral at one layer on a row past its window: the windowed f32 flash
    # forward and backward on a model's path.
    window_grads = train_grads_f32_phase(torch, dev, kmm, kfa)
    model, state, batch, train_launches = train_phase(torch, dev, kmm, kfa)
    train_trace_phase(torch, dev, model, state, batch)
    del model, state, batch
    _free(torch)
    moe_train_launches = train_families_phase(torch, dev, kmm, kfa)
    model, state, batch, _ = train_phase(
        torch, dev, kmm, kfa, "musicgen-large", steps=FAMILY_TRAIN_STEPS,
        phase="train_audio", lr=AUDIO_TRAIN_LR)
    del model, state, batch
    _free(torch)
    zoo_window_launches = train_zoo_phase(torch, dev, kmm, kfa)
    times.update(train_times_phase(torch, dev, kmm, kfa))
    # Last: when train_times ran after these phases on an H100,
    # torch.profiler recorded no device kernel in this process.
    dp_launches = train_dp_phases(torch, dev, kmm, kfa)
    dryrun_phase()
    # Each row's launches: its own run, in its own step kind.
    launches = {
        "matmul@decode": launches["matmul@decode"],
        "matmul@prefill": launches["matmul@prefill"],
        "matmul@ssm_decode": ssm_launches["matmul@decode"],
        "matmul@ssm_prefill": ssm_launches["matmul@prefill"],
        "matmul@hybrid_decode": hybrid_launches["matmul@decode"],
        "matmul@hybrid_prefill": hybrid_launches["matmul@prefill"],
        "matmul_f32@hybrid_decode": f32_launches["matmul@decode"],
        "matmul_f32@hybrid_prefill": f32_launches["matmul@prefill"],
        "flash_attention@prefill": launches["flash_attention@prefill"],
        "flash_attention@hybrid": hybrid_launches["flash_attention@prefill"],
        "flash_attention_f32@hybrid": f32_launches["flash_attention@prefill"],
        "flash_attention@window": window_launches,
        "expert_matmul@prefill": moe_launches["expert_matmul@prefill"],
        **{f"{k}@calib": n for k, n in probe_launches.items()},
        "matmul@train_dgrad": train_launches["nt"],
        "matmul@train_wgrad": train_launches["tn"],
        "flash_attention@train": train_launches["flash"],
        "flash_attention_bwd@train": train_launches["flash_bwd"],
        "flash_attention_f32@train_grads": grads_launches["flash"],
        "flash_attention_bwd_f32@train_grads": grads_launches["flash_bwd"],
        "flash_attention_f32@window": window_grads["flash"],
        "flash_attention_bwd@window": zoo_window_launches["flash_bwd"],
        "flash_attention_bwd_f32@window": window_grads["flash_bwd"],
        "epilogue_bwd@train": train_launches["epilogue_bwd"],
        "expert_matmul_bwd@train_moe_dgrad": moe_train_launches["expert_nt"],
        "expert_matmul_bwd@train_moe_wgrad": moe_train_launches["expert_tn"],
        "epilogue_bwd_grouped@train_moe":
            moe_train_launches["epilogue_bwd_grouped"]}

    gemm_src = ("src/repro_torch/csrc/matmul.cu",
                "src/repro/kernels/matmul.py:108")
    flash_src = ("src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:136")
    expert_src = ("src/repro_torch/csrc/matmul.cu",
                  "src/repro/kernels/ops.py:308")
    sources = {
        "matmul": gemm_src, "matmul_f32": gemm_src,
        "flash_attention": flash_src, "flash_attention_f32": flash_src,
        "flash_attention_bwd": flash_src, "flash_attention_bwd_f32": flash_src,
        "epilogue_bwd": gemm_src,
        "expert_matmul": expert_src, "expert_matmul_bwd": expert_src,
        "epilogue_bwd_grouped": expert_src,
        "stream_read": ("src/repro_torch/csrc/probes.cu",
                        "src/repro/calib/device.py:144"),
        "mma_chain": ("src/repro_torch/csrc/probes.cu",
                      "src/repro/calib/device.py:181"),
        "wave_grid": ("src/repro_torch/csrc/probes.cu",
                      "src/repro/calib/device.py:208")}
    idle = [key for key, n in launches.items() if n <= 0]
    if idle:
        fail(f"kernels never launched on their main path: {idle}")
    entries = []
    for key in launches:
        source, replaces = sources[key.split("@")[0]]
        t = times[key]
        entries.append({"name": key, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": max_err[key],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"],
                        **({"products": "tf32x3"} if key in TF32X3_ROWS
                           else {}),
                        **({"serve_tp_launches": tp_launches[key]}
                           if key in tp_launches else {}),
                        **({"train_dp_launches": dp_launches[key]}
                           if key in dp_launches else {})})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
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
# The examples phase: the example scripts' port twins on the card.
# ---------------------------------------------------------------------------

EXAMPLE_SERVE_ARCHS = ("phi4-mini-3.8b", "qwen3-moe-30b-a3b", "mamba2-370m",
                       "zamba2-7b", "musicgen-large", "llava-next-mistral-7b")
EXAMPLE_TRAIN_ARGS = ["--d-model", "768", "--layers", "12", "--steps", "100"]
# The quickstart and the six serve runs start together (each is host-bound
# and small); the training run follows on its own, so its tokens/s is its
# own.
EXAMPLE_RUNS = [
    [("quickstart", ["quickstart_torch.py"])]
    + [(f"serve_lm {arch}", ["serve_lm_torch.py", "--arch", arch, "--gen",
                             "8"]) for arch in EXAMPLE_SERVE_ARCHS],
    [("train_lm", ["train_lm_torch.py", *EXAMPLE_TRAIN_ARGS])]]
EXAMPLE_TIMEOUT_S = 300
EXAMPLES_BUDGET_S = 120.0   # the most the phase may add to the script


def examples_phase() -> None:
    """Run ``examples/{quickstart,serve_lm,train_lm}_torch.py`` as
    subprocesses (``PYTHONPATH=src``) on the card, after the build (the
    kernels' hashed libraries are reused, nothing rebuilds): each must exit
    0.  One row: each run's seconds, quickstart's max |err| (its own assert
    holds it under 0.3 sqrt(K)), train_lm's first and last loss (its own
    assert: the last below the first) and tokens/s, each serve run's
    tokens/s.  The phase fails past ``EXAMPLES_BUDGET_S``."""
    import os
    import re
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p])}
    t0 = time.perf_counter()
    runs = {}
    for wave in EXAMPLE_RUNS:
        procs = [(name, time.perf_counter(), subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / argv[0]), *argv[1:]],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)) for name, argv in wave]
        for name, start, proc in procs:
            try:
                out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            runs[name] = {"rc": proc.returncode, "out": out, "err": err,
                          "seconds": time.perf_counter() - start}
    row = {"phase": "examples", "seconds": time.perf_counter() - t0,
           "budget_s": EXAMPLES_BUDGET_S,
           "runs": {name: {"rc": r["rc"], "seconds": r["seconds"]}
                    for name, r in runs.items()}}
    bad = {name: r["err"][-800:] or r["out"][-800:]
           for name, r in runs.items() if r["rc"] != 0}
    if bad:
        emit(row)
        fail(f"examples: non-zero exit: {bad}")

    def grab(name, pattern):
        found = re.findall(pattern, runs[name]["out"])
        if not found:
            emit(row)
            fail(f"examples: {name} printed no {pattern!r}")
        return found[-1]
    row["quickstart_max_abs_err"] = float(grab("quickstart",
                                               r"max \|err\| = (\S+)"))
    first, last = grab("train_lm", r"loss (\S+) -> (\S+) over")
    row["train_lm"] = {
        "args": EXAMPLE_TRAIN_ARGS,
        "params": grab("train_lm", r"params: (\S+)"),
        "first_loss": float(first), "last_loss": float(last),
        "tokens_per_s": float(grab(
            "train_lm", r"loss \S+ +([\d,.]+) tok/s").replace(",", ""))}
    row["serve_lm_tokens_per_s"] = {
        arch: float(grab(f"serve_lm {arch}",
                         r"at ([\d.]+) tok/s total"))
        for arch in EXAMPLE_SERVE_ARCHS}
    emit(row)
    if row["seconds"] > EXAMPLES_BUDGET_S:
        fail(f"examples: {row['seconds']:.1f} s, over the phase's budget "
             f"of {EXAMPLES_BUDGET_S} s")


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


def _epilogues():
    from repro_torch.core.latency import Epilogue
    return {"none": Epilogue(), "residual": Epilogue(residual=True),
            "swiglu_gate": Epilogue(activation="swiglu_gate")}


def gemm_phase(torch, dev, kmm):
    """Returns the worst absolute error of each kernels-line GEMM row's
    cases (the general cases under phi4-mini's rows)."""
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import Epilogue, TileConfig
    from repro_torch.core.selector import select_gemm_config
    from repro_torch.kernels.ops import _dtype_name, _model_dtype_name
    from repro_torch.kernels.ref import gemm_tolerance

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
        # f32 inputs (split-TF32 path) and bf16 -> f32 outputs
        (128, 256, 512, none, f32, f32, None),
        (100, 300, 77, Epilogue(bias=True, activation="gelu"), f32, f32,
         TileConfig(64, 64, 32)),
        (512, 3072, 3072, swi, bf, f32, None),
    ]
    # The tensor-parallel row products (serve_tp, phi4-mini over 2 ranks):
    # a rank's half of K, f32 out for the all_reduce, the residual (bf16
    # beside the f32 output) in the first rank's flush only.
    for M in (4, RAGGED_PREFILL_M):
        cases += [(M, 3072, 1536, res, bf, f32, None),     # wo, rank 0
                  (M, 3072, 4096, res, bf, f32, None),     # wd, rank 0
                  (M, 3072, 4096, none, bf, f32, None)]    # wd, rank 1
    # The SSM and hybrid main paths' GEMMs at their selected configs, at
    # decode M and the longest served prompt, each case under its row (a
    # decode step fuses no residual: the block adds it after the GEMM).
    eps = _epilogues()
    row_of = {}
    for key, gemms, dt in (
            ("matmul@ssm", SSM_GEMMS, bf),
            ("matmul@hybrid", MAMBA_GEMMS + SHARED_GEMMS, bf),
            ("matmul_f32@hybrid", MAMBA_GEMMS + SHARED_GEMMS, f32)):
        for M, step in ((4, "decode"), (RAGGED_PREFILL_M, "prefill")):
            for _, N, K, epn in gemms:
                if step == "decode" and epn == "residual":
                    epn = "none"
                row_of[len(cases)] = f"{key}_{step}"
                cases.append((M, N, K, eps[epn], dt, dt, None))
    worst = {"matmul@decode": 0.0, **dict.fromkeys(row_of.values(), 0.0)}
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
        rtol, atol = gemm_tolerance(dt, K)
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
        key = row_of.get(i, "matmul@decode")
        worst[key] = max(worst[key], float(err.max()))
    worst["matmul@prefill"] = worst["matmul@decode"]
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


# Every head dim of both registries at full and smoke size on the served
# path (16, 32, 64, 112, 128, 160) in bf16 and f32 (and d 8 and 256 in
# f32), causal and not, GQA and not, v as the model passes it under causal:
# (..., d, dtype).
FLASH_DIMS = (16, 32, 64, 112, 128, 160)
FLASH_DIM_CASES = [(1, 8, hkv, 300, causal, None, causal, d, dt)
                   for d in FLASH_DIMS for dt in ("bfloat16", "float32")
                   for causal in (True, False) for hkv in (2, 8)] + [
    # the split-TF32 kernel's ends: one 8-column block, and DP 256 with its
    # 32-key ring stages
    (1, 8, hkv, 300, causal, None, causal, d, "float32")
    for d in (8, 256) for causal in (True, False) for hkv in (2, 8)] + [
    # zamba2-7b's shared attention as served: causal, 32 heads, no GQA
    (1, 32, 32, 474, True, None, True, 112, dt)
    for dt in ("bfloat16", "float32")]


def _attn_inputs(torch, dev, B, H, Hkv, S, model_v, seed, d=128,
                 dtype="bfloat16"):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, H, S, d), generator=g, device=dev).to(dt)
    k = torch.randn((B, Hkv, S, d), generator=g, device=dev).to(dt)
    if model_v:
        v = torch.randn((B, S, Hkv, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
    else:
        v = torch.randn((B, Hkv, S, d), generator=g, device=dev).to(dt)
    return q, k, v


def flash_phase(torch, dev, kfa):
    """Returns the worst absolute error of each (dtype, head dim)."""
    worst = {}
    rows = []
    cases = [c + (128, "bfloat16") for c in FLASH_CASES] + FLASH_DIM_CASES
    for i, (B, H, Hkv, S, causal, blocks, model_v, d, dtype) in \
            enumerate(cases):
        q, k, v = _attn_inputs(torch, dev, B, H, Hkv, S, model_v, 100 + i,
                               d=d, dtype=dtype)
        plan = kfa.plan_attention(S, S, d, batch=B, heads=H, kv_heads=Hkv,
                                  in_dtype=dtype, causal=causal)
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
        atol, rtol = ((FLASH_F32_ATOL, FLASH_F32_RTOL) if dtype == "float32"
                      else (FLASH_ATOL, FLASH_RTOL))
        ok = bool((err <= atol + rtol * want.float().abs()).all())
        ok = ok and bool(torch.isfinite(got).all()) and launched
        ok = ok and got.dtype == q.dtype
        det = bool(torch.equal(got, again))
        rows.append({"q": [B, H, S, d], "kv": [B, Hkv, S, d],
                     "dtype": dtype, "causal": causal,
                     "v_strides": list(v.stride()),
                     "blocks": [bq, bkv] if dtype == "bfloat16" else None,
                     "selected": blocks is None,
                     "ctas": (B * H * -(-S // bq) if dtype == "bfloat16"
                              else kfa.plan_attention_f32(
                                  S, d, batch=B, heads=H).ctas),
                     "max_abs_err": float(err.max()),
                     "deterministic": det, "ok": ok and det})
        if not ok or not det:
            emit({"phase": "flash", "cases": rows})
            fail(f"flash attention {rows[-1]} disagrees with its plain "
                 f"version or does not repeat bitwise")
        worst[dtype, d] = max(worst.get((dtype, d), 0.0), float(err.max()))
    emit({"phase": "flash", "tolerance": f"bf16 out: atol {FLASH_ATOL} + "
          f"rtol {FLASH_RTOL} (the kernel rounds P to bf16 before P V; the "
          f"plain version keeps it f32); f32 out: atol {FLASH_F32_ATOL} + "
          f"rtol {FLASH_F32_RTOL}", "deterministic": "two launches "
          "bitwise equal", "head_dims": list(FLASH_DIMS), "cases": rows})
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
    from repro_torch.kernels.ref import gemm_tolerance

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
        # f32 inputs (split-TF32 path)
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
        rtol, atol = gemm_tolerance(dt, K)
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


@contextlib.contextmanager
def plain_path(kmm, kfa):
    """Every kernel launch, forward and backward, replaced by its plain
    version, for reference runs of the same model code on the card; launch
    counts do not move."""
    with mock.patch.object(kmm, "_launch_cuda", kmm.matmul_plain), \
            mock.patch.object(kmm, "_launch_expert_cuda",
                              kmm.expert_matmul_plain), \
            mock.patch.object(kmm, "_launch_epilogue_bwd_cuda",
                              kmm.epilogue_bwd_plain), \
            mock.patch.object(kfa, "_launch_cuda", kfa.attention_plain), \
            mock.patch.object(kfa, "_launch_bwd_cuda",
                              kfa.attention_bwd_plain):
        yield


def _serve(torch, dev, kmm, kfa, arch, extra=(), phase=None, params=None,
           cfg=None, base=SERVE_ARGS):
    """Random params from the seed (or ``params``), then ``run_serving`` on
    the phase's traffic (``base`` plus ``extra`` flags; ``cfg`` for a model
    cut in depth) with every launch count zeroed right before and read
    right after.  Fails unless every request finished with in-vocabulary
    tokens, with no fallback rung and no launch retry, and unless the dense
    GEMM and (where the model has attention) the flash kernel launched."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_parser, run_serving
    from repro_torch.nn.model import Model
    from repro_torch.obs import metrics as obs_metrics

    args = build_parser().parse_args(["--arch", arch, *base, *extra])
    cfg = cfg or get_config(args.arch)
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = model.init(gen)
    torch.cuda.synchronize()
    emit({"phase": "serve_init", "arch": cfg.name,
          "params": sum(t.numel() for t in _leaves(params)),
          "param_bytes": sum(t.numel() * t.element_size()
                             for t in _leaves(params)),
          "param_dtypes": sorted({str(t.dtype)[6:] for t in _leaves(params)}),
          "seconds": time.perf_counter() - t0})

    prev_metrics = obs_metrics.enable_metrics(True)
    obs_metrics.get_registry().clear()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out, launches = _count_serve(
        kmm, kfa, lambda: run_serving(args, params=params, cfg=cfg))
    wall = time.perf_counter() - t0
    reg = obs_metrics.get_registry()
    fallback = sum(m.value for m in reg.metrics()
                   if m.name == "fallback_rungs")
    retries = sum(m.value for m in reg.metrics()
                  if m.name == "launch_retries")
    obs_metrics.enable_metrics(prev_metrics)
    results = out["results"]
    phase = phase or ("serve" if not cfg.is_moe else "serve_moe")
    MEASURED[phase] = {"peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                       "decode_ms_per_step": out["device_step_s_mean"] * 1e3,
                       "max_len": args.prompt_len + args.gen,
                       "batch": args.batch}
    emit({"phase": phase,
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
    if launches["matmul"] <= 0 or (cfg.family != "ssm"
                                   and launches["flash_attention"] <= 0):
        fail(f"{cfg.name}: main path did not launch the dense GEMM and "
             f"flash kernels ({launches})")
    if fallback or retries:
        fail(f"{cfg.name}: fallback rungs {fallback}, launch retries "
             f"{retries}")
    if len(results) != args.requests or not all(
            r.finished for r in results.values()):
        fail(f"{cfg.name}: not every request finished")
    for r in results.values():
        if len(r.tokens) != args.gen or not (
                (r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all():
            fail(f"{cfg.name} request {r.rid}: bad tokens "
                 f"{r.tokens.tolist()}")
    return args, model, params, out, launches


def _count_serve(kmm, kfa, run):
    """``run()`` with every launch count zeroed right before and read right
    after: (its result, the launches of each kernel in all, and inside the
    model's prefills and its decode steps apart)."""
    from repro_torch.nn import transformer
    counters = {"matmul": kmm.tiled_matmul,
                "expert_matmul": kmm.tiled_expert_matmul,
                "flash_attention": kfa.flash_attention_kernel}
    split = {"prefill": dict.fromkeys(counters, 0),
             "decode": dict.fromkeys(counters, 0)}

    def counted(kind, fn):
        def call(*a, **kw):
            n0 = {k: c.launches for k, c in counters.items()}
            try:
                return fn(*a, **kw)
            finally:
                for k, c in counters.items():
                    split[kind][k] += c.launches - n0[k]
        return call

    for fn in counters.values():
        fn.launches = 0
    with mock.patch.object(transformer, "prefill_forward",
                           counted("prefill", transformer.prefill_forward)), \
            mock.patch.object(transformer, "decode_step",
                              counted("decode", transformer.decode_step)):
        out = run()
    launches = {k: fn.launches for k, fn in counters.items()}
    for kind, counts in split.items():
        launches.update({f"{k}@{kind}": n for k, n in counts.items()})
    return out, launches


def _request_inputs(torch, dev, args, cfg, r):
    """Request ``r``'s prompt as served (``serve.request_queue``):
    right-padded to its bucket edge, with its last real position and its
    frontend inputs as the engine hands them to the prefill (or None)."""
    from repro_torch.launch.engine import _extras_at
    from repro_torch.launch.serve import request_queue
    prompt, extras = request_queue(args, cfg, dev)[r.rid]
    tokens = torch.zeros((1, r.padded_len), dtype=torch.int64, device=dev)
    tokens[0, :r.prompt_len] = torch.from_numpy(prompt).to(dev)
    return (tokens, torch.tensor([r.prompt_len - 1], device=dev),
            _extras_at(extras, r.padded_len, dev))



def _rel(torch, x, y) -> float:
    return float(torch.linalg.vector_norm(x - y)
                 / torch.linalg.vector_norm(y))


def serve_phase(torch, dev, kmm, kfa, tp_refs):
    args, model, params, out, launches = _serve(torch, dev, kmm, kfa,
                                                "phi4-mini-3.8b")
    _logits_check(torch, dev, kmm, kfa, args, model, params, out,
                  "serve_logits")
    tp_refs.append(_tp_ref(torch, dev, kmm, kfa, args, model, params,
                           out))
    return model, params, launches, out["edges"]


def _logits_check(torch, dev, kmm, kfa, args, model, params, out, phase,
                  params32=None, f32=False):
    """One request's prefill logits: kernel path vs plain path on the card,
    against the plain path's own bf16-vs-f32 distance (``params32``: the
    f32 params, made here when not given).  With ``f32`` the served params
    are f32 already, and the kernel-vs-plain distance must stay within
    ``F32_LOGITS_REL_CAP``."""
    r0 = out["results"][0]
    tokens, last, _ = _request_inputs(torch, dev, args, model.cfg, r0)
    with torch.inference_mode():
        got, _ = model.prefill(params, tokens, last)
        with plain_path(kmm, kfa):
            want, _ = model.prefill(params, tokens, last)
            if f32:
                ref32 = want
            else:
                # The same plain path in f32: how far bf16 rounding alone
                # moves the logits, the yardstick for the kernel-vs-plain
                # distance.
                p32 = (_tree_map(params, lambda t: t.float())
                       if params32 is None else params32)
                ref32, _ = model.prefill(p32, tokens, last)
                del p32
    torch.cuda.synchronize()

    d_kp, d_p32 = _rel(torch, got, want), _rel(torch, want, ref32)
    tolerance = (f"kernel vs plain relative L2 <= {F32_LOGITS_REL_CAP} (both "
                 f"f32)" if f32 else
                 f"kernel vs plain relative L2 <= {LOGITS_REL_FACTOR} x "
                 f"(plain bf16 vs plain f32) and <= {LOGITS_REL_CAP}")
    emit({"phase": phase, "arch": model.cfg.name, "rid": r0.rid,
          "prompt_len": r0.prompt_len, "padded_len": r0.padded_len,
          "rel_l2_kernel_vs_plain": d_kp,
          "rel_l2_plain_bf16_vs_plain_f32": d_p32,
          "rel_l2_kernel_vs_plain_f32": _rel(torch, got, ref32),
          "max_abs_err": float((got - want).abs().max()),
          "plain_absmax": float(want.abs().max()),
          "argmax_equal": int(got.argmax()) == int(want.argmax()),
          "first_token_matches_served":
              int(got.argmax()) == int(r0.tokens[0]),
          "tolerance": tolerance})
    if not bool(torch.isfinite(got).all()) or (
            d_kp > F32_LOGITS_REL_CAP if f32 else
            d_kp > LOGITS_REL_CAP or d_kp > LOGITS_REL_FACTOR * d_p32):
        fail(f"{model.cfg.name} prefill logits disagree with the plain path "
             f"(rel {d_kp}, bf16 rounding alone {d_p32})")


# ---------------------------------------------------------------------------
# Phase 5: serve qwen3-moe-30b-a3b at full width and depth.
# ---------------------------------------------------------------------------

def serve_moe_phase(torch, dev, kmm, kfa, tp_refs):
    import dataclasses
    from repro_torch.nn.model import Model
    from repro_torch.nn.moe import _capacity

    args, model, params, out, launches = _serve(torch, dev, kmm, kfa,
                                                "qwen3-moe-30b-a3b")
    tp_refs.append(_tp_ref(torch, dev, kmm, kfa, args, model, params,
                           out))
    cfg = model.cfg
    per_prefill = 3 * cfg.num_layers       # wu, wg + gate, wd in each layer
    n_prefills = len(out["results"])
    if launches["expert_matmul"] != per_prefill * n_prefills:
        fail(f"grouped GEMM launched {launches['expert_matmul']} times, "
             f"expected {per_prefill} per prefill x {n_prefills} prefills "
             f"and none in decode")

    r0 = out["results"][0]
    tokens, _, _ = _request_inputs(torch, dev, args, cfg, r0)
    tokens = tokens[:, :r0.prompt_len]
    row = {"phase": "serve_moe_logits", "rid": r0.rid,
           "prompt_len": r0.prompt_len}
    with torch.inference_mode():
        # Full depth: kernel path vs plain path over every position.
        got = model.forward(params, tokens)[0]
        with plain_path(kmm, kfa):
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
        with plain_path(kmm, kfa):
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
    grouped GEMM's gemm_grouped_*, the epilogue backward's
    epilogue_bwd_kernel (csrc/matmul.cu); the flash forward's flash_fwd_*
    (bf16 flash_fwd_kernel, f32 flash_fwd_tf32x3), the backward's
    flash_bwd_* (csrc/flash_attention.cu; the f32 route's split-TF32
    kernels flash_bwd_*_tf32x3 apart)."""
    import os
    import tempfile
    groups = {"matmul": 0.0, "expert_matmul": 0.0, "flash_attention": 0.0,
              "flash_attention_bwd": 0.0, "flash_attention_bwd_f32": 0.0,
              "epilogue_bwd": 0.0, "other": 0.0}
    counts = dict.fromkeys(groups, 0)
    other = {}
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
        key = ("flash_attention" if "flash_fwd" in name else
               "flash_attention_bwd_f32" if "flash_bwd" in name
               and "tf32x3" in name else
               "flash_attention_bwd" if "flash_bwd" in name else
               "epilogue_bwd" if "epilogue_bwd" in name else
               "expert_matmul" if "gemm_grouped" in name else
               "matmul" if "gemm_dense" in name else "other")
        groups[key] += ev.get("dur", 0.0) / 1e3
        counts[key] += 1
        if key == "other":
            other[name] = other.get(name, 0.0) + ev.get("dur", 0.0) / 1e3
    if not any(counts.values()):
        fail("the profiler's trace holds no device kernel events")
    return groups, counts, other


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
            ms, counts, _ = _kernel_ms(prof)
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


MAMBA_GEMMS = [  # (name, N, K, epilogue) of one zamba2-7b mamba layer
    ("in_z", 7168, 3584, "none"), ("in_x", 7168, 3584, "none"),
    ("in_b", 64, 3584, "none"), ("in_c", 64, 3584, "none"),
    ("in_dt", 112, 3584, "none"), ("out_proj", 3584, 7168, "none")]
SHARED_GEMMS = [  # (name, N, K, epilogue) of zamba2-7b's shared block
    ("wq", 3584, 3584, "none"), ("wk", 3584, 3584, "none"),
    ("wv", 3584, 3584, "none"), ("wo", 3584, 3584, "residual"),
    ("wu", 14336, 3584, "none"), ("wg", 14336, 3584, "swiglu_gate"),
    ("wd", 3584, 14336, "residual")]
SSM_GEMMS = [  # (name, N, K, epilogue) of one mamba2-370m layer
    ("in_z", 2048, 1024, "none"), ("in_x", 2048, 1024, "none"),
    ("in_b", 128, 1024, "none"), ("in_c", 128, 1024, "none"),
    ("in_dt", 32, 1024, "none"), ("out_proj", 1024, 2048, "none")]
RAGGED_PREFILL_M = 474      # the longest prompt of the served traffic


EXPERT_GEMMS = [  # (name, N, K, epilogue) of one qwen3-moe layer's experts
    ("wu", 768, 2048, "none"), ("wg", 768, 2048, "swiglu_gate"),
    ("wd", 2048, 768, "none")]


def _gemm_bytes_flops(M, N, K, ep, elem=2):
    extra = M * N * elem if ep in ("residual", "swiglu_gate") else 0
    return elem * (M * K + K * N + M * N) + extra, 2.0 * M * N * K


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
    kernels-line numbers keyed by row: matmul@{decode, prefill,
    ssm_decode, ssm_prefill, hybrid_decode, hybrid_prefill},
    matmul_f32@hybrid_{decode, prefill}, flash_attention@{prefill,
    hybrid}, flash_attention_f32@hybrid and expert_matmul@prefill."""
    import torch.nn.functional as F
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import GemmProblem, gemm_latency
    from repro_torch.core.selector import select_gemm_config

    eps = _epilogues()
    times = {}
    per_shape = []
    bf16, f32 = torch.bfloat16, torch.float32
    # phi4-mini's layer; mamba2-370m's and zamba2-7b's mamba layer at the
    # served prefill M, zamba2-7b's again in f32.
    for key, M, gemms, bf in (
            ("matmul@decode", 4, PATH_GEMMS, bf16),
            # a prefill also recomputes wk/wv for the cache
            # (transformer.py:111)
            ("matmul@prefill", 512, PATH_GEMMS + [
                g for g in PATH_GEMMS if g[0] in ("wk", "wv")], bf16),
            ("matmul@ssm_decode", 4, SSM_GEMMS, bf16),
            ("matmul@ssm_prefill", RAGGED_PREFILL_M, SSM_GEMMS, bf16),
            ("matmul@hybrid_decode", 4, MAMBA_GEMMS, bf16),
            ("matmul@hybrid_prefill", RAGGED_PREFILL_M, MAMBA_GEMMS, bf16),
            ("matmul_f32@hybrid_decode", 4, MAMBA_GEMMS, f32),
            ("matmul_f32@hybrid_prefill", RAGGED_PREFILL_M, MAMBA_GEMMS,
             f32)):
        dtype = str(bf)[6:]
        elem = 2 if bf == bf16 else 4
        peak = BF16_PEAK if bf == bf16 else TF32X3_PEAK
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "model_ms": 0.0, "bytes": 0, "flops": 0.0}
        for name, N, K, epn in gemms:
            ep = eps[epn]
            a, b, kw = _gemm_inputs(torch, dev, M, N, K, ep, bf, seed=7)
            a = a * 0.1
            b = b * 0.02
            sel = select_gemm_config(M, N, K, in_dtype=dtype,
                                     out_dtype=dtype, epilogue=ep,
                                     hw=GPU_H100_LIKE)
            cfg = sel.config
            plan = _plan(kmm, dev, M, N, K, cfg, 1)

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
            row = {"row": key, "gemm": name, "dtype": dtype, "M": M,
                   "N": N, "K": K,
                   "epilogue": epn, "config": str(cfg), "ctas": plan.ctas,
                   "split_tiles": plan.split_tiles,
                   "model_ms": sel.predicted.total * 1e3,
                   "ms": time_ms(kern), "plain_ms": time_ms(plain),
                   "library_ms": time_ms(library),
                   "host_us": host_us(torch, kern)}
            kmm.tiled_matmul.launches = n0     # timing launches do not count
            nbytes, flops = _gemm_bytes_flops(M, N, K, epn, elem)
            row["bound_ms"] = max(nbytes / HBM_BW, flops / peak) * 1e3
            row["bound_by"] = ("bytes" if nbytes / HBM_BW
                               >= flops / peak else "operations")
            per_shape.append(row)
            for k_ in ("ms", "plain_ms", "library_ms", "model_ms"):
                tot[k_] += row[k_]
            tot["bytes"] += nbytes
            tot["flops"] += flops
        t_b, t_f = tot["bytes"] / HBM_BW, tot["flops"] / peak
        times[key] = {
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "library_ms": tot["library_ms"], "model_ms": tot["model_ms"],
            "bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "what": f"sum over one layer's {len(gemms)} {dtype} GEMMs at "
                    f"M={M}"}

    # Prefill attention at each model's largest served prompt, v as the
    # model passes it; every legal pair of the block menu beside the
    # selected one (bf16); zamba2-7b's shape again in f32 (the split-TF32
    # kernel, its bound at a third of the TF32 peak).
    attn_rows = {}
    for key, arch, H, Hkv, S, d, dtype in (
            ("flash_attention@prefill", "phi4-mini-3.8b", 24, 8, max(edges),
             128, "bfloat16"),
            ("flash_attention@moe", "qwen3-moe-30b-a3b", 32, 4, moe_edge,
             128, "bfloat16"),
            ("flash_attention@hybrid", "zamba2-7b", 32, 32,
             RAGGED_PREFILL_M, 112, "bfloat16"),
            ("flash_attention_f32@hybrid", "zamba2-7b", 32, 32,
             RAGGED_PREFILL_M, 112, "float32")):
        B = 1
        q, k, v = _attn_inputs(torch, dev, B, H, Hkv, S, True, seed=11, d=d,
                               dtype=dtype)
        plan = kfa.plan_attention(S, S, d, batch=B, heads=H, kv_heads=Hkv,
                                  in_dtype=dtype, causal=True)
        n0 = kfa.flash_attention_kernel.launches

        def kern(bq, bkv):
            return time_ms(lambda: kfa._launch_cuda(
                q, k, v, block_q=bq, block_kv=bkv, causal=True, scale=None))
        menu = []
        for bq in kfa.BLOCK_MENU:
            for bkv in kfa.BLOCK_MENU:
                if dtype != "bfloat16" or not kfa.legal_blocks(bq, bkv, d):
                    continue
                priced = kfa.price_attention_blocks(
                    S, S, d, bq, bkv, batch=B, heads=H, kv_heads=Hkv,
                    causal=True)
                menu.append({"blocks": [bq, bkv], "ctas": priced.ctas,
                             "ctas_per_sm": priced.ctas_per_sm,
                             "model_ms": priced.predicted * 1e3,
                             "ms": kern(bq, bkv)})
        if dtype == "float32":       # the split-TF32 kernel's own tiles
            fp = kfa.plan_attention_f32(S, d, batch=B, heads=H)
            grid = {"blocks": [fp.q_block, fp.kv_block], "ctas": fp.ctas,
                    "ctas_per_sm": None, "model_ms": None}
        else:
            grid = {"blocks": [plan.block_q, plan.block_kv],
                    "ctas": plan.ctas, "ctas_per_sm": plan.ctas_per_sm,
                    "model_ms": plan.predicted * 1e3}
        row = {"phase": "prefill", "kernel": key.split("@")[0],
               "arch": arch, "dtype": dtype,
               "q": [B, H, S, d], "kv": [B, Hkv, S, d],
               "v_strides": list(v.stride()), **grid,
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
        nbytes = q.element_size() * d * S * B * (2 * H + 2 * Hkv)
        peak = BF16_PEAK if dtype == "bfloat16" else TF32X3_PEAK
        row["bound_ms"] = max(nbytes / HBM_BW, flops / peak) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BW >= flops / peak \
            else "operations"
        per_shape.append(row)
        attn_rows[key] = row
    for key, row in attn_rows.items():
        times[key] = {k_: row[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")}

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


# ---------------------------------------------------------------------------
# The calibration slice: the probe kernels, the fit, the oracle, the
# residual corrector and serving against the calibrated topology.
# ---------------------------------------------------------------------------

# Published dense peaks of the H100 SXM by operand type (the bound of the
# probe kernels' operations): tensor cores in bf16/f16, TF32 (the "float32"
# of the topology), fp8 and int8; f32 adds outside the tensor cores.
PEAKS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12,
         "float8_e4m3fn": 1979e12, "int8": 1979e12}
F32_SIMT_PEAK = 67e12
ATOM_FLOPS = 2.0 * 64 * 64 * 16      # gpu_h100_like's mxu_shape


def _probe_shapes():
    """The first point of every calibration sweep at gpu_h100_like, sized
    as ``calib/probes.py`` sizes it: (name, nbytes, window, n_chunks) for
    the stream read, (dtype, n_atoms, n_parallel) for the wgmma chains,
    the wave unit's atoms."""
    from repro_torch.calib import probes as cpr
    from repro_torch.core.hardware import GPU_H100_LIKE as base
    streams = []
    for idx, name, window in cpr.level_windows(base):
        bw = base.levels[idx].bandwidth
        streams.append((f"stream:{name}",
                        float(max(2 * window,
                                  int(cpr.STREAM_TARGETS_S[0] * bw))),
                        window, 64))
    issue_window = max(base.staging.budget() // 2, 1)
    streams.append(("issue", float(2 * issue_window), issue_window,
                    max(1, int(cpr.ISSUE_TARGETS_S[0] / base.dma_fixed))))
    nb = float(int(cpr.LATENCY_TARGETS_S[0] * base.backing.bandwidth))
    streams.append(("latency", nb, int(nb), 1))
    lanes = base.total_cores()
    chains = [(dt, max(16 * lanes, int(cpr.COMPUTE_TARGETS_S[0]
                                       * base.flops(dt) / ATOM_FLOPS)),
               lanes) for dt in sorted(base.peak_flops)]
    return streams, chains, cpr._wave_unit_atoms(base), lanes


def probe_phase(torch, dev, kpr):
    """The probe kernels against their plain versions at the sweeps'
    shapes (checksums equal, two launches bitwise equal); then each timed
    at one shape for the kernels line.  Returns those times."""
    streams, chains, unit_atoms, lanes = _probe_shapes()
    rows = []

    def check(kind, shape, got, again, want):
        ok = bool(torch.equal(got, want)) and bool(torch.equal(got, again))
        rows.append({"kernel": kind, "shape": shape,
                     "checksum": got.tolist(), "plain": want.tolist(),
                     "ok": ok} if got.dim() == 0 else
                    {"kernel": kind, "shape": shape,
                     "checksum_sum": int(got.sum()),
                     "plain_sum": int(want.sum()), "ok": ok})
        if not ok:
            emit({"phase": "probe", "cases": rows})
            fail(f"{kind} {shape}: the kernel's checksum differs from its "
                 f"plain version's or between two launches")

    xs = {}
    for name, nbytes, window, n_chunks in streams:
        x = xs[name] = kpr.stream_data(window, dev)
        got = kpr.stream_read(x, nbytes, window, n_chunks)
        again = kpr.stream_read(x, nbytes, window, n_chunks)
        want = kpr.stream_read_plain(x, nbytes, window, n_chunks)
        torch.cuda.synchronize()
        check("stream_read", [name, nbytes, window, n_chunks], got, again,
              want)
    ops = {}
    for dt, n_atoms, n_par in chains:
        a, b = ops[dt] = kpr.mma_operands(
            dt, dev, torch.Generator(device=dev).manual_seed(21))
        got = kpr.mma_chain(a, b, n_atoms, n_par)
        again = kpr.mma_chain(a, b, n_atoms, n_par)
        want = kpr.mma_chain_plain(a, b, n_atoms, n_par)
        torch.cuda.synchronize()
        check("mma_chain", [dt, n_atoms, n_par], got, again, want)
    a, b = ops["bfloat16"]
    for units in (lanes, lanes + 1, 2 * lanes):
        got = kpr.wave_grid(a, b, units, unit_atoms)
        again = kpr.wave_grid(a, b, units, unit_atoms)
        want = kpr.wave_grid_plain(a, b, units, unit_atoms)
        torch.cuda.synchronize()
        check("wave_grid", ["bfloat16", units, unit_atoms], got, again, want)

    # Times at one shape each: the HBM stream sweep's first point, the
    # bf16 compute sweep's first point, one wave.
    name, nbytes, window, n_chunks = streams[[s[0] for s in streams].index(
        "stream:hbm")]
    x = xs[name]
    dt, n_atoms, n_par = chains[[c[0] for c in chains].index("bfloat16")]
    counts = {f.__name__: f.launches for f in (kpr.stream_read,
                                                kpr.mma_chain, kpr.wave_grid)}
    # As the calibration times them: the sums into a buffer made once, so
    # a call is the probe's one launch.
    slots = torch.empty(4096, dtype=torch.int64, device=dev)
    cases = {
        "stream_read@calib": (
            lambda: kpr.stream_read(x, nbytes, window, n_chunks, out=slots),
            lambda: kpr.stream_read_plain(x, nbytes, window, n_chunks),
            # every f32 read is one add: bound by adds at the f32 rate (the
            # window itself, read once, is a few µs of HBM at most)
            (window + 8) / HBM_BW, nbytes / 4 / F32_SIMT_PEAK,
            {"what": f"{name}: {nbytes:g} B through a {window} B window in "
                     f"{n_chunks} fetches",
             "level_bound_ms": nbytes / 3.35e12 * 1e3}),
        "mma_chain@calib": (
            lambda: kpr.mma_chain(a, b, n_atoms, n_par, out=slots),
            lambda: kpr.mma_chain_plain(a, b, n_atoms, n_par),
            2 * 64 * 128 / HBM_BW, n_atoms * ATOM_FLOPS / PEAKS[dt],
            {"what": f"{dt}: {n_atoms} atoms of 64x64x16 over {n_par} CTAs "
                     f"of {kpr.CHAINS_PER_CTA} chains"}),
        "wave_grid@calib": (
            lambda: kpr.wave_grid(a, b, lanes, unit_atoms, out=slots),
            lambda: kpr.wave_grid_plain(a, b, lanes, unit_atoms),
            2 * 64 * 128 / HBM_BW,
            lanes * unit_atoms * ATOM_FLOPS / PEAKS["bfloat16"],
            {"what": f"bfloat16: one wave of {lanes} units of {unit_atoms} "
                     f"atoms"}),
    }
    times = {}
    for key, (kern, plain, t_bytes, t_ops, extra) in cases.items():
        times[key] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, calls=2,
                                                              reps=3),
                      "library_ms": None,
                      "bound_ms": max(t_bytes, t_ops) * 1e3,
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", **extra}
    for f in (kpr.stream_read, kpr.mma_chain, kpr.wave_grid):
        f.launches = counts[f.__name__]          # timing launches
    emit({"phase": "probe", "equal": "checksums equal to the plain "
          "versions' (integer data, exact) and two launches bitwise equal",
          "cases": rows, "times": times})
    return times


def _preset_value(base, key):
    if key.startswith("levels."):
        return next(l.bandwidth for l in base.levels
                    if l.name == key.split(".")[1])
    if key.startswith("peak_flops."):
        return base.peak_flops[key.split(".", 1)[1]]
    if key == "hbm_latency":
        return base.backing.latency
    return getattr(base, key)


def calib_phase(torch, dev, kpr):
    """fit_topology on the card, fail-fast; returns (result, reloaded
    topology, artifact path) and the probe kernels' launches in the fit."""
    from repro_torch.calib import TorchDevice, fit_topology
    from repro_torch.calib.device import latency_windows
    from repro_torch.calib.fit import theil_sen
    from repro_torch.core.hardware import GPU_H100_LIKE as base
    from repro_torch.core.topology import (load_calibrated_topology_guarded,
                                           topology_fingerprint)
    counters = {"stream_read": kpr.stream_read, "mma_chain": kpr.mma_chain,
                "wave_grid": kpr.wave_grid}
    device = TorchDevice()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = fit_topology(base, device, allow_degraded=False)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    out_dir = ROOT / "experiments" / "calib"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "gpu_h100_like.h100.topo.json"
    res.save(str(path))
    topo, prov = load_calibrated_topology_guarded(str(path), base)
    fields = {k: {"preset": _preset_value(base, k), "fitted": v,
                  "fitted_over_preset": v / _preset_value(base, k),
                  "residual": res.residuals[k]}
              for k, v in sorted(res.fitted.items())}
    wave = res.probes["wave"].params
    # hbm_latency = latency intercept - wave intercept - dma_fixed
    # (calib/fit.py): both intercepts beside it say which side moved.
    lat_sw, wave_sw = res.probes["latency"], res.probes["wave"]
    emit({"phase": "calib_constants", "device": device.name,
          **{k: res.fitted.get(k) for k in ("hbm_latency", "kernel_launch",
                                            "dma_fixed")},
          "latency_intercept": theil_sen(lat_sw.xs(), lat_sw.ys())[1],
          "wave_intercept": theil_sen(wave_sw.xs(), wave_sw.ys())[1],
          "latency_windows": [latency_windows(int(x), device.l2_bytes)
                              for x in lat_sw.xs()]})
    emit({"phase": "calib", "device": device.name, "seconds": seconds,
          "fields": fields, "static_share": res.static_share,
          "wave_cliff": {"units": [wave["cliff_units"],
                                   wave["cliff_units"] + 1],
                         "seconds": [wave["cliff_before_s"],
                                     wave["cliff_after_s"]]},
          "n_dropped": {k: sw.params["n_dropped"]
                        for k, sw in res.probes.items()},
          "samples": {k: sw.to_dict()["samples"]
                      for k, sw in res.probes.items()},
          "launches": launches, "artifact": str(path.relative_to(ROOT)),
          "fingerprint": topology_fingerprint(res.topology),
          "reloaded_fingerprint": topology_fingerprint(topo),
          "reload_degraded": prov.get("degraded") or None})
    if prov.get("degraded") or topology_fingerprint(topo) != \
            topology_fingerprint(res.topology):
        fail(f"the calibrated artifact did not reload clean "
             f"({prov.get('degraded')})")
    if min(launches.values()) <= 0:
        fail(f"a probe kernel did not launch in the fit ({launches})")
    bad = {k: v for k, v in res.fitted.items()
           if not math.isfinite(v) or v <= 0}
    if bad or res.degraded:
        fail(f"fitted fields out of range {bad} or degraded {res.degraded}")
    return (res, topo, path), launches


FIDELITY_SHAPES = [(f"phi4/M{M}/{N}x{K}", M, N, K) for M in (4, 512)
                   for N, K in ((3072, 3072), (8192, 3072), (3072, 8192))]


def fidelity_phase(calib):
    """The pruned exhaustive oracle on the served shapes: the preset's and
    the calibrated selection against the measured argmin.  Every candidate
    is held to the plain product before it is timed (``CheckedDevice``)."""
    from repro_torch.calib import (CandidateMismatch, CheckedDevice,
                                   TorchDevice)
    _, topo, _ = calib
    memo = CheckedDevice(TorchDevice())
    memo.oracle = {}
    t_all = time.perf_counter()
    try:
        rows = _fidelity_rows(memo, topo)
    except CandidateMismatch as e:
        p = e.problem
        emit({"phase": "fidelity", "failed_candidate": str(e.config),
              "shape": [p.M, p.N, p.K], "max_abs_err": e.max_abs_err})
        fail(f"fidelity: {e}")
    emit({"phase": "fidelity", "device": memo.name, "prune": True,
          "timing": "TorchDevice: a CUDA graph of 5 calls after 3 warm-up "
          "calls, median of 5 replays, per call (calib/device.py)",
          "checked_candidates": memo.checked,
          "worst_abs_err": memo.worst_err,
          "tolerance": "tests/test_kernels.py:26-27 (bf16 in: rtol 3e-2, "
          "atol 0.3*sqrt(K)) against one plain product a shape",
          "rows": rows, "seconds": time.perf_counter() - t_all})
    if memo.errors:
        fail(f"candidates failed to launch: {memo.errors[:5]}")
    return memo


def _fidelity_rows(memo, topo):
    """fidelity_phase's rows, one a shape of FIDELITY_SHAPES."""
    import numpy as np
    from repro_torch.calib import fidelity_row, oracle_best
    from repro_torch.core.hardware import GPU_H100_LIKE as base
    from repro_torch.core.latency import GemmProblem, score_candidates
    from repro_torch.core.selector import candidate_tiles, select_gemm_config
    rows = []
    for name, M, N, K in FIDELITY_SHAPES:
        t0 = time.perf_counter()
        row = fidelity_row(base, name, M, N, K, memo, prune=True)
        p = GemmProblem(M=M, N=N, K=K)
        cands = candidate_tiles(p, base)
        order = list(np.argsort(score_candidates(p, cands, base),
                                kind="stable"))
        _, _, pruned = oracle_best(p, base, memo, cands, prune=True,
                                   order=order)
        csel = select_gemm_config(M, N, K, hw=topo).config
        cs = memo.gemm_time(p, csel)
        ccands = candidate_tiles(p, topo)
        cscores = score_candidates(p, ccands, topo)
        oracle_t = next(t for t in cands if str(t) == row.oracle)
        crank = 1 + int(np.sum(cscores < cscores[ccands.index(oracle_t)]))
        memo.oracle[(M, N, K)] = row.oracle_s
        rows.append({
            "shape": name, "M": M, "N": N, "K": K,
            "candidates": row.n_candidates,
            "measured": row.n_candidates - pruned, "pruned": pruned,
            "preset_selection": row.selected,
            "preset_ms": row.selected_s * 1e3,
            "oracle": row.oracle, "oracle_ms": row.oracle_s * 1e3,
            "fidelity": row.fidelity,
            "oracle_model_rank": row.oracle_model_rank,
            "calibrated_selection": str(csel),
            "calibrated_ms": cs * 1e3,
            "calibrated_fidelity": row.oracle_s / cs,
            "calibrated_oracle_rank": crank,
            "seconds": time.perf_counter() - t0})
    return rows


def residual_phase(memo, calib):
    """A corrector fitted from silicon rows (the top 12 of every served
    shape), and its picks against the oracle on those same shapes."""
    from repro_torch.calib import (fit_residual, residual_pick,
                                   rows_from_sweep)
    from repro_torch.calib.residual import MIN_FIT_ROWS
    from repro_torch.core.hardware import GPU_H100_LIKE as base
    from repro_torch.core.latency import GemmProblem
    shapes = [(M, N, K) for _, M, N, K in FIDELITY_SHAPES]
    t0 = time.perf_counter()
    rows = rows_from_sweep(base, memo, shapes, k=12)
    if len(rows) < MIN_FIT_ROWS:
        fail(f"{len(rows)} residual rows < {MIN_FIT_ROWS}")
    corr = fit_residual(rows, base, sources=["chip_smoke: top-12 of the "
                                              "served GEMM shapes"])
    path = ROOT / "experiments" / "calib" / "gpu_h100_like.h100.residual.json"
    corr.save(str(path))
    picks = []
    for M, N, K in shapes:
        p = GemmProblem(M=M, N=N, K=K)
        pick, _ = residual_pick(corr, p, base)
        s = memo.gemm_time(p, pick)
        picks.append({"shape": [M, N, K], "pick": str(pick),
                      "pick_ms": s * 1e3,
                      "oracle_ms": memo.oracle[(M, N, K)] * 1e3,
                      "fidelity": memo.oracle[(M, N, K)] / s})
    emit({"phase": "residual", "rows": len(rows),
          "fingerprint": corr.fingerprint,
          "model_digest": corr.content_fingerprint(),
          "train_rmse_log": corr.provenance["train_rmse_log"],
          "train_mean_abs_log_ratio":
              corr.provenance["train_mean_abs_log_ratio"],
          "artifact": str(path.relative_to(ROOT)),
          "scored_on": "the shapes the corrector was fitted on",
          "picks": picks, "seconds": time.perf_counter() - t0})
    if memo.errors:
        fail(f"candidates failed to launch: {memo.errors[:5]}")


def serve_calibrated_phase(torch, dev, kmm, kfa, calib):
    """Phase 4's traffic served against the calibrated artifact, traced:
    drift rows from the warm selections and the decode windows."""
    import statistics
    from repro_torch.calib import rows_from_drift
    from repro_torch.configs.registry import get_config
    from repro_torch.core.bucketing import step_gemms
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.selector import select_gemm_config
    from repro_torch.core.topology import topology_fingerprint
    from repro_torch.kernels import ops
    res, topo, path = calib
    trace_dir = ROOT / "experiments" / "calib" / "serve_trace"
    # The drift log appends: an earlier run's rows carry another fit's
    # fingerprint and would not read back.
    shutil.rmtree(trace_dir, ignore_errors=True)
    try:
        args, model, params, out, launches = _serve(
            torch, dev, kmm, kfa, "phi4-mini-3.8b",
            extra=["--topology", str(path), "--trace-dir", str(trace_dir)],
            phase="serve_calibrated_run")
    finally:
        ops.set_default_hardware(None)
    del model, params
    _free(torch)
    drift = [json.loads(line) for line in
             (trace_dir / "drift.jsonl").read_text().splitlines()]
    warm = [r for r in drift if r["site"] == "warm_gemm"]
    decode = [r for r in drift if r["site"] == "decode_step"]
    drows, dstats = rows_from_drift(str(trace_dir / "drift.jsonl"),
                                    fingerprint=topology_fingerprint(topo))
    cfg = get_config("phi4-mini-3.8b")
    gemms = step_gemms(cfg.d_model, cfg.d_ff,
                       kv_dim=cfg.num_kv_heads * cfg.head_dim,
                       vocab=cfg.vocab_size,
                       swiglu=cfg.activation == "swiglu")
    shapes = [(m, n, k) for m in sorted({*out["edges"], args.batch})
              for n, k in gemms]
    differ = [[m, n, k] for m, n, k in shapes
              if select_gemm_config(m, n, k, hw=topo).config
              != select_gemm_config(m, n, k, hw=GPU_H100_LIKE).config]
    emit({"phase": "serve_calibrated", "topology": out["topology"],
          "degraded": out["degraded"],
          "warm_gemm_rows": len(warm), "decode_rows": len(decode),
          "warm_median_fidelity": statistics.median(
              r["fidelity"] for r in warm) if warm else None,
          "decode_median_fidelity": statistics.median(
              r["fidelity"] for r in decode) if decode else None,
          "rows_from_drift": len(drows), "rows_from_drift_stats": dstats,
          "step_gemms": len(shapes), "selections_differ": len(differ),
          "differing_shapes": differ,
          "trace_files": sorted(p.name for p in trace_dir.iterdir()),
          "launches": launches})
    if out["degraded"]:
        fail(f"the calibrated artifact was rejected: {out['degraded']}")
    if not warm or not decode or len(drows) != len(warm):
        fail(f"drift rows: {len(warm)} warm, {len(decode)} decode, "
             f"{len(drows)} read back")



# ---------------------------------------------------------------------------
# Phase 9: the SSM and hybrid families at full width and depth.
# ---------------------------------------------------------------------------

def _mamba_launches(cfg):
    """(GEMMs a prefill, GEMMs a decode step, flash launches a prefill) of
    an SSM or hybrid model, reckoned from the code: six GEMMs per mamba
    layer (in_z, in_x, in_b, in_c, in_dt, out_proj) in a prefill and in a
    decode step; per application of the hybrid's shared block nine in a
    prefill (wk, wv for the cache; wq, wk, wv, wo; wu, wg, wd), seven in a
    decode step, and one flash launch in a prefill.  The lm_head is a
    plain product."""
    shared = (cfg.num_layers // cfg.shared_attn_every
              if cfg.family == "hybrid" else 0)
    return 6 * cfg.num_layers + 9 * shared, 6 * cfg.num_layers + 7 * shared, \
        shared


def _check_mamba_launches(cfg, out, launches, phase):
    n, steps = len(out["results"]), out["steps"]
    per_prefill, per_step, flash = _mamba_launches(cfg)
    expected = {"matmul@prefill": per_prefill * n,
                "matmul@decode": per_step * steps,
                "flash_attention@prefill": flash * n,
                "flash_attention@decode": 0}
    row = {"phase": phase, "arch": cfg.name, "prefills": n, "steps": steps,
           "matmul_per_prefill": per_prefill, "matmul_per_step": per_step,
           "expected": expected,
           "launched": {k: launches[k] for k in expected}}
    emit(row)
    if row["launched"] != expected:
        fail(f"{cfg.name}: kernel launches {launches} differ from the "
             f"reckoning {row}")


def serve_ssm_phase(torch, dev, kmm, kfa, tp_refs):
    """mamba2-370m on phase 4's traffic (no bucket plan: prompts prefill at
    their exact lengths), its logits against the plain path, a trace; the
    run is one that serve_tp holds its ranks to."""
    args, model, params, out, launches = _serve(
        torch, dev, kmm, kfa, "mamba2-370m", phase="serve_ssm")
    if out["edges"]:
        fail(f"an SSM model was served on bucket edges {out['edges']}")
    _check_mamba_launches(model.cfg, out, launches, "serve_ssm_launches")
    _logits_check(torch, dev, kmm, kfa, args, model, params, out,
                  "serve_ssm_logits")
    tp_refs.append(_tp_ref(torch, dev, kmm, kfa, args, model, params, out))
    trace_phase(torch, dev, model, params, phase="ssm_trace")
    del model, params
    _free(torch)
    return launches


def serve_hybrid_phase(torch, dev, kmm, kfa, tp_refs):
    """zamba2-7b at full width and depth on phase 4's traffic: 13 flash
    launches a prefill at head dim 112, the launch reckoning, its logits
    against the plain path and a trace (the run serve_tp holds its ranks
    to); then the same model in f32 (4 requests of 4 tokens) through the
    f32 flash kernel and the f32 GEMM, its logits against the plain path
    in f32."""
    args, model, params, out, launches = _serve(
        torch, dev, kmm, kfa, "zamba2-7b", phase="serve_hybrid")
    if out["edges"]:
        fail(f"a hybrid model was served on bucket edges {out['edges']}")
    _check_mamba_launches(model.cfg, out, launches, "serve_hybrid_launches")
    tp_refs.append(_tp_ref(torch, dev, kmm, kfa, args, model, params, out))
    trace_phase(torch, dev, model, params, phase="hybrid_trace")
    params32 = _tree_map(params, lambda t: t.float())
    _logits_check(torch, dev, kmm, kfa, args, model, params, out,
                  "serve_hybrid_logits", params32=params32)
    del model, params
    _free(torch)
    args32, model, _, out32, launches32 = _serve(
        torch, dev, kmm, kfa, "zamba2-7b",
        extra=["--requests", "4", "--gen", "4"], phase="serve_hybrid_f32",
        params=params32)
    _check_mamba_launches(model.cfg, out32, launches32,
                          "serve_hybrid_f32_launches")
    _logits_check(torch, dev, kmm, kfa, args32, model, params32, out32,
                  "serve_hybrid_f32_logits", f32=True)
    del model, params32
    _free(torch)
    return launches, launches32


# ---------------------------------------------------------------------------
# Phase 10: training phi4-mini-3.8b.
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 512          # the train batch: B x S tokens
TRAIN_T = TRAIN_B * TRAIN_S        # the backward GEMMs' token count
TRAIN_STEPS = 6
GRADS_LAYERS, GRADS_B = 2, 2       # train_grads: phi4 width at 2 layers
# The flash backward in bf16 against the plain f32 backward (relative L2
# of each of dq, dk, dv): at most this factor times the plain bf16
# backward's own distance from it.
BWD_REL_FACTOR = 2.0
BWD_F32_REL_CAP = 1e-4             # f32 kernel vs plain f32 backward
GRADS_REL_FACTOR = 2.0             # train_grads bf16: kernel vs plain route
GRADS_F32_REL_CAP = 1e-4           # train_grads f32: each leaf
TRAIN_FLASH_DIMS = (16, 64, 112, 160, 256)
# The other families' train phases: 3 steps each; qwen3-moe-30b-a3b at
# 4 of its 48 layers (30.5 B params x 12 bytes of bf16 param
# and grad and f32 moments is about 366 GB at full depth), zamba2-7b at 12
# of its 81 (two applications of the shared block; 81 GB of state at full
# depth); mamba2-370m whole.
FAMILY_TRAIN_STEPS = 3
MOE_TRAIN_LAYERS = 4
# musicgen-large (48 pre-layernorm layers) overshoots on AdamW's first,
# sign-like step at lr 1e-3 and 1e-4 with no warmup (8.006 -> 19.52 ->
# 8.79 at 1e-4 on the H100), the plain route step for step with the kernel
# route (tools/train_route_ab.py); at 1e-5 its loss falls.
AUDIO_TRAIN_LR = 1e-5
HYBRID_TRAIN_LAYERS = 12
# The MoE train phase's expert GEMMs: E 128 experts, capacity C = 160 at
# T = 2048 tokens (2048 x 8 x 1.25 / 128), d_model 2048, expert d_ff 768.
MOE_E, MOE_C, MOE_D, MOE_F = 128, 160, 2048, 768


def _counters(kmm, kfa):
    """The launch counters of every kernel on the training path: the dense
    GEMM's and the grouped GEMM's ("expert_") by layout, the dense and the
    grouped epilogue backward, the flash forward and backward."""
    dense, grouped = (kmm.tiled_matmul.layout_launches,
                      kmm.tiled_expert_matmul.layout_launches)
    epi = kmm.epilogue_bwd
    return {"nn": lambda: dense["nn"], "tn": lambda: dense["tn"],
            "nt": lambda: dense["nt"],
            "expert_nn": lambda: grouped["nn"],
            "expert_tn": lambda: grouped["tn"],
            "expert_nt": lambda: grouped["nt"],
            "flash": lambda: kfa.flash_attention_kernel.launches,
            "flash_bwd": lambda: kfa.flash_attention_bwd_kernel.launches,
            "epilogue_bwd": lambda: epi.launches - epi.grouped_launches,
            "epilogue_bwd_grouped": lambda: epi.grouped_launches}


def _zero_counts(kmm, kfa) -> None:
    kmm.tiled_matmul.launches = 0
    kmm.tiled_matmul.layout_launches.update(nn=0, tn=0, nt=0)
    kmm.tiled_expert_matmul.launches = 0
    kmm.tiled_expert_matmul.layout_launches.update(nn=0, tn=0, nt=0)
    kmm.epilogue_bwd.launches = 0
    kmm.epilogue_bwd.grouped_launches = 0
    kfa.flash_attention_kernel.launches = 0
    kfa.flash_attention_bwd_kernel.launches = 0


def _read_counts(kmm, kfa):
    return {k: f() for k, f in _counters(kmm, kfa).items()}


def _check_case(rows, phase, row, ok):
    rows.append({**row, "ok": ok})
    if not ok:
        emit({"phase": phase, "cases": rows})
        fail(f"{phase}: {row} disagrees with its plain version or does not "
             f"repeat bitwise")


def train_kernels_phase(torch, dev, kmm, kfa):
    """The training kernels against their plain versions at phi4-mini's
    training shapes (T = 2048 tokens), each launched twice and bitwise
    equal: the GEMM with B read transposed (dX = dY W^T) and with A read
    transposed (dW = X^T dY) for each of wq, wk, wv, wo, wu, wg, wd in
    bf16, one small case of each layout in f32; the flash forward with its
    lse and the flash backward at (4, 24/8, 512, 128) causal bf16, at d in
    TRAIN_FLASH_DIMS, and in f32 at d 128 and 112; the epilogue backward
    of each activation in bf16 and f32; the grouped GEMM's backward and
    the grouped epilogue backward at qwen3-moe's training shapes (Kernel
    4).  Returns the worst absolute error of each kernels-line row."""
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import Epilogue
    from repro_torch.core.selector import select_gemm_config
    from repro_torch.kernels.ref import gemm_tolerance

    bf, f32 = torch.bfloat16, torch.float32
    worst = dict.fromkeys(("matmul@train_dgrad", "matmul@train_wgrad",
                           "flash_attention@train",
                           "flash_attention_bwd@train",
                           "flash_attention_f32@train_grads",
                           "flash_attention_bwd_f32@train_grads",
                           "epilogue_bwd@train",
                           "expert_matmul_bwd@train_moe_dgrad",
                           "expert_matmul_bwd@train_moe_wgrad",
                           "epilogue_bwd_grouped@train_moe"), 0.0)
    rows = []
    g = torch.Generator(device=dev).manual_seed(17)

    def rnd(*shape, dt=bf):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    # Kernel 1: (row, layout, M, N, K, dtype) of the GEMM's products.
    cases = []
    for name, N, K, _ in PATH_GEMMS:
        cases += [("matmul@train_dgrad", "nt", TRAIN_T, K, N, bf, name),
                  ("matmul@train_wgrad", "tn", K, N, TRAIN_T, bf, name)]
    cases += [("matmul@train_dgrad", "nt", 256, 320, 512, f32, "f32"),
              ("matmul@train_wgrad", "tn", 320, 256, 512, f32, "f32")]
    for key, layout, M, N, K, dt, name in cases:
        cfg = select_gemm_config(M, N, K, in_dtype=str(dt)[6:],
                                 out_dtype=str(dt)[6:],
                                 hw=GPU_H100_LIKE).config
        a = rnd(K, M, dt=dt) if layout == "tn" else rnd(M, K, dt=dt)
        b = rnd(N, K, dt=dt) if layout == "nt" else rnd(K, N, dt=dt)
        kw = dict(out_dtype=dt, trans_a=layout == "tn",
                  trans_b=layout == "nt")
        got = kmm.tiled_matmul(a, b, cfg, **kw)
        again = kmm.tiled_matmul(a, b, cfg, **kw)
        want = kmm.matmul_plain(a, b, cfg, **kw)
        torch.cuda.synchronize()
        rtol, atol = gemm_tolerance(dt, K)
        err = (got.float() - want.float()).abs()
        ok = bool((err <= atol + rtol * want.float().abs()).all()) \
            and bool(torch.isfinite(got).all()) \
            and _deterministic(torch, dev, kmm, got, again)
        worst[key] = max(worst[key], float(err.max()))
        _check_case(rows, "train_kernels", {
            "kernel": key, "gemm": name, "layout": layout,
            "shape": [M, N, K], "dtype": str(dt)[6:], "config": str(cfg),
            "max_abs_err": float(err.max()),
            "rel_l2": _rel(torch, got.float(), want.float())}, ok)

    # Kernel 2: the flash forward's lse and the backward.
    def rel(x, y):
        return _rel(torch, x.float(), y.float())
    flash_cases = [(TRAIN_B, 24, 8, TRAIN_S, 128, "bfloat16", True)]
    flash_cases += [(1, 8, 2, 300, d, "bfloat16", True)
                    for d in TRAIN_FLASH_DIMS]
    flash_cases += [(1, 8, 8, 300, 128, "bfloat16", False),
                    (1, 8, 2, 77, 128, "bfloat16", True),
                    (2, 24, 8, TRAIN_S, 128, "float32", True),
                    (1, 8, 2, 300, 112, "float32", True)]
    for B, H, Hkv, S, d, dtype, causal in flash_cases:
        dt = getattr(torch, dtype)
        q, k, v = _attn_inputs(torch, dev, B, H, Hkv, S, True, seed=d + S,
                               d=d, dtype=dtype)
        do = torch.randn(q.shape, generator=g, device=dev).to(dt)
        bq, bkv = kfa.select_attention_blocks(S, S, d, causal=causal,
                                              batch=B, heads=H, kv_heads=Hkv)
        o, lse = kfa.flash_attention_kernel(q, k, v, block_q=bq,
                                            block_kv=bkv, causal=causal,
                                            return_lse=True)
        o2, lse2 = kfa.flash_attention_kernel(q, k, v, block_q=bq,
                                              block_kv=bkv, causal=causal,
                                              return_lse=True)
        o_p, lse_p = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                                         causal=causal, return_lse=True)
        got = kfa.flash_attention_bwd_kernel(q, k, v, o_p, lse_p, do,
                                             causal=causal)
        again = kfa.flash_attention_bwd_kernel(q, k, v, o_p, lse_p, do,
                                               causal=causal)
        plain = kfa.attention_bwd_plain(q, k, v, o_p, lse_p, do,
                                        causal=causal)
        q32, k32, v32 = q.float(), k.float(), v.float()
        o32, lse32 = kfa.attention_plain(q32, k32, v32, block_q=bq,
                                         block_kv=bkv, causal=causal,
                                         return_lse=True)
        ref32 = kfa.attention_bwd_plain(q32, k32, v32, o32, lse32,
                                        do.float(), causal=causal)
        torch.cuda.synchronize()
        f32_case = dtype == "float32"
        fatol, frtol = ((FLASH_F32_ATOL, FLASH_F32_RTOL) if f32_case
                        else (FLASH_ATOL, FLASH_RTOL))
        o_err = (o.float() - o_p.float()).abs()
        ok = bool((o_err <= fatol + frtol * o_p.float().abs()).all()) \
            and bool(((lse - lse_p).abs() <= 1e-4 + 1e-5 * lse_p.abs()).all()) \
            and torch.equal(o, o2) and torch.equal(lse, lse2)
        dist = {}
        for name, x, y, p, r in zip(("dq", "dk", "dv"), got, again, plain,
                                    ref32):
            dist[name] = {"kernel_vs_plain_f32": rel(x, r),
                          "plain_vs_plain_f32": rel(p, r),
                          "kernel_vs_plain": rel(x, p)}
            ok = ok and torch.equal(x, y) and bool(torch.isfinite(x).all()) \
                and x.dtype == dt
            ok = ok and (dist[name]["kernel_vs_plain"] <= BWD_F32_REL_CAP
                         if f32_case else dist[name]["kernel_vs_plain_f32"]
                         <= BWD_REL_FACTOR
                         * dist[name]["plain_vs_plain_f32"])
            bkey = ("flash_attention_bwd_f32@train_grads" if f32_case
                    else "flash_attention_bwd@train")
            worst[bkey] = max(worst[bkey], float((x.float() - p.float())
                                                 .abs().max()))
        fkey = ("flash_attention_f32@train_grads" if f32_case
                else "flash_attention@train")
        worst[fkey] = max(worst[fkey], float(o_err.max()))
        plan = kfa.plan_attention_bwd(S, S, d, batch=B, heads=H,
                                      kv_heads=Hkv, in_dtype=dtype)
        ok = ok and plan.route == ("tf32x3" if f32_case else "wgmma")
        _check_case(rows, "train_kernels", {
            "kernel": "flash_attention_bwd", "q": [B, H, S, d],
            "kv": [B, Hkv, S, d], "dtype": dtype, "causal": causal,
            "plan": {k_: getattr(plan, k_) for k_ in (
                "route", "kv_block", "kv_ctas", "q_ctas")},
            "fwd_max_abs_err": float(o_err.max()),
            "lse_max_abs_err": float((lse - lse_p).abs().max()),
            "rel_l2": dist}, ok)

    # Kernel 3: the epilogue backward.
    M, N = TRAIN_T, 8192
    for ep in (Epilogue(activation="swiglu_gate"),
               Epilogue(activation="gelu"), Epilogue(activation="silu"),
               Epilogue(bias=True, activation="gelu"), Epilogue(bias=True)):
        for dt in (bf, f32):
            z = torch.randn((M, N), generator=g, device=dev) * 3
            gate = rnd(M, N, dt=dt) if ep.activation == "swiglu_gate" \
                else None
            kw = dict(epilogue=ep, gate=gate, dz_dtype=dt,
                      want_bias=ep.bias)
            zz = z if ep.activation else None
            dout = rnd(M, N, dt=dt)
            got = kmm.epilogue_bwd(dout, zz, **kw)
            again = kmm.epilogue_bwd(dout, zz, **kw)
            want = kmm.epilogue_bwd_plain(dout, zz, **kw)
            torch.cuda.synchronize()
            rtol, atol = (1e-5, 1e-5) if dt == f32 else (1e-2, 1e-2)
            ok, errs = True, {}
            for name, x, y, w in zip(("dz", "dgate", "dbias"), got, again,
                                     want):
                if (x is None) != (w is None):
                    ok = False
                if x is None or w is None:
                    continue
                tol = atol * (M if name == "dbias" else 1)
                err = (x.float() - w.float()).abs()
                errs[name] = float(err.max())
                ok = ok and torch.equal(x, y) and bool(
                    (err <= tol + rtol * w.float().abs()).all())
                if name != "dbias":
                    worst["epilogue_bwd@train"] = max(
                        worst["epilogue_bwd@train"], errs[name])
            _check_case(rows, "train_kernels", {
                "kernel": "epilogue_bwd", "epilogue": str(ep),
                "dtype": str(dt)[6:], "shape": [M, N],
                "max_abs_err": errs}, ok)

    # Kernel 4: the grouped GEMM's backward at qwen3-moe's training shapes
    # (E 128 experts of capacity C 160): dX_e = dZ_e W_e^T with w read
    # transposed ("nt") and dW_e = X_e^T dZ_e with x read transposed ("tn")
    # for wu and wg (D 2048 -> F 768) and wd (F -> D) in bf16, one f32 case
    # of each layout; the grouped epilogue backward of wg's swiglu in bf16
    # and f32, and of a per-expert bias.
    E, C = MOE_E, MOE_C
    gcases = []
    for name, K_in, N_out in (("wu/wg", MOE_D, MOE_F), ("wd", MOE_F, MOE_D)):
        gcases += [("expert_matmul_bwd@train_moe_dgrad", "nt", C, K_in,
                    N_out, bf, name),
                   ("expert_matmul_bwd@train_moe_wgrad", "tn", K_in, N_out,
                    C, bf, name)]
    gcases += [("expert_matmul_bwd@train_moe_dgrad", "nt", C, MOE_D, MOE_F,
                f32, "wu/wg f32"),
               ("expert_matmul_bwd@train_moe_wgrad", "tn", MOE_D, MOE_F, C,
                f32, "wu/wg f32")]
    for key, layout, M, N, K, dt, name in gcases:
        cfg = select_gemm_config(M, N, K, in_dtype=str(dt)[6:],
                                 out_dtype=str(dt)[6:],
                                 hw=GPU_H100_LIKE).config
        a = rnd(E, K, M, dt=dt) if layout == "tn" else rnd(E, M, K, dt=dt)
        b = rnd(E, N, K, dt=dt) if layout == "nt" else rnd(E, K, N, dt=dt)
        kw = dict(out_dtype=dt, trans_a=layout == "tn",
                  trans_b=layout == "nt")
        got = kmm.tiled_expert_matmul(a, b, cfg, **kw)
        again = kmm.tiled_expert_matmul(a, b, cfg, **kw)
        want = kmm.expert_matmul_plain(a, b, cfg, **kw)
        torch.cuda.synchronize()
        rtol, atol = gemm_tolerance(dt, K)
        err = (got.float() - want.float()).abs()
        ok = bool((err <= atol + rtol * want.float().abs()).all()) \
            and bool(torch.isfinite(got).all()) \
            and _deterministic(torch, dev, kmm, got, again)
        worst[key] = max(worst[key], float(err.max()))
        _check_case(rows, "train_kernels", {
            "kernel": key, "gemm": name, "layout": layout, "experts": E,
            "shape": [M, N, K], "dtype": str(dt)[6:], "config": str(cfg),
            "max_abs_err": float(err.max()),
            "rel_l2": _rel(torch, got.float(), want.float())}, ok)
        del a, b, got, again, want, err
    for ep, dt in ((Epilogue(activation="swiglu_gate"), bf),
                   (Epilogue(activation="swiglu_gate"), f32),
                   (Epilogue(bias=True, activation="silu"), bf)):
        z = torch.randn((E, C, MOE_F), generator=g, device=dev) * 3
        gate = rnd(E, C, MOE_F, dt=dt) \
            if ep.activation == "swiglu_gate" else None
        dout = rnd(E, C, MOE_F, dt=dt)
        kw = dict(epilogue=ep, gate=gate, dz_dtype=dt, want_bias=ep.bias)
        got = kmm.epilogue_bwd(dout, z, **kw)
        again = kmm.epilogue_bwd(dout, z, **kw)
        want = kmm.epilogue_bwd_plain(dout, z, **kw)
        torch.cuda.synchronize()
        rtol, atol = (1e-5, 1e-5) if dt == f32 else (1e-2, 1e-2)
        ok, errs = True, {}
        for name, x, y, w in zip(("dz", "dgate", "dbias"), got, again, want):
            if (x is None) != (w is None):
                ok = False
            if x is None or w is None:
                continue
            tol = atol * (C if name == "dbias" else 1)
            err = (x.float() - w.float()).abs()
            errs[name] = float(err.max())
            ok = ok and torch.equal(x, y) and x.shape == w.shape and bool(
                (err <= tol + rtol * w.float().abs()).all())
            if name != "dbias":
                worst["epilogue_bwd_grouped@train_moe"] = max(
                    worst["epilogue_bwd_grouped@train_moe"], errs[name])
        _check_case(rows, "train_kernels", {
            "kernel": "epilogue_bwd_grouped", "epilogue": str(ep),
            "dtype": str(dt)[6:], "shape": [E, C, MOE_F],
            "max_abs_err": errs}, ok)
    emit({"phase": "train_kernels", "tolerance": {
        "gemm": "tests/test_kernels.py:26-27 with K the product's reduction "
                "length (N for dX, T for dW)",
        "flash_bwd": f"bf16: relative L2 of dq, dk, dv against the plain "
                     f"f32 backward <= {BWD_REL_FACTOR} x the plain bf16 "
                     f"backward's; f32: <= {BWD_F32_REL_CAP} against the "
                     f"plain backward; forward o as the flash phase, lse "
                     f"atol 1e-4 + rtol 1e-5",
        "epilogue_bwd": "f32 atol 1e-5 + rtol 1e-5, bf16 atol 1e-2 + rtol "
                        "1e-2 (dbias atol x M; grouped: x C, a row an "
                        "expert)",
        "expert_matmul_bwd": "as gemm, per expert"},
          "deterministic": "two launches bitwise equal", "cases": rows})
    return worst


def _grad_rel(torch, got, want):
    from repro_torch.optim.adamw import tree_items
    return {path: _rel(torch, x.float(), w.float())
            for (path, x), (_, w) in zip(tree_items(got), tree_items(want))}


def _token_nll(torch, model, params, batch, dev):
    """Each position's next-token NLL, (B, S - 1) f32, of one full pass
    without autograd: ``lm_loss`` taken apart by token (less the MoE aux
    loss)."""
    from repro_torch.nn import transformer
    cfg = model.cfg
    tokens = torch.from_numpy(batch["tokens"]).to(dev).long()
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    n, out = tokens.shape[1] - 1, []
    with torch.no_grad():
        hidden = transformer.forward_hidden(params, tokens, cfg, extras)
        for j in range(0, n, 1024):
            lg = transformer.logits(hidden[:, j:min(j + 1024, n)], params,
                                    cfg)
            gold = tokens[:, j + 1:min(j + 1024, n) + 1]
            out.append(torch.logsumexp(lg, dim=-1)
                       - lg.gather(-1, gold[..., None])[..., 0])
    return torch.cat(out, dim=1)


def _f32_grads(torch, kmm, kfa, step, p32, batch):
    """The plain route's and then the kernel route's f32 loss and gradient
    of ``p32`` on ``batch``, this run's launches counted and, for an MoE
    model, every layer's expert ids recorded on both (the forward's; the
    remat recompute routes again in the backward pass).  Each leaf must lie
    within GRADS_F32_REL_CAP of the plain route, the loss within 1e-5
    relative, the launches must equal the reckoning, and an MoE model must
    route every token copy of every layer to the same experts on both.
    Returns (the plain route's loss and gradient, the kernel route's loss,
    the row's other f32 fields, the failed criteria, the launches)."""
    from repro_torch.nn import moe
    cfg = step.model.cfg
    routes = {}
    real_route = moe._route

    @contextlib.contextmanager
    def recording(name):
        ids = routes[name] = []

        def spy(flat, router, k):
            out = real_route(flat, router, k)
            ids.append(out[2])
            return out
        with mock.patch.object(moe, "_route", spy):
            yield

    with plain_path(kmm, kfa), recording("plain_f32"):
        loss_p32, g_p32 = step.loss_and_grads(p32, batch)
    _zero_counts(kmm, kfa)
    with recording("kernel_f32"):
        loss_k32, g_k32 = step.loss_and_grads(p32, batch)
    torch.cuda.synchronize()
    launches = _read_counts(kmm, kfa)
    want = _train_reckoning(cfg)
    expected = {k: sum(want[part].get(k, 0) for part in want)
                for k in launches}
    same_routes = len(routes["kernel_f32"]) == len(routes["plain_f32"]) \
        and all(torch.equal(a, b) for a, b in zip(routes["kernel_f32"],
                                                   routes["plain_f32"]))
    rel = _grad_rel(torch, g_k32, g_p32)
    del g_k32
    fields = {"grad_rel_l2_f32_kernel_vs_plain": rel,
              "f32_launches": launches, "f32_expected": expected,
              **({"f32_same_experts_every_copy": same_routes,
                  "f32_routed_layers": len(routes["kernel_f32"])}
                 if cfg.is_moe else {})}
    bad = [f"{p} (f32)" for p in rel if not rel[p] <= GRADS_F32_REL_CAP]
    if not abs(float(loss_k32) - float(loss_p32)) \
            <= 1e-5 * abs(float(loss_p32)):
        bad.append("loss (f32)")
    if cfg.is_moe and not same_routes:
        bad.append("the f32 routes chose other experts")
    if launches != expected:
        bad.append(f"the f32 launches {launches} differ from the "
                   f"reckoning {expected}")
    return (loss_p32, g_p32), loss_k32, fields, bad, launches


def train_grads_phase(torch, dev, kmm, kfa, arch="phi4-mini-3.8b"):
    """``arch`` at full width with GRADS_LAYERS layers (remat on), B 2 x S
    512: one loss and gradient on the kernel route against the plain route
    on the card, in bf16 (within GRADS_REL_FACTOR x the plain bf16 route's
    distance from the plain f32 route: the loss, each position's NLL as
    one vector, and each leaf; the kernel route twice, bitwise) and in f32
    (``_f32_grads``: this run puts the f32 backward kernels on a path).
    Returns the f32 run's launches."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn.model import Model
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(get_config(arch), num_layers=GRADS_LAYERS)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(5))
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_S,
                                   global_batch=GRADS_B)).batch_at(0)
    step = make_train_step(model, AdamW())

    t0 = time.perf_counter()
    loss_k, g_k = step.loss_and_grads(params, batch)
    _, g_k2 = step.loss_and_grads(params, batch)
    repeat_ok = all(torch.equal(x, y) for x, y in zip(_leaves(g_k),
                                                      _leaves(g_k2)))
    del g_k2
    p32 = _tree_map(params, lambda t: t.float())
    with plain_path(kmm, kfa):
        loss_p, g_p = step.loss_and_grads(params, batch)
    (loss_p32, g_p32), loss_k32, f32_fields, bad, launches32 = _f32_grads(
        torch, kmm, kfa, step, p32, batch)
    rel_kp, rel_p32 = _grad_rel(torch, g_k, g_p), _grad_rel(torch, g_p, g_p32)
    del g_k, g_p, g_p32
    nll = {"kernel": _token_nll(torch, model, params, batch, dev)}
    with plain_path(kmm, kfa):
        nll["plain"] = _token_nll(torch, model, params, batch, dev)
        nll["plain_f32"] = _token_nll(torch, model, p32, batch, dev)
    nll_kp = _rel(torch, nll["kernel"], nll["plain"])
    nll_p32 = _rel(torch, nll["plain"], nll["plain_f32"])
    del nll
    d_loss_kp = abs(float(loss_k) - float(loss_p))
    d_loss_p32 = abs(float(loss_p) - float(loss_p32))
    row = {"phase": "train_grads", "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "batch": [GRADS_B, TRAIN_S], "remat": cfg.remat,
           "loss": {"kernel": float(loss_k), "plain": float(loss_p),
                    "plain_f32": float(loss_p32),
                    "kernel_f32": float(loss_k32)},
           "loss_abs_diff_kernel_vs_plain": d_loss_kp,
           "loss_abs_diff_plain_vs_plain_f32": d_loss_p32,
           "token_nll_rel_l2_kernel_vs_plain": nll_kp,
           "token_nll_rel_l2_plain_vs_plain_f32": nll_p32,
           "grad_rel_l2_kernel_vs_plain": rel_kp,
           "grad_rel_l2_plain_vs_plain_f32": rel_p32,
           "kernel_route_bitwise_over_two_runs": repeat_ok,
           **f32_fields,
           "tolerance": f"bf16: loss, token NLLs and each leaf "
                        f"kernel-vs-plain <= {GRADS_REL_FACTOR} x "
                        f"plain-vs-plain-f32; f32: each leaf <= "
                        f"{GRADS_F32_REL_CAP}, loss <= 1e-5 relative",
           "seconds": time.perf_counter() - t0}
    emit(row)
    bad += [p for p in rel_kp
            if not rel_kp[p] <= GRADS_REL_FACTOR * rel_p32[p]]
    if not d_loss_kp <= GRADS_REL_FACTOR * d_loss_p32:
        bad.append("loss")
    if not nll_kp <= GRADS_REL_FACTOR * nll_p32:
        bad.append("loss by token")
    if not repeat_ok:
        bad.append("the kernel route's gradient differs between two runs")
    if bad:
        fail(f"train_grads {cfg.name}: {bad}")
    del params, p32
    _free(torch)
    return launches32


def train_grads_f32_phase(torch, dev, kmm, kfa):
    """mixtral-8x22b at full width, MIXTRAL_TRAIN_LAYERS layer (remat on),
    on one row of MIXTRAL_GRADS_S tokens, past its 4,096-key window: one
    f32 loss and gradient on the kernel route against the plain route
    (``_f32_grads``), which puts the windowed f32 flash forward and
    backward on a model's path.  Its bf16 half is not a phase: at this
    seed its loss scalar misses ``train_grads``' criterion (ROADMAP C10).
    Returns the kernel run's launches."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn.model import Model
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(get_config("mixtral-8x22b"),
                              num_layers=MIXTRAL_TRAIN_LAYERS)
    model = Model(cfg, device=dev)
    p32 = _tree_map(model.init(torch.Generator(device=dev).manual_seed(5)),
                    lambda t: t.float())
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=MIXTRAL_GRADS_S,
                                   global_batch=1)).batch_at(0)
    step = make_train_step(model, AdamW())
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    (loss_p32, g_p32), loss_k32, fields, bad, launches = _f32_grads(
        torch, kmm, kfa, step, p32, batch)
    del g_p32
    emit({"phase": "train_grads_f32", "arch": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "batch": [1, MIXTRAL_GRADS_S],
          "remat": cfg.remat, "window": cfg.sliding_window,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
          "loss": {"plain_f32": float(loss_p32),
                   "kernel_f32": float(loss_k32)},
          **fields,
          "tolerance": f"each leaf <= {GRADS_F32_REL_CAP}, loss <= 1e-5 "
                       f"relative",
          "seconds": time.perf_counter() - t0})
    if bad:
        fail(f"train_grads_f32 {cfg.name}: {bad}")
    del model, p32
    _free(torch)
    return launches


# The launches of one block's forward and backward, reckoned from the code.
# Forward: its GEMMs ("nn"; the MoE's experts "expert_nn", one grouped launch
# each) and flash forwards.  Backward: for each GEMM dX (B read transposed,
# "nt") and dW (A read transposed, "tn"); a swiglu gate adds the
# pre-activation's recompute (one more "nn", f32 out) and one epilogue
# backward; attention one flash backward.
_BLOCK_LAUNCHES = {
    # wq, wk, wv, wo + residual, one attention
    "attn": ({"nn": 4, "flash": 1},
             {"nt": 4, "tn": 4, "flash_bwd": 1}),
    # wu, wg + swiglu gate, wd + residual
    "mlp": ({"nn": 3},
            {"nt": 3, "tn": 3, "nn": 1, "epilogue_bwd": 1}),
    # w1 + gelu, w2 + residual (layernorm and gelu: musicgen-large)
    "mlp_gelu": ({"nn": 2},
                 {"nt": 2, "tn": 2, "nn": 1, "epilogue_bwd": 1}),
    # the experts' wu, wg + swiglu gate, wd, each one grouped launch (the
    # router, dispatch and combine are plain)
    "moe": ({"expert_nn": 3},
            {"expert_nt": 3, "expert_tn": 3, "expert_nn": 1,
             "epilogue_bwd_grouped": 1}),
    # in_z, in_x, in_b, in_c, in_dt, out_proj (the SSD is plain)
    "mamba": ({"nn": 6}, {"nt": 6, "tn": 6}),
}
_FWD_KEYS = ("nn", "flash", "expert_nn")
_BWD_KEYS = ("nn", "nt", "tn", "flash_bwd", "epilogue_bwd", "expert_nn",
             "expert_nt", "expert_tn", "epilogue_bwd_grouped")


def _train_reckoning(cfg):
    """The launches of one train step of ``cfg``: every layer's blocks
    (dense: attention and MLP; MoE: attention and experts; SSM: a mamba
    block; hybrid: a mamba block, and after every ``shared_attn_every``
    layers the shared attention and MLP) forward, then in the backward pass
    the remat recompute (the forward again, with ``cfg.remat``) and the
    backward.  The embedding, the lm_head and the loss are plain."""
    L = cfg.num_layers
    mlp = "mlp" if cfg.activation == "swiglu" else "mlp_gelu"
    dense = {"attn": L, mlp: L}
    blocks = {"dense": dense, "audio": dense, "vlm": dense,
              "moe": {"attn": L, "moe": L},
              "ssm": {"mamba": L},
              "hybrid": {"mamba": L, "attn": L // max(cfg.shared_attn_every,
                                                      1),
                         "mlp": L // max(cfg.shared_attn_every, 1)}}
    fwd, bwd = dict.fromkeys(_FWD_KEYS, 0), dict.fromkeys(_BWD_KEYS, 0)
    for block, n in blocks[cfg.family].items():
        f, b = _BLOCK_LAUNCHES[block]
        for k, v in f.items():
            fwd[k] += n * v
        for k, v in b.items():
            bwd[k] += n * v
    recompute = dict(fwd) if cfg.remat else dict.fromkeys(_FWD_KEYS, 0)
    return {"forward": fwd, "recompute": recompute, "backward": bwd}


def train_phase(torch, dev, kmm, kfa, arch="phi4-mini-3.8b", layers=None,
                steps=TRAIN_STEPS, phase="train", lr=1e-3,
                batch_dims=(TRAIN_B, TRAIN_S)):
    """``arch`` at full width (depth ``layers``, or the config's; remat as
    configured), ``steps`` steps of the driver's step functions
    (``launch/steps.py``: the retried loss and gradients, then the in-place
    AdamW commit) on one repeated SyntheticLM batch of ``batch_dims`` (B,
    S) tokens, B 4 x S 512 by default (plus the frontend's inputs, where
    the model has a frontend),
    AdamW(lr=``lr``, weight_decay=0.0), no warmup.  Launch counts are zeroed
    right before the steps; each step's forward (inside ``Model.loss``) and
    backward are counted apart and must equal the reckoning; the loss must
    fall, every grad norm be finite, and no degraded mode fire.  Returns
    (model, state, batch, the run's launches)."""
    import dataclasses
    import warnings
    from repro_torch.configs.registry import get_config
    from repro_torch.core.topology import DegradedModeWarning
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.nn.frontends import synth_frontend_inputs
    from repro_torch.nn.model import Model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.optim import AdamW
    from repro_torch.runtime import retry

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(lr=lr, weight_decay=0.0)
    state = TrainState(params=params, opt=opt.init(params), step=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S = batch_dims
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B)).batch_at(0)
    # A frontend's inputs join the batch, drawn as the train driver does.
    batch.update(synth_frontend_inputs(
        cfg, torch.Generator(device=dev).manual_seed(1), B, S, device=dev))
    step = make_train_step(model, opt)

    fwd = {"n": dict.fromkeys(_counters(kmm, kfa), 0)}
    real_loss = model.loss

    def counted_loss(p, b):
        n0 = _read_counts(kmm, kfa)
        try:
            return real_loss(p, b)
        finally:
            for k, v in _read_counts(kmm, kfa).items():
                fwd["n"][k] += v - n0[k]

    prev_metrics = obs_metrics.enable_metrics(True)
    obs_metrics.get_registry().clear()
    losses, gnorms, ms = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts(kmm, kfa)
    with warnings.catch_warnings(), \
            mock.patch.object(Model, "loss",
                              lambda self, p, b: counted_loss(p, b)):
        warnings.simplefilter("error", DegradedModeWarning)
        for _ in range(steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss, grads = retry(step.loss_and_grads, state.params, batch,
                                retries=2)
            state, met = step.apply(state, loss, grads)
            del grads
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
    launches = _read_counts(kmm, kfa)
    peak = torch.cuda.max_memory_allocated(dev)
    reg = obs_metrics.get_registry()
    fallback = sum(m.value for m in reg.metrics() if m.name == "fallback_rungs")
    retries = sum(m.value for m in reg.metrics() if m.name == "launch_retries")
    obs_metrics.enable_metrics(prev_metrics)
    with torch.no_grad():
        tokens = torch.from_numpy(batch["tokens"]).to(dev).long()
        final = float(model.loss(state.params, {**batch, "tokens": tokens}))

    per_step = {k: v / steps for k, v in launches.items()}
    fwd_step = {k: v / steps for k, v in fwd["n"].items()}
    bwd_step = {k: per_step[k] - fwd_step[k] for k in per_step}
    # In the backward pass the "nn" GEMMs and flash forwards are the remat
    # recompute, except one "nn" GEMM per epilogue backward (the
    # pre-activation's recompute), dense and grouped alike.
    recompute = {"nn": bwd_step["nn"] - bwd_step["epilogue_bwd"],
                 "flash": bwd_step["flash"],
                 "expert_nn": bwd_step["expert_nn"]
                 - bwd_step["epilogue_bwd_grouped"]}
    backward = {k: bwd_step[k] for k in _BWD_KEYS}
    backward["nn"] = bwd_step["epilogue_bwd"]
    backward["expert_nn"] = bwd_step["epilogue_bwd_grouped"]
    measured = {"forward": {k: fwd_step[k] for k in _FWD_KEYS},
                "recompute": recompute, "backward": backward}
    expected = _train_reckoning(cfg)
    steady = ms[1:]
    row = {"phase": phase, "arch": cfg.name, "family": cfg.family,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "remat": cfg.remat, "lr": lr,
           "params": sum(t.numel() for t in _leaves(state.params)),
           "batch": [B, S], "window": cfg.sliding_window,
           "steps": steps, "init_s": init_s, "losses": losses,
           "loss_after_last_step": final, "grad_norms": gnorms,
           "ms_per_step": ms,
           "ms_per_step_mean_after_first": sum(steady) / len(steady),
           "train_tokens_per_s": B * S * len(steady) / (sum(steady) / 1e3),
           "peak_mem_bytes": peak, "launches": launches,
           "launches_per_step": measured, "expected_per_step": expected,
           "fallback_rungs": fallback, "launch_retries": retries,
           "fixup_flags_down": _flags_down(kmm)}
    emit(row)
    MEASURED[phase] = row
    if measured != expected:
        fail(f"{phase}: launches per step {measured} differ from the "
             f"reckoning {expected}")
    if not all(math.isfinite(x) for x in gnorms + losses) \
            or not final < losses[0]:
        fail(f"{phase}: the loss did not fall ({losses} -> {final}) or a "
             f"norm is not finite ({gnorms})")
    if fallback or retries or not _flags_down(kmm):
        fail(f"{phase}: degraded mode (fallback rungs {fallback}, launch "
             f"retries {retries}, fixup flags down {_flags_down(kmm)})")
    return model, state, batch, launches


def train_families_phase(torch, dev, kmm, kfa):
    """The MoE, SSM and hybrid families' train phases, each freed before the
    next: qwen3-moe-30b-a3b at full width with MOE_TRAIN_LAYERS layers (its
    full-depth state does not fit the card) and one traced step, mamba2-370m
    at full size, zamba2-7b at full width with HYBRID_TRAIN_LAYERS layers
    (two applications of the shared block), FAMILY_TRAIN_STEPS steps each.
    Returns qwen3's launches."""
    model, state, batch, moe_launches = train_phase(
        torch, dev, kmm, kfa, "qwen3-moe-30b-a3b", layers=MOE_TRAIN_LAYERS,
        steps=FAMILY_TRAIN_STEPS, phase="train_moe")
    train_trace_phase(torch, dev, model, state, batch,
                      phase="train_moe_trace")
    del model, state, batch
    _free(torch)
    for arch, layers, phase in (("mamba2-370m", None, "train_ssm"),
                                ("zamba2-7b", HYBRID_TRAIN_LAYERS,
                                 "train_hybrid")):
        model, state, batch, _ = train_phase(
            torch, dev, kmm, kfa, arch, layers=layers,
            steps=FAMILY_TRAIN_STEPS, phase=phase)
        del model, state, batch
        _free(torch)
    return moe_launches


# train_zoo: the zoo members no other phase trains, each at full width and
# a cut depth whose state (12 bytes a parameter: bf16 params and grads, f32
# AdamW moments) stays under TRAIN_ZOO_STATE_CAP, FAMILY_TRAIN_STEPS steps
# each; (arch, layers, (B, S)).  llava's rows hold its 2,880 patch
# positions ahead of 512 text tokens.  mixtral-8x22b trains at one layer on
# one row of 8,192 tokens, so that its 4,096-key window binds in the
# forward, the remat recompute and the backward (at S 512 it never would).
MIXTRAL_TRAIN_LAYERS = 1
TRAIN_ZOO = [("minitron-8b", 6, (TRAIN_B, TRAIN_S)),
             ("stablelm-12b", 8, (TRAIN_B, TRAIN_S)),
             ("internlm2-20b", 6, (TRAIN_B, TRAIN_S)),
             ("llava-next-mistral-7b", 8, (TRAIN_B, 2880 + TRAIN_S)),
             ("mixtral-8x22b", MIXTRAL_TRAIN_LAYERS, (1, 8192))]
TRAIN_ZOO_STATE_CAP = 45e9
# At lr 1e-3 stablelm-12b (8 layers) memorises the repeated batch in two
# AdamW steps and the third overshoots: 12.55, 4.52, 0.46 -> 19.34 on the
# H100, the plain route 12.55, 4.52, 0.48 -> 14.22 (tools/train_route_ab.py),
# so the optimizer's step, not a kernel; minitron-8b bounced 0.0096 ->
# 0.23.  At 1e-4 each zoo member's loss falls below 0.2 in 3 steps.
ZOO_TRAIN_LR = 1e-4
# mixtral's train_grads_f32: one row just past the window, so that its last 512
# queries lose keys to it; the plain route's dense scores are (1, 6, S, S)
# f32 a kv head's group at a time.
MIXTRAL_GRADS_S = 4608


def train_zoo_phase(torch, dev, kmm, kfa):
    """The train phase for each model of TRAIN_ZOO, one after another, each
    freed before the next: launches a step equal to the reckoning, the loss
    after the last step below the first step's; ms a step, tokens/s and
    peak memory.  Returns the launches of the model with a window."""
    window_launches = None
    for arch, layers, dims in TRAIN_ZOO:
        model, state, batch, launches = train_phase(
            torch, dev, kmm, kfa, arch, layers=layers,
            steps=FAMILY_TRAIN_STEPS, phase="train_zoo", lr=ZOO_TRAIN_LR,
            batch_dims=dims)
        w = model.cfg.sliding_window
        if w:
            if not dims[1] > w:
                fail(f"train_zoo {arch}: rows of {dims[1]} tokens do not "
                     f"reach past the {w}-key window")
            window_launches = launches
        del model, state, batch
        _free(torch)
    return window_launches


def train_trace_phase(torch, dev, model, state, batch, phase="train_trace"):
    """One traced train step (loss and gradients, then the commit) under
    torch.profiler: wall time against device-busy time, kernel time by
    kernel (the grouped GEMM's as expert_matmul)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW
    step = make_train_step(model, AdamW(lr=1e-3, weight_decay=0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, grads = step.loss_and_grads(state.params, batch)
        step.apply(state, loss, grads)
        del grads
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ms, counts, other = _kernel_ms(prof)
    busy = sum(ms.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:12]
    L = model.cfg.num_layers
    if counts["flash_attention_bwd_f32"] \
            or counts["flash_attention_bwd"] != 3 * L:
        fail(f"{phase}: the bf16 step's attention backward ran "
             f"{counts['flash_attention_bwd']} wgmma-route kernels "
             f"(delta, dK/dV, dQ: {3 * L} expected) and "
             f"{counts['flash_attention_bwd_f32']} f32-route ones")
    emit({"phase": phase, "arch": model.cfg.name,
          "layers": L,
          "what": "torch.profiler device kernel time vs host wall time of "
          "one train step (profiler on)", "batch": [TRAIN_B, TRAIN_S],
          "wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
          "kernel_ms": ms, "kernels": counts,
          "other_top_ms": {name[:120]: t for name, t in top}})


def event_ms(torch, fn, calls: int = 5, reps: int = 3) -> float:
    """Time of one call between CUDA events (after two warm-up calls), the
    median of ``reps`` runs of ``calls`` calls, host gaps included: for the
    plain versions, which are no speed yardstick."""
    import statistics
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / calls)
    return statistics.median(runs)


def backward_ms(torch, forward, inputs, grad, calls: int = 10,
                reps: int = 5) -> float:
    """Device time of one autograd backward of ``forward(*leaves)`` with
    respect to its leaves (the library's attention backward), the leaves
    fresh copies of ``inputs`` that require grad: the forward run once on a
    side stream, ``torch.autograd.grad`` warmed up three times there, then
    ``calls`` backward calls captured in a CUDA graph on that stream and
    the graph replayed ``reps`` times between CUDA events, the median
    replay divided by ``calls``, as ``time_ms`` times the kernels.
    Autograd runs each backward op, a leaf's gradient node too, on the
    stream where it was made; so the leaves, the forward and the capture
    share one stream (a leaf that joined a graph on the default stream
    would make that stream wait on the capture, which CUDA refuses)."""
    import statistics
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = tuple(t.detach().requires_grad_() for t in inputs)
        out = forward(*leaves)

        def call():
            return torch.autograd.grad(out, leaves, grad, retain_graph=True)

        for _ in range(3):
            call()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            call()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / calls)
    del graph, out, leaves
    return statistics.median(runs)


def train_times_phase(torch, dev, kmm, kfa):
    """Times of the training kernels at phi4-mini's training shapes: the
    kernel and the library call (a CUDA graph, as the times phase; the
    library's attention backward too, ``backward_ms``), the plain version (CUDA events), and the bound max(flop / peak, bytes /
    3.35e12).  Returns the kernels-line numbers keyed by row."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.core.hardware import GPU_H100_LIKE
    from repro_torch.core.latency import Epilogue
    from repro_torch.core.selector import select_gemm_config

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(23)

    def rnd(*shape, dt=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    times, rows = {}, []
    n0 = (kmm.tiled_matmul.launches, dict(kmm.tiled_matmul.layout_launches),
          kfa.flash_attention_kernel.launches,
          kfa.flash_attention_bwd_kernel.launches, kmm.epilogue_bwd.launches,
          kmm.tiled_expert_matmul.launches,
          dict(kmm.tiled_expert_matmul.layout_launches),
          kmm.epilogue_bwd.grouped_launches)
    for key, layout in (("matmul@train_dgrad", "nt"),
                        ("matmul@train_wgrad", "tn")):
        tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bytes",
                             "flops"), 0.0)
        for name, N, K, _ in PATH_GEMMS:
            # dX (T, K) = dY (T, N) W^T, W stored (K, N);
            # dW (K, N) = X^T dY, X stored (T, K).
            M_, N_, K_ = (TRAIN_T, K, N) if layout == "nt" else (K, N, TRAIN_T)
            a = rnd(TRAIN_T, N, scale=0.1) if layout == "nt" \
                else rnd(TRAIN_T, K, scale=0.1)
            b = rnd(K, N, scale=0.02) if layout == "nt" \
                else rnd(TRAIN_T, N, scale=0.1)
            cfg = select_gemm_config(M_, N_, K_, in_dtype="bfloat16",
                                     out_dtype="bfloat16",
                                     hw=GPU_H100_LIKE).config
            kw = dict(out_dtype=bf, epilogue=None, bias=None, gate=None,
                      residual=None, trans_a=layout == "tn",
                      trans_b=layout == "nt")
            row = {"row": key, "gemm": name, "M": M_, "N": N_, "K": K_,
                   "config": str(cfg),
                   "ms": time_ms(lambda: kmm._launch_cuda(a, b, cfg, **kw)),
                   "plain_ms": event_ms(torch, lambda: kmm.matmul_plain(
                       a, b, cfg, **kw)),
                   "library_ms": time_ms((
                       lambda: torch.matmul(a, b.t())) if layout == "nt"
                       else (lambda: torch.matmul(a.t(), b)))}
            nbytes, flops = _gemm_bytes_flops(M_, N_, K_, "none")
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops,
                                                      BF16_PEAK)
            rows.append(row)
            for k_ in ("ms", "plain_ms", "library_ms"):
                tot[k_] += row[k_]
            tot["bytes"] += nbytes
            tot["flops"] += flops
        b_ms, b_by = _bound(tot["bytes"], tot["flops"], BF16_PEAK)
        times[key] = {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
                      "library_ms": tot["library_ms"], "bound_ms": b_ms,
                      "bound_by": b_by,
                      "what": f"sum over one layer's 7 bf16 GEMMs' "
                              f"{'dX' if layout == 'nt' else 'dW'} at "
                              f"T={TRAIN_T}"}

    # Flash: the forward with lse and the backward at the train shape, both
    # again in f32 at train_grads' shape.
    for key, B, dtype in (("flash_attention@train", TRAIN_B, "bfloat16"),
                          ("flash_attention_f32@train_grads", GRADS_B,
                           "float32"),
                          ("flash_attention_bwd@train", TRAIN_B, "bfloat16"),
                          ("flash_attention_bwd_f32@train_grads", GRADS_B,
                           "float32")):
        H, Hkv, S, d = 24, 8, TRAIN_S, 128
        q, k, v = _attn_inputs(torch, dev, B, H, Hkv, S, True, seed=29, d=d,
                               dtype=dtype)
        dt = q.dtype
        do = torch.randn(q.shape, generator=g, device=dev).to(dt)
        bq, bkv = kfa.select_attention_blocks(S, S, d, causal=True, batch=B,
                                              heads=H, kv_heads=Hkv)
        o, lse = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                                     causal=True, return_lse=True)
        pairs = S * (S + 1) // 2
        elem = q.element_size()
        peak = BF16_PEAK if dtype == "bfloat16" else TF32X3_PEAK
        forward = "_bwd" not in key
        sdpa = lambda a, b, c: F.scaled_dot_product_attention(  # noqa: E731
            a, b, c, is_causal=True, enable_gqa=True)
        if forward:
            kern = lambda: kfa._launch_cuda(  # noqa: E731
                q, k, v, block_q=bq, block_kv=bkv, causal=True, scale=None,
                return_lse=True)
            plain = lambda: kfa.attention_plain(  # noqa: E731
                q, k, v, block_q=bq, block_kv=bkv, causal=True,
                return_lse=True)
            flops = 4.0 * B * H * pairs * d
            nbytes = elem * d * S * B * (2 * H + 2 * Hkv) + 4 * B * H * S
        else:
            kern = lambda: kfa._launch_bwd_cuda(  # noqa: E731
                q, k, v, o, lse, do, causal=True, scale=None)
            plain = lambda: kfa.attention_bwd_plain(  # noqa: E731
                q, k, v, o, lse, do, causal=True)
            # recompute S, then dP, dV, dQ, dK: five products
            flops = 10.0 * B * H * pairs * d
            nbytes = elem * d * S * B * (4 * H + 4 * Hkv) + 4 * B * H * S
        if not forward:
            plan = kfa.plan_attention_bwd(S, S, d, batch=B, heads=H,
                                          kv_heads=Hkv, in_dtype=dtype)
            extra = {"plan": dataclasses.asdict(plan)}
        elif dtype == "float32":
            extra = {"plan": dataclasses.asdict(kfa.plan_attention_f32(
                S, d, batch=B, heads=H))}
        else:
            extra = {"blocks": [bq, bkv]}
        row = {"row": key, "q": [B, H, S, d], "kv": [B, Hkv, S, d],
               "dtype": dtype, **extra, "ms": time_ms(kern),
               "plain_ms": event_ms(torch, plain),
               # the backward rows: the library's backward alone
               "library_ms": (time_ms(lambda: sdpa(q, k, v)) if forward
                              else backward_ms(torch, sdpa, (q, k, v), do))}
        row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, peak)
        rows.append(row)
        times[key] = {k_: row[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                              "bound_ms", "bound_by")}

    # The epilogue backward of wg (swiglu) at (T, d_ff): dOut and the gate
    # bf16, z f32 read; dz and dgate bf16 written; about 20 flop an element.
    M, N = TRAIN_T, 8192
    ep = Epilogue(activation="swiglu_gate")
    dout, gate = rnd(M, N), rnd(M, N)
    z = torch.randn((M, N), generator=g, device=dev)
    kw = dict(epilogue=ep, gate=gate, dz_dtype=bf, want_bias=False)
    row = {"row": "epilogue_bwd@train", "shape": [M, N],
           "epilogue": str(ep),
           "ms": time_ms(lambda: kmm._launch_epilogue_bwd_cuda(dout, z,
                                                               **kw)),
           "plain_ms": event_ms(torch, lambda: kmm.epilogue_bwd_plain(
               dout, z, **kw)),
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = _bound((2 + 4 + 2 + 2 + 2) * M * N,
                                              20.0 * M * N, F32_PEAK)
    rows.append(row)
    times["epilogue_bwd@train"] = {k_: row[k_] for k_ in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}

    # The grouped GEMM's backward at qwen3-moe's training shapes, summed
    # over one layer's wu, wg and wd: dX_e = dZ_e W_e^T (w read transposed;
    # library torch.bmm(dz, w.transpose(1, 2))) and dW_e = X_e^T dZ_e (x read
    # transposed; torch.bmm(x.transpose(1, 2), dz)).  Bound: each expert's
    # operands read once and its output written once.
    E, C = MOE_E, MOE_C
    for key, layout in (("expert_matmul_bwd@train_moe_dgrad", "nt"),
                        ("expert_matmul_bwd@train_moe_wgrad", "tn")):
        tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bytes",
                             "flops"), 0.0)
        for name, K_in, N_out in (("wu", MOE_D, MOE_F), ("wg", MOE_D, MOE_F),
                                  ("wd", MOE_F, MOE_D)):
            # forward x (E, C, K_in) @ w (E, K_in, N_out) -> dz (E, C, N_out)
            x = rnd(E, C, K_in, scale=0.1)
            w = rnd(E, K_in, N_out, scale=0.02)
            dz = rnd(E, C, N_out, scale=0.1)
            if layout == "nt":
                a, b, (M_, N_, K_) = dz, w, (C, K_in, N_out)
                library = lambda: torch.bmm(dz, w.transpose(1, 2))  # noqa: E731
            else:
                a, b, (M_, N_, K_) = x, dz, (K_in, N_out, C)
                library = lambda: torch.bmm(x.transpose(1, 2), dz)  # noqa: E731
            cfg = select_gemm_config(M_, N_, K_, in_dtype="bfloat16",
                                     out_dtype="bfloat16",
                                     hw=GPU_H100_LIKE).config
            kw = dict(out_dtype=bf, epilogue=None, bias=None, gate=None,
                      residual=None, trans_a=layout == "tn",
                      trans_b=layout == "nt")
            row = {"row": key, "gemm": name, "experts": E, "M": M_, "N": N_,
                   "K": K_, "config": str(cfg),
                   "ms": time_ms(lambda: kmm._launch_expert_cuda(a, b, cfg,
                                                                 **kw)),
                   "plain_ms": event_ms(torch, lambda: kmm.expert_matmul_plain(
                       a, b, cfg, **kw)),
                   "library_ms": time_ms(library)}
            nbytes, flops = _gemm_bytes_flops(M_, N_, K_, "none")
            nbytes, flops = E * nbytes, E * flops
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops,
                                                      BF16_PEAK)
            # Achieved HBM rates: the bound's bytes (each operand read
            # once, the output written once) and the bytes the column
            # walk reads under kmm.l2_reckoning's 50 MB LRU, over the time.
            walk = kmm.l2_reckoning(
                kmm.work_plan(M_, N_, K_, cfg, E, kmm._sm_count(dev.index)),
                L2_BYTES)
            row["walk_bytes"] = walk["a"] + walk["b"] + walk["out"]
            row["hbm_tbs"] = nbytes / row["ms"] * 1e-9
            row["walk_hbm_tbs"] = row["walk_bytes"] / row["ms"] * 1e-9
            rows.append(row)
            for k_ in ("ms", "plain_ms", "library_ms"):
                tot[k_] += row[k_]
            tot["bytes"] += nbytes
            tot["flops"] += flops
            del x, w, dz, a, b
        b_ms, b_by = _bound(tot["bytes"], tot["flops"], BF16_PEAK)
        times[key] = {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
                      "library_ms": tot["library_ms"], "bound_ms": b_ms,
                      "bound_by": b_by,
                      "hbm_tbs": tot["bytes"] / tot["ms"] * 1e-9,
                      "what": f"sum over one qwen3-moe layer's wu, wg, wd "
                              f"{'dX' if layout == 'nt' else 'dW'}, E {E} "
                              f"C {C}"}

    # The grouped epilogue backward of wg's swiglu at (E, C, F), read and
    # written as the dense row's.
    shape = (E, C, MOE_F)
    dout, gate = rnd(*shape), rnd(*shape)
    z = torch.randn(shape, generator=g, device=dev)
    kw = dict(epilogue=ep, gate=gate, dz_dtype=bf, want_bias=False)
    n_el = E * C * MOE_F
    row = {"row": "epilogue_bwd_grouped@train_moe", "shape": list(shape),
           "epilogue": str(ep),
           "ms": time_ms(lambda: kmm._launch_epilogue_bwd_cuda(dout, z,
                                                               **kw)),
           "plain_ms": event_ms(torch, lambda: kmm.epilogue_bwd_plain(
               dout, z, **kw)),
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = _bound((2 + 4 + 2 + 2 + 2) * n_el,
                                              20.0 * n_el, F32_PEAK)
    rows.append(row)
    times["epilogue_bwd_grouped@train_moe"] = {k_: row[k_] for k_ in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    # timing launches do not count
    kmm.tiled_matmul.launches = n0[0]
    kmm.tiled_matmul.layout_launches.update(n0[1])
    kfa.flash_attention_kernel.launches = n0[2]
    kfa.flash_attention_bwd_kernel.launches = n0[3]
    kmm.epilogue_bwd.launches = n0[4]
    kmm.tiled_expert_matmul.launches = n0[5]
    kmm.tiled_expert_matmul.layout_launches.update(n0[6])
    kmm.epilogue_bwd.grouped_launches = n0[7]
    emit({"phase": "train_times", "timing": "kernels and library calls: CUDA "
          "graph of 10 calls, median of 5 replays (the library's attention "
          "backward alone, backward_ms); plain: CUDA events over 5 calls, "
          "median of 3",
          "rows": rows, "summary": times})
    return times


# ---------------------------------------------------------------------------
# The rest of the zoo: the windowed flash forward, six more architectures
# served at full width, musicgen-large trained whole.
# ---------------------------------------------------------------------------

# (B, H, Hkv, S, d, window): mixtral-8x22b's prefill at S 8192 with its
# 4,096-key window; windows of 32, 100 and 128 at S 300 and d 64, 128 and
# 160, so that block edges fall inside and on the window's lower edge; and
# windows no query reaches past (window >= S), which must be bitwise the
# causal kernel.
FLASH_WINDOW_CASES = [(1, 48, 8, 8192, 128, 4096)] + [
    (1, 8, 2, 300, d, w) for d in (64, 128, 160) for w in (32, 100, 128)]
FLASH_WINDOW_CAUSAL_CASES = [(1, 8, 2, 300, 128, 300),
                             (1, 48, 8, 474, 128, 4096)]
MIXTRAL_SHAPE = (1, 48, 8, 8192, 128, 4096)


# The windowed rows of the kernels line, keyed by (dtype, forward or not).
WINDOW_ROWS = {("bfloat16", True): "flash_attention@window",
               ("float32", True): "flash_attention_f32@window",
               ("bfloat16", False): "flash_attention_bwd@window",
               ("float32", False): "flash_attention_bwd_f32@window"}


def _window_case(torch, dev, kfa, B, H, Hkv, S, d, w, dtype, seed):
    """One flash_window case: (forward row, backward row, worst forward
    error, worst backward error); see :func:`flash_window_phase`."""
    f32 = dtype == "float32"
    q, k, v = _attn_inputs(torch, dev, B, H, Hkv, S, True, seed, d=d,
                           dtype=dtype)
    do = _attn_inputs(torch, dev, B, H, Hkv, S, False, seed + 1, d=d,
                      dtype=dtype)[0]
    plan = kfa.plan_attention(S, S, d, batch=B, heads=H, kv_heads=Hkv,
                              causal=True, window=w)
    bq, bkv = plan.block_q, plan.block_kv
    fwd_n0 = kfa.flash_attention_kernel.launches
    bwd_n0 = kfa.flash_attention_bwd_kernel.launches

    def fwd(window=w, **kw):
        return kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                          causal=True, window=window, **kw)

    def bwd(window=w):
        return kfa.flash_attention_bwd_kernel(q, k, v, o_p, lse_p, do,
                                              causal=True, window=window)
    got, again = fwd(), fwd()
    o_l, lse = fwd(return_lse=True)
    want = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                               causal=True, window=w)
    o_p, lse_p = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                                     causal=True, return_lse=True, window=w)
    grads, grads2 = bwd(), bwd()
    launched = (kfa.flash_attention_kernel.launches == fwd_n0 + 3
                and kfa.flash_attention_bwd_kernel.launches == bwd_n0 + 2)
    past = w >= S
    causal_fwd = fwd(window=0) if past else None
    causal_bwd = bwd(window=0) if past else None
    plain = kfa.attention_bwd_plain(q, k, v, o_p, lse_p, do, causal=True,
                                    window=w)
    ref32 = None
    if not f32:
        q32, k32, v32 = q.float(), k.float(), v.float()
        o32, lse32 = kfa.attention_plain(q32, k32, v32, block_q=bq,
                                         block_kv=bkv, causal=True,
                                         return_lse=True, window=w)
        ref32 = kfa.attention_bwd_plain(q32, k32, v32, o32, lse32,
                                        do.float(), causal=True, window=w)
        del q32, k32, v32, o32, lse32
    torch.cuda.synchronize()
    atol, rtol = ((FLASH_F32_ATOL, FLASH_F32_RTOL) if f32
                  else (FLASH_ATOL, FLASH_RTOL))
    err = torch.maximum((got.float() - want.float()).abs(),
                        (o_l.float() - want.float()).abs())
    lse_err = (lse - lse_p).abs()
    shape = {"q": [B, H, S, d], "kv": [B, Hkv, S, d], "window": w,
             "dtype": dtype}
    fwd_row = {**shape, "kernel": "forward",
               "blocks": None if f32 else [bq, bkv],
               "max_steps": None if f32 else plan.max_steps,
               "max_abs_err": float(err.max()),
               "lse_max_abs_err": float(lse_err.max()),
               "deterministic": bool(torch.equal(got, again)),
               "with_lse_equal": bool(torch.equal(got, o_l)),
               "equals_causal": (None if causal_fwd is None
                                 else bool(torch.equal(got, causal_fwd)))}
    fwd_row["ok"] = bool((err <= atol + rtol * want.float().abs()).all()) \
        and bool((lse_err <= 1e-4 + 1e-5 * lse_p.abs()).all()) \
        and bool(torch.isfinite(got).all()) and launched \
        and fwd_row["deterministic"] and fwd_row["equals_causal"] is not False
    dist, bwd_err, ok = {}, 0.0, launched
    for i, name in enumerate(("dq", "dk", "dv")):
        x, p = grads[i], plain[i]
        dist[name] = {"kernel_vs_plain": _rel(torch, x.float(), p.float())}
        if ref32 is not None:
            dist[name]["kernel_vs_plain_f32"] = _rel(torch, x.float(),
                                                     ref32[i])
            dist[name]["plain_vs_plain_f32"] = _rel(torch, p.float(),
                                                    ref32[i])
            ok = ok and dist[name]["kernel_vs_plain_f32"] \
                <= BWD_REL_FACTOR * dist[name]["plain_vs_plain_f32"]
        else:
            ok = ok and dist[name]["kernel_vs_plain"] <= BWD_F32_REL_CAP
        ok = ok and torch.equal(x, grads2[i]) \
            and bool(torch.isfinite(x).all()) and x.dtype == q.dtype
        bwd_err = max(bwd_err, float((x.float() - p.float()).abs().max()))
    same_causal = None if causal_bwd is None else all(
        torch.equal(x, y) for x, y in zip(grads, causal_bwd))
    bwd_row = {**shape, "kernel": "backward",
               "route": kfa.plan_attention_bwd(
                   S, S, d, batch=B, heads=H, kv_heads=Hkv,
                   in_dtype=dtype).route,
               "max_abs_err": bwd_err, "rel_l2": dist,
               "deterministic": all(torch.equal(x, y)
                                    for x, y in zip(grads, grads2)),
               "equals_causal": same_causal,
               "ok": ok and same_causal is not False}
    return fwd_row, bwd_row, float(err.max()), bwd_err


def flash_window_phase(torch, dev, kfa):
    """The sliding window in every flash kernel, each case in bf16 and
    f32, against its plain version: the forward (``chunked_attention``,
    and with its lse ``attention_lse_ref``) at the selector's blocks (bf16)
    or the f32 plan, out within the flash phase's tolerance and lse within
    1e-4 + 1e-5 relative; the backward (``attention_bwd_ref``, one kv head's
    group at a time) from the plain forward's o and lse, bf16 within
    BWD_REL_FACTOR x the plain bf16 backward's distance from the plain f32
    one and f32 within BWD_F32_REL_CAP relative L2 (train_kernels'
    criteria).  Every kernel is launched twice and must repeat bitwise; a
    window no query reaches past (window >= S) must be bitwise the causal
    kernel, forward and backward.  Returns the worst absolute error of
    each row of WINDOW_ROWS."""
    rows, worst = [], dict.fromkeys(WINDOW_ROWS.values(), 0.0)
    for i, (B, H, Hkv, S, d, w) in enumerate(FLASH_WINDOW_CASES
                                             + FLASH_WINDOW_CAUSAL_CASES):
        for dtype in ("bfloat16", "float32"):
            fwd_row, bwd_row, fwd_err, bwd_err = _window_case(
                torch, dev, kfa, B, H, Hkv, S, d, w, dtype, 300 + 2 * i)
            rows += [fwd_row, bwd_row]
            worst[WINDOW_ROWS[dtype, True]] = max(
                worst[WINDOW_ROWS[dtype, True]], fwd_err)
            worst[WINDOW_ROWS[dtype, False]] = max(
                worst[WINDOW_ROWS[dtype, False]], bwd_err)
            _free(torch)
            if not (fwd_row["ok"] and bwd_row["ok"]):
                emit({"phase": "flash_window", "cases": rows})
                fail(f"windowed flash {fwd_row} / {bwd_row} disagrees with "
                     f"its plain version, does not repeat bitwise or "
                     f"differs from the causal kernel past S")
    emit({"phase": "flash_window", "tolerance": f"forward: bf16 atol "
          f"{FLASH_ATOL} + rtol {FLASH_RTOL}, f32 atol {FLASH_F32_ATOL} + "
          f"rtol {FLASH_F32_RTOL} against chunked_attention, lse 1e-4 + 1e-5 "
          f"relative; backward: bf16 relative L2 to the plain f32 backward "
          f"<= {BWD_REL_FACTOR} x the plain bf16 backward's, f32 <= "
          f"{BWD_F32_REL_CAP} to the plain f32 backward",
          "deterministic": "two launches bitwise equal", "cases": rows})
    return worst


# (arch, layers served or None for the whole model, extra serve flags).
# mixtral-8x22b's 282 GB do not fit the card: 8 of its 56 layers at full
# width (41 GB of bf16 weights).
MIXTRAL_LAYERS = 8
ZOO_SERVE = [("musicgen-large", None, ()),
             ("llava-next-mistral-7b", None, ()),
             ("minitron-8b", None, ()),
             ("stablelm-12b", None, ()),
             ("internlm2-20b", None, ()),
             ("mixtral-8x22b", MIXTRAL_LAYERS, ())]
# mixtral's long request: one prompt of 8,192 tokens, where the window binds
# in prefill and in every decode step.
LONG_ARGS = ["--batch", "1", "--prompt-len", "8192", "--gen", "16",
             "--requests", "1", "--temperature", "0", "--seed", "0",
             "--quiet"]
# The logits' f32 yardstick is taken at this depth (views of the served
# params): an f32 copy of a whole internlm2-20b (79 GB) or of mixtral's 8
# layers (82 GB) does not fit beside the bf16 weights.
ZOO_CUT_LAYERS = 2


def _zoo_launches(cfg):
    """(per prefill, per decode step) launches of a dense, audio, vlm or
    MoE model, reckoned from the code: a layer's wq, wk, wv, wo, its MLP's
    GEMMs (swiglu wu, wg, wd; gelu w1, w2; an MoE none: the router is a
    plain product, the experts one grouped launch each of wu, wg, wd in a
    prefill and plain einsums in decode), in a prefill also wk, wv again
    for the cache and one flash launch.  The lm_head is a plain product."""
    L = cfg.num_layers
    mlp = 0 if cfg.is_moe else (3 if cfg.activation == "swiglu" else 2)
    prefill = {"matmul": L * (6 + mlp), "flash_attention": L,
               "expert_matmul": 3 * L if cfg.is_moe else 0}
    decode = {"matmul": L * (4 + mlp), "flash_attention": 0,
              "expert_matmul": 0}
    return prefill, decode


def _check_zoo_launches(cfg, out, launches, phase):
    n, steps = len(out["results"]), out["steps"]
    per_prefill, per_step = _zoo_launches(cfg)
    expected = {f"{k}@prefill": v * n for k, v in per_prefill.items()}
    expected.update({f"{k}@decode": v * steps for k, v in per_step.items()})
    row = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
           "prefills": n, "steps": steps, "per_prefill": per_prefill,
           "per_step": per_step, "expected": expected,
           "launched": {k: launches[k] for k in expected}}
    emit(row)
    if row["launched"] != expected:
        fail(f"{cfg.name}: kernel launches {row['launched']} differ from "
             f"the reckoning {expected}")


def _zoo_logits_check(torch, dev, kmm, kfa, args, model, params, out, phase):
    """Request 0's prefill logits (with its frontend inputs, as served):
    kernel path vs plain path at the served depth, within LOGITS_REL_CAP
    (MoE: MOE_FULL_REL_CAP, routing flips); then at ZOO_CUT_LAYERS layers,
    full width, kernel vs plain against the plain path's own distance from
    its f32 run, as phase 4 does at full depth."""
    import dataclasses
    from repro_torch.nn.model import Model
    cfg = model.cfg
    r0 = out["results"][0]
    tokens, last, extras = _request_inputs(torch, dev, args, cfg, r0)
    full_cap = MOE_FULL_REL_CAP if cfg.is_moe else LOGITS_REL_CAP
    with torch.inference_mode():
        got = model.prefill(params, tokens, last, extras=extras)[0]
        with plain_path(kmm, kfa):
            want = model.prefill(params, tokens, last, extras=extras)[0]
        torch.cuda.synchronize()
        d_full = _rel(torch, got, want)
        row = {"phase": phase, "arch": cfg.name, "rid": r0.rid,
               "prompt_len": r0.prompt_len, "padded_len": r0.padded_len,
               "extras": sorted(extras or {}),
               "layers": cfg.num_layers, "rel_l2_kernel_vs_plain": d_full,
               "argmax_equal": int(got.argmax()) == int(want.argmax()),
               "first_token_matches_served":
                   int(got.argmax()) == int(r0.tokens[0]),
               "tolerance": f"finite, relative L2 <= {full_cap}"}
        full_ok = bool(torch.isfinite(got).all()) and d_full <= full_cap
        del got, want
        cut = Model(dataclasses.replace(cfg, num_layers=ZOO_CUT_LAYERS),
                    device=dev)
        p_cut = dict(params, layers=_tree_map(
            params["layers"], lambda t: t[:ZOO_CUT_LAYERS]))
        got = cut.prefill(p_cut, tokens, last, extras=extras)[0]
        with plain_path(kmm, kfa):
            want = cut.prefill(p_cut, tokens, last, extras=extras)[0]
            p32 = _tree_map(p_cut, lambda t: t.float())
            ref32 = cut.prefill(p32, tokens, last, extras=extras)[0]
            del p32
        torch.cuda.synchronize()
    d_kp, d_p32 = _rel(torch, got, want), _rel(torch, want, ref32)
    row.update({"cut_layers": ZOO_CUT_LAYERS,
                "cut_rel_l2_kernel_vs_plain": d_kp,
                "cut_rel_l2_plain_bf16_vs_plain_f32": d_p32,
                "cut_rel_l2_kernel_vs_plain_f32": _rel(torch, got, ref32),
                "cut_tolerance": f"kernel vs plain relative L2 <= "
                                 f"{LOGITS_REL_FACTOR} x (plain bf16 vs "
                                 f"plain f32) and <= {LOGITS_REL_CAP}",
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})
    emit(row)
    if not full_ok:
        fail(f"{cfg.name} prefill logits disagree with the plain path at "
             f"{cfg.num_layers} layers (rel {d_full})")
    if not bool(torch.isfinite(got).all()) or d_kp > LOGITS_REL_CAP \
            or d_kp > LOGITS_REL_FACTOR * d_p32:
        fail(f"{cfg.name} {ZOO_CUT_LAYERS}-layer logits disagree with the "
             f"plain path (rel {d_kp}, bf16 rounding alone {d_p32})")


def serve_zoo_phase(torch, dev, kmm, kfa, tp_refs):
    """Each architecture of ZOO_SERVE at full width on phase 4's traffic
    (llava with its whole image prefix ahead of each text prompt), one
    after another, each freed before the next: the launches against the
    reckoning in prefills and decode steps apart, request 0's logits
    against the plain path; mixtral-8x22b (8 layers) then serves one
    request of 8,192 tokens, its window binding.  Returns mixtral's flash
    launches (every one windowed) over both runs."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    window_launches = 0
    for arch, layers, extra in ZOO_SERVE:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        args, model, params, out, launches = _serve(
            torch, dev, kmm, kfa, arch, extra=extra, phase="serve_zoo",
            cfg=cfg)
        _check_zoo_launches(cfg, out, launches, "serve_zoo_launches")
        _zoo_logits_check(torch, dev, kmm, kfa, args, model, params, out,
                          "serve_zoo_logits")
        if arch in TP_SERVE:
            tp_refs.append(_tp_ref(torch, dev, kmm, kfa, args, model,
                                   params, out))
        if cfg.sliding_window:
            window_launches += launches["flash_attention"]
            args, model, _, out, launches = _serve(
                torch, dev, kmm, kfa, arch, phase="serve_zoo_long",
                params=params, cfg=cfg, base=LONG_ARGS)
            _check_zoo_launches(cfg, out, launches,
                                "serve_zoo_long_launches")
            _zoo_logits_check(torch, dev, kmm, kfa, args, model, params,
                              out, "serve_zoo_long_logits")
            window_launches += launches["flash_attention"]
        del model, params
        _free(torch)
    return window_launches


# ---------------------------------------------------------------------------
# Phase 11b: tensor- and expert-parallel serving, 2 ranks on cuda:0.
# ---------------------------------------------------------------------------

# The archs served over TP_RANKS ranks, each held to its single-process
# run (phi4-mini, qwen3-moe, mamba2-370m and zamba2-7b whole, mixtral-8x22b
# at MIXTRAL_LAYERS).
TP_SERVE = ("phi4-mini-3.8b", "qwen3-moe-30b-a3b", "mamba2-370m",
            "zamba2-7b", "mixtral-8x22b")
TP_RANKS = 2
# serve_tp's traffic: phase 4's 8 requests (the same prompts, two waves
# through the 4 slots, the second admitted into freed slots in lockstep)
# with TP_GEN tokens each, a prefix of the one-process run's: 25
# host-staged collectives a layer-step would otherwise make the five
# models' ranks most of the script's time.
TP_GEN = 4
TP_TRAFFIC = ["--gen", str(TP_GEN)]
# Each model's ranks must be done within this (spawn, init, serve, check).
TP_JOIN_TIMEOUT = 420.0
# serve_tp_f32 holds the TP layers to one process in f32 at this depth
# (``_f32_depth``) within this relative L2: both sides run the kernels and
# differ only in the order of the row-parallel sums and of the gated
# norm's sum of squares (the f32 gaps measured: 3e-7 to 2e-6).
TP_F32_LAYERS = 2
TP_F32_REL_CAP = 1e-5


def _f32_depth(arch, layers):
    """``layers``, or for a hybrid model the least depth at which its shared
    block runs (one group of ``nn/transformer.py::_hybrid_split``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.nn.transformer import _hybrid_split
    cfg = get_config(arch)
    return max(layers, _hybrid_split(cfg)[1]) if cfg.family == "hybrid" \
        else layers


def _tp_ref(torch, dev, kmm, kfa, args, model, params, out):
    """What ``serve_tp`` holds a model's ranks to, on the host: request 0
    as served (padded to its edge), its prefill logits on the kernel path
    and on the plain path (the yardstick: how far rounding alone moves
    them), and every request's served tokens."""
    r0 = out["results"][0]
    tokens, last, _ = _request_inputs(torch, dev, args, model.cfg, r0)
    with torch.inference_mode():
        logits, _ = model.prefill(params, tokens, last)
        with plain_path(kmm, kfa):
            plain, _ = model.prefill(params, tokens, last)
    res = out["results"]
    return {"arch": args.arch, "layers": model.cfg.num_layers,
            "tokens": tokens.cpu(), "last": last.cpu(),
            "logits": logits.float().cpu(), "plain": plain.float().cpu(),
            "served": {r: res[r].tokens for r in res}}


def _tp_local_shapes(cfg, tp):
    """The (N, K) of every dense GEMM and the (E, K, N) of every grouped
    GEMM a rank launches at ``tp`` (whole heads, SSM heads, experts, d_ff
    and vocabulary split as ``tp_shardings`` splits them; every split of
    the served models divides): a mamba layer's in_z / in_x, in_b / in_c
    (whole), in_dt and out_proj; attention's wq, wk / wv and wo; the MLP's
    or the experts' products."""
    D, hd = cfg.d_model, cfg.head_dim
    for n in (cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size,
              cfg.num_experts or tp, cfg.d_ff,
              cfg.ssm_heads if cfg.has_ssm else tp):
        if n % tp:
            fail(f"serve_tp: {cfg.name} does not split over {tp} ranks")
    dense, grouped = set(), set()
    if cfg.has_ssm:
        nh = cfg.ssm_heads // tp
        di = nh * cfg.ssm_head_dim
        dense |= {(di, D), (cfg.ssm_state, D), (nh, D), (D, di)}
    if cfg.family == "ssm":
        return sorted(dense), []
    q, kv = cfg.num_heads // tp * hd, cfg.num_kv_heads // tp * hd
    dense |= {(q, D), (kv, D), (D, q)}
    if cfg.is_moe:
        e, f = cfg.num_experts // tp, cfg.moe_d_ff
        grouped = {(e, D, f), (e, f, D)}
    else:
        dense |= {(cfg.d_ff // tp, D), (D, cfg.d_ff // tp)}
    return sorted(dense), sorted(grouped)


def _tp_launches(cfg):
    """(per prefill, per decode step) launches of one rank of serve_tp:
    the one-process reckoning (a rank launches what one process launches,
    at local shapes): ``_mamba_launches`` for the SSM and hybrid families,
    ``_zoo_launches`` for the rest."""
    if not cfg.has_ssm:
        return _zoo_launches(cfg)
    prefill, step, flash = _mamba_launches(cfg)
    return ({"matmul": prefill, "flash_attention": flash,
             "expert_matmul": 0},
            {"matmul": step, "flash_attention": 0, "expert_matmul": 0})


def _tp_join(rank, world, init_method):
    """A spawned rank's start: the gloo group with every rank on cuda:0
    (the shared-card form), the (1, world) mesh installed; (dev, mesh)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import meshctx
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    dev = init_distributed(rank, world, init_method, device="cuda",
                           shared_card=True)
    mesh = make_local_mesh(world, device_type="cuda")
    meshctx.set_mesh(mesh)
    return dev, mesh


def _tp_rank(rank, world, init_method, arch, layers, ref_tokens, ref_last):
    """One rank of ``serve_tp`` (a spawned process): join the gloo group
    on cuda:0, draw this rank's shards (``init_shards``, seed 0), serve
    TP_TRAFFIC (phase 4's requests, fewer tokens) with launches counted in
    prefills and decode steps
    apart and every GEMM's shape recorded, then request 0's prefill
    logits on the same padded tokens as the single-process run."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.launch.serve import build_parser, run_serving
    from repro_torch.nn.model import Model

    dev, mesh = _tp_join(rank, world, init_method)
    args = build_parser().parse_args(
        ["--arch", arch, *SERVE_ARGS, *TP_TRAFFIC, "--tp", str(world),
         "--shared-card", "--device", str(dev)])
    cfg = get_config(arch)
    if layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init_shards(
        torch.Generator(device=dev).manual_seed(args.seed), mesh, rank)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shapes = {"dense": set(), "grouped": set()}

    def recorded(kind, fn):
        def call(a, b, *rest, **kw):
            shapes[kind].add((b.shape[1], b.shape[0]) if kind == "dense"
                             else tuple(b.shape))
            return fn(a, b, *rest, **kw)
        return call

    # Host seconds inside the collectives (gloo returns once the sum is
    # back on the card), their calls and bytes.
    coll = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def timed(fn):
        def call(t, *rest, **kw):
            t1 = time.perf_counter()
            try:
                return fn(t, *rest, **kw)
            finally:
                coll["seconds"] += time.perf_counter() - t1
                coll["calls"] += 1
                coll["bytes"] += t.numel() * t.element_size()
        return call

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with mock.patch.object(kmm, "_launch_cuda",
                           recorded("dense", kmm._launch_cuda)), \
            mock.patch.object(kmm, "_launch_expert_cuda",
                              recorded("grouped", kmm._launch_expert_cuda)), \
            mock.patch.object(torch.distributed, "all_reduce",
                              timed(torch.distributed.all_reduce)), \
            mock.patch.object(torch.distributed, "broadcast",
                              timed(torch.distributed.broadcast)):
        out, launches = _count_serve(
            kmm, kfa, lambda: run_serving(args, params=params, cfg=cfg))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.inference_mode():
        logits, _ = model.prefill(params, ref_tokens.to(dev),
                                  ref_last.to(dev))
    torch.cuda.synchronize()
    res = out["results"]
    return {"rank": rank, "backend": torch.distributed.get_backend(),
            "local_shapes": {k: sorted(v) for k, v in shapes.items()},
            "launches": launches, "init_s": init_s, "wall_s": wall,
            "collectives": coll,
            "peak_mem_bytes": peak,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(params)),
            "steps": out["steps"], "edges": out["edges"],
            "tokens_per_s": out["tokens_per_s"],
            "t_prefill_s": out["t_prefill_s"],
            "decode_ms_per_step": out["device_step_s_mean"] * 1e3,
            "dispatch_ms_per_step": out["dispatch_s_mean"] * 1e3,
            "served": {r: res[r].tokens for r in res},
            "finished": all(r.finished for r in res.values()),
            "logits": logits.float().cpu() if rank == 0 else None}


def _tp_f32_config(arch):
    """``arch`` at TP_F32_LAYERS layers (``_f32_depth``), full width, in
    f32 (mixtral with its window, which the f32 flash
    forward takes; at these prompts, at most 474 tokens, it does not
    bind)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(
        get_config(arch), num_layers=_f32_depth(arch, TP_F32_LAYERS),
        dtype="float32")


def _tp_f32_rank(rank, world, init_method, cases):
    """One rank of ``serve_tp_f32``: for each (arch, tokens, last), this
    rank's f32 shards at ``_tp_f32_config``'s depth (seed 0) and the prefill
    logits of the tokens (rank 0 keeps them)."""
    import torch
    from repro_torch.nn.model import Model

    dev, mesh = _tp_join(rank, world, init_method)
    out = []
    for arch, tokens, last in cases:
        model = Model(_tp_f32_config(arch), device=dev)
        params = model.init_shards(torch.Generator(device=dev).manual_seed(0),
                                   mesh, rank)
        with torch.inference_mode():
            logits, _ = model.prefill(params, tokens.to(dev), last.to(dev))
        out.append(logits.cpu() if rank == 0 else None)
        del params, logits
        torch.cuda.empty_cache()
    return out


def serve_tp_f32_phase(torch, tp_refs):
    """The TP layers' arithmetic at full width, with no bf16 rounding to
    hide behind: each model of serve_tp at TP_F32_LAYERS layers in f32
    (zamba2-7b at 6), request 0's prefill logits on 2 ranks against one
    process, both on the kernels (split TF32); they differ only in
    summation order, so the relative L2 must stay within
    TP_F32_REL_CAP."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.nn.model import Model
    dev = torch.device("cuda", 0)
    single = []
    for ref in tp_refs:
        model = Model(_tp_f32_config(ref["arch"]), device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        with torch.inference_mode():
            logits, _ = model.prefill(params, ref["tokens"].to(dev),
                                      ref["last"].to(dev))
        single.append(logits.cpu())
        del params, logits
        _free(torch)
    t0 = time.perf_counter()
    ranks = spawn_ranks(_tp_f32_rank, TP_RANKS,
                        ([(r["arch"], r["tokens"], r["last"])
                          for r in tp_refs],), timeout=TP_JOIN_TIMEOUT)
    rows = []
    for ref, want, got in zip(tp_refs, single, ranks[0]):
        d = _rel(torch, got, want)
        rows.append({"arch": ref["arch"],
                     "layers": _tp_f32_config(ref["arch"]).num_layers,
                     "rel_l2_tp_vs_single": d,
                     "max_abs_err": float((got - want).abs().max()),
                     "argmax_equal": int(got.argmax()) == int(want.argmax()),
                     "ok": bool(torch.isfinite(got).all())
                     and d <= TP_F32_REL_CAP})
    emit({"phase": "serve_tp_f32", "world": TP_RANKS,
          "backend": "gloo", "dtype": "float32", "cases": rows,
          "tolerance": f"relative L2 <= {TP_F32_REL_CAP} (both f32)",
          "seconds": time.perf_counter() - t0})
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"serve_tp_f32: TP logits differ from one process's in f32: "
             f"{bad}")


def serve_tp_phase(torch, tp_refs):
    """phi4-mini-3.8b, qwen3-moe-30b-a3b, mamba2-370m and zamba2-7b whole
    and mixtral-8x22b at MIXTRAL_LAYERS, each on TP_RANKS ranks sharing
    cuda:0 over gloo (the collectives staged through the host), each
    model's ranks spawned after the last's exit: per rank the launches
    against the reckoning (``_tp_launches``) in
    prefills and decode steps apart and every GEMM at the local shapes;
    request 0's prefill logits against the single-process run's on the
    same padded tokens (relative L2, LOGITS_REL_CAP dense,
    MOE_FULL_REL_CAP MoE); every request served with TP_GEN tokens and
    those against the single-process run's first tokens of the same
    request (counted: bf16 may flip near-ties).  Returns the ranks'
    launches summed over the models, keyed by the kernels line's rows."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import spawn_ranks
    import dataclasses
    _free(torch)
    totals = {}
    for ref in tp_refs:
        cfg = dataclasses.replace(get_config(ref["arch"]),
                                  num_layers=ref["layers"])
        t0 = time.perf_counter()
        ranks = spawn_ranks(_tp_rank, TP_RANKS,
                            (ref["arch"], ref["layers"], ref["tokens"],
                             ref["last"]), timeout=TP_JOIN_TIMEOUT)
        wall = time.perf_counter() - t0
        r0 = ranks[0]
        per_prefill, per_step = _tp_launches(cfg)
        n, steps = len(r0["served"]), r0["steps"]
        expected = {f"{k}@prefill": v * n for k, v in per_prefill.items()}
        expected.update({f"{k}@decode": v * steps
                         for k, v in per_step.items()})
        dense, grouped = _tp_local_shapes(cfg, TP_RANKS)
        want = ref["logits"]
        d = _rel(torch, r0["logits"], want)
        cap = MOE_FULL_REL_CAP if cfg.is_moe else LOGITS_REL_CAP
        agree = total = 0
        diverge = {}
        for rid, want_toks in ref["served"].items():
            got = r0["served"].get(rid, [])
            toks = want_toks[:TP_GEN]                # the same prompt
            total += len(toks)
            agree += sum(int(a == b) for a, b in zip(got, toks))
            diverge[rid] = next((i for i, (a, b) in enumerate(zip(got, toks))
                                 if a != b), None)
        row = {"phase": "serve_tp", "arch": cfg.name,
               "layers": cfg.num_layers, "backend": r0["backend"],
               "world": TP_RANKS, "device": "cuda:0 shared",
               "collectives": "gloo, host-staged",
               "expected_launches": expected,
               "launches": [{k: r["launches"][k] for k in expected}
                            for r in ranks],
               "local_shapes": r0["local_shapes"],
               "expected_local_shapes": {"dense": dense,
                                         "grouped": grouped},
               "rel_l2_prefill_logits_vs_single": d,
               "rel_l2_vs_single_plain": _rel(torch, r0["logits"],
                                              ref["plain"]),
               "rel_l2_single_kernel_vs_plain": _rel(torch, want,
                                                     ref["plain"]),
               "argmax_equal": int(r0["logits"].argmax())
               == int(want.argmax()),
               "logits_tolerance": f"relative L2 <= {cap}",
               "tokens_agree": agree, "tokens_total": total,
               "first_divergence": diverge,
               "edges": r0["edges"], "steps": steps,
               "tokens_per_s": r0["tokens_per_s"],
               "prefill_ms_total": r0["t_prefill_s"] * 1e3,
               "prefill_ms_per_request": r0["t_prefill_s"] * 1e3 / n,
               "decode_ms_per_step": r0["decode_ms_per_step"],
               "dispatch_ms_per_step": r0["dispatch_ms_per_step"],
               "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
               "peak_mem_gb_per_rank": [r["peak_mem_bytes"] / 1e9
                                        for r in ranks],
               "init_s_per_rank": [r["init_s"] for r in ranks],
               "serve_wall_s_per_rank": [r["wall_s"] for r in ranks],
               "collectives_per_rank": [r["collectives"] for r in ranks],
               "collective_share_per_rank": [
                   r["collectives"]["seconds"] / r["wall_s"]
                   for r in ranks],
               "phase_wall_s": wall}
        emit(row)
        for r in ranks:
            if not r["finished"] or set(r["served"]) != set(ref["served"]) \
                    or any(len(t) != TP_GEN or not (
                        (t >= 0) & (t < cfg.vocab_size)).all()
                        for t in r["served"].values()):
                fail(f"serve_tp {cfg.name} rank {r['rank']}: not every "
                     f"request finished with in-vocabulary tokens")
            if {k: r["launches"][k] for k in expected} != expected:
                fail(f"serve_tp {cfg.name} rank {r['rank']}: launches "
                     f"{r['launches']} differ from the reckoning {expected}")
            if r["local_shapes"] != {"dense": dense, "grouped": grouped}:
                fail(f"serve_tp {cfg.name} rank {r['rank']}: GEMM shapes "
                     f"{r['local_shapes']} are not the local ones "
                     f"{dense}, {grouped}")
        if r0["backend"] != "gloo":
            fail(f"serve_tp: backend {r0['backend']}, expected gloo")
        if not bool(torch.isfinite(r0["logits"]).all()) or d > cap:
            fail(f"serve_tp {cfg.name}: prefill logits differ from the "
                 f"single-process run's (relative L2 {d} > {cap})")
        for key in ("matmul@prefill", "matmul@decode",
                    "flash_attention@prefill", "expert_matmul@prefill"):
            totals[key] = [a + r["launches"][key] for a, r in
                           zip(totals.get(key, [0] * TP_RANKS), ranks)]
    if sorted(ref["arch"] for ref in tp_refs) != sorted(TP_SERVE):
        fail(f"serve_tp: served {[r['arch'] for r in tp_refs]}, expected "
             f"{list(TP_SERVE)}")
    return totals


# ---------------------------------------------------------------------------
# train_dp_f32 and train_dp: data-parallel, FSDP and tensor-parallel
# training, the ranks sharing cuda:0 over gloo.
# ---------------------------------------------------------------------------

DP_F32_LAYERS = 2
# (arch, (data, model)) of train_dp_f32, at DP_F32_LAYERS layers in f32
# (``_f32_depth``: zamba2-7b at 6): spawn A runs
# the (2, 2) cases, spawn B the (2, 1) case, then the (1, 2) one.
DP_F32 = [("qwen3-moe-30b-a3b", (2, 2)), ("zamba2-7b", (2, 2)),
          ("phi4-mini-3.8b", (2, 1)), ("mamba2-370m", (1, 2))]
DP_F32_B = 2                       # train_dp_f32's global batch: B x TRAIN_S
DP_NORM_REL_CAP = 1e-5             # train_dp_f32: the gradient norm's gap
DP_ARCH, DP_MESH = "qwen3-moe-30b-a3b", (2, 2)
DP_RESTORE_MESH = (1, 2)           # train_dp's checkpoint restores here
DP_B = 4                           # train_dp's global batch: B x TRAIN_S
DP_STEPS = 3
# train_dp's depth: the deepest (up to MOE_TRAIN_LAYERS) whose reckoned
# bytes a rank (bf16 params and grads, f32 moments, the FSDP-gathered
# weights of every layer, which live through the backward pass with remat
# off) stay under this: four ranks share the card's 80 GB with their CUDA
# contexts and activations.
DP_RANK_BUDGET = 10e9
# ... and whose checkpoint (whole bf16 params and f32 moments, 10 bytes a
# parameter) stays under this: it crosses host-staged gloo into one rank
# (0.2-0.8 GB/s a rank on an H100 host with four ranks sharing the card)
# and is read back whole by each restoring rank.
DP_CKPT_BUDGET = 15e9
DP_JOIN_TIMEOUT = 900.0
DP_DIR = ROOT / "build" / "train_dp"
# The collectives a rank times (``distributed/collectives.py``).
DP_COLLECTIVES = ("all_reduce_", "all_gather_dim", "reduce_scatter_dim")


def _dp_config(arch, layers, dtype):
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers,
                               dtype=dtype)


def _dp_f32_config(arch):
    return _dp_config(arch, _f32_depth(arch, DP_F32_LAYERS), "float32")


def _dp_batch(cfg, rows):
    from repro_torch.data import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_S,
                                  global_batch=rows)).batch_at(0)


def _dp_reference(torch, dev, arch, path):
    """train_dp_f32's yardstick, in this process before any rank starts:
    ``arch`` at its train_dp_f32 depth in f32, one step of the train step
    (no mesh) on the global batch, the loss, every gradient and every
    updated param written to ``path`` (read back memory-mapped by the
    ranks), and the leaves that are all zeros at init; everything freed
    after."""
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.nn.model import Model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_items
    cfg = _dp_f32_config(arch)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(5))
    zero_init = sorted(k for k, p in tree_items(params) if not p.any())
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    step = make_train_step(model, opt)
    t0 = time.perf_counter()
    loss, grads = step.loss_and_grads(params, _dp_batch(cfg, DP_F32_B))
    out = {"loss": torch.tensor(float(loss))}
    out.update({f"grads/{k}": g.cpu() for k, g in tree_items(grads)})
    state = TrainState(params=params, opt=opt.init(params), step=0)
    state, met = step.apply(state, loss, grads)
    del grads
    out.update({f"params/{k}": p.cpu() for k, p in tree_items(state.params)})
    out["grad_norm"] = torch.tensor(float(met["grad_norm"]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del state, params, met
    _free(torch)
    torch.save(out, path)
    return {"arch": arch, "loss": float(out["loss"]),
            "grad_norm": float(out["grad_norm"]), "zero_init": zero_init,
            "seconds": secs}


def _dp_join(rank, world, init_method, tp):
    """A spawned rank on cuda:0 over gloo with the (world // tp, tp)
    mesh installed; (dev, mesh)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import meshctx
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    dev = init_distributed(rank, world, init_method, device="cuda",
                           shared_card=True)
    mesh = make_local_mesh(tp, device_type="cuda")
    meshctx.set_mesh(mesh)
    return dev, mesh


def _dp_remesh(tp):
    from repro_torch import meshctx
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(tp, device_type="cuda")
    meshctx.set_mesh(mesh)
    return mesh


@contextlib.contextmanager
def _dp_instruments(kmm):
    """Inside: the host seconds, calls and bytes of each collective (the
    outermost call only: gloo's reduce-scatter is an ``all_reduce``), and
    the (M, N, K) of every dense and the (E, K, N) of every grouped GEMM
    launched in the "nn" layout (the forward products, their recompute)."""
    from repro_torch.distributed import collectives as coll
    stats = {k: {"calls": 0, "bytes": 0, "seconds": 0.0}
             for k in DP_COLLECTIVES}
    shapes = {"dense": set(), "grouped": set()}
    depth = [0]

    def timed(name, fn):
        def call(t, *rest, **kw):
            depth[0] += 1
            t1 = time.perf_counter()
            try:
                return fn(t, *rest, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    st = stats[name]
                    st["seconds"] += time.perf_counter() - t1
                    st["calls"] += 1
                    st["bytes"] += t.numel() * t.element_size()
        return call

    def recorded(kind, fn):
        def call(a, b, *rest, **kw):
            if not kw.get("trans_a") and not kw.get("trans_b"):
                shapes[kind].add((a.shape[0], b.shape[1], b.shape[0])
                                 if kind == "dense" else tuple(b.shape))
            return fn(a, b, *rest, **kw)
        return call

    with contextlib.ExitStack() as stack:
        for name in DP_COLLECTIVES:
            real = getattr(coll, name)
            wrapped = timed(name, real)
            # every module of the port that bound the function by name
            for mod in [m for k, m in list(sys.modules.items())
                        if k.startswith("repro_torch")]:
                if getattr(mod, name, None) is real:
                    stack.enter_context(mock.patch.object(mod, name,
                                                          wrapped))
        stack.enter_context(mock.patch.object(
            kmm, "_launch_cuda", recorded("dense", kmm._launch_cuda)))
        stack.enter_context(mock.patch.object(
            kmm, "_launch_expert_cuda",
            recorded("grouped", kmm._launch_expert_cuda)))
        yield stats, shapes


def _dp_rel(torch, tree, ref, prefix, mesh, rank, specs, dev):
    """({leaf: relative L2 of the whole leaf against ``ref[prefix +
    leaf]``}, {leaf: elements whose sign differs from the reference's}),
    each rank comparing its own block and the sums added over the axes the
    leaf is sharded on (a replicated leaf counted once)."""
    from repro_torch.distributed.collectives import all_reduce_
    from repro_torch.distributed.sharding import local_index, spec_axes
    from repro_torch.optim.adamw import tree_items
    flat = dict(tree_items(specs))
    sums, groups = {}, {}
    for path, t in tree_items(tree):
        w = ref[prefix + path]
        want = w[local_index(tuple(w.shape), flat[path], mesh, rank)]
        want = want.to(dev, torch.float64)
        got = t.detach().to(torch.float64)
        sums[path] = torch.stack([(got - want).square().sum(),
                                  want.square().sum(),
                                  (got.sign() != want.sign()).sum()
                                  .to(torch.float64)])
        axes = tuple(a for a in spec_axes(flat[path]) if mesh.shape[a] > 1)
        groups.setdefault(axes, []).append(path)
    out, flips = {}, {}
    for axes, paths in sorted(groups.items()):
        block = torch.stack([sums[p] for p in paths])
        for a in axes:
            block = all_reduce_(block, mesh.group(a))
        for p, (d2, r2, f) in zip(paths, block.tolist()):
            out[p] = math.sqrt(d2 / r2) if r2 > 0 else math.sqrt(d2)
            flips[p] = int(f)
    return out, flips


def _dp_f32_case(rank, dev, mesh, arch, ref_path):
    """One train_dp_f32 case on this rank: its shards (``init_shards``,
    seed 5, f32) and rows of the global batch, one step's loss and
    gradients (launches counted, GEMM shapes and collectives recorded) and
    the in-place commit; every gradient and updated param, block by block,
    against the one-process step's."""
    import torch
    from repro_torch.distributed.sharding import local_batch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.nn.model import Model
    from repro_torch.optim import AdamW
    cfg = _dp_f32_config(arch)
    model = Model(cfg, device=dev)
    params = model.init_shards(torch.Generator(device=dev).manual_seed(5),
                               mesh, rank)
    batch = local_batch(_dp_batch(cfg, DP_F32_B), mesh, rank)
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    _zero_counts(kmm, kfa)
    t0 = time.perf_counter()
    with _dp_instruments(kmm) as (coll, shapes):
        loss, grads = step.loss_and_grads(params, batch)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_counts(kmm, kfa)
    ref = torch.load(ref_path, mmap=True)
    rel_g, flips = _dp_rel(torch, grads, ref, "grads/", mesh, rank,
                           step.specs, dev)
    state = TrainState(params=params, opt=opt.init(params), step=0)
    state, met = step.apply(state, loss, grads)
    rel_p, _ = _dp_rel(torch, state.params, ref, "params/", mesh, rank,
                       step.specs, dev)
    out = {"arch": arch, "mesh": dict(mesh.shape), "rank": rank,
           "loss": float(loss), "ref_loss": float(ref["loss"]),
           "grad_norm": float(met["grad_norm"]),
           "ref_grad_norm": float(ref["grad_norm"]),
           "grad_rel_l2": rel_g, "param_rel_l2": rel_p,
           "grad_sign_flips": flips,
           "launches": launches,
           "local_shapes": {k: sorted(v) for k, v in shapes.items()},
           "collectives": coll, "step_s": secs,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    del ref, state, grads, params
    torch.cuda.empty_cache()
    return out


def _sha(t) -> str:
    """The sha256 of a tensor's raw bytes on the host (bf16 as its
    bits)."""
    import hashlib
    import numpy as np
    from repro_torch.checkpoint.checkpoint import _to_numpy
    return hashlib.sha256(np.ascontiguousarray(_to_numpy(t)[0]).tobytes()
                          ).hexdigest()


def _dp_state_specs(model, mesh):
    from repro_torch.distributed.sharding import opt_shardings, tp_shardings
    from repro_torch.launch.steps import TrainState
    specs = tp_shardings(model, mesh)
    return TrainState(params=specs, opt=opt_shardings(specs), step=())


def _dp_train_case(rank, dev, mesh, layers, ckpt_dir):
    """train_dp on this rank: qwen3-moe at ``layers`` layers in bf16, its
    shards (seed 0), DP_STEPS steps (AdamW lr 1e-3, no decay) on its rows
    of one repeated global batch of DP_B x TRAIN_S tokens, each step timed
    between synchronisations, launches and collectives counted; the loss
    after the last step; then the state saved with its shardings and each
    leaf's shard hashed (the restore on another mesh is held to these)."""
    import torch
    import torch.distributed as dist
    from repro_torch import checkpoint as ckpt
    from repro_torch.checkpoint.checkpoint import _items
    from repro_torch.distributed.collectives import data_mean
    from repro_torch import meshctx
    from repro_torch.distributed.sharding import local_batch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.nn.model import Model
    from repro_torch.optim import AdamW
    cfg = _dp_config(DP_ARCH, layers, "bfloat16")
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init_shards(torch.Generator(device=dev).manual_seed(0),
                               mesh, rank)
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    state = TrainState(params=params, opt=opt.init(params), step=0)
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = local_batch(_dp_batch(cfg, DP_B), mesh, rank)
    losses, norms, ms = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts(kmm, kfa)
    wall0 = time.perf_counter()
    with _dp_instruments(kmm) as (coll, shapes):
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss, grads = step.loss_and_grads(state.params, batch)
            state, met = step.apply(state, loss, grads)
            del grads
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - wall0
    launches = _read_counts(kmm, kfa)
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        tokens = torch.from_numpy(batch["tokens"]).to(dev).long()
        final = model.loss(state.params, {"tokens": tokens})
        final = float(data_mean(final, meshctx.data_axis().group,
                                meshctx.data_axis().size))
    t1 = time.perf_counter()
    ckpt.save(str(ckpt_dir), DP_STEPS, state, extra_meta={"arch": cfg.name},
              shardings=_dp_state_specs(model, mesh), mesh=mesh)
    save_s = time.perf_counter() - t1
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=2) as pool:
        hashes = {k: pool.submit(_sha, v.cpu()) for k, v in _items(state)
                  if not isinstance(v, int)}
        hashes = {k: f.result() for k, f in hashes.items()}
    out = {"rank": rank, "layers": layers, "init_s": init_s,
           "losses": losses, "loss_after_last_step": final,
           "grad_norms": norms, "ms_per_step": ms, "wall_s": wall,
           "launches": launches, "collectives": coll,
           "local_shapes": {k: sorted(v) for k, v in shapes.items()},
           "peak_mem_bytes": peak, "save_s": save_s, "shard_sha": hashes,
           "count": state.opt.count,
           "param_bytes": sum(t.numel() * t.element_size()
                              for _, t in _items(state.params))}
    del state
    dist.barrier()
    torch.cuda.empty_cache()
    return out


def _dp_restore_case(rank, dev, mesh, layers, ckpt_dir):
    """The train_dp checkpoint restored on this mesh (``restore`` with the
    shardings: this rank's blocks), and the hash of each train_dp mesh
    block that lies inside this rank's block of a leaf (every such block
    lies inside some rank's: the restore mesh splits only on "model")."""
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.checkpoint.checkpoint import _items
    from repro_torch.distributed.sharding import local_index
    from repro_torch.launch.steps import TrainState
    from repro_torch.nn.model import Model
    from repro_torch.optim import AdamW
    cfg = _dp_config(DP_ARCH, layers, "bfloat16")
    model = Model(cfg, device=dev)
    params = model.abstract_params()
    template = TrainState(params=params, opt=AdamW().init(params), step=0)
    sh = _dp_state_specs(model, mesh)
    t0 = time.perf_counter()
    step, state = ckpt.restore(str(ckpt_dir), template, device=dev,
                               shardings=sh, mesh=mesh, rank=rank)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    old = _shape_mesh(DP_MESH)
    old_specs = dict(_items(_dp_state_specs(model, old), specs=True))
    specs = dict(_items(sh, specs=True))
    from concurrent.futures import ThreadPoolExecutor
    whole = dict(_items(template))
    hashes = {}
    with ThreadPoolExecutor(max_workers=4) as pool:
        for key, leaf in _items(state):
            if isinstance(leaf, int):
                continue
            shape = tuple(whole[key].shape)
            mine = local_index(shape, specs[key], mesh, rank)
            for r in range(DP_MESH[0] * DP_MESH[1]):
                blk = local_index(shape, old_specs[key], old, r)
                if all(m.start <= b.start and b.stop <= m.stop
                       for b, m in zip(blk, mine)):
                    rel = tuple(slice(b.start - m.start, b.stop - m.start)
                                for b, m in zip(blk, mine))
                    hashes.setdefault(key, {})[r] = pool.submit(
                        _sha, leaf[rel].cpu())
    hashes = {k: {r: f.result() for r, f in v.items()}
              for k, v in hashes.items()}
    out = {"rank": rank, "step": step, "count": state.opt.count,
           "restore_s": restore_s, "block_sha": hashes,
           "hash_s": time.perf_counter() - t0 - restore_s,
           "local_wq": tuple(state.params["layers"]["attn"]["wq"].shape)}
    del state
    torch.cuda.empty_cache()
    return out


def _shape_mesh(shape):
    """A shape-only mesh of (data, model) = ``shape``."""
    import types
    return types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]})


def _dp_rank_a(rank, world, init_method, ref_paths, layers, ckpt_dir):
    """Spawn A, 4 ranks on (2, 2): train_dp_f32's qwen3-moe and zamba2
    cases, then train_dp with its checkpoint."""
    dev, mesh = _dp_join(rank, world, init_method, DP_MESH[1])
    f32 = [_dp_f32_case(rank, dev, mesh, DP_F32[i][0], ref_paths[i])
           for i in (0, 1)]
    return {"f32": f32, "train": _dp_train_case(rank, dev, mesh, layers,
                                                 ckpt_dir)}


def _dp_rank_b(rank, world, init_method, ref_paths, layers, ckpt_dir):
    """Spawn B, 2 ranks: train_dp_f32's phi4-mini case on (2, 1), its
    mamba2 case on (1, 2), then train_dp's checkpoint restored on
    (1, 2)."""
    dev, mesh = _dp_join(rank, world, init_method, DP_F32[2][1][1])
    f32 = [_dp_f32_case(rank, dev, mesh, DP_F32[2][0], ref_paths[2])]
    mesh = _dp_remesh(DP_RESTORE_MESH[1])
    f32.append(_dp_f32_case(rank, dev, mesh, DP_F32[3][0], ref_paths[3]))
    return {"f32": f32, "restore": _dp_restore_case(rank, dev, mesh, layers,
                                                     ckpt_dir)}


def dp_reckoning(layers):
    """train_dp's bytes a rank at ``layers`` layers on DP_MESH (the rank
    with the most): bf16 params and grads and f32 moments of its shards,
    and the FSDP-gathered bf16 weights of every layer (the model axis's
    block, whole over data)."""
    from repro_torch.distributed.sharding import (local_index,
                                                  tp_shardings)
    from repro_torch.nn.model import Model
    from repro_torch.optim.adamw import tree_items
    cfg = _dp_config(DP_ARCH, layers, "bfloat16")
    model = Model(cfg, device="cpu")
    mesh = _shape_mesh(DP_MESH)
    specs = dict(tree_items(tp_shardings(model, mesh)))
    nmodel = _shape_mesh((1, DP_MESH[1]))
    mspecs = dict(tree_items(tp_shardings(model, nmodel)))
    best = None
    for rank in range(DP_MESH[0] * DP_MESH[1]):
        state = gathered = 0
        for path, a in tree_items(model.abstract_params()):
            idx = local_index(tuple(a.shape), specs[path], mesh, rank)
            n = math.prod(s.stop - s.start for s in idx)
            state += n * (2 + 2 + 8)
            if path.startswith("layers/") and "data" in str(specs[path]):
                midx = local_index(tuple(a.shape), mspecs[path], nmodel,
                                   rank % DP_MESH[1])
                gathered += 2 * math.prod(s.stop - s.start for s in midx)
        row = {"layers": layers, "state_bytes": state,
               "gathered_bytes": gathered, "total": state + gathered}
        best = row if best is None or row["total"] > best["total"] else best
    best["checkpoint_bytes"] = 10 * sum(
        a.numel() for _, a in tree_items(model.abstract_params()))
    return best


def train_dp_phases(torch, dev, kmm, kfa):
    """train_dp_f32 and train_dp (module docstring): the one-process f32
    references first, each freed; then spawn A (4 ranks, (2, 2)) and spawn
    B (2 ranks, (2, 1) then (1, 2)).  Returns train_dp's launches per rank
    keyed by the kernels line's rows."""
    from repro_torch.launch.mesh import spawn_ranks
    _free(torch)
    if DP_DIR.exists():
        shutil.rmtree(DP_DIR)
    DP_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    refs = [DP_DIR / f"ref_{i}.pt" for i in range(len(DP_F32))]
    ref_rows = [_dp_reference(torch, dev, arch, path)
                for (arch, _), path in zip(DP_F32, refs)]
    ref_s = time.perf_counter() - t0
    reckoning = [dp_reckoning(n) for n in range(1, MOE_TRAIN_LAYERS + 1)]
    fits = [r["layers"] for r in reckoning if r["total"] <= DP_RANK_BUDGET
            and r["checkpoint_bytes"] <= DP_CKPT_BUDGET]
    if not fits:
        fail(f"train_dp: no depth fits {DP_RANK_BUDGET} bytes a rank and a "
             f"checkpoint of {DP_CKPT_BUDGET}: {reckoning}")
    layers = max(fits)
    emit({"phase": "train_dp_reckoning", "arch": DP_ARCH,
          "mesh": list(DP_MESH), "budget_bytes_per_rank": DP_RANK_BUDGET,
          "budget_checkpoint_bytes": DP_CKPT_BUDGET,
          "per_rank": reckoning, "layers": layers})
    ckpt_dir = DP_DIR / "ckpt"
    t1 = time.perf_counter()
    paths = [str(p) for p in refs]
    a = spawn_ranks(_dp_rank_a, DP_MESH[0] * DP_MESH[1],
                    (paths, layers, str(ckpt_dir)), timeout=DP_JOIN_TIMEOUT)
    t2 = time.perf_counter()
    b = spawn_ranks(_dp_rank_b, 2, (paths, layers, str(ckpt_dir)),
                    timeout=DP_JOIN_TIMEOUT)
    walls = {"references_s": ref_s, "spawn_a_s": t2 - t1,
             "spawn_b_s": time.perf_counter() - t2,
             "total_s": time.perf_counter() - t0}
    shutil.rmtree(DP_DIR)
    _dp_f32_report(torch, [a, b], ref_rows)
    return _dp_train_report(a, b, layers, walls)


def _dp_f32_report(torch, spawns, ref_rows):
    """train_dp_f32's row and checks: each case's every gradient leaf
    within GRADS_F32_REL_CAP, and every updated param leaf too but those
    all zeros at init; the loss within 1e-5 relative and the global
    gradient norm (the clip's input, taken over the shards) within
    DP_NORM_REL_CAP of the one-process step's; every
    rank's launches equal to the reckoning and its GEMMs at the local
    shapes.  AdamW's first step divides every element by its own size
    (m / sqrt(v) = g / (|g| + eps)), so each element's relative error
    passes into the update in full, where the gradient's relative L2
    weights it by its size; a zero-initialised leaf is that update alone
    (the SSM conv biases: conv_xb's 1.88e-4 with every gradient within
    2.08e-5, PERF.md section 6).  Such a leaf's gradient stays gated; its
    param is reported beside each leaf's gradient elements of the other
    sign."""
    rows, bad = [], []
    # each spawn's cases in DP_F32's order, each a list of the ranks' rows
    cases = [[r["f32"][j] for r in ranks] for ranks in spawns
             for j in range(len(ranks[0]["f32"]))]
    for ranks, ref, (arch, (data, model)) in zip(cases, ref_rows, DP_F32):
        cfg = _dp_f32_config(arch)
        want = _train_reckoning(cfg)
        expected = {k: sum(want[part].get(k, 0) for part in want)
                    for k in ranks[0]["launches"]}
        dense, grouped = _tp_local_shapes(cfg, model)
        rows_local = DP_F32_B // data * TRAIN_S
        r0 = ranks[0]
        worst_g = max(r0["grad_rel_l2"].values())
        gated = {k: v for k, v in r0["param_rel_l2"].items()
                 if k not in ref["zero_init"]}
        worst_leaf = max(gated, key=gated.get)
        worst_p = gated[worst_leaf]
        d_loss = abs(r0["loss"] - ref["loss"])
        d_norm = abs(r0["grad_norm"] - ref["grad_norm"])
        row = {"arch": arch, "layers": cfg.num_layers, "mesh": [data, model],
               "batch": [DP_F32_B, TRAIN_S], "loss": r0["loss"],
               "loss_one_process": ref["loss"], "loss_abs_diff": d_loss,
               "grad_norm": r0["grad_norm"],
               "grad_norm_one_process": ref["grad_norm"],
               "worst_grad_rel_l2": worst_g, "worst_param_rel_l2": worst_p,
               "worst_param_leaf": worst_leaf,
               "params_not_gated": {k: r0["param_rel_l2"][k]
                                    for k in ref["zero_init"]},
               "grad_rel_l2": r0["grad_rel_l2"],
               "param_rel_l2": r0["param_rel_l2"],
               "grad_sign_flips": {k: v for k, v in
                                   r0["grad_sign_flips"].items() if v},
               "expected_launches": expected,
               "launches_per_rank": [r["launches"] for r in ranks],
               "local_shapes": r0["local_shapes"],
               "expected_local_nk": {"dense": dense, "grouped": grouped},
               "dense_rows": rows_local,
               "step_s_per_rank": [r["step_s"] for r in ranks],
               "collectives_rank0": r0["collectives"],
               "peak_gb_per_rank": [r["peak_mem_bytes"] / 1e9
                                    for r in ranks],
               "one_process_s": ref["seconds"]}
        rows.append(row)
        if not worst_g <= GRADS_F32_REL_CAP \
                or not worst_p <= GRADS_F32_REL_CAP:
            bad.append(f"{arch}: a leaf off by {worst_g} (grads), "
                       f"{worst_p} (params, {worst_leaf})")
        if not d_loss <= 1e-5 * abs(ref["loss"]):
            bad.append(f"{arch}: loss {r0['loss']} vs {ref['loss']}")
        if not d_norm <= DP_NORM_REL_CAP * ref["grad_norm"]:
            bad.append(f"{arch}: gradient norm {r0['grad_norm']} vs "
                       f"{ref['grad_norm']}")
        for f in ranks:
            if f["launches"] != expected:
                bad.append(f"{arch} rank {f['rank']}: launches "
                           f"{f['launches']} differ from {expected}")
            got_dense = sorted({(n, k) for _, n, k in
                                f["local_shapes"]["dense"]})
            got_rows = {m for m, _, _ in f["local_shapes"]["dense"]}
            got_grouped = sorted({(e, k, n) for e, k, n in
                                  f["local_shapes"]["grouped"]})
            if got_dense != dense or got_grouped != grouped \
                    or got_rows != {rows_local}:
                bad.append(f"{arch} rank {f['rank']}: GEMMs at "
                           f"{f['local_shapes']}, expected (N, K) {dense}, "
                           f"grouped {grouped}, M {rows_local}")
    emit({"phase": "train_dp_f32", "backend": "gloo",
          "device": "cuda:0 shared", "cases": rows,
          "tolerance": f"each leaf (gradients; updated params but those "
                       f"zero at init) <= {GRADS_F32_REL_CAP} relative L2, "
                       f"loss <= 1e-5 relative, gradient norm <= "
                       f"{DP_NORM_REL_CAP} relative, against the "
                       f"one-process step"})
    if bad:
        fail(f"train_dp_f32: {bad}")


def _dp_train_report(a, b, layers, walls):
    """train_dp's row and checks: the loss falls, the norms are finite,
    the launches equal the reckoning a step, and every leaf of the
    restored state comes back bit for bit (the blocks of the train mesh
    hashed after the restore on the other mesh equal the shards' own
    hashes)."""
    cfg = _dp_config(DP_ARCH, layers, "bfloat16")
    want = _train_reckoning(cfg)
    per_step = {k: sum(want[part].get(k, 0) for part in want)
                for k in a[0]["train"]["launches"]}
    expected = {k: v * DP_STEPS for k, v in per_step.items()}
    r0 = a[0]["train"]
    steady = r0["ms_per_step"][1:]
    step_ms = max(sum(r["train"]["ms_per_step"][1:]) / len(steady)
                  for r in a)
    tokens = DP_B * TRAIN_S
    shards = {}
    for r in a:
        for key, h in r["train"]["shard_sha"].items():
            shards.setdefault(key, [None] * len(a))[r["train"]["rank"]] = h
    blocks = {}
    for r in b:
        for key, h in r["restore"]["block_sha"].items():
            blocks.setdefault(key, {}).update(h)
    bitwise = sorted(shards) == sorted(blocks) and all(
        [blocks[k].get(r) for r in range(len(a))] == shards[k]
        for k in shards)
    colls = []
    for r in a:
        t = r["train"]
        colls.append({k: {**v, "share_of_wall": v["seconds"] / t["wall_s"]}
                      for k, v in t["collectives"].items()})
    row = {"phase": "train_dp", "arch": cfg.name, "layers": layers,
           "mesh": list(DP_MESH), "backend": "gloo",
           "device": "cuda:0 shared", "collectives": "gloo, host-staged",
           "batch": [DP_B, TRAIN_S], "steps": DP_STEPS,
           "losses": r0["losses"],
           "loss_after_last_step": r0["loss_after_last_step"],
           "grad_norms": r0["grad_norms"],
           "ms_per_step_per_rank": [r["train"]["ms_per_step"] for r in a],
           "ms_per_step_after_first": step_ms,
           "global_tokens_per_s": tokens / (step_ms / 1e3),
           "peak_gb_per_rank": [r["train"]["peak_mem_bytes"] / 1e9
                                for r in a],
           "state_param_bytes_per_rank": [r["train"]["param_bytes"]
                                          for r in a],
           "reckoned_bytes_per_rank": dp_reckoning(layers),
           "init_s_per_rank": [r["train"]["init_s"] for r in a],
           "steps_wall_s_per_rank": [r["train"]["wall_s"] for r in a],
           "collectives_per_rank": colls,
           "expected_launches": expected,
           "launches_per_rank": [r["train"]["launches"] for r in a],
           "local_shapes_rank0": r0["local_shapes"],
           "checkpoint": {"saved_on": list(DP_MESH),
                          "restored_on": list(DP_RESTORE_MESH),
                          "save_s": r0["save_s"],
                          "restore_s": [r["restore"]["restore_s"]
                                        for r in b],
                          "hash_s_after_restore": [r["restore"]["hash_s"]
                                                   for r in b],
                          "leaves": len(shards), "bitwise": bitwise,
                          "step": b[0]["restore"]["step"],
                          "count": b[0]["restore"]["count"],
                          "restored_local_wq": b[0]["restore"]["local_wq"]},
           "phase_walls": walls}
    emit(row)
    for r in a:
        if r["train"]["launches"] != expected:
            fail(f"train_dp rank {r['train']['rank']}: launches "
                 f"{r['train']['launches']} differ from the reckoning "
                 f"{expected}")
    losses = r0["losses"]
    if not all(math.isfinite(x) for x in losses + r0["grad_norms"]) \
            or not r0["loss_after_last_step"] < losses[0]:
        fail(f"train_dp: the loss did not fall ({losses} -> "
             f"{r0['loss_after_last_step']}) or a norm is not finite")
    if not bitwise or b[0]["restore"]["step"] != DP_STEPS \
            or b[0]["restore"]["count"] != DP_STEPS:
        fail("train_dp: the state restored on (1, 2) differs from the one "
             "saved on (2, 2)")
    keys = {"matmul@train_dgrad": "nt", "matmul@train_wgrad": "tn",
            "flash_attention@train": "flash",
            "flash_attention_bwd@train": "flash_bwd",
            "expert_matmul_bwd@train_moe_dgrad": "expert_nt",
            "expert_matmul_bwd@train_moe_wgrad": "expert_tn",
            "epilogue_bwd_grouped@train_moe": "epilogue_bwd_grouped"}
    return {row: [r["train"]["launches"][k] for r in a]
            for row, k in keys.items()}


def window_times_phase(torch, dev, kfa):
    """The windowed kernels at mixtral's prefill shape, each beside the
    causal kernel at the same shape, its plain version and the library: the
    bf16 and f32 forwards beside the library's attention with the window as
    a boolean mask (and the bf16 causal kernel beside the library's causal
    attention), the bf16 and f32 backwards (from the plain forward's o and
    lse) beside the library's backward of that masked attention, its
    kernels' device time (``device_ms``): its forward and backward less its
    forward.  The bounds count the (query, key) pairs this window leaves
    visible: the forward 4 pairs d H flop, the backward 10 (S recomputed,
    then dP, dV, dQ, dK), at the bf16 peak or, in f32, a third of the
    TF32 peak (three TF32 products a product); bytes each input read once
    and each output written once."""
    import dataclasses
    import torch.nn.functional as F
    B, H, Hkv, S, d, w = MIXTRAL_SHAPE
    i = torch.arange(S, device=dev)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)
    pairs = int(mask.sum())
    counts = (kfa.flash_attention_kernel.launches,
              kfa.flash_attention_bwd_kernel.launches)
    rows, times = [], {}
    for dtype in ("bfloat16", "float32"):
        q, k, v = _attn_inputs(torch, dev, B, H, Hkv, S, True, seed=17, d=d,
                               dtype=dtype)
        do = _attn_inputs(torch, dev, B, H, Hkv, S, False, seed=18, d=d,
                          dtype=dtype)[0]
        f32 = dtype == "float32"
        elem, peak = q.element_size(), TF32X3_PEAK if f32 else BF16_PEAK
        plan = kfa.plan_attention(S, S, d, batch=B, heads=H, kv_heads=Hkv,
                                  causal=True, window=w)
        causal = kfa.plan_attention(S, S, d, batch=B, heads=H, kv_heads=Hkv,
                                    causal=True)
        qkv = elem * d * S * B * (H + 2 * Hkv)
        # The forward: q, k, v read, o written.
        row = {"kernel": "flash_attention", "dtype": dtype, "window": w,
               "q": [B, H, S, d], "kv": [B, Hkv, S, d],
               "visible_pairs": pairs,
               "ms": time_ms(lambda: kfa._launch_cuda(
                   q, k, v, block_q=plan.block_q, block_kv=plan.block_kv,
                   causal=True, scale=None, window=w)),
               "causal_ms": time_ms(lambda: kfa._launch_cuda(
                   q, k, v, block_q=causal.block_q,
                   block_kv=causal.block_kv, causal=True, scale=None)),
               "plain_ms": event_ms(torch, lambda: kfa.attention_plain(
                   q, k, v, block_q=64, block_kv=64, causal=True, window=w)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, enable_gqa=True))}
        if f32:
            row["plan"] = dataclasses.asdict(kfa.plan_attention_f32(
                S, d, batch=B, heads=H))
        else:
            row.update({
                "blocks": [plan.block_q, plan.block_kv], "ctas": plan.ctas,
                "max_steps": plan.max_steps,
                "model_ms": plan.predicted * 1e3,
                "causal_blocks": [causal.block_q, causal.block_kv],
                "causal_model_ms": causal.predicted * 1e3,
                # C11: the library's causal attention beside the causal
                # kernel (no window: no library call takes one but a mask)
                "causal_library_ms": time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True))})
        row["bound_ms"], row["bound_by"] = _bound(
            qkv + elem * d * S * B * H, 4.0 * B * H * pairs * d, peak)
        rows.append(row)
        times[WINDOW_ROWS[dtype, True]] = row
        # The backward: q, k, v, o, dO and lse read, dq, dk, dv written.
        o, lse = kfa.attention_plain(q, k, v, block_q=64, block_kv=64,
                                     causal=True, return_lse=True, window=w)
        row = {"kernel": "flash_attention_bwd", "dtype": dtype, "window": w,
               "q": [B, H, S, d], "kv": [B, Hkv, S, d],
               "visible_pairs": pairs,
               "plan": dataclasses.asdict(kfa.plan_attention_bwd(
                   S, S, d, batch=B, heads=H, kv_heads=Hkv,
                   in_dtype=dtype)),
               "ms": time_ms(lambda: kfa._launch_bwd_cuda(
                   q, k, v, o, lse, do, causal=True, scale=None, window=w)),
               "causal_ms": time_ms(lambda: kfa._launch_bwd_cuda(
                   q, k, v, o, lse, do, causal=True, scale=None)),
               "plain_ms": event_ms(torch, lambda: kfa.attention_bwd_plain(
                   q, k, v, o, lse, do, causal=True, window=w)),
               "library_ms": backward_ms(
                   torch, lambda a, b, c: F.scaled_dot_product_attention(
                       a, b, c, attn_mask=mask, enable_gqa=True),
                   (q, k, v), do)}
        row["bound_ms"], row["bound_by"] = _bound(
            2 * qkv + 2 * elem * d * S * B * H + 4 * B * H * S,
            10.0 * B * H * pairs * d, peak)
        rows.append(row)
        times[WINDOW_ROWS[dtype, False]] = row
        del q, k, v, do, o, lse
        _free(torch)
    (kfa.flash_attention_kernel.launches,
     kfa.flash_attention_bwd_kernel.launches) = counts   # timing launches
    emit({"phase": "window_times", "timing": "kernels and the library "
          "(its backward alone, backward_ms): CUDA graph of 10 calls, "
          "median of 5 replays; plain: CUDA events over 5 calls, median "
          "of 3",
          "rows": rows})
    return {key: {k_: row[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")}
            for key, row in times.items()}


# ---------------------------------------------------------------------------
# dryrun: the port's dry-run (``launch/dryrun.py``) beside the card.
# ---------------------------------------------------------------------------

DRYRUN_MESH = {"data": 1, "model": 1}
DRYRUN_ARCH = "phi4-mini-3.8b"


def _layer_gemm_flops(cfg, tokens):
    """The FLOPs of one dense swiglu layer's forward GEMMs at ``tokens``
    rows: wq, wk, wv, wo and wu, wg, wd (2·M·N·K each)."""
    D, hd, F = cfg.d_model, cfg.head_dim, cfg.d_ff
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return 2 * tokens * (D * q + 2 * D * kv + q * D + 3 * D * F)


def _dry_reckoning(cfg, kind, tokens):
    """(GEMM calls by layout, GEMM FLOPs) of one step of a dense swiglu
    model, reckoned from the code: a train step is ``_train_reckoning``'s
    launches, its FLOPs the forward, the remat recompute, dX and dW of
    every product (each the product's FLOPs) and each MLP's swiglu
    pre-activation once more (wg's); a decode step ``_zoo_launches``', the
    forward's FLOPs."""
    L, fwd = cfg.num_layers, _layer_gemm_flops(cfg, tokens)
    if kind == "train":
        want = _train_reckoning(cfg)
        calls = {k: sum(want[part].get(k, 0) for part in want)
                 for k in ("nn", "nt", "tn")}
        wg = 2 * tokens * cfg.d_model * cfg.d_ff
        return calls, L * ((4 if cfg.remat else 3) * fwd + wg)
    return ({"nn": _zoo_launches(cfg)[1]["matmul"], "nt": 0, "tn": 0},
            L * fwd)


def dryrun_phase():
    """The port's dry-run on a (1, 1) mesh, on the host (meta tensors, no
    kernel), at the train phase's phi4-mini cell (B 4 x S 512) and at the
    serve phase's decode step (batch 4, the cache at prompt + generated
    length): the estimated GB beside the measured peak, the counted FLOPs
    beside ``model_flops``, ``roofline_s`` beside the measured ms a step.
    Fails only if the dry-run raises or its GEMM calls or GEMM FLOPs differ
    from the reckoning of the launches the train and serve phases
    check."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.nn.config import ShapeSpec
    cfg = get_config(DRYRUN_ARCH)
    serve = MEASURED["serve"]
    cells = [("train", ShapeSpec("train_b4_s512", "train", TRAIN_S, TRAIN_B),
              MEASURED["train"]["peak_mem_bytes"],
              MEASURED["train"]["ms_per_step_mean_after_first"]),
             ("decode", ShapeSpec("decode_b4", "decode", serve["max_len"],
                                  serve["batch"]),
              serve["peak_mem_bytes"], serve["decode_ms_per_step"])]
    rows, bad = [], []
    for kind, shape, peak, ms in cells:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(DRYRUN_ARCH, shape.name, False, out_dir=None,
                              verbose=False, mesh_shape=DRYRUN_MESH,
                              shape=shape)
        cost, roof = rec["cost_module"], rec["roofline"]
        tokens = shape.global_batch * (shape.seq_len if kind == "train"
                                       else 1)
        calls, flops = _dry_reckoning(cfg, kind, tokens)
        row = {"cell": shape.name, "kind": kind, "mesh": DRYRUN_MESH,
               "batch": shape.global_batch, "seq_len": shape.seq_len,
               "estimated_gb": rec["memory_analytic_gib"]["total_gib"]
               * 2**30 / 1e9,
               "estimate_gib": rec["memory_analytic_gib"],
               "measured_peak_gb": peak / 1e9,
               "counted_flops": cost["flops"],
               "model_flops": roof["model_flops"],
               "gemm_flops": cost["gemm_flops"],
               "gemm_flops_reckoned": flops,
               "gemm_calls": cost["gemm_calls"], "gemm_calls_reckoned": calls,
               "hbm_bytes_analytic": rec["hbm_bytes_analytic"]["total"],
               "roofline_ms": roof["roofline_s"] * 1e3,
               "roofline_bound": roof["bottleneck"],
               "measured_ms_per_step": ms,
               "dry_step_s": time.perf_counter() - t0}
        rows.append(row)
        if cost["gemm_calls"] != calls or cost["gemm_flops"] != flops:
            bad.append(f"{kind}: GEMM calls {cost['gemm_calls']} and FLOPs "
                       f"{cost['gemm_flops']} against the reckoning "
                       f"{calls}, {flops}")
    emit({"phase": "dryrun", "arch": DRYRUN_ARCH,
          "topology": "gpu_h100_like", "rows": rows,
          "note": "the dry-run counts on the host; the measured numbers are "
                  "the train and serve phases' on this card"})
    if bad:
        fail(f"dryrun: {bad}")


def _bound(nbytes, flops, peak):
    """(the least ms the card could take, what bounds it): the bytes at
    HBM_BW or the flops at ``peak``, whichever is longer."""
    t_b, t_f = nbytes / HBM_BW, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


if __name__ == "__main__":
    sys.exit(main())
