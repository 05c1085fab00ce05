"""Serving driver of the port: continuous-batching engine over ragged or
uniform requests, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --batch 4 --prompt-len 512 --gen 16 --ragged --requests 8

    # the same path on the CPU at smoke size (plain PyTorch versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --smoke --device cpu

    # the MoE family (qwen3-moe-30b-a3b: 61 GB of bf16 weights on the card)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-30b-a3b --batch 4 --prompt-len 512 --gen 16 \\
        --ragged --requests 8

    # the SSM and hybrid families (mamba2-370m, zamba2-7b: 13.5 GB)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --batch 4 --prompt-len 512 --gen 16 --ragged --requests 8

    # the audio and vlm families, each request with its frontend inputs
    # (musicgen-large 4.9 GB; llava-next-mistral-7b 14.5 GB, each prompt its
    # 2,880-position image ahead of the text)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llava-next-mistral-7b --batch 4 --prompt-len 512 --gen 16 \\
        --ragged --requests 8

Requests flow through :class:`repro_torch.launch.engine.ServingEngine`;
ragged lengths are right-padded to the edges of a model-priced
:class:`~repro_torch.core.bucketing.BucketPlan`, every bucket edge's step
GEMMs are warm-selected in one batched call, and on the card every layer
projection runs the hand-written Hopper GEMM and prefill attention the
hand-written flash kernel; an MoE layer's expert GEMMs run the grouped
Hopper GEMM, one launch for all experts.  As in the reference, the bucket
plan prices every family's step with ``step_gemms`` (a d_model-wide q
projection and a d_ff MLP), and MoE prompts are admitted into buckets: pad
tokens raise the token count and so the expert capacity.  The SSM and
hybrid families get no plan (a recurrent state would integrate the pad):
their prompts prefill at exact length.  A model with a frontend (audio,
vision) gets synthetic frontend inputs a request, at that request's own
length (:func:`request_queue`; the reference draws them once at
--prompt-len, ROADMAP's caveat on ragged extras), and the engine pads a
request's frame embeddings to its bucket edge.  ``--topology``
loads a calibrated-topology artifact through the guarded loader (corrupt
artifacts quarantine, serving continues on the stock preset);
``--residual`` installs a residual corrector, loaded guarded against the
topology actually served; ``--trace-dir`` writes the run's telemetry.
``run_serving`` is the library entry point; ``main`` is the CLI shim.

``--tp N`` serves over a (data 1, model N) mesh (the reference's
``--tp``, ``repro/launch/serve.py:75, 249-251``): N ranks, each its own
process, each holding its shards of the weights (``init_sharded``: the
single-process weights' slices, from the same seed), run the same engine
in lockstep; only rank 0 prints, exports telemetry and returns the stats.
The ranks are spawned here, or started by ``torchrun`` (one rank a
process, ``env://``).  On the card each rank takes a card of its own over
NCCL; ``--shared-card`` puts every rank on ``cuda:0`` over gloo instead,
its collectives staged through the host (for a host with one card).  The
mesh is (data 1, model N): every rank serves the whole queue.  Every
family serves under ``--tp``; an SSM or hybrid model's SSM heads must
divide by N (``launch/mesh.py::check_tp``), and each rank caches its own
SSM heads::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --smoke --device cpu --tp 2
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import meshctx
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.bucketing import plan_buckets
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.selector import (get_residual_corrector,
                                       load_selection_cache,
                                       select_gemm_config,
                                       set_residual_corrector)
from repro_torch.core.simulator import simulate_gemm
from repro_torch.core.topology import load_calibrated_topology_guarded
from repro_torch.kernels import build, ops
from repro_torch.launch.engine import ServingEngine, serving_gemms
from repro_torch.launch.mesh import (check_tp, init_distributed,
                                     make_local_mesh, spawn_ranks)
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.frontends import synth_frontend_inputs
from repro_torch.nn.model import Model, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.drift import DriftMonitor, set_drift_monitor
from repro_torch.obs.perfetto import export_chrome_trace


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (max concurrent sequences)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor/expert-parallel ranks (one process each)")
    ap.add_argument("--shared-card", action="store_true",
                    help="with --tp on the card: every rank on cuda:0 over "
                         "gloo (collectives through the host) instead of "
                         "one card a rank over NCCL")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--topology", default=None, metavar="PATH",
                    help="calibrated-topology artifact to select against "
                         "(guarded load: corrupt artifacts quarantine and "
                         "fall back to the stock preset)")
    ap.add_argument("--residual", default=None, metavar="PATH",
                    help="residual-corrector artifact (repro/residual/v1) "
                         "to re-price top-ranked candidates with (guarded "
                         "load: corrupt artifacts quarantine, stale "
                         "fingerprints are ignored; serving falls back to "
                         "the pure analytical model)")
    ap.add_argument("--ragged", action="store_true",
                    help="draw ragged prompt lengths in "
                         "[prompt-len/2, prompt-len] and admit them into "
                         "model-priced buckets")
    ap.add_argument("--requests", type=int, default=None,
                    help="number of requests to serve "
                         "(default: --batch; ragged default: 2x)")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="decode steps between device syncs (straggler "
                         "sampling granularity)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress stdout status lines (they still flow "
                         "through the trace layer)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent "
                         "fallback to the CPU")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="enable telemetry and write trace.json (Perfetto), "
                         "metrics.prom, metrics.jsonl and drift.jsonl "
                         "under DIR")
    return ap


def run_serving(args: argparse.Namespace, *,
                decode_fault: Optional[Callable[..., None]] = None,
                params: Optional[Dict] = None,
                cfg: Optional[ModelConfig] = None) -> Dict:
    """Serve one request queue end to end; returns the serving stats.

    ``decode_fault(step, guard)``, when given, runs at the top of every
    decode step's retried body.  ``params`` serves given weights instead
    of initialising random ones from ``--seed``; ``cfg`` serves that
    config instead of --arch's (a model cut in depth to fit one card).

    Returns a dict with ``tokens`` (uniform mode: the (batch, steps+1)
    generated array including the prefill token; ragged mode: a list of
    per-request arrays), ``drained``, ``steps``, ``retries``,
    ``stragglers``, timings, engine stats (``pad_fraction``,
    ``bucket_hits``, ``dispatch_s_mean``, ``device_step_s_mean``,
    ``tokens_per_s``), the bucket ``edges``, the topology served against
    (plus ``degraded`` when the artifact was rejected) and the residual
    corrector's digest (plus ``residual_degraded`` when it was rejected).

    ``--trace-dir DIR`` installs the telemetry subsystem for the run and
    writes ``trace.json`` (Perfetto, with the decode-step GEMMs' simulator
    timelines), ``metrics.prom``, ``metrics.jsonl`` and ``drift.jsonl``
    under DIR.  The stats dict is the same either way.

    ``--tp`` over 1 with no mesh installed runs :func:`serve_tp` (the
    ranks, then rank 0's stats); a rank calls this with its mesh
    installed."""
    tp = int(getattr(args, "tp", 1) or 1)
    if tp > 1 and meshctx.get_mesh() is None:
        if params is not None:
            raise ValueError("--tp draws each rank's shards itself; "
                             "params cannot be passed in")
        return serve_tp(args, cfg=cfg)
    quiet = bool(getattr(args, "quiet", False))
    trace_dir = getattr(args, "trace_dir", None)

    def say(msg: str) -> None:
        obs_trace.event("status", cat="serve", track="serve",
                        args={"msg": msg})
        if not quiet:
            print(msg)

    prev_tracer = prev_mon = drift_mon = None
    prev_metrics = False
    # _run_serving installs the --residual corrector after the topology is
    # known; restore whatever was there before, success or raise.
    prev_res = get_residual_corrector()
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prev_tracer = obs_trace.set_tracer(obs_trace.Tracer())
        prev_metrics = obs_metrics.enable_metrics(True)
        obs_metrics.get_registry().clear()
        drift_mon = DriftMonitor(path=os.path.join(trace_dir,
                                                   "drift.jsonl"))
        prev_mon = set_drift_monitor(drift_mon)
    try:
        out = _run_serving(args, decode_fault=decode_fault, params=params,
                           cfg=cfg, say=say, quiet=quiet)
        if trace_dir:
            _export_telemetry(trace_dir, args)
        return out
    finally:
        set_residual_corrector(prev_res)
        if trace_dir:
            obs_trace.set_tracer(prev_tracer)
            set_drift_monitor(prev_mon)
            drift_mon.close()
            obs_metrics.enable_metrics(prev_metrics)


def _export_telemetry(trace_dir: str, args: argparse.Namespace) -> None:
    """Write the run's telemetry artifacts: the Perfetto trace (measured
    tracer spans + the decode-step GEMMs' modeled simulator timelines),
    the Prometheus textfile, and a metrics JSONL snapshot.  The drift
    JSONL streams during the run (``DriftMonitor``)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    hw = ops.get_default_hardware()
    sim_timelines = []
    if cfg.family != "ssm":
        for (n, k) in serving_gemms(cfg)[:3]:
            sel = select_gemm_config(args.batch, n, k, hw=hw)
            ev: list = []
            simulate_gemm(sel.problem, sel.config, hw, events=ev)
            sim_timelines.append((f"gemm {args.batch}x{n}x{k}", ev))
    tracer = obs_trace.get_tracer()
    if tracer is not None:
        tracer.read()
    export_chrome_trace(os.path.join(trace_dir, "trace.json"),
                        tracer.spans if tracer is not None else [],
                        sim_timelines)
    reg = obs_metrics.get_registry()
    reg.write_prometheus(os.path.join(trace_dir, "metrics.prom"))
    reg.write_jsonl(os.path.join(trace_dir, "metrics.jsonl"),
                    kind="serving", arch=args.arch)


def request_queue(args: argparse.Namespace, cfg: ModelConfig,
                  device: torch.device
                  ) -> List[Tuple[np.ndarray, Optional[Dict]]]:
    """The run's requests in submission order: (prompt token ids, frontend
    inputs or None).  Prompts are uniform rows of --prompt-len or, with
    --ragged, truncations to lengths drawn in [prompt-len/2, prompt-len],
    both from --seed; a vision model's prompt is its image,
    ``cfg.frontend_tokens`` patch positions, ahead of that text (the
    reference's driver lets the patches cover the first
    min(frontend_tokens, --prompt-len) positions instead).  Each request's
    frontend inputs are drawn at its own prompt length, one request after
    another, from a generator on ``device`` seeded --seed."""
    ragged = bool(getattr(args, "ragged", False))
    n_req = getattr(args, "requests", None) or (
        2 * args.batch if ragged else args.batch)
    prefix = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(n_req, prefix + args.prompt_len)
                           ).astype(np.int32)
    if ragged:
        lo = max(args.prompt_len // 2, 4)
        lens = np.random.default_rng(args.seed).integers(
            lo, args.prompt_len + 1, size=n_req).tolist()
    else:
        lens = [args.prompt_len] * n_req
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = []
    for i in range(n_req):
        n = prefix + lens[i]
        extras = synth_frontend_inputs(cfg, gen, 1, n, device=device)
        out.append((prompts[i, :n], extras or None))
    return out


def _run_serving(args: argparse.Namespace, *,
                 decode_fault: Optional[Callable[..., None]],
                 params: Optional[Dict], cfg: Optional[ModelConfig],
                 say: Callable[[str], None], quiet: bool) -> Dict:
    device = resolve_device(getattr(args, "device", "cuda"))
    n_warm = load_selection_cache()            # $REPRO_SELECTION_CACHE
    if n_warm:
        say(f"[selector] warm-started {n_warm} persisted GEMM selections")

    topo_info: Dict = {"topology": ops.get_default_hardware().name,
                       "degraded": None}
    if getattr(args, "topology", None):
        topo, prov = load_calibrated_topology_guarded(args.topology,
                                                      GPU_H100_LIKE)
        ops.set_default_hardware(topo)
        topo_info = {"topology": topo.name,
                     "degraded": prov.get("degraded"),
                     "quarantined": prov.get("quarantined")}
        if prov.get("degraded"):
            say(f"[serve] topology artifact rejected "
                f"({prov['degraded']}); serving on stock "
                f"preset {topo.name}")
        else:
            say(f"[serve] serving against calibrated topology "
                f"{topo.name}")

    res_info: Dict = {"residual": None, "residual_degraded": None}
    if getattr(args, "residual", None):
        # Guarded load against the topology actually served (which the
        # --topology block above may have just swapped in); run_serving's
        # finally restores the previous corrector.
        from repro_torch.calib.residual import load_residual_guarded
        corr, rprov = load_residual_guarded(
            args.residual, expect=ops.get_default_hardware())
        if corr is None:
            res_info["residual_degraded"] = rprov.get("degraded")
            say(f"[serve] residual artifact rejected "
                f"({rprov.get('degraded')}); serving on the pure "
                f"analytical model")
        else:
            set_residual_corrector(corr)
            res_info["residual"] = corr.content_fingerprint()
            say(f"[serve] residual corrector active (digest "
                f"{corr.content_fingerprint()}, top-{corr.top_f} "
                f"re-pricing, fit on {corr.provenance.get('n_rows', '?')} "
                f"drift rows)")

    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    model = Model(cfg, device=device)
    ragged = bool(getattr(args, "ragged", False))

    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        mesh = meshctx.get_mesh()
        if mesh is None:
            params = model.init(gen)
        else:
            params = model.init_shards(gen, mesh, dist.get_rank())

    requests = request_queue(args, cfg, device)
    n_req = len(requests)
    lens = [int(p.size) for p, _ in requests]
    max_len = max(lens) + args.gen

    plan = None
    if ragged and not cfg.has_ssm:
        plan = plan_buckets(lens, gemms=serving_gemms(cfg),
                            hw=ops.get_default_hardware(), max_buckets=4)
        say(f"[serve] priced bucket edges: {list(plan.edges)} "
            f"(modeled step {plan.modeled_total_s * 1e3:.2f}ms, "
            f"pad {plan.pad_fraction * 100:.1f}%)")
        max_len = max(plan.edges) + args.gen

    engine = ServingEngine(
        model, params, max_batch=args.batch, max_len=max_len, plan=plan,
        temperature=args.temperature, seed=args.seed,
        sync_every=getattr(args, "sync_every", 8),
        decode_fault=decode_fault,
        straggler_window=16, straggler_min_steps=4, quiet=quiet)
    for prompt, extras in requests:
        engine.submit(prompt, max_new_tokens=args.gen, extras=extras)

    t0 = time.time()
    warmed = engine.warm_start()
    say(f"[serve] warm-started {warmed} serving GEMM shapes in one "
        f"batched selection pass ({(time.time() - t0) * 1e3:.0f}ms)")

    stats = engine.run()
    results = stats["results"]
    n_steps = stats["steps"]

    rows = [results[r].tokens for r in sorted(results)]
    if (not ragged and n_req == args.batch
            and len({len(r) for r in rows}) <= 1):
        # Uniform mode: all requests admitted together and same length —
        # the (batch, steps+1) matrix, prefill token first.
        tokens = (np.stack(rows) if rows else np.zeros((0, 0), np.int32))
    else:
        tokens = rows

    toks_per_s = stats["tokens_per_s"]
    say(f"arch={cfg.name} device={device} batch={args.batch} "
        f"requests={n_req} prefill {stats['t_prefill_s'] * 1e3:.0f}ms; "
        f"decoded {n_steps} steps at {toks_per_s:.1f} tok/s total")
    say(f"[serve] dispatch {stats['dispatch_s_mean'] * 1e3:.2f}ms/step "
        f"vs device {stats['device_step_s_mean'] * 1e3:.2f}ms/step; "
        f"padding {stats['pad_fraction'] * 100:.1f}%; "
        f"bucket hits {stats['bucket_hits']}")
    say("sample generations (first 2 rows, first 16 tokens):")
    for row in list(tokens)[:2]:
        say(f"   {np.asarray(row)[:16].tolist()}")
    return {
        "tokens": tokens,
        "steps": n_steps,
        "drained": stats["drained"],
        "retries": stats["retries"],
        "stragglers": stats["stragglers"],
        "t_prefill_s": stats["t_prefill_s"],
        "t_decode_s": stats["t_decode_s"],
        "tokens_per_s": toks_per_s,
        "tokens_emitted": stats["tokens_emitted"],
        "pad_fraction": stats["pad_fraction"],
        "bucket_hits": stats["bucket_hits"],
        "edges": list(plan.edges) if plan is not None else [],
        "dispatch_s_mean": stats["dispatch_s_mean"],
        "device_step_s_mean": stats["device_step_s_mean"],
        "device": str(device),
        "residual_active": stats["residual_active"],
        "results": results,
        **topo_info,
        **res_info,
    }


# Spawned --tp ranks must be done within this (seconds).
TP_TIMEOUT_S = 3600.0


def _serve_rank(rank: int, world: int, init_method: str,
                args: argparse.Namespace, cfg: Optional[ModelConfig],
                shared_card: bool) -> Optional[Dict]:
    """One rank of ``serve --tp``: join the group, install the (data,
    model) mesh, serve; rank 0's stats (the others' are None)."""
    dev = init_distributed(rank, world, init_method,
                           device=getattr(args, "device", "cuda"),
                           shared_card=shared_card)
    meshctx.set_mesh(make_local_mesh(args.tp, device_type=dev.type))
    try:
        rank_args = argparse.Namespace(**vars(args))
        rank_args.device = str(dev)
        if rank != 0:
            rank_args.quiet, rank_args.trace_dir = True, None
        out = run_serving(rank_args, cfg=cfg)
    finally:
        meshctx.set_mesh(None)
        dist.destroy_process_group()
    return out if rank == 0 else None


def serve_tp(args: argparse.Namespace, *,
             cfg: Optional[ModelConfig] = None) -> Dict:
    """``--tp`` ranks serving one queue: spawned here (all done within
    ``TP_TIMEOUT_S`` or all killed; on the card the kernels are built here
    first, once), or this process is one rank under ``torchrun`` (``RANK``
    / ``WORLD_SIZE`` set).  Returns rank 0's stats (None on the other
    ranks under torchrun)."""
    check_tp(cfg or get_config(args.arch, smoke=args.smoke), args.tp)
    shared = bool(getattr(args, "shared_card", False))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _serve_rank(int(os.environ["RANK"]),
                           int(os.environ["WORLD_SIZE"]), "env://", args,
                           cfg, shared)
    if resolve_device(getattr(args, "device", "cuda")).type == "cuda":
        build.build(("matmul", "flash_attention"))   # once, not once a rank
    return spawn_ranks(_serve_rank, args.tp, (args, cfg, shared),
                       timeout=TP_TIMEOUT_S)[0]


def main() -> int:
    args = build_parser().parse_args()
    run_serving(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
