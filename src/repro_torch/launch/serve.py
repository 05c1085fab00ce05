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

Requests flow through :class:`repro_torch.launch.engine.ServingEngine`;
ragged lengths are right-padded to the edges of a model-priced
:class:`~repro_torch.core.bucketing.BucketPlan`, every bucket edge's step
GEMMs are warm-selected in one batched call, and on the card every layer
projection runs the hand-written Hopper GEMM and prefill attention the
hand-written flash kernel; an MoE layer's expert GEMMs run the grouped
Hopper GEMM, one launch for all experts.  As in the reference, the bucket
plan prices every family's step with ``step_gemms`` (a d_model-wide q
projection and a d_ff MLP), and MoE prompts are admitted into buckets: pad
tokens raise the token count and so the expert capacity.  ``--topology``
loads a calibrated-topology artifact through the guarded loader (corrupt
artifacts quarantine, serving continues on the stock preset);
``--residual`` installs a residual corrector, loaded guarded against the
topology actually served; ``--trace-dir`` writes the run's telemetry.
``run_serving`` is the library entry point; ``main`` is the CLI shim.

Tensor parallelism (the reference's ``--tp``) comes with the distributed
slice.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.bucketing import plan_buckets, step_gemms
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.selector import (get_residual_corrector,
                                       load_selection_cache,
                                       select_gemm_config,
                                       set_residual_corrector)
from repro_torch.core.simulator import simulate_gemm
from repro_torch.core.topology import load_calibrated_topology_guarded
from repro_torch.kernels import ops
from repro_torch.launch.engine import ServingEngine
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
                params: Optional[Dict] = None) -> Dict:
    """Serve one request queue end to end; returns the serving stats.

    ``decode_fault(step, guard)``, when given, runs at the top of every
    decode step's retried body.  ``params`` serves given weights instead
    of initialising random ones from ``--seed``.

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
    under DIR.  The stats dict is the same either way."""
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
                           say=say, quiet=quiet)
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
    gemms = step_gemms(cfg.d_model, cfg.d_ff,
                       kv_dim=cfg.num_kv_heads * cfg.head_dim,
                       vocab=cfg.vocab_size,
                       swiglu=cfg.activation == "swiglu")[:3]
    for (n, k) in gemms:
        sel = select_gemm_config(args.batch, n, k, hw=hw)
        ev: list = []
        simulate_gemm(sel.problem, sel.config, hw, events=ev)
        sim_timelines.append((f"gemm {args.batch}x{n}x{k}", ev))
    tracer = obs_trace.get_tracer()
    export_chrome_trace(os.path.join(trace_dir, "trace.json"),
                        tracer.spans if tracer is not None else [],
                        sim_timelines)
    reg = obs_metrics.get_registry()
    reg.write_prometheus(os.path.join(trace_dir, "metrics.prom"))
    reg.write_jsonl(os.path.join(trace_dir, "metrics.jsonl"),
                    kind="serving", arch=args.arch)


def _run_serving(args: argparse.Namespace, *,
                 decode_fault: Optional[Callable[..., None]],
                 params: Optional[Dict],
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

    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg, device=device)
    max_len = args.prompt_len + args.gen
    ragged = bool(getattr(args, "ragged", False))
    n_req = getattr(args, "requests", None) or (
        2 * args.batch if ragged else args.batch)

    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = model.init(gen)

    # Request prompts: uniform rows of prompt-len, or ragged truncations.
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(n_req, args.prompt_len)).astype(np.int32)
    if ragged:
        lo = max(args.prompt_len // 2, 4)
        lens = np.random.default_rng(args.seed).integers(
            lo, args.prompt_len + 1, size=n_req).tolist()
    else:
        lens = [args.prompt_len] * n_req

    plan = None
    if ragged:
        plan = plan_buckets(
            lens,
            gemms=step_gemms(cfg.d_model, cfg.d_ff,
                             kv_dim=cfg.num_kv_heads * cfg.head_dim,
                             vocab=cfg.vocab_size,
                             swiglu=cfg.activation == "swiglu"),
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
    for i in range(n_req):
        engine.submit(prompts[i, :lens[i]], max_new_tokens=args.gen)

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


def main() -> int:
    args = build_parser().parse_args()
    run_serving(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
