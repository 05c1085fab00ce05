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
artifacts quarantine, serving continues on the stock preset).
``run_serving`` is the library entry point; ``main`` is the CLI shim.

Not ported yet: ``--tp``, ``--trace-dir`` and ``--residual``.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.bucketing import plan_buckets, step_gemms
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.selector import load_selection_cache
from repro_torch.core.topology import load_calibrated_topology_guarded
from repro_torch.kernels import ops
from repro_torch.launch.engine import ServingEngine
from repro_torch.nn.model import Model, resolve_device
from repro_torch.obs import trace as obs_trace


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
    ``tokens_per_s``), the bucket ``edges`` and the topology served
    against (plus ``degraded`` when the artifact was rejected)."""
    quiet = bool(getattr(args, "quiet", False))

    def say(msg: str) -> None:
        obs_trace.event("status", cat="serve", track="serve",
                        args={"msg": msg})
        if not quiet:
            print(msg)

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
        "results": results,
        **topo_info,
    }


def main() -> int:
    args = build_parser().parse_args()
    run_serving(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
