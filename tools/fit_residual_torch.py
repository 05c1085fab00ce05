"""Fit the learned residual corrector from the drift stream on the port
(DESIGN.md §12): the PyTorch counterpart of ``tools/fit_residual.py``.

    python tools/fit_residual_torch.py [--preset gpu_h100_like] \
        [--device torch | virtual] \
        [--drift experiments/obs/drift.jsonl ...] [--oracle-sweep] \
        [--scale 8] [--smoke] [--out experiments/calib/<preset>.residual.json] \
        [--check-against-oracle]

Training rows come from either (or both) of:

* ``--drift PATH`` (repeatable) — ``repro/drift/v1`` JSONL streams a
  traced serving run emitted (``repro_torch.launch.serve --trace-dir``).
  Rows are validated against the live preset's topology fingerprint;
  name-shaped ``topo`` columns and malformed lines are counted and
  refused.
* ``--oracle-sweep`` — measure the top-k analytically-ranked candidates of
  the scaled llama3 sweep on the device, exactly the finalists the
  corrector re-prices at selection time: ``--device torch`` (the default)
  times them with the port's GEMM kernel on the CUDA card and refuses to
  run without one, ``--device virtual`` prices them with the simulator.

The fit is written as a ``repro/residual/v1`` artifact (fingerprint +
model digest + provenance) loadable with ``load_residual_guarded``.
``--check-against-oracle`` then evaluates it on a HELD-OUT token sweep —
shapes the fit never saw — and fails when the corrected selection's
%-of-oracle fidelity falls below the analytical baseline; the held-out
report lands next to the artifact (``residual_report_<preset>.{json,md}``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "src"))

from repro_torch.calib.device import get_device              # noqa: E402
from repro_torch.calib.oracle import (fidelity_sweep,        # noqa: E402
                                      scaled_llama3_shapes)
from repro_torch.calib.residual import (MIN_FIT_ROWS,        # noqa: E402
                                        fit_residual, rows_from_drift,
                                        rows_from_sweep)
from repro_torch.core.hardware import PRESETS, get_hardware  # noqa: E402
from repro_torch.core.topology import topology_fingerprint   # noqa: E402

DEFAULT_OUT_DIR = os.path.join(os.path.dirname(__file__), os.pardir,
                               "experiments", "calib")

# Held-out evaluation uses a token count the training sweep never saw.
TRAIN_TOKENS = (1024,)
HELDOUT_TOKENS = (512,)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="gpu_h100_like",
                    choices=sorted(PRESETS))
    ap.add_argument("--device", default="torch",
                    choices=("virtual", "torch"))
    ap.add_argument("--drift", action="append", default=[],
                    help="drift.jsonl path (repeatable)")
    ap.add_argument("--oracle-sweep", action="store_true",
                    help="supplement with top-k candidate measurements of "
                         "the scaled llama3 sweep on the device")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide llama3 sweep dims (smoke-size knob)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI preset: --scale 8 and --oracle-sweep")
    ap.add_argument("--top-k", type=int, default=12,
                    help="candidates measured per sweep shape (wider than "
                         "the corrector's top_f=8 re-pricing slate so every "
                         "re-priced finalist is in-distribution)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default experiments/calib/"
                         "<preset>.residual.json)")
    ap.add_argument("--check-against-oracle", action="store_true",
                    help="held-out fidelity report; fail if the corrected "
                         "selection underperforms the analytical baseline")
    args = ap.parse_args()
    if args.smoke:
        args.scale = max(args.scale, 8)
        args.oracle_sweep = True

    hw = get_hardware(args.preset)
    fp = topology_fingerprint(hw)
    device = get_device(args.device, hw)

    rows, sources, stats = [], [], {}
    for path in args.drift:
        drows, dstats = rows_from_drift(path, fingerprint=fp)
        print(f"[residual] {path}: kept {dstats['kept']}/{dstats['total']} "
              f"rows ({dstats['malformed']} malformed, "
              f"{dstats['no_config']} config-less, "
              f"{dstats['name_shaped_topo']} name-shaped topo, "
              f"{dstats['fingerprint_mismatch']} stale fingerprint)")
        rows += drows
        sources.append(path)
        for k, v in dstats.items():
            stats[k] = stats.get(k, 0) + v
    if args.oracle_sweep:
        shapes = [(M, N, K) for (_, M, N, K) in
                  scaled_llama3_shapes(tokens=TRAIN_TOKENS,
                                       scale=args.scale)]
        srows = rows_from_sweep(hw, device, shapes, k=args.top_k)
        print(f"[residual] oracle sweep ({len(shapes)} shapes x top-"
              f"{args.top_k}): {len(srows)} rows")
        rows += srows
        sources.append(f"oracle-sweep:scale={args.scale}")

    if len(rows) < MIN_FIT_ROWS:
        print(f"[residual] FAIL: {len(rows)} training rows < "
              f"{MIN_FIT_ROWS} (pass --drift and/or --oracle-sweep)")
        return 2
    corr = fit_residual(rows, hw, sources=sources, stats=stats or None)
    prov = corr.provenance
    print(f"[residual] fit {len(rows)} rows for {hw.name} "
          f"(fingerprint {fp}): train RMSE {prov['train_rmse_log']:.4f} "
          f"log-s vs mean |log ratio| "
          f"{prov['train_mean_abs_log_ratio']:.4f}")

    out = args.out or os.path.join(DEFAULT_OUT_DIR,
                                   f"{hw.name}.residual.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    corr.save(out)
    print(f"[residual] artifact -> {out}")

    if not args.check_against_oracle:
        return 0
    held = scaled_llama3_shapes(tokens=HELDOUT_TOKENS, scale=args.scale)
    orows = fidelity_sweep(hw, device, held, prune=False, residual=corr)
    mean_a = sum(r.fidelity for r in orows) / len(orows)
    mean_c = sum(r.corrected_fidelity for r in orows) / len(orows)
    worst_a = min(r.fidelity for r in orows)
    worst_c = min(r.corrected_fidelity for r in orows)
    report = {
        "preset": hw.name, "fingerprint": fp, "n_shapes": len(orows),
        "heldout_tokens": list(HELDOUT_TOKENS), "scale": args.scale,
        "mean_fidelity": mean_a, "mean_corrected_fidelity": mean_c,
        "worst_fidelity": worst_a, "worst_corrected_fidelity": worst_c,
        "rows": [r.as_list() for r in orows],
    }
    base = os.path.join(os.path.dirname(os.path.abspath(out)),
                        f"residual_report_{hw.name}")
    with open(base + ".json", "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    md = ["| preset | shapes | analytical mean | corrected mean | "
          "analytical worst | corrected worst |",
          "|---|---|---|---|---|---|",
          f"| {hw.name} | {len(orows)} | {100*mean_a:.2f}% "
          f"| {100*mean_c:.2f}% | {100*worst_a:.2f}% "
          f"| {100*worst_c:.2f}% |"]
    with open(base + ".md", "w") as f:
        f.write("\n".join(md) + "\n")
    print(f"[residual] held-out ({len(orows)} shapes): analytical "
          f"{100*mean_a:.2f}% mean / {100*worst_a:.2f}% worst; corrected "
          f"{100*mean_c:.2f}% mean / {100*worst_c:.2f}% worst "
          f"-> {base}.{{json,md}}")
    # The corrector must help on average and never sink the worst row
    # (small tolerance: held-out noise must not flake CI).
    if mean_c < mean_a - 0.005 or worst_c < worst_a - 0.005:
        print("[residual] FAIL: corrected fidelity regressed vs the "
              "analytical baseline on held-out shapes")
        return 1
    print("[residual] corrected >= analytical on held-out shapes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
