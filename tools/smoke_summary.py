#!/usr/bin/env python3
"""Summarise saved ``chip_smoke.py`` outputs, one block a run.

    python3 tools/smoke_summary.py RUN.txt [RUN.txt ...]

Each RUN.txt is the standard output of one ``python3 chip_smoke.py`` (its
JSON lines).  For each it prints, as one JSON object: the card's
``nvidia-smi`` line, the fitted calibration constants with the latency and
wave intercepts, the fidelity phase's mean over its shapes (preset and
calibrated topology, oracle seconds over selected seconds), the serve
rows (tokens/s, prefill ms a request, decode and dispatch ms a step) of
every serve phase, the calibrated-topology serve included, and the
``train_times`` summary.  With two or more runs the first is also the
reference that every later run's fitted constants are given against, as
``ratio_to_first``.  Nothing is measured here: it reads what the runs
printed.
"""
from __future__ import annotations

import json
import statistics
import sys

SERVE_KEYS = ("tokens_per_s", "prefill_ms_per_request", "decode_ms_per_step",
              "dispatch_ms_per_step")


def summarise(path: str) -> dict:
    out = {"run": path, "serve": {}}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line.startswith("{"):
                if line.startswith("NVIDIA"):
                    out["nvidia_smi"] = line
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            phase = rec.get("phase")
            if phase == "calib_constants":
                out["intercepts"] = {k: rec[k] for k in (
                    "latency_intercept", "wave_intercept") if k in rec}
            elif phase == "calib":
                out["fitted"] = {k: v["fitted"]
                                 for k, v in rec["fields"].items()}
                out["static_share"] = rec.get("static_share")
            elif phase == "fidelity":
                rows = rec["rows"]
                out["fidelity_mean"] = {
                    "preset": statistics.mean(r["fidelity"] for r in rows),
                    "calibrated": statistics.mean(
                        r["calibrated_fidelity"] for r in rows),
                    "shapes": len(rows)}
            elif phase in ("serve", "serve_moe", "serve_ssm", "serve_hybrid",
                           "serve_hybrid_f32", "serve_calibrated_run"):
                out["serve"][phase] = {k: rec[k] for k in SERVE_KEYS
                                       if k in rec}
            elif phase == "train_times":
                out["train_times"] = rec.get("summary")
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    runs = [summarise(p) for p in argv]
    first = runs[0].get("fitted", {})
    for run in runs:
        if run is not runs[0] and first:
            run["ratio_to_first"] = {
                k: v / first[k] for k, v in run.get("fitted", {}).items()
                if first.get(k)}
        print(json.dumps(run))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
