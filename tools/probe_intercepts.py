#!/usr/bin/env python3
"""The calibration's latency and wave sweeps on one card, their intercepts
side by side, timed both ways ``TorchDevice`` can time a probe.

    python3 tools/probe_intercepts.py [--reps 3]

``calib/fit.py`` fits ``hbm_latency`` as the latency sweep's intercept
less the wave sweep's (``kernel_launch``) less ``dma_fixed``, so the two
sweeps must carry the same fixed cost a call.  For each repetition this
runs ``calib/probes.py``'s ``probe_latency`` and ``probe_wave`` on a
``TorchDevice`` whose probes are timed by ``marginal_time`` (its timing:
graphs of ``n`` and ``2 n`` calls, the difference over ``n``) and by
``graph_time`` of the ``n``-call graph alone (each call then carries its
share of what a replay costs once), and prints one JSON line a mode with
both intercepts and slopes (Theil-Sen, as the fit), their difference in
microseconds, and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_intercepts: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.calib import device as cdev
    from repro_torch.calib import probes as cprobes
    from repro_torch.calib.fit import theil_sen
    from repro_torch.core.hardware import GPU_H100_LIKE as base

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    marginal = cdev.marginal_time
    for rep in range(args.reps):
        for mode in ("graph_time", "marginal_time"):
            # TorchDevice._time looks its timer up at each call.
            cdev.marginal_time = (cdev.graph_time if mode == "graph_time"
                                  else marginal)
            dev = cdev.TorchDevice()
            fits = {}
            for name, sweep in (("latency", cprobes.probe_latency(dev, base)),
                                ("wave", cprobes.probe_wave(dev, base))):
                slope, icpt = theil_sen(sweep.xs(), sweep.ys())
                fits[name] = {"intercept_us": icpt * 1e6, "slope": slope,
                              "samples": sweep.to_dict()["samples"]}
            print(json.dumps({
                "rep": rep, "timing": mode,
                "latency_intercept_us": fits["latency"]["intercept_us"],
                "wave_intercept_us": fits["wave"]["intercept_us"],
                "difference_us": fits["latency"]["intercept_us"]
                - fits["wave"]["intercept_us"],
                "sweeps": fits, "nvidia_smi": smi}), flush=True)
    cdev.marginal_time = marginal
    return 0


if __name__ == "__main__":
    sys.exit(main())
