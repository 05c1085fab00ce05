"""A traced run of one cell with the port's own tracer installed over the
traced stretch, on the card:

    python3 perfbench/trace_program.py --workload <name> --seed <n> \
        --seconds <s> --tracer <0|1>

from the root of a checkout.  It sets up the cell and serves its window as
``perfbench/run.py`` does, then traces one more stretch under
``perfbench/spans.py``'s ``ProgramCapture`` (``--tracer 1``) or the plain
capture (``--tracer 0``, the same stretch with the tracer off).  The last
line of standard output is one JSON object: the cell's per-layer metrics as
``BENCHMARK.json`` lists them, the span numbers of ``perfbench/spans.py``,
the program's span reduction, the breakdown, and the tracer's host cost:
microseconds a device-timed span spends opening and closing (two CUDA
events), being anchored and being read, timed over many spans with no
profiler.  It does not
check the served tokens (``run.py`` does).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import run  # noqa: E402  (sets the build caches' paths)


def tracer_cost(n: int = 4000) -> dict:
    """Host µs a device-timed span costs to open and close (nested in
    pairs), to anchor and to read, each a span; and one mark alone."""
    import torch
    from repro_torch.obs import trace as obs_trace
    tr = obs_trace.Tracer()
    prev = obs_trace.set_tracer(tr)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n // 2):
            with obs_trace.span("outer", device=True):
                with obs_trace.span("inner", device=True):
                    pass
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tr.settle()
        t3 = time.perf_counter()
        tr.read()
        t4 = time.perf_counter()
        for _ in range(n):
            tr.mark()
        t5 = time.perf_counter()
    finally:
        obs_trace.set_tracer(prev)
    return {"spans": n, "open_close_us": (t1 - t0) / n * 1e6,
            "settle_us": (t3 - t2) / n * 1e6,
            "read_us": (t4 - t3) / n * 1e6,
            "mark_us": (t5 - t4) / n * 1e6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch
    from perfbench import spans, spec, trace, work
    from perfbench.serve_cell import ServeCell
    if not torch.cuda.is_available():
        print("perfbench: a traced run needs the card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    server = ServeCell(cell, "cuda")
    server.setup(args.seed)
    win = server.window(args.seconds)
    cap = (spans.ProgramCapture if args.tracer else trace.Capture)(
        server.device)
    summary = server.trace_tail(cap)
    kind = torch.cuda.get_device_name(server.device)
    ctx = {"window": win, "trace": summary, "run": cell.run,
           "mix": cell.traffic, "peaks": work.peaks(kind)}
    out = {"workload": args.workload, "seed": args.seed,
           "tracer": bool(args.tracer), "card": run._power_limit(),
           "per_layer": {m["name"]: run._reader(m["name"])(ctx)
                         for m in cell.per_layer},
           "spans": {n: f(ctx) for n, f in spans.METRICS.items()},
           "program": summary.get("program"),
           "busy_s": summary["busy_s"], "window_s": summary["window_s"],
           "breakdown": {"device_ops": summary["device_ops"],
                         "idle_gaps": summary["idle_gaps"]},
           "window": {"waves": win["waves"], "wall_s": win["wall_s"]}}
    server.release()
    out["tracer_cost"] = tracer_cost()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
