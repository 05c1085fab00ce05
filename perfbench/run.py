"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix, which the harness
reads from their data files (``perfbench/spec.py``).  A run builds the
port's kernels (once a checkout, into ``build/``), makes the weights from
the seed, warms the cell's shapes, measures whole closed waves that
start within the seconds, and, with ``--trace 1``, traces one more
stretch for the per-layer metrics.  Then it reads the memory peak, frees
the program's state, and holds what the window produced to the plain
reference (``perfbench/reference``) under the cell's limits
(``perfbench/limits/<workload>.json``).  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``check``, each
number compared beside its limit (also the last lines of standard error).

It refuses to run (exit 2, no result) without as many CUDA devices as the
cell asks for, and fails (exit 3, no result) if JAX, flax or the JAX
package ``repro`` was imported by the time it would print.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every cache the program or its libraries keep lives at a fixed path in
# the checkout, so only a checkout's first run builds and compiles.
_CACHE = ROOT / "build" / "perfbench"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(_CACHE / _sub)
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

BARRED = ("jax", "jaxlib", "flax", "repro")


def barred_modules():
    """Loaded modules whose top-level name is barred, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BARRED))


def _reader(name: str):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def judge(readings, limits):
    """(all within their limits, {name: {"value", "limit"}})."""
    check, ok = {}, True
    for name, lim in limits["numbers"].items():
        if name not in readings:
            raise KeyError(f"the limits name {name!r}, the run read "
                           f"{sorted(readings)}")
        v = float(readings[name])
        check[name] = {"value": v, "limit": float(lim["limit"])}
        ok = ok and math.isfinite(v) and v <= float(lim["limit"])
    return ok, check


def execute(cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = None):
    """Run ``cell`` once; the result object (the check last)."""
    import torch
    from perfbench import trace as tr
    from perfbench import work
    from perfbench.serve_cell import ServeCell
    t_start = T_START if t_start is None else t_start
    driver = ServeCell(cell, device)
    driver.setup(seed)
    setup_s = time.perf_counter() - t_start
    win = driver.window(seconds)
    cuda = driver.device.type == "cuda"
    summary = None
    if trace:
        if not cuda:
            raise ValueError("a traced run needs the card")
        summary = driver.trace_tail(tr.Capture(driver.device))
    peak = torch.cuda.max_memory_allocated(driver.device) if cuda else 0
    kind_name = torch.cuda.get_device_name(driver.device) if cuda else "cpu"
    driver.release()
    readings = driver.check(seed)
    correct, check = judge(readings, cell.limits)
    correct = correct and win["failed"] == 0
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        ctx = {"window": win, "trace": summary, "run": cell.run,
               "mix": cell.traffic, "peaks": work.peaks(kind_name)}
        for m in cell.per_layer:
            v = _reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(win, setup_s)
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": units[m["name"]]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind_name,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": win["requests"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary["device_ops"]],
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"]]}
        result["kernel_events"] = {
            c: {"trace": summary["class_n"][c],
                "launches": summary["launches"][c],
                "seconds": summary["class_s"][c]}
            for c in summary["class_n"]}
    if cuda:
        result["card"] = _power_limit()
    result["window"] = {"wall_s": win["wall_s"], "waves": win["waves"]}
    result["readings"] = readings
    result["check"] = check
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from perfbench import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), this host has {have}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = barred_modules()
    if found:
        print(f"perfbench: the run imported {found}; the port's "
              f"benchmark may load none of {list(BARRED)}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
