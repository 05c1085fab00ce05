"""The readings a serving cell's limits are set from, on the card at the
cell's own size, many seeds in one process (the benchmark's own runs do
not run this):

    python3 perfbench/readings.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults altered_token,half_batch \
         --fault-seeds 4,5,6]

For each seed: the program's numbers as a run compares them, after the
closed waves at the cell's load that hold as many requests as a run's
check samples.  For each control seed, the control in the program's
place: the reference in fp8 (``reference/fp8.py``) read against the f32
reference, at the same positions of the program's served tokens.  For
each fault (``perfbench/faults.py``) and fault seed, the program with the
fault planted.  One JSON line a reading, with ``correct``: whether the
numbers pass the cell's committed limits (``run.judge``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]


def _list(text):
    return [s for s in text.split(",") if s]


def _seeds(text):
    return [int(s) for s in _list(text)]


def as_control(got):
    """The control's numbers under the names a run compares, the
    program's beside them with ``program_`` in front."""
    return {k[len("control_"):]: v for k, v in got.items()
            if k.startswith("control_")} | {
        "program_" + k: v for k, v in got.items()
        if not k.startswith("control_")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--faults", type=_list, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    args = ap.parse_args()
    import torch
    from perfbench import faults, spec
    from perfbench.common import free
    from perfbench.run import judge
    from perfbench.serve_cell import ServeCell
    if not torch.cuda.is_available():
        print("readings: needs the card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda")
    jobs = [(s, "program") for s in args.seeds] \
        + [(s, "control") for s in args.control_seeds] \
        + [(s, f) for f in args.faults for s in args.fault_seeds]
    for seed, what in jobs:
        t0 = time.perf_counter()
        undo = faults.plant(what) if what in faults.FAULTS else None
        try:
            d = ServeCell(cell, dev)
            d.setup(seed)
            d.window(0.0, waves=math.ceil(
                int(cell.traffic["check_requests"])
                / int(cell.traffic["slots"])))
        finally:
            if undo:
                undo()
        d.release()
        got = d.check(seed, control=what == "control")
        if what == "control":
            got = as_control(got)
        ok, _ = judge(got, cell.limits)
        d = None
        free(dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "what": what, "correct": ok, **got,
                          "seconds": time.perf_counter() - t0,
                          "peak": torch.cuda.max_memory_allocated()}),
              flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
