"""The traced window: torch.profiler over a stretch of a run, reduced to
what the per-layer readers need.

* ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the window; ``window_s`` its length, from a host annotation that
  opens after one device synchronisation and closes after another.
* Per kernel class (``metrics/kernel_classes.json``): device seconds and
  the number of kernel events, beside the launches the port's own
  counters saw over the same window.  The profiler has been seen to drop
  kernel events, so a class whose two counts differ is not measured.
* The breakdown: the ten device operations that took most time, and the
  ten host operations under which the device sat idle longest (each idle
  gap goes to the innermost host event that spans its middle).
"""
from __future__ import annotations

import gc
import importlib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from perfbench.spec import BENCH_DIR, ROOT

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
_NAME = 120


def kernel_classes() -> Dict:
    with open(BENCH_DIR / "metrics" / "kernel_classes.json") as f:
        return json.load(f)


def _counter(ref: str) -> int:
    mod, attrs = ref.split(":")
    obj = importlib.import_module(mod)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)


def launches(classes: Dict) -> Dict[str, int]:
    """Each class's kernel events as the port's launch counters reckon
    them, so far in this process."""
    return {cls: sum(w * _counter(ref) for ref, w in c["launches"].items())
            for cls, c in classes.items()}


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: List[Dict], classes: Dict) -> Dict:
    """Reduce chrome-trace events (µs) to seconds: window, busy, class
    times and counts, the breakdown."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, ops = [], {}
    cls_s = dict.fromkeys(classes, 0.0)
    cls_n = dict.fromkeys(classes, 0)
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = str(e.get("name", ""))
        ops[name[:_NAME]] = ops.get(name[:_NAME], 0.0) + (b - a) * 1e-6
        if e["cat"] != "kernel":
            continue
        for cls, c in classes.items():
            if any(k in name for k in c["kernels"]):
                cls_s[cls] += (b - a) * 1e-6
                cls_n[cls] += 1
    busy = _union(dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "class_s": cls_s, "class_n": cls_n,
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": _attribute(gaps, events)}


def _attribute(gaps: List[Tuple[float, float]], events: List[Dict]
               ) -> List[Tuple[str, float]]:
    """Idle seconds by the innermost host event spanning each gap's
    middle; the ten largest."""
    if not gaps:
        return []
    mids = np.array([(a + b) / 2 for a, b in gaps])
    order = np.argsort(mids)
    mids_s = mids[order]
    owner = np.full(len(gaps), -1)          # by position in mids_s
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("name") != WINDOW]
    host.sort(key=lambda e: -float(e["dur"]))        # outermost first
    for i, e in enumerate(host):
        a = np.searchsorted(mids_s, float(e["ts"]), side="left")
        b = np.searchsorted(mids_s, float(e["ts"]) + float(e["dur"]),
                            side="left")
        owner[a:b] = i
    out: Dict[str, float] = {}
    for pos, j in enumerate(order):
        a, b = gaps[j]
        i = owner[pos]
        name = str(host[i]["name"])[:_NAME] if i >= 0 else "(no host event)"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return sorted(out.items(), key=lambda kv: -kv[1])[:10]


class Capture:
    """torch.profiler over [start, stop), with the port's launch counters
    read at both ends."""

    def __init__(self, device):
        self.device = device
        self.classes = kernel_classes()
        self.summary: Optional[Dict] = None
        self._prof = self._rf = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize(self.device)
        self._n0 = launches(self.classes)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._rf = record_function(WINDOW)
        self._rf.__enter__()

    @property
    def open(self) -> bool:
        return self._prof is not None

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)
        self._rf.__exit__(None, None, None)
        self._prof.stop()
        n1 = launches(self.classes)
        path = ROOT / "build" / "perfbench" / "trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        try:
            self._prof.export_chrome_trace(str(path))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            if path.exists():
                os.unlink(path)
        self._prof = self._rf = None
        gc.collect()
        self.summary = summarize(events, self.classes)
        self.summary["launches"] = {c: n1[c] - self._n0[c]
                                    for c in self.classes}


def roofline_share(ctx: Dict, cls: str) -> Optional[float]:
    """100 x the class's roofline seconds over its kernels' device seconds
    in the traced window; None where the trace and the port's launch
    counters disagree on the class's kernel count (a dropped event)."""
    tr = ctx.get("trace")
    if not tr or cls not in tr.get("work_s", {}):
        return None
    n, want, sec = tr["class_n"][cls], tr["launches"][cls], tr["class_s"][cls]
    if n == 0 or n != want or sec <= 0:
        return None
    return 100.0 * tr["work_s"][cls] / sec


def idle_share(ctx: Dict) -> Optional[float]:
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
