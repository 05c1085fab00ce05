"""The port's own spans over a traced stretch, and the numbers read from
them.

:class:`ProgramCapture` is the profiler capture of ``perfbench/trace.py``
with the port's tracer (``repro_torch.obs.trace``) installed from
``start()`` to ``stop()``: after a synchronisation it anchors the tracer's
device marks and restores the tracer that was there; once the capture's
window has closed it reads the marks and puts :func:`reduce` of the spans
under ``summary["program"]``.  While the
profiler records, the program's spans are also ``record_function`` ranges,
so the breakdown's idle gaps fall under their names.

Only spans closed inside the stretch count: a step or request whose span
(or one of its device marks) is still open at ``stop()`` is left out.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

from perfbench.trace import Capture


def _dev_s(s) -> float:
    return s.device[1] - s.device[0]


def _closed(s) -> bool:
    return s.end is not None and (s.device is None or None not in s.device)


def reduce(spans) -> Dict:
    """``requests``: per request with a closed ``queue`` and ``request``
    span, its queue wait (submit to its prefill's device start) and its
    time to first token (submit to the prefill's device end), in seconds.
    ``prefill`` / ``decode``: per closed ``model.prefill`` /
    ``model.decode`` span, its device seconds, its ``moe`` children's, the
    ``moe.gather`` and ``moe.experts`` spans' under those, and the gathered
    bytes.  ``names``: closed spans by name."""
    closed = [s for s in spans if _closed(s)]
    kids: Dict[int, List] = defaultdict(list)
    for s in closed:
        if s.parent is not None:
            kids[s.parent].append(s)
    queue = {s.args["rid"]: s for s in closed if s.name == "queue"}
    req = {s.args["rid"]: s for s in closed if s.name == "request"}
    requests = [{"rid": rid, "queue_s": _dev_s(queue[rid]),
                 "ttft_s": req[rid].args["first_token"] - req[rid].start}
                for rid in sorted(queue.keys() & req.keys())]

    def calls(name: str) -> List[Dict]:
        out = []
        for m in (s for s in closed if s.name == name):
            moe = [k for k in kids[m.sid] if k.name == "moe"]
            parts = [g for k in moe for g in kids[k.sid]]
            out.append({
                "device_s": _dev_s(m),
                "moe_s": sum(_dev_s(k) for k in moe),
                "gather_s": sum(_dev_s(g) for g in parts
                                if g.name == "moe.gather"),
                "experts_s": sum(_dev_s(g) for g in parts
                                 if g.name == "moe.experts"),
                "gathered_bytes": sum(g.args["gathered_bytes"]
                                      for g in parts
                                      if g.name == "moe.gather")})
        return out

    names: Dict[str, int] = defaultdict(int)
    for s in closed:
        names[s.name] += 1
    return {"requests": requests, "prefill": calls("model.prefill"),
            "decode": calls("model.decode"), "names": dict(names)}


class ProgramCapture(Capture):
    """The profiler capture with the port's tracer installed over it."""

    def start(self) -> None:
        from repro_torch.obs import trace as obs_trace
        super().start()
        self.tracer = obs_trace.Tracer()
        self._prev = obs_trace.set_tracer(self.tracer)

    def stop(self) -> None:
        import torch
        from repro_torch.obs import trace as obs_trace
        torch.cuda.synchronize(self.device)
        self.tracer.settle()
        obs_trace.set_tracer(self._prev)
        super().stop()
        self.tracer.read()              # after the window: no idle added
        self.summary["program"] = reduce(self.tracer.spans)


# -- the numbers, each None where the stretch gives it nothing to read -----

def _program(ctx: Dict) -> Dict:
    return (ctx.get("trace") or {}).get("program") or {}


def queue_wait_share(ctx: Dict) -> Optional[float]:
    """100 x the requests' queue waits over their times to first token."""
    reqs = _program(ctx).get("requests") or []
    ttft = sum(r["ttft_s"] for r in reqs)
    if ttft <= 0:
        return None
    return 100.0 * sum(r["queue_s"] for r in reqs) / ttft


def moe_prefill_share(ctx: Dict) -> Optional[float]:
    """100 x the ``moe`` spans' device seconds under ``model.prefill`` over
    those prefills' device seconds."""
    calls = _program(ctx).get("prefill") or []
    dev = sum(c["device_s"] for c in calls)
    if dev <= 0:
        return None
    return 100.0 * sum(c["moe_s"] for c in calls) / dev


def moe_decode_ms_per_step(ctx: Dict) -> Optional[float]:
    """The ``moe`` spans' device ms under ``model.decode``, a step."""
    calls = _program(ctx).get("decode") or []
    if not calls:
        return None
    return 1e3 * sum(c["moe_s"] for c in calls) / len(calls)


def moe_gather_gb_per_step(ctx: Dict) -> Optional[float]:
    """The decode MoE's gathered bytes / 1e9, a step."""
    calls = _program(ctx).get("decode") or []
    if not calls:
        return None
    return sum(c["gathered_bytes"] for c in calls) / 1e9 / len(calls)


METRICS = {"queue_wait_share.longdoc": queue_wait_share,
           "moe_prefill_share.longdoc": moe_prefill_share,
           "moe_decode_ms_per_step.chat": moe_decode_ms_per_step,
           "moe_gather_gb_per_step.chat": moe_gather_gb_per_step}
