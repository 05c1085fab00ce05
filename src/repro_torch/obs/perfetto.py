"""Chrome / Perfetto ``trace.json`` exporter (DESIGN.md §11).

Converts :class:`repro_torch.obs.trace.Span` lists — and the event simulator's
``(track, name, t0, t1, args)`` timeline tuples — into the Chrome Trace
Event JSON that ``chrome://tracing`` and https://ui.perfetto.dev load
directly (:func:`export_chrome_trace`):

* duration spans   → ``"ph": "X"`` complete events (``ts``/``dur`` in µs),
* instants         → ``"ph": "i"`` (thread-scoped),
* counter samples  → ``"ph": "C"``,
* every distinct (pid, track) pair gets a ``thread_name`` metadata event so
  Perfetto labels the rows (``selection``, ``engine``, ``core3``, ``dma``…),
* a span with a parent carries its ``sid`` and ``parent`` in its args, and
  a settled device interval is one more "X" event on ``<track> (device)``.

Measured (tracer) and modeled (simulator) timelines export into one file
under different pids, so both schedules are inspectable side by side in
the same UI.  Pure functions over plain data — this module imports nothing
from ``repro_torch.core``; simulator timelines arrive as the ``events`` list
``repro_torch.core.simulator.simulate_gemm`` fills in.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import Span, sorted_spans

MEASURED_PID = 1          # tracer spans (wall-clock measured)
MODELED_PID = 2           # simulator timelines (model-priced schedule)

_US = 1e6                 # seconds -> Chrome trace microseconds


def _track_tids(tracks: Sequence[Tuple[int, str]]) -> Dict[Tuple[int, str],
                                                           int]:
    """Stable tid per (pid, track): first-seen order, counting from 1."""
    tids: Dict[Tuple[int, str], int] = {}
    for key in tracks:
        if key not in tids:
            tids[key] = len(tids) + 1
    return tids


def _meta_events(tids: Dict[Tuple[int, str], int],
                 pid_names: Dict[int, str]) -> List[Dict[str, Any]]:
    evs: List[Dict[str, Any]] = []
    for pid, name in sorted(pid_names.items()):
        evs.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": name}})
    for (pid, track), tid in sorted(tids.items(), key=lambda kv: kv[1]):
        evs.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": track}})
    return evs


def export_chrome_trace(path: str, spans: Sequence[Span] = (),
                        sim_timelines: Optional[Sequence[
                            Tuple[str, Sequence[Tuple]]]] = None,
                        indent: Optional[int] = None) -> Dict[str, Any]:
    """Write a complete Perfetto-loadable ``trace.json``: measured tracer
    spans under pid 1, each ``(label, events)`` simulator timeline under
    pid 2, plus process/thread-name metadata.  Returns the document."""
    spans = sorted_spans(spans)
    tracks: List[Tuple[int, str]] = [(MEASURED_PID, s.track) for s in spans]
    tracks.extend((MEASURED_PID, s.track + " (device)") for s in spans
                  if s.device is not None and None not in s.device)
    sim_timelines = list(sim_timelines or [])
    for _label, evs in sim_timelines:
        tracks.extend((MODELED_PID, tr) for (tr, *_rest) in evs)
    tids = _track_tids(tracks)

    pid_names = {}
    if spans:
        pid_names[MEASURED_PID] = "measured (tracer)"
    if sim_timelines:
        pid_names[MODELED_PID] = "modeled (simulator)"
    trace_events = _meta_events(tids, pid_names)

    for s in spans:
        tid = tids[(MEASURED_PID, s.track)]
        base = {"name": s.name, "cat": s.cat or "repro", "pid": MEASURED_PID,
                "tid": tid, "ts": s.start * _US}
        args = s.args or {}
        if s.parent is not None:
            args = {**args, "sid": s.sid, "parent": s.parent}
        kind = s.kind
        if kind == "counter":
            base.update(ph="C", args=s.args or {"value": 0})
        elif kind == "span":
            end = s.end if s.end is not None else s.start
            base.update(ph="X", dur=(end - s.start) * _US, args=args)
        else:
            base.update(ph="i", s="t", args=args)
        trace_events.append(base)
        if s.device is not None and None not in s.device:
            a, b = s.device
            trace_events.append(
                {**base, "ph": "X", "ts": a * _US, "dur": (b - a) * _US,
                 "tid": tids[(MEASURED_PID, s.track + " (device)")]})

    for label, evs in sim_timelines:
        prefix = f"{label}: " if label else ""
        for (track, name, t0, t1, args) in evs:
            trace_events.append(
                {"name": prefix + name, "cat": "simulator", "ph": "X",
                 "pid": MODELED_PID, "tid": tids[(MODELED_PID, track)],
                 "ts": t0 * _US, "dur": (t1 - t0) * _US, "args": args or {}})

    doc = {"traceEvents": trace_events, "displayTimeUnit": "ms",
           "otherData": {"schema": "repro/perfetto/v1"}}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=indent, sort_keys=True)
    return doc
