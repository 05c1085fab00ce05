"""Structured tracing: spans/events with an injectable clock (DESIGN.md §11).

A :class:`Tracer` records :class:`Span` objects — durations (``kind="span"``),
instants (``kind="event"``) and counter samples (``kind="counter"``) — each
on a named *track* (one Perfetto row: ``selection``, ``engine``, ``core3``,
``dma`` ...).  Span ids are a monotone counter, so ids sort in emission
order; the clock is injectable, so a test with a fixed fake clock gets a
byte-deterministic trace.  ``Tracer.to_json``/``from_json`` round-trip the
full schema; the Chrome/Perfetto ``trace.json`` exporter is
:mod:`repro_torch.obs.perfetto`.

Off by default: the module-global tracer is ``None`` until
:func:`set_tracer` installs one.  The instrumentation helpers (:func:`span`,
:func:`event`, :func:`counter`) cost one global load + ``is None`` check and
allocate NOTHING on the disabled path — :func:`span` returns a module
singleton no-op context manager, and ``Span.allocated`` (a class-level
counter) lets tests pin the zero-allocation claim.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence


class Span:
    """One trace record.  ``kind`` in {"span", "event", "counter"}; ``end``
    is None until the span closes (instants/counters keep it == start)."""

    __slots__ = ("sid", "name", "cat", "track", "start", "end", "args")
    allocated = 0              # class-level: total Span objects ever built

    def __init__(self, sid: int, name: str, cat: str, track: str,
                 start: float, end: Optional[float],
                 args: Optional[Dict[str, Any]]):
        Span.allocated += 1
        self.sid = sid
        self.name = name
        self.cat = cat
        self.track = track
        self.start = start
        self.end = end
        self.args = args

    @property
    def kind(self) -> str:
        if self.cat.startswith("counter"):
            return "counter"
        return "span" if self.end is not None and self.end != self.start \
            else "event"

    def to_dict(self) -> Dict[str, Any]:
        return {"sid": self.sid, "name": self.name, "cat": self.cat,
                "track": self.track, "start": self.start, "end": self.end,
                "args": self.args}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        return cls(int(d["sid"]), d["name"], d["cat"], d["track"],
                   float(d["start"]),
                   None if d["end"] is None else float(d["end"]),
                   d.get("args"))

    def __eq__(self, other) -> bool:
        return (isinstance(other, Span)
                and self.to_dict() == other.to_dict())

    def __repr__(self) -> str:
        return (f"Span(sid={self.sid}, name={self.name!r}, "
                f"track={self.track!r}, start={self.start}, end={self.end})")


class _OpenSpan:
    """Context manager closing one span on exit (reused per ``Tracer.span``
    call; only allocated when tracing is ON)."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, *exc) -> None:
        self._span.end = self._tracer.now()


class _NullSpan:
    """The disabled path's context manager: a module singleton, allocates
    nothing, yields None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans.  ``clock`` is injectable (defaults to a zero-based
    ``time.perf_counter``) so tests can pin timestamps; span ids count up
    from 0 in emission order."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        if clock is None:
            t0 = time.perf_counter()
            clock = lambda: time.perf_counter() - t0        # noqa: E731
        self._clock = clock
        self._next = 0
        self.spans: List[Span] = []

    def now(self) -> float:
        return self._clock()

    def _emit(self, name: str, cat: str, track: str, start: float,
              end: Optional[float], args: Optional[Dict]) -> Span:
        s = Span(self._next, name, cat, track, start, end, args)
        self._next += 1
        self.spans.append(s)
        return s

    def span(self, name: str, cat: str = "", track: str = "main",
             args: Optional[Dict] = None) -> _OpenSpan:
        """Open a duration span; closes (stamps ``end``) on ``__exit__``."""
        return _OpenSpan(self, self._emit(name, cat, track, self.now(),
                                          None, args))

    def complete(self, name: str, cat: str, track: str, start: float,
                 end: float, args: Optional[Dict] = None) -> Span:
        """Record an already-timed span (the simulator-timeline path)."""
        return self._emit(name, cat, track, start, end, args)

    def event(self, name: str, cat: str = "", track: str = "main",
              args: Optional[Dict] = None) -> Span:
        t = self.now()
        return self._emit(name, cat, track, t, t, args)

    def counter(self, name: str, value: float,
                track: str = "counters") -> Span:
        t = self.now()
        return self._emit(name, "counter", track, t, t, {"value": value})

    # -- serialization ------------------------------------------------------

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({"schema": "repro/trace/v1",
                           "spans": [s.to_dict() for s in self.spans]},
                          indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> List[Span]:
        d = json.loads(text)
        if d.get("schema") != "repro/trace/v1":
            raise ValueError(f"not a repro trace: schema={d.get('schema')!r}")
        return [Span.from_dict(sd) for sd in d["spans"]]


# ---------------------------------------------------------------------------
# Module-global tracer: the instrumented call sites' single switch.
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or with None remove) the process tracer; returns the
    previous one so tests/benchmarks can restore it."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER is not None


def span(name: str, cat: str = "", track: str = "main",
         args: Optional[Dict] = None):
    """Context manager: a real span when tracing is on, the shared no-op
    singleton (zero allocations) when off."""
    if _TRACER is None:
        return NULL_SPAN
    return _TRACER.span(name, cat, track, args)


def event(name: str, cat: str = "", track: str = "main",
          args: Optional[Dict] = None) -> None:
    if _TRACER is not None:
        _TRACER.event(name, cat, track, args)


def counter(name: str, value: float, track: str = "counters") -> None:
    if _TRACER is not None:
        _TRACER.counter(name, value, track)


def sorted_spans(spans: Sequence[Span]) -> List[Span]:
    """Spans in deterministic order: by (start, sid) — sid breaks every tie
    because ids are emission-ordered."""
    return sorted(spans, key=lambda s: (s.start, s.sid))
