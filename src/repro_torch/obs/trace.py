"""Structured tracing: spans/events with an injectable clock (DESIGN.md §11).

A :class:`Tracer` records :class:`Span` objects — durations (``kind="span"``),
instants (``kind="event"``) and counter samples (``kind="counter"``) — each
on a named *track* (one Perfetto row: ``selection``, ``engine``, ``core3``,
``dma`` ...).  Span ids are a monotone counter, so ids sort in emission
order; the clock is injectable, so a test with a fixed fake clock gets a
byte-deterministic trace.  ``Tracer.to_json``/``from_json`` round-trip the
full schema; the Chrome/Perfetto ``trace.json`` exporter is
:mod:`repro_torch.obs.perfetto`.

A span opened inside another on the same thread records the outer one's
sid as its ``parent``, so a layer's self time is its duration less its
children's.  A span opened with ``device=True`` also keeps a device
interval: CUDA events recorded on the current stream when it opens and
closes (the host clock on the CPU).  :meth:`Tracer.settle`, called right
after a synchronisation the caller makes anyway, anchors the marks
recorded so far: one event recorded then, paired with :meth:`Tracer.now`.
:meth:`Tracer.read` later places each anchored mark on the tracer's own
clock (one ``elapsed_time`` a mark), at a time when the device has work
queued, so the reads do not keep it idle.  Host and device times of one
tracer are so on one clock and can be subtracted.  While a
``torch.profiler`` records, every span opened as a context also opens a
``record_function`` range of its name, so the program's spans appear in
the profiler's trace on the profiler's clock.

Off by default: the module-global tracer is ``None`` until
:func:`set_tracer` installs one.  The instrumentation helpers (:func:`span`,
:func:`event`, :func:`counter`) cost one global load + ``is None`` check and
allocate NOTHING on the disabled path — :func:`span` returns a module
singleton no-op context manager, and ``Span.allocated`` (a class-level
counter) lets tests pin the zero-allocation claim.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


class Span:
    """One trace record.  ``kind`` in {"span", "event", "counter"}; ``end``
    is None until the span closes (instants/counters keep it == start).
    ``parent`` is the sid of the span it was opened in, or None;
    ``device`` the [start, end] of a device-timed span on the tracer's
    clock, each None until settled."""

    __slots__ = ("sid", "name", "cat", "track", "start", "end", "args",
                 "parent", "device")
    allocated = 0              # class-level: total Span objects ever built

    def __init__(self, sid: int, name: str, cat: str, track: str,
                 start: float, end: Optional[float],
                 args: Optional[Dict[str, Any]],
                 parent: Optional[int] = None):
        Span.allocated += 1
        self.sid = sid
        self.name = name
        self.cat = cat
        self.track = track
        self.start = start
        self.end = end
        self.args = args
        self.parent = parent
        self.device: Optional[List[Optional[float]]] = None

    @property
    def kind(self) -> str:
        if self.cat.startswith("counter"):
            return "counter"
        return "span" if self.end is not None and self.end != self.start \
            else "event"

    def to_dict(self) -> Dict[str, Any]:
        d = {"sid": self.sid, "name": self.name, "cat": self.cat,
             "track": self.track, "start": self.start, "end": self.end,
             "args": self.args}
        if self.parent is not None:
            d["parent"] = self.parent
        if self.device is not None:
            d["device"] = list(self.device)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        s = cls(int(d["sid"]), d["name"], d["cat"], d["track"],
                float(d["start"]),
                None if d["end"] is None else float(d["end"]),
                d.get("args"), d.get("parent"))
        if d.get("device") is not None:
            s.device = list(d["device"])
        return s

    def __eq__(self, other) -> bool:
        return (isinstance(other, Span)
                and self.to_dict() == other.to_dict())

    def __repr__(self) -> str:
        return (f"Span(sid={self.sid}, name={self.name!r}, "
                f"track={self.track!r}, start={self.start}, end={self.end})")


Mark = Any          # a CUDA event, or a float time on the marking clock


class EventTimer:
    """Device time with no host sync: on the card a mark is a CUDA event
    recorded on the current stream, read only once a synchronisation the
    caller makes anyway has passed it; on the CPU it is ``clock()``.

    A mark costs the host a few µs: events once read are recorded again
    (:meth:`recycle`), since creating one costs about as much as two
    records, and the current stream is looked up again only when its
    handle changed (``torch.cuda.current_stream`` costs more than a
    record)."""

    def __init__(self, cuda: bool,
                 clock: Callable[[], float] = time.perf_counter):
        self.cuda = cuda
        self.clock = clock
        self._free: List[Any] = []         # events read: record again
        self._stream: Tuple[Any, Any] = (None, None)   # (handle, Stream)

    def mark(self) -> Mark:
        if not self.cuda:
            return self.clock()
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record(self._current_stream())
        return ev

    def _current_stream(self):
        dev = torch.cuda.current_device()
        handle = (dev, torch._C._cuda_getCurrentRawStream(dev))
        if self._stream[0] != handle:
            self._stream = (handle, torch.cuda.current_stream(dev))
        return self._stream[1]

    def recycle(self, marks: Sequence[Mark]) -> None:
        """Take back marks that have been read, each event once, to record
        again."""
        if not self.cuda:
            return
        have = {id(m) for m in self._free}
        for m in marks:
            if id(m) not in have:
                have.add(id(m))
                self._free.append(m)

    @staticmethod
    def seconds(a: Mark, b: Mark) -> float:
        """Seconds from mark ``a`` to mark ``b`` (events: both passed)."""
        if isinstance(a, float):
            return b - a
        return a.elapsed_time(b) / 1e3

    def anchor(self) -> Tuple[Mark, float]:
        """(a mark, ``clock()`` beside it); call right after a
        synchronisation, so the device reaches the mark at once (its
        launch latency, a few µs, is the anchor's error)."""
        m = self.mark()
        t = self.clock()
        if self.cuda:
            m.synchronize()          # the device is idle: the mark alone
        return m, t

    @staticmethod
    def place(mark: Mark, anchor: Tuple[Mark, float]) -> float:
        """``mark`` on the clock, through an anchor taken after it."""
        if isinstance(mark, float):
            return mark
        ev, t = anchor
        return t - mark.elapsed_time(ev) / 1e3


class _OpenSpan:
    """Context manager around one span: pushes it as the thread's
    innermost open span, stamps ``end`` on exit; with ``device`` marks the
    device at both ends; opens a profiler range while one records.  Only
    allocated when tracing is ON."""

    __slots__ = ("_tracer", "_span", "_device", "_follows", "_rf")

    def __init__(self, tracer: "Tracer", span: Span, device: bool,
                 follows: bool = False):
        self._tracer = tracer
        self._span = span
        self._device = device
        self._follows = follows
        self._rf = None

    def __enter__(self) -> Span:
        tr = self._tracer
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self._span.name)
            self._rf.__enter__()
        tr._stack().append(self._span.sid)
        if self._device:
            self._span.device = [None, None]
            last = tr._tls.last if self._follows else None
            tr.place(self._span, 0, last if last is not None else tr.mark())
        return self._span

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        end = None
        if self._device:
            end = tr.mark()
            tr.place(self._span, 1, end)
        tr._tls.last = end
        self._span.end = tr.now()
        stack = tr._stack()
        if stack and stack[-1] == self._span.sid:
            stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)


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
        self._tls = threading.local()
        self._timer: Optional[EventTimer] = None
        self._pending: List[Tuple[Span, Any, Mark]] = []   # not anchored
        self._anchored: List[Tuple[Tuple[Mark, float], List]] = []
        self.spans: List[Span] = []

    def now(self) -> float:
        return self._clock()

    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
            self._tls.last = None     # the device end of the last span
        return st

    def _emit(self, name: str, cat: str, track: str, start: float,
              end: Optional[float], args: Optional[Dict],
              parent: Optional[int] = None) -> Span:
        s = Span(self._next, name, cat, track, start, end, args, parent)
        self._next += 1
        self.spans.append(s)
        return s

    def _events(self) -> EventTimer:
        """The tracer's timer: CUDA events once the process uses the
        card, the tracer's clock before."""
        if self._timer is None or (not self._timer.cuda
                                   and torch.cuda.is_initialized()):
            self._timer = EventTimer(torch.cuda.is_initialized(), self.now)
        return self._timer

    def span(self, name: str, cat: str = "", track: str = "main",
             args: Optional[Dict] = None, device: bool = False,
             follows: bool = False) -> _OpenSpan:
        """Open a duration span; closes (stamps ``end``) on ``__exit__``.
        Its parent is the thread's innermost open span; ``device`` also
        times it on the device (placed by :meth:`settle`, :meth:`read`).
        ``follows``: a device-timed span starts at the device end of the
        span that closed last on this thread, one event for both (each
        timing event leaves the device a few µs idle); work launched in
        between counts in it."""
        stack = self._stack()
        return _OpenSpan(self, self._emit(name, cat, track, self.now(),
                                          None, args,
                                          stack[-1] if stack else None),
                         device, follows)

    def open(self, name: str, cat: str = "", track: str = "main",
             args: Optional[Dict] = None) -> Span:
        """A span that outlives the call that opens it (a request's queue
        wait or life), closed by :meth:`close`: no parent, and never the
        parent of another."""
        return self._emit(name, cat, track, self.now(), None, args)

    def close(self, span: Span, device_end: Optional[Mark] = None) -> None:
        """Stamp ``span``'s end; with ``device_end`` (a :meth:`mark`) its
        device interval runs from its host start to that mark."""
        span.end = self.now()
        if device_end is not None:
            span.device = [span.start, None]
            self.place(span, 1, device_end)

    def mark(self) -> Mark:
        """A point on the device's timeline (the host clock on the CPU),
        for :meth:`place` or :meth:`close`."""
        return self._events().mark()

    def place(self, span: Span, key, mark: Mark) -> None:
        """Set ``span.device[key]`` (key 0 or 1) or ``span.args[key]`` (a
        name) to ``mark``'s time on this tracer's clock: now on the CPU,
        on the card at the :meth:`read` after the next :meth:`settle`."""
        if isinstance(mark, float):
            self._put(span, key, mark)
        else:
            self._pending.append((span, key, mark))

    @staticmethod
    def _put(span: Span, key, t: float) -> None:
        if isinstance(key, int):
            span.device[key] = t
        else:
            if span.args is None:
                span.args = {}
            span.args[key] = t

    def settle(self) -> None:
        """Anchor the marks recorded so far.  Call only right after a
        device synchronisation: each mark has passed, and an anchor taken
        now pairs the device's timeline with the clock."""
        if self._pending:
            self._anchored.append((self._events().anchor(), self._pending))
            self._pending = []

    def read(self) -> None:
        """Place every anchored mark on the tracer's clock (marks not yet
        anchored by :meth:`settle` stay pending)."""
        pending = {id(m) for _, _, m in self._pending}
        for anchor, marks in self._anchored:
            for span, key, mark in marks:
                self._put(span, key, EventTimer.place(mark, anchor))
            self._timer.recycle([m for _, _, m in marks
                                 if id(m) not in pending] + [anchor[0]])
        self._anchored.clear()

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
        self.read()
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
         args: Optional[Dict] = None, device: bool = False,
         follows: bool = False):
    """Context manager: a real span when tracing is on, the shared no-op
    singleton (zero allocations) when off."""
    if _TRACER is None:
        return NULL_SPAN
    return _TRACER.span(name, cat, track, args, device, follows)


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
