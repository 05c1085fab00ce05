"""Fault-tolerance machinery for thousand-node runs.

* ``StragglerMonitor`` — rolling z-score over step times; flags slow steps
  (ICI neighbor stalls, host paging) so the launcher can alert/evict.
* ``retry`` — bounded, full-jitter exponential backoff around a step
  function; transient runtime errors (preempted device, DMA timeout)
  retry, deterministic errors re-raise immediately.
* ``PreemptionGuard`` — SIGTERM/SIGINT hook that flips a flag the train
  loop polls to checkpoint-and-exit cleanly inside the grace period.
  Context-manager support restores the previous handlers on exit.
* ``Heartbeat`` — liveness file another process/agent can watch; writes
  are atomic (temp file + ``os.replace``) so a reader never observes an
  empty or partial file.
"""
from __future__ import annotations

import os
import random
import signal
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, List, Optional, Sequence, Tuple)


class StragglerMonitor:
    def __init__(self, window: int = 50, z_threshold: float = 4.0,
                 min_steps: int = 10):
        self.times: Deque[float] = deque(maxlen=window)
        self.dispatch_times: Deque[float] = deque(maxlen=window)
        self.z = z_threshold
        self.min_steps = min_steps
        self.flagged: List[Tuple[int, float, float]] = []
        self._step = 0

    def record(self, seconds: float,
               dispatch_s: Optional[float] = None) -> Optional[str]:
        """Record one step.  ``seconds`` is the step's wall/device time the
        z-score watches; ``dispatch_s`` optionally tracks the host-side
        enqueue cost separately — an async decode loop that never blocks
        has ~µs dispatches, and a dispatch that creeps toward the device
        time means the host round-trips (the bug this channel surfaces)."""
        self._step += 1
        msg = None
        if dispatch_s is not None:
            self.dispatch_times.append(dispatch_s)
        if len(self.times) >= self.min_steps:
            mean = sum(self.times) / len(self.times)
            var = sum((t - mean) ** 2 for t in self.times) / len(self.times)
            std = max(var ** 0.5, 1e-9)
            z = (seconds - mean) / std
            if z > self.z and seconds > 1.5 * mean:
                self.flagged.append((self._step, seconds, z))
                msg = (f"straggler: step {self._step} took {seconds:.3f}s "
                       f"(z={z:.1f}, mean={mean:.3f}s)")
        self.times.append(seconds)
        return msg

    def dispatch_mean(self) -> float:
        """Mean host-side dispatch seconds over the window (0.0 if the
        caller never supplied the channel)."""
        if not self.dispatch_times:
            return 0.0
        return sum(self.dispatch_times) / len(self.dispatch_times)


_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
    "preempted", "Socket closed", "transient",
)


def is_transient(err: Exception,
                 extra_markers: Sequence[str] = ()) -> bool:
    s = repr(err)
    return any(m in s for m in (*_TRANSIENT_MARKERS, *extra_markers))


def retry(fn: Callable, *args, retries: int = 3, base_delay: float = 0.5,
          max_delay: float = 30.0,
          transient_markers: Sequence[str] = (),
          on_retry: Optional[Callable[[int, Exception], None]] = None,
          rng: Optional[random.Random] = None,
          **kwargs):
    """Run fn with bounded, full-jitter exponential backoff on *transient*
    errors.

    The backoff ceiling grows as ``base_delay * 2**attempt`` but is capped
    at ``max_delay`` (the unbounded seed formula slept 2+ minutes by
    attempt 8), and the actual sleep is drawn uniformly from
    ``[0, ceiling]`` — AWS-style full jitter, so a thundering herd of
    preempted replicas does not retry in lockstep.  ``transient_markers``
    extends the built-in marker set per call site (e.g. a serving stack
    whose collective layer surfaces its own error strings).  ``rng`` pins
    the jitter draw for deterministic tests (defaults to the module
    ``random``)."""
    draw = (rng or random).uniform
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:                      # noqa: BLE001
            if attempt >= retries or not is_transient(e, transient_markers):
                raise
            if on_retry:
                on_retry(attempt, e)
            ceiling = min(base_delay * (2 ** attempt), max_delay)
            time.sleep(draw(0.0, ceiling))
            attempt += 1


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers; loop polls .should_stop.

    Use as a context manager (or call :meth:`uninstall`) to restore the
    previous handlers — a guard that leaks its handlers past the serving
    loop turns every later Ctrl-C into a silent flag flip."""

    def __init__(self, install: bool = True):
        self._stop = threading.Event()
        self._prev = {}
        if install:
            self.install()

    def install(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass                                 # non-main thread

    def uninstall(self) -> None:
        """Restore the handlers that were active before install()."""
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev = {}

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _handler(self, signum, frame):
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def request_stop(self):
        self._stop.set()


class Heartbeat:
    """Writes a monotonically-increasing liveness timestamp to a file.

    Writes go to a temp file in the same directory followed by
    ``os.replace`` (the selection cache's atomic-write convention): a
    watcher reading between the old truncate-then-write steps could
    observe an empty or half-written file and declare the process dead."""

    def __init__(self, path: str, interval: float = 10.0):
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def beat(self) -> None:
        """Write one liveness timestamp now (atomic)."""
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".hb.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(f"{time.time():.3f}\n")
            os.replace(tmp, self.path)
        except OSError:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def _run(self):
        while not self._stop.wait(self.interval):
            self.beat()

    def close(self):
        self._stop.set()

