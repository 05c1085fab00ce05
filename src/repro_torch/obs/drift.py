"""Model-vs-measured drift monitor (DESIGN.md §11).

Every executed GEMM (or serving step) whose latency the analytical model
priced can be checked against a measurement: ``DriftMonitor.record`` takes
``(site, shape, config, topology fingerprint, predicted_s, measured_s)``,
appends one JSONL record, and folds the pair into a *rolling fidelity
gauge*

    fidelity = mean over the window of  min(pred, meas) / max(pred, meas)

— 1.0 when the model nails every latency, dropping toward 0 as predictions
drift (an injected 40x outlier measurement visibly dents it; a non-finite
or non-positive sample scores 0.0 instead of poisoning the mean).  The
JSONL stream is exactly the ``(features, residual)`` dataset ROADMAP
item 5's learned-residual corrector trains on; the fingerprint column keys
each row to the topology constants the prediction used.

Drift records carry no wall-clock timestamp by default (``seq`` orders
them); callers that want one pass ``ts=...`` — keeping the default output
byte-deterministic under test.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Mapping, Optional

from repro_torch.obs.metrics import MetricsRegistry, JsonlSink, get_registry

DRIFT_SCHEMA = "repro/drift/v1"


def fidelity_of(predicted_s: float, measured_s: float) -> float:
    """Symmetric accuracy ratio in [0, 1]: 1.0 iff predicted == measured."""
    if not (predicted_s > 0.0 and measured_s > 0.0):
        return 0.0
    if predicted_s != predicted_s or measured_s != measured_s:  # NaN
        return 0.0
    lo, hi = ((predicted_s, measured_s) if predicted_s <= measured_s
              else (measured_s, predicted_s))
    if hi == float("inf"):
        return 0.0
    return lo / hi


class DriftMonitor:
    """Rolling predicted-vs-measured fidelity + JSONL dataset writer.

    ``path`` (optional) appends one JSON line per record; ``registry``
    (default: the process-global) carries the ``drift_fidelity`` gauge and
    the ``drift_records_total`` counter.
    """

    def __init__(self, path: Optional[str] = None, window: int = 64,
                 registry: Optional[MetricsRegistry] = None):
        self._sink = JsonlSink(path) if path else None
        self._window: Deque[float] = deque(maxlen=max(int(window), 1))
        self._registry = registry if registry is not None else get_registry()
        self._seq = 0
        self.records_total = 0

    def record(self, *, site: str, shape, config: Optional[Mapping] = None,
               topo: str = "", predicted_s: float, measured_s: float,
               **extra: Any) -> float:
        """Fold one (predicted, measured) pair in; returns its fidelity.

        ``shape`` is an (M, N, K[, batch]) sequence or any JSON-serializable
        tag; ``config`` the executed TileConfig as a dict (or None for
        non-GEMM sites like whole serving steps); ``topo`` the topology
        fingerprint the prediction was priced against."""
        f = fidelity_of(predicted_s, measured_s)
        self._window.append(f)
        self._seq += 1
        self.records_total += 1
        rolling = self.fidelity()
        reg = self._registry
        reg.counter("drift_records_total").inc()
        reg.gauge("drift_fidelity").set(rolling)
        if self._sink is not None:
            self._sink.write({
                "schema": DRIFT_SCHEMA, "seq": self._seq, "site": site,
                "shape": list(shape) if not isinstance(shape, str)
                else shape,
                "config": dict(config) if config else None, "topo": topo,
                "predicted_s": predicted_s, "measured_s": measured_s,
                "fidelity": f, "rolling_fidelity": rolling, **extra})
        return f

    def record_selection(self, sel, measured_s: float, *,
                         site: str = "gemm", topo: str = "",
                         **extra: Any) -> float:
        """Record straight off a ``repro_torch.core.selector.Selection`` (duck-
        typed — obs never imports core): the attached priced latency
        ``sel.predicted.total`` is the prediction, ``measured_s`` the
        device/simulator time for the SAME config.

        The ``topo`` column defaults to ``sel.topo_fingerprint`` — the
        content hash the selection was priced against — never the preset
        *name* (``sel.hardware``): a name can't be validated against the
        live topology, so name-keyed rows would silently poison the
        residual corrector's training set.  Selections predating the
        fingerprint field leave the column empty."""
        p, c = sel.problem, sel.config
        return self.record(
            site=site, shape=(p.M, p.N, p.K, p.batch),
            config={"bm": c.bm, "bn": c.bn, "bk": c.bk,
                    "split_k": c.split_k, "group_m": c.group_m,
                    "schedule": c.schedule},
            topo=topo or getattr(sel, "topo_fingerprint", "") or "",
            predicted_s=float(sel.predicted.total),
            measured_s=float(measured_s), **extra)

    def fidelity(self) -> float:
        """Rolling mean fidelity over the window (1.0 while empty — no
        evidence of drift)."""
        if not self._window:
            return 1.0
        return sum(self._window) / len(self._window)

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()

    def __enter__(self) -> "DriftMonitor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Module-global monitor: instrumented call sites' single switch (None = off).
# ---------------------------------------------------------------------------

_MONITOR: Optional[DriftMonitor] = None


def set_drift_monitor(mon: Optional[DriftMonitor]) -> Optional[DriftMonitor]:
    """Install (or with None remove) the process drift monitor; returns the
    previous one."""
    global _MONITOR
    prev = _MONITOR
    _MONITOR = mon
    return prev


def get_drift_monitor() -> Optional[DriftMonitor]:
    return _MONITOR


def record_step_drift(*, site: str, shape, predicted_s: float,
                      measured_s: float, topo: str = "",
                      config: Optional[Dict] = None, **extra: Any) -> None:
    """Fire-and-forget helper for instrumented call sites: no-op (one
    ``is None`` check) when no monitor is installed."""
    if _MONITOR is not None:
        _MONITOR.record(site=site, shape=shape, config=config, topo=topo,
                        predicted_s=predicted_s, measured_s=measured_s,
                        **extra)
