"""Process-global metrics registry: counters / gauges / histograms
(DESIGN.md §11).

A :class:`MetricsRegistry` owns named instruments, optionally labeled
(``registry.counter("selections_total", labels={"source": "cold"})``), and
exports two ways: one JSONL record per :meth:`MetricsRegistry.jsonl_record`
call (append-friendly, the :class:`JsonlSink` convention
``runtime.metrics.MetricLogger`` shares) and the Prometheus textfile format
(:meth:`MetricsRegistry.to_prometheus`) a node-exporter textfile collector
scrapes verbatim.

Two usage modes:

* **Per-run registries** are plain objects — the serving engine builds one
  per ``run()`` so its public stats stay per-run, then
  :meth:`MetricsRegistry.merge`-publishes into the process-global registry.
* **Fire-and-forget instrumentation** uses the module helpers :func:`inc`,
  :func:`set_gauge`, :func:`observe` against the process-global
  :data:`REGISTRY`.  These are gated by :func:`enable_metrics` — off by
  default, one module-global bool check when disabled.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


class Histogram:
    __slots__ = ("name", "labels", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, labels: LabelKey = (),
                 bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)      # +inf bucket last
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.sum += v
        self.count += 1


class MetricsRegistry:
    """Named, optionally-labeled instruments with get-or-create semantics.
    A name is one type forever — re-registering with another type raises."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelKey], Any] = {}
        self._types: Dict[str, type] = {}

    def _get(self, cls, name: str, labels: Optional[Mapping[str, str]],
             **kw):
        known = self._types.get(name)
        if known is not None and known is not cls:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{known.__name__}, requested {cls.__name__}")
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(name, key[1], **kw)
            self._types[name] = cls
        return m

    def counter(self, name: str,
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str,
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  labels: Optional[Mapping[str, str]] = None,
                  bounds: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def metrics(self) -> List[Any]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def clear(self) -> None:
        self._metrics.clear()
        self._types.clear()

    def merge(self, other: "MetricsRegistry") -> None:
        """Publish ``other`` into this registry: counters add, gauges take
        the other's (newer) value, histograms add bucket-wise."""
        for (name, lk), m in sorted(other._metrics.items()):
            if isinstance(m, Counter):
                self._get(Counter, name, dict(lk)).inc(m.value)
            elif isinstance(m, Gauge):
                self._get(Gauge, name, dict(lk)).set(m.value)
            else:
                h = self._get(Histogram, name, dict(lk), bounds=m.bounds)
                if h.bounds != m.bounds:
                    raise ValueError(
                        f"histogram {name!r} bucket bounds differ")
                for i, c in enumerate(m.counts):
                    h.counts[i] += c
                h.sum += m.sum
                h.count += m.count

    # -- exporters ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Flat name{labels} -> value dict (histograms: sum/count/buckets)."""
        out: Dict[str, Any] = {}
        for m in self.metrics():
            key = m.name + _label_str(m.labels)
            if isinstance(m, Histogram):
                out[key] = {"sum": m.sum, "count": m.count,
                            "buckets": dict(zip(
                                [*map(str, m.bounds), "+Inf"], m.counts))}
            else:
                out[key] = m.value
        return out

    def jsonl_record(self, **extra: Any) -> Dict[str, Any]:
        rec = dict(extra)
        rec["metrics"] = self.snapshot()
        return rec

    def write_jsonl(self, path: str, **extra: Any) -> None:
        with JsonlSink(path) as sink:
            sink.write(self.jsonl_record(**extra))

    def to_prometheus(self) -> str:
        lines: List[str] = []
        seen_type: Dict[str, str] = {}
        for m in self.metrics():
            if m.name not in seen_type:
                t = {Counter: "counter", Gauge: "gauge",
                     Histogram: "histogram"}[type(m)]
                seen_type[m.name] = t
                lines.append(f"# TYPE {m.name} {t}")
            ls = _label_str(m.labels)
            if isinstance(m, Histogram):
                acc = 0
                for b, c in zip([*self._fmt_bounds(m), "+Inf"], m.counts):
                    acc += c
                    lb = dict(m.labels)
                    lb["le"] = b
                    lines.append(
                        f"{m.name}_bucket{_label_str(_label_key(lb))} {acc}")
                lines.append(f"{m.name}_sum{ls} {m.sum}")
                lines.append(f"{m.name}_count{ls} {m.count}")
            else:
                lines.append(f"{m.name}{ls} {m.value}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def _fmt_bounds(h: Histogram) -> List[str]:
        return [repr(b) for b in h.bounds]

    def write_prometheus(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)


class JsonlSink:
    """Append-mode JSONL writer: one ``json.dumps`` line per record,
    flushed per write (a watcher tails live), context-manager + ``__del__``
    closed.  The single file-writing primitive the metrics registry and the
    legacy ``runtime.metrics.MetricLogger`` shim share."""

    def __init__(self, path: str, mode: str = "a"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, mode)
        self.path = path

    def write(self, record: Mapping[str, Any]) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):                                  # pragma: no cover
        try:
            self.close()
        except Exception:                               # noqa: BLE001
            pass


# ---------------------------------------------------------------------------
# Process-global registry + gated fire-and-forget helpers.
# ---------------------------------------------------------------------------

REGISTRY = MetricsRegistry()
_ENABLED = False


def get_registry() -> MetricsRegistry:
    return REGISTRY


def enable_metrics(on: bool = True) -> bool:
    """Switch the fire-and-forget helpers on/off; returns the previous
    state.  The registry object itself always works — this gates only the
    instrumentation call sites, so the disabled hot path costs one bool."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def metrics_enabled() -> bool:
    return _ENABLED


def inc(name: str, n: int = 1,
        labels: Optional[Mapping[str, str]] = None) -> None:
    if _ENABLED:
        REGISTRY.counter(name, labels).inc(n)


def set_gauge(name: str, value: float,
              labels: Optional[Mapping[str, str]] = None) -> None:
    if _ENABLED:
        REGISTRY.gauge(name, labels).set(value)


def observe(name: str, value: float,
            labels: Optional[Mapping[str, str]] = None) -> None:
    if _ENABLED:
        REGISTRY.histogram(name, labels).observe(value)
