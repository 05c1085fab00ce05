"""Step metrics: rolling stats + JSONL logging (the port of
``repro/runtime/metrics.py``, the same record keys).

``MetricLogger`` writes through :class:`repro_torch.obs.metrics.JsonlSink`
(append mode, directory creation, a flush per record)."""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional

from repro_torch.obs.metrics import JsonlSink


class MetricLogger:
    def __init__(self, path: Optional[str] = None, window: int = 20):
        self.path = path
        self.window = deque(maxlen=window)
        self._sink = JsonlSink(path) if path else None

    def log(self, step: int, **metrics: Any) -> Dict:
        rec: Dict[str, Any] = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if "step_time" in rec:
            self.window.append(rec["step_time"])
            rec["steps_per_s"] = (len(self.window)
                                  / max(sum(self.window), 1e-9))
        if self._sink is not None:
            self._sink.write(rec)
        return rec

    def close(self):
        if self._sink is not None:
            self._sink.close()
            self._sink = None
