"""Fault-tolerance helpers (retry, preemption guard, straggler monitor)
and the training driver's metric logger."""
from repro_torch.runtime.fault_tolerance import (Heartbeat, PreemptionGuard,
                                                 StragglerMonitor,
                                                 elastic_reshard,
                                                 is_transient, retry)
from repro_torch.runtime.metrics import MetricLogger

__all__ = ["Heartbeat", "PreemptionGuard", "StragglerMonitor",
           "elastic_reshard", "is_transient", "retry", "MetricLogger"]
