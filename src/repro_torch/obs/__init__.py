"""Telemetry: trace spans and the metrics registry (copied; no deps)."""
