"""The single dtype byte-width table (satellite of the topology refactor).

Before this module the byte widths lived in three drifting copies —
``core/hardware.DTYPE_BYTES`` (numpy-style names), ``core/roofline``'s
private HLO-short-name table, and literal ``4``s for the f32 accumulator
sprinkled through the latency model and simulator.  Everything now reads
from here; ``core.hardware`` re-exports ``DTYPE_BYTES`` for compatibility.
"""
from __future__ import annotations

from typing import Dict

# Canonical (numpy-style) dtype names -> bytes per element.
DTYPE_BYTES: Dict[str, int] = {
    "float64": 8,
    "float32": 4,
    "float16": 2,
    "bfloat16": 2,
    "float8_e4m3fn": 1,
    "float8_e5m2": 1,
    "int64": 8,
    "int32": 4,
    "int16": 2,
    "int8": 1,
    "uint64": 8,
    "uint32": 4,
    "uint16": 2,
    "uint8": 1,
    "bool": 1,
}

# HLO shape-literal short names (as printed in HLO text dumps) -> canonical.
HLO_ALIASES: Dict[str, str] = {
    "f64": "float64", "f32": "float32", "f16": "float16", "bf16": "bfloat16",
    "f8e4m3fn": "float8_e4m3fn", "f8e5m2": "float8_e5m2",
    "s64": "int64", "s32": "int32", "s16": "int16", "s8": "int8",
    "u64": "uint64", "u32": "uint32", "u16": "uint16", "u8": "uint8",
    "pred": "bool",
}

# HLO short name -> bytes, derived (the table roofline.py parses shapes with).
HLO_DTYPE_BYTES: Dict[str, int] = {
    short: DTYPE_BYTES[canon] for short, canon in HLO_ALIASES.items()
}

# The kernels accumulate in f32 scratch; every accumulator byte term in the
# model and the simulator prices this width.
ACC_DTYPE = "float32"
ACC_BYTES = DTYPE_BYTES[ACC_DTYPE]


def canonical_dtype(name: str) -> str:
    """Resolve an HLO short name or canonical name to the canonical name."""
    if name in DTYPE_BYTES:
        return name
    if name in HLO_ALIASES:
        return HLO_ALIASES[name]
    raise KeyError(
        f"unknown dtype {name!r}; known: {sorted(DTYPE_BYTES)} "
        f"(HLO aliases: {sorted(HLO_ALIASES)})")


def dtype_bytes(name: str) -> int:
    """Bytes per element for a canonical or HLO-short dtype name."""
    return DTYPE_BYTES[canonical_dtype(name)]
