"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the dense phi4-mini path is ported so far; other architectures join
as their model families are ported."""
from __future__ import annotations

from typing import List

from repro_torch.configs import phi4_mini
from repro_torch.nn.config import ModelConfig

_MODULES = {
    "phi4-mini-3.8b": phi4_mini,
}

ARCH_IDS: List[str] = sorted(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    try:
        mod = _MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return mod.SMOKE if smoke else mod.FULL
