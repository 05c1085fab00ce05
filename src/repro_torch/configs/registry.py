"""Architecture registry of the port: ``--arch <id>`` resolution.

Architectures join as their model families are ported: the dense
phi4-mini, the MoE qwen3-moe-30b-a3b, the SSM mamba2-370m and the hybrid
zamba2-7b."""
from __future__ import annotations

from typing import List

from repro_torch.configs import (mamba2_370m, phi4_mini, qwen3_moe_30b_a3b,
                                  zamba2_7b)
from repro_torch.nn.config import ModelConfig

_MODULES = {
    "phi4-mini-3.8b": phi4_mini,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "mamba2-370m": mamba2_370m,
    "zamba2-7b": zamba2_7b,
}

ARCH_IDS: List[str] = sorted(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    try:
        mod = _MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return mod.SMOKE if smoke else mod.FULL
