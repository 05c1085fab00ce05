"""Architecture registry of the port: ``--arch <id>`` resolution for all
ten architectures of the JAX package (+ smoke variants), and its (arch,
shape) cells."""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs import (internlm2_20b, llava_next_mistral_7b,
                                  mamba2_370m, minitron_8b, mixtral_8x22b,
                                  musicgen_large, phi4_mini,
                                  qwen3_moe_30b_a3b, stablelm_12b, zamba2_7b)
from repro_torch.nn.config import (SHAPES, ModelConfig, ShapeSpec,
                                   shape_applicable)

_MODULES = {
    "musicgen-large": musicgen_large,
    "phi4-mini-3.8b": phi4_mini,
    "minitron-8b": minitron_8b,
    "stablelm-12b": stablelm_12b,
    "internlm2-20b": internlm2_20b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "mamba2-370m": mamba2_370m,
    "mixtral-8x22b": mixtral_8x22b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "zamba2-7b": zamba2_7b,
}

ARCH_IDS: List[str] = sorted(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    try:
        mod = _MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return mod.SMOKE if smoke else mod.FULL


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def all_cells(include_skipped: bool = False
              ) -> List[Tuple[str, str, bool, str]]:
    """Every (arch, shape) cell with its applicability.

    Returns tuples (arch, shape_name, runs, skip_reason)."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, sspec in SHAPES.items():
            ok, why = shape_applicable(cfg, sspec)
            if ok or include_skipped:
                cells.append((arch, sname, ok, why))
    return cells
