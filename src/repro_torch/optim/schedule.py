"""Learning-rate schedules (the port of ``repro/optim/schedule.py``): a
function of the int step that returns a float, computed in f32 as the
reference computes it."""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``floor * peak_lr`` at ``total_steps``."""
    def schedule(step: int) -> float:
        s = _f32(step)
        warm = peak_lr * s / max(warmup_steps, 1)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(_f32(math.pi) * frac)))
        return float(warm if step < warmup_steps else cos)
    return schedule


def constant(lr: float) -> Schedule:
    return lambda step: float(_f32(lr))
