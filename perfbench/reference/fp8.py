"""The control: the reference's products one precision below the served
bf16, in fp8 as an fp8 GEMM would take them.

Each operand is scaled to e4m3's range and rounded, the left one row by
row and the right one column by column; the product of the rounded
operands is taken in f32.
"""
from __future__ import annotations

import torch

_E4M3_MAX = 448.0


def quantize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale a slice along ``dim`` (the
    slice's largest magnitude maps to the format's largest), back in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = _E4M3_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return quantize(x, -1) @ quantize(w, -2)
