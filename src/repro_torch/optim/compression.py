"""Gradient compression for the data axis: int8 quantization with error
feedback (the port of ``repro/optim/compression.py``).

The collective moves int8: ``compressed_psum`` all-gathers each rank's
int8 tensor and its scale over the data group and reduces locally, 1/4 of
the bytes of an f32 all-reduce (1/2 of bf16).  Error feedback keeps the
quantization bias out of the trajectory (Seide et al.; Karimireddy et al.
2019).  The reference's train driver names a ``--compress-dp`` flag in its
docstring only (``repro/launch/train.py:12-13``; its parser has none), so
the port's driver has none either; these are library functions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed.collectives import all_gather_dim


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q, the f32 scale amax / 127, or 1 for
    an all-zero tensor).  The scale is taken in ``x``'s dtype, then f32,
    as the reference does."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(q, scale, new_err): ``err`` accumulates what int8 dropped."""
    y = g.to(torch.float32) + err
    q, scale = quantize_int8(y)
    return q, scale, y - dequantize_int8(q, scale)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean of ``g`` over ``group`` with int8 on the wire: every
    rank's int8 tensor and scale all-gathered, then dequantised and summed
    here.  Returns (the f32 mean, this rank's new error)."""
    q, scale, new_err = compress_with_feedback(g, err)
    qs = all_gather_dim(q[None], 0, group)              # int8 on the wire
    ss = all_gather_dim(scale.reshape(1), 0, group)
    total = torch.tensordot(ss, qs.to(torch.float32), dims=([0], [0]))
    return total / qs.shape[0], new_err
