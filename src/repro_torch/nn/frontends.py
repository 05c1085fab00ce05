"""Modality frontend stubs (the port of ``repro/nn/frontends.py``).

The audio (musicgen) and vision (llava) families run the transformer
backbone; the EnCodec and vision towers are out of scope in the reference
too.  These helpers give the precomputed frame / patch embeddings the
backbone consumes: their shapes, and synthetic draws for smoke runs and
serving on random weights.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.nn.config import ModelConfig

Spec = Tuple[Tuple[int, ...], torch.dtype]


def frontend_input_specs(cfg: ModelConfig, batch: int, seq: int
                         ) -> Dict[str, Spec]:
    """``{name: (shape, dtype)}`` of the frontend inputs of a (batch, seq)
    token batch: audio adds ``frame_embed`` (B, S, D) to the token
    embeddings, vision puts ``patch_embed`` (B, min(frontend_tokens, S), D)
    in the first positions; both bf16.  Empty for a text-only model."""
    if cfg.frontend == "audio":
        return {"frame_embed": ((batch, seq, cfg.d_model), torch.bfloat16)}
    if cfg.frontend == "vision":
        p = min(cfg.frontend_tokens, seq)
        return {"patch_embed": ((batch, p, cfg.d_model), torch.bfloat16)}
    return {}


def synth_frontend_inputs(cfg: ModelConfig, generator: torch.Generator,
                          batch: int, seq: int, *,
                          device: Union[str, torch.device] = "cpu"
                          ) -> Dict[str, torch.Tensor]:
    """Synthetic frontend inputs: N(0, 1) x 0.02 drawn in f32 from
    ``generator`` (on ``device``), then cast to each spec's dtype."""
    out = {}
    for name, (shape, dtype) in frontend_input_specs(cfg, batch,
                                                     seq).items():
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        out[name] = (x * 0.02).to(dtype)
    return out
