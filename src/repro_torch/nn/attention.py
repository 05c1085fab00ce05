"""Decode attention: one query step against the KV cache, in plain PyTorch
(as the reference keeps it in plain jnp, ``repro/nn/attention.py:121``).

``chunked_attention`` (the sliding-window path) is not ported yet: the
dense configs of the port have no sliding window, and prefill attention
goes through ``kernels.ops.flash_attention``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")


def decode_attention(
    q: torch.Tensor,                 # (B, H, 1, d) — one new token
    k_cache: torch.Tensor,           # (B, Hkv, S, d)
    v_cache: torch.Tensor,           # (B, Hkv, S, d)
    *,
    pos: torch.Tensor,               # current length: 0-dim or per-row (B,)
    sliding_window: int = 0,
    scale: Optional[float] = None,
    gqa_packed: bool = False,
) -> torch.Tensor:
    """Flash-decode: one query step against the cache.

    ``gqa_packed=True`` keeps KV un-repeated and scores grouped queries
    against their shared kv head; otherwise KV is repeated to H heads."""
    B, H, _, d = q.shape
    _, Hkv, S, _ = k_cache.shape
    group = H // Hkv
    scale = scale if scale is not None else d ** -0.5
    k_pos = torch.arange(S, device=q.device)
    if pos.dim() == 0:
        # Scalar step (step-synchronous batch): mask broadcasts over B.
        mask = k_pos <= pos
        if sliding_window > 0:
            mask = mask & (pos - k_pos < sliding_window)
        mask_packed = mask.reshape(1, 1, 1, S)
        mask_flat = mask.reshape(1, 1, S)
    else:
        # Per-slot positions (continuous batching): each row masks its own
        # prefix, so slots mid-decode coexist with freshly admitted ones.
        mask = k_pos[None, :] <= pos[:, None]                 # (B, S)
        if sliding_window > 0:
            mask = mask & (pos[:, None] - k_pos[None, :] < sliding_window)
        mask_packed = mask[:, None, None, :]
        mask_flat = mask[:, None, :]

    if group > 1 and gqa_packed:
        qg = q[:, :, 0].reshape(B, Hkv, group, d).float() * scale
        s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float())
        s = s.masked_fill(~mask_packed, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
        return out.reshape(B, H, 1, d).to(q.dtype)

    if group > 1:
        k_cache = k_cache.repeat_interleave(group, dim=1)
        v_cache = v_cache.repeat_interleave(group, dim=1)
    qh = q[:, :, 0].float() * scale                       # (B, H, d)
    s = torch.einsum("bhd,bhkd->bhk", qh, k_cache.float())
    s = s.masked_fill(~mask_flat, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", p, v_cache.float())
    return out[:, :, None].to(q.dtype)
