"""Attention in plain PyTorch (the port of ``repro/nn/attention.py``).

``chunked_attention`` is the reference's flash equivalent: an online
softmax over 512 x 512 (query, key) chunks that never holds the (Sq, Skv)
score matrix, with the causal and the sliding-window mask (key j is
visible to query i iff j <= i and i - j < window, strict).  It is the
plain version of windowed attention: the CPU route of the flash kernel's
window (``kernels/flash_attention.py::attention_plain``) and, on the card,
the yardstick the windowed kernel is held to.  ``decode_attention`` scores
one query step against the KV cache, as the reference keeps it in plain
jnp (``repro/nn/attention.py:121``).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")


def chunked_attention(
    q: torch.Tensor,                 # (B, H, Sq, d)
    k: torch.Tensor,                 # (B, Hkv, Skv, d)
    v: torch.Tensor,                 # (B, Hkv, Skv, d)
    *,
    causal: bool = True,
    sliding_window: int = 0,
    scale: Optional[float] = None,
    chunk_q: int = 512,
    chunk_k: int = 512,
) -> torch.Tensor:
    """(B, H, Sq, d) in q's dtype; the arithmetic in f32, KV repeated to H
    heads, chunk by chunk as ``repro/nn/attention.py:33-118``.  A chunk
    pair the mask hides whole is skipped: its step would leave m, l and the
    accumulator as they were."""
    B, H, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    group = H // Hkv
    scale = scale if scale is not None else d ** -0.5
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    cq, ck = min(chunk_q, Sq), min(chunk_k, Skv)
    out = torch.empty((B, H, Sq, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, cq):
        q32 = q[:, :, q0:q0 + cq].float() * scale
        nq = q32.shape[2]
        q_pos = q0 + torch.arange(nq, device=q.device)
        m = torch.full((B, H, nq), NEG_INF, device=q.device)
        l = torch.zeros((B, H, nq), device=q.device)
        acc = torch.zeros((B, H, nq, d), device=q.device)
        for k0 in range(0, Skv, ck):
            if causal and k0 > q0 + nq - 1:
                continue
            if sliding_window > 0 and q0 - (k0 + ck - 1) >= sliding_window:
                continue
            k_blk = k[:, :, k0:k0 + ck].float()
            k_pos = k0 + torch.arange(k_blk.shape[2], device=q.device)
            s = torch.einsum("bhqd,bhkd->bhqk", q32, k_blk)
            mask = torch.ones((nq, k_blk.shape[2]), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if sliding_window > 0:
                mask = mask & (q_pos[:, None] - k_pos[None, :]
                               < sliding_window)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            safe = torch.where(torch.isfinite(m_new), m_new,
                               torch.zeros_like(m_new))
            p = torch.exp(s - safe[..., None]).masked_fill(~mask, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - safe),
                                torch.zeros_like(m))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, v[:, :, k0:k0 + ck].float())
            m = m_new
        denom = torch.where(l > 0, l, torch.ones_like(l))[..., None]
        out[:, :, q0:q0 + nq] = acc / denom
    return out.to(q.dtype)


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
