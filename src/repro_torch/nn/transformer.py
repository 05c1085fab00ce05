"""Decoder-LM assembly on PyTorch tensors, for the dense and MoE families.

The param tree keeps the JAX package's layout: layer parameters stacked on
a leading "layers" axis (``repro/nn/transformer.py:59``).  Where the
reference scans over that axis, the port runs a Python loop over views of
it.  A dense layer is attention + MLP, an MoE layer attention + MoE
(``repro/nn/transformer.py:36-41``); the other families are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.nn import layers as L
from repro_torch.nn import moe
from repro_torch.nn.config import ModelConfig


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense and moe families are ported, not "
            f"{cfg.family!r}")


def layer_defs(cfg: ModelConfig) -> Dict:
    if cfg.is_moe:
        return {"attn": L.attn_defs(cfg), "moe": moe.moe_defs(cfg)}
    return {"attn": L.attn_defs(cfg), "mlp": L.mlp_defs(cfg)}


def _stack(defs, n: int):
    return {k: (_stack(d, n) if isinstance(d, dict) else ((n, *d[0]), d[1]))
            for k, d in defs.items()}


def model_defs(cfg: ModelConfig) -> Dict:
    _check_family(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    defs = {
        "embed": ((V, D), "normal"),
        "layers": _stack(layer_defs(cfg), cfg.num_layers),
        "final_norm": L.norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((D, V), "normal")
    return defs


def _layer(tree, i: int):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def embed_tokens(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def lm_head_weight(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """(D, V); a transposed view of the embedding when tied."""
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def logits(x: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits of x (..., D), a plain product as in the reference
    (``transformer.py:242,393``).  A bf16 head accumulates in f32 and writes
    f32 without an f32 copy of the (V, D) weight on the card."""
    w = lm_head_weight(params, cfg)
    if x.dtype == w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.device.type == "cuda":
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.mm(x2, w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[1])
    return torch.matmul(x.float(), w.float())


def _kv_for_cache(attn_p, h, positions, cfg):
    """The prefill cache entry of one layer; recomputes wk/wv on the
    block input exactly as the reference does (``transformer.py:111``)."""
    B, S, _ = h.shape
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    hn = L.norm(h, attn_p["norm"], cfg)
    k = L.dense(hn, attn_p["wk"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    v = L.dense(hn, attn_p["wv"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    k = L.rope(k, positions, cfg.rope_theta)
    return k, v


def _block(lp: Dict, x: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """One layer of a full pass.  The attention residual fuses into the wo
    GEMM's flush, a dense MLP's into wd's; the MoE output is added after
    the combine, as in the reference (``transformer.py:156-157``)."""
    x = L.attn_forward(lp["attn"], x, cfg, positions=positions, residual=x)
    if cfg.is_moe:
        return x + moe.moe_forward(lp["moe"], x, cfg)[0]
    return L.mlp_forward(lp["mlp"], x, cfg, residual=x)


def forward_hidden(params: Dict, tokens: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    """Final normed hidden states (B, S, D) of a full causal pass."""
    _check_family(cfg)
    x = embed_tokens(params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        x = _block(lp, x, positions, cfg)
    return L.norm(x, params["final_norm"], cfg)


def prefill_forward(
    params: Dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    last_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Returns (last-position logits (B, V) f32, decode cache with k/v of
    shape (L, B, Hkv, S, d) in the param dtype).

    ``last_pos`` (B,) reads each row's logits at its own final real
    position — the ragged-admission path: prompts right-padded to a bucket
    edge still read out at their true last token."""
    _check_family(cfg)
    x = embed_tokens(params, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        k, v = _kv_for_cache(lp["attn"], x, positions, cfg)
        ks.append(k)
        vs.append(v)
        x = _block(lp, x, positions, cfg)
    x = L.norm(x, params["final_norm"], cfg)
    last = (x[:, -1] if last_pos is None
            else x[torch.arange(B, device=x.device), last_pos])
    return logits(last, params, cfg), {"k": torch.stack(ks),
                                       "v": torch.stack(vs)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device) -> Dict:
    """The decode cache: bf16 whatever the param dtype, as in the
    reference (``transformer.py:338-341``)."""
    _check_family(cfg)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def decode_step(
    params: Dict,
    cache: Dict,
    tokens: torch.Tensor,     # (B,) — the newly sampled tokens
    pos: torch.Tensor,        # 0-dim or (B,) — their positions
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict]:
    """One serving step: f32 logits for the next token.  The cache is
    updated in place and returned."""
    _check_family(cfg)
    x = embed_tokens(params, tokens)[:, None, :]          # (B, 1, D)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        c = {"k": cache["k"][i], "v": cache["v"][i]}
        x = x + L.attn_decode(lp["attn"], x, c, cfg, pos=pos)
        if cfg.is_moe:
            x = x + moe.moe_decode(lp["moe"], x, cfg)
        else:
            x = x + L.mlp_forward(lp["mlp"], x, cfg)
    x = L.norm(x, params["final_norm"], cfg)
    return logits(x[:, 0], params, cfg), cache
