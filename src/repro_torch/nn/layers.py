"""Building blocks of the decoder (attention, MLP), on PyTorch tensors.

Params are plain nested dicts of tensors with the JAX package's structure
(``repro/nn/layers.py``), so one converted param tree serves both.  Dense
contractions go through ``repro_torch.kernels.ops.matmul``: the selector
picks each GEMM's TileConfig per call and, on the card, the hand-written
Hopper GEMM runs it with the epilogue fused into its flush.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.nn import attention as attn_lib
from repro_torch.nn.config import ModelConfig

# ---------------------------------------------------------------------------
# Parameter definitions: shape and init rule per leaf ("normal" is
# N(0, 1) * scale, "ones" is the norm scale, "zeros" a norm bias, "ssm_a"
# and "ssm_dt" the mamba decay and step-bias rules), with the leaf's own
# dtype where it has one (the mamba A_log, D and dt_bias stay f32 in a bf16
# model, ``repro/nn/mamba2.py:113-117``).
# ---------------------------------------------------------------------------


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"
    dtype: Optional[torch.dtype] = None     # None: the model's dtype
    scale: float = 0.02


def norm_defs(cfg: ModelConfig) -> Dict:
    d = {"scale": ParamDef((cfg.d_model,), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDef((cfg.d_model,), "zeros")
    return d


def attn_defs(cfg: ModelConfig) -> Dict:
    D = cfg.d_model
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "norm": norm_defs(cfg),
        "wq": ParamDef((D, H * hd)),
        "wk": ParamDef((D, Hkv * hd)),
        "wv": ParamDef((D, Hkv * hd)),
        "wo": ParamDef((H * hd, D)),
    }


def mlp_defs(cfg: ModelConfig) -> Dict:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {
            "norm": norm_defs(cfg),
            "wg": ParamDef((D, F)),
            "wu": ParamDef((D, F)),
            "wd": ParamDef((F, D)),
        }
    return {
        "norm": norm_defs(cfg),
        "w1": ParamDef((D, F)),
        "w2": ParamDef((F, D)),
    }


# f32 elements drawn at once when a normal leaf is materialised: bounds the
# f32 temporary (a whole stacked expert leaf of qwen3-moe would need 38.6 GB).
_DRAW_ELEMS = 1 << 26


def _draw_normal(shape, generator, *, dtype, device,
                 scale: float = 0.02) -> torch.Tensor:
    """N(0, scale²) drawn in f32 and cast, in slices along axis 0 of at
    most ``_DRAW_ELEMS`` elements (one row at least)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    row = out[0].numel() if out.dim() > 1 else 1
    step = max(1, _DRAW_ELEMS // row)
    for i in range(0, shape[0], step):
        part = out[i:i + step]
        t = torch.empty(part.shape, dtype=torch.float32, device=device)
        part.copy_(t.normal_(0.0, scale, generator=generator))
    return out


def init_tree(defs: Dict, generator: torch.Generator, *,
              dtype: torch.dtype, device: torch.device) -> Dict:
    """Materialise a def tree, leaves in insertion order, from one
    generator, each leaf in its def's dtype or else ``dtype``: normal
    leaves are N(0, scale²) drawn in f32 then cast, a slice of axis 0 at a
    time; "ssm_a" is log(1 + 15 u) and "ssm_dt" is U[-4.6, -2.3), u ~
    U[0, 1) drawn in f32 (the reference's rules, ``repro/nn/layers.py:
    53-59``, from the port's own generator)."""
    out = {}
    for name, d in defs.items():
        if isinstance(d, dict):
            out[name] = init_tree(d, generator, dtype=dtype, device=device)
            continue
        dt = d.dtype or dtype
        if d.init == "ones":
            out[name] = torch.ones(d.shape, dtype=dt, device=device)
        elif d.init == "zeros":
            out[name] = torch.zeros(d.shape, dtype=dt, device=device)
        elif d.init in ("ssm_a", "ssm_dt"):
            u = torch.rand(d.shape, generator=generator, device=device,
                           dtype=torch.float32)
            u = (torch.log(1.0 + u * 15.0) if d.init == "ssm_a"
                 else u * 2.3 - 4.6)
            out[name] = u.to(dt)
        else:
            out[name] = _draw_normal(d.shape, generator, dtype=dt,
                                     device=device, scale=d.scale)
    return out


# ---------------------------------------------------------------------------
# Primitive layers.
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w + b


def norm(x: torch.Tensor, p: Dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def dense(x: torch.Tensor, w: torch.Tensor, out_dtype=None, *,
          epilogue=None, bias=None, gate=None,
          residual=None) -> torch.Tensor:
    """Selector-driven fused GEMM: epilogue(x (..., K) @ w (K, N))."""
    return kops.matmul(x, w, out_dtype=out_dtype or x.dtype,
                       epilogue=epilogue, bias=bias, gate=gate,
                       residual=residual)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, H, S, d); positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        ang = positions.float()[:, None] * freqs[None, :]
        ang = ang[None, None]                       # (1, 1, S, half)
    else:
        ang = positions.float()[..., None] * freqs
        ang = ang[:, None]                          # (B, 1, S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention block (GQA + RoPE + KV cache).
# ---------------------------------------------------------------------------

def attn_forward(
    p: Dict,
    x: torch.Tensor,                 # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,         # (S,)
    residual: Optional[torch.Tensor] = None,  # fused into the wo GEMM flush
) -> torch.Tensor:
    B, S, D = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.kv_repeat_weights:
        raise NotImplementedError(
            "KV weight repeat (a distribution knob) is not ported "
            "(ROADMAP A5/A6)")
    h = norm(x, p["norm"], cfg)
    q = dense(h, p["wq"]).reshape(B, S, H, hd).transpose(1, 2)
    k = dense(h, p["wk"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    v = dense(h, p["wv"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # The reference sends any window to its plain chunked_attention
    # (repro/nn/layers.py:190); here the window rides in the flash kernel
    # on the card and in its plain version (chunked_attention) on the CPU.
    out = kops.flash_attention(q, k, v, causal=True,
                               window=cfg.sliding_window)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return dense(out, p["wo"], residual=residual)


def _write_cache(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Write new (B, Hkv, 1, d) at each row's position, in place (the JAX
    reference returns an updated copy; the port saves the cache-sized
    copy).  ``pos`` is 0-dim (every row) or (B,) (per row)."""
    new = new.to(cache.dtype)
    if pos.dim() == 0:
        cache.index_copy_(2, pos.reshape(1), new)
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, :, pos] = new[:, :, 0]


def attn_decode(
    p: Dict,
    x: torch.Tensor,                 # (B, 1, D)
    cache: Dict,                     # {"k": (B,Hkv,S,d), "v": ...}, updated
    cfg: ModelConfig,
    *,
    pos: torch.Tensor,               # 0-dim or (B,) int — this token's index
) -> torch.Tensor:
    B, _, D = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = norm(x, p["norm"], cfg)
    q = dense(h, p["wq"]).reshape(B, 1, H, hd).transpose(1, 2)
    k = dense(h, p["wk"]).reshape(B, 1, Hkv, hd).transpose(1, 2)
    v = dense(h, p["wv"]).reshape(B, 1, Hkv, hd).transpose(1, 2)
    # Per-slot positions (continuous batching) rope each row at its own
    # offset, and each row's new KV lands at that offset.
    posv = pos.reshape(1) if pos.dim() == 0 else pos.reshape(B, 1)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    _write_cache(cache["k"], k, pos)
    _write_cache(cache["v"], v, pos)
    out = attn_lib.decode_attention(
        q, cache["k"], cache["v"], pos=pos,
        sliding_window=cfg.sliding_window,
        gqa_packed=cfg.gqa_packed_decode)
    out = out.transpose(1, 2).reshape(B, 1, H * hd)
    return dense(out, p["wo"])


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------

def mlp_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused MLP: activations run in the GEMM epilogues; the block's
    residual add (when given) fuses into the down-projection's flush."""
    h = norm(x, p["norm"], cfg)
    if cfg.activation == "swiglu":
        u = dense(h, p["wu"])
        a = dense(h, p["wg"], epilogue="swiglu_gate", gate=u)
        return dense(a, p["wd"], residual=residual)
    h1 = dense(h, p["w1"], epilogue="gelu")
    return dense(h1, p["w2"], residual=residual)
