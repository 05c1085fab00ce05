"""Building blocks of the decoder (attention, MLP), on PyTorch tensors.

Params are plain nested dicts of tensors with the JAX package's structure
(``repro/nn/layers.py``), so one converted param tree serves both.  Dense
contractions go through ``repro_torch.kernels.ops.matmul``: the selector
picks each GEMM's TileConfig per call and, on the card, the hand-written
Hopper GEMM runs it with the epilogue fused into its flush.

Tensor parallelism (a mesh installed in ``meshctx`` with a "model" axis
over 1): the layers take this rank's shards (``distributed/sharding.py::
tp_shardings``) and read their local head counts and widths from the
shards' shapes.  wq, wk, wv, wg, wu and w1 are column-parallel (the local
GEMM, no collective); wo, wd and w2 are row-parallel: the local product in
f32 plus one f32 ``all_reduce``, the residual added once, in the first
rank's flush (``distributed/collectives.py::tp_matmul``).  Where the kv
heads could not be split into whole heads, each rank computes the kv heads
its own q heads read (:func:`kv_heads_read`).  With no mesh every layer
runs as before.  Under autograd the column-parallel products' input passes
through the model axis's "copy" (its gradient, each rank's partial, is
summed over the axis) and so do replicated wk / wv whose columns a rank
selects; the row-parallel sum passes the gradient through to every rank
(``collectives.copy_to_group``, ``all_reduce_f32``).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import meshctx
from repro_torch.distributed.collectives import copy_to_group, tp_matmul
from repro_torch.kernels import ops as kops
from repro_torch.nn import attention as attn_lib
from repro_torch.nn.config import ModelConfig

# ---------------------------------------------------------------------------
# Parameter definitions: shape, logical axis names, and init rule per leaf
# ("normal" is N(0, 1) * scale, "ones" is the norm scale, "zeros" a norm
# bias, "ssm_a" and "ssm_dt" the mamba decay and step-bias rules), with the
# leaf's own dtype where it has one (the mamba A_log, D and dt_bias stay
# f32 in a bf16 model, ``repro/nn/mamba2.py:113-117``).  The axis names are
# the reference's (``repro/nn/layers.py:28-33``): the distributed layer
# maps them onto a device mesh (``distributed/sharding.py``); None names a
# leaf with no named axes (replicated everywhere).
# ---------------------------------------------------------------------------


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Optional[Tuple[Optional[str], ...]] = None  # len == ndim
    init: str = "normal"
    dtype: Optional[torch.dtype] = None     # None: the model's dtype
    scale: float = 0.02


def axes_tree(defs: Dict) -> Dict:
    """The logical axis names of every leaf of a def tree."""
    return {k: (axes_tree(d) if isinstance(d, dict) else d.axes)
            for k, d in defs.items()}


def norm_defs(cfg: ModelConfig) -> Dict:
    d = {"scale": ParamDef((cfg.d_model,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDef((cfg.d_model,), ("embed",), "zeros")
    return d


def attn_defs(cfg: ModelConfig) -> Dict:
    D = cfg.d_model
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "norm": norm_defs(cfg),
        "wq": ParamDef((D, H * hd), ("embed", "heads")),
        "wk": ParamDef((D, Hkv * hd), ("embed", "kv_heads")),
        "wv": ParamDef((D, Hkv * hd), ("embed", "kv_heads")),
        "wo": ParamDef((H * hd, D), ("heads", "embed")),
    }


def mlp_defs(cfg: ModelConfig) -> Dict:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {
            "norm": norm_defs(cfg),
            "wg": ParamDef((D, F), ("embed", "mlp")),
            "wu": ParamDef((D, F), ("embed", "mlp")),
            "wd": ParamDef((F, D), ("mlp", "embed")),
        }
    return {
        "norm": norm_defs(cfg),
        "w1": ParamDef((D, F), ("embed", "mlp")),
        "w2": ParamDef((F, D), ("mlp", "embed")),
    }


# f32 elements drawn at once when a normal leaf is materialised: bounds the
# f32 temporary (a whole stacked expert leaf of qwen3-moe would need 38.6 GB).
_DRAW_ELEMS = 1 << 26


def _whole(shape) -> Tuple[slice, ...]:
    return tuple(slice(0, n) for n in shape)


def _draw_normal(shape, generator, *, dtype, device, scale: float = 0.02,
                 index: Optional[Tuple[slice, ...]] = None) -> torch.Tensor:
    """N(0, scale²) drawn in f32 and cast, in slices along axis 0 of at
    most ``_DRAW_ELEMS`` elements (one row at least).  ``index`` (one
    ``slice(start, stop)`` an axis; the whole leaf when None) keeps only
    that block: every slice is still drawn whole, so the generator moves
    as it does for the whole leaf and the block holds its values."""
    index = index or _whole(shape)
    lo, hi = index[0].start, index[0].stop
    out = torch.empty([s.stop - s.start for s in index], dtype=dtype,
                      device=device)
    step = max(1, _DRAW_ELEMS // math.prod(shape[1:]))
    for i in range(0, shape[0], step):
        n = min(step, shape[0] - i)
        t = torch.empty((n, *shape[1:]), dtype=torch.float32, device=device)
        t.normal_(0.0, scale, generator=generator)
        a, b = max(i, lo), min(i + n, hi)
        if a < b:
            out[a - lo:b - lo].copy_(t[(slice(a - i, b - i), *index[1:])])
    return out


def init_tree(defs: Dict, generator: torch.Generator, *,
              dtype: torch.dtype, device: torch.device,
              index: Optional[Dict] = None) -> Dict:
    """Materialise a def tree, leaves in insertion order, from one
    generator, each leaf in its def's dtype or else ``dtype``: normal
    leaves are N(0, scale²) drawn in f32 then cast, a slice of axis 0 at a
    time; "ssm_a" is log(1 + 15 u) and "ssm_dt" is U[-4.6, -2.3), u ~
    U[0, 1) drawn in f32 (the reference's rules, ``repro/nn/layers.py:
    53-59``, from the port's own generator).

    ``index`` (a tree like ``defs`` of per-leaf tuples of
    ``slice(start, stop)``, one an axis) materialises only each leaf's
    block, drawing the same stream: a block equals the same block of the
    whole tree, bit for bit (``distributed/sharding.py::init_sharded``)."""
    out = {}
    for name, d in defs.items():
        idx = index.get(name) if index is not None else None
        if isinstance(d, dict):
            out[name] = init_tree(d, generator, dtype=dtype, device=device,
                                  index=idx)
            continue
        dt = d.dtype or dtype
        shape = [s.stop - s.start for s in idx or _whole(d.shape)]
        if d.init == "ones":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        elif d.init == "zeros":
            out[name] = torch.zeros(shape, dtype=dt, device=device)
        elif d.init in ("ssm_a", "ssm_dt"):
            u = torch.rand(d.shape, generator=generator, device=device,
                           dtype=torch.float32)
            u = (torch.log(1.0 + u * 15.0) if d.init == "ssm_a"
                 else u * 2.3 - 4.6)
            out[name] = u[idx or _whole(d.shape)].to(dt)
        else:
            out[name] = _draw_normal(d.shape, generator, dtype=dt,
                                     device=device, scale=d.scale,
                                     index=idx)
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

def kv_heads_read(cfg: ModelConfig, q_lo: int, q_n: int) -> List[int]:
    """The global kv heads that q heads [q_lo, q_lo + q_n) read, one entry
    a local kv head: the distinct heads in order when the q heads fall into
    them in equal runs (local GQA then maps them as the global one does),
    else the kv head of each q head (one local kv head a q head)."""
    group = cfg.num_heads // cfg.num_kv_heads
    kv = [(q_lo + i) // group for i in range(q_n)]
    uniq = sorted(set(kv))
    g = q_n // len(uniq)
    if g * len(uniq) == q_n and kv == [uniq[i // g] for i in range(q_n)]:
        return uniq
    return kv


def local_kv_heads(cfg: ModelConfig) -> int:
    """The kv heads this rank computes and caches under the installed mesh
    (``tp_shardings``' rule: q heads split when H divides by the "model"
    axis, kv heads too when Hkv does)."""
    ax = meshctx.model_axis()
    if ax is None or cfg.num_heads % ax.size:
        return cfg.num_kv_heads
    if cfg.num_kv_heads % ax.size == 0:
        return cfg.num_kv_heads // ax.size
    h = cfg.num_heads // ax.size
    return len(kv_heads_read(cfg, ax.coord * h, h))


def kv_weights(p: Dict, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wk, wv) of the kv heads this rank's q heads read: the shards as
    they are, unless the q heads are split and the kv heads are not, when
    the columns of :func:`kv_heads_read`'s heads are taken."""
    hd = cfg.head_dim
    wk, wv = p["wk"], p["wv"]
    h = p["wq"].shape[-1] // hd
    if h == cfg.num_heads or wk.shape[-1] < cfg.num_kv_heads * hd:
        return wk, wv
    ax = meshctx.model_axis()
    heads = kv_heads_read(cfg, ax.coord * h, h)
    cols = (torch.tensor(heads, device=wk.device)[:, None] * hd
            + torch.arange(hd, device=wk.device)).reshape(-1)
    # Every rank holds wk / wv whole and reads its own columns: the
    # gradient of each is the sum of the ranks' partials.
    wk, wv = copy_to_group(wk, ax.group), copy_to_group(wv, ax.group)
    return wk.index_select(-1, cols), wv.index_select(-1, cols)


def column_input(h: torch.Tensor, w: torch.Tensor, full_n: int
                 ) -> torch.Tensor:
    """``h`` as the input of a product with ``w``: when ``w``'s columns are
    this rank's shard of ``full_n``, through the model axis's "copy"."""
    if w.shape[-1] == full_n:
        return h
    return copy_to_group(h, meshctx.model_axis().group)


def row_parallel(x: torch.Tensor, w: torch.Tensor, full_k: int,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ residual) in x's dtype, for a w whose rows may be this
    rank's shard of ``full_k``: then the local f32 product summed over the
    "model" axis (``tp_matmul``), else the fused GEMM."""
    if w.shape[0] == full_k:
        return dense(x, w, residual=residual)
    return tp_matmul(x, w, meshctx.model_axis().group, reduce_k=True,
                     residual=residual).to(x.dtype)


def _repeat_kv_weight(w: torch.Tensor, hkv: int, hd: int, group: int
                      ) -> torch.Tensor:
    """(D, Hkv*hd) -> (D, Hkv*group*hd) by repeating each kv head's
    columns ``group`` times (``repro/nn/layers.py:155-164``)."""
    D = w.shape[0]
    return torch.repeat_interleave(w.reshape(D, hkv, hd), group, dim=1) \
        .reshape(D, hkv * group * hd)


def attn_forward(
    p: Dict,
    x: torch.Tensor,                 # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,         # (S,)
    residual: Optional[torch.Tensor] = None,  # fused into the wo GEMM flush
) -> torch.Tensor:
    B, S, D = x.shape
    hd = cfg.head_dim
    wk, wv = kv_weights(p, cfg)
    H, Hkv = p["wq"].shape[-1] // hd, wk.shape[-1] // hd
    group = H // Hkv
    if cfg.kv_repeat_weights and group > 1:
        # K/V projected to H heads from repeated weights: the same values
        # as GQA's shared heads (``repro/nn/layers.py:180-184``).
        wk = _repeat_kv_weight(wk, Hkv, hd, group)
        wv = _repeat_kv_weight(wv, Hkv, hd, group)
        Hkv = H
    h = column_input(norm(x, p["norm"], cfg), p["wq"], cfg.num_heads * hd)
    q = dense(h, p["wq"]).reshape(B, S, H, hd).transpose(1, 2)
    k = dense(h, wk).reshape(B, S, Hkv, hd).transpose(1, 2)
    v = dense(h, wv).reshape(B, S, Hkv, hd).transpose(1, 2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # The reference sends any window to its plain chunked_attention
    # (repro/nn/layers.py:190); here the window rides in the flash kernel
    # on the card and in its plain version (chunked_attention) on the CPU.
    out = kops.flash_attention(q, k, v, causal=True,
                               window=cfg.sliding_window)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return row_parallel(out, p["wo"], cfg.num_heads * hd, residual)


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
    hd = cfg.head_dim
    wk, wv = kv_weights(p, cfg)
    H, Hkv = p["wq"].shape[-1] // hd, wk.shape[-1] // hd
    h = norm(x, p["norm"], cfg)
    q = dense(h, p["wq"]).reshape(B, 1, H, hd).transpose(1, 2)
    k = dense(h, wk).reshape(B, 1, Hkv, hd).transpose(1, 2)
    v = dense(h, wv).reshape(B, 1, Hkv, hd).transpose(1, 2)
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
    return row_parallel(out, p["wo"], cfg.num_heads * hd)


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------

def mlp_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused MLP: activations run in the GEMM epilogues; the block's
    residual add (when given) fuses into the down-projection's flush."""
    w_in = p["wu"] if cfg.activation == "swiglu" else p["w1"]
    h = column_input(norm(x, p["norm"], cfg), w_in, cfg.d_ff)
    if cfg.activation == "swiglu":
        u = dense(h, p["wu"])
        a = dense(h, p["wg"], epilogue="swiglu_gate", gate=u)
        return row_parallel(a, p["wd"], cfg.d_ff, residual)
    h1 = dense(h, p["w1"], epilogue="gelu")
    return row_parallel(h1, p["w2"], cfg.d_ff, residual)
