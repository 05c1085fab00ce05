"""Mamba2 / SSD (state-space duality) block on PyTorch tensors, the port of
``repro/nn/mamba2.py`` (arXiv:2405.21060).

The five input projections and the output projection go through ``dense``
(the selector-driven GEMM, on the card the hand-written Hopper kernel).
The SSD contractions are plain torch einsums in f32, as the reference's
are ``jnp.einsum``s with ``preferred_element_type=f32`` that no Pallas
kernel stands behind (``mamba2.py:57,62,83``); each is written as the
pairwise contractions it needs, so the order is the same on every host.
The rounding points are the reference's: x·dt goes back to the input dtype
before the SSD, the conv tails of the decode cache are bf16, the SSM state
is f32.  The causal conv is the reference's windowed sum (an einsum over
the window), not ``F.conv1d``, which cuDNN runs in TF32 by default.

Shapes: x (B, S, D); internal heads (B, S, nh, hd); state (B, nh, hd, ns).

Tensor parallelism (a "model" mesh axis over 1, ``meshctx``): a rank holds
whole SSM heads (``distributed/sharding.py::tp_shardings``) and runs the
block on them, reading its head count from ``A_log``'s shard.  in_z, in_x
and in_dt are column-parallel and out_proj row-parallel
(``layers.row_parallel``: the f32 sum of every rank's partial product,
cast to the input dtype; the block's residual is added after it, as one
process adds it).  in_b, in_c and the B / C convs stay whole on every rank
(the reference's "state" axis); each rank's gradient of them, and of the
block input, comes from its own heads only, so they pass the model axis's
"copy", whose backward sums over the ranks.  The gated RMSNorm spans the
whole d_inner: each rank's f32 sum of squares of its channels is summed
over the axis (:func:`gated_rmsnorm`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import meshctx
from repro_torch.distributed.collectives import all_reduce_f32, copy_to_group
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import (ParamDef, dense, norm, norm_defs,
                                   rmsnorm, row_parallel)

NEG_INF = float("-inf")


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., l) -> (..., l, l) with out[i, j] = sum_{j < t <= i} a[t],
    -inf above the diagonal (the 1-semiseparable decay matrix)."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return ss.masked_fill(~mask, NEG_INF)


def ssd_chunked(
    x: torch.Tensor,        # (B, S, nh, hd) — pre-scaled by dt
    dA: torch.Tensor,       # (B, S, nh)     — log-decay per step (dt·A <= 0)
    Bm: torch.Tensor,       # (B, S, ns)
    Cm: torch.Tensor,       # (B, S, ns)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,   # (B, nh, hd, ns)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: (y (B, S, nh, hd) in x's dtype, final state f32)."""
    B, S, nh, hd = x.shape
    ns = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S {S} is not a multiple of the "
                         f"chunk {chunk}")
    c, l = S // chunk, chunk
    f32 = torch.float32
    xc = x.float().reshape(B, c, l, nh, hd)
    Ac = dA.float().reshape(B, c, l, nh).permute(0, 3, 1, 2)   # (B, nh, c, l)
    Bc = Bm.float().reshape(B, c, l, ns)
    Cc = Cm.float().reshape(B, c, l, ns)

    A_cs = torch.cumsum(Ac, dim=-1)                             # (B, nh, c, l)
    L = torch.exp(_segsum(Ac))                                  # (B, nh, c, l, l)

    # 1) intra-chunk (diagonal blocks): C Bᵀ masked by the decay, times x.
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * L, xc)

    # 2) chunk-local final states.
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)             # (B, nh, c, l)
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bcln,bclhp->bchpn", Bc, xd)

    # 3) inter-chunk recurrence (the reference's scan over chunks).
    chunk_decay = torch.exp(A_cs[..., -1])                      # (B, nh, c)
    state = (torch.zeros((B, nh, hd, ns), dtype=f32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for i in range(c):
        prev.append(state)                 # the state *entering* chunk i
        state = states[:, i] + chunk_decay[:, :, i, None, None] * state
    prev_t = torch.stack(prev, dim=1)                           # (B, c, nh, hd, ns)

    # 4) prior-state contribution to each position.
    state_decay = torch.exp(A_cs).permute(0, 2, 3, 1)[..., None]
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_t) * state_decay

    y = (y_diag + y_off).reshape(B, S, nh, hd)
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 block.
# ---------------------------------------------------------------------------

def mamba_defs(cfg: ModelConfig) -> Dict:
    """The reference's separate projections (``mamba2.py:94-118``); A_log,
    D and dt_bias are f32 whatever the model's dtype."""
    D, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv_width
    f32 = torch.float32
    return {
        "norm": norm_defs(cfg),
        "in_z": ParamDef((D, di), ("embed", "ssm_inner")),
        "in_x": ParamDef((D, di), ("embed", "ssm_inner")),
        "in_b": ParamDef((D, ns), ("embed", "state")),
        "in_c": ParamDef((D, ns), ("embed", "state")),
        "in_dt": ParamDef((D, nh), ("embed", "ssm_heads")),
        "conv_x": ParamDef((w, di), (None, "ssm_inner"), scale=0.1),
        "conv_xb": ParamDef((di,), ("ssm_inner",), "zeros"),
        "conv_b": ParamDef((w, ns), (None, "state"), scale=0.1),
        "conv_bb": ParamDef((ns,), ("state",), "zeros"),
        "conv_c": ParamDef((w, ns), (None, "state"), scale=0.1),
        "conv_cb": ParamDef((ns,), ("state",), "zeros"),
        "A_log": ParamDef((nh,), ("ssm_heads",), "ssm_a", f32),
        "D": ParamDef((nh,), ("ssm_heads",), "ones", f32),
        "dt_bias": ParamDef((nh,), ("ssm_heads",), "ssm_dt", f32),
        "gate_norm": ParamDef((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamDef((di, D), ("ssm_inner", "embed")),
    }


def _tp_group(p: Dict, cfg: ModelConfig):
    """The "model" axis's group when ``p`` holds this rank's share of the
    SSM heads, else None (the block runs as on one device)."""
    if p["A_log"].shape[-1] == cfg.ssm_heads:
        return None
    return meshctx.model_axis().group


# The leaves every rank holds whole under tensor parallelism.
_WHOLE = ("in_b", "in_c", "conv_b", "conv_bb", "conv_c", "conv_cb")


def _whole(p: Dict, group) -> Dict:
    """``p`` with the leaves every rank holds whole (in_b, in_c, the B / C
    convs) through the model axis's "copy" under tensor parallelism."""
    if group is None:
        return p
    return {k: (copy_to_group(v, group) if k in _WHOLE else v)
            for k, v in p.items()}


def _project(p: Dict, h: torch.Tensor, cfg: ModelConfig, group=None):
    """h -> (z, x, B, C, dt) via the five separate projections (with
    ``group``, h through the model axis's "copy")."""
    if group is not None:
        h = copy_to_group(h, group)
    return (dense(h, p["in_z"]), dense(h, p["in_x"]), dense(h, p["in_b"]),
            dense(h, p["in_c"]), dense(h, p["in_dt"]))


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  d_inner: int, group=None, eps: float = 1e-6
                  ) -> torch.Tensor:
    """rmsnorm(y · silu(z)) scaled by ``w``, over the whole ``d_inner``
    (``layers.rmsnorm``'s order of operations and dtypes).  With ``group``
    y, z and w hold this rank's channels: its f32 sum of squares is summed
    over the model axis, and the sum's gradient too (every rank's channels
    read it), then divided by the full ``d_inner``."""
    g = y * F.silu(z)
    if group is None:
        return rmsnorm(g, w, eps)
    x32 = g.float()
    ss = x32.square().sum(dim=-1, keepdim=True)
    var = copy_to_group(all_reduce_f32(ss, group), group) / d_inner
    return (x32 * torch.rsqrt(var + eps)).to(g.dtype) * w


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv, width w.shape[0]: (B, S, ch) -> (B, S, ch)."""
    width = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    windows = torch.stack([pad[:, k:k + S] for k in range(width)])  # (w,B,S,ch)
    out = torch.einsum("wbsc,wc->bsc", windows, w.to(windows.dtype)) + b
    return F.silu(out)


def mamba_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                  return_cache: bool = False):
    """Block forward.  With ``return_cache`` also returns the decode state
    (conv window tails + final SSM state) computed in the same pass."""
    B, S, D = x.shape
    group = _tp_group(p, cfg)
    p = _whole(p, group)
    nh, hd = p["A_log"].shape[-1], cfg.ssm_head_dim
    di = nh * hd
    h = norm(x, p["norm"], cfg)
    z, xs, Bm, Cm, dt = _project(p, h, cfg, group)

    w = cfg.ssm_conv_width
    bf16 = torch.bfloat16
    conv_tail = {"conv_x": xs[:, -(w - 1):].to(bf16),
                 "conv_b": Bm[:, -(w - 1):].to(bf16),
                 "conv_c": Cm[:, -(w - 1):].to(bf16)}
    xs = _causal_conv(xs, p["conv_x"], p["conv_xb"])
    Bm = _causal_conv(Bm, p["conv_b"], p["conv_bb"])
    Cm = _causal_conv(Cm, p["conv_c"], p["conv_cb"])

    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B, S, nh)
    A = -torch.exp(p["A_log"])                                  # (nh,)

    # Pad the sequence to a chunk multiple: pad steps carry x = 0 and
    # dt = 0 (no decay), so the final state is exact; their y is dropped.
    chunk = min(cfg.ssm_chunk, max(16, S))
    pad = (-S) % chunk
    xh = xs.reshape(B, S, nh, hd)
    xp, dtp, Bp, Cp = xh, dt, Bm, Cm
    if pad:
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtp = F.pad(dt, (0, 0, 0, pad))
        Bp = F.pad(Bm, (0, 0, 0, pad))
        Cp = F.pad(Cm, (0, 0, 0, pad))

    y, final_state = ssd_chunked(
        (xp.float() * dtp[..., None]).to(xp.dtype), dtp * A, Bp, Cp, chunk)
    y = y[:, :S]
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, di)
    y = gated_rmsnorm(y, z, p["gate_norm"], cfg.d_inner, group)
    out = row_parallel(y, p["out_proj"], cfg.d_inner)
    if return_cache:
        return out, {**conv_tail, "ssm": final_state}
    return out


# ---------------------------------------------------------------------------
# O(1) recurrent decode step.
# ---------------------------------------------------------------------------

def local_ssm_heads(cfg: ModelConfig) -> int:
    """The SSM heads this rank holds under the installed mesh
    (``tp_shardings``' rule: split only into whole heads)."""
    ax = meshctx.model_axis()
    if ax is None or cfg.ssm_heads % ax.size:
        return cfg.ssm_heads
    return cfg.ssm_heads // ax.size


def mamba_cache_defs(cfg: ModelConfig, batch: int,
                     heads: Optional[int] = None) -> Dict:
    """(shape, dtype) of each decode-cache leaf of one layer: bf16 conv
    tails and an f32 SSM state, whatever the param dtype; ``heads`` SSM
    heads (default all), conv_x holding their channels."""
    nh = cfg.ssm_heads if heads is None else heads
    ns, hd = cfg.ssm_state, cfg.ssm_head_dim
    di = nh * hd
    w = cfg.ssm_conv_width
    return {"conv_x": ((batch, w - 1, di), torch.bfloat16),
            "conv_b": ((batch, w - 1, ns), torch.bfloat16),
            "conv_c": ((batch, w - 1, ns), torch.bfloat16),
            "ssm": ((batch, nh, hd, ns), torch.float32)}


def _conv_step(x_t: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token depthwise conv: state (B, w-1, ch), x_t (B, ch); returns
    (silu(conv), the next window in the state's dtype)."""
    window = torch.cat([state.to(x_t.dtype), x_t[:, None]], dim=1)
    out = torch.einsum("bwc,wc->bc", window, w.to(window.dtype)) + b
    return F.silu(out), window[:, 1:].to(state.dtype)


def mamba_decode(p: Dict, x: torch.Tensor, cache: Dict, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    """One token (x (B, 1, D)) against one layer's cache; returns the
    output and the layer's new cache as new tensors, the given ones
    untouched (a retried step replays the same state)."""
    B = x.shape[0]
    group = _tp_group(p, cfg)
    p = _whole(p, group)
    nh, hd = p["A_log"].shape[-1], cfg.ssm_head_dim
    di = nh * hd
    h = norm(x, p["norm"], cfg)
    z, xs, Bm, Cm, dt = (t[:, 0] for t in _project(p, h, cfg, group))

    xs, new_cx = _conv_step(xs, cache["conv_x"], p["conv_x"], p["conv_xb"])
    Bm, new_cb = _conv_step(Bm, cache["conv_b"], p["conv_b"], p["conv_bb"])
    Cm, new_cc = _conv_step(Cm, cache["conv_c"], p["conv_c"], p["conv_cb"])

    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                                   # (B, nh)
    xh = xs.reshape(B, nh, hd).float() * dt[..., None]
    upd = torch.einsum("bhp,bn->bhpn", xh, Bm.float())
    state = cache["ssm"] * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    y = y + p["D"][None, :, None] * xs.reshape(B, nh, hd).float()
    y = y.reshape(B, di).to(x.dtype)
    y = gated_rmsnorm(y, z, p["gate_norm"], cfg.d_inner, group)
    return row_parallel(y, p["out_proj"], cfg.d_inner)[:, None], {
        "conv_x": new_cx, "conv_b": new_cb, "conv_c": new_cc, "ssm": state}
