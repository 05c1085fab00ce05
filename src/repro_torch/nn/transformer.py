"""Decoder-LM assembly on PyTorch tensors, for all six families: dense,
MoE, SSM, hybrid, audio and vlm.

The param tree keeps the JAX package's layout: layer parameters stacked on
a leading "layers" axis (``repro/nn/transformer.py:59``).  Where the
reference scans over that axis, the port runs a Python loop over views of
it.  A dense layer is attention + MLP, an MoE layer attention + MoE, an
SSM layer one mamba2 block (``repro/nn/transformer.py:36-41``).  The
hybrid (zamba2) family runs groups of ``shared_attn_every`` mamba layers,
each group followed by one application of the *shared* attention + MLP
block (one weight set reused at every application), then a ragged tail of
mamba layers; the shared block keeps one KV cache per application.  The
audio (musicgen) and vlm (llava) families run the dense layer over a
stubbed frontend (``nn/frontends.py``): a full pass and a prefill take
``extras``, where audio's ``frame_embed`` (B, S, D) is added to the token
embeddings and vision's ``patch_embed`` (B, P, D) replaces the first P
positions (``repro/nn/transformer.py:88-101``); a decode step takes none,
as in the reference.

Tensor parallelism (a "model" mesh axis over 1, ``meshctx``): the layers
run on this rank's shards (``nn/layers.py``, ``nn/moe.py``); the
embedding and the head are vocab-parallel.  Each rank looks up the tokens
in its own rows of the embedding, zeros elsewhere, and one f32
``all_reduce`` sums the rows (exact: one term is not zero); the head gives
this rank's (..., V/n) f32 logits, written into zeros of the full V and
summed the same way; under autograd the sums pass the gradient through
and the head's input passes the "copy" (``distributed/collectives.py``).
The decode cache holds this rank's kv heads and SSM heads.  A mamba layer
runs on this rank's SSM heads (``nn/mamba2.py``: its gated RMSNorm sums
the squares over the "model" axis); the hybrid's shared block runs the TP
attention and MLP.

Data parallelism (a data axis over 1, ``meshctx.data_axis``): each rank
runs its own rows of the batch.  A leaf FSDP shards ("embed" ->
"data", ``cfg.fsdp``) is gathered over the data axis where it is used:
each layer's inside :func:`_layer_step`, so under ``cfg.remat`` the
gathered weights live for one layer and are gathered again in the
recompute (ZeRO-3); the final norm's before it runs; in a prefill or a
decode step each layer's at its turn and the shared block's once.  The
gather's backward reduce-scatters the gradient's sum back to the shards.

With a tracer installed (``obs/trace.py``), a prefill and a decode step
run under a device-timed ``model.prefill`` / ``model.decode`` span on the
model's track, and each dense or MoE layer under ``attn`` and ``moe`` (or
``mlp``) spans, the final norm and the logits under ``head``; a full pass
records the layers' spans too.

Training: :func:`lm_loss` is the reference's chunked next-token NLL over
:func:`forward_hidden`, whose layers run under
``torch.utils.checkpoint.checkpoint`` when ``cfg.remat`` is set and
autograd records (the reference's ``jax.checkpoint``, recomputed in the
backward pass).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import meshctx
from repro_torch.distributed.collectives import (all_reduce_f32,
                                                 copy_to_group, gather_along)
from repro_torch.nn import layers as L
from repro_torch.nn import mamba2, moe
from repro_torch.nn.config import ModelConfig
from repro_torch.obs import trace as obs_trace

def layer_defs(cfg: ModelConfig) -> Dict:
    if cfg.has_ssm:
        return {"mamba": mamba2.mamba_defs(cfg)}
    if cfg.is_moe:
        return {"attn": L.attn_defs(cfg), "moe": moe.moe_defs(cfg)}
    return {"attn": L.attn_defs(cfg), "mlp": L.mlp_defs(cfg)}


def _stack(defs, n: int):
    return {k: (_stack(d, n) if isinstance(d, dict)
                else d._replace(shape=(n, *d.shape),
                                axes=("layers", *d.axes)))
            for k, d in defs.items()}


def model_defs(cfg: ModelConfig) -> Dict:
    D, V = cfg.d_model, cfg.vocab_size
    defs = {
        "embed": L.ParamDef((V, D), ("vocab", "embed_novar")),
        "layers": _stack(layer_defs(cfg), cfg.num_layers),
        "final_norm": L.norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = L.ParamDef((D, V), ("embed_novar", "vocab"))
    if cfg.family == "hybrid":
        defs["shared"] = {"attn": L.attn_defs(cfg), "mlp": L.mlp_defs(cfg)}
    return defs


def _hybrid_split(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, group_size, tail) of the hybrid layer structure."""
    g = cfg.shared_attn_every
    n_groups, tail = divmod(cfg.num_layers, g)
    return n_groups, g, tail


def _shared_after(cfg: ModelConfig, i: int) -> int:
    """The shared block's application that follows mamba layer ``i`` of a
    hybrid model (its group's index), or -1 (inside a group, the tail, or
    not hybrid)."""
    if cfg.family != "hybrid":
        return -1
    n_groups, g, _ = _hybrid_split(cfg)
    return (i + 1) // g - 1 if (i + 1) % g == 0 and i < n_groups * g else -1


def _layer(tree, i: int):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _fsdp_gather(tree: Dict, defs: Dict, cfg: ModelConfig) -> Dict:
    """``tree`` (a layer's, the shared block's or the final norm's params,
    ``defs`` their defs) with every leaf FSDP shards gathered whole over
    the data axis: each dim whose logical axis the rules map to "data" and
    whose size is below its def's.  The tree itself with no data axis."""
    ax = meshctx.data_axis()
    if ax is None:
        return tree
    from repro_torch.distributed.sharding import rules_for
    data_axes = {a for a, t in rules_for(cfg).items() if t == "data"}
    out = {}
    for k, v in tree.items():
        d = defs[k]
        if isinstance(v, dict):
            out[k] = _fsdp_gather(v, d, cfg)
            continue
        for dim, (n, name) in enumerate(zip(d.shape, d.axes or ())):
            if name in data_axes and v.shape[dim] != n:
                v = gather_along(v, dim, ax.group)
        out[k] = v
    return out


def _serving_params(params: Dict, cfg: ModelConfig):
    """(layer i's params, the hybrid's shared block's or None) for a
    prefill or a decode step, FSDP leaves gathered over the data axis
    (each layer's at its turn, the shared block's once a step)."""
    ldefs = layer_defs(cfg)
    shared = params.get("shared")
    if shared is not None:
        shared = _fsdp_gather(shared, model_defs(cfg)["shared"], cfg)
    return (lambda i: _fsdp_gather(_layer(params["layers"], i), ldefs, cfg),
            shared)


def _vocab_offset(local: int, cfg: ModelConfig) -> Optional[int]:
    """The first vocabulary row of this rank's shard of ``local`` rows, or
    None when the vocabulary is whole on every rank."""
    if local == cfg.vocab_size:
        return None
    return meshctx.model_axis().coord * local


def embed_tokens(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                 extras: Optional[Dict] = None) -> torch.Tensor:
    """The token embeddings (B, S, D), with the frontend's inputs where the
    config has a frontend and ``extras`` holds them: audio's frame
    embeddings added in, vision's patch embeddings in the first
    positions."""
    emb = params["embed"]
    lo = _vocab_offset(emb.shape[0], cfg)
    if lo is None:
        x = emb[tokens]
    else:
        local = tokens - lo
        mine = (local >= 0) & (local < emb.shape[0])
        x = torch.where(mine[..., None],
                        emb[local.clamp(0, emb.shape[0] - 1)],
                        emb.new_zeros(()))
        x = all_reduce_f32(x, meshctx.model_axis().group).to(emb.dtype)
    extras = extras or {}
    if cfg.frontend == "audio" and "frame_embed" in extras:
        x = x + extras["frame_embed"].to(x.dtype)
    if cfg.frontend == "vision" and "patch_embed" in extras:
        pe = extras["patch_embed"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def lm_head_weight(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """(D, V); a transposed view of the embedding when tied."""
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def logits(x: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits of x (..., D), a plain product as in the reference
    (``transformer.py:242,393``).  A bf16 head accumulates in f32 and writes
    f32 without an f32 copy of the (V, D) weight on the card; under autograd
    it runs as :class:`_LmHead`."""
    w = lm_head_weight(params, cfg)
    lo = _vocab_offset(w.shape[1], cfg)
    if lo is not None:
        x = copy_to_group(x, meshctx.model_axis().group)
    if x.dtype == w.dtype == torch.float32:
        out = torch.matmul(x, w)
    elif x.device.type != "cuda":
        out = torch.matmul(x.float(), w.float())
    elif torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = _LmHead.apply(x, w)
    else:
        out = _head_f32(x, w)
    if lo is None:
        return out
    full = F.pad(out, (lo, cfg.vocab_size - lo - w.shape[1]))
    return all_reduce_f32(full, meshctx.model_axis().group)


def _head_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x2 = x.reshape(-1, x.shape[-1])
    out = torch.mm(x2, w, out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[1])


class _LmHead(torch.autograd.Function):
    """The bf16 head's f32 logits on the card, and its gradients as plain
    bf16 products of the f32 logit gradient rounded to bf16 (the lm_head
    stays a plain product, as in the reference)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _head_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(w.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        dx = torch.mm(g2, w.t()).reshape(x.shape) \
            if ctx.needs_input_grad[0] else None
        dw = torch.mm(x2.t(), g2) if ctx.needs_input_grad[1] else None
        return dx, dw


def _kv_for_cache(attn_p, h, positions, cfg):
    """The prefill cache entry of one layer; recomputes wk/wv on the
    block input exactly as the reference does (``transformer.py:111``)."""
    B, S, _ = h.shape
    hd = cfg.head_dim
    wk, wv = L.kv_weights(attn_p, cfg)
    Hkv = wk.shape[-1] // hd
    hn = L.norm(h, attn_p["norm"], cfg)
    k = L.dense(hn, wk).reshape(B, S, Hkv, hd).transpose(1, 2)
    v = L.dense(hn, wv).reshape(B, S, Hkv, hd).transpose(1, 2)
    k = L.rope(k, positions, cfg.rope_theta)
    return k, v


def _span(name: str, follows: bool = False):
    """A device-timed span on the model's track (the shared no-op with no
    tracer installed); ``follows``: it starts where the span before it
    ended (``obs_trace.Tracer.span``)."""
    return obs_trace.span(name, cat="model", track="model", device=True,
                          follows=follows)


def _block(lp: Dict, x: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of a full pass: (x, the MoE aux loss or 0).  The attention
    residual fuses into the wo GEMM's flush, a dense MLP's into wd's; the
    MoE output is added after the combine, as in the reference
    (``transformer.py:156-157``)."""
    with _span("attn"):
        x = L.attn_forward(lp["attn"], x, cfg, positions=positions,
                           residual=x)
    return _ffn(lp, x, cfg)


def _ffn(lp: Dict, x: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's MoE or MLP half of a full pass or a prefill, under its
    span, which starts where the attention's ended: (x, the MoE aux loss
    or 0)."""
    if cfg.is_moe:
        with _span("moe", follows=True):
            y, aux = moe.moe_forward(lp["moe"], x, cfg)
            x = x + y
        return x, aux
    with _span("mlp", follows=True):
        x = L.mlp_forward(lp["mlp"], x, cfg, residual=x)
    return x, x.new_zeros((), dtype=torch.float32)


def _shared_block(shared: Dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """One application of the hybrid's shared attention + MLP block, both
    residuals fused into their GEMM flushes (``transformer.py:144-146``)."""
    x = L.attn_forward(shared["attn"], x, cfg, positions=positions,
                       residual=x)
    return L.mlp_forward(shared["mlp"], x, cfg, residual=x)


def _unbind_layers(tree: Dict, n: int) -> List[Dict]:
    """The ``n`` per-layer param trees of a stacked tree, each leaf one
    ``torch.unbind`` view: the backward stacks the layers' gradients once,
    where indexing the stack per layer would zero-fill and add a stack-sized
    gradient for every layer."""
    flat = {k: (_unbind_layers(v, n) if isinstance(v, dict)
                else torch.unbind(v, 0)) for k, v in tree.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _layer_step(lp: Dict, shared: Optional[Dict], x: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig, i: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i`` of a full pass (the hybrid's shared block after it where
    one follows): (x, the layer's MoE aux loss or 0).  FSDP leaves are
    gathered here, inside the layer's checkpoint."""
    lp = _fsdp_gather(lp, layer_defs(cfg), cfg)
    if not cfg.has_ssm:
        return _block(lp, x, positions, cfg)
    x = x + mamba2.mamba_forward(lp["mamba"], x, cfg)
    if _shared_after(cfg, i) >= 0:
        shared = _fsdp_gather(shared, model_defs(cfg)["shared"], cfg)
        x = _shared_block(shared, x, positions, cfg)
    return x, x.new_zeros((), dtype=torch.float32)


def forward_hidden_aux(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                       extras: Optional[Dict] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final normed hidden states (B, S, D), the MoE aux loss summed over
    layers) of a full causal pass (``transformer.py:125-165``).  With
    ``cfg.remat`` and autograd recording, each layer runs under a
    non-reentrant checkpoint: its activations are recomputed in the
    backward pass, as the reference's ``jax.checkpoint`` body."""
    x = embed_tokens(params, tokens, cfg, extras)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = x.new_zeros((), dtype=torch.float32)
    shared = params.get("shared")
    for i, lp in enumerate(_unbind_layers(params["layers"], cfg.num_layers)):
        if remat:
            x, a = checkpoint(_layer_step, lp, shared, x, positions, cfg, i,
                              use_reentrant=False)
        else:
            x, a = _layer_step(lp, shared, x, positions, cfg, i)
        aux = aux + a
    final = _fsdp_gather(params["final_norm"], L.norm_defs(cfg), cfg)
    return L.norm(x, final, cfg), aux


def forward_hidden(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                   extras: Optional[Dict] = None) -> torch.Tensor:
    """Final normed hidden states (B, S, D) of a full causal pass."""
    return forward_hidden_aux(params, tokens, cfg, extras)[0]


def lm_loss(params: Dict, batch: Dict, cfg: ModelConfig, *,
            loss_chunk: int = 1024, aux_weight: float = 0.01
            ) -> torch.Tensor:
    """Mean next-token NLL over B (S - 1) positions plus ``aux_weight`` x
    the MoE aux loss (``transformer.py:282-324``): the logits are f32 and
    made ``loss_chunk`` positions at a time, never (B, S, V) at once; each
    chunk's NLL is logsumexp minus the gold logit.  The batch's other keys
    are the frontend's inputs (``transformer.py:291``)."""
    tokens = batch["tokens"]
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    hidden, aux = forward_hidden_aux(params, tokens, cfg, extras)
    B, S, _ = hidden.shape
    n = S - 1
    c = min(loss_chunk, n)
    total = hidden.new_zeros((), dtype=torch.float32)
    for j in range(0, n, c):
        lg = logits(hidden[:, j:min(j + c, n)], params, cfg)
        gold = tokens[:, j + 1:min(j + c, n) + 1]
        nll = torch.logsumexp(lg, dim=-1) \
            - lg.gather(-1, gold[..., None])[..., 0]
        total = total + nll.sum()
    return total / (B * n) + aux_weight * aux


def prefill_forward(
    params: Dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    extras: Optional[Dict] = None,
    last_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Returns (last-position logits (B, V) f32, decode cache).  The cache
    of a dense or MoE model is k/v of shape (L, B, Hkv, S, d) in the param
    dtype; an SSM model's is ``{"mamba": {conv_x, conv_b, conv_c, ssm}}``
    stacked on L, and a hybrid's adds ``"attn"`` k/v stacked on the shared
    block's applications.

    ``last_pos`` (B,) reads each row's logits at its own final real
    position — the ragged-admission path: prompts right-padded to a bucket
    edge still read out at their true last token.  FSDP leaves are
    gathered over the data axis where they are used, as in a full pass."""
    with _span("model.prefill"):
        return _prefill(params, tokens, cfg, extras, last_pos)


def _prefill(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
             extras: Optional[Dict], last_pos: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict]:
    x = embed_tokens(params, tokens, cfg, extras)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    ks, vs, mcs = [], [], []
    layer, shared = _serving_params(params, cfg)
    for i in range(cfg.num_layers):
        lp = layer(i)
        if cfg.has_ssm:
            y, mc = mamba2.mamba_forward(lp["mamba"], x, cfg,
                                         return_cache=True)
            x = x + y
            mcs.append(mc)
            if _shared_after(cfg, i) >= 0:
                k, v = _kv_for_cache(shared["attn"], x, positions, cfg)
                ks.append(k)
                vs.append(v)
                x = _shared_block(shared, x, positions, cfg)
            continue
        with _span("attn", follows=i > 0):
            k, v = _kv_for_cache(lp["attn"], x, positions, cfg)
            x = L.attn_forward(lp["attn"], x, cfg, positions=positions,
                               residual=x)
        ks.append(k)
        vs.append(v)
        x, _ = _ffn(lp, x, cfg)
    with _span("head", follows=not cfg.has_ssm):
        x = L.norm(x, _fsdp_gather(params["final_norm"], L.norm_defs(cfg),
                                   cfg), cfg)
        last = (x[:, -1] if last_pos is None
                else x[torch.arange(B, device=x.device), last_pos])
        out = logits(last, params, cfg)
    kv = {"k": torch.stack(ks), "v": torch.stack(vs)} if ks else {}
    if not mcs:
        return out, kv
    cache = {"mamba": {name: torch.stack([mc[name] for mc in mcs])
                       for name in mcs[0]}}
    if kv:
        cache["attn"] = kv
    return out, cache


def init_cache_specs(cfg: ModelConfig, batch: int, max_len: int, *,
                     local: bool = False) -> Dict:
    """The decode cache as storage-free ("meta") tensors, shaped as
    :func:`prefill_forward`'s with ``max_len`` positions: k/v (n, B, Hkv,
    S, d) and the conv tails bf16 whatever the param dtype, the SSM state
    f32 (``transformer.py:327-353``).  ``local``: this rank's blocks under
    the installed mesh, the engine's layout (:func:`init_cache`)."""
    hkv = L.local_kv_heads(cfg) if local else cfg.num_kv_heads
    nh = mamba2.local_ssm_heads(cfg) if local else cfg.ssm_heads

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def kv(n):
        shape = (n, batch, hkv, max_len, cfg.head_dim)
        return {"k": meta(shape, torch.bfloat16),
                "v": meta(shape, torch.bfloat16)}

    if not cfg.has_ssm:
        return kv(cfg.num_layers)
    cache = {"mamba": {
        name: meta((cfg.num_layers, *shape), dt)
        for name, (shape, dt) in mamba2.mamba_cache_defs(cfg, batch,
                                                         nh).items()}}
    if cfg.family == "hybrid":
        cache["attn"] = kv(_hybrid_split(cfg)[0])
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device) -> Dict:
    """The decode cache of :func:`init_cache_specs`, zeros on ``device``.
    Under tensor parallelism k/v hold this rank's kv heads
    (``L.local_kv_heads``) and the SSM leaves its SSM heads
    (``mamba2.local_ssm_heads``: conv_x their channels, ssm their states;
    conv_b / conv_c whole); the reference shards its cache on the sequence
    and the widest dims instead (``distributed/sharding.py::
    cache_shardings``)."""
    def zeros(tree):
        return {k: (zeros(v) if isinstance(v, dict) else torch.zeros(
                    v.shape, dtype=v.dtype, device=device))
                for k, v in tree.items()}
    return zeros(init_cache_specs(cfg, batch, max_len, local=True))


def decode_step(
    params: Dict,
    cache: Dict,
    tokens: torch.Tensor,     # (B,) — the newly sampled tokens
    pos: torch.Tensor,        # 0-dim or (B,) — their positions
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict]:
    """One serving step: f32 logits for the next token.  The cache is
    updated in place and returned.  k/v are written at ``pos`` (a retried
    step writes the same values again); the mamba layers' new states are
    held until the last layer has run and then written into the cache,
    one copy per leaf, so a step that fails part-way leaves the recurrent
    state as it was."""
    with _span("model.decode"):
        return _decode(params, cache, tokens, pos, cfg)


def _decode(params: Dict, cache: Dict, tokens: torch.Tensor,
            pos: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    x = embed_tokens(params, tokens, cfg)[:, None, :]     # (B, 1, D)
    new_mamba = []
    layer, shared = _serving_params(params, cfg)
    for i in range(cfg.num_layers):
        lp = layer(i)
        if cfg.has_ssm:
            y, mc = mamba2.mamba_decode(lp["mamba"], x,
                                        _layer(cache["mamba"], i), cfg)
            new_mamba.append(mc)
            x = x + y
            a = _shared_after(cfg, i)
            if a >= 0:
                x = x + L.attn_decode(shared["attn"], x,
                                      _layer(cache["attn"], a), cfg, pos=pos)
                x = x + L.mlp_forward(shared["mlp"], x, cfg)
            continue
        c = {"k": cache["k"][i], "v": cache["v"][i]}
        with _span("attn", follows=i > 0):
            x = x + L.attn_decode(lp["attn"], x, c, cfg, pos=pos)
        if cfg.is_moe:
            with _span("moe", follows=True):
                x = x + moe.moe_decode(lp["moe"], x, cfg)
        else:
            with _span("mlp", follows=True):
                x = x + L.mlp_forward(lp["mlp"], x, cfg)
    with _span("head", follows=not cfg.has_ssm):
        x = L.norm(x, _fsdp_gather(params["final_norm"], L.norm_defs(cfg),
                                   cfg), cfg)
        out = logits(x[:, 0], params, cfg)
    for name, leaf in (cache["mamba"].items() if new_mamba else ()):
        torch.stack([mc[name] for mc in new_mamba], out=leaf)
    return out, cache
