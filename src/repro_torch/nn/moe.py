"""Mixture-of-Experts layer on PyTorch tensors: top-k routing with
sort-based capacity dispatch (the port of ``repro/nn/moe.py``).

Token copies are sorted by expert id, placed into a fixed-capacity
(E, C, D) buffer, the three expert GEMMs run on that buffer through
``kernels.ops.expert_matmul`` (on the card one launch of the grouped Hopper
GEMM each, the swiglu gate fused into the wg GEMM's flush), and results are
gathered back with gate weighting.  A decode step whose B·K token copies
would gather more bytes than reading every local expert once costs runs
the same dispatch and grouped GEMMs (capacity B: nothing drops), reading
each expert's weights in place once; a smaller step runs the reference's
einsums on the selected experts' weights gathered per token, and
``cfg.moe_dense_decode`` every expert on every token (``decode_path``).

Where the port departs from the reference's operations, the result does not
change: the dispatch buffer is filled by ``index_copy_`` (every kept copy
owns its slot; the reference scatter-adds into zeros), and the combine sums
each token's K copies over a (T, K, D) view instead of scatter-adding them,
so it is deterministic on the card, where ``index_add_`` uses atomics.  The
backward is deterministic too, and has no accumulating scatter: the copies
are gathered from a token-major (T·K, D) expansion by the sort's
permutation (each token's K copy gradients are summed by the expansion's
reduction), and the experts' outputs go back to their copies' rows by
``index_copy_`` (whose backward is a gather), a dropped copy's row zero.

Expert parallelism (a "model" mesh axis over 1, ``meshctx``): the router
is replicated and the dispatch plan is computed whole on every rank.  The
experts are split over the axis where their count divides by it, and each
rank runs the grouped GEMMs on its own experts' rows of the (E, C, D)
buffer; otherwise every rank holds every expert's d_ff shard, and its wd
product is a partial sum (in f32).  Either way a rank's copies of the other
experts (or of the other d_ff shards) count as zeros, each rank's weighted
combine is a partial sum, and one f32 ``all_reduce`` adds them.  Decode
does the same: the grouped path as a prefill, the gather path among the
rank's own experts only (the gate of every selected expert it does not
hold is 0), then one f32 ``all_reduce`` of the ranks' sums.  Under
autograd that sum passes the gradient through, and the dispatched tokens
and the gates pass the model axis's "copy"
(``distributed/collectives.py``): each rank's gradient of them is a
partial over its experts.

Data parallelism (a data axis over 1, ``meshctx.data_axis``): each rank
routes its own tokens.  The default (flat) dispatch is the reference's on
the GLOBAL batch, as GSPMD computes it (``repro/nn/moe.py:55-61``): the
capacity is C = ceil(T_global k cf / E) and a token of one shard can drop
because of another shard's tokens.  The ranks all-gather the expert ids
(small), every rank computes every copy's slot in the global plan and
writes its own copies into the (E, C, D) buffer, one ``all_reduce`` over
data sums the disjoint rows, the experts run on the whole buffer, and each
rank combines its own copies.  The aux loss takes the global means
(``data_mean``).  With ``cfg.moe_local_dispatch`` each data rank
dispatches its own tokens with C from the local T and the aux loss is the
mean of the ranks' (``_moe_forward_grouped``, the reference's vmap over
data shards).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import meshctx
from repro_torch.distributed.collectives import (all_gather_dim,
                                                 all_reduce_f32,
                                                 copy_to_group, data_mean,
                                                 sum_disjoint)
from repro_torch.kernels import ops as kops
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import ParamDef, norm, norm_defs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def moe_defs(cfg: ModelConfig) -> Dict:
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    up = ("experts", "expert_embed", "expert_mlp")
    return {
        "norm": norm_defs(cfg),
        "router": ParamDef((D, E), ("embed_novar", "experts_in")),
        "wg": ParamDef((E, D, Fd), up),
        "wu": ParamDef((E, D, Fd), up),
        "wd": ParamDef((E, Fd, D), ("experts", "expert_mlp", "expert_embed")),
    }


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert.  The round-up to 8 is semantics, not padding: it
    decides which copies drop."""
    c = int(tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def _route(flat: torch.Tensor, router: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs (T, E), gate_vals (T, K), gate_ids (T, K)): top-k of the f32
    softmax of an f32 router product, gates renormalised over the k."""
    probs = torch.softmax(flat.float() @ router.float(), dim=-1)
    gate_vals, gate_ids = torch.topk(probs, k, dim=-1)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_ids


def dispatch_plan(gate_ids: torch.Tensor, num_experts: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, keep, slot) of the T·K token copies, in expert-sorted order.

    ``order`` sorts the copies (token-major, ``gate_ids.reshape(-1)``) by
    expert id, stably, as ``jnp.argsort`` does: within an expert, earlier
    tokens take the slots and the rest drop.  ``keep`` marks the copies
    that fit, ``slot`` is each copy's row of the flat (E·C) buffer, and
    E·C (the overflow row) for every dropped copy."""
    E, C = num_experts, capacity
    eids = gate_ids.reshape(-1)
    eids_s, order = torch.sort(eids, stable=True)
    starts = torch.searchsorted(
        eids_s, torch.arange(E, device=eids.device, dtype=eids_s.dtype),
        right=False)
    pos_in_e = torch.arange(eids.numel(), device=eids.device) \
        - starts[eids_s]
    keep = pos_in_e < C
    slot = torch.where(keep, eids_s * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return order, keep, slot


def _local_experts(w: torch.Tensor, cfg: ModelConfig) -> int:
    """The first global expert of this rank's stacked expert weights
    ``w`` (E_local, ...): 0 unless the experts are split over ranks."""
    if w.shape[0] == cfg.num_experts:
        return 0
    return meshctx.model_axis().coord * w.shape[0]


def _sharded(p: Dict, cfg: ModelConfig) -> bool:
    """Whether this rank's experts are a part of the whole: split experts
    or a d_ff shard of every expert."""
    return (p["wu"].shape[0] != cfg.num_experts
            or p["wu"].shape[-1] != cfg.moe_d_ff)


def _mine(order: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """The positions in ``order`` (a permutation of the global copies) of
    the copies [lo, lo + n), in order, without a host sync."""
    other = (order < lo) | (order >= lo + n)
    return torch.sort(other.to(torch.uint8), stable=True)[1][:n]


def _dispatch_compute(p: Dict, flat: torch.Tensor, cfg: ModelConfig,
                      global_data: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch + expert GEMMs for (T, D) tokens;
    returns (y (T, D) in flat's dtype, aux loss).  ``global_data``: the
    tokens are this rank's shard of the data axis's global batch, which is
    dispatched as one (module docstring)."""
    T, D = flat.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    ax = meshctx.model_axis() if _sharded(p, cfg) else None
    dax = meshctx.data_axis() if global_data else None
    n_data = dax.size if dax is not None else 1
    C = _capacity(cfg, T * n_data)

    probs, gate_vals, gate_ids = _route(flat, p["router"], K)
    # Load-balancing auxiliary loss (Switch Transformer eq. 4), over the
    # global tokens (each shard holds T of them).
    me = probs.mean(0)
    ce = F.one_hot(gate_ids, E).float().sum(1).mean(0)
    if dax is not None:
        me = data_mean(me, dax.group, n_data)
        ce = data_mean(ce, dax.group, n_data)
    aux = E * (me * ce).sum()

    if dax is None:
        order, _, slot = dispatch_plan(gate_ids, E, C)
    else:
        # The global plan; this rank keeps its own copies (token-major
        # rows lo .. lo + T·K of the global expansion), in plan order.
        ids = all_gather_dim(gate_ids, 0, dax.group)
        order, _, slot = dispatch_plan(ids, E, C)
        lo = dax.coord * T * K
        sel = _mine(order, lo, T * K)
        order, slot = order[sel] - lo, slot[sel]
    if ax is not None:
        flat = copy_to_group(flat, ax.group)
        gate_vals = copy_to_group(gate_vals, ax.group)
    copies = flat[:, None, :].expand(T, K, D).reshape(T * K, D)[order]
    xe = _dispatch_buffer(copies, slot, E, C, dax)
    ys = _expert_rows(p, cfg, xe, order, slot)
    yk = ys.view(T, K, D) * gate_vals[..., None].to(ys.dtype)
    if ax is None:
        return yk.to(flat.dtype).sum(1), aux
    return all_reduce_f32(yk.float().sum(1), ax.group).to(flat.dtype), aux


def _dispatch_buffer(copies: torch.Tensor, slot: torch.Tensor, E: int,
                     C: int, dax=None) -> torch.Tensor:
    """The (E, C, D) expert buffer: each kept copy (``copies`` in plan
    order) in its slot, every other row zero.  Dropped copies all land in
    the overflow row E·C, which is cut off.  ``dax``: the data ranks'
    copies hold disjoint slots, and their sum is exact."""
    D = copies.shape[1]
    buf = torch.zeros((E * C + 1, D), dtype=copies.dtype,
                      device=copies.device)
    buf.index_copy_(0, slot, copies)
    xe = buf[:-1]
    if dax is not None:
        xe = sum_disjoint(xe, dax.group)
    return xe.view(E, C, D)


def _expert_rows(p: Dict, cfg: ModelConfig, xe: torch.Tensor,
                 order: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """The three grouped GEMMs on this rank's experts' rows of the (E, C,
    D) buffer ``xe``, each slot's output sent back to the token-major row
    of the copy that owns it: (n, D) for the n = ``order.numel()`` copies,
    in the GEMMs' output dtype (f32 where wd holds a d_ff shard, whose
    product is a partial sum).  A dropped copy's row is zero, so its gate
    weight multiplies nothing, and so is the row of a copy another rank's
    experts hold; an empty slot, or one of another data rank's copies,
    goes to the row n, cut off."""
    E, C, D = xe.shape
    n = order.numel()
    e0, n_e = _local_experts(p["wu"], cfg), p["wu"].shape[0]
    xe = xe[e0:e0 + n_e]
    partial = p["wd"].shape[1] != cfg.moe_d_ff
    u = kops.expert_matmul(xe, p["wu"])
    act = kops.expert_matmul(xe, p["wg"], epilogue="swiglu_gate", gate=u)
    ye = kops.expert_matmul(act, p["wd"],
                            out_dtype=torch.float32 if partial else None)
    owner = torch.full((E * C + 1,), n, dtype=order.dtype,
                       device=order.device)
    owner.index_copy_(0, slot, order)
    ys = torch.zeros((n + 1, D), dtype=ye.dtype, device=ye.device)
    ys.index_copy_(0, owner[e0 * C:(e0 + n_e) * C], ye.reshape(n_e * C, D))
    return ys[:-1]


def moe_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  Tokens over capacity are dropped
    (Switch/GShard semantics; capacity_factor sets the rate).

    ``cfg.moe_local_dispatch`` takes the per-data-shard dispatch only under
    an installed mesh whose data axes exceed 1 and divide the global
    tokens, as in the reference (``repro/nn/moe.py:62-69``); otherwise the
    flat one, over the global batch."""
    mesh = meshctx.get_mesh()
    if cfg.moe_local_dispatch and mesh is not None:
        dp = 1
        for a in meshctx.DATA_AXES:
            dp *= mesh.shape.get(a, 1)
        dax = meshctx.data_axis()
        tokens = x.shape[0] * x.shape[1] * (dax.size if dax else 1)
        if tokens % dp == 0 and dp > 1:
            return _moe_forward_grouped(p, x, cfg, dp)
    return _moe_forward_flat(p, x, cfg)


def _moe_forward_grouped(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                         dp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's per-data-shard dispatch (``repro/nn/moe.py:73-84``):
    the global tokens in ``dp`` groups, each dispatched on its own (C from
    its own token count), the aux loss the groups' mean.  Under a data
    axis of ``dp`` ranks each rank's tokens are its group and the mean is
    taken over the axis; otherwise ``x``'s tokens are split into ``dp``
    groups here."""
    B, S, D = x.shape
    h = norm(x, p["norm"], cfg)
    flat = h.reshape(B * S, D)
    dax = meshctx.data_axis()
    if dax is not None and dax.size == dp:
        y, aux = _dispatch_compute(p, flat, cfg)
        aux = data_mean(aux, dax.group, dp)
    else:
        outs = [_dispatch_compute(p, g, cfg)
                for g in flat.reshape(dp, (B * S) // dp, D)]
        y = torch.cat([o[0] for o in outs])
        aux = torch.stack([o[1] for o in outs]).mean()
    return y.reshape(B, S, D).to(x.dtype), aux


def _moe_forward_flat(p: Dict, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    h = norm(x, p["norm"], cfg)
    y, aux = _dispatch_compute(p, h.reshape(B * S, D), cfg,
                               global_data=True)
    return y.reshape(B, S, D).to(x.dtype), aux


def _span(name: str, follows: bool = False, args: Optional[Dict] = None):
    return obs_trace.span(name, cat="model", track="model", args=args,
                          device=True, follows=follows)


# The boundary between the decode paths, set from device times measured on
# an H100 at qwen3-moe's and mixtral's widths (``tools/moe_decode_ab.py``, 25
# points, each on its faster side, near the middle of the constants that
# separate them): the gather moves about 0.57 TB/s of gathered weights, the
# grouped GEMMs read the weights in place several times faster, and the
# grouped path's sort, buffer and launches cost a fixed 0.1-0.2 ms more, so
# no ratio of copies to experts alone fits both widths.
GATHER_COST = 6
DISPATCH_BYTES = 450e6


def decode_path(cfg: ModelConfig, batch: int, n_local: int,
                weight_bytes: int) -> str:
    """The path of :func:`moe_decode` for ``batch`` tokens on a rank that
    holds ``n_local`` experts of ``weight_bytes`` bytes in all (their three
    weights): ``"dense"`` under ``cfg.moe_dense_decode``; ``"grouped"``
    where gathering the B·K token copies' weights costs at least reading
    every local expert's weights once and dispatching (GATHER_COST·B·K
    experts' bytes >= weight_bytes + DISPATCH_BYTES); else ``"gather"``."""
    if cfg.moe_dense_decode:
        return "dense"
    copies = batch * cfg.experts_per_token
    if GATHER_COST * copies * weight_bytes / n_local \
            >= weight_bytes + DISPATCH_BYTES:
        return "grouped"
    return "gather"


def _weight_bytes(p: Dict) -> int:
    return sum(p[w].nbytes for w in ("wu", "wg", "wd"))


def moe_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Decode-step MoE for x (B, 1, D) on the path that
    :func:`decode_path` chooses from the batch and the local experts."""
    path = decode_path(cfg, x.shape[0], p["wg"].shape[0], _weight_bytes(p))
    return _decode(p, x, cfg, path)


def _decode(p: Dict, x: torch.Tensor, cfg: ModelConfig,
            path: str) -> torch.Tensor:
    """:func:`moe_decode` on ``path``.

    ``"grouped"``: the B·K token copies are dispatched as a prefill's are,
    into an (E, B, D) buffer (top-k ids are distinct per token, so no
    expert takes more than B copies and none drops), the three grouped
    GEMMs read the local experts' weights in place, and each token sums
    its K gated copies in f32, rounded to x's dtype once.  ``"gather"``:
    the reference's einsums on the K selected experts' weights gathered
    per token (B·K·D·F items copied per weight).  ``"dense"``
    (``cfg.moe_dense_decode``): every expert on every token, the sum
    masked by the gates.  Under expert parallelism a rank computes its own
    experts' copies only (the grouped path leaves the other copies' rows
    zero; the gather path gathers a selected expert another rank holds as
    the rank's first, under a gate of 0) and the ranks' sums are added in
    f32.  Each call counts one ``moe_decode_calls`` (label ``path``).

    With a tracer installed the parts are timed on the device: the
    grouped path's ``moe.dispatch`` (the sort and the buffer) and
    ``moe.experts`` (the GEMMs and the combine; args ``path`` and
    ``weight_bytes``, the local experts' three weights' bytes), the
    gather path's ``moe.gather`` (``gathered_bytes``, the gathered
    tensors' bytes) and ``moe.experts``, the dense path's ``moe.experts``
    alone."""
    B, _, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    ax = meshctx.model_axis() if _sharded(p, cfg) else None
    e0, n_e = _local_experts(p["wg"], cfg), p["wg"].shape[0]
    h = norm(x, p["norm"], cfg).reshape(B, D)
    _, gate_vals, gate_ids = _route(h, p["router"], K)
    obs_metrics.inc("moe_decode_calls", labels={"path": path})

    if path == "dense":
        with _span("moe.experts"):
            gates = torch.einsum("bke,bk->be",
                                 F.one_hot(gate_ids, E).float(), gate_vals)
            g = torch.einsum("bd,edf->ebf", h, p["wg"])
            u = torch.einsum("bd,edf->ebf", h, p["wu"])
            ye = torch.einsum("ebf,efd->ebd", F.silu(g) * u, p["wd"])
            y = torch.einsum("ebd,be->bd", ye,
                             gates[:, e0:e0 + n_e].to(ye.dtype))
    elif path == "grouped":
        with _span("moe.dispatch"):
            order, _, slot = dispatch_plan(gate_ids, E, B)
            copies = h[:, None, :].expand(B, K, D).reshape(B * K, D)[order]
            xe = _dispatch_buffer(copies, slot, E, B)
        with _span("moe.experts", follows=True,
                   args={"path": path, "weight_bytes": _weight_bytes(p)}):
            ys = _expert_rows(p, cfg, xe, order, slot)
            y = (ys.view(B, K, D).float() * gate_vals[..., None]).sum(1)
    else:
        if ax is not None:
            local = gate_ids - e0
            mine = (local >= 0) & (local < n_e)
            gate_ids = torch.where(mine, local, 0)
            gate_vals = torch.where(mine, gate_vals, 0.0)
        with _span("moe.gather") as sp:
            wg = p["wg"][gate_ids]            # (B, K, D, F) gather
            wu = p["wu"][gate_ids]
            wd = p["wd"][gate_ids]
            if sp is not None:
                sp.args = {"gathered_bytes":
                           wg.nbytes + wu.nbytes + wd.nbytes}
        with _span("moe.experts", follows=True):
            g = torch.einsum("bd,bkdf->bkf", h, wg)
            u = torch.einsum("bd,bkdf->bkf", h, wu)
            y = torch.einsum("bkf,bkfd->bkd", F.silu(g) * u, wd)
            y = torch.einsum("bkd,bk->bd", y, gate_vals.to(y.dtype))
    if ax is not None:
        y = all_reduce_f32(y, ax.group)
    return y.reshape(B, 1, D).to(x.dtype)
