"""Analytic per-device memory and HBM-traffic estimates, with no card and
no compile (the port of ``repro/launch/memory.py``).

The footprint a cell needs on each device follows from the sharding rules
alone (``distributed/sharding.py``'s ``rules_for`` / ``spec_for``, the
reference's layout):

    params + optimizer (m, v) + gradient transient + remat layer stash
    + decode/prefill caches

:class:`FakeMesh`, :func:`estimate_cell_memory`,
:func:`estimate_step_hbm_bytes` and :func:`select_microbatches` are the
reference's arithmetic, line for line.  The one change is the budget: the
reference asks whether a cell fits a TPU's 16 GiB of HBM, the port asks
of a topology's HBM capacity, ``GPU_H100_LIKE``'s 80 GiB by default
(``estimate_cell_memory``'s ``fits_hbm``; ``select_microbatches`` keeps
the reference's share of it, 14/16).  A caller may pass any budget in GiB
instead (the tests pass the reference's 16 and 14).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.topology import HardwareSpec
from repro_torch.distributed.sharding import SEQ_AXES, rules_for, spec_for
from repro_torch.meshctx import DATA_AXES
from repro_torch.nn.config import ModelConfig, ShapeSpec
from repro_torch.nn.model import Model

# The share of the HBM ``select_microbatches`` budgets for (the
# reference's 14 GiB of 16).
MICROBATCH_SHARE = 14.0 / 16.0


@dataclass(frozen=True)
class FakeMesh:
    """A mesh of ``shape`` ({axis name: size}) with no devices: only
    ``.shape`` is consulted by ``spec_for``."""
    shape: Dict[str, int]


def hbm_gib(hw: HardwareSpec = GPU_H100_LIKE) -> float:
    """The device memory of ``hw`` in GiB: its outermost level's
    capacity."""
    return hw.levels[0].capacity / 2**30


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _shard_factor(spec, mesh: FakeMesh) -> int:
    f = 1
    for part in spec:
        if part is None:
            continue
        for ax in (part if isinstance(part, tuple) else (part,)):
            f *= mesh.shape[ax]
    return f


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _tree_device_bytes(abstract, axes, rules, mesh: FakeMesh) -> int:
    total = 0
    ax = dict(_leaves(axes))
    for path, a in _leaves(abstract):
        spec = spec_for(tuple(a.shape), ax[path], rules, mesh)
        total += _bytes(a.shape, a.dtype) // _shard_factor(spec, mesh)
    return total


def _local_batch(shape: ShapeSpec, mesh: FakeMesh) -> int:
    batch_axes = [a for a in DATA_AXES if a in mesh.shape]
    bt = math.prod(mesh.shape[a] for a in batch_axes) or 1
    return shape.global_batch // bt if shape.global_batch % bt == 0 \
        else shape.global_batch


def estimate_cell_memory(cfg: ModelConfig, shape: ShapeSpec,
                         mesh_shape: Optional[Dict[str, int]] = None, *,
                         hbm_budget_gib: Optional[float] = None,
                         hw: HardwareSpec = GPU_H100_LIKE
                         ) -> Dict[str, float]:
    """Per-device GiB by category for one (arch, shape, mesh) cell, their
    total, the mesh's chips, and ``fits_hbm``: the total within
    ``hbm_budget_gib`` (default ``hw``'s HBM capacity)."""
    mesh = FakeMesh(mesh_shape or {"data": 16, "model": 16})
    chips = math.prod(mesh.shape.values())
    model = Model(cfg, device="meta")
    rules = rules_for(cfg)
    abst = model.abstract_params()
    axes = model.param_axes()

    out: Dict[str, float] = {}
    params_dev = _tree_device_bytes(abst, axes, rules, mesh)
    out["params"] = params_dev

    batch_axes = [a for a in DATA_AXES if a in mesh.shape]
    bt = math.prod(mesh.shape[a] for a in batch_axes) or 1
    b_loc = _local_batch(shape, mesh)

    if shape.kind == "train":
        out["optimizer_m_v"] = 2 * params_dev * 2      # f32 vs bf16 params
        out["gradients"] = params_dev
        # remat stash: one carry per scanned layer (bf16 hidden state)
        n_iters = cfg.num_layers
        if cfg.family == "hybrid":
            n_iters = cfg.num_layers // cfg.shared_attn_every \
                + cfg.num_layers % cfg.shared_attn_every
        out["remat_stash"] = n_iters * b_loc * shape.seq_len \
            * cfg.d_model * 2
        # largest transient: one layer's activations (~4x hidden) + loss chunk
        out["transient_est"] = 8 * b_loc * shape.seq_len * cfg.d_model * 2
    else:
        cache = model.cache_specs(shape.global_batch, shape.seq_len)
        cache_dev = 0
        for path, s in _leaves(cache):
            name = path.rsplit("/", 1)[-1]
            # mirror distributed.sharding.cache_shardings factors
            f = 1
            B = s.shape[1]
            used = []
            if batch_axes and B % bt == 0:
                f *= bt
                used = list(batch_axes)
            if name in ("k", "v"):
                seq_axes = [a for a in SEQ_AXES
                            if a in mesh.shape and a not in used]
                st = math.prod(mesh.shape[a] for a in seq_axes) or 1
                if seq_axes and s.shape[3] % st == 0:
                    f *= st
            elif "model" in mesh.shape and "model" not in used:
                m = mesh.shape["model"]
                if any(d % m == 0 for d in s.shape[2:]):
                    f *= m
            cache_dev += _bytes(s.shape, s.dtype) // f
        out["kv_or_state_cache"] = cache_dev
        out["transient_est"] = 4 * b_loc * max(1, shape.seq_len
                                               if shape.kind == "prefill"
                                               else 1) * cfg.d_model * 2

    out = {k: v / 2**30 for k, v in out.items()}
    out["total_gib"] = sum(out.values())
    out["chips"] = chips
    budget = hbm_gib(hw) if hbm_budget_gib is None else hbm_budget_gib
    out["hbm_gib"] = budget
    out["fits_hbm"] = out["total_gib"] <= budget
    return out


def estimate_step_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec,
                            mesh_shape: Optional[Dict[str, int]] = None,
                            microbatches: int = 1) -> Dict[str, float]:
    """Fusion-aware per-device HBM traffic of one step (the roofline's
    memory term): only fusion-boundary traffic counts — weights (x3: fwd +
    remat + bwd), remat stash (write + read), per-layer activation
    materializations (~8 hidden-sized tensors x3 passes), the flash
    attention's KV refetch (nq x (K+V)), the loss logits chunks, optimizer
    state (m, v read + write f32 + param update), caches.  Returns a
    breakdown with "total" in bytes."""
    mesh = FakeMesh(mesh_shape or {"data": 16, "model": 16})
    model = Model(cfg, device="meta")
    rules = rules_for(cfg)
    params_dev = _tree_device_bytes(model.abstract_params(),
                                    model.param_axes(), rules, mesh)
    b_loc = _local_batch(shape, mesh)
    tp = mesh.shape.get("model", 1)
    D, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    S = shape.seq_len
    hid = b_loc * S * D * 2                       # one bf16 hidden tensor

    out: Dict[str, float] = {}
    if shape.kind == "train":
        # gathered weights are read fwd + remat + bwd (bf16)
        out["weights"] = 3.0 * params_dev * (2 if cfg.fsdp else 1)
        n_iters = L if cfg.family != "hybrid" else \
            L // cfg.shared_attn_every + L % cfg.shared_attn_every
        out["remat_stash"] = 2.0 * n_iters * hid   # write + read (sum over
        # microbatches: per-microstep stash is hid/mb, times mb steps)
        out["layer_activations"] = 8.0 * n_iters * hid * 3
        if cfg.num_heads:
            Hl = max(1, cfg.num_heads // tp)
            nq = max(1, S // 512)
            kv = b_loc * S * Hl * cfg.head_dim * 2
            out["attention_kv_refetch"] = 3.0 * L * nq * 2 * kv \
                if cfg.family not in ("ssm",) else 0.0
        out["logits"] = 3.0 * b_loc * S * (V // tp) * 4
        out["optimizer"] = 2 * (params_dev * 2) * 2 + 4 * params_dev
        out["gradients"] = 2.0 * params_dev
    elif shape.kind == "prefill":
        out["weights"] = params_dev * (2 if cfg.fsdp else 1)
        out["layer_activations"] = 8.0 * L * hid
        if cfg.num_heads:
            Hl = max(1, cfg.num_heads // tp)
            nq = max(1, S // 512)
            kv = b_loc * S * Hl * cfg.head_dim * 2
            out["attention_kv_refetch"] = L * nq * 2 * kv \
                if cfg.family not in ("ssm",) else 0.0
        est = estimate_cell_memory(cfg, shape, mesh_shape)
        out["cache_write"] = est["kv_or_state_cache"] * 2**30
        out["logits"] = b_loc * (V // tp) * 4
    else:  # decode
        out["weights"] = params_dev * (2 if cfg.fsdp else 1)
        est = estimate_cell_memory(cfg, shape, mesh_shape)
        out["cache_read"] = est["kv_or_state_cache"] * 2**30
        out["activations"] = 20.0 * b_loc * D * 2 * L
        out["logits"] = b_loc * (V // tp) * 4
    out["total"] = sum(out.values())
    return out


def select_microbatches(cfg: ModelConfig, shape: ShapeSpec,
                        mesh_shape: Optional[Dict[str, int]] = None,
                        hbm_budget_gib: Optional[float] = None, *,
                        hw: HardwareSpec = GPU_H100_LIKE) -> int:
    """The smallest gradient-accumulation factor whose predicted
    per-device footprint fits the budget (default MICROBATCH_SHARE of
    ``hw``'s HBM): the paper's zero-autotuning rule one level up.

    Footprint(mb) = fixed (params + m/v + grads + f32 grad accumulator for
    mb>1) + (stash + transients)/mb.  Deterministic, O(#mb)."""
    if shape.kind != "train":
        return 1
    if hbm_budget_gib is None:
        hbm_budget_gib = MICROBATCH_SHARE * hbm_gib(hw)
    est = estimate_cell_memory(cfg, shape, mesh_shape)
    fixed = est["params"] + est["optimizer_m_v"] + est["gradients"]
    act = est["remat_stash"] + est["transient_est"]
    for mb in (1, 2, 4, 8, 16, 32):
        if shape.global_batch % mb:
            continue
        accum = 0.0 if mb == 1 else 2 * est["params"]  # f32 accumulator
        if fixed + accum + act / mb <= hbm_budget_gib:
            return mb
    return 32
