"""Plain PyTorch versions of every kernel (the port of ``repro.kernels.ref``).

They define what the CUDA kernels compute.  The kernel wrappers use them
for CPU tensors only; on the card they are what ``chip_smoke.py`` holds
each kernel against.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.latency import EPILOGUE_NONE, Epilogue


def apply_epilogue_ref(
    acc: torch.Tensor,
    ep: Epilogue,
    *,
    bias: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused kernel's flush-step epilogue, in f32, same operation order
    (DESIGN.md §3): +bias -> activation (silu(y)*gate for swiglu_gate) ->
    +residual.  Caller casts to out_dtype.  ``gelu`` is the tanh
    approximation, as ``jax.nn.gelu`` is by default."""
    acc = acc.float()
    if ep.bias:
        acc = acc + bias.float()
    if ep.activation == "gelu":
        acc = F.gelu(acc, approximate="tanh")
    elif ep.activation == "silu":
        acc = F.silu(acc)
    elif ep.activation == "swiglu_gate":
        acc = F.silu(acc) * gate.float()
    if ep.residual:
        acc = acc + residual.float()
    return acc


def matmul_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    *,
    epilogue: Optional[Epilogue] = None,
    bias: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C = epilogue(A @ B). a: (..., M, K), b: (K, N).

    A bf16 product with bf16 output and no epilogue stays a bf16 matmul
    (f32 accumulation inside, one rounding), as the JAX oracle's
    ``preferred_element_type=bf16`` dot; every other case accumulates in f32
    on exact f32 copies of the operands and casts once."""
    ep = epilogue or EPILOGUE_NONE
    if (ep.is_identity and out_dtype == torch.bfloat16
            and a.dtype == b.dtype == torch.bfloat16):
        return torch.matmul(a, b)
    acc = torch.matmul(a.float(), b.float())
    if not ep.is_identity:
        acc = apply_epilogue_ref(acc, ep, bias=bias, gate=gate,
                                 residual=residual)
    return acc.to(out_dtype)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Dense softmax attention oracle with GQA head-group broadcast.

    q: (B, H, Sq, d); k, v: (B, Hkv, Skv, d). Returns (B, H, Sq, d)."""
    B, H, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    group = H // Hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    k_ids = torch.arange(Skv, device=q.device)
    if kv_len is not None:
        mask = mask & (k_ids[None, :] < kv_len)
    if causal:
        q_ids = torch.arange(Sq, device=q.device)
        mask = mask & (q_ids[:, None] >= k_ids[None, :])
    s = s.masked_fill(~mask, float("-inf"))
    # Guard fully-masked rows (padding queries): softmax of all -inf -> 0.
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
