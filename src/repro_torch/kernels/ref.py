"""Plain PyTorch versions of every kernel (the port of ``repro.kernels.ref``).

They define what the CUDA kernels compute.  The kernel wrappers use them
for tensors on a device of :data:`PLAIN_DEVICES` only (the CPU, and
"meta", which the dry-run runs a step on to count its FLOPs); on the card
they are what ``chip_smoke.py`` holds each kernel against.  The backward versions (``epilogue_bwd_ref``,
``matmul_bwd_ref``, ``attention_bwd_ref``) are the gradients that JAX
derives through the reference's forward functions, written out in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.latency import EPILOGUE_NONE, Epilogue

# The devices whose tensors take each kernel's plain version; a CUDA tensor
# launches the kernel or raises.
PLAIN_DEVICES = ("cpu", "meta")


def gemm_tolerance(dtype: torch.dtype, K: int) -> Tuple[float, float]:
    """(rtol, atol) of a GEMM with ``dtype`` operands and reduction length
    ``K`` against its plain product (``tests/test_kernels.py:26-27``)."""
    if dtype == torch.float32:
        return 1e-5, 1e-4 * K ** 0.5
    return 3e-2, 0.3 * K ** 0.5


# The relative L2 error a GEMM may show against its plain product, by
# operand dtype.  Rounding and summation order give about 1e-4 in bf16 and
# 1e-6 in f32 (split TF32); a zeroed tile or a dropped split-K slice gives
# 1e-1 or more whatever the operands' scale, where the absolute tolerance
# above assumes unit-normal operands.
GEMM_REL_L2_CAP = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def gemm_check(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
               K: int) -> Tuple[bool, float, float]:
    """Whether a GEMM's output ``got`` agrees with its plain product
    ``want`` (``dtype``: the operands'; ``K``: the reduction length):
    finite, every element within :func:`gemm_tolerance`, and the relative
    L2 error within :data:`GEMM_REL_L2_CAP`.  Returns (agrees, max abs
    error, relative L2 error)."""
    got, want = got.float(), want.float()
    rtol, atol = gemm_tolerance(dtype, K)
    diff = got - want
    err = diff.abs()
    rel = float(torch.linalg.vector_norm(diff)
                / torch.linalg.vector_norm(want).clamp_min(1e-30))
    ok = (bool(torch.isfinite(got).all())
          and bool((err <= atol + rtol * want.abs()).all())
          and rel <= GEMM_REL_L2_CAP.get(dtype, 1e-2))
    return ok, float(err.max()), rel


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
    window: int = 0,
) -> torch.Tensor:
    """Dense softmax attention oracle with GQA head-group broadcast.

    q: (B, H, Sq, d); k, v: (B, Hkv, Skv, d). Returns (B, H, Sq, d).
    ``window`` > 0 also hides key j from query i unless i - j < window
    (strict, as ``repro/nn/attention.py:80-82``)."""
    B, H, Sq, d = q.shape
    Hkv = k.shape[1]
    group = H // Hkv
    scale = scale if scale is not None else d ** -0.5
    s, mask = _scores(q, k, causal=causal, scale=scale, kv_len=kv_len,
                      window=window)
    vf = v.float().repeat_interleave(group, dim=1)
    s = s.masked_fill(~mask, float("-inf"))
    # Guard fully-masked rows (padding queries): softmax of all -inf -> 0.
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


_GELU_C = 0.7978845608028654          # sqrt(2 / pi)


def epilogue_bwd_ref(
    dout: torch.Tensor,
    z: Optional[torch.Tensor],
    ep: Epilogue,
    *,
    gate: Optional[torch.Tensor] = None,
    dz_dtype: torch.dtype,
    want_bias: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward of :func:`apply_epilogue_ref` at the pre-activation z =
    acc (+ bias), in f32: (dz, dgate, dbias).  dz = dout * act'(z) (dout
    itself without an activation) in ``dz_dtype``; dgate = dout * silu(z)
    in the gate's dtype (swiglu only); dbias = the column sums of dz, f32,
    when ``want_bias`` (of each group's rows for a grouped (E, M, N) dout:
    dbias (E, N)).  The residual's gradient is dout."""
    d = dout.float()
    dgate = None
    if ep.activation == "gelu":
        zf = z.float()
        t = torch.tanh(_GELU_C * (zf + 0.044715 * zf * zf * zf))
        d = d * (0.5 * (1.0 + t) + 0.5 * zf * (1.0 - t * t) * _GELU_C
                 * (1.0 + 3.0 * 0.044715 * zf * zf))
    elif ep.activation in ("silu", "swiglu_gate"):
        zf = z.float()
        s = torch.sigmoid(zf)
        if ep.activation == "swiglu_gate":
            dgate = (d * zf * s).to(gate.dtype)
            d = d * gate.float()
        d = d * (s * (1.0 + zf * (1.0 - s)))
    dbias = d.sum(dim=-2) if want_bias else None
    return d.to(dz_dtype), dgate, dbias


def matmul_bwd_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    dout: torch.Tensor,
    *,
    epilogue: Optional[Epilogue] = None,
    bias: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
           Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The gradients (da, db, dbias, dgate, dresidual) of :func:`matmul_ref`
    for a (M, K), b (K, N) and dout (M, N), in f32 and cast to each
    operand's dtype: z = a b (+ bias) is recomputed in f32, then
    :func:`epilogue_bwd_ref`, then da = dz b^T and db = a^T dz."""
    ep = epilogue or EPILOGUE_NONE
    z = None
    if ep.activation is not None:
        z = torch.matmul(a.float(), b.float())
        if ep.bias:
            z = z + bias.float()
    dz, dgate, dbias = epilogue_bwd_ref(dout, z, ep, gate=gate,
                                        dz_dtype=torch.float32,
                                        want_bias=ep.bias)
    da = torch.matmul(dz, b.float().t()).to(a.dtype)
    db = torch.matmul(a.float().t(), dz).to(b.dtype)
    return (da, db, dbias.to(bias.dtype) if ep.bias else None, dgate,
            dout if ep.residual else None)


def _scores(q, k, *, causal, scale, kv_len, window=0):
    """f32 scaled scores (B, H, Sq, Skv) with GQA broadcast, and the mask
    of visible (query, key) pairs (positions from 0, key < kv_len, and
    query - key < window where ``window`` > 0)."""
    B, H, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    kf = k.float().repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    k_ids = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = mask & (k_ids[None, :] < kv_len)
    q_ids = torch.arange(Sq, device=q.device)
    if causal:
        mask = mask & (q_ids[:, None] >= k_ids[None, :])
    if window > 0:
        mask = mask & (q_ids[:, None] - k_ids[None, :] < window)
    return s, mask


def attention_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_ref` and the row log-sum-exp of its scaled scores,
    lse (B, H, Sq) f32 in natural units, +inf for a row with no visible
    key (so that the backward's exp(s - lse) is 0 there)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s, mask = _scores(q, k, causal=causal, scale=scale, kv_len=kv_len,
                      window=window)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    lse = torch.where(torch.isfinite(lse), lse,
                      torch.full_like(lse, float("inf")))
    return attention_ref(q, k, v, causal=causal, scale=scale,
                         kv_len=kv_len, window=window), lse


def attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_ref` from q, k, v, the forward's o
    and lse, and do, in f32 and cast to the inputs' dtypes: P = exp(S scale
    - lse) on the visible pairs, delta = rowsum(do o), dS = P (do v^T -
    delta), dq = scale dS k, dk = scale dS^T q and dv = P^T do, each kv
    head summing the q heads of its GQA group."""
    B, H, Sq, d = q.shape
    Hkv = k.shape[1]
    group = H // Hkv
    scale = scale if scale is not None else d ** -0.5
    s, mask = _scores(q, k, causal=causal, scale=scale, kv_len=kv_len,
                      window=window)
    p = torch.exp(s - lse.float()[..., None]).masked_fill(~mask, 0.0)
    dof = do.float()
    vf = v.float().repeat_interleave(group, dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    kf = k.float().repeat_interleave(group, dim=1)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    Skv = k.shape[2]
    dk = dk.reshape(B, Hkv, group, Skv, d).sum(dim=2)
    dv = dv.reshape(B, Hkv, group, Skv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
