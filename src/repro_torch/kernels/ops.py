"""Public kernel ops: selector-driven GEMM and attention on PyTorch tensors.

The device of the operands decides the route.  On a CUDA tensor each op
launches its hand-written Hopper kernel (``kernels/matmul.py`` for
:func:`matmul` and :func:`expert_matmul`, ``kernels/flash_attention.py``);
on a CPU tensor the same selection, launch validation, fault injection and
fallback ladder run, and the launch computes with the kernel's plain
version.  There is no backend switch.

Selection happens per call from the static shapes via
``repro_torch.core.selector.select_gemm_config`` — the tritonBLAS contract:
zero autotuning, deterministic, memoised.  The default topology is
``GPU_H100_LIKE``.

Fail-soft launch (DESIGN.md §9): selector-driven launches re-validate the
selection and, on a launch failure, walk the deterministic fallback ladder
— next-ranked candidate, then the conservative safe config — each
transient-retried and each downgrade reported as a ``fallback:<rung>``
selection source.  When every tiled rung fails, a CPU launch serves the
plain version as the last (``reference``) rung; a CUDA launch raises,
because the card never serves the plain version.  Explicitly passed
``config`` objects are the caller's contract: transient retry, no ladder.

Gradients.  Where autograd records (grad enabled and an operand requires
grad), :func:`matmul`, :func:`expert_matmul` and :func:`flash_attention`
run as ``torch.autograd.Function``s whose backward is kernels too: the
GEMM's dA = dZ B^T and dB = A^T dZ are the same Hopper GEMM reading B or A
in place (``trans_b`` / ``trans_a``), each product selected for its own
(M, N, K); an activation's dZ comes from the epilogue-backward kernel on
the pre-activation, recomputed in f32 by the GEMM.  The grouped GEMM's
gradient is the same per expert, each product one grouped launch for all
experts (dX_e = dZ_e W_e^T, dW_e = X_e^T dZ_e, read in place), dZ, dgate
and the per-expert dbias one grouped epilogue backward.  Attention's
backward is the flash backward kernels on the forward's saved output and
row log-sum-exp.  Otherwise (serving, under ``torch.inference_mode``) the ops
launch directly and build no autograd node.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.dtypes import DTYPE_BYTES
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import (EPILOGUE_NONE, Epilogue, GemmProblem,
                                      TileConfig)
from repro_torch.core.selector import (Selection, emit_fallback,
                                       fallback_ladder, select_gemm_config,
                                       validate_selection)
from repro_torch.core.topology import (DegradedModeWarning, HardwareSpec,
                                       topology_fingerprint)
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault_tolerance import retry

# ---------------------------------------------------------------------------
# Default serving hardware.  Call sites that don't pass ``hw`` price their
# selections against this topology.  ``None`` -> the gpu_h100_like preset.
# ---------------------------------------------------------------------------

_hw_override: Optional[HardwareSpec] = None


def set_default_hardware(hw: Optional[HardwareSpec]) -> None:
    """Set the topology used when call sites omit ``hw`` (None -> preset)."""
    global _hw_override
    _hw_override = hw


def get_default_hardware() -> HardwareSpec:
    return _hw_override if _hw_override is not None else GPU_H100_LIKE


# ---------------------------------------------------------------------------
# Launch fault injection.  When set, the injector is invoked with the
# TileConfig about to launch and may raise — a transient-marked error
# exercises the retry path, anything else the fallback ladder.  Never set
# in production.
# ---------------------------------------------------------------------------

_launch_fault_injector: Optional[Callable[[TileConfig], None]] = None


def set_launch_fault_injector(
        fn: Optional[Callable[[TileConfig], None]]
) -> Optional[Callable[[TileConfig], None]]:
    """Install (or clear, with None) the launch fault injector; returns
    the previous injector so tests can restore it."""
    global _launch_fault_injector
    prev = _launch_fault_injector
    _launch_fault_injector = fn
    return prev


# Transient-retry policy for kernel launches: short, capped backoff — a
# launch retry protects against injected/driver transients, not outages.
_LAUNCH_RETRIES = 2
_LAUNCH_BASE_DELAY = 0.01
_LAUNCH_MAX_DELAY = 0.1

# validate_selection prices the config; on the eager path it would run on
# every call, so its verdict is memoised per (problem, config, topology).
_VALIDATED: Dict[Tuple[GemmProblem, TileConfig, str], Optional[str]] = {}


def _validate(p: GemmProblem, cfg: TileConfig,
              hw: HardwareSpec) -> Optional[str]:
    key = (p, cfg, topology_fingerprint(hw))
    if key not in _VALIDATED:
        _VALIDATED[key] = validate_selection(p, cfg, hw)
    return _VALIDATED[key]


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _normalize_epilogue(
    epilogue: Optional[Union[str, Epilogue]],
    bias, gate, residual,
) -> Epilogue:
    """Accept an Epilogue spec, an activation-name shorthand, or infer the
    spec from which operands were passed; validate operand presence."""
    if isinstance(epilogue, Epilogue):
        ep = epilogue
    elif isinstance(epilogue, str):
        ep = Epilogue(bias=bias is not None, activation=epilogue,
                      residual=residual is not None)
    else:
        ep = Epilogue(bias=bias is not None,
                      activation="swiglu_gate" if gate is not None else None,
                      residual=residual is not None)
    if ep.bias != (bias is not None):
        raise ValueError(f"epilogue {ep} vs bias operand "
                         f"{'present' if bias is not None else 'missing'}")
    if (ep.activation == "swiglu_gate") != (gate is not None):
        raise ValueError(f"epilogue {ep} vs gate operand "
                         f"{'present' if gate is not None else 'missing'}")
    if ep.residual != (residual is not None):
        raise ValueError(f"epilogue {ep} vs residual operand "
                         f"{'present' if residual is not None else 'missing'}")
    return ep


def _model_dtype_name(dt: torch.dtype) -> str:
    """The dtype name handed to the cost model — epilogue write bytes must be
    priced in the TRUE out_dtype (bf16 halves them); fall back to f32 only
    for dtypes the model has no byte width for."""
    name = _dtype_name(dt)
    return name if name in DTYPE_BYTES else "float32"


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    out_dtype: Optional[torch.dtype] = None,
    hw: Optional[HardwareSpec] = None,
    config: Optional[TileConfig] = None,
    epilogue: Optional[Union[str, Epilogue]] = None,
    bias: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Selector-driven fused GEMM: ``epilogue(a @ b)``.

    a: (..., M, K) [leading dims folded], b: (K, N).  Epilogue operands:
    bias (N,), gate/residual (..., M, N) matching a's leading dims.
    ``epilogue`` may be an :class:`Epilogue`, an activation name shorthand
    ("gelu" | "silu" | "swiglu_gate"), or omitted (inferred from operands).

    ``config`` (and selections on multi-core topologies) may carry
    ``schedule="stream_k"`` or ``split_k > 1``; the Hopper kernel runs
    both as given, on a persistent grid of one CTA per SM that sums split
    tiles deterministically in k order (``kernels/matmul.py::work_plan``).
    """
    hw = hw if hw is not None else get_default_hardware()
    out_dtype = out_dtype or a.dtype
    ep = _normalize_epilogue(epilogue, bias, gate, residual)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (a, b, bias, gate, residual)):
        return _Matmul.apply(a, b, bias, gate, residual, ep, out_dtype, hw,
                             config)
    return _matmul_forward(a, b, ep, out_dtype, hw, config, bias, gate,
                           residual)


def _matmul_forward(a, b, ep, out_dtype, hw, config, bias, gate, residual):
    """The forward of :func:`matmul` on (..., M, K) @ (K, N)."""
    lead = tuple(a.shape[:-2]) if a.dim() > 2 else ()
    M = 1
    for s in (*lead, a.shape[-2]):
        M *= s
    K, N = b.shape
    gate2 = gate.reshape(M, N).contiguous() if gate is not None else None
    res2 = residual.reshape(M, N).contiguous() if residual is not None \
        else None
    out = _gemm(a.reshape(M, K).contiguous(), b.contiguous(), ep, out_dtype,
                hw, config, bias=bias.contiguous() if bias is not None
                else None, gate=gate2, residual=res2)
    return out.reshape(*lead, a.shape[-2], N) if lead else out


def _gemm(a: torch.Tensor, b: torch.Tensor, ep: Epilogue,
          out_dtype: torch.dtype, hw: HardwareSpec,
          config: Optional[TileConfig] = None, *,
          bias: Optional[torch.Tensor] = None,
          gate: Optional[torch.Tensor] = None,
          residual: Optional[torch.Tensor] = None,
          trans_a: bool = False, trans_b: bool = False) -> torch.Tensor:
    """epilogue(A @ B) on 2-D operands as stored (A = a.t() with
    ``trans_a``, B = b.t() with ``trans_b``), selected for its own
    (M, N, K) unless ``config`` is given, behind the fail-soft launch."""
    M = a.shape[1] if trans_a else a.shape[0]
    K = a.shape[0] if trans_a else a.shape[1]
    N = b.shape[0] if trans_b else b.shape[1]
    selected: Optional[Selection] = None
    if config is None:
        selected = select_gemm_config(M, N, K,
                                      in_dtype=_dtype_name(a.dtype),
                                      out_dtype=_model_dtype_name(out_dtype),
                                      epilogue=ep,
                                      hw=hw)
        config = selected.config
    kw = dict(out_dtype=out_dtype, epilogue=ep, bias=bias, gate=gate,
              residual=residual, trans_a=trans_a, trans_b=trans_b)
    return _launch_fail_soft(
        lambda cfg: kmm.tiled_matmul(a, b, cfg, **kw),
        lambda: kmm.matmul_plain(a, b, config, **kw),
        config, selected, hw, (M, N, K), a.device)


class _Matmul(torch.autograd.Function):
    """:func:`matmul` under autograd.  Saves a, b, bias and gate (the
    residual's gradient is the output's); the backward recomputes an
    activation's pre-activation z = A B (+ bias) in f32 with the GEMM
    rather than storing it, takes dZ (and dgate, dbias) from the
    epilogue-backward kernel, then dA = dZ B^T with b read in place and
    dB = A^T dZ with a read in place."""

    @staticmethod
    def forward(ctx, a, b, bias, gate, residual, ep, out_dtype, hw, config):
        ctx.save_for_backward(a, b, bias, gate)
        ctx.ep, ctx.hw = ep, hw
        ctx.res_meta = ((residual.shape, residual.dtype)
                        if residual is not None else None)
        return _matmul_forward(a, b, ep, out_dtype, hw, config, bias, gate,
                               residual)

    @staticmethod
    def backward(ctx, dout):
        a, b, bias, gate = ctx.saved_tensors
        ep, hw = ctx.ep, ctx.hw
        need_a, need_b, need_bias, need_gate, need_res = \
            ctx.needs_input_grad[:5]
        K, N = b.shape
        a2 = a.reshape(-1, K).contiguous()
        M = a2.shape[0]
        d2 = dout.reshape(M, N).contiguous()
        gate2 = gate.reshape(M, N).contiguous() if gate is not None else None
        dz, dgate, dbias = d2, None, None
        if ep.activation is not None:
            z = _gemm(a2, b.contiguous(), Epilogue(bias=ep.bias),
                      torch.float32, hw, bias=bias)
            dz, dgate, dbias = kmm.epilogue_bwd(
                d2, z, epilogue=ep, gate=gate2, dz_dtype=a.dtype,
                want_bias=ep.bias and need_bias)
        elif ep.bias and need_bias:
            _, _, dbias = kmm.epilogue_bwd(d2, None, epilogue=ep,
                                           dz_dtype=a.dtype, want_bias=True)
        dz = dz.to(a.dtype)
        none = EPILOGUE_NONE
        da = (_gemm(dz, b.contiguous(), none, a.dtype, hw,
                    trans_b=True).reshape(a.shape) if need_a else None)
        db = (_gemm(a2, dz, none, b.dtype, hw, trans_a=True)
              if need_b else None)
        dres = None
        if need_res:
            shape, dtype = ctx.res_meta
            dres = dout.reshape(shape).to(dtype)
        return (da, db,
                dbias.to(bias.dtype) if dbias is not None else None,
                dgate.reshape(gate.shape) if need_gate and dgate is not None
                else None,
                dres, None, None, None, None)


def expert_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    out_dtype: Optional[torch.dtype] = None,
    hw: Optional[HardwareSpec] = None,
    epilogue: Optional[Union[str, Epilogue]] = None,
    bias: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped GEMM with per-group weights: x (E, M, K) @ w (E, K, N) ->
    (E, M, N), with the same fused epilogue as :func:`matmul`; epilogue
    operands carry the leading E dim: bias (E, N), gate/residual (E, M, N).

    The selector prices the per-expert (M, N, K) problem once and every
    expert runs that config, as the reference's ``jax.vmap`` of ``matmul``
    does; on the card all experts run in one launch of the grouped kernel
    (``kernels/matmul.py::tiled_expert_matmul``)."""
    hw = hw if hw is not None else get_default_hardware()
    out_dtype = out_dtype or x.dtype
    ep = _normalize_epilogue(epilogue, bias, gate, residual)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, bias, gate, residual)):
        return _ExpertMatmul.apply(x, w, bias, gate, residual, ep, out_dtype,
                                   hw)
    return _expert_gemm(x, w, ep, out_dtype, hw, bias=bias, gate=gate,
                        residual=residual)


def _expert_gemm(x: torch.Tensor, w: torch.Tensor, ep: Epilogue,
                 out_dtype: torch.dtype, hw: HardwareSpec, *,
                 bias: Optional[torch.Tensor] = None,
                 gate: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 trans_a: bool = False, trans_b: bool = False
                 ) -> torch.Tensor:
    """epilogue(X[e] @ W[e]) for every expert e, on 3-D operands as stored
    (X[e] = x[e].t() with ``trans_a``, W[e] = w[e].t() with ``trans_b``),
    selected for the per-expert (M, N, K), behind the fail-soft launch."""
    M = x.shape[2] if trans_a else x.shape[1]
    K = x.shape[1] if trans_a else x.shape[2]
    N = w.shape[1] if trans_b else w.shape[2]
    x, w = x.contiguous(), w.contiguous()
    bias, gate, residual = (t.contiguous() if t is not None else None
                            for t in (bias, gate, residual))
    selected = select_gemm_config(M, N, K, in_dtype=_dtype_name(x.dtype),
                                  out_dtype=_model_dtype_name(out_dtype),
                                  epilogue=ep, hw=hw)
    kw = dict(out_dtype=out_dtype, epilogue=ep, bias=bias, gate=gate,
              residual=residual, trans_a=trans_a, trans_b=trans_b)
    return _launch_fail_soft(
        lambda cfg: kmm.tiled_expert_matmul(x, w, cfg, **kw),
        lambda: kmm.expert_matmul_plain(x, w, selected.config, **kw),
        selected.config, selected, hw, (M, N, K), x.device)


class _ExpertMatmul(torch.autograd.Function):
    """:func:`expert_matmul` under autograd, as :class:`_Matmul` expert by
    expert: saves x, w, bias and gate; the backward recomputes an
    activation's pre-activation z = X W (+ bias) in f32 with the grouped
    GEMM, takes dZ (and dgate, the per-expert dbias) from the grouped
    epilogue backward, then dX = dZ W^T with w read in place and dW = X^T dZ
    with x read in place, each one grouped launch for all experts."""

    @staticmethod
    def forward(ctx, x, w, bias, gate, residual, ep, out_dtype, hw):
        ctx.save_for_backward(x, w, bias, gate)
        ctx.ep, ctx.hw = ep, hw
        ctx.res_dtype = residual.dtype if residual is not None else None
        return _expert_gemm(x, w, ep, out_dtype, hw, bias=bias, gate=gate,
                            residual=residual)

    @staticmethod
    def backward(ctx, dout):
        x, w, bias, gate = ctx.saved_tensors
        ep, hw = ctx.ep, ctx.hw
        need_x, need_w, need_bias, need_gate, need_res = \
            ctx.needs_input_grad[:5]
        d = dout.contiguous()
        dz, dgate, dbias = d, None, None
        if ep.activation is not None:
            z = _expert_gemm(x, w, Epilogue(bias=ep.bias), torch.float32, hw,
                             bias=bias)
            dz, dgate, dbias = kmm.epilogue_bwd(
                d, z, epilogue=ep,
                gate=gate.contiguous() if gate is not None else None,
                dz_dtype=x.dtype, want_bias=ep.bias and need_bias)
        elif ep.bias and need_bias:
            _, _, dbias = kmm.epilogue_bwd(d, None, epilogue=ep,
                                           dz_dtype=x.dtype, want_bias=True)
        dz = dz.to(x.dtype)
        none = EPILOGUE_NONE
        dx = (_expert_gemm(dz, w, none, x.dtype, hw, trans_b=True)
              if need_x else None)
        dw = (_expert_gemm(x, dz, none, w.dtype, hw, trans_a=True)
              if need_w else None)
        return (dx, dw,
                dbias.to(bias.dtype) if dbias is not None else None,
                dgate if need_gate else None,
                dout.to(ctx.res_dtype) if need_res else None,
                None, None, None)


def _launch_fail_soft(launch: Callable[[TileConfig], torch.Tensor],
                      reference: Callable[[], torch.Tensor],
                      config: TileConfig, selected: Optional[Selection],
                      hw: HardwareSpec, shape: Tuple[int, int, int],
                      device: torch.device) -> torch.Tensor:
    """Run ``launch(config)`` behind the fault injector and the transient
    retry.  An explicit config (``selected`` None) is the caller's
    contract: no ladder, deterministic failures propagate.  A selected
    config is re-validated first and, on rejection or a failed launch, the
    fallback ladder is walked (DESIGN.md §9); past its last tiled rung a
    CPU launch serves ``reference()`` and a CUDA launch raises."""
    M, N, K = shape

    def _launch(cfg: TileConfig) -> torch.Tensor:
        if _launch_fault_injector is not None:
            _launch_fault_injector(cfg)
        return launch(cfg)

    def _on_retry(attempt: int, e: Exception) -> None:
        obs_metrics.inc("launch_retries")
        obs_trace.event("launch_retry", cat="fault", track="launch",
                        args={"attempt": attempt, "error": repr(e),
                              "shape": [M, N, K]})

    def _try(cfg: TileConfig) -> torch.Tensor:
        return retry(_launch, cfg, retries=_LAUNCH_RETRIES,
                     base_delay=_LAUNCH_BASE_DELAY,
                     max_delay=_LAUNCH_MAX_DELAY,
                     on_retry=_on_retry)

    if selected is None:
        # Explicit config: the caller's contract.  Transient-retry the
        # launch, but never silently substitute a different config —
        # deterministic failures propagate.
        return _try(config)

    # Selector-driven launch: re-validate before launching, then walk the
    # deterministic fallback ladder on any launch failure (DESIGN.md §9).
    p = selected.problem
    reason = _validate(p, config, hw)
    first_err: Optional[Exception] = None
    if reason is None:
        try:
            return _try(config)
        except Exception as e:                      # noqa: BLE001
            first_err = e
            reason = f"launch failed: {e!r}"
    obs_metrics.inc("launch_validation_failures")
    obs_trace.event("selection_rejected", cat="fault", track="launch",
                    args={"shape": [M, N, K], "reason": reason})
    obs_metrics.inc("selection_rejected")
    warnings.warn(
        f"selected config {config} rejected ({reason}); "
        f"walking fallback ladder", DegradedModeWarning, stacklevel=3)
    for sel_f, rung in fallback_ladder(p, hw, config):
        if _validate(p, sel_f.config, hw) is not None:
            continue
        obs_metrics.inc("fallback_rungs", labels={"rung": rung})
        obs_trace.event("fallback_rung", cat="fault", track="launch",
                        args={"shape": [M, N, K], "rung": rung})
        emit_fallback(sel_f, rung)
        try:
            return _try(sel_f.config)
        except Exception as e:                      # noqa: BLE001
            first_err = first_err or e
            continue
    if device.type != "cpu":
        raise RuntimeError(
            f"all tiled fallbacks failed for {p.M}x{p.N}x{p.K} on "
            f"{device}; the card never serves the plain version "
            f"(first error: {first_err!r})") from first_err
    # On the CPU every launch is the plain version already; serving it as
    # the final rung is semantically identical and cannot mis-tile.
    obs_metrics.inc("fallback_rungs", labels={"rung": "reference"})
    obs_trace.event("fallback_rung", cat="fault", track="launch",
                    args={"shape": [M, N, K], "rung": "reference"})
    emit_fallback(selected, "reference")
    warnings.warn(
        f"all tiled fallbacks failed for {p.M}x{p.N}x{p.K} "
        f"(first error: {first_err!r}); serving reference kernel",
        DegradedModeWarning, stacklevel=3)
    return reference()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    hw: Optional[HardwareSpec] = None,
    blocks: Optional[Tuple[int, int]] = None,
    window: int = 0,
) -> torch.Tensor:
    """Selector-driven attention. q: (B,H,Sq,d), k/v: (B,Hkv,Skv,d).
    ``window`` > 0 is a sliding window (key j visible to query i only if
    i - j < window); on the card the forward and, under autograd, the
    backward kernels take it in both dtypes.  On the CPU autograd runs the
    plain versions."""
    hw = hw if hw is not None else get_default_hardware()
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if blocks is None:
        blocks = kfa.select_attention_blocks(
            Sq, Skv, d, in_dtype=_dtype_name(q.dtype), hw=hw, causal=causal,
            batch=B, heads=H, kv_heads=Hkv, window=window)
    bq, bkv = blocks
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale, bq, bkv, window)
    return kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                      causal=causal, scale=scale,
                                      window=window)


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` under autograd: the forward kernel also
    writes the rows' log-sum-exp, saved with q, k, v and the output for
    the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bq, bkv, window):
        out, lse = kfa.flash_attention_kernel(
            q, k, v, block_q=bq, block_kv=bkv, causal=causal, scale=scale,
            return_lse=True, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = kfa.flash_attention_bwd_kernel(
            q, k, v, out, lse, dout, causal=ctx.causal, scale=ctx.scale,
            window=ctx.window)
        return dq, dk, dv, None, None, None, None, None
