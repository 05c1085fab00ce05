"""Public kernel ops: selector-driven GEMM and attention on PyTorch tensors.

The device of the operands decides the route.  On a CUDA tensor each op
launches its hand-written Hopper kernel (``kernels/matmul.py``,
``kernels/flash_attention.py``); on a CPU tensor the same selection, launch
validation, fault injection and fallback ladder run, and the launch
computes with the kernel's plain version.  There is no backend switch.

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
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.dtypes import DTYPE_BYTES
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import Epilogue, GemmProblem, TileConfig
from repro_torch.core.selector import (Selection, emit_fallback,
                                       fallback_ladder, select_gemm_config,
                                       validate_selection)
from repro_torch.core.topology import (DegradedModeWarning, HardwareSpec,
                                       topology_fingerprint)
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ref
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
    ``schedule="stream_k"`` or ``split_k > 1``; the Hopper kernel lowers
    both to an in-CTA loop over the whole of K (``kernels/matmul.py``),
    which is numerically the same product.
    """
    hw = hw if hw is not None else get_default_hardware()
    out_dtype = out_dtype or a.dtype
    ep = _normalize_epilogue(epilogue, bias, gate, residual)
    lead = tuple(a.shape[:-2]) if a.dim() > 2 else ()
    M = 1
    for s in (*lead, a.shape[-2]):
        M *= s
    K, N = b.shape
    a2 = a.reshape(M, K).contiguous()
    gate2 = gate.reshape(M, N).contiguous() if gate is not None else None
    res2 = residual.reshape(M, N).contiguous() if residual is not None \
        else None
    b = b.contiguous()
    bias = bias.contiguous() if bias is not None else None

    def _shape(out: torch.Tensor) -> torch.Tensor:
        return out.reshape(*lead, a.shape[-2], N) if lead else out

    selected: Optional[Selection] = None
    if config is None:
        selected = select_gemm_config(M, N, K,
                                      in_dtype=_dtype_name(a.dtype),
                                      out_dtype=_model_dtype_name(out_dtype),
                                      epilogue=ep,
                                      hw=hw)
        config = selected.config

    def _launch(cfg: TileConfig) -> torch.Tensor:
        if _launch_fault_injector is not None:
            _launch_fault_injector(cfg)
        return _shape(kmm.tiled_matmul(a2, b, cfg, out_dtype=out_dtype,
                                       epilogue=ep, bias=bias, gate=gate2,
                                       residual=res2))

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
        f"walking fallback ladder", DegradedModeWarning, stacklevel=2)
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
    if a.device.type != "cpu":
        raise RuntimeError(
            f"all tiled fallbacks failed for {p.M}x{p.N}x{p.K} on "
            f"{a.device}; the card never serves the plain version "
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
        DegradedModeWarning, stacklevel=2)
    return _shape(ref.matmul_ref(a2, b, out_dtype, epilogue=ep, bias=bias,
                                 gate=gate2, residual=res2))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    hw: Optional[HardwareSpec] = None,
    blocks: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Selector-driven attention. q: (B,H,Sq,d), k/v: (B,Hkv,Skv,d)."""
    hw = hw if hw is not None else get_default_hardware()
    _, _, Sq, d = q.shape
    Skv = k.shape[2]
    if blocks is None:
        blocks = kfa.select_attention_blocks(
            Sq, Skv, d, in_dtype=_dtype_name(q.dtype), hw=hw, causal=causal)
    bq, bkv = blocks
    return kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                      causal=causal, scale=scale)
