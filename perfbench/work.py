"""The work a cell asks of the device, reckoned from the configuration's
shapes and the window's token counts, and the table of peaks.

A kernel's roofline time is max(flops / peak flop rate, bytes / peak HBM
rate), with each input byte read once and each output byte written once,
whatever the kernel reads again.  Only the work the computation needs is
counted: real prompt tokens and not pad rows, each causal (query, key) pair
once, an MoE layer's T·k routed rows, so a share reads the same work
whatever implements it.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

from perfbench.spec import BENCH_DIR, is_moe

ELEM = 2                                  # bytes of a bf16 element


def peaks(device_kind: str) -> Dict:
    """The peak rates of the device named ``device_kind``."""
    with open(BENCH_DIR / "peaks.json") as f:
        table = json.load(f)
    for key, row in table.items():
        if key in device_kind:
            return row
    raise KeyError(f"no peaks for {device_kind!r} in peaks.json")


def bound_s(flops: float, nbytes: float, pk: Dict) -> float:
    return max(flops / pk["bf16_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])


def gemm(m: int, n: int, k: int, *, epi_inputs: int = 0
         ) -> Tuple[float, float]:
    """(flops, bytes) of an (m, k) @ (k, n) product: A and B read, C
    written, plus ``epi_inputs`` (m, n) operands the epilogue reads."""
    return 2.0 * m * n * k, ELEM * (m * k + k * n + m * n * (1 + epi_inputs))


def grouped(rows: int, n: int, k: int, experts: int, *,
            epi_inputs: int = 0) -> Tuple[float, float]:
    """(flops, bytes) of ``rows`` routed rows through ``experts`` (k, n)
    weights: every expert's weight read once."""
    return (2.0 * rows * n * k,
            ELEM * (rows * k + experts * k * n + rows * n * (1 + epi_inputs)))


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attention_fwd(b: int, h: int, hkv: int, s: int, d: int
                  ) -> Tuple[float, float]:
    """Causal flash forward: QK^T and PV over the visible pairs; q, k, v
    read, o written."""
    return (4.0 * b * h * causal_pairs(s) * d,
            ELEM * (2 * b * h * s * d + 2 * b * hkv * s * d))


def _dims(run: Dict):
    return (int(run["hidden_size"]), int(run["num_attention_heads"]),
            int(run["num_key_value_heads"]), int(run["head_dim"]),
            int(run["intermediate_size"]), int(run["num_hidden_layers"]))


def attn_gemms(run: Dict, t: int, *, fused_residual: bool
               ) -> List[Tuple[float, float]]:
    """One layer's q, k, v and o projections at ``t`` tokens."""
    D, H, Hkv, hd, _, _ = _dims(run)
    return [gemm(t, H * hd, D), gemm(t, Hkv * hd, D), gemm(t, Hkv * hd, D),
            gemm(t, D, H * hd, epi_inputs=int(fused_residual))]


def ffn_gemms(run: Dict, t: int) -> List[Tuple[float, float]]:
    """One layer's feed-forward products at ``t`` tokens: the dense MLP's
    wu, wg (the gate read) and wd (the residual read), or the experts' three
    grouped products over t·k routed rows."""
    D, _, _, _, F, _ = _dims(run)
    if is_moe(run):
        E, k = int(run["num_local_experts"]), int(run["num_experts_per_tok"])
        return [grouped(t * k, F, D, E), grouped(t * k, F, D, E, epi_inputs=1),
                grouped(t * k, D, F, E)]
    return [gemm(t, F, D), gemm(t, F, D, epi_inputs=1),
            gemm(t, D, F, epi_inputs=1)]


def prefill_gemm_bound_s(run: Dict, t: int, pk: Dict) -> float:
    """Roofline seconds of one prefill's projections at ``t`` real
    tokens (the head's one row is not on the GEMM kernel)."""
    L = int(run["num_hidden_layers"])
    work = attn_gemms(run, t, fused_residual=True) + ffn_gemms(run, t)
    return L * sum(bound_s(f, b, pk) for f, b in work)


def prefill_flash_bound_s(run: Dict, t: int, pk: Dict) -> float:
    D, H, Hkv, hd, F, L = _dims(run)
    return L * bound_s(*attention_fwd(1, H, Hkv, t, hd), pk)


def decode_gemm_bound_s(run: Dict, active: int, pk: Dict) -> float:
    """Roofline seconds of one decode step's projections on the GEMM
    kernel at ``active`` rows: attention's four, and a dense model's MLP
    (an MoE decode step's experts are not on it)."""
    L = int(run["num_hidden_layers"])
    work = attn_gemms(run, active, fused_residual=False)
    if not is_moe(run):
        work += ffn_gemms(run, active)
    return L * sum(bound_s(f, b, pk) for f, b in work)


def param_count(run: Dict) -> int:
    from perfbench.weights import layout
    n = 0
    for _, shape, _ in layout(run):
        c = 1
        for s in shape:
            c *= s
        n += c
    return n


def active_layer_params(run: Dict) -> int:
    """A token's parameters in one layer: attention, the router and its
    k experts (the whole MLP for a dense layer)."""
    D, H, Hkv, hd, F, _ = _dims(run)
    attn = 2 * D * H * hd + 2 * D * Hkv * hd
    if is_moe(run):
        E, k = int(run["num_local_experts"]), int(run["num_experts_per_tok"])
        return attn + D * E + k * 3 * D * F
    return attn + 3 * D * F


def prefill_flops(run: Dict, t: int) -> float:
    """2 N_active T, the causal attention, and the head at the one row a
    prefill reads out."""
    D, H, Hkv, hd, F, L = _dims(run)
    V = int(run["vocab_size"])
    return (2.0 * L * active_layer_params(run) * t
            + 4.0 * L * H * causal_pairs(t) * hd + 2.0 * D * V)


def weight_bytes(run: Dict) -> int:
    """Every weight once, except the embedding table a step reads rows of."""
    n = param_count(run)
    if not run["tie_word_embeddings"]:
        n -= int(run["vocab_size"]) * int(run["hidden_size"])
    return ELEM * n


def decode_step_least_bytes(run: Dict, positions: Sequence[int]) -> int:
    """The least bytes of one decode step whose rows sit at
    ``positions``: every weight read once (at 16 rows and top-2 every
    expert is touched), each row's embedding read, and each row's keys and
    values 0..pos read and the new ones written."""
    D, H, Hkv, hd, F, L = _dims(run)
    kv = sum(2 * L * Hkv * hd * ELEM * (p + 2) for p in positions)
    return weight_bytes(run) + ELEM * D * len(positions) + kv
