"""The Llama-3 key-GEMM shape table (paper Fig. 6 sweep).

The projection GEMMs of Llama-3 8B and 70B (qkv, attn-out, gate/up, down,
vocab head) at common token counts — the real inference/training shapes
the paper highlights.  Lives in the library (not ``benchmarks/``) because
the calibration oracle (``repro_torch.calib.oracle``) sweeps these shapes too;
``benchmarks/llama3_shapes.py`` re-exports for its Fig. 6 harness.
"""
from __future__ import annotations

from typing import List, Tuple

# (d_model, kv_dim, d_ff, vocab)
LLAMA3 = {
    "8b": (4096, 1024, 14336, 128256),
    "70b": (8192, 1024, 28672, 128256),
}
TOKENS = (1024, 4096, 8192)


def llama3_gemms(size: str, tokens=TOKENS) -> List[Tuple[str, int, int, int]]:
    d, kv, ff, v = LLAMA3[size]
    out = []
    for t in tokens:
        out += [
            (f"{size}/qkv/t{t}", t, d + 2 * kv, d),
            (f"{size}/attn_out/t{t}", t, d, d),
            (f"{size}/gate_up/t{t}", t, 2 * ff, d),
            (f"{size}/down/t{t}", t, d, ff),
            (f"{size}/lm_head/t{t}", t, v, d),
        ]
    return out
