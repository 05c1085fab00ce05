"""zamba2-7b [hybrid] — 81L d_model=3584, shared attn 32H (GQA kv=32)
d_ff=14336, vocab=32000, ssm_state=64 — Mamba2 backbone + ONE shared
attention+MLP block applied every 6 layers (weights reused at every
application — the Zamba trick) [arXiv:2411.15242; unverified].

81 = 13 groups of 6 + a 3-layer tail (handled by the hybrid scan).
Sub-quadratic backbone => the long_500k cell runs for this arch; the shared
attention's KV cache is sharded over the "model" axis at long contexts.
"""
from repro_torch.nn.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    shared_attn_every=6,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke",
    family="hybrid",
    num_layers=5,                 # 2 groups of 2 + tail of 1
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=32,
    ssm_conv_width=4,
    ssm_chunk=16,
    shared_attn_every=2,
    remat=False,
)
