"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088; hf].

~141B total / ~39B active params.  8 experts do not divide the 16-way
"model" axis, so EP shards each expert's d_ff tensor-parallel instead
(sharding rule table, DESIGN.md §7); FSDP over "data" is mandatory to fit
HBM (282 GB of bf16 weights).
"""
from repro_torch.nn.config import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=16384,
    sliding_window=4096,
    rope_theta=1000000.0,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_experts=4,
    experts_per_token=2,
    moe_d_ff=64,
    sliding_window=32,
    remat=False,
)
