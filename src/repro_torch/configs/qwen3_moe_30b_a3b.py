"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) per-expert
d_ff=768 vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

head_dim=128 (Qwen3 uses wide heads: H*hd = 4096 != d_model).  128 experts
shard cleanly over the 16-way "model" axis (8 experts/chip — true EP).
"""
from repro_torch.nn.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    rope_theta=1000000.0,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32,
    remat=False,
)
