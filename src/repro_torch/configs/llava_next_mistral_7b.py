"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone = Mistral-7B.  The anyres vision tower is a STUB: ``input_specs``
provides precomputed patch embeddings (base 576 + 4 tiles x 576 = 2880
positions) occupying the start of the sequence.
"""
from repro_torch.nn.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1000000.0,
    frontend="vision",
    frontend_tokens=2880,
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    frontend="vision",
    frontend_tokens=8,
    remat=False,
)
