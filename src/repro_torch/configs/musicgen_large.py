"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32 => MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf].  The EnCodec/conditioning frontend is a stub:
``input_specs`` provides precomputed frame embeddings (B, S, D) that are
added to the token embeddings.  MusicGen's backbone is a standard pre-LN
transformer (layernorm + gelu).
"""
from repro_torch.nn.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    norm="layernorm",
    activation="gelu",
    frontend="audio",
    frontend_tokens=0,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    norm="layernorm",
    activation="gelu",
    frontend="audio",
    frontend_tokens=0,
    remat=False,
)
