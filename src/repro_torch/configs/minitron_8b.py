"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000, pruned nemotron [arXiv:2407.14679; hf]."""
from repro_torch.nn.config import ModelConfig

FULL = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    remat=False,
)
