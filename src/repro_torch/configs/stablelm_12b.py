"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai/stablelm-2-12b; hf].  head_dim = 5120/32 = 160
(non-128-aligned minor dim; the selector's alignment filter handles it)."""
from repro_torch.nn.config import ModelConfig

FULL = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="stablelm-12b-smoke",
    family="dense",
    num_layers=2,
    d_model=80,
    num_heads=4,
    num_kv_heads=2,
    head_dim=20,
    d_ff=192,
    vocab_size=512,
    remat=False,
)
