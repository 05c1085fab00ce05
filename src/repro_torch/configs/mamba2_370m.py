"""mamba2-370m [ssm] — 48L d_model=1024 (attn-free) vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].

Attention-free: the paper's GEMM selector applies to the SSD chunk GEMMs
(DESIGN.md §5); sub-quadratic, so the long_500k cell runs for this arch.
"""
from repro_torch.nn.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=32,
    ssm_conv_width=4,
    ssm_chunk=16,
    tie_embeddings=True,
    remat=False,
)
