"""Model configuration — one dataclass covers all ten assigned families."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # one of FAMILIES
    num_layers: int
    d_model: int
    vocab_size: int
    # Attention (0 heads => attention-free family).
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    rope_theta: float = 10000.0
    sliding_window: int = 0           # 0 => full causal attention
    # MoE.
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                 # per-expert hidden width
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD).
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # Hybrid (zamba2): one *shared* attention block applied every k layers.
    shared_attn_every: int = 0
    # Modality frontend stub: None | "audio" | "vision".
    frontend: Optional[str] = None
    frontend_tokens: int = 0          # patch/frame positions at seq start
    # Misc.
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    activation: str = "swiglu"        # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Distribution hints (read by the JAX package's sharding; not ported).
    fsdp: bool = False                # additionally shard params over "data"
    remat: bool = True
    # Sequence-shard the residual stream at scan-body boundaries (SP):
    # divides the remat stash by the "model" axis size at the cost of
    # gather/scatter collectives around attention (EXPERIMENTS.md §Perf).
    sp_stash: bool = False
    # Grouped-query decode attention (no KV repeat): divides decode KV HBM
    # traffic by H/Hkv (EXPERIMENTS.md §Perf).
    gqa_packed_decode: bool = False
    # Repeat KV projection *weights* to H heads at trace time (Megatron's
    # KV duplication for TP > Hkv): kills the per-layer all-gather of K/V
    # activations that GSPMD inserts when Hkv doesn't divide the "model"
    # axis, for ~8% extra projection flops (EXPERIMENTS.md §Perf).
    kv_repeat_weights: bool = False
    # Decode-time MoE: run every (local) expert on the tiny decode batch
    # instead of gathering selected experts' weights (EXPERIMENTS.md §Perf).
    moe_dense_decode: bool = False
    # Train/prefill MoE: sort/pack tokens within each data shard so the
    # dispatch-buffer scatter never crosses devices (EXPERIMENTS.md §Perf).
    moe_local_dispatch: bool = False

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.family not in ("ssm",):
            assert self.num_heads > 0 and self.head_dim > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameters (analytic; used for 6*N*D MODEL_FLOPS)."""
        D, L, V = self.d_model, self.num_layers, self.vocab_size
        n = V * D                                        # embed
        if not self.tie_embeddings:
            n += D * V                                   # lm head
        n += D                                           # final norm

        def attn_block() -> int:
            h = self.num_heads * self.head_dim
            kv = self.num_kv_heads * self.head_dim
            return D * h + 2 * D * kv + h * D + D        # qkv, o, norm

        def mlp_block(ff: int) -> int:
            mult = 3 if self.activation == "swiglu" else 2
            return mult * D * ff + D                     # (gate,)up,down, norm

        def ssm_block() -> int:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = D * (2 * di + 2 * ns + nh)         # x,z,B,C,dt
            conv = (di + 2 * ns) * self.ssm_conv_width
            out = di * D
            return in_proj + conv + out + 2 * nh + D     # + A,D params, norm

        if self.family == "ssm":
            n += L * ssm_block()
        elif self.family == "hybrid":
            n += L * ssm_block()
            n += attn_block() + mlp_block(self.d_ff)     # ONE shared block
        elif self.is_moe:
            per = attn_block() + D * self.num_experts    # router
            per += self.num_experts * (3 * D * self.moe_d_ff) + D
            n += L * per
        else:
            n += L * (attn_block() + mlp_block(self.d_ff))
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        all_experts = self.num_layers * self.num_experts * 3 * self.d_model \
            * self.moe_d_ff
        active = self.num_layers * self.experts_per_token * 3 * self.d_model \
            * self.moe_d_ff
        return full - all_experts + active


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: (kind, seq_len, global_batch)."""
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs — DESIGN.md §Arch-applicability."""
    if shape.name == "long_500k" and not cfg.has_ssm:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (skip by design)")
    return True, ""
