from repro_torch.optim.adamw import AdamW, OptState, global_norm
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamW", "OptState", "global_norm", "constant", "warmup_cosine"]
