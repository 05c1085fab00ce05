from repro_torch.optim.adamw import AdamW, OptState, global_norm
from repro_torch.optim.compression import (
    compress_with_feedback,
    compressed_psum,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamW", "OptState", "global_norm", "compress_with_feedback",
           "compressed_psum", "dequantize_int8", "quantize_int8",
           "constant", "warmup_cosine"]
