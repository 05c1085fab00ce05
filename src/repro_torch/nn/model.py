"""Model facade: config, device, params and the serving entry points
(prefill, decode) — the public API of the port's launcher and tests."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.nn import layers as L
from repro_torch.nn import transformer as T
from repro_torch.nn.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the
    CPU, and a clear error when CUDA was asked for and is absent — nothing
    falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; the port runs on the GPU "
            "by default — pass device='cpu' (--device cpu) to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device = field(default="cuda")

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- parameters -------------------------------------------------------
    def defs(self) -> Dict:
        return T.model_defs(self.cfg)

    def init(self, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Random params (N(0, 0.02²), ones for norm scales) from an
        explicit generator on the model's device; ``dtype`` defaults to the
        config's."""
        return L.init_tree(self.defs(), generator,
                           dtype=dtype or _DTYPES[self.cfg.dtype],
                           device=self.device)

    # -- entrypoints --------------------------------------------------------
    def forward(self, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """f32 logits (B, S, V) of a full causal pass."""
        return T.logits(T.forward_hidden(params, tokens, self.cfg), params,
                        self.cfg)

    def prefill(self, params: Dict, tokens: torch.Tensor,
                last_pos: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
        return T.prefill_forward(params, tokens, self.cfg, last_pos=last_pos)

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        return T.decode_step(params, cache, tokens, pos, self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return T.init_cache(self.cfg, batch, max_len, device=self.device)


def params_from_jax(tree: Dict, cfg: ModelConfig, *, dtype: torch.dtype,
                    device: Union[str, torch.device]) -> Dict:
    """The port's params from the JAX package's param tree given as numpy
    arrays (layers stacked on axis 0, as ``repro/nn/transformer.py:59``).
    Every leaf of the port's def tree must be present with its shape."""
    dev = torch.device(device)

    def convert(defs, node, path):
        out = {}
        for name, d in defs.items():
            if name not in node:
                raise KeyError(f"param {path}{name} missing from the tree")
            if isinstance(d, dict):
                out[name] = convert(d, node[name], f"{path}{name}/")
                continue
            arr = np.asarray(node[name])
            if arr.shape != tuple(d[0]):
                raise ValueError(f"param {path}{name}: shape {arr.shape}, "
                                 f"expected {tuple(d[0])}")
            out[name] = torch.from_numpy(np.array(arr, np.float32)).to(
                device=dev, dtype=dtype)
        return out

    return convert(T.model_defs(cfg), tree, "")
