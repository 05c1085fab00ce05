"""Model facade: config, device, params and the entry points (train loss,
prefill, decode) — the public API of the port's launchers and tests — and
the dry-run's stand-ins (``param_count``, ``cache_specs``, ``input_specs``,
``model_flops``: ``repro/nn/model.py:33-86``), tensors on the "meta"
device with the reference's shapes and dtypes."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import init_sharded, tp_shardings
from repro_torch.nn import frontends
from repro_torch.nn import layers as L
from repro_torch.nn import transformer as T
from repro_torch.nn.config import ModelConfig, ShapeSpec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the
    CPU, and a clear error when CUDA was asked for and is absent — nothing
    falls back to the CPU on its own.  "meta" (no storage) is the
    dry-run's device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; the port runs on the GPU "
            "by default — pass device='cpu' (--device cpu) to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
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
        """Random params (the def tree's init rules) from an explicit
        generator on the model's device; ``dtype`` defaults to the config's
        and does not touch a leaf whose def carries its own dtype."""
        return L.init_tree(self.defs(), generator,
                           dtype=dtype or _DTYPES[self.cfg.dtype],
                           device=self.device)

    def init_shards(self, generator: torch.Generator, mesh, rank: int,
                    dtype: Optional[torch.dtype] = None) -> Dict:
        """This rank's shards of :meth:`init`'s params under ``mesh``
        (``distributed/sharding.py``: ``tp_shardings`` and
        ``init_sharded``): the same stream, so each shard equals the
        matching slice of the single-process params bit for bit."""
        return init_sharded(self.defs(), generator, tp_shardings(self, mesh),
                            mesh, rank,
                            dtype=dtype or _DTYPES[self.cfg.dtype],
                            device=self.device)

    def param_axes(self) -> Dict:
        """The logical axis names of every param leaf (the reference's
        ``Model.param_axes``), read by ``distributed/sharding.py``."""
        return L.axes_tree(self.defs())

    def abstract_params(self) -> Dict:
        """The param tree as storage-free ("meta") tensors of the right
        shapes and dtypes: a template for restoring a checkpoint."""
        def build(defs):
            return {k: (build(d) if isinstance(d, dict) else torch.empty(
                        d.shape, dtype=d.dtype or _DTYPES[self.cfg.dtype],
                        device="meta"))
                    for k, d in defs.items()}
        return build(self.defs())

    def param_count(self) -> int:
        return self.cfg.param_count()

    # -- entrypoints --------------------------------------------------------
    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """The training loss (``T.lm_loss``) of a batch {"tokens": (B, S)
        int64 on the model's device}, plus the frontend's inputs
        (``frame_embed`` / ``patch_embed``) where the model has one."""
        return T.lm_loss(params, batch, self.cfg)

    def forward(self, params: Dict, tokens: torch.Tensor,
                extras: Optional[Dict] = None) -> torch.Tensor:
        """f32 logits (B, S, V) of a full causal pass."""
        return T.logits(T.forward_hidden(params, tokens, self.cfg, extras),
                        params, self.cfg)

    def prefill(self, params: Dict, tokens: torch.Tensor,
                last_pos: Optional[torch.Tensor] = None, *,
                extras: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
        return T.prefill_forward(params, tokens, self.cfg, extras=extras,
                                 last_pos=last_pos)

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        return T.decode_step(params, cache, tokens, pos, self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return T.init_cache(self.cfg, batch, max_len, device=self.device)

    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """The whole decode cache as meta tensors (the reference's
        ``init_cache_specs``; :meth:`init_cache` holds a rank's block)."""
        return T.init_cache_specs(self.cfg, batch, max_len)

    # -- dry-run inputs -----------------------------------------------------
    def input_specs(self, shape: ShapeSpec) -> Dict:
        """Meta stand-ins for every model input of this cell: int32 tokens
        (B, S), or (B,) and a position scalar for a decode step, plus the
        frontend's inputs."""
        B, S = shape.global_batch, shape.seq_len

        def meta(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return {"tokens": meta((B,), torch.int32),
                    "pos": meta((), torch.int32)}
        specs = {"tokens": meta((B, S), torch.int32)}
        specs.update({name: meta(s, dt) for name, (s, dt) in
                      frontends.frontend_input_specs(self.cfg, B,
                                                     S).items()})
        return specs

    def model_flops(self, shape: ShapeSpec) -> float:
        """MODEL_FLOPS for the roofline: 6·N·D per trained token (fwd+bwd),
        2·N·D per inference token; MoE counts active params only."""
        n = self.cfg.active_param_count()
        tokens = shape.global_batch * shape.seq_len
        if shape.kind == "train":
            return 6.0 * n * tokens
        if shape.kind == "prefill":
            return 2.0 * n * tokens
        return 2.0 * n * shape.global_batch       # decode: one token/seq


def params_from_jax(tree: Dict, cfg: ModelConfig, *, dtype: torch.dtype,
                    device: Union[str, torch.device]) -> Dict:
    """The port's params from the JAX package's param tree given as numpy
    arrays (layers stacked on axis 0, as ``repro/nn/transformer.py:59``).
    Every leaf of the port's def tree must be present with its shape; a
    leaf whose def carries a dtype (the f32 mamba A_log, D, dt_bias) keeps
    it, every other leaf takes ``dtype``."""
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
            if arr.shape != tuple(d.shape):
                raise ValueError(f"param {path}{name}: shape {arr.shape}, "
                                 f"expected {tuple(d.shape)}")
            out[name] = torch.from_numpy(np.array(arr, np.float32)).to(
                device=dev, dtype=d.dtype or dtype)
        return out

    return convert(T.model_defs(cfg), tree, "")
