"""Weights from the seed, on the device, in a few large calls.

Every normal leaf is a view into one flat buffer in the served dtype,
filled with N(0, 1) by ``normal_`` from one generator in chunks of at most
2**30 elements and then scaled leaf by leaf; every norm scale is a view
into one buffer of ones. The scales stand for the trained weights a server
holds: the residual stream stays well conditioned, as trained weights keep
it: a projection into a layer reads 1/sqrt(fan_in), a projection back into
the residual stream 1/sqrt(fan_in * 2 L) (each layer a small step from the
identity), the embedding and the head 0.02. At the port's own init scale
(0.02 everywhere) a layer of mixtral-8x22b's width returns 1.6 times the
norm of its input, so a perturbation grows layer by layer, and a plain
bf16 computation's logits already lie 10-30 % from f32's. The same seed
gives the same values on the same device, so the reference makes its own
copy from the seed and reads nothing the program made.

The leaves are named and shaped as the port's param tree has them
(``repro_torch/nn/transformer.py::model_defs``): layers stacked on axis 0.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from perfbench.spec import is_moe

EMBED_STD = 0.02
_ALIGN = 128                  # elements: every leaf starts 256-byte aligned
_CHUNK = 1 << 30
_MASK63 = (1 << 63) - 1


def layout(run: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(path, shape, init) of every leaf, in draw order."""
    D, V = int(run["hidden_size"]), int(run["vocab_size"])
    L, F = int(run["num_hidden_layers"]), int(run["intermediate_size"])
    H, Hkv = int(run["num_attention_heads"]), int(run["num_key_value_heads"])
    hd = int(run["head_dim"])
    out = [("embed", (V, D), "normal"),
           ("layers/attn/norm/scale", (L, D), "ones"),
           ("layers/attn/wq", (L, D, H * hd), "normal"),
           ("layers/attn/wk", (L, D, Hkv * hd), "normal"),
           ("layers/attn/wv", (L, D, Hkv * hd), "normal"),
           ("layers/attn/wo", (L, H * hd, D), "normal")]
    if is_moe(run):
        E = int(run["num_local_experts"])
        out += [("layers/moe/norm/scale", (L, D), "ones"),
                ("layers/moe/router", (L, D, E), "normal"),
                ("layers/moe/wg", (L, E, D, F), "normal"),
                ("layers/moe/wu", (L, E, D, F), "normal"),
                ("layers/moe/wd", (L, E, F, D), "normal")]
    else:
        out += [("layers/mlp/norm/scale", (L, D), "ones"),
                ("layers/mlp/wg", (L, D, F), "normal"),
                ("layers/mlp/wu", (L, D, F), "normal"),
                ("layers/mlp/wd", (L, F, D), "normal")]
    out.append(("final_norm/scale", (D,), "ones"))
    if not run["tie_word_embeddings"]:
        out.append(("lm_head", (D, V), "normal"))
    return out


def std(run: Dict, path: str, shape) -> float:
    """The init scale of a normal leaf (module docstring)."""
    if path in ("embed", "lm_head"):
        return EMBED_STD
    fan_in = int(shape[-2])
    if path.endswith(("/wo", "/wd")):
        return (fan_in * 2 * int(run["num_hidden_layers"])) ** -0.5
    return fan_in ** -0.5


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def make(run: Dict, seed: int, device, dtype=None) -> Dict:
    """{path: tensor} of every leaf, drawn from ``seed`` on ``device``."""
    import torch
    dtype = dtype or getattr(torch, run["torch_dtype"])
    leaves = layout(run)
    offs, total = {}, {"normal": 0, "ones": 0}
    for path, shape, init in leaves:
        offs[path] = total[init]
        n = _numel(shape)
        total[init] += n + (-n) % _ALIGN
    bufs = {"normal": torch.empty(total["normal"], dtype=dtype,
                                  device=device),
            "ones": torch.ones(total["ones"], dtype=dtype, device=device)}
    g = torch.Generator(device=device)
    g.manual_seed(seed & _MASK63)
    flat = bufs["normal"]
    for i in range(0, flat.numel(), _CHUNK):
        flat[i:i + _CHUNK].normal_(0.0, 1.0, generator=g)
    out = {path: bufs[init][offs[path]:offs[path] + _numel(shape)]
           .view(shape) for path, shape, init in leaves}
    for path, shape, init in leaves:
        if init == "normal":
            out[path].mul_(std(run, path, shape))
    return out


def nest(flat: Dict) -> Dict:
    """The nested param tree of {path: tensor}."""
    out: Dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def check_layout(flat: Dict, defs: Dict) -> None:
    """Raise unless ``flat`` has exactly the leaves and shapes of the
    port's def tree ``defs``."""
    seen = set()

    def walk(node, pre):
        for k, d in node.items():
            if isinstance(d, dict):
                walk(d, f"{pre}{k}/")
                continue
            path = pre + k
            seen.add(path)
            if path not in flat or tuple(flat[path].shape) != tuple(d.shape):
                got = tuple(flat[path].shape) if path in flat else None
                raise ValueError(f"leaf {path}: the harness makes {got}, "
                                 f"the port defines {tuple(d.shape)}")
    walk(defs, "")
    extra = set(flat) - seen
    if extra:
        raise ValueError(f"leaves the port does not define: {sorted(extra)}")
