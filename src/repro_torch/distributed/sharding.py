"""Logical-axis -> mesh-axis sharding rules, and the local shards they give
(the port of ``repro/distributed/sharding.py``).

Every parameter declares logical axis names (``nn/layers.py::ParamDef``);
:func:`rules_for` and :func:`spec_for` are the reference's, copied with the
imports rewritten, and map them onto the mesh axes with the same two
safety rules (a mapping applies only where the dim divides by the mesh-axis
product; within one array each mesh axis is used once, left to right).  A
spec is a tuple with one entry a dim: None, a mesh-axis name, or a tuple of
names, as the reference's ``PartitionSpec``.

The reference hands the specs to GSPMD.  The port runs eagerly on explicit
local shards: :func:`shard_params` cuts a full param tree into one rank's
shards, :func:`init_sharded` draws only a rank's shards from the stream
``init_tree`` draws (so they equal the matching slices of the
single-process weights), and the layers read their local head counts,
widths, experts and vocabulary from the shards' shapes.  Two departures
follow from that, both layouts rather than results:

* :func:`tp_shardings` keeps a "heads" or "kv_heads" split only where it
  gives each rank whole heads.  ``spec_for`` splits the flattened width
  (H·hd), so for example 2 kv heads of 16 split four ways would give each
  rank half a head, which GSPMD reshards around and eager local attention
  cannot compute.  Where the kv split drops, each rank computes the kv
  heads its own q heads read (``nn/layers.py::kv_heads_read``).
* the decode cache is sharded by kv head and the SSM cache by SSM head
  (``nn/transformer.py::init_cache``); the reference shards k/v on the
  sequence and the SSM caches on their widest dividing dim
  (:func:`cache_shardings`, which only the dry-run and memory tools
  read, here as there).

Every axis of the mesh shards: "model" (heads, d_ff, experts, the
vocabulary) and "data" (FSDP: with ``cfg.fsdp`` the "embed" and
"expert_embed" dims; the batch's rows).  The model gathers a layer's FSDP
leaves at use (``nn/transformer.py``).  :func:`opt_shardings` and
:func:`batch_shardings` are the reference's spec trees, :func:`local_batch`
cuts a rank's rows, and :func:`gather_leaf` puts a leaf back together on
one rank (the checkpoint's save).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.meshctx import DATA_AXES
from repro_torch.nn import layers as L
from repro_torch.nn.config import ModelConfig

Spec = Tuple[Any, ...]


def rules_for(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "state": None,
        "embed": "data" if cfg.fsdp else None,
        "embed_novar": None,          # embed/lm_head d_model: never FSDP
        "expert_embed": "data" if cfg.fsdp else None,
        "expert_mlp": "model",
        "layers": None,
        "experts_in": None,
    }


def spec_for(shape: Sequence[int], axes: Optional[Sequence[Optional[str]]],
             rules: Dict[str, Any], mesh) -> Spec:
    axes = axes if axes is not None else [None] * len(shape)
    used: set = set()
    parts = []
    for dim, name in zip(shape, axes):
        target = rules.get(name) if name else None
        if target is None:
            parts.append(None)
            continue
        cand = target if isinstance(target, tuple) else (target,)
        sel = [a for a in cand if a in mesh.shape and a not in used]
        total = math.prod(mesh.shape[a] for a in sel)
        if sel and dim % total == 0:
            parts.append(tuple(sel) if len(sel) > 1 else sel[0])
            used.update(sel)
        else:
            parts.append(None)
    return tuple(parts)


def _map2(fn, a, b):
    return {k: (_map2(fn, v, b[k]) if isinstance(v, dict) else fn(v, b[k]))
            for k, v in a.items()}


def param_shardings(model, mesh) -> Dict:
    """The spec of every param leaf (``repro/distributed/sharding.py:
    83-92``): ``model`` has ``abstract_params()`` and ``param_axes()``."""
    rules = rules_for(model.cfg)
    return _map2(lambda a, ax: spec_for(tuple(a.shape), ax, rules, mesh),
                 model.abstract_params(), model.param_axes())


def _axis_product(part, mesh) -> int:
    return math.prod(mesh.shape[a] for a in
                     (part if isinstance(part, tuple) else (part,)))


def tp_shardings(model, mesh) -> Dict:
    """:func:`param_shardings` with a "heads" / "kv_heads" split kept only
    where each rank gets whole heads, and an "ssm_inner" / "ssm_heads"
    split only where each rank gets whole SSM heads (then rank r's d_inner
    block is exactly the channels of its heads): the layout the port's
    layers run."""
    cfg = model.cfg
    heads = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
             "ssm_inner": cfg.ssm_heads, "ssm_heads": cfg.ssm_heads}

    def align(spec, axes):
        return tuple(
            None if name in heads and part is not None
            and heads[name] % _axis_product(part, mesh) else part
            for part, name in zip(spec, axes or (None,) * len(spec)))

    return _map2(align, param_shardings(model, mesh), model.param_axes())


def opt_shardings(param_sh: Dict):
    """The AdamW state's specs: the moments mirror the params', the count
    is replicated (``repro/distributed/sharding.py:98-101``)."""
    from repro_torch.optim.adamw import OptState
    return OptState(m=param_sh, v=param_sh, count=())


def batch_shardings(specs: Dict, mesh) -> Dict[str, Spec]:
    """The spec of each batch leaf (anything with ``.shape``: tokens
    (B, S), frame_embed (B, S, D), patch_embed (B, P, D), decode tokens
    (B,), a position scalar): the rows over the mesh's ("pod", "data")
    axes where they divide, else replicated; a scalar replicated
    (``repro/distributed/sharding.py:104-118``)."""
    out = {}
    for name, s in specs.items():
        shape = tuple(s.shape)
        if not shape:
            out[name] = ()
            continue
        batch_axes = [a for a in DATA_AXES if a in mesh.shape]
        total = math.prod(mesh.shape[a] for a in batch_axes) or 1
        first = None
        if batch_axes and shape[0] % total == 0:
            first = (tuple(batch_axes) if len(batch_axes) > 1
                     else batch_axes[0])
        out[name] = (first,) + (None,) * (len(shape) - 1)
    return out


def local_batch(batch: Dict, mesh, rank: int) -> Dict:
    """``rank``'s block of each batch leaf under :func:`batch_shardings`
    (numpy arrays or tensors, sliced as they are).  Rows that do not divide
    over the data axes would be replicated, and every data rank would then
    train on the whole batch as if it were its own: refused."""
    specs = batch_shardings(batch, mesh)
    dp = math.prod(mesh.shape.get(a, 1) for a in DATA_AXES)
    out = {}
    for name, leaf in batch.items():
        spec = specs[name]
        if dp > 1 and spec and spec[0] is None:
            raise ValueError(f"batch leaf {name}: {tuple(leaf.shape)[0]} "
                             f"rows do not split over {dp} data ranks")
        out[name] = leaf[local_index(tuple(leaf.shape), spec, mesh, rank)]
    return out


def mesh_coords(mesh, rank: int) -> Dict[str, int]:
    """This rank's coordinate on each mesh axis (row-major over the axes in
    ``mesh.shape``'s order, as ``make_local_mesh`` lays them out)."""
    coords, r = {}, rank
    for a, n in reversed(list(mesh.shape.items())):
        r, coords[a] = divmod(r, n)
    return coords


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards on, in order."""
    out = []
    for part in spec:
        if part is not None:
            out += list(part if isinstance(part, tuple) else (part,))
    return tuple(out)


def gather_leaf(t: torch.Tensor, spec: Spec, mesh, rank: int,
                dst: int = 0) -> Optional[torch.Tensor]:
    """The whole leaf of which ``t`` is ``rank``'s block under ``spec``, on
    the host of rank ``dst`` (None on every other rank): each distinct
    block is sent once, by the rank holding it whose coordinate is 0 on
    every axis the leaf is not sharded on.  A collective: every rank of
    the mesh calls it with its block of the same leaf."""
    from repro_torch.distributed.collectives import recv_, send_
    axes = spec_axes(spec)
    shape = list(t.shape)
    for dim, part in enumerate(spec):
        for a in (part if isinstance(part, tuple) else
                  (part,) if part is not None else ()):
            shape[dim] *= mesh.shape[a]
    world = math.prod(mesh.shape.values())
    owners = [r for r in range(world)
              if all(c == 0 for a, c in mesh_coords(mesh, r).items()
                     if a not in axes)]
    if rank != dst:
        if rank in owners:
            send_(t, dst)
        return None
    whole = torch.empty(shape, dtype=t.dtype)
    for r in owners:
        block = t.cpu() if r == rank else recv_(t.shape, t.dtype, r)
        whole[local_index(shape, spec, mesh, r)] = block
    return whole


# The decode cache's sequence axes, for batches too small to split
# (``repro/distributed/sharding.py:31``).
SEQ_AXES = ("pod", "data", "model")


def cache_shardings(cache_specs: Dict, mesh, cfg: ModelConfig) -> Dict:
    """The reference's decode-cache layout as a spec tree (``repro/
    distributed/sharding.py:121-164``): the batch over ("pod", "data")
    where it divides; k/v (L, B, Hkv, S, d) with the sequence over the
    "model" axis and whatever batch axes are idle; each mamba cache
    (L, B, ...) with its widest dim that divides over "model".  Only the
    dry-run and memory tools read it: the engine keeps its own layout
    (k/v by kv head, the SSM cache by SSM head, ``nn/transformer.py::
    init_cache``).  ``cache_specs`` is a tree of anything with ``.shape``
    (``Model.cache_specs``); ``cfg`` is unused, as in the reference."""
    batch_axes = [a for a in DATA_AXES if a in mesh.shape]
    bt = math.prod(mesh.shape[a] for a in batch_axes) or 1

    def one(name: str, shape: Tuple[int, ...]) -> Spec:
        used: set = set()
        parts: list = [None] * len(shape)
        if batch_axes and shape[1] % bt == 0:
            parts[1] = tuple(batch_axes)
            used.update(batch_axes)
        if name.endswith("k") or name.endswith("v"):      # (L, B, Hkv, S, d)
            seq_axes = [a for a in SEQ_AXES
                        if a in mesh.shape and a not in used]
            st = math.prod(mesh.shape[a] for a in seq_axes) or 1
            if seq_axes and shape[3] % st == 0:
                parts[3] = tuple(seq_axes) if len(seq_axes) > 1 \
                    else seq_axes[0]
            return tuple(parts)
        if "model" in mesh.shape:
            m = mesh.shape["model"]
            for i in sorted(range(2, len(shape)), key=lambda i: -shape[i]):
                if shape[i] % m == 0:
                    parts[i] = "model"
                    break
        return tuple(parts)

    def walk(tree, path):
        return {k: (walk(v, f"{path}{k}/") if isinstance(v, dict)
                    else one(path + k, tuple(v.shape)))
                for k, v in tree.items()}

    return walk(cache_specs, "")


def local_index(shape: Sequence[int], spec: Spec, mesh, rank: int
                ) -> Tuple[slice, ...]:
    """The block of a ``shape`` leaf that ``rank`` holds under ``spec``."""
    coords = mesh_coords(mesh, rank)
    idx = []
    for n, part in zip(shape, spec):
        if part is None:
            idx.append(slice(0, n))
            continue
        names = part if isinstance(part, tuple) else (part,)
        k, c = 1, 0
        for a in names:                    # row-major over the part's axes
            k *= mesh.shape[a]
            c = c * mesh.shape[a] + coords[a]
        w = n // k
        idx.append(slice(c * w, (c + 1) * w))
    return tuple(idx)


def shard_params(tree: Dict, specs: Dict, mesh, rank: int) -> Dict:
    """``rank``'s shard of every leaf of a full param tree (contiguous
    copies: the full tree can be freed after)."""
    return _map2(lambda t, s: t[local_index(t.shape, s, mesh, rank)].clone(),
                 tree, specs)


def init_sharded(defs: Dict, generator: torch.Generator, specs: Dict, mesh,
                 rank: int, *, dtype: torch.dtype, device) -> Dict:
    """``rank``'s shards of ``L.init_tree(defs, generator, ...)``, drawn
    from the same stream: every leaf, every slice of axis 0, is drawn as
    ``init_tree`` draws it and only the local block is kept, so no rank
    holds more of a leaf than one draw slice and the shards equal
    ``shard_params`` of the single-process weights bit for bit."""
    def index(d, s):
        return local_index(d.shape, s, mesh, rank)

    return L.init_tree(defs, generator, dtype=dtype, device=device,
                       index=_map2(index, defs, specs))
