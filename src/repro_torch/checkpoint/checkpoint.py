"""Fault-tolerant checkpointing: atomic, integrity-hashed, in the JAX
package's on-disk format (the port of ``repro/checkpoint/checkpoint.py``).

* Atomic: state is written to ``<dir>/step_N.tmp`` and ``os.replace``d into
  place, so a crash mid-write never corrupts the latest checkpoint.
* Hashed: a manifest records sha256 per array; restore verifies.
* The reference's format: ``arrays.npz`` keyed by the tree path ("params/
  layers/attn/wq", "opt/m/embed", "opt/count", "step": a named tuple's
  field names, a dict's keys), bf16 stored as its raw uint16 bits with the
  true dtype in the manifest, the hash taken over the array's bytes.  So a
  checkpoint of either package restores into the other.  An int leaf (the
  step, the optimizer's count) is stored as an int32 scalar, as the
  reference keeps them.

* Elastic: a checkpoint holds whole leaves.  On a mesh, :func:`save`
  gathers each leaf whole from the ranks' shards and one rank writes, and
  :func:`restore` with ``shardings`` cuts this rank's block of each leaf,
  so a checkpoint written on one mesh (or by the JAX package, or by one
  process) restores on any other.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

_NAMES = {torch.float32: "float32", torch.float16: "float16",
          torch.int32: "int32", torch.int64: "int64"}


def _items(tree: Any, prefix: str = "", *, specs: bool = False
           ) -> List[Tuple[str, Any]]:
    """(path, leaf) of a tree of named tuples, dicts, lists and leaves;
    ``specs``: a tree of specs, whose plain tuples are leaves."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += _items(getattr(tree, name), f"{prefix}{name}/",
                          specs=specs)
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _items(tree[k], f"{prefix}{k}/", specs=specs)
        return out
    if isinstance(tree, (list, tuple)) and not specs:
        out = []
        for i, v in enumerate(tree):
            out += _items(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def _to_numpy(leaf: Union[torch.Tensor, int]) -> Tuple[np.ndarray, str]:
    """(the array npz stores, the true dtype's name)."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:  # npz cannot hold it: its raw bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _NAMES[t.dtype]


def _shas(arrays: Dict[str, np.ndarray]) -> Dict[str, str]:
    """{key: sha256} of every array, hashed on threads (hashlib releases
    the interpreter lock on large buffers)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return dict(zip(arrays, ex.map(_sha, arrays.values())))


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def save(ckpt_dir: str, step: int, tree: Any,
         extra_meta: Optional[Dict] = None, *, shardings: Any = None,
         mesh=None) -> str:
    """Write ``tree`` as step ``step``.  ``shardings`` (a tree like
    ``tree`` of specs, an int leaf's spec ignored): ``tree`` holds this
    rank's shards on ``mesh``; every rank of the mesh calls this, each leaf
    is gathered whole, and the rank whose global rank is 0 writes while the
    others wait for it.  Returns the checkpoint's path."""
    if shardings is not None:
        return _save_sharded(ckpt_dir, step, tree, extra_meta, shardings,
                             mesh)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for key, leaf in _items(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "hashes": _shas(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": dtypes,
        "meta": extra_meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _save_sharded(ckpt_dir, step, tree, extra_meta, shardings, mesh) -> str:
    """Gather each leaf whole on rank 0's host (each distinct block sent
    once), which writes; the other ranks wait for it."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import gather_leaf
    specs = dict(_items(shardings, specs=True))
    rank = dist.get_rank()
    whole = {key: leaf if isinstance(leaf, int)
             else gather_leaf(leaf, specs[key], mesh, rank)
             for key, leaf in _items(tree)}
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    if rank == 0:
        path = save(ckpt_dir, step, _rebuild(tree, whole), extra_meta)
    del whole
    dist.barrier()
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _rebuild(template: Any, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, n), leaves,
                                         f"{prefix}{n}/")
                                for n in template._fields))
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return leaves[prefix[:-1]]


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None, *,
            device: Union[str, torch.device] = "cpu", shardings: Any = None,
            mesh=None, rank: Optional[int] = None) -> Tuple[int, Any]:
    """Restore into the structure of ``template`` (tensors, which may be
    storage-free "meta" tensors, and ints) on ``device``: each tensor leaf
    takes its template's dtype, and its shape must match.

    ``shardings`` (a tree like ``template`` of specs) with ``mesh`` and
    ``rank``: the elastic restore; ``template`` holds whole leaves and
    each comes back as ``rank``'s block under its spec (the mesh need not
    be the writer's)."""
    from repro_torch.distributed.sharding import local_index
    specs = dict(_items(shardings, specs=True)) \
        if shardings is not None else {}
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        for key, leaf in _items(template):
            a = arrays[key]
            if manifest["hashes"].get(key) != _sha(a):
                raise IOError(f"checkpoint corruption detected at {key}")
            if isinstance(leaf, int):
                leaves[key] = int(a)
                continue
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {a.shape}, "
                                 f"template {tuple(leaf.shape)}")
            dtype = manifest["dtypes"].get(key, str(a.dtype))
            if key in specs:
                a = a[local_index(a.shape, specs[key], mesh, rank)]
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                 ).view(torch.bfloat16) \
                if dtype == "bfloat16" else torch.from_numpy(np.array(a))
            leaves[key] = t.to(device=device, dtype=leaf.dtype)
    return step, _rebuild(template, leaves)
