"""Rank functions for ``tests/test_torch_distributed.py``: run by
``repro_torch.launch.mesh.spawn_ranks`` in spawned processes, gloo on the
CPU.  This module imports no JAX (each rank imports it afresh); the test
file computes the JAX package's side and compares.

:func:`run_cases` joins the group, installs the (1, world) mesh and runs
every case it is given, returning one dict of numpy arrays a rank:

* ``("matmul", name, x, w, residual)``: ``tp_matmul`` column-parallel on
  this rank's columns of w, and row-parallel on its rows of w and columns
  of x, the residual added once;
* ``("model", name, cfg, tree, inputs)``: the f32 params ``tree`` (numpy,
  the whole model) cut into this rank's shards (``tp_shardings``), then a
  full pass and a ragged prefill with its cache (both with the inputs'
  frontend ``extras``), and decode steps after it at per-slot positions,
  each rank's f32 logits;
* ``("engine", name, cfg, tree, requests)``: the serving engine's greedy
  tokens at exact lengths, the params and the decode cache in f32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import meshctx
from repro_torch.distributed.collectives import tp_matmul
from repro_torch.distributed.sharding import shard_params, tp_shardings
from repro_torch.launch.engine import ServingEngine
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.nn import layers as L
from repro_torch.nn.model import Model


def _tree_float(tree):
    return {k: (_tree_float(v) if isinstance(v, dict) else v.float())
            for k, v in tree.items()}


class F32CacheModel(Model):
    """An f32 decode cache (the JAX side gets one too: its own cache is
    bf16 whatever the params)."""

    def init_cache(self, batch, max_len):
        return _tree_float(super().init_cache(batch, max_len))


def _shards(cfg, tree, mesh, rank):
    def conv(node):
        return {k: (conv(v) if isinstance(v, dict)
                    else torch.from_numpy(np.array(v)))
                for k, v in node.items()}
    full = conv(tree)
    model = F32CacheModel(cfg, device="cpu")
    return model, shard_params(full, tp_shardings(model, mesh), mesh, rank)


def _matmul(rank, world, mesh, x, w, residual):
    n = w.shape[1] // world
    k = w.shape[0] // world
    col = tp_matmul(torch.from_numpy(x),
                    torch.from_numpy(w[:, rank * n:(rank + 1) * n].copy()),
                    mesh.group("model"))
    row = tp_matmul(torch.from_numpy(x[:, rank * k:(rank + 1) * k].copy()),
                    torch.from_numpy(w[rank * k:(rank + 1) * k].copy()),
                    mesh.group("model"), reduce_k=True,
                    residual=torch.from_numpy(residual))
    return {"col": col.numpy(), "row": row.numpy()}


def _model(rank, mesh, cfg, tree, inputs):
    model, params = _shards(cfg, tree, mesh, rank)
    toks = torch.from_numpy(inputs["tokens"]).long()
    last = torch.from_numpy(inputs["last"]).long()
    extras = {k: torch.from_numpy(v) for k, v in inputs["extras"].items()}
    out = {"forward": model.forward(params, toks, extras).numpy()}
    logits, cache = model.prefill(params, toks, last, extras=extras)
    out["prefill"] = logits.numpy()
    out["cache_k"] = cache["k"].numpy()
    out["local_kv_heads"] = np.int64(L.local_kv_heads(cfg))
    # Decode from an f32 cache holding the prefill's k/v, at per-slot
    # positions (each row after its own last real token).
    B, S = toks.shape
    full = model.init_cache(B, S + len(inputs["steps"]))
    for name in ("k", "v"):
        full[name][:, :, :, :S] = cache[name]
    pos = last + 1
    steps = []
    for new in inputs["steps"]:
        lg, full = model.decode_step(params, full,
                                     torch.from_numpy(new).long(), pos)
        steps.append(lg.numpy())
        pos = pos + 1
    out["decode"] = np.stack(steps)
    return out


def _engine(rank, mesh, cfg, tree, requests, gen, max_len):
    model, params = _shards(cfg, tree, mesh, rank)
    eng = ServingEngine(model, params, max_batch=2, max_len=max_len,
                        temperature=0.0, seed=0, sync_every=4, quiet=True)
    for prompt in requests:
        eng.submit(prompt, max_new_tokens=gen)
    stats = eng.run()
    res = stats["results"]
    return {f"tokens_{r}": res[r].tokens for r in sorted(res)}


def run_cases(rank: int, world: int, init_method: str, cases) -> dict:
    torch.set_num_threads(1)        # the ranks share the host's cores
    init_distributed(rank, world, init_method, device="cpu")
    mesh = make_local_mesh(world, device_type="cpu")
    meshctx.set_mesh(mesh)
    out = {"coord": mesh.coord("model"), "shape": dict(mesh.shape)}
    try:
        with torch.inference_mode():
            for case in cases:
                kind, name = case[0], case[1]
                if kind == "matmul":
                    got = _matmul(rank, world, mesh, *case[2:])
                elif kind == "model":
                    got = _model(rank, mesh, *case[2:])
                else:
                    got = _engine(rank, mesh, *case[2:])
                out.update({f"{name}/{k}": v for k, v in got.items()})
    finally:
        meshctx.set_mesh(None)
    return out
