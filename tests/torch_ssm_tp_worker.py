"""Rank functions for ``tests/test_torch_ssm_tp.py``: run by
``repro_torch.launch.mesh.spawn_ranks`` in spawned processes, gloo on the
CPU.  This module imports no JAX; the test file computes the JAX
package's side and compares.

:func:`run_cases` joins the group and runs phases, each on the
(world // tp, tp) mesh of its ``tp`` over the same ranks; every rank
returns its own results:

* ``("grads", name, cfg, tree, batch, mutate)``: ``torch_dp_worker``'s
  loss, gradients (gathered whole on rank 0) and sharded norm of the f32
  params ``tree`` on this rank's rows of ``batch``.  ``mutate`` breaks
  one of the SSM block's model-axis sums for the test that shows the
  comparison sees it: "whole" drops the "copy" of in_b, in_c and the
  B / C convs (their gradients stay each rank's partial), "norm" drops
  the backward sum of the gated RMSNorm's sum of squares;
* ``("serve", name, cfg, tree, inputs)``: this rank's rows of the
  tokens: prefill logits, then decode steps from an f32 cache holding
  the prefill's (k/v at the first S positions), the logits of each;
* ``("engine", name, cfg, tree, requests, gen, max_len)``: the serving
  engine's greedy tokens (``torch_tp_worker``).
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch

from repro_torch import meshctx
from repro_torch.distributed.collectives import all_reduce_f32
from repro_torch.distributed.sharding import local_batch
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.nn import mamba2
from repro_torch.optim.adamw import tree_items

import torch_dp_worker
import torch_tp_worker


def _norm_without_backward_sum(y, z, w, d_inner, group=None, eps=1e-6):
    """``mamba2.gated_rmsnorm`` whose sum of squares is summed forward
    only: each rank's gradient of it stays its own channels' share."""
    g = y * torch.nn.functional.silu(z)
    if group is None:
        return mamba2.rmsnorm(g, w, eps)
    x32 = g.float()
    ss = x32.square().sum(dim=-1, keepdim=True)
    var = all_reduce_f32(ss, group) / d_inner
    return (x32 * torch.rsqrt(var + eps)).to(g.dtype) * w


def _grads(rank, mesh, cfg, tree, batch, mutate):
    patch = {"whole": lambda: mock.patch.object(mamba2, "_WHOLE", ()),
             "norm": lambda: mock.patch.object(mamba2, "gated_rmsnorm",
                                               _norm_without_backward_sum),
             None: contextlib.nullcontext}
    with patch[mutate]():
        return torch_dp_worker._grads(rank, mesh, cfg, tree, batch)


def _serve(rank, mesh, cfg, tree, inputs):
    model, params = torch_tp_worker._shards(cfg, tree, mesh, rank)
    toks = local_batch({"tokens": torch.from_numpy(inputs["tokens"])},
                       mesh, rank)["tokens"].long()
    out = {}
    with torch.inference_mode():
        logits, pc = model.prefill(params, toks)
        out["prefill"] = logits.numpy()
        B, S = toks.shape
        cache = model.init_cache(B, S + len(inputs["steps"]))
        for path, leaf in tree_items(pc):
            node = cache
            for k in path.split("/")[:-1]:
                node = node[k]
            dst = node[path.split("/")[-1]]
            dst[tuple(slice(0, n) for n in leaf.shape)] = leaf
        out["cache_shapes"] = {p: tuple(t.shape)
                               for p, t in tree_items(cache)}
        pos, steps = torch.tensor(S), []
        for new in inputs["steps"]:
            rows = local_batch({"t": torch.from_numpy(new)}, mesh,
                               rank)["t"].long()
            lg, cache = model.decode_step(params, cache, rows, pos)
            steps.append(lg.numpy())
            pos = pos + 1
    out["decode"] = np.stack(steps)
    return out


def run_cases(rank: int, world: int, init_method: str, phases) -> dict:
    """``phases``: [(tp, cases)]; returns {"meshes": each phase's (shape,
    this rank's (data, model) coordinates), "<case>/<key>": results}."""
    torch.set_num_threads(1)        # the ranks share the host's cores
    init_distributed(rank, world, init_method, device="cpu")
    out = {"meshes": []}
    for tp, cases in phases:
        mesh = make_local_mesh(tp, device_type="cpu")
        meshctx.set_mesh(mesh)
        out["meshes"].append((dict(mesh.shape),
                              (mesh.coord("data"), mesh.coord("model"))))
        try:
            for case in cases:
                kind, name = case[0], case[1]
                if kind == "grads":
                    got = _grads(rank, mesh, *case[2:])
                elif kind == "serve":
                    got = _serve(rank, mesh, *case[2:])
                else:
                    with torch.inference_mode():
                        got = torch_tp_worker._engine(rank, mesh, *case[2:])
                out.update({f"{name}/{k}": v for k, v in got.items()})
        finally:
            meshctx.set_mesh(None)
    return out
