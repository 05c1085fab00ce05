"""Rank functions for ``tests/test_torch_dp.py``: run by
``repro_torch.launch.mesh.spawn_ranks`` in spawned processes, gloo on the
CPU.  This module imports no JAX; the test file computes the JAX
package's side and compares.

:func:`run_cases` joins the group and runs phases: each installs the
(world // tp, tp) mesh of its ``tp`` over the same ranks and runs its
cases; rank 0 returns what the cases gather (whole leaves, global
outputs), every rank its own results where a case asks for them:

* ``("grads", name, cfg, tree, batch)``: the f32 params ``tree`` (numpy,
  the whole model) cut into this rank's shards (``tp_shardings``), the
  global ``batch`` cut into its rows; one ``loss_and_grads`` of the train
  step, the gradients gathered whole, and the sharded ``global_norm``;
* ``("train", name, cfg, tree, batches)``: a step of AdamW under
  ``warmup_cosine(1e-3, 2, len(batches))`` for each batch, each step's
  loss and the final params gathered whole;
* ``("moe", name, cfg, layer, x)``: one MoE layer's params (numpy, whole)
  and its (B, S, D) input: ``moe_forward`` on this rank's rows, the
  outputs gathered over data, the aux loss, and the global plan's kept
  copies (the flat dispatch's);
* ``("psum", name, grads, errs)``: ``compressed_psum`` of ``grads[rank]``
  with ``errs[rank]`` over every rank, each rank's mean and new error;
* ``("save", name, cfg, seed, ckpt_dir)``: :func:`whole_state` cut to
  this rank's shards (``elastic_reshard``) and saved with the shardings;
* ``("restore", name, cfg, ckpt_dir)``: the elastic restore of this
  rank's shards, gathered whole again (numpy, bf16 as raw uint16).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import meshctx
from repro_torch import checkpoint as ckpt
from repro_torch.distributed.collectives import all_gather_dim
from repro_torch.distributed.sharding import (gather_leaf, local_batch,
                                              opt_shardings, shard_params,
                                              tp_shardings)
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.nn import moe
from repro_torch.nn.model import Model
from repro_torch.optim import AdamW, compressed_psum, global_norm
from repro_torch.optim.adamw import OptState, tree_items, tree_map
from repro_torch.runtime import elastic_reshard


def _tensors(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bf16 as its raw uint16 bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _whole(tree, specs, mesh):
    """{path: numpy} of every leaf gathered whole on rank 0 (a
    collective; None on the other ranks)."""
    import torch.distributed as dist
    flat, rank = dict(tree_items(specs)), dist.get_rank()
    out = {p: gather_leaf(t.detach(), flat[p], mesh, rank)
           for p, t in tree_items(tree)}
    return {p: None if w is None else bits(w) for p, w in out.items()}


STATE_STEP, STATE_COUNT = 7, 3


def whole_state(cfg, seed: int) -> TrainState:
    """A whole bf16 TrainState drawn from ``seed``: the params from
    ``Model.init``, the moments N(0, 1) from the same generator."""
    gen = torch.Generator().manual_seed(seed)
    params = Model(cfg, device="cpu").init(gen)
    moment = lambda p: torch.randn(p.shape, generator=gen)  # noqa: E731
    return TrainState(params=params,
                      opt=OptState(m=tree_map(moment, params),
                                   v=tree_map(moment, params),
                                   count=STATE_COUNT),
                      step=STATE_STEP)


def _setup(cfg, tree, mesh, rank):
    model = Model(cfg, device="cpu")
    specs = tp_shardings(model, mesh)
    return model, specs, shard_params(_tensors(tree), specs, mesh, rank)


def _grads(rank, mesh, cfg, tree, batch):
    model, specs, params = _setup(cfg, tree, mesh, rank)
    step = make_train_step(model, AdamW())
    loss, grads = step.loss_and_grads(params, local_batch(batch, mesh, rank))
    norm = global_norm(grads, specs)
    return {"loss": float(loss), "norm": float(norm),
            "grads": _whole(grads, specs, mesh)}


def _train(rank, mesh, cfg, tree, batches):
    from repro_torch.optim import warmup_cosine
    model, specs, params = _setup(cfg, tree, mesh, rank)
    opt = AdamW(lr=warmup_cosine(1e-3, 2, len(batches)))
    state = TrainState(params=params, opt=opt.init(params), step=0)
    step = make_train_step(model, opt)
    losses = []
    for b in batches:
        state, met = step(state, local_batch(b, mesh, rank))
        losses.append(float(met["loss"]))
    return {"losses": losses, "params": _whole(state.params, specs, mesh),
            "count": state.opt.count}


def _moe(rank, mesh, cfg, layer, x):
    p = tree_map(lambda a: torch.from_numpy(np.array(a)), layer)
    model = Model(cfg, device="cpu")
    specs = tp_shardings(model, mesh)["layers"]["moe"]
    # the layer's specs are the stacked leaf's without the "layers" dim
    specs = {k: (v[1:] if not isinstance(v, dict) else
                 {kk: vv[1:] for kk, vv in v.items()})
             for k, v in specs.items()}
    p = shard_params(p, specs, mesh, rank)
    from repro_torch.nn.transformer import _fsdp_gather
    p = _fsdp_gather(p, moe.moe_defs(cfg), cfg)
    plans = []
    real = moe.dispatch_plan

    def spy(ids, E, C):
        out = real(ids, E, C)
        plans.append(out[1].numpy())
        return out
    moe.dispatch_plan = spy
    try:
        xl = local_batch({"x": torch.from_numpy(x)}, mesh, rank)["x"]
        with torch.no_grad():
            y, aux = moe.moe_forward(p, xl, cfg)
    finally:
        moe.dispatch_plan = real
    dax = meshctx.data_axis()
    if dax is not None:
        y = all_gather_dim(y, 0, dax.group)
    return {"y": y.numpy(), "aux": float(aux), "keep": plans}


def _psum(rank, world, grads, errs):
    import torch.distributed as dist
    mean, err = compressed_psum(torch.from_numpy(grads[rank]),
                                torch.from_numpy(errs[rank]),
                                dist.group.WORLD)
    return {f"mean_{rank}": mean.numpy(), f"err_{rank}": err.numpy()}


def _state_specs(model):
    mesh = meshctx.get_mesh()
    specs = tp_shardings(model, mesh)
    return TrainState(params=specs, opt=opt_shardings(specs), step=())


def _save(rank, mesh, cfg, seed, ckpt_dir):
    sh = _state_specs(Model(cfg, device="cpu"))
    local = elastic_reshard(whole_state(cfg, seed), sh, mesh, rank)
    ckpt.save(ckpt_dir, STATE_STEP, local, extra_meta={"arch": cfg.name},
              shardings=sh, mesh=mesh)
    return {"local_shape": tuple(local.params["layers"]["attn"]["wq"].shape)}


def _restore(rank, mesh, cfg, ckpt_dir):
    model = Model(cfg, device="cpu")
    params = model.abstract_params()
    template = TrainState(params=params, opt=AdamW().init(params), step=0)
    sh = _state_specs(model)
    step, state = ckpt.restore(ckpt_dir, template, shardings=sh, mesh=mesh,
                               rank=rank)
    out = {}
    for part, tree, specs in (("params", state.params, sh.params),
                              ("opt/m", state.opt.m, sh.opt.m),
                              ("opt/v", state.opt.v, sh.opt.v)):
        for path, a in _whole(tree, specs, mesh).items():
            out[f"{part}/{path}"] = a
    out["step"], out["count"] = step, state.opt.count
    out["local_shape"] = tuple(state.params["layers"]["attn"]["wq"].shape)
    return out


def _run(rank, world, mesh, cases, out):
    for case in cases:
        kind, name = case[0], case[1]
        if kind == "grads":
            got = _grads(rank, mesh, *case[2:])
        elif kind == "train":
            got = _train(rank, mesh, *case[2:])
        elif kind == "moe":
            got = _moe(rank, mesh, *case[2:])
        elif kind == "psum":
            got = _psum(rank, world, *case[2:])
        elif kind == "save":
            got = _save(rank, mesh, *case[2:])
        else:
            got = _restore(rank, mesh, *case[2:])
        if rank == 0 or kind == "psum":
            out.update({f"{name}/{k}": v for k, v in got.items()})


def run_cases(rank: int, world: int, init_method: str, phases) -> dict:
    """``phases``: [(tp, cases)], each run on its own (world // tp, tp)
    mesh; returns {"meshes": each phase's (shape, this rank's (data,
    model) coordinates), "<case>/<key>": results}."""
    torch.set_num_threads(1)        # the ranks share the host's cores
    init_distributed(rank, world, init_method, device="cpu")
    out = {"meshes": []}
    for tp, cases in phases:
        mesh = make_local_mesh(tp, device_type="cpu")
        meshctx.set_mesh(mesh)
        out["meshes"].append((dict(mesh.shape),
                              (mesh.coord("data"), mesh.coord("model"))))
        try:
            _run(rank, world, mesh, cases, out)
        finally:
            meshctx.set_mesh(None)
    return out
