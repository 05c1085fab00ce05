"""Data-parallel, FSDP and tensor-parallel training in the port (the data
axis of ``meshctx`` / ``distributed/sharding.py``, the autograd
collectives, the MoE dispatch over data shards, ``optim/compression.py``,
the elastic checkpoint, ``train --tp``) against the JAX package.

The reference's own sharded path cannot serve as the yardstick (its
8-fake-device suite fails under this jax, ROADMAP's last caveat), and
sharding does not change the math.  So the port's sharded training is held
to the reference's ONE-PROCESS loss, gradients and train steps on the whole
batch, and the pure functions to the reference's (``opt_shardings`` and
``batch_shardings`` on a ``jax.sharding.AbstractMesh``, which needs no
devices; the int8 compression on seeded numpy inputs).

The ranks are real: ``spawn_ranks`` starts gloo processes on the CPU, one
spawn a world size, each bounded by its own deadline; a spawn runs its
meshes one after another over the same ranks (``tests/torch_dp_worker.py``,
no JAX).  Everything compares in f32, params from ``params_from_jax``:
losses within 1e-4 relative a step, every gathered param or gradient leaf
within 1e-4 relative L2 (``tests/test_torch_train.py``'s tolerances).
phi4-mini and qwen3-moe run their smoke configs with ``fsdp`` set (the
reference worker sets it, ``tests/distributed_worker.py:44-46``); qwen3-moe
also with ``moe_local_dispatch``, where the JAX side takes its grouped path
under a duck mesh with ``repro.meshctx.constrain`` as the identity (with no
devices, its sharding constraint has nothing to pin).
"""
import dataclasses
import functools
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import checkpoint as jckpt
from repro import meshctx as jmeshctx
from repro.configs.registry import get_config as jget_config
from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
from repro.distributed import sharding as jsh
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_train_step as jmake_train_step
from repro.nn import moe as jmoe
from repro.nn.model import Model as JModel
from repro.optim import compression as jcomp
from repro.optim.adamw import AdamW as JAdamW, global_norm as jglobal_norm
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro_torch import checkpoint as ckpt
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import train as train_driver
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.nn import layers as L
from repro_torch.nn import moe
from repro_torch.nn.frontends import frontend_input_specs
from repro_torch.nn.model import Model, params_from_jax
from repro_torch.optim import (AdamW, compress_with_feedback,
                               dequantize_int8, quantize_int8)
from repro_torch.optim.adamw import tree_items
from repro_torch.runtime import elastic_reshard

import torch_dp_worker as worker

# Each spawn of ranks must be done within this (seconds).
RANKS_TIMEOUT = 240.0
SPEC_MESHES = [(2, 1), (2, 2), (4, 1), (16, 16)]
# (case name, arch, config changes): the sharded train steps and grads.
TRAIN_CASES = [("phi4", "phi4-mini-3.8b", {"fsdp": True}),
               ("qwen3", "qwen3-moe-30b-a3b", {"fsdp": True}),
               ("qwen3_local", "qwen3-moe-30b-a3b",
                {"fsdp": True, "moe_local_dispatch": True})]
# The SSM and hybrid families over a data axis: their gradients at (2, 1)
# with FSDP (their "model" axis: tests/test_torch_ssm_tp.py).
SSM_CASES = [("mamba2", "mamba2-370m", {"fsdp": True}),
             ("zamba2", "zamba2-7b", {"fsdp": True})]
STEPS, BATCH, SEQ = 5, 4, 32
# The MoE layer alone, with capacity binding: 64 tokens, top-2 of 8
# experts at capacity factor 0.5 (C = 8 slots an expert for 16 copies on
# average).
MOE_CHANGES = {"fsdp": True, "capacity_factor": 0.5}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _flat_jax(tree):
    key = jckpt.checkpoint._key_str
    return {"/".join(key(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _numpy_tree(tree):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.numpy())
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Spec trees against the reference's.
# ---------------------------------------------------------------------------

def _duck(data, model):
    return types.SimpleNamespace(shape={"data": data, "model": model})


@pytest.mark.parametrize("mesh", SPEC_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_and_batch_shardings_match_reference(arch, mesh):
    """``opt_shardings`` (moments mirror the params' specs, the count
    replicated) and ``batch_shardings`` (rows over the data axes where they
    divide) give the reference's specs on an ``AbstractMesh``; the batch
    holds the tokens, the frontend's inputs, a decode row of 3 and a
    scalar."""
    am = AbstractMesh(mesh, ("data", "model"))
    jm = JModel(jget_config(arch))
    jopt = jsh.opt_shardings(jsh.param_shardings(jm, am), am)
    model = Model(get_config(arch), device="cpu")
    opt = sh.opt_shardings(sh.param_shardings(model, _duck(*mesh)))
    for part in ("m", "v"):
        want = {k: tuple(s.spec) for k, s in _flat_spec(getattr(jopt, part))}
        assert _flat(getattr(opt, part)) == want
    assert opt.count == tuple(jopt.count.spec) == ()
    specs = {name: shape for name, (shape, _) in frontend_input_specs(
        model.cfg, 16, 128).items()}
    specs.update(tokens=(16, 128), decode=(3,), pos=())
    jspecs = {k: jax.ShapeDtypeStruct(s, jnp.float32)
              for k, s in specs.items()}
    want = {k: tuple(v.spec)
            for k, v in jsh.batch_shardings(jspecs, am).items()}
    got = sh.batch_shardings({k: torch.empty(s, device="meta")
                              for k, s in specs.items()}, _duck(*mesh))
    assert got == want


def _flat_spec(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat_spec(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_local_batch_cuts_rows_and_refuses_uneven():
    mesh = _duck(2, 2)
    batch = {"tokens": np.arange(24).reshape(4, 6),
             "frame_embed": torch.arange(48.).reshape(4, 6, 2)}
    for rank, (d, _) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        got = sh.local_batch(batch, mesh, rank)
        assert np.array_equal(got["tokens"], batch["tokens"][2 * d:2 * d + 2])
        assert torch.equal(got["frame_embed"],
                           batch["frame_embed"][2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="do not split"):
        sh.local_batch({"tokens": np.zeros((3, 6))}, mesh, 0)


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2), (4, 1)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen3-moe-30b-a3b",
                                  "mixtral-8x22b", "zamba2-7b"])
def test_init_shards_on_data_axes_equal_slices(arch, mesh, monkeypatch):
    """With FSDP on, each rank's ``init_shards`` on a mesh with a data axis
    equals its ``shard_params`` slice of the one-process ``init`` from the
    same seed, bit for bit (96-element draws: many axis-0 slices)."""
    monkeypatch.setattr(L, "_DRAW_ELEMS", 96)
    cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=True)
    model = Model(cfg, device="cpu")
    m = _duck(*mesh)
    full = model.init(torch.Generator().manual_seed(0))
    specs = sh.tp_shardings(model, m)
    assert any("data" in sh.spec_axes(s) for s in _flat(specs).values())
    for rank in range(mesh[0] * mesh[1]):
        got = _flat(model.init_shards(torch.Generator().manual_seed(0), m,
                                      rank))
        want = _flat(sh.shard_params(full, specs, m, rank))
        for k, w in want.items():
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_elastic_reshard_cuts_every_leaf():
    """``elastic_reshard`` of a whole TrainState gives each rank the block
    ``local_index`` names, ints kept; the blocks tile each leaf."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True),
                              fsdp=True)
    whole = worker.whole_state(cfg, 3)
    m = _duck(2, 2)
    specs = sh.tp_shardings(Model(cfg, device="cpu"), m)
    state_sh = type(whole)(params=specs, opt=sh.opt_shardings(specs),
                           step=())
    for rank in range(4):
        got = elastic_reshard(whole, state_sh, m, rank)
        assert got.step == whole.step and got.opt.count == whole.opt.count
        for path, leaf in tree_items(whole.opt.v):
            idx = sh.local_index(leaf.shape, dict(tree_items(specs))[path],
                                 m, rank)
            assert torch.equal(dict(tree_items(got.opt.v))[path], leaf[idx])


# ---------------------------------------------------------------------------
# int8 compression.
# ---------------------------------------------------------------------------

def _grad_arrays(n, seed, shape=(64, 48)):
    rng = np.random.default_rng(seed)
    return ([(rng.standard_normal(shape) * 10 ** rng.uniform(-3, 1))
             .astype(np.float32) for _ in range(n)],
            [(rng.standard_normal(shape) * 1e-3).astype(np.float32)
             for _ in range(n)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_feedback_match_jax(dtype):
    gs, errs = _grad_arrays(3, 7)
    gs.append(np.zeros((5, 3), np.float32))        # amax 0: scale 1
    errs.append(np.zeros((5, 3), np.float32))
    for g, e in zip(gs, errs):
        jg = jnp.asarray(g).astype(dtype)
        tg = torch.from_numpy(g).to(getattr(torch, dtype))
        jq, js = jcomp.quantize_int8(jg)
        q, s = quantize_int8(tg)
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js) and s.dtype == torch.float32
        assert np.array_equal(dequantize_int8(q, s).numpy(),
                              np.asarray(jcomp.dequantize_int8(jq, js)))
        jq, js, jerr = jcomp.compress_with_feedback(jg, jnp.asarray(e))
        q, s, err = compress_with_feedback(tg, torch.from_numpy(e))
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# The JAX side.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(arch, changes):
    """(JAX config, its f32 params, the port's config, the port's f32
    params as numpy) of ``arch``'s smoke config with ``changes``."""
    changes = dict(changes)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **changes)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                JModel(jcfg).init(jax.random.PRNGKey(0)))
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           dtype=torch.float32, device="cpu")
    return jcfg, jp, cfg, _numpy_tree(tree)


def _case(arch, changes):
    return _pair(arch, tuple(sorted(changes.items())))


def _batches():
    data = JSyntheticLM(JDataConfig(vocab_size=256, seq_len=SEQ,
                                    global_batch=BATCH), 0, 1)
    return [{"tokens": data.batch_at(i)["tokens"]} for i in range(STEPS)]


class _GroupedMesh:
    """The JAX model's grouped MoE path on one process: a duck mesh of
    ``dp`` data shards and ``constrain`` as the identity.  JAX's caches are
    cleared on the way in and out: a function jitted inside would
    otherwise keep the path it traced for calls outside, and the other
    way round."""

    def __init__(self, dp):
        self.dp = dp
        self.mp = pytest.MonkeyPatch()

    def __enter__(self):
        if self.dp > 1:
            jax.clear_caches()
            self.mp.setattr(jmeshctx, "_MESH", types.SimpleNamespace(
                shape={"data": self.dp, "model": 1}))
            self.mp.setattr(jmeshctx, "constrain", lambda x, *parts: x)
        return self

    def __exit__(self, *exc):
        self.mp.undo()
        if self.dp > 1:
            jax.clear_caches()


def _jax_side(changes, data):
    """(the JAX config's changes, the data shards it groups over): with
    ``moe_local_dispatch`` over ``data`` > 1 shards, the grouped path;
    otherwise the reference takes its flat path (``repro/nn/moe.py:
    62-69``), which it runs here without the flag and without a mesh."""
    if changes.get("moe_local_dispatch") and data > 1:
        return tuple(sorted(changes.items())), data
    return tuple(sorted((k, v) for k, v in changes.items()
                        if k != "moe_local_dispatch")), 1


@functools.lru_cache(maxsize=None)
def _jax_train(arch, changes, dp):
    jcfg, jp, _, _ = _pair(arch, changes)
    opt = JAdamW(lr=jwarmup_cosine(1e-3, 2, STEPS))
    with _GroupedMesh(dp):
        step = jax.jit(jmake_train_step(JModel(jcfg), opt))
        state = JTrainState(params=jp, opt=opt.init(jp),
                            step=jnp.zeros((), jnp.int32))
        losses = []
        for b in _batches():
            state, met = step(state, {"tokens": jnp.asarray(b["tokens"])})
            losses.append(float(met["loss"]))
    return losses, _flat_jax(state.params)


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, changes, dp):
    jcfg, jp, _, _ = _pair(arch, changes)
    with _GroupedMesh(dp):
        loss, g = jax.jit(jax.value_and_grad(JModel(jcfg).loss))(
            jp, {"tokens": jnp.asarray(_batches()[0]["tokens"])})
    return float(loss), _flat_jax(g), float(jglobal_norm(g))


def _moe_inputs():
    """One qwen3-moe smoke MoE layer (f32) with capacity binding and its
    (4, 16, 64) input."""
    jcfg, jp, cfg, tree = _case("qwen3-moe-30b-a3b", MOE_CHANGES)
    layer = {k: (v[0] if not isinstance(v, dict) else
                 {kk: vv[0] for kk, vv in v.items()})
             for k, v in tree["layers"]["moe"].items()}
    x = (np.random.default_rng(5).standard_normal((4, 16, cfg.d_model))
         .astype(np.float32))
    return jcfg, cfg, layer, x


def _jax_moe(jcfg, layer, x, dp):
    p = jax.tree_util.tree_map(jnp.asarray, layer)
    if dp == 1:
        y, aux = jmoe.moe_forward(p, jnp.asarray(x), jcfg)
    else:
        y, aux = jmoe._moe_forward_grouped(p, jnp.asarray(x), jcfg, dp)
    return np.asarray(y), float(aux)


def _numpy_keep(jcfg, layer, x):
    """The reference's kept copies of its flat dispatch on the whole
    batch: its routing's expert ids, sorted stably, within capacity."""
    h = jmoe.norm(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, layer["norm"]), jcfg).reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax(h.astype(jnp.float32)
                           @ jnp.asarray(layer["router"]), -1)
    ids = np.asarray(jax.lax.top_k(probs, jcfg.experts_per_token)[1])
    eids = ids.reshape(-1)
    T = h.shape[0]
    C = jmoe._capacity(jcfg, T)
    srt = np.sort(eids, kind="stable")
    starts = np.searchsorted(srt, np.arange(jcfg.num_experts))
    pos = np.arange(eids.size) - starts[srt]
    return pos < C


# ---------------------------------------------------------------------------
# The ranks: one spawn of 4 (the (2, 2) mesh), one of 2 ((1, 2) then
# (2, 1)); the (2, 2) spawn writes the checkpoint the 2-rank one restores.
# ---------------------------------------------------------------------------

def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _train_cases(mesh):
    out = []
    for name, arch, changes in TRAIN_CASES:
        _, _, cfg, tree = _case(arch, changes)
        out.append(("train", f"{_tag(mesh)}/train_{name}", cfg, tree,
                    _batches()))
        out.append(("grads", f"{_tag(mesh)}/grads_{name}", cfg, tree,
                    _batches()[0]))
    return out


def _moe_cases(mesh):
    jcfg, cfg, layer, x = _moe_inputs()
    local = dataclasses.replace(cfg, moe_local_dispatch=True)
    return [("moe", f"{_tag(mesh)}/moe_flat", cfg, layer, x),
            ("moe", f"{_tag(mesh)}/moe_grouped", local, layer, x)]


CKPT_CFG = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True),
                               fsdp=True)
CKPT_SEED = 4


def _psum_case(n):
    gs, errs = _grad_arrays(n, 100 + n)
    return ("psum", f"psum{n}", gs, errs)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dp_ckpt"))


@pytest.fixture(scope="module")
def ranks4(ckpt_dir):
    """The (2, 2) mesh: train steps, grads, the MoE layer, compressed_psum
    over 4 ranks, and the checkpoint written."""
    cases = (_train_cases((2, 2)) + _moe_cases((2, 2)) + [_psum_case(4)]
             + [("save", "save", CKPT_CFG, CKPT_SEED, ckpt_dir)])
    return spawn_ranks(worker.run_cases, 4, ([(2, cases)],),
                       timeout=RANKS_TIMEOUT)


@pytest.fixture(scope="module")
def ranks2(ranks4, ckpt_dir):
    """The (1, 2) mesh (train steps, grads, the checkpoint restored) and
    the (2, 1) mesh (train steps, grads, the MoE layer, compressed_psum
    over 2 ranks) on the same 2 ranks."""
    restore = [("restore", "restore", CKPT_CFG, ckpt_dir)]
    ssm = [("grads", f"2x1/grads_{name}", _case(arch, changes)[2],
            _case(arch, changes)[3], _batches()[0])
           for name, arch, changes in SSM_CASES]
    phases = [(2, _train_cases((1, 2)) + restore),
              (1, _train_cases((2, 1)) + _moe_cases((2, 1))
               + [_psum_case(2)] + ssm)]
    return spawn_ranks(worker.run_cases, 2, (phases,),
                       timeout=RANKS_TIMEOUT)


def _mesh_out(ranks4, ranks2, mesh):
    """Rank 0's results of ``mesh``'s cases, keyed without the mesh."""
    out = (ranks4 if mesh == (2, 2) else ranks2)[0]
    tag = _tag(mesh) + "/"
    return {k[len(tag):]: v for k, v in out.items() if k.startswith(tag)}


MESHES = [(2, 1), (1, 2), (2, 2)]


def test_ranks_hold_their_mesh_coordinates(ranks4, ranks2):
    want4 = [({"data": 2, "model": 2}, (r // 2, r % 2)) for r in range(4)]
    assert [o["meshes"][0] for o in ranks4] == want4
    for r, o in enumerate(ranks2):
        assert o["meshes"] == [({"data": 1, "model": 2}, (0, r)),
                               ({"data": 2, "model": 1}, (r, 0))]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name,arch,changes", TRAIN_CASES,
                         ids=[c[0] for c in TRAIN_CASES])
def test_sharded_train_steps_match_jax(ranks4, ranks2, name, arch, changes,
                                       mesh):
    """Five AdamW steps on the mesh against the JAX one-process steps on
    the whole batch: each step's loss within 1e-4 relative, every param
    leaf, gathered whole, within 1e-4 relative L2."""
    jlosses, jparams = _jax_train(arch, *_jax_side(changes, mesh[0]))
    out = _mesh_out(ranks4, ranks2, mesh)
    losses, params = out[f"train_{name}/losses"], out[f"train_{name}/params"]
    assert out[f"train_{name}/count"] == STEPS
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 1e-4 * abs(want)
    assert set(params) == set(jparams)
    for path, w in jparams.items():
        assert _rel_l2(params[path], w) <= 1e-4, path


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name,arch,changes", TRAIN_CASES,
                         ids=[c[0] for c in TRAIN_CASES])
def test_sharded_grads_and_norm_match_jax(ranks4, ranks2, name, arch,
                                          changes, mesh):
    """One loss and gradient on the mesh against ``jax.value_and_grad`` of
    the one-process loss on the whole batch: the loss within 1e-4
    relative, every gradient leaf gathered whole within 1e-4 relative L2,
    and the sharded ``global_norm`` within 1e-5 of JAX's
    ``global_norm``."""
    jloss, jgrads, jnorm = _jax_grads(arch, *_jax_side(changes, mesh[0]))
    out = _mesh_out(ranks4, ranks2, mesh)
    assert abs(out[f"grads_{name}/loss"] - jloss) <= 1e-4 * abs(jloss)
    grads = out[f"grads_{name}/grads"]
    assert set(grads) == set(jgrads)
    for path, w in jgrads.items():
        assert _rel_l2(grads[path], w) <= 1e-4, path
    assert abs(out[f"grads_{name}/norm"] - jnorm) <= 1e-5 * jnorm


@pytest.mark.parametrize("name,arch,changes", SSM_CASES,
                         ids=[c[0] for c in SSM_CASES])
def test_ssm_and_hybrid_grads_over_data_match_jax(ranks4, ranks2, name,
                                                  arch, changes):
    """mamba2 and zamba2 (the shared block's leaves FSDP'd too) over 2
    data ranks: the loss and every gradient leaf, gathered whole, as the
    JAX one-process gradient."""
    jloss, jgrads, jnorm = _jax_grads(arch, *_jax_side(changes, 2))
    out = _mesh_out(ranks4, ranks2, (2, 1))
    assert abs(out[f"grads_{name}/loss"] - jloss) <= 1e-4 * abs(jloss)
    grads = out[f"grads_{name}/grads"]
    assert set(grads) == set(jgrads)
    for path, w in jgrads.items():
        assert _rel_l2(grads[path], w) <= 1e-4, path
    assert abs(out[f"grads_{name}/norm"] - jnorm) <= 1e-5 * jnorm


def test_tp2_gradients_of_replicated_leaves(ranks2):
    """The collectives fault: at tp 2 every gradient leaf of phi4-mini in
    f32, gathered whole, the replicated norm scales among them, equals the
    one-process gradient within 1e-4 relative L2 (before the collectives
    were autograd Functions, rank 0's norm-scale gradients were off by
    0.54-1.12 relative)."""
    _, jgrads, _ = _jax_grads("phi4-mini-3.8b",
                              *_jax_side(TRAIN_CASES[0][2], 1))
    grads = _mesh_out(None, ranks2, (1, 2))["grads_phi4/grads"]
    assert {"final_norm/scale", "layers/attn/norm/scale",
            "layers/mlp/norm/scale"} <= set(grads)
    for path, w in jgrads.items():
        assert _rel_l2(grads[path], w) <= 1e-4, path


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_dispatch_over_data_matches_jax(ranks4, ranks2, mesh):
    """One MoE layer with capacity binding: the flat dispatch over 2 data
    shards equals the JAX one-process ``moe_forward`` on the whole batch
    (outputs, aux loss, and the kept copies of the global plan); the
    grouped one equals the JAX ``_moe_forward_grouped(p, x, cfg, 2)``."""
    jcfg, cfg, layer, x = _moe_inputs()
    out = _mesh_out(ranks4, ranks2, mesh)
    keep = _numpy_keep(jcfg, layer, x)
    assert not keep.all()                   # capacity binds
    got_keep = out["moe_flat/keep"]
    assert len(got_keep) == 1 and np.array_equal(got_keep[0], keep)
    for name, dp in (("moe_flat", 1), ("moe_grouped", 2)):
        y, aux = _jax_moe(jcfg, layer, x, dp)
        np.testing.assert_allclose(out[f"{name}/y"], y, rtol=1e-4,
                                   atol=2e-5)
        assert abs(out[f"{name}/aux"] - aux) <= 1e-5 * abs(aux)


def test_grouped_dispatch_in_one_process_matches_jax():
    """``_moe_forward_grouped`` with no mesh splits the tokens into the
    groups itself, as the reference's vmap does."""
    jcfg, cfg, layer, x = _moe_inputs()
    p = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
             {kk: torch.from_numpy(vv) for kk, vv in v.items()})
         for k, v in layer.items()}
    for dp in (2, 4):
        with torch.no_grad():
            y, aux = moe._moe_forward_grouped(p, torch.from_numpy(x), cfg, dp)
        jy, jaux = _jax_moe(jcfg, layer, x, dp)
        np.testing.assert_allclose(y.numpy(), jy, rtol=1e-4, atol=2e-5)
        assert abs(float(aux) - jaux) <= 1e-5 * abs(jaux)


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_matches_jax(ranks4, ranks2, n):
    """``compressed_psum`` over n ranks: every rank gets the mean of JAX's
    dequantized per-rank values (each rank's int8 and scale from JAX's
    ``compress_with_feedback``), within amax/127 of the exact mean, and
    its own error feedback."""
    outs = ranks4 if n == 4 else ranks2
    gs, errs = _grad_arrays(n, 100 + n)
    deq, amax = [], 0.0
    for r in range(n):
        q, s, e = jcomp.compress_with_feedback(jnp.asarray(gs[r]),
                                               jnp.asarray(errs[r]))
        deq.append(np.asarray(jcomp.dequantize_int8(q, s)))
        amax = max(amax, float(np.abs(gs[r] + errs[r]).max()))
        np.testing.assert_allclose(outs[r][f"psum{n}/err_{r}"],
                                   np.asarray(e), rtol=0, atol=1e-7)
    want = np.mean(deq, axis=0)
    exact = np.mean([g + e for g, e in zip(gs, errs)], axis=0)
    for r in range(n):
        got = outs[r][f"psum{n}/mean_{r}"]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * amax)
        assert np.abs(got - exact).max() <= amax / 127


def test_checkpoint_restores_across_meshes_and_packages(ranks2, ckpt_dir):
    """A bf16 state saved at (2, 2) (each rank's shards, gathered whole,
    written once) restores at (1, 2), in one process and in the JAX
    package, every leaf bit for bit."""
    whole = worker.whole_state(CKPT_CFG, CKPT_SEED)
    want = {}
    for part, tree in (("params", whole.params), ("opt/m", whole.opt.m),
                       ("opt/v", whole.opt.v)):
        want.update({f"{part}/{p}": worker.bits(t)
                     for p, t in tree_items(tree)})
    out = ranks2[0]
    assert out["restore/step"] == worker.STATE_STEP
    assert out["restore/count"] == worker.STATE_COUNT
    H, hd, D = CKPT_CFG.num_heads, CKPT_CFG.head_dim, CKPT_CFG.d_model
    assert out["restore/local_shape"] == (CKPT_CFG.num_layers, D, H * hd // 2)
    assert ranks2[0]["meshes"][0][0] == {"data": 1, "model": 2}
    for key, w in want.items():
        assert np.array_equal(out[f"restore/{key}"], w), key
    params = Model(CKPT_CFG, device="cpu").abstract_params()
    template = type(whole)(params=params, opt=AdamW().init(params), step=0)
    step, one = ckpt.restore(ckpt_dir, template)
    assert step == worker.STATE_STEP
    for part, tree in (("params", one.params), ("opt/m", one.opt.m),
                       ("opt/v", one.opt.v)):
        for p, t in tree_items(tree):
            assert np.array_equal(worker.bits(t), want[f"{part}/{p}"])
    jm = JModel(jget_config("qwen3-moe-30b-a3b", smoke=True))
    jt = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jopt = JAdamW().init(jt)
    jtemplate = JTrainState(params=jt, opt=jopt,
                            step=jnp.zeros((), jnp.int32))
    jstep, jstate = jckpt.restore(ckpt_dir, jtemplate)
    assert jstep == worker.STATE_STEP and int(jstate.opt.count) == 3
    for key, a in _flat_jax(jstate).items():
        if key in ("step", "opt/count"):
            continue
        a = np.asarray(a)
        a = a.view(np.uint16) if a.dtype.itemsize == 2 else a
        assert np.array_equal(a, want[key]), key


# ---------------------------------------------------------------------------
# The driver.
# ---------------------------------------------------------------------------

def test_train_tp_driver_resumes_exactly(tmp_path):
    """``train --tp 2 --device cpu --ranks 4`` (a (2, 2) mesh) runs six
    steps with checkpoints at 4 and 6; with step 6's removed, a second run
    resumes each rank's shards from step 4 and logs step 5's and 6's losses
    exactly as the first did."""
    import shutil
    base = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--tp", "2", "--ranks", "4", "--batch", "4", "--seq", "32",
            "--steps", "6", "--ckpt-every", "4"]
    ck, a, b = (str(tmp_path / n) for n in ("ck", "a.jsonl", "b.jsonl"))
    out = train_driver.run_training(train_driver.build_parser().parse_args(
        base + ["--ckpt-dir", ck, "--log", a]))
    assert out["world"] == 4 and len(out["records"]) == 6
    assert ckpt.latest_step(ck) == 6
    shutil.rmtree(f"{ck}/step_{6:09d}")
    assert train_driver.main(base + ["--ckpt-dir", ck, "--log", b]) == 0

    def losses(path):
        return {r["step"]: r["loss"] for r in map(json.loads, open(path))}
    first, resumed = losses(a), losses(b)
    assert sorted(first) == [1, 2, 3, 4, 5, 6] and sorted(resumed) == [5, 6]
    assert all(resumed[s] == first[s] for s in (5, 6))
    assert first[6] < first[1]
    assert all(math.isfinite(v) for v in first.values())
