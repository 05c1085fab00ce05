"""Training the rest of the zoo against the JAX package: ``lm_loss`` and its
gradients, and three AdamW train steps, for minitron-8b, stablelm-12b,
internlm2-20b, musicgen-large (frame embeddings in the batch),
llava-next-mistral-7b (patch embeddings in the batch) and mixtral-8x22b
(its 32-key smoke window binding at 48 positions), at smoke size, from the
same f32 params and the same numpy batches; and ``chip_smoke.py``'s
launch reckoning of a train step for the new families.

On the CPU the port's wrappers run their plain versions, forward and
backward (a window through ``ref.attention_bwd_ref``); the JAX side runs
its ``reference`` backend.  Tolerances are ``tests/test_torch_train.py``'s:
the loss within 1e-5 relative and each gradient leaf within 1e-4 relative
L2; after three steps each loss within 1e-4 relative and each param leaf
within 1e-4 relative L2.
"""
import dataclasses
import functools
import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs.registry import get_config as jget_config
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_train_step as jmake_train_step
from repro.nn.model import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs.registry import get_config
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.launch.steps import (TrainState, _unflatten,
                                      make_prefill_step, make_train_step)
from repro_torch.nn import frontends
from repro_torch.nn.model import Model, params_from_jax
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.optim.adamw import tree_items, tree_map

ZOO = ["minitron-8b", "stablelm-12b", "internlm2-20b", "musicgen-large",
       "llava-next-mistral-7b", "mixtral-8x22b"]
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rel_l2(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(np.asarray(got, np.float32) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _batch(cfg, i, B=4):
    """Batch ``i``: tokens and the frontend's inputs as numpy arrays, S 48
    for a model with a window (it binds), else 16."""
    S = 48 if cfg.sliding_window else 16
    rng = np.random.default_rng(i)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    for name, (shape, _) in frontends.frontend_input_specs(
            cfg, B, S).items():
        out[name] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = jget_config(arch, smoke=True)
    jm = JModel(jcfg)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                jm.init(jax.random.PRNGKey(0)))
    m = Model(get_config(arch, smoke=True), device="cpu")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), m.cfg,
                         dtype=torch.float32, device="cpu")
    return {"jm": jm, "jp": jp, "m": m, "tp": tp}


def _flat_jax(tree):
    key = jckpt.checkpoint._key_str
    return {"/".join(key(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ZOO)
def test_lm_loss_and_grads_match_jax(arch):
    p = _pair(arch)
    batch = _batch(p["m"].cfg, 0)
    jloss, jgrads = jax.jit(jax.value_and_grad(p["jm"].loss))(
        p["jp"], _jbatch(batch))
    loss, grads = make_train_step(p["m"], AdamW()).loss_and_grads(
        p["tp"], batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = _flat_jax(jgrads)
    got = dict(tree_items(grads))
    assert set(got) == set(want)
    for path, w in want.items():
        assert _rel_l2(got[path].numpy(), w) <= 1e-4, path


@pytest.mark.parametrize("arch", ZOO)
def test_train_steps_match_jax(arch):
    """Three AdamW steps (warmup-cosine lr) on three batches."""
    p = _pair(arch)
    cfg = p["m"].cfg
    jopt = JAdamW(lr=jwarmup_cosine(1e-3, 1, 3))
    jstep = jax.jit(jmake_train_step(p["jm"], jopt))
    jstate = JTrainState(params=p["jp"], opt=jopt.init(p["jp"]),
                         step=jnp.zeros((), jnp.int32))
    opt = AdamW(lr=warmup_cosine(1e-3, 1, 3))
    params = tree_map(lambda t: t.clone(), p["tp"])
    state = TrainState(params=params, opt=opt.init(params), step=0)
    step = make_train_step(p["m"], opt)
    for i in range(3):
        batch = _batch(cfg, i + 1)
        jstate, jmet = jstep(jstate, _jbatch(batch))
        state, met = step(state, batch)
        jl = float(jmet["loss"])
        assert abs(float(met["loss"]) - jl) <= 1e-4 * abs(jl), i
    want = _flat_jax(jstate.params)
    for path, t in tree_items(state.params):
        assert _rel_l2(t.numpy(), want[path]) <= 1e-4, path


def test_microbatches_split_the_frontend_inputs():
    """Two micro-batches of a musicgen batch split its frame embeddings
    with its tokens: the loss and gradients equal one shot's."""
    p = _pair("musicgen-large")
    batch = _batch(p["m"].cfg, 5)
    one = make_train_step(p["m"], AdamW()).loss_and_grads(p["tp"], batch)
    two = make_train_step(p["m"], AdamW(), microbatches=2).loss_and_grads(
        p["tp"], batch)
    assert float(two[0]) == pytest.approx(float(one[0]), rel=1e-5)
    for (path, a), (_, b) in zip(tree_items(one[1]), tree_items(two[1])):
        assert _rel_l2(b.numpy(), a.numpy()) <= 1e-4, path


def test_prefill_step_carries_the_frontend_inputs():
    """``make_prefill_step`` hands a batch's non-token keys to the
    prefill, as the reference's does."""
    p = _pair("llava-next-mistral-7b")
    batch = _batch(p["m"].cfg, 6, B=2)
    jl, _ = p["jm"].prefill(p["jp"], jnp.asarray(batch["tokens"]),
                            {"patch_embed": jnp.asarray(
                                batch["patch_embed"])})
    got, _ = make_prefill_step(p["m"])(p["tp"], {
        k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wrapper_calls(cfg):
    """The calls each kernel wrapper receives in one train step of
    ``cfg`` on the CPU (B 2): (the forward's, the backward pass's)."""
    calls = {}

    def counting(module, name, key):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            k = key(a, kw)
            calls[k] = calls.get(k, 0) + 1
            return fn(*a, **kw)
        return mock.patch.object(module, name, wrapped)

    def layout(prefix):
        return lambda a, kw: prefix + ("tn" if kw.get("trans_a") else
                                       "nt" if kw.get("trans_b") else "nn")
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    paths, leaves = zip(*tree_items(params))
    live = [t.requires_grad_() for t in leaves]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 7, B=2).items()}
    batch["tokens"] = batch["tokens"].long()
    patches = [
        counting(kmm, "tiled_matmul", layout("")),
        counting(kmm, "tiled_expert_matmul", layout("expert_")),
        counting(kmm, "epilogue_bwd",
                 lambda a, kw: "epilogue_bwd_grouped" if a[0].dim() == 3
                 else "epilogue_bwd"),
        counting(ops.kfa, "flash_attention_kernel", lambda a, kw: "flash"),
        counting(ops.kfa, "flash_attention_bwd_kernel",
                 lambda a, kw: "flash_bwd")]
    for p in patches:
        p.start()
    try:
        loss = m.loss(_unflatten(dict(zip(paths, live))), batch)
        fwd = dict(calls)
        calls.clear()
        torch.autograd.grad(loss, live)
        bwd = dict(calls)
    finally:
        for p in reversed(patches):
            p.stop()
    return fwd, bwd


def _assert_reckoned(calls, want):
    fwd, bwd = calls
    want_bwd = {k: want["recompute"].get(k, 0) + want["backward"].get(k, 0)
                for k in set(want["recompute"]) | set(want["backward"])}
    assert fwd == {k: v for k, v in want["forward"].items() if v}
    assert bwd == {k: v for k, v in want_bwd.items() if v}


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-mistral-7b",
                                  "mixtral-8x22b"])
def test_train_reckoning_matches_the_wrapper_calls(arch):
    """``chip_smoke.py``'s reckoning of a train step (forward; then the
    remat recompute and the backward) equals the calls each kernel wrapper
    receives in one step of the smoke config with remat on: the gelu MLP
    (musicgen), the vlm family and the windowed MoE."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=True)
    _assert_reckoned(_wrapper_calls(cfg), _chip_smoke()._train_reckoning(cfg))


TRAIN_ZOO = ["minitron-8b", "stablelm-12b", "internlm2-20b",
             "llava-next-mistral-7b", "mixtral-8x22b"]


def _train_zoo_entry(arch):
    """(full config at ``chip_smoke.TRAIN_ZOO``'s cut depth, (B, S))."""
    cs = _chip_smoke()
    (layers, dims), = [(n, d) for a, n, d in cs.TRAIN_ZOO if a == arch]
    return dataclasses.replace(get_config(arch), num_layers=layers), dims


def test_train_zoo_is_the_five_untrained_members():
    """``train_zoo`` trains exactly the zoo members no other train phase
    trains."""
    assert [a for a, _, _ in _chip_smoke().TRAIN_ZOO] == TRAIN_ZOO


@pytest.mark.parametrize("arch", TRAIN_ZOO)
def test_train_zoo_reckoning_matches_the_wrapper_calls(arch):
    """The reckoning of a ``train_zoo`` step at its cut depth equals the
    wrapper calls of one step of the smoke widths at that depth with the
    full config's remat: the counts follow the depth, the family, the
    activation and remat, which the two configs share (the widths change
    no count)."""
    full, _ = _train_zoo_entry(arch)
    small = dataclasses.replace(get_config(arch, smoke=True),
                                num_layers=full.num_layers,
                                remat=full.remat)
    for field in ("family", "activation", "is_moe", "frontend", "norm"):
        assert getattr(small, field) == getattr(full, field), field
    assert bool(small.sliding_window) == bool(full.sliding_window)
    want = _chip_smoke()._train_reckoning(full)
    assert want == _chip_smoke()._train_reckoning(small)
    _assert_reckoned(_wrapper_calls(small), want)


@pytest.mark.parametrize("arch", TRAIN_ZOO)
def test_train_zoo_state_fits_the_cap(arch):
    """Each ``train_zoo`` model's state at its cut depth, 12 bytes a
    parameter (bf16 params and grads, f32 AdamW moments), stays under
    ``TRAIN_ZOO_STATE_CAP`` (45 GB of the card's 80); mixtral's row
    reaches past its window, the others' are B 4 x (512 text tokens, after
    llava's 2,880 patch positions)."""
    cs = _chip_smoke()
    full, (B, S) = _train_zoo_entry(arch)
    assert 12 * full.param_count() < cs.TRAIN_ZOO_STATE_CAP
    if full.sliding_window:
        assert (B, S) == (1, 8192) and S > full.sliding_window
        assert cs.MIXTRAL_GRADS_S > full.sliding_window
    else:
        assert (B, S) == (cs.TRAIN_B, full.frontend_tokens + cs.TRAIN_S)
