"""Tensor parallelism for the SSM and hybrid families in the port (the
mamba2 block on a rank's SSM heads, ``nn/mamba2.py``; the hybrid's shared
block on the TP layers; ``launch/mesh.py::check_tp``) against the JAX
package's ONE-PROCESS model, engine and gradients.

The ranks are real: ``spawn_ranks`` starts gloo processes on the CPU, one
spawn of 2 (the (1, 2) mesh) and one of 4 (the (2, 2) mesh), running
``tests/torch_ssm_tp_worker.py`` (no JAX).  mamba2-370m and zamba2-7b run
their smoke configs in f32 (4 SSM heads; zamba2 with its full config's
FSDP), params converted from the JAX ``Model.init`` by ``params_from_jax``,
an f32 decode cache on both sides.  Tolerances: logits within the
attention f32 tolerance of ``tests/test_kernels.py`` (rtol 1e-4, atol
2e-5), greedy tokens equal, the loss within 1e-4 relative and every
gradient leaf, gathered whole, within 1e-4 relative L2
(``tests/test_torch_dp.py``'s).  Two runs break one model-axis sum each
(the "copy" of the whole B / C leaves; the backward sum of the gated
RMSNorm's sum of squares) and must miss those tolerances.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs.registry import get_config as jget_config
from repro.launch.engine import ServingEngine as JEngine
from repro.nn.model import Model as JModel
from repro_torch import meshctx
from repro_torch.configs.registry import get_config
from repro_torch.core.bucketing import step_gemms
from repro_torch.launch import serve as serve_driver
from repro_torch.launch import train as train_driver
from repro_torch.launch.engine import serving_gemms
from repro_torch.launch.mesh import check_tp, spawn_ranks
from repro_torch.nn.model import params_from_jax

import torch_ssm_tp_worker as worker

ATTN32 = dict(rtol=1e-4, atol=2e-5)
RANKS_TIMEOUT = 240.0
# (case name, arch, config changes)
CASES = [("mamba2", "mamba2-370m", {}),
         ("zamba2", "zamba2-7b", {"fsdp": True})]
BATCH, SEQ, STEPS = 4, 32, 2
ENGINE_GEN = 5
# The leaves every rank holds whole, whose gradients need the model-axis sum.
WHOLE_LEAVES = ("in_b", "in_c", "conv_b", "conv_bb", "conv_c", "conv_cb")


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _numpy_tree(tree):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.numpy())
            for k, v in tree.items()}


def _flat_jax(tree):
    key = jckpt.checkpoint._key_str
    return {"/".join(key(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


class _JF32Cache(JModel):
    def init_cache(self, batch, max_len):
        return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                      super().init_cache(batch, max_len))


@functools.lru_cache(maxsize=None)
def _pair(arch, changes):
    changes = dict(changes)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **changes)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              **changes)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                JModel(jcfg).init(jax.random.PRNGKey(0)))
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           dtype=torch.float32, device="cpu")
    return jcfg, jp, cfg, _numpy_tree(tree)


def _case(name):
    arch, changes = {c[0]: c[1:] for c in CASES}[name]
    return _pair(arch, tuple(sorted(changes.items())))


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   size=(BATCH, SEQ)).astype(np.int32),
            "steps": [rng.integers(0, cfg.vocab_size,
                                   size=BATCH).astype(np.int32)
                      for _ in range(STEPS)]}


def _requests(cfg):
    rng = np.random.default_rng(11)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in (5, 11, 8)]


@pytest.fixture(scope="module")
def reference():
    """The JAX side of every case: prefill and decode logits on the whole
    batch, the engine's greedy tokens at exact lengths, the loss and
    every gradient leaf."""
    out = {}
    for i, (name, _, _) in enumerate(CASES):
        jcfg, jp, cfg, tree = _case(name)
        inputs = _inputs(cfg, seed=i)
        jm = _JF32Cache(jcfg)
        toks = jnp.asarray(inputs["tokens"])
        logits, pc = jm.prefill(jp, toks)
        cache = jax.tree_util.tree_map(
            lambda d, s: jax.lax.dynamic_update_slice(
                d, s.astype(d.dtype), (0,) * d.ndim),
            jm.init_cache(BATCH, SEQ + STEPS), pc)
        pos, steps = jnp.int32(SEQ), []
        for new in inputs["steps"]:
            lg, cache = jm.decode_step(jp, cache, jnp.asarray(new), pos)
            steps.append(np.asarray(lg))
            pos = pos + 1
        reqs = _requests(cfg)
        max_len = max(len(r) for r in reqs) + ENGINE_GEN
        eng = JEngine(jm, jp, max_batch=2, max_len=max_len, temperature=0.0,
                      seed=0, sync_every=4)
        for r in reqs:
            eng.submit(r, max_new_tokens=ENGINE_GEN)
        res = eng.run()["results"]
        loss, g = jax.jit(jax.value_and_grad(JModel(jcfg).loss))(
            jp, {"tokens": toks})
        out[name] = {"cfg": cfg, "tree": tree, "inputs": inputs,
                     "prefill": np.asarray(logits), "decode": np.stack(steps),
                     "requests": reqs, "max_len": max_len,
                     "tokens": [res[i].tokens for i in range(len(reqs))],
                     "loss": float(loss), "grads": _flat_jax(g)}
    return out


def _grads_case(ref, name, tag, mutate=None):
    r = ref[name]
    return ("grads", f"{tag}/grads_{name}" + (f"_{mutate}" if mutate else ""),
            r["cfg"], r["tree"], {"tokens": r["inputs"]["tokens"]}, mutate)


@pytest.fixture(scope="module")
def ranks(reference):
    """{(data, model): every rank's outputs}: one spawn of 2 ranks on
    (1, 2) (serving, the engine, gradients, the two broken sums) and one
    of 4 on (2, 2) (serving and gradients on each data rank's rows)."""
    two, four = [], []
    for name, _, _ in CASES:
        r = reference[name]
        for tag, cases in (("1x2", two), ("2x2", four)):
            cases += [("serve", f"{tag}/serve_{name}", r["cfg"], r["tree"],
                       r["inputs"]), _grads_case(reference, name, tag)]
        two.append(("engine", f"1x2/engine_{name}", r["cfg"], r["tree"],
                    r["requests"], ENGINE_GEN, r["max_len"]))
    two += [_grads_case(reference, "mamba2", "1x2", m)
            for m in ("whole", "norm")]
    return {(1, 2): spawn_ranks(worker.run_cases, 2, ([(2, two)],),
                                timeout=RANKS_TIMEOUT),
            (2, 2): spawn_ranks(worker.run_cases, 4, ([(2, four)],),
                                timeout=RANKS_TIMEOUT)}


MESHES = [(1, 2), (2, 2)]


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def test_ranks_hold_their_mesh_coordinates(ranks):
    for (data, model), outs in ranks.items():
        assert [o["meshes"][0] for o in outs] == [
            ({"data": data, "model": model}, divmod(r, model))
            for r in range(data * model)]


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_ssm_tp_prefill_and_decode_match_jax(ranks, reference, name, mesh):
    """Prefill logits and two decode steps' logits of each rank's rows
    equal the JAX one-process model's rows; every rank of a data row
    agrees with the others; the cache holds the rank's SSM heads (conv_x
    their channels, conv_b / conv_c whole) and kv heads."""
    ref, (data, model) = reference[name], mesh
    cfg, rows = ref["cfg"], BATCH // data
    tag = f"{_tag(mesh)}/serve_{name}"
    for rank, o in enumerate(ranks[mesh]):
        d = rank // model
        sl = slice(d * rows, (d + 1) * rows)
        np.testing.assert_allclose(o[f"{tag}/prefill"], ref["prefill"][sl],
                                   **ATTN32)
        np.testing.assert_allclose(o[f"{tag}/decode"], ref["decode"][:, sl],
                                   **ATTN32)
        assert (o[f"{tag}/decode"].argmax(-1)
                == ref["decode"][:, sl].argmax(-1)).all()
        shapes = o[f"{tag}/cache_shapes"]
        nh, w = cfg.ssm_heads // model, cfg.ssm_conv_width
        assert shapes["mamba/ssm"] == (cfg.num_layers, rows, nh,
                                       cfg.ssm_head_dim, cfg.ssm_state)
        assert shapes["mamba/conv_x"] == (cfg.num_layers, rows, w - 1,
                                          nh * cfg.ssm_head_dim)
        assert shapes["mamba/conv_b"] == (cfg.num_layers, rows, w - 1,
                                          cfg.ssm_state)
        if cfg.family == "hybrid":
            assert shapes["attn/k"][2] == cfg.num_kv_heads // model


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_ssm_tp_engine_tokens_match_jax(ranks, reference, name):
    """The lockstep engine at tp 2: every rank's greedy tokens equal the
    JAX engine's at exact lengths."""
    for o in ranks[(1, 2)]:
        for i, want in enumerate(reference[name]["tokens"]):
            got = o[f"1x2/engine_{name}/tokens_{i}"]
            assert np.array_equal(got, want), (i, got, want)


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_ssm_tp_grads_match_jax(ranks, reference, name, mesh):
    """One loss and gradient on the mesh against ``jax.value_and_grad``
    of the one-process loss on the whole batch: the loss within 1e-4
    relative and every leaf, gathered whole, within 1e-4 relative L2, the
    whole B / C leaves among them; every rank's global gradient norm, taken
    over its shards (the optimizer's clip input), within 1e-5 relative of
    the JAX gradients' norm."""
    ref = reference[name]
    out = ranks[mesh][0]
    tag = f"{_tag(mesh)}/grads_{name}"
    assert abs(out[f"{tag}/loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    grads = out[f"{tag}/grads"]
    assert set(grads) == set(ref["grads"])
    assert {f"layers/mamba/{k}" for k in WHOLE_LEAVES} <= set(grads)
    for path, want in ref["grads"].items():
        assert _rel_l2(grads[path], want) <= 1e-4, path
    want_norm = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                            for g in ref["grads"].values()))
    for o in ranks[mesh]:
        assert abs(o[f"{tag}/norm"] - want_norm) <= 1e-5 * want_norm


@pytest.mark.parametrize("mutate,leaves", [
    ("whole", WHOLE_LEAVES),
    ("norm", ("in_z", "in_x", "in_dt", "conv_x", "norm/scale"))])
def test_dropping_a_model_axis_sum_breaks_the_grads(ranks, reference,
                                                    mutate, leaves):
    """The gradient comparison sees each model-axis sum of the SSM block:
    without the "copy" of the whole leaves their gradients are each
    rank's partial, without the gated norm's backward sum every leaf
    before the norm misses; each such leaf then misses the 1e-4 of
    :func:`test_ssm_tp_grads_match_jax` tenfold, while the forward (the
    loss) stays equal."""
    ref = reference["mamba2"]
    out = ranks[(1, 2)][0]
    tag = f"1x2/grads_mamba2_{mutate}"
    assert abs(out[f"{tag}/loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    for leaf in leaves:
        path = f"layers/mamba/{leaf}"
        assert _rel_l2(out[f"{tag}/grads"][path], ref["grads"][path]) > 1e-3, \
            path


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_check_tp_refuses_a_split_of_part_heads(arch):
    """``check_tp`` names the division a ``--tp`` leaves undone: the smoke
    configs' 4 SSM heads split 2 and 4 ways, not 3; the full mamba2-370m
    (32 SSM heads) and zamba2-7b (112) split 2 ways, and neither 3."""
    smoke = get_config(arch, smoke=True)
    for tp in (1, 2, 4):
        check_tp(smoke, tp)
    with pytest.raises(ValueError, match=r"4 SSM heads \(4 % 3 = 1\)"):
        check_tp(smoke, 3)
    full = get_config(arch)
    check_tp(full, 2)
    with pytest.raises(ValueError, match="does not divide"):
        check_tp(full, 3)
    for parse, run in ((serve_driver.build_parser, serve_driver.run_serving),
                       (train_driver.build_parser,
                        train_driver.run_training)):
        args = parse().parse_args(["--arch", arch, "--smoke", "--device",
                                   "cpu", "--tp", "3"])
        with pytest.raises(ValueError, match="does not divide"):
            run(args)


class _AxisMesh(types.SimpleNamespace):
    """A duck-typed mesh that answers ``model_axis`` (no group)."""

    def group(self, axis):
        return None

    def coord(self, axis):
        return 0


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_serving_gemms_price_local_mamba_projections(arch):
    """Under tp 2 ``serving_gemms`` starts with a mamba layer's six
    projections at this rank's SSM heads (in_b, in_c whole), then, for the
    hybrid, the shared block's local step GEMMs and the head; with no mesh
    it is ``step_gemms`` as before."""
    cfg = get_config(arch)
    D, nh = cfg.d_model, cfg.ssm_heads // 2
    di, ns = nh * cfg.ssm_head_dim, cfg.ssm_state
    mamba = [(di, D), (di, D), (ns, D), (ns, D), (nh, D), (D, di)]
    kv = cfg.num_kv_heads * cfg.head_dim
    assert serving_gemms(cfg) == step_gemms(D, cfg.d_ff, kv_dim=kv,
                                            vocab=cfg.vocab_size)
    meshctx.set_mesh(_AxisMesh(shape={"data": 1, "model": 2}))
    try:
        got = serving_gemms(cfg)
    finally:
        meshctx.set_mesh(None)
    head = [(cfg.vocab_size // 2, D)]
    if cfg.family == "ssm":
        assert got == mamba + head
    else:
        q, f = D // 2, cfg.d_ff // 2
        assert got == mamba + [(q + kv, D), (D, q), (2 * f, D), (D, f)] \
            + head
