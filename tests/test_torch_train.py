"""The port's training path against the JAX package's, on shared numpy
inputs: the GEMM's and attention's gradients, the loss and train steps of
every family (dense, MoE, SSM, hybrid), micro-batches, the schedules and
AdamW, the data stream, the checkpoint format both ways, the retried step,
the serving path's freedom from autograd, and the driver (a smoke run of
every family, and the resume).

On this CPU host the port's kernel wrappers run their plain versions,
forward and backward; the JAX side runs its ``reference`` backend (its
layers use ``chunked_attention`` on the CPU), as its own tests do.
Tolerances: the GEMM backward at rtol 1e-5 / atol 1e-4·√K, K the
product's reduction length; attention at rtol 1e-4 / atol 1e-4; in f32
the loss within 1e-5 relative and each gradient leaf within 1e-4 relative
L2 (the two sides differ in summation order and libm ulps only); the
schedules and one AdamW update within 1e-6 (XLA's and torch's f32 cos
differ in the last bit).  Micro-batching keeps ``tests/test_models.py``'s
tolerances (loss rtol 2e-3; wg rtol 2e-2 / atol 2e-3).
"""
import dataclasses
import functools
import math
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs.registry import get_config as jget_config
from repro.core import Epilogue as JEpilogue
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_train_step as jmake_train_step
from repro.nn import moe as jmoe
from repro.nn.model import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import constant as jconstant
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import checkpoint as ckpt
from repro_torch.configs.registry import get_config
from repro_torch.core.latency import Epilogue
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_driver
from repro_torch.launch.steps import (TrainState, make_serve_step,
                                      make_train_step)
from repro_torch.nn import moe
from repro_torch.nn.model import Model, params_from_jax
from repro_torch.optim import AdamW, constant, warmup_cosine
from repro_torch.optim.adamw import tree_items, tree_map
from repro_torch.runtime import retry

ARCH = "phi4-mini-3.8b"
# One smoke config of each family: dense, MoE, SSM, hybrid.
FAMILY_ARCHS = [ARCH, "qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-7b"]


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# The GEMM's backward.
# ---------------------------------------------------------------------------

EPILOGUES = [
    Epilogue(),
    Epilogue(bias=True),
    Epilogue(activation="gelu"),
    Epilogue(activation="silu"),
    Epilogue(activation="swiglu_gate"),
    Epilogue(residual=True),
    Epilogue(bias=True, activation="swiglu_gate", residual=True),
    Epilogue(bias=True, activation="gelu"),
]
GEMM_M, GEMM_K, GEMM_N = 24, 40, 56


def _gemm_case(ep, seed=0):
    r = _rng(seed)
    M, K, N = GEMM_M, GEMM_K, GEMM_N
    arrs = {"a": r.standard_normal((2, M // 2, K)),
            "b": r.standard_normal((K, N)) * 0.2,
            "cot": r.standard_normal((2, M // 2, N))}
    if ep.bias:
        arrs["bias"] = r.standard_normal(N)
    if ep.activation == "swiglu_gate":
        arrs["gate"] = r.standard_normal((2, M // 2, N))
    if ep.residual:
        arrs["residual"] = r.standard_normal((2, M // 2, N))
    return {k: np.asarray(v, np.float32) for k, v in arrs.items()}


def _jax_gemm_grads(ep, arrs):
    names = [k for k in ("a", "b", "bias", "gate", "residual") if k in arrs]
    jep = JEpilogue(bias=ep.bias, activation=ep.activation,
                    residual=ep.residual)

    def f(*xs):
        kw = dict(zip(names, xs))
        out = jops.matmul(kw.pop("a"), kw.pop("b"), epilogue=jep,
                          backend="reference", **kw)
        return jnp.sum(out * arrs["cot"])
    grads = jax.grad(f, argnums=tuple(range(len(names))))(
        *(jnp.asarray(arrs[k]) for k in names))
    return dict(zip(names, (np.asarray(g) for g in grads)))


# The reduction length of each gradient: da sums over N, db and dbias over
# the M rows, dgate and dresidual are elementwise.
_RED = {"a": GEMM_N, "b": GEMM_M, "bias": GEMM_M, "gate": 1, "residual": 1}


@pytest.mark.parametrize("ep", EPILOGUES, ids=str)
def test_gemm_backward_matches_jax(ep):
    arrs = _gemm_case(ep)
    want = _jax_gemm_grads(ep, arrs)
    ts = {k: _t(v).requires_grad_(k != "cot") for k, v in arrs.items()}
    out = ops.matmul(ts["a"], ts["b"], epilogue=ep,
                     **{k: ts[k] for k in ("bias", "gate", "residual")
                        if k in ts})
    assert out.grad_fn is not None
    (out * ts["cot"]).sum().backward()
    for name, w in want.items():
        np.testing.assert_allclose(ts[name].grad.numpy(), w, rtol=1e-5,
                                   atol=1e-4 * math.sqrt(_RED[name]),
                                   err_msg=name)


@pytest.mark.parametrize("ep", EPILOGUES, ids=str)
def test_plain_gemm_backward_matches_jax(ep):
    """``ref.matmul_bwd_ref``, the plain backward the kernels are held to
    on the card, on 2-D operands."""
    arrs = _gemm_case(ep, seed=1)
    want = _jax_gemm_grads(ep, arrs)
    M, K, N = GEMM_M, GEMM_K, GEMM_N
    da, db, dbias, dgate, dres = ref.matmul_bwd_ref(
        _t(arrs["a"]).reshape(M, K), _t(arrs["b"]),
        _t(arrs["cot"]).reshape(M, N), epilogue=ep,
        bias=_t(arrs["bias"]) if ep.bias else None,
        gate=_t(arrs["gate"]).reshape(M, N) if "gate" in arrs else None)
    got = {"a": da.reshape(2, M // 2, K), "b": db, "bias": dbias,
           "gate": None if dgate is None else dgate.reshape(2, M // 2, N),
           "residual": None if dres is None else dres.reshape(2, M // 2, N)}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-4 * math.sqrt(_RED[name]),
                                   err_msg=name)


@pytest.mark.parametrize("layout", ["tn", "nt"])
def test_transposed_operand_plain_matches_product(layout):
    """The CPU route of a product with an operand stored transposed is the
    plain product of the transposed view, counted as no launch."""
    r = _rng(2)
    a = _t(r.standard_normal((40, 24) if layout == "tn" else (24, 40)))
    b = _t(r.standard_normal((56, 40) if layout == "nt" else (40, 56)))
    n0 = dict(kmm.tiled_matmul.layout_launches)
    got = ops._gemm(a, b, Epilogue(), torch.float32, ops.get_default_hardware(),
                    trans_a=layout == "tn", trans_b=layout == "nt")
    want = (a.t() if layout == "tn" else a) @ (b.t() if layout == "nt" else b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * math.sqrt(40))
    assert kmm.tiled_matmul.layout_launches == n0


# ---------------------------------------------------------------------------
# Attention's backward.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 32, 112, 128])
@pytest.mark.parametrize("causal,Hkv", [(True, 2), (False, 2), (True, 4)],
                         ids=str)
def test_attention_backward_matches_jax(d, causal, Hkv):
    B, H, S = 1, 4, 24
    r = _rng(d + Hkv + causal)
    q, cot = (r.standard_normal((B, H, S, d)).astype(np.float32)
              for _ in range(2))
    k, v = (r.standard_normal((B, Hkv, S, d)).astype(np.float32)
            for _ in range(2))

    def f(q_, k_, v_):
        out = jops.flash_attention(q_, k_, v_, causal=causal,
                                   backend="reference")
        return jnp.sum(out * cot)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*ts, causal=causal)
    assert out.grad_fn is not None
    (out * _t(cot)).sum().backward()
    for name, t, w in zip("qkv", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_attention_lse_is_the_rows_logsumexp():
    r = _rng(3)
    q, k, v = (_t(r.standard_normal((1, 4, 20, 16))) for _ in range(3))
    out, lse = ref.attention_lse_ref(q, k, v, causal=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 16 ** -0.5
    s = s.masked_fill(~torch.ones(20, 20, dtype=torch.bool).tril(),
                      float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1))
    torch.testing.assert_close(out, ref.attention_ref(q, k, v, causal=True))


# ---------------------------------------------------------------------------
# The loss and the train step against the JAX package.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(arch):
    """``arch``'s smoke config on both sides from the same f32 params."""
    jcfg = jget_config(arch, smoke=True)
    jm = JModel(jcfg)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                jm.init(jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    m = Model(get_config(arch, smoke=True), device="cpu")
    tp = params_from_jax(tree, m.cfg, dtype=torch.float32, device="cpu")
    batch = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                     global_batch=4), 0, 1).batch_at(0)
    return {"jm": jm, "jp": jp, "m": m, "tp": tp, "batch": batch}


@pytest.fixture(scope="module")
def pair():
    """phi4-mini's smoke config on both sides from the same f32 params."""
    return _pair(ARCH)


def _flat_jax(tree):
    """{checkpoint key: array} of a JAX tree, keyed as the JAX package's
    checkpoint keys it."""
    key = jckpt.checkpoint._key_str
    return {"/".join(key(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_routing(p):
    """For an MoE model: both sides' forward passes route every token copy
    of every layer to the same experts (the reference's routing recorded by
    a debug callback beside its dispatch)."""
    if not p["m"].cfg.is_moe:
        return
    jids, tids = [], []
    real_j, real_t = jmoe._dispatch_compute, moe._route

    def spy_j(params, flat, cfg):
        probs = jax.nn.softmax(flat.astype(jnp.float32)
                               @ params["router"].astype(jnp.float32), -1)
        ids = jax.lax.top_k(probs, cfg.experts_per_token)[1]
        jax.debug.callback(lambda i: jids.append(np.asarray(i)), ids,
                           ordered=True)
        return real_j(params, flat, cfg)

    def spy_t(flat, router, k):
        out = real_t(flat, router, k)
        tids.append(out[2].numpy())
        return out
    jb = {"tokens": jnp.asarray(p["batch"]["tokens"])}
    with mock.patch.object(jmoe, "_dispatch_compute", spy_j):
        jax.block_until_ready(jax.jit(p["jm"].loss)(p["jp"], jb))
    jax.effects_barrier()
    tokens = torch.from_numpy(p["batch"]["tokens"]).long()
    with mock.patch.object(moe, "_route", spy_t), torch.no_grad():
        p["m"].loss(p["tp"], {"tokens": tokens})
    assert len(jids) == len(tids) == p["m"].cfg.num_layers
    for layer, (a, b) in enumerate(zip(jids, tids)):
        np.testing.assert_array_equal(b, a, err_msg=f"layer {layer}")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_matches_jax(arch, remat):
    pair = _pair(arch)
    _assert_same_routing(pair)
    jm = JModel(dataclasses.replace(pair["jm"].cfg, remat=remat))
    m = Model(dataclasses.replace(pair["m"].cfg, remat=remat), device="cpu")
    jb = {"tokens": jnp.asarray(pair["batch"]["tokens"])}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(pair["jp"], jb)
    loss, grads = make_train_step(m, AdamW()).loss_and_grads(
        pair["tp"], pair["batch"])
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = _flat_jax(jgrads)
    got = dict(tree_items(grads))
    assert set(got) == set(want)
    for path, w in want.items():
        assert _rel_l2(got[path].numpy(), w) <= 1e-4, path


def _jax_steps(arch):
    """Five JAX train steps (one jit) of ``arch``'s smoke config and their
    losses."""
    pair = _pair(arch)
    opt = JAdamW(lr=jwarmup_cosine(1e-3, 2, 5))
    step = jax.jit(jmake_train_step(pair["jm"], opt))
    state = JTrainState(params=pair["jp"], opt=opt.init(pair["jp"]),
                        step=jnp.zeros((), jnp.int32))
    data = JSyntheticLM(JDataConfig(vocab_size=256, seq_len=32,
                                    global_batch=4), 0, 1)
    losses = []
    for i in range(5):
        state, met = step(state, {"tokens": jnp.asarray(
            data.batch_at(i)["tokens"])})
        losses.append(float(met["loss"]))
    return losses, _flat_jax(state.params)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_steps_match_jax(arch):
    pair = _pair(arch)
    _assert_same_routing(pair)
    jlosses, jparams = _jax_steps(arch)
    m = pair["m"]
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 5))
    params = tree_map(lambda t: t.clone(), pair["tp"])
    state = TrainState(params=params, opt=opt.init(params), step=0)
    step = make_train_step(m, opt)
    data = SyntheticLM(DataConfig(vocab_size=256, seq_len=32, global_batch=4))
    for i in range(5):
        state, met = step(state, data.batch_at(i))
        assert abs(float(met["loss"]) - jlosses[i]) <= 1e-4 * abs(jlosses[i])
    assert state.step == 5 and state.opt.count == 5
    for path, p in tree_items(state.params):
        assert _rel_l2(p.numpy(), jparams[path]) <= 1e-4, path


def test_microbatched_step_matches_single_shot(pair):
    m, tp = pair["m"], pair["tp"]
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    batch = {"tokens": _rng(3).integers(0, 256, (4, 32)).astype(np.int32)}
    out = {}
    for n in (1, 4):
        params = tree_map(lambda t: t.clone(), tp)
        state = TrainState(params=params, opt=opt.init(params), step=0)
        out[n] = make_train_step(m, opt, microbatches=n)(state, batch)
    (s1, m1), (s4, m4) = out[1], out[4]
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=2e-3)
    w1 = s1.params["layers"]["mlp"]["wg"].numpy()
    w4 = s4.params["layers"]["mlp"]["wg"].numpy()
    np.testing.assert_allclose(w1, w4, rtol=2e-2, atol=2e-3)


def test_microbatched_step_matches_jax(pair):
    opt_j, opt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    batch = {"tokens": _rng(4).integers(0, 256, (4, 32)).astype(np.int32)}
    js = JTrainState(params=pair["jp"], opt=opt_j.init(pair["jp"]),
                     step=jnp.zeros((), jnp.int32))
    js, jmet = jax.jit(jmake_train_step(pair["jm"], opt_j, microbatches=4))(
        js, {"tokens": jnp.asarray(batch["tokens"])})
    params = tree_map(lambda t: t.clone(), pair["tp"])
    state = TrainState(params=params, opt=opt.init(params), step=0)
    state, met = make_train_step(pair["m"], opt, microbatches=4)(state, batch)
    assert abs(float(met["loss"]) - float(jmet["loss"])) \
        <= 1e-4 * abs(float(jmet["loss"]))
    want = _flat_jax(js.params)
    for path, p in tree_items(state.params):
        assert _rel_l2(p.numpy(), want[path]) <= 1e-4, path


# ---------------------------------------------------------------------------
# Schedules, AdamW, data.
# ---------------------------------------------------------------------------

SCHEDULES = {
    "warmup_cosine": (lambda: warmup_cosine(3e-4, 10, 100),
                      lambda: jwarmup_cosine(3e-4, 10, 100)),
    "cosine_no_warmup": (lambda: warmup_cosine(1e-3, 0, 6),
                         lambda: jwarmup_cosine(1e-3, 0, 6)),
    "constant": (lambda: constant(1e-3), lambda: jconstant(1e-3)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    make, jmake = SCHEDULES[name]
    s, js = make(), jmake()
    for step in range(0, 121):
        want = float(js(jnp.asarray(step, jnp.int32)))
        assert abs(s(step) - want) <= 1e-6 * abs(want), step


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_jax(clip):
    r = _rng(5)
    shapes = {"w": (6, 5), "b": (5,), "deep": {"u": (3, 4)}}
    mk = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda s: np.asarray(r.standard_normal(s), np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    p0, g0, m0, v0 = mk(), mk(), mk(), mk()
    v0 = jax.tree_util.tree_map(np.abs, v0)
    jopt = JAdamW(lr=jwarmup_cosine(1e-3, 3, 10), clip_norm=clip)
    jstate = jopt.init(p0)._replace(m=m0, v=v0, count=jnp.asarray(2))
    jp, js, jm = jopt.update(g0, jstate, p0)
    opt = AdamW(lr=warmup_cosine(1e-3, 3, 10), clip_norm=clip)
    conv = lambda t: tree_map(_t, t)  # noqa: E731
    params = conv(p0)
    state = opt.init(params)._replace(m=conv(m0), v=conv(v0), count=2)
    state, met = opt.update(conv(g0), state, params)
    assert state.count == 3
    np.testing.assert_allclose(float(met["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(met["lr"], float(jm["lr"]), rtol=1e-6)
    for got, want in ((params, jp), (state.m, js.m), (state.v, js.v)):
        want = _flat_jax(want)
        for path, t in tree_items(got):
            np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-6,
                                       atol=1e-7, err_msg=path)


@pytest.mark.parametrize("pi,pc", [(0, 1), (0, 2), (1, 2)])
def test_synthetic_batches_equal_jax(pi, pc):
    cfg = dict(vocab_size=1000, seq_len=40, global_batch=8, seed=7)
    ours = SyntheticLM(DataConfig(**cfg), process_index=pi, process_count=pc)
    theirs = JSyntheticLM(JDataConfig(**cfg), process_index=pi,
                          process_count=pc)
    for step in (0, 1, 5, 1234):
        a, b = ours.batch_at(step)["tokens"], theirs.batch_at(step)["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Checkpoints: the JAX package's format, both ways.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_bf16_state():
    jm = JModel(jget_config(ARCH, smoke=True))
    p = jm.init(jax.random.PRNGKey(1))
    opt = JAdamW()
    o = opt.init(p)
    o = o._replace(m=jax.tree_util.tree_map(lambda x: x + 0.5, o.m),
                   count=jnp.asarray(3, jnp.int32))
    return JTrainState(params=p, opt=o, step=jnp.asarray(7, jnp.int32)), jm


def _port_template(m):
    params = m.abstract_params()
    return TrainState(params=params, opt=AdamW().init(params), step=0)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def test_jax_checkpoint_restores_into_port(tmp_path, jax_bf16_state):
    jstate, _ = jax_bf16_state
    jckpt.save(str(tmp_path), 7, jstate)
    m = Model(get_config(ARCH, smoke=True), device="cpu")
    step, state = ckpt.restore(str(tmp_path), _port_template(m))
    assert step == 7 and state.step == 7 and state.opt.count == 3
    want = _flat_jax(jstate)
    got = dict(ckpt.checkpoint._items(state))
    assert set(got) == set(want)
    for key, t in got.items():
        if isinstance(t, int):
            assert t == int(want[key])
            continue
        assert str(t.dtype)[6:] == str(want[key].dtype)
        assert np.array_equal(_bits(ckpt.checkpoint._to_numpy(t)[0]),
                              _bits(want[key])), key


def test_port_checkpoint_restores_into_jax(tmp_path, jax_bf16_state):
    jstate, _ = jax_bf16_state
    m = Model(get_config(ARCH, smoke=True), device="cpu")
    params = m.init(torch.Generator().manual_seed(2))
    opt = AdamW().init(params)
    opt = opt._replace(v=tree_map(lambda t: t + 0.25, opt.v), count=4)
    state = TrainState(params=params, opt=opt, step=9)
    ckpt.save(str(tmp_path), 9, state, extra_meta={"arch": ARCH})
    step, restored = jckpt.restore(str(tmp_path), jstate)
    assert step == 9 and int(restored.step) == 9
    assert int(restored.opt.count) == 4
    want = dict(ckpt.checkpoint._items(state))
    for key, a in _flat_jax(restored).items():
        w = want[key]
        if isinstance(w, int):
            continue
        assert np.array_equal(_bits(a), _bits(ckpt.checkpoint._to_numpy(w)[0]))


def test_corrupted_checkpoint_raises(tmp_path):
    m = Model(get_config(ARCH, smoke=True), device="cpu")
    params = m.init(torch.Generator().manual_seed(3))
    state = TrainState(params=params, opt=AdamW().init(params), step=1)
    path = ckpt.save(str(tmp_path), 1, state)
    npz = os.path.join(path, "arrays.npz")
    with np.load(npz) as f:
        arrays = dict(f)
    arrays["params/embed"] = arrays["params/embed"].copy()
    arrays["params/embed"][0, 0] ^= 1
    np.savez(npz, **arrays)
    with pytest.raises(IOError, match="params/embed"):
        ckpt.restore(str(tmp_path), _port_template(m))


def test_interrupted_save_keeps_the_last_checkpoint(tmp_path):
    m = Model(get_config(ARCH, smoke=True), device="cpu")
    params = m.init(torch.Generator().manual_seed(4))
    state = TrainState(params=params, opt=AdamW().init(params), step=1)
    ckpt.save(str(tmp_path), 1, state)
    later = state._replace(params=tree_map(lambda t: t + 1, params), step=2)
    with mock.patch.object(ckpt.checkpoint.os, "replace",
                           side_effect=OSError("killed before the rename")):
        with pytest.raises(OSError):
            ckpt.save(str(tmp_path), 2, later)
    assert ckpt.latest_step(str(tmp_path)) == 1
    step, got = ckpt.restore(str(tmp_path), _port_template(m))
    assert step == 1
    for (_, a), (_, b) in zip(tree_items(got.params), tree_items(params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The step's two parts, serving, families, the driver.
# ---------------------------------------------------------------------------

def test_retried_step_equals_a_clean_one(pair):
    """A transient fault part-way through the loss and gradients: the
    retried step's params and moments equal a clean step's bit for bit,
    because that part mutates nothing and the commit runs once."""
    from repro_torch.nn import layers
    m, batch = pair["m"], pair["batch"]
    opt = AdamW(lr=1e-3)

    def run(fault):
        params = tree_map(lambda t: t.clone(), pair["tp"])
        state = TrainState(params=params, opt=opt.init(params), step=0)
        step = make_train_step(m, opt)
        state, _ = step(state, batch)           # moments not zero
        real, calls = layers.mlp_forward, []

        def flaky(*a, **kw):
            calls.append(1)
            if fault and len(calls) == 2:
                raise RuntimeError("UNAVAILABLE: injected transient fault")
            return real(*a, **kw)
        with mock.patch.object(layers, "mlp_forward", flaky):
            loss, grads = retry(step.loss_and_grads, state.params, batch,
                                retries=2, base_delay=0.0)
        state, _ = step.apply(state, loss, grads)
        return state, len(calls)

    clean, n_clean = run(False)
    faulty, n_faulty = run(True)
    assert n_faulty == n_clean + 2      # the failed attempt reached layer 2
    for a, b in ((clean.params, faulty.params), (clean.opt.m, faulty.opt.m),
                 (clean.opt.v, faulty.opt.v)):
        for (_, x), (_, y) in zip(tree_items(a), tree_items(b)):
            assert torch.equal(x, y)


def test_serving_builds_no_autograd_node(pair):
    """Under inference_mode (the engine's) the ops launch directly: no
    autograd Function runs, even with params that require grad."""
    m = pair["m"]
    params = tree_map(lambda t: t.clone().requires_grad_(), pair["tp"])
    tokens = torch.from_numpy(pair["batch"]["tokens"][:2, :16]).long()
    boom = mock.Mock(side_effect=AssertionError("autograd Function ran"))
    with mock.patch.object(ops._Matmul, "apply", boom), \
            mock.patch.object(ops._FlashAttention, "apply", boom), \
            torch.inference_mode():
        logits, cache = m.prefill(params, tokens)
        cache = m.init_cache(2, 24)
        out, _ = make_serve_step(m)(params, cache, tokens[:, 0],
                                    torch.tensor(3))
    assert logits.grad_fn is None and out.grad_fn is None
    assert not logits.requires_grad and not out.requires_grad
    with mock.patch.object(ops._Matmul, "apply", boom), \
            pytest.raises(AssertionError, match="autograd Function ran"):
        m.forward(params, tokens)


def test_train_step_refuses_a_family_the_port_lacks():
    """Every family of the JAX package is ported, so a train step takes a
    model of each; the config refuses a family neither package has, so no
    model of one reaches a train step."""
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.nn.config import FAMILIES
    assert {get_config(a).family for a in ARCH_IDS} == set(FAMILIES)
    for arch in ARCH_IDS:
        make_train_step(Model(get_config(arch, smoke=True), device="cpu"),
                        AdamW())
    with pytest.raises(AssertionError, match="encoder"):
        dataclasses.replace(get_config(ARCH, smoke=True), family="encoder")


@pytest.mark.parametrize("arch", FAMILY_ARCHS[1:])
def test_train_driver_trains_every_family(tmp_path, arch):
    """``python -m repro_torch.launch.train --smoke --device cpu`` for the
    MoE, SSM and hybrid families: every step logged with a finite loss and
    norm, and the loss falls over six steps at lr 1e-2."""
    import json
    log = str(tmp_path / "log.jsonl")
    assert train_driver.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--batch", "4", "--seq", "32", "--steps", "6",
                              "--lr", "1e-2", "--warmup", "0",
                              "--log", log]) == 0
    recs = [json.loads(line) for line in open(log)]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5, 6]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in recs)
    assert recs[-1]["loss"] < recs[0]["loss"]


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_reckoning_matches_the_wrapper_calls(arch):
    """``chip_smoke.py``'s reckoning of a train step's kernel launches
    (forward; then in the backward pass the remat recompute and the
    backward) equals the calls each kernel wrapper receives in one step of
    the smoke config with remat on, here on the CPU, where each call is
    the kernel's plain version and would be one launch on the card."""
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
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=True)
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    paths, leaves = zip(*tree_items(params))
    live = [t.requires_grad_() for t in leaves]
    from repro_torch.launch.steps import _unflatten
    tokens = torch.from_numpy(_rng(8).integers(0, cfg.vocab_size, (2, 32)))
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
        loss = m.loss(_unflatten(dict(zip(paths, live))),
                      {"tokens": tokens.long()})
        fwd = dict(calls)
        calls.clear()
        torch.autograd.grad(loss, live)
        bwd = dict(calls)
    finally:
        for p in reversed(patches):
            p.stop()
    want = _chip_smoke()._train_reckoning(cfg)
    want_bwd = {k: want["recompute"].get(k, 0) + want["backward"].get(k, 0)
                for k in set(want["recompute"]) | set(want["backward"])}
    assert fwd == {k: v for k, v in want["forward"].items() if v}
    assert bwd == {k: v for k, v in want_bwd.items() if v}


def test_train_driver_resumes_exactly(tmp_path):
    """--steps 4 with checkpoints, then a resume to step 6: steps 5-6 log
    the losses of an uninterrupted six-step run."""
    import json
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "32"]
    ck, a, b = (str(tmp_path / n) for n in ("ck", "a.jsonl", "b.jsonl"))
    assert train_driver.main(base + ["--steps", "4", "--ckpt-dir", ck,
                                     "--log", a]) == 0
    assert ckpt.latest_step(ck) == 4
    assert train_driver.main(base + ["--steps", "6", "--ckpt-dir", ck,
                                     "--log", a]) == 0
    assert train_driver.main(base + ["--steps", "6", "--log", b]) == 0

    def losses(path):
        return {r["step"]: r["loss"] for r in map(json.loads, open(path))}
    resumed, clean = losses(a), losses(b)
    assert sorted(resumed) == sorted(clean) == [1, 2, 3, 4, 5, 6]
    assert all(resumed[s] == clean[s] for s in (5, 6))
    assert clean[6] < clean[1]


def test_train_driver_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_driver.main(["--arch", ARCH, "--smoke", "--steps", "1"])
