"""The rest of the model zoo against the JAX package: minitron-8b,
stablelm-12b and internlm2-20b (dense), musicgen-large (audio: frame
embeddings added to the token embeddings), llava-next-mistral-7b (vlm:
patch embeddings in the first positions) and mixtral-8x22b (MoE with a
sliding window), at smoke size, from the same params (JAX ``Model.init``
converted through numpy by ``params_from_jax``) and the same numpy inputs.

The JAX side runs its CPU ``reference`` backend, whose layers send every
attention through ``chunked_attention``; the port's CPU route is the flash
wrapper's plain version (``chunked_attention`` under a window).
mixtral's smoke window is 32 keys, and its sequences here are 64-96
tokens, so the window binds in prefill and in decode.  Tolerances are
``tests/test_torch_model.py``'s: f32 atol 1e-5 + rtol 1e-5, bf16 atol
2e-2 + rtol 2e-2; attention in f32 at rtol 1e-4 / atol 2e-5
(``tests/test_kernels.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.configs import registry as jregistry
from repro.nn import attention as jattn
from repro.nn import frontends as jfrontends
from repro.nn.model import Model as JModel
from repro_torch.configs import registry
from repro_torch.configs.registry import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref
from repro_torch.nn import attention as tattn
from repro_torch.nn import frontends
from repro_torch.nn.model import Model, params_from_jax

ZOO = ["minitron-8b", "stablelm-12b", "internlm2-20b", "musicgen-large",
       "llava-next-mistral-7b", "mixtral-8x22b"]
TIGHT = dict(rtol=1e-5, atol=1e-5)
LOOSE = dict(rtol=2e-2, atol=2e-2)
ATTN32 = dict(rtol=1e-4, atol=2e-5)


def _seq(cfg, short):
    """A sequence length at which mixtral's window binds (twice it and
    more), else ``short``."""
    return 2 * cfg.sliding_window + short if cfg.sliding_window else short


@pytest.fixture(scope="module", params=ZOO)
def pair(request):
    arch = request.param
    jcfg = jget_config(arch, smoke=True)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)), jp)
    m = Model(get_config(arch, smoke=True), device="cpu")
    return {
        "jm": jm, "m": m, "cfg": m.cfg,
        "jp": {"float32": jax.tree_util.tree_map(
                   lambda x: x.astype(jnp.float32), jp),
               "bfloat16": jp},
        "tp": {"float32": params_from_jax(tree, m.cfg, dtype=torch.float32,
                                          device="cpu"),
               "bfloat16": params_from_jax(tree, m.cfg,
                                           dtype=torch.bfloat16,
                                           device="cpu")},
    }


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _extras(cfg, B, S, seed=0):
    """The frontend's inputs as shared numpy arrays (f32, N(0, 1) x 0.02),
    shaped by the port's ``frontend_input_specs``."""
    rng = np.random.default_rng(seed + 100)
    return {name: (rng.standard_normal(shape) * 0.02).astype(np.float32)
            for name, (shape, _) in frontends.frontend_input_specs(
                cfg, B, S).items()}


def _both(extras):
    """(the JAX side's extras, the port's) from shared numpy arrays."""
    if not extras:
        return None, None
    return ({k: jnp.asarray(v) for k, v in extras.items()},
            {k: torch.from_numpy(v) for k, v in extras.items()})


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(TIGHT if dtype == "float32" else LOOSE))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_reference(smoke, arch):
    """Each copied ModelConfig equals the JAX package's, field for field."""
    want = dataclasses.asdict(jget_config(arch, smoke=smoke))
    got = dataclasses.asdict(get_config(arch, smoke=smoke))
    assert got == want


def test_registry_resolves_every_reference_id():
    """All ten ids, and the reference's (arch, shape) cells."""
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert len(registry.ARCH_IDS) == 10
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert dataclasses.asdict(registry.get_shape(name)) == \
            dataclasses.asdict(jregistry.get_shape(name))
    for skipped in (False, True):
        assert registry.all_cells(skipped) == jregistry.all_cells(skipped)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("B,S", [(2, 12), (1, 3)])
def test_frontend_input_specs_match_reference(arch, B, S):
    """Names, shapes and dtypes of the frontend inputs; the synthetic draws
    are N(0, 1) x 0.02 in bf16, from an explicit generator."""
    cfg = get_config(arch, smoke=True)
    jspecs = jfrontends.frontend_input_specs(jget_config(arch, smoke=True),
                                             B, S)
    specs = frontends.frontend_input_specs(cfg, B, S)
    assert {k: (shape, str(dt)[6:]) for k, (shape, dt) in specs.items()} \
        == {k: (s.shape, str(s.dtype)) for k, s in jspecs.items()}
    want = {"audio": {"frame_embed"}, "vision": {"patch_embed"}}.get(
        cfg.frontend, set())
    assert set(specs) == want
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    x1 = frontends.synth_frontend_inputs(cfg, g1, B, S)
    x2 = frontends.synth_frontend_inputs(cfg, g2, B, S)
    for name, (shape, dt) in specs.items():
        assert tuple(x1[name].shape) == shape and x1[name].dtype == dt
        assert torch.equal(x1[name], x2[name])
        assert float(x1[name].float().std()) == pytest.approx(0.02, rel=0.3)


def test_params_from_jax_structure(pair):
    """Every leaf converted with its shape; the layernorm biases of
    musicgen and the experts of mixtral included."""
    tp, cfg = pair["tp"]["bfloat16"], pair["cfg"]
    leaves = jax.tree_util.tree_leaves(pair["jp"]["bfloat16"])
    assert len(_flat(tp)) == len(leaves)
    assert tuple(tp["layers"]["attn"]["wq"].shape) == (
        cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim)
    if cfg.norm == "layernorm":
        assert tuple(tp["layers"]["attn"]["norm"]["bias"].shape) == (
            cfg.num_layers, cfg.d_model)
        assert tuple(tp["final_norm"]["bias"].shape) == (cfg.d_model,)
    if cfg.is_moe:
        assert tuple(tp["layers"]["moe"]["wg"].shape) == (
            cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    if cfg.activation == "gelu":
        assert tuple(tp["layers"]["mlp"]["w1"].shape) == (
            cfg.num_layers, cfg.d_model, cfg.d_ff)
    assert all(t.dtype == torch.bfloat16 for t in _flat(tp).values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits(pair, dtype):
    cfg = pair["cfg"]
    S = _seq(cfg, 12)
    toks = _tokens(cfg, 2, S)
    jx, tx = _both(_extras(cfg, 2, S))
    want = pair["jm"].forward(pair["jp"][dtype], jnp.asarray(toks), jx)
    got = pair["m"].forward(pair["tp"][dtype], torch.from_numpy(toks).long(),
                            tx)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, S, cfg.vocab_size)
    _close(got, want, dtype)


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-mistral-7b"])
def test_frontend_inputs_move_the_logits(arch):
    """The extras reach the backbone: without them the logits differ (an
    audio model everywhere, a vision model from the patch positions on)."""
    m = Model(get_config(arch, smoke=True), device="cpu")
    params = m.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    toks = torch.from_numpy(_tokens(m.cfg, 1, 12)).long()
    _, tx = _both(_extras(m.cfg, 1, 12))
    with_x = m.forward(params, toks, tx)
    without = m.forward(params, toks)
    assert not torch.allclose(with_x[:, 0], without[:, 0])
    assert not torch.allclose(with_x[:, -1], without[:, -1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_logits_and_cache(pair, dtype, ragged):
    cfg = pair["cfg"]
    S = _seq(cfg, 10)
    toks = _tokens(cfg, 2, S, seed=1)
    jx, tx = _both(_extras(cfg, 2, S, seed=1))
    last = np.array([S - 4, S - 1], np.int32) if ragged else None
    jl, jc = pair["jm"].prefill(pair["jp"][dtype], jnp.asarray(toks), jx,
                                None if last is None else jnp.asarray(last))
    tl, tc = pair["m"].prefill(pair["tp"][dtype],
                               torch.from_numpy(toks).long(),
                               None if last is None
                               else torch.from_numpy(last).long(), extras=tx)
    _close(tl, jl, dtype)
    got, want = _flat(tc), _flat(jc)
    assert set(got) == set(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        _close(got[path], w.astype(jnp.float32), dtype)


def _jax_cache(jm, B, S, dtype):
    return jax.tree_util.tree_map(lambda x: x.astype(dtype),
                                  jm.init_cache(B, S))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_logits(pair, dtype, per_slot):
    """A prefill's cache, then one decode step (no extras, as in the
    reference) at a scalar or per-slot position; mixtral's positions lie
    past its window."""
    cfg = pair["cfg"]
    B, P = 3, _seq(cfg, 8)
    S = P + 8
    jm, m = pair["jm"], pair["m"]
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    toks = _tokens(cfg, B, P, seed=2)
    jx, _ = _both(_extras(cfg, B, P, seed=2))
    _, pc = jm.prefill(pair["jp"][dtype], jnp.asarray(toks), jx)
    jcache = jax.tree_util.tree_map(
        lambda d, s: jax.lax.dynamic_update_slice(
            d, s.astype(d.dtype), (0,) * d.ndim),
        _jax_cache(jm, B, S, cdt), pc)
    tcache = jax.tree_util.tree_map(
        lambda v: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
            torch.float32 if v.dtype == jnp.float32 else torch.bfloat16),
        jcache)
    new = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                            size=B).astype(np.int32)
    pos = np.array([P, P - 3, P - 1], np.int32) if per_slot else np.int32(P)
    jl, jc2 = jm.decode_step(pair["jp"][dtype], jcache, jnp.asarray(new),
                             jnp.asarray(pos))
    tl, tc2 = m.decode_step(pair["tp"][dtype], tcache,
                            torch.from_numpy(new).long(),
                            torch.as_tensor(pos, dtype=torch.int64))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B,
                                                             cfg.vocab_size)
    _close(tl, jl, dtype)
    for path, w in _flat(jc2).items():
        _close(_flat(tc2)[path], w.astype(jnp.float32), dtype)


# chunked_attention against the reference's, and the flash wrapper's
# windowed plain versions against it, on shared numpy inputs.
ATTN_CASES = [(w, H, Hkv, causal) for w in (0, 1, 31, 32, 33)
              for H, Hkv in ((4, 4), (4, 2)) for causal in (True, False)]


def _qkv(B, H, Hkv, Sq, Skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, d)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, d)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, d)).astype(np.float32))


@pytest.mark.parametrize("window,H,Hkv,causal", ATTN_CASES, ids=str)
def test_chunked_attention_matches_reference(window, H, Hkv, causal):
    """Windows on and around a 32-key chunk's edge (chunks of 32 here, so
    that the (q, k) chunk pairs the mask hides whole are skipped), GQA and
    not, causal and not, ragged 77 positions."""
    q, k, v = _qkv(2, H, Hkv, 77, 77, 16, seed=window + H + Hkv)
    kw = dict(causal=causal, sliding_window=window, chunk_q=32, chunk_k=32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    got = tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN32)


@pytest.mark.parametrize("window", [1, 31, 32, 33, 64, 100, 500])
@pytest.mark.parametrize("Hkv", [2, 4])
def test_windowed_plain_versions_match_chunked_attention(window, Hkv):
    """The flash wrapper's windowed plain routes (``chunked_attention`` at
    512-key chunks; ``ref.attention_ref`` and ``attention_lse_ref`` with
    the window) agree with ``chunked_attention`` at 32-key chunks, and a
    window past the sequence is causal attention."""
    q, k, v = _qkv(1, 4, Hkv, 150, 150, 32, seed=window)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    want = tattn.chunked_attention(q, k, v, causal=True,
                                   sliding_window=window, chunk_q=32,
                                   chunk_k=32)
    plain = kfa.attention_plain(q, k, v, block_q=64, block_kv=64,
                                causal=True, window=window)
    dense = ref.attention_ref(q, k, v, causal=True, window=window)
    out, lse = kfa.attention_plain(q, k, v, block_q=64, block_kv=64,
                                   causal=True, return_lse=True,
                                   window=window)
    for got in (plain, dense, out):
        torch.testing.assert_close(got, want, **ATTN32)
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(4 // Hkv, dim=1)) * 32 ** -0.5
    i = torch.arange(150)
    vis = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    torch.testing.assert_close(
        lse, torch.logsumexp(s.masked_fill(~vis, float("-inf")), -1),
        rtol=1e-5, atol=1e-5)
    if window >= 150:
        torch.testing.assert_close(
            want, ref.attention_ref(q, k, v, causal=True), **ATTN32)


def test_windowed_attention_gradients_on_the_cpu():
    """Under autograd on the CPU a window runs the plain forward and
    backward, whose gradients equal autograd through the dense windowed
    reference."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(1, 4, 2, 70, 70, 16, seed=9))
    out = ops.flash_attention(q, k, v, causal=True, window=20)
    g = torch.autograd.grad(out.square().sum(), (q, k, v))
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out2 = ref.attention_ref(q2, k2, v2, causal=True, window=20)
    g2 = torch.autograd.grad(out2.square().sum(), (q2, k2, v2))
    torch.testing.assert_close(out, out2, **ATTN32)
    for a, b in zip(g, g2):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,bq,bkv,window", [
    (8192, 64, 64, 4096), (8192, 128, 64, 4096), (8192, 64, 128, 4096),
    (300, 64, 64, 100), (300, 128, 128, 32), (300, 64, 64, 128),
    (300, 64, 64, 1), (300, 128, 64, 5000)], ids=str)
def test_windowed_kv_steps(S, bq, bkv, window):
    """The selector's step counts under a window: a q block walks from the
    block of its first row's first visible key to its causal diagonal, at
    most ceil((window + bq - 1) / bkv) + 1 blocks, counts that never fall
    (the kernel's reversed order is the heaviest first); the memo keys the
    window."""
    steps = kfa.kv_steps(S, S, bq, bkv, causal=True, window=window)
    causal = kfa.kv_steps(S, S, bq, bkv, causal=True)
    cap = -(-(window + bq - 1) // bkv) + 1
    for i, n in enumerate(steps):
        q0, q1 = i * bq, min((i + 1) * bq, S) - 1
        keys = {j // bkv for r in (q0, q1)
                for j in range(max(0, r - window + 1), r + 1)}
        assert n == max(keys) - min(keys) + 1
        assert n <= min(cap, causal[i])
    assert steps == sorted(steps)
    if window >= S:
        assert steps == causal
    a = kfa.plan_attention(S, S, 128, heads=48, kv_heads=8, causal=True,
                           window=window)
    b = kfa.plan_attention(S, S, 128, heads=48, kv_heads=8, causal=True)
    assert a.max_steps <= b.max_steps
    if window < S - bq:
        assert a.predicted < b.predicted


def test_mixtral_capacity_and_window_at_full_size():
    """mixtral-8x22b at full size: E 8, top-2, moe_d_ff 16384, capacity
    152 at 474 tokens and 2,560 at 8,192 (``nn/moe.py::_capacity``), and
    its 4,096-key window walks at most 65 of 64-key blocks a q block."""
    from repro_torch.nn.moe import _capacity
    cfg = get_config("mixtral-8x22b")
    assert (cfg.num_experts, cfg.experts_per_token, cfg.moe_d_ff,
            cfg.sliding_window) == (8, 2, 16384, 4096)
    assert _capacity(cfg, 474) == 152 and _capacity(cfg, 8192) == 2560
    assert max(kfa.kv_steps(8192, 8192, 64, 64, True, 4096)) == 65
