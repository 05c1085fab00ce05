"""The port's phi4-mini model against the JAX package's, from the same
params (JAX ``Model.init`` converted through numpy by ``params_from_jax``).

The JAX side runs on its CPU ``reference`` backend.  f32 params are held
tight (atol 1e-5 + rtol 1e-5 on logits of magnitude ~0.7; the two sides
differ only in summation order and in libm ulps of exp/cos/sin/rsqrt, and
measured 1.5e-7 apart); bf16 params loose (atol 2e-2 + rtol 2e-2: every
layer rounds its activations to bf16 in each framework's own order, and
measured 2e-3 apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.nn.model import Model as JModel
from repro_torch.configs.registry import get_config
from repro_torch.nn.model import Model, params_from_jax

ARCH = "phi4-mini-3.8b"
TIGHT = dict(rtol=1e-5, atol=1e-5)
LOOSE = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def pair():
    jcfg = jget_config(ARCH, smoke=True)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)), jp)
    m = Model(get_config(ARCH, smoke=True), device="cpu")
    return {
        "jm": jm, "m": m,
        "jp": {"float32": jax.tree_util.tree_map(
                   lambda x: x.astype(jnp.float32), jp),
               "bfloat16": jp},
        "tp": {"float32": params_from_jax(tree, m.cfg, dtype=torch.float32,
                                          device="cpu"),
               "bfloat16": params_from_jax(tree, m.cfg,
                                           dtype=torch.bfloat16,
                                           device="cpu")},
    }


def _tokens(B, S, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)
                                                ).astype(np.int32)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(TIGHT if dtype == "float32" else LOOSE))


@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_reference(smoke):
    """The port's copied ModelConfig and registry entry equal the JAX
    package's, field for field, at full size and at smoke size."""
    import dataclasses
    want = dataclasses.asdict(jget_config(ARCH, smoke=smoke))
    got = dataclasses.asdict(get_config(ARCH, smoke=smoke))
    assert got == want


def test_params_from_jax_structure(pair):
    tp = pair["tp"]["bfloat16"]
    cfg = pair["m"].cfg
    assert tuple(tp["embed"].shape) == (cfg.vocab_size, cfg.d_model)
    assert tuple(tp["layers"]["attn"]["wq"].shape) == (
        cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert tp["layers"]["mlp"]["wd"].dtype == torch.bfloat16
    leaves = jax.tree_util.tree_leaves(pair["jp"]["bfloat16"])
    n = 0
    stack = [tp]
    while stack:
        node = stack.pop()
        for v in node.values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                n += 1
    assert n == len(leaves)
    with pytest.raises(KeyError, match="missing"):
        params_from_jax({"embed": np.zeros((256, 64))}, cfg,
                        dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits(pair, dtype):
    toks = _tokens(2, 12)
    want = pair["jm"].forward(pair["jp"][dtype], jnp.asarray(toks))
    got = pair["m"].forward(pair["tp"][dtype], torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, 256)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_logits_and_cache(pair, dtype, ragged):
    toks = _tokens(2, 10, seed=1)
    last = np.array([6, 9], np.int32) if ragged else None
    jl, jc = pair["jm"].prefill(pair["jp"][dtype], jnp.asarray(toks),
                                last_pos=None if last is None
                                else jnp.asarray(last))
    tl, tc = pair["m"].prefill(pair["tp"][dtype],
                               torch.from_numpy(toks).long(),
                               None if last is None
                               else torch.from_numpy(last).long())
    _close(tl, jl, dtype)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name].astype(jnp.float32), dtype)


def _jax_cache(jm, B, S, dtype):
    # The reference decode cache is bf16; an f32 cache lets f32 params run
    # through the JAX decode (its cache update needs matching dtypes).
    return jax.tree_util.tree_map(lambda x: x.astype(dtype),
                                  jm.init_cache(B, S))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_logits(pair, dtype, per_slot):
    B, S = 3, 16
    rng = np.random.default_rng(5)
    jm, m = pair["jm"], pair["m"]
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jcache = _jax_cache(jm, B, S, cdt)
    # Fill the cache with the prefill of a prompt, then decode one token.
    toks = _tokens(B, 8, seed=2)
    _, pc = jm.prefill(pair["jp"][dtype], jnp.asarray(toks))
    jcache = jax.tree_util.tree_map(
        lambda d, s: jax.lax.dynamic_update_slice(
            d, s.astype(d.dtype), (0,) * d.ndim), jcache, pc)
    tcache = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if dtype == "float32" else torch.bfloat16)
        for k, v in jcache.items()}
    new = rng.integers(0, 256, size=B).astype(np.int32)
    pos = np.array([8, 5, 7], np.int32) if per_slot else np.int32(8)
    jl, jc2 = jm.decode_step(pair["jp"][dtype], jcache, jnp.asarray(new),
                             jnp.asarray(pos))
    tl, tc2 = m.decode_step(pair["tp"][dtype], tcache,
                            torch.from_numpy(new).long(),
                            torch.as_tensor(pos, dtype=torch.int64))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 256)
    _close(tl, jl, dtype)
    for name in ("k", "v"):
        _close(tc2[name], jc2[name].astype(jnp.float32), dtype)


def test_init_cache_is_bf16_and_init_is_seeded():
    m = Model(get_config(ARCH, smoke=True), device="cpu")
    c = m.init_cache(2, 8)
    assert c["k"].dtype == torch.bfloat16 and c["v"].dtype == torch.bfloat16
    p1 = m.init(torch.Generator().manual_seed(3), dtype=torch.float32)
    p2 = m.init(torch.Generator().manual_seed(3), dtype=torch.float32)
    torch.testing.assert_close(p1["embed"], p2["embed"], rtol=0, atol=0)
    assert float(p1["layers"]["attn"]["wq"].std()) == pytest.approx(0.02,
                                                                     rel=0.1)
    assert bool((p1["final_norm"]["scale"] == 1).all())
