"""The port's models against the JAX package's, from the same params (JAX
``Model.init`` converted through numpy by ``params_from_jax``), for each
ported family: phi4-mini (dense), qwen3-moe-30b-a3b (MoE), mamba2-370m
(SSM) and zamba2-7b (hybrid: mamba layers and one shared attention + MLP
block), at smoke size.

The JAX side runs on its CPU ``reference`` backend.  f32 params are held
tight (atol 1e-5 + rtol 1e-5 on logits of magnitude ~0.7; the two sides
differ only in summation order and in libm ulps of exp/cos/sin/rsqrt, and
measured 1.5e-7 apart); bf16 params loose (atol 2e-2 + rtol 2e-2: every
layer rounds its activations to bf16 in each framework's own order, and
measured 2e-3 apart on phi4-mini).  The MoE routes on an f32 softmax of an
f32 router product on both sides, so the same experts are chosen.  The
mamba A_log, D and dt_bias leaves stay f32 in a bf16 model on both sides.
Caches are compared leaf by leaf over their nested trees (the SSM cache is
``{"mamba": {conv_x, conv_b, conv_c, ssm}}``, a hybrid's adds ``"attn"``).
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

ARCHS = ["phi4-mini-3.8b", "qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-7b"]
TIGHT = dict(rtol=1e-5, atol=1e-5)
LOOSE = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = jget_config(arch, smoke=True)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)), jp)
    m = Model(get_config(arch, smoke=True), device="cpu")
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


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (a cache or a param tree)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# A cache leaf the reference stores in bf16 whatever the param dtype (the
# mamba conv tails) is held to one bf16 rounding step in an f32 run: the
# f32 values behind it agree to ~1e-7, but one that lies on a bf16
# rounding boundary rounds to either neighbour.
BF16_STEP = dict(rtol=2 ** -7, atol=1e-5)


def _close_cache(got, want, dtype):
    """Every leaf of the port's cache against the JAX cache's, by path."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        if dtype == "float32" and w.dtype == jnp.bfloat16:
            np.testing.assert_allclose(got[path].float().numpy(),
                                       np.asarray(w, np.float32),
                                       **BF16_STEP)
        else:
            _close(got[path], w.astype(jnp.float32), dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_reference(smoke, arch):
    """The port's copied ModelConfig and registry entry equal the JAX
    package's, field for field, at full size and at smoke size."""
    import dataclasses
    want = dataclasses.asdict(jget_config(arch, smoke=smoke))
    got = dataclasses.asdict(get_config(arch, smoke=smoke))
    assert got == want


def test_params_from_jax_structure(pair):
    tp = pair["tp"]["bfloat16"]
    cfg = pair["m"].cfg
    assert tuple(tp["embed"].shape) == (cfg.vocab_size, cfg.d_model)
    if cfg.has_ssm:
        mb = tp["layers"]["mamba"]
        assert tuple(mb["in_x"].shape) == (cfg.num_layers, cfg.d_model,
                                           cfg.d_inner)
        assert mb["in_x"].dtype == torch.bfloat16
        for name in ("A_log", "D", "dt_bias"):      # f32 in a bf16 model
            assert mb[name].dtype == torch.float32
            assert tuple(mb[name].shape) == (cfg.num_layers, cfg.ssm_heads)
        # the hybrid's one shared block: no layer axis
        assert ("shared" in tp) == (cfg.family == "hybrid")
        if cfg.family == "hybrid":
            assert tuple(tp["shared"]["attn"]["wq"].shape) == (
                cfg.d_model, cfg.num_heads * cfg.head_dim)
            assert tp["shared"]["mlp"]["wd"].dtype == torch.bfloat16
    else:
        assert tuple(tp["layers"]["attn"]["wq"].shape) == (
            cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim)
        block = tp["layers"]["moe" if cfg.is_moe else "mlp"]
        assert block["wd"].dtype == torch.bfloat16
        if cfg.is_moe:
            assert tuple(block["wg"].shape) == (cfg.num_layers,
                                                cfg.num_experts,
                                                cfg.d_model, cfg.moe_d_ff)
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
    _close_cache(tc, jc, dtype)


def _jax_cache(jm, B, S, dtype):
    # The reference decode cache is bf16 (but for the f32 SSM state); an
    # f32 cache lets f32 params run through the JAX decode (its cache update
    # needs matching dtypes).
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if x.dtype == jnp.bfloat16 else x,
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
    tcache = jax.tree_util.tree_map(
        lambda v: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
            torch.float32 if v.dtype == jnp.float32 else torch.bfloat16),
        jcache)
    new = rng.integers(0, 256, size=B).astype(np.int32)
    pos = np.array([8, 5, 7], np.int32) if per_slot else np.int32(8)
    jl, jc2 = jm.decode_step(pair["jp"][dtype], jcache, jnp.asarray(new),
                             jnp.asarray(pos))
    tl, tc2 = m.decode_step(pair["tp"][dtype], tcache,
                            torch.from_numpy(new).long(),
                            torch.as_tensor(pos, dtype=torch.int64))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 256)
    _close(tl, jl, dtype)
    _close_cache(tc2, jc2, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_is_bf16_and_init_is_seeded(arch):
    """The decode cache is bf16 whatever the param dtype (k/v, conv tails),
    but for the f32 SSM state, and shaped as the JAX package's; params
    draw from an explicit generator."""
    cfg = get_config(arch, smoke=True)
    m = Model(cfg, device="cpu")
    c = _flat(m.init_cache(2, 8))
    want = jax.tree_util.tree_map(
        lambda s: (s.shape, str(s.dtype)),
        JModel(jget_config(arch, smoke=True)).init_cache(2, 8))
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in c.items()} \
        == _flat(want)
    for path, t in c.items():
        assert t.dtype == (torch.float32 if path.endswith("ssm")
                           else torch.bfloat16), path
    p1 = m.init(torch.Generator().manual_seed(3), dtype=torch.float32)
    p2 = m.init(torch.Generator().manual_seed(3), dtype=torch.float32)
    torch.testing.assert_close(p1["embed"], p2["embed"], rtol=0, atol=0)
    w = (p1["layers"]["mamba"]["in_x"] if cfg.has_ssm
         else p1["layers"]["attn"]["wq"])
    assert float(w.std()) == pytest.approx(0.02, rel=0.1)
    assert bool((p1["final_norm"]["scale"] == 1).all())
    pb = m.init(torch.Generator().manual_seed(3))          # the config's bf16
    for path, t in _flat(pb).items():
        f32 = path.rsplit("/", 1)[-1] in ("A_log", "D", "dt_bias")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), path


def test_init_draws_large_leaves_in_slices(monkeypatch):
    """A normal leaf is drawn a slice of axis 0 at a time, each slice at
    most the draw bound (one row at least), from the one generator."""
    from repro_torch.nn import layers as L
    monkeypatch.setattr(L, "_DRAW_ELEMS", 40)
    drawn = []
    real = torch.Tensor.normal_

    def spy(t, *a, **kw):
        drawn.append(tuple(t.shape))
        return real(t, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "normal_", spy)
    g = torch.Generator().manual_seed(0)
    tree = L.init_tree({"w": L.ParamDef((5, 4, 3)), "v": L.ParamDef((7, 8)),
                        "s": L.ParamDef((9,))}, g, dtype=torch.bfloat16,
                       device=torch.device("cpu"))
    assert drawn == [(3, 4, 3), (2, 4, 3), (5, 8), (2, 8), (9,)]
    assert all(t.dtype == torch.bfloat16 for t in tree.values())
    assert tuple(tree["w"].shape) == (5, 4, 3)
