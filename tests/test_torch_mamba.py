"""The port's mamba2 / SSD block (``repro_torch/nn/mamba2.py``) against the
JAX package's (``repro/nn/mamba2.py``), function by function, at the
mamba2-370m and zamba2-7b smoke sizes.

Each case makes its inputs and params with numpy from a seed and hands the
same arrays to both sides.  The JAX side runs on the CPU as its own tests
run it (its GEMMs on the ``reference`` backend).  Tolerances are
``tests/test_torch_model.py``'s: f32 TIGHT (rtol 1e-5, atol 1e-5; the two
sides differ in summation order and libm ulps of exp/log), bf16 LOOSE
(rtol 2e-2, atol 2e-2; each framework rounds activations to bf16 in its
own order).  The A_log, D and dt_bias leaves are f32 in both dtypes, as in
the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.nn import mamba2 as jm
from repro_torch.configs.registry import get_config
from repro_torch.nn import layers as L
from repro_torch.nn import mamba2 as tm

TIGHT = dict(rtol=1e-5, atol=1e-5)
LOOSE = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ARCHS = ["mamba2-370m", "zamba2-7b"]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **(TIGHT if dtype == "float32" else LOOSE))


def _pair(arr, dtype, keep_f32=False):
    """One numpy array as a (jax, torch) pair in ``dtype`` (f32 if
    ``keep_f32``)."""
    jdt, tdt = DTYPES["float32" if keep_f32 else dtype]
    arr = np.asarray(arr, np.float32)
    return jnp.asarray(arr, jdt), torch.from_numpy(arr).to(tdt)


def _params(cfg, dtype, seed=0):
    """Both sides' params of one mamba block, drawn with numpy by the port's
    def tree: normal leaves at their scale, the ssm_a / ssm_dt ranges, ones
    and zeros; zeros and ones are nudged so that every bias and scale term
    is exercised."""
    rng = np.random.default_rng(seed)
    jp, tp = {}, {}
    for name, d in tm.mamba_defs(cfg).items():
        if isinstance(d, dict):
            arr = 1.0 + 0.1 * rng.standard_normal(d["scale"].shape)
            j, t = _pair(arr, dtype)
            jp[name], tp[name] = {"scale": j}, {"scale": t}
            continue
        if d.init == "ssm_a":
            arr = np.log(1.0 + 15.0 * rng.uniform(size=d.shape))
        elif d.init == "ssm_dt":
            arr = rng.uniform(-4.6, -2.3, size=d.shape)
        elif d.init in ("ones", "zeros"):
            arr = float(d.init == "ones") + 0.1 * rng.standard_normal(d.shape)
        else:
            arr = d.scale * rng.standard_normal(d.shape)
        jp[name], tp[name] = _pair(arr, dtype, keep_f32=d.dtype is not None)
    return jp, tp


def _cfgs(arch):
    return jget_config(arch, smoke=True), get_config(arch, smoke=True)


def test_segsum_matches_jax():
    a = -np.random.default_rng(1).uniform(0.0, 0.5, size=(2, 3, 16))
    want = jm._segsum(jnp.asarray(a, jnp.float32))
    got = tm._segsum(torch.from_numpy(a.astype(np.float32)))
    assert tuple(got.shape) == (2, 3, 16, 16)
    assert bool(torch.isneginf(got[..., 0, 1]).all())
    finite = np.isfinite(np.asarray(want))
    assert np.array_equal(torch.isfinite(got).numpy(), finite)
    np.testing.assert_allclose(got.numpy()[finite], np.asarray(want)[finite],
                               **TIGHT)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(dtype, chunks, with_state):
    rng = np.random.default_rng(10 * chunks + with_state)
    B, l, nh, hd, ns = 2, 16, 4, 8, 16
    S = chunks * l
    jx, tx = _pair(rng.standard_normal((B, S, nh, hd)) * 0.5, dtype)
    jdA, tdA = _pair(-rng.uniform(0.0, 0.3, size=(B, S, nh)), dtype, True)
    jb, tb = _pair(rng.standard_normal((B, S, ns)), dtype)
    jc, tc = _pair(rng.standard_normal((B, S, ns)), dtype)
    js, ts = (_pair(rng.standard_normal((B, nh, hd, ns)), dtype, True)
              if with_state else (None, None))
    jy, jfinal = jm.ssd_chunked(jx, jdA, jb, jc, l, initial_state=js)
    ty, tfinal = tm.ssd_chunked(tx, tdA, tb, tc, l, initial_state=ts)
    assert ty.dtype == tx.dtype and tfinal.dtype == torch.float32
    _close(ty, jy, dtype)
    _close(tfinal, jfinal, dtype)


def test_ssd_chunked_refuses_a_ragged_sequence():
    x = torch.zeros((1, 20, 2, 4))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm.ssd_chunked(x, torch.zeros((1, 20, 2)), torch.zeros((1, 20, 8)),
                       torch.zeros((1, 20, 8)), 16)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", [1, 2, 9])
def test_causal_conv_matches_jax(dtype, S):
    rng = np.random.default_rng(S)
    jx, tx = _pair(rng.standard_normal((2, S, 24)), dtype)
    jw, tw = _pair(0.5 * rng.standard_normal((4, 24)), dtype)
    jb, tb = _pair(0.1 * rng.standard_normal(24), dtype)
    _close(tm._causal_conv(tx, tw, tb), jm._causal_conv(jx, jw, jb), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv_step_matches_jax(dtype):
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((3, 24)), dtype)
    js, ts = _pair(rng.standard_normal((3, 3, 24)), "bfloat16")
    jw, tw = _pair(0.5 * rng.standard_normal((4, 24)), dtype)
    jb, tb = _pair(0.1 * rng.standard_normal(24), dtype)
    jy, jstate = jm._conv_step(jx, js, jw, jb)
    ty, tstate = tm._conv_step(tx, ts, tw, tb)
    assert tstate.dtype == torch.bfloat16
    _close(ty, jy, dtype)
    _close(tstate, jstate, dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", [5, 16, 37])
def test_mamba_forward_with_cache_matches_jax(arch, dtype, S):
    """The block at a sequence shorter than, equal to and not a multiple of
    the chunk (the pad steps carry dt 0, so the final state is exact)."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(cfg, dtype, seed=S)
    x = np.random.default_rng(S + 1).standard_normal((2, S, cfg.d_model))
    jx, tx = _pair(x, dtype)
    jout, jcache = jm.mamba_forward(jp, jx, jcfg, return_cache=True)
    tout, tcache = tm.mamba_forward(tp, tx, cfg, return_cache=True)
    assert tout.dtype == tx.dtype and tuple(tout.shape) == tuple(x.shape)
    _close(tout, jout, dtype)
    assert set(tcache) == set(jcache)
    for name, want in jcache.items():
        assert tuple(tcache[name].shape) == want.shape, name
        assert str(tcache[name].dtype)[6:] == str(want.dtype), name
        _close(tcache[name], want, dtype)
    _close(tm.mamba_forward(tp, tx, cfg), jout, dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_decode_matches_jax(arch, dtype):
    """Two decode steps after a prefill: the output and every leaf of the
    new cache, which the port returns as new tensors and leaves the given
    cache as it was (a retried step replays the same state)."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(cfg, dtype, seed=3)
    rng = np.random.default_rng(8)
    jx, tx = _pair(rng.standard_normal((3, 7, cfg.d_model)), dtype)
    _, jcache = jm.mamba_forward(jp, jx, jcfg, return_cache=True)
    tcache = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in jcache.items()}
    for step in range(2):
        x = rng.standard_normal((3, 1, cfg.d_model))
        jx, tx = _pair(x, dtype)
        jout, jcache = jm.mamba_decode(jp, jx, jcache, jcfg)
        before = {k: v.clone() for k, v in tcache.items()}
        tout, tnew = tm.mamba_decode(tp, tx, tcache, cfg)
        assert all(torch.equal(tcache[k], v) for k, v in before.items())
        tcache = tnew
        assert tout.dtype == tx.dtype and tuple(tout.shape) == x.shape
        _close(tout, jout, dtype)
        for name, want in jcache.items():
            assert tcache[name].dtype == (torch.float32 if name == "ssm"
                                          else torch.bfloat16)
            _close(tcache[name], want, dtype)


def test_cache_defs_match_jax():
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        want = jm.mamba_cache_defs(jcfg, 3)
        got = tm.mamba_cache_defs(cfg, 3)
        assert {k: (tuple(s), str(dt)[6:]) for k, (s, dt) in got.items()} \
            == {k: (v.shape, str(v.dtype)) for k, v in want.items()}


def test_init_rules_are_seeded_and_in_range():
    cfg = get_config("zamba2-7b", smoke=True)
    defs = tm.mamba_defs(cfg)

    def draw(seed):
        return L.init_tree(defs, torch.Generator().manual_seed(seed),
                           dtype=torch.bfloat16, device=torch.device("cpu"))
    p, again = draw(5), draw(5)
    for name in ("A_log", "D", "dt_bias"):
        assert p[name].dtype == torch.float32
        assert torch.equal(p[name], again[name])
    assert p["in_x"].dtype == torch.bfloat16
    a = p["A_log"]
    assert bool(((a >= 0) & (a <= float(np.log(16.0)))).all())
    dt = p["dt_bias"]
    assert bool(((dt >= -4.6) & (dt < -2.3)).all())
    assert bool((p["D"] == 1).all()) and bool((p["conv_xb"] == 0).all())
    assert float(p["conv_x"].float().std()) == pytest.approx(0.1, rel=0.2)
    assert float(p["in_x"].float().std()) == pytest.approx(0.02, rel=0.1)
