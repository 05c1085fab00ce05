"""The port's grouped expert GEMM and MoE layer against the JAX package's,
on shared numpy inputs.

``expert_matmul``: the JAX side runs through both its ``reference`` backend
and its Pallas kernel in interpret mode (the vmapped ``matmul_pallas``),
selected against the same H100 preset as the port; the port's op computes
with the grouped kernel's plain version on this CPU host.  Tolerances are
``tests/test_kernels.py``'s: f32 rtol 1e-5 / atol 1e-4·√K, bf16 rtol 3e-2 /
atol 0.3·√K, with K the contraction depth.

MoE layer (qwen3-moe-30b-a3b smoke config: 8 experts, top-2, d_model 64,
expert d_ff 32): params drawn with numpy at std 1/√fan_in, so the layer's
outputs are O(1) and the GEMM tolerances' K is d_model (the deepest
contraction the output depends on).  A bf16 layer rounds h, u, the gated
activation, every expert output and the combine to bf16 in each
framework's own order, so bf16 layer outputs are held at rtol 3e-2 /
atol 3e-2 (the GEMM bound of 0.3·√K would pass anything of this size).
"""
import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import Epilogue as JEpilogue
from repro.core.hardware import GPU_H100_LIKE as JGPU_H100_LIKE
from repro.kernels import ops as jops
from repro.nn import moe as jmoe
from repro.nn.layers import norm as jnorm
from repro_torch.configs.registry import get_config
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import Epilogue
from repro_torch.core.selector import select_gemm_config
from repro_torch.core.topology import DegradedModeWarning
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.nn import moe
from repro_torch.obs import metrics as obs_metrics

ARCH = "qwen3-moe-30b-a3b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
EPILOGUES = [
    Epilogue(),
    Epilogue(bias=True),
    Epilogue(activation="swiglu_gate"),
    Epilogue(residual=True),
    Epilogue(bias=True, activation="swiglu_gate", residual=True),
]


def _tol(dt, K):
    if dt == "f32":
        return 1e-5, 1e-4 * math.sqrt(K)
    return 3e-2, 0.3 * math.sqrt(K)


def _layer_tol(dt, K):
    if dt == "f32":
        return 1e-5, 1e-4 * math.sqrt(K)
    return 3e-2, 3e-2


def _jep(ep):
    return JEpilogue(bias=ep.bias, activation=ep.activation,
                     residual=ep.residual)


# ---------------------------------------------------------------------------
# The grouped GEMM op.
# ---------------------------------------------------------------------------

def _expert_operands(E, M, K, N, ep, seed):
    rng = np.random.default_rng(seed)
    arrs = {"x": rng.standard_normal((E, M, K)),
            "w": rng.standard_normal((E, K, N))}
    if ep.bias:
        arrs["bias"] = rng.standard_normal((E, N))
    if ep.activation == "swiglu_gate":
        arrs["gate"] = rng.standard_normal((E, M, N))
    if ep.residual:
        arrs["residual"] = rng.standard_normal((E, M, N))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


@pytest.mark.parametrize("backend", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 24, 64, 96), (3, 17, 40, 72)],
                         ids=["aligned", "ragged"])
@pytest.mark.parametrize("ep", EPILOGUES, ids=str)
def test_expert_matmul_matches_jax(ep, shape, dt, backend):
    E, M, K, N = shape
    arrs = _expert_operands(E, M, K, N, ep, seed=M)
    jdt, tdt = DTYPES[dt]
    j = {k: jnp.asarray(v, dtype=jdt) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).to(tdt) for k, v in arrs.items()}
    want = jops.expert_matmul(j.pop("x"), j.pop("w"), hw=JGPU_H100_LIKE,
                              backend=backend, epilogue=_jep(ep), **j)
    n0 = kmm.tiled_expert_matmul.launches
    got = ops.expert_matmul(t.pop("x"), t.pop("w"), epilogue=ep, **t)
    assert kmm.tiled_expert_matmul.launches == n0     # plain on the CPU
    assert got.dtype == tdt and tuple(got.shape) == (E, M, N)
    rtol, atol = _tol(dt, K)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


def test_expert_matmul_bf16_in_f32_out():
    arrs = _expert_operands(4, 40, 64, 32, Epilogue(), seed=9)
    x, w = (torch.from_numpy(arrs[k]).bfloat16() for k in ("x", "w"))
    got = ops.expert_matmul(x, w, out_dtype=torch.float32)
    want = jops.expert_matmul(jnp.asarray(arrs["x"], jnp.bfloat16),
                              jnp.asarray(arrs["w"], jnp.bfloat16),
                              out_dtype=jnp.float32, backend="reference")
    assert got.dtype == torch.float32
    rtol, atol = _tol("bf16", 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_expert_matmul_plain_is_per_expert_matmul():
    """The grouped plain version is the dense plain version per expert."""
    arrs = _expert_operands(3, 8, 16, 24, Epilogue(bias=True), seed=2)
    x, w, b = (torch.from_numpy(arrs[k]) for k in ("x", "w", "bias"))
    ep = Epilogue(bias=True, activation="gelu")
    cfg = select_gemm_config(8, 24, 16, in_dtype="float32",
                             out_dtype="float32", epilogue=ep,
                             hw=GPU_H100_LIKE).config
    got = kmm.expert_matmul_plain(x, w, cfg, out_dtype=torch.float32,
                                  epilogue=ep, bias=b)
    for e in range(3):
        want = kmm.matmul_plain(x[e], w[e], cfg, out_dtype=torch.float32,
                                epilogue=ep, bias=b[e])
        torch.testing.assert_close(got[e], want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Fail-soft launch of the grouped op: the same ladder as ops.matmul.
# ---------------------------------------------------------------------------

@pytest.fixture
def metrics():
    prev = obs_metrics.enable_metrics(True)
    obs_metrics.get_registry().clear()
    yield obs_metrics.get_registry()
    obs_metrics.get_registry().clear()
    obs_metrics.enable_metrics(prev)


def _count(reg, name, **labels):
    return sum(m.value for m in reg.metrics() if m.name == name
               and all(dict(m.labels).get(k) == v
                       for k, v in labels.items()))


def _xw(E=4, M=24, K=64, N=96):
    arrs = _expert_operands(E, M, K, N, Epilogue(), seed=5)
    return torch.from_numpy(arrs["x"]), torch.from_numpy(arrs["w"])


def _with_injector(fn, injector):
    prev = ops.set_launch_fault_injector(injector)
    try:
        return fn()
    finally:
        ops.set_launch_fault_injector(prev)


def test_expert_ladder_walks_to_next_rung(metrics):
    x, w = _xw()
    clean = ops.expert_matmul(x, w)
    primary = select_gemm_config(24, 96, 64, in_dtype="float32",
                                 out_dtype="float32", epilogue=Epilogue(),
                                 hw=GPU_H100_LIKE).config
    tried = []

    def injector(cfg):
        tried.append(cfg)
        if cfg == primary:
            raise RuntimeError("injected deterministic launch failure")

    with pytest.warns(DegradedModeWarning):
        got = _with_injector(lambda: ops.expert_matmul(x, w), injector)
    assert tried[0] == primary and len(tried) == 2 and tried[1] != primary
    torch.testing.assert_close(got, clean, rtol=0, atol=0)
    assert _count(metrics, "fallback_rungs", rung="next") == 1
    assert _count(metrics, "launch_validation_failures") == 1
    assert _count(metrics, "selection_rejected") == 1
    assert _count(metrics, "launch_retries") == 0


def test_expert_transient_fault_is_retried(metrics):
    x, w = _xw()
    fired = []

    def injector(cfg):
        if not fired:
            fired.append(cfg)
            raise RuntimeError("transient: injected launch fault")

    got = _with_injector(lambda: ops.expert_matmul(x, w), injector)
    torch.testing.assert_close(got, torch.bmm(x, w), rtol=1e-5, atol=1e-4)
    assert _count(metrics, "launch_retries") == 1
    assert _count(metrics, "fallback_rungs") == 0


def test_expert_cpu_last_rung_serves_plain_version(metrics):
    x, w = _xw()

    def injector(cfg):
        raise RuntimeError("every tiled launch fails")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegradedModeWarning)
        got = _with_injector(lambda: ops.expert_matmul(x, w), injector)
    torch.testing.assert_close(got, torch.bmm(x, w), rtol=1e-5, atol=1e-4)
    assert _count(metrics, "fallback_rungs", rung="reference") == 1


class _Elsewhere:
    """A tensor stand-in on a device no wrapper takes: neither a device
    of the plain versions (the CPU, meta) nor CUDA."""
    device = torch.device("xpu")


def test_expert_last_rung_raises_off_cpu():
    """Off the CPU the grouped GEMM's ladder ends in an error, never in
    the plain version: driven for a CUDA device with every tiled rung
    failing (no card is here), it raises.  Meta tensors take the plain
    versions (the dry-run's device): a meta grouped product is a meta
    tensor of its shape.  A device neither plain nor CUDA is refused."""
    sel = select_gemm_config(24, 96, 64, in_dtype="float32",
                             out_dtype="float32", epilogue=Epilogue(),
                             hw=GPU_H100_LIKE)

    def launch(cfg):
        raise RuntimeError("every tiled launch fails")

    def reference():
        raise AssertionError("the plain version was served off the CPU")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegradedModeWarning)
        with pytest.raises(RuntimeError, match="never serves the plain"):
            ops._launch_fail_soft(launch, reference, sel.config, sel,
                                  GPU_H100_LIKE, (24, 96, 64),
                                  torch.device("cuda", 0))
    x = torch.empty((4, 24, 64), device="meta")
    w = torch.empty((4, 64, 96), device="meta")
    out = ops.expert_matmul(x, w)
    assert out.device.type == "meta" and tuple(out.shape) == (4, 24, 96)
    with pytest.raises(ValueError, match="unsupported device"):
        kmm.tiled_expert_matmul(_Elsewhere(), _Elsewhere(), sel.config,
                                out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# The MoE layer.
# ---------------------------------------------------------------------------

def _configs(**changes):
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), **changes)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **changes)
    return jcfg, cfg


def _moe_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(
            np.float32)
    return {"norm": {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(
                np.float32)},
            "router": normal((D, E), D),
            "wg": normal((E, D, F), D),
            "wu": normal((E, D, F), D),
            "wd": normal((E, F, D), F)}


def _both(tree, x, dt):
    jdt, tdt = DTYPES[dt]
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)
    tp = {k: ({kk: torch.from_numpy(vv).to(tdt) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v).to(tdt))
          for k, v in tree.items()}
    return jp, tp, jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, dt, K):
    rtol, atol = _layer_tol(dt, K)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=rtol, atol=atol)


def test_moe_defs_and_capacity_match_reference():
    jcfg, cfg = _configs()
    jdefs = jmoe.moe_defs(jcfg)
    defs = moe.moe_defs(cfg)
    assert set(defs) == set(jdefs)
    for name in ("router", "wg", "wu", "wd"):
        assert defs[name][0] == tuple(jdefs[name].shape)
    for cf in (0.25, 1.0, 1.25, 2.0):
        jc, c = _configs(capacity_factor=cf)
        for T in (1, 7, 16, 64, 474, 512):
            assert moe._capacity(c, T) == jmoe._capacity(jc, T)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_forward_matches_jax(dt):
    jcfg, cfg = _configs()
    tree = _moe_params(cfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jp, tp, jx, tx = _both(tree, x, dt)
    jy, jaux = jmoe.moe_forward(jp, jx, jcfg)
    ty, taux = moe.moe_forward(tp, tx, cfg)
    assert ty.dtype == tx.dtype and tuple(ty.shape) == x.shape
    _close(ty, jy, dt, cfg.d_model)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def _jax_keep(jp, jx, jcfg):
    """The reference's routing and kept-copy mask, step for step as
    ``repro/nn/moe.py:103-127``."""
    B, S, D = jx.shape
    T, E, K = B * S, jcfg.num_experts, jcfg.experts_per_token
    h = jnorm(jx, jp["norm"], jcfg).reshape(T, D)
    probs = jax.nn.softmax(h.astype(jnp.float32)
                           @ jp["router"].astype(jnp.float32), axis=-1)
    _, gate_ids = jax.lax.top_k(probs, K)
    eids = gate_ids.reshape(T * K)
    eids_s = eids[jnp.argsort(eids)]
    starts = jnp.searchsorted(eids_s, jnp.arange(E))
    pos = jnp.arange(T * K) - starts[eids_s]
    return np.asarray(gate_ids), np.asarray(pos < jmoe._capacity(jcfg, T))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_forward_drops_the_same_copies(dt):
    """capacity_factor 0.25 on both configs: 64 tokens x top-2 over 8
    experts meet capacity 8, so copies really drop — the same ones on both
    sides — and the outputs still agree."""
    jcfg, cfg = _configs(capacity_factor=0.25)
    tree = _moe_params(cfg, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    jp, tp, jx, tx = _both(tree, x, dt)
    jids, jkeep = _jax_keep(jp, jx, jcfg)
    T = x.shape[0] * x.shape[1]
    h = moe.norm(tx, tp["norm"], cfg).reshape(T, cfg.d_model)
    _, _, ids = moe._route(h, tp["router"], cfg.experts_per_token)
    _, keep, _ = moe.dispatch_plan(ids, cfg.num_experts,
                                   moe._capacity(cfg, T))
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert 0 < int((~keep).sum()) < keep.numel()
    jy, _ = jmoe.moe_forward(jp, jx, jcfg)
    ty, _ = moe.moe_forward(tp, tx, cfg)
    _close(ty, jy, dt, cfg.d_model)


# The decode paths, each run by itself (``moe._decode``) on the smoke
# config (8 experts, top 2): grouped at B 4 (the copies reach every
# expert), gather at B 3, dense by config.
DECODE_ARMS = {"grouped": 4, "gather": 3, "dense": 3}

# Which sparse decode path ran faster on an H100 (tools/moe_decode_ab.py,
# device time from CUDA graphs, bf16): (arch, changes to its config, the
# batches where the gather won, the batches where the grouped path won).
DECODE_MEASURED = [
    ("qwen3-moe-30b-a3b", {"num_experts": 128}, (1, 2, 3),
     (4, 6, 8, 12, 16, 24, 32)),
    ("qwen3-moe-30b-a3b", {"num_experts": 64}, (1, 2), (4, 8, 16)),
    ("qwen3-moe-30b-a3b", {"num_experts": 32}, (1,), (2, 4, 8)),
    ("mixtral-8x22b", {}, (), (1, 2, 3, 4, 8, 16)),
]


@pytest.mark.parametrize("arch,changes,gather,grouped", DECODE_MEASURED,
                         ids=["qwen3_e128", "qwen3_e64", "qwen3_e32",
                              "mixtral"])
def test_decode_path_takes_the_measured_faster_path(arch, changes, gather,
                                                    grouped):
    """At the published widths ``decode_path`` chooses, at every measured
    batch, the path that ran faster on the card (the experts' bf16 weights'
    bytes, as ``moe_decode`` counts them); ``moe_dense_decode`` is always
    dense."""
    cfg = dataclasses.replace(get_config(arch), **changes)
    E = cfg.num_experts
    weight_bytes = 3 * E * cfg.d_model * cfg.moe_d_ff * 2
    for B in gather:
        assert moe.decode_path(cfg, B, E, weight_bytes) == "gather", B
    for B in grouped:
        assert moe.decode_path(cfg, B, E, weight_bytes) == "grouped", B
    dcfg = dataclasses.replace(cfg, moe_dense_decode=True)
    assert moe.decode_path(dcfg, max(grouped), E, weight_bytes) == "dense"


@pytest.mark.parametrize("B", [1, 4, 16])
def test_moe_decode_counts_the_path_it_takes(B, metrics):
    """``moe_decode`` runs ``decode_path``'s choice for its batch and the
    params' experts and counts one ``moe_decode_calls`` under it: at the
    smoke width the gather (the grouped path's fixed cost outweighs
    gathering experts this small), under ``moe_dense_decode`` dense."""
    for dense in (False, True):
        _, cfg = _configs(moe_dense_decode=dense)
        x = np.random.default_rng(7).standard_normal(
            (B, 1, cfg.d_model)).astype(np.float32)
        _, tp, _, tx = _both(_moe_params(cfg, seed=6), x, "f32")
        path = moe.decode_path(cfg, B, cfg.num_experts,
                               moe._weight_bytes(tp))
        assert path == ("dense" if dense else "gather")
        metrics.clear()
        torch.testing.assert_close(moe.moe_decode(tp, tx, cfg),
                                   moe._decode(tp, tx, cfg, path))
        assert _count(metrics, "moe_decode_calls", path=path) == 2
        assert _count(metrics, "moe_decode_calls") == 2


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("path", list(DECODE_ARMS))
def test_moe_decode_matches_jax(path, dt):
    """Each decode path, run by itself at its own batch, against the
    reference's decode (the gather, or the dense branch under
    ``moe_dense_decode``)."""
    jcfg, cfg = _configs(moe_dense_decode=path == "dense")
    B = DECODE_ARMS[path]
    tree = _moe_params(cfg, seed=6)
    x = np.random.default_rng(7).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    jp, tp, jx, tx = _both(tree, x, dt)
    want = jmoe.moe_decode(jp, jx, jcfg)
    got = moe._decode(tp, tx, cfg, path)
    assert got.dtype == tx.dtype and tuple(got.shape) == x.shape
    _close(got, want, dt, cfg.d_model)


def test_moe_decode_branches_agree():
    """With ample capacity every decode path computes the same f32
    function: at B 4 and at B 1, each sparse path taken by itself against
    the dense branch."""
    _, cfg = _configs()
    _, dcfg = _configs(moe_dense_decode=True)
    tree = _moe_params(cfg, seed=8)
    for B in (4, 1):
        x = np.random.default_rng(9).standard_normal(
            (B, 1, cfg.d_model)).astype(np.float32)
        _, tp, _, tx = _both(tree, x, "f32")
        want = moe.moe_decode(tp, tx, dcfg)
        for path in ("grouped", "gather"):
            got = moe._decode(tp, tx, cfg, path)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_decode_grouped_drops_nothing(dt):
    """A router rigged so that every token picks experts 0 and 1: each of
    the two holds all B copies (a prefill's capacity at B 16 would keep 8),
    the decode's capacity B keeps every one, and the grouped path equals
    the gather path (bf16: both round each product once, in another
    order)."""
    _, cfg = _configs()
    B, D, K = 16, cfg.d_model, cfg.experts_per_token
    assert moe._capacity(cfg, B) < B
    tree = _moe_params(cfg, seed=10)
    v = np.ones(D, np.float32) / math.sqrt(D)
    tree["router"] = np.zeros((D, cfg.num_experts), np.float32)
    tree["router"][:, 0] = 8 * v
    tree["router"][:, 1] = 4 * v
    rng = np.random.default_rng(11)
    x = (4 * v + 0.1 * rng.standard_normal((B, 1, D))).astype(np.float32)
    _, tp, _, tx = _both(tree, x, dt)
    h = moe.norm(tx, tp["norm"], cfg).reshape(B, D)
    _, _, ids = moe._route(h, tp["router"], K)
    assert ids.tolist() == [[0, 1]] * B
    _, keep, _ = moe.dispatch_plan(ids, cfg.num_experts, B)
    assert bool(keep.all())
    got = moe._decode(tp, tx, cfg, "grouped")
    want = moe._decode(tp, tx, cfg, "gather")
    _close(got, want.float().numpy(), dt, D)
    assert float(got.float().abs().min()) > 0     # no token's sum is empty


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("path", list(DECODE_ARMS))
def test_moe_decode_spans_count_the_gathered_bytes(path, dt, metrics):
    """Under a tracer each path, run at its own batch, nests its spans
    under the caller's: the gather path's ``moe.gather`` records B·K·3·D·F
    items of the weights' size in ``gathered_bytes``, beside
    ``moe.experts``; the grouped path has ``moe.dispatch`` then
    ``moe.experts`` (``weight_bytes`` E·3·D·F items, no gather); the dense
    branch ``moe.experts`` alone.  Each call counts one
    ``moe_decode_calls`` under its path."""
    from repro_torch.obs import trace as obs_trace
    _, cfg = _configs(moe_dense_decode=path == "dense")
    B, K = DECODE_ARMS[path], cfg.experts_per_token
    x = np.random.default_rng(7).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    _, tp, _, tx = _both(_moe_params(cfg, seed=6), x, dt)
    tr = obs_trace.Tracer()
    prev = obs_trace.set_tracer(tr)
    try:
        with obs_trace.span("moe") as outer:
            moe._decode(tp, tx, cfg, path)
            moe._decode(tp, tx, cfg, path)
    finally:
        obs_trace.set_tracer(prev)
    kids = [s for s in tr.spans if s.parent == outer.sid]
    names = {"grouped": ["moe.dispatch", "moe.experts"],
             "gather": ["moe.gather", "moe.experts"],
             "dense": ["moe.experts"]}[path]
    assert [s.name for s in kids] == names * 2
    item = torch.empty((), dtype=DTYPES[dt][1]).element_size()
    weights = 3 * cfg.d_model * cfg.moe_d_ff * item
    gathers = [s.args["gathered_bytes"] for s in kids
               if s.name == "moe.gather"]
    assert gathers == ([B * K * weights] * 2 if path == "gather" else [])
    experts = [s.args for s in kids if s.name == "moe.experts"]
    if path == "grouped":
        assert experts == [{"path": "grouped",
                            "weight_bytes": cfg.num_experts * weights}] * 2
    assert all(None not in s.device for s in kids)
    for arm in DECODE_ARMS:
        assert _count(metrics, "moe_decode_calls", path=arm) \
            == (2 if arm == path else 0)


def test_moe_forward_grouped_raises():
    """``moe_local_dispatch`` takes the grouped (per-data-shard) dispatch
    only under a mesh whose data axis exceeds 1, as the reference does
    (``repro/nn/moe.py:62-69``): with no mesh the flat dispatch runs and
    gives the reference's output.  The grouped path no longer raises (it
    was ROADMAP A5b): with ``dp`` groups it equals the reference's
    ``_moe_forward_grouped`` on the same tokens (on real data ranks in
    ``tests/test_torch_dp.py``)."""
    jcfg, cfg = _configs(moe_local_dispatch=True)
    tree = _moe_params(cfg)
    x = np.random.default_rng(2).standard_normal(
        (2, 4, cfg.d_model)).astype(np.float32)
    jp, tp, jx, tx = _both(tree, x, "f32")
    jy, jaux = jmoe.moe_forward(jp, jx, jcfg)
    ty, taux = moe.moe_forward(tp, tx, cfg)
    _close(ty, jy, "f32", cfg.d_model)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    for dp in (2, 4):
        jy, jaux = jmoe._moe_forward_grouped(jp, jx, jcfg, dp)
        ty, taux = moe._moe_forward_grouped(tp, tx, cfg, dp)
        _close(ty, jy, "f32", cfg.d_model)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
