"""The port's kernel ops against the JAX package's on shared numpy inputs.

On this CPU host the port's wrappers compute with their plain versions; the
JAX side runs the real Pallas kernel bodies in interpret mode with the same
TileConfig / blocks, so each case holds the port's semantics (epilogue
order, padding, GQA, masks) against the TPU kernel's.  Tolerances are
``tests/test_kernels.py``'s: GEMM f32 rtol 1e-5 / atol 1e-4·√K, bf16
rtol 3e-2 / atol 0.3·√K; attention f32 rtol 1e-4 / atol 2e-5.

``tests/test_torch_gpu.py`` holds the CUDA kernels against their plain
versions on the card.
"""
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Epilogue as JEpilogue
from repro.core import TileConfig as JTileConfig
from repro.kernels import ops as jops
from repro.nn import attention as jattn
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import Epilogue, TileConfig
from repro_torch.core.selector import select_gemm_config
from repro_torch.core.topology import DegradedModeWarning
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.nn import attention as tattn
from repro_torch.obs import metrics as obs_metrics

EPILOGUES = [
    Epilogue(),
    Epilogue(bias=True),
    Epilogue(activation="gelu"),
    Epilogue(activation="silu"),
    Epilogue(activation="swiglu_gate"),
    Epilogue(residual=True),
    Epilogue(bias=True, activation="swiglu_gate", residual=True),
]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt, K):
    if dt == "f32":
        return 1e-5, 1e-4 * math.sqrt(K)
    return 3e-2, 0.3 * math.sqrt(K)


def _jep(ep):
    return JEpilogue(bias=ep.bias, activation=ep.activation,
                     residual=ep.residual)


def _jcfg(c):
    return JTileConfig(bm=c.bm, bn=c.bn, bk=c.bk, split_k=c.split_k,
                       group_m=c.group_m, schedule=c.schedule)


def _gemm_case(M, N, K, ep, dt, cfg=None, seed=0, out="f32"):
    rng = np.random.default_rng(seed)
    arrs = {"a": rng.standard_normal((M, K)),
            "b": rng.standard_normal((K, N))}
    if ep.bias:
        arrs["bias"] = rng.standard_normal(N)
    if ep.activation == "swiglu_gate":
        arrs["gate"] = rng.standard_normal((M, N))
    if ep.residual:
        arrs["residual"] = rng.standard_normal((M, N))
    jdt, tdt = DTYPES[dt]
    if cfg is None:
        cfg = select_gemm_config(M, N, K, in_dtype=str(tdt)[6:],
                                 out_dtype="float32", epilogue=ep,
                                 hw=GPU_H100_LIKE).config
    j = {k: jnp.asarray(v.astype(np.float32), dtype=jdt)
         for k, v in arrs.items()}
    t = {k: torch.from_numpy(v.astype(np.float32)).to(tdt)
         for k, v in arrs.items()}
    jout, tout = DTYPES[out]
    want = jops.matmul(j.pop("a"), j.pop("b"), out_dtype=jout,
                       backend="pallas_interpret", config=_jcfg(cfg),
                       epilogue=_jep(ep), **j)
    got = ops.matmul(t.pop("a"), t.pop("b"), out_dtype=tout, epilogue=ep,
                     config=cfg, **t)
    assert got.dtype == tout and tuple(got.shape) == (M, N)
    rtol, atol = _tol(dt, K)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(128, 128, 128), (100, 300, 77),
                                   (8, 256, 512)],
                         ids=["aligned", "ragged", "skinny"])
@pytest.mark.parametrize("ep", EPILOGUES, ids=str)
def test_matmul_matches_pallas(ep, shape, dt):
    _gemm_case(*shape, ep, dt)


def test_matmul_bf16_output_matches_pallas():
    _gemm_case(96, 256, 320, Epilogue(residual=True), "bf16", out="bf16")


def test_matmul_grouped_ragged_final_group():
    # Tm = 6 row tiles in groups of 4: the last group has 2 rows.
    _gemm_case(333, 200, 264, Epilogue(activation="swiglu_gate"), "bf16",
               cfg=TileConfig(bm=64, bn=64, bk=64, group_m=4))


def test_matmul_split_k():
    _gemm_case(64, 128, 2048, Epilogue(), "bf16",
               cfg=TileConfig(bm=64, bn=128, bk=256, split_k=4))


def test_matmul_stream_k_schedule():
    _gemm_case(4, 3072, 1024, Epilogue(residual=True), "f32",
               cfg=TileConfig(bm=32, bn=256, bk=128, schedule="stream_k"))


def test_matmul_leading_dims_fold():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 3, 16, 64)).astype(np.float32)
    b = rng.standard_normal((64, 48)).astype(np.float32)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), backend="reference")
    assert tuple(got.shape) == (2, 3, 16, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# Flash attention and decode attention.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads,s_q,s_kv", [
    ((4, 2), 64, 64),          # GQA, one block
    ((4, 2), 100, 100),        # GQA, ragged Sq
    ((2, 2), 130, 130),        # MHA, ragged past one block
], ids=["gqa", "gqa-ragged", "mha-ragged"])
def test_flash_attention_matches_pallas(heads, s_q, s_kv, causal):
    H, Hkv = heads
    rng = np.random.default_rng(s_q)
    q = rng.standard_normal((2, H, s_q, 16)).astype(np.float32)
    k = rng.standard_normal((2, Hkv, s_kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, Hkv, s_kv, 16)).astype(np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                blocks=(128, 128),
                                backend="pallas_interpret")
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("gqa_packed", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_attention_matches_jax(per_slot, gqa_packed):
    rng = np.random.default_rng(7)
    B, H, Hkv, S, d = 3, 4, 2, 24, 16
    q = rng.standard_normal((B, H, 1, d)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    pos = np.array([3, 17, 23], np.int32) if per_slot else np.int32(11)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), pos=jnp.asarray(pos),
                                  gqa_packed=gqa_packed)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc),
                                 pos=torch.as_tensor(pos, dtype=torch.int64),
                                 gqa_packed=gqa_packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# Fail-soft launch: retry, fallback ladder, and no plain fallback off-CPU.
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


def _operands(M=40, N=96, K=64, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)))


def test_ladder_walks_to_next_rung_with_same_output(metrics):
    a, b, res = _operands()
    clean = ops.matmul(a, b, residual=res)
    primary = select_gemm_config(40, 96, 64, in_dtype="float32",
                                 out_dtype="float32",
                                 epilogue=Epilogue(residual=True),
                                 hw=GPU_H100_LIKE).config
    tried = []

    def injector(cfg):
        tried.append(cfg)
        if cfg == primary:
            raise RuntimeError("injected deterministic launch failure")

    prev = ops.set_launch_fault_injector(injector)
    try:
        with pytest.warns(DegradedModeWarning):
            got = ops.matmul(a, b, residual=res)
    finally:
        ops.set_launch_fault_injector(prev)
    assert tried[0] == primary and len(tried) == 2 and tried[1] != primary
    torch.testing.assert_close(got, clean, rtol=0, atol=0)
    assert _count(metrics, "fallback_rungs", rung="next") == 1
    assert _count(metrics, "launch_validation_failures") == 1
    assert _count(metrics, "selection_rejected") == 1
    assert _count(metrics, "launch_retries") == 0


def test_transient_launch_fault_is_retried(metrics):
    a, b, _ = _operands()
    fired = []

    def injector(cfg):
        if not fired:
            fired.append(cfg)
            raise RuntimeError("transient: injected launch fault")

    prev = ops.set_launch_fault_injector(injector)
    try:
        got = ops.matmul(a, b)
    finally:
        ops.set_launch_fault_injector(prev)
    torch.testing.assert_close(got, a @ b, rtol=1e-5, atol=1e-4)
    assert _count(metrics, "launch_retries") == 1
    assert _count(metrics, "fallback_rungs") == 0


def test_cpu_last_rung_serves_plain_version(metrics):
    a, b, _ = _operands()

    def injector(cfg):
        raise RuntimeError("every tiled launch fails")

    prev = ops.set_launch_fault_injector(injector)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DegradedModeWarning)
            got = ops.matmul(a, b)
    finally:
        ops.set_launch_fault_injector(prev)
    torch.testing.assert_close(got, a @ b, rtol=1e-5, atol=1e-4)
    assert _count(metrics, "fallback_rungs", rung="reference") == 1


def test_last_rung_raises_off_cpu():
    """Off the CPU the ladder ends in an error, never in the plain version:
    meta tensors reach no kernel, so every tiled rung fails."""
    a = torch.empty((40, 64), device="meta")
    b = torch.empty((64, 96), device="meta")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegradedModeWarning)
        with pytest.raises(RuntimeError, match="never serves the plain"):
            ops.matmul(a, b)


def test_wrappers_refuse_other_devices():
    a = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kmm.tiled_matmul(a, a.t(), TileConfig(32, 32, 32),
                         out_dtype=torch.float32)
    q = torch.empty((1, 2, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kfa.flash_attention_kernel(q, q, q, block_q=64, block_kv=64)
