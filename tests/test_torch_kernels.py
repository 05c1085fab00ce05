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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [112, 160])
def test_flash_attention_matches_pallas_at_wide_head_dims(d, causal):
    """zamba2-7b's head dim (112) and stablelm-12b's (160), neither a whole
    64-column chunk of the Hopper kernel's tiles, against the TPU kernel
    in interpret mode (GQA, ragged Sq)."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 4, 70, d)).astype(np.float32)
    k = rng.standard_normal((1, 2, 70, d)).astype(np.float32)
    v = rng.standard_normal((1, 2, 70, d)).astype(np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                blocks=(128, 128),
                                backend="pallas_interpret")
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-5)


def test_flash_head_dim_rule_covers_both_registries():
    """Every full-size head dim of the JAX registry and every head dim of
    the port's registry (full and smoke) is one the kernels take (a
    multiple of 8 up to 256); others raise with the rule.  stablelm-12b's
    smoke config (d 20) is the one off the rule: its 40-byte rows are no
    TMA stride, so it runs on the CPU only.  The legal block pairs are the
    ones the launcher instantiates: at a padded head dim above 128 only
    64-key blocks."""
    from repro.configs.registry import ARCH_IDS as JARCH_IDS
    from repro.configs.registry import get_config as jget_config
    from repro_torch.configs.registry import ARCH_IDS, get_config
    full = {jget_config(a).head_dim for a in JARCH_IDS} - {0}
    ported = {get_config(a, smoke=s).head_dim for a in ARCH_IDS
              for s in (False, True)} - {0}
    assert full == {64, 112, 128, 160}
    assert ported == {16, 20, 32, 64, 112, 128, 160}
    for d in full | ported - {20}:
        kfa.check_head_dim(d)
    assert jget_config("stablelm-12b", smoke=True).head_dim == 20
    assert get_config("stablelm-12b", smoke=True).head_dim == 20
    for bad in (12, 20, 100, 264):
        with pytest.raises(ValueError, match="multiple of 8 up to 256"):
            kfa.check_head_dim(bad)
    for d in kfa.HEAD_DIMS:
        legal = {(bq, bkv) for bq in kfa.BLOCK_MENU for bkv in kfa.BLOCK_MENU
                 if kfa.legal_blocks(bq, bkv, d)}
        assert (64, 64) in legal
        if kfa.padded_head_dim(d) > 128:
            assert all(bkv == 64 for _, bkv in legal), (d, legal)


def _registry_head_dims():
    """The head dims of both registries the kernels take (all but
    stablelm-12b's smoke 20, a CPU-only config)."""
    from repro.configs.registry import ARCH_IDS as JARCH_IDS
    from repro.configs.registry import get_config as jget_config
    from repro_torch.configs.registry import ARCH_IDS, get_config
    full = {jget_config(a).head_dim for a in JARCH_IDS} - {0}
    ported = {get_config(a, smoke=s).head_dim for a in ARCH_IDS
              for s in (False, True)} - {0}
    return {d for d in full | ported if d in kfa.HEAD_DIMS}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_bwd_route_covers_both_registries(dtype):
    """The backward's route follows the dtype alone: every head dim of
    both registries (and every one the kernels take) runs the wgmma
    kernels in bf16 and the split-TF32 kernels in f32, both with 64 kv
    rows a dK/dV CTA and 64 q rows a dQ CTA; every launch's shared memory
    fits the 227 KB a block may opt into."""
    dims = _registry_head_dims()
    assert dims == {16, 32, 64, 112, 128, 160}
    for d in sorted(dims | set(kfa.HEAD_DIMS)):
        plan = kfa.plan_attention_bwd(300, 300, d, batch=1, heads=8,
                                      kv_heads=2, in_dtype=dtype)
        assert plan.kv_smem <= 232448 and plan.q_smem <= 232448, plan
        # a bf16 dK/dV CTA a kv head, an f32 one a q head
        route, kv_ctas = (("tf32x3", 40) if dtype == "float32"
                          else ("wgmma", 10))
        assert (plan.route, plan.kv_block, plan.q_block, plan.sq_pad,
                plan.kv_ctas, plan.q_ctas) == (route, 64, 64, 320,
                                               kv_ctas, 40), plan
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        kfa.plan_attention_bwd(64, 64, 20)
    with pytest.raises(ValueError, match="no route for float16"):
        kfa.plan_attention_bwd(64, 64, 64, in_dtype="float16")


def test_flash_bwd_plan_at_phi4_train_shape():
    """phi4-mini's training attention, (4, 24/8, 512, 128) in bf16: the
    plan's tiles, grids and shared bytes; and the grids at a ragged S
    shorter than one 64-row block."""
    plan = kfa.plan_attention_bwd(512, 512, 128, batch=4, heads=24,
                                  kv_heads=8)
    assert plan == kfa.BwdPlan(
        route="wgmma", kv_block=64, q_block=64, sq_pad=512, kv_ctas=256,
        q_ctas=768, kv_smem=1024 + 98304 + 1024 + 40,
        q_smem=1024 + 98304 + 40)
    short = kfa.plan_attention_bwd(40, 40, 64, heads=8, kv_heads=2)
    assert (short.sq_pad, short.kv_ctas, short.q_ctas) == (64, 2, 8)
    assert kfa.plan_attention_bwd(77, 77, 128, heads=8,
                                  kv_heads=2).q_ctas == 16


def test_tma_operand_check_refuses_misaligned_strides():
    """The bf16 kernels read q, k, v and dO in place by TMA: a stride that
    is no 16-byte multiple raises instead of being copied."""
    x = torch.zeros((1, 2, 8, 24), dtype=torch.bfloat16)
    kfa.check_tma_operands("t", q=x, v=x.transpose(1, 2))
    shifted = torch.zeros(385, dtype=torch.bfloat16)[1:].view(1, 2, 8, 24)
    with pytest.raises(ValueError, match="do strides"):
        kfa.check_tma_operands("t", do=shifted)
    with pytest.raises(ValueError, match="q strides"):
        kfa.check_tma_operands("t", q=torch.zeros((1, 2, 8, 20),
                                                  dtype=torch.bfloat16))


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
    the ladder driven for a CUDA device with every tiled rung failing
    raises (no card is here, so the launch is a stand-in that fails).
    Meta tensors take the plain versions (the dry-run's device), so they
    are no stand-in for the card: a meta product is a meta tensor of the
    product's shape."""
    sel = select_gemm_config(40, 96, 64, hw=GPU_H100_LIKE)

    def launch(cfg):
        raise RuntimeError("every tiled launch fails")

    def reference():
        raise AssertionError("the plain version was served off the CPU")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegradedModeWarning)
        with pytest.raises(RuntimeError, match="never serves the plain"):
            ops._launch_fail_soft(launch, reference, sel.config, sel,
                                  GPU_H100_LIKE, (40, 96, 64),
                                  torch.device("cuda", 0))
    a = torch.empty((40, 64), device="meta")
    b = torch.empty((64, 96), device="meta")
    out = ops.matmul(a, b)
    assert out.device.type == "meta" and tuple(out.shape) == (40, 96)


class _Elsewhere:
    """A tensor stand-in on a device no wrapper takes: neither a device
    of the plain versions (the CPU, meta) nor CUDA."""
    device = torch.device("xpu")


def test_wrappers_refuse_other_devices():
    a = _Elsewhere()
    with pytest.raises(ValueError, match="unsupported device"):
        kmm.tiled_matmul(a, a, TileConfig(32, 32, 32),
                         out_dtype=torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        kfa.flash_attention_kernel(a, a, a, block_q=64, block_kv=64)
