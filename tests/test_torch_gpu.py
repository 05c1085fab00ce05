"""The port's CUDA kernels (dense and grouped GEMM, forward and backward,
flash attention, the calibration probes) against their plain versions, on
the card.

Marked ``gpu``; each test skips on a host without CUDA.  The file imports
only torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

GEMM tolerances are ``tests/test_kernels.py``'s (f32 rtol 1e-5 /
atol 1e-4·√K, bf16 rtol 3e-2 / atol 0.3·√K).  Attention compares bf16
outputs at rtol 2e-2 / atol 1e-2, because the kernel rounds P to bf16
before P·V where the plain version keeps it in f32, and f32 outputs at the
attention f32 tolerance (rtol 1e-4 / atol 2e-5).  The probe kernels'
checksums sum integers and must equal their plain versions' exactly.
"""
import math

import pytest
import torch

from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import Epilogue, TileConfig
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.kernels import probes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _tol(dtype, K):
    if dtype == torch.float32:
        return 1e-5, 1e-4 * math.sqrt(K)
    return 3e-2, 0.3 * math.sqrt(K)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,cfg,ep,dtype", [
    (4, 3072, 3072, TileConfig(32, 256, 128, schedule="stream_k"),
     Epilogue(residual=True), torch.bfloat16),
    (512, 3072, 3072, TileConfig(256, 128, 128), Epilogue(residual=True),
     torch.bfloat16),
    (520, 1000, 3072, TileConfig(256, 256, 32),
     Epilogue(activation="swiglu_gate"), torch.bfloat16),
    (333, 200, 264, TileConfig(64, 64, 64, group_m=4),
     Epilogue(residual=True), torch.bfloat16),
    (100, 300, 77, TileConfig(32, 32, 32),
     Epilogue(bias=True, activation="gelu"), torch.float32),
], ids=str)
def test_gemm_kernel_on_card(cuda, M, N, K, cfg, ep, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)
    kw = {}
    if ep.bias:
        kw["bias"] = rnd(N)
    if ep.activation == "swiglu_gate":
        kw["gate"] = rnd(M, N)
    if ep.residual:
        kw["residual"] = rnd(M, N)
    a, b = rnd(M, K), rnd(K, N)
    n0 = kmm.tiled_matmul.launches
    got = kmm.tiled_matmul(a, b, cfg, out_dtype=dtype, epilogue=ep, **kw)
    want = kmm.matmul_plain(a, b, cfg, out_dtype=dtype, epilogue=ep, **kw)
    torch.cuda.synchronize()
    assert kmm.tiled_matmul.launches == n0 + 1
    rtol, atol = _tol(dtype, K)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# The persistent scheduler's partitions: stream-K strips and split-K shard
# ranges that do not line up with tiles (partials from several CTAs per
# tile), split-K with one CTA per shard, and the f32 path under both.
SCHEDULE_CASES = [
    (4, 3072, 3072, TileConfig(32, 256, 128, schedule="stream_k"),
     Epilogue(activation="swiglu_gate"), torch.bfloat16),
    (512, 3072, 8192, TileConfig(256, 128, 128, group_m=2,
                                 schedule="stream_k"),
     Epilogue(residual=True), torch.bfloat16),
    (300, 1000, 1000, TileConfig(128, 64, 64, group_m=4,
                                 schedule="stream_k"),
     Epilogue(bias=True), torch.bfloat16),
    (100, 1000, 1000, TileConfig(64, 128, 64, split_k=4),
     Epilogue(activation="gelu"), torch.bfloat16),
    (384, 4096, 1024, TileConfig(128, 128, 64, split_k=4),
     Epilogue(), torch.bfloat16),
    (4, 8192, 3072, TileConfig(32, 128, 32, split_k=8),
     Epilogue(residual=True), torch.bfloat16),
    (100, 300, 1000, TileConfig(64, 64, 32, schedule="stream_k"),
     Epilogue(residual=True), torch.float32),
    (64, 200, 1000, TileConfig(32, 64, 64, split_k=8),
     Epilogue(activation="silu"), torch.float32),
]


def _gemm_operands(dev, M, N, K, ep, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    kw = {}
    if ep.bias:
        kw["bias"] = rnd(N)
    if ep.activation == "swiglu_gate":
        kw["gate"] = rnd(M, N)
    if ep.residual:
        kw["residual"] = rnd(M, N)
    return rnd(M, K), rnd(K, N), kw


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,cfg,ep,dtype", SCHEDULE_CASES, ids=str)
def test_gemm_schedules_on_card(cuda, M, N, K, cfg, ep, dtype):
    """Each partition against the plain version, launched twice: the fixup
    sums partials in k order, so the two outputs are bitwise equal, and the
    flags are all down again after the launch."""
    plan = kmm.work_plan(M, N + (-N) % 8, K + (-K) % 8, cfg, 1,
                         kmm._sm_count(cuda.index))
    assert plan.partials > 0
    a, b, kw = _gemm_operands(cuda, M, N, K, ep, dtype)
    got = kmm.tiled_matmul(a, b, cfg, out_dtype=dtype, epilogue=ep, **kw)
    again = kmm.tiled_matmul(a, b, cfg, out_dtype=dtype, epilogue=ep, **kw)
    want = kmm.matmul_plain(a, b, cfg, out_dtype=dtype, epilogue=ep, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _flags_down()
    rtol, atol = _tol(dtype, K)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [
    TileConfig(64, 128, 128, schedule="stream_k"),
    TileConfig(64, 128, 128, split_k=8),
    TileConfig(32, 256, 128, schedule="stream_k"),
], ids=str)
def test_grouped_schedules_on_card(cuda, cfg):
    """Grouped stream-K and split-K: strips cross expert boundaries."""
    ep = Epilogue(activation="swiglu_gate")
    x, w, kw = _expert_operands(cuda, 16, 40, 768, 2048, ep, torch.bfloat16,
                                seed=5)
    plan = kmm.work_plan(40, 768, 2048, cfg, 16, kmm._sm_count(cuda.index))
    assert plan.partials > 0
    got = kmm.tiled_expert_matmul(x, w, cfg, out_dtype=torch.bfloat16,
                                  epilogue=ep, **kw)
    again = kmm.tiled_expert_matmul(x, w, cfg, out_dtype=torch.bfloat16,
                                    epilogue=ep, **kw)
    want = kmm.expert_matmul_plain(x, w, cfg, out_dtype=torch.bfloat16,
                                   epilogue=ep, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    rtol, atol = _tol(torch.bfloat16, 2048)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
def test_gemm_replays_in_a_cuda_graph(cuda):
    """A split launch captured in a CUDA graph replays twice with the eager
    launch's bits: the capture stream has a fixup scratch of its own, and
    the flags are down again at the end of every launch."""
    cfg = TileConfig(32, 256, 128, schedule="stream_k")
    ep = Epilogue(residual=True)
    a, b, kw = _gemm_operands(cuda, 4, 3072, 3072, ep, torch.bfloat16)
    eager = kmm.tiled_matmul(a, b, cfg, out_dtype=torch.bfloat16,
                             epilogue=ep, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kmm.tiled_matmul(a, b, cfg, out_dtype=torch.bfloat16, epilogue=ep,
                         **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kmm.tiled_matmul(a, b, cfg, out_dtype=torch.bfloat16,
                               epilogue=ep, **kw)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert _flags_down()


@pytest.mark.gpu
def test_split_launches_on_two_streams(cuda):
    """Split launches on two streams at once, small enough to run side by
    side: each stream has its own fixup flags, so every output equals the
    launch made alone, bitwise, and every flag is down at the end."""
    cfg = TileConfig(64, 128, 64, split_k=4)
    ep = Epilogue(residual=True)
    operands = [_gemm_operands(cuda, 64, 128, 2048, ep, torch.bfloat16,
                               seed=s) for s in (1, 2)]
    alone = [kmm.tiled_matmul(a, b, cfg, out_dtype=torch.bfloat16,
                              epilogue=ep, **kw) for a, b, kw in operands]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(50):
        for i, s in enumerate(streams):
            a, b, kw = operands[i]
            with torch.cuda.stream(s):
                outs[i].append(kmm.tiled_matmul(
                    a, b, cfg, out_dtype=torch.bfloat16, epilogue=ep, **kw))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, alone[i]) for o in outs[i])
    assert _flags_down()


def _flags_down():
    """Every stream's fixup flags are zero again."""
    return all(int(f.abs().sum()) == 0
               for _, _, f in kmm._SCRATCH.values())


# The qwen3-moe-30b-a3b prefill expert GEMMs (E 128, C 40 and 32, d_model
# 2048, expert d_ff 768) with their epilogues, then bias, residual, ragged
# C, a forced corner config and f32 inputs.
EXPERT_CASES = [
    (128, 40, 768, 2048, None, Epilogue(), torch.bfloat16),
    (128, 40, 768, 2048, None, Epilogue(activation="swiglu_gate"),
     torch.bfloat16),
    (128, 40, 2048, 768, None, Epilogue(), torch.bfloat16),
    (128, 32, 768, 2048, None, Epilogue(activation="swiglu_gate"),
     torch.bfloat16),
    (128, 32, 2048, 768, None, Epilogue(), torch.bfloat16),
    (128, 40, 768, 2048, None, Epilogue(bias=True), torch.bfloat16),
    (128, 32, 2048, 768, None, Epilogue(residual=True), torch.bfloat16),
    (128, 24, 768, 2048, None, Epilogue(activation="swiglu_gate"),
     torch.bfloat16),
    (16, 40, 768, 2048, TileConfig(256, 256, 32, group_m=4),
     Epilogue(activation="swiglu_gate"), torch.bfloat16),
    (8, 24, 200, 264, TileConfig(32, 32, 32), Epilogue(bias=True),
     torch.float32),
]


def _expert_operands(dev, E, M, N, K, ep, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    kw = {}
    if ep.bias:
        kw["bias"] = rnd(E, N)
    if ep.activation == "swiglu_gate":
        kw["gate"] = rnd(E, M, N)
    if ep.residual:
        kw["residual"] = rnd(E, M, N)
    return rnd(E, M, K), rnd(E, K, N), kw


@pytest.mark.gpu
@pytest.mark.parametrize("E,M,N,K,cfg,ep,dtype", EXPERT_CASES, ids=str)
def test_expert_kernel_on_card(cuda, E, M, N, K, cfg, ep, dtype):
    from repro_torch.core.selector import select_gemm_config
    if cfg is None:
        cfg = select_gemm_config(M, N, K, in_dtype=str(dtype)[6:],
                                 out_dtype=str(dtype)[6:], epilogue=ep,
                                 hw=GPU_H100_LIKE).config
    x, w, kw = _expert_operands(cuda, E, M, N, K, ep, dtype, seed=M + N)
    n0 = kmm.tiled_expert_matmul.launches
    got = kmm.tiled_expert_matmul(x, w, cfg, out_dtype=dtype, epilogue=ep,
                                  **kw)
    want = kmm.expert_matmul_plain(x, w, cfg, out_dtype=dtype, epilogue=ep,
                                   **kw)
    torch.cuda.synchronize()
    assert kmm.tiled_expert_matmul.launches == n0 + 1
    rtol, atol = _tol(dtype, K)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
def test_selected_expert_matmul_launches_the_kernel(cuda):
    """The selector-driven grouped op on CUDA tensors is one launch of the
    grouped kernel for all experts."""
    x, w, _ = _expert_operands(cuda, 128, 40, 768, 2048, Epilogue(),
                               torch.bfloat16, seed=3)
    w = w * 0.02
    n0, d0 = kmm.tiled_expert_matmul.launches, kmm.tiled_matmul.launches
    got = ops.expert_matmul(x, w)
    torch.cuda.synchronize()
    assert kmm.tiled_expert_matmul.launches == n0 + 1
    assert kmm.tiled_matmul.launches == d0
    want = torch.einsum("emk,ekn->emn", x.float(), w.float())
    rtol, atol = _tol(torch.bfloat16, 2048)
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


# The decode MoE at a reduced mixtral width: d_model 1,024, expert d_ff
# 2,048, 8 experts, top 2; at B 16 and at B 4 the B·K copies reach every
# expert and the grouped path runs.  Its outputs are O(1) (weights at std
# 1/√fan_in), so the layer is held at the bf16 rtol above with atol 3e-2,
# the layer tolerance of ``tests/test_torch_moe.py``.
@pytest.mark.gpu
@pytest.mark.parametrize("B", [16, 4])
def test_decode_moe_reads_the_experts_in_place_on_card(cuda, B):
    """The grouped decode launches the grouped kernel three times a call,
    gathers no expert weights (no ``moe.gather`` span, and the call's
    allocations stay under one gathered weight's B·K·D·F items), and
    matches the gather path."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.nn import moe
    from repro_torch.obs import trace as obs_trace
    cfg = dataclasses.replace(get_config("mixtral-8x22b", smoke=True),
                              d_model=1024, moe_d_ff=2048, num_experts=8,
                              experts_per_token=2)
    D, F, E, K = 1024, 2048, 8, 2
    g = torch.Generator(device=cuda).manual_seed(B)

    def rnd(*shape, fan_in):
        return (torch.randn(shape, generator=g, device=cuda)
                / math.sqrt(fan_in)).to(torch.bfloat16)
    p = {"norm": {"scale": torch.ones(D, device=cuda,
                                      dtype=torch.bfloat16)},
         "router": rnd(D, E, fan_in=D), "wg": rnd(E, D, F, fan_in=D),
         "wu": rnd(E, D, F, fan_in=D), "wd": rnd(E, F, D, fan_in=F)}
    x = rnd(B, 1, D, fan_in=1)
    assert moe.decode_path(cfg, B, E, moe._weight_bytes(p)) == "grouped"
    moe.moe_decode(p, x, cfg)                # selection and workspace
    torch.cuda.synchronize()
    n0, d0 = kmm.tiled_expert_matmul.launches, kmm.tiled_matmul.launches
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    tr = obs_trace.Tracer()
    prev = obs_trace.set_tracer(tr)
    try:
        got = moe.moe_decode(p, x, cfg)
        torch.cuda.synchronize()
    finally:
        obs_trace.set_tracer(prev)
    assert kmm.tiled_expert_matmul.launches == n0 + 3
    assert kmm.tiled_matmul.launches == d0
    assert [s.name for s in tr.spans if s.name.startswith("moe.")] \
        == ["moe.dispatch", "moe.experts"]
    assert torch.cuda.max_memory_allocated(cuda) - base < B * K * D * F * 2
    want = moe._decode(p, x, cfg, "gather")
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


# (B, H, Hkv, S, causal, blocks or None for the selector's, v as the model
# passes it: the transposed view of a (B, S, Hkv, d) tensor).
FLASH_CASES = [
    (2, 24, 8, 512, True, None, False),
    (2, 24, 8, 512, False, None, False),
    (2, 24, 8, 1000, True, None, False),
    (2, 24, 8, 1000, False, None, False),
    # the served prefill shapes: phi4-mini at both edges, qwen3-moe
    (1, 24, 8, 336, True, None, True),
    (1, 24, 8, 474, True, None, True),
    (1, 24, 8, 474, True, None, False),
    (1, 32, 4, 474, True, None, True),
    # a sequence shorter than one q block
    (1, 24, 8, 40, True, None, True),
    (1, 24, 8, 40, False, (128, 128), False),
] + [(1, 32, 4, 474, True, blocks, True) for blocks in
     ((64, 64), (64, 128), (128, 64), (128, 128))] + [
    (2, 24, 8, 300, False, blocks, False) for blocks in
    ((64, 64), (64, 128), (128, 64), (128, 128))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,causal,blocks,model_v", FLASH_CASES,
                         ids=str)
def test_flash_kernel_on_card(cuda, B, H, Hkv, S, causal, blocks, model_v):
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn((B, H, S, 128), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, Hkv, S, 128), generator=g, device=cuda).bfloat16()
    if model_v:
        v = torch.randn((B, S, Hkv, 128), generator=g,
                        device=cuda).bfloat16().transpose(1, 2)
    else:
        v = torch.randn((B, Hkv, S, 128), generator=g, device=cuda).bfloat16()
    bq, bkv = blocks or kfa.select_attention_blocks(
        S, S, 128, causal=causal, batch=B, heads=H, kv_heads=Hkv)
    n0 = kfa.flash_attention_kernel.launches
    got = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                     causal=causal)
    again = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                       causal=causal)
    want = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                               causal=causal)
    torch.cuda.synchronize()
    assert kfa.flash_attention_kernel.launches == n0 + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=1e-2)


# Every head dim of both registries at full and smoke size (16, 32, 64, 112,
# 128, 160) and the rule's ends (8, 256), in bf16 and f32, GQA and not,
# causal and not.  f32 is held at the attention f32 tolerance (rtol 1e-4,
# atol 2e-5: the kernel takes every product in split TF32, three TF32
# products of split operands, with the softmax and the sums in f32); bf16
# as above.
HEAD_DIM_CASES = [(d, dt, causal, heads)
                  for d in (8, 16, 32, 64, 112, 128, 160, 256)
                  for dt in (torch.bfloat16, torch.float32)
                  for causal in (True, False)
                  for heads in ((4, 2), (4, 4))]


def _attn_case(cuda, B, H, Hkv, S, d, dtype, seed, model_v=False):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, H, S, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Hkv, S, d), generator=g, device=cuda).to(dtype)
    if model_v:
        v = torch.randn((B, S, Hkv, d), generator=g,
                        device=cuda).to(dtype).transpose(1, 2)
    else:
        v = torch.randn((B, Hkv, S, d), generator=g, device=cuda).to(dtype)
    return q, k, v


def _attn_tol(dtype):
    return (dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32
            else dict(rtol=2e-2, atol=1e-2))


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype,causal,heads", HEAD_DIM_CASES, ids=str)
def test_flash_kernel_every_head_dim_on_card(cuda, d, dtype, causal, heads):
    H, Hkv = heads
    S = 200                                  # ragged past three 64-blocks
    q, k, v = _attn_case(cuda, 2, H, Hkv, S, d, dtype, seed=d,
                         model_v=causal)
    bq, bkv = kfa.select_attention_blocks(
        S, S, d, causal=causal, batch=2, heads=H, kv_heads=Hkv)
    n0 = kfa.flash_attention_kernel.launches
    got = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                     causal=causal)
    again = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                       causal=causal)
    want = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                               causal=causal)
    torch.cuda.synchronize()
    assert kfa.flash_attention_kernel.launches == n0 + 2
    assert got.dtype == dtype and tuple(got.shape) == (2, H, S, d)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("d", (8, 16, 32, 64, 112, 128, 160, 256))
@pytest.mark.parametrize("S,causal,heads", [(77, True, (4, 2)),
                                            (77, False, (4, 4)),
                                            (40, True, (4, 2))], ids=str)
def test_flash_f32_ragged_every_head_dim_on_card(cuda, d, S, causal, heads):
    """The split-TF32 forward at a ragged S (77: no multiple of the 64-row
    q block or of a ring stage's 64 or 32 keys, the last stage straddling
    the causal diagonal and the key end; 40: under one block), out and lse
    against the plain version, two launches bitwise equal."""
    H, Hkv = heads
    q, k, v = _attn_case(cuda, 2, H, Hkv, S, d, torch.float32, seed=d + S,
                         model_v=causal)
    n0 = kfa.flash_attention_kernel.launches
    got, lse = kfa.flash_attention_kernel(q, k, v, block_q=64, block_kv=64,
                                          causal=causal, return_lse=True)
    again, lse2 = kfa.flash_attention_kernel(q, k, v, block_q=64,
                                             block_kv=64, causal=causal,
                                             return_lse=True)
    want, lse_p = kfa.attention_plain(q, k, v, block_q=64, block_kv=64,
                                      causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert kfa.flash_attention_kernel.launches == n0 + 2
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    torch.testing.assert_close(got, want, **_attn_tol(torch.float32))
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_flash_f32_unaligned_view_raises(cuda):
    """cp.async reads q, k and v in place: a view whose base or strides are
    not 16-byte multiples raises instead of falling back or copying."""
    q, k, v = _attn_case(cuda, 1, 4, 4, 64, 64, torch.float32, seed=5)
    flat = torch.randn(q.numel() + 1, device=cuda)
    shifted = flat[1:].view(q.shape)            # base 4 bytes off
    n0 = kfa.flash_attention_kernel.launches
    with pytest.raises(ValueError, match="not aligned"):
        kfa.flash_attention_kernel(shifted, k, v, block_q=64, block_kv=64)
    odd = torch.randn((1, 4, 64, 66), device=cuda)[..., :64]   # row 66 floats
    with pytest.raises(ValueError, match="not aligned"):
        kfa.flash_attention_kernel(q, k, odd, block_q=64, block_kv=64)
    assert kfa.flash_attention_kernel.launches == n0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [112, 160])
def test_flash_every_legal_block_pair_at_odd_head_dims(cuda, d):
    """zamba2's (d 112) and stablelm's (d 160) head dims, whose last
    64-column chunk runs past d, at every pair the budgets admit."""
    q, k, v = _attn_case(cuda, 1, 8, 8, 300, d, torch.bfloat16, seed=7,
                         model_v=True)
    pairs = [(bq, bkv) for bq in kfa.BLOCK_MENU for bkv in kfa.BLOCK_MENU
             if kfa.legal_blocks(bq, bkv, d)]
    assert (64, 64) in pairs
    for bq, bkv in pairs:
        got = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                         causal=True)
        want = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                                   causal=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=1e-2)


@pytest.mark.gpu
def test_f32_flash_route_never_reaches_the_plain_version(cuda, monkeypatch):
    """An f32 model's prefill attention on the card launches the
    split-TF32 kernel: the plain version is not called, and a launch is
    counted."""
    from repro_torch.kernels import ref

    def refuse(*a, **kw):
        raise AssertionError("the plain attention ran on a CUDA tensor")
    monkeypatch.setattr(kfa, "attention_plain", refuse)
    monkeypatch.setattr(ref, "attention_ref", refuse)
    q, k, v = _attn_case(cuda, 1, 32, 32, 474, 112, torch.float32, seed=3)
    n0 = kfa.flash_attention_kernel.launches
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kfa.flash_attention_kernel.launches == n0 + 1
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 474])
@pytest.mark.parametrize("N,K", [(32, 1024), (128, 1024), (64, 3584),
                                 (112, 3584)], ids=str)
def test_narrow_mamba_gemms_on_card(cuda, M, N, K):
    """The mamba projections' narrow outputs (mamba2-370m in_dt N 32 and
    in_b/in_c N 128 at K 1024; zamba2-7b in_b/in_c N 64 and in_dt N 112 at
    K 3584), through the selector-driven op, at decode and prefill M."""
    g = torch.Generator(device=cuda).manual_seed(M + N)
    a = torch.randn((M, K), generator=g, device=cuda).bfloat16()
    w = (torch.randn((K, N), generator=g, device=cuda) * 0.02).bfloat16()
    n0 = kmm.tiled_matmul.launches
    got = ops.matmul(a, w)
    again = ops.matmul(a, w)
    torch.cuda.synchronize()
    assert kmm.tiled_matmul.launches == n0 + 2
    assert torch.equal(got, again)
    rtol, atol = _tol(torch.bfloat16, K)
    torch.testing.assert_close(got.float(), a.float() @ w.float(),
                               rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_selected_gemm_launches_the_kernel(cuda):
    """The selector-driven op on a CUDA tensor goes through the kernel:
    one launch, no fallback to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn((4, 3072), generator=g, device=cuda).bfloat16()
    w = (torch.randn((3072, 1024), generator=g, device=cuda) * 0.02
         ).bfloat16()
    n0 = kmm.tiled_matmul.launches
    got = ops.matmul(a, w)
    torch.cuda.synchronize()
    assert kmm.tiled_matmul.launches == n0 + 1
    want = a.float() @ w.float()
    rtol, atol = _tol(torch.bfloat16, 3072)
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


# (nbytes, window, n_chunks): fetches shared by groups of CTAs, fetches
# that wrap the window several times over the whole grid, four vectors a
# fetch one CTA each (the issue sweep's shape), and windows larger than an
# SM's shared memory (read through the L2 only), over the grid and in
# groups.
STREAM_CASES = [(1 << 20, 1 << 16, 8), (48 << 20, 116736, 16),
                (233472, 116736, 3000), (3 << 20, 1 << 24, 2),
                (600000, 466944, 5), (1 << 22, 1 << 20, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("nbytes,window,n_chunks", STREAM_CASES, ids=str)
def test_stream_probe_on_card(cuda, nbytes, window, n_chunks):
    x = probes.stream_data(window, cuda)
    n0 = probes.stream_read.launches
    got = probes.stream_read(x, nbytes, window, n_chunks)
    again = probes.stream_read(x, nbytes, window, n_chunks)
    assert probes.stream_read.launches == n0 + 2
    want = probes.stream_read_plain(x, nbytes, window, n_chunks)
    assert int(got) == int(want) == int(again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(probes.PROBE_DTYPES))
@pytest.mark.parametrize("n_atoms,n_parallel", [(1000, 132), (37, 3),
                                                (2112, 132), (301971, 132)])
def test_mma_probe_on_card(cuda, dtype, n_atoms, n_parallel):
    a, b = probes.mma_operands(dtype, cuda,
                               torch.Generator(device=cuda).manual_seed(1))
    n0 = probes.mma_chain.launches
    got = probes.mma_chain(a, b, n_atoms, n_parallel)
    again = probes.mma_chain(a, b, n_atoms, n_parallel)
    assert probes.mma_chain.launches == n0 + 2
    want = probes.mma_chain_plain(a, b, n_atoms, n_parallel)
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(probes.PROBE_DTYPES))
def test_wave_probe_on_card(cuda, dtype):
    a, b = probes.mma_operands(dtype, cuda,
                               torch.Generator(device=cuda).manual_seed(2))
    n0 = probes.wave_grid.launches
    got = probes.wave_grid(a, b, 133, 285)
    assert probes.wave_grid.launches == n0 + 1
    assert torch.equal(got, probes.wave_grid_plain(a, b, 133, 285))


# ---------------------------------------------------------------------------
# Training: the GEMM with a transposed operand read in place, the epilogue's
# backward and the flash backward, each against its plain version; then one
# loss and gradient of a smoke model on the kernels against the CPU.
# ---------------------------------------------------------------------------

# (M, N, K, config or None for the selector's) of products with A stored
# (K, M) ("tn": the weight gradient) or B stored (N, K) ("nt": the input
# gradient): phi4-mini's backward shapes at a small token count, the menu's
# corners, stream-K and split-K fixups, ragged N and K.
TRANS_CASES = [
    (3072, 1024, 256, None), (256, 3072, 8192, None),
    (512, 3072, 3072, TileConfig(256, 128, 128)),
    (64, 256, 512, TileConfig(32, 32, 32)),
    (512, 512, 1024, TileConfig(256, 256, 64)),
    (256, 1000, 1000, TileConfig(128, 64, 64, group_m=4,
                                 schedule="stream_k")),
    (128, 512, 2048, TileConfig(64, 128, 64, split_k=4)),
    (96, 200, 264, TileConfig(64, 64, 32)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tn", "nt"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("M,N,K,cfg", TRANS_CASES, ids=str)
def test_gemm_transposed_operand_on_card(cuda, layout, dtype, M, N, K, cfg):
    from repro_torch.core.selector import select_gemm_config
    if cfg is None:
        cfg = select_gemm_config(M, N, K, in_dtype=str(dtype)[6:],
                                 out_dtype=str(dtype)[6:],
                                 hw=GPU_H100_LIKE).config
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randn((K, M) if layout == "tn" else (M, K), generator=g,
                    device=cuda).to(dtype)
    b = torch.randn((N, K) if layout == "nt" else (K, N), generator=g,
                    device=cuda).to(dtype)
    kw = dict(out_dtype=dtype, trans_a=layout == "tn",
              trans_b=layout == "nt")
    n0 = dict(kmm.tiled_matmul.layout_launches)
    got = kmm.tiled_matmul(a, b, cfg, **kw)
    again = kmm.tiled_matmul(a, b, cfg, **kw)
    want = kmm.matmul_plain(a, b, cfg, **kw)
    torch.cuda.synchronize()
    assert kmm.tiled_matmul.layout_launches[layout] == n0[layout] + 2
    assert got.shape == (M, N) and torch.equal(got, again)
    rtol, atol = _tol(dtype, K)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("ep", [
    Epilogue(activation="gelu"), Epilogue(activation="silu"),
    Epilogue(activation="swiglu_gate"), Epilogue(bias=True),
    Epilogue(bias=True, activation="gelu"),
    Epilogue(bias=True, activation="swiglu_gate", residual=True)], ids=str)
def test_epilogue_bwd_on_card(cuda, dtype, ep):
    M, N = 300, 520
    g = torch.Generator(device=cuda).manual_seed(5)
    dout = torch.randn((M, N), generator=g, device=cuda).to(dtype)
    z = torch.randn((M, N), generator=g, device=cuda) * 3
    gate = (torch.randn((M, N), generator=g, device=cuda).to(dtype)
            if ep.activation == "swiglu_gate" else None)
    kw = dict(epilogue=ep, gate=gate, dz_dtype=dtype, want_bias=ep.bias)
    zz = z if ep.activation else None
    n0 = kmm.epilogue_bwd.launches
    got = kmm.epilogue_bwd(dout, zz, **kw)
    again = kmm.epilogue_bwd(dout, zz, **kw)
    want = kmm.epilogue_bwd_plain(dout, zz, **kw)
    torch.cuda.synchronize()
    assert kmm.epilogue_bwd.launches == n0 + 2
    # f32: expf / tanhf against torch's within a few ulps; bf16 outputs
    # within one bf16 rounding; dbias sums M = 300 rows in another order.
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 1e-2)
    for x, y, w in zip(got, again, want):
        assert (x is None) == (w is None)
        if x is None:
            continue
        assert torch.equal(x, y)
        torch.testing.assert_close(x.float(), w.float(), rtol=rtol,
                                   atol=atol * (M if x.dim() == 1 else 1))


def _rel_l2(x, y):
    return float(torch.linalg.vector_norm(x.float() - y.float())
                 / torch.linalg.vector_norm(y.float()))


def _check_flash_bwd(cuda, dtype, B, H, Hkv, S, d, causal, seed,
                     do_view=False, window=0):
    """The forward's lse and the backward against the plain versions: f32
    within 1e-4 relative L2; bf16 within 2x the plain bf16 backward's
    distance from the plain f32 backward (the kernel rounds P and dS to
    bf16 before the wgmma products, the plain version keeps them f32).
    Two launches must be bitwise equal.  ``do_view``: dO as the transposed
    view of a (B, S, H, d) tensor, the layout autograd hands back through
    the model's head merge; ``window``: a sliding window in the forward
    and the backward."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(seed)
    q32 = torch.randn((B, H, S, d), generator=g, device=cuda)
    k32 = torch.randn((B, Hkv, S, d), generator=g, device=cuda)
    v32 = torch.randn((B, S, Hkv, d), generator=g, device=cuda).transpose(1, 2)
    do32 = (torch.randn((B, S, H, d), generator=g, device=cuda).transpose(1, 2)
            if do_view else torch.randn((B, H, S, d), generator=g,
                                        device=cuda))
    q, k, v, do = (t.to(dt) for t in (q32, k32, v32, do32))
    assert do.is_contiguous() != do_view
    bq, bkv = kfa.select_attention_blocks(S, S, d, causal=causal, batch=B,
                                          heads=H, kv_heads=Hkv,
                                          window=window)
    o, lse = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                        causal=causal, return_lse=True,
                                        window=window)
    o_p, lse_p = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                                     causal=causal, return_lse=True,
                                     window=window)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
    n0 = kfa.flash_attention_bwd_kernel.launches
    got, again = (kfa.flash_attention_bwd_kernel(
        q, k, v, o_p, lse_p, do, causal=causal, window=window)
        for _ in range(2))
    plain = kfa.attention_bwd_plain(q, k, v, o_p, lse_p, do, causal=causal,
                                    window=window)
    o32, lse32 = kfa.attention_plain(q.float(), k.float(), v.float(),
                                     block_q=bq, block_kv=bkv, causal=causal,
                                     return_lse=True, window=window)
    ref32 = kfa.attention_bwd_plain(q.float(), k.float(), v.float(), o32,
                                    lse32, do.float(), causal=causal,
                                    window=window)
    torch.cuda.synchronize()
    assert kfa.flash_attention_bwd_kernel.launches == n0 + 2
    plan = kfa.plan_attention_bwd(S, S, d, batch=B, heads=H, kv_heads=Hkv,
                                  in_dtype=dtype)
    assert plan.route == ("tf32x3" if dtype == "float32" else "wgmma")
    for x, y, p, r in zip(got, again, plain, ref32):
        assert torch.equal(x, y) and x.dtype == dt and x.shape == p.shape
        assert bool(torch.isfinite(x).all())
        if dtype == "float32":
            assert _rel_l2(x, p) <= 1e-4
        else:
            assert _rel_l2(x, r) <= 2 * _rel_l2(p, r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [16, 64, 112, 128, 160, 256])
@pytest.mark.parametrize("causal,Hkv", [(True, 2), (False, 8), (True, 8)],
                         ids=str)
def test_flash_bwd_on_card(cuda, dtype, d, causal, Hkv):
    """Every head dim in both dtypes, causal with GQA and without, at
    (2, 8, 200, d): see :func:`_check_flash_bwd`."""
    _check_flash_bwd(cuda, dtype, 2, 8, Hkv, 200, d, causal, seed=d + Hkv)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,H,Hkv,S,d,causal,do_view", [
    (4, 24, 8, 512, 128, True, False),   # phi4-mini's training attention
    (1, 8, 2, 40, 64, True, False),      # S shorter than one 64-row block
    (1, 8, 2, 77, 128, True, False),     # a ragged second block
    (1, 8, 2, 77, 112, False, False),
    (2, 24, 8, 300, 128, True, True),    # dO a transposed view
], ids=str)
def test_flash_bwd_shapes_on_card(cuda, dtype, B, H, Hkv, S, d, causal,
                                  do_view):
    """The backward at phi4-mini's training shape, at a ragged S and with a
    non-contiguous dO: see :func:`_check_flash_bwd`."""
    _check_flash_bwd(cuda, dtype, B, H, Hkv, S, d, causal, d + Hkv + S,
                     do_view)


@pytest.mark.gpu
def test_smoke_training_grads_on_card(cuda):
    """One f32 loss and gradient of phi4-mini's smoke config on the kernels
    (the f32 GEMM in every layout, the f32 flash forward and backward)
    against the same step's plain versions on the CPU: each leaf within
    1e-4 relative L2."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn.model import Model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_items, tree_map
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    opt = AdamW()
    want_loss, want = make_train_step(cpu, opt).loss_and_grads(
        params, {"tokens": tokens})
    gpu = Model(cfg, device=cuda)
    n0 = (dict(kmm.tiled_matmul.layout_launches),
          kfa.flash_attention_bwd_kernel.launches, kmm.epilogue_bwd.launches)
    loss, got = make_train_step(gpu, opt).loss_and_grads(
        tree_map(lambda t: t.to(cuda), params), {"tokens": tokens})
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert kmm.tiled_matmul.layout_launches["tn"] - n0[0]["tn"] == 7 * L
    assert kmm.tiled_matmul.layout_launches["nt"] - n0[0]["nt"] == 7 * L
    assert kfa.flash_attention_bwd_kernel.launches - n0[1] == L
    assert kmm.epilogue_bwd.launches - n0[2] == L
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for (path, x), (_, w) in zip(tree_items(got), tree_items(want)):
        assert _rel_l2(x.cpu(), w) <= 1e-4, path


MENU_TILES = [(bm, bn) for bm in (32, 64, 128, 256)
              for bn in (32, 64, 128, 256)]

# ---------------------------------------------------------------------------
# The grouped GEMM's backward: the grouped kernel with each expert's operand
# read transposed in place (dW_e = X_e^T dZ_e: x stored (E, C, K), "tn";
# dX_e = dZ_e W_e^T: w stored (E, K, N), "nt"), the grouped epilogue
# backward, and expert_matmul's autograd route end to end.
# ---------------------------------------------------------------------------

# (E, M, N, K, config or None for the selector's) of the per-expert product:
# qwen3-moe's training shapes (capacity 160, d_model 2048, expert d_ff 768)
# at 8 experts, a corner of the menu, stream-K and split-K strips that cross
# expert boundaries, ragged N and K.
GROUPED_TRANS_CASES = [
    (8, 2048, 768, 160, None), (8, 160, 2048, 768, None),
    (8, 768, 2048, 160, None), (8, 160, 768, 2048, None),
    (4, 512, 512, 256, TileConfig(256, 256, 64)),
    (16, 64, 256, 512, TileConfig(64, 128, 64, schedule="stream_k")),
    (16, 128, 256, 1024, TileConfig(64, 128, 64, split_k=4)),
    (3, 96, 200, 264, TileConfig(64, 64, 32, group_m=2)),
]


def _grouped_trans(cuda, layout, dtype, E, M, N, K, cfg, seed):
    """(got, again, want) of one grouped product with an operand stored
    transposed, launched twice on the kernel, once on the plain version."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn((E, K, M) if layout == "tn" else (E, M, K), generator=g,
                    device=cuda).to(dtype)
    b = torch.randn((E, N, K) if layout == "nt" else (E, K, N), generator=g,
                    device=cuda).to(dtype)
    kw = dict(out_dtype=dtype, trans_a=layout == "tn",
              trans_b=layout == "nt")
    n0 = dict(kmm.tiled_expert_matmul.layout_launches)
    got = kmm.tiled_expert_matmul(a, b, cfg, **kw)
    again = kmm.tiled_expert_matmul(a, b, cfg, **kw)
    want = kmm.expert_matmul_plain(a, b, cfg, **kw)
    torch.cuda.synchronize()
    assert kmm.tiled_expert_matmul.layout_launches[layout] == n0[layout] + 2
    assert got.shape == (E, M, N)
    return got, again, want


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tn", "nt"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("E,M,N,K,cfg", GROUPED_TRANS_CASES, ids=str)
def test_grouped_transposed_operand_on_card(cuda, layout, dtype, E, M, N, K,
                                            cfg):
    from repro_torch.core.selector import select_gemm_config
    if cfg is None:
        cfg = select_gemm_config(M, N, K, in_dtype=str(dtype)[6:],
                                 out_dtype=str(dtype)[6:],
                                 hw=GPU_H100_LIKE).config
    got, again, want = _grouped_trans(cuda, layout, dtype, E, M, N, K, cfg,
                                      seed=M + N + K)
    assert torch.equal(got, again)
    assert _flags_down()
    rtol, atol = _tol(dtype, K)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tn", "nt"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("bm,bn", MENU_TILES, ids=str)
def test_grouped_transposed_every_tile_on_card(cuda, layout, dtype, bm, bn):
    """Each (bm, bn) of the menu with each operand transposed, 3 experts,
    ragged N and K, a stream-K or split-K fixup."""
    M, N, K = 208, 332, 472
    bk = 48 if (bm + bn) % 64 else 64
    cfg = (TileConfig(bm, bn, bk, schedule="stream_k") if bm <= bn
           else TileConfig(bm, bn, bk, split_k=2, group_m=2))
    got, again, want = _grouped_trans(cuda, layout, dtype, 3, M, N, K, cfg,
                                      seed=bm * 7 + bn)
    assert torch.equal(got, again)
    assert _flags_down()
    rtol, atol = _tol(dtype, K)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tn", "nt"])
def test_grouped_transposed_replays_in_a_cuda_graph(cuda, layout):
    """A grouped split launch with a transposed operand (qwen3's dW / dX of
    wu at 8 experts, stream-K) replays twice in a CUDA graph with the eager
    launch's bits."""
    cfg = TileConfig(64, 128, 64, schedule="stream_k")
    M, N, K = (2048, 768, 160) if layout == "tn" else (160, 2048, 768)
    g = torch.Generator(device=cuda).manual_seed(9)
    a = torch.randn((8, K, M) if layout == "tn" else (8, M, K), generator=g,
                    device=cuda).bfloat16()
    b = torch.randn((8, N, K) if layout == "nt" else (8, K, N), generator=g,
                    device=cuda).bfloat16()
    kw = dict(out_dtype=torch.bfloat16, trans_a=layout == "tn",
              trans_b=layout == "nt")
    eager = kmm.tiled_expert_matmul(a, b, cfg, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kmm.tiled_expert_matmul(a, b, cfg, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kmm.tiled_expert_matmul(a, b, cfg, **kw)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert _flags_down()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("ep", [
    Epilogue(activation="swiglu_gate"), Epilogue(activation="gelu"),
    Epilogue(bias=True), Epilogue(bias=True, activation="silu")], ids=str)
def test_grouped_epilogue_bwd_on_card(cuda, dtype, ep):
    """The epilogue backward over (E, C, N), dbias per expert (E, N)."""
    E, M, N = 16, 160, 768
    g = torch.Generator(device=cuda).manual_seed(6)
    dout = torch.randn((E, M, N), generator=g, device=cuda).to(dtype)
    z = torch.randn((E, M, N), generator=g, device=cuda) * 3
    gate = (torch.randn((E, M, N), generator=g, device=cuda).to(dtype)
            if ep.activation == "swiglu_gate" else None)
    kw = dict(epilogue=ep, gate=gate, dz_dtype=dtype, want_bias=ep.bias)
    zz = z if ep.activation else None
    n0 = kmm.epilogue_bwd.grouped_launches
    got = kmm.epilogue_bwd(dout, zz, **kw)
    again = kmm.epilogue_bwd(dout, zz, **kw)
    want = kmm.epilogue_bwd_plain(dout, zz, **kw)
    torch.cuda.synchronize()
    assert kmm.epilogue_bwd.grouped_launches == n0 + 2
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 1e-2)
    for x, y, w in zip(got, again, want):
        assert (x is None) == (w is None)
        if x is None:
            continue
        assert x.shape == w.shape and torch.equal(x, y)
        torch.testing.assert_close(x.float(), w.float(), rtol=rtol,
                                   atol=atol * (M if x.dim() == 2 else 1))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m",
                                  "zamba2-7b"])
def test_smoke_family_grads_on_card(cuda, arch):
    """One f32 loss and gradient of the MoE, SSM and hybrid smoke configs on
    the kernels (for MoE the grouped GEMM forward and backward) against the
    same step's plain versions on the CPU: each leaf within 1e-4 relative
    L2, twice bitwise on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn.model import Model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_items, tree_map
    cfg = get_config(arch, smoke=True)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    opt = AdamW()
    want_loss, want = make_train_step(cpu, opt).loss_and_grads(
        params, {"tokens": tokens})
    gpu = Model(cfg, device=cuda)
    step = make_train_step(gpu, opt)
    dev_params = tree_map(lambda t: t.to(cuda), params)
    n0 = (dict(kmm.tiled_expert_matmul.layout_launches),
          kmm.epilogue_bwd.grouped_launches)
    loss, got = step.loss_and_grads(dev_params, {"tokens": tokens})
    _, again = step.loss_and_grads(dev_params, {"tokens": tokens})
    torch.cuda.synchronize()
    if cfg.is_moe:
        L = cfg.num_layers
        n = kmm.tiled_expert_matmul.layout_launches
        assert n["tn"] - n0[0]["tn"] == 2 * 3 * L
        assert n["nt"] - n0[0]["nt"] == 2 * 3 * L
        assert kmm.epilogue_bwd.grouped_launches - n0[1] == 2 * L
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for (path, x), (_, y), (_, w) in zip(tree_items(got), tree_items(again),
                                         tree_items(want)):
        assert torch.equal(x, y), path
        assert _rel_l2(x.cpu(), w) <= 1e-4, path


# ---------------------------------------------------------------------------
# The f32 routes on split-TF32 products (csrc/tf32x3.cuh): the GEMM at every
# tile of the menu in every layout and grouped, at zamba2-7b's mamba
# GEMMs, in a CUDA graph; the flash backward at every head dim; the probes'
# timed form.  f32 tolerances as above; every case launched twice, bitwise.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nn", "tn", "nt", "grouped"])
@pytest.mark.parametrize("bm,bn", MENU_TILES, ids=str)
def test_f32_gemm_every_tile_and_layout_on_card(cuda, layout, bm, bn):
    """Each (bm, bn) of the menu in each layout, ragged M, N and K, with a
    k-step (48) that is no multiple of 32 on half the tiles (the 16-deep
    ring slices) and a stream-K or split-K fixup."""
    M, N, K = 204, 332, 472
    bk = 48 if (bm + bn) % 64 else 64
    cfg = (TileConfig(bm, bn, bk, schedule="stream_k") if bm <= bn
           else TileConfig(bm, bn, bk, split_k=2, group_m=2))
    g = torch.Generator(device=cuda).manual_seed(bm * 7 + bn)
    f32 = torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    if layout == "grouped":
        x, w = rnd(3, M, K), rnd(3, K, N)
        ep = Epilogue(bias=True, activation="silu")
        bias = rnd(3, N)
        kw = dict(out_dtype=f32, epilogue=ep, bias=bias)
        got, again = (kmm.tiled_expert_matmul(x, w, cfg, **kw)
                      for _ in range(2))
        want = kmm.expert_matmul_plain(x, w, cfg, **kw)
    else:
        a = rnd(K, M) if layout == "tn" else rnd(M, K)
        b = rnd(N, K) if layout == "nt" else rnd(K, N)
        ep = Epilogue(residual=True)
        kw = dict(out_dtype=f32, epilogue=ep, residual=rnd(M, N),
                  trans_a=layout == "tn", trans_b=layout == "nt")
        got, again = (kmm.tiled_matmul(a, b, cfg, **kw) for _ in range(2))
        want = kmm.matmul_plain(a, b, cfg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _flags_down()
    rtol, atol = _tol(f32, K)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


ZAMBA2_MAMBA_GEMMS = [(7168, 3584), (64, 3584), (112, 3584), (3584, 7168)]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 474])
@pytest.mark.parametrize("N,K", ZAMBA2_MAMBA_GEMMS, ids=str)
def test_f32_zamba2_gemms_on_card(cuda, M, N, K):
    """zamba2-7b's mamba projections in f32 (the f32 serve's GEMMs) at
    decode and prefill M on the selector's config, bf16 outputs too."""
    from repro_torch.core.selector import select_gemm_config
    cfg = select_gemm_config(M, N, K, in_dtype="float32",
                             out_dtype="float32", hw=GPU_H100_LIKE).config
    g = torch.Generator(device=cuda).manual_seed(N + K + M)
    a = torch.randn((M, K), generator=g, device=cuda) * 0.1
    b = torch.randn((K, N), generator=g, device=cuda) * 0.02
    for out_dtype in (torch.float32, torch.bfloat16):
        got, again = (kmm.tiled_matmul(a, b, cfg, out_dtype=out_dtype)
                      for _ in range(2))
        want = kmm.matmul_plain(a, b, cfg, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        rtol, atol = _tol(out_dtype, K)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.gpu
def test_f32_gemm_replays_in_a_cuda_graph(cuda):
    """The f32 route's split launch (zamba2's decode in_z on its stream-K
    config) replays twice in a CUDA graph with the eager launch's bits."""
    cfg = TileConfig(32, 128, 128, schedule="stream_k")
    a, b, kw = _gemm_operands(cuda, 4, 7168, 3584, Epilogue(residual=True),
                              torch.float32)
    kw = dict(out_dtype=torch.float32, epilogue=Epilogue(residual=True),
              **kw)
    eager = kmm.tiled_matmul(a, b, cfg, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kmm.tiled_matmul(a, b, cfg, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kmm.tiled_matmul(a, b, cfg, **kw)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert _flags_down()


@pytest.mark.gpu
@pytest.mark.parametrize("d", kfa.HEAD_DIMS)
@pytest.mark.parametrize("causal,Hkv", [(True, 2), (False, 4)], ids=str)
def test_flash_bwd_f32_every_head_dim_on_card(cuda, d, causal, Hkv):
    """The split-TF32 backward at every head dim the f32 route takes
    (every multiple of 8 up to 256), causal with GQA and not without, at
    a ragged S: see :func:`_check_flash_bwd`."""
    _check_flash_bwd(cuda, "float32", 1, 4, Hkv, 150, d, causal, seed=d)


@pytest.mark.gpu
def test_probes_timed_form_on_card(cuda):
    """With ``out`` the probes write their sums into the caller's buffer
    (no fill before them): the stream's CTA sums add up to the checksum,
    the chains' sums equal the plain version's."""
    x = probes.stream_data(1 << 20, cuda)
    out = torch.full((4096,), -1, dtype=torch.int64, device=cuda)
    _, chunk, _ = probes.stream_geometry(3 << 20, 1 << 20, 4)
    per, groups = probes.stream_groups(chunk, kmm._sm_count(cuda.index))
    got = probes.stream_read(x, 3 << 20, 1 << 20, 4, out=out)
    torch.cuda.synchronize()
    assert got is out
    want = probes.stream_read_plain(x, 3 << 20, 1 << 20, 4)
    assert int(out[:per * groups].sum()) == int(want)
    assert bool((out[per * groups:] == -1).all())
    a, b = probes.mma_operands("bfloat16", cuda,
                               torch.Generator(device=cuda).manual_seed(3))
    probes.wave_grid(a, b, 133, 40, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out[:133], probes.wave_grid_plain(a, b, 133, 40))
    probes.mma_chain(a, b, 1000, 7, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out[:28], probes.mma_chain_plain(a, b, 1000, 7))


# ---------------------------------------------------------------------------
# The bf16 route's TMA-store epilogue: every output goes through the
# warpgroup's staging tile and a TMA store that clips at the tensor's
# bounds (ragged M, N a multiple of 8 but not of bn, a 32-row tile's box),
# and the grouped launch's column walk.
# ---------------------------------------------------------------------------

EPILOGUE_KINDS = [
    Epilogue(), Epilogue(bias=True), Epilogue(activation="gelu"),
    Epilogue(bias=True, activation="silu"),
    Epilogue(activation="swiglu_gate"), Epilogue(residual=True),
    Epilogue(bias=True, activation="swiglu_gate", residual=True),
]


def _epilogue_operands(g, dev, shape, ep, dtype):
    """bias (G, N), gate and residual (G, M, N) for a grouped shape (G, M,
    N), drawn from ``g``."""
    G, M, N = shape

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)
    kw = {}
    if ep.bias:
        kw["bias"] = rnd(G, N)
    if ep.activation == "swiglu_gate":
        kw["gate"] = rnd(G, M, N)
    if ep.residual:
        kw["residual"] = rnd(G, M, N)
    return kw


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("ep", EPILOGUE_KINDS, ids=str)
@pytest.mark.parametrize("bm,bn", MENU_TILES, ids=str)
def test_tma_store_epilogue_every_tile_on_card(cuda, bm, bn, ep, out_dtype):
    """Each (bm, bn) of the menu with each epilogue kind, bf16 inputs and
    bf16 or f32 outputs: dense at M 333 and grouped (3 groups, A read in
    place stored (K, M) at M 160, B stored (N, K) or (K, N) at M 333), N
    200, a stream-K or split-K fixup; within the bf16 GEMM tolerance of
    the plain version and bitwise over two launches."""
    K, N = 200, 200
    cfg = (TileConfig(bm, bn, 64, schedule="stream_k") if bm <= bn
           else TileConfig(bm, bn, 64, split_k=2, group_m=2))
    layout = ("nn", "tn", "nt")[(bm + bn // 32) % 3]
    g = torch.Generator(device=cuda).manual_seed(bm * 13 + bn)
    bf = torch.bfloat16
    for grouped in (False, True):
        G, M = (3, 160 if layout == "tn" else 333) if grouped else (1, 333)
        ta, tb = grouped and layout == "tn", grouped and layout == "nt"
        a = torch.randn((G, K, M) if ta else (G, M, K), generator=g,
                        device=cuda).to(bf)
        b = torch.randn((G, N, K) if tb else (G, K, N), generator=g,
                        device=cuda).to(bf)
        kw = dict(out_dtype=out_dtype, epilogue=ep, trans_a=ta, trans_b=tb,
                  **_epilogue_operands(g, cuda, (G, M, N), ep, bf))
        if grouped:
            got = kmm.tiled_expert_matmul(a, b, cfg, **kw)
            again = kmm.tiled_expert_matmul(a, b, cfg, **kw)
            want = kmm.expert_matmul_plain(a, b, cfg, **kw)
        else:
            dense = {k: v[0] for k, v in kw.items()
                     if k in ("bias", "gate", "residual")}
            kw.update(dense)
            got = kmm.tiled_matmul(a[0], b[0], cfg, **kw)
            again = kmm.tiled_matmul(a[0], b[0], cfg, **kw)
            want = kmm.matmul_plain(a[0], b[0], cfg, **kw)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == want.shape
        assert torch.equal(got, again)
        assert _flags_down()
        rtol, atol = _tol(bf, K)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("grouped", [False, True], ids=["dense", "grouped"])
def test_tma_store_epilogue_replays_in_a_cuda_graph(cuda, grouped):
    """A split launch with a gate and a residual (the staged path) and one
    with a bias and gelu (the register path) replay twice in a CUDA graph
    with the eager launches' bits."""
    g = torch.Generator(device=cuda).manual_seed(4)
    bf = torch.bfloat16
    G, M, N, K = (5, 333, 520, 640) if grouped else (1, 333, 520, 640)
    cfg = TileConfig(64, 128, 64, schedule="stream_k")
    a = torch.randn((G, M, K), generator=g, device=cuda).to(bf)
    b = torch.randn((G, K, N), generator=g, device=cuda).to(bf)
    calls = []
    for ep in (Epilogue(bias=True, activation="swiglu_gate", residual=True),
               Epilogue(bias=True, activation="gelu")):
        kw = dict(out_dtype=bf, epilogue=ep,
                  **_epilogue_operands(g, cuda, (G, M, N), ep, bf))
        if grouped:
            calls.append(lambda kw=kw: kmm.tiled_expert_matmul(a, b, cfg,
                                                               **kw))
        else:
            kw.update({k: v[0] for k, v in kw.items()
                       if k in ("bias", "gate", "residual")})
            calls.append(lambda kw=kw: kmm.tiled_matmul(a[0], b[0], cfg,
                                                        **kw))
    eager = [fn() for fn in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in calls]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)
    assert _flags_down()


@pytest.mark.gpu
@pytest.mark.parametrize("layout,M,N,K", [
    ("nt", 160, 2048, 768), ("nt", 160, 768, 2048),
    ("tn", 2048, 768, 160), ("tn", 768, 2048, 160)], ids=str)
def test_grouped_backward_at_qwen3_shapes_is_exact_on_card(cuda, layout, M,
                                                           N, K):
    """qwen3-moe's expert-GEMM gradients (128 experts of capacity 160) at
    the selected configs, dX reading W transposed (nt), dW reading X
    transposed (tn), on integer operands in [-2, 2]: every partial sum is
    an integer of at most 2^13, exact in f32 in any order, so the kernel's
    output (its column walk, fixup and TMA stores) must equal the plain
    version's bits."""
    from repro_torch.core.selector import select_gemm_config
    E, bf = 128, torch.bfloat16
    cfg = select_gemm_config(M, N, K, in_dtype="bfloat16",
                             out_dtype="bfloat16", hw=GPU_H100_LIKE).config
    g = torch.Generator(device=cuda).manual_seed(M + N)
    a = torch.randint(-2, 3, (E, K, M) if layout == "tn" else (E, M, K),
                      generator=g, device=cuda).to(bf)
    b = torch.randint(-2, 3, (E, N, K) if layout == "nt" else (E, K, N),
                      generator=g, device=cuda).to(bf)
    kw = dict(out_dtype=bf, trans_a=layout == "tn", trans_b=layout == "nt")
    got = kmm.tiled_expert_matmul(a, b, cfg, **kw)
    want = kmm.expert_matmul_plain(a, b, cfg, **kw)
    torch.cuda.synchronize()
    assert kmm.work_plan(M, N, K, cfg, E,
                         kmm._sm_count(cuda.index)).column_walk
    assert torch.equal(got, want)
    assert _flags_down()


# The sliding window in the bf16 forward (mixtral-8x22b's SWA): (B, H, Hkv,
# S, d, window).  Windows of 32, 100 and 128 at S 300 put block edges
# inside and on the window's lower edge (64 and 128 are block sizes); a
# window past S must equal the causal kernel; mixtral's own shape at
# S 8192, window 4096, as served.  The plain version is
# ``nn/attention.py::chunked_attention``.
WINDOW_CASES = [(1, 8, 2, 300, d, w) for d in (64, 128, 160)
                for w in (32, 64, 100, 128)] + [
    (2, 8, 8, 300, 128, 1), (1, 48, 8, 8192, 128, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,d,window", WINDOW_CASES, ids=str)
def test_flash_window_matches_chunked_attention(cuda, B, H, Hkv, S, d,
                                                window):
    """Every legal block pair (S 300) or the selector's (S 8192) against
    the plain windowed attention, two launches bitwise equal, v as the
    model passes it."""
    q, k, v = _attn_case(cuda, B, H, Hkv, S, d, torch.bfloat16,
                         seed=S + d + window, model_v=True)
    pairs = ([(bq, bkv) for bq in kfa.BLOCK_MENU for bkv in kfa.BLOCK_MENU
              if kfa.legal_blocks(bq, bkv, d)] if S < 1000 else
             [kfa.select_attention_blocks(S, S, d, causal=True, batch=B,
                                          heads=H, kv_heads=Hkv,
                                          window=window)])
    want = kfa.attention_plain(q, k, v, block_q=64, block_kv=64,
                               causal=True, window=window)
    for bq, bkv in pairs:
        n0 = kfa.flash_attention_kernel.launches
        got = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                         causal=True, window=window)
        again = kfa.flash_attention_kernel(q, k, v, block_q=bq,
                                           block_kv=bkv, causal=True,
                                           window=window)
        torch.cuda.synchronize()
        assert kfa.flash_attention_kernel.launches == n0 + 2
        assert torch.equal(got, again), (bq, bkv)
        torch.testing.assert_close(got.float(), want.float(),
                                   **_attn_tol(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", [(300, 300), (300, 5000), (474, 474)])
def test_flash_window_past_the_sequence_is_causal(cuda, S, window):
    """A window that no query reaches past (window >= S) is bitwise the
    causal kernel."""
    q, k, v = _attn_case(cuda, 1, 8, 2, S, 128, torch.bfloat16, seed=S,
                         model_v=True)
    for bq, bkv in ((64, 64), (128, 128)):
        got = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                         causal=True, window=window)
        want = kfa.flash_attention_kernel(q, k, v, block_q=bq,
                                          block_kv=bkv, causal=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (bq, bkv)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,d,window", WINDOW_CASES, ids=str)
def test_flash_window_f32_matches_chunked_attention(cuda, B, H, Hkv, S, d,
                                                    window):
    """The split-TF32 forward with a window against the plain windowed
    attention at the f32 tolerance, its lse against the plain lse, two
    launches bitwise equal, v as the model passes it."""
    q, k, v = _attn_case(cuda, B, H, Hkv, S, d, torch.float32,
                         seed=S + d + window, model_v=True)
    want = kfa.attention_plain(q, k, v, block_q=64, block_kv=64,
                               causal=True, window=window)
    _, lse_p = kfa.attention_plain(q, k, v, block_q=64, block_kv=64,
                                   causal=True, return_lse=True,
                                   window=window)
    n0 = kfa.flash_attention_kernel.launches
    got, lse = kfa.flash_attention_kernel(q, k, v, block_q=64, block_kv=64,
                                          causal=True, return_lse=True,
                                          window=window)
    again = kfa.flash_attention_kernel(q, k, v, block_q=64, block_kv=64,
                                       causal=True, window=window)
    torch.cuda.synchronize()
    assert kfa.flash_attention_kernel.launches == n0 + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, **_attn_tol(torch.float32))
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,H,Hkv,S,d,window",
                         [c for c in WINDOW_CASES if c[-1] > 1], ids=str)
def test_flash_window_bwd_on_card(cuda, dtype, B, H, Hkv, S, d, window):
    """The backward with a window, bf16 (wgmma) and f32 (split TF32),
    against the plain windowed backward (one kv head's group at a time at
    S 8192): see :func:`_check_flash_bwd`.  Window 1 has a test of its
    own."""
    _check_flash_bwd(cuda, dtype, B, H, Hkv, S, d, True, S + d + window,
                     do_view=True, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_flash_window_one_bwd_on_card(cuda, dtype):
    """At window 1 each query sees only its own key: P is 1 on the
    diagonal, so o = v, dv = dO and dS = P (dP - delta) = dO.v - dO.o is 0
    but for rounding, and so are dq and dk.  A relative distance between
    two roundings of 0 says nothing, so dv is held to the plain backward
    (f32 within 1e-4 relative L2, bf16 within 2x the plain bf16
    backward's distance from the plain f32 one) and dq, dk to 1e-5 of
    dv's largest value; two launches bitwise equal."""
    q, k, v = _attn_case(cuda, 2, 8, 8, 300, 128, dtype, seed=11,
                         model_v=True)
    do = torch.randn(q.shape, generator=torch.Generator(
        device=cuda).manual_seed(12), device=cuda).to(dtype)
    o, lse = kfa.attention_plain(q, k, v, block_q=64, block_kv=64,
                                 causal=True, return_lse=True, window=1)
    got, again = (kfa.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                                 causal=True, window=1)
                  for _ in range(2))
    plain = kfa.attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                    window=1)
    o32, lse32 = kfa.attention_plain(q.float(), k.float(), v.float(),
                                     block_q=64, block_kv=64, causal=True,
                                     return_lse=True, window=1)
    ref32 = kfa.attention_bwd_plain(q.float(), k.float(), v.float(), o32,
                                    lse32, do.float(), causal=True, window=1)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert torch.equal(x, y) and bool(torch.isfinite(x).all())
    dv = got[2].float()
    if dtype == torch.float32:
        assert _rel_l2(dv, plain[2]) <= 1e-4
    else:
        assert _rel_l2(dv, ref32[2]) <= 2 * _rel_l2(plain[2], ref32[2])
    for x in got[:2]:
        assert float(x.float().abs().max()) <= 1e-5 * float(dv.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("S,window", [(300, 300), (300, 5000), (474, 474)])
def test_flash_window_past_the_sequence_is_causal_fwd_and_bwd(cuda, dtype, S,
                                                              window):
    """A window that no query reaches past (window >= S) is bitwise the
    causal kernel: the f32 forward and the backward in both dtypes."""
    q, k, v = _attn_case(cuda, 1, 8, 2, S, 128, dtype, seed=S + 1,
                         model_v=True)
    do = torch.randn(q.shape, generator=torch.Generator(
        device=cuda).manual_seed(S), device=cuda).to(dtype)
    o, lse = kfa.flash_attention_kernel(q, k, v, block_q=64, block_kv=64,
                                        causal=True, return_lse=True)
    if dtype == torch.float32:
        got = kfa.flash_attention_kernel(q, k, v, block_q=64, block_kv=64,
                                         causal=True, window=window)
        assert torch.equal(got, o)
    got = kfa.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=True,
                                         window=window)
    want = kfa.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_windowed_autograd_launches_the_kernels(cuda):
    """``ops.flash_attention`` with a window under autograd, in bf16 and
    f32, runs the forward and backward kernels (their counters move) and
    its gradients match the plain backward's: f32 within 1e-4 relative L2,
    bf16 within 2x the plain bf16 backward's distance from the plain f32
    backward."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _attn_case(cuda, 1, 4, 2, 200, 64, dtype, seed=3)
        ql, kl, vl = (t.requires_grad_() for t in (q, k, v))
        n0 = (kfa.flash_attention_kernel.launches,
              kfa.flash_attention_bwd_kernel.launches)
        out = ops.flash_attention(ql, kl, vl, causal=True, window=32)
        dq, dk, dv = torch.autograd.grad(out.float().sum(), (ql, kl, vl))
        torch.cuda.synchronize()
        assert (kfa.flash_attention_kernel.launches,
                kfa.flash_attention_bwd_kernel.launches) == (n0[0] + 1,
                                                             n0[1] + 1)
        def plain(*qkv):
            o, lse = kfa.attention_plain(*qkv, block_q=64, block_kv=64,
                                         causal=True, return_lse=True,
                                         window=32)
            return kfa.attention_bwd_plain(*qkv, o, lse, torch.ones_like(o),
                                           causal=True, window=32)
        qkv = [t.detach() for t in (q, k, v)]
        want, ref32 = plain(*qkv), plain(*(t.float() for t in qkv))
        for x, w, r in zip((dq, dk, dv), want, ref32):
            if dtype == torch.float32:
                assert _rel_l2(x, w) <= 1e-4
            else:
                assert _rel_l2(x, r) <= 2 * _rel_l2(w, r)


@pytest.mark.gpu
def test_flash_head_dim_off_the_rule_raises(cuda):
    """stablelm-12b's smoke head dim, 20 (40-byte rows: no TMA stride),
    raises a clear error on the card; the config runs on the CPU only."""
    q, k, v = _attn_case(cuda, 1, 4, 2, 64, 20, torch.bfloat16, seed=2)
    with pytest.raises(ValueError, match="head_dim 20 is not taken"):
        ops.flash_attention(q, k, v, causal=True)
