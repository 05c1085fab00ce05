"""The port's CUDA kernels (dense and grouped GEMM, flash attention, the
calibration probes) against their plain versions, on the card.

Marked ``gpu``; each test skips on a host without CUDA.  The file imports
only torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

GEMM tolerances are ``tests/test_kernels.py``'s (f32 rtol 1e-5 /
atol 1e-4·√K, bf16 rtol 3e-2 / atol 0.3·√K).  Attention compares bf16
outputs at rtol 2e-2 / atol 1e-2, because the kernel rounds P to bf16
before P·V where the plain version keeps it in f32.  The probe kernels'
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
