"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips on a host without CUDA.  The file imports
only torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

GEMM tolerances are ``tests/test_kernels.py``'s (f32 rtol 1e-5 /
atol 1e-4·√K, bf16 rtol 3e-2 / atol 0.3·√K).  Attention compares bf16
outputs at rtol 2e-2 / atol 1e-2, because the kernel rounds P to bf16
before P·V where the plain version keeps it in f32.
"""
import math

import pytest
import torch

from repro_torch.core.latency import Epilogue, TileConfig
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops


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


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [512, 1000])
def test_flash_kernel_on_card(cuda, S, causal):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((2, 24, S, 128), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, 8, S, 128), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, 8, S, 128), generator=g, device=cuda).bfloat16()
    bq, bkv = kfa.select_attention_blocks(S, S, 128, causal=causal)
    n0 = kfa.flash_attention_kernel.launches
    got = kfa.flash_attention_kernel(q, k, v, block_q=bq, block_kv=bkv,
                                     causal=causal)
    want = kfa.attention_plain(q, k, v, block_q=bq, block_kv=bkv,
                               causal=causal)
    torch.cuda.synchronize()
    assert kfa.flash_attention_kernel.launches == n0 + 1
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
