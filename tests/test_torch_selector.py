"""The port's copied selector against the JAX package's goldens, and the
port's own Hopper attention-block selector.

``repro_torch.core`` is a copy of ``repro.core`` (the port imports nothing of
the JAX package); these goldens are what keep the two from drifting: every
preset's llama3-sweep selection — config, candidate count and the float64
latency bit for bit — must match ``tests/goldens/llama3_selections.json``.
"""
import json
import os

import pytest

from benchmarks.llama3_shapes import llama3_gemms
from repro_torch.core.hardware import GPU_H100_LIKE, PRESETS
from repro_torch.core.selector import (clear_selection_cache,
                                       select_gemm_config,
                                       select_gemm_config_batch)
from repro_torch.kernels import flash_attention as kfa

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           "llama3_selections.json")


def _entry(sel):
    c = sel.config
    return {
        "M": sel.problem.M, "N": sel.problem.N, "K": sel.problem.K,
        "config": {"bm": c.bm, "bn": c.bn, "bk": c.bk,
                   "split_k": c.split_k, "group_m": c.group_m,
                   "schedule": c.schedule},
        "n_candidates": sel.n_candidates,
        "total_hex": sel.predicted.total.hex(),
    }


def _sweep():
    return [g for size in ("8b", "70b") for g in llama3_gemms(size)]


def test_golden_presets_match():
    with open(GOLDEN_PATH) as f:
        assert set(json.load(f)) == set(PRESETS)


@pytest.mark.parametrize("hw_name", sorted(PRESETS))
def test_copied_selector_reproduces_goldens(hw_name):
    with open(GOLDEN_PATH) as f:
        want = json.load(f)[hw_name]
    hw = PRESETS[hw_name]
    got = {name: _entry(select_gemm_config(M, N, K, hw=hw))
           for (name, M, N, K) in _sweep()}
    assert len(got) == 30
    assert got == want


@pytest.mark.parametrize("hw_name", ["gpu_h100_like", "tpu_v5e"])
def test_batch_selection_equals_scalar(hw_name):
    hw = PRESETS[hw_name]
    shapes = [(M, N, K) for (_, M, N, K) in _sweep()[::3]]
    clear_selection_cache()
    batch = select_gemm_config_batch(shapes, hw=hw)
    clear_selection_cache()
    scalar = [select_gemm_config(M, N, K, hw=hw) for (M, N, K) in shapes]
    for b, s in zip(batch, scalar):
        assert b.config == s.config
        assert b.n_candidates == s.n_candidates
        assert b.predicted.total.hex() == s.predicted.total.hex()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(128, 128, 64), (512, 512, 64),
                                   (2048, 2048, 128), (4096, 4096, 128)])
def test_attention_blocks_legal_on_h100(shape, causal):
    """The reference selector finds no candidate on GPU_H100_LIKE; the
    port's returns a pair the Hopper kernel takes, within its shared-memory
    and register budgets."""
    s_q, s_kv, d = shape
    bq, bkv = kfa.select_attention_blocks(s_q, s_kv, d, hw=GPU_H100_LIKE,
                                          causal=causal)
    assert bq in kfa.BLOCK_MENU and bkv in kfa.BLOCK_MENU
    assert kfa._smem_bytes(bkv, d, 2) <= kfa._SMEM_BYTES
    assert kfa._regs_per_thread(bkv, d) <= kfa._MAX_REGS
    if d in kfa.HEAD_DIMS:
        assert (bq, bkv) == kfa.select_attention_blocks(
            s_q, s_kv, d, causal=causal)        # H100 is the default


def test_attention_blocks_exist_up_to_head_dim_256():
    for d in (16, 32, 64, 96, 128, 256):
        for s in (1, 100, 8192):
            assert kfa.select_attention_blocks(s, s, d) is not None
