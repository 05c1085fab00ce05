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
    assert kfa._smem_bytes(bq, bkv, d) <= kfa._SMEM_BYTES
    assert kfa._regs_per_thread(bkv, d) <= kfa._max_regs(bq)
    if d in kfa.HEAD_DIMS:
        assert (bq, bkv) == kfa.select_attention_blocks(
            s_q, s_kv, d, causal=causal)        # H100 is the default


# (block_q, block_kv, d): the kernel's shared memory (1 KB alignment slack,
# Q, two stages of K + V, 7 mbarriers), a consumer's registers, whether it
# is legal, and the CTAs one SM holds.
@pytest.mark.parametrize("bq,bkv,d,smem,regs,legal,per_sm", [
    (64, 64, 128, 83000, 152, True, 2),
    (64, 128, 128, 148536, 200, True, 1),
    (128, 64, 128, 99384, 152, True, 1),
    (128, 128, 128, 164920, 200, True, 1),
    (64, 64, 256, 164920, 216, True, 1),
    (64, 128, 256, 295992, 264, False, 0),
    (128, 64, 256, 197688, 216, True, 1),
    (128, 128, 256, 328760, 264, False, 0),
], ids=str)
def test_attention_block_budgets(bq, bkv, d, smem, regs, legal, per_sm):
    assert kfa._smem_bytes(bq, bkv, d) == smem
    assert kfa._regs_per_thread(bkv, d) == regs
    assert kfa.legal_blocks(bq, bkv, d) == legal
    if legal:
        assert kfa.ctas_per_sm(bq, bkv, d) == per_sm


# The served prefill shapes: phi4-mini (24/8 heads) at both bucket edges,
# qwen3-moe-30b-a3b (32/4) at its one.
SERVED = [(24, 8, 336), (24, 8, 474), (32, 4, 474)]


@pytest.mark.parametrize("heads,kv_heads,S", SERVED, ids=str)
def test_attention_blocks_fill_the_card(heads, kv_heads, S):
    """At the served shapes the chosen grid holds at least one CTA for
    each of the H100's 132 SMs."""
    plan = kfa.plan_attention(S, S, 128, heads=heads, kv_heads=kv_heads,
                              causal=True)
    assert plan.ctas == heads * -(-S // plan.block_q)
    assert plan.ctas >= GPU_H100_LIKE.total_cores() == 132
    assert (plan.block_q, plan.block_kv) == kfa.select_attention_blocks(
        S, S, 128, heads=heads, kv_heads=kv_heads, causal=True)
    # The pair that ran fastest of the menu at all three shapes on the
    # H100 (PERF.md §6): 64-row q blocks, two CTAs an SM.
    assert (plan.block_q, plan.block_kv, plan.ctas_per_sm) == (64, 64, 2)


@pytest.mark.parametrize("heads,kv_heads,S", SERVED, ids=str)
def test_attention_selection_is_deterministic(heads, kv_heads, S):
    """The same pair from a cold memo, from the memo, and with the H100
    named or left as the default."""
    kw = dict(heads=heads, kv_heads=kv_heads, causal=True)
    kfa._PLANS.clear()
    cold = kfa.plan_attention(S, S, 128, hw=GPU_H100_LIKE, **kw)
    assert kfa.plan_attention(S, S, 128, **kw) == cold
    kfa._PLANS.clear()
    assert kfa.plan_attention(S, S, 128, **kw) == cold


@pytest.mark.parametrize("d", list(range(16, 257, 16)))
def test_attention_blocks_for_every_head_dim(d):
    for s in (1, 40, 474, 8192):
        for causal in (False, True):
            bq, bkv = kfa.select_attention_blocks(s, s, d, causal=causal,
                                                  heads=8, kv_heads=2)
            assert kfa.legal_blocks(bq, bkv, d)


@pytest.mark.parametrize("bq,bkv", [(64, 64), (64, 128), (128, 64),
                                    (128, 128)])
@pytest.mark.parametrize("s_q", [40, 336, 474])
def test_kv_steps_cover_the_causal_mask(s_q, bq, bkv):
    """Each q block walks exactly the kv blocks that hold a key one of its
    rows sees: the causal skip drops no visible key and walks no block
    that is all masked."""
    steps = kfa.kv_steps(s_q, s_q, bq, bkv, causal=True)
    assert len(steps) == -(-s_q // bq)
    for i, n in enumerate(steps):
        last_row = min((i + 1) * bq, s_q) - 1
        visible = {key // bkv for key in range(last_row + 1)}
        assert n == len(visible) == max(visible) + 1
    assert kfa.kv_steps(s_q, s_q, bq, bkv, causal=False) == \
        [-(-s_q // bkv)] * len(steps)


def test_attention_blocks_exist_up_to_head_dim_256():
    for d in (16, 32, 64, 96, 128, 256):
        for s in (1, 100, 8192):
            assert kfa.select_attention_blocks(s, s, d) is not None
