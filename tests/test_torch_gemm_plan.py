"""The persistent GEMM's work plan (``kernels/matmul.py::work_plan``)
against the JAX package's latency model and its Pallas kernel.

``csrc/matmul.cu`` computes the same partition from the same integers, so
these CPU tests hold the kernel's schedule to what the model prices:

* every (group, tile, k-step) is covered exactly once, for ``stream_k`` and
  for split_k in {1, 2, 4, 8}, on the main-path shapes, on ragged shapes
  and with fewer k-steps than CTAs;
* the fixup's partial bytes against ``repro.core.latency.
  schedule_extra_classes`` on the 132-SM preset: equal under ``stream_k``;
  under split-K the model counts a partial for every shard, the kernel
  none for the owner's own shard (kept in registers) nor for consecutive
  shards of one tile in one CTA (summed in one accumulator), and the test
  states that difference exactly;
* an emulation of the kernel's arithmetic -- per-piece f32 sums, the
  owner's fixup in k order, the epilogue once -- against the JAX package's
  ``repro.kernels.ops.matmul`` in interpret mode with the same TileConfig,
  at ``tests/test_kernels.py``'s f32 tolerance (rtol 1e-5, atol 1e-4 sqrt K).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import latency as jlat
from repro.core.hardware import GPU_H100_LIKE as J_H100
from repro.kernels.matmul import _swizzle as pallas_swizzle
from repro.kernels import ops as jops
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import Epilogue, TileConfig
from repro_torch.core.selector import select_gemm_config
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ref

SMS = 132

# (M, N, K, groups): phi4-mini's decode and prefill projections, qwen3-moe's
# expert GEMMs (128 experts at capacity 40), ragged shapes, and a GEMM with
# fewer k-steps than CTAs.
SHAPES = [
    (4, 3072, 3072, 1), (4, 8192, 3072, 1), (4, 3072, 8192, 1),
    (512, 3072, 3072, 1), (512, 1024, 3072, 1), (512, 8192, 3072, 1),
    (40, 768, 2048, 128), (40, 2048, 768, 128),
    (100, 300, 80, 1), (333, 200, 264, 3), (4, 1024, 256, 1),
]
SCHEDULES = [("stream_k", 1), ("data_parallel", 1), ("data_parallel", 2),
             ("data_parallel", 4), ("data_parallel", 8)]


def _config(M, N, K, schedule, split_k):
    """The selector's tile for the shape, under the given schedule."""
    sel = select_gemm_config(M, N, K, in_dtype="bfloat16",
                             out_dtype="bfloat16", epilogue=Epilogue(),
                             hw=GPU_H100_LIKE).config
    return TileConfig(sel.bm, sel.bn, sel.bk, split_k=split_k,
                      group_m=sel.group_m, schedule=schedule)


def _ids(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) and \
        isinstance(v[0], int) else "-".join(map(str, v))


@pytest.mark.parametrize("schedule", SCHEDULES, ids=_ids)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_work_plan_covers_every_step_once(shape, schedule):
    M, N, K, G = shape
    plan = kmm.work_plan(M, N, K, _config(M, N, K, *schedule), G, SMS)
    assert plan.ctas == math.ceil(plan.units / plan.units_per_cta) <= SMS
    assert plan.units_per_cta == math.ceil(plan.units / min(SMS, plan.units))
    seen = np.zeros((plan.tiles, plan.steps_per_tile), np.int64)
    owners, writers = {}, 0
    for c in range(plan.ctas):
        pieces = plan.pieces(c)
        assert pieces, f"CTA {c} has no work"
        for i, pc in enumerate(pieces):
            seen[pc.tile, pc.s0:pc.s1] += 1
            if pc.first:
                assert pc.tile not in owners
                owners[pc.tile] = (c, pc.last_cta)
            else:
                assert i == 0, "only a CTA's first piece starts mid-tile"
                writers += 1
            if pc.last:
                assert pc.last_cta == c
    assert (seen == 1).all()
    assert sorted(owners) == list(range(plan.tiles))
    assert writers == plan.partials
    assert plan.split_tiles == sum(o != last for o, last in owners.values())
    assert plan.workspace_bytes == (plan.ctas * plan.slot_bytes
                                    if plan.partials else 0)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=_ids)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_partial_bytes_against_the_model(shape, schedule):
    M, N, K, G = shape
    cfg = _config(M, N, K, *schedule)
    plan = kmm.work_plan(M, N, K, cfg, G, SMS)
    jcfg = jlat.TileConfig(bm=cfg.bm, bn=cfg.bn, bk=cfg.bk,
                           split_k=cfg.split_k, group_m=cfg.group_m,
                           schedule=cfg.schedule)
    classes = jlat.schedule_extra_classes(
        jlat.GemmProblem(M, N, K, batch=G), jcfg, J_H100)
    model = sum(b for b, _ in classes)
    block = cfg.bm * cfg.bn * 4
    assert J_H100.total_cores() == SMS
    if cfg.schedule == "stream_k" or cfg.split_k == 1:
        assert plan.partial_bytes == model
        return
    # Split-K: the model writes and re-reads one partial per shard.
    assert model == 2 * cfg.split_k * plan.tiles * block
    saved = model - plan.partial_bytes
    assert saved == 2 * block * (cfg.split_k * plan.tiles - plan.partials)
    if plan.units_per_cta == 1:
        # One shard per CTA: only the owner's shard stays in registers.
        assert saved == 2 * block * plan.tiles
    else:
        assert saved >= 2 * block * plan.tiles


def test_tile_order_is_the_pallas_swizzle():
    plan = kmm.work_plan(333, 200, 264, TileConfig(64, 64, 64, group_m=4),
                         2, SMS)
    Tm, Tn = plan.tiles_m, plan.tiles_n
    for t in range(plan.tiles):
        g, pm, pn = plan.tile_coords(t)
        jm, jn = pallas_swizzle(t % (Tm * Tn), Tm, Tn, 4)
        assert (g, pm, pn) == (t // (Tm * Tn), int(jm), int(jn))


EPILOGUES = [
    Epilogue(),
    Epilogue(bias=True),
    Epilogue(activation="gelu"),
    Epilogue(activation="silu"),
    Epilogue(activation="swiglu_gate"),
    Epilogue(residual=True),
    Epilogue(bias=True, activation="swiglu_gate", residual=True),
]


def _emulate(plan, a, b, ep, kw):
    """What the kernel computes, in its order: each CTA sums its pieces in
    f32 k-step by k-step; a piece that starts mid-tile becomes its CTA's
    partial; the owner adds the partials of CTAs c+1..last_cta in k order
    to its own sum and applies the epilogue once."""
    M, N, K, bm, bn, bk = plan.M, plan.N, plan.K, plan.bm, plan.bn, plan.bk
    out = np.full((M, N), np.nan, np.float32)
    partial, owned = {}, []
    for c in range(plan.ctas):
        for pc in plan.pieces(c):
            _, pm, pn = plan.tile_coords(pc.tile)
            r, q = slice(pm * bm, min(M, (pm + 1) * bm)), \
                slice(pn * bn, min(N, (pn + 1) * bn))
            acc = np.zeros((r.stop - r.start, q.stop - q.start), np.float32)
            for s in range(pc.s0, pc.s1):
                k = slice(s * bk, min(K, (s + 1) * bk))
                if k.start < K:
                    acc += a[r, k] @ b[k, q]
            if pc.first:
                owned.append((c, pc, r, q, acc))
            else:
                partial[c] = acc
    for c, pc, r, q, acc in owned:
        for c2 in range(c + 1, pc.last_cta + 1):
            acc = acc + partial.pop(c2)
        t = {k: torch.from_numpy(v[q] if k == "bias" else v[r, q])
             for k, v in kw.items()}
        out[r, q] = ref.apply_epilogue_ref(torch.from_numpy(acc), ep,
                                           **t).numpy()
    assert not partial, "a partial was never read"
    assert not np.isnan(out).any(), "an output element was never written"
    return out


@pytest.mark.parametrize("cfg,ctas", [
    (TileConfig(32, 32, 32, schedule="stream_k"), SMS),   # 3 CTAs a tile
    (TileConfig(32, 64, 16, schedule="stream_k"), 8),     # strips span tiles
    (TileConfig(64, 32, 16, split_k=2), 9),               # unaligned shards
], ids=["streamk-132", "streamk-8", "sk2-9"])
@pytest.mark.parametrize("ep", EPILOGUES, ids=str)
def test_fixup_emulation_matches_pallas(ep, cfg, ctas):
    M, N, K = 100, 300, 77
    rng = np.random.default_rng(11)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    kw = {}
    if ep.bias:
        kw["bias"] = rng.standard_normal(N).astype(np.float32)
    if ep.activation == "swiglu_gate":
        kw["gate"] = rng.standard_normal((M, N)).astype(np.float32)
    if ep.residual:
        kw["residual"] = rng.standard_normal((M, N)).astype(np.float32)
    plan = kmm.work_plan(M, N, K, cfg, 1, ctas)
    assert plan.partials > 0
    got = _emulate(plan, a, b, ep, kw)
    want = jops.matmul(
        jnp.asarray(a), jnp.asarray(b), out_dtype=jnp.float32,
        backend="pallas_interpret",
        config=jlat.TileConfig(bm=cfg.bm, bn=cfg.bn, bk=cfg.bk,
                               split_k=cfg.split_k, group_m=cfg.group_m,
                               schedule=cfg.schedule),
        epilogue=jlat.Epilogue(bias=ep.bias, activation=ep.activation,
                               residual=ep.residual),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                               atol=1e-4 * math.sqrt(K))
