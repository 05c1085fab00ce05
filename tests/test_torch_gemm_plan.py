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
import itertools
import math
from collections import Counter

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
    to its own sum and applies the epilogue once.  a (G, M, K), b (G, K,
    N) and the epilogue operands with a leading group axis (G = 1 for the
    dense launch)."""
    M, N, K, bm, bn, bk = plan.M, plan.N, plan.K, plan.bm, plan.bn, plan.bk
    out = np.full((plan.groups, M, N), np.nan, np.float32)
    partial, owned = {}, []
    for c in range(plan.ctas):
        for pc in plan.pieces(c):
            g, pm, pn = plan.tile_coords(pc.tile)
            r, q = slice(pm * bm, min(M, (pm + 1) * bm)), \
                slice(pn * bn, min(N, (pn + 1) * bn))
            acc = np.zeros((r.stop - r.start, q.stop - q.start), np.float32)
            for s in range(pc.s0, pc.s1):
                k = slice(s * bk, min(K, (s + 1) * bk))
                if k.start < K:
                    acc += a[g, r, k] @ b[g, k, q]
            if pc.first:
                owned.append((c, pc, g, r, q, acc))
            else:
                partial[c] = acc
    for c, pc, g, r, q, acc in owned:
        for c2 in range(c + 1, pc.last_cta + 1):
            acc = acc + partial.pop(c2)
        t = {k: torch.from_numpy(v[g, q] if k == "bias" else v[g, r, q])
             for k, v in kw.items()}
        out[g, r, q] = ref.apply_epilogue_ref(torch.from_numpy(acc), ep,
                                              **t).numpy()
    assert not partial, "a partial was never read"
    assert not np.isnan(out).any(), "an output element was never written"
    return out


@pytest.mark.parametrize("cfg,ctas,groups", [
    (TileConfig(32, 32, 32, schedule="stream_k"), SMS, 1),  # 3 CTAs a tile
    (TileConfig(32, 64, 16, schedule="stream_k"), 8, 1),    # strips span
    (TileConfig(64, 32, 16, split_k=2), 9, 1),              # unaligned
    (TileConfig(32, 32, 32, schedule="stream_k"), 50, 3),
    (TileConfig(32, 64, 16, schedule="stream_k"), 8, 3),
    (TileConfig(64, 32, 16, split_k=2), 11, 3),
], ids=["streamk-132", "streamk-8", "sk2-9", "streamk-50-grouped3",
        "streamk-8-grouped3", "sk2-11-grouped3"])
@pytest.mark.parametrize("ep", EPILOGUES, ids=str)
def test_fixup_emulation_matches_pallas(ep, cfg, ctas, groups):
    """The kernel's walk, dense (the flattened order) and grouped (the
    column walk), each group held to ``matmul_pallas`` in interpret mode
    with the same config (the reference's grouped GEMM is its vmap)."""
    M, N, K = 100, 300, 77
    rng = np.random.default_rng(11)
    a = rng.standard_normal((groups, M, K)).astype(np.float32)
    b = rng.standard_normal((groups, K, N)).astype(np.float32)
    kw = {}
    if ep.bias:
        kw["bias"] = rng.standard_normal((groups, N)).astype(np.float32)
    if ep.activation == "swiglu_gate":
        kw["gate"] = rng.standard_normal((groups, M, N)).astype(np.float32)
    if ep.residual:
        kw["residual"] = rng.standard_normal((groups, M, N)).astype(
            np.float32)
    plan = kmm.work_plan(M, N, K, cfg, groups, ctas)
    assert plan.partials > 0
    assert plan.column_walk == (groups > 1)
    got = _emulate(plan, a, b, ep, kw)
    for g in range(groups):
        want = jops.matmul(
            jnp.asarray(a[g]), jnp.asarray(b[g]), out_dtype=jnp.float32,
            backend="pallas_interpret",
            config=jlat.TileConfig(bm=cfg.bm, bn=cfg.bn, bk=cfg.bk,
                                   split_k=cfg.split_k, group_m=cfg.group_m,
                                   schedule=cfg.schedule),
            epilogue=jlat.Epilogue(bias=ep.bias, activation=ep.activation,
                                   residual=ep.residual),
            **{k: jnp.asarray(v[g]) for k, v in kw.items()})
        np.testing.assert_allclose(got[g], np.asarray(want), rtol=1e-5,
                                   atol=1e-4 * math.sqrt(K))


# ---------------------------------------------------------------------------
# The grouped launch's column walk (ROADMAP C9).
# ---------------------------------------------------------------------------

# qwen3-moe's expert-GEMM gradients at its training shape (E 128, C 160,
# d_model 2048, expert d_ff 768): wu's and wd's dX = dZ W^T, then their
# dW = X^T dZ (wg's are wu's shapes).
QWEN3_BWD = [(160, 2048, 768, 128), (160, 768, 2048, 128),
             (2048, 768, 160, 128), (768, 2048, 160, 128)]
L2_BYTES = 50 * 1024**2


def _flattened_pieces(plan, c):
    """The walk before the column walk: CTA c's units in order, a piece
    for each tile they touch."""
    upt, out = plan.units_per_tile, []
    r = plan.cta_units(c)
    u = r.start
    while u < r.stop:
        t = u // upt
        pe = min(r.stop, (t + 1) * upt)
        out.append(plan._piece(t, u, pe))
        u = pe
    return out


def _flattened(plan):
    return [_flattened_pieces(plan, c) for c in range(plan.ctas)]


@pytest.mark.parametrize("schedule", SCHEDULES[:2], ids=_ids)
@pytest.mark.parametrize("shape", SHAPES + QWEN3_BWD, ids=_ids)
def test_walk_keeps_the_pieces_and_the_boundary_pieces(shape, schedule):
    """The column walk reorders only a CTA's whole tiles: the same pieces
    (tile, k-range, first, last, last_cta) as the flattened walk, its
    first piece first and its last piece last; the dense launch keeps the
    flattened order itself."""
    M, N, K, G = shape
    plan = kmm.work_plan(M, N, K, _config(M, N, K, *schedule), G, SMS)
    assert plan.column_walk == (G > 1 and plan.group_m == 1
                                and plan.tiles_m > 1)
    for c in range(plan.ctas):
        new, old = plan.pieces(c), _flattened_pieces(plan, c)
        assert Counter(new) == Counter(old)
        assert new[0] == old[0] and new[-1] == old[-1]
        assert all(pc.first and pc.last for pc in new[1:-1])
        if not plan.column_walk:
            assert new == old


@pytest.mark.parametrize("shape", QWEN3_BWD[:2], ids=_ids)
def test_grouped_dx_walk_runs_a_column_tiles_row_tiles_in_a_row(shape):
    """At the selected config of qwen3's dX products, a CTA's whole tiles
    of one (expert, column tile) come one after another, their row tiles
    in order up or down, and the columns follow each other in order."""
    M, N, K, G = shape
    cfg = select_gemm_config(M, N, K, in_dtype="bfloat16",
                             out_dtype="bfloat16", hw=GPU_H100_LIKE).config
    plan = kmm.work_plan(M, N, K, cfg, G, SMS)
    runs_seen = 0
    for c in range(plan.ctas):
        coords = [plan.tile_coords(pc.tile) for pc in plan.pieces(c)[1:-1]]
        runs = [list(grp) for _, grp in itertools.groupby(
            coords, key=lambda t: (t[0], t[2]))]
        keys = [(run[0][0], run[0][2]) for run in runs]
        assert len(keys) == len(set(keys)), "a column tile came back"
        assert [n for _, n in keys] == sorted(n for _, n in keys)
        for run in runs:
            rows = [m for _, m, _ in run]
            assert rows in (list(range(rows[0], rows[-1] + 1)),
                            list(range(rows[0], rows[-1] - 1, -1)))
        runs_seen += len(runs)
    assert runs_seen > plan.ctas


def _tile_footprint(plan):
    """The bytes one tile's k-loop touches: its A rows and B columns over
    the whole K, and its bf16 output."""
    return 2 * (plan.bm * plan.K + plan.K * plan.bn + plan.bm * plan.bn)


def test_column_walk_reads_each_experts_w_once_where_the_l2_holds_it():
    """``l2_reckoning`` (an LRU cache of 50 MB shared by the 132 CTAs,
    advancing a piece a step together) at qwen3's dX of wu (K 768): a W
    column tile comes back one tile later, and 132 CTAs touch about 38.8
    MB in one tile, under the L2, so the column walk reads W within 25 %
    of once (the rest where two CTAs share an expert at different times)
    where the flattened walk reads it 3x (once a row tile); dZ's row
    tiles come back a column later and are read again, fewer bytes in
    all.  At wd's dX (K 2048) one tile's footprint is 104 MB: no order of
    a CTA's tiles keeps W, and the walk reads it about 3x too."""
    got = {}
    for M, N, K, G in QWEN3_BWD[:2]:
        cfg = select_gemm_config(M, N, K, in_dtype="bfloat16",
                                 out_dtype="bfloat16",
                                 hw=GPU_H100_LIKE).config
        plan = kmm.work_plan(M, N, K, cfg, G, SMS)
        col = kmm.l2_reckoning(plan, L2_BYTES)
        row = kmm.l2_reckoning(plan, L2_BYTES, walks=_flattened(plan))
        assert col["b_once"] == G * K * N * 2
        got[K] = (SMS * _tile_footprint(plan), col, row)
    fits, col, row = got[768]
    assert fits < L2_BYTES
    assert col["b"] <= 1.25 * col["b_once"]
    assert row["b"] == 3 * row["b_once"]
    assert col["a"] + col["b"] < 0.7 * (row["a"] + row["b"])
    spills, col, row = got[2048]
    assert spills > 2 * L2_BYTES
    assert col["b"] >= 2.5 * col["b_once"]


@pytest.mark.parametrize("shape", QWEN3_BWD[2:], ids=_ids)
def test_column_walk_reads_fewer_bytes_at_the_grouped_dw(shape):
    """qwen3's dW products (K = C = 160, a 403 MB output): the reckoning's
    operand bytes of the column walk under the flattened walk's."""
    M, N, K, G = shape
    cfg = select_gemm_config(M, N, K, in_dtype="bfloat16",
                             out_dtype="bfloat16", hw=GPU_H100_LIKE).config
    plan = kmm.work_plan(M, N, K, cfg, G, SMS)
    col = kmm.l2_reckoning(plan, L2_BYTES)
    row = kmm.l2_reckoning(plan, L2_BYTES, walks=_flattened(plan))
    assert col["out"] == row["out"] == G * M * N * 2
    assert col["a"] + col["b"] < row["a"] + row["b"]
