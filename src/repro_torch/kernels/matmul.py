"""Selector-tiled fused GEMM, dense and grouped: the wrappers over
``csrc/matmul.cu``.

Replaces ``repro/kernels/matmul.py::matmul_pallas`` (:func:`tiled_matmul`)
and ``repro/kernels/ops.py::expert_matmul``, the reference's ``jax.vmap`` of
it over experts (:func:`tiled_expert_matmul`: one launch, the expert axis in
the kernel's work space).  The CUDA kernel runs the selected
:class:`~repro_torch.core.latency.TileConfig` as given: a persistent grid of
one CTA per SM walks the work units that :func:`work_plan` lays out, where
``schedule`` and ``split_k`` decide what a unit is (one k-step under
``stream_k``, one (tile, k-shard) under ``data_parallel``), bm x bn is the
output tile, bk the k-step, group_m the row swizzle; the fused epilogue runs
once per tile, on the full f32 sum.  A tile whose units span several CTAs is
summed deterministically, in k order, from f32 partials in a workspace this
wrapper allocates once per stream (:func:`_scratch`).  The source note in ``csrc/matmul.cu`` says what bounds
the kernel on the H100 and what its design does about it.

:func:`tiled_matmul` and :func:`tiled_expert_matmul` also take the two
operand layouts of the GEMM's backward, each read in place: ``trans_a`` (a
stored (K, M): the weight gradient ``X^T dY`` reads the activation as it
is) and ``trans_b`` (b stored (N, K): the input gradient ``dY W^T`` reads the
weight as it is); grouped, each expert's operand has that layout.
:func:`epilogue_bwd` is the fused epilogue's backward, one elementwise pass
of its own kernel in the same source, dense (M, N) or grouped (E, M, N) with
a bias gradient per expert.

:func:`tiled_matmul` takes the route from the device of its operands: a CPU
tensor gets the plain version (``ref.matmul_ref``), a CUDA tensor the
kernel, and anything else raises; :func:`tiled_expert_matmul` and
:func:`epilogue_bwd` likewise.  ``tiled_matmul.launches``,
``tiled_expert_matmul.launches`` and ``epilogue_bwd.launches`` count each
wrapper's kernel launches; ``tiled_matmul.layout_launches`` and
``tiled_expert_matmul.layout_launches`` split them by layout ("nn", "tn":
trans_a, "nt": trans_b), ``epilogue_bwd.grouped_launches`` counts the
grouped ones.
"""
from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.dtypes import ACC_BYTES
from repro_torch.core.latency import (EPILOGUE_NONE, Epilogue, GemmProblem,
                                      TileConfig, cdiv, grid_shape)
from repro_torch.kernels import build, ref

_TILES = (32, 64, 128, 256)
_ACT_CODES = {None: 0, "gelu": 1, "silu": 2, "swiglu_gate": 3}
_DTYPES = (torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# The work plan: how the persistent kernel cuts the GEMM into units and the
# units into CTAs.  csrc/matmul.cu computes the same partition from the same
# integers (steps_per_tile, steps_per_unit, units_per_cta, ctas).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Piece:
    """The k-steps [s0, s1) of one tile that one CTA sums in registers.
    ``first``: the piece holds the tile's first k-step, so its CTA owns the
    tile's fixup and epilogue; ``last``: it holds the tile's last k-step.
    ``last_cta``: the CTA that holds the tile's last k-step."""
    tile: int
    s0: int
    s1: int
    first: bool
    last: bool
    last_cta: int


@dataclass(frozen=True)
class WorkPlan:
    """The persistent kernel's partition of ``groups`` GEMMs of one shape.

    The iteration space is flattened (group, swizzled tile, k-step); a tile
    has ``steps_per_tile`` k-steps of ``bk`` (``latency.grid_shape``'s Tk,
    split_k shards included).  A unit is ``steps_per_unit`` consecutive
    k-steps of one tile: one k-step under ``stream_k``, one k-shard under
    ``data_parallel``.  CTA ``c`` walks units [c q, (c + 1) q) with
    q = ``units_per_cta`` = ceil(units / min(cores, units)), the strip
    length ``latency.schedule_extra_classes`` prices; consecutive units of
    one tile in one CTA share its accumulator.

    Every CTA whose range starts inside a tile writes one f32 partial
    (bm x bn) of that tile to its workspace slot and raises its flag; the
    CTA holding the tile's first k-step keeps its own sum in registers,
    adds the partials of the CTAs after it in k order and applies the
    epilogue.  ``partials`` counts those writes (each read back once)."""
    M: int
    N: int
    K: int
    bm: int
    bn: int
    bk: int
    groups: int
    tiles_m: int
    tiles_n: int
    steps_per_tile: int
    steps_per_unit: int
    units: int
    units_per_cta: int
    ctas: int
    partials: int
    split_tiles: int
    group_m: int = 1

    @property
    def units_per_tile(self) -> int:
        return self.steps_per_tile // self.steps_per_unit

    @property
    def tiles(self) -> int:
        return self.groups * self.tiles_m * self.tiles_n

    @property
    def partial_bytes(self) -> int:
        """Fixup traffic: each partial written once and read once."""
        return 2 * self.partials * self.bm * self.bn * ACC_BYTES

    @property
    def slot_bytes(self) -> int:
        """One CTA's workspace slot: the kernel's accumulator layout holds
        at least 64 rows and 64 columns."""
        return max(self.bm, 64) * max(self.bn, 64) * ACC_BYTES

    @property
    def workspace_bytes(self) -> int:
        """The workspace the launch uses: a slot per CTA when a tile is
        split (within the wrapper's per-stream scratch, which holds the
        largest tile's slot for every SM)."""
        return self.ctas * self.slot_bytes if self.partials else 0

    def cta_units(self, c: int) -> range:
        q = self.units_per_cta
        return range(c * q, min((c + 1) * q, self.units))

    @property
    def column_walk(self) -> bool:
        """Whether a CTA walks its whole tiles column by column: in the
        grouped launch under ``group_m`` 1, with more than one row tile a
        group (a single row tile shares its column tile with none).  There
        the 132 CTAs run on as many groups at once, so an operand tile that
        comes back many tiles later has left the 50 MB L2.  In the column
        walk a group's B column tile is used by its row tiles one after
        another, and a CTA that shares a group with its neighbour (the
        strips cut groups anywhere) walks that group's columns at the pace
        its neighbour does.  The dense launch keeps the selected
        ``group_m`` swizzle; the kernel takes this choice as given."""
        return self.groups > 1 and self.group_m <= 1 and self.tiles_m > 1

    def _piece(self, t: int, ua: int, ub: int) -> Piece:
        """The piece of tile ``t`` over units [ua, ub)."""
        upt = self.units_per_tile
        tu0, tu1 = t * upt, (t + 1) * upt
        return Piece(t, (ua - tu0) * self.steps_per_unit,
                     (ub - tu0) * self.steps_per_unit, ua == tu0, ub == tu1,
                     (tu1 - 1) // self.units_per_cta)

    def pieces(self, c: int) -> List[Piece]:
        """CTA ``c``'s pieces in the order it runs them (the kernel's
        ``next_piece`` walk).  Its range's first piece (which may start
        mid-tile and become a partial) comes first and its last (which may
        end mid-tile, and whose owner then waits for later CTAs) last, so
        the fixup's order argument holds in either walk; the whole tiles
        between them come in the flattened order or, with
        :attr:`column_walk`, column tile by column tile."""
        upt = self.units_per_tile
        r = self.cta_units(c)
        t0, t1 = r.start // upt, (r.stop - 1) // upt
        first = self._piece(t0, r.start, min(r.stop, (t0 + 1) * upt))
        if t1 == t0:
            return [first]
        last = self._piece(t1, t1 * upt, r.stop)
        return [first, *(self._piece(t, t * upt, (t + 1) * upt)
                         for t in self.middle_tiles(t0 + 1, t1)), last]

    def middle_tiles(self, lo: int, hi: int) -> List[int]:
        """The whole tiles [lo, hi) of a CTA's range in its walk order
        (``csrc/matmul.cu``'s ``walk_column_tile`` runs the same loops).
        With :attr:`column_walk` (flattened tile t = r Tn + n for the
        global row r = group Tm + row): column by column, each column's
        rows of the range in a serpentine, up in even columns and down in
        odd ones, so the row tile at a turn is used twice in a row."""
        if not self.column_walk or hi <= lo:
            return list(range(lo, hi))
        tn, out = self.tiles_n, []
        for n in range(tn):
            rows = range(-(-(lo - n) // tn), (hi - 1 - n) // tn + 1)
            out += [r * tn + n for r in (rows if n % 2 == 0 else rows[::-1])]
        return out

    def tile_coords(self, tile: int) -> Tuple[int, int, int]:
        """Flattened tile -> (group, row tile, column tile) under the
        group_m row swizzle of ``matmul_pallas``'s ``_swizzle``."""
        return (tile // (self.tiles_m * self.tiles_n),
                *_swizzle(tile % (self.tiles_m * self.tiles_n),
                          self.tiles_m, self.tiles_n, self.group_m))


def l2_reckoning(plan: WorkPlan, l2_bytes: int, *, elem: int = 2,
                 out_elem: int = 2,
                 walks: Optional[Sequence[Sequence[Piece]]] = None) -> dict:
    """The HBM bytes a walk of ``plan`` reads, reckoned through an LRU
    cache of ``l2_bytes`` that every CTA shares: the CTAs advance one
    piece a step together (CTA order within a step), each piece touches
    the k-step slices of its tile's A rows and B columns and, when it owns
    the tile, writes its output tile (which takes L2 room until evicted).
    Returns the bytes of A and of B read from HBM beside the bytes of each
    read once (``a_once``, ``b_once``) and the output bytes.  A model of
    reuse distance, not of the card's L2 (two partitions, its own
    replacement).  ``walks`` holds each CTA's pieces in order, the plan's
    own (:meth:`WorkPlan.pieces`) when not given."""
    M, N, K, bm, bn, bk = plan.M, plan.N, plan.K, plan.bm, plan.bn, plan.bk
    lru, held = OrderedDict(), [0]
    got = dict.fromkeys(("a", "b", "a_once", "b_once", "out"), 0)

    def touch(key, nbytes, read):
        if key in lru:
            lru.move_to_end(key)
            return
        if read:
            got[key[0]] += nbytes
        lru[key] = nbytes
        held[0] += nbytes
        while held[0] > l2_bytes:
            held[0] -= lru.popitem(last=False)[1]

    if walks is None:
        walks = [plan.pieces(c) for c in range(plan.ctas)]
    for i in range(max(map(len, walks))):
        for walk in walks:
            if i >= len(walk):
                continue
            pc = walk[i]
            g, pm, pn = plan.tile_coords(pc.tile)
            rows = min(bm, M - pm * bm)
            cols = min(bn, N - pn * bn)
            for st in range(pc.s0, pc.s1):
                depth = min(bk, K - st * bk)
                if depth <= 0:
                    break
                touch(("a", g, pm, st), rows * depth * elem, True)
                touch(("b", g, pn, st), depth * cols * elem, True)
            if pc.first:
                touch(("out", pc.tile), rows * cols * out_elem, False)
                got["out"] += rows * cols * out_elem
    got["a_once"] = plan.groups * M * K * elem
    got["b_once"] = plan.groups * K * N * elem
    return got


def _swizzle(pid: int, Tm: int, Tn: int, group_m: int) -> Tuple[int, int]:
    if group_m <= 1:
        return pid // Tn, pid % Tn
    group_size = group_m * Tn
    first_m = (pid // group_size) * group_m
    rows = min(Tm - first_m, group_m)
    local = pid % group_size
    return first_m + local % rows, local // rows


@functools.lru_cache(maxsize=4096)
def work_plan(M: int, N: int, K: int, cfg: TileConfig, groups: int,
              ctas: int) -> WorkPlan:
    """The partition of ``groups`` (M, K) @ (K, N) GEMMs on ``cfg`` over at
    most ``ctas`` resident CTAs (the device's SM count)."""
    Tm, Tn, Tk = grid_shape(GemmProblem(M, N, K), cfg)
    spu = 1 if cfg.schedule == "stream_k" else Tk // cfg.split_k
    upt = Tk // spu
    units = groups * Tm * Tn * upt
    q = cdiv(units, min(ctas, units))
    grid = cdiv(units, q)
    split = [c * q for c in range(1, grid) if (c * q) % upt]
    return WorkPlan(M=M, N=N, K=K, bm=cfg.bm, bn=cfg.bn, bk=cfg.bk,
                    groups=groups, tiles_m=Tm, tiles_n=Tn,
                    steps_per_tile=Tk, steps_per_unit=spu, units=units,
                    units_per_cta=q, ctas=grid, partials=len(split),
                    split_tiles=len({u // upt for u in split}),
                    group_m=cfg.group_m)


# The f32 kernel's tiling (csrc/matmul.cu: dispatch_f32, launch_f32): one
# consumer warpgroup for bm <= 64, two above, each 64 rows of a pass; a pass
# up to 128 columns wide (a 256-row tile runs as two 128-row passes, a
# 256-wide one as two 128-wide passes); a ring of 32-deep f32 slabs of A
# (the pass's rows) and B (its columns), as many stages as fit beside the
# hi / lo copies of a B slab, the epilogue buffers and the barriers (at
# most 8).
_F32_KS = 32
_MAX_STAGES = 8
_EPI_BYTES = 64 * 40 * 4
SMEM_MAX = 232448


@dataclass(frozen=True)
class F32Tiling:
    """How the f32 (split-TF32) kernel runs a ``TileConfig``: ``nwg``
    consumer warpgroups, passes of ``rows`` x ``pass_n`` (``passes`` of
    them a tile), ring stages ``ks`` deep, ``stages`` of them in ``smem``
    bytes.  The wrapper passes ``stages`` and ``smem`` to the C entry,
    which refuses a launch whose own differ."""
    nwg: int
    rows: int
    pass_n: int
    passes: int
    ks: int
    stages: int
    smem: int


def f32_tiling(cfg: TileConfig, *, trans_a: bool = False,
               trans_b: bool = False) -> F32Tiling:
    """``dispatch_f32`` / ``launch_f32``'s tiling of ``cfg`` (the same in
    every operand layout: TMA boxes hold the slabs as stored)."""
    bm, bn = cfg.bm, cfg.bn
    nwg = 1 if bm <= 64 else 2
    rows, pn = min(bm, 64 * nwg), min(bn, 128)
    fixed = 1024 + 2 * pn * _F32_KS * 4 + nwg * _EPI_BYTES \
        + 2 * _MAX_STAGES * 8
    stage = (rows + pn) * _F32_KS * 4
    stages = min(_MAX_STAGES, (SMEM_MAX - fixed) // stage)
    return F32Tiling(nwg=nwg, rows=rows, pass_n=pn,
                     passes=(bm // rows) * (bn // pn), ks=_F32_KS,
                     stages=stages, smem=fixed + stages * stage)


def matmul_plain(a, b, cfg: TileConfig, *, out_dtype, epilogue=None,
                 bias=None, gate=None, residual=None, trans_a=False,
                 trans_b=False) -> torch.Tensor:
    """The plain version: what the kernel computes, whatever the tiling
    (``trans_a`` / ``trans_b``: the operand is stored transposed)."""
    return ref.matmul_ref(a.t() if trans_a else a, b.t() if trans_b else b,
                          out_dtype, epilogue=epilogue, bias=bias,
                          gate=gate, residual=residual)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, cfg: TileConfig, *,
                 out_dtype: torch.dtype,
                 epilogue: Optional[Epilogue] = None,
                 bias: Optional[torch.Tensor] = None,
                 gate: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 trans_a: bool = False,
                 trans_b: bool = False) -> torch.Tensor:
    """C = epilogue(A @ B) (M, N); bias (N,), gate/residual (M, N).  A is
    ``a`` (M, K), or ``a.t()`` for a stored (K, M) with ``trans_a``; B is
    ``b`` (K, N), or ``b.t()`` for b stored (N, K) with ``trans_b``."""
    if a.device.type in ref.PLAIN_DEVICES:
        return matmul_plain(a, b, cfg, out_dtype=out_dtype,
                            epilogue=epilogue, bias=bias, gate=gate,
                            residual=residual, trans_a=trans_a,
                            trans_b=trans_b)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul: unsupported device {a.device}")
    return _launch_cuda(a, b, cfg, out_dtype=out_dtype, epilogue=epilogue,
                        bias=bias, gate=gate, residual=residual,
                        trans_a=trans_a, trans_b=trans_b)


tiled_matmul.launches = 0
tiled_matmul.layout_launches = {"nn": 0, "tn": 0, "nt": 0}


def expert_matmul_plain(x, w, cfg: TileConfig, *, out_dtype, epilogue=None,
                        bias=None, gate=None, residual=None, trans_a=False,
                        trans_b=False) -> torch.Tensor:
    """The plain version of the grouped kernel, as the reference's
    ``expert_matmul`` (``repro/kernels/ops.py:333-339``): an f32-accumulated
    per-expert product, then the epilogue with bias broadcast over rows
    (``trans_a`` / ``trans_b``: each expert's operand is stored
    transposed)."""
    ep = epilogue or EPILOGUE_NONE
    xe = x.transpose(1, 2) if trans_a else x
    we = w.transpose(1, 2) if trans_b else w
    acc = torch.einsum("emk,ekn->emn", xe.float(), we.float())
    acc = ref.apply_epilogue_ref(
        acc, ep, bias=bias[:, None, :] if bias is not None else None,
        gate=gate, residual=residual)
    return acc.to(out_dtype)


def tiled_expert_matmul(x: torch.Tensor, w: torch.Tensor, cfg: TileConfig,
                        *, out_dtype: torch.dtype,
                        epilogue: Optional[Epilogue] = None,
                        bias: Optional[torch.Tensor] = None,
                        gate: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None,
                        trans_a: bool = False, trans_b: bool = False
                        ) -> torch.Tensor:
    """out[e] = epilogue(X[e] @ W[e]) for X (E, M, K), W (E, K, N); bias
    (E, N), gate/residual (E, M, N).  X is ``x``, or x stored (E, K, M)
    with ``trans_a``; W is ``w``, or w stored (E, N, K) with ``trans_b``.
    One launch for all E experts."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias, gate=gate,
              residual=residual, trans_a=trans_a, trans_b=trans_b)
    if x.device.type in ref.PLAIN_DEVICES:
        return expert_matmul_plain(x, w, cfg, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"tiled_expert_matmul: unsupported device "
                         f"{x.device}")
    return _launch_expert_cuda(x, w, cfg, **kw)


tiled_expert_matmul.launches = 0
tiled_expert_matmul.layout_launches = {"nn": 0, "tn": 0, "nt": 0}


def _layout(trans_a: bool, trans_b: bool) -> str:
    return "tn" if trans_a else "nt" if trans_b else "nn"


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % n
    return F.pad(x, (0, pad)) if pad else x


def _launch_cuda(a, b, cfg, *, out_dtype, epilogue, bias, gate, residual,
                 trans_a=False, trans_b=False):
    """The dense launch: the grouped kernel with one group."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"tiled_matmul: operands {tuple(a.shape)}, "
                         f"{tuple(b.shape)} are not matrices")
    out = _launch_groups(
        "tiled_matmul", a[None], b[None], cfg, grouped=False,
        out_dtype=out_dtype,
        epilogue=epilogue, bias=None if bias is None else bias[None],
        gate=None if gate is None else gate[None],
        residual=None if residual is None else residual[None],
        trans_a=trans_a, trans_b=trans_b)
    tiled_matmul.launches += 1
    tiled_matmul.layout_launches[_layout(trans_a, trans_b)] += 1
    return out[0]


def _launch_expert_cuda(x, w, cfg, *, out_dtype, epilogue, bias, gate,
                        residual, trans_a=False, trans_b=False):
    out = _launch_groups("tiled_expert_matmul", x, w, cfg, grouped=True,
                         out_dtype=out_dtype, epilogue=epilogue, bias=bias,
                         gate=gate, residual=residual, trans_a=trans_a,
                         trans_b=trans_b)
    tiled_expert_matmul.launches += 1
    tiled_expert_matmul.layout_launches[_layout(trans_a, trans_b)] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# A slot of the largest tile (256 x 256 f32 partials) for every SM, then a
# flag (an int) for every SM: what any work plan on the device can use.
_SLOT_BYTES_MAX = 256 * 256 * ACC_BYTES
_SCRATCH = {}


def _scratch(device: torch.device,
             stream: torch.cuda.Stream) -> Tuple[int, int, torch.Tensor]:
    """One stream's fixup scratch: (workspace pointer, flags pointer, flags).

    A launch writes the workspace slots it reads back, and each flag is
    raised by one CTA and lowered by the one CTA that waits on it, in the
    same launch, so the flags are zero between launches; the launches that
    share the scratch are the stream's own, which run in order.  It is
    allocated once and never replaced, so a CUDA graph that captured its
    address stays valid.  Under graph capture the stream is the capture
    stream: the scratch then comes from the graph's pool (its flags zeroed
    by a node of that graph), and graphs captured on one stream share it,
    so replay them in order, as graphs that share a memory pool."""
    key = (device.index, stream.cuda_stream)
    got = _SCRATCH.get(key)
    if got is None:
        sms = _sm_count(device.index)
        buf = torch.empty(sms * (_SLOT_BYTES_MAX + 4), dtype=torch.uint8,
                          device=device)
        flags = buf[sms * _SLOT_BYTES_MAX:].view(torch.int32)
        flags.zero_()
        got = _SCRATCH[key] = (buf.data_ptr(), flags.data_ptr(), flags)
    return got


def _launch_groups(what, a, b, cfg, *, grouped, out_dtype, epilogue, bias,
                   gate, residual, trans_a=False, trans_b=False):
    """Check and launch ``csrc/matmul.cu`` on G problems of one shape: a
    (G, M, K), b (G, K, N), bias (G, N), gate/residual (G, M, N).
    ``grouped`` picks the grouped kernel (its own name in a trace).  a may
    be stored (G, K, M) (``trans_a``) or b stored (G, N, K) (``trans_b``):
    the kernel reads each group's operand in place."""
    ep = epilogue or EPILOGUE_NONE
    if trans_a and trans_b:
        raise ValueError(f"{what}: trans_a and trans_b together are not "
                         f"taken (the backward needs one or the other)")
    a_mk = a.transpose(1, 2) if trans_a else a          # logical (G, M, K)
    b_kn = b.transpose(1, 2) if trans_b else b          # logical (G, K, N)
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a_mk.shape[2] != b_kn.shape[1]:
        raise ValueError(f"{what}: shapes {tuple(a_mk.shape)} @ "
                         f"{tuple(b_kn.shape)} are not (G, M, K) @ (G, K, N)")
    G, M, K = a_mk.shape
    N = b_kn.shape[2]
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"{what}: inputs must both be bf16 or f32, "
                         f"got {a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"{what}: out_dtype {out_dtype} not in {_DTYPES}")
    if cfg.bm not in _TILES or cfg.bn not in _TILES or cfg.bk % 16 \
            or cfg.bk <= 0 or cfg.group_m < 1:
        raise ValueError(f"{what}: config {cfg} outside the kernel's "
                         f"menu (bm, bn in {_TILES}; bk a multiple of 16)")
    ops = {"bias": bias, "gate": gate, "residual": residual}
    want = {"bias": ep.bias, "gate": ep.activation == "swiglu_gate",
            "residual": ep.residual}
    for name, t in ops.items():
        if want[name] != (t is not None):
            raise ValueError(f"{what}: epilogue {ep} vs {name} "
                             f"operand {'missing' if t is None else 'given'}")
    ep_dtype = next((t.dtype for t in ops.values() if t is not None), a.dtype)
    for name, t in ops.items():
        if t is None:
            continue
        shape = (G, N) if name == "bias" else (G, M, N)
        if tuple(t.shape) != shape or t.dtype != ep_dtype \
                or t.dtype not in _DTYPES:
            raise ValueError(f"{what}: {name} must be {shape} in one "
                             f"dtype of {_DTYPES}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for t in (b, *ops.values()):
        if t is not None and t.device != a.device:
            raise ValueError(f"{what}: operands on different devices")
    for name, t in (("a", a), ("b", b), *ops.items()):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")

    # 16-byte loads need K and N to be multiples of 8 elements (4 for f32);
    # pad with zeros where they are not (never on the served or trained
    # paths).  A stored (K, M) is read in rows of M: M must be such a
    # multiple too.
    vec = 4 if a.dtype == torch.float32 else 8
    if trans_a and M % vec:
        raise ValueError(f"{what}: a stored (K, M) needs M a multiple of "
                         f"{vec} ({a.dtype} rows of 16-byte multiples), got "
                         f"M = {M}")
    Kp, Np = K + (-K) % vec, N + (-N) % vec
    if Kp != K:
        a = F.pad(a, (0, 0, 0, Kp - K)) if trans_a else _pad_last(a, vec)
        b = _pad_last(b, vec) if trans_b else F.pad(b, (0, 0, 0, Kp - K))
    if Np != N:
        b = F.pad(b, (0, 0, 0, Np - N)) if trans_b else _pad_last(b, vec)
        ops = {k: (_pad_last(t, vec).contiguous() if t is not None else None)
               for k, t in ops.items()}
    # TMA wants 16-byte aligned operands; the epilogue's paired loads want
    # 8-byte aligned ones (views of stacked params may sit at any offset).
    for t in (a, b):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operand not 16-byte aligned")
    ops = {k: (t.clone() if t is not None and t.data_ptr() % 8 else t)
           for k, t in ops.items()}
    out = torch.empty((G, M, Np), dtype=out_dtype, device=a.device)
    dev = a.device
    plan = work_plan(M, Np, Kp, cfg, G, _sm_count(dev.index))

    f32 = f32_tiling(cfg, trans_a=trans_a, trans_b=trans_b) \
        if a.dtype == torch.float32 else None

    lib = build.load("matmul")
    fn = lib.repro_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 23 \
            + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def ptr(t):
        return t.data_ptr() if t is not None else None

    def stride(t):
        return t.stride(0) if t is not None and G > 1 else 0

    stream = torch.cuda.current_stream(dev)
    ws, flags, _ = _scratch(dev, stream)
    args = (ptr(a), ptr(b), ptr(out), ptr(ops["bias"]), ptr(ops["gate"]),
            ptr(ops["residual"]), ws, flags,
            M, Np, Kp, cfg.bm, cfg.bn, cfg.bk, cfg.group_m,
            int(a.dtype == torch.float32), int(out_dtype == torch.float32),
            int(ep_dtype == torch.float32),
            int(ep.bias), _ACT_CODES[ep.activation], int(ep.residual),
            G, int(grouped), int(trans_a), int(trans_b),
            plan.steps_per_tile, plan.steps_per_unit,
            plan.units_per_cta, plan.ctas,
            f32.stages if f32 else 0, f32.smem if f32 else 0,
            stride(a), stride(b), stride(out), stride(ops["bias"]),
            stride(ops["gate"]), stride(ops["residual"]), stream.cuda_stream)
    # The C entry launches on the current device; switch only when the
    # operands live on another (the switch costs microseconds a call on
    # the host-bound decode path).
    if dev.index == torch.cuda.current_device():
        code = fn(*args)
    else:
        with torch.cuda.device(dev):
            code = fn(*args)
    build.check(lib, code, f"{what} {G}x{M}x{N}x{K} {cfg}")
    return out[..., :N] if Np != N else out


# ---------------------------------------------------------------------------
# The epilogue's backward: one elementwise pass (``csrc/matmul.cu``,
# ``epilogue_bwd_kernel``).
# ---------------------------------------------------------------------------

# Rows a CTA walks when no bias sum needs every row in one CTA: enough CTAs
# to cover the card at the training shapes (M 2048: 32 row blocks).
_EPI_BWD_ROWS = 64


def epilogue_bwd_plain(dout, z, *, epilogue, gate=None, dz_dtype,
                       want_bias=False):
    """The plain version: ``ref.epilogue_bwd_ref`` (elementwise on any
    shape; dbias sums the rows of each group)."""
    return ref.epilogue_bwd_ref(dout, z, epilogue, gate=gate,
                                dz_dtype=dz_dtype, want_bias=want_bias)


def epilogue_bwd(dout: torch.Tensor, z: Optional[torch.Tensor], *,
                 epilogue: Epilogue, gate: Optional[torch.Tensor] = None,
                 dz_dtype: torch.dtype, want_bias: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            Optional[torch.Tensor]]:
    """(dz, dgate, dbias) of the fused epilogue for dout (M, N), the f32
    pre-activation z = A B (+ bias) (M, N) (None when the epilogue has no
    activation) and the swiglu gate (M, N): dz in ``dz_dtype`` (dout itself
    without an activation), dgate in the gate's dtype, dbias (N,) f32 when
    ``want_bias``.  Grouped (the grouped GEMM's backward), every operand is
    (E, M, N) and dbias (E, N), each expert's rows summed apart.  The
    residual's gradient is dout and needs no kernel."""
    if dout.device.type in ref.PLAIN_DEVICES:
        return epilogue_bwd_plain(dout, z, epilogue=epilogue, gate=gate,
                                  dz_dtype=dz_dtype, want_bias=want_bias)
    if dout.device.type != "cuda":
        raise ValueError(f"epilogue_bwd: unsupported device {dout.device}")
    return _launch_epilogue_bwd_cuda(dout, z, epilogue=epilogue, gate=gate,
                                     dz_dtype=dz_dtype, want_bias=want_bias)


epilogue_bwd.launches = 0
epilogue_bwd.grouped_launches = 0


def _launch_epilogue_bwd_cuda(dout, z, *, epilogue, gate, dz_dtype,
                              want_bias):
    ep = epilogue
    act = _ACT_CODES[ep.activation]
    if dout.dim() not in (2, 3):
        raise ValueError(f"epilogue_bwd: dout {tuple(dout.shape)} is not "
                         f"(M, N) or (E, M, N)")
    shape = tuple(dout.shape)
    G, M, N = shape if dout.dim() == 3 else (1, *shape)
    if act == 0 and not want_bias:
        return dout.to(dz_dtype), None, None
    if N % 2:
        raise ValueError(f"epilogue_bwd: N = {N} must be even (the kernel "
                         f"takes column pairs)")
    for name, t, dts in (("dout", dout, _DTYPES), ("z", z, (torch.float32,)),
                         ("gate", gate, _DTYPES)):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype not in dts \
                or t.device != dout.device or not t.is_contiguous():
            raise ValueError(f"epilogue_bwd: {name} must be a contiguous "
                             f"{shape} tensor in {dts} on {dout.device}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if dz_dtype not in _DTYPES:
        raise ValueError(f"epilogue_bwd: dz dtype {dz_dtype} not in "
                         f"{_DTYPES}")
    if act and z is None:
        raise ValueError(f"epilogue_bwd: {ep} needs the pre-activation z")
    if (act == _ACT_CODES["swiglu_gate"]) != (gate is not None):
        raise ValueError(f"epilogue_bwd: {ep} vs gate operand")
    dev = dout.device
    dz = torch.empty(shape, dtype=dz_dtype, device=dev) if act else None
    dgate = torch.empty_like(gate) if gate is not None else None
    dbias = torch.empty(shape[:-2] + (N,), dtype=torch.float32, device=dev) \
        if want_bias else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = build.load("matmul")
    fn = lib.repro_epilogue_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # Without a bias sum the pass is elementwise over all G M rows; with
    # one, each group's M rows are one CTA's.
    groups, m, rows = (G, M, M) if want_bias else (1, G * M, _EPI_BWD_ROWS)
    with torch.cuda.device(dev):
        code = fn(ptr(dout), ptr(z), ptr(gate), ptr(dz), ptr(dgate),
                  ptr(dbias), m, N, groups, act,
                  int(want_bias), int(dout.dtype == torch.float32),
                  int(gate is not None and gate.dtype == torch.float32),
                  int(dz_dtype == torch.float32), rows,
                  torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, f"epilogue_bwd {shape} {ep}")
    epilogue_bwd.launches += 1
    epilogue_bwd.grouped_launches += int(dout.dim() == 3)
    return (dz if act else dout.to(dz_dtype)), dgate, dbias
