"""Event-level Pallas-grid simulator — independent ground truth for Fig. 3.

The selection-efficiency benchmark (paper §V-A) needs a "measured" latency per
candidate that the selector did NOT use to rank.  On GPU the paper measures
wall clock; in this CPU container we substitute this simulator, which models
the machine at a strictly finer granularity than the closed-form model in
``latency.py``:

* exact edge-block DMA bytes (Pallas fetches the real slice; compute always
  runs the full padded block),
* exact revisit skips at tile boundaries in the true grid iteration order
  (grouped or row-major, k innermost),
* an explicit two-stage max-plus pipeline recurrence with finite buffer depth
  (``hw.pipeline_depth``), not a steady-state max(),
* output writebacks consume the same DMA-engine port capacity as input
  fetches but do not stall queued fetches behind the tile's compute (a
  reordering DMA queue never idles with work pending; completion is
  tracked separately and carries the accumulate data dependency),
* in-kernel split-K: the grid is ``(tiles, sk, Tk)`` and the f32 accumulator
  carries across all of a tile's k-shards, so there is no HBM partial buffer
  and no combine pass — only the per-shard K padding,
* fused epilogue operands (bias / gate / residual) fetched once per output
  tile at the flush,
* per-level byte counters on multi-level topologies: each re-fetched
  operand panel's *measured* reuse distance decides which cache level
  serves it — event-by-event, not the latency model's closed-form windows
  — and the fetch is timed at that level's bandwidth (single-core: bytes
  streamed since last use, an upper-bound stack-distance proxy;
  multi-core: the exact LRU stack distance over distinct panels),
* multi-core topologies (``Topology.total_cores() > 1``): work units are
  scheduled round-robin over the cores — one (tile, k-shard) per unit under
  ``data_parallel``, contiguous k-step strips under ``stream_k`` — so the
  measured wave count (max units on any core) cross-checks the closed-form
  Alg. 4 wave model; reuse distances are measured against a chip-wide LRU
  for device-scoped caches and per-partition LRUs for partition-scoped
  ones (cores are blocked per partition within a wave); each memory port's
  bandwidth is shared over the cores actually fetching from it within a
  wave (fetch-stream population — the uniform-mixing limit of which is the
  closed-form model's per-level convention); data-parallel split-K shards
  write block partials that a per-tile combine re-reads, and stream-K
  strips pay a partial fixup at every strip boundary that is not
  tile-aligned — mirroring the schedules the model prices.

It shares nothing with ``latency.py`` but the Topology constants.

Per-tile O(1) fast path: within one output tile's k-loop, fetch and compute
times are constant (edges depend on (m, n) only; no revisit while k varies),
so the pipeline recurrence settles to a linear regime after a few steps.  We
simulate the first ``_EXPLICIT`` steps of each tile exactly and extend by the
settled slope — this keeps the simulator exact while making whole-sweep
benchmarks tractable on CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import chain
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dtypes import ACC_BYTES, DTYPE_BYTES
from repro_torch.core.latency import GemmProblem, TileConfig, cdiv
from repro_torch.core.topology import HardwareSpec, MemoryLevel, reference_dtype

_EXPLICIT = 3  # pipeline steps simulated exactly at each tile start


class _LruStack:
    """Exact LRU stack distances over a stream of (key, bytes) uses.

    The stack distance of a key is the summed size of the DISTINCT keys
    touched since its last use — the residency criterion of an ideal
    fully-associative LRU cache (repeat fetches of the same panel do not
    grow the working set).  Implemented as a Fenwick tree over the use
    order so both ``use`` and ``distance`` are O(log n): each key holds
    one live slot at its last-use position; moving a key re-zeroes its old
    slot and appends a new one."""

    __slots__ = ("tree", "n", "cursor", "total", "pos", "size")

    def __init__(self, n_slots: int = 1024):
        self.n = max(n_slots, 16)
        self.tree = [0.0] * (self.n + 1)
        self.cursor = 0
        self.total = 0.0
        self.pos: Dict = {}
        self.size: Dict = {}

    def _add(self, i: int, v: float) -> None:
        while i <= self.n:
            self.tree[i] += v
            i += i & -i

    def _prefix(self, i: int) -> float:
        s = 0.0
        while i > 0:
            s += self.tree[i]
            i -= i & -i
        return s

    def distance(self, key):
        """Bytes of distinct keys used strictly after ``key``'s last use,
        or None if the key was never used."""
        p = self.pos.get(key)
        if p is None:
            return None
        return self.total - self._prefix(p)

    def use(self, key, bytes_: float) -> None:
        p = self.pos.pop(key, None)
        if p is not None:
            old = self.size.pop(key)
            self._add(p, -old)
            self.total -= old
        if self.cursor >= self.n:             # grow: rebuild compacted
            live = sorted(self.pos, key=self.pos.get)
            self.n = max(2 * self.n, 2 * len(live) + 16)
            self.tree = [0.0] * (self.n + 1)
            self.cursor = 0
            for k in live:
                self.cursor += 1
                self.pos[k] = self.cursor
                self._add(self.cursor, self.size[k])
        self.cursor += 1
        self._add(self.cursor, bytes_)
        self.total += bytes_
        self.pos[key] = self.cursor
        self.size[key] = bytes_


@dataclass(frozen=True)
class SimResult:
    time: float          # seconds, end-to-end kernel latency
    hbm_bytes: float     # bytes moved, all levels + writebacks (legacy view)
    mxu_busy: float      # seconds the MXU was computing (chip-equivalent)
    steps: int
    # Bytes served from each memory level (backing + caches).  On a 1-level
    # chain the single entry equals hbm_bytes.
    level_bytes: Mapping[str, float] = field(default_factory=dict)
    # Occupancy cross-check (Alg. 4): schedulable work units, the measured
    # wave count (max units landed on any core by the round-robin
    # scheduler), and the core count they were spread over.  Single-core
    # chains report units == waves, cores == 1.
    units: int = 0
    waves: int = 0
    cores: int = 1

    @property
    def tflops(self) -> float:          # filled by caller via problem
        raise AttributeError("use problem.flops / result.time")


def _tile_order(Tm: int, Tn: int, group_m: int) -> Iterator[Tuple[int, int]]:
    """The kernel's (m, n) iteration order: row-major, or grouped rows with m
    innermost inside each group (Triton's grouped ordering)."""
    if group_m <= 1:
        for i in range(Tm):
            for j in range(Tn):
                yield i, j
        return
    g = group_m
    for i0 in range(0, Tm, g):
        hi = min(i0 + g, Tm)
        for j in range(Tn):
            for i in range(i0, hi):
                yield i, j


def simulate_gemm(p: GemmProblem, t: TileConfig, hw: HardwareSpec,
                  events: Optional[List[Tuple]] = None) -> SimResult:
    """Dispatch: the event-level single-core pipeline (bit-identical to the
    single-core model) on 1-core chains; the round-robin multi-core scheduler
    otherwise.

    ``events`` (optional) collects the priced timeline as
    ``(track, name, t_start, t_end, args)`` tuples — one span per DMA
    fetch / compute step / writeback on the single-core pipeline (bulk
    fast-path regions appear as one aggregated span), one span per
    fetch/write event per core on multi-core chains.  Capture is append-
    only: the priced ``SimResult`` is bit-identical with or without it
    (``repro_torch.obs.perfetto`` renders the list as Perfetto tracks)."""
    if hw.total_cores() > 1:
        return _simulate_multicore(p, t, hw, events)
    return _simulate_single_core(p, t, hw, events)


def _simulate_single_core(p: GemmProblem, t: TileConfig,
                          hw: HardwareSpec,
                          events: Optional[List[Tuple]] = None) -> SimResult:
    bi = DTYPE_BYTES[p.in_dtype]
    bo = DTYPE_BYTES[p.out_dtype]
    mm, mn, mk = hw.mxu_shape
    bw = hw.hbm_bandwidth

    k_extent = cdiv(p.K, t.split_k)           # k span per split
    Tm, Tn = cdiv(p.M, t.bm), cdiv(p.N, t.bn)
    Tk = cdiv(k_extent, t.bk)

    # Full-block compute time: Pallas pads edge blocks in VMEM, the MXU always
    # chews the full (bm, bn, bk) block; VMEM port moves block + accumulator.
    atoms = cdiv(t.bm, mm) * cdiv(t.bn, mn) * cdiv(t.bk, mk)
    ct_mxu = atoms * (2.0 * mm * mn * mk) / hw.flops(p.in_dtype)
    ct_vmem = ((t.bm * t.bk + t.bk * t.bn) * bi
               + 2 * t.bm * t.bn * ACC_BYTES) / hw.vmem_bandwidth
    ct = max(ct_mxu, ct_vmem)

    # Multi-level state: measured reuse distances decide the serving level.
    # ``clock`` counts bytes streamed into staging (an LRU stack-distance
    # proxy); a panel re-fetched after fewer bytes than a cache level's
    # budget is served from that level at its bandwidth.
    caches = hw.cache_levels
    backing = hw.backing
    level_bytes = {lvl.name: 0.0 for lvl in hw.levels[:-1]}
    clock = 0.0
    last_a = {}                                # (batch, i, s) -> clock
    last_b = {}                                # (batch, j, s) -> clock

    def panel_level(last, key):
        prev = last.get(key)
        if prev is not None:
            dist = clock - prev
            for lvl in reversed(caches):
                if dist <= lvl.budget():
                    return lvl
        return backing

    # Pipeline state.
    depth = hw.pipeline_depth
    dma_cursor = hw.kernel_launch + hw.hbm_latency   # DMA engine free-time
    out_cursor = 0.0                                 # last flush completion
    comp_hist: List[float] = []                      # compute end times (ring)
    comp_cursor = 0.0
    total_bytes = 0.0
    mxu_busy = 0.0
    n_steps = 0

    def run_step(fetch_bytes: float, fetch_seconds: float) -> None:
        nonlocal dma_cursor, comp_cursor, total_bytes, mxu_busy, n_steps, clock
        # DMA may start once its target buffer was drained `depth` steps ago.
        gate = comp_hist[-depth] if len(comp_hist) >= depth else 0.0
        if fetch_bytes > 0:
            dma_start = max(dma_cursor, gate)
            dma_cursor = dma_start + fetch_seconds + hw.dma_fixed
            ready = dma_cursor
            if events is not None:
                events.append(("dma", "fetch", dma_start, dma_cursor,
                               {"bytes": fetch_bytes}))
        else:
            ready = gate                              # fully revisited step
        comp_cursor = max(comp_cursor, ready) + ct
        if events is not None:
            events.append(("core0", "compute", comp_cursor - ct,
                           comp_cursor, None))
        comp_hist.append(comp_cursor)
        if len(comp_hist) > depth + 1:
            del comp_hist[0]
        total_bytes += fetch_bytes
        clock += fetch_bytes
        mxu_busy += ct
        n_steps += 1

    def write_back(bytes_: float) -> None:
        # The flush waits for the tile's accumulate (data dependency) and
        # consumes port bandwidth, but does NOT stall the next tile's
        # already-queued input fetches: a reordering DMA queue never idles
        # with fetch work pending (Pallas double-buffers output windows on
        # the outbound stream).  Port capacity is reserved order-free
        # (``dma_cursor += port_s``, same engine total as before); only
        # the completion time ``out_cursor`` carries the data dependency.
        # The old ``start = max(dma_cursor, comp_cursor)`` convention put
        # an engine-idle bubble + refill in front of EVERY output tile —
        # the oracle fidelity harness exposed it as a per-tile straggler
        # artifact the continuous grid pipeline does not have.
        nonlocal dma_cursor, out_cursor, total_bytes, clock
        port_s = bytes_ / bw + hw.dma_fixed
        dma_cursor += port_s
        out_cursor = max(out_cursor, comp_cursor + port_s, dma_cursor)
        if events is not None:
            events.append(("dma", "write_back", dma_cursor - port_s,
                           dma_cursor, {"bytes": bytes_}))
        total_bytes += bytes_
        clock += bytes_                               # writes evict too
        level_bytes[backing.name] += bytes_

    ep = p.epilogue
    for e in range(p.batch):
        prev_a = prev_b = None
        for (i, j) in _tile_order(Tm, Tn, t.group_m):
            em = min(t.bm, p.M - i * t.bm)            # real edge extents
            en = min(t.bn, p.N - j * t.bn)
            # k-shards run back-to-back inside the tile (grid (tiles, sk, Tk),
            # s middle, k inner); the accumulator carries across all of them.
            for s in range(t.split_k):
                if caches:
                    lvl_a = panel_level(last_a, (e, i, s))
                    lvl_b = panel_level(last_b, (e, j, s))
                    bw_a, bw_b = lvl_a.bandwidth, lvl_b.bandwidth
                else:
                    lvl_a = lvl_b = backing
                    bw_a = bw_b = bw
                k_lo = s * k_extent
                k_hi = min(p.K, (s + 1) * k_extent)
                # Per-step fetch bytes within this shard (constant over k).
                steps_here = Tk
                first_fetches: List[Tuple[float, float]] = []
                for kk in range(min(steps_here, _EXPLICIT)):
                    ek = max(0, min(t.bk, (k_hi - k_lo) - kk * t.bk))
                    a_idx, b_idx = (i, s, kk), (s, kk, j)
                    fa = 0.0 if a_idx == prev_a else em * ek * bi
                    fb = 0.0 if b_idx == prev_b else ek * en * bi
                    prev_a, prev_b = a_idx, b_idx
                    first_fetches.append((fa, fb))
                for fa, fb in first_fetches:
                    level_bytes[lvl_a.name] += fa
                    level_bytes[lvl_b.name] += fb
                    secs = ((fa + fb) / bw if not caches
                            else fa / bw_a + fb / bw_b)
                    run_step(fa + fb, secs)
                rest = steps_here - len(first_fetches)
                if rest > 0:
                    # Settled linear regime: constant fetch (interior k) and
                    # constant compute -> both cursors advance by the slope.
                    fa = em * t.bk * bi
                    fb = t.bk * en * bi
                    f = (em * t.bk + t.bk * en) * bi
                    sf = f / bw if not caches else fa / bw_a + fb / bw_b
                    # last k block may be ragged; simulate it explicitly
                    ragged = (k_hi - k_lo) % t.bk
                    bulk = rest - (1 if ragged else 0)
                    if bulk > 0:
                        slope = max(sf + hw.dma_fixed, ct)
                        if events is not None:
                            dma0, comp0 = dma_cursor, comp_cursor
                        dma_cursor += bulk * (sf + hw.dma_fixed)
                        comp_cursor = max(comp_cursor + bulk * ct,
                                          dma_cursor + ct)
                        comp_cursor = max(comp_cursor,
                                          (comp_hist[-1] if comp_hist else 0)
                                          + bulk * slope)
                        if events is not None:
                            events.append(("dma", "fetch[bulk]", dma0,
                                           dma_cursor,
                                           {"steps": bulk,
                                            "bytes": bulk * f}))
                            events.append(("core0", "compute[bulk]", comp0,
                                           comp_cursor, {"steps": bulk}))
                        comp_hist.append(comp_cursor)
                        if len(comp_hist) > depth + 1:
                            del comp_hist[0]
                        total_bytes += bulk * f
                        clock += bulk * f
                        level_bytes[lvl_a.name] += bulk * fa
                        level_bytes[lvl_b.name] += bulk * fb
                        mxu_busy += bulk * ct
                        n_steps += bulk
                        prev_a = (i, s, steps_here - (2 if ragged else 1))
                        prev_b = (s, steps_here - (2 if ragged else 1), j)
                    if ragged:
                        ek = ragged
                        a_idx = (i, s, steps_here - 1)
                        b_idx = (s, steps_here - 1, j)
                        fa = em * ek * bi
                        fb = ek * en * bi
                        prev_a, prev_b = a_idx, b_idx
                        level_bytes[lvl_a.name] += fa
                        level_bytes[lvl_b.name] += fb
                        secs = ((fa + fb) / bw if not caches
                                else fa / bw_a + fb / bw_b)
                        run_step(fa + fb, secs)
                if caches:
                    last_a[(e, i, s)] = clock
                    last_b[(e, j, s)] = clock
            # Epilogue operand fetch + single accumulator flush per tile
            # (split-K included: no HBM partials, no combine pass).
            e_fetch = (ep.n_mn_operands * em * en
                       + (en if ep.bias else 0)) * bi
            write_back(em * en * bo + e_fetch)

    end = max(comp_cursor, dma_cursor, out_cursor)
    units = Tm * Tn * p.batch * t.split_k
    return SimResult(time=end, hbm_bytes=total_bytes,
                     mxu_busy=mxu_busy, steps=n_steps,
                     level_bytes=level_bytes,
                     units=units, waves=units, cores=1)


@dataclass
class _PlacedGrid:
    """Pass-1 (placement) record for one candidate on a multi-core chain:
    the priced-event streams plus every counter the pricing convention
    leaves untouched (``tests/test_wave_model.py`` pins the counters).
    Fetch spans carry level INDICES into ``hw.levels`` so the batched
    pricer can stack candidates into flat numpy columns."""

    ct: float                    # per-core full-block step compute seconds
    fetch_events: List[Tuple]    # (core, wave, n_empty, nfull, fa_full,
                                 #  fb_full, fa_rag, fb_rag, ia, ib)
    write_events: List[Tuple]    # (core, wave, bytes, level index)
    level_bytes: Dict[str, float]
    total_bytes: float
    mxu_busy: float
    n_steps: int
    units: int
    waves: int


def _simulate_multicore(p: GemmProblem, t: TileConfig,
                        hw: HardwareSpec,
                        events: Optional[List[Tuple]] = None) -> SimResult:
    """Round-robin multi-core scheduler over the chip's cores.

    Compute rates are the chip aggregates shared evenly (MXU: peak/C,
    staging port: bandwidth/C — cores own their compute, static share is
    physical).  Memory-port bandwidth is shared over the cores *actually
    fetching from that level within the same wave* (fetch-stream
    population): a lone core streaming compulsory panels from HBM while
    the rest of the wave hits cache gets (nearly) the full HBM rate, not a
    1/C sliver.  The calibration subsystem's oracle harness exposed the
    older all-C static share as a straggler artifact — one first-touch
    unit per wave priced at C x the HBM time dominated every wall clock —
    and in the uniform-mixing limit the population share reduces exactly
    to the closed-form model's per-level convention (wave wall = max over
    ports of wave-bytes/bandwidth).  Reuse distances are measured in bytes
    against a chip-wide clock for device-scoped caches and per-partition
    clocks for partition-scoped ones; cores are blocked per partition
    (cores [p*core_count, (p+1)*core_count) form partition p), so within a
    wave consecutive units stream through the same partition cache.

    Schedules: ``data_parallel`` — one unit per (tile, k-shard); shards of
    a split tile land on different cores, write a full-block f32 partial
    each, and the tile's last shard runs the combine (reads all split_k
    partials).  The wave index is the round-robin pass (unit_index // C).
    ``stream_k`` — the flattened k-step space is cut into
    ``ceil(steps / C)``-step strips, one per core; every strip boundary
    not on a tile edge costs one partial write + read (fixup).  Strips
    start together and advance span-by-span, so the wave index is the span
    ordinal within the strip.  Partials are consumed as soon as they are
    complete, so their footprint is deterministic: the serving level is
    the nearest cache whose budget covers it at the cache's partition
    share — the one placement decision shared with the model's
    formulation, since a never-idle buffer has no measurable reuse
    distance.

    Placement runs in a first pass in deterministic clock order (byte
    counters, serving levels, waves/units/steps are untouched by the
    pricing convention — ``tests/test_wave_model.py`` pins them); the
    second pass prices every recorded event with its wave's populations.
    """
    return _price_multicore(_place_multicore(p, t, hw), hw, events)


def _place_multicore(p: GemmProblem, t: TileConfig,
                     hw: HardwareSpec) -> _PlacedGrid:
    """Pass 1: deterministic-clock placement — serving levels from the LRU
    stacks, byte/step/wave counters, and the priced-event record (see
    :func:`_simulate_multicore` for the conventions)."""
    bi = DTYPE_BYTES[p.in_dtype]
    bo = DTYPE_BYTES[p.out_dtype]
    mm, mn, mk = hw.mxu_shape
    C = hw.total_cores()

    k_extent = cdiv(p.K, t.split_k)           # k span per split
    Tm, Tn = cdiv(p.M, t.bm), cdiv(p.N, t.bn)
    Tk = cdiv(k_extent, t.bk)                 # k blocks per shard

    # Per-core step compute time: chip rates shared evenly over C cores.
    atoms = cdiv(t.bm, mm) * cdiv(t.bn, mn) * cdiv(t.bk, mk)
    ct_mxu = atoms * (2.0 * mm * mn * mk) * C / hw.flops(p.in_dtype)
    ct_vmem = ((t.bm * t.bk + t.bk * t.bn) * bi
               + 2 * t.bm * t.bn * ACC_BYTES) * C / hw.vmem_bandwidth
    ct = max(ct_mxu, ct_vmem)

    caches = hw.cache_levels
    backing = hw.backing
    level_bytes = {lvl.name: 0.0 for lvl in hw.levels[:-1]}
    # Exact LRU stack distance per scope (``_LruStack``): the reuse
    # distance of a panel is the summed size of the DISTINCT keys touched
    # since its last use.  (The single-core simulator keeps the cheaper
    # streamed-bytes proxy — an upper bound on stack distance — because
    # its consecutive-step revisit structure rarely puts a reuse window
    # near a budget boundary; here the oracle harness showed the proxy's
    # double-counted repeat fetches spilling classes an ideal-LRU cache,
    # and the closed-form model's unique-byte windows, keep resident.)
    chip_lru = _LruStack()
    part_lru = [_LruStack() for _ in range(hw.partitions)]
    # A scope's stack is only ever read by a cache level OF that scope —
    # skip maintaining clocks no level will consult (the Fenwick updates
    # are the placement pass's hottest loop; H100-like chains have no
    # partition-scoped cache, halving their LRU cost).
    need_chip = any(lvl.scope != "partition" for lvl in caches)
    need_part = any(lvl.scope == "partition" for lvl in caches)

    def serving_level(kind, key, part) -> MemoryLevel:
        """Measured-reuse-distance placement: nearest cache whose budget
        covers the LRU stack distance since this panel's last use, in the
        cache's scope (chip-wide, or this core's partition)."""
        d_chip = d_part = None                # lazy, computed on demand
        for lvl in reversed(caches):
            if lvl.scope == "partition":
                if d_part is None:
                    d = part_lru[part].distance((kind, key))
                    d_part = float("inf") if d is None else d
                dist = d_part
            else:
                if d_chip is None:
                    d = chip_lru.distance((kind, key))
                    d_chip = float("inf") if d is None else d
                dist = d_chip
            if dist <= lvl.budget():
                return lvl
        return backing

    def record_use(kind, key, part, bytes_) -> None:
        if need_chip:
            chip_lru.use((kind, key), bytes_)
        if need_part:
            part_lru[part].use((kind, key), bytes_)

    def fixup_level() -> MemoryLevel:
        """Serving level for block partials (combine / stream-K fixup):
        produced-then-immediately-consumed, footprint = the outstanding
        partials of one tile."""
        footprint = (t.split_k if t.schedule != "stream_k" else 1) \
            * t.bm * t.bn * ACC_BYTES
        for lvl in reversed(caches):
            scale = 1.0 / hw.partitions if lvl.scope == "partition" else 1.0
            if footprint * scale <= lvl.budget():
                return lvl
        return backing

    total_bytes = 0.0
    mxu_busy = 0.0
    n_steps = 0
    block_acc = t.bm * t.bn * ACC_BYTES
    idx_of = {lvl.name: i for i, lvl in enumerate(hw.levels)}
    fix_lvl = fixup_level()
    fix_i = idx_of[fix_lvl.name]
    back_i = idx_of[backing.name]
    ep = p.epilogue

    # Pass-1 event records.  Fetch spans:
    #   (core, wave, n_empty, nfull, fa_full, fb_full, fa_rag, fb_rag,
    #    ia, ib)   [serving-level indices into hw.levels]
    # writes (partials / combines / output flushes):
    #   (core, wave, bytes, level index)
    fetch_events: List[Tuple] = []
    write_events: List[Tuple] = []

    def span_place(e, i, j, s, blk_lo, n_blk, core, wave) -> None:
        """Placement for ``n_blk`` k-blocks (starting at block ``blk_lo``)
        of k-shard ``s`` of tile (i, j) on ``core``: serving levels from
        the clocks, byte/step counters, and the priced-event record.  O(1)
        via the constant interior step (full blocks) + the ragged final k
        block of the shard."""
        nonlocal total_bytes, mxu_busy, n_steps
        part = core // hw.core_count
        em = min(t.bm, p.M - i * t.bm)
        en = min(t.bn, p.N - j * t.bn)
        k_lo = s * k_extent + blk_lo * t.bk
        k_hi = min(p.K, (s + 1) * k_extent)
        span = max(0, min(n_blk * t.bk, k_hi - k_lo))  # real (unpadded) k
        lvl_a = serving_level("a", (e, i, s), part)
        lvl_b = serving_level("b", (e, j, s), part)
        ragged = span % t.bk
        nfull = span // t.bk
        # ALL n_blk padded grid steps run (compute chews full blocks); only
        # the real span moves bytes — exactly the single-core accounting.
        n_empty = n_blk - nfull - (1 if ragged else 0)
        a_total = em * span * bi
        b_total = span * en * bi
        fetch_events.append(
            (core, wave, n_empty, nfull,
             em * t.bk * bi, t.bk * en * bi,
             em * ragged * bi, ragged * en * bi,
             idx_of[lvl_a.name], idx_of[lvl_b.name]))
        level_bytes[lvl_a.name] += a_total
        level_bytes[lvl_b.name] += b_total
        total_bytes += a_total + b_total
        mxu_busy += n_blk * ct / C
        n_steps += n_blk
        record_use("a", (e, i, s), part, a_total)
        record_use("b", (e, j, s), part, b_total)

    def writeback_place(e, i, j, core, wave) -> None:
        """Output flush + epilogue operand fetch for tile (i, j)."""
        nonlocal total_bytes
        em = min(t.bm, p.M - i * t.bm)
        en = min(t.bn, p.N - j * t.bn)
        wb = em * en * bo + (ep.n_mn_operands * em * en
                             + (en if ep.bias else 0)) * bi
        level_bytes[backing.name] += wb
        total_bytes += wb
        part = core // hw.core_count
        record_use("wb", (e, i, j), part, wb)
        write_events.append((core, wave, wb, back_i))

    tiles = [(e, i, j) for e in range(p.batch)
             for (i, j) in _tile_order(Tm, Tn, t.group_m)]

    if t.schedule == "stream_k":
        steps_per_tile = t.split_k * Tk
        total_steps = len(tiles) * steps_per_tile
        q = cdiv(total_steps, C)              # strip length (k-steps)
        units = total_steps
        waves = q                             # max k-steps on any core
        st = 0
        for core in range(cdiv(total_steps, q)):
            hi = min(st + q, total_steps)
            wave = 0                          # span ordinal within strip
            if st % steps_per_tile:
                # strip boundary inside a tile: the previous core wrote a
                # block partial, this one reads it back (fixup).
                fix = 2.0 * block_acc
                level_bytes[fix_lvl.name] += fix
                total_bytes += fix
                write_events.append((core, 0, fix, fix_i))
            while st < hi:
                ti, off = divmod(st, steps_per_tile)
                e, i, j = tiles[ti]
                s, blk = divmod(off, Tk)
                n_sub = min(hi - st, Tk - blk)
                span_place(e, i, j, s, blk, n_sub, core, wave)
                st += n_sub
                if st % steps_per_tile == 0:
                    writeback_place(e, i, j, core, wave)
                wave += 1
    else:
        unit_list = [(e, i, j, s) for (e, i, j) in tiles
                     for s in range(t.split_k)]
        units = len(unit_list)
        for q_i, (e, i, j, s) in enumerate(unit_list):
            core = q_i % C
            wave = q_i // C
            span_place(e, i, j, s, 0, Tk, core, wave)
            if t.split_k > 1:
                # shard writes its block partial; last shard combines.
                level_bytes[fix_lvl.name] += block_acc
                total_bytes += block_acc
                write_events.append((core, wave, block_acc, fix_i))
                if s == t.split_k - 1:
                    rd = t.split_k * block_acc
                    level_bytes[fix_lvl.name] += rd
                    total_bytes += rd
                    write_events.append((core, wave, rd, fix_i))
                    writeback_place(e, i, j, core, wave)
            else:
                writeback_place(e, i, j, core, wave)
        waves = cdiv(units, C)

    return _PlacedGrid(ct=ct, fetch_events=fetch_events,
                       write_events=write_events, level_bytes=level_bytes,
                       total_bytes=total_bytes, mxu_busy=mxu_busy,
                       n_steps=n_steps, units=units, waves=waves)


def _price_multicore(g: _PlacedGrid, hw: HardwareSpec,
                     events: Optional[List[Tuple]] = None) -> SimResult:
    """Pass 2 — fetch-stream populations per (wave, level): the cores of a
    wave that fetch from a level share its port; everyone else does not
    occupy it.  Writes/partials are priced at their wave's population
    (min 1 — a lone writer gets the full port)."""
    C = hw.total_cores()
    bw = [lvl.bandwidth for lvl in hw.levels]
    ct = g.ct
    core_time = [0.0] * C
    launch = hw.kernel_launch + hw.hbm_latency

    pop: Dict[Tuple[int, int], set] = {}
    for (core, wave, _, _, _, _, _, _, ia, ib) in g.fetch_events:
        pop.setdefault((wave, ia), set()).add(core)
        pop.setdefault((wave, ib), set()).add(core)
    n_pop = {k: len(v) for k, v in pop.items()}

    for (core, wave, n_empty, nfull, fa, fb, fa_r, fb_r,
         ia, ib) in g.fetch_events:
        na = n_pop[(wave, ia)]
        nb = n_pop[(wave, ib)]
        secs = n_empty * ct
        if nfull:
            secs += nfull * max(ct, (fa * na / bw[ia]
                                     + fb * nb / bw[ib])
                                + hw.dma_fixed)
        if fa_r or fb_r:
            secs += max(ct, (fa_r * na / bw[ia]
                             + fb_r * nb / bw[ib]) + hw.dma_fixed)
        if events is not None:
            t0 = launch + core_time[core]
            events.append((f"core{core}", f"unit w{wave}", t0, t0 + secs,
                           {"wave": wave,
                            "bytes": (nfull * (fa + fb) + fa_r + fb_r)}))
        core_time[core] += secs
    for (core, wave, bytes_, il) in g.write_events:
        n = n_pop.get((wave, il), 1)
        secs = bytes_ * n / bw[il]
        if events is not None:
            t0 = launch + core_time[core]
            events.append((f"core{core}", f"write w{wave}", t0, t0 + secs,
                           {"wave": wave, "bytes": bytes_,
                            "level": hw.levels[il].name}))
        core_time[core] += secs
    end = launch + max(core_time)
    return SimResult(time=end, hbm_bytes=g.total_bytes,
                     mxu_busy=g.mxu_busy, steps=g.n_steps,
                     level_bytes=g.level_bytes,
                     units=g.units, waves=g.waves, cores=C)


def _price_multicore_batch(grids: Sequence[_PlacedGrid],
                           hw: HardwareSpec) -> List[SimResult]:
    """Pass 2 across the candidate axis: :func:`_price_multicore` with the
    per-event Python loops replaced by flat numpy columns over ALL
    candidates' events at once.

    Bit-identity with the scalar pricer is by construction, not tolerance
    (``tests/test_simulator_batch.py`` hex-compares every field):

    * populations are distinct-core counts per (candidate, wave, level)
      key — integer set cardinalities, computed exactly by ``np.unique``;
    * each event's seconds evaluate the same IEEE-754 float64 operations
      in the same association order as the scalar expressions (numpy
      elementwise ops are the same C doubles);
    * per-(candidate, core) times accumulate through ONE ``np.bincount``
      over the concatenated [fetch spans, then writes] stream — bincount
      adds weights in input order, reproducing the scalar loops'
      fetch-then-write accumulation order bin by bin.
    """
    C = hw.total_cores()
    L = len(hw.levels)
    n_grids = len(grids)
    bw = np.array([lvl.bandwidth for lvl in hw.levels])
    ct = np.array([g.ct for g in grids])
    launch = hw.kernel_launch + hw.hbm_latency

    fe = np.fromiter(
        chain.from_iterable(chain.from_iterable(
            g.fetch_events for g in grids)),
        dtype=np.float64).reshape(-1, 10)
    f_cand = np.repeat(np.arange(n_grids, dtype=np.int64),
                       [len(g.fetch_events) for g in grids])
    f_core = fe[:, 0].astype(np.int64)
    f_wave = fe[:, 1].astype(np.int64)
    n_empty, nfull = fe[:, 2], fe[:, 3]
    fa, fb, fa_r, fb_r = fe[:, 4], fe[:, 5], fe[:, 6], fe[:, 7]
    ia = fe[:, 8].astype(np.int64)
    ib = fe[:, 9].astype(np.int64)

    we = np.fromiter(
        chain.from_iterable(chain.from_iterable(
            g.write_events for g in grids)),
        dtype=np.float64).reshape(-1, 4)
    w_cand = np.repeat(np.arange(n_grids, dtype=np.int64),
                       [len(g.write_events) for g in grids])
    w_core = we[:, 0].astype(np.int64)
    w_wave = we[:, 1].astype(np.int64)
    w_bytes = we[:, 2]
    w_il = we[:, 3].astype(np.int64)

    # Populations: distinct cores per (candidate, wave, level) over the A
    # and B fetch streams.  Keys are packed into one int64 (W bounds every
    # wave index, fetch and write alike, so write-side lookups share the
    # encoding).
    W = 1 + max(int(f_wave.max(initial=-1)), int(w_wave.max(initial=-1)))
    ka = (f_cand * W + f_wave) * L + ia
    kb = (f_cand * W + f_wave) * L + ib
    upairs = np.unique(np.concatenate([ka, kb]) * C
                       + np.concatenate([f_core, f_core]))
    uk, cnt = np.unique(upairs // C, return_counts=True)
    na = cnt[np.searchsorted(uk, ka)]
    nb = cnt[np.searchsorted(uk, kb)]

    ctf = ct[f_cand]
    secs = n_empty * ctf
    full = nfull * np.maximum(ctf, (fa * na / bw[ia]
                                    + fb * nb / bw[ib])
                              + hw.dma_fixed)
    secs = secs + np.where(nfull > 0, full, 0.0)
    rag = np.maximum(ctf, (fa_r * na / bw[ia]
                           + fb_r * nb / bw[ib]) + hw.dma_fixed)
    secs = secs + np.where((fa_r > 0) | (fb_r > 0), rag, 0.0)

    # Writes price at their wave's fetch population, default 1.
    kw = (w_cand * W + w_wave) * L + w_il
    pos = np.minimum(np.searchsorted(uk, kw), max(len(uk) - 1, 0))
    wn = np.where(uk[pos] == kw, cnt[pos], 1) if len(uk) else \
        np.ones(len(kw), dtype=np.int64)
    w_secs = w_bytes * wn / bw[w_il]

    core_time = np.bincount(
        np.concatenate([f_cand * C + f_core, w_cand * C + w_core]),
        weights=np.concatenate([secs, w_secs]),
        minlength=n_grids * C)
    end = launch + core_time.reshape(n_grids, C).max(axis=1)

    return [SimResult(time=float(end[i]), hbm_bytes=g.total_bytes,
                      mxu_busy=g.mxu_busy, steps=g.n_steps,
                      level_bytes=g.level_bytes,
                      units=g.units, waves=g.waves, cores=C)
            for i, g in enumerate(grids)]


def simulate_gemm_batch(p: GemmProblem, candidates: Sequence[TileConfig],
                        hw: HardwareSpec) -> List[SimResult]:
    """Simulate every candidate of one problem, batching the pricing pass
    (populations + per-core byte clocks) across the candidate axis.

    Bit-identical to ``[simulate_gemm(p, t, hw) for t in candidates]`` —
    placement (pass 1) is the same per-candidate code path as the scalar
    simulator; only pricing (pass 2) is stacked, and
    :func:`_price_multicore_batch` documents why that stacking is exact.
    The exhaustive-autotune oracle uses this to price a FULL candidate
    menu per shape without the compute-lower-bound pruning."""
    if hw.total_cores() == 1:
        return [_simulate_single_core(p, t, hw) for t in candidates]
    if not candidates:
        return []
    return _price_multicore_batch(
        [_place_multicore(p, t, hw) for t in candidates], hw)


# ---------------------------------------------------------------------------
# Virtual-device adapter (DESIGN.md §8).
#
# The calibration subsystem (repro_torch.calib) probes a Device with three
# microbenchmark primitives — a strided stream, a resident compute loop, and
# a wave-occupancy grid — and fits Topology constants from the timings.  On
# real hardware those primitives are measured; in CI they run against these
# deterministic simulated implementations, which share the GEMM simulators'
# conventions (reuse-distance serving levels, static 1/C bandwidth and
# compute shares, per-fetch dma_fixed, kernel_launch + first-byte latency)
# so the fit pipeline can be validated end-to-end: the fitted topology must
# recover the planted constants.
# ---------------------------------------------------------------------------

def simulate_stream(hw: HardwareSpec, nbytes: float, window: int,
                    n_chunks: int = 64) -> float:
    """Seconds to stream ``nbytes`` cyclically through a working set of
    ``window`` bytes, issued as ``n_chunks`` DMA fetches.

    Serving-level rule shared with the GEMM simulators' measured
    reuse-distance placement: after the compulsory first pass (served from
    backing memory), every re-touch of the window has reuse distance ==
    ``window`` bytes, so it is served from the nearest level — staging
    included, a pure copy stream pins nothing else there — whose budget
    covers the window, else from backing memory."""
    backing = hw.backing
    serving = backing
    for lvl in reversed(hw.levels[1:]):       # innermost (staging) first
        if window <= lvl.budget():
            serving = lvl
            break
    first_pass = min(float(window), nbytes)
    return (hw.kernel_launch + hw.hbm_latency
            + first_pass / backing.bandwidth
            + (nbytes - first_pass) / serving.bandwidth
            + n_chunks * hw.dma_fixed)


def simulate_compute(hw: HardwareSpec, dtype: Optional[str],
                     n_atoms: int) -> float:
    """Seconds for ``n_atoms`` back-to-back MXU macro-atoms on resident
    operands (the issue-rate microbenchmark: no memory traffic).

    ``dtype`` falls back to the shared :func:`reference_dtype` rule — the
    same default its sibling :func:`simulate_wave` applies — so
    calibration probes run on bf16-less topologies instead of raising
    ``KeyError``."""
    if dtype is None:
        dtype = reference_dtype(hw.peak_flops)
    mm, mn, mk = hw.mxu_shape
    return hw.kernel_launch + n_atoms * (2.0 * mm * mn * mk) / hw.flops(dtype)


def simulate_wave(hw: HardwareSpec, n_units: int, unit_atoms: int,
                  dtype: Optional[str] = None) -> float:
    """Seconds for ``n_units`` identical compute-only work units scheduled
    round-robin over the chip's cores — the wave-latency microbenchmark.

    Each core gets the static 1/C share of the chip's peak (the same
    simplification ``_simulate_multicore`` and the closed-form occupancy
    stage apply), so the time staircase steps once per wave; the probe fits
    exactly that static-share slope plus ``kernel_launch`` as intercept.
    ``dtype`` defaults to the shared :func:`reference_dtype` rule, so
    bf16-less topologies probe their first known dtype instead of
    crashing."""
    if dtype is None:
        dtype = reference_dtype(hw.peak_flops)
    C = hw.total_cores()
    mm, mn, mk = hw.mxu_shape
    unit_s = unit_atoms * (2.0 * mm * mn * mk) * C / hw.flops(dtype)
    waves = cdiv(n_units, C)
    return hw.kernel_launch + waves * unit_s


def exhaustive_best(p: GemmProblem, hw: HardwareSpec,
                    candidates) -> Tuple[TileConfig, SimResult]:
    """The autotuner stand-in: simulate every candidate, return the argmin.

    An empty menu is a caller bug (a menu filter over-pruned, or a shape
    defeated every placement constraint) — raise a ``ValueError`` naming
    the problem shape instead of returning ``(None, None)`` and crashing
    the caller with an opaque unpack/attribute error downstream.  Ties
    keep the first candidate in menu order, matching the scalar loop this
    replaced."""
    candidates = list(candidates)
    if not candidates:
        raise ValueError(
            f"exhaustive_best: empty candidate list for GEMM "
            f"M={p.M} N={p.N} K={p.K} batch={p.batch} on {hw.name}")
    best_t, best_r = None, None
    for t, r in zip(candidates, simulate_gemm_batch(p, candidates, hw)):
        if best_r is None or r.time < best_r.time:
            best_t, best_r = t, r
    return best_t, best_r
