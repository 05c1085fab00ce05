"""Device abstraction for the calibration probes (DESIGN.md §8).

A :class:`Device` exposes the four primitives the probe layer times:

* ``stream_time``  — stream ``nbytes`` cyclically through a ``window``-byte
  working set in ``n_chunks`` fetches (per-level bandwidth / latency /
  issue-cost probes);
* ``compute_time`` — ``n_atoms`` back-to-back matrix macro-atoms on
  resident operands (peak issue rate per dtype);
* ``wave_time``    — ``n_units`` identical compute-only units launched as a
  grid (occupancy staircase: core count, launch overhead, and the static
  bandwidth/compute-share term of the occupancy stage);
* ``gemm_time``    — one full GEMM under an explicit ``TileConfig`` (the
  exhaustive-autotune oracle's per-candidate measurement).

Two implementations:

* :class:`VirtualDevice` wraps ``core/simulator.py`` around a *planted*
  topology: fully deterministic (optionally with seeded multiplicative
  noise to exercise the robust-fit path), so the whole probe → fit → oracle
  pipeline is CI-testable — the fit must recover the planted constants.
* :class:`TorchDevice` times the port's kernels on the card: the three
  probe kernels of ``kernels/probes.py`` and the GEMM kernel.  With
  ``device="cpu"`` it runs their plain versions (tiny sizes, used by smoke
  tests for the code path only) and the numbers describe the host.
"""
from __future__ import annotations

import hashlib
import itertools
import time
from typing import Optional, Protocol, runtime_checkable

from repro_torch.core.latency import GemmProblem, TileConfig
from repro_torch.core.simulator import (simulate_compute, simulate_gemm,
                                  simulate_gemm_batch, simulate_stream,
                                  simulate_wave)
from repro_torch.core.topology import Topology


@runtime_checkable
class Device(Protocol):
    """What the probe layer needs from a machine under calibration."""

    name: str

    def stream_time(self, nbytes: float, window: int,
                    n_chunks: int) -> float: ...

    def compute_time(self, dtype: str, n_atoms: int,
                     n_parallel: int = 1) -> float: ...

    def wave_time(self, n_units: int, unit_atoms: int,
                  dtype: str) -> float: ...

    def gemm_time(self, p: GemmProblem, t: TileConfig) -> float: ...


class VirtualDevice:
    """The simulator wrapped as a deterministic device.

    ``planted`` is the ground-truth topology whose constants the probes
    observe; the fit pipeline starts from a *different* (or identical) base
    preset and must recover them.  ``noise`` adds a deterministic
    multiplicative jitter in ``[-noise, +noise]`` derived from a hash of
    the call arguments (stable across call order and processes), so the
    least-squares fits are exercised against imperfect measurements
    without flaky tests.
    """

    def __init__(self, planted: Topology, *, noise: float = 0.0,
                 seed: int = 0):
        self.planted = planted
        self.noise = float(noise)
        self.seed = int(seed)
        self.name = f"virtual:{planted.name}"

    def _jitter(self, *key) -> float:
        if not self.noise:
            return 1.0
        h = hashlib.md5(repr((self.seed,) + key).encode()).digest()
        u = int.from_bytes(h[:8], "big") / float(1 << 64)    # [0, 1)
        return 1.0 + self.noise * (2.0 * u - 1.0)

    def stream_time(self, nbytes: float, window: int,
                    n_chunks: int) -> float:
        t = simulate_stream(self.planted, nbytes, window, n_chunks)
        return t * self._jitter("stream", nbytes, window, n_chunks)

    def compute_time(self, dtype: str, n_atoms: int,
                     n_parallel: int = 1) -> float:
        # simulate_compute retires atoms at the full chip rate, so the
        # parallelism hint is already implied (jitter key excludes it).
        t = simulate_compute(self.planted, dtype, n_atoms)
        return t * self._jitter("compute", dtype, n_atoms)

    def wave_time(self, n_units: int, unit_atoms: int,
                  dtype: str) -> float:
        t = simulate_wave(self.planted, n_units, unit_atoms, dtype)
        return t * self._jitter("wave", n_units, unit_atoms, dtype)

    def gemm_time(self, p: GemmProblem, t: TileConfig) -> float:
        # The oracle's per-candidate price: the event-level simulator, which
        # shares no scoring logic with the closed-form model it judges.
        return simulate_gemm(p, t, self.planted).time

    def gemm_time_batch(self, p: GemmProblem, candidates) -> list:
        """Whole-menu pricing through the vectorized simulator — bit-identical
        to ``[self.gemm_time(p, t) for t in candidates]`` (the batched pricer
        shares the scalar placement pass and reduces in the same order), at
        the cost of one numpy pass instead of P python event loops.  The
        unpruned oracle's fast path; optional on the Device protocol —
        callers feature-detect with ``hasattr``."""
        return [r.time for r in simulate_gemm_batch(p, candidates,
                                                    self.planted)]


# TorchDevice's timing on the card: a CUDA graph of GRAPH_CALLS calls
# replayed GRAPH_REPS times (the probes: at least MARGINAL_CALLS calls, and
# twice as many, marginal_time); its inputs come from generators seeded
# SEED.
GRAPH_CALLS = 5
GRAPH_REPS = 5
MARGINAL_CALLS = 20
SEED = 0


def marginal_time(fn, calls: int, reps: int, side=None) -> float:
    """Device seconds of one ``fn()`` among back-to-back calls: the
    replay of a graph of ``2 calls`` calls less that of ``calls`` calls
    (each :func:`graph_time`), over ``calls``.  What a replay costs once,
    whatever its length, cancels.  Timed by one graph, the wave sweep's
    intercept, which the fit reads as the launch cost, came out above the
    latency sweep's on the H100 and the fitted HBM latency below zero
    (ROADMAP C7; ``tools/probe_intercepts.py`` times both ways)."""
    once = graph_time(fn, calls, reps, side) * calls
    twice = graph_time(fn, 2 * calls, reps, side) * 2 * calls
    return (twice - once) / calls


def l2_budget(topo: Topology) -> int:
    """The budget of the largest cache inside the backing memory (the
    H100's L2): what ``calib/probes.py::level_windows`` sizes the backing
    window from."""
    return max((l.budget() for l in topo.levels[1:]), default=0)


def latency_windows(window: int, l2_bytes: int) -> int:
    """How many distinct ``window``-byte windows the latency sweep rotates
    through so that at least twice ``l2_bytes`` pass between two reads of
    one window: every fetch then misses the L2."""
    window = max(int(window), 1)
    return -(-2 * int(l2_bytes) // window) + 1


def graph_time(fn, calls: int, reps: int, side=None) -> float:
    """Device seconds of one ``fn()`` on the current CUDA device: three
    warm-up calls on the side stream ``side`` (a new one if None), then
    ``calls`` calls captured in a CUDA graph, the graph replayed ``reps``
    times between CUDA events, the median replay divided by ``calls``.
    The graph takes the host's launch overhead out of the time."""
    import torch
    side = side if side is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e-3 / calls)
    times.sort()
    return times[len(times) // 2]


class TorchDevice:
    """Real-execution device: the port's kernels timed on the card.

    On a CUDA device the three probe primitives run the probe kernels of
    ``kernels/probes.py`` (one launch each, the loop on the card) and
    ``gemm_time`` runs the port's GEMM kernel through ``ops.matmul`` under
    the explicit config.  Each is timed in CUDA graphs replayed
    :data:`GRAPH_REPS` times between CUDA events, which takes the host's
    launch cost out: a GEMM wrapper spends tens of microseconds of host
    time a call, which events around an eager call would measure instead
    of the kernel.  The probes take :func:`marginal_time` (graphs of at
    least :data:`MARGINAL_CALLS` calls and twice as many), so what a
    replay costs once cancels and every probe carries the same fixed cost
    a call; the
    ``kernel_launch`` a fit reads from the wave sweep's intercept is the
    launch gap between kernels inside a graph, not the cost of an eager
    launch.  ``gemm_time`` takes :func:`graph_time` of one graph.

    A single-pass transfer (the latency sweep: ``n_chunks == 1``,
    ``window == nbytes``) reads a window of its own in each call:
    :func:`latency_windows` windows carved from one buffer made before
    capture, at least twice ``l2_bytes`` (the topology's L2 budget,
    :func:`l2_budget` of ``GPU_H100_LIKE`` unless given) between two reads
    of one, taken in turn.  So every fetch comes
    from HBM, as ``simulate_stream`` prices a first pass; with
    :data:`GRAPH_CALLS` calls on one window every fetch after the first
    hit the L2 (ROADMAP C7).

    ``device`` defaults to ``"cuda"``; without CUDA the constructor raises
    unless the caller passes ``device="cpu"``.  There the primitives run
    the kernels' plain versions, timed with ``perf_counter`` (best of
    ``repeat`` after one warm-up call): the numbers describe the host.
    Inputs come from ``torch.Generator``s seeded with :data:`SEED`: the
    probes' operands per dtype, the GEMM's per problem, in its
    ``in_dtype``.
    """

    def __init__(self, device: str = "cuda", *, repeat: int = 3,
                 l2_bytes: Optional[int] = None):
        import torch
        self._torch = torch
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchDevice: no CUDA device; pass device='cpu' to time "
                    "the kernels' plain versions on the host")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            kind = torch.cuda.get_device_name(dev)
        elif dev.type == "cpu":
            kind = "host"
        else:
            raise ValueError(f"TorchDevice: unsupported device {device!r}")
        self.device = dev
        self.repeat = int(repeat)
        self.name = f"torch:{dev.type}:{kind}"
        if l2_bytes is None:
            from repro_torch.core.hardware import GPU_H100_LIKE
            l2_bytes = l2_budget(GPU_H100_LIKE)
        self.l2_bytes = int(l2_bytes)
        self._windows: dict = {}
        self._rotation = None
        self._operands: dict = {}
        self._gemm_key = None
        self._gemm_ab = None
        self._side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._slots_buf = None

    def _generator(self):
        return self._torch.Generator(device=self.device).manual_seed(SEED)

    def _time(self, fn, calls: int = GRAPH_CALLS,
              marginal: bool = True) -> float:
        torch = self._torch
        if self.device.type == "cpu":
            fn()
            best = float("inf")
            for _ in range(self.repeat):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            return best
        with torch.cuda.device(self.device):
            if marginal:
                return marginal_time(fn, max(calls, MARGINAL_CALLS),
                                     GRAPH_REPS, self._side)
            return graph_time(fn, calls, GRAPH_REPS, self._side)

    def _mma_operands(self, dtype: str):
        from repro_torch.kernels import probes
        if dtype not in self._operands:
            self._operands[dtype] = probes.mma_operands(
                dtype, self.device, self._generator())
        return self._operands[dtype]

    def _slots(self, n: int):
        """The int64 buffer (at least ``n`` slots) that timed probe calls
        write their sums into, made before any graph captures it: a timed
        call is then the probe's one launch, with no fill or allocation
        beside it, for every probe alike.  None on the CPU."""
        if self.device.type != "cuda":
            return None
        if self._slots_buf is None or self._slots_buf.numel() < n:
            self._slots_buf = self._torch.empty(
                max(int(n), 4096), dtype=self._torch.int64,
                device=self.device)
        return self._slots_buf

    def rotation(self, window: int) -> list:
        """The latency sweep's :func:`latency_windows` distinct windows of
        ``window`` bytes, views of one buffer (kept for the next sweep
        point while it is large enough), each laid out as
        ``probes.stream_data`` lays out a window."""
        from repro_torch.kernels import probes
        n = latency_windows(window, self.l2_bytes)
        floats = max(int(window) // probes.VEC_BYTES, 1) * 4
        if self._rotation is None or self._rotation.numel() < n * floats:
            self._rotation = None               # free the smaller one first
            self._rotation = probes.stream_data(n * floats * 4, self.device)
        buf = self._rotation
        return [buf[i * floats:(i + 1) * floats] for i in range(n)]

    def stream_time(self, nbytes: float, window: int,
                    n_chunks: int) -> float:
        from repro_torch.kernels import probes
        out = self._slots(probes.STREAM_SLOTS_MAX)
        if n_chunks == 1 and int(nbytes) == int(window):
            # The latency sweep: call i of the graph reads window i.
            xs = self.rotation(window)
            turn = itertools.count()
            return self._time(
                lambda: probes.stream_read(xs[next(turn) % len(xs)], nbytes,
                                           window, 1, out=out),
                calls=len(xs))
        x = self._windows.get(window)
        if x is None:
            x = self._windows[window] = probes.stream_data(window,
                                                           self.device)
        return self._time(
            lambda: probes.stream_read(x, nbytes, window, n_chunks, out=out))

    def compute_time(self, dtype: str, n_atoms: int,
                     n_parallel: int = 1) -> float:
        # n_parallel CTAs of probes.CHAINS_PER_CTA chains: the fit reads
        # the slope as the chip-wide issue rate, which one chain a core
        # cannot reach.
        from repro_torch.kernels import probes
        a, b = self._mma_operands(dtype)
        n_parallel = max(int(n_parallel), 1)
        out = self._slots(n_parallel * probes.CHAINS_PER_CTA)
        return self._time(
            lambda: probes.mma_chain(a, b, n_atoms, n_parallel, out=out))

    def wave_time(self, n_units: int, unit_atoms: int,
                  dtype: str) -> float:
        from repro_torch.kernels import probes
        a, b = self._mma_operands(dtype)
        out = self._slots(max(int(n_units), 1))
        return self._time(
            lambda: probes.wave_grid(a, b, n_units, unit_atoms, out=out))

    def gemm_time(self, p: GemmProblem, t: TileConfig) -> float:
        from repro_torch.kernels import ops
        torch = self._torch
        key = (p.M, p.N, p.K, p.in_dtype)
        if key != self._gemm_key:
            g = self._generator()
            dt = getattr(torch, p.in_dtype)
            self._gemm_ab = tuple(
                torch.randn(shape, generator=g, device=self.device).to(dt)
                for shape in ((p.M, p.K), (p.K, p.N)))
            self._gemm_key = key
        a, b = self._gemm_ab
        out_dtype = getattr(torch, p.out_dtype)
        return self._time(
            lambda: ops.matmul(a, b, out_dtype=out_dtype, config=t),
            marginal=False)


class CandidateMismatch(Exception):
    """A GEMM candidate whose output disagrees with the plain product: a
    correctness fault, never a slow measurement.  Not a RuntimeError, so the
    oracle's loop (which skips candidates that fail to launch) lets it
    through."""

    def __init__(self, p: GemmProblem, t: TileConfig, max_abs_err: float):
        super().__init__(f"candidate {t} at {p.M}x{p.N}x{p.K} disagrees "
                         f"with the plain product (max abs err "
                         f"{max_abs_err})")
        self.problem, self.config, self.max_abs_err = p, t, max_abs_err


class CheckedDevice:
    """A :class:`TorchDevice` whose ``gemm_time`` is memoised by (problem,
    config) and, before a candidate's first timing, holds its output to one
    plain product of the problem (``kernels/ref.py::gemm_check``): a
    wrong config that ran fast would otherwise win the oracle's argmin.  A
    disagreement raises :class:`CandidateMismatch`; a candidate that fails
    to launch is recorded in ``errors`` and its RuntimeError re-raised.
    The check's launch is not counted in ``tiled_matmul.launches``."""

    def __init__(self, inner: "TorchDevice"):
        self.inner, self.name = inner, inner.name
        self.times: dict = {}
        self.errors: list = []
        self.checked = 0
        self.worst_err = 0.0
        self._ref = None

    def gemm_time(self, p: GemmProblem, t: TileConfig) -> float:
        key = (p, t)
        if key not in self.times:
            try:
                self._check(p, t)
                self.times[key] = self.inner.gemm_time(p, t)
            except RuntimeError as e:
                self.errors.append(f"{p.M}x{p.N}x{p.K} {t}: {e}")
                raise
        return self.times[key]

    def _check(self, p: GemmProblem, t: TileConfig) -> None:
        import torch
        from repro_torch.kernels import matmul as kmm
        from repro_torch.kernels import ops
        from repro_torch.kernels.ref import gemm_check
        dev = self.inner.device
        if self._ref is None or self._ref[0] != p:
            self._ref = None                    # free the last shape's first
            g = torch.Generator(device=dev).manual_seed(17)
            a, b = (torch.randn(shape, generator=g, device=dev).to(
                getattr(torch, p.in_dtype)) for shape in ((p.M, p.K),
                                                          (p.K, p.N)))
            want = kmm.matmul_plain(
                a, b, t, out_dtype=getattr(torch, p.out_dtype)).float()
            self._ref = (p, a, b, want)
        _, a, b, want = self._ref
        n0 = kmm.tiled_matmul.launches
        got = ops.matmul(a, b, out_dtype=getattr(torch, p.out_dtype),
                         config=t)
        kmm.tiled_matmul.launches = n0          # checks do not count
        ok, worst, _ = gemm_check(got, want, a.dtype, p.K)
        if not ok:
            raise CandidateMismatch(p, t, worst)
        self.checked += 1
        self.worst_err = max(self.worst_err, worst)


def get_device(kind: str, base: Topology, *, noise: float = 0.0,
               seed: int = 0, planted: Optional[Topology] = None,
               fault_plan=None) -> Device:
    """Device factory for the CLI / benchmarks: ``virtual`` wraps the
    simulator around ``planted`` (default: the base preset itself — the
    self-consistency check), ``torch`` measures the port's kernels on the
    card (:class:`TorchDevice`, which raises without CUDA).

    ``fault_plan`` (a ``repro_torch.calib.faults.FaultPlan``) decorates the
    device with seeded, deterministic measurement faults — the chaos
    harness's entry point into the probe pipeline."""
    if kind == "virtual":
        device: Device = VirtualDevice(planted or base, noise=noise,
                                       seed=seed)
    elif kind == "torch":
        device = TorchDevice(l2_bytes=l2_budget(base))
    else:
        raise ValueError(
            f"unknown device kind {kind!r}; choose virtual | torch")
    if fault_plan is not None:
        from repro_torch.calib.faults import FaultyDevice
        device = FaultyDevice(device, fault_plan)
    return device
