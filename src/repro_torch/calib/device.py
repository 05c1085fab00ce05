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
# replayed GRAPH_REPS times; its inputs come from generators seeded SEED.
GRAPH_CALLS = 5
GRAPH_REPS = 5
SEED = 0


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
    the explicit config.  Each is timed by :func:`graph_time`, a CUDA
    graph of :data:`GRAPH_CALLS` calls replayed :data:`GRAPH_REPS` times
    between CUDA events, which takes the host's launch cost out: a GEMM
    wrapper spends tens of microseconds of host time a call, which events
    around an eager call would measure instead of the kernel.  So the
    ``kernel_launch`` a fit reads from the wave sweep's intercept is the
    launch gap inside a graph, not the cost of an eager launch.

    ``device`` defaults to ``"cuda"``; without CUDA the constructor raises
    unless the caller passes ``device="cpu"``.  There the primitives run
    the kernels' plain versions, timed with ``perf_counter`` (best of
    ``repeat`` after one warm-up call): the numbers describe the host.
    Inputs come from ``torch.Generator``s seeded with :data:`SEED`: the
    probes' operands per dtype, the GEMM's per problem, in its
    ``in_dtype``.
    """

    def __init__(self, device: str = "cuda", *, repeat: int = 3):
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
        self._windows: dict = {}
        self._operands: dict = {}
        self._gemm_key = None
        self._gemm_ab = None
        self._side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def _generator(self):
        return self._torch.Generator(device=self.device).manual_seed(SEED)

    def _time(self, fn) -> float:
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
            return graph_time(fn, GRAPH_CALLS, GRAPH_REPS, self._side)

    def _mma_operands(self, dtype: str):
        from repro_torch.kernels import probes
        if dtype not in self._operands:
            self._operands[dtype] = probes.mma_operands(
                dtype, self.device, self._generator())
        return self._operands[dtype]

    def stream_time(self, nbytes: float, window: int,
                    n_chunks: int) -> float:
        from repro_torch.kernels import probes
        x = self._windows.get(window)
        if x is None:
            x = self._windows[window] = probes.stream_data(window,
                                                           self.device)
        return self._time(
            lambda: probes.stream_read(x, nbytes, window, n_chunks))

    def compute_time(self, dtype: str, n_atoms: int,
                     n_parallel: int = 1) -> float:
        # n_parallel CTAs of probes.CHAINS_PER_CTA chains: the fit reads
        # the slope as the chip-wide issue rate, which one chain a core
        # cannot reach.
        from repro_torch.kernels import probes
        a, b = self._mma_operands(dtype)
        return self._time(
            lambda: probes.mma_chain(a, b, n_atoms, max(int(n_parallel), 1)))

    def wave_time(self, n_units: int, unit_atoms: int,
                  dtype: str) -> float:
        from repro_torch.kernels import probes
        a, b = self._mma_operands(dtype)
        return self._time(
            lambda: probes.wave_grid(a, b, n_units, unit_atoms))

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
            lambda: ops.matmul(a, b, out_dtype=out_dtype, config=t))


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
        device = TorchDevice()
    else:
        raise ValueError(
            f"unknown device kind {kind!r}; choose virtual | torch")
    if fault_plan is not None:
        from repro_torch.calib.faults import FaultyDevice
        device = FaultyDevice(device, fault_plan)
    return device
