"""Microbenchmark probes: the measurement layer of calibration (DESIGN.md §8).

Each probe runs a sweep of one :class:`~repro_torch.calib.device.Device`
primitive and returns a :class:`ProbeSweep` — the raw ``(x, seconds)``
samples plus the fixed parameters, which the fit layer turns into Topology
constants and which land verbatim in the calibrated-topology artifact's
provenance.  Probes never fit; fits never measure.

The sweeps, and what their slopes/intercepts mean (``fit.py``):

* ``stream:<level>`` — nbytes sweep at a *fixed* reuse window targeting one
  memory level (bigger than every inner level's budget, within the target's)
  with a fixed chunk count, so ``d(time)/d(nbytes) = 1/bandwidth(level)``.
* ``latency`` — single-pass small transfers (``window == nbytes``,
  one chunk): the intercept isolates launch + first-byte latency.
* ``issue`` — chunk-count sweep at fixed bytes/window:
  ``d(time)/d(n_chunks) = dma_fixed``.
* ``compute:<dtype>`` — macro-atom count sweep on resident operands:
  ``d(time)/d(n_atoms) = atom_flops / peak_flops[dtype]``.
* ``wave`` — work-unit sweep in exact multiples of the declared core count:
  ``d(time)/d(waves)`` is the per-wave unit time under the occupancy
  stage's *static* 1/C bandwidth-share simplification, and the intercept is
  ``kernel_launch``.  Two extra off-staircase samples (C and C+1 units)
  record the tail-wave cliff itself.

Window targeting walks the declared capacity chain — capacities and core
counts are structural datasheet facts; calibration measures *rates*
(paper §V-E: retarget by swapping measured constants only).

Fail-soft measurement (DESIGN.md §9): every probe call can be bounded by a
watchdog ``deadline_s`` — a hung device (wedged driver, injected hang)
raises :class:`ProbeTimeout` inside the watchdog instead of wedging the
calibration run, and the sample is *dropped*, not recorded.  Samples that
come back non-finite or non-positive (NaN poison, sign flips — physically
impossible times) are dropped the same way; per-sweep drop counts land in
``params["n_dropped"]`` so provenance shows how degraded a sweep was.
Outliers are NOT dropped here: plausible-but-wrong values are the robust
fit's job (Theil–Sen), not the measurement layer's.
"""
from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.calib.device import Device
from repro_torch.core.topology import Topology, reference_dtype


class ProbeTimeout(RuntimeError):
    """A probe call exceeded its watchdog deadline (hung device/driver)."""


def _measure(fn: Callable[[], float],
             deadline_s: Optional[float]) -> float:
    """Run one timing call under the watchdog.  ``deadline_s=None`` means
    unbounded (the trusted-substrate fast path: no thread hop)."""
    if deadline_s is None:
        return fn()
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(fn)
        try:
            return fut.result(timeout=deadline_s)
        except _FuturesTimeout:
            fut.cancel()
            raise ProbeTimeout(
                f"probe call exceeded watchdog deadline {deadline_s:g}s"
            ) from None
    finally:
        # Don't block on a wedged worker — it is left to die with the
        # process (the injected-hang case sleeps bounded time anyway).
        ex.shutdown(wait=False)


def _guarded(fn: Callable[[], float],
             deadline_s: Optional[float]) -> Optional[float]:
    """One guarded sample: None (dropped) on watchdog timeout or a
    non-finite / non-positive measurement; the honest value otherwise."""
    try:
        y = _measure(fn, deadline_s)
    except ProbeTimeout:
        return None
    if not math.isfinite(y) or y <= 0.0:
        return None
    return y

# Target wall times per sweep point.  Sweep sizes (bytes, atoms, chunk
# counts) are derived from these and the *base* preset's order-of-magnitude
# constants, so every probe's signal dwarfs launch overhead and measurement
# noise on machines of any speed — a fixed atom count that keeps a TPU busy
# for 20 us vanishes inside the launch jitter of a chip with 16^3 atoms.
# Sizing only needs the preset to be right to an order of magnitude; the
# fit replaces the constants with what was measured.
STREAM_TARGETS_S = (50e-6, 100e-6, 200e-6, 400e-6, 800e-6)
LATENCY_TARGETS_S = (0.5e-6, 1e-6, 1.5e-6, 2e-6, 3e-6, 4e-6)
ISSUE_TARGETS_S = (6.25e-6, 12.5e-6, 25e-6, 50e-6)
COMPUTE_TARGETS_S = (20e-6, 40e-6, 80e-6, 160e-6)
WAVE_UNIT_TARGET_S = 5e-6
WAVE_MULTIPLES = (1, 2, 3, 4, 5, 6, 7, 8)  # x total_cores -> exact waves


@dataclass(frozen=True)
class ProbeSweep:
    """One probe's raw measurements: ``samples[i] = (x_i, seconds_i)``."""

    kind: str                 # stream | latency | issue | compute | wave
    target: str               # stream/latency: level name; compute/wave:
                              # dtype; "" for machine-wide (issue)
    params: Dict[str, float]  # fixed sweep parameters
    samples: Tuple[Tuple[float, float], ...]

    def xs(self) -> List[float]:
        return [x for x, _ in self.samples]

    def ys(self) -> List[float]:
        return [y for _, y in self.samples]

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "target": self.target,
                "params": dict(self.params),
                "samples": [list(s) for s in self.samples]}


def level_windows(base: Topology) -> List[Tuple[int, str, int]]:
    """(level index, name, reuse-window bytes) targeting each probeable
    level of the chain, innermost first, backing memory last.

    A window targets level ℓ when it exceeds the budget of every level
    *inner* than ℓ (so nearer levels cannot serve the re-touches) while
    fitting ℓ's own budget.  A cache whose budget does not leave room above
    its inner neighbours (a budget inversion) is reported unprobeable by
    omission — the fit keeps its preset bandwidth."""
    out: List[Tuple[int, str, int]] = []
    levels = base.levels
    for i in range(len(levels) - 1, 0, -1):           # innermost first
        inner = max((l.budget() for l in levels[i + 1:]), default=0)
        budget = levels[i].budget()
        window = min(budget, 2 * inner) if inner else max(budget // 2, 1)
        if window <= inner:
            continue                                   # budget inversion
        out.append((i, levels[i].name, window))
    inner = max((l.budget() for l in levels[1:]), default=1)
    out.append((0, levels[0].name, 2 * inner))         # backing: spills all
    return out


def probe_stream_levels(device: Device, base: Topology, *,
                        n_chunks: int = 64,
                        targets: Sequence[float] = STREAM_TARGETS_S,
                        deadline_s: Optional[float] = None,
                        ) -> Dict[str, ProbeSweep]:
    """Per-level bandwidth sweeps: fixed window, nbytes varied.  nbytes per
    point is sized from the level's *preset* bandwidth to hit the target
    wall times (a KB-scale window needs hundreds of thousands of passes
    before its port time is visible over launch overhead)."""
    out: Dict[str, ProbeSweep] = {}
    for idx, name, window in level_windows(base):
        bw = base.levels[idx].bandwidth
        samples: List[Tuple[float, float]] = []
        dropped = 0
        for T in targets:
            nb = float(max(2 * window, int(T * bw)))
            y = _guarded(lambda: device.stream_time(nb, window, n_chunks),
                         deadline_s)
            if y is None:
                dropped += 1
            else:
                samples.append((nb, y))
        out[f"stream:{name}"] = ProbeSweep(
            kind="stream", target=name,
            params={"window": window, "n_chunks": n_chunks,
                    "n_dropped": dropped},
            samples=tuple(samples))
    return out


def probe_latency(device: Device, base: Topology,
                  targets: Sequence[float] = LATENCY_TARGETS_S,
                  deadline_s: Optional[float] = None) -> ProbeSweep:
    """Single-pass small transfers: ``window == nbytes``, one chunk — the
    intercept over nbytes is launch + first-byte latency + issue cost.
    Transfers are kept small (sub-launch-scale) so the intercept
    extrapolation stays short."""
    bw = base.backing.bandwidth
    samples: List[Tuple[float, float]] = []
    dropped = 0
    for T in targets:
        nb = float(max(int(T * bw), 1))
        y = _guarded(lambda: device.stream_time(nb, int(nb), 1), deadline_s)
        if y is None:
            dropped += 1
        else:
            samples.append((nb, y))
    return ProbeSweep(kind="latency", target=base.backing.name,
                      params={"n_chunks": 1, "n_dropped": dropped},
                      samples=tuple(samples))


def probe_issue(device: Device, base: Topology,
                targets: Sequence[float] = ISSUE_TARGETS_S,
                deadline_s: Optional[float] = None) -> ProbeSweep:
    """DMA-issue cost: chunk-count sweep at fixed (small) bytes and window
    so the constant byte term stays small next to the issue term.  Chunk
    counts are sized from the preset ``dma_fixed``."""
    window = max(base.staging.budget() // 2, 1)
    nbytes = float(2 * window)
    dma = base.dma_fixed or 1e-9
    chunks = sorted({max(1, int(T / dma)) for T in targets})
    samples: List[Tuple[float, float]] = []
    dropped = 0
    for c in chunks:
        y = _guarded(lambda: device.stream_time(nbytes, window, c),
                     deadline_s)
        if y is None:
            dropped += 1
        else:
            samples.append((float(c), y))
    return ProbeSweep(kind="issue", target="",
                      params={"window": window, "nbytes": nbytes,
                              "n_dropped": dropped},
                      samples=tuple(samples))


def probe_compute(device: Device, base: Topology, dtype: str,
                  targets: Sequence[float] = COMPUTE_TARGETS_S,
                  deadline_s: Optional[float] = None) -> ProbeSweep:
    """Issue-rate sweep for one dtype: n resident macro-atoms back-to-back,
    n sized from the preset peak to hit the target wall times."""
    mm, mn, mk = base.mxu_shape
    atom_flops = 2.0 * mm * mn * mk
    peak = base.flops(dtype)
    lanes = base.total_cores()      # chip-wide rate needs every core busy
    samples: List[Tuple[float, float]] = []
    dropped = 0
    for T in targets:
        n = max(16 * lanes, int(T * peak / atom_flops))
        y = _guarded(lambda: device.compute_time(dtype, n, lanes),
                     deadline_s)
        if y is None:
            dropped += 1
        else:
            samples.append((float(n), y))
    return ProbeSweep(kind="compute", target=dtype,
                      params={"mxu_m": mm, "mxu_n": mn, "mxu_k": mk,
                              "n_parallel": lanes, "n_dropped": dropped},
                      samples=tuple(samples))


def _wave_unit_atoms(base: Topology) -> int:
    """Atoms per wave unit sized so one wave ~ WAVE_UNIT_TARGET_S."""
    mm, mn, mk = base.mxu_shape
    atom_flops = 2.0 * mm * mn * mk
    ref = reference_dtype(base.peak_flops)
    return max(16, int(WAVE_UNIT_TARGET_S * base.peak_flops[ref]
                       / (atom_flops * base.total_cores())))


def probe_wave(device: Device, base: Topology, *,
               unit_atoms: Optional[int] = None,
               multiples: Sequence[int] = WAVE_MULTIPLES,
               deadline_s: Optional[float] = None) -> ProbeSweep:
    """Wave-latency staircase: unit counts in exact multiples of the
    declared core count (x == wave count), plus the C / C+1 cliff pair."""
    if unit_atoms is None:
        unit_atoms = _wave_unit_atoms(base)
    C = base.total_cores()
    ref = reference_dtype(base.peak_flops)
    samples: List[Tuple[float, float]] = []
    dropped = 0
    for k in multiples:
        y = _guarded(lambda: device.wave_time(k * C, unit_atoms, ref),
                     deadline_s)
        if y is None:
            dropped += 1
        else:
            samples.append((float(k), y))
    cliff = []
    for units in (C, C + 1):
        y = _guarded(lambda: device.wave_time(units, unit_atoms, ref),
                     deadline_s)
        if y is None:
            dropped += 1
            y = float("nan")          # provenance-only; never fitted
        cliff.append(y)
    return ProbeSweep(kind="wave", target=ref,
                      params={"unit_atoms": unit_atoms, "cores": C,
                              "cliff_units": C,
                              "cliff_before_s": cliff[0],
                              "cliff_after_s": cliff[1],
                              "n_dropped": dropped},
                      samples=tuple(samples))


def run_probes(device: Device, base: Topology, *,
               dtypes: Optional[Sequence[str]] = None,
               deadline_s: Optional[float] = None,
               ) -> Dict[str, ProbeSweep]:
    """The full probe suite for one device against one base topology.

    ``deadline_s`` bounds every individual timing call with the watchdog
    (None -> trust the device not to hang)."""
    sweeps = probe_stream_levels(device, base, deadline_s=deadline_s)
    sweeps["latency"] = probe_latency(device, base, deadline_s=deadline_s)
    sweeps["issue"] = probe_issue(device, base, deadline_s=deadline_s)
    for dt in (dtypes if dtypes is not None else sorted(base.peak_flops)):
        sweeps[f"compute:{dt}"] = probe_compute(device, base, dt,
                                                deadline_s=deadline_s)
    sweeps["wave"] = probe_wave(device, base, deadline_s=deadline_s)
    return sweeps
