"""Seeded, deterministic fault injection for the whole pipeline (DESIGN.md §9).

The calibration -> selection -> serving path assumes a trusted measurement
substrate; production does not grant one.  This module makes every failure
mode the fail-soft layer handles *reproducible in CI*:

* :class:`FaultPlan` — the seeded fault schedule.  Each injection site
  draws from a hash of ``(seed, site, kind, call-index)`` — the same seed
  and the same call sequence always produce the same fault sequence, with
  no shared RNG stream to perturb (the VirtualDevice jitter convention).
  Every fired fault is appended to ``plan.log`` so tests can assert the
  exact sequence.
* :class:`FaultyDevice` — decorates any :class:`~repro_torch.calib.device.Device`
  with probe-layer faults: hangs (caught by the ``probes.py`` watchdog
  deadline), NaN, multiplicative outliers (Theil–Sen's job), and
  sign-flipped measurements (physically impossible; the probe layer drops
  them).
* :func:`launch_injector` / :func:`scripted_injector` — callables for
  ``kernels.ops.set_launch_fault_injector``: seeded compile/transient
  launch failures, or an exact scripted sequence for ladder tests.
* :func:`decode_injector` — per-step transient faults for the serving
  loop's retry path (``launch/serve.py``).
* Artifact/cache corruption helpers — tampered fingerprints, truncated
  (mid-write) files, and parseable-but-illegal cache entries.

Faults are injected at *wrapper* boundaries only; no production module
imports this one.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.calib.device import Device
from repro_torch.core.latency import GemmProblem, TileConfig

# Probe-measurement fault kinds, in draw order (at most one fires per
# call — earlier kinds shadow later ones, so rates compose predictably).
PROBE_FAULT_KINDS = ("timeout", "nan", "outlier", "signflip")


@dataclass
class FaultPlan:
    """A seeded, deterministic fault schedule.

    Rates are per-call probabilities in ``[0, 1]``.  Each (site, kind)
    pair keeps its own call counter; the k-th draw for a pair is a pure
    function of ``(seed, site, kind, k)`` — deterministic, order-robust
    across unrelated sites, and replayable: re-running the same workload
    against ``FaultPlan(seed=s, ...)`` reproduces the identical fault
    sequence.
    """

    seed: int = 0
    # --- probe-layer measurement faults (FaultyDevice) ---
    probe_timeout: float = 0.0    # hang for hang_s (watchdog's job)
    probe_nan: float = 0.0        # measurement comes back NaN
    probe_outlier: float = 0.0    # measurement x outlier_factor
    probe_signflip: float = 0.0   # measurement negated (impossible value)
    # --- kernel-launch faults (launch_injector) ---
    launch_compile: float = 0.0   # deterministic "compile failure"
    launch_transient: float = 0.0  # transient-marked launch failure
    # --- serving faults (decode_injector) ---
    decode_transient: float = 0.0
    # --- fault shapes ---
    hang_s: float = 0.05          # how long a "timeout" fault blocks
    outlier_factor: float = 40.0  # survives Theil-Sen, wrecks least squares
    log: List[Tuple[str, int, str]] = field(default_factory=list)
    _counters: Dict[Tuple[str, str], int] = field(default_factory=dict)

    def _rate(self, kind: str) -> float:
        return float(getattr(self, kind))

    def draw(self, site: str, kind: str) -> bool:
        """Advance the (site, kind) counter and decide whether the fault
        fires this call; fired faults are recorded in ``log``."""
        rate = self._rate(kind)
        k = self._counters.get((site, kind), 0)
        self._counters[(site, kind)] = k + 1
        if rate <= 0.0:
            return False
        h = hashlib.md5(repr((self.seed, site, kind, k)).encode()).digest()
        u = int.from_bytes(h[:8], "big") / float(1 << 64)     # [0, 1)
        fired = u < rate
        if fired:
            self.log.append((site, k, kind))
        return fired

    def probe_fault(self, site: str) -> Optional[str]:
        """The probe-fault kind firing for this call, if any (first in
        ``PROBE_FAULT_KINDS`` order wins; every kind's counter advances
        so the sequence stays deterministic regardless of which fires)."""
        fired = None
        for kind in PROBE_FAULT_KINDS:
            if self.draw(site, f"probe_{kind}") and fired is None:
                fired = kind
        return fired

    def reset(self) -> None:
        """Rewind to the pristine schedule (counters and log cleared) —
        replaying the same workload reproduces the same faults."""
        self._counters.clear()
        self.log.clear()


class FaultyDevice:
    """A :class:`Device` decorated with a :class:`FaultPlan`.

    Each timing primitive draws its probe faults under its own site name
    (``stream`` / ``compute`` / ``wave`` / ``gemm``), then corrupts the
    inner device's honest measurement:

    * ``timeout``  — block for ``plan.hang_s`` before answering; only the
      probes' watchdog deadline turns this into a dropped sample.
    * ``nan``      — NaN (``validate_measured``-class poison).
    * ``outlier``  — honest value x ``plan.outlier_factor``; must be
      survived by the robust fit, not the probe layer.
    * ``signflip`` — honest value negated; physically impossible, dropped
      at the probe layer like any non-positive sample.
    """

    def __init__(self, inner: Device, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self.name = f"faulty:{inner.name}"

    def _corrupt(self, site: str, value: float) -> float:
        kind = self.plan.probe_fault(site)
        if kind == "timeout":
            time.sleep(self.plan.hang_s)
            return value
        if kind == "nan":
            return float("nan")
        if kind == "outlier":
            return value * self.plan.outlier_factor
        if kind == "signflip":
            return -value
        return value

    def stream_time(self, nbytes: float, window: int,
                    n_chunks: int) -> float:
        return self._corrupt(
            "stream", self.inner.stream_time(nbytes, window, n_chunks))

    def compute_time(self, dtype: str, n_atoms: int,
                     n_parallel: int = 1) -> float:
        return self._corrupt(
            "compute", self.inner.compute_time(dtype, n_atoms, n_parallel))

    def wave_time(self, n_units: int, unit_atoms: int,
                  dtype: str) -> float:
        return self._corrupt(
            "wave", self.inner.wave_time(n_units, unit_atoms, dtype))

    def gemm_time(self, p: GemmProblem, t: TileConfig) -> float:
        return self._corrupt("gemm", self.inner.gemm_time(p, t))


# ---------------------------------------------------------------------------
# Kernel-launch and serving injectors.  The "transient" marker string is in
# runtime.fault_tolerance._TRANSIENT_MARKERS, so transient-kind faults are
# retried in place; compile-kind faults are deterministic and drive the
# fallback ladder.
# ---------------------------------------------------------------------------


class InjectedCompileError(RuntimeError):
    """A deterministic injected kernel compile/lowering failure."""


class InjectedTransientError(RuntimeError):
    """An injected transient fault (repr carries the 'transient' marker)."""


def launch_injector(plan: FaultPlan) -> Callable[[TileConfig], None]:
    """An injector for ``kernels.ops.set_launch_fault_injector`` drawing
    from ``plan``: compile faults (deterministic -> ladder) are drawn
    first, then transient faults (-> in-place retry)."""
    def inject(cfg: TileConfig) -> None:
        if plan.draw("launch", "launch_compile"):
            raise InjectedCompileError(
                f"injected compile failure for {cfg}")
        if plan.draw("launch", "launch_transient"):
            raise InjectedTransientError(
                f"transient: injected launch fault for {cfg}")
    return inject


def scripted_injector(
        script: Sequence[Optional[Exception]]) -> Callable[[TileConfig], None]:
    """An injector that replays an exact failure script: the i-th launch
    attempt raises ``script[i]`` (None -> succeed); attempts beyond the
    script succeed.  For ladder tests that need a precise sequence like
    [compile, compile, None] without tuning seeds."""
    it = iter(list(script))

    def inject(cfg: TileConfig) -> None:
        err = next(it, None)
        if err is not None:
            raise err
    return inject


def decode_injector(plan: FaultPlan) -> Callable[..., None]:
    """A per-decode-step fault hook for the serving loop
    (``run_serving(..., decode_fault=...)``): raises an
    :class:`InjectedTransientError` (retried by the loop's ``retry``
    wrapper) when the plan's ``decode_transient`` draw fires.  The hook
    runs *before* the step's donated-cache execution, so a retry replays
    an intact cache.  ``guard`` is the serving loop's PreemptionGuard —
    unused here, available to custom hooks (e.g. request a drain)."""
    def inject(step: int, guard=None) -> None:
        if plan.draw("decode", "decode_transient"):
            raise InjectedTransientError(
                f"transient: injected decode fault at step {step}")
    return inject


# ---------------------------------------------------------------------------
# Artifact / cache corruption.  These mutate files the way real rot does —
# a partial write, a bit-rotted constant, an entry edited out-of-band — so
# the guarded loaders' quarantine/fall-through behaviour is testable.
# ---------------------------------------------------------------------------


def tamper_artifact_fingerprint(path: str) -> None:
    """Edit one topology constant in a calibrated-topology artifact while
    leaving its recorded fingerprint untouched — the canonical 'constants
    edited after the fit' corruption ``load_calibrated_topology`` must
    reject."""
    with open(path) as f:
        doc = json.load(f)
    levels = doc["topology"]["levels"]
    levels[0]["bandwidth"] = float(levels[0]["bandwidth"]) * 1.5
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)


def truncate_file(path: str, frac: float = 0.5) -> None:
    """Cut a file mid-write: keep the leading ``frac`` of its bytes — the
    on-disk state a crash between ``write`` and ``replace`` leaves behind
    for any NON-atomic writer."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(int(size * frac), 1))


def corrupt_cache_entry(path: str, *, bm: int = 12288) -> int:
    """Tamper every entry of a persistent selection-cache file into a
    parseable-but-illegal config (non-menu, budget-busting ``bm``) without
    touching its topology fingerprint — valid JSON that only per-entry
    re-validation (``validate_selection``) can catch.  Returns the number
    of entries tampered."""
    with open(path) as f:
        table = json.load(f)
    n = 0
    for entry in table.values():
        cfg = entry.get("config")
        if isinstance(cfg, dict):
            cfg["bm"] = bm
            n += 1
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    return n
