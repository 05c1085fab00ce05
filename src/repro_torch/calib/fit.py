"""Fit Topology constants from probe measurements (DESIGN.md §8).

The probe layer (``probes.py``) returns raw ``(x, seconds)`` sweeps; this
module turns their slopes and intercepts into calibrated
:class:`~repro_torch.core.topology.Topology` fields:

* per-level ``bandwidth``   <- 1 / slope of the ``stream:<level>`` sweeps;
* ``peak_flops[dtype]``     <- atom FLOPs / slope of ``compute:<dtype>``;
* ``kernel_launch``         <- intercept of the ``wave`` staircase;
* ``dma_fixed``             <- slope of the ``issue`` sweep;
* backing ``latency``       <- intercept of the single-pass ``latency``
                               sweep minus launch and one issue cost;
* ``static_share``          <- wave slope x fitted peak / (unit work x C):
  how much of the chip's rate one core actually got, ~1.0 when the
  occupancy stage's static 1/C share assumption holds (recorded in
  provenance, not a Topology field — it validates the model's shape).

Fits are Theil-Sen (median of pairwise slopes): robust to the occasional
outlier a wall-clock measurement produces, identical to least squares on
clean data.  Every fitted value passes the same positivity/finiteness
validation ``repro_torch.core.hardware.calibrate`` applies to hand-supplied
microbenchmarks, and the result serializes to the calibrated-topology JSON
artifact (``core/topology.py::calibrated_topology_json``) whose provenance
carries the raw sweeps, per-fit relative residuals, and the topology
fingerprint the selection cache keys invalidation on.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.calib.device import Device
from repro_torch.calib.probes import ProbeSweep, run_probes
from repro_torch.core.topology import (Topology, calibrated_topology_json,
                                 reference_dtype, topology_fingerprint)


def theil_sen(xs: Sequence[float], ys: Sequence[float]
              ) -> Tuple[float, float]:
    """Robust (slope, intercept): median pairwise slope, median residual
    intercept.  Exact on collinear data; breaks down only past ~29%
    outliers."""
    if len(xs) < 2:
        raise ValueError("need >= 2 samples to fit a line")
    slopes = sorted((ys[j] - ys[i]) / (xs[j] - xs[i])
                    for i in range(len(xs)) for j in range(i + 1, len(xs))
                    if xs[j] != xs[i])
    if not slopes:
        # Every surviving x coincides (e.g. watchdog/NaN dropping reduced a
        # sweep to one repeated point): there is no slope to take a median
        # of.  A clean ValueError lets fit_topology(allow_degraded=True)
        # keep the preset constant and record the reason, instead of the
        # bare IndexError _median([]) used to raise.
        raise ValueError(
            f"degenerate sweep: all {len(xs)} samples share x={xs[0]!r}, "
            f"no pairwise slope exists")
    slope = _median(slopes)
    intercept = _median(sorted(y - slope * x for x, y in zip(xs, ys)))
    return slope, intercept


def _median(sorted_vals: List[float]) -> float:
    n = len(sorted_vals)
    mid = n // 2
    return (sorted_vals[mid] if n % 2
            else 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid]))


def _rel_residual(sweep: ProbeSweep, slope: float, intercept: float) -> float:
    """Root-mean-square relative residual of the fitted line."""
    acc = 0.0
    for x, y in sweep.samples:
        pred = intercept + slope * x
        acc += ((pred - y) / y) ** 2 if y else 0.0
    return (acc / len(sweep.samples)) ** 0.5


@dataclass
class CalibrationResult:
    """A fitted topology plus everything needed to audit / reproduce it."""

    base: Topology
    topology: Topology
    device_name: str
    fitted: Dict[str, float]          # field path -> fitted value
    residuals: Dict[str, float]       # field path -> rel RMS residual
    static_share: float               # wave-probe share coefficient (~1.0)
    probes: Dict[str, ProbeSweep] = field(default_factory=dict)
    created_unix: float = 0.0
    degraded: Dict[str, str] = field(default_factory=dict)
    # field path -> why its fit was skipped and the preset value kept
    # (degraded-mode calibration, DESIGN.md §9); empty on a clean fit

    def provenance(self) -> Dict:
        return {
            "device": self.device_name,
            "base_preset": self.base.name,
            "created_unix": self.created_unix,
            "fitted_fields": dict(self.fitted),
            "residuals": dict(self.residuals),
            "degraded": dict(self.degraded),
            "static_share": self.static_share,
            "base_fingerprint": topology_fingerprint(self.base),
            "probes": {k: v.to_dict() for k, v in self.probes.items()},
        }

    def to_json(self) -> str:
        return calibrated_topology_json(self.topology, self.provenance())

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    def compare_to(self, truth: Topology) -> Dict[str, float]:
        """Relative error of each fitted field against a ground-truth
        topology (the virtual device's planted constants, in tests)."""
        out: Dict[str, float] = {}
        truth_levels = {l.name: l for l in truth.levels}
        for key, val in self.fitted.items():
            if key.startswith("levels.") and key.endswith(".bandwidth"):
                ref = truth_levels[key.split(".")[1]].bandwidth
            elif key.startswith("peak_flops."):
                ref = truth.peak_flops[key.split(".", 1)[1]]
            elif key == "hbm_latency":
                ref = truth.backing.latency
            else:
                ref = getattr(truth, key)
            out[key] = abs(val - ref) / ref if ref else abs(val)
        return out


_FIT_ERRORS = (ValueError, KeyError, IndexError, ZeroDivisionError)


def fit_topology(base: Topology, device: Device, *,
                 dtypes: Optional[Sequence[str]] = None,
                 probes: Optional[Mapping[str, ProbeSweep]] = None,
                 deadline_s: Optional[float] = None,
                 allow_degraded: bool = False,
                 ) -> CalibrationResult:
    """Run (or reuse) the probe suite against ``device`` and fit a
    calibrated topology from ``base``'s structure.

    Structure (level chain, capacities, core counts, menus, MXU shape) is
    taken from the datasheet preset; only *rates and overheads* are fitted
    — exactly the paper's §V-E retargeting contract.  Levels whose sweep is
    missing (budget inversion) keep their preset bandwidth.

    ``deadline_s`` bounds each probe call with the watchdog (probes.py).
    ``allow_degraded=True`` turns per-field fit failures (too few surviving
    samples after watchdog drops, a fit value failing ``validate_measured``)
    into *kept preset values* recorded in ``CalibrationResult.degraded``
    (and artifact provenance) instead of aborting the whole calibration —
    the fail-soft mode for untrusted substrates (DESIGN.md §9).  The
    default remains fail-fast: a tool run should see the error."""
    from repro_torch.core.hardware import validate_measured

    sweeps = dict(probes) if probes is not None \
        else run_probes(device, base, dtypes=dtypes, deadline_s=deadline_s)
    mm, mn, mk = base.mxu_shape
    atom_flops = 2.0 * mm * mn * mk
    fitted: Dict[str, float] = {}
    residuals: Dict[str, float] = {}
    degraded: Dict[str, str] = {}

    def _give_up(name: str, e: Exception) -> None:
        if not allow_degraded:
            raise
        degraded[name] = str(e) or type(e).__name__

    # -- compute issue rate per dtype -> peak_flops ------------------------
    peak = dict(base.peak_flops)
    for key, sw in sweeps.items():
        if sw.kind != "compute":
            continue
        try:
            slope, icpt = theil_sen(sw.xs(), sw.ys())
            value = atom_flops / slope
            validate_measured(f"peak_flops.{sw.target}", value)
        except _FIT_ERRORS as e:
            _give_up(f"peak_flops.{sw.target}", e)
            continue
        peak[sw.target] = value
        fitted[f"peak_flops.{sw.target}"] = value
        residuals[f"peak_flops.{sw.target}"] = _rel_residual(sw, slope, icpt)

    # -- wave staircase -> kernel_launch + static-share coefficient --------
    kernel_launch = base.kernel_launch
    static_share = 1.0          # degraded: assume the model's static share
    try:
        wave = sweeps["wave"]
        w_slope, w_icpt = theil_sen(wave.xs(), wave.ys())
        kernel_launch = max(w_icpt, 0.0)
        validate_measured("kernel_launch", kernel_launch)
        C = base.total_cores()
        unit_atoms = wave.params["unit_atoms"]
        # The dtype the wave probe actually timed (recorded on the sweep;
        # legacy sweeps without it fall back to the same shared rule).
        ref_dtype = wave.target or reference_dtype(peak)
        static_share = (w_slope * peak[ref_dtype]
                        / (unit_atoms * atom_flops * C))
    except _FIT_ERRORS as e:
        kernel_launch = base.kernel_launch
        _give_up("kernel_launch", e)
    else:
        fitted["kernel_launch"] = kernel_launch
        residuals["kernel_launch"] = _rel_residual(wave, w_slope, w_icpt)

    # -- issue sweep -> dma_fixed ------------------------------------------
    dma_fixed = base.dma_fixed
    try:
        issue = sweeps["issue"]
        i_slope, i_icpt = theil_sen(issue.xs(), issue.ys())
        dma_fixed = max(i_slope, 0.0)
        validate_measured("dma_fixed", dma_fixed)
    except _FIT_ERRORS as e:
        dma_fixed = base.dma_fixed
        _give_up("dma_fixed", e)
    else:
        fitted["dma_fixed"] = dma_fixed
        residuals["dma_fixed"] = _rel_residual(issue, i_slope, i_icpt)

    # -- per-level stream sweeps -> bandwidths ------------------------------
    bandwidths: Dict[str, float] = {}
    for key, sw in sweeps.items():
        if sw.kind != "stream":
            continue
        try:
            slope, icpt = theil_sen(sw.xs(), sw.ys())
            value = 1.0 / slope
            validate_measured(f"levels.{sw.target}.bandwidth", value)
        except _FIT_ERRORS as e:
            _give_up(f"levels.{sw.target}.bandwidth", e)
            continue
        bandwidths[sw.target] = value
        fitted[f"levels.{sw.target}.bandwidth"] = value
        residuals[f"levels.{sw.target}.bandwidth"] = \
            _rel_residual(sw, slope, icpt)

    # -- single-pass latency sweep -> backing first-byte latency -----------
    hbm_latency = base.backing.latency
    try:
        lat = sweeps["latency"]
        l_slope, l_icpt = theil_sen(lat.xs(), lat.ys())
        hbm_latency = max(l_icpt - kernel_launch - dma_fixed, 0.0)
        validate_measured("hbm_latency", hbm_latency)
    except _FIT_ERRORS as e:
        hbm_latency = base.backing.latency
        _give_up("hbm_latency", e)
    else:
        fitted["hbm_latency"] = hbm_latency
        residuals["hbm_latency"] = _rel_residual(lat, l_slope, l_icpt)

    levels = tuple(
        replace(l,
                bandwidth=bandwidths.get(l.name, l.bandwidth),
                latency=hbm_latency if l is base.backing else l.latency)
        for l in base.levels)
    topo = base.with_calibration(levels=levels, peak_flops=peak,
                                 kernel_launch=kernel_launch,
                                 dma_fixed=dma_fixed)
    return CalibrationResult(
        base=base, topology=topo, device_name=device.name,
        fitted=fitted, residuals=residuals, static_share=static_share,
        probes=sweeps, created_unix=_time.time(), degraded=degraded)
