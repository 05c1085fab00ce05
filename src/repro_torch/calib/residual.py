"""Learned residual corrector on the drift stream (DESIGN.md §12).

The analytical model is the interpretable prior; what its probes can't
isolate (compiler scheduling, cache politics, measurement substrate) shows
up as a systematic ratio between predicted and measured seconds.  This
module fits that ratio — a ridge regression on ``log(measured /
predicted)`` over shape/config features — from exactly the rows the drift
monitor already writes (``repro/drift/v1`` JSONL: the serving
telemetry) and/or device sweeps, and packages it as a fingerprint-stamped
``repro/residual/v1`` artifact with the same provenance / digest /
quarantine semantics as calibrated topologies.

Training-set hygiene is the whole game (the satellite bugfixes in this
PR exist because it is):

* rows are grouped by **topology fingerprint** and only rows matching the
  live topology's fingerprint are kept — a recalibration orphans the old
  rows instead of letting them steer the new model;
* a ``topo`` column holding a preset *name* (the old
  ``record_selection`` default) is refused with a counted warning — names
  survive recalibration unchanged and cannot be validated;
* rows without a config (whole-step sites), with non-positive /
  non-finite times, or on malformed JSONL lines are counted and dropped.

Application is an opt-in post-ranking stage: ``repro_torch.core.selector``
re-prices only the top-F analytically-ranked candidates through
:meth:`ResidualCorrector.correct` (duck-typed — core never imports this
module), with the correction clipped in log space and a switch margin so
an uncertain residual can neither explode a price nor churn selections
the model already got right.  With no corrector installed, selection is
bit-identical to this module not existing.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import re
import time as _time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.selector import select_topk
from repro_torch.core.topology import (SCHEDULES, DegradedModeWarning, Topology,
                                 quarantine_artifact, topology_fingerprint)
from repro_torch.obs.drift import DRIFT_SCHEMA

RESIDUAL_SCHEMA = "repro/residual/v1"

# A topology fingerprint is 16 lowercase hex chars (md5 prefix,
# core/topology.py).  Anything else in a ``topo`` column is name-shaped —
# unverifiable against the live topology, refused by the fitter.
_FP_RE = re.compile(r"^[0-9a-f]{16}$")

FEATURE_NAMES: Tuple[str, ...] = (
    "log2_m", "log2_n", "log2_k", "log2_batch",
    "log2_bm", "log2_bn", "log2_bk", "log2_sk", "log2_gm",
    "log2_tm", "log2_tn", "log2_tk", "log2_steps",
    "log2_waves", "tail_frac", "log2_intensity",
) + tuple(f"sched_{s}" for s in SCHEDULES)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _feature_vector(M: int, N: int, K: int, batch: int,
                    bm: int, bn: int, bk: int, sk: int, gm: int,
                    schedule: str, cores: int) -> np.ndarray:
    """One row of the design matrix.  Everything the drift stream records
    about a GEMM, in log2 where spans are multiplicative: problem dims,
    config dims, and the derived grid/wave terms the model's misses
    correlate with (tail waves, arithmetic intensity)."""
    Tm, Tn = _cdiv(M, bm), _cdiv(N, bn)
    Tk = _cdiv(_cdiv(K, sk), bk) * sk
    steps = Tm * Tn * Tk * batch
    base_tiles = Tm * Tn * batch * sk
    waves = _cdiv(base_tiles, cores)
    tail = (base_tiles - (waves - 1) * cores) / cores
    intensity = 2.0 * M * N * K / (M * K + K * N + M * N)
    lg = math.log2
    vec = [lg(M), lg(N), lg(K), lg(batch),
           lg(bm), lg(bn), lg(bk), lg(sk), lg(gm),
           lg(Tm), lg(Tn), lg(Tk), lg(steps),
           lg(waves), tail, lg(intensity)]
    vec += [1.0 if schedule == s else 0.0 for s in SCHEDULES]
    return np.asarray(vec, np.float64)


@dataclass(frozen=True)
class ResidualRow:
    """One training sample: a (shape, config) whose prediction was checked
    against a measurement."""

    M: int
    N: int
    K: int
    batch: int
    config: Mapping[str, object]     # bm/bn/bk/split_k/group_m/schedule
    predicted_s: float
    measured_s: float

    @property
    def log_ratio(self) -> float:
        return math.log(self.measured_s / self.predicted_s)

    def features(self, cores: int) -> np.ndarray:
        c = self.config
        return _feature_vector(
            self.M, self.N, self.K, self.batch,
            int(c["bm"]), int(c["bn"]), int(c["bk"]),
            int(c.get("split_k", 1)), int(c.get("group_m", 1)),
            str(c.get("schedule", "data_parallel")), cores)


@dataclass(frozen=True)
class ResidualCorrector:
    """The fitted corrector: standardized linear model over
    :data:`FEATURE_NAMES` predicting ``log(measured / predicted)``.

    ``fingerprint`` is the topology content fingerprint the training rows
    were validated against — the selector ignores the corrector (counted
    metric) whenever the live topology's fingerprint differs, exactly as
    the selection cache invalidates on recalibration.  ``clip`` bounds the
    log-space correction; ``top_f`` is how many analytically-ranked
    finalists the selector re-prices; ``switch_margin`` is the relative
    corrected advantage required to overrule the analytical winner."""

    feature_names: Tuple[str, ...]
    mean: Tuple[float, ...]
    scale: Tuple[float, ...]
    weights: Tuple[float, ...]
    intercept: float
    clip: float
    top_f: int
    switch_margin: float
    fingerprint: str                 # topology fingerprint trained against
    hardware: str                    # preset name (display only)
    provenance: Dict = field(default_factory=dict, compare=False)

    # -- application -------------------------------------------------------

    def predict_log_ratio(self, X: np.ndarray) -> np.ndarray:
        z = (X - np.asarray(self.mean)) / np.asarray(self.scale)
        raw = z @ np.asarray(self.weights) + self.intercept
        return np.clip(raw, -self.clip, self.clip)

    def correct(self, p, configs: Sequence, totals, hw) -> np.ndarray:
        """Re-price ``totals`` (model-predicted seconds for ``configs`` of
        problem ``p`` on topology ``hw``) with the learned multiplicative
        residual.  Duck-typed for the selector: ``p`` needs M/N/K/batch,
        configs need bm/bn/bk/split_k/group_m/schedule."""
        cores = hw.total_cores()
        X = np.stack([
            _feature_vector(p.M, p.N, p.K, p.batch, t.bm, t.bn, t.bk,
                            t.split_k, t.group_m, t.schedule, cores)
            for t in configs])
        return np.asarray(totals, np.float64) \
            * np.exp(self.predict_log_ratio(X))

    # -- artifact ----------------------------------------------------------

    def _model_dict(self) -> Dict:
        return {"feature_names": list(self.feature_names),
                "mean": list(self.mean), "scale": list(self.scale),
                "weights": list(self.weights),
                "intercept": self.intercept, "clip": self.clip,
                "top_f": self.top_f, "switch_margin": self.switch_margin}

    def content_fingerprint(self) -> str:
        """Content hash of the model block — the residual memo-namespace
        key in the selector (a refit corrector must re-select)."""
        blob = json.dumps(self._model_dict(), sort_keys=True)
        return hashlib.md5(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict:
        prov = dict(self.provenance)
        prov["fingerprint"] = self.fingerprint
        prov["hardware"] = self.hardware
        prov["model_digest"] = self.content_fingerprint()
        return {"schema": RESIDUAL_SCHEMA, "model": self._model_dict(),
                "provenance": prov}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


# ---------------------------------------------------------------------------
# Training-set assembly.
# ---------------------------------------------------------------------------

def _row_ok(predicted_s: float, measured_s: float) -> bool:
    return (math.isfinite(predicted_s) and math.isfinite(measured_s)
            and predicted_s > 0.0 and measured_s > 0.0)


def rows_from_drift(path: str, *, fingerprint: str,
                    ) -> Tuple[List[ResidualRow], Dict[str, int]]:
    """Consume a ``drift.jsonl`` stream into training rows for the
    topology with content fingerprint ``fingerprint``.

    Returns ``(rows, stats)`` where stats counts every rejection class:
    ``malformed`` (truncated writer tail), ``no_config`` (whole-step
    sites), ``bad_measurement`` (non-finite / non-positive),
    ``name_shaped_topo`` (a preset name where a fingerprint belongs — the
    pre-fix ``record_selection`` default; refused with a warning),
    ``fingerprint_mismatch`` (rows from a since-recalibrated topology).
    """
    stats = {"total": 0, "kept": 0, "malformed": 0, "no_config": 0,
             "bad_measurement": 0, "name_shaped_topo": 0,
             "fingerprint_mismatch": 0}
    rows: List[ResidualRow] = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            stats["total"] += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                stats["malformed"] += 1
                continue
            if rec.get("schema") != DRIFT_SCHEMA:
                stats["malformed"] += 1
                continue
            topo = str(rec.get("topo") or "")
            if topo and not _FP_RE.match(topo):
                stats["name_shaped_topo"] += 1
                continue
            if topo != fingerprint:
                stats["fingerprint_mismatch"] += 1
                continue
            cfg = rec.get("config")
            if not cfg:
                stats["no_config"] += 1
                continue
            try:
                pred = float(rec["predicted_s"])
                meas = float(rec["measured_s"])
                shape = list(rec["shape"])
                row = ResidualRow(
                    M=int(shape[0]), N=int(shape[1]), K=int(shape[2]),
                    batch=int(shape[3]) if len(shape) > 3 else 1,
                    config=dict(cfg), predicted_s=pred, measured_s=meas)
            except (KeyError, TypeError, ValueError, IndexError):
                stats["malformed"] += 1
                continue
            if not _row_ok(pred, meas):
                stats["bad_measurement"] += 1
                continue
            rows.append(row)
            stats["kept"] += 1
    if stats["name_shaped_topo"]:
        warnings.warn(
            f"{path}: refused {stats['name_shaped_topo']} drift row(s) "
            f"whose topo column holds a preset name, not a topology "
            f"fingerprint — they cannot be validated against the live "
            f"topology and would poison the residual training set "
            f"(re-record with a fingerprint-carrying Selection)",
            UserWarning, stacklevel=2)
    return rows, stats


def rows_from_sweep(hw: Topology, device, shapes: Sequence[Sequence[int]],
                    *, k: int = 12) -> List[ResidualRow]:
    """Supplement (or replace) the drift stream by sweeping ``device``
    directly: for each (M, N, K[, batch]) shape, measure the top-``k``
    analytically-ranked candidates.  The default ``k`` deliberately
    over-spans the corrector's ``top_f`` re-pricing slate (8): every
    finalist the corrector will re-price at selection time must be
    in-distribution, with margin — a corrector trained on a narrower
    slate extrapolates onto exactly the configs it is asked to rank."""
    from repro_torch.core.latency import GemmProblem, gemm_latency

    rows: List[ResidualRow] = []
    for s in shapes:
        M, N, K = int(s[0]), int(s[1]), int(s[2])
        batch = int(s[3]) if len(s) > 3 else 1
        p = GemmProblem(M=M, N=N, K=K, batch=batch)
        configs, totals, _ = select_topk(p, hw, k)
        for t, pred in zip(configs, totals.tolist()):
            try:
                meas = float(device.gemm_time(p, t))
            except RuntimeError:
                continue
            if not _row_ok(pred, meas):
                continue
            rows.append(ResidualRow(
                M=M, N=N, K=K, batch=batch,
                config={"bm": t.bm, "bn": t.bn, "bk": t.bk,
                        "split_k": t.split_k, "group_m": t.group_m,
                        "schedule": t.schedule},
                predicted_s=float(pred), measured_s=meas))
    return rows


# ---------------------------------------------------------------------------
# Fitting.
# ---------------------------------------------------------------------------

MIN_FIT_ROWS = 8


def fit_residual(rows: Sequence[ResidualRow], hw: Topology, *,
                 ridge: float = 1e-2, clip: float = 0.5, top_f: int = 8,
                 switch_margin: float = 0.02,
                 sources: Optional[Sequence[str]] = None,
                 stats: Optional[Mapping[str, int]] = None,
                 ) -> ResidualCorrector:
    """Closed-form ridge fit of ``log(measured / predicted)`` on the
    standardized feature matrix.  Numpy-only; deterministic.  Raises
    ``ValueError`` below :data:`MIN_FIT_ROWS` rows — a residual fit on a
    handful of points would memorize noise, not absorb structure."""
    if len(rows) < MIN_FIT_ROWS:
        raise ValueError(
            f"too few rows to fit a residual: {len(rows)} < {MIN_FIT_ROWS}")
    cores = hw.total_cores()
    X = np.stack([r.features(cores) for r in rows])
    y = np.asarray([r.log_ratio for r in rows], np.float64)
    mean = X.mean(axis=0)
    scale = X.std(axis=0)
    scale[scale == 0.0] = 1.0         # constant feature: weight stays 0
    Z = (X - mean) / scale
    n, d = Z.shape
    A = Z.T @ Z + ridge * n * np.eye(d)
    b = Z.T @ (y - y.mean())
    w = np.linalg.solve(A, b)
    intercept = float(y.mean())
    resid = Z @ w + intercept - y
    rmse = float(np.sqrt(np.mean(resid ** 2)))
    prov: Dict = {
        "n_rows": n,
        "train_rmse_log": rmse,
        "train_mean_abs_log_ratio": float(np.mean(np.abs(y))),
        "ridge": ridge,
        "created_unix": _time.time(),
        "sources": list(sources or []),
    }
    if stats:
        prov["row_stats"] = dict(stats)
    return ResidualCorrector(
        feature_names=FEATURE_NAMES, mean=tuple(mean.tolist()),
        scale=tuple(scale.tolist()), weights=tuple(w.tolist()),
        intercept=intercept, clip=float(clip), top_f=int(top_f),
        switch_margin=float(switch_margin),
        fingerprint=topology_fingerprint(hw), hardware=hw.name,
        provenance=prov)


def residual_pick(res: ResidualCorrector, p, hw, *,
                  allow_split_k: bool = True, allow_grouping: bool = True):
    """The corrected argmin over the top-F analytical finalists — the same
    choice rule the selector applies (clip + switch margin), exposed for
    the oracle/fidelity harness to evaluate a corrector WITHOUT installing
    it process-wide.  Returns (config, n_candidates)."""
    configs, totals, n = select_topk(
        p, hw, res.top_f, allow_split_k=allow_split_k,
        allow_grouping=allow_grouping)
    corrected = res.correct(p, configs, totals, hw)
    j = int(np.argmin(corrected))
    if j != 0 and not corrected[j] < corrected[0] * (1.0 - res.switch_margin):
        j = 0
    return configs[j], n


# ---------------------------------------------------------------------------
# Artifact loading — mirrors core/topology.py's calibrated-topology pair:
# a strict parser for tools, a fail-soft guarded loader for serving.
# ---------------------------------------------------------------------------

def load_residual(text: str) -> ResidualCorrector:
    """Parse a ``repro/residual/v1`` artifact.  Validates the schema tag
    and the recorded model digest against the recomputed one — an artifact
    whose weights were edited after the fit is rejected, exactly like a
    calibrated topology whose constants no longer match its fingerprint."""
    doc = json.loads(text)
    schema = doc.get("schema")
    if schema != RESIDUAL_SCHEMA:
        raise ValueError(f"not a residual artifact: schema={schema!r}, "
                         f"expected {RESIDUAL_SCHEMA!r}")
    m = doc["model"]
    prov = dict(doc.get("provenance", {}))
    fp = str(prov.get("fingerprint") or "")
    if not _FP_RE.match(fp):
        raise ValueError(
            f"residual artifact carries no topology fingerprint "
            f"(got {fp!r}) — cannot be validated against a live topology")
    corr = ResidualCorrector(
        feature_names=tuple(m["feature_names"]),
        mean=tuple(float(v) for v in m["mean"]),
        scale=tuple(float(v) for v in m["scale"]),
        weights=tuple(float(v) for v in m["weights"]),
        intercept=float(m["intercept"]), clip=float(m["clip"]),
        top_f=int(m["top_f"]), switch_margin=float(m["switch_margin"]),
        fingerprint=fp, hardware=str(prov.get("hardware", "")),
        provenance=prov)
    if len(corr.mean) != len(corr.feature_names) \
            or len(corr.scale) != len(corr.feature_names) \
            or len(corr.weights) != len(corr.feature_names):
        raise ValueError("residual artifact is corrupt: feature/weight "
                         "vector lengths disagree")
    recorded = prov.get("model_digest")
    actual = corr.content_fingerprint()
    if recorded != actual:
        raise ValueError(
            f"residual artifact for {corr.hardware!r} is corrupt: recorded "
            f"model digest {recorded!r} != recomputed {actual!r} "
            f"(weights were edited after the fit)")
    return corr


def load_residual_guarded(
    path: str,
    *,
    expect: Optional[Topology] = None,
    quarantine: bool = True,
) -> Tuple[Optional[ResidualCorrector], Dict]:
    """Fail-soft residual loading for serving paths (mirrors
    ``load_calibrated_topology_guarded``).  Never raises on a bad
    artifact: a truncated / tampered / wrong-schema file is quarantined to
    a ``.quarantined`` sidecar with a :class:`DegradedModeWarning`, and
    ``(None, info)`` is returned so serving continues on the pure
    analytical model (which is always correct — the corrector is an
    accuracy upgrade, never a dependency).

    ``expect`` additionally rejects an artifact fit for a different
    topology fingerprint — stale, not corrupt, so it is warned about but
    NOT quarantined (it may be the right artifact for another host)."""
    def _degrade(reason: str, *, evidence: bool) -> Tuple[None, Dict]:
        sidecar = None
        if evidence and quarantine and os.path.exists(path):
            try:
                sidecar = quarantine_artifact(path)
            except OSError:
                pass
        warnings.warn(
            f"residual artifact {path!r} rejected ({reason}); serving on "
            f"the pure analytical model"
            + (f"; artifact quarantined to {sidecar!r}" if sidecar else ""),
            DegradedModeWarning, stacklevel=3)
        return None, {"degraded": reason, "quarantined": sidecar}

    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        warnings.warn(
            f"residual artifact {path!r} unreadable ({e}); serving on the "
            f"pure analytical model",
            DegradedModeWarning, stacklevel=2)
        return None, {"degraded": f"unreadable: {e}", "quarantined": None}
    try:
        corr = load_residual(text)
    except (ValueError, KeyError, TypeError) as e:
        return _degrade(str(e) or type(e).__name__, evidence=True)
    if expect is not None:
        live = topology_fingerprint(expect)
        if corr.fingerprint != live:
            return _degrade(
                f"fit for topology fingerprint {corr.fingerprint!r}, live "
                f"topology is {live!r} (stale, not quarantined)",
                evidence=False)
    return corr, dict(corr.provenance)
