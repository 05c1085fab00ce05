"""Calibration & model-fidelity subsystem (DESIGN.md §8).

Closes the loop between the analytical model and the hardware it claims to
predict, in three layers:

* **probes** (``probes.py``) — microbenchmark sweeps against a
  :class:`~repro_torch.calib.device.Device` (the port's kernels on the
  card through :class:`TorchDevice`, or the event simulator wrapped as a
  deterministic :class:`VirtualDevice` for CI);
* **fit** (``fit.py``) — robust fits from probe measurements to
  :class:`~repro_torch.core.topology.Topology` constants, serialized as
  calibrated-topology JSON artifacts with full provenance;
* **oracle** (``oracle.py``) — the exhaustive-autotune harness measuring
  the paper's headline fidelity number: % of the empirical optimum the
  zero-autotune analytical selection achieves, per preset x shape sweep.

Entry points: ``repro_torch.core.hardware.calibrate(base, device=...)``,
``tools/fit_topology_torch.py`` and ``tools/fit_residual_torch.py``
(CLIs).
"""
from repro_torch.calib.device import (CandidateMismatch, CheckedDevice,
                                      Device, TorchDevice, VirtualDevice,
                                      get_device)
from repro_torch.calib.faults import (FaultPlan, FaultyDevice,
                                InjectedCompileError,
                                InjectedTransientError, corrupt_cache_entry,
                                decode_injector, launch_injector,
                                scripted_injector,
                                tamper_artifact_fingerprint, truncate_file)
from repro_torch.calib.fit import CalibrationResult, fit_topology, theil_sen
from repro_torch.calib.oracle import (OracleRow, fidelity_report, fidelity_row,
                                fidelity_sweep, oracle_best,
                                scaled_llama3_shapes)
from repro_torch.calib.probes import (ProbeSweep, ProbeTimeout, level_windows,
                                probe_compute, probe_issue, probe_latency,
                                probe_stream_levels, probe_wave, run_probes)
from repro_torch.calib.residual import (RESIDUAL_SCHEMA, ResidualCorrector,
                                  ResidualRow, fit_residual, load_residual,
                                  load_residual_guarded, residual_pick,
                                  rows_from_drift, rows_from_sweep)

__all__ = [
    "CandidateMismatch", "CheckedDevice", "Device", "TorchDevice",
    "VirtualDevice", "get_device",
    "FaultPlan", "FaultyDevice", "InjectedCompileError",
    "InjectedTransientError", "corrupt_cache_entry", "decode_injector",
    "launch_injector", "scripted_injector", "tamper_artifact_fingerprint",
    "truncate_file",
    "CalibrationResult", "fit_topology", "theil_sen",
    "OracleRow", "fidelity_report", "fidelity_row", "fidelity_sweep",
    "oracle_best", "scaled_llama3_shapes",
    "ProbeSweep", "ProbeTimeout", "level_windows", "probe_compute",
    "probe_issue", "probe_latency", "probe_stream_levels", "probe_wave",
    "run_probes",
    "RESIDUAL_SCHEMA", "ResidualCorrector", "ResidualRow", "fit_residual",
    "load_residual", "load_residual_guarded", "residual_pick",
    "rows_from_drift", "rows_from_sweep",
]
