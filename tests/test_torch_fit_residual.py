"""``tools/fit_residual_torch.py`` on this host: the held-out report with a
calibrated topology on the virtual device (the calibrated selection priced
against the same oracle as the preset's), and the card's path, where every
candidate is held to the plain product first (``CheckedDevice``), run on
the CPU's plain versions with a planted wrong candidate.
"""
import json
import pathlib
import sys
from unittest import mock

import pytest

from repro_torch.calib import TorchDevice, device as cdev
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import GemmProblem
from repro_torch.core.selector import select_gemm_config
from repro_torch.core.topology import load_calibrated_topology
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import fit_residual_torch as frt  # noqa: E402
import fit_topology_torch as ftt  # noqa: E402


def test_heldout_report_prices_the_calibrated_selection(tmp_path):
    topo_path = tmp_path / "h100.topo.json"
    with mock.patch.object(sys, "argv", [
            "fit_topology_torch.py", "--device", "virtual",
            "--out", str(topo_path)]):
        assert ftt.main() == 0
    out = tmp_path / "h100.residual.json"
    assert frt.main(["--device", "virtual", "--smoke",
                     "--check-against-oracle", "--topology", str(topo_path),
                     "--out", str(out)]) == 0
    report = json.loads(
        (tmp_path / "residual_report_gpu_h100_like.json").read_text())
    topo, _ = load_calibrated_topology(topo_path.read_text())
    dev = cdev.get_device("virtual", GPU_H100_LIKE)
    rows, cal = report["rows"], report["calibrated_rows"]
    assert len(rows) == len(cal) == report["n_shapes"] == 5
    for row, c in zip(rows, cal):
        gemm, M, N, K, oracle_s = row[1], row[2], row[3], row[4], row[9]
        pick = select_gemm_config(M, N, K, hw=topo).config
        s = dev.gemm_time(GemmProblem(M=M, N=N, K=K), pick)
        assert (c["gemm"], c["selected"]) == (gemm, str(pick))
        assert c["selected_s"] == pytest.approx(s, rel=1e-12)
        # the row's oracle seconds are printed to 7 digits
        assert c["fidelity"] == pytest.approx(float(oracle_s) / s, rel=1e-6)
        assert 0.0 < c["fidelity"] <= 1.0 + 1e-9
    assert report["mean_calibrated_fidelity"] == pytest.approx(
        sum(c["fidelity"] for c in cal) / len(cal), rel=1e-12)
    assert report["worst_calibrated_fidelity"] == min(
        c["fidelity"] for c in cal)
    assert report["mean_corrected_fidelity"] >= \
        report["mean_fidelity"] - 0.005


def test_a_wrong_candidate_stops_the_tool_on_the_card_path(tmp_path, capsys):
    """``--device torch`` wraps the device in ``CheckedDevice``: here the
    device is the CPU's (plain versions) and every GEMM comes out doubled,
    so the first candidate checked stops the oracle sweep and the tool
    returns 1 without writing an artifact."""
    real = ops.matmul

    def doubled(a, b, **kw):
        return real(a, b, **kw) * 2.0

    def cpu_device(kind, base, **kw):
        assert kind == "torch"
        return TorchDevice(device="cpu", repeat=1)
    out = tmp_path / "h100.residual.json"
    with mock.patch.object(frt, "get_device", cpu_device), \
            mock.patch.object(ops, "matmul", doubled):
        rc = frt.main(["--device", "torch", "--smoke",
                       "--check-against-oracle", "--out", str(out)])
    assert rc == 1
    said = capsys.readouterr().out
    assert "[residual] FAIL: candidate" in said
    assert "disagrees with the plain product" in said
    assert "[residual] fit " not in said and not out.exists()
