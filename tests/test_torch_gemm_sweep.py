"""``tools/gemm_sweep.py`` (every candidate of the selector's space, held to
the plain product, then timed) and ``calib/device.py::CheckedDevice`` (the
oracle's device on the card, each candidate checked before it is timed),
on this host: the kernel launches are the plain versions and the timer a
stub, so what is tested is the loop's bookkeeping, never a time.
"""
import pathlib
import subprocess
import sys
from unittest import mock

import pytest
import torch

from repro_torch.calib import (CandidateMismatch, CheckedDevice, TorchDevice,
                               oracle_best)
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import GemmProblem
from repro_torch.core.selector import (candidate_tiles, rank_candidates,
                                       select_gemm_config)
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gemm_check

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import gemm_sweep as gs  # noqa: E402

CPU = torch.device("cpu")


def test_groups_are_the_main_path_shapes():
    cs = gs.cs
    assert set(gs.GROUPS) == {
        "mamba2_decode", "mamba2_prefill", "zamba2_decode",
        "zamba2_prefill", "zamba2_f32_decode", "phi4_dx", "phi4_dw",
        "qwen3_bwd"}
    assert [(s.M, s.N, s.K) for s in gs.GROUPS["mamba2_decode"]] == \
        [(4, N, K) for _, N, K, _ in cs.SSM_GEMMS]
    assert [(s.M, s.N, s.K) for s in gs.GROUPS["zamba2_prefill"]] == \
        [(474, N, K) for _, N, K, _ in cs.MAMBA_GEMMS]
    assert {s.dtype for s in gs.GROUPS["zamba2_f32_decode"]} == {"float32"}
    # mamba2-370m: D 1024, d_inner 2048, state 128, 32 heads.
    assert [(s.gemm, s.N, s.K) for s in gs.GROUPS["mamba2_prefill"]] == [
        ("in_z", 2048, 1024), ("in_x", 2048, 1024), ("in_b", 128, 1024),
        ("in_c", 128, 1024), ("in_dt", 32, 1024), ("out_proj", 1024, 2048)]
    # phi4-mini's backward at T = 4 x 512: dX = dY W^T, dW = X^T dY.
    for (name, N, K, _), dx, dw in zip(cs.PATH_GEMMS, gs.GROUPS["phi4_dx"],
                                       gs.GROUPS["phi4_dw"]):
        assert (dx.gemm, dx.layout, dx.M, dx.N, dx.K) == \
            (name, "nt", 2048, K, N)
        assert (dw.gemm, dw.layout, dw.M, dw.N, dw.K) == \
            (name, "tn", K, N, 2048)
    assert [(s.gemm, s.M, s.N, s.K, s.experts)
            for s in gs.GROUPS["qwen3_bwd"]] == [
        ("wu dX", 160, 2048, 768, 128), ("wu dW", 2048, 768, 160, 128),
        ("wd dX", 160, 768, 2048, 128), ("wd dW", 768, 2048, 160, 128)]


def _fake_timer():
    """A time_ms stand-in: runs the call once, returns a fresh time a
    call (later calls slower), so the first candidate timed is fastest."""
    seen = []

    def time_ms(fn, calls=10, reps=5):
        fn()
        seen.append(fn)
        return 0.01 * len(seen)
    return time_ms, seen


def _offset(cfg, a, b, out, **kw):
    return out + 1.0e3


def _zeroed(cfg, a, b, out, **kw):
    return torch.zeros_like(out)


def _dropped_slice(cfg, a, b, out, **kw):
    """The product without the last of ``cfg``'s split-K slices (a
    stream-K strip: half of K), as a lost partial sum gives (the layout
    "nn")."""
    keep = a.shape[-1] - a.shape[-1] // max(cfg.split_k, 2)
    return kmm.tiled_matmul(a[:, :keep].contiguous(),
                            b[:keep].contiguous(), cfg, **kw)


def _sweep(shape, faults=()):
    """sweep_shape on the CPU: the launches are the plain versions
    (``faults``: (config, fault) pairs, each fault a function that makes
    that config's output wrong)."""
    faults = dict(faults)

    def planted(real):
        def launch(a, b, cfg, **kw):
            out = real(a, b, cfg, **kw)
            return faults[cfg](cfg, a, b, out, **kw) if cfg in faults \
                else out
        return launch
    dense = planted(kmm.tiled_matmul)
    grouped = planted(kmm.tiled_expert_matmul)
    time_ms, seen = _fake_timer()
    with mock.patch.object(kmm, "_launch_cuda", dense), \
            mock.patch.object(kmm, "_launch_expert_cuda", grouped), \
            mock.patch.object(kmm, "_sm_count", lambda index: 132), \
            mock.patch.object(gs.cs, "time_ms", time_ms):
        return gs.sweep_shape(torch, CPU, kmm, shape, 3, "card, 700 W"), seen


@pytest.mark.parametrize("shape", [
    gs.Shape("g", "nn", "nn", 4, 32, 64, "bfloat16"),
    gs.Shape("g", "nt", "nt", 8, 48, 64, "float32"),
    gs.Shape("g", "tn", "tn", 40, 32, 24, "bfloat16"),
    gs.Shape("g", "grouped dX", "nt", 16, 32, 24, "bfloat16", 3)])
def test_sweep_times_every_candidate_that_agrees(shape):
    row, seen = _sweep(shape)
    p = GemmProblem(shape.M, shape.N, shape.K, in_dtype=shape.dtype,
                    out_dtype=shape.dtype)
    ranked = [str(t) for t, _ in rank_candidates(p, GPU_H100_LIKE)]
    sel = select_gemm_config(shape.M, shape.N, shape.K,
                             in_dtype=shape.dtype, out_dtype=shape.dtype,
                             hw=GPU_H100_LIKE).config
    assert row["candidates"] == row["timed"] == len(ranked) == len(seen) - 1
    assert row["wrong"] == [] and row["refused"] == []
    assert row["selected"] == str(sel)
    assert row["selected_model_rank"] == ranked.index(str(sel)) + 1
    # the stub makes the model's first candidate the fastest
    assert (row["best"], row["best_model_rank"]) == (ranked[0], 1)
    assert row["best_ms"] == min(t[1] for t in row["top"]) == 0.01
    assert len(row["top"]) == min(3, len(ranked))
    assert row["library_ms"] == 0.01 * len(seen)
    assert row["selection_gap"] == row["selected_ms"] / row["best_ms"]
    assert row["kernel_gap"] == row["best_ms"] / row["library_ms"]
    elem = 2 if shape.dtype == "bfloat16" else 4
    n = max(shape.experts, 1)
    nbytes = n * elem * (shape.M * shape.K + shape.K * shape.N
                         + shape.M * shape.N)
    assert row["bound_ms"] >= nbytes / 3.35e12 * 1e3
    summary = gs.group_summary([row])
    assert summary["selection_gap"] == row["selection_gap"]
    assert summary["selected_at_best"] == int(row["selected"] == row["best"])


def test_sweep_lists_a_wrong_candidate_and_never_times_it():
    shape = gs.Shape("g", "nn", "nn", 4, 32, 64, "bfloat16")
    p = GemmProblem(4, 32, 64, in_dtype="bfloat16", out_dtype="bfloat16")
    bad = rank_candidates(p, GPU_H100_LIKE)[0][0]
    row, _ = _sweep(shape, [(bad, _offset)])
    assert [w[0] for w in row["wrong"]] == [str(bad)]
    assert row["wrong"][0][1] >= 1.0e3 * 0.9
    assert row["timed"] == row["candidates"] - 1
    assert str(bad) not in [t[0] for t in row["top"]]
    assert gs.group_summary([row])["wrong"] == 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sweep_lists_a_zeroed_output_and_a_dropped_split_k_slice(dtype):
    shape = gs.Shape("g", "nn", "nn", 16, 64, 256, dtype)
    p = GemmProblem(16, 64, 256, in_dtype=dtype, out_dtype=dtype)
    ranked = [t for t, _ in rank_candidates(p, GPU_H100_LIKE)]
    split = [t for t in ranked if t.split_k > 1]
    zero, drop = ranked[0], split[0]
    strip = next(t for t in ranked[1:] if t.schedule == "stream_k")
    row, _ = _sweep(shape, [(zero, _zeroed), (drop, _dropped_slice),
                            (strip, _dropped_slice)])
    assert sorted(w[0] for w in row["wrong"]) == \
        sorted(map(str, (zero, drop, strip)))
    assert all(w[2] > 0.1 for w in row["wrong"])      # relative L2
    assert row["timed"] == row["candidates"] - 3
    assert row["worst_rel_l2"] <= (1e-2 if dtype == "bfloat16" else 1e-5)


def test_sweep_operands_are_unit_normal():
    for s in (gs.Shape("g", "nt", "nt", 64, 256, 512, "bfloat16"),
              gs.Shape("g", "tn", "tn", 64, 128, 96, "float32", 4)):
        g = torch.Generator().manual_seed(0)
        a, b = gs._operands(torch, CPU, s, g)
        assert a.dtype == b.dtype == getattr(torch, s.dtype)
        lead = (s.experts,) if s.experts else ()
        assert a.shape == lead + ((s.K, s.M) if s.layout == "tn"
                                  else (s.M, s.K))
        for t in (a, b):
            assert abs(float(t.float().std()) - 1.0) < 0.05


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale", [1.0, 2e-3])
def test_gemm_check_fails_a_zeroed_output_and_a_dropped_slice(dtype, scale):
    """The relative L2 cap catches both faults at any operand scale (at
    0.1 x 0.02 the absolute tolerance alone passes an all-zero output)."""
    g = torch.Generator().manual_seed(3)
    M, N, K = 32, 64, 1024
    a = (torch.randn(M, K, generator=g) * scale).to(dtype)
    b = torch.randn(K, N, generator=g).to(dtype)
    want = kmm.matmul_plain(a, b, None, out_dtype=dtype)
    ok, err, rel = gemm_check(want, want, dtype, K)
    assert ok and err == rel == 0.0
    # summing in another order, as a tiled kernel does, still agrees
    halves = (a[:, :K // 2].float() @ b[:K // 2].float()
              + a[:, K // 2:].float() @ b[K // 2:].float()).to(dtype)
    assert gemm_check(halves, want, dtype, K)[0]
    dropped = (a[:, :K - K // 8].float() @ b[:K - K // 8].float()).to(dtype)
    for got in (torch.zeros_like(want), dropped):
        ok, _, rel = gemm_check(got, want, dtype, K)
        assert not ok and rel > 0.1
    nan = want.clone()
    nan[0, 0] = float("nan")
    assert not gemm_check(nan, want, dtype, K)[0]


def test_sweep_tool_refuses_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    run = subprocess.run([sys.executable, str(ROOT / "tools" / "gemm_sweep.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 2
    assert "needs a CUDA device" in run.stderr


def test_checked_device_checks_once_then_times():
    dev = CheckedDevice(TorchDevice(device="cpu", repeat=1))
    p = GemmProblem(M=8, N=32, K=64)
    cands = candidate_tiles(p, GPU_H100_LIKE)[:3]
    for t in cands + cands:
        assert dev.gemm_time(p, t) > 0
    assert dev.checked == len(cands) == len(dev.times)
    assert dev.errors == [] and dev.worst_err >= 0.0


def test_checked_device_stops_the_oracle_on_a_wrong_candidate():
    dev = CheckedDevice(TorchDevice(device="cpu", repeat=1))
    p = GemmProblem(M=8, N=32, K=64)
    cands = candidate_tiles(p, GPU_H100_LIKE)
    bad = cands[1]
    real = ops.matmul

    def wrong(a, b, *, config=None, **kw):
        out = real(a, b, config=config, **kw)
        return out * 2.0 if config == bad else out
    with mock.patch.object(ops, "matmul", wrong):
        with pytest.raises(CandidateMismatch) as e:
            oracle_best(p, GPU_H100_LIKE, dev, cands, prune=False)
    assert e.value.config == bad and e.value.problem == p
    assert not isinstance(e.value, RuntimeError)
    assert e.value.max_abs_err > 0


def test_checked_device_records_a_launch_failure():
    dev = CheckedDevice(TorchDevice(device="cpu", repeat=1))
    p = GemmProblem(M=8, N=32, K=64)
    t = candidate_tiles(p, GPU_H100_LIKE)[0]
    with mock.patch.object(ops, "matmul",
                           side_effect=RuntimeError("no launch")):
        with pytest.raises(RuntimeError, match="no launch"):
            dev.gemm_time(p, t)
    assert len(dev.errors) == 1 and "no launch" in dev.errors[0]
    assert dev.checked == 0 and not dev.times
