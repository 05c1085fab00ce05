"""The port's calibration pipeline against the JAX package's, on the CPU.

Each copied module is held to its twin on the same inputs: the event
simulator (``core/simulator.py``), the probes, the fit, the fault
injection, the exhaustive-autotune oracle, the residual corrector, the
drift monitor, the Perfetto exporter and the llama3 shape sweep.  The
copies share the reference's arithmetic line for line, so simulator,
probe, fit, oracle and drift parity is exact (``==``); the residual fit's
coefficients come from a numpy solve on each side and are held to 1e-12
relative.

The port's own device, :class:`repro_torch.calib.TorchDevice`, runs the
probe kernels' plain versions on the CPU; the probe checksums are checked
against numpy doing the same work.  The kernels themselves are held to
their plain versions on the card (``tests/test_torch_gpu.py``).
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import repro.calib as jc
import repro.core.selector as jsel
import repro.core.simulator as jsim
import repro.obs.drift as jdrift
import repro.obs.perfetto as jperf
import repro.obs.trace as jtrace
from repro.configs.llama3_shapes import llama3_gemms as jllama3_gemms
from repro.core import hardware as jhw
from repro.core import latency as jlat
from repro.core import topology as jtopo
import repro_torch.calib as tc
import repro_torch.core.selector as tsel
import repro_torch.core.simulator as tsim
import repro_torch.obs.drift as tdrift
import repro_torch.obs.perfetto as tperf
import repro_torch.obs.trace as ttrace
from repro_torch.calib import residual as tres
from repro_torch.configs.llama3_shapes import llama3_gemms
from repro_torch.core import hardware as thw
from repro_torch.core import latency as tlat
from repro_torch.core import topology as ttopo
from repro_torch.kernels import probes

PRESETS = ("tpu_v5e", "tpu_v5p", "tpu_v4", "gpu_mi300x_like", "gpu_h100_like")
PROBLEMS = [(128, 128, 128), (4, 3072, 3072), (100, 300, 77),
            (512, 1024, 3072), (333, 200, 264)]
CONFIGS = [(32, 32, 32, 1, 1, "data_parallel"),
           (128, 128, 64, 1, 4, "data_parallel"),
           (32, 256, 128, 1, 1, "stream_k"),
           (64, 128, 64, 4, 1, "data_parallel"),
           (256, 128, 128, 1, 2, "stream_k")]


def _pair(preset):
    return jhw.get_hardware(preset), thw.get_hardware(preset)


def _problem(lat, M, N, K, **kw):
    return lat.GemmProblem(M=M, N=N, K=K, **kw)


def _config(lat, bm, bn, bk, split_k, group_m, schedule):
    return lat.TileConfig(bm=bm, bn=bn, bk=bk, split_k=split_k,
                          group_m=group_m, schedule=schedule)


def _sim(r):
    return dataclasses.asdict(r)


def _sweeps(sweeps):
    """Probe sweeps as JSON text: a dropped cliff sample is NaN, which
    compares equal only as text."""
    return json.dumps({k: v.to_dict() for k, v in sweeps.items()},
                      sort_keys=True)


def _perturbed(base):
    """A planted ground truth with every measurable constant off preset
    (tests/test_calibration.py's)."""
    return base.with_calibration(
        levels=tuple(dataclasses.replace(l, bandwidth=l.bandwidth * 1.3,
                                         latency=l.latency * 0.7)
                     for l in base.levels),
        peak_flops={k: v * 0.85 for k, v in base.peak_flops.items()},
        kernel_launch=base.kernel_launch * 1.5,
        dma_fixed=base.dma_fixed * 2.0)


# ---------------------------------------------------------------------------
# core/simulator.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_simulate_gemm_matches_jax(preset):
    jh, th = _pair(preset)
    for M, N, K in PROBLEMS:
        for cfg in CONFIGS:
            jp, tp = _problem(jlat, M, N, K), _problem(tlat, M, N, K)
            jt, tt = _config(jlat, *cfg), _config(tlat, *cfg)
            jev, tev = [], []
            want = jsim.simulate_gemm(jp, jt, jh, events=jev)
            got = tsim.simulate_gemm(tp, tt, th, events=tev)
            assert _sim(got) == _sim(want), (preset, M, N, K, cfg)
            assert tev == jev


@pytest.mark.parametrize("preset", PRESETS)
def test_simulate_gemm_batch_matches_jax(preset):
    jh, th = _pair(preset)
    for M, N, K in PROBLEMS[:3]:
        jp, tp = _problem(jlat, M, N, K), _problem(tlat, M, N, K)
        jcands = jsel.candidate_tiles(jp, jh)[:60]
        tcands = tsel.candidate_tiles(tp, th)[:60]
        assert [str(t) for t in tcands] == [str(t) for t in jcands]
        got = [_sim(r) for r in tsim.simulate_gemm_batch(tp, tcands, th)]
        want = [_sim(r) for r in jsim.simulate_gemm_batch(jp, jcands, jh)]
        assert got == want


@pytest.mark.parametrize("preset", PRESETS)
def test_simulate_probes_match_jax(preset):
    jh, th = _pair(preset)
    for nbytes, window, chunks in [(1e6, 4096, 64), (3e9, 116736, 64),
                                   (233472.0, 116736, 50000),
                                   (5e7, 78643200, 1)]:
        assert tsim.simulate_stream(th, nbytes, window, chunks) == \
            jsim.simulate_stream(jh, nbytes, window, chunks)
    for dtype in (None, *sorted(th.peak_flops)):
        for n in (16, 1000, 123457):
            assert tsim.simulate_compute(th, dtype, n) == \
                jsim.simulate_compute(jh, dtype, n)
        for units, atoms in ((1, 16), (132, 285), (133, 285), (1056, 40)):
            assert tsim.simulate_wave(th, units, atoms, dtype) == \
                jsim.simulate_wave(jh, units, atoms, dtype)


# ---------------------------------------------------------------------------
# calib/probes.py, calib/fit.py, calib/device.py::VirtualDevice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_level_windows_and_probes_match_jax(preset):
    jh, th = _pair(preset)
    assert tc.level_windows(th) == jc.level_windows(jh)
    got = tc.run_probes(tc.VirtualDevice(th, noise=0.02, seed=3), th)
    want = jc.run_probes(jc.VirtualDevice(jh, noise=0.02, seed=3), jh)
    assert _sweeps(got) == _sweeps(want)


@pytest.mark.parametrize("preset", ["tpu_v5e", "gpu_mi300x_like",
                                    "gpu_h100_like"])
@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_fit_topology_matches_jax(preset, noise):
    jh, th = _pair(preset)
    got = tc.fit_topology(th, tc.VirtualDevice(_perturbed(th), noise=noise,
                                               seed=1))
    want = jc.fit_topology(jh, jc.VirtualDevice(_perturbed(jh), noise=noise,
                                                seed=1))
    assert got.fitted == want.fitted
    assert got.residuals == want.residuals
    assert got.static_share == want.static_share
    assert got.degraded == want.degraded == {}
    assert ttopo.topology_fingerprint(got.topology) == \
        jtopo.topology_fingerprint(want.topology)


def test_degraded_fit_under_total_probe_loss_matches_jax():
    jh, th = _pair("gpu_h100_like")
    jdev = jc.FaultyDevice(jc.VirtualDevice(jh), jc.FaultPlan(probe_nan=1.0))
    tdev = tc.FaultyDevice(tc.VirtualDevice(th), tc.FaultPlan(probe_nan=1.0))
    want = jc.fit_topology(jh, jdev, allow_degraded=True)
    got = tc.fit_topology(th, tdev, allow_degraded=True)
    assert got.degraded == want.degraded and got.degraded
    assert got.fitted == want.fitted == {}
    with pytest.raises(ValueError):
        tc.fit_topology(th, tc.FaultyDevice(tc.VirtualDevice(th),
                                            tc.FaultPlan(probe_nan=1.0)))


def test_calibrated_artifacts_cross_load(tmp_path):
    jh, th = _pair("gpu_h100_like")
    want = jc.fit_topology(jh, jc.VirtualDevice(_perturbed(jh)))
    got = tc.fit_topology(th, tc.VirtualDevice(_perturbed(th)))
    jpath, tpath = tmp_path / "j.topo.json", tmp_path / "t.topo.json"
    want.save(str(jpath))
    got.save(str(tpath))
    topo, prov = ttopo.load_calibrated_topology(jpath.read_text())
    assert ttopo.topology_fingerprint(topo) == prov["fingerprint"] == \
        jtopo.topology_fingerprint(want.topology)
    jtopo_, jprov = jtopo.load_calibrated_topology(tpath.read_text())
    assert jtopo.topology_fingerprint(jtopo_) == jprov["fingerprint"] == \
        ttopo.topology_fingerprint(got.topology)
    guarded, gprov = ttopo.load_calibrated_topology_guarded(str(jpath), th)
    assert not gprov.get("degraded")
    assert ttopo.topology_fingerprint(guarded) == prov["fingerprint"]


def test_calibrate_delegates_to_the_fit():
    th = thw.GPU_H100_LIKE
    dev = tc.VirtualDevice(_perturbed(th))
    got = thw.calibrate(th, device=dev, dtypes=["bfloat16"])
    want = tc.fit_topology(th, dev, dtypes=["bfloat16"]).topology
    assert ttopo.topology_fingerprint(got) == \
        ttopo.topology_fingerprint(want)
    assert got.peak_flops["float16"] == th.peak_flops["float16"]
    with pytest.raises(ValueError, match="either"):
        thw.calibrate(th, {"kernel_launch": lambda: 1e-6}, device=dev)
    with pytest.raises(ValueError, match="either"):
        thw.calibrate(th)


# ---------------------------------------------------------------------------
# calib/faults.py
# ---------------------------------------------------------------------------

def test_fault_plans_and_faulty_device_match_jax():
    kw = dict(seed=7, probe_timeout=0.0, probe_nan=0.1, probe_outlier=0.1,
              probe_signflip=0.1, launch_compile=0.2,
              launch_transient=0.3, decode_transient=0.25)
    jp, tp = jc.FaultPlan(**kw), tc.FaultPlan(**kw)
    for site in ("stream", "compute", "launch", "decode"):
        for kind in ("probe_nan", "launch_compile", "decode_transient"):
            for _ in range(20):
                assert tp.draw(site, kind) == jp.draw(site, kind)
    assert tp.log == jp.log and tp.log
    jh, th = _pair("gpu_h100_like")
    jp.reset()
    tp.reset()
    got = tc.run_probes(tc.FaultyDevice(tc.VirtualDevice(th), tp), th)
    want = jc.run_probes(jc.FaultyDevice(jc.VirtualDevice(jh), jp), jh)
    assert _sweeps(got) == _sweeps(want)
    assert tp.log == jp.log


def test_injectors_drive_the_port_hooks():
    """launch_injector plugs into ops.set_launch_fault_injector and
    decode_injector into the engine's decode hook, as in the reference."""
    from repro_torch.kernels import ops
    plan = tc.FaultPlan(seed=0, launch_transient=1.0)
    inj = tc.launch_injector(plan)
    prev = ops.set_launch_fault_injector(inj)
    try:
        a = torch.ones(8, 16)
        with pytest.raises(tc.InjectedTransientError):
            ops.matmul(a, torch.ones(16, 8),
                       config=tlat.TileConfig(32, 32, 32))
    finally:
        ops.set_launch_fault_injector(prev)
    assert plan.log and all(k == "launch_transient" for _, _, k in plan.log)
    hook = tc.decode_injector(tc.FaultPlan(seed=0, decode_transient=1.0))
    with pytest.raises(tc.InjectedTransientError):
        hook(0, None)


# ---------------------------------------------------------------------------
# calib/oracle.py, configs/llama3_shapes.py
# ---------------------------------------------------------------------------

def test_llama3_shapes_match_jax():
    for size in ("8b", "70b"):
        assert llama3_gemms(size, (1, 1024)) == jllama3_gemms(size, (1, 1024))
    assert tc.scaled_llama3_shapes(("8b",), (1024,), 8) == \
        jc.scaled_llama3_shapes(("8b",), (1024,), 8)


def test_fidelity_report_matches_jax(tmp_path):
    kw = dict(presets=("tpu_v5e", "gpu_h100_like"), scale=8, verbose=False)
    got = tc.fidelity_report(out_dir=str(tmp_path / "t"), **kw)
    want = jc.fidelity_report(out_dir=str(tmp_path / "j"), **kw)
    assert got["rows"] == want["rows"] and len(got["rows"]) == 10
    assert got["presets"] == want["presets"]


def test_pruned_oracle_matches_jax():
    jh, th = _pair("gpu_h100_like")
    for M, N, K in ((4, 3072, 3072), (512, 1024, 3072)):
        got = tc.fidelity_row(th, "g", M, N, K, tc.VirtualDevice(th),
                              prune=True)
        want = jc.fidelity_row(jh, "g", M, N, K, jc.VirtualDevice(jh),
                               prune=True)
        assert got.as_list() == want.as_list()
        tp = _problem(tlat, M, N, K)
        cands = tsel.candidate_tiles(tp, th)
        _, _, pruned = tc.oracle_best(tp, th, tc.VirtualDevice(th), cands)
        jp = _problem(jlat, M, N, K)
        _, _, jpruned = jc.oracle_best(jp, jh, jc.VirtualDevice(jh),
                                       jsel.candidate_tiles(jp, jh))
        assert pruned == jpruned


# ---------------------------------------------------------------------------
# calib/residual.py
# ---------------------------------------------------------------------------

SWEEP_SHAPES = [(4, 3072, 3072), (512, 3072, 3072), (512, 1024, 3072),
                (256, 2048, 512)]


def _residual_pair():
    jh, th = _pair("gpu_h100_like")
    jrows = jc.rows_from_sweep(jh, jc.VirtualDevice(_perturbed(jh)),
                               SWEEP_SHAPES, k=6)
    trows = tc.rows_from_sweep(th, tc.VirtualDevice(_perturbed(th)),
                               SWEEP_SHAPES, k=6)
    return jh, th, jrows, trows


def test_residual_fit_matches_jax(tmp_path):
    jh, th, jrows, trows = _residual_pair()
    assert [dataclasses.asdict(r) for r in trows] == \
        [dataclasses.asdict(r) for r in jrows]
    assert len(trows) >= tres.MIN_FIT_ROWS
    got, want = tc.fit_residual(trows, th), jc.fit_residual(jrows, jh)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-12)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-12)
    np.testing.assert_allclose(got.scale, want.scale, rtol=1e-12)
    assert got.intercept == pytest.approx(want.intercept, rel=1e-12)
    assert got.fingerprint == want.fingerprint
    for M, N, K in SWEEP_SHAPES:
        tpick, tn = tc.residual_pick(got, _problem(tlat, M, N, K), th)
        jpick, jn = jc.residual_pick(want, _problem(jlat, M, N, K), jh)
        assert str(tpick) == str(jpick) and tn == jn

    # Artifacts cross-load, each way, with the same model digest.
    jpath, tpath = tmp_path / "j.residual.json", tmp_path / "t.residual.json"
    want.save(str(jpath))
    got.save(str(tpath))
    t_from_j, info = tc.load_residual_guarded(str(jpath), expect=th)
    assert t_from_j is not None, info
    assert t_from_j.content_fingerprint() == want.content_fingerprint()
    j_from_t, info = jc.load_residual_guarded(str(tpath), expect=jh)
    assert j_from_t is not None, info
    assert j_from_t.content_fingerprint() == got.content_fingerprint()


def test_rows_from_drift_matches_jax(tmp_path):
    jh, th, jrows, trows = _residual_pair()
    path = tmp_path / "drift.jsonl"
    with tdrift.DriftMonitor(path=str(path)) as mon:
        for r in trows:
            mon.record(site="warm_gemm", shape=(r.M, r.N, r.K, r.batch),
                       config=r.config,
                       topo=ttopo.topology_fingerprint(th),
                       predicted_s=r.predicted_s, measured_s=r.measured_s)
    fp = ttopo.topology_fingerprint(th)
    got, gstats = tc.rows_from_drift(str(path), fingerprint=fp)
    want, wstats = jc.rows_from_drift(str(path), fingerprint=fp)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want] == \
        [dataclasses.asdict(r) for r in trows]
    assert gstats == wstats


# ---------------------------------------------------------------------------
# obs/drift.py, obs/perfetto.py
# ---------------------------------------------------------------------------

def test_drift_monitor_rows_match_jax(tmp_path):
    jh, th = _pair("gpu_h100_like")
    paths = {}
    for name, drift, sel, hw in (("j", jdrift, jsel, jh),
                                 ("t", tdrift, tsel, th)):
        paths[name] = tmp_path / f"{name}.jsonl"
        with drift.DriftMonitor(path=str(paths[name]), window=4) as mon:
            for M, N, K in SWEEP_SHAPES:
                s = sel.select_gemm_config(M, N, K, hw=hw)
                mon.record_selection(s, s.predicted.total * 1.25,
                                     site="warm_gemm")
            for step in range(5):
                mon.record(site="decode_step", shape=(4,),
                           predicted_s=1e-3, measured_s=1e-3 * (1 + step),
                           topo="abc", step=step, dispatch_s=2e-3)
            assert mon.fidelity() > 0
    lines = {k: [json.loads(l) for l in p.read_text().splitlines()]
             for k, p in paths.items()}
    assert lines["t"] == lines["j"] and len(lines["t"]) == 9


def test_perfetto_export_matches_jax(tmp_path):
    jh, th = _pair("gpu_h100_like")
    docs = {}
    for name, sim, lat, hw, trace, perf in (
            ("j", jsim, jlat, jh, jtrace, jperf),
            ("t", tsim, tlat, th, ttrace, tperf)):
        ev = []
        sim.simulate_gemm(_problem(lat, 4, 3072, 3072),
                          _config(lat, 32, 256, 128, 1, 1, "stream_k"), hw,
                          events=ev)
        spans = [trace.Span(1, "prefill", "engine", "engine", 0.5, 0.75,
                            {"rid": 0}),
                 trace.Span(2, "status", "serve", "serve", 0.6, 0.6, None)]
        docs[name] = perf.export_chrome_trace(
            str(tmp_path / f"{name}.json"), spans, [("gemm 4x3072x3072",
                                                     ev)])
    assert docs["t"] == docs["j"]
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


# ---------------------------------------------------------------------------
# The port's device: TorchDevice and the probe kernels' plain versions.
# ---------------------------------------------------------------------------

def test_torch_device_primitives_execute_on_the_cpu():
    """The four primitives run the plain versions at tiny sizes (host
    clocks, meaningless as device numbers; the code path is the
    contract)."""
    dev = tc.TorchDevice(device="cpu", repeat=1)
    assert dev.name == "torch:cpu:host"
    for t in (dev.stream_time(16384.0, 8192, 4),
              dev.compute_time("bfloat16", 32, 4),
              dev.compute_time("int8", 32, 1),
              dev.compute_time("float32", 8, 2),
              dev.wave_time(4, 8, "bfloat16"),
              dev.gemm_time(tlat.GemmProblem(M=64, N=32, K=48),
                            tlat.TileConfig(bm=32, bn=32, bk=32))):
        assert t > 0.0 and math.isfinite(t)
    assert tc.get_device("virtual", thw.GPU_H100_LIKE).name == \
        "virtual:gpu_h100_like"
    # FaultyDevice decorates it like any device.
    faulty = tc.FaultyDevice(dev, tc.FaultPlan(seed=0, probe_signflip=1.0))
    assert faulty.stream_time(16384.0, 8192, 4) < 0
    assert faulty.name == "faulty:torch:cpu:host"


def test_torch_device_refuses_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.TorchDevice()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.get_device("torch", thw.GPU_H100_LIKE)


def _np_stream(nbytes, window, n_chunks):
    """numpy doing the stream probe's work: fetch i reads `chunk` 16-byte
    vectors from (i chunk) % elems on, wrapping at the window's end."""
    elems = max(window // 16, 1)
    chunk = max(int(nbytes / 16) // n_chunks, 1)
    x = (np.arange(elems * 4) % 13).reshape(elems, 4)
    total = 0
    for i in range(n_chunks):
        idx = (i * chunk + np.arange(chunk)) % elems
        total += int(x[idx].sum())
    return total


@pytest.mark.parametrize("nbytes,window,n_chunks", [
    (4096.0, 1024, 4), (65536.0, 1024, 3), (2048.0, 4096, 1),
    (233472.0, 116736, 40), (1e5, 4000, 7)])
def test_stream_probe_checksum_matches_numpy(nbytes, window, n_chunks):
    x = probes.stream_data(window, "cpu")
    got = probes.stream_read(x, nbytes, window, n_chunks)
    assert got.dtype == torch.int64
    assert int(got) == _np_stream(nbytes, window, n_chunks)


def _np_chains(a, b, k, counts):
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    sums = [float((a[:, s * k:(s + 1) * k] @ b[:, s * k:(s + 1) * k].T).sum())
            for s in range(4)]
    return [int(sum((n // 4 + (s < n % 4)) * sums[s] for s in range(4)))
            for n in counts]


@pytest.mark.parametrize("dtype", list(probes.PROBE_DTYPES))
def test_mma_and_wave_probe_checksums_match_numpy(dtype):
    a, b = probes.mma_operands(dtype, "cpu",
                               torch.Generator().manual_seed(5))
    k = probes.PROBE_DTYPES[dtype][2]
    assert tuple(a.shape) == (64, 4 * k)
    assert a.element_size() * a.shape[1] == probes.ROW_BYTES
    na, nb = a.float().numpy(), b.float().numpy()
    n_atoms, n_parallel = 23, 2
    instr = probes.instructions(dtype, n_atoms)
    assert instr == math.ceil(n_atoms * 16 / k)
    chains = n_parallel * probes.CHAINS_PER_CTA
    counts = [instr // chains + (c < instr % chains) for c in range(chains)]
    got = probes.mma_chain(a, b, n_atoms, n_parallel)
    assert got.tolist() == _np_chains(na, nb, k, counts)
    got = probes.wave_grid(a, b, 3, 5)
    assert got.tolist() == _np_chains(na, nb, k,
                                      [probes.instructions(dtype, 5)] * 3)


def test_stream_groups_split_fetches_over_the_grid():
    """Bandwidth sweeps' fetches span the whole grid; the issue sweep's
    one-vector fetches go one to a CTA; the latency probe's single fetch
    takes as many CTAs as it has 1024-vector rows."""
    assert probes.stream_groups(1_464_843, 132) == (132, 1)
    assert probes.stream_groups(1, 132) == (1, 132)
    assert probes.stream_groups(104_687, 132) == (103, 1)
    assert probes.stream_groups(3000, 132) == (3, 44)


def test_probe_wrappers_check_their_operands():
    a, b = probes.mma_operands("bfloat16", "cpu",
                               torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="share one dtype"):
        probes.mma_chain(a, b.float(), 8, 1)
    with pytest.raises(ValueError, match="must be"):
        probes.wave_grid(a[:, :32], b[:, :32], 2, 4)
    with pytest.raises(ValueError, match="f32"):
        probes.stream_read(torch.zeros(8), 4096.0, 4096, 2)
