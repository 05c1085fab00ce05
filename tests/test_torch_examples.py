"""The port's example scripts (``examples/*_torch.py``) against their JAX
references, and ``tools/obs_report.py`` on the port's telemetry.

* The four twins import nothing of ``repro`` or ``jax``.
* The three that compute on a device refuse a host without CUDA unless
  ``--device cpu`` is given.
* ``gemm_explorer_torch.py`` prints what ``gemm_explorer.py`` prints,
  character for character, at the same flags.
* ``quickstart_torch.py`` selects and ranks as the reference's selector does
  on gpu_h100_like, and its product (the plain version on this host) is
  within the bf16 GEMM tolerance of ``tests/test_kernels.py``'s (rtol 3e-2,
  atol 0.3·√K) of the reference's ``matmul_ref`` on the same numpy inputs.
* ``train_lm_torch.py`` at a tiny size reads the reference's batches bit
  for bit; from the same f32 params its first loss is within 1e-5
  relative of the JAX train step's (summation order only), its five
  losses within 1e-4 of the JAX steps' (``tests/test_torch_train.py``'s
  leaf tolerance), and its loss falls.  The run takes --lr 3e-2: five
  steps of the 20-step warmup at the default 3e-3 move the loss less than
  the batches differ.
* ``serve_lm_torch.py``'s settings serve every request in full; greedy
  and in f32 (an f32 decode cache on both sides, as
  ``tests/test_torch_engine.py`` runs it) its tokens equal the JAX
  ``ServingEngine``'s from the same params, in-process (the reference's
  driver raises under jax 0.9.0, ROADMAP's last caveat).
"""
import ast
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import GPU_H100_LIKE as JGPU_H100_LIKE
from repro.core import GemmProblem as JGemmProblem
from repro.core import rank_candidates as jrank_candidates
from repro.core import select_gemm_config as jselect_gemm_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels.ref import matmul_ref as jmatmul_ref
from repro.launch.engine import ServingEngine as JEngine
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_train_step as jmake_train_step
from repro.nn.model import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.nn.model import Model, params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("gemm_explorer", "quickstart", "serve_lm", "train_lm")
DEVICE_TWINS = ("quickstart", "serve_lm", "train_lm")


def _load(name):
    """An example script as a module (``examples/`` is no package)."""
    path = EXAMPLES / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env():
    src = str(ROOT / "src")
    return {**os.environ, "PYTHONPATH": src + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_twins_import_no_jax_and_no_repro():
    for name in TWINS:
        path = EXAMPLES / f"{name}_torch.py"
        mods = list(_imports(path))
        assert "repro_torch" in {m.split(".")[0] for m in mods}, path
        bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                       "repro")]
        assert not bad, (path.name, bad)


@pytest.mark.parametrize("name", DEVICE_TWINS)
def test_device_twins_refuse_a_host_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is usable")
    run = subprocess.run([sys.executable, str(EXAMPLES / f"{name}_torch.py")],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert run.returncode != 0
    assert "CUDA is not available" in run.stderr
    assert "OK" not in run.stdout and "loss" not in run.stdout


@pytest.mark.parametrize("hw", ["gpu_h100_like", "tpu_v5e"])
@pytest.mark.parametrize("mnk", [(4, 128, 1024), (512, 3072, 3072)])
def test_gemm_explorer_prints_the_reference_lines(mnk, hw, capsys):
    argv = ["gemm_explorer", "--m", str(mnk[0]), "--n", str(mnk[1]),
            "--k", str(mnk[2]), "--hw", hw, "--top", "5"]
    outs = []
    for name in ("gemm_explorer", "gemm_explorer_torch"):
        with mock.patch.object(sys, "argv", argv):
            _load(name).main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert f"on {hw}" in outs[1] and "portability" in outs[1]


def test_gemm_explorer_defaults_to_the_port_topology(capsys):
    with mock.patch.object(sys, "argv", ["gemm_explorer", "--m", "4",
                                         "--n", "128", "--k", "1024"]):
        _load("gemm_explorer_torch").main()
    assert "bfloat16 on gpu_h100_like" in capsys.readouterr().out


def test_quickstart_selects_and_ranks_as_the_reference():
    q = _load("quickstart_torch")
    sel, top = q.select()
    want = jselect_gemm_config(q.M, q.N, q.K, in_dtype="bfloat16",
                               hw=JGPU_H100_LIKE)
    assert str(sel) == str(want)
    assert str(sel.config) == str(want.config)
    assert sel.n_candidates == want.n_candidates
    jtop = jrank_candidates(JGemmProblem(M=q.M, N=q.N, K=q.K),
                            JGPU_H100_LIKE)[:5]
    assert [(str(c), p.total, p.bottleneck) for c, p in top] == \
        [(str(c), p.total, p.bottleneck) for c, p in jtop]


def test_quickstart_product_matches_the_reference_oracle():
    q = _load("quickstart_torch")
    sel, _ = q.select()
    a, b = q.operands("cpu")
    got = q.product(a, b, sel.config).numpy()
    rng = np.random.default_rng(0)
    ja, jb = (jnp.asarray(rng.standard_normal(s), dtype=jnp.bfloat16)
              for s in ((q.M, q.K), (q.K, q.N)))
    want = np.asarray(jmatmul_ref(ja, jb, out_dtype=jnp.float32))
    np.testing.assert_allclose(got, want, rtol=3e-2,
                               atol=0.3 * np.sqrt(q.K))
    assert q.main(["--device", "cpu"]) < 0.3 * np.sqrt(q.K)


def test_train_lm_matches_the_reference_step():
    t = _load("train_lm_torch")
    args = t.build_parser().parse_args(
        ["--d-model", "64", "--layers", "2", "--seq", "32", "--steps", "5",
         "--lr", "3e-2", "--device", "cpu"])
    cfg = t.example_config(args)
    jcfg = dataclasses.replace(
        jget_config("phi4-mini-3.8b", smoke=True), name="example-lm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=2048, remat=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)

    jdata = JSyntheticLM(JDataConfig(vocab_size=2048, seq_len=32,
                                     global_batch=8)).iterate(0)
    stream = t.data_stream(cfg, args)
    try:
        for _ in range(args.steps):
            got, want = next(stream)["tokens"], next(jdata)["tokens"]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    finally:
        stream.close()

    jm = JModel(jcfg)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                jm.init(jax.random.PRNGKey(0)))
    opt = JAdamW(lr=jwarmup_cosine(args.lr, 20, args.steps))
    jstate = JTrainState(params=jp, opt=opt.init(jp),
                         step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jmake_train_step(jm, opt))
    jdata = JSyntheticLM(JDataConfig(vocab_size=2048, seq_len=32,
                                     global_batch=8))
    jlosses = []
    for i in range(args.steps):
        jstate, met = jstep(jstate,
                            {"tokens": jnp.asarray(jdata.batch_at(i)["tokens"])})
        jlosses.append(float(met["loss"]))

    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                             dtype=torch.float32, device="cpu")
    losses = t.train(args, params=params)
    assert len(losses) == args.steps
    assert abs(losses[0] - jlosses[0]) <= 1e-5 * abs(jlosses[0])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]


def _tree_float(tree):
    return {k: (_tree_float(v) if isinstance(v, dict) else v.float())
            for k, v in tree.items()}


class _F32Cache(Model):
    def init_cache(self, batch, max_len):
        return _tree_float(super().init_cache(batch, max_len))


class _JF32Cache(JModel):
    def init_cache(self, batch, max_len):
        return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                      super().init_cache(batch, max_len))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-370m"])
def test_serve_lm_serves_greedy_tokens_of_the_reference(arch):
    s = _load("serve_lm_torch")
    ex = s.build_parser().parse_args(["--arch", arch, "--gen", "6",
                                      "--device", "cpu"])
    args = serve.build_parser().parse_args(
        s.serve_argv(ex) + ["--temperature", "0", "--quiet"])
    assert (args.smoke, args.batch, args.prompt_len) == (True, 4, 24)
    jcfg = jget_config(arch, smoke=True)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                JModel(jcfg).init(jax.random.PRNGKey(0)))
    cfg = get_config(arch, smoke=True)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                         dtype=torch.float32, device="cpu")
    with mock.patch.object(serve, "Model", _F32Cache):
        out = serve.run_serving(args, params=tp)
    results = out["results"]
    assert len(results) == args.batch
    assert all(r.finished and len(r.tokens) == args.gen
               for r in results.values())

    prompts = [p for p, _ in serve.request_queue(args, cfg,
                                                 torch.device("cpu"))]
    eng = JEngine(_JF32Cache(jcfg), jp, max_batch=args.batch,
                  max_len=args.prompt_len + args.gen, temperature=0.0,
                  seed=args.seed)
    for p in prompts:
        eng.submit(p, max_new_tokens=args.gen)
    want = eng.run()["results"]
    for rid in range(len(prompts)):
        np.testing.assert_array_equal(results[rid].tokens, want[rid].tokens,
                                      err_msg=f"request {rid}")


def test_obs_report_renders_the_port_telemetry(tmp_path):
    out_dir = tmp_path / "obs"
    serve.run_serving(serve.build_parser().parse_args(
        ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
         "--batch", "2", "--prompt-len", "12", "--gen", "6", "--ragged",
         "--requests", "3", "--sync-every", "2", "--quiet",
         "--temperature", "0", "--trace-dir", str(out_dir)]))
    run = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "obs_report.py"),
                          str(out_dir)], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert run.returncode == 0, run.stderr
    report = run.stdout
    events = json.loads((out_dir / "trace.json").read_text())["traceEvents"]
    assert f"## Trace — {len(events)} events" in report
    assert "| measured (tracer) | engine | engine |" in report
    assert "| modeled (simulator) |" in report
    prom = [ln for ln in (out_dir / "metrics.prom").read_text().splitlines()
            if ln.strip() and not ln.startswith("#")]
    assert f"## Metrics — {len(prom)} samples (metrics.prom)" in report
    assert "| engine_tokens_emitted | 18 |" in report
    drift = (out_dir / "drift.jsonl").read_text().splitlines()
    assert f"## Drift — {len(drift)} records" in report
    for site in ("warm_gemm", "decode_step"):
        assert f"| {site} |" in report
