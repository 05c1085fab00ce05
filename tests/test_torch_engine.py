"""The port's ServingEngine and serve driver against the JAX package's, and
the port's package rules.

Token equality runs in f32 (params cast to f32, and an f32 decode cache on
both sides): in bf16 the two frameworks round activations in different
orders, which can flip an argmax between near-tied logits, while in f32 the
logits agree to ~1e-6 and greedy tokens must be identical.  Every engine
case runs for each ported family: phi4-mini (pair) and qwen3-moe-30b-a3b
(MoE), at smoke size.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core.bucketing import plan_buckets as jplan_buckets
from repro.core.hardware import GPU_H100_LIKE as JGPU_H100_LIKE
from repro.launch.engine import ServingEngine as JEngine
from repro.nn.model import Model as JModel
from repro_torch.configs.registry import get_config
from repro_torch.core.bucketing import plan_buckets, step_gemms
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.launch.engine import ServingEngine
from repro_torch.launch.serve import build_parser, run_serving
from repro_torch.nn.model import Model, params_from_jax

ARCH = "phi4-mini-3.8b"
ARCHS = [ARCH, "qwen3-moe-30b-a3b"]
ROOT = pathlib.Path(__file__).resolve().parents[1]


class _JF32Cache(JModel):
    def init_cache(self, batch, max_len):
        return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                      super().init_cache(batch, max_len))


class _F32Cache(Model):
    def init_cache(self, batch, max_len):
        return {k: v.float() for k, v in super().init_cache(batch,
                                                            max_len).items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jget_config(request.param, smoke=True)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    jp32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp)
    tree = jax.tree_util.tree_map(np.asarray, jp32)
    cfg = get_config(request.param, smoke=True)
    return {"jm": _JF32Cache(jcfg), "jp": jp32, "cfg": cfg,
            "m": _F32Cache(cfg, device="cpu"),
            "tp": params_from_jax(tree, cfg, dtype=torch.float32,
                                  device="cpu")}


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _gemms(cfg):
    return step_gemms(cfg.d_model, cfg.d_ff,
                      kv_dim=cfg.num_kv_heads * cfg.head_dim,
                      vocab=cfg.vocab_size,
                      swiglu=cfg.activation == "swiglu")


def _serve(engine_cls, model, params, prompts, n, **kw):
    eng = engine_cls(model, params, temperature=0.0, seed=0, **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=n)
    return eng.run()


def test_ragged_bucketed_tokens_match_jax_and_isolated(pair):
    """The test_engine.py case: ragged prompts padded to priced bucket
    edges in a slot-reusing batch.  The port's tokens equal the JAX
    engine's, and each request's equal its solo run's."""
    cfg = pair["cfg"]
    lens = [5, 9, 13, 7]
    prompts = _prompts(cfg, lens)
    plan = plan_buckets(lens, gemms=_gemms(cfg), hw=GPU_H100_LIKE,
                        max_buckets=2)
    jplan = jplan_buckets(lens, gemms=_gemms(cfg), hw=JGPU_H100_LIKE,
                          max_buckets=2)
    assert plan.edges == jplan.edges
    kw = dict(max_batch=2, max_len=64, sync_every=4)
    got = _serve(ServingEngine, pair["m"], pair["tp"], prompts, 4,
                 plan=plan, **kw)
    want = _serve(JEngine, pair["jm"], pair["jp"], prompts, 4,
                  plan=jplan, **kw)
    assert got["steps"] == want["steps"] and not got["drained"]
    assert got["bucket_hits"] == want["bucket_hits"]
    assert got["pad_fraction"] == pytest.approx(want["pad_fraction"])
    for i, p in enumerate(prompts):
        g, w = got["results"][i], want["results"][i]
        assert np.array_equal(g.tokens, w.tokens), (i, g.tokens, w.tokens)
        assert g.finished and g.padded_len == plan.bucket_for(lens[i])
        solo = _serve(ServingEngine, pair["m"], pair["tp"], [p], 4,
                      max_batch=1, max_len=64)["results"][0].tokens
        assert np.array_equal(solo, g.tokens)


def _faulted(engine_cls, model, params, prompts, temperature=0.0):
    fired = []

    def hook(step, guard):
        if step == 1 and not fired:
            fired.append(step)
            raise RuntimeError("transient: injected decode fault")
        if step == 3:
            guard.request_stop()

    eng = engine_cls(model, params, max_batch=2, max_len=64,
                     temperature=temperature, seed=5, decode_fault=hook)
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    return eng.run(), fired


def test_fault_retry_and_drain_prefix_matches_jax(pair):
    """One injected transient (retried against the intact cache) plus a
    preemption drain: the faulted run's tokens are a prefix of the clean
    run's, and both equal the JAX engine's under the same hook."""
    prompts = _prompts(pair["cfg"], [8, 8])
    clean = _serve(ServingEngine, pair["m"], pair["tp"], prompts, 6,
                   max_batch=2, max_len=64)
    assert clean["steps"] == 5 and not clean["drained"]
    faulted, fired = _faulted(ServingEngine, pair["m"], pair["tp"],
                              prompts)
    jfaulted, _ = _faulted(JEngine, pair["jm"], pair["jp"], prompts)
    assert faulted["retries"] == 1 and fired == [1]
    assert faulted["drained"] and faulted["steps"] == 4
    for rid in (0, 1):
        f = faulted["results"][rid].tokens
        assert np.array_equal(f, clean["results"][rid].tokens[:len(f)])
        assert np.array_equal(f, jfaulted["results"][rid].tokens)
        assert not faulted["results"][rid].finished


def test_temperature_sampling_seeded_and_prefix_under_faults(pair):
    """temperature > 0: per-step seeds from a pre-split table make runs
    reproducible, and a retry or drain never shifts the stream."""
    prompts = _prompts(pair["cfg"], [6, 6], seed=3)

    def clean():
        eng = ServingEngine(pair["m"], pair["tp"], max_batch=2,
                            max_len=64, temperature=0.9, seed=5)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        return eng.run()

    a, b = clean(), clean()
    faulted, _ = _faulted(ServingEngine, pair["m"], pair["tp"], prompts,
                          temperature=0.9)
    greedy = _serve(ServingEngine, pair["m"], pair["tp"], prompts, 6,
                    max_batch=2, max_len=64)
    differs = False
    for rid in (0, 1):
        ta = a["results"][rid].tokens
        assert np.array_equal(ta, b["results"][rid].tokens)
        f = faulted["results"][rid].tokens
        assert np.array_equal(f, ta[:len(f)])
        differs |= not np.array_equal(ta, greedy["results"][rid].tokens)
    assert differs


def test_submit_validation(pair):
    eng = ServingEngine(pair["m"], pair["tp"], max_batch=1, max_len=16)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros(0, np.int32), max_new_tokens=4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.zeros(4, np.int32), max_new_tokens=0)
    with pytest.raises(ValueError, match="cache rows"):
        eng.submit(np.zeros(10, np.int32), max_new_tokens=8)


STATS_KEYS = {"tokens", "steps", "drained", "retries", "stragglers",
              "t_prefill_s", "t_decode_s", "tokens_per_s", "tokens_emitted",
              "pad_fraction", "bucket_hits", "edges", "dispatch_s_mean",
              "device_step_s_mean", "device", "results", "topology",
              "degraded"}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ragged", [False, True])
def test_run_serving_smoke_on_cpu(ragged, arch):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--gen", "3", "--quiet",
            "--temperature", "0"]
    if ragged:
        argv += ["--ragged", "--requests", "3"]
    out = run_serving(build_parser().parse_args(argv))
    assert STATS_KEYS <= set(out)
    assert out["device"] == "cpu" and out["topology"] == "gpu_h100_like"
    assert len(out["results"]) == (3 if ragged else 2)
    assert all(r.finished and len(r.tokens) == 3
               for r in out["results"].values())
    assert out["tokens_emitted"] == 3 * len(out["results"])
    if ragged:
        assert out["edges"] and isinstance(out["tokens"], list)
    else:
        assert out["tokens"].shape == (2, 3)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is usable")
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_serving(build_parser().parse_args(["--arch", ARCH, "--smoke"]))
    assert build_parser().parse_args(["--arch", ARCH]).device == "cuda"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.append(ROOT / "tests" / "test_torch_gpu.py")   # runs on the card
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
