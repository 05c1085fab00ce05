"""The rest of the zoo in the serving engine and the drivers, against the
JAX package: greedy tokens of each new smoke config (musicgen-large and
llava-next-mistral-7b with their frontend inputs, mixtral-8x22b with its
window binding in prefill and decode), bucketed and isolated in the port,
against the JAX engine at exact lengths; the engine's handling of a
request's frontend inputs; ``chip_smoke.py``'s launch reckoning for these
families; a driver run of ``launch/serve.py`` and ``launch/train.py`` for
llava and musicgen.

Token equality runs in f32 (params and caches f32 on both sides), as
``tests/test_torch_engine.py`` does.  The JAX engine serves each request
at its exact length: under a plan it would add a request's (len, D) frame
embeddings to a (bucket edge, D) embedding block.
"""
import importlib.util
import json
import math
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.launch.engine import ServingEngine as JEngine
from repro.nn.model import Model as JModel
from repro_torch.configs.registry import get_config
from repro_torch.core.bucketing import plan_buckets, step_gemms
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import serve as serve_driver
from repro_torch.launch import train as train_driver
from repro_torch.launch.engine import ServingEngine, _extras_at
from repro_torch.nn import frontends
from repro_torch.nn import transformer as T
from repro_torch.nn.model import Model, params_from_jax

ZOO = ["minitron-8b", "stablelm-12b", "internlm2-20b", "musicgen-large",
       "llava-next-mistral-7b", "mixtral-8x22b"]
ROOT = pathlib.Path(__file__).resolve().parents[1]


class _JF32Cache(JModel):
    def init_cache(self, batch, max_len):
        return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                      super().init_cache(batch, max_len))


def _tree_float(tree):
    return {k: (_tree_float(v) if isinstance(v, dict) else v.float())
            for k, v in tree.items()}


class _F32Cache(Model):
    def init_cache(self, batch, max_len):
        return _tree_float(super().init_cache(batch, max_len))


@pytest.fixture(scope="module", params=ZOO)
def pair(request):
    jcfg = jget_config(request.param, smoke=True)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    jp32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp)
    cfg = get_config(request.param, smoke=True)
    return {"jm": _JF32Cache(jcfg), "jp": jp32, "cfg": cfg,
            "m": _F32Cache(cfg, device="cpu"),
            "tp": params_from_jax(jax.tree_util.tree_map(np.asarray, jp32),
                                  cfg, dtype=torch.float32, device="cpu")}


def _requests(cfg, lens, seed=0):
    """(prompt, numpy frontend inputs or None) per length, shared by both
    engines."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        extras = {name: (rng.standard_normal(shape) * 0.02).astype(
                      np.float32)
                  for name, (shape, _) in frontends.frontend_input_specs(
                      cfg, 1, n).items()}
        out.append((prompt, extras or None))
    return out


def _serve(engine_cls, model, params, requests, n, convert, **kw):
    eng = engine_cls(model, params, temperature=0.0, seed=0, **kw)
    for prompt, extras in requests:
        eng.submit(prompt, max_new_tokens=n,
                   extras=None if extras is None
                   else {k: convert(v) for k, v in extras.items()})
    return eng.run()


def _lens(cfg):
    """Ragged prompts; mixtral's longer than its 32-key window."""
    return [45, 70, 58, 66] if cfg.sliding_window else [5, 11, 13, 8]


def test_bucketed_tokens_match_jax_at_exact_lengths(pair):
    """The port's engine on a priced bucket plan (frame embeddings padded
    to the edge), and each request alone at its exact length, emit the JAX
    engine's greedy tokens at exact lengths."""
    cfg = pair["cfg"]
    lens = _lens(cfg)
    reqs = _requests(cfg, lens)
    plan = plan_buckets(lens, gemms=step_gemms(
        cfg.d_model, cfg.d_ff, kv_dim=cfg.num_kv_heads * cfg.head_dim,
        vocab=cfg.vocab_size, swiglu=cfg.activation == "swiglu"),
        hw=GPU_H100_LIKE, max_buckets=2)
    assert any(plan.bucket_for(n) != n for n in lens)
    max_len = max(plan.edges) + 6
    got = _serve(ServingEngine, pair["m"], pair["tp"], reqs, 6,
                 torch.from_numpy, plan=plan, max_batch=2, max_len=max_len,
                 sync_every=4)
    want = _serve(JEngine, pair["jm"], pair["jp"], reqs, 6, jnp.asarray,
                  max_batch=2, max_len=max_len, sync_every=4)
    assert not got["drained"]
    for i, req in enumerate(reqs):
        g, w = got["results"][i], want["results"][i]
        assert g.padded_len == plan.bucket_for(lens[i])
        assert np.array_equal(g.tokens, w.tokens), (i, g.tokens, w.tokens)
        solo = _serve(ServingEngine, pair["m"], pair["tp"], [req], 6,
                      torch.from_numpy, max_batch=1, max_len=max_len)
        assert np.array_equal(solo["results"][0].tokens, w.tokens)


def test_request_extras_reach_the_prefill(monkeypatch):
    """Admission hands a request's frontend inputs to its prefill: frame
    embeddings right-padded with zero rows to the bucket edge, patch
    embeddings as they are; a decode step takes none."""
    seen = []
    real = T.prefill_forward

    def spy(params, tokens, cfg, *, extras=None, last_pos=None):
        seen.append((tuple(tokens.shape), {k: v.clone() for k, v in
                                           (extras or {}).items()}))
        return real(params, tokens, cfg, extras=extras, last_pos=last_pos)
    monkeypatch.setattr(T, "prefill_forward", spy)
    for arch, name in (("musicgen-large", "frame_embed"),
                       ("llava-next-mistral-7b", "patch_embed")):
        cfg = get_config(arch, smoke=True)
        m = Model(cfg, device="cpu")
        params = m.init(torch.Generator().manual_seed(0))
        (prompt, extras), = _requests(cfg, [9])
        plan = plan_buckets([9, 12], gemms=step_gemms(
            cfg.d_model, cfg.d_ff, kv_dim=cfg.num_kv_heads * cfg.head_dim,
            vocab=cfg.vocab_size, swiglu=cfg.activation == "swiglu"),
            hw=GPU_H100_LIKE, max_buckets=1)
        assert plan.edges == (12,)
        seen.clear()
        _serve(ServingEngine, m, params, [(prompt, extras)], 3,
               torch.from_numpy, plan=plan, max_batch=1, max_len=16)
        (shape, got), = seen
        assert shape == (1, 12) and set(got) == {name}
        x = torch.from_numpy(extras[name])
        if name == "frame_embed":
            assert tuple(got[name].shape) == (1, 12, cfg.d_model)
            assert torch.equal(got[name][:, :9], x)
            assert not got[name][:, 9:].any()
        else:
            assert torch.equal(got[name], x)
    assert _extras_at(None, 12, torch.device("cpu")) is None


def test_submit_checks_the_frontend_rows():
    """A request's frame embeddings need one row a prompt token, its patch
    embeddings at most as many (the reference caveat: its driver hands a
    truncated prompt a longer frame block)."""
    for arch, name, rows in (("musicgen-large", "frame_embed", 8),
                             ("musicgen-large", "frame_embed", 10),
                             ("llava-next-mistral-7b", "patch_embed", 10)):
        cfg = get_config(arch, smoke=True)
        m = Model(cfg, device="cpu")
        eng = ServingEngine(m, m.init(torch.Generator().manual_seed(0)),
                            max_batch=1, max_len=32)
        with pytest.raises(ValueError, match=f"{name} has {rows} rows"):
            eng.submit(np.arange(9), 2,
                       extras={name: np.zeros((1, rows, cfg.d_model),
                                              np.float32)})


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ZOO)
def test_serve_reckoning_matches_the_wrapper_calls(arch):
    """``chip_smoke.py``'s reckoning of a prefill's and a decode step's
    kernel launches (``_zoo_launches``) equals the calls each kernel
    wrapper receives here on the CPU, where each call is the kernel's plain
    version and would be one launch on the card."""
    cfg = get_config(arch, smoke=True)
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    calls = {}

    def counting(module, name, key):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        return mock.patch.object(module, name, wrapped)
    (prompt, extras), = _requests(cfg, [40])
    tx = {k: torch.from_numpy(v) for k, v in (extras or {}).items()}
    with counting(kmm, "tiled_matmul", "matmul"), \
            counting(kmm, "tiled_expert_matmul", "expert_matmul"), \
            counting(kfa, "flash_attention_kernel", "flash_attention"):
        _, cache = m.prefill(params, torch.from_numpy(prompt)[None].long(),
                             extras=tx or None)
        prefill = dict(calls)
        calls.clear()
        full = m.init_cache(1, 48)
        for name in ("k", "v"):
            full[name][:, :, :, :40] = cache[name]
        m.decode_step(params, full, torch.tensor([3]), torch.tensor(40))
        decode = dict(calls)
    want_prefill, want_decode = _chip_smoke()._zoo_launches(cfg)
    assert prefill == {k: v for k, v in want_prefill.items() if v}
    assert decode == {k: v for k, v in want_decode.items() if v}


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-mistral-7b"])
def test_serve_driver_with_frontend_inputs(arch):
    """``python -m repro_torch.launch.serve --smoke --device cpu``: every
    request finishes; each carries frontend inputs at its own length (with
    a llava prompt is its whole image prefix and its text)."""
    cfg = get_config(arch, smoke=True)
    flags = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
             "--prompt-len", "24", "--gen", "4", "--ragged", "--requests",
             "4", "--temperature", "0", "--quiet"]
    args = serve_driver.build_parser().parse_args(flags)
    out = serve_driver.run_serving(args)
    assert len(out["results"]) == 4
    assert all(r.finished and len(r.tokens) == 4
               for r in out["results"].values())
    queue = serve_driver.request_queue(args, cfg, torch.device("cpu"))
    prefix = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    for (prompt, extras), r in zip(queue, sorted(out["results"])):
        assert out["results"][r].prompt_len == prompt.size
        assert 12 + prefix <= prompt.size <= 24 + prefix
        (name, x), = extras.items()
        rows = prompt.size if cfg.frontend == "audio" else prefix
        assert tuple(x.shape) == (1, rows, cfg.d_model)
        assert x.dtype == torch.bfloat16


def test_train_driver_with_frontend_inputs(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu`` for
    musicgen and llava: frame / patch embeddings join every batch, every
    step logs a finite loss, and the loss falls."""
    for arch in ("musicgen-large", "llava-next-mistral-7b"):
        log = str(tmp_path / f"{arch}.jsonl")
        seen = []
        real = T.lm_loss

        def spy(params, batch, cfg, **kw):
            seen.append(sorted(batch))
            return real(params, batch, cfg, **kw)
        with mock.patch.object(T, "lm_loss", spy):
            assert train_driver.main([
                "--arch", arch, "--smoke", "--device", "cpu", "--batch",
                "4", "--seq", "32", "--steps", "4", "--lr", "1e-2",
                "--warmup", "0", "--log", log]) == 0
        name = ("frame_embed" if arch == "musicgen-large"
                else "patch_embed")
        assert seen and all(s == sorted(["tokens", name]) for s in seen)
        recs = [json.loads(line) for line in open(log)]
        assert [r["step"] for r in recs] == [1, 2, 3, 4]
        assert all(math.isfinite(r["loss"]) for r in recs)
        assert recs[-1]["loss"] < recs[0]["loss"]
