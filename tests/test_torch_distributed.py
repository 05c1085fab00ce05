"""Tensor- and expert-parallel serving in the port (``distributed/``,
``meshctx``, ``launch/mesh.py``, the TP layers, ``serve --tp``) against the
JAX package.

The reference's own sharded path cannot serve as the yardstick (its
8-fake-device suite fails under this jax, ROADMAP's last caveat), and
sharding does not change the math.  So the port's TP model is held to the
reference's UNSHARDED ``Model`` and ``ServingEngine``, and the pure
functions to the reference's (``rules_for`` / ``spec_for`` /
``param_shardings`` on a duck-typed mesh, ``choose_gemm_layout`` and the
ring times with the same topology on both sides).

The ranks are real: ``spawn_ranks`` starts 2 and 4 gloo processes on the
CPU that meet through a file store in a temporary directory, each bounded
by its own deadline (a rank that fails or hangs takes them all down).  The
ranks run ``tests/torch_tp_worker.py`` (no JAX); this file computes the
JAX side.  Everything compares in f32: params converted from the JAX
``Model.init`` by ``params_from_jax``, an f32 decode cache on both sides,
logits within the attention f32 tolerance of ``tests/test_kernels.py``
(rtol 1e-4, atol 2e-5), greedy tokens equal.  tp 4 drops the kv-head split
of the smoke configs (2 kv heads: each rank computes the one its q head
reads), and qwen3-moe with 6 experts drops the expert split there (each
rank holds a d_ff quarter of every expert).  At these widths the MoE's
decode takes the gather path (``nn/moe.py::decode_path``), so each MoE
case also runs its first layer's decode on both sparse paths by name,
the grouped one included, and with 3 experts (a d_ff share of every
expert at tp 2 and 4) the grouped path's partial wd product too.
Cases also run qwen3-moe
with ``moe_dense_decode``, phi4-mini with ``kv_repeat_weights``, and the
audio and vlm models with their frontend inputs (musicgen's 4 heads are
whole kv heads at tp 4 too).
"""
import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import hardware as jhw
from repro.distributed import collectives as jcoll
from repro.distributed import sharding as jsh
from repro.launch.engine import ServingEngine as JEngine
from repro.nn import moe as jmoe
from repro.nn.model import Model as JModel
from repro_torch import meshctx
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.bucketing import step_gemms
from repro_torch.core import hardware as thw
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.launch import serve as serve_driver
from repro_torch.launch import train as train_driver
from repro_torch.launch.engine import serving_gemms
from repro_torch.launch.mesh import check_tp, spawn_ranks
from repro_torch.nn import layers as L
from repro_torch.nn.frontends import frontend_input_specs
from repro_torch.nn.model import Model, params_from_jax

import torch_tp_worker

ATTN32 = dict(rtol=1e-4, atol=2e-5)
MESHES = [(1, 2), (1, 4), (2, 4), (1, 16), (16, 16)]
# Each spawned group of ranks must be done within this (seconds).
RANKS_TIMEOUT = 240.0
# (case name, arch, config changes) served at tp 2 and tp 4.
TP_CASES = [("phi4", "phi4-mini-3.8b", {}),
            ("qwen3", "qwen3-moe-30b-a3b", {}),
            ("mixtral", "mixtral-8x22b", {}),
            ("qwen3_e6", "qwen3-moe-30b-a3b", {"num_experts": 6}),
            ("qwen3_dense", "qwen3-moe-30b-a3b", {"moe_dense_decode": True}),
            ("phi4_kvrep", "phi4-mini-3.8b", {"kv_repeat_weights": True}),
            ("musicgen", "musicgen-large", {}),
            ("llava", "llava-next-mistral-7b", {})]
ENGINE_CASES = ("phi4", "qwen3", "mixtral")
# (case name, arch, config changes): the first layer's MoE decode on each
# sparse path at tp 2 and tp 4.
MOE_CASES = [("qwen3", "qwen3-moe-30b-a3b", {}),
             ("mixtral", "mixtral-8x22b", {}),
             ("qwen3_e6", "qwen3-moe-30b-a3b", {"num_experts": 6}),
             ("qwen3_e3", "qwen3-moe-30b-a3b", {"num_experts": 3})]


def _mesh(data, model):
    return types.SimpleNamespace(shape={"data": data, "model": model})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# The pure functions against the reference's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_reference(arch, smoke):
    got = Model(get_config(arch, smoke=smoke), device="cpu").param_axes()
    want = JModel(jget_config(arch, smoke=smoke)).param_axes()
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(arch, smoke, mesh):
    """Every leaf's spec, both sides on the same duck-typed mesh (the
    reference's ``param_shardings`` loop without its ``NamedSharding``)."""
    m = _mesh(*mesh)
    jm = JModel(jget_config(arch, smoke=smoke))
    rules = jsh.rules_for(jm.cfg)
    abst, axes = _flat(jm.abstract_params()), _flat(jm.param_axes())
    want = {k: tuple(jsh.spec_for(a.shape, axes[k], rules, m))
            for k, a in abst.items()}
    got = _flat(sh.param_shardings(Model(get_config(arch, smoke=smoke),
                                         device="cpu"), m))
    assert got == want
    assert sh.rules_for(get_config(arch, smoke=smoke)) == rules


@pytest.mark.parametrize("tp", [2, 4, 16])
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tp_shardings_keep_whole_heads(arch, smoke, tp):
    """``tp_shardings`` is ``param_shardings`` except that a heads or kv
    heads split is kept only where it gives every rank whole heads, and an
    SSM d_inner or SSM heads split only where it gives every rank whole
    SSM heads."""
    model = Model(get_config(arch, smoke=smoke), device="cpu")
    cfg, mesh = model.cfg, _mesh(1, tp)
    specs = _flat(sh.param_shardings(model, mesh))
    aligned = _flat(sh.tp_shardings(model, mesh))
    axes, abst = _flat(model.param_axes()), _flat(model.abstract_params())
    heads = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
             "ssm_inner": cfg.ssm_heads, "ssm_heads": cfg.ssm_heads}
    for k, spec in specs.items():
        for part, got, name, n in zip(spec, aligned[k], axes[k] or (),
                                      abst[k].shape):
            if name in heads and part is not None:
                assert got == (part if heads[name] % tp == 0 else None), k
            else:
                assert got == part, k
            if got is not None:
                assert n % tp == 0


@pytest.mark.parametrize("hw", ["TPU_V5E", "GPU_H100_LIKE"])
def test_layout_choice_and_ring_times_match_reference(hw):
    jtopo, ttopo = getattr(jhw, hw), getattr(thw, hw)
    for n in (1, 2, 4, 8, 16):
        for nbytes in (4096.0, 3.2e6, 1.7e9):
            assert coll.ring_all_reduce_s(nbytes, n, ttopo) == \
                jcoll.ring_all_reduce_s(nbytes, n, jtopo)
            assert coll.ring_all_gather_s(nbytes, n, ttopo) == \
                jcoll.ring_all_gather_s(nbytes, n, jtopo)
    for (M, N, K) in [(4, 3072, 3072), (512, 8192, 3072), (474, 3072, 8192),
                      (6, 100, 10), (2048, 768, 2048), (7, 9, 11)]:
        for n in (2, 4, 16):
            for dt in ("bfloat16", "float32"):
                got = coll.choose_gemm_layout(M, N, K, n, dt, hw=ttopo)
                want = jcoll.choose_gemm_layout(M, N, K, n, dt, hw=jtopo)
                assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert coll.choose_gemm_layout.__defaults__[-1] is thw.GPU_H100_LIKE


# ---------------------------------------------------------------------------
# Local shards.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draw", [None, 96], ids=["default", "small_draws"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen3-moe-30b-a3b",
                                  "mixtral-8x22b", "zamba2-7b"])
def test_init_sharded_equals_slices_of_init_tree(arch, tp, draw,
                                                 monkeypatch):
    """Each rank's ``init_shards`` equals its ``shard_params`` slice of the
    single-process ``init`` from the same seed, bit for bit; with 96-element
    draws every leaf is drawn in many axis-0 slices, a vocabulary- or
    expert-sharded axis 0 cutting across them."""
    if draw is not None:
        monkeypatch.setattr(L, "_DRAW_ELEMS", draw)
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu")
    mesh = _mesh(1, tp)
    full = model.init(torch.Generator().manual_seed(0))
    specs = sh.tp_shardings(model, mesh)
    for rank in range(tp):
        got = _flat(model.init_shards(torch.Generator().manual_seed(0),
                                      mesh, rank))
        want = _flat(sh.shard_params(full, specs, mesh, rank))
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_local_index_tiles_each_leaf():
    """The ranks' blocks of every leaf cover it evenly: a split leaf once,
    a replicated one on every rank."""
    model = Model(get_config("qwen3-moe-30b-a3b", smoke=True), device="cpu")
    mesh = _mesh(1, 4)
    specs = _flat(sh.tp_shardings(model, mesh))
    for k, a in _flat(model.abstract_params()).items():
        seen = torch.zeros(a.shape, dtype=torch.int32)
        for rank in range(4):
            seen[sh.local_index(a.shape, specs[k], mesh, rank)] += 1
        copies = 1 if any(p is not None for p in specs[k]) else 4
        assert bool((seen == copies).all()), k


def test_data_axis_and_ssm_raise_a5b():
    """A mesh whose data axis exceeds 1 shards (FSDP's "embed" dims over
    "data", the rest over "model"); ``--tp 2`` serves and trains the SSM
    and hybrid families on the CPU (their SSM heads split over "model"),
    and ``check_tp`` refuses a ``--tp`` that does not divide the SSM
    heads, naming the division."""
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True),
                              fsdp=True)
    model = Model(cfg, device="cpu")
    mesh = _mesh(2, 2)
    specs = sh.tp_shardings(model, mesh)
    assert specs["layers"]["attn"]["wq"] == (None, "data", "model")
    full = model.init(torch.Generator().manual_seed(0))
    wq = full["layers"]["attn"]["wq"]
    L_, D, F = wq.shape
    for rank in range(4):
        d, m = divmod(rank, 2)
        got = sh.shard_params(full, specs, mesh, rank)["layers"]["attn"]["wq"]
        assert torch.equal(got, wq[:, d * D // 2:(d + 1) * D // 2,
                                   m * F // 2:(m + 1) * F // 2])
        assert torch.equal(
            model.init_shards(torch.Generator().manual_seed(0), mesh,
                              rank)["layers"]["attn"]["wq"], got)
    for arch in ("mamba2-370m", "zamba2-7b"):
        scfg = get_config(arch, smoke=True)
        specs = sh.tp_shardings(Model(scfg, device="cpu"), _mesh(1, 2))
        assert specs["layers"]["mamba"]["in_x"] == (None, None, "model")
        assert specs["layers"]["mamba"]["in_b"] == (None, None, None)
        args = serve_driver.build_parser().parse_args(
            ["--arch", arch, "--smoke", "--device", "cpu", "--tp", "2",
             "--requests", "2", "--gen", "3", "--quiet"])
        res = serve_driver.run_serving(args)["results"]
        assert len(res) == 2 and all(r.finished for r in res.values())
        for r in res.values():
            assert len(r.tokens) == 3
            assert ((r.tokens >= 0) & (r.tokens < scfg.vocab_size)).all()
        targs = train_driver.build_parser().parse_args(
            ["--arch", arch, "--smoke", "--device", "cpu", "--tp", "2",
             "--steps", "2"])
        recs = train_driver.run_training(targs)["records"]
        assert len(recs) == 2 and all(math.isfinite(r["loss"])
                                      for r in recs)
        with pytest.raises(ValueError, match=r"does not divide its 4 SSM "
                                             r"heads \(4 % 3 = 1\)"):
            check_tp(scfg, 3)


class _AxisMesh(types.SimpleNamespace):
    """A duck-typed mesh that also answers ``model_axis`` (no group)."""

    def group(self, axis):
        return None

    def coord(self, axis):
        return self.at


@pytest.fixture
def duck_mesh():
    def install(model, at=0):
        meshctx.set_mesh(_AxisMesh(shape={"data": 1, "model": model},
                                   at=at))
    yield install
    meshctx.set_mesh(None)


def test_serving_gemms_price_local_shapes(duck_mesh):
    """warm_start and the bucket plan price the GEMMs a rank launches: with
    no mesh ``step_gemms``, under tp 2 each at its local extent."""
    cfg = get_config("phi4-mini-3.8b")
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kv = cfg.num_kv_heads * cfg.head_dim
    assert serving_gemms(cfg) == step_gemms(D, F, kv_dim=kv, vocab=V)
    duck_mesh(2)
    assert serving_gemms(cfg) == [(D // 2 + kv, D), (D, D // 2),
                                  (F, D), (D, F // 2), (V // 2, D)]


def test_mixtral_whole_at_tp4_fits_a_card_a_rank(duck_mesh):
    """mixtral-8x22b whole (56 layers) over 4 ranks, reckoned from meta
    tensors and ``tp_shardings``: every rank holds the same bf16 bytes,
    about 70.3 GB (2 experts, 12 q and 2 kv heads, a quarter of the
    vocabulary), and with the decode cache of ``chip_smoke.py``'s ragged
    traffic (batch 4, prompts up to 512 tokens plus 16 generated, the
    rank's kv heads) stays under 79 GB of the card's 80."""
    cfg = get_config("mixtral-8x22b")
    model = Model(cfg, device="cpu")
    mesh = _mesh(1, 4)
    specs = _flat(sh.tp_shardings(model, mesh))
    per_rank = []
    for rank in range(4):
        n = 0
        for k, a in _flat(model.abstract_params()).items():
            idx = sh.local_index(a.shape, specs[k], mesh, rank)
            n += math.prod(s.stop - s.start for s in idx) * a.element_size()
        per_rank.append(n)
    assert len(set(per_rank)) == 1
    assert abs(per_rank[0] / 70.3e9 - 1) < 0.005
    duck_mesh(4, at=3)
    kv_heads = L.local_kv_heads(cfg)
    assert kv_heads == 2
    cache = 2 * cfg.num_layers * 4 * kv_heads * (512 + 16) \
        * cfg.head_dim * 2
    assert per_rank[0] + cache < 79e9


# ---------------------------------------------------------------------------
# kv_repeat_weights (one process): the reference's weight repeat.
# ---------------------------------------------------------------------------

def _jax_pair(arch, changes):
    return _jax_pair_cached(arch, tuple(sorted(changes.items())))


@functools.lru_cache(maxsize=None)
def _jax_pair_cached(arch, changes):
    """(JAX config, its f32 params, the port's config, the port's f32
    params converted from them), once a case for the whole module."""
    changes = dict(changes)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **changes)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                JModel(jcfg).init(jax.random.PRNGKey(0)))
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           dtype=torch.float32, device="cpu")
    return jcfg, jp, cfg, tree


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen3-moe-30b-a3b",
                                  "mixtral-8x22b"])
def test_kv_repeat_weights_matches_jax(arch):
    """With ``kv_repeat_weights`` the K/V projections run on weights
    repeated to H heads (``repro/nn/layers.py:155-164, 180-184``): prefill
    logits and the full pass equal the JAX package's in f32, and equal the
    unrepeated run's (the same function)."""
    jcfg, jp, cfg, tree = _jax_pair(arch, {"kv_repeat_weights": True})
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    m = Model(cfg, device="cpu")
    jm = JModel(jcfg)
    with torch.inference_mode():
        got, _ = m.prefill(tree, torch.from_numpy(toks).long())
        full = m.forward(tree, torch.from_numpy(toks).long())
        plain, _ = Model(dataclasses.replace(cfg, kv_repeat_weights=False),
                         device="cpu").prefill(tree,
                                               torch.from_numpy(toks).long())
    want, _ = jm.prefill(jp, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN32)
    np.testing.assert_allclose(full.numpy(),
                               np.asarray(jm.forward(jp, jnp.asarray(toks))),
                               **ATTN32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **ATTN32)


# ---------------------------------------------------------------------------
# The TP model and engine on real ranks.
# ---------------------------------------------------------------------------

class _JF32Cache(JModel):
    def init_cache(self, batch, max_len):
        return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                      super().init_cache(batch, max_len))


def _numpy_tree(tree):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.numpy())
            for k, v in tree.items()}


def _inputs(cfg, seed):
    """A ragged (2, S) prefill (row 0 ends 3 tokens early) with the
    frontend's inputs (N(0, 1) x 0.02, f32) and 2 decode steps after it; S
    covers mixtral's 32-key window twice."""
    rng = np.random.default_rng(seed)
    S = 72 if cfg.sliding_window else 12
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   size=(2, S)).astype(np.int32),
            "last": np.array([S - 4, S - 1], np.int64),
            "extras": {name: (rng.standard_normal(shape) * 0.02).astype(
                           np.float32)
                       for name, (shape, _) in frontend_input_specs(
                           cfg, 2, S).items()},
            "steps": [rng.integers(0, cfg.vocab_size, size=2).astype(
                np.int32) for _ in range(2)]}


def _jax_model_side(jcfg, jp, inputs):
    jm = _JF32Cache(jcfg)
    toks = jnp.asarray(inputs["tokens"])
    last = jnp.asarray(inputs["last"].astype(np.int32))
    extras = {k: jnp.asarray(v) for k, v in inputs["extras"].items()}
    out = {"forward": np.asarray(jm.forward(jp, toks, extras or None))}
    logits, pc = jm.prefill(jp, toks, extras or None, last_pos=last)
    out["prefill"] = np.asarray(logits)
    B, S = inputs["tokens"].shape
    cache = jax.tree_util.tree_map(
        lambda d, s: jax.lax.dynamic_update_slice(
            d, s.astype(d.dtype), (0,) * d.ndim),
        jm.init_cache(B, S + len(inputs["steps"])), pc)
    pos, steps = last + 1, []
    for new in inputs["steps"]:
        lg, cache = jm.decode_step(jp, cache, jnp.asarray(new), pos)
        steps.append(np.asarray(lg))
        pos = pos + 1
    out["decode"] = np.stack(steps)
    return out


def _requests(cfg):
    rng = np.random.default_rng(11)
    lens = [45, 70, 58] if cfg.sliding_window else [5, 11, 8]
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


ENGINE_GEN = 5


@pytest.fixture(scope="module")
def reference():
    """The JAX side of every case, and the inputs both sides share."""
    out = {}
    for name, arch, changes in TP_CASES:
        jcfg, jp, cfg, tree = _jax_pair(arch, changes)
        inputs = _inputs(cfg, seed=len(out))
        case = {"cfg": cfg, "tree": _numpy_tree(tree), "inputs": inputs,
                "want": _jax_model_side(jcfg, jp, inputs)}
        if name in ENGINE_CASES:
            reqs = _requests(cfg)
            max_len = max(len(r) for r in reqs) + ENGINE_GEN
            eng = JEngine(_JF32Cache(jcfg), jp, max_batch=2,
                          max_len=max_len, temperature=0.0, seed=0,
                          sync_every=4)
            for r in reqs:
                eng.submit(r, max_new_tokens=ENGINE_GEN)
            res = eng.run()["results"]
            case.update(requests=reqs, max_len=max_len,
                        tokens=[res[i].tokens for i in range(len(reqs))])
        out[name] = case
    for name, arch, changes in MOE_CASES:
        jcfg, jp, cfg, tree = _jax_pair(arch, changes)
        x = np.random.default_rng(len(out)).standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)
        layer = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
        out[name + "_moe"] = {
            "cfg": cfg, "tree": _numpy_tree(tree), "x": x,
            "want": np.asarray(jmoe.moe_decode(layer, jnp.asarray(x), jcfg))}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def ranks(request, reference):
    """Every rank's outputs of every case at tp 2 or 4 (one spawn)."""
    tp = request.param
    rng = np.random.default_rng(tp)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    res = rng.standard_normal((6, 32)).astype(np.float32)
    cases = [("matmul", "mm", x, w, res)]
    for name, case in reference.items():
        if "x" in case:
            cases.append(("moe", name, case["cfg"], case["tree"], case["x"]))
            continue
        cases.append(("model", name, case["cfg"], case["tree"],
                      case["inputs"]))
        if name in ENGINE_CASES:
            cases.append(("engine", name + "_engine", case["cfg"],
                          case["tree"], case["requests"], ENGINE_GEN,
                          case["max_len"]))
    outs = spawn_ranks(torch_tp_worker.run_cases, tp, (cases,),
                       timeout=RANKS_TIMEOUT)
    return {"tp": tp, "outs": outs, "mm": (x, w, res)}


def test_ranks_hold_their_mesh_coordinates(ranks):
    tp = ranks["tp"]
    assert [o["coord"] for o in ranks["outs"]] == list(range(tp))
    assert all(o["shape"] == {"data": 1, "model": tp}
               for o in ranks["outs"])


def test_tp_matmul_both_forms(ranks):
    x, w, res = ranks["mm"]
    outs = ranks["outs"]
    want = x.astype(np.float64) @ w.astype(np.float64)
    tol = dict(rtol=1e-5, atol=1e-4 * math.sqrt(x.shape[1]))
    np.testing.assert_allclose(
        np.concatenate([o["mm/col"] for o in outs], axis=1), want, **tol)
    for o in outs:
        assert o["mm/row"].dtype == np.float32
        np.testing.assert_allclose(o["mm/row"], want + res, **tol)


@pytest.mark.parametrize("name", [c[0] for c in TP_CASES])
def test_tp_logits_match_jax(ranks, reference, name):
    """Full pass, ragged prefill and two per-slot decode steps: every
    rank's logits equal the unsharded JAX model's, and rank 0's."""
    want = reference[name]["want"]
    outs = ranks["outs"]
    for what in ("forward", "prefill", "decode"):
        for o in outs:
            got = o[f"{name}/{what}"]
            assert got.shape == want[what].shape
            np.testing.assert_allclose(got, want[what], **ATTN32)
            np.testing.assert_allclose(got, outs[0][f"{name}/{what}"],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", [c[0] for c in TP_CASES])
def test_tp_cache_holds_local_kv_heads(ranks, reference, name):
    """Each rank caches its own kv heads: Hkv / tp where they split into
    whole heads, else the kv heads its q heads read."""
    cfg, tp = reference[name]["cfg"], ranks["tp"]
    for rank, o in enumerate(ranks["outs"]):
        n = int(o[f"{name}/local_kv_heads"])
        if cfg.num_kv_heads % tp == 0:
            assert n == cfg.num_kv_heads // tp
        else:
            h = cfg.num_heads // tp
            assert n == len(L.kv_heads_read(cfg, rank * h, h))
        assert o[f"{name}/cache_k"].shape[2] == n


@pytest.mark.parametrize("name", [c[0] for c in MOE_CASES])
def test_tp_moe_decode_paths_match_jax(ranks, reference, name):
    """Under the model axis both sparse decode paths, grouped and gather,
    give every rank the unsharded JAX MoE decode, in f32."""
    want = reference[name + "_moe"]["want"]
    for o in ranks["outs"]:
        for path in ("grouped", "gather"):
            got = o[f"{name}_moe/{path}"]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, **ATTN32)


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_tp_engine_tokens_match_jax(ranks, reference, name):
    """The lockstep engine's greedy tokens, on every rank, equal the JAX
    engine's at exact lengths."""
    want = reference[name]["tokens"]
    for o in ranks["outs"]:
        for i, w in enumerate(want):
            got = o[f"{name}_engine/tokens_{i}"]
            assert np.array_equal(got, w), (i, got, w)


def test_serve_tp_driver_end_to_end():
    """``serve --tp 2 --smoke --device cpu``: two spawned ranks serve the
    ragged queue on a priced plan; rank 0's stats come back."""
    args = serve_driver.build_parser().parse_args(
        ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
         "--tp", "2", "--ragged", "--requests", "4", "--gen", "4",
         "--temperature", "0", "--quiet"])
    out = serve_driver.run_serving(args)
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    res = out["results"]
    assert len(res) == 4 and all(r.finished for r in res.values())
    assert out["edges"] and out["steps"] > 0
    for r in res.values():
        assert len(r.tokens) == 4
        assert ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()
