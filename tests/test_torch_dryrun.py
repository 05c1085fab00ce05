"""The port's dry-run, memory and roofline tooling (``launch/dryrun.py``,
``launch/memory.py``, ``core/roofline.py``, ``Model``'s stand-ins,
``distributed/sharding.py::cache_shardings``, the dry mesh's collectives)
against the JAX package.

The pure functions must equal the reference's exactly, for every (arch,
shape) cell of ``all_cells`` on the reference's (16, 16) and (2, 16, 16)
meshes, with the reference's budgets passed to both sides (16 GiB, and 14
GiB for the micro-batches): ``param_count``, ``model_flops``, the cache
and input stand-ins' shapes and dtypes, ``estimate_cell_memory``,
``estimate_step_hbm_bytes``, ``select_microbatches`` and ``roofline``.
``cache_shardings``, ``_fit_and_eval`` and ``_probe_depths`` are held to
the reference's in a subprocess with 8 fake devices
(``tests/dryrun_reference_worker.py``): ``repro.launch.dryrun`` rewrites
XLA_FLAGS at import, and this process keeps one device.  The dry step
itself runs on "meta" tensors: its probe-extrapolated FLOPs must equal a
direct count within 1e-9 relative.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.registry import all_cells as jall_cells
from repro.configs.registry import get_config as jget_config
from repro.core import hardware as jhw
from repro.core.roofline import roofline as jroofline
from repro.launch import memory as jmem
from repro.nn.config import SHAPES as JSHAPES
from repro.nn.model import Model as JModel
from repro_torch.configs.registry import ARCH_IDS, all_cells, get_config
from repro_torch.core import hardware as thw
from repro_torch.core.roofline import roofline
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import dryrun, memory
from repro_torch.launch.mesh import DryMesh
from repro_torch.nn.config import SHAPES
from repro_torch.nn.model import Model

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
CELLS = [(a, s) for a, s, ok, _ in all_cells() if ok]
WORKER = os.path.join(os.path.dirname(__file__), "dryrun_reference_worker.py")
# The fake-device meshes cache_shardings is compared on, and the batch /
# length pairs of its cells (every cell's, and a batch of 3, which no
# batch axis divides).
SPEC_MESHES = [(("data", "model"), (2, 4)), (("data", "model"), (4, 2)),
               (("pod", "data", "model"), (2, 2, 2))]
SPEC_LENGTHS = sorted({(s.global_batch, s.seq_len) for s in SHAPES.values()}
                      | {(3, 64)})
PROBE_SAMPLES = {(x, s): 1e9 + 3e5 * s + x * (7e7 + 11.0 * s + 0.25 * s * s)
                 for x in (2, 4) for s in (512, 1024, 2048)}


def _fits():
    """(samples, X, S) sets for ``_fit_and_eval``: a polynomial of the
    fit's form, then every cell's analytic HBM bytes at its probe points
    on (16, 16), to be evaluated at the cell's full depth and length."""
    out = [(PROBE_SAMPLES, 7, 3000)]
    for arch, shape in CELLS:
        cfg, spec = get_config(arch), SHAPES[shape]
        depths, full_x = dryrun._probe_depths(cfg)
        out.append(({(x, s): memory.estimate_step_hbm_bytes(
            c, dataclasses.replace(spec, seq_len=s), MESHES[0])["total"]
            for x, c in depths for s in dryrun._PROBE_S[spec.kind]},
            full_x, spec.seq_len))
    return out


def _tag(mesh):
    return "x".join(str(n) for n in mesh.values())


def test_cells_and_shapes_are_the_references():
    assert CELLS == [(a, s) for a, s, ok, _ in jall_cells() if ok]
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}


def _dtype(d):
    return np.dtype(str(d).replace("torch.", "")) if d != torch.bfloat16 \
        else "bfloat16"


def _jdtype(d):
    return "bfloat16" if str(d) == "bfloat16" else np.dtype(d)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}"
                                                   for a, s in CELLS])
def test_model_stand_ins_match_jax(arch, shape):
    """``param_count``, ``model_flops``, ``input_specs`` and
    ``cache_specs`` (on meta) equal the reference ``Model``'s."""
    import jax
    cfg, jm = get_config(arch), JModel(jget_config(arch))
    m = Model(cfg, device="meta")
    spec = SHAPES[shape]
    assert m.param_count() == jm.param_count()
    assert m.model_flops(spec) == jm.model_flops(JSHAPES[shape])
    got = m.input_specs(spec)
    want = jm.input_specs(JSHAPES[shape])
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert _dtype(got[k].dtype) == _jdtype(w.dtype), k
    got = dict(_leaves(m.cache_specs(spec.global_batch, spec.seq_len)))
    want = {"/".join(str(k.key) for k in p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                jm.cache_specs(spec.global_batch, spec.seq_len))[0]}
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert _dtype(got[k].dtype) == _jdtype(w.dtype), k


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_memory_estimates_match_jax(mesh):
    """Every cell's ``estimate_cell_memory`` (each category, the total,
    the chips; ``fits_hbm`` at 16 GiB against the reference's
    ``fits_16gib_hbm``), ``estimate_step_hbm_bytes`` and
    ``select_microbatches`` at 14 GiB equal the reference's exactly; with
    no budget passed the port budgets ``GPU_H100_LIKE``'s 80 GiB, and the
    micro-batches 14/16 of it."""
    for arch, shape in CELLS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        spec, jspec = SHAPES[shape], JSHAPES[shape]
        got = memory.estimate_cell_memory(cfg, spec, mesh,
                                          hbm_budget_gib=16.0)
        want = jmem.estimate_cell_memory(jcfg, jspec, mesh)
        assert got.pop("fits_hbm") == want.pop("fits_16gib_hbm")
        assert got.pop("hbm_gib") == 16.0
        assert got == want, (arch, shape)
        assert memory.estimate_step_hbm_bytes(cfg, spec, mesh) == \
            jmem.estimate_step_hbm_bytes(jcfg, jspec, mesh), (arch, shape)
        assert memory.select_microbatches(cfg, spec, mesh, 14.0) == \
            jmem.select_microbatches(jcfg, jspec, mesh, 14.0), (arch, shape)
        h100 = memory.estimate_cell_memory(cfg, spec, mesh)
        assert h100["hbm_gib"] == 80.0
        assert h100["fits_hbm"] == (h100["total_gib"] <= 80.0)
        assert memory.select_microbatches(cfg, spec, mesh) == \
            jmem.select_microbatches(jcfg, jspec, mesh, 70.0), (arch, shape)


def test_mixtral_params_at_tp4_are_the_served_reckoning():
    """The analytic params a device of mixtral-8x22b at (1, 4) are the
    70.3 GB a rank that ``serve --tp 4`` reckons from its shards
    (``tests/test_torch_distributed.py``)."""
    est = memory.estimate_cell_memory(get_config("mixtral-8x22b"),
                                      SHAPES["decode_32k"],
                                      {"data": 1, "model": 4})
    assert abs(est["params"] * 2**30 / 70.3e9 - 1) < 0.005


@pytest.mark.parametrize("hw", ["gpu_h100_like", "tpu_v5e"])
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_roofline_matches_jax(hw, mesh):
    """``roofline`` of every cell (its analytic HBM bytes and model FLOPs,
    a FLOP count and collectives of every kind) on the same topology
    equals the reference's report; the port's default topology is
    ``GPU_H100_LIKE``."""
    chips = math.prod(mesh.values())
    for arch, shape in CELLS:
        cfg, spec = get_config(arch), SHAPES[shape]
        mf = Model(cfg, device="meta").model_flops(spec)
        kw = dict(arch=arch, shape_name=shape, mesh=_tag(mesh), chips=chips,
                  hlo_flops=1.3 * mf / chips,
                  hlo_bytes=memory.estimate_step_hbm_bytes(
                      cfg, spec, mesh)["total"],
                  collectives={"all-reduce": 1.0e9, "all-gather": 2.0e8,
                               "reduce-scatter": 3.0e8, "total": 1.5e9},
                  model_flops=mf)
        got = roofline(**kw, hw=thw.get_hardware(hw)).as_dict()
        assert got == jroofline(**kw, hw=jhw.get_hardware(hw)).as_dict()
        if hw == "gpu_h100_like":
            assert roofline(**kw).as_dict() == got


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The subprocess's side: cache_shardings specs, _fit_and_eval,
    _probe_depths."""
    req = {"cells": [[a, b, s] for a in ARCH_IDS for b, s in SPEC_LENGTHS],
           "meshes": [[list(n), list(s)] for n, s in SPEC_MESHES],
           "fits": [[[[x, s, v] for (x, s), v in samples.items()], X, S]
                    for samples, X, S in _fits()]}
    path = tmp_path_factory.mktemp("dryrun") / "req.json"
    path.write_text(json.dumps(req))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, WORKER, str(path)], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _norm(spec):
    """A spec as lists, a one-name tuple as the name (P treats both
    alike)."""
    def part(p):
        if isinstance(p, (tuple, list)):
            return p[0] if len(p) == 1 else list(p)
        return p
    return [part(p) for p in spec]


def test_cache_shardings_match_jax(reference):
    """Every arch's decode cache at every cell's (batch, length) and at a
    batch of 3: the port's spec tree equals the reference's
    ``cache_shardings`` on a fake-device mesh, leaf for leaf."""
    n = 0
    for names, sizes in SPEC_MESHES:
        mesh = DryMesh(dict(zip(names, sizes)))
        tag = "x".join(str(s) for s in sizes)
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for b, s in SPEC_LENGTHS:
                got = dict(_leaves(sh.cache_shardings(
                    Model(cfg, device="meta").cache_specs(b, s), mesh, cfg)))
                want = reference["specs"][f"{arch}/{b}/{s}/{tag}"]
                assert {k: _norm(v) for k, v in got.items()} == \
                    {k: _norm(v) for k, v in want.items()}, (arch, b, s, tag)
                n += 1
    assert n == len(SPEC_MESHES) * len(ARCH_IDS) * len(SPEC_LENGTHS)


def test_fit_and_probe_depths_match_jax(reference):
    """``_fit_and_eval`` on the same samples (a polynomial of its form,
    which it reproduces; every cell's HBM bytes at its probe points) and
    ``_probe_depths`` of every arch equal the reference's."""
    fits = _fits()
    assert len(fits) == len(reference["fits"])
    for (samples, X, S), want in zip(fits, reference["fits"]):
        assert dryrun._fit_and_eval(samples, X, S) == want
    poly = 1e9 + 3e5 * 3000 + 7 * (7e7 + 11.0 * 3000 + 0.25 * 3000 ** 2)
    assert abs(reference["fits"][0] / poly - 1) < 1e-12
    for arch in ARCH_IDS:
        depths, full_x = dryrun._probe_depths(get_config(arch))
        assert {"depths": [[x, c.num_layers] for x, c in depths],
                "full_x": full_x} == reference["probe_depths"][arch]


SMOKE_MESH = {"data": 2, "model": 2}


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_probe_extrapolation_equals_a_direct_count(kind):
    """phi4-mini's smoke config on a (2, 2) dry mesh: the FLOPs the
    reference's probes (depths 2 and 4, S 512-2048) extrapolate to 7
    layers at S 768 equal the dry step's direct count there within 1e-9
    relative."""
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True),
                              num_layers=7)
    shape = SHAPES["train_4k" if kind == "train" else "prefill_32k"]
    shape = dataclasses.replace(shape, seq_len=768, global_batch=4)
    probes = dryrun.probe_costs(cfg, shape, SMOKE_MESH)
    direct = dryrun.dry_step(cfg, shape, SMOKE_MESH)["flops"]
    assert direct > 0
    assert abs(probes["flops"] / direct - 1) <= 1e-9


def test_dry_step_counts_gemms_and_collectives():
    """The dry step of a smoke train cell on (2, 2): the hand-written
    GEMMs' calls by layout are those of the forward, the remat recompute
    and the backward (dX and dW a forward product, the swiglu gate's
    pre-activation recomputed once an MLP, none for the lm_head, a plain
    product); the collectives are tallied by kind."""
    cfg = get_config("zamba2-7b", smoke=True)
    cfg = dataclasses.replace(cfg, fsdp=True, remat=True)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=4)
    got = dryrun.dry_step(cfg, shape, SMOKE_MESH)
    calls = got["gemm_calls"]
    groups = cfg.num_layers // cfg.shared_attn_every
    fwd = 6 * cfg.num_layers + 7 * groups       # mamba six, shared seven
    assert calls == {"nn": 2 * fwd + groups, "nt": fwd, "tn": fwd}
    c = got["collectives"]
    assert c["all-reduce"] > 0 and c["all-gather"] > 0 \
        and c["reduce-scatter"] > 0
    assert c["total"] == sum(v for k, v in c.items() if k != "total")
    assert got["flops"] > got["gemm_flops"] > 0


def test_dry_group_moves_nothing_and_tallies_result_bytes():
    mesh = DryMesh({"pod": 2, "data": 2, "model": 4}, rank=13)
    assert (mesh.coord("pod"), mesh.coord("data"), mesh.coord("model")) \
        == (1, 1, 1)
    g = mesh.group(("pod", "data"))
    assert (g.size, g.rank) == (4, 3)
    x = torch.empty((6, 8), dtype=torch.bfloat16, device="meta")
    assert coll.all_reduce_(x, g) is x
    y = coll.all_gather_dim(x, 1, g)
    z = coll.reduce_scatter_dim(y, 1, mesh.group("model"))
    assert y.device.type == z.device.type == "meta"
    assert tuple(y.shape) == (6, 32) and tuple(z.shape) == (6, 8)
    assert mesh.tally == {"all-reduce": 96, "all-gather": 384,
                          "reduce-scatter": 96}
    assert coll.group_rank(mesh.group("model")) == 1


def test_meta_tensors_take_the_plain_versions():
    """A meta tensor takes each kernel wrapper's plain version (the
    counterpart of the reference's ``set_backend("reference")``) and
    launches nothing."""
    from repro_torch.core.selector import select_gemm_config
    a = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    b = torch.empty((32, 48), dtype=torch.bfloat16, device="meta")
    before = kmm.tiled_matmul.launches
    cfg = select_gemm_config(64, 48, 32).config
    out = kmm.tiled_matmul(a, b, cfg, out_dtype=torch.float32)
    assert out.device.type == "meta" and tuple(out.shape) == (64, 48)
    assert kmm.tiled_matmul.launches == before


def test_run_cell_writes_the_record(tmp_path):
    """``run_cell`` on a smoke config: the reference's record keys where
    a counterpart exists (no ``memory``: ``memory_analysis`` has none),
    the roofline priced against ``GPU_H100_LIKE``, the file named as the
    reference names it."""
    cfg = get_config("mamba2-370m", smoke=True)
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                global_batch=4)
    rec = dryrun.run_cell("mamba2-370m", "decode_32k", False,
                          out_dir=str(tmp_path), verbose=False,
                          mesh_shape=SMOKE_MESH, cfg=cfg, shape=shape)
    assert {"memory_analytic_gib", "hbm_bytes_analytic", "params",
            "microbatches", "topology", "roofline", "cost_module",
            "collectives_module"} <= set(rec)
    assert "memory" not in rec
    assert rec["topology"]["name"] == "gpu_h100_like"
    assert rec["roofline"]["hlo_bytes"] == rec["hbm_bytes_analytic"]["total"]
    assert rec["params"] == cfg.param_count()
    assert rec["cost_module"]["gemm_calls"] == {
        "nn": 6 * cfg.num_layers, "nt": 0, "tn": 0}
    path = tmp_path / "mamba2-370m__decode_32k__data2xmodel2.json"
    assert json.loads(path.read_text())["roofline"] == rec["roofline"]
    assert math.isfinite(rec["roofline"]["roofline_s"])
