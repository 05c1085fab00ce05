"""Dry-run of every (arch x shape x mesh) cell: one rank's step, with no
card and no peers (the port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for the 16x16 single-pod mesh
and the 2x16x16 multi-pod mesh of fake XLA devices and reads
``compiled.cost_analysis()``, the partitioned HLO's collectives and
``compiled.memory_analysis()``.  The port runs what rank 0 of that mesh
would run, eagerly, on "meta" tensors (shapes and dtypes, no storage):

* its param shards under ``tp_shardings`` and its rows of the batch (the
  reference's ``batch_shardings``: rows that do not divide over the data
  axes stay whole);
* its step: a train cell's loss, gradients and AdamW commit
  (``launch/steps.py``), a prefill, or a decode step on the engine's
  cache layout (``Model.init_cache``'s, a rank's kv and SSM heads);
* under a :class:`~repro_torch.launch.mesh.DryMesh`, whose collectives
  move nothing and tally their result bytes by kind
  (``distributed/collectives.py::DryGroup``), and under
  ``torch.utils.flop_counter.FlopCounterMode``.  Every kernel wrapper
  takes its plain version on meta (``kernels/ref.py::PLAIN_DEVICES``), as
  the reference's dry-run sets the reference backend.

Each cell's record keeps the reference's keys where a counterpart exists:
``memory_analytic_gib``, ``hbm_bytes_analytic``, ``params``,
``microbatches``, ``topology``, ``cost_module`` (``flops`` from the
counter: every Python loop of the port is counted, where XLA counts a
scan body once; ``gemm_flops`` and ``gemm_calls``, the hand-written GEMMs'
share, by layout), ``collectives_module`` and ``roofline``, priced against
``GPU_H100_LIKE``.  ``compiled.memory_analysis()`` has no counterpart, so
there is no ``memory`` key; the analytic estimate stands in for it.
``--with-probes`` keeps the reference's reduced-(L, S) probes and their
exact structural fit (:func:`_probe_depths`, :func:`_fit_and_eval`,
unchanged): on the port the direct count is exact already, and the fit
reproduces it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch phi4-mini-3.8b --shape train_4k [--multi-pod] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import meshctx
from repro_torch.configs.registry import (ARCH_IDS, all_cells, get_config,
                                          get_shape)
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.roofline import COLLECTIVES, roofline
from repro_torch.core.topology import HardwareSpec, topology_fingerprint
from repro_torch.distributed.sharding import local_index, tp_shardings
from repro_torch.kernels import matmul as kmm
from repro_torch.launch.memory import (estimate_cell_memory,
                                       estimate_step_hbm_bytes,
                                       select_microbatches)
from repro_torch.launch.mesh import DryMesh
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.meshctx import DATA_AXES
from repro_torch.nn import transformer as T
from repro_torch.nn.config import ModelConfig, ShapeSpec
from repro_torch.nn.model import Model
from repro_torch.optim import AdamW

# The reference's production meshes (``repro/launch/mesh.py:9-14``).
MESHES = {False: ("pod16x16", {"data": 16, "model": 16}),
          True: ("pod2x16x16", {"pod": 2, "data": 16, "model": 16})}
KNOBS = ("sp_stash", "gqa_packed_decode", "kv_repeat_weights",
         "moe_dense_decode", "moe_local_dispatch")


# ---------------------------------------------------------------------------
# Cost probes (the reference's, unchanged): reduced (L, S) variants and the
# exact structural model
#     f(L, S) = a0 + a1*S + L*(b0 + b1*S + b2*S^2)
# (embedding/loss terms linear in S; per-layer work with linear and, for
# attention, quadratic S terms; optimizer work per layer S-independent).
# Six probes (2 depths x 3 sequence points) solve it exactly.
# ---------------------------------------------------------------------------

_PROBE_S = {"train": (512, 1024, 2048),
            "prefill": (512, 1024, 2048),
            "decode": (2048, 4096, 8192)}


def _probe_depths(cfg):
    """Two reduced-depth variants + the linear depth variable (layers, or
    groups for the hybrid family) with its full-scale value."""
    if cfg.family == "hybrid":
        g = cfg.shared_attn_every
        tail = cfg.num_layers % g
        mk = lambda k: dataclasses.replace(  # noqa: E731
            cfg, num_layers=k * g + tail)
        full_x = (cfg.num_layers - tail) // g
    else:
        mk = lambda k: dataclasses.replace(cfg, num_layers=k)  # noqa: E731
        full_x = cfg.num_layers
    return [(2, mk(2)), (4, mk(4))], full_x


def _fit_and_eval(samples, X_full, S_full):
    """samples: {(x, s): value}. Fit f = a0+a1*s+x*(b0+b1*s+b2*s^2)."""
    xs = sorted({x for x, _ in samples})
    ss = sorted({s for _, s in samples})
    x1, x2 = xs
    dL = {s: (samples[(x2, s)] - samples[(x1, s)]) / (x2 - x1) for s in ss}
    A = np.array([[1.0, s, s * s] for s in ss])
    b = np.linalg.solve(A, np.array([dL[s] for s in ss]))
    a_vals = np.array([samples[(x1, s)] - x1 * dL[s] for s in ss])
    a_coef, _res, _rk, _sv = np.linalg.lstsq(
        np.array([[1.0, s] for s in ss]), a_vals, rcond=None)
    return float(a_coef[0] + a_coef[1] * S_full
                 + X_full * (b[0] + b[1] * S_full + b[2] * S_full ** 2))


# ---------------------------------------------------------------------------
# One rank's step on meta.
# ---------------------------------------------------------------------------

def gemm_flops(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
               trans_b: bool = False) -> Tuple[int, str]:
    """(2·M·N·K, layout) of one hand-written GEMM call: a dense (M, K) @
    (K, N) or a grouped (E, M, K) @ (E, K, N), either operand stored
    transposed (``kernels/matmul.py``'s ``trans_a`` / ``trans_b``)."""
    lead = a.shape[:-2]
    m, k = (a.shape[-1], a.shape[-2]) if trans_a else a.shape[-2:]
    n = b.shape[-2] if trans_b else b.shape[-1]
    layout = "tn" if trans_a else "nt" if trans_b else "nn"
    return 2 * math.prod(lead) * m * n * k, layout


@contextlib.contextmanager
def gemm_tally() -> Iterator[Dict]:
    """Inside: {"flops", "calls": {layout: n}} of every GEMM the kernel
    wrappers hand to their plain versions (dense and grouped, forward and
    backward)."""
    tally = {"flops": 0, "calls": {"nn": 0, "nt": 0, "tn": 0}}

    def counted(fn):
        def call(a, b, *rest, **kw):
            f, layout = gemm_flops(a, b, trans_a=kw.get("trans_a", False),
                                   trans_b=kw.get("trans_b", False))
            tally["flops"] += f
            tally["calls"][layout] += 1
            return fn(a, b, *rest, **kw)
        return call

    real = kmm.matmul_plain, kmm.expert_matmul_plain
    kmm.matmul_plain = counted(real[0])
    kmm.expert_matmul_plain = counted(real[1])
    try:
        yield tally
    finally:
        kmm.matmul_plain, kmm.expert_matmul_plain = real


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def local_params(model: Model, mesh, rank: int = 0) -> Dict:
    """``rank``'s shards of every param under ``tp_shardings``, as meta
    tensors."""
    def build(abstract, specs):
        return {k: (build(a, specs[k]) if isinstance(a, dict) else _meta(
                    [s.stop - s.start for s in local_index(
                        tuple(a.shape), specs[k], mesh, rank)], a.dtype))
                for k, a in abstract.items()}
    return build(model.abstract_params(), tp_shardings(model, mesh))


def local_rows(n: int, mesh) -> int:
    """A rank's rows of ``n``: split over the data axes where they divide,
    else whole (the reference's ``batch_shardings``)."""
    dp = math.prod(mesh.shape.get(a, 1) for a in DATA_AXES)
    return n // dp if n % dp == 0 else n


def dry_step(cfg: ModelConfig, shape: ShapeSpec, mesh_shape: Dict[str, int],
             microbatches: int = 1, rank: int = 0) -> Dict:
    """Rank ``rank``'s step of ``shape`` on meta under a dry mesh of
    ``mesh_shape`` (installed here, removed after): {"flops" (the
    counter's total), "gemm_flops", "gemm_calls", "collectives" ({kind:
    result bytes}, "total")}."""
    mesh = DryMesh(mesh_shape, rank)
    model = Model(cfg, device="meta")
    meshctx.set_mesh(mesh)
    try:
        params = local_params(model, mesh, rank)
        B = local_rows(shape.global_batch, mesh)
        specs = model.input_specs(dataclasses.replace(shape,
                                                      global_batch=B))
        with FlopCounterMode(display=False) as counter, \
                gemm_tally() as gemms:
            if shape.kind == "train":
                opt = AdamW()
                step = make_train_step(model, opt, microbatches)
                loss, grads = step.loss_and_grads(params, specs)
                step.apply(TrainState(params=params, opt=opt.init(params),
                                      step=0), loss, grads)
            elif shape.kind == "prefill":
                extras = {k: v for k, v in specs.items() if k != "tokens"}
                with torch.no_grad():
                    model.prefill(params, specs["tokens"].long(),
                                  extras=extras or None)
            else:
                cache = T.init_cache_specs(cfg, B, shape.seq_len,
                                           local=True)
                with torch.no_grad():
                    model.decode_step(params, cache, specs["tokens"].long(),
                                      specs["pos"].long())
    finally:
        meshctx.set_mesh(None)
    colls = {k: float(mesh.tally.get(k, 0)) for k in COLLECTIVES}
    colls["total"] = sum(colls.values())
    return {"flops": float(counter.get_total_flops()),
            "gemm_flops": float(gemms["flops"]),
            "gemm_calls": dict(gemms["calls"]), "collectives": colls}


def _knobbed(cfg: ModelConfig, knobs: Dict[str, bool]) -> ModelConfig:
    on = {k: True for k in KNOBS if knobs.get(k)}
    return dataclasses.replace(cfg, **on) if on else cfg


def probe_costs(cfg: ModelConfig, shape: ShapeSpec,
                mesh_shape: Dict[str, int], microbatches: int = 1,
                verbose: bool = False) -> Dict:
    """The reference's probes on the port: the counted FLOPs, the analytic
    HBM bytes and the collective bytes of each reduced (depth, S) variant,
    fitted and evaluated at the cell's full depth and S."""
    depths, X_full = _probe_depths(cfg)
    flops_s, bytes_s, coll_s = {}, {}, {}
    for x, cfgv in depths:
        for s in _PROBE_S[shape.kind]:
            shp = dataclasses.replace(shape, seq_len=s)
            got = dry_step(cfgv, shp, mesh_shape, microbatches)
            flops_s[(x, s)] = got["flops"]
            bytes_s[(x, s)] = estimate_step_hbm_bytes(
                cfgv, shp, mesh_shape, microbatches)["total"]
            coll_s[(x, s)] = got["collectives"]["total"]
            if verbose:
                print(f"    probe x={x} S={s}: flops={flops_s[(x, s)]:.3e} "
                      f"bytes={bytes_s[(x, s)]:.3e} "
                      f"coll={coll_s[(x, s)]:.3e}")
    S_full = shape.seq_len
    return {
        "flops": _fit_and_eval(flops_s, X_full, S_full),
        "bytes": _fit_and_eval(bytes_s, X_full, S_full),
        "collective_bytes": _fit_and_eval(coll_s, X_full, S_full),
        "probe_points": {f"x{x}_s{s}": {"flops": flops_s[(x, s)],
                                        "bytes": bytes_s[(x, s)],
                                        "coll": coll_s[(x, s)]}
                         for (x, s) in flops_s},
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = "build/dryrun", verbose: bool = True,
             with_probes: bool = False, microbatches: int = 1,
             hw: HardwareSpec = GPU_H100_LIKE,
             mesh_shape: Optional[Dict[str, int]] = None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeSpec] = None, **knobs) -> Dict:
    """One cell's record (module docstring), written to ``out_dir`` as
    ``<arch>__<shape>__<mesh>.json`` (not written when ``out_dir`` is
    None).  ``mesh_shape``, ``cfg`` and ``shape`` override the production
    mesh, the registry's config and the shape cell (``chip_smoke.py`` runs
    a (1, 1) mesh at its own batch)."""
    cfg = _knobbed(cfg or get_config(arch), knobs)
    shape = shape or get_shape(shape_name)
    mesh_name, prod_shape = MESHES[multi_pod]
    if mesh_shape is not None:
        mesh_name = "x".join(f"{a}{n}" for a, n in mesh_shape.items())
    mesh_shape = dict(mesh_shape or prod_shape)
    chips = math.prod(mesh_shape.values())
    model = Model(cfg, device="meta")
    if microbatches == 0:          # 0 => analytic auto-selection
        microbatches = select_microbatches(cfg, shape, mesh_shape, hw=hw)
    t0 = time.time()
    cost = dry_step(cfg, shape, mesh_shape, microbatches)
    t_step = time.time() - t0
    mem = estimate_cell_memory(cfg, shape, mesh_shape, hw=hw)
    hbm = estimate_step_hbm_bytes(cfg, shape, mesh_shape,
                                  microbatches=microbatches)
    colls = cost["collectives"]
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "kind": shape.kind,
        "topology": {
            "name": hw.name,
            "fingerprint": topology_fingerprint(hw),
            "levels": [{"name": lvl.name, "bandwidth": lvl.bandwidth,
                        "capacity": lvl.capacity, "scope": lvl.scope}
                       for lvl in hw.levels],
        },
        "step_s": round(t_step, 2),
        "microbatches": microbatches,
        **{k: bool(knobs.get(k)) for k in KNOBS},
        "memory_analytic_gib": {k: round(v, 3) if isinstance(v, float)
                                and not isinstance(v, bool) else v
                                for k, v in mem.items()},
        "hbm_bytes_analytic": {k: float(v) for k, v in hbm.items()},
        "cost_module": {"flops": cost["flops"],
                        "gemm_flops": cost["gemm_flops"],
                        "gemm_calls": cost["gemm_calls"],
                        "note": "FlopCounterMode over one rank's step on "
                                "meta; every loop counted"},
        "collectives_module": {k: v for k, v in colls.items() if v},
        "params": model.param_count(),
    }
    flops, coll_terms = cost["flops"], colls
    if with_probes:
        probes = probe_costs(cfg, shape, mesh_shape, microbatches, verbose)
        record["cost_reconstructed"] = {k: probes[k] for k in
                                        ("flops", "bytes",
                                         "collective_bytes")}
        record["probe_points"] = probes["probe_points"]
        flops = probes["flops"]
        coll_terms = {"total": probes["collective_bytes"],
                      "all-reduce": probes["collective_bytes"]}
    rep = roofline(arch=arch, shape_name=shape_name, mesh=mesh_name,
                   chips=chips, hlo_flops=flops, hlo_bytes=hbm["total"],
                   collectives=coll_terms,
                   model_flops=model.model_flops(shape), hw=hw)
    record["roofline"] = rep.as_dict()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    if verbose:
        print(f"[OK] {arch} x {shape_name} x {mesh_name}: "
              f"step {t_step:.1f}s  "
              f"est {mem['total_gib']:.2f}GiB/dev "
              f"(fits {mem['hbm_gib']:.0f}: {mem['fits_hbm']})  "
              f"flops/dev {flops:.3e}  bound={rep.bottleneck}")
        print(f"     collectives={record['collectives_module']}  "
              f"gemm_calls={cost['gemm_calls']}")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + ["all"],
                    help="architecture id (or 'all')")
    ap.add_argument("--shape", default=None,
                    help="shape cell name (omit for all applicable)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all applicable (arch x shape) cells")
    ap.add_argument("--with-probes", action="store_true",
                    help="also reconstruct the costs from reduced (L, S) "
                         "probes")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation factor for train cells "
                         "(0 = analytic auto-selection from memory model)")
    ap.add_argument("--sp-stash", action="store_true",
                    help="sequence-shard the residual stream at scan "
                         "boundaries (SP remat stash)")
    ap.add_argument("--gqa-packed-decode", action="store_true",
                    help="grouped-query decode attention (no KV repeat)")
    ap.add_argument("--kv-repeat-weights", action="store_true",
                    help="Megatron KV-weight duplication (TP > Hkv)")
    ap.add_argument("--moe-dense-decode", action="store_true",
                    help="decode MoE: all local experts, no weight gather")
    ap.add_argument("--moe-local-dispatch", action="store_true",
                    help="MoE dispatch packed within each data shard")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    if args.all or args.arch == "all":
        cells = [(a, s) for a, s, ok, _ in all_cells() if ok]
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        if args.shape:
            cells = [(args.arch, args.shape)]
        else:
            cells = [(a, s) for a, s, ok, _ in all_cells()
                     if ok and a == args.arch]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    knobs = {k: getattr(args, k) for k in KNOBS}

    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                run_cell(arch, shape, mp, out_dir=args.out,
                         with_probes=args.with_probes,
                         microbatches=args.microbatches, **knobs)
            except Exception as e:                     # noqa: BLE001
                failures.append((arch, shape, mp, repr(e)))
                print(f"[FAIL] {arch} x {shape} x "
                      f"{'multi' if mp else 'single'}: {e}")
                traceback.print_exc()
    print(f"\n{len(cells)*len(meshes)-len(failures)} passed, "
          f"{len(failures)} failed")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
