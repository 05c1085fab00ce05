"""The JAX side of ``tests/test_torch_dryrun.py`` that needs devices or
``repro.launch.dryrun``, run in a subprocess with 8 fake CPU devices (as
``tests/distributed_worker.py`` sets them up), so the test process keeps
its one device and never imports a module that rewrites XLA_FLAGS.

    python tests/dryrun_reference_worker.py IN.json

IN.json: {"cells": [[arch, batch, max_len], ...], "meshes": [[axis
names], [sizes]], ...], "fits": [[[[x, s, value], ...], X, S], ...]}.
Prints one JSON object: every cell's ``cache_shardings`` specs on every
mesh ({"<arch>/<B>/<S>/<mesh>": {leaf path: [part, ...]}}, a part None, a
name or a list of names), ``_fit_and_eval`` of each set of samples at its
(X, S), and ``_probe_depths`` of every architecture (its probe depths,
their layer counts and the full depth variable).
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

jax.devices()                     # 8 devices, before dryrun rewrites the flag

from repro.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro.distributed.sharding import cache_shardings  # noqa: E402
from repro.launch import dryrun  # noqa: E402
from repro.nn.model import Model  # noqa: E402


def _part(p):
    if p is None or isinstance(p, str):
        return p
    return list(p)


def main() -> None:
    with open(sys.argv[1]) as f:
        req = json.load(f)
    out = {"specs": {}, "probe_depths": {}}
    for names, sizes in req["meshes"]:
        mesh = jax.make_mesh(tuple(sizes), tuple(names),
                             devices=jax.devices()[:int(np.prod(sizes))])
        tag = "x".join(str(n) for n in sizes)
        for arch, batch, max_len in req["cells"]:
            cfg = get_config(arch)
            specs = cache_shardings(Model(cfg).cache_specs(batch, max_len),
                                    mesh, cfg)
            flat = jax.tree_util.tree_flatten_with_path(specs)[0]
            out["specs"][f"{arch}/{batch}/{max_len}/{tag}"] = {
                "/".join(str(k.key) for k in path): [_part(p)
                                                     for p in s.spec]
                for path, s in flat}
    out["fits"] = [dryrun._fit_and_eval({(x, s): v for x, s, v in samples},
                                        X, S)
                   for samples, X, S in req["fits"]]
    for arch in ARCH_IDS:
        depths, full_x = dryrun._probe_depths(get_config(arch))
        out["probe_depths"][arch] = {
            "depths": [[x, c.num_layers] for x, c in depths],
            "full_x": full_x}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
