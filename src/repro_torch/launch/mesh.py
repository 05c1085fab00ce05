"""Process groups, the ("data", "model") mesh, and spawned ranks (the port
of ``repro/launch/mesh.py``).

Nothing here runs at import.  :class:`DryMesh` is a mesh for one rank
with no peers, whose collectives move nothing (the dry-run's).  A rank joins its process group with
:func:`init_distributed`, builds the mesh over it with
:func:`make_local_mesh` and installs it with ``meshctx.set_mesh``.  The
backend follows the devices:

* one card a rank: NCCL, rank ``r`` on ``cuda:r % device_count``;
* the CPU: gloo;
* several ranks sharing ``cuda:0`` (``shared_card=True``, which the caller
  asks for by name; nothing falls back to it): gloo, whose CUDA path stages
  each collective through the host.  NCCL refuses two ranks on one card.
  gloo takes ``all_reduce`` and ``broadcast`` of CUDA tensors itself (the
  serving path's two collectives); ``distributed/collectives.py`` runs
  training's all-gather (FSDP, the MoE's routing) and reduce-scatter
  through gloo's ``all_reduce``, and the checkpoint's point-to-point
  sends through the host.

:func:`spawn_ranks` runs a function in ``world`` spawned processes that
meet through a file store in a temporary directory (no port to pick), with
a deadline: a rank that fails or outlives it takes every rank down.
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence

import torch


class LocalMesh:
    """A ``DeviceMesh`` with the reference's reading of it: ``shape`` is the
    ``{axis name: size}`` dict ``distributed/sharding.py`` duck-types on;
    ``group(axis)`` and ``coord(axis)`` are the axis's process group and
    this rank's coordinate on it."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.shape: Dict[str, int] = dict(zip(device_mesh.mesh_dim_names,
                                              device_mesh.mesh.shape))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)


class DryMesh:
    """A mesh of ``shape`` ({axis name: size}) for one rank with no peers:
    the dry-run's (``launch/dryrun.py``).  ``coord(axis)`` is ``rank``'s
    coordinate (row-major, as :func:`make_local_mesh` lays ranks out);
    ``group(axis)`` (an axis name or a tuple of them, as
    ``meshctx.data_axis`` asks) is a ``collectives.DryGroup`` whose
    collectives move nothing and add their result bytes to
    :attr:`tally`."""

    def __init__(self, shape: Dict[str, int], rank: int = 0):
        from repro_torch.distributed.sharding import mesh_coords
        self.shape = dict(shape)
        self.coords = mesh_coords(self, rank)
        self.tally: Dict[str, int] = {}

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis):
        from repro_torch.distributed.collectives import DryGroup
        names = axis if isinstance(axis, tuple) else (axis,)
        size, coord = 1, 0
        for a in names:
            size *= self.shape[a]
            coord = coord * self.shape[a] + self.coords[a]
        return DryGroup(size, coord, self.tally)


def init_distributed(rank: int, world: int, init_method: str, *,
                     device: str = "cuda", shared_card: bool = False
                     ) -> torch.device:
    """Join the default process group as ``rank`` of ``world``; returns
    this rank's device.  ``device="cpu"``: gloo.  ``device="cuda"``: NCCL
    with one card a rank, or, with ``shared_card``, gloo with every rank on
    ``cuda:0``."""
    import torch.distributed as dist
    kind = torch.device(device).type
    if kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    elif kind != "cuda":
        raise ValueError(f"unsupported device {device}")
    elif not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass "
                           "device='cpu' to run the ranks on the CPU")
    elif shared_card:
        dev, backend = torch.device("cuda", 0), "gloo"
    else:
        n = torch.cuda.device_count()
        if n < world:
            raise RuntimeError(
                f"{world} ranks need {world} cards for NCCL, this host has "
                f"{n}; ask for shared_card=True to run them on cuda:0 over "
                f"gloo")
        dev, backend = torch.device("cuda", rank % n), "nccl"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dev


def check_tp(cfg, tp: int) -> None:
    """Refuse a "model" axis the model cannot split over: an SSM or hybrid
    model's SSM heads must split into whole heads (``tp_shardings`` keeps
    the d_inner split only then; a rank's gated RMSNorm, conv channels and
    SSM state are its heads')."""
    if tp > 1 and cfg.has_ssm and cfg.ssm_heads % tp:
        raise ValueError(
            f"{cfg.name}: --tp {tp} does not divide its {cfg.ssm_heads} SSM "
            f"heads ({cfg.ssm_heads} % {tp} = {cfg.ssm_heads % tp})")


def make_local_mesh(tp: int = 1, *, device_type: str = "cuda") -> LocalMesh:
    """The ("data", "model") mesh of shape (world // tp, tp) over the
    default process group (``repro/launch/mesh.py:17-21``), row-major:
    rank r holds data coordinate r // tp and model coordinate r % tp.
    ``group("data")`` is the ranks that share this rank's model
    coordinate, ``group("model")`` those that share its data
    coordinate."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if tp < 1 or n % tp:
        raise ValueError(f"tp {tp} does not divide the world size {n}")
    return LocalMesh(init_device_mesh(device_type, (n // tp, tp),
                                      mesh_dim_names=("data", "model")))


def _rank_main(fn: Callable, rank: int, world: int, init_method: str,
               args: Sequence, results) -> None:
    import torch.distributed as dist
    try:
        # Pickled here, by value: the queue would share a tensor's storage
        # with the parent through this process, which exits right after.
        results.put((rank, True,
                     pickle.dumps(fn(rank, world, init_method, *args))))
    except BaseException:                          # reported, then exit
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: Sequence = (), *,
                timeout: float = 600.0) -> List[Any]:
    """``[fn(rank, world, init_method, *args) for rank in range(world)]``,
    each call in a spawned process; ``init_method`` is a file store all
    ranks meet at.  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function).  Raises with the rank's traceback when one fails, or when
    the ranks are not done within ``timeout`` seconds; every rank still
    alive then is killed."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: Dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, tuple(args), results))
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} not "
                        f"done within {timeout:.0f} s")
                try:
                    rank, ok, val = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{val}")
                out[rank] = pickle.loads(val)
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            results.close()
    return [out[r] for r in range(world)]
