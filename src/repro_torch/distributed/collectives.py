"""Mesh-level applications of the analytical model, and the tensor-parallel
GEMM (the port of ``repro/distributed/collectives.py``).

The paper scopes itself to one GPU.  The reference extends its
max(compute, data-movement) scoring with ring-collective terms to rank the
sharding layouts of one GEMM on a mesh: per-device GEMM latency (the
paper's model, at the LOCAL shapes) against collective latency (a ring
over ``hw.ici_bandwidth``, NVLink4's 50 GB/s a link on the port's default
``GPU_H100_LIKE``).  :func:`ring_all_reduce_s`, :func:`ring_all_gather_s`,
:class:`LayoutChoice` and :func:`choose_gemm_layout` are the reference's,
copied with the imports rewritten.

:func:`tp_matmul` is the reference's ``shard_map`` written as the local
product plus an explicit collective on a ``torch.distributed`` group: the
selector sees the local (M, N, K), and on the card the local product is the
hand-written Hopper GEMM (``kops.matmul``).  A column-sharded product needs
no collective; a row-sharded one sums f32 partial products with one
``all_reduce`` (the reference's ``psum``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.dtypes import DTYPE_BYTES
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.selector import select_gemm_config
from repro_torch.core.topology import HardwareSpec
from repro_torch.kernels import ops as kops


def ring_all_reduce_s(nbytes: float, n: int, hw: HardwareSpec) -> float:
    """Bidirectional-ring all-reduce time: 2(n-1)/n * bytes / link_bw."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * nbytes / hw.ici_bandwidth


def ring_all_gather_s(nbytes_local: float, n: int, hw: HardwareSpec) -> float:
    if n <= 1:
        return 0.0
    return (n - 1) * nbytes_local / hw.ici_bandwidth


@dataclass(frozen=True)
class LayoutChoice:
    layout: str            # "dp" | "tp_n" | "tp_k" | "replicated"
    predicted_s: float
    per_chip: Tuple[int, int, int]
    collective_s: float


def choose_gemm_layout(M: int, N: int, K: int, n_chips: int,
                       in_dtype: str = "bfloat16",
                       hw: HardwareSpec = GPU_H100_LIKE) -> LayoutChoice:
    """Rank {row-shard M (DP), col-shard N (TP-n), shard K (TP-k + psum)}
    with the paper's per-chip latency model + ring collective terms."""
    b = DTYPE_BYTES[in_dtype]
    cands = []
    if M % n_chips == 0:
        sel = select_gemm_config(M // n_chips, N, K, in_dtype=in_dtype, hw=hw)
        cands.append(LayoutChoice("dp", sel.predicted.total,
                                  (M // n_chips, N, K), 0.0))
    if N % n_chips == 0:
        sel = select_gemm_config(M, N // n_chips, K, in_dtype=in_dtype, hw=hw)
        cands.append(LayoutChoice("tp_n", sel.predicted.total,
                                  (M, N // n_chips, K), 0.0))
    if K % n_chips == 0:
        sel = select_gemm_config(M, N, K // n_chips, in_dtype=in_dtype, hw=hw)
        coll = ring_all_reduce_s(M * N * 4.0, n_chips, hw)
        cands.append(LayoutChoice(
            "tp_k", sel.predicted.total + coll, (M, N, K // n_chips), coll))
    if not cands:
        sel = select_gemm_config(M, N, K, in_dtype=in_dtype, hw=hw)
        cands.append(LayoutChoice("replicated", sel.predicted.total,
                                  (M, N, K), 0.0))
    return min(cands, key=lambda c: c.predicted_s)


def all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in f32 (an f32 ``x`` is summed in
    place; any other dtype is summed in an f32 copy)."""
    import torch.distributed as dist
    y = x if x.dtype == torch.float32 else x.float()
    dist.all_reduce(y, group=group)
    return y


def tp_matmul(x: torch.Tensor, w: torch.Tensor, group, *,
              reduce_k: bool = False,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tensor-parallel GEMM on this rank's shards: the selector and the
    kernel see the LOCAL shapes.

    reduce_k=False: w column-sharded (D, F/n), x whole -> this rank's
    (..., F/n) columns in x's dtype, no collective.
    reduce_k=True : w row-sharded (D/n, F), x sharded on D -> the f32 sum
    of every rank's partial product (one ``all_reduce``).  ``residual``
    (..., F) is added once: in the flush of the group's first rank, as the
    reference fuses it into the one flush of its unsharded product."""
    if not reduce_k:
        if residual is not None:
            raise ValueError("tp_matmul: a residual is added only to the "
                             "row-sharded (reduce_k) product")
        return kops.matmul(x, w)
    import torch.distributed as dist
    if dist.get_group_rank(group, dist.get_rank()) != 0:
        residual = None
    y = kops.matmul(x, w, out_dtype=torch.float32, residual=residual)
    dist.all_reduce(y, group=group)
    return y
