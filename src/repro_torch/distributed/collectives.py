"""Mesh-level applications of the analytical model, the tensor-parallel
GEMM, and the collectives autograd sees (the port of
``repro/distributed/collectives.py``).

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

The reference differentiates its collectives through GSPMD.  Here each is
a ``torch.autograd.Function`` with its backward written out, in two
conventions:

* the "model" axis (Megatron's f and g): every rank of the axis holds the
  same activations and the same loss.  :func:`copy_to_group` is the
  identity forward and sums the gradient over the axis backward (it sits
  before a column-parallel product, whose input gradient is each rank's
  partial); :func:`all_reduce_f32` sums forward and passes the gradient
  through (after a row-parallel product or a vocab-parallel lookup).
* the data axis: each rank holds its rows and its own loss, and the
  objective is the ranks' mean.  :func:`gather_along` (FSDP: all-gather a
  sharded weight along a dim) reduce-scatters the gradient sum backward;
  :func:`data_mean` is the mean forward and backward; the train step then
  averages every gradient over the axis (``launch/steps.py``).

Each collective runs on the group's backend.  NCCL runs them natively.
gloo (the CPU, and ranks sharing one card) takes ``all_reduce`` of a CUDA
tensor itself, staged through the host, and the port runs its other
collectives through that ``all_reduce``: the all-gather as the sum of
zero-padded blocks (exact: each element has one nonzero term; a -0.0
comes back +0.0), the reduce-scatter as the whole sum with this rank's
block kept.  Each moves the whole tensor, up to twice a native one's
bytes, and still runs 2-5x faster than the same collectives staged
through pageable host copies (four ranks sharing one H100: 0.12-0.20
GB/s a rank staged, 0.83 through gloo's ``all_reduce``).
Point-to-point sends of a CUDA tensor go through the host.  Nothing
switches backend.  Every collective the model issues goes through
:func:`all_reduce_`, :func:`all_gather_dim` and :func:`reduce_scatter_dim`,
where a profiler can time it.

On a :class:`DryGroup` (a group of the dry-run's mesh, ``launch/mesh.py::
DryMesh``) nothing moves: each of the three gives a "meta" tensor of its
result's shape (the all-reduce its input, as it sums in place) and adds
its result bytes to the mesh's tally by kind, the counterpart of the
reference's per-device collective bytes of the partitioned HLO
(``repro/core/roofline.py::parse_collective_bytes``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

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


class DryGroup:
    """A process group of ``size`` ranks in which this one is ``rank``,
    whose collectives move nothing and add their result bytes to
    ``tally`` (kind -> bytes, shared by the groups of one dry mesh)."""

    def __init__(self, size: int, rank: int, tally: dict):
        self.size, self.rank, self.tally = size, rank, tally

    def count(self, kind: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A meta tensor of the result, its bytes tallied under ``kind``."""
        out = torch.empty(shape, dtype=dtype, device="meta")
        self.tally[kind] = self.tally.get(kind, 0) + \
            out.numel() * out.element_size()
        return out


def _backend(group) -> str:
    import torch.distributed as dist
    return dist.get_backend(group)


def group_rank(group) -> int:
    """This process's rank within ``group``."""
    if isinstance(group, DryGroup):
        return group.rank
    import torch.distributed as dist
    return dist.get_group_rank(group, dist.get_rank())


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (every backend takes it natively;
    gloo stages a CUDA tensor through the host itself)."""
    if isinstance(group, DryGroup):
        group.count("all-reduce", t.shape, t.dtype)
        return t
    import torch.distributed as dist
    dist.all_reduce(t, group=group)
    return t


def _gloo(group) -> bool:
    return _backend(group) == "gloo"


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group members' ``t`` (equal shapes) concatenated along ``dim``
    in group-rank order."""
    if isinstance(group, DryGroup):
        shape = list(t.shape)
        shape[dim] *= group.size
        return group.count("all-gather", shape, t.dtype)
    import torch.distributed as dist
    n, r = dist.get_world_size(group), group_rank(group)
    src = t.movedim(dim, 0).contiguous()
    w = src.shape[0]
    out = torch.empty((n * w, *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    if _gloo(group):
        out.zero_()[r * w:(r + 1) * w] = src
        all_reduce_(out, group)
    else:
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This member's block along ``dim`` (``t.shape[dim]`` / the group's
    size) of the sum of the members' ``t``, in ``t``'s dtype."""
    if isinstance(group, DryGroup):
        shape = list(t.shape)
        shape[dim] //= group.size
        return group.count("reduce-scatter", shape, t.dtype)
    import torch.distributed as dist
    n = dist.get_world_size(group)
    w = t.shape[dim] // n
    if _gloo(group):
        return all_reduce_(t.contiguous().clone(), group).narrow(
            dim, group_rank(group) * w, w).contiguous()
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((w, *src.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def send_(t: torch.Tensor, dst: int) -> None:
    """Send ``t`` to global rank ``dst`` (gloo: from the host)."""
    import torch.distributed as dist
    dist.send(t.cpu() if _gloo(None) else t.contiguous(), dst=dst)


def recv_(shape, dtype, src: int) -> torch.Tensor:
    """A tensor of ``shape`` received from global rank ``src``, on the
    host (NCCL receives on this rank's card)."""
    import torch.distributed as dist
    dev = "cpu" if _gloo(None) else torch.device(
        "cuda", torch.cuda.current_device())
    buf = torch.empty(shape, dtype=dtype, device=dev)
    dist.recv(buf, src=src)
    return buf.cpu()


class _Copy(torch.autograd.Function):
    """Forward the identity; backward the gradient summed over the group
    (f32, cast back)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.float(), ctx.group).to(g.dtype), None


class _Reduce(torch.autograd.Function):
    """Forward the sum over the group (f32 unless ``keep_dtype``); backward
    the gradient passed through in the input's dtype."""

    @staticmethod
    def forward(ctx, x, group, keep_dtype):
        ctx.dtype = x.dtype
        y = x.clone() if keep_dtype or x.dtype == torch.float32 \
            else x.float()
        return all_reduce_(y, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _Gather(torch.autograd.Function):
    """FSDP's gather: forward the all-gather along ``dim``; backward the
    reduce-scatter of the gradient's sum, in the gradient's dtype (as the
    reference's psum of a bf16 gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _Mean(torch.autograd.Function):
    """The mean over the group, forward and (its adjoint) backward."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return all_reduce_(x.float().clone(), group).div_(n).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.float().clone(), ctx.group).div_(ctx.n).to(
            g.dtype), None, None


class _ResidualGrad(torch.autograd.Function):
    """Forward ``y`` as it is; backward ``y``'s gradient to ``y`` and to
    ``residual`` too: a residual another rank added into ``y``'s sum."""

    @staticmethod
    def forward(ctx, y, residual):
        ctx.dtype = residual.dtype
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g, g.to(ctx.dtype)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The model axis's "copy": ``x`` unchanged, and in the backward pass
    its gradient summed over ``group`` (the input of column-parallel
    products, whose gradients are each rank's partial)."""
    return _Copy.apply(x, group) if _needs_grad(x) else x


def all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The model axis's "reduce": the sum of ``x`` over ``group`` in f32
    (with no autograd recording, an f32 ``x`` is summed in place and any
    other dtype in an f32 copy); the gradient passes through to every
    rank's term."""
    if _needs_grad(x):
        return _Reduce.apply(x, group, False)
    return all_reduce_(x if x.dtype == torch.float32 else x.float(), group)


def sum_disjoint(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of tensors whose nonzero entries are
    disjoint (each rank writes its own rows of a shared buffer), in
    ``x``'s dtype, exactly; the gradient passes through, which is the
    whole gradient of the rows this rank wrote when each rank reads back
    only those rows' results."""
    if _needs_grad(x):
        return _Reduce.apply(x, group, True)
    return all_reduce_(x.clone(), group)


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """FSDP's gather: every group member's block of a leaf concatenated
    along ``dim``; in the backward pass the gradient's sum over the group
    is reduce-scattered back to the blocks."""
    if _needs_grad(x):
        return _Gather.apply(x, dim, group)
    return all_gather_dim(x, dim, group)


def data_mean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``x`` over the ``n`` ranks of ``group``, and the same
    mean of the gradient in the backward pass."""
    if _needs_grad(x):
        return _Mean.apply(x, group, n)
    return all_reduce_(x.float().clone(), group).div_(n).to(x.dtype)


def tp_matmul(x: torch.Tensor, w: torch.Tensor, group, *,
              reduce_k: bool = False,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tensor-parallel GEMM on this rank's shards: the selector and the
    kernel see the LOCAL shapes.

    reduce_k=False: w column-sharded (D, F/n), x whole -> this rank's
    (..., F/n) columns in x's dtype, no collective (x's gradient is summed
    over the group in the backward pass).
    reduce_k=True : w row-sharded (D/n, F), x sharded on D -> the f32 sum
    of every rank's partial product (one ``all_reduce``).  ``residual``
    (..., F) is added once: in the flush of the group's first rank, as the
    reference fuses it into the one flush of its unsharded product; every
    rank's residual receives the sum's gradient."""
    if not reduce_k:
        if residual is not None:
            raise ValueError("tp_matmul: a residual is added only to the "
                             "row-sharded (reduce_k) product")
        return kops.matmul(copy_to_group(x, group), w)
    first = group_rank(group) == 0
    y = kops.matmul(x, w, out_dtype=torch.float32,
                    residual=residual if first else None)
    y = all_reduce_f32(y, group)
    if not first and _needs_grad(residual):
        y = _ResidualGrad.apply(y, residual)
    return y
