"""Flash attention on Hopper: the wrapper over ``csrc/flash_attention.cu`` and
the port's own (block_q, block_kv) selector.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.  The
kernel computes online-softmax attention for q (B, H, Sq, d) against k/v
(B, Hkv, Skv, d) with GQA by index (no KV repeat), the causal block skip,
the ``k < kv_len`` padding mask and f32 m/l/acc with the TPU kernel's -inf
guards; every kernel, forward and backward in both dtypes, also takes a
sliding window (``window`` > 0: key j is visible to query i only if
i - j < window, the reference's strict test,
``repro/nn/attention.py:80-82``), whose plain versions are
``nn/attention.py::chunked_attention``, ``ref.attention_lse_ref`` and
``ref.attention_bwd_ref``; the source note in ``csrc/flash_attention.cu``
says what bounds it on the H100 and what its design does about that.

:func:`flash_attention_kernel` takes the route from the device of q: a CPU
tensor gets the plain version (``ref.attention_ref``), a CUDA tensor the
kernel, and anything else raises.  On the card, bf16 q/k/v take the wgmma
kernel and f32 q/k/v the split-TF32 kernel of the same source (route
"tf32x3", mma.sync; :func:`plan_attention_f32` holds its tiles, grid and
shared bytes, which the C entry checks), at any head dim in
:data:`HEAD_DIMS`; any other head dim or dtype raises.  With
``return_lse`` it also returns the rows' log-sum-exp, which
:func:`flash_attention_bwd_kernel` (the backward: the delta, dK/dV and dQ
kernels of the same source; plain version ``ref.attention_bwd_ref``)
takes.  The backward's route follows the dtype alone: bf16 runs the wgmma
kernels at every head dim, f32 the split-TF32 ones ("tf32x3", mma.sync);
:func:`plan_attention_bwd`
holds its tiles, grids and shared bytes, and the launch passes that plan to
the C entry, which checks it against the instantiation it runs.
``flash_attention_kernel.launches`` counts forward launches of both
dtypes, ``flash_attention_bwd_kernel.launches`` backward ones.  A window
changes no plan: it shortens each CTA's walk, not the grid.
"""
from __future__ import annotations

import ctypes
import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.dtypes import DTYPE_BYTES
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import cdiv
from repro_torch.core.topology import HardwareSpec, topology_fingerprint
from repro_torch.kernels import build, ref
from repro_torch.nn.attention import chunked_attention

BLOCK_MENU = (64, 128)
# Head dims the kernels take: multiples of 8 up to 256.  The bf16 kernel is
# instantiated for d rounded up to 64 (its 128-byte swizzled chunks); the
# padded columns read zeros and are not stored.
HEAD_DIM_ALIGN, MAX_HEAD_DIM = 8, 256
HEAD_DIMS = tuple(range(HEAD_DIM_ALIGN, MAX_HEAD_DIM + 1, HEAD_DIM_ALIGN))
DTYPES = (torch.bfloat16, torch.float32)
STAGES = 2                         # the kernel's K/V ring
_SMEM_BYTES = 227 * 1024           # a block's opt-in dynamic shared memory
_SMEM_RESERVED = 1024              # shared memory the system reserves per block
_TILE_BYTES = 2                    # the kernel stages bf16 tiles
_REG_OVERHEAD = 40                 # addresses, loop state, softmax scalars


def _ctas_per_sm_at_launch(block_q: int) -> int:
    """The kernel's launch bounds: a one-warpgroup CTA (block_q 64) is
    built for two CTAs an SM, a two-warpgroup CTA for one."""
    return 2 if block_q == 64 else 1


def _max_regs(block_q: int) -> int:
    """A consumer thread's registers after the producer warpgroup hands its
    own over (setmaxnreg: 224 when two CTAs share the register file, 232
    for one)."""
    return 224 if block_q == 64 else 232


def padded_head_dim(head_dim: int) -> int:
    """The head dim the bf16 kernel computes over: d rounded up to a whole
    64-column (128-byte) swizzled chunk."""
    return cdiv(head_dim, 64) * 64


def _smem_bytes(block_q: int, block_kv: int, head_dim: int) -> int:
    """The kernel's shared memory: the 1 KB alignment slack of the
    swizzled tiles, the Q tile, STAGES x (K tile + V tile) at the padded
    head dim, and the mbarriers."""
    tiles = (block_q + 2 * STAGES * block_kv) * padded_head_dim(head_dim) \
        * _TILE_BYTES
    return 1024 + tiles + 8 * (1 + 3 * STAGES)


def _regs_per_thread(block_kv: int, head_dim: int) -> int:
    """A consumer thread's share of its warpgroup's 64-row fragments: the
    f32 scores S (64 x block_kv) and output O (64 x padded d) over 128
    threads, and P as bf16 pairs, live beside the next block's S; plus
    overhead."""
    return (block_kv // 2 + padded_head_dim(head_dim) // 2 + block_kv // 4
            + _REG_OVERHEAD)


def legal_blocks(block_q: int, block_kv: int, head_dim: int) -> bool:
    """Whether the kernel's budgets take (block_q, block_kv) at head_dim:
    227 KB of shared memory a block, a consumer's registers."""
    return (_smem_bytes(block_q, block_kv, head_dim) <= _SMEM_BYTES
            and _regs_per_thread(block_kv, head_dim) <= _max_regs(block_q))


def ctas_per_sm(block_q: int, block_kv: int, head_dim: int,
                hw: HardwareSpec = GPU_H100_LIKE) -> int:
    """CTAs resident on one SM: its shared memory (the staging level's
    capacity, 228 KB on the H100) and the kernel's launch bounds."""
    by_smem = hw.staging.capacity // (_smem_bytes(block_q, block_kv, head_dim)
                                      + _SMEM_RESERVED)
    return max(1, min(by_smem, _ctas_per_sm_at_launch(block_q)))


def kv_walk(i: int, s_q: int, s_kv: int, block_q: int, block_kv: int,
            causal: bool, window: int = 0) -> Tuple[int, int]:
    """The kv blocks [lo, hi) that q block i walks in the forward kernels
    and the backward's dQ kernels: all of them, or under causal those up
    to the diagonal of its last row; under a window from the block holding
    its first row's first visible key, (q0 - window + 1) // block_kv."""
    n_kv = cdiv(s_kv, block_kv)
    hi = (min(n_kv, (min((i + 1) * block_q, s_q) - 1) // block_kv + 1)
          if causal else n_kv)
    lo = max(0, i * block_q - window + 1) // block_kv if window > 0 else 0
    return lo, max(lo, hi)


def kv_steps(s_q: int, s_kv: int, block_q: int, block_kv: int,
             causal: bool, window: int = 0) -> List[int]:
    """The number of kv blocks each q block walks (q block i first,
    :func:`kv_walk`): under a window at most ceil((window + block_q - 1) /
    block_kv) + 1.  The counts never fall as i grows: the kernel's
    reversed q-block order is the heaviest first with a window too."""
    return [hi - lo for lo, hi in
            (kv_walk(i, s_q, s_kv, block_q, block_kv, causal, window)
             for i in range(cdiv(s_q, block_q)))]


def _makespan(ctas: Sequence[Tuple[float, float]], sms: int,
              per_sm: int) -> float:
    """The finish time of ``ctas`` -- (chain seconds, tensor-core seconds)
    each -- issued longest first, each to the slot that frees first, slot
    j on SM j mod ``sms`` (the hardware fills every SM before it doubles
    up).  An SM finishes when its last chain does, or when the tensor-core
    work of every CTA it held is done, if that is later."""
    slots = [(0.0, j) for j in range(max(1, min(sms * per_sm, len(ctas))))]
    work = [0.0] * sms
    finish = [0.0] * sms
    for chain, tensor in sorted(ctas, reverse=True):
        t, j = heapq.heappop(slots)
        heapq.heappush(slots, (t + chain, j))
        work[j % sms] += tensor
        finish[j % sms] = max(finish[j % sms], t + chain)
    return max(max(w, f) for w, f in zip(work, finish))


@dataclass(frozen=True)
class AttentionPlan:
    """One (block_q, block_kv) priced on the card: its grid, residency,
    the longest CTA's kv steps and the predicted seconds."""
    block_q: int
    block_kv: int
    ctas: int
    ctas_per_sm: int
    max_steps: int
    predicted: float


# An SM's dense bf16 tensor-core flops a clock on Hopper (989 TFLOP/s over
# 132 SMs at 1.83 GHz), and the clocks one score of the softmax costs on
# its CUDA cores: one exp2 at 16 a clock and about six f32 operations
# (scale, max, subtract, sum, rescale share, convert) at 128 a clock.
_TC_FLOPS_PER_CLOCK = 4096
_SOFTMAX_CLOCKS_PER_SCORE = 1 / 16 + 6 / 128


def price_attention_blocks(
    s_q: int, s_kv: int, head_dim: int, block_q: int, block_kv: int, *,
    batch: int = 1, heads: int = 1, kv_heads: Optional[int] = None,
    in_dtype: str = "bfloat16", hw: HardwareSpec = GPU_H100_LIKE,
    causal: bool = False, window: int = 0,
) -> AttentionPlan:
    """The kernel's time at (block_q, block_kv), analytically.

    CTAs = batch·heads·⌈s_q/block_q⌉ on ``hw.total_cores()`` SMs, with
    :func:`ctas_per_sm` of them resident on each.  A kv step of a CTA
    costs max(NWG·tc + softmax, 2·bkv·d·bytes / (bw / resident CTAs)):

    - tc = 4·64·bkv·dp / (peak / SMs), one consumer warpgroup's two
      products over the padded head dim dp at one SM's share of the
      tensor-core peak; the CTA's NWG =
      block_q / 64 warpgroups take turns on the tensor cores;
    - softmax = 64·bkv scores at ``_SOFTMAX_CLOCKS_PER_SCORE`` on the
      CUDA cores, priced in series with the products: the kernel runs it
      beside P·V, but a second warpgroup on the SM wants those cycles too,
      and priced so the model ranks the measured menu at the served
      shapes as the card does (PERF.md §6);
    - the K and V tiles at a resident CTA's share of the bandwidth that
      serves them: the L2's when the K/V of every kv head fit its budget
      (each tile is read by ⌈s_q/bq⌉·heads/kv_heads CTAs, and only the
      first read reaches HBM), else HBM's.

    A CTA adds two HBM latencies and its Q, first K/V and O tiles at that
    bandwidth share (the loads before its first step, the store after its
    last), then walks its own kv steps (causal and windowed,
    :func:`kv_steps`).  The CTAs run longest first (:func:`_makespan`);
    co-resident CTAs share an SM's tensor cores.  The
    total is that makespan, or the unique q/k/v/o bytes at the HBM rate if
    longer, plus one kernel launch."""
    kv_heads = heads if kv_heads is None else kv_heads
    bi = DTYPE_BYTES[in_dtype]
    sms = hw.total_cores()
    per_sm = ctas_per_sm(block_q, block_kv, head_dim, hw)
    steps = kv_steps(s_q, s_kv, block_q, block_kv, causal, window)
    ctas = batch * heads * len(steps)
    resident = min(ctas, sms * per_sm)
    nwg = block_q // 64
    tc = 4.0 * 64 * block_kv * padded_head_dim(head_dim) \
        / (hw.flops(in_dtype) / sms)
    clock = hw.flops("bfloat16") / sms / _TC_FLOPS_PER_CLOCK
    softmax = 64 * block_kv * _SOFTMAX_CLOCKS_PER_SCORE / clock
    kv_set = 2 * batch * kv_heads * s_kv * head_dim * bi
    bw = hw.hbm_bandwidth
    for level in hw.cache_levels:
        if kv_set <= level.budget():
            bw = level.bandwidth
            break
    share = bw / resident
    step = max(nwg * tc + softmax, 2.0 * block_kv * head_dim * bi / share)
    fixed = 2 * hw.hbm_latency \
        + (2 * block_q + 2 * block_kv) * head_dim * bi / share
    work = [(fixed + n * step, n * nwg * tc) for n in steps] * (batch * heads)
    unique = 2 * (batch * heads * s_q + batch * kv_heads * s_kv) \
        * head_dim * bi
    total = max(_makespan(work, sms, per_sm), unique / hw.hbm_bandwidth) \
        + hw.kernel_launch
    return AttentionPlan(block_q, block_kv, ctas, per_sm, max(steps), total)


_PLANS: Dict[tuple, AttentionPlan] = {}


def plan_attention(
    s_q: int, s_kv: int, head_dim: int, *, batch: int = 1, heads: int = 1,
    kv_heads: Optional[int] = None, in_dtype: str = "bfloat16",
    hw: HardwareSpec = GPU_H100_LIKE, causal: bool = False, window: int = 0,
) -> AttentionPlan:
    """The cheapest legal pair of the menu under
    :func:`price_attention_blocks` (ties: more CTAs, then larger blocks);
    memoised per topology, like the GEMM selections."""
    key = (topology_fingerprint(hw), s_q, s_kv, head_dim, batch, heads,
           kv_heads, in_dtype, bool(causal), int(window))
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    best_key = None
    for bq in BLOCK_MENU:
        for bkv in BLOCK_MENU:
            if not legal_blocks(bq, bkv, head_dim):
                continue
            cand = price_attention_blocks(
                s_q, s_kv, head_dim, bq, bkv, batch=batch, heads=heads,
                kv_heads=kv_heads, in_dtype=in_dtype, hw=hw, causal=causal,
                window=window)
            cand_key = (cand.predicted, -cand.ctas, -(bq * bkv))
            if best_key is None or cand_key < best_key:
                plan, best_key = cand, cand_key
    if plan is None:
        raise ValueError(f"no legal attention blocks for head_dim "
                         f"{head_dim} ({in_dtype})")
    _PLANS[key] = plan
    return plan


def select_attention_blocks(
    s_q: int,
    s_kv: int,
    head_dim: int,
    *,
    in_dtype: str = "bfloat16",
    hw: HardwareSpec = GPU_H100_LIKE,
    causal: bool = False,
    batch: int = 1,
    heads: int = 1,
    kv_heads: Optional[int] = None,
    window: int = 0,
) -> Tuple[int, int]:
    """Analytical (block_q, block_kv) for the Hopper kernel, with zero
    autotuning: :func:`plan_attention`'s pair.  The legal set is the
    bf16 kernel's (:func:`legal_blocks`; the tiles are bf16 whatever
    ``in_dtype`` prices); (64, 64) is legal for every d up to 256, so a
    pair always exists.  The f32 kernel ignores the pair and runs the
    tiles of :func:`plan_attention_f32`."""
    plan = plan_attention(s_q, s_kv, head_dim, batch=batch, heads=heads,
                          kv_heads=kv_heads, in_dtype=in_dtype, hw=hw,
                          causal=causal, window=window)
    return plan.block_q, plan.block_kv


# The f32 forward (``flash_fwd_tf32x3`` in csrc/flash_attention.cu): split-TF32
# products on mma.sync over f32 tiles of the head dim padded to DP + 4
# floats; a CTA of 8 warps per 64 q rows, two warps a 16-row group, each
# taking half of every ring stage's keys; (K, V) through a 2-stage ring.
FWD_F32_Q_ROWS = 64       # q rows an f32 forward CTA
_FWD_F32_STAGES = 2


def fwd_f32_kv_rows(head_dim: int) -> int:
    """Keys a ring stage of the f32 forward (csrc ``FwdF32::kKeys``): 64,
    and 32 past a padded head dim of 128, so that the Q tile and two stages
    fit 227 KB."""
    return 64 if padded_head_dim(head_dim) <= 128 else 32


@dataclass(frozen=True)
class FwdF32Plan:
    """The f32 forward's launch, every field of which the C entry checks
    against the instantiation it runs: the route, the CTA's ``q_block`` q
    rows, a ring stage's ``kv_block`` keys, the grid and the shared bytes."""
    route: str
    q_block: int
    kv_block: int
    ctas: int
    smem: int


def plan_attention_f32(s_q: int, head_dim: int, *, batch: int = 1,
                       heads: int = 1) -> FwdF32Plan:
    """The f32 forward's launch at these shapes: one CTA per (64 q rows,
    head, batch) whatever the key length and the GQA group; shared memory holds
    the Q tile and two stages of K and V rows, each row the padded head dim
    plus 4 floats."""
    check_head_dim(head_dim)
    ld = padded_head_dim(head_dim) + 4
    kv = fwd_f32_kv_rows(head_dim)
    smem = 4 * (FWD_F32_Q_ROWS + _FWD_F32_STAGES * 2 * kv) * ld
    return FwdF32Plan("tf32x3", FWD_F32_Q_ROWS, kv,
                      cdiv(s_q, FWD_F32_Q_ROWS) * batch * heads, smem)


# The backward (``flash_bwd_*`` in csrc/flash_attention.cu).  bf16: a dK/dV
# kernel (a CTA per 64 kv rows, a dV and a dK consumer warpgroup, a ring of
# 64-row (Q, dO) tiles) and a dQ kernel (a CTA per 64-row q block, a ring of
# 64-key (K, V) tiles), both on wgmma; f32: the same two kernels' structure
# with split-TF32 products on mma.sync (route "tf32x3"), f32 tiles whose
# ring stages hold fewer rows past a padded head dim of 128.  Both start
# with the delta kernel.
BWD_KV_ROWS = 64          # kv rows a dK/dV CTA
BWD_Q_ROWS = 64           # q rows a dK/dV ring stage and a dQ CTA
BWD_KEYS = 64             # keys a dQ ring stage
_BWD_STAGES = 2


def _bwd_kv_smem(head_dim: int) -> int:
    """The dK/dV kernel's shared memory: alignment slack, the K and V
    tiles, the ring's (Q, dO) tiles and its stages' lse2 and delta rows,
    and the mbarriers."""
    tiles = (2 * BWD_KV_ROWS + _BWD_STAGES * 2 * BWD_Q_ROWS) \
        * padded_head_dim(head_dim) * _TILE_BYTES
    return 1024 + tiles + _BWD_STAGES * 2 * BWD_Q_ROWS * 4 \
        + 8 * (1 + 2 * _BWD_STAGES)


def _bwd_q_smem(head_dim: int) -> int:
    """The dQ kernel's: slack, the Q and dO tiles, the ring's (K, V)
    tiles, the mbarriers."""
    tiles = (2 * BWD_Q_ROWS + _BWD_STAGES * 2 * BWD_KEYS) \
        * padded_head_dim(head_dim) * _TILE_BYTES
    return 1024 + tiles + 8 * (1 + 2 * _BWD_STAGES)


def bwd_f32_step_rows(head_dim: int) -> int:
    """The f32 kernels' ring stage: q rows of a dK/dV stage and keys of a
    dQ stage (csrc ``BwdF32::kStep``), fewer past a padded head dim of 128
    so that two stages fit beside the CTA's own two tiles."""
    dp = padded_head_dim(head_dim)
    return 64 if dp <= 128 else (32 if dp <= 192 else 16)


def _bwd_f32_smem(head_dim: int) -> Tuple[int, int]:
    """The f32 kernels' shared memory (dK/dV, dQ): the CTA's two 64-row
    f32 tiles and two ring stages of two tiles, rows of the padded head dim
    plus 4 floats; a dK/dV stage also holds its q rows' lse2 and delta,
    and the dK/dV CTA the P^T its dV warps hand to its dK warps (4 row
    groups x 32 lanes x step / 2 values)."""
    ld, step = padded_head_dim(head_dim) + 4, bwd_f32_step_rows(head_dim)
    own = 2 * 64 * ld
    kv = own + _BWD_STAGES * (2 * step * ld + 2 * step) + 64 * step
    q = own + _BWD_STAGES * 2 * step * ld
    return 4 * kv, 4 * q


@dataclass(frozen=True)
class BwdPlan:
    """The backward's launch, every field of which the C entry checks
    against the instantiation it runs: the route, the dK/dV CTA's
    ``kv_block`` kv rows, the dQ CTA's ``q_block`` q rows, ``sq_pad`` rows
    a (batch, head) of the lse/delta scratch, and each kernel's grid and
    shared bytes."""
    route: str
    kv_block: int
    q_block: int
    sq_pad: int
    kv_ctas: int
    q_ctas: int
    kv_smem: int
    q_smem: int


def plan_attention_bwd(
    s_q: int, s_kv: int, head_dim: int, *, batch: int = 1, heads: int = 1,
    kv_heads: Optional[int] = None, in_dtype: str = "bfloat16",
) -> BwdPlan:
    """The backward's launch at these shapes: bf16 takes the wgmma kernels,
    f32 the split-TF32 ones ("tf32x3"); both run 64 kv rows a dK/dV CTA
    and 64 q rows a dQ CTA, whatever the head dim.  A bf16 dK/dV CTA walks
    its kv head's whole GQA group, an f32 one a single q head (its grid
    counts q heads; a group-sum kernel adds them)."""
    kv_heads = heads if kv_heads is None else kv_heads
    check_head_dim(head_dim)
    n_qb = cdiv(s_q, BWD_Q_ROWS)
    if in_dtype == "float32":
        kv_smem, q_smem = _bwd_f32_smem(head_dim)
        return BwdPlan("tf32x3", BWD_KV_ROWS, BWD_Q_ROWS, n_qb * BWD_Q_ROWS,
                       cdiv(s_kv, BWD_KV_ROWS) * batch * heads,
                       n_qb * batch * heads, kv_smem, q_smem)
    if in_dtype != "bfloat16":
        raise ValueError(f"flash_attention_bwd: no route for {in_dtype}")
    return BwdPlan("wgmma", BWD_KV_ROWS, BWD_Q_ROWS, n_qb * BWD_Q_ROWS,
                   cdiv(s_kv, BWD_KV_ROWS) * batch * kv_heads,
                   n_qb * batch * heads, _bwd_kv_smem(head_dim),
                   _bwd_q_smem(head_dim))


def _by_kv_head(fn, q, k, v, *per_q):
    """``fn(q, k, v, *per_q)`` computed one kv head's GQA group at a time
    (``per_q``: tensors laid out as q, sliced with it), each output
    concatenated along its head axis: the same function, with the dense
    (Sq, Skv) scores of one group alive at a time instead of every head's
    (at S 8192 and 48 heads, 1.6 GB a tensor instead of 12.9)."""
    hkv = k.shape[1]
    if hkv == 1:
        return fn(q, k, v, *per_q)
    g = q.shape[1] // hkv
    parts = [fn(q[:, i * g:(i + 1) * g], k[:, i:i + 1], v[:, i:i + 1],
                *(t[:, i * g:(i + 1) * g] for t in per_q))
             for i in range(hkv)]
    return tuple(torch.cat(xs, dim=1) for xs in zip(*parts))


def attention_plain(q, k, v, *, block_q: int, block_kv: int,
                    causal: bool = False, scale: Optional[float] = None,
                    return_lse: bool = False, window: int = 0):
    """The plain version: what the kernels compute, whatever the blocks,
    at any head dim and dtype (and the rows' lse, f32, with
    ``return_lse``, one kv head's group at a time).  With a window and no
    lse it is the reference's chunked online softmax
    (:func:`chunked_attention`), which holds one 512 x 512 score chunk a
    head where ``ref.attention_ref`` would hold all Sq x Skv."""
    if return_lse:
        return _by_kv_head(
            lambda q_, k_, v_: ref.attention_lse_ref(
                q_, k_, v_, causal=causal, scale=scale, window=window),
            q, k, v)
    if window > 0:
        return chunked_attention(q, k, v, causal=causal,
                                 sliding_window=window, scale=scale)
    return ref.attention_ref(q, k, v, causal=causal, scale=scale)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, block_q: int, block_kv: int,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           return_lse: bool = False, window: int = 0):
    """Attention of q (B, H, Sq, d) over k/v (B, Hkv, Skv, d); returns
    (B, H, Sq, d) in q's dtype, and with ``return_lse`` also the rows'
    log-sum-exp of the scaled scores, (B, H, Sq) f32 (+inf where a row sees
    no key).  ``block_q``/``block_kv`` tile the bf16 kernel; the f32 kernel
    runs the tiles of :func:`plan_attention_f32` (64-row q blocks, ring
    stages of 64 keys, 32 past a padded head dim of 128).  ``window`` > 0
    hides key j from query i unless i - j < window."""
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if q.device.type in ref.PLAIN_DEVICES:
        return attention_plain(q, k, v, block_q=block_q, block_kv=block_kv,
                               causal=causal, scale=scale,
                               return_lse=return_lse, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch_cuda(q, k, v, block_q=block_q, block_kv=block_kv,
                        causal=causal, scale=scale, return_lse=return_lse,
                        window=window)


flash_attention_kernel.launches = 0


def attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = False,
                        scale: Optional[float] = None, window: int = 0):
    """The plain version of the backward: ``ref.attention_bwd_ref``, one kv
    head's GQA group at a time."""
    return _by_kv_head(
        lambda q_, k_, v_, o_, lse_, do_: ref.attention_bwd_ref(
            q_, k_, v_, o_, lse_, do_, causal=causal, scale=scale,
            window=window),
        q, k, v, o, lse, do)


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor, *,
                               causal: bool = False,
                               scale: Optional[float] = None,
                               window: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_kernel` at q, k, v, its o and
    lse, and the output gradient do, each in its input's dtype, under the
    same causal mask and ``window``."""
    if window < 0:
        raise ValueError(f"flash_attention_bwd: window {window} < 0")
    if q.device.type in ref.PLAIN_DEVICES:
        return attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                   scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    return _launch_bwd_cuda(q, k, v, o, lse, do, causal=causal, scale=scale,
                            window=window)


flash_attention_bwd_kernel.launches = 0


def check_head_dim(d: int) -> None:
    """Raise unless the kernels take head dim ``d``."""
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head_dim {d} is not taken by the kernels "
            f"(a multiple of {HEAD_DIM_ALIGN} up to {MAX_HEAD_DIM})")


def _check_qkv(q, k, v, what="flash_attention"):
    """Shapes, head dim, dtype, device and unit d strides of q, k, v."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(B,H,Sq,d) / (B,Hkv,Skv,d)")
    B, H, Sq, d = q.shape
    _, Hkv, Skv, dk = k.shape
    if k.shape[0] != B or dk != d or H % Hkv:
        raise ValueError(f"{what}: incompatible q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)}")
    check_head_dim(d)
    if q.dtype not in DTYPES:
        raise ValueError(f"{what}: q is {q.dtype}; the kernels take bf16 "
                         f"or f32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{what}: q, k, v on different devices")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a unit stride on the "
                             f"head dim")


def check_tma_operands(what: str, **tensors: torch.Tensor) -> None:
    """Raise unless TMA (bf16) or cp.async (f32) can read each tensor in
    place: a 16-byte aligned base and 16-byte multiples (8 bf16, 4 f32)
    for the strides of its first three dims.  Nothing is padded or copied
    to make it so."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(s < 0 or s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"{what}: {name} strides {t.stride()} not "
                             f"aligned for the kernel")


def _launch_bwd_cuda(q, k, v, o, lse, do, *, causal, scale, window=0):
    """The backward's three kernels (delta, dK/dV, dQ) in one call, on the
    route, tiles and grids of :func:`plan_attention_bwd`."""
    _check_qkv(q, k, v, "flash_attention_bwd")
    B, H, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} "
                         f"{o.dtype}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    # Autograd may hand an expanded or cast output gradient (a stride-0
    # broadcast of a sum's gradient): that one is made a dense copy.
    if do.dtype != q.dtype or do.stride(-1) != 1:
        do = do.to(q.dtype).contiguous()
    lse = lse.contiguous()
    for t in (o, do, lse):
        if t.device != q.device:
            raise ValueError("flash_attention_bwd: operands on different "
                             "devices")
    if o.stride(-1) != 1:
        raise ValueError("flash_attention_bwd: o needs a unit stride on "
                         "the head dim")
    f32 = q.dtype == torch.float32
    # TMA (bf16) and cp.async (f32) read q, k, v and dO in place.
    check_tma_operands("flash_attention_bwd", q=q, k=k, v=v, do=do)
    plan = plan_attention_bwd(Sq, Skv, d, batch=B, heads=H, kv_heads=Hkv,
                              in_dtype="float32" if f32 else "bfloat16")
    scale = scale if scale is not None else d ** -0.5
    dq = torch.empty((B, H, Sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Skv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    # delta and lse2 = lse log2(e), plan.sq_pad rows a head; in f32 under
    # GQA each q head's dK and dV, which a group-sum kernel adds up.
    scratch = torch.empty((2, B, H, plan.sq_pad),
                          dtype=torch.float32, device=q.device)
    part = torch.empty((2, B, H, Skv, d), dtype=torch.float32,
                       device=q.device) if f32 and H > Hkv else None
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 15 \
            + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 5 \
            + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), scratch[0].data_ptr(),
                  scratch[1].data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  part.data_ptr() if part is not None else None,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *o.stride()[:3], *do.stride()[:3], B, H, Hkv, Sq, Skv,
                  Skv, int(causal), int(window), float(scale), d, int(f32),
                  plan.kv_block, plan.q_block, plan.sq_pad, plan.kv_ctas,
                  plan.q_ctas, plan.kv_smem, plan.q_smem,
                  torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, f"flash_attention_bwd {q.dtype} q{tuple(q.shape)} "
                           f"k{tuple(k.shape)} window {window} plan {plan}")
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


def _launch_cuda(q, k, v, *, block_q, block_kv, causal, scale,
                 return_lse=False, window=0):
    _check_qkv(q, k, v)
    B, H, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    if block_q not in BLOCK_MENU or block_kv not in BLOCK_MENU:
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_kv}) "
                         f"not in {BLOCK_MENU}")
    f32 = q.dtype == torch.float32
    if not f32 and not legal_blocks(block_q, block_kv, d):
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_kv}) "
                         f"exceed the kernel's budgets at head_dim {d}")
    # TMA (bf16) and cp.async (f32) read q, k and v in place (v may be a
    # transposed view).
    check_tma_operands("flash_attention", q=q, k=k, v=v)
    # Output laid out (B, Sq, H, d): the model's head merge is then a view.
    out = torch.empty((B, Sq, H, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    scale = scale if scale is not None else d ** -0.5

    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_f32 if f32 else lib.repro_flash_attention
    if fn.argtypes is None:
        # B, H, Hkv, Sq, Skv, kv_len, causal, window, scale, then
        # bf16: block_q, block_kv, d; f32: d, q_rows, kv_rows, ctas, smem.
        mid = [ctypes.c_int] * 8 + [ctypes.c_float]
        tail = ([ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 if f32
                else [ctypes.c_int] * 3)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12 \
            + mid + tail + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    if f32:
        plan = plan_attention_f32(Sq, d, batch=B, heads=H)
        tiles = (d, plan.q_block, plan.kv_block, plan.ctas, plan.smem)
        what = f"plan {plan} window {window}"
    else:
        tiles = (block_q, block_kv, d)
        what = f"blocks ({block_q}, {block_kv}) window {window}"
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if lse is not None else None,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], B, H, Hkv, Sq, Skv, Skv, int(causal),
                  int(window), float(scale), *tiles,
                  torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, f"flash_attention {q.dtype} q{tuple(q.shape)} "
                           f"k{tuple(k.shape)} {what}")
    flash_attention_kernel.launches += 1
    return (out, lse) if return_lse else out
