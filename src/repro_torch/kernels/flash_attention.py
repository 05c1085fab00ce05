"""Flash attention on Hopper: the wrapper over ``csrc/flash_attention.cu`` and
the port's own (block_q, block_kv) selector.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.  The
kernel computes online-softmax attention for q (B, H, Sq, d) against k/v
(B, Hkv, Skv, d) with GQA by index (no KV repeat), the causal block skip,
the ``k < kv_len`` padding mask and f32 m/l/acc with the TPU kernel's -inf
guards; the source note in ``csrc/flash_attention.cu`` says what bounds it
on the H100 and what its design does about that.

:func:`flash_attention_kernel` takes the route from the device of q: a CPU
tensor gets the plain version (``ref.attention_ref``), a CUDA tensor the
kernel, and anything else raises.  ``flash_attention_kernel.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.dtypes import DTYPE_BYTES
from repro_torch.core.hardware import GPU_H100_LIKE
from repro_torch.core.latency import cdiv
from repro_torch.core.topology import HardwareSpec
from repro_torch.kernels import build, ref

BLOCK_MENU = (64, 128)
HEAD_DIMS = (128,)                 # instantiated in csrc/flash_attention.cu
_SMEM_BYTES = 227 * 1024           # opt-in dynamic shared memory per block
_MAX_REGS = 255                    # per thread
_REG_OVERHEAD = 40                 # addresses, loop state, softmax scalars


def _smem_bytes(block_kv: int, head_dim: int, bi: int) -> int:
    """The kernel's shared memory: one K tile (row-major) and one V tile
    (transposed), each row padded by 8 elements."""
    return (block_kv * (head_dim + 8) + head_dim * (block_kv + 8)) * bi


def _regs_per_thread(block_kv: int, head_dim: int) -> int:
    """Scores (16 x block_kv), output (16 x d) in f32 and Q fragments
    (16 x d bf16), spread over a warp, plus fixed overhead."""
    return block_kv // 2 + head_dim // 2 + head_dim // 8 + _REG_OVERHEAD


def select_attention_blocks(
    s_q: int,
    s_kv: int,
    head_dim: int,
    *,
    in_dtype: str = "bfloat16",
    hw: HardwareSpec = GPU_H100_LIKE,
    causal: bool = False,
) -> Tuple[int, int]:
    """Analytical (block_q, block_kv) for the Hopper kernel: the reference
    selector's score, steps * max(compute, memory) per (bq, bkv) step,
    priced against what bounds this kernel instead of VMEM.

    Per step: FLOPs 4·bq·bkv·d (QKᵀ and PV) at the tensor-core rate, and
    the K and V tiles (2·bkv·d bytes) from HBM.  Legal when the staged K/V
    tiles fit 227 KB of shared memory and the scores, output and Q
    fragments, held in registers, fit 255 registers a thread.  The menu
    starts at 64 (the TPU menu's 128 floor is a lane-width rule), and
    (64, 64) is legal for every d up to 256, so a pair always exists."""
    bi = DTYPE_BYTES[in_dtype]
    flops = hw.flops(in_dtype)
    best, best_key = None, None
    for bq in BLOCK_MENU:
        if bq > 2 * max(s_q, BLOCK_MENU[0]):
            continue
        for bkv in BLOCK_MENU:
            if bkv > 2 * max(s_kv, BLOCK_MENU[0]):
                continue
            if _smem_bytes(bkv, head_dim, bi) > _SMEM_BYTES \
                    or _regs_per_thread(bkv, head_dim) > _MAX_REGS:
                continue
            steps = cdiv(s_q, bq) * cdiv(s_kv, bkv)
            if causal:
                steps = max(1, steps // 2)        # half the blocks skipped
            comp = 4.0 * bq * bkv * head_dim / flops
            mem = 2.0 * bkv * head_dim * bi / hw.hbm_bandwidth + hw.dma_fixed
            key = (steps * max(comp, mem), -(bq * bkv))
            if best_key is None or key < best_key:
                best, best_key = (bq, bkv), key
    if best is None:
        raise ValueError(f"no legal attention blocks for head_dim "
                         f"{head_dim} ({in_dtype})")
    return best


def attention_plain(q, k, v, *, block_q: int, block_kv: int,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: what the kernel computes, whatever the blocks."""
    return ref.attention_ref(q, k, v, causal=causal, scale=scale)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, block_q: int, block_kv: int,
                           causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, H, Sq, d) over k/v (B, Hkv, Skv, d); returns
    (B, H, Sq, d) in q's dtype."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, block_q=block_q, block_kv=block_kv,
                               causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch_cuda(q, k, v, block_q=block_q, block_kv=block_kv,
                        causal=causal, scale=scale)


flash_attention_kernel.launches = 0


def _launch_cuda(q, k, v, *, block_q, block_kv, causal, scale):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(B,H,Sq,d) / (B,Hkv,Skv,d)")
    B, H, Sq, d = q.shape
    _, Hkv, Skv, dk = k.shape
    if k.shape[0] != B or dk != d or H % Hkv:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if block_q not in BLOCK_MENU or block_kv not in BLOCK_MENU:
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_kv}) "
                         f"not in {BLOCK_MENU}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bf16, got "
                             f"{t.dtype}")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a unit stride "
                             f"on the head dim")
    # k/v rows are read as 16-byte vectors, q and o as 4-byte pairs.
    for name, t, align in (("q", q, 2), ("k", k, 8), ("v", v, 8)):
        if t.data_ptr() % 16 or any(s % align for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} strides "
                             f"{t.stride()} not aligned for the kernel")
    # Output laid out (B, Sq, H, d): the model's head merge is then a view.
    out = torch.empty((B, Sq, H, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    scale = scale if scale is not None else d ** -0.5

    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 \
            + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], B, H, Hkv, Sq, Skv, Skv, int(causal),
                  float(scale), block_q, block_kv, d,
                  torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, f"flash_attention q{tuple(q.shape)} "
                           f"k{tuple(k.shape)} blocks ({block_q}, {block_kv})")
    flash_attention_kernel.launches += 1
    return out
