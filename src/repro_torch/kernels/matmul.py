"""Selector-tiled fused GEMM, dense and grouped: the wrappers over
``csrc/matmul.cu``.

Replaces ``repro/kernels/matmul.py::matmul_pallas`` (:func:`tiled_matmul`)
and ``repro/kernels/ops.py::expert_matmul``, the reference's ``jax.vmap`` of
it over experts (:func:`tiled_expert_matmul`: one launch, the expert axis in
the grid).  The CUDA kernel runs the selected
:class:`~repro_torch.core.latency.TileConfig` as given, per expert: bm x bn
output tile per CTA, bk-deep staged K steps, the group_m row swizzle, and
the fused epilogue in the flush.  ``split_k`` and the ``stream_k`` schedule
lower to one in-CTA loop over the whole of K with a single flush, as the
TPU kernel lowers both onto its sequential grid (same sum, same result).
The source note in ``csrc/matmul.cu`` says what bounds the kernel on the
H100 and what its design does about it.

:func:`tiled_matmul` takes the route from the device of its operands: a CPU
tensor gets the plain version (``ref.matmul_ref``), a CUDA tensor the
kernel, and anything else raises; :func:`tiled_expert_matmul` likewise.
``tiled_matmul.launches`` and ``tiled_expert_matmul.launches`` count each
wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.latency import EPILOGUE_NONE, Epilogue, TileConfig
from repro_torch.kernels import build, ref

_TILES = (32, 64, 128, 256)
_ACT_CODES = {None: 0, "gelu": 1, "silu": 2, "swiglu_gate": 3}
_DTYPES = (torch.bfloat16, torch.float32)


def matmul_plain(a, b, cfg: TileConfig, *, out_dtype, epilogue=None,
                 bias=None, gate=None, residual=None) -> torch.Tensor:
    """The plain version: what the kernel computes, whatever the tiling."""
    return ref.matmul_ref(a, b, out_dtype, epilogue=epilogue, bias=bias,
                          gate=gate, residual=residual)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, cfg: TileConfig, *,
                 out_dtype: torch.dtype,
                 epilogue: Optional[Epilogue] = None,
                 bias: Optional[torch.Tensor] = None,
                 gate: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = epilogue(a @ b) for a (M, K), b (K, N); bias (N,),
    gate/residual (M, N)."""
    if a.device.type == "cpu":
        return matmul_plain(a, b, cfg, out_dtype=out_dtype,
                            epilogue=epilogue, bias=bias, gate=gate,
                            residual=residual)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul: unsupported device {a.device}")
    return _launch_cuda(a, b, cfg, out_dtype=out_dtype, epilogue=epilogue,
                        bias=bias, gate=gate, residual=residual)


tiled_matmul.launches = 0


def expert_matmul_plain(x, w, cfg: TileConfig, *, out_dtype, epilogue=None,
                        bias=None, gate=None,
                        residual=None) -> torch.Tensor:
    """The plain version of the grouped kernel, as the reference's
    ``expert_matmul`` (``repro/kernels/ops.py:333-339``): an f32-accumulated
    per-expert product, then the epilogue with bias broadcast over rows."""
    ep = epilogue or EPILOGUE_NONE
    acc = torch.einsum("emk,ekn->emn", x.float(), w.float())
    acc = ref.apply_epilogue_ref(
        acc, ep, bias=bias[:, None, :] if bias is not None else None,
        gate=gate, residual=residual)
    return acc.to(out_dtype)


def tiled_expert_matmul(x: torch.Tensor, w: torch.Tensor, cfg: TileConfig,
                        *, out_dtype: torch.dtype,
                        epilogue: Optional[Epilogue] = None,
                        bias: Optional[torch.Tensor] = None,
                        gate: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """out[e] = epilogue(x[e] @ w[e]) for x (E, M, K), w (E, K, N); bias
    (E, N), gate/residual (E, M, N).  One launch for all E experts."""
    if x.device.type == "cpu":
        return expert_matmul_plain(x, w, cfg, out_dtype=out_dtype,
                                   epilogue=epilogue, bias=bias, gate=gate,
                                   residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"tiled_expert_matmul: unsupported device "
                         f"{x.device}")
    return _launch_expert_cuda(x, w, cfg, out_dtype=out_dtype,
                               epilogue=epilogue, bias=bias, gate=gate,
                               residual=residual)


tiled_expert_matmul.launches = 0


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % n
    return F.pad(x, (0, pad)) if pad else x


def _launch_cuda(a, b, cfg, *, out_dtype, epilogue, bias, gate, residual):
    """The dense launch: the grouped kernel with one group."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"tiled_matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} are not (M, K) @ (K, N)")
    out = _launch_groups(
        "tiled_matmul", a[None], b[None], cfg, out_dtype=out_dtype,
        epilogue=epilogue, bias=None if bias is None else bias[None],
        gate=None if gate is None else gate[None],
        residual=None if residual is None else residual[None])
    tiled_matmul.launches += 1
    return out[0]


def _launch_expert_cuda(x, w, cfg, *, out_dtype, epilogue, bias, gate,
                        residual):
    out = _launch_groups("tiled_expert_matmul", x, w, cfg,
                         out_dtype=out_dtype, epilogue=epilogue, bias=bias,
                         gate=gate, residual=residual)
    tiled_expert_matmul.launches += 1
    return out


def _launch_groups(what, a, b, cfg, *, out_dtype, epilogue, bias, gate,
                   residual):
    """Check and launch ``csrc/matmul.cu`` on G problems of one shape: a
    (G, M, K), b (G, K, N), bias (G, N), gate/residual (G, M, N)."""
    ep = epilogue or EPILOGUE_NONE
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} are not (G, M, K) @ (G, K, N)")
    G, M, K = a.shape
    N = b.shape[2]
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"{what}: inputs must both be bf16 or f32, "
                         f"got {a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"{what}: out_dtype {out_dtype} not in {_DTYPES}")
    if cfg.bm not in _TILES or cfg.bn not in _TILES or cfg.bk % 16 \
            or cfg.bk <= 0 or cfg.group_m < 1:
        raise ValueError(f"{what}: config {cfg} outside the kernel's "
                         f"menu (bm, bn in {_TILES}; bk a multiple of 16)")
    ops = {"bias": bias, "gate": gate, "residual": residual}
    want = {"bias": ep.bias, "gate": ep.activation == "swiglu_gate",
            "residual": ep.residual}
    for name, t in ops.items():
        if want[name] != (t is not None):
            raise ValueError(f"{what}: epilogue {ep} vs {name} "
                             f"operand {'missing' if t is None else 'given'}")
    ep_dtype = next((t.dtype for t in ops.values() if t is not None), a.dtype)
    for name, t in ops.items():
        if t is None:
            continue
        shape = (G, N) if name == "bias" else (G, M, N)
        if tuple(t.shape) != shape or t.dtype != ep_dtype \
                or t.dtype not in _DTYPES:
            raise ValueError(f"{what}: {name} must be {shape} in one "
                             f"dtype of {_DTYPES}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for t in (b, *ops.values()):
        if t is not None and t.device != a.device:
            raise ValueError(f"{what}: operands on different devices")
    for name, t in (("a", a), ("b", b), *ops.items()):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")

    # 16-byte loads need K and N to be multiples of 8 elements (4 for f32);
    # pad with zeros where they are not (never on the served paths).
    vec = 4 if a.dtype == torch.float32 else 8
    Kp, Np = K + (-K) % vec, N + (-N) % vec
    if Kp != K:
        a = _pad_last(a, vec)
        b = F.pad(b, (0, 0, 0, Kp - K))
    if Np != N:
        b = _pad_last(b, vec)
        ops = {k: (_pad_last(t, vec).contiguous() if t is not None else None)
               for k, t in ops.items()}
    for t in (a, b):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operand not 16-byte aligned")
    out = torch.empty((G, M, Np), dtype=out_dtype, device=a.device)

    lib = build.load("matmul")
    fn = lib.repro_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 \
            + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def ptr(t):
        return t.data_ptr() if t is not None else None

    def stride(t):
        return t.stride(0) if t is not None and G > 1 else 0

    with torch.cuda.device(a.device):
        code = fn(ptr(a), ptr(b), ptr(out), ptr(ops["bias"]),
                  ptr(ops["gate"]), ptr(ops["residual"]),
                  M, Np, Kp, cfg.bm, cfg.bn, cfg.bk, cfg.group_m,
                  int(a.dtype == torch.float32),
                  int(out_dtype == torch.float32),
                  int(ep_dtype == torch.float32),
                  int(ep.bias), _ACT_CODES[ep.activation], int(ep.residual),
                  G, stride(a), stride(b), stride(out), stride(ops["bias"]),
                  stride(ops["gate"]), stride(ops["residual"]),
                  torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, code, f"{what} {G}x{M}x{N}x{K} {cfg}")
    return out[..., :N] if Np != N else out
