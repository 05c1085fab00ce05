"""Calibration probe kernels: the wrappers over ``csrc/probes.cu``.

Replace the three jitted XLA loops of ``repro/calib/device.py::JaxDevice``
(``stream_time``, ``compute_time``, ``wave_time``).  Each of those is one
device program per call; here each is one kernel launch whose loop runs on
the card, so a sweep times the card and not the host's launch rate:

* :func:`stream_read` — ``n_chunks`` fetches walking one ``window``-byte
  f32 working set cyclically, one CTA per SM;
* :func:`mma_chain` — ``n_atoms`` macro-atoms (64 x 64 x 16) of back-to-back
  wgmma on resident operands, spread over ``n_parallel`` CTAs of
  :data:`CHAINS_PER_CTA` independent chains;
* :func:`wave_grid` — ``n_units`` CTAs of one chain of ``unit_atoms`` atoms,
  each holding a whole SM, so that the units run in waves.

Each wrapper returns a checksum (int64) of what its kernel read or
accumulated, and takes the route from its operands' device: a CPU tensor
gets the plain version beside it (the same work in PyTorch, the same
checksum), a CUDA tensor the kernel, anything else raises.  The counts
``stream_read.launches``, ``mma_chain.launches`` and ``wave_grid.launches``
go up by one per kernel launch.

Each kernel writes its sums (one a CTA for the stream, one a chain for the
others) with plain stores, so no output needs zeroing.  A timed call
(``calib/device.py::TorchDevice``) passes ``out``, a buffer it owns: the
call then enqueues the probe's one launch and nothing else (no fill, no
allocation, no reduction), the same fixed work for every probe, since the
fit subtracts the wave sweep's intercept from the latency sweep's.  On the
card ``stream_read`` then returns the CTAs' sums, whose total is the
checksum; without ``out`` it allocates them and returns the total.

The stream's work departs from ``JaxDevice``'s in two ways, both so that
the sweep moves what ``core/simulator.py::simulate_stream`` prices:
``nbytes`` in all, each byte read again one window later.  A fetch larger
than the window wraps around it (``JaxDevice`` clamps a fetch to the
window, which moves only ``n_chunks x window`` bytes once ``nbytes``
outgrows them), and fetch i starts at ``(i chunk) % elems``, one cyclic
walk (``JaxDevice`` starts it at ``(i chunk) % (elems - chunk + 1)``, the
same for one-vector fetches, but a fetch that is a large part of the
window then re-reads most of the one before, which the L2 serves).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.matmul import _sm_count

STREAM_THREADS = 1024       # threads of a stream CTA (csrc/probes.cu)
VEC_BYTES = 16              # a stream fetch reads 16-byte vectors of 4 f32
CHAINS_PER_CTA = 4          # wgmma chains (warpgroups) of a compute CTA
ATOM_K = 16                 # the macro-atom's depth: mxu_shape (64, 64, 16)
ROW_BYTES = 128             # an operand row: four 32-byte K slices
# both operands, 1024-byte aligned, and the warps' int64 sums after them
MMA_SMEM = 2 * 64 * ROW_BYTES + 1024 + 16 * 8
WAVE_SMEM = 120 * 1024      # > half an SM's 228 KB: one wave CTA an SM
STREAM_SLOTS_MAX = 1024     # the stream grid's CTAs (one an SM) at most

# dtype name (the topology's peak_flops keys) -> (kernel code, torch dtype
# of the operands, K of one instruction: 32 bytes of the operand type).
# "float32" is the tensor cores' tf32 path.
PROBE_DTYPES = {
    "bfloat16": (0, torch.bfloat16, 16),
    "float16": (1, torch.float16, 16),
    "float32": (2, torch.float32, 8),
    "float8_e4m3fn": (3, torch.float8_e4m3fn, 32),
    "int8": (4, torch.int8, 32),
}
_BY_TORCH = {v[1]: k for k, v in PROBE_DTYPES.items()}


# ---------------------------------------------------------------------------
# stream_read
# ---------------------------------------------------------------------------

def stream_geometry(nbytes: float, window: int,
                    n_chunks: int) -> Tuple[int, int, int]:
    """(vectors in the window, vectors a fetch, fetches): fetch i reads
    vectors (i chunk + j) % elems for j < chunk."""
    elems = max(int(window) // VEC_BYTES, 1)
    chunks = max(int(n_chunks), 1)
    chunk = max(int(nbytes / VEC_BYTES) // chunks, 1)
    return elems, chunk, chunks


def stream_groups(chunk: int, ctas: int) -> Tuple[int, int]:
    """(CTAs a fetch, groups): as many CTAs share a fetch as give each of
    their threads at least one vector, at most the grid; the grid's groups
    take the fetches in turn."""
    per = min(ctas, max(1, -(-chunk // STREAM_THREADS)))
    return per, ctas // per


def stream_data(window: int, device) -> torch.Tensor:
    """The working set: f32 x[e] = e % 13, integers, so every sum the probe
    takes is exact."""
    n = max(int(window) // VEC_BYTES, 1) * 4
    return (torch.arange(n, device=device) % 13).to(torch.float32)


def stream_read_plain(x: torch.Tensor, nbytes: float, window: int,
                      n_chunks: int) -> torch.Tensor:
    """The plain version: every fetch gathered and summed, in order."""
    elems, chunk, chunks = stream_geometry(nbytes, window, n_chunks)
    vec = x[:elems * 4].view(elems, 4).to(torch.int64).sum(1)
    offs = torch.arange(chunk, device=x.device)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(chunks):
        total += vec[(i * chunk + offs) % elems].sum()
    return total


def stream_read(x: torch.Tensor, nbytes: float, window: int,
                n_chunks: int, *, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Checksum (0-d int64) of ``n_chunks`` fetches moving ``nbytes`` in
    all through the first ``window`` bytes of ``x`` (from
    :func:`stream_data`).  The kernel's per-thread f32 sums, and so the
    checksum, are exact while a thread reads fewer than 2^24 / 12 vectors
    (``ceil(n_chunks / groups) * ceil(chunk / (1024 * CTAs a fetch))``,
    :func:`stream_groups`).  With ``out`` (int64, at least one element an
    SM; the card only) the kernel writes its CTAs' sums into its first
    slots and ``out`` is returned, with nothing else enqueued."""
    elems, chunk, chunks = stream_geometry(nbytes, window, n_chunks)
    if x.dtype != torch.float32 or x.dim() != 1 or x.numel() < elems * 4:
        raise ValueError(f"stream_read: x must be 1-D f32 with at least "
                         f"{elems * 4} elements, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if _route(x, "stream_read") == "plain":
        return stream_read_plain(x, nbytes, window, n_chunks)
    ctas = _sm_count(x.device.index)
    if not x.is_contiguous() or x.data_ptr() % VEC_BYTES:
        raise ValueError("stream_read: x must be contiguous and 16-byte "
                         "aligned")
    if chunk + ctas * STREAM_THREADS >= 2**31:
        raise ValueError(f"stream_read: a fetch of {chunk} vectors is too "
                         f"large (raise n_chunks)")
    per, groups = stream_groups(chunk, ctas)
    if per * groups > STREAM_SLOTS_MAX:
        raise ValueError(f"stream_read: {per * groups} CTAs exceed "
                         f"{STREAM_SLOTS_MAX} result slots")
    parts = _out_slots("stream_read", out, per * groups, x.device)
    _run("repro_probe_stream", x.device,
         f"stream_read {nbytes:g} B / {window} B window / {chunks} fetches",
         x.data_ptr(), elems, chunk, chunks, per * groups, per,
         parts.data_ptr())
    stream_read.launches += 1
    return parts if out is not None else parts.sum()


stream_read.launches = 0


# ---------------------------------------------------------------------------
# mma_chain and wave_grid
# ---------------------------------------------------------------------------

def mma_operands(dtype: str, device,
                 generator: torch.Generator) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Resident operands A and B: 64 rows of 128 bytes (four instructions'
    K) in ``dtype``, drawn from ``generator``: integers in [0, 3], or in
    [0, 1] for fp8, whose tensor-core sums keep only about 14 bits (small
    operands keep a chain's sums below 2^14, so its checksum stays exact)."""
    _, tdt, k = PROBE_DTYPES[dtype]
    cols = 4 * k
    high = 2 if dtype == "float8_e4m3fn" else 4
    a, b = (torch.randint(0, high, (64, cols), generator=generator,
                          device=device) for _ in range(2))
    return a.float().to(tdt), b.float().to(tdt)


def instructions(dtype: str, atoms: int) -> int:
    """wgmma instructions for ``atoms`` macro-atoms of depth 16: two an atom
    for tf32 (k 8), one for bf16/f16, one per two atoms for fp8/int8 (k 32),
    rounded up to whole instructions."""
    k = PROBE_DTYPES[dtype][2]
    return -(-int(atoms) * ATOM_K // k)


def _chains_plain(a: torch.Tensor, b: torch.Tensor, base: int, extra: int,
                  chains: int) -> torch.Tensor:
    """Chain c runs base + (c < extra) instructions, instruction i on K
    slice i % 4: its 64 x 64 accumulator grows by A_s B_s^T each step.
    Returns each chain's accumulator sum (int64).  Host integers only, so a
    CUDA graph can capture it."""
    k = PROBE_DTYPES[_BY_TORCH[a.dtype]][2]
    # f32 as the kernel accumulates (exact below 2^24); int8 accumulates in
    # s32 on the card, so f64 here (integer matmul has no CUDA kernel).
    acc_dt = torch.float64 if a.dtype == torch.int8 else torch.float32
    A, B = a.to(acc_dt), b.to(acc_dt)
    slices = [A[:, s * k:(s + 1) * k] @ B[:, s * k:(s + 1) * k].T
              for s in range(4)]
    counts = base + (torch.arange(chains, device=a.device) < extra).long()
    acc = torch.zeros((chains, 64, 64), dtype=acc_dt, device=a.device)
    for i in range(base + (extra > 0)):
        live = (i < counts).to(acc_dt)[:, None, None]
        acc += live * slices[i % 4]
    return acc.to(torch.int64).sum((1, 2))


def _check_operands(what: str, a: torch.Tensor, b: torch.Tensor) -> str:
    dtype = _BY_TORCH.get(a.dtype)
    if dtype is None or b.dtype != a.dtype:
        raise ValueError(f"{what}: operands must share one dtype of "
                         f"{sorted(str(t) for t in _BY_TORCH)}, got "
                         f"{a.dtype} and {b.dtype}")
    shape = (64, 4 * PROBE_DTYPES[dtype][2])
    if tuple(a.shape) != shape or tuple(b.shape) != shape:
        raise ValueError(f"{what}: operands must be {shape} "
                         f"(64 rows of {ROW_BYTES} bytes), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"{what}: operands on different devices")
    return dtype


def _route(t: torch.Tensor, what: str) -> str:
    """"plain" for a CPU tensor, "kernel" for a CUDA one; raises for any
    other device."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return "kernel"


def _out_slots(what: str, out: Optional[torch.Tensor], n: int,
               device) -> torch.Tensor:
    """The kernel's n int64 result slots: the first n of the caller's
    ``out`` (returned whole) or, without one, a new tensor (no fill: the
    kernel writes every slot)."""
    if out is None:
        return torch.empty(n, dtype=torch.int64, device=device)
    if out.dtype != torch.int64 or out.dim() != 1 or out.numel() < n \
            or out.device != device or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous int64 vector of "
                         f"at least {n} elements on {device}")
    return out


def _run(fn_name: str, device, what: str, *args) -> None:
    """Call the C entry ``fn_name`` of ``csrc/probes.cu`` on ``device``'s
    current stream and raise on its error code."""
    lib = _lib()
    stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device):
        code = getattr(lib, fn_name)(*args, stream.cuda_stream)
    build.check(lib, code, what)


def _launch_chains(what, a, b, dtype, base, extra, ctas, chains, smem, out):
    for t in (a, b):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             f"16-byte aligned")
    sums = _out_slots(what, out, ctas * chains, a.device)
    _run("repro_probe_mma", a.device, f"{what} {dtype} {ctas} x {chains} "
         f"chains", PROBE_DTYPES[dtype][0], a.data_ptr(), b.data_ptr(), base,
         extra, ctas, chains, smem, sums.data_ptr())
    return sums


def mma_chain_plain(a, b, n_atoms: int, n_parallel: int) -> torch.Tensor:
    chains = max(int(n_parallel), 1) * CHAINS_PER_CTA
    base, extra = divmod(instructions(_BY_TORCH[a.dtype], n_atoms), chains)
    return _chains_plain(a, b, base, extra, chains)


def mma_chain(a: torch.Tensor, b: torch.Tensor, n_atoms: int,
              n_parallel: int, *,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Checksums (int64, one a chain) of ``n_atoms`` macro-atoms on the
    resident operands ``a``, ``b`` (from :func:`mma_operands`), split over
    ``n_parallel`` CTAs of :data:`CHAINS_PER_CTA` chains: chain c runs
    I // chains + (c < I % chains) of the I instructions.  ``out`` (card
    only): an int64 buffer whose first slots take them; it is returned."""
    dtype = _check_operands("mma_chain", a, b)
    if _route(a, "mma_chain") == "plain":
        return mma_chain_plain(a, b, n_atoms, n_parallel)
    ctas = max(int(n_parallel), 1)
    base, extra = divmod(instructions(dtype, n_atoms), ctas * CHAINS_PER_CTA)
    sums = _launch_chains("mma_chain", a, b, dtype, base, extra, ctas,
                          CHAINS_PER_CTA, MMA_SMEM, out)
    mma_chain.launches += 1
    return sums


mma_chain.launches = 0


def wave_grid_plain(a, b, n_units: int, unit_atoms: int) -> torch.Tensor:
    return _chains_plain(a, b, instructions(_BY_TORCH[a.dtype], unit_atoms),
                         0, max(int(n_units), 1))


def wave_grid(a: torch.Tensor, b: torch.Tensor, n_units: int,
              unit_atoms: int, *,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Checksums (int64, one a unit) of ``n_units`` CTAs, each one chain of
    ``unit_atoms`` macro-atoms with :data:`WAVE_SMEM` of shared memory, so
    that a CTA holds a whole SM.  ``out`` as for :func:`mma_chain`."""
    dtype = _check_operands("wave_grid", a, b)
    if _route(a, "wave_grid") == "plain":
        return wave_grid_plain(a, b, n_units, unit_atoms)
    sums = _launch_chains("wave_grid", a, b, dtype,
                          instructions(dtype, unit_atoms), 0,
                          max(int(n_units), 1), 1, WAVE_SMEM, out)
    wave_grid.launches += 1
    return sums


wave_grid.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("probes")
    if lib.repro_probe_stream.argtypes is None:
        lib.repro_probe_stream.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.repro_probe_stream.restype = ctypes.c_int
        lib.repro_probe_mma.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.repro_probe_mma.restype = ctypes.c_int
    return lib
