// Calibration probe kernels, hand-written for Hopper (sm_90a): the device
// side of repro_torch.calib.device.TorchDevice.
//
// Replaces the three jitted XLA loops of src/repro/calib/device.py::JaxDevice
// (stream_time :144-170, compute_time :181-206, wave_time :208-225).  Those
// are one device program per call; a PyTorch loop would launch one kernel per
// chunk or per atom and time the host's launch rate instead of the card.  So
// each probe is one launch whose loop runs on the device:
//
//  * probe_stream: n_chunks fetches of chunk 16-byte vectors walk one window
//    of f32 data cyclically: fetch i starts at vector (i chunk) % elems and
//    wraps at the window's end, so every byte is read again one window
//    later.  Groups of CTAs (one CTA per SM in all) take the fetches in
//    turn, a group as many CTAs as give each thread at least one vector of a
//    fetch: the bandwidth sweeps' fetches span the whole grid (neighbouring
//    threads on neighbouring vectors), the issue sweep's one-vector fetches
//    go one to a CTA.  Each fetch is one iteration of the group's device
//    loop.  A window larger than an SM's shared memory is read through the
//    L2 only (ld.global.cg): split over the grid, an SM revisits a small
//    part of such a window, which its L1 would otherwise serve.  Bound by
//    the bytes of the level that holds the window (L1 for the smem window,
//    L2, HBM); at one vector a fetch by the loop iteration each fetch
//    costs, spread over the CTAs.  Every load is folded into per-thread f32
//    sums, reduced to one int64 a CTA, so nothing is hoisted or dropped.
//  * probe_mma: chains of back-to-back wgmma on resident operands.  One
//    64 x 64 x (32 bytes of K) instruction per step, both operands K-major in
//    shared memory (128-byte swizzle), the accumulators in registers; the
//    step cycles through the four 32-byte K slices of the 128-byte operand
//    rows.  A warpgroup is one chain; a CTA holds 1-4 chains, so several
//    independent chains keep an SM's tensor cores busy.  Bound by the tensor
//    cores' issue rate.  Each chain's accumulators are summed into an int64
//    checksum (exact while every accumulator stays below 2^24).
//  * Both probes end the same way: each CTA (stream) or chain (mma) writes
//    its int64 sum to its own slot with a plain store.  No atomics into a
//    zeroed buffer, so a timed call is the probe's one launch and nothing
//    else: the calibration subtracts the wave sweep's intercept from the
//    latency sweep's, and both must carry the same fixed cost.
//    The compute sweep runs 4 chains a CTA, one CTA per SM; the wave sweep
//    runs one chain a CTA with 120 KB of dynamic shared memory, so that a
//    CTA holds a whole SM and n_units CTAs run in ceil(n_units / SMs) waves.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace repro {

constexpr int kStreamThreads = 1024;
constexpr int kOperandBytes = 64 * 128;  // 64 rows of 128 bytes, swizzled
constexpr int kMaxChains = 4;            // warpgroups a CTA
constexpr int kSumBytes = 4 * kMaxChains * 8;  // the warps' int64 sums
constexpr int kMaxProbeSmem = 232448;

enum ProbeDtype { kBf16 = 0, kF16 = 1, kTf32 = 2, kE4m3 = 3, kS8 = 4 };

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// probe_stream
// ---------------------------------------------------------------------------

template <bool kL2Only>
__global__ void __launch_bounds__(kStreamThreads, 1)
    probe_stream_kernel(const float4* __restrict__ x, int elems, int chunk,
                        long long n_chunks, int group_ctas, long long* out) {
  // CTA group g takes fetches g, g + groups, ...; within the group, thread
  // lt reads vectors lt, lt + group_threads, ... of each fetch.
  const int groups = gridDim.x / group_ctas;
  const int g = blockIdx.x / group_ctas;
  const int lt = (blockIdx.x % group_ctas) * blockDim.x + threadIdx.x;
  const int group_threads = group_ctas * blockDim.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (lt < chunk && g < groups) {
    const int off = lt % elems;
    const int step = group_threads % elems;
    const int adv = static_cast<int>(
        static_cast<long long>(groups) * chunk % elems);
    int start = static_cast<int>(static_cast<long long>(g) * chunk % elems);
    for (long long i = g; i < n_chunks; i += groups) {
      int idx = start + off;
      if (idx >= elems) idx -= elems;
#pragma unroll 4
      for (int j = lt; j < chunk; j += group_threads) {
        const float4 v = kL2Only ? __ldcg(x + idx) : x[idx];
        a0 += v.x;
        a1 += v.y;
        a2 += v.z;
        a3 += v.w;
        idx += step;
        if (idx >= elems) idx -= elems;
      }
      start += adv;
      if (start >= elems) start -= elems;
    }
  }
  // The sums hold integers below 2^24 (the wrapper's data), so the
  // conversion is exact and the checksum does not depend on the order.
  long long s = static_cast<long long>(a0) + static_cast<long long>(a1) +
                static_cast<long long>(a2) + static_cast<long long>(a3);
  __shared__ long long warp_sums[kStreamThreads / 32];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      t += warp_sums[w];
    out[blockIdx.x] = t;
  }
}

// ---------------------------------------------------------------------------
// probe_mma: one wgmma instruction per dtype, 64 x 64 x (32 bytes of K),
// A and B both K-major (scale-d = 1: accumulate).
// ---------------------------------------------------------------------------

#define REPRO_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define REPRO_ACC32(c, d)                                                    \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),    \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),    \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),  \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),  \
      c(d[29]), c(d[30]), c(d[31])

template <int D>
struct Mma;

template <>
struct Mma<kBf16> {
  using Acc = float;
  static __device__ __forceinline__ void step(float (&d)[32], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : REPRO_ACC32("+f", d)
        : "l"(da), "l"(db), "n"(1));
  }
};

template <>
struct Mma<kF16> {
  using Acc = float;
  static __device__ __forceinline__ void step(float (&d)[32], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " REPRO_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : REPRO_ACC32("+f", d)
        : "l"(da), "l"(db), "n"(1));
  }
};

template <>
struct Mma<kTf32> {
  using Acc = float;
  static __device__ __forceinline__ void step(float (&d)[32], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REPRO_D32
        ", %32, %33, p, 1, 1;\n}\n"
        : REPRO_ACC32("+f", d)
        : "l"(da), "l"(db), "n"(1));
  }
};

template <>
struct Mma<kE4m3> {
  using Acc = float;
  static __device__ __forceinline__ void step(float (&d)[32], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 " REPRO_D32
        ", %32, %33, p, 1, 1;\n}\n"
        : REPRO_ACC32("+f", d)
        : "l"(da), "l"(db), "n"(1));
  }
};

template <>
struct Mma<kS8> {
  using Acc = int;
  static __device__ __forceinline__ void step(int (&d)[32], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " REPRO_D32
        ", %32, %33, p;\n}\n"
        : REPRO_ACC32("+r", d)
        : "l"(da), "l"(db), "n"(1));
  }
};

// Pins the accumulators across wgmma's asynchronous writes.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void pin(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Steps of one chain: K slice s of the 128-byte rows starts 32 s bytes in.
template <int D>
__device__ __forceinline__ void mma_step(typename Mma<D>::Acc (&d)[32],
                                         uint32_t sa, uint32_t sb, int s) {
  Mma<D>::step(d, smem_desc(sa + s * 32, 16, 1024, 128),
               smem_desc(sb + s * 32, 16, 1024, 128));
}

// Chain c (warpgroup c % chains of CTA c / chains) runs base + (c < extra)
// instructions, instruction i on K slice i % 4; out[c] += the sum of its
// accumulators.  a and b: 64 rows of 128 bytes each, row-major.
template <int D>
__global__ void __launch_bounds__(128 * kMaxChains, 1)
    probe_mma_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                     long long base, long long extra, long long* out) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle works on 1024-byte aligned groups of 8 rows.
  const uint32_t sa = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sb = sa + kOperandBytes;
  // 16-byte chunk k of row r goes to chunk k ^ (r % 8) of that row.
  constexpr int kChunks = kOperandBytes / 16;
  for (int i = threadIdx.x; i < 2 * kChunks; i += blockDim.x) {
    const int j = i % kChunks;
    const int r = j / 8, k = j % 8;
    st_shared_v4((i < kChunks ? sa : sb) + r * 128 + ((k ^ (r % 8)) * 16),
                 (i < kChunks ? a : b)[j]);
  }
  fence_proxy_async();
  __syncthreads();

  using Acc = typename Mma<D>::Acc;
  // Broadcast from lane 0 so that ptxas sees the chain and its length as
  // warp-uniform (otherwise it serialises every wgmma).
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const long long chain =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 128) + wg;
  const long long n =
      __shfl_sync(0xffffffffu, base + (chain < extra ? 1 : 0), 0);
  // Groups of 8 instructions, one commit group each, the next group issued
  // while the one before runs; the accumulators are zeroed and pinned
  // before the first fence, so no other instruction defines them inside a
  // pipeline stage (which would serialise every wgmma).
  Acc d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = Acc(0);
  pin(d);
  long long i = 0;
  for (; i + 8 <= n; i += 8) {
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 8; ++u) mma_step<D>(d, sa, sb, u % 4);
    wgmma_commit();
    wgmma_wait<1>();
  }
  const int tail = static_cast<int>(n - i);
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < 7; ++u)
    if (u < tail) mma_step<D>(d, sa, sb, u % 4);
  wgmma_commit();
  wgmma_wait<0>();
  pin(d);

  long long s = 0;
#pragma unroll
  for (int r = 0; r < 32; ++r) s += static_cast<long long>(d[r]);
  s = warp_sum(s);
  // The chain's four warp sums, added in warp order by its first thread,
  // in the dynamic shared memory past the operands (a static array would
  // lower the dynamic bytes the kernel may opt into).
  long long* warp_sums = reinterpret_cast<long long*>(
      smem_raw + (sb + kOperandBytes - smem_u32(smem_raw)));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = s;
  named_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0)
    out[chain] = warp_sums[4 * wg] + warp_sums[4 * wg + 1] +
                 warp_sums[4 * wg + 2] + warp_sums[4 * wg + 3];
}

template <int D>
cudaError_t launch_mma(const void* a, const void* b, long long base,
                       long long extra, int ctas, int chains, int smem,
                       long long* out, cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(probe_mma_kernel<D>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxProbeSmem);
  if (opted != cudaSuccess) return opted;
  probe_mma_kernel<D><<<ctas, 128 * chains, smem, stream>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b), base, extra,
      out);
  return cudaGetLastError();
}

}  // namespace repro

using namespace repro;

// Streams n_chunks fetches of chunk 16-byte vectors through the first elems
// vectors of x, fetch i from vector (i chunk) % elems, on ctas CTAs of 1024
// threads in groups of group_ctas (ctas a multiple of it).  out[c] (ctas
// int64) = the sum of every f32 CTA c read: plain stores, so the launch
// needs no zeroed buffer and no fill kernel before it.
extern "C" int repro_probe_stream(const void* x, int elems, int chunk,
                                  long long n_chunks, int ctas,
                                  int group_ctas, void* out, void* stream) {
  if (x == nullptr || out == nullptr || elems < 1 || chunk < 1 ||
      n_chunks < 1 || group_ctas < 1 || ctas < group_ctas ||
      ctas % group_ctas || reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool l2_only = 16LL * elems > smem_per_sm;
  auto kernel = l2_only ? probe_stream_kernel<true> : probe_stream_kernel<false>;
  kernel<<<ctas, kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), elems, chunk, n_chunks, group_ctas,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ctas CTAs of `chains` warpgroups each run wgmma chains on the operands a
// and b (64 rows of 128 bytes, in the dtype's encoding); chain c runs
// base + (c < extra) instructions and writes its accumulators' sum to
// out[c] (ctas * chains int64; plain stores, as the stream probe's).  smem: dynamic shared memory a CTA asks
// for (at least the operands' 17 KB and the sums' 128 bytes; more keeps
// other CTAs off its SM).
extern "C" int repro_probe_mma(int dtype, const void* a, const void* b,
                               long long base, long long extra, int ctas,
                               int chains, int smem, void* out,
                               void* stream) {
  if (a == nullptr || b == nullptr || out == nullptr || base < 0 ||
      extra < 0 || ctas < 1 || chains < 1 || chains > kMaxChains ||
      smem < 2 * kOperandBytes + 1024 + kSumBytes || smem > kMaxProbeSmem ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<long long*>(out);
  switch (dtype) {
    case kBf16: return launch_mma<kBf16>(a, b, base, extra, ctas, chains, smem, o, s);
    case kF16: return launch_mma<kF16>(a, b, base, extra, ctas, chains, smem, o, s);
    case kTf32: return launch_mma<kTf32>(a, b, base, extra, ctas, chains, smem, o, s);
    case kE4m3: return launch_mma<kE4m3>(a, b, base, extra, ctas, chains, smem, o, s);
    case kS8: return launch_mma<kS8>(a, b, base, extra, ctas, chains, smem, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
