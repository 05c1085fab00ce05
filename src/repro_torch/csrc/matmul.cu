// Selector-tiled GEMM with a fused epilogue, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/matmul.py::matmul_pallas (pallas_call at :181,
// body _make_kernel :77, _swizzle :48, _apply_epilogue :62).
//
//   C = epilogue(A @ B),  A (M, K) row-major, B (K, N) row-major.
//   epilogue = +bias (N) -> gelu(tanh) | silu | silu(y) * gate (M, N)
//              -> +residual (M, N) -> cast to the output type,
//   applied once, on the f32 accumulator, in DESIGN.md §3's order.
//
// What it honours of the selected TileConfig:
//   * bm x bn is the output tile one CTA owns; the grid is Tm * Tn CTAs and
//     the CTA's tile comes out of the same group_m row swizzle as the TPU
//     kernel's index maps, ragged final group included.
//   * bk is the depth of one staged K step (A: pass_m x bk, B: bk x pass_n in
//     shared memory, double-buffered with cp.async).
//   * split_k and schedule (data_parallel / stream_k) lower, as on the TPU
//     (matmul.py:24-32), to one in-CTA loop over the whole of K and a single
//     flush.  The sum runs over the same K blocks in order, so the result is
//     the one the k-sharded grid computes.  A persistent 132-SM stream-K and a
//     cross-CTA split-K combine are the redesign this kernel is queued for.
//
// What bounds it on the H100: at prefill (M = 512) the projections are
// compute-bound (arithmetic intensity ~ M / 2 flop per weight byte) and want
// the tensor cores; at decode (M = 4) every GEMM streams its weight once and
// is bound by HBM bytes.  The design answers the first with WMMA bf16 tensor
// cores (m16n8k16 mma.sync underneath) fed from padded, bank-conflict-free
// shared tiles, and the second by reading each weight element exactly once
// per CTA row-block with 16-byte cp.async loads; at M = 4 a 32-row tile
// wastes 7/8 of the tensor-core work but none of the bytes.
//
// Register capacity caps one pass at 128 x 128 accumulators (8 warps, 64 f32
// per thread).  A larger selected tile (256 x 128, 256 x 256) is walked in
// passes of up to 128 x 128, each running the full K loop; the flush order
// and result are unchanged.
//
// Ragged edges: M rows, N columns and K depth are masked in the kernel
// (zero-filled loads via cp.async src-size 0, guarded stores).  The wrapper
// pads only K and N up to a multiple of 8 elements so every 16-byte load is
// either wholly inside or wholly outside the matrix.
//
// float32 inputs take a SIMT FMA path with the same tiling (tensor-core TF32
// would miss the f32 tolerance); outputs and epilogue operands may be bf16 or
// f32 independently of the inputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPass = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in dynamic shared memory

enum Act { kActNone = 0, kActGelu = 1, kActSilu = 2, kActSwiglu = 3 };

struct Params {
  const void* a;
  const void* b;
  void* out;
  const void* bias;
  const void* gate;
  const void* residual;
  int M, N, K;
  int bm, bn, bk;
  int group_m;
  int out_f32, ep_f32;
  int has_bias, act, has_res;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float load_ep(const void* p, size_t i, int f32) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// The flush of one output element (matmul.py::_apply_epilogue).
__device__ __forceinline__ void epilogue_store(const Params& p, int row,
                                               int col, float acc) {
  const size_t idx = static_cast<size_t>(row) * p.N + col;
  if (p.has_bias) acc += load_ep(p.bias, col, p.ep_f32);
  if (p.act == kActGelu) {
    const float u = 0.7978845608028654f * (acc + 0.044715f * acc * acc * acc);
    acc = 0.5f * acc * (1.0f + tanhf(u));
  } else if (p.act == kActSilu) {
    acc = acc / (1.0f + expf(-acc));
  } else if (p.act == kActSwiglu) {
    acc = acc / (1.0f + expf(-acc)) * load_ep(p.gate, idx, p.ep_f32);
  }
  if (p.has_res) acc += load_ep(p.residual, idx, p.ep_f32);
  if (p.out_f32) {
    static_cast<float*>(p.out)[idx] = acc;
  } else {
    static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16(acc);
  }
}

// Stage A[row0:row0+PM, k0:k0+bk] and B[k0:k0+bk, col0:col0+PN] into shared
// memory with 16-byte cp.async copies; out-of-range chunks are zero-filled.
template <typename T, int PM, int PN>
__device__ __forceinline__ void load_tiles(const Params& p, T* As, T* Bs,
                                           int row0, int col0, int k0) {
  constexpr int kVec = 16 / sizeof(T);
  const int bk = p.bk;
  const int lda = bk + kVec, ldb = PN + kVec;
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  const int a_cpr = bk / kVec;
  for (int c = threadIdx.x; c < PM * a_cpr; c += kThreads) {
    const int r = c / a_cpr, cc = (c - r * a_cpr) * kVec;
    const int gr = row0 + r, gk = k0 + cc;
    const bool ok = gr < p.M && gk < p.K;
    const T* src = ok ? A + static_cast<size_t>(gr) * p.K + gk : A;
    cp_async16(As + r * lda + cc, src, ok);
  }
  constexpr int b_cpr = PN / kVec;
  for (int c = threadIdx.x; c < bk * b_cpr; c += kThreads) {
    const int r = c / b_cpr, cc = (c - r * b_cpr) * kVec;
    const int gk = k0 + r, gn = col0 + cc;
    const bool ok = gk < p.K && gn < p.N;
    const T* src = ok ? B + static_cast<size_t>(gk) * p.N + gn : B;
    cp_async16(Bs + r * ldb + cc, src, ok);
  }
}

// One PM x PN pass on bf16 tensor cores: double-buffered K loop, then the
// accumulators go through shared memory so the epilogue writes coalesced.
template <int PM, int PN>
__device__ void pass_bf16(const Params& p, __nv_bfloat16* As,
                          __nv_bfloat16* Bs, float* Cs, int row0, int col0) {
  constexpr int WN = (PN / 16) < 4 ? (PN / 16) : 4;
  constexpr int WM_MAX = 8 / WN;
  constexpr int WM = (PM / 16) < WM_MAX ? (PM / 16) : WM_MAX;
  constexpr int FM = PM / 16 / WM;
  constexpr int FN = PN / 16 / WN;
  constexpr int ldc = PN + 4;
  const int bk = p.bk;
  const int lda = bk + 8, ldb = PN + 8;
  const int warp = threadIdx.x / 32;
  const bool active = warp < WM * WN;
  const int wm = warp / WN, wn = warp % WN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (p.K + bk - 1) / bk;
  load_tiles<__nv_bfloat16, PM, PN>(p, As, Bs, row0, col0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tiles<__nv_bfloat16, PM, PN>(p, As + (cur ^ 1) * PM * lda,
                                        Bs + (cur ^ 1) * bk * ldb, row0, col0,
                                        (kt + 1) * bk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const __nv_bfloat16* a = As + cur * PM * lda + (wm * FM * 16) * lda;
      const __nv_bfloat16* b = Bs + cur * bk * ldb + wn * FN * 16;
      for (int kk = 0; kk < bk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(af[i], a + i * 16 * lda + kk, lda);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(bf[j], b + kk * ldb + j * 16, ldb);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
            wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(
            Cs + (wm * FM * 16 + i * 16) * ldc + wn * FN * 16 + j * 16,
            acc[i][j], ldc, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < PM * PN; idx += kThreads) {
    const int r = idx / PN, c = idx % PN;
    const int row = row0 + r, col = col0 + c;
    if (row < p.M && col < p.N) epilogue_store(p, row, col, Cs[r * ldc + c]);
  }
  __syncthreads();  // Cs aliases the staging buffers of the next pass
}

// One PM x PN pass in f32 FMA: a 16 x 16 thread grid, each thread owning the
// rows ty + 16 i and columns tx + 16 j of the pass.
template <int PM, int PN>
__device__ void pass_f32(const Params& p, float* As, float* Bs, int row0,
                         int col0) {
  constexpr int TM = PM / 16, TN = PN / 16;
  const int bk = p.bk;
  const int lda = bk + 4, ldb = PN + 4;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int nk = (p.K + bk - 1) / bk;
  load_tiles<float, PM, PN>(p, As, Bs, row0, col0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tiles<float, PM, PN>(p, As + (cur ^ 1) * PM * lda,
                                Bs + (cur ^ 1) * bk * ldb, row0, col0,
                                (kt + 1) * bk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* a = As + cur * PM * lda;
    const float* b = Bs + cur * bk * ldb;
    for (int kk = 0; kk < bk; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a[(ty + 16 * i) * lda + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b[kk * ldb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int row = row0 + ty + 16 * i, col = col0 + tx + 16 * j;
      if (row < p.M && col < p.N) epilogue_store(p, row, col, acc[i][j]);
    }
}

template <typename T, int PM, int PN>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + 2 * PM * (p.bk + kVec);

  // Flattened tile id -> (pid_m, pid_n) under the grouped order
  // (matmul.py::_swizzle), ragged final group included.
  const int Tm = (p.M + p.bm - 1) / p.bm, Tn = (p.N + p.bn - 1) / p.bn;
  const int pid = blockIdx.x;
  int pid_m, pid_n;
  if (p.group_m <= 1) {
    pid_m = pid / Tn;
    pid_n = pid % Tn;
  } else {
    const int group_size = p.group_m * Tn;
    const int first_m = (pid / group_size) * p.group_m;
    const int rows = min(Tm - first_m, p.group_m);
    const int local = pid % group_size;
    pid_m = first_m + local % rows;
    pid_n = local / rows;
  }

  for (int pm = 0; pm < p.bm; pm += PM) {
    const int row0 = pid_m * p.bm + pm;
    if (row0 >= p.M) break;
    for (int pn = 0; pn < p.bn; pn += PN) {
      const int col0 = pid_n * p.bn + pn;
      if (col0 >= p.N) break;
      if constexpr (sizeof(T) == 2) {
        pass_bf16<PM, PN>(p, As, Bs, reinterpret_cast<float*>(smem), row0,
                          col0);
      } else {
        pass_f32<PM, PN>(p, As, Bs, row0, col0);
      }
    }
  }
}

template <typename T, int PM, int PN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t staging =
      2 * (static_cast<size_t>(PM) * (p.bk + kVec) +
           static_cast<size_t>(p.bk) * (PN + kVec)) *
      sizeof(T);
  const size_t cstage =
      sizeof(T) == 2 ? static_cast<size_t>(PM) * (PN + 4) * sizeof(float) : 0;
  const size_t smem = staging > cstage ? staging : cstage;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<T, PM, PN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return e;
    opted_in = kMaxSmem;
  }
  const long long tiles =
      static_cast<long long>((p.M + p.bm - 1) / p.bm) * ((p.N + p.bn - 1) / p.bn);
  gemm_kernel<T, PM, PN><<<static_cast<unsigned>(tiles), kThreads, smem,
                           stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  const int pm = p.bm < kMaxPass ? p.bm : kMaxPass;
  const int pn = p.bn < kMaxPass ? p.bn : kMaxPass;
#define REPRO_GEMM_CASE(PM_, PN_) \
  if (pm == PM_ && pn == PN_) return launch<T, PM_, PN_>(p, stream);
  REPRO_GEMM_CASE(32, 32)
  REPRO_GEMM_CASE(32, 64)
  REPRO_GEMM_CASE(32, 128)
  REPRO_GEMM_CASE(64, 32)
  REPRO_GEMM_CASE(64, 64)
  REPRO_GEMM_CASE(64, 128)
  REPRO_GEMM_CASE(128, 32)
  REPRO_GEMM_CASE(128, 64)
  REPRO_GEMM_CASE(128, 128)
#undef REPRO_GEMM_CASE
  return cudaErrorInvalidValue;
}

bool tile_ok(int v) { return v == 32 || v == 64 || v == 128 || v == 256; }

}  // namespace

extern "C" int repro_gemm(const void* a, const void* b, void* out,
                          const void* bias, const void* gate,
                          const void* residual, int M, int N, int K, int bm,
                          int bn, int bk, int group_m, int in_f32, int out_f32,
                          int ep_f32, int has_bias, int act, int has_res,
                          void* stream) {
  const int vec = in_f32 ? 4 : 8;
  if (M <= 0 || N <= 0 || K <= 0 || N % vec || K % vec || !tile_ok(bm) ||
      !tile_ok(bn) || bk <= 0 || bk % 16 || group_m < 1 || act < 0 ||
      act > kActSwiglu)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{a,  b,  out, bias,    gate,    residual, M,        N,   K,
           bm, bn, bk,  group_m, out_f32, ep_f32,   has_bias, act, has_res};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(in_f32 ? dispatch<float>(p, s)
                                 : dispatch<__nv_bfloat16>(p, s));
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
