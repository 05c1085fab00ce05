// Online-softmax (flash) attention forward, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (pallas_call at :166, body _attn_kernel :82).
//
//   q (B, H, Sq, d), k / v (B, Hkv, Skv, d), bf16, any strides with a unit
//   d stride; output in q's type.  GQA maps head h to kv head
//   h / (H / Hkv) with no KV repeat.  Keys at or beyond kv_len are masked;
//   with causal set, key j is visible to query i iff i >= j (positions from
//   0, Sq == Skv at prefill).  Running max m, sum l and accumulator stay f32,
//   with the same -inf guards as the TPU kernel (rows with no valid key yet
//   keep m = -inf, alpha = 0, and a row whose l stays 0 writes zeros).
//
// Structure: one CTA per (q block, head, batch); 16 query rows per warp
// (block_q / 16 warps).  The CTA loops over kv blocks up to the causal
// diagonal and skips every block above it.  Each kv block is staged in
// shared memory (K row-major, V transposed), both warp-shared; Q, the
// scores S = Q K^T and the output accumulator stay in registers as
// mma.sync.m16n8k16 fragments, and P is re-packed from the S accumulator
// fragments straight into the A operand of P V (the C-fragment layout of
// two n8 tiles is the A-fragment layout of one k16 step).
//
// What bounds it on the H100: at prefill lengths (S <= a few thousand,
// d = 128) the two chained products are 4 S^2 d flop per head (halved by the
// causal skip) against 4 S d bytes of q/k/v/o per head, so the work is
// compute-bound on paper; in practice the online softmax (exp, max, rescale
// on the CUDA cores) and the per-block shared-memory staging bound it.
// This first version keeps S and P out of shared memory and device memory
// entirely, which is what the design buys; kv-block double buffering,
// ldmatrix loads and wgmma are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct FlashParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, H, Hkv, Sq, Skv, kv_len, causal;
  float scale_log2;  // softmax scale * log2(e): exponentials run in base 2
};

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BQ * 2) flash_fwd_kernel(FlashParams p) {
  constexpr int kWarps = BQ / 16;
  constexpr int kThreads = kWarps * 32;
  constexpr int ldk = D + 8;    // K tile row stride (elements)
  constexpr int ldv = BKV + 8;  // transposed V tile row stride
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [BKV][D+8]
  __nv_bfloat16* Vt = Ks + BKV * ldk;                           // [D][BKV+8]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * BQ + warp * 16;
  const int rows[2] = {q0 + g, q0 + g + 8};

  const __nv_bfloat16* Q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* Kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* Vg = p.v + b * p.v_sb + hk * p.v_sh;

  // Q A-fragments for all of d, held for the whole kv loop.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = rows[r] < p.Sq;
      const __nv_bfloat16* src = Q + static_cast<long long>(rows[r]) * p.q_ss;
      qf[kk][r] = ok ? ld_u32(src + c) : 0u;
      qf[kk][r + 2] = ok ? ld_u32(src + c + 8) : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.0f, 0.0f};  // per-thread partial row sums

  const int q_last = min(qb * BQ + BQ, p.Sq) - 1;
  int n_blocks = (min(p.Skv, p.kv_len) + BKV - 1) / BKV;
  if (p.causal) n_blocks = min(n_blocks, q_last / BKV + 1);

  for (int kb = 0; kb < n_blocks; ++kb) {
    const int k0 = kb * BKV;
    __syncthreads();  // the previous block's K/V reads are done
    // K block, row-major, 16-byte loads; rows past Skv are zero.
    for (int c = threadIdx.x; c < BKV * (D / 8); c += kThreads) {
      const int j = c / (D / 8), d0 = (c % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < p.Skv)
        val = *reinterpret_cast<const uint4*>(
            Kg + static_cast<long long>(k0 + j) * p.k_ss + d0);
      *reinterpret_cast<uint4*>(Ks + j * ldk + d0) = val;
    }
    // V block, transposed to [d][key] so its B-fragments are 32-bit loads;
    // key index fastest across lanes keeps the scattered stores conflict-free.
    for (int c = threadIdx.x; c < BKV * (D / 8); c += kThreads) {
      const int j = c % BKV, d0 = (c / BKV) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < p.Skv)
        val = *reinterpret_cast<const uint4*>(
            Vg + static_cast<long long>(k0 + j) * p.v_ss + d0);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(d0 + i) * ldv + j] = e[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BKV keys.
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * ldk + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16_16816(s[j], qf[kk], ld_u32(kr + kk * 16),
                       ld_u32(kr + kk * 16 + 8));
    }

    // Scale into base 2, mask (padding, causal), row max across the quad.
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int row = rows[e >> 1];
        const bool valid = key < p.kv_len && key < p.Skv &&
                           (!p.causal || row >= key);
        s[j][e] = valid ? s[j][e] * p.scale_log2 : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }

    // Online softmax update with the TPU kernel's -inf guards.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r]);
      const float safe = m_new == -CUDART_INF_F ? 0.0f : m_new;
      const float alpha =
          m_run[r] == -CUDART_INF_F ? 0.0f : exp2f(m_run[r] - safe);
      m_run[r] = m_new;
      l_run[r] *= alpha;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][2 * r] *= alpha;
        o[dn][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pv =
              s[j][e] == -CUDART_INF_F ? 0.0f : exp2f(s[j][e] - safe);
          s[j][e] = pv;
          l_run[r] += pv;
        }
    }

    // O += P V, P re-packed from the S fragments as bf16 A-fragments.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vr = Vt + (dn * 8 + g) * ldv + kk * 16 + 2 * t;
        mma_bf16_16816(o[dn], a, ld_u32(vr), ld_u32(vr + 8));
      }
    }
  }

  // Finish: reduce l over the quad, divide (0 where no key was valid), store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.0f ? 1.0f / l : 1.0f;
    if (rows[r] >= p.Sq) continue;
    __nv_bfloat16* dst = p.o + b * p.o_sb + h * p.o_sh +
                         static_cast<long long>(rows[r]) * p.o_ss + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(dst + dn * 8) =
          pack_bf16x2(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
  }
}

template <int D, int BQ, int BKV>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(BKV) * (D + 8) + static_cast<size_t>(D) * (BKV + 8)) *
      sizeof(__nv_bfloat16);
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, BQ, BKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<D, BQ, BKV><<<grid, BQ * 2, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int H, int Hkv,
    int Sq, int Skv, int kv_len, int causal, float scale, int block_q,
    int block_kv, int d, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv <= 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p{static_cast<const __nv_bfloat16*>(q),
                static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v),
                static_cast<__nv_bfloat16*>(o),
                q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                o_sb, o_sh, o_ss, B, H, Hkv, Sq, Skv, kv_len, causal,
                scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(D_, BQ_, BKV_)                  \
  if (d == D_ && block_q == BQ_ && block_kv == BKV_) \
    return static_cast<int>(launch<D_, BQ_, BKV_>(p, s));
  REPRO_FLASH_CASE(128, 64, 64)
  REPRO_FLASH_CASE(128, 64, 128)
  REPRO_FLASH_CASE(128, 128, 64)
  REPRO_FLASH_CASE(128, 128, 128)
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
