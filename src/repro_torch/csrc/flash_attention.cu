// Online-softmax (flash) attention forward, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (pallas_call at :166, body _attn_kernel :82).
//
//   q (B, H, Sq, d), k / v (B, Hkv, Skv, d), bf16 or f32, any head dim d
//   that is a multiple of 8 up to 256, any strides with a unit d stride
//   (bf16: multiples of 16 bytes; v may be the transposed view of a
//   (B, Skv, Hkv, d) tensor, as the model passes it); the output o
//   (B, H, Sq, d) in q's dtype with its own strides.  GQA maps head h to kv
//   head h / (H / Hkv) with no KV repeat.  Keys at or beyond kv_len are
//   masked; with causal set, key j is visible to query i iff i >= j
//   (positions from 0); every kernel here, forward and backward, also takes
//   a sliding window: with window > 0, key j is visible to query i only if
//   i - j < window (the reference's strict test,
//   src/repro/nn/attention.py:80-82).  Running
//   max m, sum l and the accumulator stay f32, with the TPU kernel's -inf
//   guards (a row with no valid key yet keeps
//   m = -inf and alpha = 0; a row whose l stays 0 writes zeros).
//
// What bounds it on the H100.  At the served prefill lengths (S <= 474,
// d = 128) the two chained products are 4 S^2 d flop per head, halved by
// the causal skip, against 4 S d bytes of q/k/v/o per head: a few
// microseconds of tensor-core work and 2-9 MB of traffic, so neither the
// 989 TFLOP/s nor the 3.35 TB/s bound is near.  What bounds it is latency:
// how many of the 132 SMs have work, how long the longest CTA's chain of
// kv steps is, and whether each step waits for its loads and for the
// tensor cores in turn.
//
// What the design does about it:
//  * A grid that fills the card and ends on short work.  One CTA per
//    (64- or 128-row q block, head, batch), issued heaviest causal q block
//    first (the grid's index runs over q blocks in reverse), so the last
//    CTAs to start are the one- and two-step ones.  With 64-row q blocks
//    phi4's 24 heads at S = 474 give 192 CTAs, and two fit on one SM.
//  * K and V arrive by TMA into a 2-stage ring of mbarrier-guarded stages
//    that one producer thread keeps filled; Q is loaded once, by TMA as
//    well.  The tensor maps are 4-D over (d, S, head, batch) with the
//    caller's strides, so a strided v needs no copy, and TMA zero-fills
//    rows past Sq and Skv (the key mask covers the ragged edge).  The
//    producer's warpgroup hands its registers to the consumers
//    (setmaxnreg).
//  * Both products on wgmma.  S = Q K^T reads Q (64 rows a consumer
//    warpgroup) and the K tile from shared memory (both K-major, 128-byte
//    swizzled); O += P V takes P from registers -- the S accumulator's
//    layout is the register-A layout, so P is S converted to bf16 in place
//    -- and V in its natural [key][d] layout as an MN-major B operand, so V
//    is never transposed.  The next kv block's S product and this block's
//    P V go to the tensor cores together, and the next block's softmax runs
//    while P V does (O takes its rescale once P V is done).  The last P V
//    is peeled off the loop: with it inside, ptxas saw the softmax read an
//    accumulator inside an open wgmma stage and serialised every wgmma
//    (C7514).
//  * Any head dim on one code path, templated on d rounded up to 64 (DP:
//    64, 128, 192 or 256).  The tiles keep the 128-byte swizzle in 64-column
//    chunks; the TMA box of the last chunk runs past d and TMA fills the
//    columns past d with zeros, so Q K^T over DP columns is Q K^T over d,
//    and O's columns past d are zero and are clipped by the TMA store.  No
//    host copy pads anything; the cost is the padded work (d 112: 8 k16
//    steps instead of 7, d 160: 12 instead of 10).  P V runs as 128-column
//    wgmma where DP is a multiple of 128 and as 64-column ones otherwise.
//  * The softmax runs on the accumulator fragments in base 2 (two rows a
//    thread, the row max and sum across the four threads of a quad); only
//    the blocks that straddle the causal diagonal, the window's lower edge
//    or the key end are masked.  The epilogue divides by l and writes bf16
//    through shared memory (the dead Q tile, in the output map's swizzle)
//    with a TMA store, which clips rows past Sq.
//  * A sliding window starts each q block's walk at the key block of its
//    first row's first visible key, (q0 - window + 1) / BKV, as the causal
//    diagonal ends it: at most ceil((window + BQ - 1) / BKV) + 1 blocks
//    whatever the sequence length.  Only the blocks that straddle the
//    window's lower edge are masked for it.  The f32 forward and the dQ
//    kernels of the backward walk the same way; a dK/dV CTA ends its walk
//    at the last q block that still sees one of its 64 keys, (k0 + 63 +
//    window - 1) / QR with QR q rows a step.  Under causal with a window a
//    q block's kv-block count never falls as q0 grows and a kv block's
//    q-block count never rises as k0 grows, so the launch orders stay the
//    heaviest CTA first: q blocks reversed, kv block 0 first.  In the f32
//    forward and in the backward kernels the window is a template flag,
//    WIN, set where window > 0: without one they compile to the causal
//    code, with no window term in their loops (a runtime test slowed the
//    causal bf16 backward by 14 % on an H100, tools/flash_ab.py --bwd).
//
// f32 inputs take a second kernel, flash_fwd_tf32x3 (below), that computes
// the same function on the tensor cores with every product in split TF32
// (csrc/tf32x3.cuh: one TF32 product keeps ten mantissa bits, too few for
// the f32 tolerance; three meet it), on mma.sync.m16n8k8: tf32 wgmma takes
// B only K-major, and P V's B is V in its [key][d] layout.  One CTA of 8
// warps per (64 q rows, head, batch), the heaviest causal block first; Q
// loaded once, (K, V) through a 2-stage cp.async ring of 64 keys (32 past
// a padded d of 128); two warps share each 16-row group, each taking half
// of every stage's keys with its own online softmax, and their (m, l, O)
// are merged in a fixed order at the end.  At zamba2-7b's f32 prefill
// (causal, 32 heads of 474 x 112) the products are 1.6e9 flop, 0.0098 ms
// at a third of the 495 TFLOP/s TF32 peak; what bounds the kernel is the
// longest CTA's chain of 8 dependent kv steps and a grid of 256 CTAs about
// two deep on the 132 SMs.
//
// Both forward kernels can also write the row log-sum-exp of the scaled
// scores, lse (B, H, Sq) f32 in natural units (+inf for a row with no
// visible key, so that the backward's exp(s - lse) is 0 there), which the
// backward needs; the serving launches pass none.
//
// The backward (flash_bwd_*) is the FlashAttention-2 form, deterministic
// (no float atomics: two launches are bitwise equal).  flash_bwd_delta
// first computes delta = rowsum(dO o O), a warp a row.  bf16 (every head
// dim) then runs two wgmma kernels:
//  * flash_bwd_dkdv_wgmma: one CTA per (kv block, kv head, batch), kv block
//    0 first, walking the q heads of its GQA group and their 64-row q
//    blocks (under causal from its own diagonal).  K and V are loaded once
//    by TMA; (Q, dO) tiles and the q block's lse2 = lse log2(e) and delta
//    arrive through a 2-stage mbarrier ring that a producer warpgroup keeps
//    filled.  Each of two consumer warpgroups computes S^T = K Q^T and
//    dP^T = V dO^T over its 64 kv rows (K-major A and B), forms
//    P^T = exp2(S^T scale log2(e) - lse2) and dS^T = P^T o (dP^T - delta)
//    on the fragments, converts both to bf16 in place (the register-A
//    layout) and accumulates dV += P^T dO and dK += dS^T Q, with the same
//    swizzled [row][d] Q and dO tiles read as MN-major B: no operand is
//    transposed or copied.  A CTA holds 64 kv rows, warpgroup 0
//    accumulating their dV and warpgroup 1 their dK (past a padded d of
//    128 the two sums of one row do not fit one thread's registers), both
//    recomputing S^T.  dK is scaled once; dK and dV are stored by TMA
//    through the dead K / V tiles.
//  * flash_bwd_dq_wgmma: one CTA per (64-row q block, head, batch), the
//    heaviest causal block first; Q and dO loaded once, (K, V) through the
//    ring; S = Q K^T and dP = dO V^T, then P, dS, and dQ += dS K with K as
//    an MN-major B; dQ scaled once and stored by TMA.
// Each product group is waited for before its accumulators are read (a
// read inside an open wgmma stage makes ptxas serialise every wgmma,
// C7514).  q rows past Sq are zero-filled by TMA and carry lse2 = +inf in
// the padded scratch, so their P is 0; only blocks that straddle the
// causal diagonal or the key end are masked.  The cost of determinism is
// S and dP computed twice (seven 64x64 products a block pair where a
// dQ accumulated by atomics needs five).  What bounds it at phi4's
// training shape (causal, 4 x 24 heads of 512 x 128) is neither the
// bytes (about 0.02 ms at 3.35 TB/s) nor the tensor cores (the seven
// products about 0.023 ms at the bf16 peak) but latency: the longest dK/dV
// CTA walks 24 dependent q-block steps, each waiting for its products,
// its score math and its products again.  The route follows the dtype
// alone, and the host plan (kernels/flash_attention.py::plan_attention_bwd)
// passes its tiles, grids and shared bytes, which the entry checks against
// the instantiation it runs.  f32 inputs run the same
// two-kernel structure on the tensor cores with split-TF32 products
// (flash_bwd_dkdv_tf32x3 / flash_bwd_dq_tf32x3, below; one TF32 product
// misses the f32 tolerance, three meet it).  At the f32 training shape
// (2 x 24/8 heads of 512 x 128, causal) the backward's five products are
// 8.07e9 flop, about 0.05 ms at the TF32 peak three times over; the
// kernels compute seven 64x64 products a block pair (S^T, dP^T, dV, dK;
// S, dP, dQ), and what bounds them is again the longest dK/dV CTA's
// chain of q-block steps, each its products, its score math and its
// products again.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace repro {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxD = 256;      // the largest head dim
constexpr int kStages = 2;      // K/V ring depth
constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16 of the head dim

struct FlashParams {
  int B, H, Hkv, Sq, Skv, kv_len, causal, window, n_qb;
  float scale_log2;  // softmax scale * log2(e): exponentials run in base 2
  float* lse;        // (B, H, Sq) or null
};

constexpr float kLn2 = 0.6931471805599453f;

// NWG consumer warpgroups of 64 q rows each, plus one producer warpgroup,
// over a head dim padded to DP columns.  A one-warpgroup CTA is built for
// two CTAs an SM (128 registers a thread at launch: 224 for a consumer, 32
// for the producer); a two-warpgroup CTA for one (168 at launch: 232 and
// 40, as the GEMM's 256-row tile).  O is kOChunks accumulators of kCW
// columns, one P V wgmma each.
template <int NWG, int BKV, int DP>
struct Flash {
  static constexpr int kChunks = DP / 64;
  static constexpr int kCW = DP % 128 == 0 ? 128 : 64;
  static constexpr int kOChunks = DP / kCW;
  static constexpr int kBQ = NWG * 64;
  static constexpr int kConsumers = NWG * 128;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kMinBlocks = NWG == 1 ? 2 : 1;
  static constexpr int kConsumerRegs = NWG == 1 ? 224 : 232;
  static constexpr int kProducerRegs = NWG == 1 ? 32 : 40;
  static constexpr uint32_t kQChunk = kBQ * kRowBytes;   // 64 columns of Q
  static constexpr uint32_t kKVChunk = BKV * kRowBytes;  // 64 columns of K or V
  static constexpr uint32_t kQBytes = kChunks * kQChunk;
  static constexpr uint32_t kKVBytes = kChunks * kKVChunk;
  static_assert(DP % 64 == 0 && DP <= kMaxD, "DP: 64, 128, 192 or 256");
  // [Q][K0 V0 K1 V1][mbarriers: q_full, k_full x2, v_full x2, empty x2]
  static constexpr uint32_t kBarAt = kQBytes + kStages * 2 * kKVBytes;
  static constexpr size_t kSmem = 1024 + kBarAt + 8 * (1 + 3 * kStages);
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

template <int BKV, int DP>
__device__ __forceinline__ void qk_product(float (&s)[BKV / 2], uint32_t q,
                                           uint32_t q_chunk, uint32_t k,
                                           uint32_t k_chunk) {
  // K-major 128-byte swizzled tiles: a k16 step moves 32 bytes along the
  // row; 8-row groups are 1024 bytes apart.
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = smem_desc(q + (kk / 4) * q_chunk + off, 16, 1024, 128);
    const uint64_t db = smem_desc(k + (kk / 4) * k_chunk + off, 16, 1024, 128);
    if constexpr (BKV == 64) wgmma_m64n64_kk(s, da, db, kk > 0);
    if constexpr (BKV == 128) wgmma_m64n128_kk(s, da, db, kk > 0);
  }
}

// O += P V over one stage's V tile, MN-major: a k16 step moves 16 rows;
// the 64-column chunks of d are v_chunk bytes apart, and O chunk c starts
// at chunk c * CW / 64.
template <int BKV, int CW, int NC>
__device__ __forceinline__ void pv_product(float (&o)[NC][CW / 2],
                                           const uint32_t (&pa)[BKV / 16][4],
                                           uint32_t v, uint32_t v_chunk) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t db = smem_desc(
          v + c * (CW / 64) * v_chunk + kk * 16 * kRowBytes, v_chunk, 1024,
          128);
      if constexpr (CW == 64) wgmma_m64n64_rs(o[c], pa[kk], db);
      if constexpr (CW == 128) wgmma_m64n128_rs(o[c], pa[kk], db);
    }
}

template <int CW, int NC>
__device__ __forceinline__ void fence_o(float (&o)[NC][CW / 2]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_acc(o[c]);
}

// The online-softmax update of one kv block on a consumer thread's S
// fragments (rows row0 and row0 + 8, key columns k0 + 8 j + 2 t + e): scale
// into base 2, mask only where the block crosses the key end, the causal
// diagonal or the window's lower edge (row - key >= window) of the
// warpgroup's rows, row max across the quad; then S becomes
// P = exp2(S - m) in place, l takes alpha and P's row sum, and alpha =
// exp2(m_old - m_new) is left for O.  The -inf guards are the TPU
// kernel's: a row with no valid key yet keeps m = -inf and alpha = 0.
template <int BKV>
__device__ __forceinline__ void online_softmax(
    float (&s)[BKV / 2], float (&m_run)[2], float (&l_run)[2],
    float (&alpha)[2], int k0, int kv_lim, int causal, int window, int row0,
    int wg_row0, int t, float scale_log2) {
  const bool edge = k0 + BKV > kv_lim || (causal && k0 + BKV - 1 > wg_row0) ||
                    (window > 0 && wg_row0 + 63 - k0 >= window);
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (key >= kv_lim || (causal && row < key) ||
            (window > 0 && row - key >= window))
          x = -CUDART_INF_F;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    const float safe = m_new == -CUDART_INF_F ? 0.0f : m_new;
    alpha[r] = m_run[r] == -CUDART_INF_F ? 0.0f : exp2f(m_run[r] - safe);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = exp2f(s[4 * j + 2 * r + e] - safe);  // 0 at -inf
        s[4 * j + 2 * r + e] = pv;
        l_run[r] += pv;
      }
  }
}

// P as bf16 A fragments: key columns 16 kk .. 16 kk + 15 are the
// accumulator's 8-column groups 2 kk and 2 kk + 1.
template <int BKV>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BKV / 16][4],
                                       const float (&s)[BKV / 2]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Rows 16 warp + g and 16 warp + g + 8 of a warpgroup's 64 x (NC CW) f32
// accumulator, times mul[0] and mul[1], as bf16 into a 64-row tile of
// 64-column chunks `chunk` bytes apart, in the 128-byte swizzle of a TMA
// map (row % 8 == g).
template <int CW, int NC>
__device__ __forceinline__ void stage_bf16(const float (&acc)[NC][CW / 2],
                                           uint32_t tile, uint32_t chunk,
                                           const float (&mul)[2], int warp,
                                           int g, int t) {
#pragma unroll
  for (int j = 0; j < NC * CW / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const uint32_t addr = tile + (j / 8) * chunk + row * kRowBytes +
                            (((j % 8) ^ g) * 16) + t * 4;
      const float* a = acc[j / (CW / 8)] + 4 * (j % (CW / 8));
      st_shared_u32(addr,
                    pack_bf16x2(a[2 * r] * mul[r], a[2 * r + 1] * mul[r]));
    }
}

// One thread stores a staged 64-row tile (CHUNKS chunks `chunk` bytes
// apart) at rows row0.. of a (d, S, head, batch) map and waits until the
// shared memory has been read.
template <int CHUNKS>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           uint32_t tile, uint32_t chunk,
                                           int row0, int head, int batch) {
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
    tma_store_4d(map, tile + c * chunk, 64 * c, row0, head, batch);
  bulk_commit();
  bulk_wait_read();
}

template <int NWG, int BKV, int DP>
__global__ void __launch_bounds__(Flash<NWG, BKV, DP>::kThreads,
                                  Flash<NWG, BKV, DP>::kMinBlocks)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tma_q,
                     const __grid_constant__ CUtensorMap tma_k,
                     const __grid_constant__ CUtensorMap tma_v,
                     const __grid_constant__ CUtensorMap tma_o,
                     const __grid_constant__ FlashParams p) {
  using F = Flash<NWG, BKV, DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_at = base;
  auto k_at = [&](int s) { return base + F::kQBytes + s * 2 * F::kKVBytes; };
  auto v_at = [&](int s) { return k_at(s) + F::kKVBytes; };
  const uint32_t q_full = base + F::kBarAt;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };

  // The work item: all heads of the last q block first under causal.
  const int heads = p.H * p.B;
  const int step = blockIdx.x / heads, hb = blockIdx.x - step * heads;
  const int qb = p.causal ? p.n_qb - 1 - step : step;
  const int h = hb % p.H, b = hb / p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qb * F::kBQ;
  const int kv_lim = min(p.Skv, p.kv_len);
  int n_blocks = kv_lim > 0 ? (kv_lim + BKV - 1) / BKV : 0;
  if (p.causal) n_blocks = min(n_blocks, (min(q0 + F::kBQ, p.Sq) - 1) / BKV + 1);
  // Under a window the walk starts at the block of row q0's first key.
  const int kb0 = p.window > 0 ? max(0, q0 - p.window + 1) / BKV : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), F::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The warpgroup index, broadcast so that the compiler sees the role split
  // as warp-uniform (otherwise it serialises every wgmma).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F::kProducerRegs)
                 : "memory");
    // Producer: one thread issues every TMA load of the CTA.
    if (tid == F::kConsumers) {
      mbar_expect_tx(q_full, F::kQBytes);
#pragma unroll
      for (int c = 0; c < F::kChunks; ++c)
        tma_load_4d(q_at + c * F::kQChunk, &tma_q, q_full, 64 * c, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = kb0; kb < n_blocks; ++kb) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(k_full(stage), F::kKVBytes);
#pragma unroll
        for (int c = 0; c < F::kChunks; ++c)
          tma_load_4d(k_at(stage) + c * F::kKVChunk, &tma_k, k_full(stage),
                      64 * c, kb * BKV, hk, b);
        mbar_expect_tx(v_full(stage), F::kKVBytes);
#pragma unroll
        for (int c = 0; c < F::kChunks; ++c)
          tma_load_4d(v_at(stage) + c * F::kKVChunk, &tma_v, v_full(stage),
                      64 * c, kb * BKV, hk, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows q0 + 64 wg ... + 63; this thread
  // rows row0 and row0 + 8 of them.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F::kConsumerRegs)
               : "memory");
  const int warp = __shfl_sync(0xffffffffu, (tid % 128) / 32, 0);
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + g;
  const uint32_t q_wg = q_at + wg * 64 * kRowBytes;

  float o[F::kOChunks][F::kCW / 2];
#pragma unroll
  for (int c = 0; c < F::kOChunks; ++c)
#pragma unroll
    for (int i = 0; i < F::kCW / 2; ++i) o[c][i] = 0.0f;
  float s[BKV / 2];
  uint32_t pa[BKV / 16][4];
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.0f, 0.0f};  // this thread's partial row sums
  float alpha[2];

  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  if (kb0 < n_blocks) {
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    qk_product<BKV, DP>(s, q_wg, F::kQChunk, k_at(0), F::kKVChunk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    online_softmax<BKV>(s, m_run, l_run, alpha, kb0 * BKV, kv_lim, p.causal,
                        p.window, row0, wg_row0, t, p.scale_log2);
    pack_p<BKV>(pa, s);
  }
  // Steps kb0 .. n - 2: S of block kb + 1 and O += P V of block kb go to
  // the tensor cores together; block kb + 1's softmax runs while P V does,
  // and O takes its alpha once P V is done.
  for (int kb = kb0; kb + 1 < n_blocks; ++kb) {
    const int next = stage + 1 == kStages ? 0 : stage + 1;
    const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
    wgmma_fence();
    mbar_wait(k_full(next), next_phase);
    qk_product<BKV, DP>(s, q_wg, F::kQChunk, k_at(next), F::kKVChunk);
    wgmma_commit();
    mbar_wait(v_full(stage), phase);
    pv_product<BKV, F::kCW, F::kOChunks>(o, pa, v_at(stage),
                                         F::kKVChunk);
    wgmma_commit();
    wgmma_wait<1>();  // S of block kb + 1, the older group, is done
    fence_acc(s);
    online_softmax<BKV>(s, m_run, l_run, alpha, (kb + 1) * BKV, kv_lim,
                        p.causal, p.window, row0, wg_row0, t, p.scale_log2);
    wgmma_wait<0>();
    fence_o<F::kCW, F::kOChunks>(o);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_frag(pa[kk]);
    mbar_arrive(empty(stage));
#pragma unroll
    for (int c = 0; c < F::kOChunks; ++c)
#pragma unroll
      for (int j = 0; j < F::kCW / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[c][4 * j + 2 * r] *= alpha[r];
          o[c][4 * j + 2 * r + 1] *= alpha[r];
        }
    pack_p<BKV>(pa, s);
    stage = next;
    phase = next_phase;
  }
  if (kb0 < n_blocks) {  // the last block's P V
    wgmma_fence();
    mbar_wait(v_full(stage), phase);
    pv_product<BKV, F::kCW, F::kOChunks>(o, pa, v_at(stage),
                                         F::kKVChunk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_o<F::kCW, F::kOChunks>(o);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_frag(pa[kk]);
    mbar_arrive(empty(stage));
  }

  // Epilogue: l over the quad, divide (a row with l = 0 keeps O = 0), stage
  // bf16 rows in this warpgroup's part of the Q tile -- every product that
  // read it has completed -- in the 128-byte swizzle of the output map,
  // then one thread stores the 64 x DP tile with TMA (columns past d are
  // clipped).
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.0f ? 1.0f / l : 1.0f;
    // m_run is in base-2 units of the scaled scores: lse = m ln 2 + ln l.
    const int row = row0 + 8 * r;
    if (p.lse != nullptr && t == 0 && row < p.Sq)
      p.lse[(static_cast<size_t>(b) * p.H + h) * p.Sq + row] =
          l > 0.0f ? m_run[r] * kLn2 + logf(l) : CUDART_INF_F;
  }
  stage_bf16<F::kCW, F::kOChunks>(o, q_wg, F::kQChunk, inv, warp, g, t);
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (tid % 128 == 0)
    store_tile<F::kChunks>(&tma_o, q_wg, F::kQChunk, wg_row0, h, b);
}

// A 4-D bf16 tensor map over (d, S, head, batch) with element strides
// (ss, sh, sb) and a (64, rows, 1, 1) box, 128-byte swizzled.  A box that
// runs past d (or past S) reads zeros and stores nothing there.
bool encode_4d(CUtensorMap* map, const void* ptr, int d, int S, int heads,
               int batch, long long ss, long long sh, long long sb,
               uint32_t rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A kernel's dynamic shared memory above 48 KB, up to the 227 KB a block
// may opt into.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;  // 227 KB a block
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Operands {
  const void *q, *k, *v;
  void* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
};

template <int NWG, int BKV, int DP>
cudaError_t launch(const Operands& a, const FlashParams& p, int d,
                   cudaStream_t stream) {
  using F = Flash<NWG, BKV, DP>;
  static const cudaError_t opted =
      opt_in_smem(flash_fwd_kernel<NWG, BKV, DP>, F::kSmem);
  if (opted != cudaSuccess) return opted;
  CUtensorMap tq, tk, tv, to;
  if (!encode_4d(&tq, a.q, d, p.Sq, p.H, p.B, a.q_ss, a.q_sh, a.q_sb,
                 F::kBQ) ||
      !encode_4d(&tk, a.k, d, p.Skv, p.Hkv, p.B, a.k_ss, a.k_sh, a.k_sb,
                 BKV) ||
      !encode_4d(&tv, a.v, d, p.Skv, p.Hkv, p.B, a.v_ss, a.v_sh, a.v_sb,
                 BKV) ||
      !encode_4d(&to, a.o, d, p.Sq, p.H, p.B, a.o_ss, a.o_sh, a.o_sb, 64))
    return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(p.n_qb) * p.H * p.B;
  flash_fwd_kernel<NWG, BKV, DP><<<grid, F::kThreads, F::kSmem, stream>>>(
      tq, tk, tv, to, p);
  return cudaGetLastError();
}

// The (block_q, block_kv) pairs whose shared memory fits a block at DP
// (kernels/flash_attention.py::legal_blocks prices the same budgets).
template <int DP>
cudaError_t launch_dp(int block_q, int block_kv, const Operands& a,
                      const FlashParams& p, int d, cudaStream_t s) {
  if (block_q == 64 && block_kv == 64) return launch<1, 64, DP>(a, p, d, s);
  if (block_q == 128 && block_kv == 64) return launch<2, 64, DP>(a, p, d, s);
  if constexpr (DP <= 128) {
    if (block_q == 64 && block_kv == 128)
      return launch<1, 128, DP>(a, p, d, s);
    if (block_q == 128 && block_kv == 128)
      return launch<2, 128, DP>(a, p, d, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores: split-TF32 products (tf32x3.cuh, mma.sync) over
// f32 tiles whose rows are the head dim padded to DP + 4 floats (ld % 32 ==
// 4: fragment loads across rows and across columns are free of bank
// conflicts), loaded by cp.async, 16 bytes a copy, zero-filled past S and
// past d.  The forward here, the backward's kernels further down.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // an f32 CTA: 8 warps
constexpr int kFwdF32Rows = 64;   // q rows an f32 forward CTA

// Rows [r0, r0 + R) of an (S, d) f32 matrix with row stride ss into an
// [R][DP + 4] tile; rows past S and columns past d are zero-filled.
template <int DP, int R>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ss, int r0, int S,
                                              int d) {
  constexpr int kCpr = DP / 4;
  for (int c = threadIdx.x; c < R * kCpr; c += kF32Threads) {
    const int r = c / kCpr, col = (c - r * kCpr) * 4;
    const bool ok = r0 + r < S && col < d;
    cp_async16(dst + r * (DP + 4) + col,
               ok ? src + static_cast<long long>(r0 + r) * ss + col : src,
               ok);
  }
}

// The forward's CTA: 64 q rows, four 16-row groups, each shared by two warps
// that take the two halves of every ring stage's keys.  A stage holds 64
// keys of K and of V up to DP 128 and 32 past it, so that the Q tile and two
// stages fit 227 KB.
template <int DP>
struct FwdF32 {
  static constexpr int kLd = DP + 4;
  static constexpr int kRows = kFwdF32Rows;
  static constexpr int kGroups = kRows / 16;
  static constexpr int kSplits = kF32Threads / 32 / kGroups;
  static constexpr int kKeys = DP <= 128 ? 64 : 32;
  static constexpr int kWarpKeys = kKeys / kSplits;
  static constexpr int kStages = 2;
  // k8 steps of Q K^T unrolled together (past DP 128 O's accumulators
  // leave no registers for more); two CTAs an SM where DP 64 lets them.
  static constexpr int kUnroll = DP <= 128 ? 4 : 1;
  static constexpr int kMinBlocks = DP <= 64 ? 2 : 1;
  static constexpr int kStage = 2 * kKeys * kLd;  // K rows, then V rows
  static constexpr size_t kSmem =
      sizeof(float) * (kRows * kLd + kStages * kStage);
  static_assert(DP % 64 == 0 && DP <= kMaxD, "DP: 64, 128, 192 or 256");
  static_assert(kWarpKeys % 8 == 0, "a warp's keys: whole n8 / k8 blocks");
  static_assert((kSplits - 1) * kRows <= kStages * 2 * kKeys,
                "the key halves' merge fits the dead ring");
  static_assert(kSmem <= 232448, "227 KB a CTA");
};

struct FwdF32Params {
  int B, H, Hkv, Sq, Skv, kv_len, causal, window, n_qb, d;
  float scale_log2;  // softmax scale * log2(e): exponentials run in base 2
  float* lse;        // (B, H, Sq) or null
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
};

// One CTA per (64 q rows, head, batch), the heaviest causal block first.
// Warp w holds q rows 16 (w % 4) .. + 15 and keys (w / 4) KW .. + KW - 1 of
// every stage, and runs its own online softmax over them: S = Q K^T in
// split TF32 (Q from the tile loaded once, K as K-major B), the row max and
// sum across the quad in base 2 (masked only where the warp's keys cross
// the key end, its rows' causal diagonal or the window's lower edge), then
// O = alpha O + P V with P turned from the S accumulator into the A
// fragment in registers and V's rows as the row-indexed B, into a fresh
// accumulator added by a rounded f32 add.  At the end the second half's
// (m, l, O) go through the dead ring and the first half merges them, always
// in that order: two launches are bitwise equal.  Under a window the walk
// starts at the stage holding row q0's first visible key, and the mask
// also covers the window's lower edge.  The -inf guards are the TPU
// kernel's: a row with no valid key keeps m = -inf and alpha = 0; a row
// whose l stays 0 writes zeros and lse = +inf.
template <int DP, bool WIN>
__global__ void __launch_bounds__(kF32Threads, FwdF32<DP>::kMinBlocks)
    flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     const FwdF32Params p) {
  using F = FwdF32<DP>;
  constexpr int LD = F::kLd, KB = F::kKeys, KW = F::kWarpKeys, NK = KW / 8,
                NC = DP / 8;
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  float* q_s = reinterpret_cast<float*>(tf32_smem);
  float* ring = q_s + F::kRows * LD;

  const int heads = p.H * p.B;
  const int step = blockIdx.x / heads, hb = blockIdx.x - step * heads;
  const int qb = p.causal ? p.n_qb - 1 - step : step;
  const int h = hb % p.H, b = hb / p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qb * F::kRows;
  const int kv_lim = min(p.Skv, p.kv_len);
  int n_kb = kv_lim > 0 ? (kv_lim + KB - 1) / KB : 0;
  if (p.causal) n_kb = min(n_kb, (min(q0 + F::kRows, p.Sq) - 1) / KB + 1);
  // Under a window the walk starts at the block of row q0's first key.
  const int kb0 = WIN ? max(0, q0 - p.window + 1) / KB : 0;

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rg = warp % F::kGroups, kh = warp / F::kGroups;
  const float* kbase = k + b * p.k_sb + hk * p.k_sh;
  const float* vbase = v + b * p.v_sb + hk * p.v_sh;
  auto load_step = [&](int kb, int stage) {
    float* k_s = ring + stage * F::kStage;
    load_rows_f32<DP, KB>(k_s, kbase, p.k_ss, kb * KB, p.Skv, p.d);
    load_rows_f32<DP, KB>(k_s + KB * LD, vbase, p.v_ss, kb * KB, p.Skv, p.d);
  };
  load_rows_f32<DP, F::kRows>(q_s, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0,
                              p.Sq, p.d);
  if (kb0 < n_kb) load_step(kb0, kb0 % F::kStages);
  cp_async_commit();

  const int row0 = q0 + 16 * rg + g;  // the thread's rows row0, row0 + 8
  const float* qr = q_s + 16 * rg * LD;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.0f, 0.0f};  // the thread's partial row sums
  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  for (int kb = kb0; kb < n_kb; ++kb) {
    cp_async_wait<0>();
    __syncthreads();  // stage kb has landed; stage kb - 1 is read
    if (kb + 1 < n_kb) load_step(kb + 1, (kb + 1) % F::kStages);
    cp_async_commit();
    const int k0 = kb * KB + kh * KW;  // the warp's first key
    const float* k_s = ring + (kb % F::kStages) * F::kStage + kh * KW * LD;
    const float* v_s = k_s + KB * LD;

    // S = Q K^T over the warp's 16 rows and KW keys.
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll (F::kUnroll)
    for (int kk = 0; kk < DP; kk += 8) {
      if (kk >= p.d) break;
      FragA fq;
      load_a_rows(fq, qr + kk, LD, g, t);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        FragB fb;
        load_b_rows(fb, k_s + 8 * j * LD + kk, LD, g, t);
        mma_tf32x3(s[j], fq, fb);
      }
    }

    // The online softmax, base 2: P = exp2(S scale log2(e) - m) in place.
    const bool edge =
        k0 + KW > kv_lim || (p.causal && k0 + KW - 1 > q0 + 16 * rg) ||
        (WIN && q0 + 16 * rg + 15 - k0 >= p.window);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key >= kv_lim || (p.causal && row < key) ||
              (WIN && row - key >= p.window))
            x = -CUDART_INF_F;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float safe = m_new == -CUDART_INF_F ? 0.0f : m_new;
      alpha[r] = m[r] == -CUDART_INF_F ? 0.0f : exp2f(m[r] - safe);
      m[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = exp2f(s[j][2 * r + e] - safe);  // 0 at -inf
          s[j][2 * r + e] = pv;
          sum += pv;
        }
      l[r] = l[r] * alpha[r] + sum;
    }

    // O = alpha O + P V.
    FragA fa[NK];
#pragma unroll
    for (int j = 0; j < NK; ++j) ka_from_acc(fa[j], s[j]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (8 * c >= p.d) continue;
      float part[4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        FragB fb;
        load_b_cols_pairs(fb, v_s + 8 * j * LD + 8 * c, LD, g, t);
        if (j == 0)
          mma_tf32x3_fresh(part, fa[j], fb);
        else
          mma_tf32x3(part, fa[j], fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[c][e] = acc[c][e] * alpha[e >> 1] + part[e];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it takes the merge

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // Key split kh > 0 leaves its rows' O, m and l (columns DP, DP + 1 of the
  // padded row) in slot kh - 1 of the ring; split 0 merges the slots in
  // order.
  if (kh > 0) {
    float* slot = ring + (kh - 1) * F::kRows * LD + 16 * rg * LD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* row = slot + (g + 8 * r) * LD;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        *reinterpret_cast<float2*>(row + 8 * c + 2 * t) =
            make_float2(acc[c][2 * r], acc[c][2 * r + 1]);
      if (t == 0) {
        row[DP] = m[r];
        row[DP + 1] = l[r];
      }
    }
  }
  __syncthreads();
  if (kh > 0) return;
#pragma unroll
  for (int sp = 1; sp < F::kSplits; ++sp) {
    const float* slot = ring + (sp - 1) * F::kRows * LD + 16 * rg * LD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* row = slot + (g + 8 * r) * LD;
      const float mb = row[DP], lb = row[DP + 1];
      const float mn = fmaxf(m[r], mb);
      const float fa = m[r] == -CUDART_INF_F ? 0.0f : exp2f(m[r] - mn);
      const float fb = mb == -CUDART_INF_F ? 0.0f : exp2f(mb - mn);
      m[r] = mn;
      l[r] = l[r] * fa + lb * fb;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (8 * c >= p.d) continue;
        const float2 ob =
            *reinterpret_cast<const float2*>(row + 8 * c + 2 * t);
        acc[c][2 * r] = acc[c][2 * r] * fa + ob.x * fb;
        acc[c][2 * r + 1] = acc[c][2 * r + 1] * fa + ob.y * fb;
      }
    }
  }

  // Divide by l and store two floats a thread a column block; lse = m ln 2
  // + ln l (m is in base-2 units of the scaled scores).
  float* og = o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
    if (p.lse != nullptr && t == 0)
      p.lse[(static_cast<size_t>(b) * p.H + h) * p.Sq + row] =
          l[r] > 0.0f ? m[r] * kLn2 + logf(l[r]) : CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < p.d)
        *reinterpret_cast<float2*>(og + row * p.o_ss + col) =
            make_float2(acc[c][2 * r] * inv, acc[c][2 * r + 1] * inv);
    }
  }
}

// The launch at DP; `q_rows`, `kv_rows`, `ctas` and `smem` are the caller's
// plan and must be this instantiation's.
template <int DP, bool WIN>
cudaError_t launch_fwd_tf32x3(const float* q, const float* k, const float* v,
                              float* o, const FwdF32Params& p, int q_rows,
                              int kv_rows, long long ctas, long long smem,
                              cudaStream_t s) {
  using F = FwdF32<DP>;
  const long long grid = static_cast<long long>(p.n_qb) * p.H * p.B;
  if (q_rows != F::kRows || kv_rows != F::kKeys || ctas != grid ||
      smem != static_cast<long long>(F::kSmem))
    return cudaErrorInvalidValue;
  static const cudaError_t opted =
      opt_in_smem(flash_fwd_tf32x3<DP, WIN>, F::kSmem);
  if (opted != cudaSuccess) return opted;
  flash_fwd_tf32x3<DP, WIN><<<static_cast<unsigned>(grid), kF32Threads,
                              F::kSmem, s>>>(q, k, v, o, p);
  return cudaGetLastError();
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

bool valid_shape(int B, int H, int Hkv, int Sq, int Skv, int d, int block_q) {
  const long long n_qb = (Sq + block_q - 1) / block_q;
  return B > 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && Sq > 0 && Skv > 0 &&
         d > 0 && d % 8 == 0 && d <= kMaxD && n_qb * H * B <= 0x7fffffffLL;
}

// ---------------------------------------------------------------------------
// Backward.  delta = rowsum(dO o O) first (flash_bwd_delta, either dtype);
// then bf16 runs the two wgmma kernels below and f32 the split-TF32
// kernels further down.
// ---------------------------------------------------------------------------

constexpr int kBwdStages = 2;                     // the backward's TMA rings
constexpr int kBwdKVRows = 64;                    // kv rows a dK/dV CTA
constexpr int kBwdQRows = 64;                     // q rows a dQ CTA / ring stage
constexpr int kBwdKeys = 64;                      // keys a dQ ring stage
constexpr uint32_t kStatBytes = 2 * kBwdQRows * 4;  // a q block's lse2, delta

struct BwdParams {
  int B, H, Hkv, Sq, Skv, kv_len, causal, window, d;
  int sq_pad;  // rows a (b, h) of delta / lse2: Sq padded to 64
  float scale, scale_log2;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss, g_sb, g_sh, g_ss;  // g: dO
  // dq (B, H, Sq, d) and dk / dv (B, Hkv, Skv, d) contiguous; lse (B, H,
  // Sq) f32; delta and lse2 (B, H, sq_pad) f32.
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[row] = sum_c dO[row][c] O[row][c], a warp a row, over the B H
// sq_pad rows (0 past Sq).  With lse2 given (the wgmma route) it also
// writes lse2 = lse log2(e), the base-2 exponent offset, +inf past Sq, so
// that a padded q row's P is exp2(-inf) = 0.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ lse2, const BwdParams p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.B) * p.H * p.sq_pad) return;
  const int i = static_cast<int>(row % p.sq_pad);
  const long long bh = row / p.sq_pad;
  float s = 0.0f;
  if (i < p.Sq) {  // the warp's one row: a uniform branch
    const int h = static_cast<int>(bh % p.H), b = static_cast<int>(bh / p.H);
    const T* orow = o + b * p.o_sb + h * p.o_sh + i * p.o_ss;
    const T* grow = dout + b * p.g_sb + h * p.g_sh + i * p.g_ss;
    for (int c = lane; c < p.d; c += 32)
      s = fmaf(to_f32(orow[c]), to_f32(grow[c]), s);
  }
  s = warp_sum(s);
  if (lane == 0) {
    delta[row] = s;
    if (lse2 != nullptr)
      lse2[row] = i < p.Sq ? lse[bh * p.Sq + i] * kLog2e : CUDART_INF_F;
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on wgmma (FlashAttention-2 form, deterministic).
// ---------------------------------------------------------------------------

struct BwdTmaParams {
  int B, H, Hkv, Sq, Skv, kv_len, causal, window, sq_pad;
  float scale, scale_log2;
  const float* lse2;   // (B, H, sq_pad): lse log2(e), +inf past Sq
  const float* delta;  // (B, H, sq_pad): 0 past Sq
};

// The dK/dV kernel's CTA: a producer warpgroup and two consumer
// warpgroups over 64 kv rows, consumer 0 accumulating their dV and
// consumer 1 their dK (two DP-column sums do not fit one thread's
// registers past DP 128).  K and V are loaded once; (Q, dO) tiles of 64 q
// rows and the q block's lse2 and delta come through a kBwdStages ring.
template <int DP>
struct BwdKV {
  static constexpr int kBKV = kBwdKVRows;
  static constexpr int kChunks = DP / 64;
  static constexpr int kCW = DP % 128 == 0 ? 128 : 64;
  static constexpr int kNC = DP / kCW;
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr uint32_t kKVChunk = kBKV * kRowBytes;
  static constexpr uint32_t kKVBytes = kChunks * kKVChunk;
  static constexpr uint32_t kQChunk = kBwdQRows * kRowBytes;
  static constexpr uint32_t kQBytes = kChunks * kQChunk;
  // [K][V][Q dO] x stages [lse2 delta] x stages [kv_full, full x stages,
  // empty x stages]
  static constexpr uint32_t kStatAt = 2 * kKVBytes + kBwdStages * 2 * kQBytes;
  static constexpr uint32_t kBarAt = kStatAt + kBwdStages * kStatBytes;
  static constexpr size_t kSmem = 1024 + kBarAt + 8 * (1 + 2 * kBwdStages);
  static_assert(DP % 64 == 0 && DP <= kMaxD, "DP: 64, 128, 192 or 256");
};

// The dQ kernel's CTA: one consumer warpgroup of 64 q rows and a producer;
// Q and dO loaded once, (K, V) tiles of 64 keys through the ring.  Two
// CTAs an SM up to DP 128 (224 registers a consumer thread after
// setmaxnreg), one above.
template <int DP>
struct BwdQ {
  static constexpr int kChunks = DP / 64;
  static constexpr int kCW = DP % 128 == 0 ? 128 : 64;
  static constexpr int kNC = DP / kCW;
  static constexpr int kMinBlocks = DP <= 128 ? 2 : 1;
  static constexpr int kConsumers = 128;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr uint32_t kQChunk = kBwdQRows * kRowBytes;
  static constexpr uint32_t kQBytes = kChunks * kQChunk;
  static constexpr uint32_t kKVChunk = kBwdKeys * kRowBytes;
  static constexpr uint32_t kKVBytes = kChunks * kKVChunk;
  // [Q][dO][K V] x stages [q_full, full x stages, empty x stages]
  static constexpr uint32_t kBarAt = 2 * kQBytes + kBwdStages * 2 * kKVBytes;
  static constexpr size_t kSmem = 1024 + kBarAt + 8 * (1 + 2 * kBwdStages);
};

// What a dK/dV consumer warpgroup accumulates.
enum BwdRole { kRoleDV, kRoleDK };

// A dK/dV consumer warpgroup: for each ring stage (q block q0 of head h),
// S^T = K Q^T and (for dK) dP^T = V dO^T over the CTA's 64 kv rows (both
// operands K-major tiles), then P^T = exp2(S^T scale log2(e) - lse2) and
// dS^T = P^T o (dP^T - delta) on the fragments -- the accumulator's column
// is the q row, so lse2 and delta come from the stage's shared copy, read
// at columns 8 j + 2 t + e -- converted to bf16 in place (the register-A
// layout), then dV += P^T dO and dK += dS^T Q with dO and Q as MN-major B
// operands (the same [row][d] tiles).  Only tiles that cross the causal
// diagonal, the window's lower edge or the key end are masked; q rows past
// Sq carry lse2 = +inf.  At the end dK takes the softmax scale and is
// stored by TMA through the dead K tile, dV through the dead V tile (rows
// past Skv clipped).
template <int DP, int ROLE, bool WIN>
__device__ __forceinline__ void dkdv_consumer(
    const BwdTmaParams& p, const CUtensorMap* tma_dk,
    const CUtensorMap* tma_dv, uint32_t base, const unsigned char* gbase,
    int wg, int b, int hk, int k0, int qb0, int per_head, int n_steps) {
  using F = BwdKV<DP>;
  constexpr bool kDK = ROLE == kRoleDK;
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, (tid % 128) / 32, 0);
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kv_lim = min(p.Skv, p.kv_len);
  const uint32_t k_s = base, v_s = base + F::kKVBytes;
  const uint32_t kv_full = base + F::kBarAt;

  // acc: dV (warpgroup 0) or dK (warpgroup 1); pa: P^T or dS^T in bf16.
  float acc[F::kNC][F::kCW / 2];
#pragma unroll
  for (int c = 0; c < F::kNC; ++c)
#pragma unroll
    for (int i = 0; i < F::kCW / 2; ++i) acc[c][i] = 0.0f;
  float s[32], dp[32];
  uint32_t pa[4][4];

  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_steps; ++i) {
    const int gi = i / per_head;
    const int q0 = (qb0 + i - gi * per_head) * kBwdQRows;
    const uint32_t q_s = base + 2 * F::kKVBytes + stage * 2 * F::kQBytes;
    const uint32_t do_s = q_s + F::kQBytes;
    mbar_wait(kv_full + 8u * (1 + stage), phase);
    wgmma_fence();
    qk_product<64, DP>(s, k_s, F::kKVChunk, q_s, F::kQChunk);
    if constexpr (kDK)
      qk_product<64, DP>(dp, v_s, F::kKVChunk, do_s, F::kQChunk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    if constexpr (kDK) fence_acc(dp);
    const float* st = reinterpret_cast<const float*>(
        gbase + F::kStatAt + stage * kStatBytes);
    const bool edge = (p.causal && q0 < k0 + 63) || k0 + 64 > kv_lim ||
                      (WIN && q0 + 63 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(st + kBwdQRows + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * p.scale_log2 - ((e & 1) ? l2.y : l2.x);
        if (edge) {
          const int key = k0 + warp * 16 + g + 8 * (e >> 1);
          const int qi = q0 + 8 * j + 2 * t + (e & 1);
          if (key >= kv_lim || (p.causal && qi < key) ||
              (WIN && qi - key >= p.window))
            x = -CUDART_INF_F;
        }
        const float pv = exp2f(x);
        s[4 * j + e] = pv;
        if constexpr (kDK)
          dp[4 * j + e] = pv * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
    }
    // dV += P^T dO, or dK += dS^T Q.
    if constexpr (kDK)
      pack_p<64>(pa, dp);
    else
      pack_p<64>(pa, s);
    wgmma_fence();
    pv_product<64, F::kCW, F::kNC>(acc, pa, kDK ? q_s : do_s, F::kQChunk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_o<F::kCW, F::kNC>(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_frag(pa[kk]);
    mbar_arrive(kv_full + 8u * (1 + kBwdStages + stage));
    if (++stage == kBwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // The other warpgroup may still read the K / V tile this one overwrites.
  named_sync(1, F::kConsumers);
  const float one[2] = {1.0f, 1.0f}, scale[2] = {p.scale, p.scale};
  const uint32_t out_s = kDK ? k_s : v_s;
  stage_bf16<F::kCW, F::kNC>(acc, out_s, F::kKVChunk, kDK ? scale : one,
                             warp, g, t);
  fence_proxy_async();
  named_sync(2 + wg, 128);
  if (tid % 128 == 0)
    store_tile<F::kChunks>(kDK ? tma_dk : tma_dv, out_s, F::kKVChunk, k0, hk,
                           b);
}

// One CTA per (kv block, kv head, batch), kv block 0 first: under causal
// it walks the most q blocks.  The CTA walks the q heads of its GQA group
// and their q blocks, under causal from its own diagonal, under a window
// up to the last q block that still sees one of its keys.
template <int DP, bool WIN>
__global__ void __launch_bounds__(BwdKV<DP>::kThreads, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tma_q,
                         const __grid_constant__ CUtensorMap tma_k,
                         const __grid_constant__ CUtensorMap tma_v,
                         const __grid_constant__ CUtensorMap tma_do,
                         const __grid_constant__ CUtensorMap tma_dk,
                         const __grid_constant__ CUtensorMap tma_dv,
                         const __grid_constant__ BwdTmaParams p) {
  using F = BwdKV<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t kv_full = base + F::kBarAt;
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + kBwdStages + s); };

  const int bhk = p.B * p.Hkv;
  const int kvb = blockIdx.x / bhk, hb = blockIdx.x - kvb * bhk;
  const int hk = hb % p.Hkv, b = hb / p.Hkv;
  const int k0 = kvb * F::kBKV;
  const int group = p.H / p.Hkv;
  const int n_qb = (p.Sq + kBwdQRows - 1) / kBwdQRows;
  // Under causal, query i sees key j iff i >= j: q blocks from k0's.
  const int qb0 = p.causal ? min(k0 / kBwdQRows, n_qb) : 0;
  // Under a window, query i sees key j only if i - j < window: q blocks up
  // to the one holding query k0 + 63 + window - 1.
  const int qb_end =
      WIN ? min(n_qb, (k0 + 63 + p.window - 1) / kBwdQRows + 1)
                   : n_qb;
  const int per_head =
      k0 < min(p.Skv, p.kv_len) ? max(0, qb_end - qb0) : 0;
  const int n_steps = group * per_head;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), F::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == F::kConsumers) {
      mbar_expect_tx(kv_full, 2 * F::kKVBytes);
#pragma unroll
      for (int c = 0; c < F::kChunks; ++c) {
        tma_load_4d(base + c * F::kKVChunk, &tma_k, kv_full, 64 * c, k0, hk,
                    b);
        tma_load_4d(base + F::kKVBytes + c * F::kKVChunk, &tma_v, kv_full,
                    64 * c, k0, hk, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_steps; ++i) {
        const int gi = i / per_head;
        const int qb = qb0 + i - gi * per_head;
        const int h = hk * group + gi;
        const uint32_t q_s = base + 2 * F::kKVBytes + stage * 2 * F::kQBytes;
        const uint32_t st = base + F::kStatAt + stage * kStatBytes;
        const size_t row = (static_cast<size_t>(b) * p.H + h) * p.sq_pad +
                           qb * kBwdQRows;
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), 2 * F::kQBytes + kStatBytes);
#pragma unroll
        for (int c = 0; c < F::kChunks; ++c) {
          tma_load_4d(q_s + c * F::kQChunk, &tma_q, full(stage), 64 * c,
                      qb * kBwdQRows, h, b);
          tma_load_4d(q_s + F::kQBytes + c * F::kQChunk, &tma_do,
                      full(stage), 64 * c, qb * kBwdQRows, h, b);
        }
        bulk_load(st, p.lse2 + row, kStatBytes / 2, full(stage));
        bulk_load(st + kStatBytes / 2, p.delta + row, kStatBytes / 2,
                  full(stage));
        if (++stage == kBwdStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const unsigned char* gbase = smem_raw + (base - raw);
  if (wg == 0)
    dkdv_consumer<DP, kRoleDV, WIN>(p, &tma_dk, &tma_dv, base, gbase, wg, b,
                                    hk, k0, qb0, per_head, n_steps);
  else
    dkdv_consumer<DP, kRoleDK, WIN>(p, &tma_dk, &tma_dv, base, gbase, wg, b,
                                    hk, k0, qb0, per_head, n_steps);
}

// One CTA per (64-row q block, head, batch), the heaviest causal q block
// first; under a window its walk starts at the key block of row q0's first
// visible key.  Per kv block: S = Q K^T and dP = dO V^T (K-major), P and dS
// on the fragments (row-indexed lse2 and delta, two rows a thread, in
// registers), dQ += dS K with K as an MN-major B.  dQ takes the softmax
// scale once and is stored by TMA through the dead Q tile.
template <int DP, bool WIN>
__global__ void __launch_bounds__(BwdQ<DP>::kThreads, BwdQ<DP>::kMinBlocks)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tma_q,
                       const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v,
                       const __grid_constant__ CUtensorMap tma_do,
                       const __grid_constant__ CUtensorMap tma_dq,
                       const __grid_constant__ BwdTmaParams p) {
  using F = BwdQ<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_at = base, do_at = base + F::kQBytes;
  auto k_at = [&](int s) { return base + 2 * F::kQBytes + s * 2 * F::kKVBytes; };
  auto v_at = [&](int s) { return k_at(s) + F::kKVBytes; };
  const uint32_t q_full = base + F::kBarAt;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + kBwdStages + s); };

  const int heads = p.H * p.B;
  const int n_qb = (p.Sq + kBwdQRows - 1) / kBwdQRows;
  const int step = blockIdx.x / heads, hb = blockIdx.x - step * heads;
  const int qb = p.causal ? n_qb - 1 - step : step;
  const int h = hb % p.H, b = hb / p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qb * kBwdQRows;
  const int kv_lim = min(p.Skv, p.kv_len);
  int n_kb = kv_lim > 0 ? (kv_lim + kBwdKeys - 1) / kBwdKeys : 0;
  if (p.causal)
    n_kb = min(n_kb, (min(q0 + kBwdQRows, p.Sq) - 1) / kBwdKeys + 1);
  // Under a window the walk starts at the block of row q0's first key.
  const int kb0 = WIN ? max(0, q0 - p.window + 1) / kBwdKeys : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), F::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wg == 1) {
    if constexpr (F::kMinBlocks == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (tid == F::kConsumers) {
      mbar_expect_tx(q_full, 2 * F::kQBytes);
#pragma unroll
      for (int c = 0; c < F::kChunks; ++c) {
        tma_load_4d(q_at + c * F::kQChunk, &tma_q, q_full, 64 * c, q0, h, b);
        tma_load_4d(do_at + c * F::kQChunk, &tma_do, q_full, 64 * c, q0, h,
                    b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = kb0; kb < n_kb; ++kb) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), 2 * F::kKVBytes);
#pragma unroll
        for (int c = 0; c < F::kChunks; ++c) {
          tma_load_4d(k_at(stage) + c * F::kKVChunk, &tma_k, full(stage),
                      64 * c, kb * kBwdKeys, hk, b);
          tma_load_4d(v_at(stage) + c * F::kKVChunk, &tma_v, full(stage),
                      64 * c, kb * kBwdKeys, hk, b);
        }
        if (++stage == kBwdStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if constexpr (F::kMinBlocks == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // row0 + 8 r < sq_pad: the scratch is padded
    const size_t at = (static_cast<size_t>(b) * p.H + h) * p.sq_pad + row0 +
                      8 * r;
    lse2[r] = p.lse2[at];
    dl[r] = p.delta[at];
  }
  float dq[F::kNC][F::kCW / 2];
#pragma unroll
  for (int c = 0; c < F::kNC; ++c)
#pragma unroll
    for (int i = 0; i < F::kCW / 2; ++i) dq[c][i] = 0.0f;
  float s[32], dp[32];
  uint32_t da[4][4];

  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kb = kb0; kb < n_kb; ++kb) {
    const int k0 = kb * kBwdKeys;
    mbar_wait(full(stage), phase);
    wgmma_fence();
    qk_product<64, DP>(s, q_at, F::kQChunk, k_at(stage), F::kKVChunk);
    qk_product<64, DP>(dp, do_at, F::kQChunk, v_at(stage), F::kKVChunk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    const bool edge =
        k0 + kBwdKeys > kv_lim || (p.causal && k0 + kBwdKeys - 1 > q0) ||
        (WIN && q0 + 63 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[4 * j + e] * p.scale_log2 - lse2[r];
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * r;
          if (key >= kv_lim || (p.causal && row < key) ||
              (WIN && row - key >= p.window))
            x = -CUDART_INF_F;
        }
        dp[4 * j + e] = exp2f(x) * (dp[4 * j + e] - dl[r]);
      }
    pack_p<64>(da, dp);
    wgmma_fence();
    pv_product<64, F::kCW, F::kNC>(dq, da, k_at(stage), F::kKVChunk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_o<F::kCW, F::kNC>(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_frag(da[kk]);
    mbar_arrive(empty(stage));
    if (++stage == kBwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Every product that read the Q tile has completed: stage dQ there.
  const float scale[2] = {p.scale, p.scale};
  stage_bf16<F::kCW, F::kNC>(dq, q_at, F::kQChunk, scale, warp, g, t);
  fence_proxy_async();
  named_sync(1, 128);
  if (tid == 0) store_tile<F::kChunks>(&tma_dq, q_at, F::kQChunk, q0, h, b);
}

struct BwdOperands {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long g_sb, g_sh, g_ss;
};

// The dK/dV launch at DP; `smem` and `ctas` are the caller's plan of its
// shared memory and grid and must be this instantiation's.
template <int DP, bool WIN>
cudaError_t launch_dkdv(const BwdOperands& a, const BwdTmaParams& p, int d,
                        long long smem, long long ctas, cudaStream_t stream) {
  using F = BwdKV<DP>;
  const long long grid =
      static_cast<long long>((p.Skv + F::kBKV - 1) / F::kBKV) * p.B * p.Hkv;
  if (smem != static_cast<long long>(F::kSmem) || ctas != grid)
    return cudaErrorInvalidValue;
  static const cudaError_t opted =
      opt_in_smem(flash_bwd_dkdv_wgmma<DP, WIN>, F::kSmem);
  if (opted != cudaSuccess) return opted;
  const long long dd = d, kv_head = static_cast<long long>(p.Skv) * d;
  CUtensorMap tq, tk, tv, tg, tdk, tdv;
  if (!encode_4d(&tq, a.q, d, p.Sq, p.H, p.B, a.q_ss, a.q_sh, a.q_sb,
                 kBwdQRows) ||
      !encode_4d(&tk, a.k, d, p.Skv, p.Hkv, p.B, a.k_ss, a.k_sh, a.k_sb,
                 F::kBKV) ||
      !encode_4d(&tv, a.v, d, p.Skv, p.Hkv, p.B, a.v_ss, a.v_sh, a.v_sb,
                 F::kBKV) ||
      !encode_4d(&tg, a.dout, d, p.Sq, p.H, p.B, a.g_ss, a.g_sh, a.g_sb,
                 kBwdQRows) ||
      !encode_4d(&tdk, a.dk, d, p.Skv, p.Hkv, p.B, dd, kv_head,
                 kv_head * p.Hkv, 64) ||
      !encode_4d(&tdv, a.dv, d, p.Skv, p.Hkv, p.B, dd, kv_head,
                 kv_head * p.Hkv, 64))
    return cudaErrorInvalidValue;
  flash_bwd_dkdv_wgmma<DP, WIN><<<static_cast<unsigned>(grid), F::kThreads,
                                  F::kSmem, stream>>>(tq, tk, tv, tg, tdk,
                                                      tdv, p);
  return cudaGetLastError();
}

template <int DP, bool WIN>
cudaError_t launch_dq(const BwdOperands& a, const BwdTmaParams& p, int d,
                      long long smem, long long ctas, cudaStream_t stream) {
  using F = BwdQ<DP>;
  const long long grid =
      static_cast<long long>(p.sq_pad / kBwdQRows) * p.H * p.B;
  if (smem != static_cast<long long>(F::kSmem) || ctas != grid)
    return cudaErrorInvalidValue;
  static const cudaError_t opted = opt_in_smem(flash_bwd_dq_wgmma<DP, WIN>,
                                               F::kSmem);
  if (opted != cudaSuccess) return opted;
  const long long dd = d, q_head = static_cast<long long>(p.Sq) * d;
  CUtensorMap tq, tk, tv, tg, tdq;
  if (!encode_4d(&tq, a.q, d, p.Sq, p.H, p.B, a.q_ss, a.q_sh, a.q_sb,
                 kBwdQRows) ||
      !encode_4d(&tk, a.k, d, p.Skv, p.Hkv, p.B, a.k_ss, a.k_sh, a.k_sb,
                 kBwdKeys) ||
      !encode_4d(&tv, a.v, d, p.Skv, p.Hkv, p.B, a.v_ss, a.v_sh, a.v_sb,
                 kBwdKeys) ||
      !encode_4d(&tg, a.dout, d, p.Sq, p.H, p.B, a.g_ss, a.g_sh, a.g_sb,
                 kBwdQRows) ||
      !encode_4d(&tdq, a.dq, d, p.Sq, p.H, p.B, dd, q_head, q_head * p.H, 64))
    return cudaErrorInvalidValue;
  flash_bwd_dq_wgmma<DP, WIN><<<static_cast<unsigned>(grid), F::kThreads,
                                F::kSmem, stream>>>(tq, tk, tv, tg, tdq, p);
  return cudaGetLastError();
}

// dK/dV, then dQ, at DP.
template <int DP, bool WIN>
cudaError_t launch_bwd_wgmma(const BwdOperands& a, const BwdTmaParams& p,
                             int d, long long kv_smem, long long q_smem,
                             long long kv_ctas, long long q_ctas,
                             cudaStream_t s) {
  const cudaError_t err = launch_dkdv<DP, WIN>(a, p, d, kv_smem, kv_ctas, s);
  if (err != cudaSuccess) return err;
  return launch_dq<DP, WIN>(a, p, d, q_smem, q_ctas, s);
}

// ---------------------------------------------------------------------------
// f32 backward on the tensor cores: the bf16 route's structure with every
// product in split TF32 (tf32x3.cuh, mma.sync) and the sums and the softmax
// algebra in f32, on the forward's f32 tiles (above); one [row][d] tile
// serves as the K-major operand of Q K^T and dO V^T
// (fragment loads across its rows) and as the row-indexed B of P^T dO,
// dS^T Q and dS K (loads across its columns, k in the paired order of the
// register A operand): P and dS never leave the registers and no tile is
// transposed.  Products skip the 8-column blocks past d.
//  * flash_bwd_dkdv_tf32x3: one CTA per (64 kv rows, q head, batch), kv
//    block 0 first, walking the head's q blocks (under causal from its
//    diagonal) through a 2-stage ring of (Q, dO) tiles with the block's
//    lse2 and delta; K and V loaded once.  8 warps: warp w holds kv rows
//    16 (w % 4) and accumulates their dV (w < 4) or dK (w >= 4).  Each
//    computes one product of scores a step, S^T = K Q^T (dV) or
//    dP^T = V dO^T (dK), and the dV warp hands P^T to its dK partner
//    through shared memory: two products a warp a step, none twice.
//    Under GQA a CTA per q head, not per kv head, cuts the longest CTA's
//    walk by the group size (24 q-block steps to 8 at the f32 training
//    shape); each writes its head's dK, dV to a scratch, and
//    flash_bwd_group_sum adds a group's heads in head order.
//  * flash_bwd_dq_tf32x3: one CTA per (64 q rows, head, batch), heaviest
//    causal block first; Q and dO loaded once, (K, V) tiles through the
//    ring.  Warp w holds q rows 16 (w % 4) and half of each stage's keys
//    (w / 4); the two halves' dQ are added in a fixed order at the end.
// Past a head dim of 128 the ring's stages hold fewer rows (kBwdF32Rows)
// so that K, V and two stages fit 227 KB.  No atomics: two launches are
// bitwise equal.
// ---------------------------------------------------------------------------

template <int DP>
struct BwdF32 {
  static constexpr int kLd = DP + 4;         // floats a tile row
  static constexpr int kRows = 64;           // kv rows a dK/dV CTA, q rows a dQ CTA
  // q rows a dK/dV stage, keys a dQ stage
  static constexpr int kStep = DP <= 128 ? 64 : (DP <= 192 ? 32 : 16);
  static constexpr int kStages = 2;
  static constexpr int kThreads = kF32Threads;
  // k8 steps of a score product unrolled together: past DP 128 the
  // accumulators of the head dim leave no registers for more.
  static constexpr int kUnroll = DP <= 128 ? 4 : 1;
  static constexpr int kStatFloats = 2 * kStep;  // lse2, delta of a stage
  static constexpr int kKVStage = 2 * kStep * kLd + kStatFloats;
  // P^T handed from the dV warps to the dK warps: 4 row groups x 32 lanes
  // x the kStep / 2 values of a thread's fragments.
  static constexpr int kXFloats = 4 * 32 * (kStep / 2);
  static constexpr size_t kKVSmem =
      sizeof(float) * (2 * kRows * kLd + kStages * kKVStage + kXFloats);
  static constexpr int kQStage = 2 * kStep * kLd;
  static constexpr size_t kQSmem =
      sizeof(float) * (2 * kRows * kLd + kStages * kQStage);
  static_assert(DP % 64 == 0 && DP <= kMaxD, "DP: 64, 128, 192 or 256");
  static_assert(kKVSmem <= 232448 && kQSmem <= 232448, "227 KB a CTA");
};

// n floats (a multiple of 4) from global to shared memory.
__device__ __forceinline__ void load_floats(float* dst, const float* src,
                                            int n) {
  for (int c = threadIdx.x * 4; c < n; c += 4 * 256)
    cp_async16(dst + c, src + c, true);
}

template <int DP, bool WIN>
__global__ void __launch_bounds__(BwdF32<DP>::kThreads, 1)
    flash_bwd_dkdv_tf32x3(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          float* __restrict__ part, const BwdParams p) {
  using F = BwdF32<DP>;
  constexpr int LD = F::kLd, QR = F::kStep, NQ = QR / 8, NC = DP / 8;
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  float* k_s = reinterpret_cast<float*>(tf32_smem);
  float* v_s = k_s + F::kRows * LD;
  float* ring = v_s + F::kRows * LD;

  const int bh = p.B * p.H;
  const int kvb = blockIdx.x / bh, hb = blockIdx.x - kvb * bh;
  const int h = hb % p.H, b = hb / p.H;
  const int group = p.H / p.Hkv, hk = h / group;
  const int k0 = kvb * F::kRows;
  const int kv_lim = min(p.Skv, p.kv_len);
  const int n_qb = (p.Sq + QR - 1) / QR;
  // Under causal, query i sees key j iff i >= j: q blocks from k0's; under
  // a window up to the one holding query k0 + 63 + window - 1.
  const int qb0 = p.causal ? min(k0 / QR, n_qb) : 0;
  const int qb_end =
      WIN ? min(n_qb, (k0 + 63 + p.window - 1) / QR + 1) : n_qb;
  const int n_steps = k0 < kv_lim ? max(0, qb_end - qb0) : 0;

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rg = warp % 4;
  const bool kDK = warp >= 4;  // warp-uniform role

  auto load_step = [&](int i, int stage) {
    const int qb = qb0 + i;
    float* q_s = ring + stage * F::kKVStage;
    load_rows_f32<DP, QR>(q_s, q + b * p.q_sb + h * p.q_sh, p.q_ss, qb * QR,
                          p.Sq, p.d);
    load_rows_f32<DP, QR>(q_s + QR * LD, dout + b * p.g_sb + h * p.g_sh,
                          p.g_ss, qb * QR, p.Sq, p.d);
    const size_t row = (static_cast<size_t>(b) * p.H + h) * p.sq_pad + qb * QR;
    load_floats(q_s + 2 * QR * LD, lse2 + row, QR);
    load_floats(q_s + 2 * QR * LD + QR, delta + row, QR);
  };

  load_rows_f32<DP, 64>(k_s, k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.Skv,
                        p.d);
  load_rows_f32<DP, 64>(v_s, v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.Skv,
                        p.d);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
  const float* kr = k_s + 16 * rg * LD;
  const float* vr = v_s + 16 * rg * LD;
  // A dV warp's P^T for the dK warp of its rows: [row group][j][e][lane].
  float* xb = ring + F::kStages * F::kKVStage + rg * NQ * 4 * 32 + lane;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // step i has landed; step i - 1's stage is read
    if (i + 1 < n_steps) load_step(i + 1, (i + 1) % F::kStages);
    cp_async_commit();
    const int q0 = (qb0 + i) * QR;
    const float* q_s = ring + (i % F::kStages) * F::kKVStage;
    const float* do_s = q_s + QR * LD;
    const float* st = do_s + QR * LD;

    // The dV warp: S^T = K Q^T over its 16 kv rows; the dK warp of the same
    // rows: dP^T = V dO^T.
    float s[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    const float* a_rows = kDK ? vr : kr;
    const float* b_rows = kDK ? do_s : q_s;
#pragma unroll (F::kUnroll)
    for (int kk = 0; kk < DP; kk += 8) {
      if (kk >= p.d) break;
      FragA fa;
      load_a_rows(fa, a_rows + kk, LD, g, t);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        FragB fb;
        load_b_rows(fb, b_rows + 8 * j * LD + kk, LD, g, t);
        mma_tf32x3(s[j], fa, fb);
      }
    }
    // The dV warp: P^T = exp2(S^T scale log2(e) - lse2), the accumulator's
    // column being the q row, handed to its dK partner through shared
    // memory (each thread's own fragment positions); the dK warp:
    // dS^T = P^T o (dP^T - delta).
    if (!kDK) {
      const bool edge = (p.causal && q0 < k0 + 63) || k0 + 64 > kv_lim ||
                        (WIN && q0 + QR - 1 - k0 >= p.window);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          float x = s[j][e] * p.scale_log2 - st[qc];
          if (edge) {
            const int key = k0 + 16 * rg + g + 8 * (e >> 1);
            if (key >= kv_lim || (p.causal && q0 + qc < key) ||
                (WIN && q0 + qc - key >= p.window))
              x = -CUDART_INF_F;
          }
          s[j][e] = exp2f(x);
          xb[(j * 4 + e) * 32] = s[j][e];
        }
    }
    named_sync(1 + rg, 64);  // the pair's P^T is written
    if (kDK) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          s[j][e] = xb[(j * 4 + e) * 32] * (s[j][e] - st[QR + qc]);
        }
    }
    // dV += P^T dO, or dK += dS^T Q: the step's products a fragment in a
    // fresh accumulator, then one rounded add into the running sum.
    const float* rows = kDK ? q_s : do_s;
    FragA fa[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) ka_from_acc(fa[j], s[j]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (8 * c >= p.d) continue;
      float part[4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        FragB fb;
        load_b_cols_pairs(fb, rows + 8 * j * LD + 8 * c, LD, g, t);
        if (j == 0)
          mma_tf32x3_fresh(part, fa[j], fb);
        else
          mma_tf32x3(part, fa[j], fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += part[e];
    }
  }
  cp_async_wait<0>();

  // Without GQA straight to dK / dV; else to the head's slot of the scratch.
  const float mul = kDK ? p.scale : 1.0f;
  float* out = group == 1
                   ? (kDK ? dk : dv) +
                         (static_cast<size_t>(b) * p.Hkv + hk) * p.Skv * p.d
                   : part + (kDK ? 0 : static_cast<size_t>(bh) * p.Skv * p.d) +
                         static_cast<size_t>(hb) * p.Skv * p.d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + 16 * rg + g + 8 * h;
    if (row >= p.Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < p.d)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * p.d +
                                   col) =
            make_float2(acc[c][2 * h] * mul, acc[c][2 * h + 1] * mul);
    }
  }
}

template <int DP, bool WIN>
__global__ void __launch_bounds__(BwdF32<DP>::kThreads, 1)
    flash_bwd_dq_tf32x3(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse2,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, const BwdParams p) {
  using F = BwdF32<DP>;
  constexpr int LD = F::kLd, KB = F::kStep, NK = KB / 16, NC = DP / 8;
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  float* q_s = reinterpret_cast<float*>(tf32_smem);
  float* do_s = q_s + F::kRows * LD;
  float* ring = do_s + F::kRows * LD;

  const int heads = p.H * p.B;
  const int n_qb = p.sq_pad / F::kRows;
  const int step = blockIdx.x / heads, hb = blockIdx.x - step * heads;
  const int qb = p.causal ? n_qb - 1 - step : step;
  const int h = hb % p.H, b = hb / p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qb * F::kRows;
  const int kv_lim = min(p.Skv, p.kv_len);
  int n_kb = kv_lim > 0 ? (kv_lim + KB - 1) / KB : 0;
  if (p.causal) n_kb = min(n_kb, (min(q0 + F::kRows, p.Sq) - 1) / KB + 1);
  // Under a window the walk starts at the stage of row q0's first key.
  const int kb0 = WIN ? max(0, q0 - p.window + 1) / KB : 0;

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rg = warp % 4, kh = warp / 4;
  const float* kbase = k + b * p.k_sb + hk * p.k_sh;
  const float* vbase = v + b * p.v_sb + hk * p.v_sh;
  auto load_step = [&](int kb, int stage) {
    float* k_s = ring + stage * F::kQStage;
    load_rows_f32<DP, KB>(k_s, kbase, p.k_ss, kb * KB, p.Skv, p.d);
    load_rows_f32<DP, KB>(k_s + KB * LD, vbase, p.v_ss, kb * KB, p.Skv, p.d);
  };
  load_rows_f32<DP, 64>(q_s, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq,
                        p.d);
  load_rows_f32<DP, 64>(do_s, dout + b * p.g_sb + h * p.g_sh, p.g_ss, q0,
                        p.Sq, p.d);
  if (kb0 < n_kb) load_step(kb0, kb0 % F::kStages);
  cp_async_commit();

  // The thread's two q rows (the scratch is padded to sq_pad rows).
  const int row0 = q0 + 16 * rg + g;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at =
        (static_cast<size_t>(b) * p.H + h) * p.sq_pad + row0 + 8 * r;
    l2[r] = lse2[at];
    dl[r] = delta[at];
  }
  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
  const float* qr = q_s + 16 * rg * LD;
  const float* gr = do_s + 16 * rg * LD;

  for (int kb = kb0; kb < n_kb; ++kb) {
    cp_async_wait<0>();
    __syncthreads();
    if (kb + 1 < n_kb) load_step(kb + 1, (kb + 1) % F::kStages);
    cp_async_commit();
    const int k0 = kb * KB + kh * (KB / 2);  // the warp's first key
    const float* k_s = ring + (kb % F::kStages) * F::kQStage + kh * (KB / 2) * LD;
    const float* v_s = k_s + KB * LD;

    // S = Q K^T and dP = dO V^T over the warp's 16 q rows and KB / 2 keys.
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll (F::kUnroll)
    for (int kk = 0; kk < DP; kk += 8) {
      if (kk >= p.d) break;
      FragA fq, fo;
      load_a_rows(fq, qr + kk, LD, g, t);
      load_a_rows(fo, gr + kk, LD, g, t);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        FragB fb;
        load_b_rows(fb, k_s + 8 * j * LD + kk, LD, g, t);
        mma_tf32x3(s[j], fq, fb);
        load_b_rows(fb, v_s + 8 * j * LD + kk, LD, g, t);
        mma_tf32x3(dp[j], fo, fb);
      }
    }
    const bool edge =
        k0 + KB / 2 > kv_lim || (p.causal && k0 + KB / 2 - 1 > q0) ||
        (WIN && q0 + 16 * rg + 15 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[j][e] * p.scale_log2 - l2[r];
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * r;
          if (key >= kv_lim || (p.causal && row < key) ||
              (WIN && row - key >= p.window))
            x = -CUDART_INF_F;
        }
        dp[j][e] = exp2f(x) * (dp[j][e] - dl[r]);
      }
    // dQ += dS K, K's rows as the row-indexed B, a fresh accumulator a
    // step as in the dK/dV kernel.
    FragA fa[NK];
#pragma unroll
    for (int j = 0; j < NK; ++j) ka_from_acc(fa[j], dp[j]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (8 * c >= p.d) continue;
      float part[4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        FragB fb;
        load_b_cols_pairs(fb, k_s + 8 * j * LD + 8 * c, LD, g, t);
        if (j == 0)
          mma_tf32x3_fresh(part, fa[j], fb);
        else
          mma_tf32x3(part, fa[j], fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += part[e];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the Q tile: it takes the sums

  // The second key half's dQ goes through the dead Q tile, then the first
  // half adds it, scales and stores: a fixed order, so bitwise repeatable.
  float* red = q_s + 16 * rg * LD;
  if (kh == 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(red + (g + 8 * hh) * LD + 8 * c + 2 * t) =
            make_float2(acc[c][2 * hh], acc[c][2 * hh + 1]);
  }
  __syncthreads();
  if (kh == 1) return;
  float* out = dq + (static_cast<size_t>(b) * p.H + h) * p.Sq * p.d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 8 * c + 2 * t;
      if (col >= p.d) continue;
      const float2 o2 = *reinterpret_cast<const float2*>(
          red + (g + 8 * hh) * LD + col);
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * p.d + col) =
          make_float2((acc[c][2 * hh] + o2.x) * p.scale,
                      (acc[c][2 * hh + 1] + o2.y) * p.scale);
    }
  }
}

// dK and dV of kv head hk = the sum of its group's q heads' slots of the
// scratch (part: dK slots, then dV slots, each (B, H, Skv, d)), in head
// order; a thread a float4.
__global__ void __launch_bounds__(256)
    flash_bwd_group_sum(const float4* __restrict__ part,
                        float4* __restrict__ dk, float4* __restrict__ dv,
                        const BwdParams p) {
  const long long per_head = static_cast<long long>(p.Skv) * p.d / 4;
  const long long n = static_cast<long long>(p.B) * p.Hkv * per_head;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  const long long j = is_v ? i - n : i;
  const long long bhk = j / per_head, at = j - bhk * per_head;
  const int group = p.H / p.Hkv;
  const float4* src = part + (is_v ? static_cast<long long>(p.B) * p.H *
                                         per_head
                                   : 0) +
                      bhk * group * per_head + at;
  float4 s = src[0];
  for (int gi = 1; gi < group; ++gi) {
    const float4 x = src[gi * per_head];
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  (is_v ? dv : dk)[j] = s;
}

// delta and lse2, then dK/dV (and under GQA the group sum), then dQ at DP;
// `kv_smem`, `q_smem` and the grids are the caller's plan and must be this
// instantiation's.
template <int DP, bool WIN>
cudaError_t launch_bwd_tf32x3(const float* q, const float* k, const float* v,
                              const float* dout, const float* lse2,
                              const float* delta, float* dq, float* dk,
                              float* dv, float* part, const BwdParams& p,
                              long long kv_smem, long long q_smem,
                              long long kv_ctas, long long q_ctas,
                              cudaStream_t s) {
  using F = BwdF32<DP>;
  const long long kv_grid =
      static_cast<long long>((p.Skv + F::kRows - 1) / F::kRows) * p.B * p.H;
  const long long q_grid =
      static_cast<long long>(p.sq_pad / F::kRows) * p.B * p.H;
  if (kv_smem != static_cast<long long>(F::kKVSmem) ||
      q_smem != static_cast<long long>(F::kQSmem) || kv_ctas != kv_grid ||
      q_ctas != q_grid || ((p.H != p.Hkv) != (part != nullptr)))
    return cudaErrorInvalidValue;
  static const cudaError_t opted = [] {
    const cudaError_t e =
        opt_in_smem(flash_bwd_dkdv_tf32x3<DP, WIN>, F::kKVSmem);
    return e != cudaSuccess
               ? e
               : opt_in_smem(flash_bwd_dq_tf32x3<DP, WIN>, F::kQSmem);
  }();
  if (opted != cudaSuccess) return opted;
  flash_bwd_dkdv_tf32x3<DP, WIN><<<static_cast<unsigned>(kv_grid),
                                   F::kThreads, F::kKVSmem, s>>>(
      q, k, v, dout, lse2, delta, dk, dv, part, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (part != nullptr) {
    const long long n4 = 2LL * p.B * p.Hkv * p.Skv * p.d / 4;
    flash_bwd_group_sum<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0,
                          s>>>(reinterpret_cast<const float4*>(part),
                               reinterpret_cast<float4*>(dk),
                               reinterpret_cast<float4*>(dv), p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_tf32x3<DP, WIN><<<static_cast<unsigned>(q_grid), F::kThreads,
                                 F::kQSmem, s>>>(q, k, v, dout, lse2, delta,
                                                 dq, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

using namespace repro;

// bf16 q, k, v and o; window 0 for none.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse,
    long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int H, int Hkv,
    int Sq, int Skv, int kv_len, int causal, int window, float scale,
    int block_q, int block_kv, int d, void* stream) {
  // TMA needs 16-byte aligned bases and strides (8 bf16).
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  bool aligned = true;
  for (long long st : strides) aligned = aligned && st >= 0 && st % 8 == 0;
  for (const void* ptr : {q, k, v, static_cast<const void*>(o)})
    aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (!aligned || (block_q != 64 && block_q != 128) ||
      (block_kv != 64 && block_kv != 128) || window < 0 ||
      !valid_shape(B, H, Hkv, Sq, Skv, d, block_q))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qb = (Sq + block_q - 1) / block_q;
  const Operands a{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                   v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const FlashParams p{B, H, Hkv, Sq, Skv, kv_len, causal, window, n_qb,
                      scale * kLog2e, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch ((d + 63) / 64) {
    case 1: err = launch_dp<64>(block_q, block_kv, a, p, d, s); break;
    case 2: err = launch_dp<128>(block_q, block_kv, a, p, d, s); break;
    case 3: err = launch_dp<192>(block_q, block_kv, a, p, d, s); break;
    case 4: err = launch_dp<256>(block_q, block_kv, a, p, d, s); break;
  }
  return static_cast<int>(err);
}

// f32 q, k, v and o on the split-TF32 kernel, element strides with a unit d
// stride: cp.async reads q, k and v in place (16-byte aligned bases and
// strides of 4 floats), o is written two floats a store (8-byte aligned
// base, even strides).  The launch follows the caller's plan
// (kernels/flash_attention.py::plan_attention_f32): q rows a CTA, keys a
// ring stage, the grid and the shared bytes, each checked against the
// instantiation that runs.
extern "C" int repro_flash_attention_f32(
    const float* q, const float* k, const float* v, float* o, float* lse,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss, int B,
    int H, int Hkv, int Sq, int Skv, int kv_len, int causal, int window,
    float scale, int d, int q_rows, int kv_rows, long long ctas,
    long long smem, void* stream) {
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                                k_ss, v_sb, v_sh, v_ss};
  bool aligned = reinterpret_cast<uintptr_t>(o) % 8 == 0;
  for (long long st : strides) aligned = aligned && st >= 0 && st % 4 == 0;
  for (long long st : {o_sb, o_sh, o_ss})
    aligned = aligned && st >= 0 && st % 2 == 0;
  for (const float* ptr : {q, k, v})
    aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (!aligned || q_rows != kFwdF32Rows || window < 0 ||
      !valid_shape(B, H, Hkv, Sq, Skv, d, kFwdF32Rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdF32Params p{B, H, Hkv, Sq, Skv, kv_len, causal, window,
                       (Sq + kFwdF32Rows - 1) / kFwdF32Rows, d,
                       scale * kLog2e, lse,
                       q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                       o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
#define REPRO_FWD_F32_CASE(N_)                                              \
  case N_:                                                                  \
    return static_cast<int>(                                                \
        p.window > 0 ? launch_fwd_tf32x3<64 * N_, true>(                    \
                           q, k, v, o, p, q_rows, kv_rows, ctas, smem, s)   \
                     : launch_fwd_tf32x3<64 * N_, false>(                   \
                           q, k, v, o, p, q_rows, kv_rows, ctas, smem, s));
    REPRO_FWD_F32_CASE(1) REPRO_FWD_F32_CASE(2) REPRO_FWD_F32_CASE(3)
    REPRO_FWD_F32_CASE(4)
#undef REPRO_FWD_F32_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward (f32 != 0: f32 tensors, on the split-TF32 kernels; else
// bf16, on wgmma): dq (B, H, Sq, d), dk / dv (B, Hkv, Skv, d) contiguous
// in the inputs' type, from q, k, v, the forward's o and lse, and dO
// (element strides with a unit d stride, 16-byte aligned bases and
// strides: TMA (bf16) and cp.async (f32) read q, k, v and dO in place).
// delta and lse2 are (B, H, sq_pad) f32 scratch; f32 under GQA (H > Hkv)
// also takes
// dkv_part, (2, B, H, Skv, d) f32 scratch for each q head's dK and dV
// (null otherwise).  The launch follows the caller's plan
// (kernels/flash_attention.py::plan_attention_bwd): the dK/dV CTA's kv
// rows, the dQ CTA's q rows, sq_pad and each kernel's grid and shared
// memory, every one checked against the instantiation that runs.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* lse2, void* dq,
    void* dk, void* dv, void* dkv_part, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, long long g_sb, long long g_sh, long long g_ss, int B,
    int H, int Hkv, int Sq, int Skv, int kv_len, int causal, int window,
    float scale, int d, int f32, int kv_block, int q_block, int sq_pad,
    long long kv_ctas, long long q_ctas, long long kv_smem, long long q_smem,
    void* stream) {
  const BwdParams p{B, H, Hkv, Sq, Skv, kv_len, causal, window, d, sq_pad,
                    scale, scale * kLog2e,
                    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                    o_sb, o_sh, o_ss, g_sb, g_sh, g_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_kvb = kv_block > 0 ? (Skv + kv_block - 1) / kv_block : 0;
  if (!valid_shape(B, H, Hkv, Sq, Skv, d, q_block) || window < 0 ||
      n_kvb * B * Hkv > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned delta_grid =
      static_cast<unsigned>((static_cast<long long>(B) * H * sq_pad + 7) / 8);
  if (f32) {
    // cp.async reads q, k, v and dO in place: 16-byte aligned bases and
    // strides (4 floats).
    const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                   v_sb, v_sh, v_ss, g_sb, g_sh, g_ss};
    bool aligned = lse2 != nullptr;
    for (long long st : strides) aligned = aligned && st >= 0 && st % 4 == 0;
    for (const void* ptr : {q, k, v, dout, static_cast<const void*>(dq),
                            static_cast<const void*>(dk),
                            static_cast<const void*>(dv),
                            static_cast<const void*>(delta),
                            static_cast<const void*>(lse2),
                            static_cast<const void*>(dkv_part)})
      aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
    if (!aligned || kv_block != kBwdKVRows || q_block != kBwdQRows ||
        sq_pad != (Sq + kBwdQRows - 1) / kBwdQRows * kBwdQRows)
      return static_cast<int>(cudaErrorInvalidValue);
    flash_bwd_delta<float><<<delta_grid, 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), lse,
        delta, lse2, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const float *fq = static_cast<const float*>(q),
                *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v),
                *fg = static_cast<const float*>(dout);
    float *gq = static_cast<float*>(dq), *gk = static_cast<float*>(dk),
          *gv = static_cast<float*>(dv);
    switch ((d + 63) / 64) {
#define REPRO_BWD_CASE(N_)                                                   \
  case N_:                                                                   \
    return static_cast<int>(                                                  \
        window > 0                                                            \
            ? launch_bwd_tf32x3<64 * N_, true>(                               \
                  fq, fk, fv, fg, lse2, delta, gq, gk, gv,                    \
                  static_cast<float*>(dkv_part), p, kv_smem, q_smem, kv_ctas, \
                  q_ctas, s)                                                  \
            : launch_bwd_tf32x3<64 * N_, false>(                              \
                  fq, fk, fv, fg, lse2, delta, gq, gk, gv,                    \
                  static_cast<float*>(dkv_part), p, kv_smem, q_smem, kv_ctas, \
                  q_ctas, s));
      REPRO_BWD_CASE(1) REPRO_BWD_CASE(2) REPRO_BWD_CASE(3) REPRO_BWD_CASE(4)
#undef REPRO_BWD_CASE
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }

  // bf16: TMA needs 16-byte aligned bases and strides (8 bf16); the
  // bulk copies of lse2 and delta 16-byte aligned rows.
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, g_sb, g_sh, g_ss};
  bool aligned = lse2 != nullptr;
  for (long long st : strides) aligned = aligned && st >= 0 && st % 8 == 0;
  for (const void* ptr : {q, k, v, dout, static_cast<const void*>(dq),
                          static_cast<const void*>(dk),
                          static_cast<const void*>(dv),
                          static_cast<const void*>(delta),
                          static_cast<const void*>(lse2)})
    aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (!aligned || kv_block != kBwdKVRows || q_block != kBwdQRows ||
      sq_pad != (Sq + kBwdQRows - 1) / kBwdQRows * kBwdQRows ||
      dkv_part != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_delta<__nv_bfloat16><<<delta_grid, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, lse2, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdOperands a{q,    k,    v,    dout, dq,   dk,   dv,
                      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                      v_sh, v_ss, g_sb, g_sh, g_ss};
  const BwdTmaParams tp{B,      H,      Hkv,   Sq,
                        Skv,    kv_len, causal, window,
                        sq_pad, scale,  scale * kLog2e, lse2,
                        delta};
  switch ((d + 63) / 64) {
#define REPRO_BWD_CASE(N_)                                                  \
  case N_:                                                                  \
    return static_cast<int>(                                                \
        window > 0 ? launch_bwd_wgmma<64 * N_, true>(                       \
                         a, tp, d, kv_smem, q_smem, kv_ctas, q_ctas, s)     \
                   : launch_bwd_wgmma<64 * N_, false>(                      \
                         a, tp, d, kv_smem, q_smem, kv_ctas, q_ctas, s));
    REPRO_BWD_CASE(1) REPRO_BWD_CASE(2) REPRO_BWD_CASE(3) REPRO_BWD_CASE(4)
#undef REPRO_BWD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
