// Selector-tiled GEMM with a fused epilogue, hand-written for Hopper (sm_90a):
// a persistent stream-K / split-K kernel on wgmma and TMA.
//
// Replaces src/repro/kernels/matmul.py::matmul_pallas (pallas_call at :181,
// body _make_kernel :77, _swizzle :48, _apply_epilogue :62) and, as the
// grouped launch, src/repro/kernels/ops.py::expert_matmul (a jax.vmap of
// matmul_pallas over the expert axis, ops.py:349-361).
//
//   C[g] = epilogue(A[g] @ B[g]),  A (M, K) row-major, B (K, N) row-major,
//   epilogue = +bias (N) -> gelu(tanh) | silu | silu(y) * gate (M, N)
//              -> +residual (M, N) -> cast to the output type,
//   applied once per output element, on the full f32 sum, in DESIGN.md §3's
//   order.  The dense GEMM is the launch with one group and zero strides.
//   A launch, dense or grouped, may also read A stored (K, M) (trans_a: the
//   weight gradient X^T dY reads the activation X in place; per expert,
//   dW_e = X_e^T dZ_e reads the (E, C, D) dispatch buffer in place) or B
//   stored (N, K) (trans_b: the input gradient dY W^T reads the weight W
//   in place; per expert dX_e = dZ_e W_e^T); the tensor maps are encoded
//   over the operand as stored, the group as their third coordinate, and
//   wgmma takes it MN-major (A) or K-major (B), so no transposed copy is
//   ever made.  These are the gradients JAX derives through matmul_pallas
//   and through expert_matmul's vmap of it.
//
// The epilogue's backward (epilogue_bwd_kernel) is a second, elementwise
// kernel of this source: from dOut and the recomputed pre-activation z it
// gives dz = dOut * act'(z) (gelu(tanh), silu, or silu(z) * gate), dgate =
// dOut * silu(z), and dbias as column sums in a fixed order (no atomics),
// one bias row per group for the grouped GEMM.  It is bound by HBM bytes
// (a few flops an element): one pass over dOut, z and the gate, each
// column strip's rows walked by eight warps whose partial sums are added in
// warp order.
//
// What bounds it on the H100.  At decode (M = 4) every GEMM streams its
// weight once: bound by HBM bytes, it needs loads in flight on every SM.  At
// prefill (M = 474-512) the projections are bound by tensor-core operations
// and need wgmma fed from shared memory without stalls.  The TPU kernel walks
// one sequential grid, so its split-K and stream-K are the same in-core loop;
// a Hopper grid runs in parallel, and a kernel that gives each output tile
// one CTA leaves most of the 132 SMs idle on the small-M tiles the selector
// picks (12 CTAs for a 4 x 3072 x 3072 decode GEMM).
//
// What the design does about it:
//  * One persistent scheduler for every schedule (kernels/matmul.py::
//    work_plan computes the same partition).  The grid is at most one CTA
//    per SM; the iteration space (group, swizzled tile, k-step) is cut into
//    units -- one k-step under stream_k, one (tile, k-shard) under
//    data_parallel -- and CTA c walks units [c q, (c + 1) q), q = ceil(units
//    / min(SMs, units)), the strip the latency model prices
//    (core/latency.py: wave_model, schedule_extra_classes).  Consecutive
//    units of one tile in one CTA ("a piece") share one accumulator.
//  * Deterministic fixup.  A CTA whose range starts inside a tile writes its
//    f32 partial of that tile to its workspace slot and raises its flag; the
//    CTA holding the tile's first k-step keeps its own sum in registers,
//    waits for the flags of the CTAs after it, adds their partials in k order
//    and applies the epilogue once.  No float atomics: the same inputs give
//    bitwise-equal outputs.  The spin-wait is safe because every CTA is
//    resident at once (a cooperative launch: the hardware schedules the
//    whole grid together, whatever else runs on the card) and a CTA only
//    waits on CTAs after it, whose pieces of the tile come first in their
//    ranges.  The waiter lowers each flag it consumed, so the flags are
//    zero again when the launch ends (a CUDA graph replays it unchanged);
//    launches that share flags must run in order (the wrapper keeps one
//    buffer per stream).
//  * bf16 inputs run on wgmma fed by TMA, warp-specialised: one producer
//    thread (of a warp, or of a warpgroup that gives its registers to the
//    consumers for a 256-row tile) keeps cp.async.bulk.tensor loads in
//    flight in a ring of up to 8 mbarrier-guarded stages, each a 64-deep
//    (or bk-deep) slice of the k-step, so a 256 x 128 x 128 tile has a
//    4-deep ring in 192 KB; one or
//    two consumer warpgroups issue wgmma.mma_async with the accumulators in
//    registers (a 256-row tile is held whole by two warpgroups, 128 f32 a
//    thread).  The epilogue stores through TMA: a launch with no gate or
//    residual, on tiles of at most 128 x 128 (one 64-row block and 64
//    accumulators a consumer thread), converts its sums, after the bias
//    and activation, to the output type in a 16 KB staging tile a
//    warpgroup (64 rows of 256 bytes, in TMA boxes of 128-byte swizzled
//    rows), fences it for the async proxy, and one thread issues
//    cp.async.bulk.tensor stores on a 3-D output map (N, M, groups) that
//    clips ragged rows, columns and groups.  The warpgroup goes straight
//    on to its next piece, whose slices the producer has already brought
//    in, and waits for the stores to have read the staging only before it
//    writes there again.  The staging takes no ring stage from the
//    backward's tiles (64x128x128 keeps 8, 128x128x128 6).  The other
//    launches (a gate or residual, whose loads are batched and coalesced;
//    256-row or 256-wide tiles, whose 128 accumulators leave no registers
//    for the register path) stage 32 f32 columns of a 64-row block at a
//    time in half the staging and put their outputs in a TMA box in the
//    other half, stored the same way.  Blocks of fewer than 32 rows, as at
//    decode, store their rows from the f32 buffer to global memory in
//    column pairs, and so do 256-row tiles: there the TMA stores measured
//    slower (PERF.md §6).  The activation is a template argument of the
//    epilogue for none and swiglu (gelu and silu share one run-time
//    copy): chosen at run time, every branch was evaluated for every
//    output, and the grouped dW at qwen3's shape (K = 160, a 403 MB
//    output) spent most of its time there.  A 32-row (decode) tile
//    runs the 64-row instruction with TMA filling only its 32 rows: at
//    M = 4 the MMA is idle anyway, and what the decode GEMMs need -- every
//    SM streaming the weight with several TMA loads in flight -- is what the
//    scheduler and the ring give.  TMA zero-fills out-of-range rows, columns
//    and depth (per group: the descriptors are 3-D).  A 256 x 256 tile is
//    walked as two 256 x 128 passes (registers cap a thread at 128
//    accumulators).
//  * The grouped launch (group_m 1, more than one row tile a group) walks
//    a CTA's whole tiles column by column (Walk): 132 CTAs run on as many
//    groups at once, so an operand tile that comes back many tiles later
//    has left the 50 MB L2.  In the column walk a group's B column tile
//    (an expert's W in dX = dZ W^T) is used by its row tiles one after
//    another and by the neighbour CTA that shares the group at about the
//    same time.  The first and last pieces keep their places, so the
//    fixup's order argument above is unchanged, and every sum is the same:
//    the outputs are bitwise those of the flattened walk.
//  * f32 inputs run on the tensor cores too, under the same scheduler,
//    fixup and CTA shape, with split-TF32 products (tf32x3.cuh): each
//    operand split into a TF32 hi and lo part, three wgmma products a k8
//    step, f32 sums.  One TF32 product keeps ten mantissa bits and misses
//    the f32 tolerance; three reach it, at a third of the TF32 rate (495 /
//    3 = 165 TFLOP/s, against 67 on the CUDA cores).  At decode the f32
//    weight's bytes bound it as in bf16; at prefill the three products.
//    tf32 wgmma reads B only K-major and takes no transpose, and the route
//    must read B stored (K, N) and A stored (K, M) in place: TMA lands each
//    operand's slab as stored, the consumers split B into K-major hi / lo
//    copies in shared memory (transposing B stored (K, N)) and take A from
//    registers, loaded from the slab in whichever layout it has.  So every
//    operand's K-slab of a tile is read from memory once.  Outputs and
//    epilogue operands may be bf16 or f32 independently of the inputs.
//    This route keeps its epilogue of paired global stores.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"
#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace repro {

constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in dynamic shared memory
constexpr int kMaxStages = 8;

enum Act { kActNone = 0, kActGelu = 1, kActSilu = 2, kActSwiglu = 3 };
template <int A>
struct ActTag {
  static constexpr int kAct = A;
};

struct Params {
  const void* a;
  const void* b;
  void* out;
  const void* bias;
  const void* gate;
  const void* residual;
  float* ws;   // one partial slot per CTA (null when no tile is split)
  int* flags;  // one flag per CTA, zero between launches
  int M, N, K;
  int bm, bn, bk;
  int group_m;
  int out_f32, ep_f32;
  int has_bias, act, has_res;
  int groups;
  int trans_a, trans_b;   // A stored (K, M), B stored (N, K)
  int Tm, Tn;             // output tiles of one group
  int column_walk;        // walk whole tiles column by column (Walk)
  int steps_per_unit;     // k-steps of bk in one unit
  int units_per_tile;
  int units_per_cta;      // q
  int ctas;               // the grid
  long long units;        // groups * Tm * Tn * units_per_tile
  int ks;                 // depth of one shared-memory stage
  int stages;
  int plan_stages, plan_smem;  // the f32 kernel's, as the caller planned them
  size_t slot_floats;     // one CTA's workspace slot
  // Element strides between consecutive groups (0 for the dense case).
  size_t sa, sb, so, sbias, sgate, sres;
};

// ---------------------------------------------------------------------------
// The work plan (kernels/matmul.py::WorkPlan.pieces walks the same way).
// ---------------------------------------------------------------------------

struct Piece {
  int tile;      // flattened (group, tile)
  int s0, s1;    // k-steps [s0, s1) of the tile
  bool first;    // holds the tile's first k-step: owns fixup and epilogue
  bool last;     // holds the tile's last k-step
  int last_cta;  // the CTA holding the tile's last k-step
};

// The piece of tile t over units [ua, ub).
__device__ __forceinline__ Piece make_piece(const Params& p, int t,
                                            long long ua, long long ub) {
  const long long tu0 = static_cast<long long>(t) * p.units_per_tile;
  const long long tu1 = tu0 + p.units_per_tile;
  Piece pc;
  pc.tile = t;
  pc.s0 = static_cast<int>(ua - tu0) * p.steps_per_unit;
  pc.s1 = static_cast<int>(ub - tu0) * p.steps_per_unit;
  pc.first = ua == tu0;
  pc.last = ub == tu1;
  pc.last_cta = static_cast<int>((tu1 - 1) / p.units_per_cta);
  return pc;
}

// A CTA's walk over its units [u0, u1): its first piece (which may start
// mid-tile: a partial), then the whole tiles between, then its last piece
// (which may end mid-tile: its owner waits for later CTAs' partials), so
// a CTA never waits before it has raised its own flag.  The whole tiles
// come in the flattened order or, with p.column_walk (as
// WorkPlan.column_walk: the grouped launch under group_m 1, more than one
// row tile a group), column tile by column tile: a column's tiles are the rows r =
// group * Tm + row of one contiguous range, walked up in even columns and
// down in odd ones, so that a group's B column tile is used by its row
// tiles one after another, and by the neighbour CTA that shares the group
// at about the same time.  kernels/matmul.py::WorkPlan.pieces walks the
// same way.  The cursor is made opaque to the compiler each step: left
// visible, it specialised the kernel's loop by the walk's stage, which
// doubled the code and raised the registers of the mainloop.
struct Walk {
  int t_first, t_last;  // the first and last pieces' tiles
  int i;                // pieces taken
  int n, r;             // the column walk's next column and row
};

// This CTA's units [u0, u1).
__device__ __forceinline__ void cta_units(const Params& p, long long& u0,
                                          long long& u1) {
  u0 = static_cast<long long>(blockIdx.x) * p.units_per_cta;
  u1 = u0 + p.units_per_cta < p.units ? u0 + p.units_per_cta : p.units;
}

__device__ __forceinline__ void walk_begin(const Params& p, Walk& w) {
  long long u0, u1;
  cta_units(p, u0, u1);
  w.t_first = static_cast<int>(u0 / p.units_per_tile);
  w.t_last = static_cast<int>((u1 - 1) / p.units_per_tile);
  w.i = 0;
  w.n = 0;
  w.r = (w.t_first + 1 + p.Tn - 1) / p.Tn;  // column 0's first row
}

// The next whole tile of the column walk over the tiles [t_first + 1,
// t_last): column n holds the rows r with t_first < r Tn + n < t_last.
__device__ __forceinline__ int walk_column_tile(const Params& p, Walk& w) {
  const int lo = w.t_first + 1, hi = w.t_last, tn = p.Tn;
  for (;;) {
    const int r_lo = (lo - w.n + tn - 1) / tn;
    const int r_hi = hi - 1 - w.n >= 0 ? (hi - 1 - w.n) / tn : -1;
    if (w.r >= r_lo && w.r <= r_hi) break;
    ++w.n;  // the column is done: the next one from its top or bottom
    w.r = (w.n & 1) ? (hi - 1 - w.n >= 0 ? (hi - 1 - w.n) / tn : -1)
                    : (lo - w.n + tn - 1) / tn;
  }
  const int t = w.r * tn + w.n;
  w.r += (w.n & 1) ? -1 : 1;
  return t;
}

__device__ __forceinline__ bool next_piece(const Params& p, Walk& w,
                                           Piece& pc) {
  asm volatile("" : "+r"(w.i), "+r"(w.n), "+r"(w.r), "+r"(w.t_first),
               "+r"(w.t_last));
  const int last = w.t_last - w.t_first;  // the last piece's index
  if (w.i > last) return false;
  const long long upt = p.units_per_tile;
  if (w.i == 0 || w.i == last) {
    const int t = w.i == 0 ? w.t_first : w.t_last;
    long long u0, u1;
    cta_units(p, u0, u1);
    const long long ta = t * upt, tb = ta + upt;
    pc = make_piece(p, t, u0 > ta ? u0 : ta, u1 < tb ? u1 : tb);
  } else {
    const int t = p.column_walk ? walk_column_tile(p, w) : w.t_first + w.i;
    pc = make_piece(p, t, t * upt, (t + 1) * upt);
  }
  ++w.i;
  return true;
}

// Flattened tile -> (group, first row, first column) under the group_m row
// swizzle (matmul.py::_swizzle), ragged final row group included.
__device__ __forceinline__ void tile_origin(const Params& p, int tile, int& g,
                                            int& row0, int& col0) {
  const int per_group = p.Tm * p.Tn;
  g = tile / per_group;
  const int pid = tile - g * per_group;
  int pid_m, pid_n;
  if (p.group_m <= 1) {
    pid_m = pid / p.Tn;
    pid_n = pid % p.Tn;
  } else {
    const int group_size = p.group_m * p.Tn;
    const int first_m = (pid / group_size) * p.group_m;
    const int rows = min(p.Tm - first_m, p.group_m);
    const int local = pid % group_size;
    pid_m = first_m + local % rows;
    pid_n = local / rows;
  }
  row0 = pid_m * p.bm;
  col0 = pid_n * p.bn;
}

// The real depth [k_lo, k_hi) of a piece: k-steps past K (the tail of the
// last split-K shard) hold nothing to load.
__device__ __forceinline__ void piece_depth(const Params& p, const Piece& pc,
                                            int& k_lo, int& k_hi) {
  k_lo = pc.s0 * p.bk;
  k_hi = min(pc.s1 * p.bk, p.K);
}

// ---------------------------------------------------------------------------
// Cross-CTA flags (release / acquire at GPU scope).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void raise_flag(int* f) {
  __threadfence();
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(f), "r"(1)
               : "memory");
}

__device__ __forceinline__ void await_and_lower_flag(int* f) {
  int v;
  do {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(f)
                 : "memory");
  } while (v == 0);
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(f), "r"(0)
               : "memory");
}

// ---------------------------------------------------------------------------
// The epilogue (matmul.py::_apply_epilogue) of one output element.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float load_ep(const void* p, size_t i, int f32) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// The activation A of DESIGN.md §3 (gelu is the tanh form, as
// jax.nn.gelu); gate is read only by swiglu.  A is a template argument
// (with_act): with a run-time one the compiler evaluated every branch for
// every output (if-conversion), and the epilogue of an act-none launch
// cost more than its mainloop (the grouped dW at qwen3's shape; PERF.md
// §6).
template <int A>
__device__ __forceinline__ float activate(float x, float gate) {
  if constexpr (A == kActGelu)
    return 0.5f * x *
           (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  if constexpr (A == kActSilu) return x / (1.0f + expf(-x));
  if constexpr (A == kActSwiglu) return x / (1.0f + expf(-x)) * gate;
  return x;
}

// Calls f(ActTag<A>{}) with the launch's activation A at compile time
// where a timed launch needs it -- none, and swiglu where the epilogue
// takes a gate (kGate) -- and A = kActAny (gelu or silu, chosen at run
// time) otherwise: each copy of the epilogue is code in every bf16
// kernel, and with all four in both epilogues the build took 15 % longer
// (PERF.md §6).
constexpr int kActAny = -1;

template <bool kGate, typename F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  if (act == kActNone) {
    f(ActTag<kActNone>{});
    return;
  }
  if constexpr (kGate) {
    if (act == kActSwiglu) {
      f(ActTag<kActSwiglu>{});
      return;
    }
  }
  f(ActTag<kActAny>{});
}

template <int A>
__device__ __forceinline__ float activate_any(int act, float x, float gate) {
  if constexpr (A == kActAny)
    return act == kActGelu ? activate<kActGelu>(x, gate)
                           : activate<kActSilu>(x, gate);
  return activate<A>(x, gate);
}

// Two neighbouring columns (col even; N is a multiple of 8, so col + 1 < N).
__device__ __forceinline__ float2 load_ep2(const void* p, size_t i, int f32) {
  if (f32) return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      static_cast<const __nv_bfloat16*>(p) + i));
}

// TA: A is MN-major in shared memory; TB: B is MN-major (wgmma's
// transpose-a / transpose-b).
template <int PN, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[PN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (PN == 32) wgmma_m64n32<TA, TB>(d, da, db);
  if constexpr (PN == 64) wgmma_m64n64<TA, TB>(d, da, db);
  if constexpr (PN == 128) wgmma_m64n128<TA, TB>(d, da, db);
  if constexpr (PN == 256) wgmma_m64n256<TA, TB>(d, da, db);
}

__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The f32 route's epilogue buffer: one per consumer warpgroup, 64 rows of
// kEpiCols f32; the row stride of 40 floats keeps the fragment writes (8
// rows x 4 column pairs a half-warp) free of bank conflicts.
constexpr int kEpiCols = 32;
constexpr int kEpiStride = kEpiCols + 8;
constexpr int kEpiBytes = 64 * kEpiStride * 4;

// The bf16 route's output staging: one per consumer warpgroup, 64 rows of
// 256 bytes (128 bf16 or 64 f32 columns), in TMA boxes of 128-byte rows
// (64 bf16 or 32 f32 columns; 64-byte rows for 32 bf16 columns), each box
// in the swizzle its tensor map names; or, for the epilogue that goes
// through an f32 buffer, one such box and the buffer (kEpiSwzAt).
constexpr int kOutStage = 64 * 256;

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Byte offset of 16-byte chunk `chunk16` (plus byte `b` in it) of row r of
// a box of `rb`-byte rows (128 or 64) in the TMA swizzle of that row width,
// the box 1024-aligned.
__device__ __forceinline__ uint32_t swz_at(int r, int rb, int chunk16,
                                           int b) {
  const int sw = rb == 128 ? (r & 7) : ((r >> 1) & 3);
  return r * rb + ((chunk16 ^ sw) << 4) + b;
}

// Two outputs (x, y) as the output type at column pair c (even) of row r
// of a staged chunk: boxes of box_cols columns (32 or 64: 1 << lg_cols),
// 64 rows of rb bytes each.
__device__ __forceinline__ void stage_pair(unsigned char* stage, int r, int c,
                                           int lg_cols, int rb, int f32,
                                           float x, float y) {
  const int cb = (c & ((1 << lg_cols) - 1)) << (f32 ? 2 : 1);
  unsigned char* at =
      stage + (c >> lg_cols) * 64 * rb + swz_at(r, rb, cb >> 4, cb & 15);
  if (f32)
    *reinterpret_cast<float2*>(at) = make_float2(x, y);
  else
    *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x, y);
}

// The bf16 route's f32 buffer: 64 rows x kEpiCols f32 of 128 bytes in the
// upper half of the warpgroup's staging, each row's 16-byte chunks XORed
// with the row (the fragment writes stay free of bank conflicts without
// the f32 route's padding), so that the lower half holds a TMA box of
// outputs beside it.
constexpr int kEpiSwzAt = kOutStage / 2;

__device__ __forceinline__ int epi_swz(int r, int c) {
  return r * kEpiCols + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// The epilogue of rows x kEpiCols outputs staged in epi (the first rows of
// a 64-row block starting at row0, columns from col0; kSwz: the bf16
// route's swizzled rows, else rows of kEpiStride), by the 128 threads of
// one warpgroup: thread t takes column pair t % 16 of rows t / 16 + 8 s.
// Each round issues the gate and residual loads of kBatch rows before
// their first use, so their latencies overlap.  A 256-row tile keeps 128
// accumulators live through its epilogue and has no registers to spare
// for a batch: it takes one row a round.  The outputs go to `box`, a TMA
// box of 64 rows of rb bytes (1 << lg_cols columns, this chunk from its
// column box_c0) in the box's swizzle, or with no box to global memory in
// column pairs.
template <int kBatch, bool kSwz>
__device__ __forceinline__ void epilogue_block(
    const Params& p, const float* epi, int g_, int row0, int rows, int col0,
    int t, unsigned char* box = nullptr, int box_c0 = 0, int lg_cols = 0,
    int rb = 0) {
  constexpr int kPairs = kEpiCols / 2;
  const size_t g = static_cast<size_t>(g_);
  const int c = (t % kPairs) * 2, col = col0 + c;
  if (col >= p.N) return;
  float2 bias = make_float2(0.0f, 0.0f);
  if (p.has_bias) bias = load_ep2(p.bias, g * p.sbias + col, p.ep_f32);
  with_act<true>(p.act, [&](auto tag) {
    constexpr int A = decltype(tag)::kAct;
#pragma unroll 1
    for (int r0 = t / kPairs; r0 < rows; r0 += kBatch * (128 / kPairs)) {
      float2 v[kBatch], gate[kBatch], res[kBatch];
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        const int r = r0 + s * (128 / kPairs);
        v[s] = gate[s] = res[s] = make_float2(0.0f, 0.0f);
        if (r >= rows) continue;
        const size_t idx = static_cast<size_t>(row0 + r) * p.N + col;
        v[s] = *reinterpret_cast<const float2*>(
            epi + (kSwz ? epi_swz(r, c) : r * kEpiStride + c));
        if constexpr (A == kActSwiglu)
          gate[s] = load_ep2(p.gate, g * p.sgate + idx, p.ep_f32);
        if (p.has_res)
          res[s] = load_ep2(p.residual, g * p.sres + idx, p.ep_f32);
      }
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        const int r = r0 + s * (128 / kPairs);
        if (r >= rows) continue;
        const float x =
            activate_any<A>(p.act, v[s].x + bias.x, gate[s].x) + res[s].x;
        const float y =
            activate_any<A>(p.act, v[s].y + bias.y, gate[s].y) + res[s].y;
        if (box) {
          stage_pair(box, r, box_c0 + c, lg_cols, rb, p.out_f32, x, y);
          continue;
        }
        const size_t o =
            g * p.so + static_cast<size_t>(row0 + r) * p.N + col;
        if (p.out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
              make_float2(x, y);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + o) =
              __floats2bfloat162_rn(x, y);
        }
      }
    }
  });
}

// ---------------------------------------------------------------------------
// The tensor-core kernel.  NWG consumer warpgroups of MB 64-row blocks each
// cover the tile's rows (NWG * MB * 64 >= bm); PN columns per pass.  TA / TB
// select the operands' stored layouts: TA = 0 stages A K-major (a TMA box of
// bm rows x ks), TA = 1 stages A stored (K, M) MN-major (one 64 x ks box,
// 128-byte rows of 64 m, per 64-row block); TB = 0 stages B stored (K, N)
// MN-major (64-column chunks), TB = 1 stages B stored (N, K) K-major (one
// ks x PN box).  A stage holds the same bytes in every layout.
// ---------------------------------------------------------------------------

template <int NWG, int MB, int PN>
struct Sm90 {
  static constexpr int kConsumers = NWG * 128;
  // A 256-row tile keeps 128 accumulators a consumer thread: its producer
  // is a whole warpgroup that hands its registers to the consumers
  // (setmaxnreg), which removes their spills.  Other tiles have room, and
  // one producer warp costs less there: with a producer warpgroup the
  // 32 x 256 decode tiles ran 17-20 % slower (tools/gemm_ab.py).
  static constexpr bool kRebalance = MB == 2;
  static constexpr int kThreads = kConsumers + (kRebalance ? 128 : 32);
  static constexpr int kRows = NWG * MB * 64;       // rows of the A stage
  static constexpr int kCW = PN < 64 ? PN : 64;     // B chunk width
  static constexpr int kChunks = PN / kCW;
  static constexpr int kAcc = PN / 2;               // f32 a thread, per block
  // The register epilogue (sm90_body) stages outputs straight from the
  // registers, a 32-column slice copied out at a time: with 128
  // accumulators (a 256-row tile, or PN 256) that copy spilled, and these
  // tiles go through the f32 buffer.
  static constexpr bool kRegEpilogue = MB == 1 && kAcc <= 64;
};

template <int NWG, int MB, int PN, int TA, int TB>
__device__ __forceinline__ void sm90_body(const CUtensorMap& tma_a,
                                          const CUtensorMap& tma_b,
                                          const CUtensorMap& tma_o,
                                          const Params& p) {
  using S = Sm90<NWG, MB, PN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [stages x (A slice, B chunks)] [NWG output stagings] [mbarriers]
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int ks = p.ks;
  const uint32_t a_bytes = S::kRows * ks * 2;
  const uint32_t b_chunk = ks * S::kCW * 2;
  const uint32_t stage_bytes = a_bytes + S::kChunks * b_chunk;
  const uint32_t epi_at = base + p.stages * stage_bytes;
  const uint32_t bars = epi_at + NWG * kOutStage;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kMaxStages + s); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), S::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int passes = p.bn / PN;
  // The warpgroup index, broadcast from lane 0 so that the compiler sees
  // the role split as warp-uniform; otherwise it serialises every wgmma.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wg == NWG) {
    if constexpr (S::kRebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // Producer: one thread issues every TMA load of the CTA's pieces.
    if (tid == S::kConsumers) {
      const uint32_t tx = (TA ? S::kRows : p.bm) * ks * 2 + PN * ks * 2;
      int stage = 0;
      uint32_t phase = 0;
      Walk w;
      walk_begin(p, w);
      Piece pc;
      while (next_piece(p, w, pc)) {
        int g, row0, col0, k_lo, k_hi;
        tile_origin(p, pc.tile, g, row0, col0);
        piece_depth(p, pc, k_lo, k_hi);
        for (int ps = 0; ps < passes; ++ps) {
          for (int k = k_lo; k < k_hi; k += ks) {
            mbar_wait(empty(stage), phase ^ 1);
            mbar_expect_tx(full(stage), tx);
            const uint32_t sa = base + stage * stage_bytes;
            if constexpr (TA) {
#pragma unroll
              for (int c = 0; c < S::kRows / 64; ++c)
                tma_load_3d(sa + c * ks * 128, &tma_a, full(stage),
                            row0 + 64 * c, k, g);
            } else {
              tma_load_3d(sa, &tma_a, full(stage), k, row0, g);
            }
            if constexpr (TB) {
              tma_load_3d(sa + a_bytes, &tma_b, full(stage), k,
                          col0 + ps * PN, g);
            } else {
#pragma unroll
              for (int j = 0; j < S::kChunks; ++j)
                tma_load_3d(sa + a_bytes + j * b_chunk, &tma_b, full(stage),
                            col0 + ps * PN + j * S::kCW, k, g);
            }
            if (++stage == p.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // Consumers.
  if constexpr (S::kRebalance)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = __shfl_sync(0xffffffffu, (tid % 128) / 32, 0);
  const int lane = tid % 32;
  const bool issuer = tid % 128 == 0;  // issues the warpgroup's TMA stores
  float acc[MB][S::kAcc];
  int stage = 0;
  uint32_t phase = 0;
  Walk w;
  walk_begin(p, w);
  Piece pc;
  while (next_piece(p, w, pc)) {
    int g, row0, col0, k_lo, k_hi;
    tile_origin(p, pc.tile, g, row0, col0);
    piece_depth(p, pc, k_lo, k_hi);
    for (int ps = 0; ps < passes; ++ps) {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
        for (int i = 0; i < S::kAcc; ++i) acc[mb][i] = 0.0f;
        fence_acc(acc[mb]);
      }
      int prev = -1;
      for (int k = k_lo; k < k_hi; k += ks) {
        mbar_wait(full(stage), phase);
        const uint32_t sa = base + stage * stage_bytes;
        wgmma_fence();
        for (int kk = 0; kk < ks / 16; ++kk) {
          // K-major tiles: a k16 step moves 32 bytes along the swizzled
          // row, 8-row groups 8 rows apart.  MN-major tiles: a k16 step
          // moves 16 rows of 128 (or kCW * 2) bytes, 8-row groups 1024
          // bytes apart, 64-wide chunks one chunk apart.
          const uint64_t db =
              TB ? smem_desc(sa + a_bytes + kk * 32, 16, 8 * ks * 2, ks * 2)
                 : smem_desc(sa + a_bytes + kk * 16 * S::kCW * 2, b_chunk,
                             8 * S::kCW * 2, S::kCW * 2);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            const int blk = wg * MB + mb;
            const uint64_t da =
                TA ? smem_desc(sa + blk * ks * 128 + kk * 16 * 128, ks * 128,
                               1024, 128)
                   : smem_desc(sa + blk * 64 * ks * 2 + kk * 32, 16,
                               8 * ks * 2, ks * 2);
            wgmma_bf16<PN, TA, 1 - TB>(acc[mb], da, db);
          }
        }
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          mbar_arrive(empty(prev));
        }
        prev = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (prev >= 0) {
        wgmma_wait<0>();
        mbar_arrive(empty(prev));
      }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);

      // Partial slot of this pass: [block][register / 4][consumer thread],
      // four registers a float4, so a warp moves 512 contiguous bytes.
      const size_t region = static_cast<size_t>(ps) * S::kRows * PN / 4;
      if (!pc.first) {
        float4* slot = reinterpret_cast<float4*>(p.ws + blockIdx.x * p.slot_floats) + region;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          if ((wg * MB + mb) * 64 + warp * 16 >= p.bm) continue;
#pragma unroll
          for (int i = 0; i < S::kAcc / 4; ++i)
            __stcg(slot + ((wg * MB + mb) * S::kAcc / 4 + i) * 128 + tid % 128,
                   make_float4(acc[mb][4 * i], acc[mb][4 * i + 1],
                               acc[mb][4 * i + 2], acc[mb][4 * i + 3]));
        }
        if (ps == passes - 1) {
          consumer_sync(S::kConsumers);
          if (tid == 0) raise_flag(p.flags + blockIdx.x);
        }
        continue;
      }
      if (!pc.last) {
        if (ps == 0 && tid == 0)
          for (int c = blockIdx.x + 1; c <= pc.last_cta; ++c)
            await_and_lower_flag(p.flags + c);
        consumer_sync(S::kConsumers);
        for (int c = blockIdx.x + 1; c <= pc.last_cta; ++c) {
          const float4* slot = reinterpret_cast<const float4*>(p.ws + c * p.slot_floats) + region;
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            if ((wg * MB + mb) * 64 + warp * 16 >= p.bm) continue;
#pragma unroll
            for (int i = 0; i < S::kAcc / 4; ++i) {
              const float4 v = __ldcg(
                  slot + ((wg * MB + mb) * S::kAcc / 4 + i) * 128 + tid % 128);
              acc[mb][4 * i] += v.x;
              acc[mb][4 * i + 1] += v.y;
              acc[mb][4 * i + 2] += v.z;
              acc[mb][4 * i + 3] += v.w;
            }
          }
        }
      }
      // The epilogue, 32 columns of one 64-row block at a time, picked
      // from the registers by a rolled loop over cases with constant
      // register indices (one copy of the epilogue code per block).
      unsigned char* out_stage =
          smem_raw + (epi_at - smem_u32(smem_raw)) + wg * kOutStage;
      const int rows0 = min(min(64, p.bm - wg * MB * 64),
                            p.M - row0 - wg * MB * 64);
      const bool reg_path =
          S::kRegEpilogue && p.act != kActSwiglu && !p.has_res;
      if (reg_path && rows0 >= 32) {
        if constexpr (S::kRegEpilogue) {
          // TMA stores: the bias and activation in registers, the outputs
          // in the output type straight into this warpgroup's staging, in
          // the TMA boxes' swizzle (a pass of bf16 outputs fills it once;
          // f32 outputs of a 128-wide pass take two chunks); then a fence
          // for the async proxy, and one thread stores the chunk with TMA,
          // which clips rows, columns and groups at the tensor's bounds.
          // The warpgroup goes on to its next piece while the stores
          // drain, and writes the staging again only after they have read
          // it (bulk_wait_read).  A block of fewer than 32 rows (decode)
          // takes the loop below, which touches only its rows.
          int out_f32 = p.out_f32;  // opaque: keeps what derives from it
          asm volatile("" : "+r"(out_f32));  // out of the mainloop's registers
          const int ob = out_f32 ? 4 : 2;
          const int box_cols = min(PN, 128 / ob);  // 128-byte box rows
          const int lg_cols = box_cols == 64 ? 6 : 5;
          const int rb = box_cols * ob;            // (64 for 32 bf16)
          const int chunk_cols = min(PN, 256 / ob);
          const int blk = wg * 64;
          const int col_pass = col0 + ps * PN;
#pragma unroll 1
          for (int jc = 0; jc < PN / kEpiCols; ++jc) {
            const int cc0 = (jc * kEpiCols) % chunk_cols;  // in the chunk
            if (cc0 == 0) {
              if (issuer) bulk_wait_read();
              warpgroup_sync(wg);
            }
            float v[kEpiCols / 2];
#pragma unroll
            for (int cc = 0; cc < PN / kEpiCols; ++cc) {
              if (cc != jc) continue;
#pragma unroll
              for (int i = 0; i < kEpiCols / 2; ++i)
                v[i] = acc[0][cc * (kEpiCols / 2) + i];
            }
            // Fragment j of the slice holds columns 8 j + 2 (lane % 4) +
            // {0, 1} of rows warp * 16 + lane / 4 + {0, 8}.
            const int col = col_pass + jc * kEpiCols;
            with_act<false>(p.act, [&](auto tag) {
              constexpr int A = decltype(tag)::kAct;
#pragma unroll
              for (int j = 0; j < kEpiCols / 8; ++j) {
                const int c = j * 8 + (lane % 4) * 2;
                float2 bias = make_float2(0.0f, 0.0f);
                if (p.has_bias && col + c < p.N)
                  bias = load_ep2(p.bias, g * p.sbias + col + c, p.ep_f32);
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  stage_pair(out_stage, warp * 16 + lane / 4 + 8 * h,
                             cc0 + c, lg_cols, rb, out_f32,
                             activate_any<A>(p.act, v[j * 4 + 2 * h] + bias.x,
                                             0.0f),
                             activate_any<A>(p.act,
                                             v[j * 4 + 2 * h + 1] + bias.y,
                                             0.0f));
              }
            });
            if (cc0 + kEpiCols == chunk_cols || jc == PN / kEpiCols - 1) {
              fence_proxy_async();
              warpgroup_sync(wg);
              if (issuer) {
                const int chunk0 = col - cc0;  // the chunk's first column
                const uint32_t at = smem_u32(out_stage);
                for (int b = 0; b * box_cols < cc0 + kEpiCols; ++b) {
                  if (chunk0 + b * box_cols >= p.N) break;
                  tma_store_3d(&tma_o, at + b * 64 * rb,
                               chunk0 + b * box_cols, row0 + blk, g);
                }
                bulk_commit();
              }
            }
          }
        }
      } else {
        // A gate or residual operand, or a tile whose 128 accumulators a
        // thread leave no room for the register path: 32 columns of a
        // 64-row block at a time go through the f32 buffer in the upper
        // half of the staging, so that the operands' loads are coalesced
        // and batched, and their outputs into a TMA box in the lower half,
        // stored as the register path stores its chunks (a bf16 box of 64
        // columns takes two of these rounds; the issuer waits for the
        // previous box's reads before the first).  Stores to global memory
        // in column pairs stay where the box measured slower (PERF.md §6):
        // a block of fewer than 32 rows (decode), and a 256-row tile, which
        // also keeps the f32 route's padded rows: there the swizzle's
        // per-thread addresses, live beside 128 accumulators, doubled the
        // spills and slowed its rows.
        if (reg_path) {  // earlier TMA stores read the whole staging
          if (issuer) bulk_wait_read();
          warpgroup_sync(wg);
        }
        constexpr bool kBox = MB == 1;
        float* epi =
            reinterpret_cast<float*>(out_stage + (kBox ? kEpiSwzAt : 0));
        const int ob = p.out_f32 ? 4 : 2;
        const int box_cols = min(PN, 128 / ob);  // as the register path's
        const int lg_cols = box_cols == 64 ? 6 : 5;
        const int rb = box_cols * ob;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const int blk = (wg * MB + mb) * 64;
          const int rows = min(min(64, p.bm - blk), p.M - row0 - blk);
          if (rows <= 0) continue;
          const bool tma = kBox && rows >= 32;
#pragma unroll 1
          for (int jc = 0; jc < PN / kEpiCols; ++jc) {
#pragma unroll
            for (int cc = 0; cc < PN / kEpiCols; ++cc) {
              if (cc != jc) continue;
#pragma unroll
              for (int jj = 0; jj < kEpiCols / 8; ++jj) {
                const int j = cc * (kEpiCols / 8) + jj;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int r = warp * 16 + lane / 4 + 8 * h;
                  const int c = jj * 8 + (lane % 4) * 2;
                  *reinterpret_cast<float2*>(
                      epi + (kBox ? epi_swz(r, c) : r * kEpiStride + c)) =
                      make_float2(acc[mb][j * 4 + 2 * h],
                                  acc[mb][j * 4 + 2 * h + 1]);
                }
              }
            }
            const int bc0 = (jc * kEpiCols) % box_cols;  // in the box
            const int col = col0 + ps * PN + jc * kEpiCols;
            if (tma && bc0 == 0 && issuer) bulk_wait_read();
            warpgroup_sync(wg);
            epilogue_block<kBox ? 4 : 1, kBox>(
                p, epi, g, row0 + blk, rows, col, tid % 128,
                tma ? out_stage : nullptr, bc0, lg_cols, rb);
            const bool store = tma && bc0 + kEpiCols == box_cols;
            if (store) fence_proxy_async();
            warpgroup_sync(wg);
            if (store && issuer && col - bc0 < p.N) {
              tma_store_3d(&tma_o, smem_u32(out_stage), col - bc0,
                           row0 + blk, g);
              bulk_commit();
            }
          }
        }
      }
    }
  }
  // The stores' writes complete with the grid; the staging must outlive
  // their reads (as CUTLASS's tma_store_wait).
  if (issuer) bulk_wait_read();
}

template <int NWG, int MB, int PN, int TA, int TB>
__global__ void __launch_bounds__(Sm90<NWG, MB, PN>::kThreads, 1)
    gemm_dense_sm90(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b,
                    const __grid_constant__ CUtensorMap tma_o,
                    const __grid_constant__ Params p) {
  sm90_body<NWG, MB, PN, TA, TB>(tma_a, tma_b, tma_o, p);
}

template <int NWG, int MB, int PN, int TA, int TB>
__global__ void __launch_bounds__(Sm90<NWG, MB, PN>::kThreads, 1)
    gemm_grouped_sm90(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      const __grid_constant__ CUtensorMap tma_o,
                      const __grid_constant__ Params p) {
  sm90_body<NWG, MB, PN, TA, TB>(tma_a, tma_b, tma_o, p);
}

// ---------------------------------------------------------------------------
// The f32 kernel: split-TF32 products (tf32x3.cuh) on wgmma, under the same
// scheduler, fixup and epilogue as the bf16 kernel.  The CTA is the bf16
// kernel's: NWG consumer warpgroups of MB 64-row blocks and a producer
// warpgroup that keeps TMA loads in flight through a ring of stages, each a
// 32-deep k slab of A and B as stored (f32 rows of 128 bytes, 128-byte
// swizzle; TMA zero-fills past M, N and K).  tf32 wgmma takes B only
// K-major from shared memory and A from registers in any layout, so for
// each slab the consumers first split B into TF32 hi and lo copies, K-major
// (a transposing copy for B stored (K, N), an elementwise one for B stored
// (N, K)), and load their A fragments from the slab in registers, split
// there.  Each 64-row block's products of a slab (three wgmma a k8 step)
// go to a fresh accumulator of at most 128 columns, added to the block's
// running f32 sum by a rounded add: the tensor cores' own adds are not
// rounded to nearest, and summed in the accumulator over the whole K the
// f32 GEMM at 474 x 14336 x 3584 (zamba2-7b's wg, swiglu) drifted from the
// plain f32 product by up to 0.020 against the f32 tolerance's 0.006 +
// 1e-5 |y| (one H100).  A pass is 64 rows a consumer warpgroup by up to
// 128 columns: a thread then holds 64 running sums and a fresh accumulator
// of 64 (with 128 running sums, as one pass of a 256 x 128 tile needs,
// ptxas spilled); so a 256-row tile runs as two 128-row passes, each
// reading its own half of A and the tile's B slab again, and a 256-wide
// tile as two 128-wide passes.
// ---------------------------------------------------------------------------

constexpr int kF32Ks = 32;           // k of a stage: one 128-byte f32 row
constexpr int kF32Box = 32;          // f32 of a 128-byte swizzled row
constexpr uint32_t kF32BoxBytes = kF32Box * kF32Ks * 4;  // a 32 x 32 box

template <int NWG, int PN>
struct Tf32 {
  static constexpr int kConsumers = NWG * 128;
  // A producer warpgroup; with two consumer warpgroups it hands its
  // registers to them (setmaxnreg).
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kRows = NWG * 64;           // rows of a pass
  static constexpr int kAcc = PN / 2;              // running sums a thread
  static constexpr uint32_t kBBytes = PN * kF32Ks * 4;  // a B slab
};

// Byte offset of element (row, col) of a 128-byte-swizzled tile of rows of
// 32 f32 (the layout TMA writes and wgmma reads), the tile 1024-aligned.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
}

// A[r][k] of a stage's A slab: TA = 0 stores (M, K) as bm rows of 32 k;
// TA = 1 stores (K, M) as bm / 32 boxes of 32 k rows of 32 m.  Rows past
// the tile's bm read 0.
template <int TA>
__device__ __forceinline__ float a_elem(const unsigned char* sa, int bm,
                                        int r, int k) {
  if (r >= bm) return 0.0f;
  if constexpr (TA)
    return *reinterpret_cast<const float*>(sa + (r >> 5) * kF32BoxBytes +
                                           swz(k, r & 31));
  else
    return *reinterpret_cast<const float*>(sa + swz(r, k));
}

// The stage's B slab as hi and lo TF32 copies, K-major ([n][k], swizzled),
// k at or past kv (the piece's end) zeroed, by the NWG * 128 consumers.
// TB = 1 (B stored (N, K)) lands in that layout already: an elementwise
// split, 16 bytes a thread a step.  TB = 0 (B stored (K, N)) lands as PN /
// 32 boxes of 32 k rows of 32 n: a thread takes a 4 x 4 block, transposes
// it in registers and splits it.
template <int TB, int NT, int PN>
__device__ __forceinline__ void split_b_slab(const unsigned char* sb,
                                             unsigned char* hi,
                                             unsigned char* lo, int kv,
                                             int tid) {
  if constexpr (TB) {
    for (int i = tid; i < PN * 8; i += NT) {
      const int n = i >> 3, kc = (i & 7) ^ (n & 7);
      const float4 x = *reinterpret_cast<const float4*>(sb + i * 16);
      const float v[4] = {x.x, x.y, x.z, x.w};
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(4 * kc + e < kv ? v[e] : 0.0f, h[e], l[e]);
      *reinterpret_cast<uint4*>(hi + i * 16) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + i * 16) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  } else {
    for (int i = tid; i < PN * 2; i += NT) {
      const int k0 = (i & 7) * 4, n0 = (i >> 3) * 4;
      const unsigned char* box = sb + (n0 >> 5) * kF32BoxBytes;
      float v[4][4];  // v[k][n]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 x = *reinterpret_cast<const float4*>(
            box + swz(k0 + kk, n0 & 31));
        const bool ok = k0 + kk < kv;
        v[kk][0] = ok ? x.x : 0.0f;
        v[kk][1] = ok ? x.y : 0.0f;
        v[kk][2] = ok ? x.z : 0.0f;
        v[kk][3] = ok ? x.w : 0.0f;
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) split_tf32(v[kk][nn], h[kk], l[kk]);
        const uint32_t at = swz(n0 + nn, k0);
        *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
  }
}

template <int NWG, int PN, int TA, int TB>
__device__ __forceinline__ void tf32_body(const CUtensorMap& tma_a,
                                          const CUtensorMap& tma_b,
                                          const Params& p) {
  using S = Tf32<NWG, PN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [stages x (A slab, B slab)] [B hi] [B lo] [NWG epilogue buffers]
  // [mbarriers]
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int rows = min(p.bm, S::kRows);             // A rows of a pass
  const int col_passes = p.bn / PN;
  const int passes = (p.bm / rows) * col_passes;
  const uint32_t a_bytes = rows * kF32Ks * 4;
  const uint32_t stage_bytes = a_bytes + S::kBBytes;
  const uint32_t hi_at = p.stages * stage_bytes;
  const uint32_t lo_at = hi_at + S::kBBytes;
  const uint32_t epi_at = lo_at + S::kBBytes;
  const uint32_t bars = base + epi_at + NWG * kEpiBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kMaxStages + s); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), S::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wg == NWG) {
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // Producer: one thread issues every TMA load of the CTA's pieces.
    if (tid == S::kConsumers) {
      const uint32_t tx = stage_bytes;
      int stage = 0;
      uint32_t phase = 0;
      Walk w;
      walk_begin(p, w);
      Piece pc;
      while (next_piece(p, w, pc)) {
        int g, row0, col0, k_lo, k_hi;
        tile_origin(p, pc.tile, g, row0, col0);
        piece_depth(p, pc, k_lo, k_hi);
        for (int ps = 0; ps < passes; ++ps) {
          const int r0 = row0 + (ps / col_passes) * rows;
          const int c0 = col0 + (ps % col_passes) * PN;
          for (int k = k_lo; k < k_hi; k += kF32Ks) {
            mbar_wait(empty(stage), phase ^ 1);
            mbar_expect_tx(full(stage), tx);
            const uint32_t sa = base + stage * stage_bytes;
            if constexpr (TA) {
              for (int c = 0; c < rows / kF32Box; ++c)
                tma_load_3d(sa + c * kF32BoxBytes, &tma_a, full(stage),
                            r0 + kF32Box * c, k, g);
            } else {
              tma_load_3d(sa, &tma_a, full(stage), k, r0, g);
            }
            if constexpr (TB) {
              tma_load_3d(sa + a_bytes, &tma_b, full(stage), k, c0, g);
            } else {
#pragma unroll
              for (int j = 0; j < PN / kF32Box; ++j)
                tma_load_3d(sa + a_bytes + j * kF32BoxBytes, &tma_b,
                            full(stage), c0 + kF32Box * j, k, g);
            }
            if (++stage == p.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // Consumers.
  if constexpr (NWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = __shfl_sync(0xffffffffu, (tid % 128) / 32, 0);
  const int lane = tid % 32, gq = lane / 4, tq = lane % 4;
  float* epi = reinterpret_cast<float*>(gbase + epi_at + wg * kEpiBytes);
  unsigned char* b_hi = gbase + hi_at;
  unsigned char* b_lo = gbase + lo_at;
  float acc[S::kAcc];
  float part[S::kAcc];
  int stage = 0;
  uint32_t phase = 0;
  Walk w;
  walk_begin(p, w);
  Piece pc;
  while (next_piece(p, w, pc)) {
    int g, row0, col0, k_lo, k_hi;
    tile_origin(p, pc.tile, g, row0, col0);
    piece_depth(p, pc, k_lo, k_hi);
    for (int ps = 0; ps < passes; ++ps) {
      const int r0 = row0 + (ps / col_passes) * rows;
      const int c0 = col0 + (ps % col_passes) * PN;
#pragma unroll
      for (int i = 0; i < S::kAcc; ++i) acc[i] = 0.0f;
      const int r = wg * 64 + warp * 16 + gq;  // the thread's first A row
      for (int k = k_lo; k < k_hi; k += kF32Ks) {
        mbar_wait(full(stage), phase);
        const unsigned char* sa = gbase + stage * stage_bytes;
        // Every warpgroup is done with the last slab's hi / lo copies.
        consumer_sync(S::kConsumers);
        split_b_slab<TB, S::kConsumers, PN>(sa + a_bytes, b_hi, b_lo,
                                            k_hi - k, tid);
        fence_proxy_async();
        consumer_sync(S::kConsumers);
        const int kv = min(kF32Ks, k_hi - k);
        for (int kk = 0; kk < kv; kk += 16) {
          FragA fa[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kc = kk + 8 * h + tq;
            const float x[4] = {a_elem<TA>(sa, rows, r, kc),
                                a_elem<TA>(sa, rows, r + 8, kc),
                                a_elem<TA>(sa, rows, r, kc + 4),
                                a_elem<TA>(sa, rows, r + 8, kc + 4)};
            split_a(x, fa[h]);
          }
          wgmma_fence();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t off = (kk + 8 * h) * 4;
            const uint64_t dh = smem_desc(base + hi_at + off, 16, 1024, 128);
            const uint64_t dl = smem_desc(base + lo_at + off, 16, 1024, 128);
            wgmma_tf32_rs<PN>(part, fa[h].lo, dh, kk + h > 0);
            wgmma_tf32_rs<PN>(part, fa[h].hi, dl, 1);
            wgmma_tf32_rs<PN>(part, fa[h].hi, dh, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            fence_frag(fa[h].hi);
            fence_frag(fa[h].lo);
          }
        }
        fence_acc(part);
#pragma unroll
        for (int i = 0; i < S::kAcc; ++i) acc[i] += part[i];
        mbar_arrive(empty(stage));
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // Partial slot of this pass: [register / 4][consumer thread].
      const size_t region = static_cast<size_t>(ps) * S::kRows * PN / 4;
      const bool live = wg * 64 + warp * 16 < rows;
      if (!pc.first) {
        float4* slot =
            reinterpret_cast<float4*>(p.ws + blockIdx.x * p.slot_floats) + region;
        if (live) {
#pragma unroll
          for (int i = 0; i < S::kAcc / 4; ++i)
            __stcg(slot + i * S::kConsumers + tid,
                   make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                               acc[4 * i + 3]));
        }
        if (ps == passes - 1) {
          consumer_sync(S::kConsumers);
          if (tid == 0) raise_flag(p.flags + blockIdx.x);
        }
        continue;
      }
      if (!pc.last) {
        if (ps == 0 && tid == 0)
          for (int c = blockIdx.x + 1; c <= pc.last_cta; ++c)
            await_and_lower_flag(p.flags + c);
        consumer_sync(S::kConsumers);
        if (live) {
          for (int c = blockIdx.x + 1; c <= pc.last_cta; ++c) {
            const float4* slot =
                reinterpret_cast<const float4*>(p.ws + c * p.slot_floats) +
                region;
#pragma unroll
            for (int i = 0; i < S::kAcc / 4; ++i) {
              const float4 v = __ldcg(slot + i * S::kConsumers + tid);
              acc[4 * i] += v.x;
              acc[4 * i + 1] += v.y;
              acc[4 * i + 2] += v.z;
              acc[4 * i + 3] += v.w;
            }
          }
        }
      }
      // The epilogue, 32 columns of the warpgroup's 64 rows at a time,
      // through its staging buffer (as the bf16 kernel's).
      const int blk = wg * 64;
      const int out_rows = min(min(64, rows - blk), p.M - r0 - blk);
      if (out_rows <= 0) continue;
#pragma unroll 1
      for (int jc = 0; jc < PN / kEpiCols; ++jc) {
#pragma unroll
        for (int cc = 0; cc < PN / kEpiCols; ++cc) {
          if (cc != jc) continue;
#pragma unroll
          for (int jj = 0; jj < kEpiCols / 8; ++jj) {
            const int j = cc * (kEpiCols / 8) + jj;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(
                  epi + (warp * 16 + gq + 8 * h) * kEpiStride + jj * 8 +
                  tq * 2) = make_float2(acc[j * 4 + 2 * h],
                                        acc[j * 4 + 2 * h + 1]);
          }
        }
        warpgroup_sync(wg);
        epilogue_block<4, false>(p, epi, g, r0 + blk, out_rows,
                                 c0 + jc * kEpiCols, tid % 128);
        warpgroup_sync(wg);
      }
    }
  }
}

template <int NWG, int PN, int TA, int TB>
__global__ void __launch_bounds__(Tf32<NWG, PN>::kThreads, 1)
    gemm_dense_f32(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b,
                   const __grid_constant__ Params p) {
  tf32_body<NWG, PN, TA, TB>(tma_a, tma_b, p);
}

template <int NWG, int PN, int TA, int TB>
__global__ void __launch_bounds__(Tf32<NWG, PN>::kThreads, 1)
    gemm_grouped_f32(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b,
                     const __grid_constant__ Params p) {
  tf32_body<NWG, PN, TA, TB>(tma_a, tma_b, p);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// Opts the kernel in to the full 227 KB of dynamic shared memory: one limit
// for every stage depth it launches with.
inline cudaError_t opt_in_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kMaxSmem));
}

// Launches the persistent grid as a cooperative kernel: the fixup spin-waits
// on peer CTAs, so every CTA must be resident at once, and a cooperative
// launch has the hardware guarantee that (or refuses, with
// cudaErrorCooperativeLaunchTooLarge).  It can be captured in a CUDA graph.
template <typename... Exp, typename... Act>
cudaError_t launch_resident(void (*kernel)(Exp...), int ctas, int threads,
                            size_t smem, cudaStream_t stream, Act&&... args) {
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
  return cudaGetLastError();  // the launch's error, cleared
}

// A 3-D tensor map (bf16 or f32) over (groups, outer, inner), inner
// contiguous, with a (box_outer, box_inner) box whose inner rows are
// swizzled over their bytes.
inline bool encode_tiled3d(CUtensorMap* map, bool f32, const void* ptr,
                           uint64_t inner, uint64_t outer, uint64_t groups,
                           uint64_t group_stride, uint32_t box_inner,
                           uint32_t box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const uint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {inner, outer, groups};
  const cuuint64_t strides[2] = {inner * elem, group_stride * elem};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const uint64_t row = box_inner * elem;
  const CUtensorMapSwizzle sw = row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : (row == 64
                                                  ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode_tiled3d through a small cache.  A tensor map is a pure function
// of these arguments, so a cached one is exact; the decode step's weights,
// and mostly its activations, recur every step, and the encoder costs
// microseconds of the host time that bounds decode.
inline bool encode_cached(CUtensorMap* map, bool f32, const void* ptr,
                          uint64_t inner, uint64_t outer, uint64_t groups,
                          uint64_t group_stride, uint32_t box_inner,
                          uint32_t box_outer) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    bool f32;
    uint64_t inner, outer, groups, group_stride;
    uint32_t box_inner, box_outer;
  };
  constexpr int kEntries = 512;
  static Entry cache[kEntries];
  static std::mutex mu;
  const std::lock_guard<std::mutex> lock(mu);
  const uint64_t h = (reinterpret_cast<uint64_t>(ptr) >> 4) ^ inner * 31 ^
                     outer * 131 ^ box_inner * 7 ^ box_outer ^ (f32 ? 1 : 0);
  Entry& e = cache[h % kEntries];
  if (e.ptr == ptr && e.f32 == f32 && e.inner == inner && e.outer == outer &&
      e.groups == groups && e.group_stride == group_stride &&
      e.box_inner == box_inner && e.box_outer == box_outer) {
    *map = e.map;
    return true;
  }
  if (!encode_tiled3d(map, f32, ptr, inner, outer, groups, group_stride,
                      box_inner, box_outer))
    return false;
  e = Entry{*map, ptr, f32, inner, outer, groups, group_stride, box_inner,
            box_outer};
  return true;
}

template <int NWG, int MB, int PN, bool kGrouped, int TA, int TB>
cudaError_t launch_sm90(Params p, cudaStream_t stream) {
  using S = Sm90<NWG, MB, PN>;
  p.ks = p.bk % 64 == 0 ? 64 : (p.bk % 32 == 0 ? 32 : 16);
  const size_t stage = static_cast<size_t>(S::kRows + PN) * p.ks * 2;
  const size_t fixed = 1024 + NWG * kOutStage + 2 * kMaxStages * 8;
  size_t stages = (kMaxSmem - fixed) / stage;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 2) return cudaErrorInvalidValue;
  p.stages = static_cast<int>(stages);
  const size_t smem = fixed + stages * stage;
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, Params);
  if constexpr (kGrouped)
    kernel = gemm_grouped_sm90<NWG, MB, PN, TA, TB>;
  else
    kernel = gemm_dense_sm90<NWG, MB, PN, TA, TB>;
  static const cudaError_t opted =
      opt_in_smem(reinterpret_cast<const void*>(kernel));
  if (opted != cudaSuccess) return opted;

  // Each map is encoded over its operand as stored: A (M, K), or (K, M)
  // read in 64 x ks boxes; B (K, N) in kCW x ks boxes, or (N, K) in ks x PN.
  CUtensorMap tma_a, tma_b;
  const uint64_t M = p.M, N = p.N, K = p.K, G = p.groups;
  const uint64_t ga = G > 1 ? p.sa : M * K, gb = G > 1 ? p.sb : K * N;
  const bool a_ok =
      TA ? encode_cached(&tma_a, false, p.a, M, K, G, ga, 64, p.ks)
         : encode_cached(&tma_a, false, p.a, K, M, G, ga, p.ks, p.bm);
  const bool b_ok =
      TB ? encode_cached(&tma_b, false, p.b, K, N, G, gb, p.ks, PN)
         : encode_cached(&tma_b, false, p.b, N, K, G, gb, S::kCW, p.ks);
  // The output (N, M, groups) in boxes of a 64-row block (the tile's rows
  // when it has fewer) by 128 bytes of columns (64 for 32 bf16 columns),
  // so that a store never reaches a neighbouring tile's rows or columns.
  CUtensorMap tma_o;
  const uint64_t go = G > 1 ? p.so : M * N;
  const uint32_t box_cols = PN < 128 / (p.out_f32 ? 4 : 2)
                                ? PN : 128 / (p.out_f32 ? 4 : 2);
  const bool o_ok = encode_cached(&tma_o, p.out_f32, p.out, N, M, G, go,
                                  box_cols, p.bm < 64 ? p.bm : 64);
  if (!a_ok || !b_ok || !o_ok) return cudaErrorInvalidValue;
  return launch_resident(kernel, p.ctas, S::kThreads, smem, stream, tma_a,
                         tma_b, tma_o, p);
}

template <int NWG, int PN, bool kGrouped, int TA, int TB>
cudaError_t launch_f32(Params p, cudaStream_t stream) {
  using S = Tf32<NWG, PN>;
  p.ks = kF32Ks;
  const int rows = p.bm < S::kRows ? p.bm : S::kRows;
  const size_t stage = static_cast<size_t>(rows + PN) * kF32Ks * 4;
  const size_t fixed =
      1024 + 2 * S::kBBytes + NWG * kEpiBytes + 2 * kMaxStages * 8;
  size_t stages = (kMaxSmem - fixed) / stage;
  if (stages > kMaxStages) stages = kMaxStages;
  const size_t smem = fixed + stages * stage;
  if (stages < 2 || static_cast<int>(stages) != p.plan_stages ||
      smem != static_cast<size_t>(p.plan_smem))
    return cudaErrorInvalidValue;
  p.stages = static_cast<int>(stages);
  void (*kernel)(CUtensorMap, CUtensorMap, Params);
  if constexpr (kGrouped)
    kernel = gemm_grouped_f32<NWG, PN, TA, TB>;
  else
    kernel = gemm_dense_f32<NWG, PN, TA, TB>;
  static const cudaError_t opted =
      opt_in_smem(reinterpret_cast<const void*>(kernel));
  if (opted != cudaSuccess) return opted;
  // Each map over its operand as stored, in boxes of 32 f32 (128-byte
  // rows): A (M, K) in 32 x rows boxes or (K, M) in 32 x 32; B (N, K) in
  // 32 x PN or (K, N) in 32 x 32.
  CUtensorMap tma_a, tma_b;
  const uint64_t M = p.M, N = p.N, K = p.K, G = p.groups;
  const uint64_t ga = G > 1 ? p.sa : M * K, gb = G > 1 ? p.sb : K * N;
  const bool a_ok =
      TA ? encode_cached(&tma_a, true, p.a, M, K, G, ga, kF32Box, kF32Ks)
         : encode_cached(&tma_a, true, p.a, K, M, G, ga, kF32Ks, rows);
  const bool b_ok =
      TB ? encode_cached(&tma_b, true, p.b, K, N, G, gb, kF32Ks, PN)
         : encode_cached(&tma_b, true, p.b, N, K, G, gb, kF32Box, kF32Ks);
  if (!a_ok || !b_ok) return cudaErrorInvalidValue;
  return launch_resident(kernel, p.ctas, S::kThreads, smem, stream, tma_a,
                         tma_b, p);
}

// The f32 kernel of (consumer warpgroups, pass width) for the tile: one
// warpgroup up to 64 rows, two above (a 256-row tile in two 128-row
// passes), passes of up to 128 columns; kernels/matmul.py::f32_tiling
// mirrors it.
template <bool kGrouped, int TA, int TB>
cudaError_t dispatch_f32(const Params& p, cudaStream_t stream) {
  const int nwg = p.bm <= 64 ? 1 : 2;
  const int pn = p.bn < 128 ? p.bn : 128;
#define REPRO_CASE(NWG, PN)            \
  if (nwg == NWG && pn == PN)          \
    return launch_f32<NWG, PN, kGrouped, TA, TB>(p, stream);
  REPRO_CASE(1, 32) REPRO_CASE(1, 64) REPRO_CASE(1, 128)
  REPRO_CASE(2, 32) REPRO_CASE(2, 64) REPRO_CASE(2, 128)
#undef REPRO_CASE
  return cudaErrorInvalidValue;
}

// Picks the tensor-core kernel of (warpgroups, 64-row blocks each, pass
// width) for the tile; one per (bm, bn) of the gpu_h100_like menu.
template <bool kGrouped, int TA, int TB>
cudaError_t dispatch_sm90(const Params& p, cudaStream_t stream) {
  const int nwg = p.bm <= 64 ? 1 : 2;
  const int mb = p.bm == 256 ? 2 : 1;
  const int pn = p.bm == 256 && p.bn == 256 ? 128 : p.bn;
#define REPRO_CASE(NWG, MB, PN)                 \
  if (nwg == NWG && mb == MB && pn == PN)       \
    return launch_sm90<NWG, MB, PN, kGrouped, TA, TB>(p, stream);
  REPRO_CASE(1, 1, 32) REPRO_CASE(1, 1, 64) REPRO_CASE(1, 1, 128)
  REPRO_CASE(1, 1, 256) REPRO_CASE(2, 1, 32) REPRO_CASE(2, 1, 64)
  REPRO_CASE(2, 1, 128) REPRO_CASE(2, 1, 256) REPRO_CASE(2, 2, 32)
  REPRO_CASE(2, 2, 64) REPRO_CASE(2, 2, 128)
#undef REPRO_CASE
  return cudaErrorInvalidValue;
}

inline bool tile_ok(int v) {
  return v == 32 || v == 64 || v == 128 || v == 256;
}

// ---------------------------------------------------------------------------
// The epilogue's backward over groups of M rows (the grouped GEMM's (E, C,
// N) output as E groups of C rows; one group for the dense GEMM).  CTA (x,
// y) takes columns [64 x, 64 x + 64) of rows [rows_per_cta b, ...) of group
// g, y = g blocks_per_group + b; lane l of warp w takes columns 2 l, 2 l + 1
// of rows w, w + 8, ...  With a bias a group has one row block, so each
// column's sum of the group is complete in its CTA: every warp sums its rows
// in order, then the eight warp sums are added in warp order.
// ---------------------------------------------------------------------------

constexpr int kEbCols = 64;
constexpr int kEbWarps = 8;

struct EpiBwdParams {
  // Each (groups M, N), rows contiguous:
  const void* dout;   // the output's type
  const float* z;     // pre-activation z = A B (+ bias), f32
  const void* gate;   // swiglu only
  void* dz;           // A's type (written unless act is none)
  void* dgate;        // the gate's type (swiglu only)
  float* dbias;       // (groups, N), f32 (with has_bias)
  int M, N, rows_per_cta;  // M: the rows of one group
  int blocks_per_group;
  int dout_f32, gate_f32, dz_f32;
  int act, has_bias;
};

__device__ __forceinline__ void store_ep2(void* p, size_t i, int f32, float x,
                                          float y) {
  if (f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(x, y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + i) =
        __floats2bfloat162_rn(x, y);
  }
}

// d act(z) / dz (times the gate for swiglu) and, for swiglu, d out / d gate
// = silu(z); the derivatives of activate<>() above.
__device__ __forceinline__ void act_grad(int act, float z, float gate,
                                         float& dz, float& dgate) {
  dgate = 0.0f;
  if (act == kActGelu) {
    const float c = 0.7978845608028654f, z2 = z * z;
    const float t = tanhf(c * (z + 0.044715f * z2 * z));
    dz = 0.5f * (1.0f + t) +
         0.5f * z * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * z2);
    return;
  }
  if (act == kActSilu || act == kActSwiglu) {
    const float s = 1.0f / (1.0f + expf(-z));
    dz = s * (1.0f + z * (1.0f - s));
    if (act == kActSwiglu) {
      dgate = z * s;
      dz *= gate;
    }
    return;
  }
  dz = 1.0f;
}

__global__ void __launch_bounds__(32 * kEbWarps)
    epilogue_bwd_kernel(const EpiBwdParams p) {
  __shared__ float part[kEbWarps][kEbCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = static_cast<int>(blockIdx.x) * kEbCols + 2 * lane;
  const int g = static_cast<int>(blockIdx.y) / p.blocks_per_group;
  const int r_begin =
      static_cast<int>(blockIdx.y) % p.blocks_per_group * p.rows_per_cta;
  const int r_end = min(p.M, r_begin + p.rows_per_cta);
  const size_t row0 = static_cast<size_t>(g) * p.M;
  float2 db = make_float2(0.0f, 0.0f);
  if (col < p.N) {
    for (int r = r_begin + warp; r < r_end;
         r += kEbWarps) {
      const size_t i = (row0 + r) * p.N + col;
      float2 d = load_ep2(p.dout, i, p.dout_f32);
      if (p.act != kActNone) {
        const float2 z = *reinterpret_cast<const float2*>(p.z + i);
        const float2 gt = p.act == kActSwiglu ? load_ep2(p.gate, i, p.gate_f32)
                                              : make_float2(0.0f, 0.0f);
        float d0, d1, g0, g1;
        act_grad(p.act, z.x, gt.x, d0, g0);
        act_grad(p.act, z.y, gt.y, d1, g1);
        if (p.act == kActSwiglu)
          store_ep2(p.dgate, i, p.gate_f32, d.x * g0, d.y * g1);
        d = make_float2(d.x * d0, d.y * d1);
        store_ep2(p.dz, i, p.dz_f32, d.x, d.y);
      }
      db.x += d.x;
      db.y += d.y;
    }
  }
  if (!p.has_bias) return;  // uniform over the grid
  part[warp][2 * lane] = db.x;
  part[warp][2 * lane + 1] = db.y;
  __syncthreads();
  const int c = static_cast<int>(blockIdx.x * kEbCols + threadIdx.x);
  if (threadIdx.x < kEbCols && c < p.N) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kEbWarps; ++w) s += part[w][threadIdx.x];
    p.dbias[static_cast<size_t>(g) * p.N + c] = s;
  }
}

}  // namespace repro

using namespace repro;

// groups GEMMs of one shape in one launch; operand g starts sa * g (a),
// sb * g (b), so * g (out), ... elements past its base pointer.  The dense
// GEMM is groups = 1 with zero strides.  Either may take A stored (K, M)
// (trans_a, M a multiple of 8 for bf16, 4 for f32: TMA's 16-byte row
// strides) or B stored (N, K) (trans_b), not both; a group's operand is
// then that layout at its own stride.  The plan integers come
// from kernels/matmul.py::work_plan: k-steps per tile and per unit, units
// per CTA and the grid (the walk of a CTA's whole tiles follows from the
// launch, as WorkPlan.column_walk); workspace holds ctas slots of
// max(bm, 64) x max(bn, 64) f32 when a tile is split, flags one int per CTA, all zero.
// f32 inputs also take the f32 kernel's ring stages and shared bytes as
// kernels/matmul.py::f32_tiling planned them (0 for bf16); a launch whose
// own differ is refused.
extern "C" int repro_gemm(
    const void* a, const void* b, void* out, const void* bias,
    const void* gate, const void* residual, void* workspace, void* flags,
    int M, int N, int K, int bm, int bn, int bk, int group_m, int in_f32,
    int out_f32, int ep_f32, int has_bias, int act, int has_res, int groups,
    int grouped, int trans_a, int trans_b, int steps_per_tile,
    int steps_per_unit, int units_per_cta, int ctas, int f32_stages,
    int f32_smem, long long sa, long long sb, long long so,
    long long sbias, long long sgate, long long sres, void* stream) {
  const int vec = in_f32 ? 4 : 8;
  if ((trans_a && trans_b) || (!grouped && groups != 1) ||
      (trans_a && M % vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0 || N % vec || K % vec || !tile_ok(bm) ||
      !tile_ok(bn) || bk <= 0 || bk % 16 || group_m < 1 || act < 0 ||
      act > kActSwiglu || groups < 1 || sa < 0 || sb < 0 || so < 0 ||
      sbias < 0 || sgate < 0 || sres < 0 || sa % vec || sb % vec ||
      steps_per_unit < 1 || steps_per_tile % steps_per_unit ||
      static_cast<long long>(steps_per_tile) * bk < K || units_per_cta < 1 ||
      ctas < 1 || flags == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.a = a;
  p.b = b;
  p.out = out;
  p.bias = bias;
  p.gate = gate;
  p.residual = residual;
  p.ws = static_cast<float*>(workspace);
  p.flags = static_cast<int*>(flags);
  p.M = M;
  p.N = N;
  p.K = K;
  p.bm = bm;
  p.bn = bn;
  p.bk = bk;
  p.group_m = group_m;
  p.out_f32 = out_f32;
  p.ep_f32 = ep_f32;
  p.has_bias = has_bias;
  p.act = act;
  p.has_res = has_res;
  p.groups = groups;
  p.trans_a = trans_a;
  p.trans_b = trans_b;
  p.Tm = (M + bm - 1) / bm;
  p.Tn = (N + bn - 1) / bn;
  p.column_walk = groups > 1 && group_m == 1 && p.Tm > 1;  // WorkPlan's
  p.steps_per_unit = steps_per_unit;
  p.units_per_tile = steps_per_tile / steps_per_unit;
  p.units_per_cta = units_per_cta;
  p.units = static_cast<long long>(groups) * p.Tm * p.Tn * p.units_per_tile;
  p.ctas = ctas;
  p.plan_stages = f32_stages;
  p.plan_smem = f32_smem;
  p.slot_floats = static_cast<size_t>(bm > 64 ? bm : 64) * (bn > 64 ? bn : 64);
  p.sa = static_cast<size_t>(sa);
  p.sb = static_cast<size_t>(sb);
  p.so = static_cast<size_t>(so);
  p.sbias = static_cast<size_t>(sbias);
  p.sgate = static_cast<size_t>(sgate);
  p.sres = static_cast<size_t>(sres);
  // The grid must cover every unit with no empty CTA, and a split tile
  // needs the workspace.
  const long long q = units_per_cta;
  if (static_cast<long long>(ctas) * q < p.units ||
      static_cast<long long>(ctas - 1) * q >= p.units ||
      (workspace == nullptr && ctas > 1 && q % p.units_per_tile != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_f32 && grouped)
    err = trans_a   ? dispatch_f32<true, 1, 0>(p, s)
          : trans_b ? dispatch_f32<true, 0, 1>(p, s)
                    : dispatch_f32<true, 0, 0>(p, s);
  else if (in_f32)
    err = trans_a   ? dispatch_f32<false, 1, 0>(p, s)
          : trans_b ? dispatch_f32<false, 0, 1>(p, s)
                    : dispatch_f32<false, 0, 0>(p, s);
  else if (grouped)
    err = trans_a   ? dispatch_sm90<true, 1, 0>(p, s)
          : trans_b ? dispatch_sm90<true, 0, 1>(p, s)
                    : dispatch_sm90<true, 0, 0>(p, s);
  else
    err = trans_a   ? dispatch_sm90<false, 1, 0>(p, s)
          : trans_b ? dispatch_sm90<false, 0, 1>(p, s)
                    : dispatch_sm90<false, 0, 0>(p, s);
  return static_cast<int>(err);
}

// The epilogue's backward over groups x (M, N), rows contiguous: dz (A's
// type, dz_f32), dgate (the gate's type, gate_f32) and dbias (groups, N) f32
// from dout (dout_f32) and the f32 pre-activation z; act 0 reads neither z
// nor the gate and only sums dout's columns into dbias, a row per group.  N
// must be even; rows_per_cta splits each group's rows over the grid's y
// (one block of all M rows when has_bias).
extern "C" int repro_epilogue_bwd(const void* dout, const float* z,
                                  const void* gate, void* dz, void* dgate,
                                  float* dbias, int M, int N, int groups,
                                  int act, int has_bias, int dout_f32,
                                  int gate_f32, int dz_f32, int rows_per_cta,
                                  void* stream) {
  if (M <= 0 || N <= 0 || N % 2 || groups < 1 || act < 0 ||
      act > kActSwiglu || rows_per_cta <= 0 ||
      (has_bias && (rows_per_cta < M || !dbias)) ||
      (act != kActNone && (!z || !dz)) || (act == kActSwiglu && (!gate || !dgate)) ||
      (act == kActNone && !has_bias))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (M + rows_per_cta - 1) / rows_per_cta;
  EpiBwdParams p{dout, z, gate, dz, dgate, dbias, M, N, rows_per_cta, blocks,
                 dout_f32, gate_f32, dz_f32, act, has_bias};
  const dim3 grid((N + kEbCols - 1) / kEbCols,
                  static_cast<unsigned>(static_cast<long long>(groups) * blocks));
  if (static_cast<long long>(groups) * blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  epilogue_bwd_kernel<<<grid, 32 * kEbWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
