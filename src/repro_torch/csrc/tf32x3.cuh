// Split-TF32 ("3xTF32") products on the tensor cores, shared by the f32
// GEMM (csrc/matmul.cu) and the f32 flash attention, forward and backward
// (csrc/flash_attention.cu).
//
// A TF32 tensor-core product keeps ten mantissa bits of each operand, too
// few for the f32 tolerances.  Each f32 operand x is split into hi, x
// rounded to TF32 (to nearest, ties away from zero: the value
// cvt.rna.tf32.f32 gives), and lo = x - hi, which is exact in f32 and
// which the tensor cores read as TF32 by dropping its low 13 bits (they
// ignore those bits of a .tf32 operand).  hi + lo then keeps 21-22 of the
// 24 bits of x (within 2^-22 |x|, against 2^-23 with lo rounded to
// nearest too), and a product is summed as a_lo b_hi + a_hi b_lo +
// a_hi b_hi into f32 accumulators (the a_lo b_lo term, 2^-22 of the
// product, is dropped).  The accumulator's own adds are not rounded to
// nearest, so a kernel keeps the number of them into one accumulator small
// (a fresh one a few k8 steps, then a rounded f32 add into its running
// sum).  The split costs an integer add, a mask and a subtraction a
// value; with cvt.rna.tf32.f32 on both parts the f32 GEMM's six zamba2-7b
// prefill products took 2.27 ms, with this split 1.96 (tools/f32_ab.py,
// one H100, both summed in one accumulator).  The f32 GEMM runs the
// products on wgmma (A from registers, B split into K-major hi / lo copies
// in shared memory: tf32 wgmma takes B only K-major and no transpose),
// the f32 flash forward and backward on mma.sync.m16n8k8, whose fragments
// load from shared memory in any layout: the row operands of P V, P^T dO,
// dS^T Q and dS K are MN-major, and P and dS start in registers.  Both
// load their A fragments (flash also its B fragments) with 32-bit
// shared-memory loads and split them in registers.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32), lane = 4 g + t:
//   A (16 x 8): a[0] = A[g][t], a[1] = A[g + 8][t], a[2] = A[g][t + 4],
//               a[3] = A[g + 8][t + 4];
//   B (8 x 8):  b[0] = B[t][g], b[1] = B[t + 4][g];
//   C (16 x 8): c[0..1] = C[g][2 t .. 2 t + 1], c[2..3] = C[g + 8][2 t ..].
// A product whose A operand is the accumulator of an earlier one (P, dS)
// takes its k index in the order 2 t, 2 t + 1 (ka_from_acc and the
// *_pairs loads of B): a sum over k does not depend on the order, and a
// thread then holds its A fragment already.
//
// Bank conflicts: a tile of rows of `ld` floats serves fragment loads
// across its rows (A[g][t], B[n = g][k = t]) without conflicts when
// ld % 32 == 4; the paired-k loads across its columns need the same.
#pragma once
#include <stdint.h>

namespace repro {

// Round to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32's
// value for every finite x): half a TF32 ulp added to the magnitude, the
// low 13 bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_a(const float (&x)[4], FragA& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], f.hi[i], f.lo[i]);
}

__device__ __forceinline__ void split_b(float x0, float x1, FragB& f) {
  split_tf32(x0, f.hi[0], f.lo[0]);
  split_tf32(x1, f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = A B (no accumulator read: the zeros come from the zero register).
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// d += A B in split TF32: the two small cross terms first, then hi hi.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// d = A B in split TF32, into a fresh accumulator.
__device__ __forceinline__ void mma_tf32x3_fresh(float (&d)[4],
                                                 const FragA& a,
                                                 const FragB& b) {
  mma_tf32_fresh(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// ---------------------------------------------------------------------------
// The warpgroup form (the f32 GEMM): D (64 x N, f32, registers) (+)= A
// (64 x 8, tf32 from registers: each warp's 16 rows in the fragment layout
// above) * B (8 x N, tf32, K-major in shared memory: tf32 wgmma takes no
// transpose).  scale_d = 0 overwrites d.  Thread t of the warpgroup holds
// d[4 j + 2 h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) + e].
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_tf32_m64n32_rs(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_m64n64_rs(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_m64n128_rs(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_tf32_m64n32_rs(d, a, db, scale_d);
  if constexpr (N == 64) wgmma_tf32_m64n64_rs(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_tf32_m64n128_rs(d, a, db, scale_d);
}

// ---------------------------------------------------------------------------
// Fragment loads from shared memory (f32 tiles), split on the way in.
// `s` points at the fragment's element (0, 0); ld is the tile's row stride
// in floats; g = lane / 4, t = lane % 4.
// ---------------------------------------------------------------------------

// A stored by rows ([m][k]: K-major).
__device__ __forceinline__ void load_a_rows(FragA& f, const float* s, int ld,
                                            int g, int t) {
  const float x[4] = {s[g * ld + t], s[(g + 8) * ld + t],
                      s[g * ld + t + 4], s[(g + 8) * ld + t + 4]};
  split_a(x, f);
}

// B stored by its n rows ([n][k]: K-major).
__device__ __forceinline__ void load_b_rows(FragB& f, const float* s, int ld,
                                            int g, int t) {
  split_b(s[g * ld + t], s[g * ld + t + 4], f);
}

// B stored by its k rows, k in the paired order of ka_from_acc: rows 2 t
// and 2 t + 1.
__device__ __forceinline__ void load_b_cols_pairs(FragB& f, const float* s,
                                                  int ld, int g, int t) {
  split_b(s[2 * t * ld + g], s[(2 * t + 1) * ld + g], f);
}

// The A fragment (k in the paired order) of the 16 x 8 accumulator c of an
// earlier product: c's columns 2 t, 2 t + 1 become k 2 t, 2 t + 1.
__device__ __forceinline__ void ka_from_acc(FragA& f, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split_a(x, f);
}

}  // namespace repro
