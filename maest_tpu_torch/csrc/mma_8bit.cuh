// 8-bit tensor-core helpers shared by the int8 / e4m3 attention kernels
// (sm_90a): mma.sync m16n8k32 for s8 (s32 accumulate, sm_80+) and e4m3
// (f32 accumulate, sm_89+, PTX ISA 8.4), fragment loads and packing.
//
// Fragment layout of m16n8k32 with 8-bit A and B (PTX ISA), lane = 4 g + t;
// each register holds four consecutive k elements, the lowest in bits 0-7:
//   A: a0 (row g, k 4t..4t+3), a1 (row g+8, same), a2 (row g, k 16+4t..
//      16+4t+3), a3 (row g+8, same)
//   B: b0 (k 4t..4t+3, col g), b1 (k 16+4t..16+4t+3, col g)
//   C: as m16n8k16: c0,c1 (row g, cols 2t..2t+1), c2,c3 (row g+8, same)
// On a row-major tile of 16-byte rows, ldmatrix (no .trans) hands lane the
// bytes 4t..4t+3 of row g of each 8x16-byte matrix, which is the A fragment
// of a 16-row tile and the B fragment of X.Y^T (contraction over the row's
// bytes). ldmatrix.trans transposes 16-bit elements and cannot reorder
// bytes, so a product that contracts over the sequence reads a transposed
// copy made beforehand.
//
// Re-using an accumulator as the next A operand: a thread holds, for row g
// of a 16 x 32 tile of C (four n-tiles), the columns 2t, 2t+1, 8+2t, 9+2t,
// 16+2t, 17+2t, 24+2t, 25+2t, while the A fragment wants 4t..4t+3 and
// 16+4t..16+4t+3. A contraction does not care in which order its index
// runs, so the thread packs its own values as they lie (pack_a below) and
// the transposed copy of the other operand stores the sequence in the
// matching order: within each 16-row group, row 8a + 2t + c sits at
// column 4t + 2a + c (seq_pos). No shuffle is needed.
#pragma once

#include <cuda_fp8.h>

#include "mma_bf16.cuh"

namespace maest {

constexpr int LD8 = 64 + 16;  // shared-memory row of 64 bytes (a 64-key or
                              // head_dim-64 row), padded to 80: the 8 rows an
                              // ldmatrix phase reads hit 32 banks
// the padded row of d bytes (head_dim d, 8-bit): 80 at 64, 144 at 128, whose
// 8 rows of an ldmatrix phase also hit 32 banks
__host__ __device__ constexpr int ld8(int d) { return d + 16; }

__device__ __forceinline__ uint32_t ld_u32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x32, row-major) * b (32x8, column-major); s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b with e4m3 operands and fp32 accumulators
__device__ __forceinline__ void mma_e4m3(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments (KS k-steps of 32 over d: 2 at head_dim 64) of the rows
// row0 / row0 + 8 of a (row, 32 KS) 8-bit view in global memory; rows are
// clamped to n - 1
template <int KS>
__device__ __forceinline__ void load_row_frags8(uint32_t (&f)[KS][4],
                                                const uint8_t* base,
                                                long long rs, int row0, int n,
                                                int t) {
  const uint8_t* r0 = base + static_cast<long long>(min(row0, n - 1)) * rs;
  const uint8_t* r1 = base + static_cast<long long>(min(row0 + 8, n - 1)) * rs;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 32 + 4 * t;
    f[kk][0] = ld_u32(r0 + c);
    f[kk][1] = ld_u32(r1 + c);
    f[kk][2] = ld_u32(r0 + c + 16);
    f[kk][3] = ld_u32(r1 + c + 16);
  }
}

__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
  return (b0 & 0xffu) | (b1 & 0xffu) << 8 | (b2 & 0xffu) << 16 |
         (b3 & 0xffu) << 24;
}

// the bytes x[4][4] of a 16 x 32 C-layout tile (four n-tiles of 8
// columns) as the A fragment of one 32-deep k-step, in the seq_pos order
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const uint32_t (&x)[4][4]) {
  a[0] = pack4(x[0][0], x[0][1], x[1][0], x[1][1]);
  a[1] = pack4(x[0][2], x[0][3], x[1][2], x[1][3]);
  a[2] = pack4(x[2][0], x[2][1], x[3][0], x[3][1]);
  a[3] = pack4(x[2][2], x[2][3], x[3][2], x[3][3]);
}

// column of sequence row r in a transposed copy (see the note above)
__host__ __device__ __forceinline__ int seq_pos(int r) {
  const int i = r & 15;
  return (r & ~15) + ((i >> 1) & 3) * 4 + (i >> 3) * 2 + (i & 1);
}

// round half to even into an int8 byte (|x| <= 127.5 by construction)
__device__ __forceinline__ uint32_t to_s8(float x) {
  return static_cast<uint32_t>(static_cast<int>(rintf(x))) & 0xffu;
}

// round half to even into an int8 byte, saturated to [-128, 127], NaN to
// 0: the conversion of jnp.round(x).astype(jnp.int8), for values that may
// leave the int8 range
__device__ __forceinline__ uint32_t to_s8_sat(float x) {
  uint32_t r;
  asm("cvt.rni.sat.s8.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffu;
}

// e4m3 byte of a probability (x in [0, 1]), round to nearest even. The
// hardware conversion saturates; no value in [0, 1] reaches e4m3's range
// limit (448), so this is the JAX package's cast, which gives NaN there.
// (q, k and v are cast before the kernel, NaN beyond the range.)
__device__ __forceinline__ uint32_t prob_to_e4m3(float x) {
  return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

}  // namespace maest
