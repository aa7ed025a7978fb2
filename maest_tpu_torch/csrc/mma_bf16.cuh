// Tensor-core helpers shared by the attention kernels (sm_90a): bf16
// packing, cp.async staging, ldmatrix and mma.sync m16n8k16.
//
// Fragment layout of m16n8k16 (PTX ISA), lane = 4 g + t:
//   A: a0 (row g, cols 2t..2t+1), a1 (row g+8, same), a2 (row g, cols
//      2t+8..2t+9), a3 (row g+8, same)
//   B: b0 (rows 2t..2t+1, col g), b1 (rows 2t+8..2t+9, col g)
//   C: c0,c1 (row g, cols 2t..2t+1), c2,c3 (row g+8, same)
// ldmatrix.x4 gives lane the pair (row g, cols 2t..2t+1) of each of four
// 8x8 tiles whose rows lanes 8i..8i+7 address; .trans gives the pair
// (rows 2t..2t+1, col g). On a row-major (row, d) tile in shared memory
// the first is the B operand of X.Y^T (contraction over d), the second
// that of P.Y (contraction over the tile's rows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace maest {

constexpr int D = 64;  // head_dim of the probe kernels, and the default D
                       // of the production kernels (instances at 64, 128)
constexpr float NEG_INF = -1e30f;

struct Strides {  // element strides of a (B, N, H, D) view
  long long b, n, h;
};

using bf16 = __nv_bfloat16;

// the padded bf16 shared-memory row of head_dim d: 72 (144 bytes) at 64,
// 136 (272 bytes) at 128, so the 8 rows an ldmatrix phase reads hit 32
// banks
__host__ __device__ constexpr int ld_bf16(int d) { return d + 8; }

// log2 of a power of two, for shifts that index rows of chunks
__host__ __device__ constexpr int ilog2(int x) {
  return x > 1 ? 1 + ilog2(x / 2) : 0;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses registers; src_bytes 0 fills
// the destination with zeros (rows past the end of the sequence)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row-major) * b (16x8, column-major); fp32 accumulators
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments (KS k-steps of 16 over d: 4 at head_dim 64) of the 16 rows
// row0 / row0 + 8 of a (row, 16 KS) bf16 view, read from global memory;
// rows are clamped to n - 1
template <int KS>
__device__ __forceinline__ void load_row_frags(uint32_t (&f)[KS][4],
                                               const bf16* base, long long rs,
                                               int row0, int n, int t) {
  const bf16* r0 = base + static_cast<long long>(min(row0, n - 1)) * rs;
  const bf16* r1 = base + static_cast<long long>(min(row0 + 8, n - 1)) * rs;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = ld_u32(r0 + c);
    f[kk][1] = ld_u32(r1 + c);
    f[kk][2] = ld_u32(r0 + c + 8);
    f[kk][3] = ld_u32(r1 + c + 8);
  }
}

// The runtime-width (``_dn``) kernels stage head_dim in chunks of CH columns
// (rows of ld_bf16(CH) in shared memory).
constexpr int CH = 64;

// c (16 x 64) += a (a warp's 16 rows over one 64-column chunk, 4 k-steps)
// . tile^T (64 staged rows of the same chunk): C layout, n-tile nt covers
// tile rows 8 nt ..; per n-tile the k-steps run in order, so chunk after
// chunk the sums over head_dim run as one pass over the whole row would
__device__ __forceinline__ void chunk_dot(float (&c)[8][4],
                                          const uint32_t (&a)[4][4],
                                          const bf16 (*tile)[ld_bf16(CH)],
                                          int lr, int li) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t f[4];
      ldmatrix_x4(f, &tile[nt * 8 + lr][half * 32 + li * 8]);
      mma_16816(c[nt], a[2 * half], f[0], f[1]);
      mma_16816(c[nt], a[2 * half + 1], f[2], f[3]);
    }
}

// the C-layout tile x (16 x 64) as bf16 A fragments of 4 k-steps
__device__ __forceinline__ void chunk_frags(uint32_t (&f)[4][4],
                                            const float (&x)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    f[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(x[nt][0], x[nt][1]);
    f[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(x[nt][2], x[nt][3]);
  }
}

// acc (16 x 64) += p (16 x 64 staged rows, bf16 A fragments) . tile (the 64
// staged rows of one 64-column chunk), through ldmatrix.trans; the k-steps
// over the staged rows run in order
__device__ __forceinline__ void chunk_pv(float (&acc)[8][4],
                                         const uint32_t (&p)[4][4],
                                         const bf16 (*tile)[ld_bf16(CH)],
                                         int lr, int li) {
#pragma unroll
  for (int kj = 0; kj < 4; ++kj)
#pragma unroll
    for (int dc = 0; dc < 4; ++dc) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, &tile[kj * 16 + (li & 1) * 8 + lr]
                                [dc * 16 + (li >> 1) * 8]);
      mma_16816(acc[2 * dc], p[kj], f[0], f[1]);
      mma_16816(acc[2 * dc + 1], p[kj], f[2], f[3]);
    }
}

}  // namespace maest
