// The 3xTF32 machinery that the fp32 attention kernels at head_dim 64 share
// (attn_fwd_tf32.cuh, the forward; attn_bwd_tf32.cuh, the backward): the
// tf32 split, the tf32 wgmma products, the layout of the tf32 planes in
// shared memory, the prep pass that writes the planes, and their TMA maps.
//
// 3xTF32: the parity tier holds 2e-5, which one TF32 product (10 mantissa
// bits) misses by ~20x. Each operand x is split into hi = tf32_rna(x) and
// lo = tf32_rna(x - hi) (x - hi is exact in fp32), and a product is three
// tf32 wgmma products into one fp32 accumulator: first the two small terms
// lo.hi and hi.lo over every k-step, then hi.hi. The dropped lo.lo term is
// ~2^-22 of the product. TF_3X false keeps hi.hi alone (1xTF32), the fault
// a planted copy builds to show the checks see a dropped term.
//
// tf32 wgmma has no transpose bit: both shared-memory operands are K-major,
// so a product that contracts over the sequence reads a transposed copy
// (B H, 64, N_pad) that the prep pass writes. The fp32 accumulator of an
// m64nN product hands thread (g, t) the columns 8j + 2t and 8j + 2t + 1,
// and the tf32 register-A fragment of a k8 step wants k = t and t + 4, so a
// thread packs its values as they lie (tf_pack) and the transposed copy
// holds, inside each 8-row group, row tf_key_at(p) at position p (0, 2, 4,
// 6, 1, 3, 5, 7): positions p < 4 are rows 2p, the others 2 (p - 4) + 1.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked

#include "attn_fwd_wgmma.cuh"  // mbarriers, 4-D TMA, descriptors, wgmma
                                // fences, setmaxnreg, encode_tiled

namespace maest {

// three products a tf32 product (lo.hi, hi.lo, hi.hi); false: hi.hi alone
constexpr bool TF_3X = true;

// ---------------------------------------------------------------- PTX ---
// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as fp32 bits with the low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi = tf32_rna(x), lo = tf32_rna(x - hi)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// the key (or sequence row) at position p of an 8-row group of the
// transposed copies, and the position of row r
__host__ __device__ constexpr int tf_key_at(int p) {
  return ((p & 3) << 1) | (p >> 2);
}
__host__ __device__ constexpr int tf_pos_of(int r) {
  return ((r & 1) << 2) | (r >> 1);
}

__device__ __forceinline__ void tf_st4(uint32_t addr, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// d (64 x 32, fp32, C layout a warp) (+)= A (64 x 8 tf32, shared memory,
// K-major) . B (8 x 32 tf32, shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void tf_ss_n32(float (&d)[4][4], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32, C layout a warp) (+)= A (64 x 8 tf32, shared memory,
// K-major) . B (8 x 64 tf32, shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void tf_ss_n64(float (&d)[8][4], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32) (+)= A (64 x 8 tf32, registers: a warp's 16 rows, a0
// (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)) . B (8 x 64
// tf32, shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void tf_rs_n64(float (&d)[8][4],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ------------------------------------------------------------- layout ---
constexpr uint32_t TF_HALF = 64 * 128;    // 64 rows x 32 tf32: one swizzle span
constexpr uint32_t TF_TILE = 4 * TF_HALF; // 64 x 64: hi, lo, two halves each

// the descriptor of k-step kk (8 columns) of plane `lo` (0 hi, 1 lo) of a
// 64-column operand at `base` stored as [hi 0..31][hi 32..63][lo 0..31][lo
// 32..63], each half `half` bytes of 128-byte rows (TMA's 128-byte swizzle,
// base 1024-byte aligned): +32 bytes a k-step inside a half
__device__ __forceinline__ uint64_t tf_desc(uint32_t base, uint32_t half,
                                            int lo, int kk) {
  return sw128_desc(base + (2 * lo + (kk >> 2)) * half) + 2 * (kk & 3);
}

// the tf32 register-A fragments (hi, lo) of accumulator chunk x (columns
// 8j.. of a warp's rows): a0 = (g, 2t), a1 = (g + 8, 2t), a2 = (g, 2t + 1),
// a3 = (g + 8, 2t + 1), so k position t holds column 2t and t + 4 column
// 2t + 1 (tf_key_at)
__device__ __forceinline__ void tf_pack(const float (&x)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  tf32_split(x[0], hi[0], lo[0]);
  tf32_split(x[2], hi[1], lo[1]);
  tf32_split(x[1], hi[2], lo[2]);
  tf32_split(x[3], hi[3], lo[3]);
}

// ---------------------------------------------------------- prep pass ---
// One 64-row tile of a (B, N, H, 64) fp32 view split into tf32 planes:
// hi_r / lo_r (B H, n_pad, 64) as it lies, and hi_t / lo_t (B H, 64,
// n_pad) transposed, row r of each 8-row group at position tf_pos_of(r);
// rows past N are zeros. Either pair may be null. Grid (n_pad / 64, B H),
// 256 threads.
__global__ void __launch_bounds__(256)
tf_split_kernel(const float* __restrict__ x, Strides xs, int n, int n_pad,
                int heads, float* __restrict__ hi_r, float* __restrict__ lo_r,
                float* __restrict__ hi_t, float* __restrict__ lo_t) {
  __shared__ float tile[64][65];  // [row][d], 65: conflict-free columns
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int r0 = blockIdx.x * 64;
  const float* xb = x + b * xs.b + h * xs.h;
  for (int i = threadIdx.x; i < 64 * 64; i += 256) {
    const int r = i >> 6, d = i & 63;
    const int row = r0 + r;
    const float val = row < n ? xb[static_cast<long long>(row) * xs.n + d] : 0.f;
    tile[r][d] = val;
    if (hi_r != nullptr) {
      uint32_t hi, lo;
      tf32_split(val, hi, lo);
      const long long at = (static_cast<long long>(bh) * n_pad + row) * 64 + d;
      hi_r[at] = __uint_as_float(hi);
      lo_r[at] = __uint_as_float(lo);
    }
  }
  if (hi_t == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 64; i += 256) {
    const int d = i >> 6, p = i & 63;  // position p of the tile
    uint32_t hi, lo;
    tf32_split(tile[(p & ~7) | tf_key_at(p & 7)][d], hi, lo);
    const long long at = (static_cast<long long>(bh) * 64 + d) * n_pad + r0 + p;
    hi_t[at] = __uint_as_float(hi);
    lo_t[at] = __uint_as_float(lo);
  }
}

// rows of the planes: round_up(n, 64)
__host__ __device__ constexpr int tf_pad(int n) { return (n + 63) / 64 * 64; }

// --------------------------------------------------------------- host ---
// the map of an fp32 plane set (planes, rows, cols) at `ptr`, contiguous:
// dims (cols, rows, planes), boxes of 32 columns x `box_rows` rows, the
// 128-byte swizzle, zeros past the edges
inline bool tf_encode_plane(CUtensorMap* map, const float* ptr, int planes,
                            int rows, int cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(rows) * cols * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one split launch (tf_split_kernel) of the view x into planes of n_pad
// rows (a multiple of 64) on `stream`
inline int tf_split(const float* x, const Strides& xs, int batch, int n,
                    int n_pad, int heads, float* hi_r, float* lo_r,
                    float* hi_t, float* lo_t, cudaStream_t stream) {
  const dim3 grid(n_pad / 64, batch * heads);
  tf_split_kernel<<<grid, 256, 0, stream>>>(x, xs, n, n_pad, heads, hi_r,
                                             lo_r, hi_t, lo_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
