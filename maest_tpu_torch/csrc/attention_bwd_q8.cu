// int8 attention backward for Hopper (sm_90a), head_dim 64, 128 and 256
// (K7; a template parameter D_ of each kernel), and any multiple of 64
// above (the _dn kernels, head_dim a runtime argument).
//
// The bf16 entry at head_dim 64, maest_attn_bwd_q8, runs the s8 wgmma/TMA
// kernels of attn_bwd_q8_wgmma.cuh after this file's amax pass (one score
// pass per key tile and q tile, dq summed in int32); the mma.sync kernels
// below stay as its control (maest_attn_bwd_q8_mma) and run every other
// instance (fp32, head_dim 128, 256, _dn) and the backward rig's.
//
// Replaces maest_tpu/ops/attention.py::_attn_bwd_kernel_q8 + _q8_tensor
// (called from _flash_bwd_q8 when bwd_quant="int8" and round_up(N, 128) <=
// 4096). All five products run in int8 with int32 sums, and every scale is
// a scalar, as there:
//
//   scale(x) = max(max|x|, 1e-30) (1/127); x8 = round(x (1/scale(x)))
//   q, do: one scale per (head, q-block); k, v: one per head (all N keys)
//   s   = s_int (qs ks sl); keys >= n_real: -1e30;  p = exp2(s - lse)
//   pst = max(max p, 1e-30);   p8 = round(p (127 / pst))        per q-block
//   dv  = sum over q-blocks of (p8^T . do8) (dos pst (1/127))
//   dp  = (do8 . v8^T) (dos vs);   ds = p (dp - delta) scale
//   dst = max(max |ds|, 1e-30);  ds8 = round(ds (127 / dst))    per q-block
//   dq  = (ds8 . k8) (dst ks (1/127));  dk = sum of (ds8^T . q8) (dst qs (1/127))
//
// with the TPU's association order in every scale product, delta =
// rowsum(do * o) in fp32 from the stored bf16 o, dk and dv summed over the
// q-blocks in fp32 and stored in bf16. The q-block is the TPU's
// (ops/attention.py, bwd_q_block): one block per head at every shipped
// training shape, three at N 1800. Masked keys get exactly zero dk and dv.
//
// Why five launches: pst and dst are maxima over a whole (head, q-block)
// of p and ds, and must be known before the first p8 or ds8 exists. The
// TPU kernel holds a full q-block's scores in VMEM; here a block owns 64
// rows, and CUDA blocks run in no order, so the maxima take a pass of their
// own. Like the bf16 backward (attention_bwd.cu), dk/dv and dq are two
// kernels that each own their output rows, so no sum is taken with atomics
// and the result is deterministic (the maxima use atomicMax on the bits of
// non-negative floats, which is order-free):
//   1. amax:  max|q|, max|do| per (head, q-block); max|k|, max|v| per head;
//   2. quant: int8 q, k, v, do (row-major) and q, do, k transposed in the
//      seq_pos order of mma_8bit.cuh (8-bit products that contract over the
//      sequence read those), and delta;
//   3. scale pass: s and dp over every (row, key), pst and dst;
//   4. dk/dv: a block owns 64 keys and streams every q tile: S^T, dP^T,
//      then p8^T.do8 and ds8^T.q8 with the accumulators as A operands;
//      int32 sums per q-block, folded into fp32 with that block's scalars;
//   5. dq: a block owns 64 q rows and streams the key tiles: ds8.k8.
//
// What bounds it on the H100: at (32, 866, 12, 64) the bf16 tensors it
// must read (q, k, v, o, do) and write (dq, dk, dv), ~340 MB, take 0.10 ms
// at the data-sheet rate, the five products of N^2 64 in int8 0.093 ms.
// This design does more: the scale pass and the two output kernels
// recompute s and dp (nine products in all), and it takes 3 N^2 exp2 on
// the special-function units (16 a clock per SM: ~0.23 ms at 1.8 GHz),
// which bind it before the tensor cores do.
//
// Element types: the kernels are templates over T, the type of q, k, v, o,
// do (read) and dq, dk, dv (written): bf16 (K7, maest_attn_bwd_q8) and
// fp32 (maest_attn_bwd_q8_fp32, K7 under the fp32 tier). The int8 copies,
// the scales and the five int8 products do not depend on T; fp32 inputs
// are quantized from their own values and the gradients stored unrounded.
//
// head_dim 128 (D_ = 128): the dk/dv kernel's four sets of sums (fp32 and
// int32, dk and dv) would take 4 x 64 registers a thread, so, as the bf16
// backward, it computes dk and dv in 64-column slices over a third grid
// axis: each slice's block recomputes s and dp over the full head_dim and
// stages only its 64 d rows of the transposed q and do. The scale pass and
// dq keep their rows whole (dq's int32 sums: 64 registers). The tiles of
// the product kernels then pass the 48 KB of static shared memory and take
// dynamic shared memory (q8b_smem_bytes).
//
// head_dim 256 (D_ = 256): the dk/dv kernel's K and V fragments (64
// registers) no longer fit beside its four sets of sums, so the block
// stages its 64 keys' int8 K and V rows in shared memory (OWN, 2 x 64 rows
// of 272 bytes) and the warps read their A fragments through ldmatrix
// (rows_dot8_own: the same int8 products); it keeps 64-column slices (four
// a head). The dq kernel's int32 sums (128 registers whole) are summed in
// 128-column slices over a third grid axis (dq_cols), each recomputing s
// and dp over the full head_dim and staging only its rows of K^T. The
// quant pass's transposed tiles (60 KB) take dynamic shared memory.
//
// The backward rig (scripts/bwd_int8_probe.py:52 _bwd_rig_kernel, its int8
// kind) runs the dk/dv and dq kernels with RIG = true: the rig's fixed
// scalars in place of Stats (no amax, quant or scale pass), p8 and ds8
// saturated as jnp's astype(int8) (its fixed scales take ds8 past +-127),
// one q-block over all rows, no key masked, dk and dv stored as fp32 (one
// int32 sum times 1e-2), dq in bf16; a layout pass of its own
// (bwd_rig_layout_kernel) first makes K's rows and the seq_pos copies from
// the rig's operands. What bounds it at the rig's (384, 896, 64): its bytes
// (354 MB, 0.106 ms) and five int8 products (0.100 ms), far below the two
// kernels' recomputed s and dp and their exp2.

#include "attn_bwd_q8_wgmma.cuh"  // the bf16 route at head_dim 64
#include "mma_8bit.cuh"

namespace {

using namespace maest;

constexpr float INV127 = static_cast<float>(1.0 / 127.0);
constexpr float EPS = 1e-30f;
constexpr int BW = 4;           // warps of the three product kernels
constexpr int BR = 16 * BW;     // rows (q rows or keys) a block owns
constexpr int TILE = 64;        // streamed rows per shared-memory tile

__device__ __forceinline__ float q8_scale(float amax) {
  return __fmul_rn(fmaxf(amax, EPS), INV127);
}

// per (head, q-block): max|q|, max|do|, max p, max|ds|; per head: max|k|,
// max|v|. Non-negative floats, zeroed by the caller, raised with atomicMax
// on their bits.
struct Stats {
  float *qmax, *domax, *pmax, *dsmax, *kmax, *vmax;
};

// the int8 copies: q, k, v, do (bh, N_pad, D); q, do, k as (bh, D, N_pad)
struct Bytes8 {
  uint8_t *q, *k, *v, *dout, *qt, *dot, *kt;
};

__device__ __forceinline__ void atomic_max_pos(float* p, float x) {
  atomicMax(reinterpret_cast<int*>(p), __float_as_int(x));
}

__device__ __forceinline__ void load16(const float* p, float (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(p + 4 * i);
    x[4 * i] = a.x;
    x[4 * i + 1] = a.y;
    x[4 * i + 2] = a.z;
    x[4 * i + 3] = a.w;
  }
}

__device__ __forceinline__ void load16(const bf16* p, float (&x)[16]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint4 a = *reinterpret_cast<const uint4*>(p + 8 * half);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[8 * half + 2 * i] = f.x;
      x[8 * half + 2 * i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float amax8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  const float ma = fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)),
                         fmaxf(fabsf(a.z), fabsf(a.w)));
  const float mb = fmaxf(fmaxf(fabsf(b.x), fabsf(b.y)),
                         fmaxf(fabsf(b.z), fabsf(b.w)));
  return fmaxf(ma, mb);
}

__device__ __forceinline__ float amax8(const bf16* p) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return m;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// two values of a row into T (bf16: rounded to nearest even)
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ------------------------------------------------------------ 1. amax ---
template <typename T, int D_ = D>
__global__ void __launch_bounds__(256)
bwd_q8_amax_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   Stats st, int n, int heads, int bq, int nqb, Strides qs,
                   Strides ks, Strides vs, Strides ds) {
  __shared__ float red[8][4];
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int j = blockIdx.y;
  const int r0 = j * bq;
  const int r1 = min(n, r0 + bq);
  float mx[4] = {0.f, 0.f, 0.f, 0.f};  // q, do, k, v
  for (int i = threadIdx.x; i < (r1 - r0) * (D_ / 8); i += 256) {
    const long long row = r0 + (i >> ilog2(D_ / 8));
    const int c = (i & (D_ / 8 - 1)) * 8;
    mx[0] = fmaxf(mx[0], amax8(q + b * qs.b + row * qs.n + h * qs.h + c));
    mx[1] = fmaxf(mx[1], amax8(dout + b * ds.b + row * ds.n + h * ds.h + c));
    mx[2] = fmaxf(mx[2], amax8(k + b * ks.b + row * ks.n + h * ks.h + c));
    mx[3] = fmaxf(mx[3], amax8(v + b * vs.b + row * vs.n + h * vs.h + c));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    mx[e] = warp_max(mx[e]);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][e] = mx[e];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float x = 0.f;
    for (int w = 0; w < 8; ++w) x = fmaxf(x, red[w][threadIdx.x]);
    const int qb = bh * nqb + j;
    if (threadIdx.x == 0) st.qmax[qb] = x;
    if (threadIdx.x == 1) st.domax[qb] = x;
    if (threadIdx.x == 2) atomic_max_pos(st.kmax + bh, x);
    if (threadIdx.x == 3) atomic_max_pos(st.vmax + bh, x);
  }
}

// ----------------------------------------------------------- 2. quant ---
// dynamic shared memory of the quant pass: its transposed tiles past
// head_dim 128 (static below)
__host__ __device__ constexpr int quant_smem_bytes(int d) {
  return d > 128 ? 3 * d * LD8 : 0;
}

// a block quantizes 64 rows of one head; rows >= n are written as zeros
template <typename T, int D_ = D>
__global__ void __launch_bounds__(256)
bwd_q8_quant_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, Stats st, Bytes8 by,
                    float* __restrict__ delta, int n, int heads, int bq,
                    int nqb, Strides qs, Strides ks, Strides vs, Strides os,
                    Strides ds) {
  constexpr bool DYN = quant_smem_bytes(D_) > 0;
  // q, do, k transposed
  __shared__ __align__(16) uint8_t tr_st[3][DYN ? 1 : D_][LD8];
  extern __shared__ __align__(16) uint8_t tr_dyn[];
  uint8_t(*tr)[D_][LD8] = DYN ? reinterpret_cast<uint8_t(*)[D_][LD8]>(tr_dyn)
                              : reinterpret_cast<uint8_t(*)[D_][LD8]>(tr_st);
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int t0 = blockIdx.y * TILE;
  const int npad = (n + TILE - 1) / TILE * TILE;
  const int qb = bh * nqb + t0 / bq;  // a 64-row tile lies in one q-block
  const int r = threadIdx.x >> 2;     // row of the tile
  const int s0 = (threadIdx.x & 3) * 16;  // its 16 columns (of each 64)
  const long long row = t0 + r;
  const float inv[4] = {1.f / q8_scale(st.qmax[qb]), 1.f / q8_scale(st.domax[qb]),
                        1.f / q8_scale(st.kmax[bh]), 1.f / q8_scale(st.vmax[bh])};
  float dsum = 0.f;
#pragma unroll
  for (int hh = 0; hh < D_ / 64; ++hh) {  // each 64 columns of the row
    const int c0 = hh * 64 + s0;
    uint32_t w[4][4];  // q8, do8, k8, v8: 16 bytes each
    if (row < n) {
      float x[16], y[16];
      const T* src[4] = {q + b * qs.b + row * qs.n + h * qs.h + c0,
                         dout + b * ds.b + row * ds.n + h * ds.h + c0,
                         k + b * ks.b + row * ks.n + h * ks.h + c0,
                         v + b * vs.b + row * vs.n + h * vs.h + c0};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        load16(src[a], x);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[a][i] = pack4(to_s8(__fmul_rn(x[4 * i], inv[a])),
                          to_s8(__fmul_rn(x[4 * i + 1], inv[a])),
                          to_s8(__fmul_rn(x[4 * i + 2], inv[a])),
                          to_s8(__fmul_rn(x[4 * i + 3], inv[a])));
        if (a == 1) {  // delta = rowsum(do * o), fp32
          load16(o + b * os.b + row * os.n + h * os.h + c0, y);
#pragma unroll
          for (int i = 0; i < 16; ++i) dsum = fmaf(x[i], y[i], dsum);
        }
      }
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) w[a][i] = 0u;
    }
    const long long off = (static_cast<long long>(bh) * npad + row) * D_ + c0;
    uint8_t* rows[4] = {by.q, by.dout, by.k, by.v};
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<uint4*>(rows[a] + off) = make_uint4(w[a][0], w[a][1], w[a][2], w[a][3]);
    const int pos = seq_pos(r);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int i = 0; i < 16; ++i) tr[a][c0 + i][pos] = (w[a][i >> 2] >> (8 * (i & 3))) & 0xffu;
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  if (row < n && s0 == 0) delta[static_cast<long long>(bh) * n + row] = dsum;
  __syncthreads();
  // the transposed tiles: d rows dr, the 16 sequence columns from s0
#pragma unroll
  for (int hh = 0; hh < D_ / 64; ++hh) {
    const int dr = (threadIdx.x >> 2) + hh * 64;
    const long long toff = (static_cast<long long>(bh) * D_ + dr) * npad + t0 + s0;
    uint8_t* cols[3] = {by.qt, by.dot, by.kt};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      *reinterpret_cast<uint4*>(cols[a] + toff) = *reinterpret_cast<const uint4*>(&tr[a][dr][s0]);
  }
}

// stage rows [row0, row0 + 64) of a (rows, D_) byte array, 16-byte chunks
template <int D_>
__device__ __forceinline__ void stage_rows8(uint8_t (*dst)[ld8(D_)], const uint8_t* src,
                                            long long rs, int row0) {
  for (int i = threadIdx.x; i < TILE * (D_ / 16); i += 32 * BW) {
    const int j = i >> ilog2(D_ / 16);
    const int c = (i & (D_ / 16 - 1)) * 16;
    cp_async16(&dst[j][c], src + static_cast<long long>(row0 + j) * rs + c, 16);
  }
}

// the 16 x 32 int32 product of a warp's A fragments (16 rows x 32 KS) with
// the 32 staged rows r0.. of `tile` (contraction over the row's 32 KS
// bytes)
template <int KS>
__device__ __forceinline__ void rows_dot8(int (&c)[4][4], const uint32_t (&a)[KS][4],
                                          const uint8_t (*tile)[ld8(32 * KS)], int r0,
                                          int lr, int li) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0;
#pragma unroll
    for (int half = 0; half < KS / 2; ++half) {
      uint32_t f[4];
      ldmatrix_x4(f, &tile[r0 + nt * 8 + lr][half * 64 + li * 16]);
      mma_s8(c[nt], a[2 * half], f[0], f[1]);
      mma_s8(c[nt], a[2 * half + 1], f[2], f[3]);
    }
  }
}

// rows_dot8 with the A fragments read from shared memory: the warp's 16
// rows from w0 of `own`, two k-steps at a time for every n-tile
template <int KS>
__device__ __forceinline__ void rows_dot8_own(int (&c)[4][4],
                                              const uint8_t (*own)[ld8(32 * KS)],
                                              int w0,
                                              const uint8_t (*tile)[ld8(32 * KS)],
                                              int r0, int lr, int li) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0;
#pragma unroll
  for (int half = 0; half < KS / 2; ++half) {
    uint32_t a[2][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
      ldmatrix_x4(a[x], &own[w0 + (li & 1) * 8 + lr]
                            [(2 * half + x) * 32 + (li >> 1) * 16]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t f[4];
      ldmatrix_x4(f, &tile[r0 + nt * 8 + lr][half * 64 + li * 16]);
      mma_s8(c[nt], a[0], f[0], f[1]);
      mma_s8(c[nt], a[1], f[2], f[3]);
    }
  }
}

// acc (16 x 8 NDT) += A (16 x 32, one k-step) . the transposed tile's
// sequence columns r0..r0+31 (rows of the tile are d)
template <int NDT>
__device__ __forceinline__ void acc_seq8(int (&acc)[NDT][4], const uint32_t (&a)[4],
                                         const uint8_t (*tile)[LD8], int r0,
                                         int lr, int li) {
#pragma unroll
  for (int dp = 0; dp < NDT / 2; ++dp) {
    uint32_t f[4];
    ldmatrix_x4(f, &tile[(2 * dp + (li >> 1)) * 8 + lr][r0 + (li & 1) * 16]);
    mma_s8(acc[2 * dp], a, f[0], f[1]);
    mma_s8(acc[2 * dp + 1], a, f[2], f[3]);
  }
}

// p and ds of one score element, as _attn_bwd_kernel_q8 rounds them
__device__ __forceinline__ float prob(int s_int, float c_s, bool live, float lse) {
  const float s = live ? __fmul_rn(__int2float_rn(s_int), c_s) : NEG_INF;
  return exp2f(__fsub_rn(s, lse));
}
__device__ __forceinline__ float dscore(float p, int dp_int, float c_dp,
                                        float delta, float scale) {
  const float dp = __fmul_rn(__int2float_rn(dp_int), c_dp);
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// an int8 code: K7's (|x| <= 127.5 by its scales) or, SAT, the rig's
// saturating jnp round(x).astype(int8) (its fixed scales leave the range)
template <bool SAT>
__device__ __forceinline__ uint32_t code8(float x) {
  if constexpr (SAT)
    return to_s8_sat(x);
  else
    return to_s8(x);
}

// dq columns a block of the dq kernel sums: all, or past head_dim 128 a
// slice of 128 (a third grid axis)
__host__ __device__ constexpr int dq_cols(int d) { return d > 128 ? 128 : d; }

// dynamic shared memory of the product kernels past head_dim 64: the rows
// kernel's K and V tiles (rows of ld8(d) bytes) and its K^T tiles (DQ: two
// of dq_cols(d) rows), or the dk/dv kernel's q and do tiles and its two
// pairs of 64-row q^T and do^T tiles (a 64-column slice), and past 128 its
// own K and V rows
__host__ __device__ constexpr int q8b_smem_bytes(int kernel, int d) {
  return d <= 64 ? 0
         : kernel == 2 ? 4 * TILE * ld8(d) + 4 * 64 * LD8 +  // dk/dv
                             (d > 128 ? 2 * BR * ld8(d) : 0)
                       : 4 * TILE * ld8(d) + (kernel ? 2 * dq_cols(d) : d) * LD8;
}

// ----------------------------------------- 3. scale pass and 5. dq ---
// a block owns 64 q rows of one head (one q-block) and streams the key
// tiles below n_real; DQ = false: max p and max |ds| into st.pmax /
// st.dsmax (dq unused; both entries run the <false, bf16> instance); DQ =
// true: dq = (ds8 . k8) (dst ks (1/127)), stored as T
template <bool DQ, typename T, int D_ = D, bool RIG = false>
__global__ void __launch_bounds__(32 * BW)
bwd_q8_rows_kernel(Bytes8 by, const float* __restrict__ lse,
                   const float* __restrict__ delta, Stats st,
                   T* __restrict__ dq, int n, int n_real, int heads, int bq,
                   int nqb, Strides dqs, float sl, float scale) {
  constexpr int LDK = ld8(D_);
  constexpr bool DYN = q8b_smem_bytes(DQ, D_) > 0;
  constexpr int S = DYN ? 1 : 2;  // static buffers, or one placeholder
  __shared__ __align__(128) uint8_t k_st[S][DYN ? 1 : TILE][LDK];
  __shared__ __align__(128) uint8_t v_st[S][DYN ? 1 : TILE][LDK];
  constexpr int DC = DQ ? dq_cols(D_) : D_;  // dq columns of this block
  __shared__ __align__(128) uint8_t kt_st[DQ ? S : 1][DYN ? 1 : DC][LD8];
  extern __shared__ __align__(128) uint8_t rows_dyn[];
  uint8_t(*k_sm)[TILE][LDK];
  uint8_t(*v_sm)[TILE][LDK];
  uint8_t(*kt_sm)[DC][LD8];
  if constexpr (DYN) {
    k_sm = reinterpret_cast<uint8_t(*)[TILE][LDK]>(rows_dyn);
    v_sm = k_sm + 2;
    kt_sm = reinterpret_cast<uint8_t(*)[DC][LD8]>(v_sm + 2);
  } else {
    k_sm = reinterpret_cast<uint8_t(*)[TILE][LDK]>(k_st);
    v_sm = reinterpret_cast<uint8_t(*)[TILE][LDK]>(v_st);
    kt_sm = reinterpret_cast<uint8_t(*)[DC][LD8]>(kt_st);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;
  const int li = lane >> 3;
  const int bh = blockIdx.x;
  const int npad = (n + TILE - 1) / TILE * TILE;
  const int qb = bh * nqb + blockIdx.y * BR / bq;
  const int row0 = blockIdx.y * BR + warp * 16 + g;  // and row0 + 8
  const int c0 = DC < D_ ? blockIdx.z * DC : 0;  // DQ: this block's columns

  // RIG: the rig's fixed scalars (sl is its sl 1e-4), no Stats
  const float qsc = RIG ? 0.f : q8_scale(st.qmax[qb]);
  const float ksc = RIG ? 0.f : q8_scale(st.kmax[bh]);
  const float c_s = RIG ? sl : __fmul_rn(__fmul_rn(qsc, ksc), sl);
  const float c_dp =
      RIG ? 1e-4f : __fmul_rn(q8_scale(st.domax[qb]), q8_scale(st.vmax[bh]));
  float c_ds = 0.f, c_dq = 0.f;
  if constexpr (DQ && RIG) {
    c_ds = 1.f;
    c_dq = 1e-2f;
  } else if constexpr (DQ) {
    const float dst = fmaxf(st.dsmax[qb], EPS);
    c_ds = __fdiv_rn(127.f, dst);
    c_dq = __fmul_rn(__fmul_rn(dst, ksc), INV127);
  }

  const long long head = static_cast<long long>(bh) * npad * D_;
  const uint8_t* kb = by.k + head;
  const uint8_t* vb = by.v + head;
  const uint8_t* ktb = by.kt + head;  // (D_, N_pad) of this head
  auto stage = [&](int tile, int buf) {
    stage_rows8<D_>(k_sm[buf], kb, D_, tile * TILE);
    stage_rows8<D_>(v_sm[buf], vb, D_, tile * TILE);
    if constexpr (DQ) {
      for (int i = threadIdx.x; i < DC * 4; i += 32 * BW) {
        const int j = i >> 2;
        const int c = (i & 3) * 16;
        cp_async16(&kt_sm[buf][j][c], ktb + static_cast<long long>(c0 + j) * npad + tile * TILE + c, 16);
      }
    }
    cp_async_commit();
  };
  stage(0, 0);

  uint32_t qf[D_ / 32][4], dof[D_ / 32][4];
  load_row_frags8(qf, by.q + head, D_, row0, npad, t);
  load_row_frags8(dof, by.dout + head, D_, row0, npad, t);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long i = static_cast<long long>(bh) * n + row;
    // rows past N: lse +inf gives p = 0, delta 0 gives ds = 0
    lse_r[r] = row < n ? lse[i] : __int_as_float(0x7f800000);
    delta_r[r] = row < n ? delta[i] : 0.f;
  }

  float pmax = 0.f, dsmax = 0.f;
  int acc[DC / 8][4];
#pragma unroll
  for (int dt = 0; dt < DC / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0;

  const int n_tiles = (n_real + TILE - 1) / TILE;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int base = it * TILE;
#pragma unroll
    for (int r0 = 0; r0 < TILE; r0 += 32) {
      int si[4][4], dpi[4][4];
      rows_dot8(si, qf, k_sm[buf], r0, lr, li);   // S = Q8.K8^T
      rows_dot8(dpi, dof, v_sm[buf], r0, lr, li);  // dP = dO8.V8^T
      uint32_t x[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = base + r0 + nt * 8 + 2 * t + (e & 1);
          const float p = prob(si[nt][e], c_s, key < n_real, lse_r[e >> 1]);
          const float dsv = dscore(p, dpi[nt][e], c_dp, delta_r[e >> 1], scale);
          if constexpr (DQ) {
            x[nt][e] = code8<RIG>(__fmul_rn(dsv, c_ds));
          } else {
            pmax = fmaxf(pmax, p);
            dsmax = fmaxf(dsmax, fabsf(dsv));
          }
        }
      if constexpr (DQ) {
        uint32_t a[4];
        pack_a(a, x);
        acc_seq8(acc, a, kt_sm[buf], r0, lr, li);  // dQ += dS8.K8
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  if constexpr (DQ) {
    const int b = bh / heads;
    const int h = bh - b * heads;
    T* base = dq + b * dqs.b + h * dqs.h + c0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n) continue;
      T* p = base + static_cast<long long>(row) * dqs.n + 2 * t;
#pragma unroll
      for (int dt = 0; dt < DC / 8; ++dt)
        store2(p + dt * 8, __fmul_rn(__int2float_rn(acc[dt][2 * r]), c_dq),
               __fmul_rn(__int2float_rn(acc[dt][2 * r + 1]), c_dq));
    }
  } else {
    pmax = warp_max(pmax);
    dsmax = warp_max(dsmax);
    if (lane == 0) {
      atomic_max_pos(st.pmax + qb, pmax);
      atomic_max_pos(st.dsmax + qb, dsmax);
    }
  }
}

// ----------------------------------------------------------- 4. dk/dv ---
template <typename T>
__device__ __forceinline__ void store_rows_f(T* base, long long rs,
                                             const float (&x)[8][4], int row0,
                                             int n, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    T* p = base + static_cast<long long>(row) * rs + 2 * t;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      store2(p + dt * 8, x[dt][2 * r], x[dt][2 * r + 1]);
  }
}

// f += float(i) c, i = 0: one q-block's int32 sums into the fp32 totals
__device__ __forceinline__ void fold(float (&f)[8][4], int (&i)[8][4], float c) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[dt][e] = __fadd_rn(f[dt][e], __fmul_rn(__int2float_rn(i[dt][e]), c));
      i[dt][e] = 0;
    }
}

template <typename T, int D_ = D, bool RIG = false>
__global__ void __launch_bounds__(32 * BW)
bwd_q8_dkdv_kernel(Bytes8 by, const float* __restrict__ lse,
                   const float* __restrict__ delta, Stats st,
                   T* __restrict__ dk, T* __restrict__ dv, int n,
                   int n_real, int heads, int bq, int nqb, Strides dks,
                   Strides dvs, float sl, float scale) {
  constexpr int LDK = ld8(D_);
  constexpr bool DYN = q8b_smem_bytes(2, D_) > 0;
  constexpr bool OWN = D_ > 128;  // K and V fragments from shared memory
  constexpr int S = DYN ? 1 : 2;  // static buffers, or one placeholder
  __shared__ __align__(128) uint8_t q_st[S][DYN ? 1 : TILE][LDK];
  __shared__ __align__(128) uint8_t do_st[S][DYN ? 1 : TILE][LDK];
  // the transposed q and do of this block's 64 d rows
  __shared__ __align__(128) uint8_t qt_st[S][DYN ? 1 : 64][LD8];
  __shared__ __align__(128) uint8_t dot_st[S][DYN ? 1 : 64][LD8];
  __shared__ float lse_sm[2][TILE];
  __shared__ float delta_sm[2][TILE];
  extern __shared__ __align__(128) uint8_t dkdv_dyn[];
  uint8_t(*q_sm)[TILE][LDK];
  uint8_t(*do_sm)[TILE][LDK];
  uint8_t(*qt_sm)[64][LD8];
  uint8_t(*dot_sm)[64][LD8];
  if constexpr (DYN) {
    q_sm = reinterpret_cast<uint8_t(*)[TILE][LDK]>(dkdv_dyn);
    do_sm = q_sm + 2;
    qt_sm = reinterpret_cast<uint8_t(*)[64][LD8]>(do_sm + 2);
    dot_sm = qt_sm + 2;
  } else {
    q_sm = reinterpret_cast<uint8_t(*)[TILE][LDK]>(q_st);
    do_sm = reinterpret_cast<uint8_t(*)[TILE][LDK]>(do_st);
    qt_sm = reinterpret_cast<uint8_t(*)[64][LD8]>(qt_st);
    dot_sm = reinterpret_cast<uint8_t(*)[64][LD8]>(dot_st);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;
  const int li = lane >> 3;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int npad = (n + TILE - 1) / TILE * TILE;
  const int key0 = blockIdx.y * BR + warp * 16 + g;  // and key0 + 8
  // this block's 64 gradient columns (D_ > 64: a slice of the head_dim)
  const int c0 = D_ > 64 ? blockIdx.z * 64 : 0;

  float fk[8][4], fv[8][4];
  int ik[8][4], iv[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fk[dt][e] = fv[dt][e] = 0.f;
      ik[dt][e] = iv[dt][e] = 0;
    }

  if (blockIdx.y * BR < n_real) {  // else dk = dv = 0
    const long long head = static_cast<long long>(bh) * npad * D_;
    const float* lse_bh = lse + static_cast<long long>(bh) * n;
    const float* delta_bh = delta + static_cast<long long>(bh) * n;
    auto stage = [&](int tile, int buf) {
      stage_rows8<D_>(q_sm[buf], by.q + head, D_, tile * TILE);
      stage_rows8<D_>(do_sm[buf], by.dout + head, D_, tile * TILE);
      for (int i = threadIdx.x; i < 64 * 4; i += 32 * BW) {
        const int j = i >> 2;
        const int c = (i & 3) * 16;
        const long long src = head + static_cast<long long>(c0 + j) * npad + tile * TILE + c;
        cp_async16(&qt_sm[buf][j][c], by.qt + src, 16);
        cp_async16(&dot_sm[buf][j][c], by.dot + src, 16);
      }
      for (int i = threadIdx.x; i < TILE; i += 32 * BW) {
        const int row = tile * TILE + i;
        // rows past N: lse +inf gives p = 0, delta 0 gives ds = 0
        lse_sm[buf][i] = row < n ? lse_bh[row] : __int_as_float(0x7f800000);
        delta_sm[buf][i] = row < n ? delta_bh[row] : 0.f;
      }
      cp_async_commit();
    };
    // OWN: the block's keys, after the transposed tiles, with tile 0's
    // copy group
    uint8_t(*own_k)[LDK] = reinterpret_cast<uint8_t(*)[LDK]>(dot_sm + 2);
    uint8_t(*own_v)[LDK] = own_k + BR;
    if constexpr (OWN) {
      stage_rows8<D_>(own_k, by.k + head, D_, blockIdx.y * BR);
      stage_rows8<D_>(own_v, by.v + head, D_, blockIdx.y * BR);
    }
    stage(0, 0);

    // this warp's 16 keys over the full head_dim, A fragments (OWN: read
    // from shared memory in the loop)
    uint32_t kf[OWN ? 1 : D_ / 32][4], vf[OWN ? 1 : D_ / 32][4];
    if constexpr (!OWN) {
      load_row_frags8(kf, by.k + head, D_, key0, npad, t);
      load_row_frags8(vf, by.v + head, D_, key0, npad, t);
    }
    const bool live[2] = {key0 < n_real, key0 + 8 < n_real};
    const float ksc = RIG ? 0.f : q8_scale(st.kmax[bh]);
    const float vsc = RIG ? 0.f : q8_scale(st.vmax[bh]);

    int jq = -1;  // the q-block of the tiles being summed
    float c_s = 0.f, c_p = 0.f, c_dp = 0.f, c_ds = 0.f, c_dv = 0.f, c_dk = 0.f;
    const int n_tiles = npad / TILE;
    for (int it = 0; it < n_tiles; ++it) {
      if (it * TILE / bq != jq) {  // a new q-block: fold, then its scalars
        if (jq >= 0) {
          fold(fk, ik, c_dk);
          fold(fv, iv, c_dv);
        }
        jq = it * TILE / bq;
        const int qb = bh * nqb + jq;
        if constexpr (RIG) {  // the rig's fixed scalars (sl: its sl 1e-4)
          c_s = sl;
          c_p = 127.f;
          c_dp = 1e-4f;
          c_ds = 1.f;
          c_dv = c_dk = 1e-2f;
        } else {
          const float qsc = q8_scale(st.qmax[qb]);
          const float dosc = q8_scale(st.domax[qb]);
          const float pst = fmaxf(st.pmax[qb], EPS);
          const float dst = fmaxf(st.dsmax[qb], EPS);
          c_s = __fmul_rn(__fmul_rn(qsc, ksc), sl);
          c_p = __fdiv_rn(127.f, pst);
          c_dp = __fmul_rn(dosc, vsc);
          c_ds = __fdiv_rn(127.f, dst);
          c_dv = __fmul_rn(__fmul_rn(dosc, pst), INV127);
          c_dk = __fmul_rn(__fmul_rn(dst, qsc), INV127);
        }
      }
      const int buf = it & 1;
      if (it + 1 < n_tiles) {
        stage(it + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int r0 = 0; r0 < TILE; r0 += 32) {
        // S^T = K8.Q8^T: rows are this warp's keys, columns q rows r0..
        int si[4][4];
        if constexpr (OWN)
          rows_dot8_own<D_ / 32>(si, own_k, warp * 16, q_sm[buf], r0, lr, li);
        else
          rows_dot8(si, kf, q_sm[buf], r0, lr, li);
        float p[4][4];
        uint32_t x[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = r0 + nt * 8 + 2 * t + (e & 1);
            p[nt][e] = prob(si[nt][e], c_s, live[e >> 1], lse_sm[buf][col]);
            x[nt][e] = code8<RIG>(__fmul_rn(p[nt][e], c_p));
          }
        uint32_t a[4];
        pack_a(a, x);
        acc_seq8(iv, a, dot_sm[buf], r0, lr, li);  // dV += P8^T.dO8

        int dpi[4][4];
        if constexpr (OWN)  // dP^T = V8.dO8^T
          rows_dot8_own<D_ / 32>(dpi, own_v, warp * 16, do_sm[buf], r0, lr, li);
        else
          rows_dot8(dpi, vf, do_sm[buf], r0, lr, li);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = r0 + nt * 8 + 2 * t + (e & 1);
            x[nt][e] = code8<RIG>(__fmul_rn(
                dscore(p[nt][e], dpi[nt][e], c_dp, delta_sm[buf][col], scale), c_ds));
          }
        pack_a(a, x);
        acc_seq8(ik, a, qt_sm[buf], r0, lr, li);  // dK += dS8^T.Q8
      }
      __syncthreads();  // every warp is done with `buf` before it is refilled
    }
    fold(fk, ik, c_dk);
    fold(fv, iv, c_dv);
  }
  store_rows_f(dk + b * dks.b + h * dks.h + c0, dks.n, fk, key0, n, t);
  store_rows_f(dv + b * dvs.b + h * dvs.h + c0, dvs.n, fv, key0, n, t);
}

// dynamic shared-memory limit of a product kernel, once an instance,
// before any launch a graph captures; the setting holds for the current
// device only: the port drives one card a process
template <auto kernel>
cudaError_t smem_limit(int bytes) {
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

// the five launches of K7 on `stream` for q, k, v, o, dout, dq, dk, dv of
// element type T and head_dim D_; the arguments as maest_attn_bwd_q8's
template <typename T, int D_ = D>
int launch_bwd_q8(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* stats, void* bytes,
                  float* delta, void* dq, void* dk, void* dv, int batch, int n,
                  int heads, int n_real, int bq, const long long* strides,
                  float sl, float scale, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  Strides w[8];
  for (int i = 0; i < 8; ++i)
    w[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int bh = batch * heads;
  const int nqb = (n + bq - 1) / bq;
  const int npad = (n + TILE - 1) / TILE * TILE;
  const long long plane = static_cast<long long>(bh) * npad * D_;
  uint8_t* b8 = static_cast<uint8_t*>(bytes);
  const Bytes8 by{b8, b8 + plane, b8 + 2 * plane, b8 + 3 * plane,
                  b8 + 4 * plane, b8 + 5 * plane, b8 + 6 * plane};
  const long long nb = static_cast<long long>(bh) * nqb;
  const Stats st{stats, stats + nb, stats + 2 * nb, stats + 3 * nb,
                 stats + 4 * nb, stats + 4 * nb + bh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(o),
          *td = static_cast<const T*>(dout);
  int err;
  constexpr int smem_s = q8b_smem_bytes(0, D_), smem_kv = q8b_smem_bytes(2, D_),
                smem_q = q8b_smem_bytes(1, D_), smem_t = quant_smem_bytes(D_);
  if constexpr (D_ > 128) {
    const cudaError_t e = smem_limit<&bwd_q8_quant_kernel<T, D_>>(smem_t);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if constexpr (D_ > 64) {
    cudaError_t e = smem_limit<&bwd_q8_rows_kernel<false, bf16, D_>>(smem_s);
    if (e == cudaSuccess) e = smem_limit<&bwd_q8_dkdv_kernel<T, D_>>(smem_kv);
    if (e == cudaSuccess) e = smem_limit<&bwd_q8_rows_kernel<true, T, D_>>(smem_q);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bwd_q8_amax_kernel<T, D_><<<dim3(bh, nqb), 256, 0, s>>>(
      tq, tk, tv, td, st, n, heads, bq, nqb, w[0], w[1], w[2], w[4]);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const dim3 tiles(bh, npad / TILE);
  bwd_q8_quant_kernel<T, D_><<<tiles, 256, smem_t, s>>>(tq, tk, tv, to, td, st, by,
                                                   delta, n, heads, bq, nqb,
                                                   w[0], w[1], w[2], w[3], w[4]);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  bwd_q8_rows_kernel<false, bf16, D_><<<tiles, 32 * BW, smem_s, s>>>(
      by, lse, delta, st, nullptr, n, n_real, heads, bq, nqb, w[5], sl, scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  bwd_q8_dkdv_kernel<T, D_><<<dim3(bh, npad / TILE, D_ / 64), 32 * BW, smem_kv, s>>>(
      by, lse, delta, st, static_cast<T*>(dk), static_cast<T*>(dv), n, n_real,
      heads, bq, nqb, w[6], w[7], sl, scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  bwd_q8_rows_kernel<true, T, D_><<<dim3(bh, npad / TILE, D_ / dq_cols(D_)), 32 * BW, smem_q, s>>>(
      by, lse, delta, st, static_cast<T*>(dq), n, n_real, heads, bq, nqb, w[5],
      sl, scale);
  return static_cast<int>(cudaGetLastError());
}

// K7 in bf16 at head_dim 64 on wgmma (attn_bwd_q8_wgmma.cuh): this file's
// amax pass, then the header's quant, stats, main and dq launches; the
// arguments as maest_attn_bwd_q8's, delta the header's scratch
int launch_bwd_q8_wgmma(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* stats, void* bytes, float* scratch, void* dq,
                        void* dk, void* dv, int batch, int n, int heads,
                        int n_real, int bq, const long long* strides, float sl,
                        float scale, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  Strides w[8];
  for (int i = 0; i < 8; ++i)
    w[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int bh = batch * heads;
  const int nqb = (n + bq - 1) / bq;
  const long long nb = static_cast<long long>(bh) * nqb;
  const Stats st{stats, stats + nb, stats + 2 * nb, stats + 3 * nb,
                 stats + 4 * nb, stats + 4 * nb + bh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *tq = static_cast<const bf16*>(q), *tk = static_cast<const bf16*>(k),
             *tv = static_cast<const bf16*>(v), *td = static_cast<const bf16*>(dout);
  bwd_q8_amax_kernel<bf16><<<dim3(bh, nqb), 256, 0, s>>>(
      tq, tk, tv, td, st, n, heads, bq, nqb, w[0], w[1], w[2], w[4]);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_bwd_q8w(tq, tk, tv, static_cast<const bf16*>(o), td, lse,
                        stats, static_cast<uint8_t*>(bytes), scratch,
                        static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                        static_cast<bf16*>(dv), batch, n, heads, n_real, bq, w,
                        sl, scale, s);
}

// ---------------------------------------------------------- any width ---
// head_dim above 256 (the _dn entries): the width dp, zero-padded by the
// caller to a multiple of 64, is an argument, so no register or
// shared-memory size grows with it. The five launches keep their roles;
// what changes is how head_dim is walked:
//   1. amax runs over dp columns;
//   2. quant walks the row in 64-column chunks, each through one 64 x 64
//      transposed tile in shared memory (delta summed in the same order);
//   3. and 5. the rows kernel streams 32-key tiles: per tile it stages K's
//      and V's 64-byte chunks in turn and sums S and dP over them in int32
//      (exact, so the order does not matter), then (dq) stages the 64 d
//      rows of K^T of its slice and adds ds8 . k8; dq in 64-column slices
//      over a third grid axis, each recomputing S and dP;
//   4. dk/dv streams 32-row q tiles the same way (S^T, dP^T over chunks of
//      Q and dO, then the slice's q^T and do^T), dk and dv in 64-column
//      slices over a third grid axis; the q-blocks' int32 sums are folded
//      as in the fixed-width kernel.
// So S and dP are computed dp / 64 times for dq, dp / 64 times for dk/dv
// and once in the scale pass. The amax and quant passes copy the
// fixed-width ones with the width a runtime value rather than giving those
// a runtime branch: the fixed instances keep their SASS.
constexpr int DN_T = 32;  // streamed rows (keys or q rows) a tile

template <typename T>
__global__ void __launch_bounds__(256)
bwd_q8_amax_dn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      Stats st, int n, int heads, int bq, int nqb, int dp,
                      Strides qs, Strides ks, Strides vs, Strides ds) {
  __shared__ float red[8][4];
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int j = blockIdx.y;
  const int r0 = j * bq;
  const int r1 = min(n, r0 + bq);
  const int c8 = dp / 8;  // 8-column pieces a row
  float mx[4] = {0.f, 0.f, 0.f, 0.f};  // q, do, k, v
  for (int i = threadIdx.x; i < (r1 - r0) * c8; i += 256) {
    const int rr = i / c8;
    const long long row = r0 + rr;
    const int c = (i - rr * c8) * 8;
    mx[0] = fmaxf(mx[0], amax8(q + b * qs.b + row * qs.n + h * qs.h + c));
    mx[1] = fmaxf(mx[1], amax8(dout + b * ds.b + row * ds.n + h * ds.h + c));
    mx[2] = fmaxf(mx[2], amax8(k + b * ks.b + row * ks.n + h * ks.h + c));
    mx[3] = fmaxf(mx[3], amax8(v + b * vs.b + row * vs.n + h * vs.h + c));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    mx[e] = warp_max(mx[e]);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][e] = mx[e];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float x = 0.f;
    for (int w = 0; w < 8; ++w) x = fmaxf(x, red[w][threadIdx.x]);
    const int qb = bh * nqb + j;
    if (threadIdx.x == 0) st.qmax[qb] = x;
    if (threadIdx.x == 1) st.domax[qb] = x;
    if (threadIdx.x == 2) atomic_max_pos(st.kmax + bh, x);
    if (threadIdx.x == 3) atomic_max_pos(st.vmax + bh, x);
  }
}

// a block quantizes 64 rows of one head, 64 columns at a time; rows >= n
// are written as zeros
template <typename T>
__global__ void __launch_bounds__(256)
bwd_q8_quant_dn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const T* __restrict__ dout, Stats st, Bytes8 by,
                       float* __restrict__ delta, int n, int heads, int bq,
                       int nqb, int dp, Strides qs, Strides ks, Strides vs,
                       Strides os, Strides ds) {
  __shared__ __align__(16) uint8_t tr[3][64][LD8];  // q, do, k transposed
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int t0 = blockIdx.y * TILE;
  const int npad = (n + TILE - 1) / TILE * TILE;
  const int qb = bh * nqb + t0 / bq;  // a 64-row tile lies in one q-block
  const int r = threadIdx.x >> 2;     // row of the tile
  const int s0 = (threadIdx.x & 3) * 16;  // its 16 columns (of each 64)
  const long long row = t0 + r;
  const float inv[4] = {1.f / q8_scale(st.qmax[qb]), 1.f / q8_scale(st.domax[qb]),
                        1.f / q8_scale(st.kmax[bh]), 1.f / q8_scale(st.vmax[bh])};
  float dsum = 0.f;
  for (int hh = 0; hh < dp / 64; ++hh) {  // each 64 columns of the row
    const int c0 = hh * 64 + s0;
    uint32_t w[4][4];  // q8, do8, k8, v8: 16 bytes each
    if (row < n) {
      float x[16], y[16];
      const T* src[4] = {q + b * qs.b + row * qs.n + h * qs.h + c0,
                         dout + b * ds.b + row * ds.n + h * ds.h + c0,
                         k + b * ks.b + row * ks.n + h * ks.h + c0,
                         v + b * vs.b + row * vs.n + h * vs.h + c0};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        load16(src[a], x);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[a][i] = pack4(to_s8(__fmul_rn(x[4 * i], inv[a])),
                          to_s8(__fmul_rn(x[4 * i + 1], inv[a])),
                          to_s8(__fmul_rn(x[4 * i + 2], inv[a])),
                          to_s8(__fmul_rn(x[4 * i + 3], inv[a])));
        if (a == 1) {  // delta = rowsum(do * o), fp32
          load16(o + b * os.b + row * os.n + h * os.h + c0, y);
#pragma unroll
          for (int i = 0; i < 16; ++i) dsum = fmaf(x[i], y[i], dsum);
        }
      }
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) w[a][i] = 0u;
    }
    const long long off = (static_cast<long long>(bh) * npad + row) * dp + c0;
    uint8_t* rows[4] = {by.q, by.dout, by.k, by.v};
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<uint4*>(rows[a] + off) = make_uint4(w[a][0], w[a][1], w[a][2], w[a][3]);
    const int pos = seq_pos(r);
    __syncthreads();  // the last chunk's tiles are written out
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int i = 0; i < 16; ++i) tr[a][s0 + i][pos] = (w[a][i >> 2] >> (8 * (i & 3))) & 0xffu;
    __syncthreads();
    // the transposed tiles: d rows hh * 64 + dr, the 16 sequence columns
    // from s0
    const int dr = threadIdx.x >> 2;
    const long long toff = (static_cast<long long>(bh) * dp + hh * 64 + dr) * npad + t0 + s0;
    uint8_t* cols[3] = {by.qt, by.dot, by.kt};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      *reinterpret_cast<uint4*>(cols[a] + toff) = *reinterpret_cast<const uint4*>(&tr[a][dr][s0]);
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  if (row < n && s0 == 0) delta[static_cast<long long>(bh) * n + row] = dsum;
}

// c += the 16 x 32 int32 product of a warp's A fragments (16 rows x 64
// bytes) with the 32 staged rows of `tile` (exact: int32)
__device__ __forceinline__ void add_rows_dot8(int (&c)[4][4], const uint32_t (&a)[2][4],
                                              const uint8_t (*tile)[LD8], int lr, int li) {
  int x[4][4];
  rows_dot8(x, a, tile, 0, lr, li);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] += x[nt][e];
}

// the scale pass (DQ = false: max p and max |ds| into st.pmax / st.dsmax;
// both entries run the <false, bf16> instance) and dq (DQ = true: this
// block's 64 columns of (ds8 . k8) (dst ks (1/127)), stored as T). A block
// owns 64 q rows of one head and streams 32-key tiles below n_real.
template <bool DQ, typename T>
__global__ void __launch_bounds__(32 * BW)
bwd_q8_rows_dn_kernel(Bytes8 by, const float* __restrict__ lse,
                      const float* __restrict__ delta, Stats st,
                      T* __restrict__ dq, int n, int n_real, int heads, int bq,
                      int nqb, int dp, Strides dqs, float sl, float scale) {
  // a step's tiles: K's and V's chunk (32 rows each), or K^T's 64 d rows of
  // the slice (32 keys of each)
  __shared__ __align__(128) uint8_t tile[2][2][DN_T][LD8];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;
  const int li = lane >> 3;
  const int bh = blockIdx.x;
  const int npad = (n + TILE - 1) / TILE * TILE;
  const int qb = bh * nqb + blockIdx.y * BR / bq;
  const int row0 = blockIdx.y * BR + warp * 16 + g;  // and row0 + 8
  const int c0 = blockIdx.z * 64;  // DQ: this block's columns
  const int nch = dp / 64;
  const int steps = nch + (DQ ? 1 : 0);
  const int total = (n_real + DN_T - 1) / DN_T * steps;

  const float qsc = q8_scale(st.qmax[qb]);
  const float ksc = q8_scale(st.kmax[bh]);
  const float c_s = __fmul_rn(__fmul_rn(qsc, ksc), sl);
  const float c_dp = __fmul_rn(q8_scale(st.domax[qb]), q8_scale(st.vmax[bh]));
  float c_ds = 0.f, c_dq = 0.f;
  if constexpr (DQ) {
    const float dst = fmaxf(st.dsmax[qb], EPS);
    c_ds = __fdiv_rn(127.f, dst);
    c_dq = __fmul_rn(__fmul_rn(dst, ksc), INV127);
  }

  const long long head = static_cast<long long>(bh) * npad * dp;
  const int i = threadIdx.x;
  auto stage = [&](int j, int buf) {
    const int it = j / steps;
    const int c = j - it * steps;
    const int key0 = it * DN_T;
    if (c < nch) {  // 32 keys x 4 pieces of 16 bytes of K and of V
      const long long src = head + static_cast<long long>(key0 + (i >> 2)) * dp +
                            c * 64 + (i & 3) * 16;
      cp_async16(&tile[buf][0][i >> 2][(i & 3) * 16], by.k + src, 16);
      cp_async16(&tile[buf][1][i >> 2][(i & 3) * 16], by.v + src, 16);
    } else {  // K^T: 64 d rows x 2 pieces of 16 keys
      uint8_t(*kt)[LD8] = reinterpret_cast<uint8_t(*)[LD8]>(tile[buf]);
      cp_async16(&kt[i >> 1][(i & 1) * 16],
                 by.kt + head + static_cast<long long>(c0 + (i >> 1)) * npad + key0 +
                     (i & 1) * 16,
                 16);
    }
    cp_async_commit();
  };

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long x = static_cast<long long>(bh) * n + row;
    // rows past N: lse +inf gives p = 0, delta 0 gives ds = 0
    lse_r[r] = row < n ? lse[x] : __int_as_float(0x7f800000);
    delta_r[r] = row < n ? delta[x] : 0.f;
  }
  float pmax = 0.f, dsmax = 0.f;
  int acc[DQ ? 8 : 1][4];
#pragma unroll
  for (int dt = 0; dt < (DQ ? 8 : 1); ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0;
  int si[4][4], dpi[4][4];
  uint32_t a[4];  // DQ: ds8 of the tile, the A fragment of dQ += dS8.K8

  stage(0, 0);
  for (int j = 0; j < total; ++j) {
    const int buf = j & 1;
    if (j + 1 < total) {
      stage(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int it = j / steps;
    const int c = j - it * steps;
    if (c < nch) {
      if (c == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) si[nt][e] = dpi[nt][e] = 0;
      }
      uint32_t qf[2][4], dof[2][4];
      load_row_frags8(qf, by.q + head + c * 64, dp, row0, npad, t);
      load_row_frags8(dof, by.dout + head + c * 64, dp, row0, npad, t);
      add_rows_dot8(si, qf, tile[buf][0], lr, li);   // S = Q8.K8^T
      add_rows_dot8(dpi, dof, tile[buf][1], lr, li);  // dP = dO8.V8^T
      if (c == nch - 1) {
        uint32_t x[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = it * DN_T + nt * 8 + 2 * t + (e & 1);
            const float p = prob(si[nt][e], c_s, key < n_real, lse_r[e >> 1]);
            const float dsv = dscore(p, dpi[nt][e], c_dp, delta_r[e >> 1], scale);
            if constexpr (DQ) {
              x[nt][e] = code8<false>(__fmul_rn(dsv, c_ds));
            } else {
              pmax = fmaxf(pmax, p);
              dsmax = fmaxf(dsmax, fabsf(dsv));
            }
          }
        if constexpr (DQ) pack_a(a, x);
      }
    } else if constexpr (DQ) {
      acc_seq8(acc, a, reinterpret_cast<const uint8_t(*)[LD8]>(tile[buf]), 0,
               lr, li);  // dQ += dS8.K8
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  if constexpr (DQ) {
    const int b = bh / heads;
    const int h = bh - b * heads;
    T* base = dq + b * dqs.b + h * dqs.h + c0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n) continue;
      T* p = base + static_cast<long long>(row) * dqs.n + 2 * t;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        store2(p + dt * 8, __fmul_rn(__int2float_rn(acc[dt][2 * r]), c_dq),
               __fmul_rn(__int2float_rn(acc[dt][2 * r + 1]), c_dq));
    }
  } else {
    pmax = warp_max(pmax);
    dsmax = warp_max(dsmax);
    if (lane == 0) {
      atomic_max_pos(st.pmax + qb, pmax);
      atomic_max_pos(st.dsmax + qb, dsmax);
    }
  }
}

// dk/dv: a block owns 64 keys of one head and this block's 64 columns, and
// streams every 32-row q tile
template <typename T>
__global__ void __launch_bounds__(32 * BW)
bwd_q8_dkdv_dn_kernel(Bytes8 by, const float* __restrict__ lse,
                      const float* __restrict__ delta, Stats st,
                      T* __restrict__ dk, T* __restrict__ dv, int n,
                      int n_real, int heads, int bq, int nqb, int dp,
                      Strides dks, Strides dvs, float sl, float scale) {
  // a step's tiles: Q's and dO's chunk (32 rows each), or the slice's q^T
  // and do^T (64 d rows of 32 q rows each)
  __shared__ __align__(128) uint8_t tile[2][2][64][LD8];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;
  const int li = lane >> 3;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int npad = (n + TILE - 1) / TILE * TILE;
  const int key0 = blockIdx.y * BR + warp * 16 + g;  // and key0 + 8
  const int c0 = blockIdx.z * 64;                    // this block's columns
  const int nch = dp / 64;
  const int steps = nch + 1;

  float fk[8][4], fv[8][4];
  int ik[8][4], iv[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fk[dt][e] = fv[dt][e] = 0.f;
      ik[dt][e] = iv[dt][e] = 0;
    }

  if (blockIdx.y * BR < n_real) {  // else dk = dv = 0
    const long long head = static_cast<long long>(bh) * npad * dp;
    const float* lse_bh = lse + static_cast<long long>(bh) * n;
    const float* delta_bh = delta + static_cast<long long>(bh) * n;
    const int i = threadIdx.x;
    auto stage = [&](int j, int buf) {
      const int it = j / steps;
      const int c = j - it * steps;
      const int r0 = it * DN_T;
      if (c < nch) {  // 32 q rows x 4 pieces of 16 bytes of Q and of dO
        const long long src = head + static_cast<long long>(r0 + (i >> 2)) * dp +
                              c * 64 + (i & 3) * 16;
        cp_async16(&tile[buf][0][i >> 2][(i & 3) * 16], by.q + src, 16);
        cp_async16(&tile[buf][1][i >> 2][(i & 3) * 16], by.dout + src, 16);
      } else {  // q^T and do^T: 64 d rows x 2 pieces of 16 q rows
        const long long src = head + static_cast<long long>(c0 + (i >> 1)) * npad + r0 +
                              (i & 1) * 16;
        cp_async16(&tile[buf][0][i >> 1][(i & 1) * 16], by.qt + src, 16);
        cp_async16(&tile[buf][1][i >> 1][(i & 1) * 16], by.dot + src, 16);
      }
      cp_async_commit();
    };

    const bool live[2] = {key0 < n_real, key0 + 8 < n_real};
    const float ksc = q8_scale(st.kmax[bh]);
    const float vsc = q8_scale(st.vmax[bh]);
    int jq = -1;  // the q-block of the tiles being summed
    float c_s = 0.f, c_p = 0.f, c_dp = 0.f, c_ds = 0.f, c_dv = 0.f, c_dk = 0.f;
    int si[4][4], dpi[4][4];
    uint32_t ap[4], ads[4];  // p8 and ds8 of the tile: A fragments
    const int total = npad / DN_T * steps;
    stage(0, 0);
    for (int j = 0; j < total; ++j) {
      const int buf = j & 1;
      if (j + 1 < total) {
        stage(j + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int it = j / steps;
      const int c = j - it * steps;
      if (c < nch) {
        if (c == 0) {
          if (it * DN_T / bq != jq) {  // a new q-block: fold, then its scalars
            if (jq >= 0) {
              fold(fk, ik, c_dk);
              fold(fv, iv, c_dv);
            }
            jq = it * DN_T / bq;
            const int qb = bh * nqb + jq;
            const float qsc = q8_scale(st.qmax[qb]);
            const float dosc = q8_scale(st.domax[qb]);
            const float pst = fmaxf(st.pmax[qb], EPS);
            const float dst = fmaxf(st.dsmax[qb], EPS);
            c_s = __fmul_rn(__fmul_rn(qsc, ksc), sl);
            c_p = __fdiv_rn(127.f, pst);
            c_dp = __fmul_rn(dosc, vsc);
            c_ds = __fdiv_rn(127.f, dst);
            c_dv = __fmul_rn(__fmul_rn(dosc, pst), INV127);
            c_dk = __fmul_rn(__fmul_rn(dst, qsc), INV127);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) si[nt][e] = dpi[nt][e] = 0;
        }
        // this warp's 16 keys over the chunk: A fragments
        uint32_t kf[2][4], vf[2][4];
        load_row_frags8(kf, by.k + head + c * 64, dp, key0, npad, t);
        load_row_frags8(vf, by.v + head + c * 64, dp, key0, npad, t);
        add_rows_dot8(si, kf, tile[buf][0], lr, li);   // S^T = K8.Q8^T
        add_rows_dot8(dpi, vf, tile[buf][1], lr, li);  // dP^T = V8.dO8^T
        if (c == nch - 1) {
          uint32_t x[4][4], y[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = it * DN_T + nt * 8 + 2 * t + (e & 1);
              // rows past N: lse +inf gives p = 0, delta 0 gives ds = 0
              const float lr_ = row < n ? lse_bh[row] : __int_as_float(0x7f800000);
              const float dl = row < n ? delta_bh[row] : 0.f;
              const float p = prob(si[nt][e], c_s, live[e >> 1], lr_);
              x[nt][e] = code8<false>(__fmul_rn(p, c_p));
              y[nt][e] = code8<false>(
                  __fmul_rn(dscore(p, dpi[nt][e], c_dp, dl, scale), c_ds));
            }
          pack_a(ap, x);
          pack_a(ads, y);
        }
      } else {
        acc_seq8(iv, ap, tile[buf][1], 0, lr, li);  // dV += P8^T.dO8
        acc_seq8(ik, ads, tile[buf][0], 0, lr, li);  // dK += dS8^T.Q8
      }
      __syncthreads();  // every warp is done with `buf` before it is refilled
    }
    fold(fk, ik, c_dk);
    fold(fv, iv, c_dv);
  }
  store_rows_f(dk + b * dks.b + h * dks.h + c0, dks.n, fk, key0, n, t);
  store_rows_f(dv + b * dvs.b + h * dvs.h + c0, dvs.n, fv, key0, n, t);
}

// the five launches of K7 at head_dim dp on `stream`; the arguments as
// maest_attn_bwd_q8_dn's
template <typename T>
int launch_bwd_q8_dn(int dp, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* stats, void* bytes, float* delta, void* dq,
                     void* dk, void* dv, int batch, int n, int heads,
                     int n_real, int bq, const long long* strides, float sl,
                     float scale, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (dp <= 0 || dp % 64) return static_cast<int>(cudaErrorInvalidValue);
  Strides w[8];
  for (int i = 0; i < 8; ++i)
    w[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int bh = batch * heads;
  const int nqb = (n + bq - 1) / bq;
  const int npad = (n + TILE - 1) / TILE * TILE;
  const long long plane = static_cast<long long>(bh) * npad * dp;
  uint8_t* b8 = static_cast<uint8_t*>(bytes);
  const Bytes8 by{b8, b8 + plane, b8 + 2 * plane, b8 + 3 * plane,
                  b8 + 4 * plane, b8 + 5 * plane, b8 + 6 * plane};
  const long long nb = static_cast<long long>(bh) * nqb;
  const Stats st{stats, stats + nb, stats + 2 * nb, stats + 3 * nb,
                 stats + 4 * nb, stats + 4 * nb + bh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(o),
          *td = static_cast<const T*>(dout);
  int err;
  bwd_q8_amax_dn_kernel<T><<<dim3(bh, nqb), 256, 0, s>>>(
      tq, tk, tv, td, st, n, heads, bq, nqb, dp, w[0], w[1], w[2], w[4]);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const dim3 tiles(bh, npad / TILE);
  bwd_q8_quant_dn_kernel<T><<<tiles, 256, 0, s>>>(tq, tk, tv, to, td, st, by,
                                                  delta, n, heads, bq, nqb, dp,
                                                  w[0], w[1], w[2], w[3], w[4]);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  bwd_q8_rows_dn_kernel<false, bf16><<<tiles, 32 * BW, 0, s>>>(
      by, lse, delta, st, nullptr, n, n_real, heads, bq, nqb, dp, w[5], sl,
      scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const dim3 slices(bh, npad / TILE, dp / 64);
  bwd_q8_dkdv_dn_kernel<T><<<slices, 32 * BW, 0, s>>>(
      by, lse, delta, st, static_cast<T*>(dk), static_cast<T*>(dv), n, n_real,
      heads, bq, nqb, dp, w[6], w[7], sl, scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  bwd_q8_rows_dn_kernel<true, T><<<slices, 32 * BW, 0, s>>>(
      by, lse, delta, st, static_cast<T*>(dq), n, n_real, heads, bq, nqb, dp,
      w[5], sl, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- the backward rig, P4 ---
// scripts/bwd_int8_probe.py:52 _bwd_rig_kernel computes, per head, on 8-bit
// q, v, do (bh, N, 64) rows, kt (bh, 64, N) and bf16 o, every row and key
// (no mask) with fixed scalars. Its int8 kind runs K7's dk/dv and dq kernels
// with RIG = true (c_s = its sl 1e-4, dp 1e-4, p8 and ds8 saturated, dq, dk
// and dv 1e-2 of one int32 sum over all N rows: bq = N); its fp8 kind runs
// K3b's kernels on e4m3 (attention_bwd.cu). This pass lays the rig's
// operands out as those kernels read them: K's rows from kt (both kinds),
// q, do and K transposed in the seq_pos order (I8), and delta =
// rowsum(do o) in fp32 from the 8-bit do (int8 or e4m3) and the bf16 o.
// A block takes 64 rows of one head (N a multiple of 64).
__device__ __forceinline__ float e4m3_float(uint8_t b) {
  __nv_fp8_e4m3 x;
  x.__x = b;
  return static_cast<float>(x);
}

template <bool I8>
__global__ void __launch_bounds__(256)
bwd_rig_layout_kernel(const uint8_t* __restrict__ q,
                      const uint8_t* __restrict__ kt,
                      const uint8_t* __restrict__ dout,
                      const bf16* __restrict__ o, uint8_t* __restrict__ krows,
                      uint8_t* __restrict__ qt, uint8_t* __restrict__ dot,
                      uint8_t* __restrict__ kts, float* __restrict__ delta,
                      int n) {
  __shared__ __align__(16) uint8_t tr[3][64][LD8];  // q^T, do^T, K^T (seq_pos)
  __shared__ __align__(16) uint8_t kr[64][LD8];     // K's rows
  const long long bh = blockIdx.x;
  const int t0 = blockIdx.y * 64;
  const int r = threadIdx.x >> 2;         // row of the tile, and d row of kt
  const int s0 = (threadIdx.x & 3) * 16;  // its 16 columns
  const long long row = (bh * n + t0 + r) * 64 + s0;  // in (bh, N, 64)
  const long long col = (bh * 64 + r) * n + t0 + s0;  // in (bh, 64, N)
  uint4 w = *reinterpret_cast<const uint4*>(dout + row);
  const uint8_t* db = reinterpret_cast<const uint8_t*>(&w);
  float y[16];
  load16(o + row, y);
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    dsum = fmaf(I8 ? static_cast<float>(static_cast<int8_t>(db[i]))
                   : e4m3_float(db[i]),
                y[i], dsum);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  if (s0 == 0) delta[bh * n + t0 + r] = dsum;
  const uint4 kw = *reinterpret_cast<const uint4*>(kt + col);
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(&kw);
  const uint4 qw = *reinterpret_cast<const uint4*>(q + row);
  const uint8_t* qb = reinterpret_cast<const uint8_t*>(&qw);
  const int pos = seq_pos(r);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    kr[s0 + i][r] = kb[i];  // key s0 + i, column r
    if constexpr (I8) {
      tr[0][s0 + i][pos] = qb[i];
      tr[1][s0 + i][pos] = db[i];
      tr[2][r][seq_pos(s0 + i)] = kb[i];
    }
  }
  __syncthreads();
  *reinterpret_cast<uint4*>(krows + row) = *reinterpret_cast<const uint4*>(&kr[r][s0]);
  if constexpr (I8) {
    uint8_t* cols[3] = {qt, dot, kts};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      *reinterpret_cast<uint4*>(cols[a] + col) = *reinterpret_cast<const uint4*>(&tr[a][r][s0]);
  }
}

}  // namespace

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o, dout (bf16 reads) and dq, dk, dv (bf16 writes): (batch, n,
// heads, 64) with element strides strides[0..23] = (b, n, h) of q, k, v, o,
// dout, dq, dk, dv in that order, a contiguous last dimension and rows on
// 16-byte boundaries. lse: contiguous fp32 (batch, heads, n) from the
// forward. bq: the q-block of the scales, a multiple of 128. Scratch, from
// the caller: stats, 4 (batch heads nqb) + 2 (batch heads) fp32 zeros
// (nqb = ceil(n / bq)); bytes, maest_attn_bwd_q8_bytes(batch, n, heads)
// bytes; delta, maest_attn_bwd_q8_scratch(batch, n, heads) floats (dq's
// int32 sums, the padded lse and delta). sl = scale * log2(e), scale =
// head_dim^-0.5. 1 <= n_real <= n. The wgmma route (attn_bwd_q8_wgmma.cuh):
// five launches on `stream`; returns the first non-zero cudaGetLastError().
int maest_attn_bwd_q8(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* stats, void* bytes, float* delta, void* dq,
                      void* dk, void* dv, int batch, int n, int heads,
                      int n_real, int bq, const long long* strides, float sl,
                      float scale, void* stream) {
  return launch_bwd_q8_wgmma(q, k, v, o, dout, lse, stats, bytes, delta, dq,
                             dk, dv, batch, n, heads, n_real, bq, strides, sl,
                             scale, stream);
}

// floats of the scratch maest_attn_bwd_q8 takes in delta's place
long long maest_attn_bwd_q8_scratch(int batch, int n, int heads) {
  return qw_scratch_floats(batch, n, heads);
}

// bytes of the int8 copies maest_attn_bwd_q8 takes
long long maest_attn_bwd_q8_bytes(int batch, int n, int heads) {
  return qw_bytes(batch, n, heads);
}

// The control of the wgmma route: the mma.sync kernels (amax, quant, scale
// pass, dk/dv, dq), arguments as maest_attn_bwd_q8's but bytes 7 (batch
// heads round_up(n, 64) 64) bytes and delta fp32 (batch, heads, n).
int maest_attn_bwd_q8_mma(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          float* stats, void* bytes, float* delta, void* dq,
                          void* dk, void* dv, int batch, int n, int heads,
                          int n_real, int bq, const long long* strides,
                          float sl, float scale, void* stream) {
  return launch_bwd_q8<bf16>(q, k, v, o, dout, lse, stats, bytes, delta, dq,
                             dk, dv, batch, n, heads, n_real, bq, strides, sl,
                             scale, stream);
}

// maest_attn_bwd_q8 on fp32 tensors (reads and writes)
int maest_attn_bwd_q8_fp32(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* stats, void* bytes, float* delta, void* dq,
                           void* dk, void* dv, int batch, int n, int heads,
                           int n_real, int bq, const long long* strides,
                           float sl, float scale, void* stream) {
  return launch_bwd_q8<float>(q, k, v, o, dout, lse, stats, bytes, delta, dq,
                              dk, dv, batch, n, heads, n_real, bq, strides, sl,
                              scale, stream);
}

// The same two entries at head_dim 128: (batch, n, heads, 128) views and
// 7 (batch heads round_up(n, 64) 128) bytes of scratch.
int maest_attn_bwd_q8_d128(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* stats, void* bytes, float* delta, void* dq,
                           void* dk, void* dv, int batch, int n, int heads,
                           int n_real, int bq, const long long* strides,
                           float sl, float scale, void* stream) {
  return launch_bwd_q8<bf16, 128>(q, k, v, o, dout, lse, stats, bytes, delta,
                                  dq, dk, dv, batch, n, heads, n_real, bq,
                                  strides, sl, scale, stream);
}

int maest_attn_bwd_q8_fp32_d128(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const float* lse, float* stats, void* bytes,
                                float* delta, void* dq, void* dk, void* dv,
                                int batch, int n, int heads, int n_real,
                                int bq, const long long* strides, float sl,
                                float scale, void* stream) {
  return launch_bwd_q8<float, 128>(q, k, v, o, dout, lse, stats, bytes, delta,
                                   dq, dk, dv, batch, n, heads, n_real, bq,
                                   strides, sl, scale, stream);
}

// The same two entries at head_dim 256: (batch, n, heads, 256) views and
// 7 (batch heads round_up(n, 64) 256) bytes of scratch.
int maest_attn_bwd_q8_d256(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* stats, void* bytes, float* delta, void* dq,
                           void* dk, void* dv, int batch, int n, int heads,
                           int n_real, int bq, const long long* strides,
                           float sl, float scale, void* stream) {
  return launch_bwd_q8<bf16, 256>(q, k, v, o, dout, lse, stats, bytes, delta,
                                  dq, dk, dv, batch, n, heads, n_real, bq,
                                  strides, sl, scale, stream);
}

int maest_attn_bwd_q8_fp32_d256(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const float* lse, float* stats, void* bytes,
                                float* delta, void* dq, void* dk, void* dv,
                                int batch, int n, int heads, int n_real,
                                int bq, const long long* strides, float sl,
                                float scale, void* stream) {
  return launch_bwd_q8<float, 256>(q, k, v, o, dout, lse, stats, bytes, delta,
                                   dq, dk, dv, batch, n, heads, n_real, bq,
                                   strides, sl, scale, stream);
}

// The same two entries at a head_dim dp above 256, a multiple of 64 (a
// head_dim between is zero-padded by the caller), its first argument:
// (batch, n, heads, dp) views and 7 (batch heads round_up(n, 64) dp) bytes
// of scratch. Returns cudaErrorInvalidValue for another dp.
int maest_attn_bwd_q8_dn(int dp, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         float* stats, void* bytes, float* delta, void* dq,
                         void* dk, void* dv, int batch, int n, int heads,
                         int n_real, int bq, const long long* strides,
                         float sl, float scale, void* stream) {
  return launch_bwd_q8_dn<bf16>(dp, q, k, v, o, dout, lse, stats, bytes, delta,
                                dq, dk, dv, batch, n, heads, n_real, bq,
                                strides, sl, scale, stream);
}

int maest_attn_bwd_q8_fp32_dn(int dp, const void* q, const void* k,
                              const void* v, const void* o, const void* dout,
                              const float* lse, float* stats, void* bytes,
                              float* delta, void* dq, void* dk, void* dv,
                              int batch, int n, int heads, int n_real, int bq,
                              const long long* strides, float sl, float scale,
                              void* stream) {
  return launch_bwd_q8_dn<float>(dp, q, k, v, o, dout, lse, stats, bytes,
                                 delta, dq, dk, dv, batch, n, heads, n_real,
                                 bq, strides, sl, scale, stream);
}

// The backward rig's layout pass (i8 = 1: its int8 kind, 0: fp8): q, do
// (bh, n, 64) 8-bit, kt (bh, 64, n) 8-bit, o (bh, n, 64) bf16, n a multiple
// of 64, all contiguous; writes krows (bh, n, 64), and for i8 qt, dot, kts
// (bh, 64, n) in the seq_pos order, and delta (bh, n) fp32. One launch.
int maest_bwd_rig_layout(int i8, const void* q, const void* kt,
                         const void* dout, const void* o, void* krows,
                         void* qt, void* dot, void* kts, float* delta, int bh,
                         int n, void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (n % 64) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = i8 ? bwd_rig_layout_kernel<true> : bwd_rig_layout_kernel<false>;
  kernel<<<dim3(bh, n / 64), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(kt),
      static_cast<const uint8_t*>(dout), static_cast<const bf16*>(o),
      static_cast<uint8_t*>(krows), static_cast<uint8_t*>(qt),
      static_cast<uint8_t*>(dot), static_cast<uint8_t*>(kts), delta, n);
  return static_cast<int>(cudaGetLastError());
}

// The backward rig's int8 kind on the layout pass's copies: K7's dk/dv and
// dq kernels with RIG = true. q, v, dout (bh, n, 64) int8 rows, krows from
// the pass, qt, dot, kts (bh, 64, n) seq_pos; lse and delta (bh, n) fp32;
// writes dq (bh, n, 64) bf16 and dk, dv (bh, n, 64) fp32. sl: the rig's
// SCALE log2(e) 1e-4 in fp32; scale: its SCALE 127 (15.875). Two launches.
int maest_bwd_rig_i8(const void* q, const void* krows, const void* v,
                     const void* dout, const void* qt, const void* dot,
                     const void* kts, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, int bh, int n, float sl,
                     float scale, void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (n % 64) return static_cast<int>(cudaErrorInvalidValue);
  auto b8 = [](const void* p) {
    return const_cast<uint8_t*>(static_cast<const uint8_t*>(p));
  };
  const Bytes8 by{b8(q), b8(krows), b8(v), b8(dout), b8(qt), b8(dot), b8(kts)};
  const Stats st{};  // RIG reads no maxima
  const Strides rows{static_cast<long long>(n) * 64, 64, 0};  // heads = 1
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(bh, n / 64);
  bwd_q8_dkdv_kernel<float, 64, true><<<grid, 32 * BW, 0, s>>>(
      by, lse, delta, st, static_cast<float*>(dk), static_cast<float*>(dv), n,
      n, 1, n, 1, rows, rows, sl, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  bwd_q8_rows_kernel<true, bf16, 64, true><<<grid, 32 * BW, 0, s>>>(
      by, lse, delta, st, static_cast<bf16*>(dq), n, n, 1, n, 1, rows, sl,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
