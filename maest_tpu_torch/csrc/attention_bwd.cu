// Attention backward for Hopper (sm_90a), head_dim 64, 128 and 256 (a
// template parameter D_ of each kernel; the caller zero-pads a smaller
// head_dim), and any multiple of 64 above 256 (the _dn entries).
//
// The bf16 entry at head_dim 64, maest_attn_bwd_bf16, runs the wgmma/TMA
// kernel of attn_bwd_wgmma.cuh (one score pass per key tile and q tile);
// the mma.sync kernels below stay as its control, maest_attn_bwd_bf16_mma.
// The bf16 entry at head_dim 256, maest_attn_bwd_bf16_d256, runs the
// wgmma/TMA kernels of attn_bwd_d256_wgmma.cuh (a dk/dv and a dq kernel,
// each tile's work split between two consumer warpgroups); the mma.sync
// kernels at 256 stay as its control, maest_attn_bwd_bf16_d256_mma. The
// bf16 entry above 256, maest_attn_bwd_bf16_dn, runs the wgmma/TMA kernels
// of attn_bwd_dn_wgmma.cuh (a scores kernel that writes p and ds once,
// then the three gradients as products over them); the mma.sync _dn
// kernels stay as its control, maest_attn_bwd_bf16_dn_mma. The mma.sync
// kernels serve every other instance.
//
// Replaces maest_tpu/ops/attention.py::_attn_bwd_kernel + _bwd_body (the
// combined full-K backward, K3b, called from _flash_bwd) and _bwd_dq_kernel +
// _bwd_dkv_kernel (the split backward for n_pad > 4096, K4, called from
// _flash_bwd_split). It computes what both compute, for any N:
//
//   delta = rowsum(do * o)                       (fp32)
//   p     = exp2(q.k * scale * log2(e) - lse)    keys >= n_real: p = 0
//   dv    = p^T . do          p rounded to the input dtype first
//   dp    = do . v^T
//   ds    = p * (dp - delta) * scale             rounded to the input dtype
//   dq    = ds . k            dk = ds^T . q
//
// with fp32 accumulation; dq, dk and dv are stored in the input dtype. lse
// is the forward's m + log2(l) per query row (attention_fwd.cu, K3a).
// Query rows >= n_real still contribute; only masked keys get exactly zero
// dk and dv.
//
// Why not the TPU design: the TPU kernel accumulates dk/dv across q blocks
// in grid-resident output blocks because its grid runs the q blocks in
// sequence. CUDA blocks run concurrently, so that accumulation would need
// atomics (fp32 atomicAdd: nondeterministic sums). Here the work is split
// as in the TPU's own split backward, three launches:
//   1. delta, eight threads per row;
//   2. dk/dv: a block owns a tile of keys and streams every q tile,
//      rebuilding p from lse; its dk/dv stay in registers until the end;
//   3. dq: a block owns a tile of q rows and streams every key tile.
// Scores are computed twice (once per kernel), as in the TPU's split path;
// the working set is bounded by the tiles, so any N runs, and every sum
// is taken in one fixed order: the result is deterministic.
//
// What bounds it on the H100: arithmetic, as in the forward. Per (batch,
// head) the backward does 2 x 2 N^2 64 flops for the two score recomputes
// and 3 x 2 N^2 64 for dv, dp/dq and dk (5 products of N^2 64) against
// 8 N 64 elements moved, plus the N^2 exp2.
//
// Layout: q, k, v, o, do (reads) and dq, dk, dv (writes) are (B, N, H, D)
// views with any batch/token/head strides and a contiguous last dimension,
// so the q/k/v slices of the fused qkv projection are read in place.
//
// bf16 design: mma.sync m16n8k16 on the tensor cores, with the helpers of
// mma_bf16.cuh. In the dk/dv kernel each warp owns 16 keys and keeps their
// K and V rows as A fragments in registers; the block's q and do tiles are
// double-buffered in shared memory with cp.async. Scores are formed
// transposed, S^T = K.Q^T, so the accumulator rows are keys: p^T and ds^T
// then serve as A operands of p^T.do and ds^T.q without leaving registers.
// The dq kernel is the forward's structure: each warp owns 16 q rows (Q and
// do fragments in registers), K and V tiles are double-buffered, and ds
// (registers) times K (ldmatrix.trans) accumulates dq.
//
// The bf16 kernels take the tile as template parameters: WARPS_ warps own
// 16 rows each (keys in dk/dv, q rows in dq), and TILE_ streamed rows are
// double-buffered (a multiple of SUB). The control (maest_attn_bwd_bf16_mma)
// is 4 warps (64 rows) x 64. The other tiles are the instances of
// scripts/attn_tune.py's backward sweep (:116 time_bwd, which runs
// _flash_bwd at each block_q), entered through maest_attn_bwd_tile; a
// tile changes which block sums a gradient, not the order of its sums
// over the streamed rows' SUB passes. Tiles of 128 rows
// need 73.7 KB of buffers, past the 48 KB of static shared memory: they
// take dynamic shared memory (bwd_smem_bytes).
//
// fp32 design (the parity tier, which must hold 2e-5): at head_dim 64 the
// products run on the tensor cores as 3xTF32 (attn_bwd_tf32.cuh, the route
// of maest_attn_bwd_fp32: a prep pass of tf32 planes, a dk/dv kernel and a
// dq kernel on tf32 wgmma); one tf32 product alone misses 2e-5 by ~20x.
// The other widths and the control at 64 (maest_attn_bwd_fp32_fma) run
// scalar FMA. In the dk/dv kernel a thread owns one key (its k and v rows
// in shared memory rows padded to 65 floats, so 32 threads hit 32 banks;
// dk and dv in registers) and q/do tiles are read as broadcasts; in the
// dq kernel a thread owns one q row the same way and k/v tiles are the
// broadcasts.
//
// head_dim 128 (D_ = 128). A warp's dk and dv sums, with its K and V rows
// held as A fragments, would take ~2 x 64 + 2 x 32 registers a thread in
// the bf16 dk/dv kernel, so it computes the gradients in 64-column slices
// over a third grid axis: each slice's block recomputes s and dp over the
// full head_dim and sums only its 64 columns of dk and dv, which keeps
// d = 64's accumulators (1.5x the products of one unsliced pass: two score
// and two dp products of 128, against one each). The dq kernel keeps its
// 64-register output sums unsliced beside 64 registers of q and do
// fragments. The fp32 dk/dv kernel slices the same way (64 + 64 fp32 sums a
// thread, as at 64); both fp32 kernels own 32 rows a block and stream
// 8-row tiles, so the owned rows (129 floats) and tiles stay within the 48
// KB of static shared memory. The bf16 tiles (rows of 136) take dynamic
// shared memory at 128 (bwd_smem_bytes).
//
// head_dim 256 (D_ = 256). A warp's K and V fragments (dk/dv) or q and do
// fragments (dq) alone would take 128 registers a thread, so each block
// stages its own 64 rows of both in shared memory (OWN: 2 x 64 rows of
// 264, 67.6 KB beside the 135 KB of streamed tiles, one block an SM) and
// the warps read their A fragments through ldmatrix, two k-steps at a time
// for every n-tile of a pass (rows_dot_own: the products and their order
// of summation are rows_dot's). That frees the registers for wider
// slices: the dk/dv kernel sums 128-column slices (two a head, 1.5x the
// products of one unsliced pass where 64-column slices would take 2.5x),
// and the dq kernel keeps its 128 registers of fp32 sums whole. The fp32
// kernels own 16 rows a block and stream 4-row tiles; the fp32 dq kernel
// sums 64-column slices of dq as the dk/dv kernel does (a whole row's
// sums would be 256 registers).
//
// Any head_dim above 256 (the _dn entries): one template a tier,
// attn_bwd_bf16_dn_kernel (since the wgmma kernels of
// attn_bwd_dn_wgmma.cuh took the bf16 route, the control
// maest_attn_bwd_bf16_dn_mma) and attn_bwd_fp32_dn_kernel, whose width dp,
// zero-padded by the caller to a multiple of 64, is a runtime argument, so
// registers and shared memory do not grow with it. For each streamed tile
// s and dp are summed over 64-column chunks staged from global memory for
// that tile; each block then sums one column slice of its gradients (a
// third grid axis), recomputing s and dp over the full dp: dk/dv in
// 64-column slices, dq in 128-column slices in bf16 and 64 in fp32. At dp
// 384 the bf16 backward computes the scores 6 + 3 = 9 times (K3b at 64: 2),
// the fp32 one 12; at 512, 8 + 4 = 12 and 16. The delta pass takes dp too.

#include <type_traits>

#include "attn_bwd_tf32.cuh"   // the fp32 backward at head_dim 64, 3xTF32
#include "attn_bwd_wgmma.cuh"  // the bf16 backward at head_dim 64
#include "attn_bwd_d256_wgmma.cuh"  // the bf16 backward at head_dim 256
#include "attn_bwd_dn_wgmma.cuh"    // the bf16 backward above 256
#include "mma_8bit.cuh"

namespace {

using namespace maest;

// -------------------------------------------------------------- delta ---
// eight 16-byte-aligned elements as fp32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// delta = rowsum(do * o): eight lanes per row, eight elements per lane in
// each 64 columns of the head_dim D_, rows in (b, n, h) order so that
// neighbouring rows of a (b, n) are neighbouring memory and a warp reads
// four whole rows at once
template <typename T, int D_ = D>
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int batch, int n, int heads,
                      Strides os, Strides ds) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  const bool live = r < static_cast<long long>(batch) * n * heads;
  int b = 0, row = 0, h = 0;
  float acc = 0.f;
  if (live) {
    h = static_cast<int>(r % heads);
    const long long bn = r / heads;
    row = static_cast<int>(bn % n);
    b = static_cast<int>(bn / n);
#pragma unroll
    for (int c = 0; c < D_; c += 64) {
      float x[8], y[8];
      load8(o + b * os.b + row * os.n + h * os.h + c + part * 8, x);
      load8(dout + b * ds.b + row * ds.n + h * ds.h + c + part * 8, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(y[i], x[i], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (live && part == 0)
    delta[(static_cast<long long>(b) * heads + h) * n + row] = acc;  // (B, H, N)
}

// ---------------------------------------------------------------- fp32 ---
constexpr int F_ROWS = 64;  // keys (dk/dv) or q rows (dq) per block
constexpr int F_TILE = 16;  // streamed rows per shared-memory tile
constexpr int SLICE = 64;   // gradient columns a dk/dv block sums

// the fp32 tiles at head_dim d: rows a block, streamed rows a tile
__host__ __device__ constexpr int f_rows(int d) { return F_ROWS * D / d; }
__host__ __device__ constexpr int f_tile(int d) { return F_TILE * D / d; }

template <int D_ = D>
__global__ void __launch_bounds__(f_rows(D_))
attn_bwd_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int n, int n_real, int heads,
                         Strides qs, Strides ks, Strides vs, Strides dos,
                         Strides dks, Strides dvs, float sl, float scale) {
  constexpr int ROWS = f_rows(D_), TL = f_tile(D_);
  // owned rows padded by one float, so 32 threads hit 32 banks
  __shared__ float k_own[ROWS][D_ + 1];
  __shared__ float v_own[ROWS][D_ + 1];
  __shared__ float4 q_t[TL][D_ / 4];
  __shared__ float4 do_t[TL][D_ / 4];
  __shared__ float lse_t[TL];
  __shared__ float delta_t[TL];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int key0 = blockIdx.y * ROWS;
  const int key = key0 + threadIdx.x;
  // this block's gradient columns (D_ > 64: a slice of SLICE)
  const int c0 = D_ > SLICE ? blockIdx.z * SLICE : 0;
  float acc_k[SLICE], acc_v[SLICE];
#pragma unroll
  for (int d = 0; d < SLICE; ++d) acc_k[d] = acc_v[d] = 0.f;

  if (key0 < n_real) {  // tiles wholly at or past n_real: dk = dv = 0
    for (int i = threadIdx.x; i < ROWS * D_; i += ROWS) {
      const int j = i / D_;
      const int d = i - j * D_;
      const long long r = min(key0 + j, n - 1);
      k_own[j][d] = k[b * ks.b + r * ks.n + h * ks.h + d];
      v_own[j][d] = v[b * vs.b + r * vs.n + h * vs.h + d];
    }
    const float* lse_bh = lse + static_cast<long long>(bh) * n;
    const float* delta_bh = delta + static_cast<long long>(bh) * n;
    const bool live = key < n_real;
    for (int base = 0; base < n; base += TL) {
      __syncthreads();  // the previous tile is consumed (and own rows staged)
      float* qt = reinterpret_cast<float*>(q_t);
      float* dt = reinterpret_cast<float*>(do_t);
      for (int i = threadIdx.x; i < TL * D_; i += ROWS) {
        const int j = i / D_;
        const int d = i - j * D_;
        const int row = base + j;
        float qv = 0.f, dv_ = 0.f;
        if (row < n) {
          qv = q[b * qs.b + static_cast<long long>(row) * qs.n + h * qs.h + d];
          dv_ = dout[b * dos.b + static_cast<long long>(row) * dos.n + h * dos.h + d];
        }
        qt[i] = qv;
        dt[i] = dv_;
      }
      if (threadIdx.x < TL) {
        const int row = base + threadIdx.x;
        // rows past N: lse +inf gives p = 0, delta 0 gives ds = 0
        lse_t[threadIdx.x] = row < n ? lse_bh[row] : __int_as_float(0x7f800000);
        delta_t[threadIdx.x] = row < n ? delta_bh[row] : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      const int rows = min(TL, n - base);
      for (int j = 0; j < rows; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D_ / 4; ++d4) {
          const float4 qq = q_t[j][d4];
          const float4 gg = do_t[j][d4];
          s = fmaf(k_own[threadIdx.x][4 * d4 + 0], qq.x, s);
          s = fmaf(k_own[threadIdx.x][4 * d4 + 1], qq.y, s);
          s = fmaf(k_own[threadIdx.x][4 * d4 + 2], qq.z, s);
          s = fmaf(k_own[threadIdx.x][4 * d4 + 3], qq.w, s);
          dp = fmaf(v_own[threadIdx.x][4 * d4 + 0], gg.x, dp);
          dp = fmaf(v_own[threadIdx.x][4 * d4 + 1], gg.y, dp);
          dp = fmaf(v_own[threadIdx.x][4 * d4 + 2], gg.z, dp);
          dp = fmaf(v_own[threadIdx.x][4 * d4 + 3], gg.w, dp);
        }
        const float p = exp2f(s * sl - lse_t[j]);
        const float dsv = p * (dp - delta_t[j]) * scale;
#pragma unroll
        for (int d4 = 0; d4 < SLICE / 4; ++d4) {
          const float4 qq = q_t[j][c0 / 4 + d4];
          const float4 gg = do_t[j][c0 / 4 + d4];
          acc_v[4 * d4 + 0] = fmaf(p, gg.x, acc_v[4 * d4 + 0]);
          acc_v[4 * d4 + 1] = fmaf(p, gg.y, acc_v[4 * d4 + 1]);
          acc_v[4 * d4 + 2] = fmaf(p, gg.z, acc_v[4 * d4 + 2]);
          acc_v[4 * d4 + 3] = fmaf(p, gg.w, acc_v[4 * d4 + 3]);
          acc_k[4 * d4 + 0] = fmaf(dsv, qq.x, acc_k[4 * d4 + 0]);
          acc_k[4 * d4 + 1] = fmaf(dsv, qq.y, acc_k[4 * d4 + 1]);
          acc_k[4 * d4 + 2] = fmaf(dsv, qq.z, acc_k[4 * d4 + 2]);
          acc_k[4 * d4 + 3] = fmaf(dsv, qq.w, acc_k[4 * d4 + 3]);
        }
      }
    }
  }
  if (key < n) {
    float* kp = dk + b * dks.b + static_cast<long long>(key) * dks.n + h * dks.h + c0;
    float* vp = dv + b * dvs.b + static_cast<long long>(key) * dvs.n + h * dvs.h + c0;
#pragma unroll
    for (int d = 0; d < SLICE; ++d) {
      kp[d] = acc_k[d];
      vp[d] = acc_v[d];
    }
  }
}

// dq columns a block of the fp32 dq kernel sums: all, or past head_dim 128
// a slice of SLICE (a third grid axis)
__host__ __device__ constexpr int f_dq_cols(int d) {
  return d > 128 ? SLICE : d;
}

template <int D_ = D>
__global__ void __launch_bounds__(f_rows(D_))
attn_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int n, int n_real, int heads, Strides qs, Strides ks,
                        Strides vs, Strides dos, Strides dqs, float sl,
                        float scale) {
  constexpr int ROWS = f_rows(D_), TL = f_tile(D_);
  __shared__ float q_own[ROWS][D_ + 1];
  __shared__ float do_own[ROWS][D_ + 1];
  __shared__ float4 k_t[TL][D_ / 4];
  __shared__ float4 v_t[TL][D_ / 4];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row0 = blockIdx.y * ROWS;
  const int row = row0 + threadIdx.x;
  for (int i = threadIdx.x; i < ROWS * D_; i += ROWS) {
    const int j = i / D_;
    const int d = i - j * D_;
    const long long r = min(row0 + j, n - 1);
    q_own[j][d] = q[b * qs.b + r * qs.n + h * qs.h + d];
    do_own[j][d] = dout[b * dos.b + r * dos.n + h * dos.h + d];
  }
  const long long stat = static_cast<long long>(bh) * n + min(row, n - 1);
  const float lse_r = lse[stat];
  const float delta_r = delta[stat];
  constexpr int QC = f_dq_cols(D_);
  const int c0 = D_ > 128 ? blockIdx.z * SLICE : 0;  // this block's columns
  float acc[QC];
#pragma unroll
  for (int d = 0; d < QC; ++d) acc[d] = 0.f;

  for (int base = 0; base < n_real; base += TL) {
    __syncthreads();
    float* kt = reinterpret_cast<float*>(k_t);
    float* vt = reinterpret_cast<float*>(v_t);
    for (int i = threadIdx.x; i < TL * D_; i += ROWS) {
      const int j = i / D_;
      const int d = i - j * D_;
      const int key = base + j;
      float kv = 0.f, vv = 0.f;
      if (key < n) {
        kv = k[b * ks.b + static_cast<long long>(key) * ks.n + h * ks.h + d];
        vv = v[b * vs.b + static_cast<long long>(key) * vs.n + h * vs.h + d];
      }
      kt[i] = kv;
      vt[i] = vv;
    }
    __syncthreads();
    const int keys = min(TL, n_real - base);
    for (int j = 0; j < keys; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D_ / 4; ++d4) {
        const float4 kk = k_t[j][d4];
        const float4 vv = v_t[j][d4];
        s = fmaf(q_own[threadIdx.x][4 * d4 + 0], kk.x, s);
        s = fmaf(q_own[threadIdx.x][4 * d4 + 1], kk.y, s);
        s = fmaf(q_own[threadIdx.x][4 * d4 + 2], kk.z, s);
        s = fmaf(q_own[threadIdx.x][4 * d4 + 3], kk.w, s);
        dp = fmaf(do_own[threadIdx.x][4 * d4 + 0], vv.x, dp);
        dp = fmaf(do_own[threadIdx.x][4 * d4 + 1], vv.y, dp);
        dp = fmaf(do_own[threadIdx.x][4 * d4 + 2], vv.z, dp);
        dp = fmaf(do_own[threadIdx.x][4 * d4 + 3], vv.w, dp);
      }
      const float p = exp2f(s * sl - lse_r);
      const float dsv = p * (dp - delta_r) * scale;
#pragma unroll
      for (int d4 = 0; d4 < QC / 4; ++d4) {
        const float4 kk = k_t[j][c0 / 4 + d4];
        acc[4 * d4 + 0] = fmaf(dsv, kk.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(dsv, kk.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(dsv, kk.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(dsv, kk.w, acc[4 * d4 + 3]);
      }
    }
  }
  if (row < n) {
    float* op = dq + b * dqs.b + static_cast<long long>(row) * dqs.n + h * dqs.h + c0;
#pragma unroll
    for (int d = 0; d < QC; ++d) op[d] = acc[d];
  }
}

// ---------------------------------------------------------------- bf16 ---
constexpr int WARPS = 4;          // K3b: 4 warps own 64 rows (keys in dk/dv,
                                  // q rows in dq) per block
constexpr int TILE = 64;          // streamed rows per shared-memory tile
constexpr int SUB = 32;           // streamed rows per register pass
// dynamic shared memory of a tile's two double-buffered bf16 tiles, and
// past head_dim 128 the block's own two sets of rows (16 a warp)
__host__ __device__ constexpr int bwd_smem_bytes(int tile, int d = D,
                                                 int warps = WARPS) {
  return (tile > 64 || d > 64
              ? 2 * 2 * tile * ld_bf16(d) * static_cast<int>(sizeof(bf16))
              : 0) +
         (d > 128 ? 2 * 16 * warps * ld_bf16(d) * static_cast<int>(sizeof(bf16))
                  : 0);
}

// gradient columns a dk/dv block sums: 64, or 128 past head_dim 128
__host__ __device__ constexpr int kv_slice(int d) { return d > 128 ? 128 : 64; }

// stage rows [row0, row0 + TILE_) of two (row, D_) bf16 views into a/b via
// cp.async; rows past n are zero-filled
template <int WARPS_, int TILE_, int D_>
__device__ __forceinline__ void stage_pair(bf16 (*a)[ld_bf16(D_)],
                                           bf16 (*bsm)[ld_bf16(D_)],
                                           const bf16* ga, long long as,
                                           const bf16* gb, long long bs,
                                           int row0, int n) {
  for (int i = threadIdx.x; i < TILE_ * (D_ / 8); i += 32 * WARPS_) {
    const int j = i >> ilog2(D_ / 8);
    const int c = (i & (D_ / 8 - 1)) * 8;
    const int row = row0 + j;
    const long long src = static_cast<long long>(min(row, n - 1));
    const int bytes = row < n ? 16 : 0;
    cp_async16(&a[j][c], ga + src * as + c, bytes);
    cp_async16(&bsm[j][c], gb + src * bs + c, bytes);
  }
  cp_async_commit();
}

// 16 x SUB product X.Y^T of a warp's A fragments (16 rows x 16 KS) with SUB
// rows of a staged tile (rows r0.., contraction over d): C layout, n-tile
// nt covers tile rows r0 + 8 nt ..
template <int KS>
__device__ __forceinline__ void rows_dot(float (&c)[SUB / 8][4],
                                         const uint32_t (&a)[KS][4],
                                         const bf16 (*tile)[ld_bf16(16 * KS)],
                                         int r0, int lr, int li) {
#pragma unroll
  for (int nt = 0; nt < SUB / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
    for (int half = 0; half < KS / 2; ++half) {
      uint32_t f[4];
      ldmatrix_x4(f, &tile[r0 + nt * 8 + lr][half * 32 + li * 8]);
      mma_16816(c[nt], a[2 * half], f[0], f[1]);
      mma_16816(c[nt], a[2 * half + 1], f[2], f[3]);
    }
  }
}

// rows_dot with the A fragments read from shared memory: the warp's 16
// rows from w0 of `own`, two k-steps at a time for every n-tile; the same
// products in the same order
template <int KS>
__device__ __forceinline__ void rows_dot_own(float (&c)[SUB / 8][4],
                                             const bf16 (*own)[ld_bf16(16 * KS)],
                                             int w0,
                                             const bf16 (*tile)[ld_bf16(16 * KS)],
                                             int r0, int lr, int li) {
#pragma unroll
  for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
  for (int half = 0; half < KS / 2; ++half) {
    uint32_t a[2][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
      ldmatrix_x4(a[x], &own[w0 + (li & 1) * 8 + lr]
                            [(2 * half + x) * 16 + (li >> 1) * 8]);
#pragma unroll
    for (int nt = 0; nt < SUB / 8; ++nt) {
      uint32_t f[4];
      ldmatrix_x4(f, &tile[r0 + nt * 8 + lr][half * 32 + li * 8]);
      mma_16816(c[nt], a[0], f[0], f[1]);
      mma_16816(c[nt], a[1], f[2], f[3]);
    }
  }
}

// acc (16 x 8 NDT) += P (16 x SUB, bf16 A fragments) . tile rows
// r0..r0+SUB, columns c0.. of rows of LD_
template <int NDT, int LD_>
__device__ __forceinline__ void acc_pv(float (&acc)[NDT][4],
                                       const uint32_t (&p)[SUB / 16][4],
                                       const bf16 (*tile)[LD_], int r0, int lr,
                                       int li, int c0 = 0) {
#pragma unroll
  for (int kj = 0; kj < SUB / 16; ++kj) {
#pragma unroll
    for (int dp = 0; dp < NDT / 2; ++dp) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, &tile[r0 + kj * 16 + (li & 1) * 8 + lr]
                                [c0 + dp * 16 + (li >> 1) * 8]);
      mma_16816(acc[2 * dp], p[kj], f[0], f[1]);
      mma_16816(acc[2 * dp + 1], p[kj], f[2], f[3]);
    }
  }
}

// the C-layout tile x (16 x SUB) as bf16 A fragments of SUB / 16 k-steps
__device__ __forceinline__ void to_a_frags(uint32_t (&f)[SUB / 16][4],
                                           const float (&x)[SUB / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < SUB / 8; ++nt) {
    f[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(x[nt][0], x[nt][1]);
    f[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(x[nt][2], x[nt][3]);
  }
}

template <int NDT>
__device__ __forceinline__ void store_rows(bf16* base, long long rs,
                                           const float (&acc)[NDT][4], int row0,
                                           int n, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    bf16* p = base + static_cast<long long>(row) * rs + 2 * t;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(p + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

template <int NDT>
__device__ __forceinline__ void store_rows(float* base, long long rs,
                                           const float (&acc)[NDT][4], int row0,
                                           int n, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    float* p = base + static_cast<long long>(row) * rs + 2 * t;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      *reinterpret_cast<float2*>(p + dt * 8) =
          make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// E4M3 (the backward rig's fp8 kind, scripts/bwd_int8_probe.py:91-107): q,
// k, v and do arrive as e4m3 bytes (K as its rows), s and dp are e4m3
// products (m16n8k32, fp32 sums: rows_dot_e4m3), the streamed tiles staged
// as bytes and widened to bf16 in shared memory (exact) for the bf16
// products p^T.do, ds^T.q and ds.k; dk and dv are stored in fp32. The
// caller passes n_real = n: no key is masked. Only at head_dim 64.
template <bool E4M3>
using bwd_in_t = std::conditional_t<E4M3, uint8_t, bf16>;

// dynamic shared memory of an E4M3 instance: the double-buffered bf16 tiles
// and, after them, their double-buffered e4m3 bytes
__host__ __device__ constexpr int bwd_e4m3_smem_bytes() {
  return 2 * 2 * TILE * ld_bf16(D) * static_cast<int>(sizeof(bf16)) +
         2 * 2 * TILE * LD8;
}

// rows_dot on e4m3: the warp's A fragments (16 rows x 64 bytes, two
// k-steps of 32) times SUB staged byte rows from r0 (contraction over the
// row's 64 bytes)
__device__ __forceinline__ void rows_dot_e4m3(float (&c)[SUB / 8][4],
                                              const uint32_t (&a)[2][4],
                                              const uint8_t (*tile)[LD8],
                                              int r0, int lr, int li) {
#pragma unroll
  for (int nt = 0; nt < SUB / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
    uint32_t f[4];
    ldmatrix_x4(f, &tile[r0 + nt * 8 + lr][li * 16]);
    mma_e4m3(c[nt], a[0], f[0], f[1]);
    mma_e4m3(c[nt], a[1], f[2], f[3]);
  }
}

// stage rows [row0, row0 + TILE) of two (row, 64) byte views (row strides
// as, bs in bytes); rows past n are zero-filled
__device__ __forceinline__ void stage_pair8(uint8_t (*a)[LD8],
                                            uint8_t (*bsm)[LD8],
                                            const uint8_t* ga, long long as,
                                            const uint8_t* gb, long long bs,
                                            int row0, int n, int threads) {
  for (int i = threadIdx.x; i < TILE * 4; i += threads) {
    const int j = i >> 2;
    const int c = (i & 3) * 16;
    const int row = row0 + j;
    const long long src = static_cast<long long>(min(row, n - 1));
    const int bytes = row < n ? 16 : 0;
    cp_async16(&a[j][c], ga + src * as + c, bytes);
    cp_async16(&bsm[j][c], gb + src * bs + c, bytes);
  }
  cp_async_commit();
}

// widen a staged (TILE, 64) e4m3 byte tile to bf16 (exact)
__device__ __forceinline__ void widen_e4m3(bf16 (*dst)[ld_bf16(D)],
                                           const uint8_t (*src)[LD8],
                                           int threads) {
  for (int i = threadIdx.x; i < TILE * 8; i += threads) {
    const int j = i >> 3;
    const int c = (i & 7) * 8;
    const uint2 w = *reinterpret_cast<const uint2*>(&src[j][c]);
    const uint32_t b[2] = {w.x, w.y};
    uint32_t out[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __half2_raw x = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(b[h >> 1] >> (16 * (h & 1))),
          __NV_E4M3);
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&x));
      out[h] = pack_bf16(f.x, f.y);
    }
    *reinterpret_cast<uint4*>(&dst[j][c]) = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

template <int WARPS_ = WARPS, int TILE_ = TILE, int D_ = D, bool E4M3 = false>
__global__ void __launch_bounds__(32 * WARPS_)
attn_bwd_dkv_bf16_kernel(const bwd_in_t<E4M3>* __restrict__ q,
                         const bwd_in_t<E4M3>* __restrict__ k,
                         const bwd_in_t<E4M3>* __restrict__ v,
                         const bwd_in_t<E4M3>* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         std::conditional_t<E4M3, float, bf16>* __restrict__ dk,
                         std::conditional_t<E4M3, float, bf16>* __restrict__ dv,
                         int n, int n_real, int heads,
                         Strides qs, Strides ks, Strides vs, Strides dos,
                         Strides dks, Strides dvs, float sl, float scale) {
  static_assert(!E4M3 || (D_ == 64 && TILE_ == TILE), "E4M3: K3b's tile");
  constexpr int ROWS = 16 * WARPS_;  // keys per block
  constexpr int LD_ = ld_bf16(D_);
  constexpr bool DYN = E4M3 || bwd_smem_bytes(TILE_, D_, WARPS_) > 0;
  constexpr bool OWN = D_ > 128;  // K and V fragments from shared memory
  constexpr int SL = kv_slice(D_);
  constexpr int ST = DYN ? 1 : TILE_;
  __shared__ __align__(128) bf16 q_st[2][ST][LD_];
  __shared__ __align__(128) bf16 do_st[2][ST][LD_];
  __shared__ float lse_sm[2][TILE_];
  __shared__ float delta_sm[2][TILE_];
  extern __shared__ __align__(128) bf16 tiles_dyn[];
  bf16(*q_sm)[TILE_][LD_];
  bf16(*do_sm)[TILE_][LD_];
  if constexpr (DYN) {
    q_sm = reinterpret_cast<bf16(*)[TILE_][LD_]>(tiles_dyn);
    do_sm = q_sm + 2;
  } else {
    q_sm = q_st;
    do_sm = do_st;
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
  const int key0 = blockIdx.y * ROWS + warp * 16 + g;  // and key0 + 8
  // this block's SL gradient columns (D_ > 64: a slice of the head_dim)
  const int c0 = D_ > 64 ? blockIdx.z * SL : 0;

  float acc_k[SL / 8][4], acc_v[SL / 8][4];
#pragma unroll
  for (int dt = 0; dt < SL / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dt][e] = acc_v[dt][e] = 0.f;

  if (blockIdx.y * ROWS < n_real) {  // else dk = dv = 0
    const auto* qb = q + b * qs.b + h * qs.h;
    const auto* dob = dout + b * dos.b + h * dos.h;
    const float* lse_bh = lse + static_cast<long long>(bh) * n;
    const float* delta_bh = delta + static_cast<long long>(bh) * n;
    // E4M3: the e4m3 bytes of the q and do tiles, after the bf16 ones
    uint8_t(*q8_sm)[TILE_][LD8] = reinterpret_cast<uint8_t(*)[TILE_][LD8]>(do_sm + 2);
    uint8_t(*do8_sm)[TILE_][LD8] = q8_sm + 2;
    auto stage = [&](int tile, int buf) {
      if constexpr (E4M3)
        stage_pair8(q8_sm[buf], do8_sm[buf], qb, qs.n, dob, dos.n,
                    tile * TILE_, n, 32 * WARPS_);
      else
        stage_pair<WARPS_, TILE_, D_>(q_sm[buf], do_sm[buf], qb, qs.n, dob,
                                      dos.n, tile * TILE_, n);
      for (int i = threadIdx.x; i < TILE_; i += 32 * WARPS_) {
        const int row = tile * TILE_ + i;
        // rows past N: lse +inf gives p = 0, delta 0 gives ds = 0
        lse_sm[buf][i] = row < n ? lse_bh[row] : __int_as_float(0x7f800000);
        delta_sm[buf][i] = row < n ? delta_bh[row] : 0.f;
      }
    };
    // OWN: the block's keys, after the q and do buffers
    bf16(*own_k)[LD_] = reinterpret_cast<bf16(*)[LD_]>(do_sm + 2);
    bf16(*own_v)[LD_] = own_k + ROWS;
    if constexpr (OWN)  // a copy group of their own, before tile 0's
      stage_pair<WARPS_, ROWS, D_>(own_k, own_v, k + b * ks.b + h * ks.h,
                                   ks.n, v + b * vs.b + h * vs.h, vs.n,
                                   blockIdx.y * ROWS, n);
    stage(0, 0);

    // this warp's 16 keys over the full head_dim, A fragments (OWN: read
    // from shared memory in the loop)
    uint32_t kf[OWN ? 1 : D_ / 16][4], vf[OWN ? 1 : D_ / 16][4];
    uint32_t kf8[2][4], vf8[2][4];  // E4M3: two k-steps of 32
    if constexpr (E4M3) {
      load_row_frags8(kf8, k + b * ks.b + h * ks.h, ks.n, key0, n, t);
      load_row_frags8(vf8, v + b * vs.b + h * vs.h, vs.n, key0, n, t);
    } else if constexpr (!OWN) {
      load_row_frags(kf, k + b * ks.b + h * ks.h, ks.n, key0, n, t);
      load_row_frags(vf, v + b * vs.b + h * vs.h, vs.n, key0, n, t);
    }
    const bool live0 = key0 < n_real;
    const bool live1 = key0 + 8 < n_real;

    const int n_tiles = (n + TILE_ - 1) / TILE_;
    for (int it = 0; it < n_tiles; ++it) {
      const int buf = it & 1;
      if (it + 1 < n_tiles) {
        stage(it + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if constexpr (E4M3) {  // the bf16 q and do of the bf16 products
        widen_e4m3(q_sm[buf], q8_sm[buf], 32 * WARPS_);
        widen_e4m3(do_sm[buf], do8_sm[buf], 32 * WARPS_);
        __syncthreads();
      }
#pragma unroll
      for (int r0 = 0; r0 < TILE_; r0 += SUB) {
        // S^T = K.Q^T: rows are this warp's keys, columns q rows r0..
        float p[SUB / 8][4];
        if constexpr (E4M3)
          rows_dot_e4m3(p, kf8, q8_sm[buf], r0, lr, li);
        else if constexpr (OWN)
          rows_dot_own<D_ / 16>(p, own_k, warp * 16, q_sm[buf], r0, lr, li);
        else
          rows_dot(p, kf, q_sm[buf], r0, lr, li);
#pragma unroll
        for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = exp2f(p[nt][e] * sl - lse_sm[buf][r0 + nt * 8 + 2 * t + (e & 1)]);
            p[nt][e] = ((e >> 1) ? live1 : live0) ? x : 0.f;
          }
        uint32_t pf[SUB / 16][4];
        to_a_frags(pf, p);
        acc_pv(acc_v, pf, do_sm[buf], r0, lr, li, c0);  // dv += p^T . do

        float ds[SUB / 8][4];
        if constexpr (E4M3)  // dp^T = V.dO^T
          rows_dot_e4m3(ds, vf8, do8_sm[buf], r0, lr, li);
        else if constexpr (OWN)
          rows_dot_own<D_ / 16>(ds, own_v, warp * 16, do_sm[buf], r0, lr, li);
        else
          rows_dot(ds, vf, do_sm[buf], r0, lr, li);
#pragma unroll
        for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[nt][e] = p[nt][e] *
                        (ds[nt][e] - delta_sm[buf][r0 + nt * 8 + 2 * t + (e & 1)]) *
                        scale;
        uint32_t dsf[SUB / 16][4];
        to_a_frags(dsf, ds);
        acc_pv(acc_k, dsf, q_sm[buf], r0, lr, li, c0);  // dk += ds^T . q
      }
      __syncthreads();  // every warp is done with `buf` before it is refilled
    }
  }
  store_rows(dk + b * dks.b + h * dks.h + c0, dks.n, acc_k, key0, n, t);
  store_rows(dv + b * dvs.b + h * dvs.h + c0, dvs.n, acc_v, key0, n, t);
}

template <int WARPS_ = WARPS, int TILE_ = TILE, int D_ = D, bool E4M3 = false>
__global__ void __launch_bounds__(32 * WARPS_)
attn_bwd_dq_bf16_kernel(const bwd_in_t<E4M3>* __restrict__ q,
                        const bwd_in_t<E4M3>* __restrict__ k,
                        const bwd_in_t<E4M3>* __restrict__ v,
                        const bwd_in_t<E4M3>* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int n, int n_real, int heads, Strides qs, Strides ks,
                        Strides vs, Strides dos, Strides dqs, float sl,
                        float scale) {
  constexpr int ROWS = 16 * WARPS_;  // q rows per block
  constexpr int LD_ = ld_bf16(D_);
  static_assert(!E4M3 || (D_ == 64 && TILE_ == TILE), "E4M3: K3b's tile");
  constexpr bool DYN = E4M3 || bwd_smem_bytes(TILE_, D_, WARPS_) > 0;
  constexpr bool OWN = D_ > 128;  // q and do fragments from shared memory
  constexpr int ST = DYN ? 1 : TILE_;
  __shared__ __align__(128) bf16 k_st[2][ST][LD_];
  __shared__ __align__(128) bf16 v_st[2][ST][LD_];
  extern __shared__ __align__(128) bf16 tiles_dyn[];
  bf16(*k_sm)[TILE_][LD_];
  bf16(*v_sm)[TILE_][LD_];
  if constexpr (DYN) {
    k_sm = reinterpret_cast<bf16(*)[TILE_][LD_]>(tiles_dyn);
    v_sm = k_sm + 2;
  } else {
    k_sm = k_st;
    v_sm = v_st;
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
  const int row0 = blockIdx.y * ROWS + warp * 16 + g;  // and row0 + 8

  const auto* kb = k + b * ks.b + h * ks.h;
  const auto* vb = v + b * vs.b + h * vs.h;
  // E4M3: the e4m3 bytes of the K and V tiles, after the bf16 ones
  uint8_t(*k8_sm)[TILE_][LD8] = reinterpret_cast<uint8_t(*)[TILE_][LD8]>(v_sm + 2);
  uint8_t(*v8_sm)[TILE_][LD8] = k8_sm + 2;
  // OWN: the block's q and do rows, after the K and V buffers
  bf16(*own_q)[LD_] = reinterpret_cast<bf16(*)[LD_]>(v_sm + 2);
  bf16(*own_do)[LD_] = own_q + ROWS;
  if constexpr (OWN)  // a copy group of their own, before tile 0's
    stage_pair<WARPS_, ROWS, D_>(own_q, own_do, q + b * qs.b + h * qs.h, qs.n,
                                 dout + b * dos.b + h * dos.h, dos.n,
                                 blockIdx.y * ROWS, n);
  if constexpr (E4M3)
    stage_pair8(k8_sm[0], v8_sm[0], kb, ks.n, vb, vs.n, 0, n, 32 * WARPS_);
  else
    stage_pair<WARPS_, TILE_, D_>(k_sm[0], v_sm[0], kb, ks.n, vb, vs.n, 0, n);

  uint32_t qf[OWN ? 1 : D_ / 16][4], dof[OWN ? 1 : D_ / 16][4];
  uint32_t qf8[2][4], dof8[2][4];  // E4M3: two k-steps of 32
  if constexpr (E4M3) {
    load_row_frags8(qf8, q + b * qs.b + h * qs.h, qs.n, row0, n, t);
    load_row_frags8(dof8, dout + b * dos.b + h * dos.h, dos.n, row0, n, t);
  } else if constexpr (!OWN) {
    load_row_frags(qf, q + b * qs.b + h * qs.h, qs.n, row0, n, t);
    load_row_frags(dof, dout + b * dos.b + h * dos.h, dos.n, row0, n, t);
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = static_cast<long long>(bh) * n + min(row0 + 8 * r, n - 1);
    lse_r[r] = lse[i];
    delta_r[r] = delta[i];
  }

  float acc[D_ / 8][4];
#pragma unroll
  for (int dt = 0; dt < D_ / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int n_tiles = (n_real + TILE_ - 1) / TILE_;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      if constexpr (E4M3)
        stage_pair8(k8_sm[buf ^ 1], v8_sm[buf ^ 1], kb, ks.n, vb, vs.n,
                    (it + 1) * TILE_, n, 32 * WARPS_);
      else
        stage_pair<WARPS_, TILE_, D_>(k_sm[buf ^ 1], v_sm[buf ^ 1], kb, ks.n,
                                      vb, vs.n, (it + 1) * TILE_, n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (E4M3) {  // the bf16 K of ds.k
      widen_e4m3(k_sm[buf], k8_sm[buf], 32 * WARPS_);
      __syncthreads();
    }
    const int base = it * TILE_;
#pragma unroll
    for (int r0 = 0; r0 < TILE_; r0 += SUB) {
      float p[SUB / 8][4];
      if constexpr (E4M3)  // S = Q.K^T
        rows_dot_e4m3(p, qf8, k8_sm[buf], r0, lr, li);
      else if constexpr (OWN)
        rows_dot_own<D_ / 16>(p, own_q, warp * 16, k_sm[buf], r0, lr, li);
      else
        rows_dot(p, qf, k_sm[buf], r0, lr, li);
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = base + r0 + nt * 8 + 2 * t + (e & 1);
          p[nt][e] = key < n_real ? exp2f(p[nt][e] * sl - lse_r[e >> 1]) : 0.f;
        }
      float ds[SUB / 8][4];
      if constexpr (E4M3)  // dP = dO.V^T
        rows_dot_e4m3(ds, dof8, v8_sm[buf], r0, lr, li);
      else if constexpr (OWN)
        rows_dot_own<D_ / 16>(ds, own_do, warp * 16, v_sm[buf], r0, lr, li);
      else
        rows_dot(ds, dof, v_sm[buf], r0, lr, li);
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[nt][e] = p[nt][e] * (ds[nt][e] - delta_r[e >> 1]) * scale;
      uint32_t dsf[SUB / 16][4];
      to_a_frags(dsf, ds);
      acc_pv(acc, dsf, k_sm[buf], r0, lr, li);  // dq += ds . k
    }
    __syncthreads();
  }
  store_rows(dq + b * dqs.b + h * dqs.h, dqs.n, acc, row0, n, t);
}

// ---------------------------------------------------------- any width ---
// head_dim above 256 (see the note at the top): dp, a multiple of CH = 64,
// is an argument. One template a tier: DQ = false is the dk/dv kernel (a
// block owns 64 keys and streams the q and do rows), DQ = true the dq
// kernel (a block owns 64 q rows and streams the key and value rows). A
// block sums one column slice of its gradients (a third grid axis) and
// recomputes s and dp over the full dp for it.
constexpr int DN_DQ_SLICE = 128;  // dq columns a bf16 dq block sums (dk/dv:
                                  // CH = 64 of each, fp32: 64 of each)

// delta = rowsum(dout o) at any width: attn_bwd_delta_kernel with the
// runtime dp as the bound of its column loop. It is a copy, not one
// template with a width argument, so that the fixed instances at 64, 128
// and 256 keep the machine code they had before the runtime width came;
// the two may be merged (loop bound D_ ? D_ : dp) once that is not asked.
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta_dn_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                         float* __restrict__ delta, int batch, int n,
                         int heads, int dp, Strides os, Strides ds) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  const bool live = r < static_cast<long long>(batch) * n * heads;
  int b = 0, row = 0, h = 0;
  float acc = 0.f;
  if (live) {
    h = static_cast<int>(r % heads);
    const long long bn = r / heads;
    row = static_cast<int>(bn % n);
    b = static_cast<int>(bn / n);
    for (int c = 0; c < dp; c += CH) {
      float x[8], y[8];
      load8(o + b * os.b + row * os.n + h * os.h + c + part * 8, x);
      load8(dout + b * ds.b + row * ds.n + h * ds.h + c + part * 8, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(y[i], x[i], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (live && part == 0)
    delta[(static_cast<long long>(b) * heads + h) * n + row] = acc;
}

// bf16: 4 warps, 16 owned rows each. A step stages one 64 x 64 tile of each
// streamed tensor (double-buffered, cp.async; a ring of four with one
// barrier a step measured no faster at dp 384 on the H100): the streamed
// rows' chunk c
// of head_dim for c < dp / 64 (s and dp summed chunk after chunk, the owned
// rows' A fragments of the chunk read from global memory), then the chunks
// of the block's gradient columns, against which p and ds, rounded to bf16
// as K3b rounds them, are multiplied. g0, g1: dk, dv (DQ = false) or dq
// and unused.
template <bool DQ>
__global__ void __launch_bounds__(32 * WARPS)
attn_bwd_bf16_dn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ g0,
                        bf16* __restrict__ g1, int n, int n_real, int heads,
                        int dp, Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides g0s, Strides g1s, float sl, float scale) {
  constexpr int ROWS = 16 * WARPS;  // owned rows a block
  __shared__ __align__(128) bf16 ta[2][TILE][ld_bf16(CH)];  // K, or q
  __shared__ __align__(128) bf16 tb[2][TILE][ld_bf16(CH)];  // V, or do
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;
  const int li = lane >> 3;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int own0 = blockIdx.y * ROWS + warp * 16 + g;  // and own0 + 8
  const int c0 = blockIdx.z * (DQ ? DN_DQ_SLICE : CH);
  const int nch = dp / CH;
  const int nsc = DQ ? min(DN_DQ_SLICE, dp - c0) / CH : 1;  // slice chunks
  const int steps = nch + nsc;
  const int n_tiles = ((DQ ? n_real : n) + TILE - 1) / TILE;
  // owned rows (A operands) and streamed rows (staged tiles)
  const bf16* oa = DQ ? q + b * qs.b + h * qs.h : k + b * ks.b + h * ks.h;
  const bf16* ob = DQ ? dout + b * dos.b + h * dos.h : v + b * vs.b + h * vs.h;
  const long long oas = DQ ? qs.n : ks.n, obs = DQ ? dos.n : vs.n;
  const bf16* sa = DQ ? k + b * ks.b + h * ks.h : q + b * qs.b + h * qs.h;
  const bf16* sb = DQ ? v + b * vs.b + h * vs.h : dout + b * dos.b + h * dos.h;
  const long long sas = DQ ? ks.n : qs.n, sbs = DQ ? vs.n : dos.n;
  const float* lse_bh = lse + static_cast<long long>(bh) * n;
  const float* delta_bh = delta + static_cast<long long>(bh) * n;

  // DQ: dq columns c0.. and c0 + 64..; else dk and dv columns c0..
  float acc0[8][4], acc1[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[dt][e] = acc1[dt][e] = 0.f;

  if (DQ || blockIdx.y * ROWS < n_real) {  // else dk = dv = 0
    // step j: chunk c < nch of streamed tile j / steps, else a slice chunk
    // (DQ: K's alone)
    auto stage = [&](int j, int buf) {
      const int it = j / steps;
      const int c = j - it * steps;
      const int col = c < nch ? c * CH : c0 + (c - nch) * CH;
      const bool both = !DQ || c < nch;
      for (int i = threadIdx.x; i < TILE * (CH / 8); i += 32 * WARPS) {
        const int jj = i >> 3;
        const int cc = col + (i & 7) * 8;
        const int row = it * TILE + jj;
        const long long src = static_cast<long long>(min(row, n - 1));
        const int bytes = row < n ? 16 : 0;
        cp_async16(&ta[buf][jj][cc - col], sa + src * sas + cc, bytes);
        if (both) cp_async16(&tb[buf][jj][cc - col], sb + src * sbs + cc, bytes);
      }
      cp_async_commit();
    };
    float lse_r[2], delta_r[2];  // DQ: of the owned rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = min(own0 + 8 * r, n - 1);
      lse_r[r] = DQ ? lse_bh[i] : 0.f;
      delta_r[r] = DQ ? delta_bh[i] : 0.f;
    }
    const bool live[2] = {own0 < n_real, own0 + 8 < n_real};  // dk/dv keys

    float s[8][4], dpv[8][4];  // S and dP (DQ), or S^T and dP^T
    uint32_t pf[4][4], dsf[4][4];
    const int total = n_tiles * steps;
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
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = dpv[nt][e] = 0.f;
        }
        uint32_t f[4][4];
        load_row_frags(f, oa + c * CH, oas, own0, n, t);
        chunk_dot(s, f, ta[buf], lr, li);
        load_row_frags(f, ob + c * CH, obs, own0, n, t);
        chunk_dot(dpv, f, tb[buf], lr, li);
        if (c == nch - 1) {  // p and ds of this tile, as K3b forms them
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = it * TILE + nt * 8 + 2 * t + (e & 1);
              float p, dl;
              if constexpr (DQ) {
                p = col < n_real ? exp2f(s[nt][e] * sl - lse_r[e >> 1]) : 0.f;
                dl = delta_r[e >> 1];
              } else {
                // rows past N: lse +inf gives p = 0, delta 0 gives ds = 0
                const float x = exp2f(
                    s[nt][e] * sl - (col < n ? lse_bh[col]
                                             : __int_as_float(0x7f800000)));
                p = live[e >> 1] ? x : 0.f;
                dl = col < n ? delta_bh[col] : 0.f;
              }
              s[nt][e] = p;
              dpv[nt][e] = p * (dpv[nt][e] - dl) * scale;
            }
          chunk_frags(pf, s);
          chunk_frags(dsf, dpv);
        }
      } else if constexpr (DQ) {  // dq += ds . K's chunk
        if (c == nch)
          chunk_pv(acc0, dsf, ta[buf], lr, li);
        else
          chunk_pv(acc1, dsf, ta[buf], lr, li);
      } else {  // dv += p^T . do, dk += ds^T . q
        chunk_pv(acc1, pf, tb[buf], lr, li);
        chunk_pv(acc0, dsf, ta[buf], lr, li);
      }
      __syncthreads();  // every warp is done with `buf` before it is refilled
    }
  }
  if constexpr (DQ) {
    bf16* base = g0 + b * g0s.b + h * g0s.h + c0;
    store_rows(base, g0s.n, acc0, own0, n, t);
    if (c0 + CH < dp) store_rows(base + CH, g0s.n, acc1, own0, n, t);
  } else {
    store_rows(g0 + b * g0s.b + h * g0s.h + c0, g0s.n, acc0, own0, n, t);
    store_rows(g1 + b * g1s.b + h * g1s.h + c0, g1s.n, acc1, own0, n, t);
  }
}

constexpr int FDN_TILE = 16;  // streamed rows a tile of the fp32 kernel

// fp32: one thread an owned row, F_ROWS a block, 64 columns of its
// gradients a block. For each tile of 16 streamed rows, s and dp are summed
// over 64-column chunks staged in shared memory (owned rows padded to 65
// floats, streamed rows read as broadcasts), then the tile's chunk at the
// block's columns is staged for the gradient sums.
template <bool DQ>
__global__ void __launch_bounds__(F_ROWS)
attn_bwd_fp32_dn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ g0,
                        float* __restrict__ g1, int n, int n_real, int heads,
                        int dp, Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides g0s, Strides g1s, float sl, float scale) {
  __shared__ float own_a[F_ROWS][CH + 1];  // k, or q
  __shared__ float own_b[F_ROWS][CH + 1];  // v, or do
  __shared__ float4 ta[FDN_TILE][CH / 4];  // q, or k
  __shared__ float4 tb[FDN_TILE][CH / 4];  // do, or v
  __shared__ float lse_t[FDN_TILE];
  __shared__ float delta_t[FDN_TILE];
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int own0 = blockIdx.y * F_ROWS;
  const int me = own0 + threadIdx.x;
  const int c0 = blockIdx.z * CH;
  const float* oa = DQ ? q + b * qs.b + h * qs.h : k + b * ks.b + h * ks.h;
  const float* ob = DQ ? dout + b * dos.b + h * dos.h : v + b * vs.b + h * vs.h;
  const long long oas = DQ ? qs.n : ks.n, obs = DQ ? dos.n : vs.n;
  const float* sa = DQ ? k + b * ks.b + h * ks.h : q + b * qs.b + h * qs.h;
  const float* sb = DQ ? v + b * vs.b + h * vs.h : dout + b * dos.b + h * dos.h;
  const long long sas = DQ ? ks.n : qs.n, sbs = DQ ? vs.n : dos.n;
  const float* lse_bh = lse + static_cast<long long>(bh) * n;
  const float* delta_bh = delta + static_cast<long long>(bh) * n;
  const float lse_r = DQ ? lse_bh[min(me, n - 1)] : 0.f;
  const float delta_r = DQ ? delta_bh[min(me, n - 1)] : 0.f;
  const int n_end = DQ ? n_real : n;  // streamed rows

  // stage the streamed rows [base, base + 16) at columns c (b too: both)
  auto stage_tile = [&](int base, int c, bool both) {
    float* xa = reinterpret_cast<float*>(ta);
    float* xb = reinterpret_cast<float*>(tb);
    for (int i = threadIdx.x; i < FDN_TILE * CH; i += F_ROWS) {
      const int j = i / CH;
      const int d = i - j * CH;
      const long long row = base + j;
      xa[i] = row < n ? sa[row * sas + c + d] : 0.f;
      if (both) xb[i] = row < n ? sb[row * sbs + c + d] : 0.f;
    }
  };
  float acc0[CH], acc1[DQ ? 1 : CH];  // dq, or dk and dv
#pragma unroll
  for (int d = 0; d < CH; ++d) acc0[d] = 0.f;
#pragma unroll
  for (int d = 0; d < (DQ ? 1 : CH); ++d) acc1[d] = 0.f;

  if (DQ || own0 < n_real) {  // else dk = dv = 0
    const bool live = DQ || me < n_real;
    for (int base = 0; base < n_end; base += FDN_TILE) {
      float s[FDN_TILE], dpv[FDN_TILE];
#pragma unroll
      for (int j = 0; j < FDN_TILE; ++j) s[j] = dpv[j] = 0.f;
      for (int c = 0; c < dp; c += CH) {
        __syncthreads();  // the previous tiles are consumed
        for (int i = threadIdx.x; i < F_ROWS * CH; i += F_ROWS) {
          const int j = i / CH;
          const int d = i - j * CH;
          const long long r = min(own0 + j, n - 1);
          own_a[j][d] = oa[r * oas + c + d];
          own_b[j][d] = ob[r * obs + c + d];
        }
        stage_tile(base, c, true);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < FDN_TILE; ++j)
#pragma unroll
          for (int d4 = 0; d4 < CH / 4; ++d4) {
            const float4 xa = ta[j][d4];
            const float4 xb = tb[j][d4];
            s[j] = fmaf(own_a[threadIdx.x][4 * d4 + 0], xa.x, s[j]);
            s[j] = fmaf(own_a[threadIdx.x][4 * d4 + 1], xa.y, s[j]);
            s[j] = fmaf(own_a[threadIdx.x][4 * d4 + 2], xa.z, s[j]);
            s[j] = fmaf(own_a[threadIdx.x][4 * d4 + 3], xa.w, s[j]);
            dpv[j] = fmaf(own_b[threadIdx.x][4 * d4 + 0], xb.x, dpv[j]);
            dpv[j] = fmaf(own_b[threadIdx.x][4 * d4 + 1], xb.y, dpv[j]);
            dpv[j] = fmaf(own_b[threadIdx.x][4 * d4 + 2], xb.z, dpv[j]);
            dpv[j] = fmaf(own_b[threadIdx.x][4 * d4 + 3], xb.w, dpv[j]);
          }
      }
      __syncthreads();
      stage_tile(base, c0, !DQ);  // this block's columns of q, do (or k)
      if (!DQ && threadIdx.x < FDN_TILE) {
        const int row = base + threadIdx.x;
        // rows past N: lse +inf gives p = 0, delta 0 gives ds = 0
        lse_t[threadIdx.x] = row < n ? lse_bh[row] : __int_as_float(0x7f800000);
        delta_t[threadIdx.x] = row < n ? delta_bh[row] : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      const int rows = min(FDN_TILE, n_end - base);
#pragma unroll
      for (int j = 0; j < FDN_TILE; ++j) {
        if (j >= rows) break;
        const float p = exp2f(s[j] * sl - (DQ ? lse_r : lse_t[j]));
        const float dsv = p * (dpv[j] - (DQ ? delta_r : delta_t[j])) * scale;
        const float* xa = reinterpret_cast<const float*>(ta[j]);
        const float* xb = reinterpret_cast<const float*>(tb[j]);
#pragma unroll
        for (int d = 0; d < CH; ++d) {
          acc0[d] = fmaf(dsv, xa[d], acc0[d]);
          if constexpr (!DQ) acc1[d] = fmaf(p, xb[d], acc1[d]);
        }
      }
    }
  }
  if (me < n) {
    float* p0 = g0 + b * g0s.b + static_cast<long long>(me) * g0s.n + h * g0s.h + c0;
#pragma unroll
    for (int d = 0; d < CH; ++d) p0[d] = acc0[d];
    if constexpr (!DQ) {
      float* p1 = g1 + b * g1s.b + static_cast<long long>(me) * g1s.n + h * g1s.h + c0;
#pragma unroll
      for (int d = 0; d < CH; ++d) p1[d] = acc1[d];
    }
  }
}

// ---------------------------------------------------------------- entry ---
struct Views {
  Strides q, k, v, o, dout, dq, dk, dv;
};

Views views(const long long* st) {
  Views w;
  Strides* s[8] = {&w.q, &w.k, &w.v, &w.o, &w.dout, &w.dq, &w.dk, &w.dv};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  return w;
}

template <typename T, int D_ = D>
int launch_delta(const void* o, const void* dout, float* delta, int batch,
                 int n, int heads, const Views& w, cudaStream_t s) {
  const long long threads = 8LL * batch * heads * n;  // eight per row
  attn_bwd_delta_kernel<T, D_><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, batch, n,
      heads, w.o, w.dout);
  return static_cast<int>(cudaGetLastError());
}

// the three launches of the bf16 backward at the tile (16 WARPS_ rows,
// TILE_ streamed rows) and head_dim D_: delta, dk/dv (D_ / kv_slice(D_)
// column slices), dq
template <int WARPS_, int TILE_, int D_ = D>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* lse, float* delta, void* dq,
                    void* dk, void* dv, int batch, int n, int heads,
                    int n_real, const long long* strides, float sl,
                    float scale, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Views w = views(strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_delta<bf16, D_>(o, dout, delta, batch, n, heads, w, s);
  if (err) return err;
  constexpr int smem = bwd_smem_bytes(TILE_, D_, WARPS_);
  // once an instance, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  if (smem > 0) {
    static const cudaError_t attr = [] {
      const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
      const cudaError_t e = cudaFuncSetAttribute(
          attn_bwd_dkv_bf16_kernel<WARPS_, TILE_, D_>, a, smem);
      return e != cudaSuccess
                 ? e
                 : cudaFuncSetAttribute(
                       attn_bwd_dq_bf16_kernel<WARPS_, TILE_, D_>, a, smem);
    }();
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const dim3 grid(batch * heads, (n + 16 * WARPS_ - 1) / (16 * WARPS_));
  const dim3 grid_kv(grid.x, grid.y, D_ / kv_slice(D_));
  attn_bwd_dkv_bf16_kernel<WARPS_, TILE_, D_><<<grid_kv, 32 * WARPS_, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, n_real, heads, w.q,
      w.k, w.v, w.dout, w.dk, w.dv, sl, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  attn_bwd_dq_bf16_kernel<WARPS_, TILE_, D_><<<grid, 32 * WARPS_, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), n, n_real, heads, w.q, w.k, w.v, w.dout, w.dq,
      sl, scale);
  return static_cast<int>(cudaGetLastError());
}

// the three launches of the fp32 backward at head_dim D_: delta, dk/dv
// (D_ / 64 column slices), dq (past head_dim 128, D_ / 64 column slices)
template <int D_ = D>
int launch_bwd_fp32(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* lse, float* delta, void* dq,
                    void* dk, void* dv, int batch, int n, int heads,
                    int n_real, const long long* strides, float sl,
                    float scale, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Views w = views(strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_delta<float, D_>(o, dout, delta, batch, n, heads, w, s);
  if (err) return err;
  constexpr int rows = f_rows(D_);
  const dim3 grid(batch * heads, (n + rows - 1) / rows);
  attn_bwd_dkv_fp32_kernel<D_><<<dim3(grid.x, grid.y, D_ / SLICE), rows, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), n, n_real, heads, w.q,
      w.k, w.v, w.dout, w.dk, w.dv, sl, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  attn_bwd_dq_fp32_kernel<D_><<<dim3(grid.x, grid.y, D_ / f_dq_cols(D_)), rows, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), n, n_real, heads, w.q, w.k, w.v, w.dout, w.dq,
      sl, scale);
  return static_cast<int>(cudaGetLastError());
}

// the three launches of the backward at a head_dim dp above 256 (a multiple
// of CH): delta, dk/dv (dp / 64 column slices), dq (bf16: ceil(dp / 128)
// slices, fp32: dp / 64)
template <typename T>
int launch_bwd_dn(int dp, const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const float* lse,
                  float* delta, void* dq, void* dk, void* dv, int batch, int n,
                  int heads, int n_real, const long long* strides, float sl,
                  float scale, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (dp <= 0 || dp % CH) return static_cast<int>(cudaErrorInvalidValue);
  const Views w = views(strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long threads = 8LL * batch * heads * n;  // eight per row
  attn_bwd_delta_dn_kernel<T><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, batch, n,
      heads, dp, w.o, w.dout);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  constexpr bool BF = std::is_same<T, bf16>::value;
  constexpr int rows = BF ? 16 * WARPS : F_ROWS;
  const dim3 grid(batch * heads, (n + rows - 1) / rows, dp / CH);
  const dim3 grid_q(grid.x, grid.y,
                    BF ? (dp + DN_DQ_SLICE - 1) / DN_DQ_SLICE : dp / CH);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *td = static_cast<const T*>(dout);
  T *tdq = static_cast<T*>(dq), *tdk = static_cast<T*>(dk),
    *tdv = static_cast<T*>(dv);
  if constexpr (BF) {
    attn_bwd_bf16_dn_kernel<false><<<grid, 32 * WARPS, 0, s>>>(
        tq, tk, tv, td, lse, delta, tdk, tdv, n, n_real, heads, dp, w.q, w.k,
        w.v, w.dout, w.dk, w.dv, sl, scale);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    attn_bwd_bf16_dn_kernel<true><<<grid_q, 32 * WARPS, 0, s>>>(
        tq, tk, tv, td, lse, delta, tdq, nullptr, n, n_real, heads, dp, w.q,
        w.k, w.v, w.dout, w.dq, w.dq, sl, scale);
  } else {
    attn_bwd_fp32_dn_kernel<false><<<grid, rows, 0, s>>>(
        tq, tk, tv, td, lse, delta, tdk, tdv, n, n_real, heads, dp, w.q, w.k,
        w.v, w.dout, w.dk, w.dv, sl, scale);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    attn_bwd_fp32_dn_kernel<true><<<grid_q, rows, 0, s>>>(
        tq, tk, tv, td, lse, delta, tdq, nullptr, n, n_real, heads, dp, w.q,
        w.k, w.v, w.dout, w.dq, w.dq, sl, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o, dout (reads) and dq, dk, dv (writes): (batch, n, heads, 64)
// with element strides strides[0..23] = (b, n, h) of q, k, v, o, dout, dq,
// dk, dv in that order, and a contiguous last dimension. lse: contiguous
// fp32 (batch, heads, n) from the forward; delta: fp32 scratch of the same
// shape. sl = scale * log2(e), scale = head_dim^-0.5. 1 <= n_real <= n.
// Every o and dout row (both entries) and every q/k/v row (bf16 entries)
// must start on a 16-byte boundary. Three launches on `stream` (delta, dk/dv, dq); returns the
// first non-zero cudaGetLastError().
//
// An entry X that takes other scratch in delta's place exports
// X_scratch(batch, n, heads), its floats; the port sizes the scratch by it.
//
// The fp32 entry at head_dim 64 runs the 3xTF32 wgmma kernels
// (attn_bwd_tf32.cuh): four split launches and the stats pass, then the
// dk/dv and the dq kernel, each summing every tile's products freshly and
// adding them to its gradients in registers (on the H100 one running sum
// landed several times farther from plain at (32, 866), in about the same
// time; PERF.md). Its `delta` is fp32 scratch of
// maest_attn_bwd_fp32_scratch(batch, n, heads) floats (the tf32 planes,
// lse and delta of the padded rows).
int maest_attn_bwd_fp32(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int batch,
                        int n, int heads, int n_real, const long long* strides,
                        float sl, float scale, void* stream) {
  return launch_bwd_tf32(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, n,
                         heads, n_real, strides, sl, scale, stream);
}

long long maest_attn_bwd_fp32_scratch(int batch, int n, int heads) {
  return tb_scratch_floats(batch, n, heads);
}

// The scalar FMA kernels that maest_attn_bwd_fp32 ran before the tf32 ones
// (delta, dk/dv, dq), kept as their control; `delta` fp32 (batch, heads, n).
int maest_attn_bwd_fp32_fma(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* lse,
                            float* delta, void* dq, void* dk, void* dv,
                            int batch, int n, int heads, int n_real,
                            const long long* strides, float sl, float scale,
                            void* stream) {
  return launch_bwd_fp32(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, n,
                         heads, n_real, strides, sl, scale, stream);
}

// The bf16 entry at head_dim 64 runs the wgmma kernel (attn_bwd_wgmma.cuh)
// with q tiles of 64 rows, two consumer warpgroups of 64 keys, no turns
// (turns moved it by 1 % either way in the sweep at N 866 and 281,
// 128-row q tiles lost 8-23 %). Its `delta` is fp32 scratch
// of maest_attn_bwd_bf16_scratch(batch, n, heads) floats (dq's sums, lse
// and delta of the padded rows, the hand-over counters); two launches
// (the prep pass, the kernel).
int maest_attn_bwd_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int batch,
                        int n, int heads, int n_real, const long long* strides,
                        float sl, float scale, void* stream) {
  return launch_bwd_wgmma<64, 2, false>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, batch, n, heads, n_real, strides,
                                        sl, scale, stream);
}

long long maest_attn_bwd_bf16_scratch(int batch, int n, int heads) {
  return bw_scratch_floats(batch, n, heads);
}

// The mma.sync kernels that maest_attn_bwd_bf16 ran before the wgmma one
// (delta, dk/dv, dq), kept as its control; arguments as the fp32 entry's.
int maest_attn_bwd_bf16_mma(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* lse,
                            float* delta, void* dq, void* dk, void* dv,
                            int batch, int n, int heads, int n_real,
                            const long long* strides, float sl, float scale,
                            void* stream) {
  return launch_bwd_bf16<WARPS, TILE>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                      batch, n, heads, n_real, strides, sl,
                                      scale, stream);
}

// The wgmma kernel's configurations of the tile sweep, chosen by `config`
// (chip_smoke.py WG_BWD_CONFIGS): q rows a tile x consumer warpgroups,
// with or without turns: 0 (64, 2, off), the production route; 1 (64, 2,
// on); 2 (128, 2, off); 3 (128, 2, on). Otherwise the arguments of
// maest_attn_bwd_bf16; another config returns cudaErrorInvalidValue.
int maest_attn_bwd_bf16_wgmma(int config, const void* q, const void* k,
                              const void* v, const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, int batch, int n, int heads,
                              int n_real, const long long* strides, float sl,
                              float scale, void* stream) {
#define MAEST_BW(BQ, NC, PP)                                                   \
  launch_bwd_wgmma<BQ, NC, PP>(q, k, v, o, dout, lse, delta, dq, dk, dv,       \
                               batch, n, heads, n_real, strides, sl, scale,    \
                               stream)
  switch (config) {
    case 0: return MAEST_BW(64, 2, false);
    case 1: return MAEST_BW(64, 2, true);
    case 2: return MAEST_BW(128, 2, false);
    case 3: return MAEST_BW(128, 2, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MAEST_BW
}

// Its scratch, as maest_attn_bwd_bf16's.
long long maest_attn_bwd_bf16_wgmma_scratch(int batch, int n, int heads) {
  return bw_scratch_floats(batch, n, heads);
}

// The same two entries at head_dim 128: (batch, n, heads, 128) views, scale
// = 128^-0.5 or, on inputs zero-padded from a head_dim d, d^-0.5.
int maest_attn_bwd_fp32_d128(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             float* delta, void* dq, void* dk, void* dv,
                             int batch, int n, int heads, int n_real,
                             const long long* strides, float sl, float scale,
                             void* stream) {
  return launch_bwd_fp32<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                              n, heads, n_real, strides, sl, scale, stream);
}

int maest_attn_bwd_bf16_d128(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             float* delta, void* dq, void* dk, void* dv,
                             int batch, int n, int heads, int n_real,
                             const long long* strides, float sl, float scale,
                             void* stream) {
  return launch_bwd_bf16<WARPS, TILE, 128>(q, k, v, o, dout, lse, delta, dq,
                                           dk, dv, batch, n, heads, n_real,
                                           strides, sl, scale, stream);
}

// The same two entries at head_dim 256: (batch, n, heads, 256) views, scale
// = 256^-0.5 or, on inputs zero-padded from a head_dim d, d^-0.5.
int maest_attn_bwd_fp32_d256(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             float* delta, void* dq, void* dk, void* dv,
                             int batch, int n, int heads, int n_real,
                             const long long* strides, float sl, float scale,
                             void* stream) {
  return launch_bwd_fp32<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                              n, heads, n_real, strides, sl, scale, stream);
}

// The bf16 entry at head_dim 256 runs the wgmma kernels
// (attn_bwd_d256_wgmma.cuh): the prep pass, the dk/dv kernel, the dq
// kernel. Its `delta` is fp32 scratch of
// maest_attn_bwd_bf16_d256_scratch(batch, n, heads) floats (lse and delta
// of the padded rows), and each view's base address and strides must be
// multiples of 16 bytes (TMA).
int maest_attn_bwd_bf16_d256(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             float* delta, void* dq, void* dk, void* dv,
                             int batch, int n, int heads, int n_real,
                             const long long* strides, float sl, float scale,
                             void* stream) {
  return launch_bwd_d256_wgmma(q, k, v, o, dout, lse, delta, dq, dk, dv,
                               batch, n, heads, n_real, strides, sl, scale,
                               stream);
}

long long maest_attn_bwd_bf16_d256_scratch(int batch, int n, int heads) {
  return b2_scratch_floats(batch, n, heads);
}

// The mma.sync kernels that maest_attn_bwd_bf16_d256 ran before the wgmma
// ones (delta, dk/dv in 128-column slices, dq), kept as its control;
// arguments as the fp32 entry's.
int maest_attn_bwd_bf16_d256_mma(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const float* lse, float* delta, void* dq,
                                 void* dk, void* dv, int batch, int n,
                                 int heads, int n_real,
                                 const long long* strides, float sl,
                                 float scale, void* stream) {
  return launch_bwd_bf16<WARPS, TILE, 256>(q, k, v, o, dout, lse, delta, dq,
                                           dk, dv, batch, n, heads, n_real,
                                           strides, sl, scale, stream);
}

// The same two entries at a head_dim dp above 256, a multiple of 64 (a
// head_dim between is zero-padded by the caller): (batch, n, heads, dp)
// views, scale = dp^-0.5 or the unpadded head_dim's. Returns
// cudaErrorInvalidValue for another dp.
int maest_attn_bwd_fp32_dn(int dp, const void* q, const void* k,
                           const void* v, const void* o, const void* dout,
                           const float* lse, float* delta, void* dq, void* dk,
                           void* dv, int batch, int n, int heads, int n_real,
                           const long long* strides, float sl, float scale,
                           void* stream) {
  return launch_bwd_dn<float>(dp, q, k, v, o, dout, lse, delta, dq, dk, dv,
                              batch, n, heads, n_real, strides, sl, scale,
                              stream);
}

// The bf16 entry above 256 runs the wgmma kernels (attn_bwd_dn_wgmma.cuh):
// the prep pass, the scores kernel, the dv/dk and the dq products. Its
// `delta` is fp32 scratch of maest_attn_bwd_bf16_dn_scratch(batch, n,
// heads) floats (lse and delta of the padded rows, the p^T and ds^T
// planes), and each view's base address and strides must be multiples of
// 16 bytes (TMA).
int maest_attn_bwd_bf16_dn(int dp, const void* q, const void* k,
                           const void* v, const void* o, const void* dout,
                           const float* lse, float* delta, void* dq, void* dk,
                           void* dv, int batch, int n, int heads, int n_real,
                           const long long* strides, float sl, float scale,
                           void* stream) {
  return launch_bwd_dn_wgmma(dp, q, k, v, o, dout, lse, delta, dq, dk, dv,
                             batch, n, heads, n_real, strides, sl, scale,
                             stream);
}

long long maest_attn_bwd_bf16_dn_scratch(int batch, int n, int heads) {
  return bd_scratch_floats(batch, n, heads);
}

// The mma.sync kernels that maest_attn_bwd_bf16_dn ran before the wgmma
// ones (delta, dk/dv in 64-column slices, dq in 128-column slices), kept
// as its control; arguments as the fp32 _dn entry's.
int maest_attn_bwd_bf16_dn_mma(int dp, const void* q, const void* k,
                               const void* v, const void* o,
                               const void* dout, const float* lse,
                               float* delta, void* dq, void* dk, void* dv,
                               int batch, int n, int heads, int n_real,
                               const long long* strides, float sl,
                               float scale, void* stream) {
  return launch_bwd_dn<bf16>(dp, q, k, v, o, dout, lse, delta, dq, dk, dv,
                             batch, n, heads, n_real, strides, sl, scale,
                             stream);
}

// The backward rig's fp8 kind (scripts/bwd_int8_probe.py:91-107): K3b's
// dk/dv and dq kernels with E4M3 = true on q, v, dout (bh, n, 64) e4m3 rows
// and krows, K's rows made from the rig's kt (attention_bwd_q8.cu
// maest_bwd_rig_layout, which also gives delta); lse, delta (bh, n) fp32.
// Writes dq (bh, n, 64) bf16, dk and dv (bh, n, 64) fp32. sl = the rig's
// SCALE log2(e), scale = its SCALE. No key is masked. Two launches.
int maest_bwd_rig_fp8(const void* q, const void* krows, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, int bh, int n, float sl,
                      float scale, void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  constexpr int smem = bwd_e4m3_smem_bytes();
  static const cudaError_t attr = [] {
    const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dkv_bf16_kernel<WARPS, TILE, D, true>, a, smem);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(attn_bwd_dq_bf16_kernel<WARPS, TILE, D, true>,
                                      a, smem);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strides rows{static_cast<long long>(n) * D, D, 0};  // heads = 1
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(bh, (n + 16 * WARPS - 1) / (16 * WARPS));
  const uint8_t *q8 = static_cast<const uint8_t*>(q),
                *k8 = static_cast<const uint8_t*>(krows),
                *v8 = static_cast<const uint8_t*>(v),
                *d8 = static_cast<const uint8_t*>(dout);
  attn_bwd_dkv_bf16_kernel<WARPS, TILE, D, true><<<grid, 32 * WARPS, smem, s>>>(
      q8, k8, v8, d8, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), n, n, 1, rows, rows, rows, rows, rows, rows, sl,
      scale);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  attn_bwd_dq_bf16_kernel<WARPS, TILE, D, true><<<grid, 32 * WARPS, smem, s>>>(
      q8, k8, v8, d8, lse, delta, static_cast<bf16*>(dq), n, n, 1, rows, rows,
      rows, rows, rows, sl, scale);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward at another tile: rows (16 a warp: 32, 64 or 128) and
// tile (streamed rows: 32, 64 or 128), the rest as maest_attn_bwd_bf16_mma's.
// (64, 64) is that control. Returns cudaErrorInvalidValue for another tile.
int maest_attn_bwd_tile(int rows, int tile, const void* q, const void* k,
                        const void* v, const void* o, const void* dout,
                        const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int batch, int n, int heads, int n_real,
                        const long long* strides, float sl, float scale,
                        void* stream) {
  decltype(&launch_bwd_bf16<4, 64>) fn;
  switch (rows * 1000 + tile) {
    case 32032: fn = launch_bwd_bf16<2, 32>; break;
    case 32064: fn = launch_bwd_bf16<2, 64>; break;
    case 32128: fn = launch_bwd_bf16<2, 128>; break;
    case 64032: fn = launch_bwd_bf16<4, 32>; break;
    case 64064: fn = launch_bwd_bf16<4, 64>; break;
    case 64128: fn = launch_bwd_bf16<4, 128>; break;
    case 128032: fn = launch_bwd_bf16<8, 32>; break;
    case 128064: fn = launch_bwd_bf16<8, 64>; break;
    case 128128: fn = launch_bwd_bf16<8, 128>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, n, heads, n_real,
            strides, sl, scale, stream);
}

}  // extern "C"
