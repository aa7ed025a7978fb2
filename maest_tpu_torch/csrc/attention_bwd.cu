// Attention backward for Hopper (sm_90a), head_dim 64, 128 and 256 (a
// template parameter D_ of each kernel; the caller zero-pads a smaller
// head_dim).
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
// double-buffered (a multiple of SUB). K3b is 4 warps (64 rows) x 64. The
// other tiles are the instances of scripts/attn_tune.py's backward sweep
// (:116 time_bwd, which runs _flash_bwd at each block_q), entered through
// maest_attn_bwd_tile; a tile changes which block sums a gradient, not the
// order of its sums over the streamed rows' SUB passes. Tiles of 128 rows
// need 73.7 KB of buffers, past the 48 KB of static shared memory: they
// take dynamic shared memory (bwd_smem_bytes).
//
// fp32 design (the parity tier, which must stay true fp32): scalar FMA. In
// the dk/dv kernel a thread owns one key (its k and v rows in shared memory
// rows padded to 65 floats, so 32 threads hit 32 banks; dk and dv in
// registers) and q/do tiles are read as broadcasts; in the dq kernel a
// thread owns one q row the same way and k/v tiles are the broadcasts.
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

#include "mma_bf16.cuh"

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

template <int WARPS_ = WARPS, int TILE_ = TILE, int D_ = D>
__global__ void __launch_bounds__(32 * WARPS_)
attn_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int n, int n_real, int heads,
                         Strides qs, Strides ks, Strides vs, Strides dos,
                         Strides dks, Strides dvs, float sl, float scale) {
  constexpr int ROWS = 16 * WARPS_;  // keys per block
  constexpr int LD_ = ld_bf16(D_);
  constexpr bool DYN = bwd_smem_bytes(TILE_, D_, WARPS_) > 0;
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
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* dob = dout + b * dos.b + h * dos.h;
    const float* lse_bh = lse + static_cast<long long>(bh) * n;
    const float* delta_bh = delta + static_cast<long long>(bh) * n;
    auto stage = [&](int tile, int buf) {
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
    if constexpr (!OWN) {
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
#pragma unroll
      for (int r0 = 0; r0 < TILE_; r0 += SUB) {
        // S^T = K.Q^T: rows are this warp's keys, columns q rows r0..
        float p[SUB / 8][4];
        if constexpr (OWN)
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
        if constexpr (OWN)  // dp^T = V.dO^T
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

template <int WARPS_ = WARPS, int TILE_ = TILE, int D_ = D>
__global__ void __launch_bounds__(32 * WARPS_)
attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int n, int n_real, int heads, Strides qs, Strides ks,
                        Strides vs, Strides dos, Strides dqs, float sl,
                        float scale) {
  constexpr int ROWS = 16 * WARPS_;  // q rows per block
  constexpr int LD_ = ld_bf16(D_);
  constexpr bool DYN = bwd_smem_bytes(TILE_, D_, WARPS_) > 0;
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

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  // OWN: the block's q and do rows, after the K and V buffers
  bf16(*own_q)[LD_] = reinterpret_cast<bf16(*)[LD_]>(v_sm + 2);
  bf16(*own_do)[LD_] = own_q + ROWS;
  if constexpr (OWN)  // a copy group of their own, before tile 0's
    stage_pair<WARPS_, ROWS, D_>(own_q, own_do, q + b * qs.b + h * qs.h, qs.n,
                                 dout + b * dos.b + h * dos.h, dos.n,
                                 blockIdx.y * ROWS, n);
  stage_pair<WARPS_, TILE_, D_>(k_sm[0], v_sm[0], kb, ks.n, vb, vs.n, 0, n);

  uint32_t qf[OWN ? 1 : D_ / 16][4], dof[OWN ? 1 : D_ / 16][4];
  if constexpr (!OWN) {
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
      stage_pair<WARPS_, TILE_, D_>(k_sm[buf ^ 1], v_sm[buf ^ 1], kb, ks.n,
                                    vb, vs.n, (it + 1) * TILE_, n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int base = it * TILE_;
#pragma unroll
    for (int r0 = 0; r0 < TILE_; r0 += SUB) {
      float p[SUB / 8][4];
      if constexpr (OWN)  // S = Q.K^T
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
      if constexpr (OWN)  // dP = dO.V^T
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
// Every o and dout row (both entries) and every q/k/v row (bf16 entry)
// must start on a 16-byte boundary. Three launches on `stream` (delta, dk/dv, dq); returns the
// first non-zero cudaGetLastError().
int maest_attn_bwd_fp32(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int batch,
                        int n, int heads, int n_real, const long long* strides,
                        float sl, float scale, void* stream) {
  return launch_bwd_fp32(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, n,
                         heads, n_real, strides, sl, scale, stream);
}

int maest_attn_bwd_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int batch,
                        int n, int heads, int n_real, const long long* strides,
                        float sl, float scale, void* stream) {
  return launch_bwd_bf16<WARPS, TILE>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                      batch, n, heads, n_real, strides, sl,
                                      scale, stream);
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

int maest_attn_bwd_bf16_d256(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             float* delta, void* dq, void* dk, void* dv,
                             int batch, int n, int heads, int n_real,
                             const long long* strides, float sl, float scale,
                             void* stream) {
  return launch_bwd_bf16<WARPS, TILE, 256>(q, k, v, o, dout, lse, delta, dq,
                                           dk, dv, batch, n, heads, n_real,
                                           strides, sl, scale, stream);
}

// The bf16 backward at another tile: rows (16 a warp: 32, 64 or 128) and
// tile (streamed rows: 32, 64 or 128), the rest as maest_attn_bwd_bf16's.
// (64, 64) is K3b. Returns cudaErrorInvalidValue for another tile.
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
