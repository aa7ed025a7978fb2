// Attention forward for Hopper (sm_90a): online softmax, head_dim 64, 128
// and 256 (a template parameter D_ of each kernel; a smaller head_dim is
// zero-padded to the next instance by the caller, ops/attention.py), and
// any multiple of 64 above 256 (the _dn entries).
//
// Replaces maest_tpu/ops/attention.py::_attn_kernel + _attn_body (called
// from _flash_fwd_lse): the inference forward without the log-sum-exp
// output (K2, lse == nullptr) and the training forward with it (K3a, from
// _fwd of the custom VJP). The lse is m + log2(l) per query row, fp32, in
// the log2 domain of _attn_body, written as (B, H, N); the backward in
// attention_bwd.cu rebuilds the probabilities from it. Semantics are those of
// _attn_body: scores q.k are scaled by scale*log2(e) and exponentiated with
// exp2; keys at index >= n_real get -1e30; the running max and sum are fp32
// and P.V accumulates in fp32; the output is divided by the sum once, at
// the end. For bf16 inputs the probabilities are rounded to bf16 for the
// P.V product, as the TPU kernel feeds them to its bf16 matrix unit, while
// the sum adds the fp32 values.
//
// Layout: q, k and v are (B, N, H, D) views with any batch/token/head
// strides and a contiguous last dimension, so the kernels read the q/k/v
// slices of the fused qkv projection in place; they write out
// (B, N, H, D) themselves. No transpose copies are made on either side.
//
// What bounds it on the H100: arithmetic. Per (batch, head) the forward
// does 4 N^2 64 flops against 4 N 64 elements moved; at N = 1676 that is
// ~800 flops per element, so the matrix products and the N^2 exp2 of the
// softmax bound it, not device memory.
//
// Design, bf16 (the production tier; its loop is the FLASH variant of the
// template in attn_fwd_bf16.cuh): tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 accumulate). A block of 8 warps owns 128 query
// rows, 16 per warp; each warp keeps its q fragments, its 16 x 64 score
// tile and its 16 x 64 output accumulator in registers, and the score
// accumulator becomes the A operand of P.V without a trip through shared
// memory. Key/value tiles of 64 rows are double-buffered in shared memory
// with cp.async, so the next tile loads while this one is multiplied; the
// B operands come from the row-major tiles through ldmatrix (.trans for
// V), whose rows are padded by 8 elements so each phase hits 32 banks.
// Row max and row sum are reduced across the 4 threads that share a row
// with two shuffles.
//
// Design, fp32 at head_dim 64 (the parity tier, which must hold 2e-5): the
// products on the tensor cores as 3xTF32, each operand split into a tf32
// high part and a tf32 remainder and three tf32 wgmma products summed in
// fp32 (attn_fwd_tf32.cuh, the route of maest_attn_fwd_fp32); one tf32
// product alone misses 2e-5 by ~20x. Its control and every other fp32
// width run scalar fp32 FMA (maest_attn_fwd_fp32_fma at 64): one thread
// per query row keeps its q row and output accumulator in registers;
// key/value tiles are staged in shared memory as fp32 and read as
// broadcasts; each group of SUB keys is scored, then the running max,
// correction and sum are updated once for the group. The fp32 FMA rate
// bounds this kernel. At
// D_ = 128 the key tile halves to 32 keys (two 16 KB fp32 tiles, inside
// the 48 KB of static shared memory), and the q row and accumulator, 256
// registers together, spill in part to local memory, which L1 caches:
// the tier exists for parity, and a slower kernel is still exact.
// At D_ = 256 the q row and sums would take 512 registers, so four threads
// share a row (attn_fwd_fp32_wide_kernel): each holds 64 of its columns
// (every fourth float4 of the row, so the four read neighbouring 16-byte
// chunks of a key row at once) and its 64 sums, as at D_ = 64, and the
// row's dot is summed across the four with two shuffles; a block owns 32
// rows and 16-key tiles (32 KB).
//
// D_ = 128 in bf16 runs the wgmma/TMA kernel of attn_fwd_wgmma.cuh at D =
// 128 (each row two 64-column chunks; two consumer warpgroups, 80- or
// 96-key tiles); the mma.sync FLASH instance at D_ = 128 stays as its
// control, maest_attn_fwd_bf16_d128_mma. D_ = 256 in bf16 runs the
// wgmma/TMA kernel of attn_fwd_d256_wgmma.cuh (two consumer warpgroups and
// no producer warp, O whole in registers, S made once); the template's QSM
// path (attn_fwd_bf16.cuh, q rows in shared memory) stays as its control,
// maest_attn_fwd_bf16_d256_mma.
//
// Any head_dim above 256 (the _dn entries): the width dp, zero-padded by
// the caller to a multiple of 64, is a runtime argument, so registers and
// shared memory do not grow with it. In bf16, maest_attn_fwd_bf16_dn runs
// the wgmma/TMA kernel of attn_fwd_dn_wgmma.cuh: 128 query rows a block
// with q resident in shared memory (streamed beside K above dp 768), the
// key tile's 64-column K chunks and the slice's V chunks through a TMA ring,
// 192-column output slices over the grid, so at dp 384 the scores are made
// twice. Its control, maest_attn_fwd_bf16_dn_mma, is the mma.sync kernel
// below: the scores of a key tile summed over 64-column chunks of K, each
// staged from global memory for that tile (q's fragments of the chunk read
// from global memory too), the output in 128-column slices over a third
// grid axis, each slice's block recomputing the scores and the softmax
// over the full dp (3 times at dp 384; 64 registers of sums beside the
// score tile, one block an SM), its 64 x 64 tiles (the K chunks of a key
// tile, then V's chunks of the slice) double-buffered with cp.async (a ring
// of four with one barrier a tile measured no faster at dp 384 on the
// H100). The fp32 kernel computes 64-column slices, one thread a row, so
// its scores are made 6 times at dp 384 and 8 at 512, and stages 32-key
// tiles synchronously. Only slice 0 writes lse.
//
// Every kernel: key tiles wholly at or past n_real would contribute
// exactly zero (exp2(-1e30 - m) underflows to 0), so the key loop stops at
// n_real; inside the last tile the keys >= n_real are masked with -1e30 as
// in the TPU kernel. Query rows past N are computed on clamped (or, through
// TMA, zero) inputs and never stored, so any N works.

#include "attn_fwd_bf16.cuh"   // the bf16 kernel (variant FLASH) and launch
#include "attn_fwd_wgmma.cuh"  // the bf16 kernel at head_dim 64 on wgmma/TMA
#include "attn_fwd_dn_wgmma.cuh"  // the bf16 kernel above 256 on wgmma/TMA
#include "attn_fwd_d256_wgmma.cuh"  // the bf16 kernel at 256 on wgmma/TMA
#include "attn_fwd_tf32.cuh"   // the fp32 kernel at head_dim 64, 3xTF32

namespace {

using namespace maest;

// ---------------------------------------------------------------- fp32 ---
constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int BK = 64;   // keys per shared-memory tile (head_dim 64)
constexpr int SUB = 16;  // keys per softmax update

template <int D_ = D>
__global__ void __launch_bounds__(BQ)
attn_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int n, int n_real, int heads,
                     Strides qs, Strides ks, Strides vs, Strides os, float sl) {
  constexpr int BK_ = BK * D / D_;  // 32 KB of K/V tiles at every head_dim
  __shared__ float4 k_tile[BK_][D_ / 4];
  __shared__ float4 v_tile[BK_][D_ / 4];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row = blockIdx.y * BQ + threadIdx.x;
  const int row_c = row < n ? row : n - 1;

  float qr[D_];
  const float* qp = q + b * qs.b + static_cast<long long>(row_c) * qs.n + h * qs.h;
#pragma unroll
  for (int d = 0; d < D_; ++d) qr[d] = qp[d];

  float acc[D_];
#pragma unroll
  for (int d = 0; d < D_; ++d) acc[d] = 0.f;
  float m = NEG_INF, l = 0.f;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  for (int base = 0; base < n_real; base += BK_) {
    __syncthreads();  // the previous tile is fully consumed
    float* kt = reinterpret_cast<float*>(k_tile);
    float* vt = reinterpret_cast<float*>(v_tile);
    for (int i = threadIdx.x; i < BK_ * D_; i += BQ) {
      const int j = i / D_;
      const int d = i - j * D_;
      const int key = base + j;
      float kv = 0.f, vv = 0.f;
      if (key < n) {
        kv = kb[static_cast<long long>(key) * ks.n + d];
        vv = vb[static_cast<long long>(key) * vs.n + d];
      }
      kt[i] = kv;
      vt[i] = vv;
    }
    __syncthreads();

    const int tile_keys = min(BK_, n_real - base);
    for (int j0 = 0; j0 < tile_keys; j0 += SUB) {
      float s[SUB];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D_ / 4; ++d4) {
          const float4 kk = k_tile[j0 + jj][d4];
          dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        const float sc = (j0 + jj < tile_keys) ? dot * sl : NEG_INF;
        s[jj] = sc;
        m_new = fmaxf(m_new, sc);
      }
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D_; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = exp2f(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int d4 = 0; d4 < D_ / 4; ++d4) {
          const float4 vv = v_tile[j0 + jj][d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row < n) {
    float* op = out + b * os.b + static_cast<long long>(row) * os.n + h * os.h;
#pragma unroll
    for (int d = 0; d < D_; ++d) op[d] = acc[d] / l;
    if (lse != nullptr) lse[static_cast<long long>(bh) * n + row] = m + log2f(l);
  }
}

// D_ > 128: TPR threads a row, 32 rows a block (see the design note)
template <int D_>
__global__ void __launch_bounds__(BQ)
attn_fwd_fp32_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          float* __restrict__ lse, int n, int n_real,
                          int heads, Strides qs, Strides ks, Strides vs,
                          Strides os, float sl) {
  constexpr int TPR = D_ / 64;      // threads a row
  constexpr int C4 = D_ / 4 / TPR;  // float4 chunks a thread owns
  constexpr int BK_ = BK * D / D_;  // 32 KB of K/V tiles
  __shared__ float4 k_tile[BK_][D_ / 4];
  __shared__ float4 v_tile[BK_][D_ / 4];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row = blockIdx.y * (BQ / TPR) + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;  // chunks part, part + TPR, ...
  const int row_c = row < n ? row : n - 1;

  float4 qr[C4];
  const float* qp = q + b * qs.b + static_cast<long long>(row_c) * qs.n + h * qs.h;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    const float* x = qp + 4 * (c * TPR + part);
    qr[c] = make_float4(x[0], x[1], x[2], x[3]);
  }

  float4 acc[C4];
#pragma unroll
  for (int c = 0; c < C4; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = NEG_INF, l = 0.f;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  for (int base = 0; base < n_real; base += BK_) {
    __syncthreads();  // the previous tile is fully consumed
    float* kt = reinterpret_cast<float*>(k_tile);
    float* vt = reinterpret_cast<float*>(v_tile);
    for (int i = threadIdx.x; i < BK_ * D_; i += BQ) {
      const int j = i / D_;
      const int d = i - j * D_;
      const int key = base + j;
      float kv = 0.f, vv = 0.f;
      if (key < n) {
        kv = kb[static_cast<long long>(key) * ks.n + d];
        vv = vb[static_cast<long long>(key) * vs.n + d];
      }
      kt[i] = kv;
      vt[i] = vv;
    }
    __syncthreads();

    const int tile_keys = min(BK_, n_real - base);
    for (int j0 = 0; j0 < tile_keys; j0 += SUB) {
      float s[SUB];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 kk = k_tile[j0 + jj][c * TPR + part];
          dot = fmaf(qr[c].x, kk.x, dot);
          dot = fmaf(qr[c].y, kk.y, dot);
          dot = fmaf(qr[c].z, kk.z, dot);
          dot = fmaf(qr[c].w, kk.w, dot);
        }
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const float sc = (j0 + jj < tile_keys) ? dot * sl : NEG_INF;
        s[jj] = sc;
        m_new = fmaxf(m_new, sc);
      }
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        acc[c].x *= corr;
        acc[c].y *= corr;
        acc[c].z *= corr;
        acc[c].w *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = exp2f(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 vv = v_tile[j0 + jj][c * TPR + part];
          acc[c].x = fmaf(p, vv.x, acc[c].x);
          acc[c].y = fmaf(p, vv.y, acc[c].y);
          acc[c].z = fmaf(p, vv.z, acc[c].z);
          acc[c].w = fmaf(p, vv.w, acc[c].w);
        }
      }
      m = m_new;
    }
  }

  if (row < n) {
    float* op = out + b * os.b + static_cast<long long>(row) * os.n + h * os.h;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      float* x = op + 4 * (c * TPR + part);
      x[0] = acc[c].x / l;
      x[1] = acc[c].y / l;
      x[2] = acc[c].z / l;
      x[3] = acc[c].w / l;
    }
    if (lse != nullptr && part == 0)
      lse[static_cast<long long>(bh) * n + row] = m + log2f(l);
  }
}

// ---------------------------------------------------------- any width ---
// head_dim above 256 (see the note at the top): dp, a multiple of CH = 64,
// is an argument. Grid (B*H, ceil(N / rows a block), slices); a block
// recomputes the scores over the full dp and sums one slice of the output
// columns; only slice 0 writes lse.
constexpr int DN_SLICE = 128;  // output columns a bf16 block sums

__global__ void __launch_bounds__(32 * WARPS, 1)
attn_fwd_bf16_dn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        float* __restrict__ lse, int n, int n_real, int heads,
                        int dp, Strides qs, Strides ks, Strides vs, Strides os,
                        float sl) {
  // double-buffered 64-key x 64-column tiles: a chunk of K, or of V's slice
  __shared__ __align__(128) bf16 tile[2][MK][ld_bf16(CH)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;
  const int li = lane >> 3;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row0 = blockIdx.y * MQ + warp * 16 + g;  // and row0 + 8
  const int c0 = blockIdx.z * DN_SLICE;              // this block's columns
  const int nch = dp / CH;                           // K chunks a key tile
  const int nvc = min(DN_SLICE, dp - c0) / CH;       // V chunks: 1 or 2
  const int steps = nch + nvc;                       // tiles a key tile
  const int total = (n_real + MK - 1) / MK * steps;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  // step j: chunk c < nch of key tile j / steps from K, else V's chunk
  auto stage = [&](int j, int buf) {
    const int it = j / steps;
    const int c = j - it * steps;
    const bf16* src = c < nch ? kb + c * CH : vb + c0 + (c - nch) * CH;
    const long long rs = c < nch ? ks.n : vs.n;
    for (int i = threadIdx.x; i < MK * (CH / 8); i += 32 * WARPS) {
      const int jj = i >> 3;
      const int cc = (i & 7) * 8;
      const int key = it * MK + jj;
      cp_async16(&tile[buf][jj][cc],
                 src + static_cast<long long>(min(key, n - 1)) * rs + cc,
                 key < n ? 16 : 0);
    }
    cp_async_commit();
  };

  float o0[8][4], o1[8][4];  // the slice's two 64-column halves
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o0[dt][e] = o1[dt][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float s[8][4];
  uint32_t pf[4][4];
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
    if (c < nch) {  // s += q_c . K_c^T
      if (c == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
      uint32_t qf[4][4];
      load_row_frags(qf, qb + c * CH, qs.n, row0, n, t);
      chunk_dot(s, qf, tile[buf], lr, li);
      if (c == nch - 1) {  // FLASH's softmax step over this key tile
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = it * MK + nt * 8 + 2 * t + (e & 1);
            const float x = key < n_real ? s[nt][e] * sl : NEG_INF;
            s[nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = exp2f(m[r] - mx[r]);
          l[r] *= corr[r];
          m[r] = mx[r];
        }
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o0[dt][e] *= corr[e >> 1];
            o1[dt][e] *= corr[e >> 1];
          }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float p0 = exp2f(s[nt][0] - m[0]);
          const float p1 = exp2f(s[nt][1] - m[0]);
          const float p2 = exp2f(s[nt][2] - m[1]);
          const float p3 = exp2f(s[nt][3] - m[1]);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
          pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
      }
    } else if (c == nch) {  // o0 += P . V chunk (as FLASH's P.V)
      chunk_pv(o0, pf, tile[buf], lr, li);
    } else {
      chunk_pv(o1, pf, tile[buf], lr, li);
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  bf16* ob = out + b * os.b + h * os.h + c0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    bf16* orow = ob + static_cast<long long>(row) * os.n + 2 * t;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
          __floats2bfloat162_rn(o0[dt][2 * r] / l[r], o0[dt][2 * r + 1] / l[r]);
      if (nvc == 2)
        *reinterpret_cast<__nv_bfloat162*>(orow + CH + dt * 8) =
            __floats2bfloat162_rn(o1[dt][2 * r] / l[r],
                                  o1[dt][2 * r + 1] / l[r]);
    }
    if (lse != nullptr && blockIdx.z == 0 && t == 0)
      lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
  }
}

constexpr int FDN_BK = 32;  // keys a tile of the fp32 kernel (two SUB groups)

// fp32, one thread a query row: the scores of a 32-key tile are summed over
// 64-column chunks of K staged in shared memory (q read from global memory,
// a chunk at a time), then a 64-column slice of the output takes FLASH's
// SUB-key updates
__global__ void __launch_bounds__(BQ)
attn_fwd_fp32_dn_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int n, int n_real, int heads,
                        int dp, Strides qs, Strides ks, Strides vs, Strides os,
                        float sl) {
  __shared__ float k_tile[FDN_BK][CH];
  __shared__ float v_tile[FDN_BK][CH];
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row = blockIdx.y * BQ + threadIdx.x;
  const int c0 = blockIdx.z * CH;  // this block's output columns
  const float* qp =
      q + b * qs.b + static_cast<long long>(row < n ? row : n - 1) * qs.n +
      h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  float acc[CH];
#pragma unroll
  for (int d = 0; d < CH; ++d) acc[d] = 0.f;
  float m = NEG_INF, l = 0.f;
  // stage columns c.. of the tile's keys from x (rows of stride rs)
  auto stage = [&](float (*dst)[CH], const float* x, long long rs, int base,
                   int c) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < FDN_BK * CH; i += BQ) {
      const int j = i / CH;
      const int d = i - j * CH;
      const int key = base + j;
      dst[j][d] = key < n ? x[static_cast<long long>(key) * rs + c + d] : 0.f;
    }
    __syncthreads();
  };
  for (int base = 0; base < n_real; base += FDN_BK) {
    float s[FDN_BK];
#pragma unroll
    for (int j = 0; j < FDN_BK; ++j) s[j] = 0.f;
    for (int c = 0; c < dp; c += CH) {
      stage(k_tile, kb, ks.n, base, c);
#pragma unroll 4
      for (int d = 0; d < CH; ++d) {
        const float qd = qp[c + d];
#pragma unroll
        for (int j = 0; j < FDN_BK; ++j) s[j] = fmaf(qd, k_tile[j][d], s[j]);
      }
    }
    stage(v_tile, vb, vs.n, base, c0);
    const int tile_keys = min(FDN_BK, n_real - base);
#pragma unroll
    for (int j0 = 0; j0 < FDN_BK; j0 += SUB) {
      if (j0 >= tile_keys) break;
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float sc = j0 + jj < tile_keys ? s[j0 + jj] * sl : NEG_INF;
        s[j0 + jj] = sc;
        m_new = fmaxf(m_new, sc);
      }
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < CH; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = exp2f(s[j0 + jj] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < CH; ++d)
          acc[d] = fmaf(p, v_tile[j0 + jj][d], acc[d]);
      }
      m = m_new;
    }
  }

  if (row < n) {
    float* op = out + b * os.b + static_cast<long long>(row) * os.n + h * os.h +
                c0;
#pragma unroll
    for (int d = 0; d < CH; ++d) op[d] = acc[d] / l;
    if (lse != nullptr && blockIdx.z == 0)
      lse[static_cast<long long>(bh) * n + row] = m + log2f(l);
  }
}

// the runtime-width kernel on a grid with a third axis of `slices`
template <typename T>
int launch_dn(void (*kernel)(const T*, const T*, const T*, T*, float*, int,
                             int, int, int, Strides, Strides, Strides, Strides,
                             float),
              int rows_per_block, int threads, int slices, int dp,
              const void* q, const void* k, const void* v, void* out,
              float* lse, int batch, int n, int heads, int n_real,
              const long long* st, float sl, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (dp <= 0 || dp % CH) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(batch * heads, (n + rows_per_block - 1) / rows_per_block,
                  slices);
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, n, n_real, heads,
      dp, qs, ks, vs, os, sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, out: (batch, n, heads, 64) with element strides
// strides[0..11] = (q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h, o_b, o_n,
// o_h) and a contiguous last dimension. lse: nullptr (inference), or a
// contiguous fp32 (batch, heads, n) that receives m + log2(l) per row.
// sl = head_dim^-0.5 * log2(e). 1 <= n_real <= n. The bf16 entry also
// needs every q/k/v row to start on a 16-byte boundary. Launches on
// `stream`; returns cudaGetLastError().
//
// An entry X that takes scratch (after lse) exports X_scratch(batch, n,
// heads), its floats; the port sizes the scratch by it.
//
// The fp32 entry at head_dim 64 runs the 3xTF32 wgmma kernel
// (attn_fwd_tf32.cuh): its prep pass, then the kernel with two consumer
// warpgroups (128 query rows a block) taking turns, one product in flight
// at a time and each tile's P.V summed in fresh chains (on the H100 the
// next tile's S issued with P.V into one running sum ran 8 % faster and
// landed several times farther from plain at (32, 1676); PERF.md). It takes
// one more argument after lse, `scratch`: maest_attn_fwd_fp32_scratch(
// batch, n, heads) floats for k's and v's tf32 planes.
int maest_attn_fwd_fp32(const void* q, const void* k, const void* v, void* out,
                        float* lse, float* scratch, int batch, int n,
                        int heads, int n_real, const long long* strides,
                        float sl, void* stream) {
  return launch_fwd_tf32(q, k, v, out, lse, scratch, batch, n, heads, n_real,
                         strides, sl, stream);
}

long long maest_attn_fwd_fp32_scratch(int batch, int n, int heads) {
  return tf_fwd_scratch_floats(batch, n, heads);
}

// The scalar fp32 FMA kernel that maest_attn_fwd_fp32 ran before the tf32
// one, kept as its control: the arguments of maest_attn_fwd_bf16.
int maest_attn_fwd_fp32_fma(const void* q, const void* k, const void* v,
                            void* out, float* lse, int batch, int n,
                            int heads, int n_real, const long long* strides,
                            float sl, void* stream) {
  return launch<float>(attn_fwd_fp32_kernel<>, BQ, BQ, q, k, v, out, lse,
                       batch, n, heads, n_real, strides, sl, stream);
}

// The bf16 entry at head_dim 64 runs the wgmma kernel (attn_fwd_wgmma.cuh)
// with three consumer warpgroups taking turns and the key tile, 96 or 112
// keys, that pads n_real the least (96 on a tie; wg_key_tile): in the tile
// sweep (chip_smoke.py phase 30) 112 was best at N 866 and 1676 (8 and 15
// tiles, 30 and 4 keys padded) and 96 at 281 (3 tiles, 7 padded, where 112
// pads 55). It reads q, k and v through TMA, so each view's base address and
// strides must be multiples of 16 bytes.
int maest_attn_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                        float* lse, int batch, int n, int heads, int n_real,
                        const long long* strides, float sl, void* stream) {
  if (wg_key_tile(n_real) == 112)
    return launch_fwd_wgmma<112, 3, true>(q, k, v, out, lse, batch, n, heads,
                                          n_real, strides, sl, stream);
  return launch_fwd_wgmma<96, 3, true>(q, k, v, out, lse, batch, n, heads,
                                       n_real, strides, sl, stream);
}

// The mma.sync kernel that maest_attn_fwd_bf16 ran before the wgmma one
// (variant FLASH of attn_fwd_bf16.cuh), kept as its control: the same
// arguments.
int maest_attn_fwd_bf16_mma(const void* q, const void* k, const void* v,
                            void* out, float* lse, int batch, int n,
                            int heads, int n_real, const long long* strides,
                            float sl, void* stream) {
  return launch<bf16>(attn_fwd_bf16_kernel<FLASH>, MQ, 32 * WARPS, q, k, v,
                      out, lse, batch, n, heads, n_real, strides, sl, stream);
}

// The wgmma kernel's configurations of the tile sweep, chosen by `config`
// (key tile BK, consumer warpgroups NC, turns PP): 0 (96, 3, on) and 4
// (112, 3, on), the two that maest_attn_fwd_bf16 chooses between; 1 (96,
// 3, off); 2 (64, 3, on), whose 64-key tiles give the control's numbers
// bit for bit; 3 (64, 2, on); 5 (128, 3, on); 6 (128, 2, on); 7 (192, 2,
// on). Otherwise the arguments of maest_attn_fwd_bf16; another config
// returns cudaErrorInvalidValue.
int maest_attn_fwd_bf16_wgmma(int config, const void* q, const void* k,
                              const void* v, void* out, float* lse, int batch,
                              int n, int heads, int n_real,
                              const long long* strides, float sl,
                              void* stream) {
#define MAEST_WG(BK, NC, PP)                                                   \
  launch_fwd_wgmma<BK, NC, PP>(q, k, v, out, lse, batch, n, heads, n_real,     \
                               strides, sl, stream)
  switch (config) {
    case 0: return MAEST_WG(96, 3, true);
    case 1: return MAEST_WG(96, 3, false);
    case 2: return MAEST_WG(64, 3, true);
    case 3: return MAEST_WG(64, 2, true);
    case 4: return MAEST_WG(112, 3, true);
    case 5: return MAEST_WG(128, 3, true);
    case 6: return MAEST_WG(128, 2, true);
    case 7: return MAEST_WG(192, 2, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MAEST_WG
}

// The same two entries at head_dim 128: (batch, n, heads, 128) views,
// sl = 128^-0.5 log2(e) or, on inputs zero-padded from a head_dim d, d^-0.5
// log2(e).
int maest_attn_fwd_fp32_d128(const void* q, const void* k, const void* v,
                             void* out, float* lse, int batch, int n,
                             int heads, int n_real, const long long* strides,
                             float sl, void* stream) {
  return launch<float>(attn_fwd_fp32_kernel<128>, BQ, BQ, q, k, v, out, lse,
                       batch, n, heads, n_real, strides, sl, stream);
}

// The bf16 entry at head_dim 128 runs the wgmma kernel (attn_fwd_wgmma.cuh
// at D = 128) with two consumer warpgroups taking turns, a ring of two
// stages and the key tile, 80 or 96 keys, that pads n_real the least (80 on
// a tie; wg128_key_tile): in the tile sweep (maest_attn_fwd_bf16_d128_wgmma,
// chip_smoke.py phase 43) 80 and 96 keys ran within a few per cent of each
// other at N 1676 (21 and 18 tiles), 80 was best at N 866 (11 tiles, 14
// keys padded, where 96 pads 94), 64 keys lost at both and three or four
// stages gained nothing. It reads q, k and v through TMA, so each view's
// base address and strides must be multiples of 16 bytes.
int maest_attn_fwd_bf16_d128(const void* q, const void* k, const void* v,
                             void* out, float* lse, int batch, int n,
                             int heads, int n_real, const long long* strides,
                             float sl, void* stream) {
  if (wg128_key_tile(n_real) == 96)
    return launch_fwd_wgmma<96, 2, true, false, 1, 128>(
        q, k, v, out, lse, batch, n, heads, n_real, strides, sl, stream);
  return launch_fwd_wgmma<80, 2, true, false, 1, 128>(
      q, k, v, out, lse, batch, n, heads, n_real, strides, sl, stream);
}

// The mma.sync kernel that maest_attn_fwd_bf16_d128 ran before the wgmma
// one (variant FLASH of attn_fwd_bf16.cuh at D_ = 128), kept as its
// control: the same arguments.
int maest_attn_fwd_bf16_d128_mma(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int batch, int n,
                                 int heads, int n_real,
                                 const long long* strides, float sl,
                                 void* stream) {
  return launch_fwd<FLASH, 1, WARPS, MK, false, 128>(
      q, k, v, out, lse, batch, n, heads, n_real, strides, sl, stream);
}

// The head_dim-128 wgmma kernel's configurations of the tile sweep, chosen
// by `config` (key tile BK, ring stages ST; two consumer warpgroups taking
// turns): 0 (64, 2), 1 (64, 3), 2 (80, 2), 3 (80, 3), 4 (96, 2), 5 (96, 3),
// 6 (64, 4), 7 (80, 4), 8 (96, 4). Otherwise the arguments of
// maest_attn_fwd_bf16_d128; another config returns cudaErrorInvalidValue.
int maest_attn_fwd_bf16_d128_wgmma(int config, const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int batch, int n, int heads, int n_real,
                                   const long long* strides, float sl,
                                   void* stream) {
#define MAEST_WG(BK, ST)                                                       \
  launch_fwd_wgmma<BK, 2, true, false, 1, 128, ST>(                            \
      q, k, v, out, lse, batch, n, heads, n_real, strides, sl, stream)
  switch (config) {
    case 0: return MAEST_WG(64, 2);
    case 1: return MAEST_WG(64, 3);
    case 2: return MAEST_WG(80, 2);
    case 3: return MAEST_WG(80, 3);
    case 4: return MAEST_WG(96, 2);
    case 5: return MAEST_WG(96, 3);
    case 6: return MAEST_WG(64, 4);
    case 7: return MAEST_WG(80, 4);
    case 8: return MAEST_WG(96, 4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MAEST_WG
}

// The same two entries at head_dim 256: (batch, n, heads, 256) views, sl
// = 256^-0.5 log2(e) or, on inputs zero-padded from a head_dim d, d^-0.5
// log2(e).
int maest_attn_fwd_fp32_d256(const void* q, const void* k, const void* v,
                             void* out, float* lse, int batch, int n,
                             int heads, int n_real, const long long* strides,
                             float sl, void* stream) {
  return launch<float>(attn_fwd_fp32_wide_kernel<256>, BQ / 4, BQ, q, k, v,
                       out, lse, batch, n, heads, n_real, strides, sl, stream);
}

// The bf16 entry at head_dim 256 runs the wgmma/TMA kernel
// (attn_fwd_d256_wgmma.cuh), so each view's base address and strides must
// be multiples of 16 bytes.
int maest_attn_fwd_bf16_d256(const void* q, const void* k, const void* v,
                             void* out, float* lse, int batch, int n,
                             int heads, int n_real, const long long* strides,
                             float sl, void* stream) {
  return launch_fwd_d256_wgmma(q, k, v, out, lse, batch, n, heads, n_real,
                               strides, sl, stream);
}

// The mma.sync FLASH instance that maest_attn_fwd_bf16_d256 ran before the
// wgmma one (q rows in shared memory), kept as its control; the same
// arguments.
int maest_attn_fwd_bf16_d256_mma(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int batch, int n,
                                 int heads, int n_real,
                                 const long long* strides, float sl,
                                 void* stream) {
  return launch_fwd<FLASH, 1, WARPS, MK, false, 256>(
      q, k, v, out, lse, batch, n, heads, n_real, strides, sl, stream);
}

// The same two entries at a head_dim dp above 256, a multiple of 64 (a
// head_dim between is zero-padded by the caller): (batch, n, heads, dp)
// views; sl = dp^-0.5 log2(e), or the unpadded head_dim's. Returns
// cudaErrorInvalidValue for another dp. The bf16 entry runs the wgmma/TMA
// kernel (attn_fwd_dn_wgmma.cuh), so each view's base address and strides
// must be multiples of 16 bytes; maest_attn_fwd_bf16_dn_mma, the mma.sync
// kernel it ran before, stays as its control with the same arguments. The
// fp32 entry runs the scalar FMA kernel.
int maest_attn_fwd_fp32_dn(int dp, const void* q, const void* k,
                           const void* v, void* out, float* lse, int batch,
                           int n, int heads, int n_real,
                           const long long* strides, float sl, void* stream) {
  return launch_dn<float>(attn_fwd_fp32_dn_kernel, BQ, BQ, dp / CH, dp, q, k,
                          v, out, lse, batch, n, heads, n_real, strides, sl,
                          stream);
}

int maest_attn_fwd_bf16_dn(int dp, const void* q, const void* k,
                           const void* v, void* out, float* lse, int batch,
                           int n, int heads, int n_real,
                           const long long* strides, float sl, void* stream) {
  return launch_fwd_dn_wgmma(dp, q, k, v, out, lse, batch, n, heads, n_real,
                             strides, sl, stream);
}

int maest_attn_fwd_bf16_dn_mma(int dp, const void* q, const void* k,
                               const void* v, void* out, float* lse,
                               int batch, int n, int heads, int n_real,
                               const long long* strides, float sl,
                               void* stream) {
  return launch_dn<bf16>(attn_fwd_bf16_dn_kernel, MQ, 32 * WARPS,
                         (dp + DN_SLICE - 1) / DN_SLICE, dp, q, k, v, out, lse,
                         batch, n, heads, n_real, strides, sl, stream);
}

}  // extern "C"
