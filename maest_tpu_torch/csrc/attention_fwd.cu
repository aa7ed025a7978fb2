// Attention forward for Hopper (sm_90a): online softmax, head_dim 64, 128
// and 256 (a template parameter D_ of each kernel; a smaller head_dim is
// zero-padded to the next instance by the caller, ops/attention.py).
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
// Design, fp32 (the parity tier, which must hold 2e-5 and so cannot use
// TF32 or bf16 products): scalar fp32 FMA. One thread per query row keeps
// its q row and output accumulator in registers; key/value tiles are
// staged in shared memory as fp32 and read as broadcasts; each group of
// SUB keys is scored, then the running max, correction and sum are
// updated once for the group. The fp32 FMA rate bounds this kernel. At
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
// D_ = 256 in bf16: the template's QSM path (attn_fwd_bf16.cuh), q rows in
// shared memory.
//
// Both kernels: grid (B*H, ceil(N / rows per block)). Key tiles wholly at
// or past n_real would contribute exactly zero (exp2(-1e30 - m) underflows
// to 0), so the key loop stops at n_real; inside the last tile the keys
// >= n_real are masked with -1e30 as in the TPU kernel. Query rows past N
// are computed on clamped inputs and never stored, so any N works.

#include "attn_fwd_bf16.cuh"  // the bf16 kernel (variant FLASH) and launch

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
int maest_attn_fwd_fp32(const void* q, const void* k, const void* v, void* out,
                        float* lse, int batch, int n, int heads, int n_real,
                        const long long* strides, float sl, void* stream) {
  return launch<float>(attn_fwd_fp32_kernel<>, BQ, BQ, q, k, v, out, lse,
                       batch, n, heads, n_real, strides, sl, stream);
}

int maest_attn_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                        float* lse, int batch, int n, int heads, int n_real,
                        const long long* strides, float sl, void* stream) {
  return launch<bf16>(attn_fwd_bf16_kernel<FLASH>, MQ, 32 * WARPS, q, k, v,
                      out, lse, batch, n, heads, n_real, strides, sl, stream);
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

int maest_attn_fwd_bf16_d128(const void* q, const void* k, const void* v,
                             void* out, float* lse, int batch, int n,
                             int heads, int n_real, const long long* strides,
                             float sl, void* stream) {
  return launch_fwd<FLASH, 1, WARPS, MK, false, 128>(
      q, k, v, out, lse, batch, n, heads, n_real, strides, sl, stream);
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

int maest_attn_fwd_bf16_d256(const void* q, const void* k, const void* v,
                             void* out, float* lse, int batch, int n,
                             int heads, int n_real, const long long* strides,
                             float sl, void* stream) {
  return launch_fwd<FLASH, 1, WARPS, MK, false, 256>(
      q, k, v, out, lse, batch, n, heads, n_real, strides, sl, stream);
}

}  // extern "C"
