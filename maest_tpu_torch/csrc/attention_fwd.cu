// Attention forward for Hopper (sm_90a): online softmax, head_dim 64.
//
// Replaces maest_tpu/ops/attention.py::_attn_kernel + _attn_body (called
// from _flash_fwd / _flash_fwd_lse(with_lse=False) / flash_attention), the
// inference forward without the log-sum-exp output. Semantics are those of
// _attn_body: scores q.k are scaled by scale*log2(e) and exponentiated with
// exp2; keys at index >= n_real get -1e30; the running max and sum are fp32
// and P.V accumulates in fp32; the output is divided by the sum once, at
// the end. For bf16 inputs the probabilities are rounded to bf16 for the
// P.V product, as the TPU kernel feeds them to its bf16 matrix unit, while
// the sum adds the fp32 values.
//
// Layout: q, k and v are (B, N, H, 64) views with any batch/token/head
// strides and a contiguous last dimension, so the kernels read the q/k/v
// slices of the fused qkv projection in place; they write out
// (B, N, H, 64) themselves. No transpose copies are made on either side.
//
// What bounds it on the H100: arithmetic. Per (batch, head) the forward
// does 4 N^2 64 flops against 4 N 64 elements moved; at N = 1676 that is
// ~800 flops per element, so the matrix products and the N^2 exp2 of the
// softmax bound it, not device memory.
//
// Design, bf16 (the production tier): tensor cores through mma.sync
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
// updated once for the group. The fp32 FMA rate bounds this kernel.
//
// Both kernels: grid (B*H, ceil(N / rows per block)). Key tiles wholly at
// or past n_real would contribute exactly zero (exp2(-1e30 - m) underflows
// to 0), so the key loop stops at n_real; inside the last tile the keys
// >= n_real are masked with -1e30 as in the TPU kernel. Query rows past N
// are computed on clamped inputs and never stored, so any N works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;  // head_dim, fixed at compile time
constexpr float NEG_INF = -1e30f;

struct Strides {  // element strides of a (B, N, H, D) view
  long long b, n, h;
};

// ---------------------------------------------------------------- fp32 ---
constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int SUB = 16;  // keys per softmax update

__global__ void __launch_bounds__(BQ)
attn_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int n, int n_real, int heads, Strides qs, Strides ks,
                     Strides vs, Strides os, float sl) {
  __shared__ float4 k_tile[BK][D / 4];
  __shared__ float4 v_tile[BK][D / 4];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row = blockIdx.y * BQ + threadIdx.x;
  const int row_c = row < n ? row : n - 1;

  float qr[D];
  const float* qp = q + b * qs.b + static_cast<long long>(row_c) * qs.n + h * qs.h;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = qp[d];

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = NEG_INF, l = 0.f;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  for (int base = 0; base < n_real; base += BK) {
    __syncthreads();  // the previous tile is fully consumed
    float* kt = reinterpret_cast<float*>(k_tile);
    float* vt = reinterpret_cast<float*>(v_tile);
    for (int i = threadIdx.x; i < BK * D; i += BQ) {
      const int j = i / D;
      const int d = i - j * D;
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

    const int tile_keys = min(BK, n_real - base);
    for (int j0 = 0; j0 < tile_keys; j0 += SUB) {
      float s[SUB];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
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
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = exp2f(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
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
    for (int d = 0; d < D; ++d) op[d] = acc[d] / l;
  }
}

// ---------------------------------------------------------------- bf16 ---
using bf16 = __nv_bfloat16;
constexpr int WARPS = 8;
constexpr int MQ = 16 * WARPS;  // query rows per block
constexpr int MK = 64;          // keys per shared-memory tile
constexpr int LD = D + 8;       // shared-memory row, bf16: 144 bytes, so the
                                // 8 rows an ldmatrix phase reads hit 32 banks

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
// the destination with zeros (keys past the end of the sequence)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
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

// Fragment layout of m16n8k16 (PTX ISA), lane = 4 g + t:
//   A: a0 (row g, cols 2t..2t+1), a1 (row g+8, same), a2 (row g, cols
//      2t+8..2t+9), a3 (row g+8, same)
//   B: b0 (rows 2t..2t+1, col g), b1 (rows 2t+8..2t+9, col g)
//   C: c0,c1 (row g, cols 2t..2t+1), c2,c3 (row g+8, same)
// ldmatrix.x4 gives lane the pair (row g, cols 2t..2t+1) of each of four
// 8x8 tiles whose rows lanes 8i..8i+7 address; .trans gives the pair
// (rows 2t..2t+1, col g). On row-major K (key, d) the first is the B
// operand of Q.K^T, on row-major V (key, d) the second that of P.V.
// two blocks per SM: caps the kernel at 128 registers a thread (it needs
// 132 uncapped, which leaves room for one block); measured 1.39 vs 1.64 ms
__global__ void __launch_bounds__(32 * WARPS, 2)
attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int n, int n_real, int heads, Strides qs, Strides ks,
                     Strides vs, Strides os, float sl) {
  __shared__ __align__(128) bf16 k_sm[2][MK][LD];  // double-buffered tiles
  __shared__ __align__(128) bf16 v_sm[2][MK][LD];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int row0 = blockIdx.y * MQ + warp * 16 + g;  // and row0 + 8

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  // stage key tile `tile` into buffer `buf`: 64 keys x 8 chunks of 16 bytes
  // for each of K and V, two chunks per thread per tensor
  auto stage = [&](int tile, int buf) {
    for (int i = threadIdx.x; i < MK * (D / 8); i += 32 * WARPS) {
      const int j = i >> 3;
      const int c = (i & 7) * 8;
      const int key = tile * MK + j;
      const long long src = static_cast<long long>(min(key, n - 1));
      const int bytes = key < n ? 16 : 0;
      cp_async16(&k_sm[buf][j][c], kb + src * ks.n + c, bytes);
      cp_async16(&v_sm[buf][j][c], vb + src * vs.n + c, bytes);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int n_tiles = (n_real + MK - 1) / MK;
  stage(0, 0);

  // q fragments of this warp's 16 rows, 4 k-steps over d
  uint32_t qf[4][4];
  {
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* q0 = qb + static_cast<long long>(min(row0, n - 1)) * qs.n;
    const bf16* q1 = qb + static_cast<long long>(min(row0 + 8, n - 1)) * qs.n;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = ld_u32(q0 + c);
      qf[kk][1] = ld_u32(q1 + c);
      qf[kk][2] = ld_u32(q0 + c + 8);
      qf[kk][3] = ld_u32(q1 + c + 8);
    }
  }

  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g+8
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  // ldmatrix row addresses: lanes 8i..8i+7 address the rows of tile i
  const int lr = lane & 7;
  const int li = lane >> 3;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage(it + 1, buf ^ 1);  // the buffer the previous iteration freed
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile `it` is in shared memory for every warp
    const int base = it * MK;

    // scores: 16 rows x 64 keys = 8 n-tiles of 8 keys; one ldmatrix.x4
    // brings K for one n-tile and two k-steps (d 0..31 or 32..63)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &k_sm[buf][nt * 8 + lr][half * 32 + li * 8]);
        mma_16816(s[nt], qf[2 * half], kf[0], kf[1]);
        mma_16816(s[nt], qf[2 * half + 1], kf[2], kf[3]);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = base + nt * 8 + 2 * t + (e & 1);
        const float x = key < n_real ? s[nt][e] * sl : NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // probabilities: fp32 into the sums, bf16 into the A operand of P.V;
    // n-tiles 2j and 2j+1 of the scores form k-step j of P
    uint32_t pf[4][4];
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

    // out += P (16 x 64 keys) . V (64 keys x 64 d); one ldmatrix.x4.trans
    // brings V for one k-step (16 keys) and two d n-tiles
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, &v_sm[buf][kj * 16 + (li & 1) * 8 + lr][dp * 16 + (li >> 1) * 8]);
        mma_16816(o[2 * dp], pf[kj], vf[0], vf[1]);
        mma_16816(o[2 * dp + 1], pf[kj], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    bf16* orow = ob + static_cast<long long>(row) * os.n + 2 * t;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) = __floats2bfloat162_rn(
          o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
  }
}

// ---------------------------------------------------------------- entry ---
template <typename T>
int launch(void (*kernel)(const T*, const T*, const T*, T*, int, int, int,
                          Strides, Strides, Strides, Strides, float),
           int rows_per_block, int threads, const void* q, const void* k,
           const void* v, void* out, int batch, int n, int heads, int n_real,
           const long long* st, float sl, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(batch * heads, (n + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, n_real, heads, qs, ks,
      vs, os, sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, out: (batch, n, heads, 64) with element strides
// strides[0..11] = (q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h, o_b, o_n,
// o_h) and a contiguous last dimension. sl = head_dim^-0.5 * log2(e).
// 1 <= n_real <= n. The bf16 entry also needs every q/k/v row to start on
// a 16-byte boundary. Launches on `stream`; returns cudaGetLastError().
int maest_attn_fwd_fp32(const void* q, const void* k, const void* v, void* out,
                        int batch, int n, int heads, int n_real,
                        const long long* strides, float sl, void* stream) {
  return launch<float>(attn_fwd_fp32_kernel, BQ, BQ, q, k, v, out, batch, n, heads,
                       n_real, strides, sl, stream);
}

int maest_attn_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                        int batch, int n, int heads, int n_real,
                        const long long* strides, float sl, void* stream) {
  return launch<bf16>(attn_fwd_bf16_kernel, MQ, 32 * WARPS, q, k, v, out, batch, n, heads,
                      n_real, strides, sl, stream);
}

}  // extern "C"
