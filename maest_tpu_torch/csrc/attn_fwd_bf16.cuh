// The bf16 attention forward loop for Hopper (sm_90a), head_dim 64, as one
// template over what the softmax section and the epilogue compute.
//
// Variant FLASH is the production kernel (K2 without lse, K3a with it):
// online softmax, instantiated by attention_fwd.cu; its design and bounds
// are described there. The other four are the measurement variants of
// scripts/attn_profile_r2.py, instantiated by attention_probe.cu. They keep
// FLASH's grid, cp.async double buffer, ldmatrix fragments and mma.sync
// m16n8k16 products line for line and change only the two sections named
// above, so the time each one saves is the time of what it leaves out:
//
//   MXU_ONLY  (_mxu_only_kernel, :47): p = bf16(s * sl) with sl = scale,
//             no mask, no max, no sum; out = bf16(acc), not divided. The
//             caller passes n_real = n: keys past n are staged as zeros
//             and add nothing.
//   NOEXP_MAX (_noexp_max_kernel, :63): x = s * sl, keys >= n_real at
//             -1e30; p = exp2(x) with no shift; out = acc / l. Valid while
//             |x| stays well under 128 (fp32 exp2's range).
//   NOVMAX    (_novmax_kernel, :88): p = exp2(x - max over this 64-key
//             tile only): no running max and no correction of l or acc;
//             out = acc / l. The function depends on the key tile.
//   BF16S     (_bf16_scores_kernel, :113): the caller pre-scales q by
//             scale * log2(e) in bf16; s is the fp32 product rounded to
//             bf16 (masked keys at bf16(-1e30)), and the max, exp2, sum and
//             correction run as FLASH's on fp32(s). sl is not used.
//
// Every variant rounds p to bf16 for the P.V product and keeps l and acc
// in fp32, as FLASH does. Only FLASH writes lse.

#pragma once

#include "mma_bf16.cuh"

namespace maest {

enum FwdVariant { FLASH, MXU_ONLY, NOEXP_MAX, NOVMAX, BF16S };

constexpr int WARPS = 8;
constexpr int MQ = 16 * WARPS;  // query rows per block
constexpr int MK = 64;          // keys per shared-memory tile
constexpr int LD = D + 8;       // shared-memory row, bf16: 144 bytes, so the
                                // 8 rows an ldmatrix phase reads hit 32 banks

// Fragment layouts: see mma_bf16.cuh.
// two blocks per SM: caps the kernel at 128 registers a thread (it needs
// 132 uncapped, which leaves room for one block); measured 1.39 vs 1.64 ms
template <int Variant>
__global__ void __launch_bounds__(32 * WARPS, 2)
attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int n, int n_real, int heads,
                     Strides qs, Strides ks, Strides vs, Strides os, float sl) {
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
  // rows g and g+8: the shift of exp2 (NOEXP_MAX: none, 0)
  float m[2] = {Variant == NOEXP_MAX ? 0.f : NEG_INF,
                Variant == NOEXP_MAX ? 0.f : NEG_INF};
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

    // probabilities: fp32 into the sums, bf16 into the A operand of P.V;
    // n-tiles 2j and 2j+1 of the scores form k-step j of P
    uint32_t pf[4][4];
    if constexpr (Variant == MXU_ONLY) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(s[nt][0] * sl, s[nt][1] * sl);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2] * sl, s[nt][3] * sl);
      }
    } else {
      // NOVMAX: the max of this tile alone
      float mx[2] = {Variant == NOVMAX ? NEG_INF : m[0],
                     Variant == NOVMAX ? NEG_INF : m[1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = base + nt * 8 + 2 * t + (e & 1);
          float x;
          if constexpr (Variant == BF16S)  // scores and mask rounded to bf16
            x = __bfloat162float(
                __float2bfloat16_rn(key < n_real ? s[nt][e] : NEG_INF));
          else
            x = key < n_real ? s[nt][e] * sl : NEG_INF;
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      if constexpr (Variant != NOEXP_MAX) {
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          if constexpr (Variant != NOVMAX) {
            corr[r] = exp2f(m[r] - mx[r]);
            l[r] *= corr[r];
          }
          m[r] = mx[r];
        }
        if constexpr (Variant != NOVMAX) {
#pragma unroll
          for (int dt = 0; dt < 8; ++dt) {
            o[dt][0] *= corr[0];
            o[dt][1] *= corr[0];
            o[dt][2] *= corr[1];
            o[dt][3] *= corr[1];
          }
        }
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
    if constexpr (Variant == MXU_ONLY) {
      l[r] = 1.f;  // divides by nothing
    } else {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
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
    if (Variant == FLASH && lse != nullptr && t == 0)  // probes pass none
      lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
  }
}

// grid (B*H, ceil(N / rows_per_block)) on `stream`; returns
// cudaGetLastError(). st: the (b, n, h) element strides of q, k, v, out.
template <typename T>
int launch(void (*kernel)(const T*, const T*, const T*, T*, float*, int, int,
                          int, Strides, Strides, Strides, Strides, float),
           int rows_per_block, int threads, const void* q, const void* k,
           const void* v, void* out, float* lse, int batch, int n, int heads,
           int n_real, const long long* st, float sl, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(batch * heads, (n + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, n, n_real, heads,
      qs, ks, vs, os, sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
