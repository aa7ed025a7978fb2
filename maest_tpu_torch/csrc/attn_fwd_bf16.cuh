// The bf16 attention forward loop for Hopper (sm_90a), as one template over
// what the softmax section and the epilogue compute, over how many (batch,
// head) pairs a block walks, over the tile and over the head_dim D_ (64,
// 128 or 256 for the production FLASH instances; the probes stay at 64).
//
// Variant FLASH is the production kernel (K2 without lse, K3a with it):
// online softmax, instantiated by attention_fwd.cu; its design and bounds
// are described there. The other variants are the measurement variants of
// scripts/attn_profile_r2.py and scripts/attn_vpu_probe.py, instantiated by
// attention_probe.cu. They keep FLASH's grid, cp.async double buffer,
// ldmatrix fragments and mma.sync m16n8k16 products line for line and
// change only the two sections named above, so the time each one saves is
// the time of what it leaves out:
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
//   BF16SM    (attn_vpu_probe.py _variant_kernel, kind "bf16sm", :112-132):
//             the softmax in bf16, softmax_bf16 below.
//   MIX       (scripts/int8_probe.py _probe_kernel, kind "mix_bf16", :76-81):
//             p = exp2(s * 1e-4 - 1) of the unscaled fp32 s, each step
//             rounded on its own, with no mask, no max and no sum; out =
//             bf16(acc), not divided. The caller passes n_real = n.
//
// G (_gh_kernel, attn_profile_r2.py:148): a block walks G (batch, head)
// pairs in turn, each through the whole loop with its own m, l and acc, so
// each head's arithmetic and output are those of G = 1. The grid is
// (B*H / G, ceil(N / (16 WARPS_))); the caller keeps B*H divisible by G.
//
// The tile (scripts/attn_tune.py, :67 time_config): WARPS_ warps own 16
// query rows each, and key / value tiles of MK_ keys are double-buffered.
// K2 is 8 warps (128 rows) x 64 keys. The rows a warp owns change which
// block computes a row, not its arithmetic; the key tile changes where p
// is rounded against the running max. Tiles of 128 keys need 73.7 KB of
// K/V buffers, past the 48 KB of static shared memory: they take dynamic
// shared memory (fwd_smem_bytes), which the launch sets the limit for.
//
// QPAD (scripts/qpad_probe.py:46 fwd_qpad, which pads q rows to the
// sublane's 8, not the block's): a warp whose 16 rows all lie at or past N
// skips its products, softmax and store, but still stages its share of
// every tile and meets every __syncthreads. The H100's counterpart pads q
// to mma.sync's 16 rows. The output is K2's.
//
// Every variant rounds p to bf16 for the P.V product and keeps l and acc
// in fp32, as FLASH does. Only FLASH writes lse.
//
// D_ = 128 (head_dim 65-128, zero-padded to 128 by the caller): the same
// loop with D_ / 16 k-steps in the scores product and D_ / 8 output
// n-tiles. A warp's fp32 output sums double to 64 registers a thread and
// its q fragments to 32, past the 128 that two 8-warp blocks an SM allow,
// so the instance runs one block an SM (fwd_min_blocks) with up to 255
// registers; its double-buffered K/V tiles (rows of 136 bf16) take 69.6
// KB, past the 48 KB of static shared memory: dynamic (fwd_smem_bytes).
//
// D_ = 256 (head_dim 129-256): the output sums alone take 128 registers a
// thread, and q's fragments would take 64 more beside the 32 of the score
// tile and 16 of P, past the 255 a thread can have. So the block stages
// its q rows once in shared memory (QSM: 128 rows of 264 bf16, 67.6 KB)
// and each warp reads its q fragments through ldmatrix for every key tile,
// two k-steps at a time: 16 ldmatrix.x4 a tile beside the 64 of K and 64
// of V. The products and their order of summation are the register
// path's. K/V buffers (135 KB) and q take 203 KB of dynamic shared memory,
// one block an SM.

#pragma once

#include "mma_bf16.cuh"

namespace maest {

enum FwdVariant { FLASH, MXU_ONLY, NOEXP_MAX, NOVMAX, BF16S, BF16SM, MIX };

constexpr int WARPS = 8;
constexpr int MQ = 16 * WARPS;  // query rows per block
constexpr int MK = 64;          // keys per shared-memory tile

// 2^x of both halves of a bf16x2 on the special-function units (sm_90).
// PTX gives its relative error as at most 2^-7, where rounding an exact
// exp2 to bf16 (the plain version) errs by at most 2^-8; bf16 results
// below 2^-126 flush to zero.
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// The softmax of attn_vpu_probe.py's bf16 kinds (:112-132) on one warp's
// 16 x 64 score tile s (fp32 products in the C layout; row g in elements
// 0-1, row g + 8 in 2-3): x = bf16(s * sl), keys >= n_real at bf16(-1e30)
// when MASK; the running max m in bf16 (bf16 values held in fp32
// registers); p = exp2(bf16(x - m)) on packed bf16x2 pairs of one row,
// which are P's A fragments as they lie; corr = exp2(fp32(bf16(m_old -
// m))) scales l and acc, both fp32, and l adds the bf16 p.
template <bool MASK, int NDT>
__device__ __forceinline__ void softmax_bf16(const float (&s)[8][4], float sl,
                                             int base, int n_real, int t,
                                             float (&m)[2], float (&l)[2],
                                             float (&o)[NDT][4],
                                             uint32_t (&pf)[4][4]) {
  __nv_bfloat162 x[8][2];
  __nv_bfloat162 mx[2] = {__float2bfloat162_rn(m[0]),
                          __float2bfloat162_rn(m[1])};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int key = base + nt * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float a = s[nt][2 * r] * sl;
      float b = s[nt][2 * r + 1] * sl;
      if constexpr (MASK) {
        a = key < n_real ? a : NEG_INF;
        b = key + 1 < n_real ? b : NEG_INF;
      }
      x[nt][r] = __floats2bfloat162_rn(a, b);
      mx[r] = __hmax2(mx[r], x[nt][r]);
    }
  }
  __nv_bfloat162 m2[2];
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mr = fmaxf(__low2float(mx[r]), __high2float(mx[r]));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    m2[r] = __float2bfloat162_rn(mr);
    corr[r] = exp2f(__bfloat162float(
        __hsub(__float2bfloat16_rn(m[r]), __low2bfloat16(m2[r]))));
    m[r] = mr;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    o[dt][0] *= corr[0];
    o[dt][1] *= corr[0];
    o[dt][2] *= corr[1];
    o[dt][3] *= corr[1];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t p = ex2_bf16x2(bf16x2_bits(__hsub2(x[nt][r], m2[r])));
      pf[nt >> 1][(nt & 1) * 2 + r] = p;
      l[r] += __uint_as_float(p << 16) + __uint_as_float(p & 0xffff0000u);
    }
  }
}

// Blocks an SM keeps in flight: K2's two blocks of 8 warps cap the kernel
// at 128 registers a thread (it needs 132 uncapped, which leaves room for
// one block; measured 1.39 vs 1.64 ms). Every instance with tiles of 32 or
// 64 keys keeps that cap; 128-key tiles, whose score tile alone takes 64
// registers, get twice the registers (but a 16-warp block, 512 threads,
// gets no more than 128). So does head_dim 128, whose output sums alone
// take 64 registers.
__host__ __device__ constexpr int fwd_min_blocks(int warps, int mk,
                                                 int d = D) {
  const int blocks = (mk > 64 || d > 64 ? 256 : 512) / (32 * warps);
  return blocks > 1 ? blocks : 1;
}

// dynamic shared memory of an instance: its K/V buffers past 64 keys or
// past head_dim 64, and past head_dim 128 its q rows (16 a warp)
__host__ __device__ constexpr int fwd_smem_bytes(int mk, int d = D,
                                                 int warps = WARPS) {
  return (mk > 64 || d > 64
              ? 2 * 2 * mk * ld_bf16(d) * static_cast<int>(sizeof(bf16))
              : 0) +
         (d > 128 ? 16 * warps * ld_bf16(d) * static_cast<int>(sizeof(bf16))
                  : 0);
}

// Fragment layouts: see mma_bf16.cuh.
template <int Variant, int G = 1, int WARPS_ = WARPS, int MK_ = MK,
          bool QPAD = false, int D_ = D>
__global__ void __launch_bounds__(32 * WARPS_, fwd_min_blocks(WARPS_, MK_, D_))
attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int n, int n_real, int heads,
                     Strides qs, Strides ks, Strides vs, Strides os, float sl) {
  constexpr int MQ_ = 16 * WARPS_;         // query rows per block
  constexpr int LD_ = ld_bf16(D_);
  constexpr bool DYN = fwd_smem_bytes(MK_, D_, WARPS_) > 0;
  constexpr bool QSM = D_ > 128;  // q fragments from shared memory
  constexpr int SMK = DYN ? 1 : MK_;
  __shared__ __align__(128) bf16 k_st[2][SMK][LD_];  // double-buffered tiles
  __shared__ __align__(128) bf16 v_st[2][SMK][LD_];
  extern __shared__ __align__(128) bf16 kv_dyn[];
  bf16(*k_sm)[MK_][LD_];
  bf16(*v_sm)[MK_][LD_];
  if constexpr (DYN) {
    k_sm = reinterpret_cast<bf16(*)[MK_][LD_]>(kv_dyn);
    v_sm = k_sm + 2;
  } else {
    k_sm = k_st;
    v_sm = v_st;
  }
  // QSM: the block's q rows, after the K/V buffers
  bf16(*q_sm)[LD_] = reinterpret_cast<bf16(*)[LD_]>(v_sm + 2);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 1
  for (int gi = 0; gi < G; ++gi) {  // the heads of this block, in turn
    const int bh = blockIdx.x * G + gi;
    const int b = bh / heads;
    const int h = bh - b * heads;
    const int row0 = blockIdx.y * MQ_ + warp * 16 + g;  // and row0 + 8
    // QPAD: false for a warp whose 16 rows all lie at or past N
    const bool live = !QPAD || blockIdx.y * MQ_ + warp * 16 < n;

    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;
    // stage key tile `tile` into buffer `buf`: MK_ keys x D_ / 8 chunks of
    // 16 bytes for each of K and V (K2: two chunks per thread per tensor)
    auto stage = [&](int tile, int buf) {
      for (int i = threadIdx.x; i < MK_ * (D_ / 8); i += 32 * WARPS_) {
        const int j = i >> ilog2(D_ / 8);
        const int c = (i & (D_ / 8 - 1)) * 8;
        const int key = tile * MK_ + j;
        const long long src = static_cast<long long>(min(key, n - 1));
        const int bytes = key < n ? 16 : 0;
        cp_async16(&k_sm[buf][j][c], kb + src * ks.n + c, bytes);
        cp_async16(&v_sm[buf][j][c], vb + src * vs.n + c, bytes);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };

    const int n_tiles = (n_real + MK_ - 1) / MK_;
    if constexpr (QSM) {  // the q rows join tile 0's copy group
      const bf16* qb = q + b * qs.b + h * qs.h;
      for (int i = threadIdx.x; i < MQ_ * (D_ / 8); i += 32 * WARPS_) {
        const int j = i >> ilog2(D_ / 8);
        const int c = (i & (D_ / 8 - 1)) * 8;
        const int row = blockIdx.y * MQ_ + j;
        cp_async16(&q_sm[j][c],
                   qb + static_cast<long long>(min(row, n - 1)) * qs.n + c,
                   row < n ? 16 : 0);
      }
    }
    stage(0, 0);

    // q fragments of this warp's 16 rows, D_ / 16 k-steps over d (QSM: read
    // from shared memory in the loop)
    uint32_t qf[QSM ? 1 : D_ / 16][4];
    if constexpr (!QSM) {
      const bf16* qb = q + b * qs.b + h * qs.h;
      const bf16* q0 = qb + static_cast<long long>(min(row0, n - 1)) * qs.n;
      const bf16* q1 =
          qb + static_cast<long long>(min(row0 + 8, n - 1)) * qs.n;
#pragma unroll
      for (int kk = 0; kk < D_ / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        qf[kk][0] = ld_u32(q0 + c);
        qf[kk][1] = ld_u32(q1 + c);
        qf[kk][2] = ld_u32(q0 + c + 8);
        qf[kk][3] = ld_u32(q1 + c + 8);
      }
    }

    float o[D_ / 8][4];
#pragma unroll
    for (int dt = 0; dt < D_ / 8; ++dt)
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
      const int base = it * MK_;

      if (live) {
        // scores: 16 rows x MK_ keys = MK_ / 8 n-tiles of 8 keys; one
        // ldmatrix.x4 brings K for one n-tile and two k-steps (d 0..31,
        // 32..63, ...)
        float s[MK_ / 8][4];
        if constexpr (QSM) {
          // the same products in the same order, q's two k-steps of each
          // 32 d read once for all n-tiles
#pragma unroll
          for (int nt = 0; nt < MK_ / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
          for (int half = 0; half < D_ / 32; ++half) {
            uint32_t qa[2][4];
#pragma unroll
            for (int x = 0; x < 2; ++x)
              ldmatrix_x4(qa[x], &q_sm[warp * 16 + (li & 1) * 8 + lr]
                                      [(2 * half + x) * 16 + (li >> 1) * 8]);
#pragma unroll
            for (int nt = 0; nt < MK_ / 8; ++nt) {
              uint32_t kf[4];
              ldmatrix_x4(kf, &k_sm[buf][nt * 8 + lr][half * 32 + li * 8]);
              mma_16816(s[nt], qa[0], kf[0], kf[1]);
              mma_16816(s[nt], qa[1], kf[2], kf[3]);
            }
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < MK_ / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
            for (int half = 0; half < D_ / 32; ++half) {
              uint32_t kf[4];
              ldmatrix_x4(kf, &k_sm[buf][nt * 8 + lr][half * 32 + li * 8]);
              mma_16816(s[nt], qf[2 * half], kf[0], kf[1]);
              mma_16816(s[nt], qf[2 * half + 1], kf[2], kf[3]);
            }
          }
        }

        // probabilities: fp32 into the sums, bf16 into the A operand of P.V;
        // n-tiles 2j and 2j+1 of the scores form k-step j of P
        uint32_t pf[MK_ / 16][4];
        if constexpr (Variant == MXU_ONLY) {
#pragma unroll
          for (int nt = 0; nt < MK_ / 8; ++nt) {
            pf[nt >> 1][(nt & 1) * 2 + 0] =
                pack_bf16(s[nt][0] * sl, s[nt][1] * sl);
            pf[nt >> 1][(nt & 1) * 2 + 1] =
                pack_bf16(s[nt][2] * sl, s[nt][3] * sl);
          }
        } else if constexpr (Variant == BF16SM) {
          softmax_bf16<true>(s, sl, base, n_real, t, m, l, o, pf);
        } else if constexpr (Variant == MIX) {
#pragma unroll
          for (int nt = 0; nt < MK_ / 8; ++nt) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[e] = exp2f(__fsub_rn(__fmul_rn(s[nt][e], 1e-4f), 1.f));
            pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
            pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
          }
        } else {
          // NOVMAX: the max of this tile alone
          float mx[2] = {Variant == NOVMAX ? NEG_INF : m[0],
                         Variant == NOVMAX ? NEG_INF : m[1]};
#pragma unroll
          for (int nt = 0; nt < MK_ / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = base + nt * 8 + 2 * t + (e & 1);
              float x;
              // BF16S: scores and mask rounded to bf16
              if constexpr (Variant == BF16S)
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
              for (int dt = 0; dt < D_ / 8; ++dt) {
                o[dt][0] *= corr[0];
                o[dt][1] *= corr[0];
                o[dt][2] *= corr[1];
                o[dt][3] *= corr[1];
              }
            }
          }

#pragma unroll
          for (int nt = 0; nt < MK_ / 8; ++nt) {
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

        // out += P (16 x MK_ keys) . V (MK_ keys x D_ d); one
        // ldmatrix.x4.trans brings V for one k-step (16 keys) and two d
        // n-tiles
#pragma unroll
        for (int kj = 0; kj < MK_ / 16; ++kj) {
#pragma unroll
          for (int dp = 0; dp < D_ / 16; ++dp) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, &v_sm[buf][kj * 16 + (li & 1) * 8 + lr]
                                           [dp * 16 + (li >> 1) * 8]);
            mma_16816(o[2 * dp], pf[kj], vf[0], vf[1]);
            mma_16816(o[2 * dp + 1], pf[kj], vf[2], vf[3]);
          }
        }
      }  // live
      __syncthreads();  // every warp is done with `buf` before it is refilled
    }

    if (!live) continue;  // its rows lie past N: nothing to store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (Variant == MXU_ONLY || Variant == MIX) {
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
      for (int dt = 0; dt < D_ / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
      if (Variant == FLASH && lse != nullptr && t == 0)  // probes pass none
        lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
    }
  }
}

// grid (B*H / group, ceil(N / rows_per_block)) on `stream`; returns
// cudaGetLastError(). st: the (b, n, h) element strides of q, k, v, out.
// group: the kernel's G (B*H must be divisible by it). smem: the kernel's
// dynamic shared memory in bytes (its limit set by the caller).
template <typename T>
int launch(void (*kernel)(const T*, const T*, const T*, T*, float*, int, int,
                          int, Strides, Strides, Strides, Strides, float),
           int rows_per_block, int threads, const void* q, const void* k,
           const void* v, void* out, float* lse, int batch, int n, int heads,
           int n_real, const long long* st, float sl, void* stream,
           int group = 1, int smem = 0) {
  if (batch <= 0 || n <= 0) return 0;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(batch * heads / group,
                  (n + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, n, n_real, heads,
      qs, ks, vs, os, sl);
  return static_cast<int>(cudaGetLastError());
}

// an instance of attn_fwd_bf16_kernel with its rows, threads and dynamic
// shared memory
template <int Variant, int G = 1, int WARPS_ = WARPS, int MK_ = MK,
          bool QPAD = false, int D_ = D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int batch, int n, int heads, int n_real,
               const long long* st, float sl, void* stream) {
  const auto kernel = attn_fwd_bf16_kernel<Variant, G, WARPS_, MK_, QPAD, D_>;
  constexpr int smem = fwd_smem_bytes(MK_, D_, WARPS_);
  // once an instance, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  if (smem > 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  return launch<bf16>(kernel, 16 * WARPS_, 32 * WARPS_, q, k, v, out, lse,
                      batch, n, heads, n_real, st, sl, stream, G, smem);
}

}  // namespace maest
