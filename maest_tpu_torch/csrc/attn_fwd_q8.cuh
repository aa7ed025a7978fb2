// The 8-bit attention forward loop for Hopper (sm_90a), as one template over
// the mode (how q.k and p.v are multiplied and what the softmax section and
// the epilogue compute) and over the head_dim D_: 64, 128 or 256 for the
// production modes (the measurement variants stay at 64).
//
// The production modes (K5, K6), instantiated by attention_fwd_q8.cu, whose
// design and bounds are described there:
//
//   QK8, QK8PV8  int8 q.k with per-row / per-key scales; bf16 or int8 p.v
//   FP8, FP8PV8  e4m3 q.k; bf16 or e4m3 p.v
//
// The measurement variants, instantiated by attention_probe.cu (FP8PV8 is
// also attn_vpu_probe.py's "fp8lean", on a q pre-scaled by scale * log2(e)
// and sl = 1):
//
//   INT8_RIG  (attn_profile_r2.py _int8_kernel, :226-267): QK8PV8's
//             products and scores with the rig's scales (qsl = qs / 127^2
//             * sl per row, sk = max|k| per key, sv127 = vs / 127^2 per
//             column); p = exp2((s - m) + 6.9886) in fp32, so p <= 127;
//             p8 = round-half-even(p); l sums the unrounded p; acc adds
//             int32(p8 . v8); out = (acc * sv127) / l, written in fp32.
//   FP8SM     (attn_vpu_probe.py "fp8sm", :112-132): e4m3 q.k, the softmax
//             of softmax_bf16 (attn_fwd_bf16.cuh), bf16 p.v.
//   FP8NOEXP  ("fp8noexp", :63-83): e4m3 q.k, x = s * sl with keys >=
//             n_real at -1e30, p = exp2(x - 32) with no max and no
//             correction, bf16 p.v, out = acc / l.
//   FP8NOMASK ("fp8nomask"): FP8SM with no key mask. The caller passes
//             n_real = n_pad, a multiple of 64 at or past n: the loop walks
//             every tile up to it, and the keys from n on, staged as zeros,
//             each add exp2(bf16(0 - m)) to l and nothing to acc.
//   MIX8      (scripts/int8_probe.py _probe_kernel, kind "mix_i8", :68-74):
//             QK8PV8's int8 products without scales: p = exp2(float(s) *
//             1e-4 - 1), each step rounded on its own, no mask, no max;
//             p8 = round(p 127) saturated to [-128, 127] (to_s8_sat: the
//             rig's p reaches 2^20 and more, where to_s8 would wrap); the
//             int32 p8.v8 sums of every tile in one int32 total, converted
//             to fp32 once at the end and not divided. T = float.
//
// Every mode walks 64-key tiles with fp32 l and acc; the plain versions
// walk the same tiles.
//
// T is the element type of v (where it is not 8-bit) and of the output:
// bf16 for the production instances; fp32 for the int8 rig and for the
// production modes under the fp32 tier (attention_fwd_q8.cu's *_fp32
// entries). There QK8 and FP8 take P.V as _attn_body_q8 does on fp32 v, p
// unrounded times fp32 v, in scalar fp32 FMA (the fp32 K2's arithmetic):
// the four threads of a quad hold a row's 64 p between them, and each
// takes the other three's by shuffle. The pv8 modes multiply as in bf16.
//
// D_ = 128: D_ / 32 k-steps of 32 bytes in q.k, D_ / 8 output n-tiles, and
// the transposed 8-bit V of the pv8 modes holds D_ d rows. As in K2 at
// 128, the output sums take 64 registers a thread, so the instance runs
// one block an SM (fwd_min_blocks), and its K/V buffers (53-83 KB) take
// dynamic shared memory (q8_smem_bytes), whose limit the launch sets.
//
// D_ = 256: the output sums take 128 registers a thread, and the score
// tile, its probabilities and P's fragments 80 more, so, as K2 at 256
// (attn_fwd_bf16.cuh), q's fragments (32 registers) are read from the
// block's q rows staged once in shared memory (QSM, 128 rows of 272
// bytes), two k-steps at a time for every n-tile.

#pragma once

#include "attn_fwd_bf16.cuh"  // WARPS, MQ, MK, fwd_min_blocks, softmax_bf16
#include "mma_8bit.cuh"

namespace maest {

enum Q8Mode {
  QK8 = 0,
  QK8PV8 = 1,
  FP8 = 2,
  FP8PV8 = 3,
  INT8_RIG = 4,
  FP8SM = 5,
  FP8NOEXP = 6,
  FP8NOMASK = 7,
  MIX8 = 8
};

constexpr float NOEXP_SHIFT = 32.f;  // FP8NOEXP's constant max
constexpr float P127_SHIFT = 6.9886f;  // INT8_RIG: 2^6.9886 = 126.99

// bytes of one buffer of V: 8-bit transposed (d, 64 keys) rows, or fp32 /
// bf16 (key, d) rows
__host__ __device__ constexpr int q8_vbytes(bool pv8, bool f32v, int d) {
  return pv8 ? d * LD8 : (f32v ? MK * d * 4 : MK * ld_bf16(d) * 2);
}

// dynamic shared memory of an instance (head_dim past 64): two K buffers
// of ld8(d)-byte rows and two V buffers, and past 128 the block's q rows;
// the key scales stay static
__host__ __device__ constexpr int q8_smem_bytes(bool pv8, bool f32v, int d) {
  return d > 64 ? 2 * MK * ld8(d) + 2 * q8_vbytes(pv8, f32v, d) +
                      (d > 128 ? MQ * ld8(d) : 0)
                : 0;
}

template <int MODE, typename T = bf16, int D_ = D>
__global__ void __launch_bounds__(32 * WARPS, fwd_min_blocks(WARPS, MK, D_))
attn_fwd_q8_kernel(const uint8_t* __restrict__ q8, const uint8_t* __restrict__ k8,
                   const float* __restrict__ qsl, const float* __restrict__ sk,
                   const void* __restrict__ v, const float* __restrict__ sv127,
                   T* __restrict__ out, float* __restrict__ lse, int n,
                   int n_real, int heads, Strides qs, Strides ks, Strides vs,
                   Strides os, float sl) {
  constexpr bool SCALES = MODE == QK8 || MODE == QK8PV8 || MODE == INT8_RIG;
  constexpr bool INT8 = SCALES || MODE == MIX8;  // int8 products
  constexpr bool PV8 = MODE == QK8PV8 || MODE == FP8PV8 || MODE == INT8_RIG ||
                       MODE == MIX8;
  constexpr bool QSM = D_ > 128;  // q fragments from shared memory
  constexpr bool SM16 = MODE == FP8SM || MODE == FP8NOMASK;  // bf16 softmax
  constexpr bool F32V = !PV8 && sizeof(T) == 4;  // fp32 v, scalar P.V
  constexpr int LDK = ld8(D_);     // K rows of D_ bytes
  constexpr int LDV = ld_bf16(D_);  // bf16 V rows
  // V: bf16 or fp32 (key, d) rows, or 8-bit transposed (d, key) rows
  constexpr int VBYTES = q8_vbytes(PV8, F32V, D_);
  constexpr bool DYN = q8_smem_bytes(PV8, F32V, D_) > 0;
  __shared__ __align__(128) uint8_t k_st[DYN ? 1 : 2][DYN ? 1 : MK][LDK];
  __shared__ __align__(128) uint8_t v_st[DYN ? 1 : 2][DYN ? 1 : VBYTES];
  __shared__ float sk_sm[2][MK];
  extern __shared__ __align__(128) uint8_t q8_dyn[];
  uint8_t(*k_sm)[MK][LDK];
  uint8_t(*v_sm)[VBYTES];
  if constexpr (DYN) {
    k_sm = reinterpret_cast<uint8_t(*)[MK][LDK]>(q8_dyn);
    v_sm = reinterpret_cast<uint8_t(*)[VBYTES]>(q8_dyn + 2 * MK * LDK);
  } else {
    k_sm = reinterpret_cast<uint8_t(*)[MK][LDK]>(k_st);
    v_sm = reinterpret_cast<uint8_t(*)[VBYTES]>(v_st);
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
  const int row0 = blockIdx.y * MQ + warp * 16 + g;  // and row0 + 8
  const int npad = (n + MK - 1) / MK * MK;

  const uint8_t* kb = k8 + b * ks.b + h * ks.h;
  const uint8_t* vt = static_cast<const uint8_t*>(v) +
                      static_cast<long long>(bh) * D_ * npad;  // pv8
  const T* vb = static_cast<const T*>(v) + b * vs.b + h * vs.h;
  const float* skb = SCALES ? sk + static_cast<long long>(bh) * n : nullptr;
  // 16-byte chunks of a K row (and, pv8, of a V^T row's 64 keys: 4) a
  // thread stages: D_ / 64 of each
  constexpr int KC = D_ / 16;
  auto stage = [&](int tile, int buf) {
    // 64 rows x KC chunks of 16 bytes: D_ / 64 each
#pragma unroll
    for (int rep = 0; rep < D_ / 64; ++rep) {
      const int i = threadIdx.x + rep * 32 * WARPS;
      const int j = i >> ilog2(KC);
      const int c = (i & (KC - 1)) * 16;
      const int key = tile * MK + j;
      const long long src = static_cast<long long>(min(key, n - 1));
      cp_async16(&k_sm[buf][j][c], kb + src * ks.n + c, key < n ? 16 : 0);
    }
    const int i = threadIdx.x;
    if constexpr (PV8) {  // d row j, keys tile*64 + c.. (N_pad is in range)
#pragma unroll
      for (int rep = 0; rep < D_ / 64; ++rep) {
        const int j = (i >> 2) + rep * 64;
        const int c = (i & 3) * 16;
        cp_async16(&v_sm[buf][j * LD8 + c],
                   vt + static_cast<long long>(j) * npad + tile * MK + c, 16);
      }
    } else if constexpr (F32V) {  // 64 keys x D_ / 4 chunks of 4 floats
      float(*vsm)[D_] = reinterpret_cast<float(*)[D_]>(v_sm[buf]);
      for (int e = i; e < MK * (D_ / 4); e += 32 * WARPS) {
        const int j = e >> ilog2(D_ / 4);
        const int c = (e & (D_ / 4 - 1)) * 4;
        const int key = tile * MK + j;
        const long long src = static_cast<long long>(min(key, n - 1));
        cp_async16(&vsm[j][c], vb + src * vs.n + c, key < n ? 16 : 0);
      }
    } else {
      bf16(*vsm)[LDV] = reinterpret_cast<bf16(*)[LDV]>(v_sm[buf]);
      for (int e = i; e < MK * (D_ / 8); e += 32 * WARPS) {
        const int j = e >> ilog2(D_ / 8);
        const int c = (e & (D_ / 8 - 1)) * 8;
        const int key = tile * MK + j;
        const long long src = static_cast<long long>(min(key, n - 1));
        cp_async16(&vsm[j][c], vb + src * vs.n + c, key < n ? 16 : 0);
      }
    }
    if constexpr (SCALES) {
      if (i < MK) {
        const int key = tile * MK + i;
        sk_sm[buf][i] = key < n ? skb[key] : 0.f;
      }
    }
    cp_async_commit();
  };

  const int n_tiles = (n_real + MK - 1) / MK;
  // QSM: the block's q rows, after the K and V buffers, with tile 0's
  // copy group
  uint8_t(*q_sm)[LDK] =
      reinterpret_cast<uint8_t(*)[LDK]>(q8_dyn + 2 * MK * LDK + 2 * VBYTES);
  if constexpr (QSM) {
    const uint8_t* qb = q8 + b * qs.b + h * qs.h;
    for (int i = threadIdx.x; i < MQ * KC; i += 32 * WARPS) {
      const int j = i >> ilog2(KC);
      const int c = (i & (KC - 1)) * 16;
      const int row = blockIdx.y * MQ + j;
      cp_async16(&q_sm[j][c],
                 qb + static_cast<long long>(min(row, n - 1)) * qs.n + c,
                 row < n ? 16 : 0);
    }
  }
  stage(0, 0);

  // this warp's 16 rows, k-steps of 32 over d (QSM: read in the loop)
  uint32_t qf[QSM ? 1 : D_ / 32][4];
  if constexpr (!QSM)
    load_row_frags8(qf, q8 + b * qs.b + h * qs.h, qs.n, row0, n, t);
  float rs[2] = {sl, sl};  // per-row score scale: sq * sl (int8) or sl
  if constexpr (SCALES) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rs[r] = qsl[static_cast<long long>(bh) * n + min(row0 + 8 * r, n - 1)];
  }

  float o[D_ / 8][4];
  int oi[MODE == MIX8 ? D_ / 8 : 1][4];  // MIX8: the int32 p8.v8 totals
#pragma unroll
  for (int dt = 0; dt < D_ / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
  for (int dt = 0; dt < (MODE == MIX8 ? D_ / 8 : 1); ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oi[dt][e] = 0;
  constexpr float M0 = MODE == FP8NOEXP ? NOEXP_SHIFT : NEG_INF;
  float m[2] = {M0, M0};    // rows g and g+8
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage(it + 1, buf ^ 1);  // the buffer the previous iteration freed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every warp
    const int base = it * MK;

    // scores: 16 rows x 64 keys = 8 n-tiles; one ldmatrix.x4 brings K for
    // one n-tile and two k-steps (64 of its D_ bytes)
    float s[8][4];
    if constexpr (QSM) {
      // the same products in the same order, q's two k-steps of each 64
      // bytes read once for all n-tiles
      int c[INT8 ? 8 : 1][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = 0.f;
          if constexpr (INT8) c[nt][e] = 0;
        }
#pragma unroll
      for (int half = 0; half < D_ / 64; ++half) {
        uint32_t qa[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x)
          ldmatrix_x4(qa[x], &q_sm[warp * 16 + (li & 1) * 8 + lr]
                                  [(2 * half + x) * 32 + (li >> 1) * 16]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t kf[4];
          ldmatrix_x4(kf, &k_sm[buf][nt * 8 + lr][half * 64 + li * 16]);
          if constexpr (INT8) {
            mma_s8(c[nt], qa[0], kf[0], kf[1]);
            mma_s8(c[nt], qa[1], kf[2], kf[3]);
          } else {
            mma_e4m3(s[nt], qa[0], kf[0], kf[1]);
            mma_e4m3(s[nt], qa[1], kf[2], kf[3]);
          }
        }
      }
      if constexpr (INT8) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = __int2float_rn(c[nt][e]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if constexpr (INT8) {
          int c[4] = {0, 0, 0, 0};
#pragma unroll
          for (int half = 0; half < D_ / 64; ++half) {
            uint32_t kf[4];
            ldmatrix_x4(kf, &k_sm[buf][nt * 8 + lr][half * 64 + li * 16]);
            mma_s8(c, qf[2 * half], kf[0], kf[1]);
            mma_s8(c, qf[2 * half + 1], kf[2], kf[3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = __int2float_rn(c[e]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
          for (int half = 0; half < D_ / 64; ++half) {
            uint32_t kf[4];
            ldmatrix_x4(kf, &k_sm[buf][nt * 8 + lr][half * 64 + li * 16]);
            mma_e4m3(s[nt], qf[2 * half], kf[0], kf[1]);
            mma_e4m3(s[nt], qf[2 * half + 1], kf[2], kf[3]);
          }
        }
      }
    }

    // probabilities: fp32 p into the sums and then 8-bit or bf16 into P's
    // A operand, or (SM16) bf16 p straight into the bf16 fragments pf16
    float p[8][4];
    uint32_t pf16[4][4];
    if constexpr (SM16) {
      softmax_bf16<MODE != FP8NOMASK>(s, sl, base, n_real, t, m, l, o, pf16);
    } else if constexpr (MODE == MIX8) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[nt][e] = exp2f(__fsub_rn(__fmul_rn(s[nt][e], 1e-4f), 1.f));
    } else {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          // the rounded products of _attn_body(_q8), never fused into an fma
          float x = __fmul_rn(s[nt][e], rs[e >> 1]);
          if constexpr (SCALES) x = __fmul_rn(x, sk_sm[buf][col]);
          x = base + col < n_real ? x : NEG_INF;
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      if constexpr (MODE != FP8NOEXP) {  // the running max and correction
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] = __fmul_rn(l[r], corr[r]);
        }
#pragma unroll
        for (int dt = 0; dt < D_ / 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[dt][e] = __fmul_rn(o[dt][e], corr[e >> 1]);
      }

#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] - m[e >> 1];
          // p in [0, 127]: the rig's fixed p scale, rounded twice as its
          // (s - m) + 6.9886
          if constexpr (MODE == INT8_RIG) x = x + P127_SHIFT;
          p[nt][e] = exp2f(x);
          l[e >> 1] += p[nt][e];
        }
    }

    if constexpr (PV8) {
      // two k-steps of 32 keys; n-tiles 4j..4j+3 form k-step j
      uint32_t pf[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t x[4][4];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv = p[4 * j + nn][e];
            if constexpr (MODE == INT8_RIG)
              x[nn][e] = to_s8(pv);
            else if constexpr (MODE == MIX8)
              x[nn][e] = to_s8_sat(__fmul_rn(pv, 127.f));
            else
              x[nn][e] = INT8 ? to_s8(__fmul_rn(pv, 127.f)) : prob_to_e4m3(pv);
          }
        pack_a(pf[j], x);
      }
      // acc += P . V over this tile, from zero; V^T rows are d, one
      // ldmatrix.x4 brings one d n-tile for both k-steps
#pragma unroll
      for (int dt = 0; dt < D_ / 8; ++dt) {
        uint32_t vf[4];
        ldmatrix_x4(vf, &v_sm[buf][(dt * 8 + lr) * LD8 + li * 16]);
        if constexpr (MODE == MIX8) {
          mma_s8(oi[dt], pf[0], vf[0], vf[1]);
          mma_s8(oi[dt], pf[1], vf[2], vf[3]);
        } else if constexpr (INT8) {
          int c[4] = {0, 0, 0, 0};
          mma_s8(c, pf[0], vf[0], vf[1]);
          mma_s8(c, pf[1], vf[2], vf[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dt][e] += __int2float_rn(c[e]);
        } else {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_e4m3(c, pf[0], vf[0], vf[1]);
          mma_e4m3(c, pf[1], vf[2], vf[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dt][e] += c[e];
        }
      }
    } else if constexpr (F32V) {
      // acc += P . V in fp32, p unrounded: key 8 nt + 2 tt + c of this
      // row lies at thread tt of the quad, as p[nt][c] (row g) and
      // p[nt][2 + c] (row g + 8); V rows are broadcasts in shared memory
      const float(*vsm)[D_] = reinterpret_cast<const float(*)[D_]>(v_sm[buf]);
      const int quad = lane & ~3;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int tt = 0; tt < 4; ++tt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p0 = __shfl_sync(0xffffffffu, p[nt][c], quad | tt);
            const float p1 =
                __shfl_sync(0xffffffffu, p[nt][2 + c], quad | tt);
            const float* vr = &vsm[nt * 8 + 2 * tt + c][2 * t];
#pragma unroll
            for (int dt = 0; dt < D_ / 8; ++dt) {
              const float2 x = *reinterpret_cast<const float2*>(vr + dt * 8);
              o[dt][0] = fmaf(p0, x.x, o[dt][0]);
              o[dt][1] = fmaf(p0, x.y, o[dt][1]);
              o[dt][2] = fmaf(p1, x.x, o[dt][2]);
              o[dt][3] = fmaf(p1, x.y, o[dt][3]);
            }
          }
    } else {
      // bf16 P.V as in attention_fwd.cu: n-tiles 2j and 2j+1 of the scores
      // form k-step j of P; one ldmatrix.x4.trans brings V for one k-step
      // and two d n-tiles
      if constexpr (!SM16) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          pf16[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[nt][0], p[nt][1]);
          pf16[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[nt][2], p[nt][3]);
        }
      }
      bf16(*vsm)[LDV] = reinterpret_cast<bf16(*)[LDV]>(v_sm[buf]);
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
#pragma unroll
        for (int dp = 0; dp < D_ / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(
              vf, &vsm[kj * 16 + (li & 1) * 8 + lr][dp * 16 + (li >> 1) * 8]);
          mma_16816(o[2 * dp], pf16[kj], vf[0], vf[1]);
          mma_16816(o[2 * dp + 1], pf16[kj], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (MODE == MIX8) {  // the int32 totals, converted once
#pragma unroll
    for (int dt = 0; dt < D_ / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = __int2float_rn(oi[dt][e]);
    l[0] = l[1] = 1.f;
  }
  if constexpr (MODE == QK8PV8 || MODE == INT8_RIG) {  // acc sv127, once
    const float* svb = sv127 + static_cast<long long>(bh) * D_;
#pragma unroll
    for (int dt = 0; dt < D_ / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[dt][e] = __fmul_rn(o[dt][e], svb[dt * 8 + 2 * t + (e & 1)]);
  }
  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    T* orow = ob + static_cast<long long>(row) * os.n + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D_ / 8; ++dt) {
      // stored in place, not through an overloaded helper: the helper
      // changes the bf16 instances' SASS
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(orow + dt * 8) =
            make_float2(o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
    }
    if (lse != nullptr && t == 0)
      lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
  }
}

// grid (B*H, ceil(N / 128)) on `stream`; returns cudaGetLastError(). The
// arguments are those of the C entries of attention_fwd_q8.cu; out (and v
// where it is not 8-bit) of element type T.
template <int MODE, typename T = bf16, int D_ = D>
int launch_q8(const void* q8, const void* k8, const float* qsl, const float* sk,
              const void* v, const float* sv127, void* out, float* lse,
              int batch, int n, int heads, int n_real, const long long* st,
              float sl, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(batch * heads, (n + MQ - 1) / MQ);
  constexpr bool PV8 = MODE == QK8PV8 || MODE == FP8PV8 || MODE == INT8_RIG ||
                       MODE == MIX8;
  constexpr int smem = q8_smem_bytes(PV8, !PV8 && sizeof(T) == 4, D_);
  // once an instance, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  if (smem > 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        attn_fwd_q8_kernel<MODE, T, D_>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  attn_fwd_q8_kernel<MODE, T, D_><<<grid, 32 * WARPS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q8), static_cast<const uint8_t*>(k8), qsl, sk,
      v, sv127, static_cast<T*>(out), lse, n, n_real, heads, qs, ks, vs, os,
      sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
