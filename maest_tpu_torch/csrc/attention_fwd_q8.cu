// 8-bit attention forward for Hopper (sm_90a), head_dim 64: the int8 modes
// qk8 / qk8pv8 (K5) and the e4m3 modes fp8 / fp8pv8 (K6).
//
// Replaces maest_tpu/ops/attention.py::_attn_kernel_q8 + _attn_body_q8
// (K5, called from _flash_fwd_lse with quant "qk8" / "qk8pv8") and
// _attn_kernel + _attn_body run on e4m3 operands (K6, quant "fp8" /
// "fp8pv8"). As there, the quantization runs before the kernel, in
// PyTorch (ops/attention.py, quantize_fwd_q8): per-row int8 q and k with
// fp32 scales, the per-column int8 v scale sv, the e4m3 casts. The kernel
// computes, per query row, over 64-key tiles:
//
//   s = (s_int * (sq * sl)) * sk       int8: exact int32 q8.k8, per-row /
//                                      per-key scales (sl = scale log2 e)
//   s = (q8.k8) * sl                   e4m3: fp32 accumulation
//   keys >= n_real: s = -1e30; online softmax in the log2 domain (m, l fp32)
//   qk8:    acc = acc corr + bf16(p) . v           (v bf16)
//   qk8pv8: acc = acc corr + int32(round(p 127) . v8); out acc (sv / 127) / l
//   fp8:    acc = acc corr + bf16(p) . v
//   fp8pv8: acc = acc corr + e4m3(p) . e4m3(v)      (fp32 accumulation)
//
// with the output divided by l at the end and lse = m + log2(l) when asked
// for (the training forward). p is rounded relative to the running max of
// the tiles seen so far, so the result depends on the key tiling; the
// plain version (attention_q8_reference) walks the same 64-key tiles.
//
// What bounds it on the H100: at the tagging shape (32, 1676, 12, 64) the
// two products take 0.209 ms at the data-sheet rates in qk8 / fp8 (8-bit
// q.k, bf16 p.v) and 0.140 ms in the pv8 modes; the N^2 exp2 of the
// softmax run on the special-function units at 16 a clock per SM, ~0.27 ms
// at 1.8-2.0 GHz, which is above the 8-bit tensor-core time. So this kernel
// cannot beat the bf16 one (attention_fwd.cu) by much at head_dim 64: the
// exponentials bound both. Device memory is far from binding (~0.07 ms).
//
// Design: the bf16 kernel's (8 warps x 16 query rows a block, key / value
// tiles of 64 double-buffered with cp.async, the score accumulator reused
// as the A operand of P.V in registers), with mma.sync m16n8k32 for every
// 8-bit product. K tiles are (key, 64-byte) rows read by ldmatrix; in the
// pv8 modes V arrives transposed, (64, N_pad) bytes with the sequence in
// the seq_pos order of mma_8bit.cuh, so the score accumulator packs into
// P's A fragment without a shuffle. int8 P.V sums each tile in int32 from
// zero and adds it to the fp32 accumulator, as the TPU kernel does per key
// block; e4m3 P.V does the same in fp32.

#include "mma_8bit.cuh"

namespace {

using namespace maest;

enum Mode { QK8 = 0, QK8PV8 = 1, FP8 = 2, FP8PV8 = 3 };

constexpr int WARPS = 8;
constexpr int MQ = 16 * WARPS;  // query rows per block
constexpr int MK = 64;          // keys per shared-memory tile
constexpr int LD = D + 8;       // bf16 shared-memory row (144 bytes)

template <int MODE>
__global__ void __launch_bounds__(32 * WARPS, 2)
attn_fwd_q8_kernel(const uint8_t* __restrict__ q8, const uint8_t* __restrict__ k8,
                   const float* __restrict__ qsl, const float* __restrict__ sk,
                   const void* __restrict__ v, const float* __restrict__ sv127,
                   bf16* __restrict__ out, float* __restrict__ lse, int n,
                   int n_real, int heads, Strides qs, Strides ks, Strides vs,
                   Strides os, float sl) {
  constexpr bool INT8 = MODE == QK8 || MODE == QK8PV8;
  constexpr bool PV8 = MODE == QK8PV8 || MODE == FP8PV8;
  // V: bf16 (key, d) rows, or 8-bit transposed (d, key) rows
  constexpr int VBYTES = PV8 ? D * LD8 : MK * LD * 2;
  __shared__ __align__(128) uint8_t k_sm[2][MK][LD8];
  __shared__ __align__(128) uint8_t v_sm[2][VBYTES];
  __shared__ float sk_sm[2][MK];

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
                      static_cast<long long>(bh) * D * npad;  // pv8
  const bf16* vb = static_cast<const bf16*>(v) + b * vs.b + h * vs.h;
  const float* skb = INT8 ? sk + static_cast<long long>(bh) * n : nullptr;
  auto stage = [&](int tile, int buf) {
    const int i = threadIdx.x;  // 64 rows x 4 chunks of 16 bytes: one each
    {
      const int j = i >> 2;
      const int c = (i & 3) * 16;
      const int key = tile * MK + j;
      const long long src = static_cast<long long>(min(key, n - 1));
      cp_async16(&k_sm[buf][j][c], kb + src * ks.n + c, key < n ? 16 : 0);
    }
    if constexpr (PV8) {  // d row j, keys tile*64 + c.. (N_pad is in range)
      const int j = i >> 2;
      const int c = (i & 3) * 16;
      cp_async16(&v_sm[buf][j * LD8 + c],
                 vt + static_cast<long long>(j) * npad + tile * MK + c, 16);
    } else {
      bf16(*vsm)[LD] = reinterpret_cast<bf16(*)[LD]>(v_sm[buf]);
      for (int e = i; e < MK * (D / 8); e += 32 * WARPS) {
        const int j = e >> 3;
        const int c = (e & 7) * 8;
        const int key = tile * MK + j;
        const long long src = static_cast<long long>(min(key, n - 1));
        cp_async16(&vsm[j][c], vb + src * vs.n + c, key < n ? 16 : 0);
      }
    }
    if constexpr (INT8) {
      if (i < MK) {
        const int key = tile * MK + i;
        sk_sm[buf][i] = key < n ? skb[key] : 0.f;
      }
    }
    cp_async_commit();
  };

  const int n_tiles = (n_real + MK - 1) / MK;
  stage(0, 0);

  uint32_t qf[2][4];  // this warp's 16 rows, 2 k-steps of 32 over d
  load_row_frags8(qf, q8 + b * qs.b + h * qs.h, qs.n, row0, n, t);
  float rs[2] = {sl, sl};  // per-row score scale: sq * sl (int8) or sl
  if constexpr (INT8) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rs[r] = qsl[static_cast<long long>(bh) * n + min(row0 + 8 * r, n - 1)];
  }

  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g+8
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

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
    // one n-tile and both k-steps
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t kf[4];
      ldmatrix_x4(kf, &k_sm[buf][nt * 8 + lr][li * 16]);
      if constexpr (INT8) {
        int c[4] = {0, 0, 0, 0};
        mma_s8(c, qf[0], kf[0], kf[1]);
        mma_s8(c, qf[1], kf[2], kf[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = __int2float_rn(c[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        mma_e4m3(s[nt], qf[0], kf[0], kf[1]);
        mma_e4m3(s[nt], qf[1], kf[2], kf[3]);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        // the rounded products of _attn_body(_q8), never fused into an fma
        float x = __fmul_rn(s[nt][e], rs[e >> 1]);
        if constexpr (INT8) x = __fmul_rn(x, sk_sm[buf][col]);
        x = base + col < n_real ? x : NEG_INF;
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
      l[r] = __fmul_rn(l[r], corr[r]);
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = __fmul_rn(o[dt][e], corr[e >> 1]);

    // probabilities: fp32 into the sums, 8-bit or bf16 into P's A operand
    float p[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p[nt][e];
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
            x[nn][e] = INT8 ? to_s8(__fmul_rn(pv, 127.f)) : prob_to_e4m3(pv);
          }
        pack_a(pf[j], x);
      }
      // acc += P . V over this tile, from zero; V^T rows are d, one
      // ldmatrix.x4 brings one d n-tile for both k-steps
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t vf[4];
        ldmatrix_x4(vf, &v_sm[buf][(dt * 8 + lr) * LD8 + li * 16]);
        if constexpr (INT8) {
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
    } else {
      // bf16 P.V as in attention_fwd.cu: n-tiles 2j and 2j+1 of the scores
      // form k-step j of P; one ldmatrix.x4.trans brings V for one k-step
      // and two d n-tiles
      uint32_t pf[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[nt][0], p[nt][1]);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[nt][2], p[nt][3]);
      }
      bf16(*vsm)[LD] = reinterpret_cast<bf16(*)[LD]>(v_sm[buf]);
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(
              vf, &vsm[kj * 16 + (li & 1) * 8 + lr][dp * 16 + (li >> 1) * 8]);
          mma_16816(o[2 * dp], pf[kj], vf[0], vf[1]);
          mma_16816(o[2 * dp + 1], pf[kj], vf[2], vf[3]);
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
  if constexpr (MODE == QK8PV8) {  // acc (sv / 127), once, after the loop
    const float* svb = sv127 + static_cast<long long>(bh) * D;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[dt][e] = __fmul_rn(o[dt][e], svb[dt * 8 + 2 * t + (e & 1)]);
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
    if (lse != nullptr && t == 0)
      lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
  }
}

template <int MODE>
int launch(const void* q8, const void* k8, const float* qsl, const float* sk,
           const void* v, const float* sv127, void* out, float* lse, int batch,
           int n, int heads, int n_real, const long long* st, float sl,
           void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(batch * heads, (n + MQ - 1) / MQ);
  attn_fwd_q8_kernel<MODE><<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q8), static_cast<const uint8_t*>(k8), qsl, sk,
      v, sv127, static_cast<bf16*>(out), lse, n, n_real, heads, qs, ks, vs, os,
      sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q8, k8: (batch, n, heads, 64) int8 (qk8*) or e4m3 (fp8*) with element
// strides strides[0..5] and 16-byte rows; qsl, sk: contiguous fp32
// (batch, heads, n) of sq * sl and sk (int8 modes, else nullptr); v: the
// bf16 (batch, n, heads, 64) view with strides[6..8] (qk8, fp8) or the
// contiguous (batch * heads, 64, round_up(n, 64)) transposed 8-bit copy in
// seq_pos order (pv8 modes); sv127: contiguous fp32 (batch, heads, 64) of
// sv / 127 (qk8pv8, else nullptr); out: bf16 (batch, n, heads, 64) with
// strides[9..11]; lse: nullptr or contiguous fp32 (batch, heads, n).
// sl = head_dim^-0.5 * log2(e). 1 <= n_real <= n. Launches on `stream`;
// returns cudaGetLastError().
#define MAEST_FWD_Q8(NAME, MODE)                                               \
  int NAME(const void* q8, const void* k8, const float* qsl, const float* sk, \
           const void* v, const float* sv127, void* out, float* lse,          \
           int batch, int n, int heads, int n_real, const long long* strides, \
           float sl, void* stream) {                                          \
    return launch<MODE>(q8, k8, qsl, sk, v, sv127, out, lse, batch, n, heads, \
                        n_real, strides, sl, stream);                         \
  }

MAEST_FWD_Q8(maest_attn_fwd_qk8, QK8)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8, QK8PV8)
MAEST_FWD_Q8(maest_attn_fwd_fp8, FP8)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8, FP8PV8)

}  // extern "C"
