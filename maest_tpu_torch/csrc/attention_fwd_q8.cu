// 8-bit attention forward for Hopper (sm_90a), head_dim 64, 128 and 256, and
// any multiple of 64 above (the _dn entries): the int8 modes qk8 / qk8pv8
// (K5) and the e4m3 modes fp8 / fp8pv8 (K6).
//
// The bf16 entries at head_dim 64 (maest_attn_fwd_qk8, _qk8pv8, _fp8,
// _fp8pv8: the route of the port's tagging and training paths) run the
// wgmma / TMA kernel of attn_fwd_q8_wgmma.cuh behind its own CUDA
// quantisation pass, over 128-key tiles; the mma.sync kernel below stays
// beside them as their control (the *_mma entries) and runs every other
// instance (fp32, head_dim 128, 256 and the _dn widths).
//
// Replaces maest_tpu/ops/attention.py::_attn_kernel_q8 + _attn_body_q8
// (K5, called from _flash_fwd_lse with quant "qk8" / "qk8pv8") and
// _attn_kernel + _attn_body run on e4m3 operands (K6, quant "fp8" /
// "fp8pv8"). For the mma.sync instances, as there, the quantization runs
// before the kernel, in PyTorch (ops/attention.py _launch_fwd_q8):
// per-row int8 q and k with fp32 scales, the per-column int8 v scale sv,
// the e4m3 casts. The kernel computes, per query row, over 64-key tiles:
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
// plain version (attention_q8_reference) walks the same 64-key tiles
// (block_k Q8_BLOCK_K) for these instances, and 128-key tiles for the
// wgmma route's.
//
// What bounds it on the H100: at the tagging shape (32, 1676, 12, 64) the
// two products take 0.209 ms at the data-sheet rates in qk8 / fp8 (8-bit
// q.k, bf16 p.v) and 0.140 ms in the pv8 modes; the N^2 exp2 of the
// softmax run on the special-function units at 16 a clock per SM, ~0.27 ms
// at 1.8-2.0 GHz, which is above the 8-bit tensor-core time. So this kernel
// cannot beat the bf16 one (attention_fwd.cu) by much at head_dim 64: the
// exponentials bound both. Device memory is far from binding (~0.07 ms).
//
// fp32 tier (the *_fp32 entries): q and k quantized from fp32 in the same
// way; qk8 and fp8 multiply fp32 v by unrounded p in scalar fp32 FMA,
// which bounds them as it bounds the fp32 K2 (67 TFLOP/s); qk8pv8 and
// fp8pv8 run the bf16 instances' 8-bit products and write fp32.
//
// Design of the mma.sync kernel: the bf16 kernel's (8 warps x 16 query
// rows a block, key / value tiles of 64 double-buffered with cp.async, the
// score accumulator reused as the A operand of P.V in registers), with
// mma.sync m16n8k32 for every 8-bit product. K tiles are (key, 64-byte)
// rows read by ldmatrix; in the pv8 modes V arrives transposed, (64,
// N_pad) bytes with the sequence in the seq_pos order of mma_8bit.cuh, so
// the score accumulator packs into P's A fragment without a shuffle. int8
// P.V sums each tile in int32 from zero and adds it to the fp32
// accumulator, as the TPU kernel does per key block; e4m3 P.V does the
// same in fp32.

#include "attn_fwd_q8.cuh"  // the kernel template (modes QK8..FP8PV8)
#include "attn_fwd_q8_wgmma.cuh"  // the bf16 route at head_dim 64

namespace {

using namespace maest;

// ---------------------------------------------------------- any width ---
// head_dim above 256 (the _dn entries): the width dp, zero-padded by the
// caller to a multiple of CH = 64, is an argument, so no register or
// shared-memory size grows with it (the design of the bf16 and fp32 _dn
// kernels, attention_fwd.cu). Grid (B*H, ceil(N / 128), dp / 64): a block
// of the template's 8 warps x 16 query rows walks the 64-key tiles below
// n_real; for each it stages K's 64-byte chunks in turn (q's fragments of
// the chunk read from global memory) and sums the scores over them (int32
// in the int8 modes, exact; fp32 in the e4m3 ones, k-step after k-step in
// the template's order), runs the template's softmax step on the tile,
// then stages the tile's V for the block's 64 output columns and adds P.V
// as the template does. Every slice recomputes the scores over the full
// dp (dp / 64 times at each width); only slice 0 writes lse. Two staged
// tiles alternate (cp.async, one commit group a tile).

// bytes of a staged tile: K's chunk (64 keys x 64 bytes) or V's slice:
// 8-bit transposed (64 d rows x 64 keys), fp32 (64 keys x 64) or bf16 (64
// keys x 64, padded rows)
__host__ __device__ constexpr int q8_dn_tile_bytes(bool pv8, bool f32v) {
  return pv8 ? MK * LD8
             : (f32v ? MK * CH * 4
                     : (MK * ld_bf16(CH) * 2 > MK * LD8 ? MK * ld_bf16(CH) * 2
                                                        : MK * LD8));
}

template <int MODE, typename T>
__global__ void __launch_bounds__(32 * WARPS, 1)
attn_fwd_q8_dn_kernel(const uint8_t* __restrict__ q8,
                      const uint8_t* __restrict__ k8,
                      const float* __restrict__ qsl,
                      const float* __restrict__ sk,
                      const void* __restrict__ v,
                      const float* __restrict__ sv127, T* __restrict__ out,
                      float* __restrict__ lse, int n, int n_real, int heads,
                      int dp, Strides qs, Strides ks, Strides vs, Strides os,
                      float sl) {
  constexpr bool INT8 = MODE == QK8 || MODE == QK8PV8;  // with scales
  constexpr bool PV8 = MODE == QK8PV8 || MODE == FP8PV8;
  constexpr bool F32V = !PV8 && sizeof(T) == 4;  // fp32 v, scalar P.V
  constexpr int LDV = ld_bf16(CH);
  __shared__ __align__(128) uint8_t tile[2][q8_dn_tile_bytes(PV8, F32V)];

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
  const int c0 = blockIdx.z * CH;                    // this block's columns
  const int nch = dp / CH;                           // K chunks a key tile
  const int steps = nch + 1;                         // and V's slice
  const int total = (n_real + MK - 1) / MK * steps;
  const int npad = (n + MK - 1) / MK * MK;
  const uint8_t* qb = q8 + b * qs.b + h * qs.h;
  const uint8_t* kb = k8 + b * ks.b + h * ks.h;
  const uint8_t* vt = static_cast<const uint8_t*>(v) +
                      static_cast<long long>(bh) * dp * npad;  // pv8
  const T* vb = static_cast<const T*>(v) + b * vs.b + h * vs.h;
  const float* skb = INT8 ? sk + static_cast<long long>(bh) * n : nullptr;

  // step j: chunk c < nch of key tile j / steps from K, else V's slice
  auto stage = [&](int j, int buf) {
    const int it = j / steps;
    const int c = j - it * steps;
    const int i = threadIdx.x;
    if (c < nch) {  // 64 keys x 4 pieces of 16 bytes: one a thread
      uint8_t(*kt)[LD8] = reinterpret_cast<uint8_t(*)[LD8]>(tile[buf]);
      const int key = it * MK + (i >> 2);
      cp_async16(&kt[i >> 2][(i & 3) * 16],
                 kb + static_cast<long long>(min(key, n - 1)) * ks.n + c * CH +
                     (i & 3) * 16,
                 key < n ? 16 : 0);
    } else if constexpr (PV8) {  // d row c0 + (i >> 2), the tile's keys
      uint8_t(*vtt)[LD8] = reinterpret_cast<uint8_t(*)[LD8]>(tile[buf]);
      cp_async16(&vtt[i >> 2][(i & 3) * 16],
                 vt + static_cast<long long>(c0 + (i >> 2)) * npad + it * MK +
                     (i & 3) * 16,
                 16);
    } else if constexpr (F32V) {  // 64 keys x 16 pieces of 4 floats
      float(*vsm)[CH] = reinterpret_cast<float(*)[CH]>(tile[buf]);
      for (int e = i; e < MK * (CH / 4); e += 32 * WARPS) {
        const int key = it * MK + (e >> 4);
        cp_async16(&vsm[e >> 4][(e & 15) * 4],
                   vb + static_cast<long long>(min(key, n - 1)) * vs.n + c0 +
                       (e & 15) * 4,
                   key < n ? 16 : 0);
      }
    } else {  // 64 keys x 8 pieces of 8 bf16
      bf16(*vsm)[LDV] = reinterpret_cast<bf16(*)[LDV]>(tile[buf]);
      for (int e = i; e < MK * (CH / 8); e += 32 * WARPS) {
        const int key = it * MK + (e >> 3);
        cp_async16(&vsm[e >> 3][(e & 7) * 8],
                   vb + static_cast<long long>(min(key, n - 1)) * vs.n + c0 +
                       (e & 7) * 8,
                   key < n ? 16 : 0);
      }
    }
    cp_async_commit();
  };

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
  float s[8][4];
  int si[INT8 ? 8 : 1][4];          // int8: the exact int32 scores
  float p[F32V ? 8 : 1][4];         // fp32 v: p unrounded for P.V
  uint32_t pf16[4][4], pf8[2][4];   // P's bf16 or 8-bit A fragments

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
          for (int e = 0; e < 4; ++e) {
            s[nt][e] = 0.f;
            if constexpr (INT8) si[nt][e] = 0;
          }
      }
      uint32_t qf[2][4];
      load_row_frags8(qf, qb + c * CH, qs.n, row0, n, t);
      const uint8_t(*kt)[LD8] = reinterpret_cast<const uint8_t(*)[LD8]>(tile[buf]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &kt[nt * 8 + lr][li * 16]);
        if constexpr (INT8) {
          mma_s8(si[nt], qf[0], kf[0], kf[1]);
          mma_s8(si[nt], qf[1], kf[2], kf[3]);
        } else {
          mma_e4m3(s[nt], qf[0], kf[0], kf[1]);
          mma_e4m3(s[nt], qf[1], kf[2], kf[3]);
        }
      }
      if (c == nch - 1) {  // the template's softmax step over this key tile
        const int base = it * MK;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nt * 8 + 2 * t + (e & 1);
            if constexpr (INT8) s[nt][e] = __int2float_rn(si[nt][e]);
            // the rounded products of _attn_body(_q8), never fused
            float x = __fmul_rn(s[nt][e], rs[e >> 1]);
            if constexpr (INT8)
              x = __fmul_rn(x, skb[min(base + col, n - 1)]);
            x = base + col < n_real ? x : NEG_INF;
            s[nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
          for (int e = 0; e < 4; ++e)
            o[dt][e] = __fmul_rn(o[dt][e], corr[e >> 1]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = exp2f(s[nt][e] - m[e >> 1]);
            s[nt][e] = x;
            l[e >> 1] += x;
            if constexpr (F32V) p[nt][e] = x;
          }
        if constexpr (PV8) {  // two k-steps of 32 keys (n-tiles 4j..4j+3)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t x[4][4];
#pragma unroll
            for (int nn = 0; nn < 4; ++nn)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float pv = s[4 * jj + nn][e];
                x[nn][e] = INT8 ? to_s8(__fmul_rn(pv, 127.f)) : prob_to_e4m3(pv);
              }
            pack_a(pf8[jj], x);
          }
        } else if constexpr (!F32V) {
          chunk_frags(pf16, s);
        }
      }
    } else if constexpr (PV8) {  // o += P8 . V8 of this tile, from zero
      const uint8_t(*vtt)[LD8] =
          reinterpret_cast<const uint8_t(*)[LD8]>(tile[buf]);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t vf[4];
        ldmatrix_x4(vf, &vtt[dt * 8 + lr][li * 16]);
        if constexpr (INT8) {
          int cc[4] = {0, 0, 0, 0};
          mma_s8(cc, pf8[0], vf[0], vf[1]);
          mma_s8(cc, pf8[1], vf[2], vf[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dt][e] += __int2float_rn(cc[e]);
        } else {
          float cc[4] = {0.f, 0.f, 0.f, 0.f};
          mma_e4m3(cc, pf8[0], vf[0], vf[1]);
          mma_e4m3(cc, pf8[1], vf[2], vf[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dt][e] += cc[e];
        }
      }
    } else if constexpr (F32V) {
      // o += P . V in fp32, p unrounded, as the template's fp32 tier: key
      // 8 nt + 2 tt + c of this row lies at thread tt of the quad
      const float(*vsm)[CH] = reinterpret_cast<const float(*)[CH]>(tile[buf]);
      const int quad = lane & ~3;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int tt = 0; tt < 4; ++tt)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float p0 = __shfl_sync(0xffffffffu, p[nt][cc], quad | tt);
            const float p1 = __shfl_sync(0xffffffffu, p[nt][2 + cc], quad | tt);
            const float* vr = &vsm[nt * 8 + 2 * tt + cc][2 * t];
#pragma unroll
            for (int dt = 0; dt < 8; ++dt) {
              const float2 x = *reinterpret_cast<const float2*>(vr + dt * 8);
              o[dt][0] = fmaf(p0, x.x, o[dt][0]);
              o[dt][1] = fmaf(p0, x.y, o[dt][1]);
              o[dt][2] = fmaf(p1, x.x, o[dt][2]);
              o[dt][3] = fmaf(p1, x.y, o[dt][3]);
            }
          }
    } else {  // o += bf16(p) . V, as the template's bf16 P.V
      chunk_pv(o, pf16, reinterpret_cast<const bf16(*)[LDV]>(tile[buf]), lr,
               li);
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (MODE == QK8PV8) {  // acc sv127, once
    const float* svb = sv127 + static_cast<long long>(bh) * dp + c0;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[dt][e] = __fmul_rn(o[dt][e], svb[dt * 8 + 2 * t + (e & 1)]);
  }
  T* ob = out + b * os.b + h * os.h + c0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    T* orow = ob + static_cast<long long>(row) * os.n + 2 * t;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(orow + dt * 8) =
            make_float2(o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
    }
    if (lse != nullptr && blockIdx.z == 0 && t == 0)
      lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
  }
}

template <int MODE, typename T>
int launch_q8_dn(int dp, const void* q8, const void* k8, const float* qsl,
                 const float* sk, const void* v, const float* sv127, void* out,
                 float* lse, int batch, int n, int heads, int n_real,
                 const long long* st, float sl, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (dp <= 0 || dp % CH) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(batch * heads, (n + MQ - 1) / MQ, dp / CH);
  attn_fwd_q8_dn_kernel<MODE, T>
      <<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(q8), static_cast<const uint8_t*>(k8),
          qsl, sk, v, sv127, static_cast<T*>(out), lse, n, n_real, heads, dp,
          qs, ks, vs, os, sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The route (bf16 at head_dim 64): q, k, v bf16 (batch, n, heads, 64) views
// with element strides strides[0..8] and rows on 16-byte boundaries; out
// bf16 (batch, n, heads, 64) with strides[9..11]; lse nullptr or contiguous
// fp32 (batch, heads, n); bytes: NAME_bytes(batch, n, heads) bytes and
// scratch: NAME_scratch(batch, n, heads) floats, both uninitialised, for
// the pass's 8-bit copies and scales (attn_fwd_q8_wgmma.cuh). sl =
// head_dim^-0.5 * log2(e), 1 <= n_real <= n. Launches on `stream` (qk8pv8:
// a memset, the vmax pass, the pass, the kernel; else the pass, the
// kernel); returns the first cudaGetLastError() that is not 0.
#define MAEST_FWD_Q8W(NAME, MODE)                                              \
  int NAME(const void* q, const void* k, const void* v, void* out,            \
           float* lse, void* bytes, float* scratch, int batch, int n,         \
           int heads, int n_real, const long long* strides, float sl,         \
           void* stream) {                                                    \
    return maest::launch_fwd_q8w<maest::MODE>(q, k, v, out, lse, bytes,       \
                                              scratch, batch, n, heads,       \
                                              n_real, strides, sl, stream);   \
  }                                                                           \
  long long NAME##_scratch(int batch, int n, int heads) {                     \
    return maest::qf_scratch_floats(batch, n, heads);                         \
  }                                                                           \
  long long NAME##_bytes(int batch, int n, int heads) {                       \
    return maest::qf_bytes(maest::MODE, batch, n, heads);                     \
  }

MAEST_FWD_Q8W(maest_attn_fwd_qk8, QK8)
MAEST_FWD_Q8W(maest_attn_fwd_qk8pv8, QK8PV8)
MAEST_FWD_Q8W(maest_attn_fwd_fp8, FP8)
MAEST_FWD_Q8W(maest_attn_fwd_fp8pv8, FP8PV8)

// The route's passes alone (mode 0 qk8, 1 qk8pv8, 2 fp8, 3 fp8pv8), with
// the route's arguments but strides[0..8] (q, k, v): its 8-bit copies and
// scales into bytes and scratch, as the route's kernel reads them. For
// the checks that hold the pass to its plain version
// (ops/attention.py q8_pass_reference) and for its timing.
int maest_attn_fwd_q8w_pass(int mode, const void* q, const void* k,
                            const void* v, void* bytes, float* scratch,
                            int batch, int n, int heads,
                            const long long* strides, float sl, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const maest::Strides s[3] = {{strides[0], strides[1], strides[2]},
                               {strides[3], strides[4], strides[5]},
                               {strides[6], strides[7], strides[8]}};
  const auto* q16 = static_cast<const maest::bf16*>(q);
  const auto* k16 = static_cast<const maest::bf16*>(k);
  const auto* v16 = static_cast<const maest::bf16*>(v);
  auto* b8 = static_cast<uint8_t*>(bytes);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case maest::QK8:
      return maest::launch_fwd_q8w_pass<maest::QK8>(q16, k16, v16, b8, scratch,
                                                    batch, n, heads, s, sl, cs);
    case maest::QK8PV8:
      return maest::launch_fwd_q8w_pass<maest::QK8PV8>(
          q16, k16, v16, b8, scratch, batch, n, heads, s, sl, cs);
    case maest::FP8:
      return maest::launch_fwd_q8w_pass<maest::FP8>(q16, k16, v16, b8, scratch,
                                                    batch, n, heads, s, sl, cs);
    case maest::FP8PV8:
      return maest::launch_fwd_q8w_pass<maest::FP8PV8>(
          q16, k16, v16, b8, scratch, batch, n, heads, s, sl, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The mma.sync kernel (the route's control at bf16 head_dim 64, the *_mma
// entries, and every other instance):
// q8, k8: (batch, n, heads, 64) int8 (qk8*) or e4m3 (fp8*) with element
// strides strides[0..5] and 16-byte rows; qsl, sk: contiguous fp32
// (batch, heads, n) of sq * sl and sk (int8 modes, else nullptr); v: the
// bf16 (batch, n, heads, 64) view with strides[6..8] (qk8, fp8) or the
// contiguous (batch * heads, 64, round_up(n, 64)) transposed 8-bit copy in
// seq_pos order (pv8 modes); sv127: contiguous fp32 (batch, heads, 64) of
// sv / 127 (qk8pv8, else nullptr); out: bf16 (batch, n, heads, 64) with
// strides[9..11]; lse: nullptr or contiguous fp32 (batch, heads, n).
// sl = head_dim^-0.5 * log2(e). 1 <= n_real <= n. Launches on `stream`;
// returns cudaGetLastError(). The *_fp32 entries take fp32 v (qk8, fp8;
// rows on 16-byte boundaries) and write fp32 out. The *_d128 entries take
// head_dim 128 in place of 64 everywhere above (sv127 (batch, heads, 128),
// the transposed copy (batch * heads, 128, round_up(n, 64))), the *_d256
// entries head_dim 256 the same way.
#define MAEST_FWD_Q8(NAME, MODE, T, D_)                                        \
  int NAME(const void* q8, const void* k8, const float* qsl, const float* sk, \
           const void* v, const float* sv127, void* out, float* lse,          \
           int batch, int n, int heads, int n_real, const long long* strides, \
           float sl, void* stream) {                                          \
    return maest::launch_q8<maest::MODE, T, D_>(q8, k8, qsl, sk, v, sv127,    \
                                                out, lse, batch, n, heads,    \
                                                n_real, strides, sl, stream); \
  }

MAEST_FWD_Q8(maest_attn_fwd_qk8_mma, QK8, maest::bf16, 64)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_mma, QK8PV8, maest::bf16, 64)
MAEST_FWD_Q8(maest_attn_fwd_fp8_mma, FP8, maest::bf16, 64)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_mma, FP8PV8, maest::bf16, 64)
MAEST_FWD_Q8(maest_attn_fwd_qk8_fp32, QK8, float, 64)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_fp32, QK8PV8, float, 64)
MAEST_FWD_Q8(maest_attn_fwd_fp8_fp32, FP8, float, 64)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_fp32, FP8PV8, float, 64)
MAEST_FWD_Q8(maest_attn_fwd_qk8_d128, QK8, maest::bf16, 128)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_d128, QK8PV8, maest::bf16, 128)
MAEST_FWD_Q8(maest_attn_fwd_fp8_d128, FP8, maest::bf16, 128)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_d128, FP8PV8, maest::bf16, 128)
MAEST_FWD_Q8(maest_attn_fwd_qk8_fp32_d128, QK8, float, 128)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_fp32_d128, QK8PV8, float, 128)
MAEST_FWD_Q8(maest_attn_fwd_fp8_fp32_d128, FP8, float, 128)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_fp32_d128, FP8PV8, float, 128)
MAEST_FWD_Q8(maest_attn_fwd_qk8_d256, QK8, maest::bf16, 256)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_d256, QK8PV8, maest::bf16, 256)
MAEST_FWD_Q8(maest_attn_fwd_fp8_d256, FP8, maest::bf16, 256)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_d256, FP8PV8, maest::bf16, 256)
MAEST_FWD_Q8(maest_attn_fwd_qk8_fp32_d256, QK8, float, 256)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_fp32_d256, QK8PV8, float, 256)
MAEST_FWD_Q8(maest_attn_fwd_fp8_fp32_d256, FP8, float, 256)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_fp32_d256, FP8PV8, float, 256)

// The same entries at a head_dim dp above 256, a multiple of 64 (a head_dim
// between is zero-padded by the caller), its first argument: (batch, n,
// heads, dp) views, sv127 (batch, heads, dp), the transposed copy (batch *
// heads, dp, round_up(n, 64)). Returns cudaErrorInvalidValue for another
// dp.
#define MAEST_FWD_Q8_DN(NAME, MODE, T)                                         \
  int NAME(int dp, const void* q8, const void* k8, const float* qsl,          \
           const float* sk, const void* v, const float* sv127, void* out,     \
           float* lse, int batch, int n, int heads, int n_real,               \
           const long long* strides, float sl, void* stream) {                \
    return launch_q8_dn<maest::MODE, T>(dp, q8, k8, qsl, sk, v, sv127, out,   \
                                        lse, batch, n, heads, n_real,         \
                                        strides, sl, stream);                 \
  }

MAEST_FWD_Q8_DN(maest_attn_fwd_qk8_dn, QK8, maest::bf16)
MAEST_FWD_Q8_DN(maest_attn_fwd_qk8pv8_dn, QK8PV8, maest::bf16)
MAEST_FWD_Q8_DN(maest_attn_fwd_fp8_dn, FP8, maest::bf16)
MAEST_FWD_Q8_DN(maest_attn_fwd_fp8pv8_dn, FP8PV8, maest::bf16)
MAEST_FWD_Q8_DN(maest_attn_fwd_qk8_fp32_dn, QK8, float)
MAEST_FWD_Q8_DN(maest_attn_fwd_qk8pv8_fp32_dn, QK8PV8, float)
MAEST_FWD_Q8_DN(maest_attn_fwd_fp8_fp32_dn, FP8, float)
MAEST_FWD_Q8_DN(maest_attn_fwd_fp8pv8_fp32_dn, FP8PV8, float)

}  // extern "C"
