// The 8-bit attention forward at head_dim 64 in bf16 on Hopper's
// asynchronous machinery (sm_90a): K5 (qk8, qk8pv8) and K6 (fp8, fp8pv8),
// with and without lse, the production instances behind
// maest_attn_fwd_qk8 / _qk8pv8 / _fp8 / _fp8pv8 (attention_fwd_q8.cu),
// which keeps the mma.sync kernel of attn_fwd_q8.cuh beside them as the
// *_mma entries (the control).
//
// It computes what maest_tpu/ops/attention.py::_attn_kernel_q8 +
// _attn_body_q8 (K5) and _attn_kernel + _attn_body on e4m3 operands (K6)
// compute, with the quantisation the TPU package runs in XLA before its
// kernel (_quantize_rows, the e4m3 casts, the per-column v scale) moved
// into a CUDA pass of its own:
//
//   int8:  q8, k8 = round(x / s) half to even, s = max(amax, 1e-30) / 127
//          per row (IEEE divisions); s = (float(q8.k8) (sq sl)) sk
//   e4m3:  q8, k8 = e4m3(x) (NaN where |x| > 464); s = (q8.k8) sl, the
//          products exact and summed in fp32
//   keys >= n_real: s = -1e30; online softmax in the log2 domain
//   qk8, fp8:  acc = acc corr + bf16(p).v             (v bf16)
//   qk8pv8:    acc = acc corr + float(int32(round(p 127).v8))
//   fp8pv8:    acc = acc corr + e4m3(p).e4m3(v)     (fp32 sums)
//   out = acc (qk8pv8: (sv / 127) a column) / l; lse = m + log2(l)
//
// p is rounded against the running max of the key tiles seen so far, so
// the result depends on the key tile: this route walks tiles of QF_BK =
// 128 keys, the JAX kernel's own floor (_pick_block), and its plain
// version is attention_q8_reference with block_k 128 (ops/attention.py
// Q8_WG_BLOCK_K); the control keeps its 64-key tiles (Q8_BLOCK_K).
//
// What bounds it: at (32, 1676, 12, 64) the two products take 0.209 ms at
// the data-sheet rates in qk8 / fp8 (8-bit q.k, bf16 p.v) and 0.140 ms in
// the pv8 modes; the N^2 exp2 ~0.26 ms on the special-function units,
// which the design overlaps with the products as K2's does; in the int8
// modes as many int32 -> fp32 conversions of the scores, which run on the
// full-rate fp32 pipe here (qf_i2f), not on the quarter-rate I2F. p and
// corr are ex2.approx.ftz (qw_ex2, K7's; exp2f adds a rescale for
// arguments below -126): a p below 2^-126 flushes to 0, which changes no
// 8-bit code and no sum that holds the tile's largest p, 1. The pass is
// bound by bytes: bf16 q, k (and v in the pv8 modes) read once, the
// copies written once, 0.075-0.135 ms at that shape.
//
// e4m3 q.k on the tensor cores: e4m3 wgmma sums its products in fewer
// bits than fp32 (a k-step's sum is truncated, ~2^-13 of its largest
// term), which moved lse by up to 6e-4 from plain at (32, 866) on an
// H100, past the 1e-4 bound. The e4m3 values are bf16 values, so the
// pass writes q8 and k8 of the e4m3 modes as bf16 and S runs on bf16
// wgmma (K2's product), whose sums hold the plain version's to its
// bounds; p8.v8 of fp8pv8 stays on e4m3 wgmma, a fresh sum a tile: it
// shrinks o by ~3e-5 relative, far below a bf16 ulp of the output.
//
// Design:
//   1. (qk8pv8) vmax: max|v| per (head, column) over the sequence, by
//      atomicMax on the bits of non-negative floats (K7's amax pass:
//      order-free and exact) into a zeroed row of the scratch.
//   2. pass (attn_fwd_q8w_pass_kernel): a block takes 64 rows of one
//      head, four threads a row. It writes q8 and k8 head-major (B H,
//      N_pad, 64), N_pad = round_up(N, 128), zeros past N (int8 codes, or
//      the e4m3 values as bf16); in the int8 modes the rows qs sl and sk
//      (B H, N_pad) fp32, zeros past N; in the pv8 modes v8 transposed
//      (B H, 64, N_pad), the keys in the
//      seq_pos order of mma_8bit.cuh, so the score accumulator is the
//      register A of the next 8-bit product as it lies (K7's order).
//   3. the kernel, K2's schedule (attn_fwd_wgmma.cuh): warpgroup 0 is the
//      producer, one thread loading the block's q8 once and keeping key
//      tiles of k8 (with their sk row, a bulk copy on the same barrier)
//      and v in flight in a two-stage ring; QF_NC = 2 consumer
//      warpgroups of 64 q rows take turns to issue through named
//      barriers (three, K2's, leave 128 registers a thread, where the
//      128-key tile spills). S = Q8.K8^T on s8 wgmma (int32 sums, exact;
//      64-byte swizzle) or, e4m3 values, bf16 wgmma (fp32 sums; 128-byte
//      swizzle), both operands K-major as the planes lie. P.V: in qk8 /
//      fp8 bf16 wgmma with p packed as register A and the bf16 v view
//      through the transpose bit, accumulating into o, as K2; in the pv8
//      modes 8-bit wgmma (no transpose bit) with p8 packed as it lies
//      (pack_a) and B the transposed copy (128-byte swizzle), each tile
//      into a fresh accumulator added to o in registers (acc corr + pv,
//      the order of _attn_body_q8; in fp8pv8 this also keeps the tensor
//      core's fp32 sums to one tile). Each iteration issues the next
//      tile's S with this tile's P.V and runs the softmax under P.V.

#pragma once

#include "attn_bwd_q8_wgmma.cuh"  // s8 wgmma, 64-byte swizzle, u8 maps,
                                   // bulk copies, trapping waits; via it
                                   // TMA, mbarriers, bf16 wgmma, bf16 maps
#include "attn_fwd_q8.cuh"         // the modes QK8..FP8PV8

namespace maest {

// ---------------------------------------------------------------- PTX ---
// d (64 x 128, s32, C layout a warp) (+)= A (64 x 32, s8, shared memory,
// K-major) . B (32 x 128, s8, shared memory, K-major); scale_d 0 overwrites
__device__ __forceinline__ void wgmma_ss_s8_n128(int (&d)[16][4], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32) (+)= A (64 x 32 e4m3, registers: a warp's 16 rows as
// mma.sync's m16n8k32 A fragment, as wgmma_rs_s8_n64's) . B (32 x 64,
// e4m3, shared memory, K-major); scale_d 0 overwrites
__device__ __forceinline__ void wgmma_rs_e4m3_n64(float (&d)[8][4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ------------------------------------------------------------- shared ---
constexpr int QF_BK = 128;      // keys a tile (a multiple of 32: register
                                // A of an 8-bit k-step covers 32 keys)
constexpr int QF_NC = 2;        // consumer warpgroups of 64 q rows
constexpr int QF_STAGES = 2;    // key tiles in flight
// registers a thread after setmaxnreg: 128 (40) + 256 (232) = 384 (168)
constexpr int QF_PRODUCER_REGS = 40;
constexpr int QF_CONSUMER_REGS = 232;
constexpr float QF_E4M3_OVERFLOW = 464.f;  // rounds past 448, e4m3's top

__host__ __device__ constexpr bool qf_int8(int mode) {
  return mode == QK8 || mode == QK8PV8;
}
__host__ __device__ constexpr bool qf_pv8(int mode) {
  return mode == QK8PV8 || mode == FP8PV8;
}

// bytes of a row of the q8 and k8 planes: 64 int8 codes, or 64 e4m3
// values as bf16
__host__ __device__ constexpr int qf_row_bytes(int mode) {
  return qf_int8(mode) ? 64 : 128;
}

// bytes of a stage's v tile: v8^T (64 d rows of QF_BK keys) or bf16 v
// (QF_BK rows of 128 bytes)
__host__ __device__ constexpr int qf_v_bytes(int mode) {
  return qf_pv8(mode) ? 64 * QF_BK : QF_BK * 128;
}

// dynamic shared memory: 1024 bytes of alignment slack, q8 (64 QF_NC
// rows), per stage k8 (QF_BK rows), v and (int8) the tile's sk, then the
// mbarriers
__host__ __device__ constexpr int qf_smem_bytes(int mode) {
  return 1024 + 64 * QF_NC * qf_row_bytes(mode) +
         QF_STAGES * (QF_BK * qf_row_bytes(mode) + qf_v_bytes(mode) +
                      (qf_int8(mode) ? QF_BK * 4 : 0)) +
         8 * (1 + 4 * QF_STAGES);
}

// N_pad of the route: whole key tiles
inline int qf_n_pad(int n) { return (n + QF_BK - 1) / QF_BK * QF_BK; }

// bytes of the copies the route takes: the q8 and k8 planes (B H, N_pad)
// rows of qf_row_bytes, then v8^T (B H, 64, N_pad) (written in the pv8
// modes only)
inline long long qf_bytes(int mode, int batch, int n, int heads) {
  return static_cast<long long>(batch) * heads * qf_n_pad(n) *
         (2 * qf_row_bytes(mode) + 64);
}

// floats of the scratch the route takes: the rows qs sl and sk (B H,
// N_pad), then max|v| (B H, 64)
inline long long qf_scratch_floats(int batch, int n, int heads) {
  return static_cast<long long>(batch) * heads * (2 * qf_n_pad(n) + 64);
}

// the int8 byte of round(x / s), half to even, an IEEE division (|x / s|
// <= 127 by construction)
__device__ __forceinline__ uint32_t qf_s8(float x, float s) {
  return static_cast<uint32_t>(__float2int_rn(__fdiv_rn(x, s))) & 0xffu;
}

// float(i) for |i| < 2^22 on the full-rate fp32 pipe (I2F runs at a
// quarter of its rate): the bits of 1.5 2^23 + i, less 1.5 2^23, both
// exact
__device__ __forceinline__ float qf_i2f(int i) {
  return __fsub_rn(__int_as_float(0x4B400000 + i), QW_MAGIC);
}

// the e4m3 byte of x as the JAX package casts it (ops/attention.py
// to_e4m3): NaN (0x7f) where |x| > 464, written here, else round to
// nearest even by the saturating conversion, which gives |x| in (448,
// 464] the 448 they round to; a NaN x stays NaN (chip_smoke.py phase 35
// holds 450 and 464 -> 448 and 466 -> NaN to the plain cast)
__device__ __forceinline__ uint32_t qf_e4m3(float x) {
  return fabsf(x) > QF_E4M3_OVERFLOW
             ? 0x7fu
             : static_cast<uint32_t>(
                   __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
}

// the e4m3 value of x (qf_e4m3) as a bf16, exact: e4m3 -> half -> bf16
__device__ __forceinline__ uint32_t qf_e4m3_bf16(float x) {
  const __half h = __half(__nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(qf_e4m3(x)), __NV_E4M3));
  const bf16 y = __float2bfloat16_rn(__half2float(h));
  return *reinterpret_cast<const uint16_t*>(&y);
}

// the low bytes of b0 .. b3 in one word, b0 lowest (two byte permutes)
__device__ __forceinline__ uint32_t qf_pack4(uint32_t b0, uint32_t b1,
                                             uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

// the e4m3 bytes of two probabilities (in [0, 1]: prob_to_e4m3's
// conversion, two at once), lo in the low byte
__device__ __forceinline__ uint32_t qf_e4m3x2(float lo, float hi) {
  uint32_t r;
  asm("{\n.reg .b16 t;\ncvt.rn.satfinite.e4m3x2.f32 t, %2, %1;\n"
      "cvt.u32.u16 %0, t;\n}\n"
      : "=r"(r)
      : "f"(lo), "f"(hi));
  return r;
}

// the 16 values of a row's columns s0 .. s0 + 15, zeros past N
__device__ __forceinline__ void qf_load16(const bf16* p, bool live,
                                          float (&x)[16]) {
  if (live) {
    bw_load8(p, *reinterpret_cast<float(*)[8]>(x));
    bw_load8(p + 8, *reinterpret_cast<float(*)[8]>(x + 8));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = 0.f;
  }
}

// ------------------------------------------------------------ 1. vmax ---
// grid (B H, ceil(N / 256)), 256 threads: a block takes 256 rows of one
// head, four threads a row of 16 columns each; max|v| per column over them
// into vmax (B H, 64), zeroed by the caller, by atomicMax on the bits
__global__ void __launch_bounds__(256)
attn_fwd_q8w_vmax_kernel(const bf16* __restrict__ v, float* vmax, int n,
                         int heads, Strides vs) {
  __shared__ float red[8][64];
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int r = threadIdx.x >> 2;
  const int s0 = (threadIdx.x & 3) * 16;
  float mx[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) mx[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = blockIdx.y * 256 + 64 * j + r;
    float x[16];
    qf_load16(v + b * vs.b + static_cast<long long>(row) * vs.n + h * vs.h + s0,
              row < n, x);
#pragma unroll
    for (int i = 0; i < 16; ++i) mx[i] = fmaxf(mx[i], fabsf(x[i]));
  }
  // over the warp's eight rows (lanes 4, 8, 16 apart share the columns)
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
  const int lane = threadIdx.x & 31;
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i) red[threadIdx.x >> 5][s0 + i] = mx[i];
  }
  __syncthreads();
  if (threadIdx.x < 64) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    atomicMax(reinterpret_cast<int*>(vmax + static_cast<long long>(bh) * 64 +
                                     threadIdx.x),
              __float_as_int(m));
  }
}

// ------------------------------------------------------------ 2. pass ---
// grid (B H, N_pad / 64), 256 threads: a block quantises 64 rows of one
// head, four threads a row of 16 columns (a row's int8 scale by two
// shuffles), rows >= N as zeros. bytes: q8, k8 (B H, N_pad, 64) int8
// codes or e4m3 values as bf16, then in the pv8 modes v8^T (B H, 64,
// N_pad) in the seq_pos order; scales: qs sl, sk (B H, N_pad) in the int8
// modes (zeros past N); vmax (B H, 64) from the vmax pass in qk8pv8.
template <int MODE>
__global__ void __launch_bounds__(256)
attn_fwd_q8w_pass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ vmax,
                         uint8_t* __restrict__ bytes,
                         float* __restrict__ scales, int n, int n_pad,
                         int heads, Strides qs, Strides ks, Strides vs,
                         float sl) {
  constexpr bool INT8 = qf_int8(MODE);
  constexpr bool PV8 = qf_pv8(MODE);
  __shared__ __align__(16) uint8_t tr[PV8 ? 64 : 1][LD8];  // v8^T, 64 keys
  const int n_bh = gridDim.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int t0 = blockIdx.y * 64;
  const int r = threadIdx.x >> 2;
  const int s0 = (threadIdx.x & 3) * 16;
  const int row = t0 + r;
  const bool live = row < n;
  const long long prow = static_cast<long long>(bh) * n_pad + row;
  constexpr int ROW = qf_row_bytes(MODE);
  const long long plane = static_cast<long long>(n_bh) * n_pad * ROW;
#pragma unroll
  for (int a = 0; a < 2; ++a) {  // q, then k
    float x[16];
    qf_load16(a == 0 ? q + b * qs.b + static_cast<long long>(row) * qs.n +
                           h * qs.h + s0
                     : k + b * ks.b + static_cast<long long>(row) * ks.n +
                           h * ks.h + s0,
              live, x);
    if constexpr (INT8) {
      uint32_t c[16];
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) m = fmaxf(m, fabsf(x[i]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float s = __fdiv_rn(fmaxf(m, QW_EPS), 127.f);
#pragma unroll
      for (int i = 0; i < 16; ++i) c[i] = qf_s8(x[i], s);
      if (s0 == 0)
        scales[a * static_cast<long long>(n_bh) * n_pad + prow] =
            live ? (a == 0 ? __fmul_rn(s, sl) : s) : 0.f;
      *reinterpret_cast<uint4*>(bytes + a * plane + prow * ROW + s0) =
          make_uint4(pack4(c[0], c[1], c[2], c[3]),
                     pack4(c[4], c[5], c[6], c[7]),
                     pack4(c[8], c[9], c[10], c[11]),
                     pack4(c[12], c[13], c[14], c[15]));
    } else {  // the e4m3 values as bf16: 32 bytes
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = qf_e4m3_bf16(x[2 * i]) | qf_e4m3_bf16(x[2 * i + 1]) << 16;
      uint4* dst = reinterpret_cast<uint4*>(bytes + a * plane + prow * ROW +
                                            2 * s0);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
  if constexpr (PV8) {
    float x[16];
    qf_load16(v + b * vs.b + static_cast<long long>(row) * vs.n + h * vs.h + s0,
              live, x);
    const int pos = seq_pos(r);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t c;
      if constexpr (INT8) {
        const float sv = __fdiv_rn(
            fmaxf(vmax[static_cast<long long>(bh) * 64 + s0 + i], QW_EPS), 127.f);
        c = qf_s8(x[i], sv);
      } else {
        c = qf_e4m3(x[i]);
      }
      tr[s0 + i][pos] = static_cast<uint8_t>(c);
    }
    __syncthreads();
    // d row dr of the transposed copy, the 16 positions from s0
    const int dr = threadIdx.x >> 2;
    *reinterpret_cast<uint4*>(
        bytes + 2 * plane + (static_cast<long long>(bh) * 64 + dr) * n_pad +
        t0 + s0) = *reinterpret_cast<const uint4*>(&tr[dr][s0]);
  }
}

// ---------------------------------------------------------- 3. kernel ---
// grid (B H ceil(N / (64 QF_NC))), the q tiles of one head on neighbouring
// blocks (they share its key tiles in L2), 128 (QF_NC + 1) threads. tq, tk:
// maps of the q8, k8 planes, boxes of 64 QF_NC and QF_BK rows (int8: 64-byte
// swizzle; e4m3 as bf16: 128-byte); tv: of v8^T, boxes of QF_BK keys x 64
// (128-byte swizzle), or
// of the bf16 (B, N, H, 64) v view, boxes of QF_BK rows; scales: the
// pass's (qs sl, then sk); vmax: max|v| (B H, 64) (qk8pv8)
template <int MODE>
__global__ void __launch_bounds__(128 * (QF_NC + 1), 1)
attn_fwd_q8w_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ scales,
                    const float* __restrict__ vmax, bf16* __restrict__ out,
                    float* __restrict__ lse, int n, int n_pad, int n_real,
                    int heads, Strides os, float sl) {
  constexpr bool INT8 = qf_int8(MODE);
  constexpr bool PV8 = qf_pv8(MODE);
  constexpr int NC = QF_NC;
  constexpr int BK = QF_BK;
  constexpr int BQ = 64 * NC;
  constexpr int ROW = qf_row_bytes(MODE);
  constexpr uint32_t K_BYTES = BK * ROW;
  constexpr uint32_t V_BYTES = qf_v_bytes(MODE);
  constexpr uint32_t SK_BYTES = INT8 ? BK * 4 : 0;
  extern __shared__ uint8_t qf_smem[];
  const uint32_t sq = (smem_addr(qf_smem) + 1023u) & ~1023u;
  const uint8_t* const g0 = qf_smem + (sq - smem_addr(qf_smem));  // sq
  const uint32_t sk = sq + BQ * ROW;            // stage s: + s K_BYTES
  const uint32_t sv = sk + QF_STAGES * K_BYTES;  // stage s: + s V_BYTES
  const uint32_t ssk = sv + QF_STAGES * V_BYTES;  // stage s: + s SK_BYTES
  const uint32_t bars = ssk + QF_STAGES * SK_BYTES;  // 8 bytes each
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + QF_STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * QF_STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * QF_STAGES + s); };

  const int n_bh = gridDim.x / ((n + BQ - 1) / BQ);
  const int q_tiles = (n + BQ - 1) / BQ;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = (blockIdx.x - bh * q_tiles) * BQ;
  const int n_tiles = (n_real + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < QF_STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 128 * NC);  // every consumer thread releases
      mbar_init(empty_v(s), 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------ producer
    setmaxnreg_dec<QF_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const float* sk_row = scales + (static_cast<long long>(n_bh) + bh) * n_pad;
      mbar_expect_tx(full_q, BQ * ROW);
      tma_load_3d(sq, &tq, full_q, 0, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % QF_STAGES;
        const uint32_t ph = (it / QF_STAGES) & 1;
        qw_wait(empty_k(s), ph ^ 1);  // the first round passes at once
        mbar_expect_tx(full_k(s), K_BYTES + SK_BYTES);
        tma_load_3d(sk + s * K_BYTES, &tk, full_k(s), 0, it * BK, bh);
        if constexpr (INT8)
          bulk_load(ssk + s * SK_BYTES, sk_row + it * BK, SK_BYTES, full_k(s));
        qw_wait(empty_v(s), ph ^ 1);
        mbar_expect_tx(full_v(s), V_BYTES);
        if constexpr (PV8)
          tma_load_3d(sv + s * V_BYTES, &tv, full_v(s), it * BK, 0, bh);
        else
          tma_load_4d(sv + s * V_BYTES, &tv, full_v(s), 0, h, it * BK, b);
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<QF_CONSUMER_REGS>();
    const int c = wg - 1;  // this consumer's 64 rows: q0 + 64 c ..
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // consumer c issues after named barrier 1 + c, then lets the next one
    // go; the last consumer lets consumer 0 take the first turn (K2's)
    const int turns = n_tiles + 1;  // S_0, then S_it with P.V_it-1, P.V_last
    int turn = 0;
    auto take_turn = [&] {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
    };
    auto pass_turn = [&] {
      if (!(c == NC - 1 && turn == turns - 1))
        asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (c + 1) % NC)
                     : "memory");
      ++turn;
    };
    if (c == NC - 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

    const int row0 = q0 + c * 64 + warp * 16 + g;  // and row0 + 8
    float rs[2] = {sl, sl};  // the row's score scale: qs sl (int8) or sl
    if constexpr (INT8) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rs[r] = scales[static_cast<long long>(bh) * n_pad +
                       min(row0 + 8 * r, n_pad - 1)];
    }
    const uint64_t dq = INT8 ? sw64_desc(sq + c * 64 * ROW)
                             : sw128_desc(sq + c * 64 * ROW);
    float o[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float corr[2];
    int si[INT8 ? BK / 8 : 1][4];      // int8: the exact int32 scores
    float sf[INT8 ? 1 : BK / 8][4];    // e4m3: the fp32 sums
    float s[BK / 8][4];                // scores, then p in fp32
    // P's A fragments: 8-bit k-steps of 32 keys, or bf16 of 16
    uint32_t pf[PV8 ? BK / 32 : BK / 16][4];
    int pvi[MODE == QK8PV8 ? 8 : 1][4];   // a tile's int32 P8.V8
    float pvf[MODE == FP8PV8 ? 8 : 1][4]; // a tile's fp32 e4m3 P.V
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (MODE == QK8PV8) pvi[dt][e] = 0;
        if constexpr (MODE == FP8PV8) pvf[dt][e] = 0.f;
      }

    // s = Q8.K8^T of the key tile in stage st (s8: 2 k-steps of 32 over
    // d; bf16: 4 of 16; +32 bytes a k-step)
    auto issue_s = [&](int st) {
      if constexpr (INT8) {
        const uint64_t dk = sw64_desc(sk + st * K_BYTES);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_ss_s8_n128(si, dq + 2 * kk, dk + 2 * kk, kk);
      } else {
        const uint64_t dk = sw128_desc(sk + st * K_BYTES);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<BK>(sf, dq + 2 * kk, dk + 2 * kk, kk);
      }
      wgmma_commit();
    };
    // P.V of the key tile in stage st: pv8 into the fresh accumulator (4
    // k-steps of 32 keys, +32 bytes of the v8^T rows each), else into o (8
    // k-steps of 16 keys, +2048 bytes: 16 rows of v)
    auto issue_pv = [&](int st) {
      if constexpr (PV8) {
        const uint64_t dv = sw128_desc(sv + st * V_BYTES);
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          if constexpr (INT8)
            wgmma_rs_s8_n64(pvi, pf[kk], dv + 2 * kk, kk);
          else
            wgmma_rs_e4m3_n64(pvf, pf[kk], dv + 2 * kk, kk);
        }
      } else {
        const uint64_t dv = sw128_desc(sv + st * V_BYTES);
#pragma unroll
        for (int kj = 0; kj < BK / 16; ++kj)
          wgmma_rs_n64_t(o, pf[kj], dv + kj * 128);
      }
      wgmma_commit();
    };
    auto fence_s = [&] {
      if constexpr (INT8)
        reg_fence(si);
      else
        reg_fence(sf);
    };
    auto fence_pv = [&] {
      if constexpr (MODE == QK8PV8)
        reg_fence(pvi);
      else if constexpr (MODE == FP8PV8)
        reg_fence(pvf);
      else
        reg_fence(o);
    };
    // the softmax of key tile `it` (stage st): the scores in the rounded
    // products of _attn_body(_q8), masked, the new running max, corr, p
    // in fp32 (into s) and its sums; o is rescaled later, once the P.V in
    // flight has added to it
    auto softmax = [&](int it, int st) {
      const int base = it * BK;
      const float* skt =
          reinterpret_cast<const float*>(g0 + (ssk - sq) + st * SK_BYTES);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        float2 kv = make_float2(0.f, 0.f);
        if constexpr (INT8)
          kv = *reinterpret_cast<const float2*>(skt + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (INT8)
            s[nt][e] = __fmul_rn(__fmul_rn(qf_i2f(si[nt][e]), rs[e >> 1]),
                                 (e & 1) ? kv.y : kv.x);
          else
            s[nt][e] = __fmul_rn(sf[nt][e], sl);
        }
      }
      if (base + BK > n_real) {  // the last tile: keys >= n_real masked
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (base + nt * 8 + 2 * t + (e & 1) >= n_real) s[nt][e] = NEG_INF;
      }
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = qw_ex2(m[r] - mx[r]);
        l[r] = __fmul_rn(l[r], corr[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = qw_ex2(s[nt][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[nt][e] = p;
        }
    };
    // pv8: o += the finished tile's P.V (o was rescaled by that tile's
    // corr when its p was packed: acc corr + pv)
    auto add_pv = [&] {
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (MODE == QK8PV8)
            o[dt][e] = __fadd_rn(o[dt][e], qf_i2f(pvi[dt][e]));
          if constexpr (MODE == FP8PV8)
            o[dt][e] = __fadd_rn(o[dt][e], pvf[dt][e]);
        }
    };
    // o *= corr, then p into P's A fragments: pv8 codes of n-tiles 4 kk ..
    // 4 kk + 3 as they lie (pack_a's order: register r of k-step kk holds
    // (n-tile j, e), (j, e + 1), (j + 1, e), (j + 1, e + 1), j = 4 kk +
    // 2 (r >> 1), e = 2 (r & 1)), bf16 n-tiles 2 j, 2 j + 1 (K2's)
    auto rescale_pack = [&] {
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = __fmul_rn(o[dt][e], corr[e >> 1]);
      if constexpr (MODE == QK8PV8) {  // pack_a's order, bytes by permutes
        // (the low byte of 1.5 2^23 + p 127 is round(p 127): qw_code)
        auto code = [&](int nt, int e) {
          return __float_as_uint(__fadd_rn(__fmul_rn(s[nt][e], 127.f), QW_MAGIC));
        };
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = 4 * kk + 2 * (r >> 1), e = 2 * (r & 1);
            pf[kk][r] = qf_pack4(code(j, e), code(j, e + 1), code(j + 1, e),
                                 code(j + 1, e + 1));
          }
      } else if constexpr (MODE == FP8PV8) {  // pack_a's order, two at once
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = 4 * kk + 2 * (r >> 1), e = 2 * (r & 1);
            pf[kk][r] = qf_e4m3x2(s[j][e], s[j][e + 1]) |
                        qf_e4m3x2(s[j + 1][e], s[j + 1][e + 1]) << 16;
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(s[nt][0], s[nt][1]);
          pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
        }
      }
    };

    qw_wait(full_q, 0);
    qw_wait(full_k(0), 0);
    take_turn();
    wgmma_fence();
    issue_s(0);
    pass_turn();
    wgmma_wait<0>();
    fence_s();
    softmax(0, 0);
    mbar_arrive(empty_k(0));  // k8 and sk of the stage are read
    rescale_pack();
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % QF_STAGES, prev = (it - 1) % QF_STAGES;
      qw_wait(full_k(st), (it / QF_STAGES) & 1);
      qw_wait(full_v(prev), ((it - 1) / QF_STAGES) & 1);
      take_turn();
      fence_pv();
      reg_fence(pf);
      wgmma_fence();
      issue_s(st);      // S of this tile
      issue_pv(prev);   // and P.V of the last one, under its softmax
      pass_turn();
      wgmma_wait<1>();  // S is done
      fence_s();
      softmax(it, st);
      mbar_arrive(empty_k(st));
      wgmma_wait<0>();  // P.V is done
      fence_pv();
      reg_fence(pf);
      mbar_arrive(empty_v(prev));
      add_pv();
      rescale_pack();
    }
    const int last = (n_tiles - 1) % QF_STAGES;
    qw_wait(full_v(last), ((n_tiles - 1) / QF_STAGES) & 1);
    take_turn();
    fence_pv();
    reg_fence(pf);
    wgmma_fence();
    issue_pv(last);
    pass_turn();
    wgmma_wait<0>();
    fence_pv();
    mbar_arrive(empty_v(last));
    add_pv();

    // epilogue: (qk8pv8) acc (sv / 127) once, o / l in bf16, rows past N
    // never stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if constexpr (MODE == QK8PV8) {
      const float* vm = vmax + static_cast<long long>(bh) * 64;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float sv127 = __fdiv_rn(
              __fdiv_rn(fmaxf(vm[dt * 8 + 2 * t + u], QW_EPS), 127.f), 127.f);
          o[dt][u] = __fmul_rn(o[dt][u], sv127);
          o[dt][2 + u] = __fmul_rn(o[dt][2 + u], sv127);
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
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
      if (lse != nullptr && t == 0)
        lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
    }
  }
}

// --------------------------------------------------------------- host ---
// the passes alone on `stream` (qk8pv8: vmax zeroed, the vmax pass, then
// the pass; else the pass): the route's inputs into bytes (qf_bytes) and
// scratch (qf_scratch_floats); s: the strides of q, k, v
template <int MODE>
int launch_fwd_q8w_pass(const bf16* q, const bf16* k, const bf16* v,
                        uint8_t* bytes, float* scratch, int batch, int n,
                        int heads, const Strides* s, float sl,
                        cudaStream_t cs) {
  const int n_bh = batch * heads;
  const int n_pad = qf_n_pad(n);
  float* vmax = scratch + 2LL * n_bh * n_pad;
  if constexpr (MODE == QK8PV8) {
    cudaError_t e = cudaMemsetAsync(vmax, 0, static_cast<size_t>(n_bh) * 64 * 4, cs);
    if (e != cudaSuccess) return static_cast<int>(e);
    attn_fwd_q8w_vmax_kernel<<<dim3(n_bh, (n + 255) / 256), 256, 0, cs>>>(
        v, vmax, n, heads, s[2]);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  attn_fwd_q8w_pass_kernel<MODE><<<dim3(n_bh, n_pad / 64), 256, 0, cs>>>(
      q, k, v, vmax, bytes, scratch, n, n_pad, heads, s[0], s[1], s[2], sl);
  return static_cast<int>(cudaGetLastError());
}

// the route on `stream`: the passes, then the kernel. q, k, v, out: bf16
// (B, N, H, 64) views with strides st (q, k, v, out); lse nullptr or (B,
// H, N) fp32
template <int MODE>
int launch_fwd_q8w(const void* q, const void* k, const void* v, void* out,
                   float* lse, void* bytes, float* scratch, int batch, int n,
                   int heads, int n_real, const long long* st, float sl,
                   void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Strides s[4] = {{st[0], st[1], st[2]}, {st[3], st[4], st[5]},
                        {st[6], st[7], st[8]}, {st[9], st[10], st[11]}};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const auto kernel = attn_fwd_q8w_kernel<MODE>;
  constexpr int smem = qf_smem_bytes(MODE);
  // once an instance, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  uint8_t* b8 = static_cast<uint8_t*>(bytes);
  int err = launch_fwd_q8w_pass<MODE>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), b8, scratch, batch, n, heads, s, sl, cs);
  if (err) return err;
  const int n_bh = batch * heads;
  const int n_pad = qf_n_pad(n);
  constexpr int ROW = qf_row_bytes(MODE);
  const long long plane = static_cast<long long>(n_bh) * n_pad * ROW;
  constexpr auto SWQK = ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                  : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv;
  if (!encode_u8_3d(&tq, b8, ROW, n_pad, n_bh, ROW, 64 * QF_NC, SWQK) ||
      !encode_u8_3d(&tk, b8 + plane, ROW, n_pad, n_bh, ROW, QF_BK, SWQK))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tv_ok =
      qf_pv8(MODE)
          ? encode_u8_3d(&tv, b8 + 2 * plane, n_pad, 64, n_bh, QF_BK, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B)
          : encode_bnh64(&tv, v, batch, n, heads, s[2], QF_BK);
  if (!tv_ok) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + 64 * QF_NC - 1) / (64 * QF_NC) * n_bh;
  kernel<<<grid, 128 * (QF_NC + 1), smem, cs>>>(
      tq, tk, tv, scratch, scratch + 2LL * n_bh * n_pad, static_cast<bf16*>(out),
      lse, n, n_pad, n_real, heads, s[3], sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
