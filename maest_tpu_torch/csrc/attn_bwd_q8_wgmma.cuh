// The int8 attention backward at head_dim 64 in bf16 on Hopper's
// asynchronous machinery (sm_90a): K7, the production instance behind
// maest_attn_bwd_q8 (attention_bwd_q8.cu), which keeps its mma.sync kernels
// beside it as maest_attn_bwd_q8_mma.
//
// It computes what maest_tpu/ops/attention.py::_attn_bwd_kernel_q8 +
// _q8_tensor compute (the formulas head attention_bwd_q8.cu): per (head,
// q-block) scalar scales for q, do, p and ds, per head for k and v; all
// five products in int8 with integer sums; every scale product in the
// TPU's association order; delta = rowsum(do * o) in fp32 from the stored
// o; dk and dv summed over the q-blocks in fp32; masked keys exactly zero
// dk and dv. The q-block is the TPU's (bwd_q_block), semantics and not
// tuning: the scales of a 64-row q tile are those of the block it lies in.
//
// What bounds it: at (32, 866, 12, 64) its bf16 reads and writes (~340 MB)
// take 0.10 ms at the data-sheet rate, its five int8 products 0.093 ms.
// Beside them it forms s and dp twice (a stats pass, then the main kernel:
// 7 products in all) and takes 2 N^2 exp2.
//
// Design, K3b's schedule (attn_bwd_wgmma.cuh) on s8 wgmma:
//   1. amax (attention_bwd_q8.cu's pass): max|q|, max|do| per (head,
//      q-block), max|k|, max|v| per head, by atomicMax on the bits of
//      non-negative floats (order-free).
//   2. quant (attn_bwd_q8w_quant_kernel): q8, k8, v8, do8 row-major, and
//      q8, do8, k8 transposed, (d, N_pad), with the sequence in the
//      seq_pos order of mma_8bit.cuh (below); delta and lse copied into
//      (B H, N_pad) rows (past N: delta 0, lse +1e30, so p = 0); the int32
//      dq sums zeroed. N_pad = round_up(N, 128).
//   3. stats (attn_bwd_q8w_kernel<true>): per (key tile, q tile) S^T =
//      K8.Q8^T and dP^T = V8.dO8^T on wgmma with int32 sums, p and ds; max
//      p and max|ds| per (head, q-block) by atomicMax. pst needs the
//      quantised scores, so this pass cannot be folded away.
//   4. main (attn_bwd_q8w_kernel<false>), K3b's shape: a block owns 128
//      keys (two consumer warpgroups of 64), K8, V8 and K8^T loaded once by
//      TMA; one producer thread streams the 64-row q tiles of q8, do8,
//      q8^T, do8^T (3-D tensor maps, 64-byte swizzle) and lse, delta (bulk
//      copies) through a two-stage mbarrier ring. A consumer forms S^T and
//      dP^T once per tile, quantises p8^T = round(p 127 / pst) and ds8^T in
//      registers, and feeds them as the register A of dV += P8^T.dO8 and
//      dK += dS8^T.Q8 (B the transposed copies, K-major). dK and dV are
//      int32 sums in registers, folded into fp32 with the block's scalars
//      at every q-block boundary (the running fp32 sums in shared memory)
//      and once at the end, then stored in bf16.
//   5. dQ: each consumer stores its ds8 (q rows x its 64 keys) byte by byte
//      into a 64-byte-swizzled tile, keys in the seq_pos order of the K8^T
//      copy, and runs dQ = dS8.K8 (A that tile, B K8^T: both K-major). Its
//      int32 partial goes to shared memory in the order the accumulator
//      lies (conflict-free 16-byte stores) and one thread adds the 16 KB
//      into an int32 workspace (B H, N_pad, 64) by a TMA bulk reduction
//      (cp.reduce.async.bulk .add.s32), in any order: integer addition is
//      exact, so the sum is deterministic without the ordered hand-over
//      that K3b's fp32 dq needs, and no thread spends instruction slots on
//      it. |dq_int| <= 4096 127^2 < 2^31 at the longest length K7 takes.
//      A last pass (attn_bwd_q8w_dq_kernel) applies dst ks (1/127) once
//      and rounds into dq.
//
// 8-bit wgmma has no transpose bit: both shared-memory operands must be
// K-major, so every product that contracts over the sequence reads a
// transposed copy. Re-using the int32 accumulator as the next product's A
// operand: the accumulator of an m64nNk32 s32 product hands thread (g, t)
// of each warp the columns 8j + 2t + c, while the s8 register-A fragment
// of a 32-deep k-step wants 4t + {0..3} and 16 + 4t + {0..3} (the layout
// of mma.sync's m16n8k32, a warp's 16 rows). A contraction runs in any
// order, so the thread packs its values as they lie (pack_a) and the
// transposed copies hold the sequence in the matching order (seq_pos): the
// same order as the mma.sync kernels' copies.

#pragma once

#include "attn_bwd_wgmma.cuh"  // bulk_load, fence_proxy_async; mbarriers,
                                // TMA, descriptors, wgmma, setmaxnreg
#include "mma_8bit.cuh"        // seq_pos, to_s8, pack4, pack_a

namespace maest {

// ---------------------------------------------------------------- PTX ---
// *dst += the `bytes` (a multiple of 16) of int32 at shared src, added by
// the TMA unit in L2 (exact, in any order), one bulk group
__device__ __forceinline__ void bulk_add_s32(int* dst, uint32_t src,
                                             uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.s32 [%0], [%1], "
      "%2;\ncp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until all of this thread's bulk groups are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the shared-memory matrix descriptor of a K-major tile of 64-byte rows in
// the 64-byte swizzle (8-row atoms of 512 bytes, the tile 512-byte
// aligned): start address >> 4, leading byte offset 1 (unused by a
// swizzled K-major layout), 512 bytes between 8-row groups, layout 2
// (64-byte swizzle)
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (32ull << 32) | (2ull << 62);
}

template <int R>
__device__ __forceinline__ void reg_fence(int (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
}

// d (64 x 64, s32, C layout a warp) (+)= A (64 x 32, s8, shared memory,
// K-major) . B (32 x 64, s8, shared memory, K-major); scale_d 0 overwrites
__device__ __forceinline__ void wgmma_ss_s8_n64(int (&d)[8][4], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, s32) (+)= A (64 x 32 s8, registers: the four b32 of a warp's
// 16 rows, as mma.sync's m16n8k32 A fragment) . B (32 x 64, s8, shared
// memory, K-major); scale_d 0 overwrites
__device__ __forceinline__ void wgmma_rs_s8_n64(int (&d)[8][4],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ------------------------------------------------------------- shared ---
constexpr int QW_BQ = 64;       // q rows a streamed tile
constexpr int QW_DQ_BUFS = 2;   // dQ partials a consumer has in flight
constexpr int QW_TILE = 64 * 64;  // bytes of a 64 x 64 int8 tile
// registers a thread after setmaxnreg, as attn_bwd_wgmma.cuh's kernel
constexpr int QW_PRODUCER_REGS = 64;
constexpr int QW_CONSUMER_REGS = 216;
constexpr float QW_INV127 = static_cast<float>(1.0 / 127.0);
constexpr float QW_EPS = 1e-30f;     // scale floor
constexpr float QW_LSE_PAD = 1e30f;  // lse of the rows past N: p = 0

// max(amax, 1e-30) (1/127): the scale of an int8 tensor (_q8_tensor)
__device__ __forceinline__ float qw_scale(float amax) {
  return __fmul_rn(fmaxf(amax, QW_EPS), QW_INV127);
}

// round() on the full-rate fp32 pipe (F2I runs at a quarter of its rate,
// two a score): 1.5 2^23 + x, rounded half to even, holds round(x) in its
// low mantissa bits for |x| < 2^22.
constexpr float QW_MAGIC = 12582912.f;  // 1.5 2^23, bits 0x4B400000
// the int8 byte of round(x), half to even, for |x| <= 127.5: to_s8(x)
__device__ __forceinline__ uint32_t qw_code(float x) {
  return __float_as_uint(__fadd_rn(x, QW_MAGIC)) & 0xffu;
}

// 2^x: the instruction exp2f runs for x >= -126 (exp2f rescales below;
// there p < 2^-126 flushes to 0, whose 8-bit code p8 is 0 either way)
__device__ __forceinline__ float qw_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the stats buffer (zeroed by the caller): per (head, q-block) max|q|,
// max|do|, max p, max|ds|, then per head max|k|, max|v|
struct QwStats {
  float *qmax, *domax, *pmax, *dsmax, *kmax, *vmax;
  __host__ __device__ QwStats(float* s, long long n_bh, long long n_qb)
      : qmax(s),
        domax(s + n_qb),
        pmax(s + 2 * n_qb),
        dsmax(s + 3 * n_qb),
        kmax(s + 4 * n_qb),
        vmax(s + 4 * n_qb + n_bh) {}
};

// byte offsets past the 1024-byte aligned base of an instance's dynamic
// shared memory: K8 and V8 (KB rows of 64 bytes), K8^T (main: 64 d rows of
// the block's 128 keys, 128-byte swizzle), per stage q8 and do8 (and,
// main, q8^T and do8^T) tiles of 64 x 64, the consumers' ds8 tiles and
// QW_DQ_BUFS sets of their int32 dQ partials (64 x 64 each), the
// consumers' fp32 dk, dv running sums over q-blocks (32 floats a thread
// each), per stage lse and delta (64 floats each), the mbarriers. The
// stats pass keeps no sums, so it takes three consumers (registers for
// 512 threads) and a deeper ring.
template <bool STATS>
struct QwLayout {
  static constexpr int NC = STATS ? 3 : 2;    // consumer warpgroups
  static constexpr int KB = 64 * NC;          // keys a block
  static constexpr int STAGES = STATS ? 4 : 2;  // q tiles in flight
  static constexpr int K = 0;
  static constexpr int V = K + KB * 64;
  static constexpr int KT = V + KB * 64;
  static constexpr int RING = KT + (STATS ? 0 : 64 * KB);
  static constexpr int STAGE = (STATS ? 2 : 4) * QW_TILE;
  static constexpr int DS = RING + STAGES * STAGE;
  static constexpr int DQ = DS + (STATS ? 0 : NC * QW_TILE);
  static constexpr int DQ_PART = 64 * 64 * 4;
  static constexpr int TOT = DQ + (STATS ? 0 : QW_DQ_BUFS * NC * DQ_PART);
  static constexpr int LD = TOT + (STATS ? 0 : NC * 2 * 32 * 128 * 4);
  static constexpr int BARS = LD + STAGES * 2 * QW_BQ * 4;
  static constexpr int BYTES = 1024 + BARS + 8 * (1 + 2 * STAGES);
};
static_assert(QwLayout<false>::KB == 128, "the main kernel's key tile");

// the int of a q tile's dq sums (64 x 64 int32) that holds (row, col) in
// fragment order: [warp][n-tile dt][lane][4], the order in which a
// consumer's accumulator lies (thread 4 g + t of warp w: rows 16 w + g + 8
// e, columns 8 dt + 2 t + u at register 4 dt + 2 e + u), so a warp stores
// it in 512 contiguous bytes
__host__ __device__ __forceinline__ int qw_frag_at(int row, int col) {
  const int warp = row >> 4, g = row & 7, e = (row >> 3) & 1;
  const int dt = col >> 3, t = (col >> 1) & 3, u = col & 1;
  return ((warp * 8 + dt) * 32 + 4 * g + t) * 4 + 2 * e + u;
}

// byte of the ds8 tile (64 q rows of 64 key bytes, 64-byte swizzle: the
// 16-byte chunk of row r XOR (r >> 1) & 3) at q row r, key position kp
__device__ __forceinline__ int qw_ds_at(int r, int kp) {
  return r * 64 + ((((kp >> 4) ^ (r >> 1)) & 3) << 4) + (kp & 15);
}

__device__ __forceinline__ float qw_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ------------------------------------------------------------ 2. quant ---
// grid (B H, N_pad / 64), 256 threads: a block quantizes 64 rows of one
// head with the amax pass's maxima, 16 columns a thread (rows >= n as
// zeros), writes delta and lse into their (B H, N_pad) rows and zeroes the
// rows' int32 dq sums. bytes: seven (B H, N_pad, 64) planes, q8, k8, v8,
// do8, then q8^T, do8^T, k8^T as (B H, 64, N_pad) in the seq_pos order.
__global__ void __launch_bounds__(256)
attn_bwd_q8w_quant_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse, float* stats,
                          uint8_t* __restrict__ bytes, float* __restrict__ lse_p,
                          float* __restrict__ delta_p, int* __restrict__ dq_acc,
                          int n, int n_pad, int heads, int bq, int nqb,
                          Strides qs, Strides ks, Strides vs, Strides os,
                          Strides ds) {
  __shared__ __align__(16) uint8_t tr[3][64][LD8];  // q, do, k transposed
  const int n_bh = gridDim.x;
  const QwStats st(stats, n_bh, static_cast<long long>(n_bh) * nqb);
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int t0 = blockIdx.y * 64;
  const int qb = bh * nqb + t0 / bq;  // a 64-row tile lies in one q-block
  const int r = threadIdx.x >> 2;     // row of the tile
  const int s0 = (threadIdx.x & 3) * 16;  // its 16 columns
  const int row = t0 + r;
  const float inv[4] = {1.f / qw_scale(st.qmax[qb]), 1.f / qw_scale(st.domax[qb]),
                        1.f / qw_scale(st.kmax[bh]), 1.f / qw_scale(st.vmax[bh])};
  float dsum = 0.f;
  uint32_t w[4][4];  // q8, do8, k8, v8: 16 bytes each
  if (row < n) {
    float x[16], y[16];
    const bf16* src[4] = {q + b * qs.b + row * qs.n + h * qs.h + s0,
                          dout + b * ds.b + row * ds.n + h * ds.h + s0,
                          k + b * ks.b + row * ks.n + h * ks.h + s0,
                          v + b * vs.b + row * vs.n + h * vs.h + s0};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      bw_load8(src[a], *reinterpret_cast<float(*)[8]>(x));
      bw_load8(src[a] + 8, *reinterpret_cast<float(*)[8]>(x + 8));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[a][i] = pack4(to_s8(__fmul_rn(x[4 * i], inv[a])),
                        to_s8(__fmul_rn(x[4 * i + 1], inv[a])),
                        to_s8(__fmul_rn(x[4 * i + 2], inv[a])),
                        to_s8(__fmul_rn(x[4 * i + 3], inv[a])));
      if (a == 1) {  // delta = rowsum(do * o), fp32, as the mma.sync pass
        const bf16* orow = o + b * os.b + row * os.n + h * os.h + s0;
        bw_load8(orow, *reinterpret_cast<float(*)[8]>(y));
        bw_load8(orow + 8, *reinterpret_cast<float(*)[8]>(y + 8));
#pragma unroll
        for (int i = 0; i < 16; ++i) dsum = fmaf(x[i], y[i], dsum);
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) w[a][i] = 0u;
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  const long long prow = static_cast<long long>(bh) * n_pad + row;
  if (s0 == 0) {
    delta_p[prow] = row < n ? dsum : 0.f;
    lse_p[prow] = row < n ? lse[static_cast<long long>(bh) * n + row] : QW_LSE_PAD;
  }
  int4* z = reinterpret_cast<int4*>(dq_acc + prow * 64 + s0);
#pragma unroll
  for (int i = 0; i < 4; ++i) z[i] = make_int4(0, 0, 0, 0);
  const long long plane = static_cast<long long>(n_bh) * n_pad * 64;
  const long long off = prow * 64 + s0;
  const int rows_of[4] = {0, 3, 1, 2};  // plane of q8, do8, k8, v8
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<uint4*>(bytes + rows_of[a] * plane + off) =
        make_uint4(w[a][0], w[a][1], w[a][2], w[a][3]);
  const int pos = seq_pos(r);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      tr[a][s0 + i][pos] = (w[a][i >> 2] >> (8 * (i & 3))) & 0xffu;
  __syncthreads();
  // the transposed tiles: d row dr, the 16 sequence columns from s0
  const int dr = threadIdx.x >> 2;
  const long long toff = (static_cast<long long>(bh) * 64 + dr) * n_pad + t0 + s0;
#pragma unroll
  for (int a = 0; a < 3; ++a)  // q8^T, do8^T, k8^T: planes 4, 5, 6
    *reinterpret_cast<uint4*>(bytes + (4 + a) * plane + toff) =
        *reinterpret_cast<const uint4*>(&tr[a][dr][s0]);
}

// --------------------------------------------------- 3. stats, 4. main ---
// grid (B H ceil(N / KB)), the key tiles of one (b, h) on neighbouring
// blocks, 128 (NC + 1) threads: warpgroup 0 the producer (one thread), NC
// consumer warpgroups of 64 keys. tq, tdo, tk, tv: maps of the (B H, N_pad,
// 64) int8 rows with boxes of 64 (q8, do8) or KB (k8, v8) rows; tqt, tdot,
// tkt: of the (B H, 64, N_pad) transposed copies, boxes of 64 (q, do) or
// 128 (k) sequence bytes; lse_p, delta_p (B H, N_pad); dq_acc (B H, N_pad,
// 64) int32, each 64-row tile in fragment order (qw_frag_at). STATS: max p,
// max|ds| into `stats`; else dk and dv into their views and dq's int32
// sums into dq_acc.
template <bool STATS>
__global__ void __launch_bounds__(128 * (QwLayout<STATS>::NC + 1), 1)
attn_bwd_q8w_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tqt,
                    const __grid_constant__ CUtensorMap tdot,
                    const __grid_constant__ CUtensorMap tkt,
                    const float* __restrict__ lse_p,
                    const float* __restrict__ delta_p, float* stats,
                    int* __restrict__ dq_acc, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int n, int n_pad, int n_real,
                    int heads, int bq, int nqb, Strides dks, Strides dvs,
                    float sl, float scale) {
  using L = QwLayout<STATS>;
  constexpr int NC = L::NC;  // consumer warpgroups of 64 keys
  constexpr int KB = L::KB;  // keys a block
  extern __shared__ uint8_t qw_smem[];
  const uint32_t s0 = (smem_addr(qw_smem) + 1023u) & ~1023u;
  uint8_t* const g0 = qw_smem + (s0 - smem_addr(qw_smem));  // s0, generic
  const uint32_t sk = s0 + L::K;
  const uint32_t sv = s0 + L::V;
  const uint32_t skt = s0 + L::KT;
  // stage s: q8, do8, then (main) q8^T, do8^T
  auto stage = [&](int s) { return s0 + L::RING + s * L::STAGE; };
  auto s_lse = [&](int s) { return s0 + L::LD + s * 2 * QW_BQ * 4; };
  auto s_delta = [&](int s) { return s_lse(s) + QW_BQ * 4; };
  auto dq_part = [&](int j, int c) {
    return reinterpret_cast<int*>(g0 + L::DQ + (j * NC + c) * L::DQ_PART);
  };
  const uint32_t bars = s0 + L::BARS;
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + L::STAGES + s); };

  const int n_kb = (n + KB - 1) / KB;
  const int n_bh = gridDim.x / n_kb;
  const int bh = blockIdx.x / n_kb;
  const int kb = blockIdx.x - bh * n_kb;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = kb * KB;
  const QwStats st(stats, n_bh, static_cast<long long>(n_bh) * nqb);

  if (k0 >= n_real) {  // every key masked: no mass; main: zero dk and dv
    if constexpr (!STATS) {
      const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
      for (int i = threadIdx.x; i < KB * 32; i += blockDim.x) {
        const int key = k0 + (i >> 5);
        if (key >= n) break;
        const int col = (i & 31) * 2;
        *reinterpret_cast<__nv_bfloat162*>(
            dk + b * dks.b + h * dks.h + static_cast<long long>(key) * dks.n +
            col) = z;
        *reinterpret_cast<__nv_bfloat162*>(
            dv + b * dvs.b + h * dvs.h + static_cast<long long>(key) * dvs.n +
            col) = z;
      }
    }
    return;
  }
  const int n_qt = (n + QW_BQ - 1) / QW_BQ;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
#pragma unroll
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * NC);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // -------------------------------------------- producer
    if constexpr (!STATS) setmaxnreg_dec<QW_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, 2 * KB * 64 + (STATS ? 0 : 64 * KB));
      tma_load_3d(sk, &tk, full_kv, 0, k0, bh);
      tma_load_3d(sv, &tv, full_kv, 0, k0, bh);
      if constexpr (!STATS) tma_load_3d(skt, &tkt, full_kv, k0, 0, bh);
      const float* lse_row = lse_p + static_cast<long long>(bh) * n_pad;
      const float* delta_row = delta_p + static_cast<long long>(bh) * n_pad;
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % L::STAGES;
        qw_wait(empty(s), ((it / L::STAGES) & 1) ^ 1);  // first round at once
        mbar_expect_tx(full(s), L::STAGE + 2 * QW_BQ * 4);
        const int r0 = it * QW_BQ;
        tma_load_3d(stage(s), &tq, full(s), 0, r0, bh);
        tma_load_3d(stage(s) + QW_TILE, &tdo, full(s), 0, r0, bh);
        if constexpr (!STATS) {
          tma_load_3d(stage(s) + 2 * QW_TILE, &tqt, full(s), r0, 0, bh);
          tma_load_3d(stage(s) + 3 * QW_TILE, &tdot, full(s), r0, 0, bh);
        }
        bulk_load(s_lse(s), lse_row + r0, QW_BQ * 4, full(s));
        bulk_load(s_delta(s), delta_row + r0, QW_BQ * 4, full(s));
      }
    }
  } else {  // ----------------------------------------------- consumers
    if constexpr (!STATS) setmaxnreg_inc<QW_CONSUMER_REGS>();
    const int c = wg - 1;  // this consumer's keys: k0 + 64 c ..
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = 16 * warp + g;  // accumulator rows row0, row0 + 8
    const int key0 = k0 + 64 * c + row0;
    const bool live0 = key0 < n_real, live1 = key0 + 8 < n_real;
    const uint64_t k_desc = sw64_desc(sk + c * QW_TILE);
    const uint64_t v_desc = sw64_desc(sv + c * QW_TILE);
    const float ksc = qw_scale(st.kmax[bh]);
    const float vsc = qw_scale(st.vmax[bh]);
    const int bq_tiles = bq / QW_BQ;  // q tiles a q-block

    // the scalars of q-block jb (c_p and after it main's only)
    float c_s = 0.f, c_dp = 0.f, c_p = 0.f, c_ds = 0.f, c_dk = 0.f, c_dv = 0.f;
    auto scalars = [&](int jb) {
      const long long qb = static_cast<long long>(bh) * nqb + jb;
      const float qsc = qw_scale(st.qmax[qb]);
      const float dosc = qw_scale(st.domax[qb]);
      c_s = __fmul_rn(__fmul_rn(qsc, ksc), sl);
      c_dp = __fmul_rn(dosc, vsc);
      if constexpr (!STATS) {
        const float pst = fmaxf(st.pmax[qb], QW_EPS);
        const float dst = fmaxf(st.dsmax[qb], QW_EPS);
        c_p = __fdiv_rn(127.f, pst);
        c_ds = __fdiv_rn(127.f, dst);
        c_dv = __fmul_rn(__fmul_rn(dosc, pst), QW_INV127);
        c_dk = __fmul_rn(__fmul_rn(dst, qsc), QW_INV127);
      }
    };
    // S^T = K8.Q8^T, then dP^T = V8.dO8^T of the tile in stage stg (keys x
    // its q rows), two commit groups, +32 bytes a k-step
    auto products = [&](int (&sa)[8][4], int (&da)[8][4], int stg) {
      const uint64_t q_desc = sw64_desc(stage(stg));
      const uint64_t do_desc = sw64_desc(stage(stg) + QW_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_ss_s8_n64(sa, k_desc + 2 * kk, q_desc + 2 * kk, kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_ss_s8_n64(da, v_desc + 2 * kk, do_desc + 2 * kk, kk);
      wgmma_commit();
    };
    // p = exp2(s_int c_s - lse[q]), keys >= n_real at 0, as
    // _attn_bwd_kernel_q8 rounds it (exp2 computed for every key, then
    // selected: no branch)
    auto prob = [&](int s_int, float l, bool live) {
      const float x = qw_ex2(__fsub_rn(__fmul_rn(__int2float_rn(s_int), c_s), l));
      return live ? x : 0.f;
    };
    // ds = p (dp_int c_dp - delta[q]) scale
    auto dscore = [&](float p, int dp_int, float dl) {
      return __fmul_rn(
          __fmul_rn(p, __fsub_rn(__fmul_rn(__int2float_rn(dp_int), c_dp), dl)),
          scale);
    };

    qw_wait(full_kv, 0);
    int jq = 0;  // the q-block of the tiles being summed
    int next = bq_tiles;  // the first q tile of the next q-block
    scalars(0);
    if constexpr (STATS) {
      // max p and max|ds| of the block's share of q-block jq into the (head,
      // q-block)'s at its end
      float pm = 0.f, dsm = 0.f;
      auto flush = [&] {
        pm = qw_warp_max(pm);
        dsm = qw_warp_max(dsm);
        if (lane == 0) {
          const long long qb = static_cast<long long>(bh) * nqb + jq;
          atomicMax(reinterpret_cast<int*>(st.pmax + qb), __float_as_int(pm));
          atomicMax(reinterpret_cast<int*>(st.dsmax + qb), __float_as_int(dsm));
        }
        pm = dsm = 0.f;
      };
      for (int it = 0; it < n_qt; ++it) {
        if (it == next) {  // a new q-block
          flush();
          scalars(++jq);
          next += bq_tiles;
        }
        const int stg = it % L::STAGES;
        qw_wait(full(stg), (it / L::STAGES) & 1);
        int si[8][4], dpi[8][4];
        products(si, dpi, stg);
        const float* lse_t = reinterpret_cast<const float*>(g0 + (s_lse(stg) - s0));
        const float* delta_t =
            reinterpret_cast<const float*>(g0 + (s_delta(stg) - s0));
        wgmma_wait<1>();
        reg_fence(si);
        float p[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 l = *reinterpret_cast<const float2*>(lse_t + nt * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[nt][e] = prob(si[nt][e], (e & 1) ? l.y : l.x, (e >> 1) ? live1 : live0);
            pm = fmaxf(pm, p[nt][e]);
          }
        }
        wgmma_wait<0>();
        reg_fence(dpi);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 dl = *reinterpret_cast<const float2*>(delta_t + nt * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dsm = fmaxf(dsm, fabsf(dscore(p[nt][e], dpi[nt][e], (e & 1) ? dl.y : dl.x)));
        }
        mbar_arrive(empty(stg));  // q8, do8, lse, delta of the stage are read
      }
      flush();
    } else {
      // dK and dV of the consumer's keys, int32 over the q tiles of a
      // q-block; their fp32 sums over the q-blocks before it in shared
      // memory, 32 floats a thread each ([i][tid], bank by thread)
      int dka[8][4], dva[8][4];
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0;
      float* tot_k = reinterpret_cast<float*>(g0 + L::TOT) + c * 2 * 32 * 128 + tid;
      float* tot_v = tot_k + 32 * 128;
      // the position of the consumer's keys row0, row0 + 8 in the ds8 tile
      // (K8^T's seq_pos order)
      const int kp0 = seq_pos(row0), kp1 = seq_pos(row0 + 8);
      uint8_t* const ds_tile = g0 + L::DS + c * QW_TILE;
      const uint64_t ds_desc = sw64_desc(s0 + L::DS + c * QW_TILE);
      // B of dQ: the consumer's 64 keys of the K8^T rows (+64 c bytes)
      const uint64_t kt_desc = sw128_desc(skt) + 4 * c;
      // the int32 sums of q-block jq into the fp32 sums, exactly as dk +=
      // dk_int.float() (dst qs (1/127)) over the q-blocks in order
      auto fold = [&] {
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = (dt * 4 + e) * 128;
            const float xk = __fmul_rn(__int2float_rn(dka[dt][e]), c_dk);
            const float xv = __fmul_rn(__int2float_rn(dva[dt][e]), c_dv);
            tot_k[i] = jq == 0 ? xk : __fadd_rn(tot_k[i], xk);
            tot_v[i] = jq == 0 ? xv : __fadd_rn(tot_v[i], xv);
            dka[dt][e] = dva[dt][e] = 0;
          }
      };
      for (int it = 0; it < n_qt; ++it) {
        if (it == next) {  // a new q-block
          fold();
          scalars(++jq);
          next += bq_tiles;
        }
        const int stg = it % L::STAGES;
        qw_wait(full(stg), (it / L::STAGES) & 1);
        int si[8][4], dpi[8][4];  // S^T, dP^T: keys x the tile's q rows
        products(si, dpi, stg);
        const float* lse_t = reinterpret_cast<const float*>(g0 + (s_lse(stg) - s0));
        const float* delta_t =
            reinterpret_cast<const float*>(g0 + (s_delta(stg) - s0));
        // p8^T, then ds8^T, in the register-A layout: each k-step of 32 q
        // rows from four accumulator n-tiles as they lie (pack_a); each
        // ds8 code once into the ds8 tile
        wgmma_wait<1>();
        reg_fence(si);
        float p[8][4];
        uint32_t pf[2][4], dsf[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t x[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nt = 4 * kk + j;
            const float2 l = *reinterpret_cast<const float2*>(lse_t + nt * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              p[nt][e] = prob(si[nt][e], (e & 1) ? l.y : l.x, (e >> 1) ? live1 : live0);
              x[j][e] = qw_code(__fmul_rn(p[nt][e], c_p));
            }
          }
          pack_a(pf[kk], x);
        }
        wgmma_wait<0>();
        reg_fence(dpi);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t x[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nt = 4 * kk + j;
            const float2 dl = *reinterpret_cast<const float2*>(delta_t + nt * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              x[j][e] = qw_code(__fmul_rn(
                  dscore(p[nt][e], dpi[nt][e], (e & 1) ? dl.y : dl.x), c_ds));
              const int r = nt * 8 + 2 * t + (e & 1);  // q row of the tile
              ds_tile[qw_ds_at(r, (e >> 1) ? kp1 : kp0)] = static_cast<uint8_t>(x[j][e]);
            }
          }
          pack_a(dsf[kk], x);
        }

        // dV += P8^T.dO8, dK += dS8^T.Q8: A from registers, B the transposed
        // copies (d rows of the tile's 64 q positions, K-major)
        const uint64_t qt_desc = sw64_desc(stage(stg) + 2 * QW_TILE);
        const uint64_t dot_desc = sw64_desc(stage(stg) + 3 * QW_TILE);
        reg_fence(dka);
        reg_fence(dva);
        reg_fence(pf);
        reg_fence(dsf);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) wgmma_rs_s8_n64(dva, pf[kk], dot_desc + 2 * kk);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) wgmma_rs_s8_n64(dka, dsf[kk], qt_desc + 2 * kk);
        wgmma_commit();

        // dQ partial of the tile over this consumer's keys: A = its ds8 tile,
        // B = its K8^T rows
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
        int dqa[8][4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_ss_s8_n64(dqa, ds_desc + 2 * kk, kt_desc + 2 * kk, kk);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dqa);
        reg_fence(dka);
        reg_fence(dva);
        mbar_arrive(empty(stg));  // the stage's tiles, lse, delta are read
        // the partial in fragment order (qw_frag_at: 512 contiguous bytes a
        // warp), then one bulk add of its 16 KB into the q tile's dq sums;
        // a buffer is written again once its add has read it
        int* part = dq_part(it % QW_DQ_BUFS, c);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
          *reinterpret_cast<int4*>(part + ((warp * 8 + dt) * 32 + lane) * 4) =
              make_int4(dqa[dt][0], dqa[dt][1], dqa[dt][2], dqa[dt][3]);
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
        if (tid == 0) {
          bulk_add_s32(dq_acc + (static_cast<long long>(bh) * n_pad + it * QW_BQ) * 64,
                       smem_addr(part), QW_BQ * 64 * 4);
          bulk_wait_read<QW_DQ_BUFS - 1>();  // the next buffer is free
        }
      }

      if (tid == 0) bulk_wait_all();  // the bulk adds done
      // epilogue: the last q-block folded, dK and dV in bf16, masked keys
      // exactly zero, rows past N never stored
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= n) continue;
        const bool live = r == 0 ? live0 : live1;
        bf16* krow = dk + b * dks.b + h * dks.h +
                     static_cast<long long>(key) * dks.n + 2 * t;
        bf16* vrow = dv + b * dvs.b + h * dvs.h +
                     static_cast<long long>(key) * dvs.n + 2 * t;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          float xk[2], xv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * r + u;
            const int i = (dt * 4 + e) * 128;
            xk[u] = __fmul_rn(__int2float_rn(dka[dt][e]), c_dk);
            xv[u] = __fmul_rn(__int2float_rn(dva[dt][e]), c_dv);
            if (jq > 0) {
              xk[u] = __fadd_rn(tot_k[i], xk[u]);
              xv[u] = __fadd_rn(tot_v[i], xv[u]);
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(krow + dt * 8) =
              live ? __floats2bfloat162_rn(xk[0], xk[1])
                   : __floats2bfloat162_rn(0.f, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(vrow + dt * 8) =
              live ? __floats2bfloat162_rn(xv[0], xv[1])
                   : __floats2bfloat162_rn(0.f, 0.f);
        }
      }
    }
  }
}

// --------------------------------------------------------------- 5. dq ---
// dq = float(dq_int) (dst ks (1/127)), rounded to bf16 into its (B, N, H,
// 64) view; a thread takes 4 columns of a row
__global__ void __launch_bounds__(256)
attn_bwd_q8w_dq_kernel(const int* __restrict__ dq_acc, float* stats,
                       bf16* __restrict__ dq, int n_bh, int n, int n_pad,
                       int heads, int bq, int nqb, Strides dqs) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_bh) * n * 16) return;
  const int c4 = static_cast<int>(i & 15);
  const long long r = i >> 4;
  const int bh = static_cast<int>(r / n);
  const int row = static_cast<int>(r - static_cast<long long>(bh) * n);
  const QwStats st(stats, n_bh, static_cast<long long>(n_bh) * nqb);
  const float dst = fmaxf(st.dsmax[static_cast<long long>(bh) * nqb + row / bq], QW_EPS);
  const float c_dq = __fmul_rn(__fmul_rn(dst, qw_scale(st.kmax[bh])), QW_INV127);
  // columns 4 c4 .. 4 c4 + 3 of the row: two int2 in fragment order
  const int* tile = dq_acc + (static_cast<long long>(bh) * n_pad + (row & ~63)) * 64;
  const int2 lo = *reinterpret_cast<const int2*>(tile + qw_frag_at(row & 63, 4 * c4));
  const int2 hi = *reinterpret_cast<const int2*>(tile + qw_frag_at(row & 63, 4 * c4 + 2));
  const int4 a = make_int4(lo.x, lo.y, hi.x, hi.y);
  const int b = bh / heads;
  const int h = bh - b * heads;
  *reinterpret_cast<uint2*>(dq + b * dqs.b + h * dqs.h +
                            static_cast<long long>(row) * dqs.n + 4 * c4) =
      make_uint2(pack_bf16(__fmul_rn(__int2float_rn(a.x), c_dq),
                           __fmul_rn(__int2float_rn(a.y), c_dq)),
                 pack_bf16(__fmul_rn(__int2float_rn(a.z), c_dq),
                           __fmul_rn(__int2float_rn(a.w), c_dq)));
}

// --------------------------------------------------------------- host ---
// N_pad of the route: whole 128-key tiles of the main kernel, and at
// least the stats pass's 192, so no tensor map box is longer than a head's
// rows (a box past them is filled with zeros)
inline int qw_n_pad(int n) {
  return n <= 128 ? 256 : (n + 127) / 128 * 128;
}

// bytes of the int8 copies the route takes: seven (B H, N_pad, 64) planes
inline long long qw_bytes(int batch, int n, int heads) {
  return 7LL * batch * heads * qw_n_pad(n) * 64;
}

// floats of the scratch the route takes in delta's place (the port's
// wrapper allocates it): dq's int32 sums (B H, N_pad, 64), lse and delta
// (B H, N_pad) each
inline long long qw_scratch_floats(int batch, int n, int heads) {
  return static_cast<long long>(batch) * heads * qw_n_pad(n) * 66;
}

// the map of a (d2, d1, d0) uint8 array (rows of d0 bytes, contiguous),
// boxes of b1 rows of b0 bytes, zeros past the edges
inline bool encode_u8_3d(CUtensorMap* map, const void* ptr, long long d0,
                         long long d1, long long d2, int b0, int b1,
                         CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0),
                                 static_cast<cuuint64_t>(d0 * d1)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the launches after the amax pass on `stream`: quant, stats, main, dq.
// stats: the amax pass's buffer (4 (B H nqb) + 2 (B H) floats); bytes: 7
// (B H, N_pad, 64) planes; scratch: qw_scratch_floats; s: the strides of
// q, k, v, o, dout, dq, dk, dv
inline int launch_bwd_q8w(const bf16* q, const bf16* k, const bf16* v,
                          const bf16* o, const bf16* dout, const float* lse,
                          float* stats, uint8_t* bytes, float* scratch,
                          bf16* dq, bf16* dk, bf16* dv, int batch, int n,
                          int heads, int n_real, int bq, const Strides* s,
                          float sl, float scale, cudaStream_t cs) {
  const int n_bh = batch * heads;
  const int nqb = (n + bq - 1) / bq;
  const int n_pad = qw_n_pad(n);
  const long long rows = static_cast<long long>(n_bh) * n_pad;
  int* dq_acc = reinterpret_cast<int*>(scratch);
  float* lse_p = scratch + rows * 64;
  float* delta_p = lse_p + rows;
  const auto stats_kernel = attn_bwd_q8w_kernel<true>;
  const auto main_kernel = attn_bwd_q8w_kernel<false>;
  // once an instance, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  static const cudaError_t attr_s = cudaFuncSetAttribute(
      stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      QwLayout<true>::BYTES);
  static const cudaError_t attr_m = cudaFuncSetAttribute(
      main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      QwLayout<false>::BYTES);
  if (attr_s != cudaSuccess) return static_cast<int>(attr_s);
  if (attr_m != cudaSuccess) return static_cast<int>(attr_m);

  attn_bwd_q8w_quant_kernel<<<dim3(n_bh, n_pad / 64), 256, 0, cs>>>(
      q, k, v, o, dout, lse, stats, bytes, lse_p, delta_p, dq_acc, n, n_pad,
      heads, bq, nqb, s[0], s[1], s[2], s[3], s[4]);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const long long plane = rows * 64;
  constexpr int KS = QwLayout<true>::KB, KM = QwLayout<false>::KB;
  constexpr auto SW64 = CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tdo, tk, tv, tks, tvs, tqt, tdot, tkt;  // tks, tvs: stats'
  if (!encode_u8_3d(&tq, bytes, 64, n_pad, n_bh, 64, QW_BQ, SW64) ||
      !encode_u8_3d(&tk, bytes + plane, 64, n_pad, n_bh, 64, KM, SW64) ||
      !encode_u8_3d(&tv, bytes + 2 * plane, 64, n_pad, n_bh, 64, KM, SW64) ||
      !encode_u8_3d(&tks, bytes + plane, 64, n_pad, n_bh, 64, KS, SW64) ||
      !encode_u8_3d(&tvs, bytes + 2 * plane, 64, n_pad, n_bh, 64, KS, SW64) ||
      !encode_u8_3d(&tdo, bytes + 3 * plane, 64, n_pad, n_bh, 64, QW_BQ, SW64) ||
      !encode_u8_3d(&tqt, bytes + 4 * plane, n_pad, 64, n_bh, QW_BQ, 64, SW64) ||
      !encode_u8_3d(&tdot, bytes + 5 * plane, n_pad, 64, n_bh, QW_BQ, 64, SW64) ||
      !encode_u8_3d(&tkt, bytes + 6 * plane, n_pad, 64, n_bh, KM, 64,
                    CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  stats_kernel<<<(n + KS - 1) / KS * n_bh, 128 * (QwLayout<true>::NC + 1),
                 QwLayout<true>::BYTES, cs>>>(
      tq, tdo, tks, tvs, tqt, tdot, tkt, lse_p, delta_p, stats, dq_acc, dk,
      dv, n, n_pad, n_real, heads, bq, nqb, s[6], s[7], sl, scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  main_kernel<<<(n + KM - 1) / KM * n_bh, 128 * (QwLayout<false>::NC + 1),
                QwLayout<false>::BYTES, cs>>>(
      tq, tdo, tk, tv, tqt, tdot, tkt, lse_p, delta_p, stats, dq_acc, dk, dv,
      n, n_pad, n_real, heads, bq, nqb, s[6], s[7], sl, scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const long long items = static_cast<long long>(n_bh) * n * 16;
  attn_bwd_q8w_dq_kernel<<<static_cast<unsigned>((items + 255) / 256), 256, 0, cs>>>(
      dq_acc, stats, dq, n_bh, n, n_pad, heads, bq, nqb, s[5]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
