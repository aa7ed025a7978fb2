// The bf16 attention forward at head_dim 256 (129-256, zero-padded by the
// caller) on Hopper's asynchronous machinery (sm_90a): K2 (no lse) and K3a
// (lse), the route of maest_attn_fwd_bf16_d256 (attention_fwd.cu), which
// keeps the mma.sync FLASH instance at 256 (attn_fwd_bf16.cuh, q rows in
// shared memory) beside it as maest_attn_fwd_bf16_d256_mma.
//
// It computes what maest_tpu/ops/attention.py::_attn_kernel + _attn_body
// compute, as the kernels of attn_fwd_wgmma.cuh do: scores q.k scaled by
// sl = scale log2(e), keys >= n_real at -1e30, the running max m and sum l
// in fp32, p = exp2(s - m) in fp32 summed into l, p rounded to bf16 for
// P.V with fp32 sums, the output divided by l once at the end, lse = m +
// log2(l) (B, H, N) in the log2 domain the backward reads.
//
// What bounds it: the two products, 4 B H N^2 256 operations, at the bf16
// tensor-core peak (0.279 ms at (32, 1676, 3, 256)); exp2 counts N^2 a
// head, a quarter of head_dim 64's for the same operations.
//
// Why this shape: a consumer warpgroup's O over 64 rows x 256 columns takes
// 128 registers a thread, S and P of a 64-key tile 32 and 16 more. ptxas
// holds a kernel of more than 8 warps to 168 registers a thread (PERF.md),
// so a producer warp beside two consumers leaves too few, and the _dn
// kernel's answer (attn_fwd_dn_wgmma.cuh: output slices over the grid)
// forms S twice at 256 (3 products' worth for 2). This kernel has the two
// consumer warpgroups and no producer: 8 warps, up to 255 registers a
// thread, O whole, S made once.
//   - Grid: one block a (batch, head) and 128 query rows, the q tiles of a
//     head on neighbouring blocks (they read the same K and V from L2).
//   - TMA: q, k and v are read through 4-D tensor maps of their strided
//     (B, N, H, 256) views in boxes of 64 columns x 64 rows (8 KB) under
//     the 128-byte swizzle; rows past N arrive as zeros.
//   - Shared memory: q's 128 x 256 block stays resident (64 KB); a ring of
//     F2_STAGES 8 KB stages (160 KB, 2.5 key tiles) streams each 64-key
//     tile's four K chunks and then its four V chunks (items 8 it + c),
//     with full and empty mbarriers per stage.
//   - Loads: warpgroup 1's first thread issues them as predicated
//     instructions (every consumer thread runs the same code, so ptxas sees
//     no divergent path around the wgmma pipeline): q and the first
//     F2_STAGES items at the start, then, after each S and each P.V, where
//     no wgmma is in flight, warpgroup 1 refills every stage whose item it
//     has released (warpgroup 0, a turn ahead, has released it too).
//   - Turns: the two warpgroups take turns to issue their products through
//     named barriers (warpgroup 0 first; two turns a key tile, S then
//     P.V), so one's softmax runs under the other's products. On an H100
//     the kernel ran faster with the turns than without; issuing a tile's
//     S together with the tile before's P.V (two P's in registers, 223-234
//     of them) ran slower, with turns or without.
//   - Products: S = Q.K^T by wgmma m64n64k16 with both operands from
//     shared-memory descriptors (K-major), 4 k-steps a chunk, the four
//     chunks one commit group; O += P.V by wgmma m64n64k16 a V chunk with
//     P from registers (the accumulator layout of S is the register-A
//     layout) and V MN-major through the transpose bit, as
//     attn_fwd_dn_wgmma.cuh does, one commit group.
//   - Stores: each row's bf16 output gathered into 16-byte chunks
//     (quad_chunks) before it is written.

#pragma once

#include "attn_fwd_wgmma.cuh"

namespace maest {

constexpr int F2_D = 256;                  // head_dim
constexpr int F2_CH = F2_D / 64;           // 64-column chunks of a row
constexpr int F2_BQ = 128;                 // query rows a block
constexpr int F2_BK = 64;                  // keys a tile
constexpr int F2_ITEMS = 2 * F2_CH;        // ring items a key tile: K, V
constexpr int F2_STAGES = 20;              // the ring's 8 KB stages
constexpr uint32_t F2_STAGE = F2_BK * 128;     // a K or V chunk of a tile
constexpr uint32_t F2_QCHUNK = F2_BQ * 128;    // q's 128 rows of a chunk
constexpr int F2_THREADS = 256;            // two consumer warpgroups
constexpr int F2_BAR_BYTES = 512;
static_assert(F2_BK == 64 && F2_BQ == 128, "a consumer's wgmma rows are 64");
static_assert(F2_STAGES > F2_ITEMS, "the ring holds a key tile and more");

__host__ __device__ constexpr int f2_smem_bytes() {
  return 1024 + F2_CH * static_cast<int>(F2_QCHUNK) +
         F2_STAGES * static_cast<int>(F2_STAGE) + F2_BAR_BYTES;
}
static_assert(f2_smem_bytes() <= 227 * 1024, "q and the ring");
static_assert(8 * (1 + 2 * F2_STAGES) <= F2_BAR_BYTES, "the mbarriers");

// grid (B H ceil(N / 128)), F2_THREADS threads; tq, tk, tv: the maps of the
// (B, N, H, 256) views in boxes of 64 columns x 64 rows
__global__ void __launch_bounds__(F2_THREADS, 1)
attn_fwd_d256_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int n, int n_real, int heads, Strides os,
                           float sl) {
  extern __shared__ uint8_t f2_smem[];
  const uint32_t sq = (smem_addr(f2_smem) + 1023u) & ~1023u;
  const uint32_t ring = sq + F2_CH * F2_QCHUNK;
  const uint32_t bars = ring + F2_STAGES * F2_STAGE;  // 8 bytes each
  const uint32_t full_q = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + F2_STAGES + s); };

  const int q_tiles = (n + F2_BQ - 1) / F2_BQ;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = (blockIdx.x - bh * q_tiles) * F2_BQ;
  const int n_tiles = (n_real + F2_BK - 1) / F2_BK;
  const int total = n_tiles * F2_ITEMS;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // uniform
  const bool issuer = threadIdx.x == 128;  // warpgroup 1's first thread

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < F2_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // item i (K chunk i % 8 of key tile i / 8, or V chunk i % 8 - 4) into its
  // stage, from the issuer only
  auto load_item = [&](int i) {
    const int s = i % F2_STAGES;
    const int c = i % F2_ITEMS;
    const uint32_t dst = ring + s * F2_STAGE;
    mbar_expect_tx_if(issuer, full(s), F2_STAGE);
    tma_load_4d_if(issuer, dst, c < F2_CH ? &tk : &tv, full(s),
                   64 * (c % F2_CH), h, (i / F2_ITEMS) * F2_BK, b);
  };
  mbar_expect_tx_if(issuer, full_q, F2_CH * F2_QCHUNK);
#pragma unroll
  for (int c = 0; c < F2_CH; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      tma_load_4d_if(issuer, sq + c * F2_QCHUNK + half * F2_STAGE, &tq, full_q,
                     64 * c, h, q0 + 64 * half, b);
  int issued = 0;  // items issued (warpgroup 1 keeps the count)
  for (; issued < F2_STAGES && issued < total; ++issued) load_item(issued);

  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t rows = wg * F2_STAGE;  // its rows' offset in a q chunk

  float o[F2_CH][8][4];
#pragma unroll
  for (int vc = 0; vc < F2_CH; ++vc)
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[vc][dt][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float s[F2_BK / 8][4];    // scores
  uint32_t pf[F2_BK / 16][4];  // p in bf16: the A fragments of P.V

  int st = 0;  // the ring position of the next item
  uint32_t ph = 0;
  int done = 0;  // items this warpgroup has released
  auto take = [&] {  // waits for the next item; its stage
    const int mine = st;
    qw_wait(full(st), ph);
    if (++st == F2_STAGES) {
      st = 0;
      ph ^= 1;
    }
    return mine;
  };
  auto release = [&](int stage) {
    mbar_arrive(empty(stage));
    ++done;
  };
  // warpgroup 1, no wgmma in flight: every stage whose item it has
  // released is refilled with the item F2_STAGES on, once warpgroup 0 (a
  // turn ahead) has released it too
  auto refill = [&] {
    if (wg != 1) return;
    for (; issued < total && issued - F2_STAGES < done; ++issued) {
      qw_wait(empty(issued % F2_STAGES), (issued / F2_STAGES - 1) & 1);
      load_item(issued);
    }
  };

  // turns: warpgroup c issues its products after named barrier 1 + c and
  // then lets the other go, so one's softmax runs under the other's
  // products; two turns a key tile (S, then P.V), warpgroup 0 first
  // (warpgroup 1's hand-over ahead of any turn), and warpgroup 1's last
  // turn hands over to no one
  const int turns = 2 * n_tiles;
  int turn = 0;
  auto take_turn = [&] {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto pass_turn = [&] {
    if (!(wg == 1 && turn == turns - 1))
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    ++turn;
  };
  if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

  int held[F2_CH];  // the stages of the chunks in flight
  qw_wait(full_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    // s = Q.K^T, the four K chunks in one commit group; the first product
    // overwrites s
    take_turn();
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < F2_CH; ++c) {
      held[c] = take();
      const uint64_t da = sw128_desc(sq + c * F2_QCHUNK + rows);
      const uint64_t db = sw128_desc(ring + held[c] * F2_STAGE);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // +32 bytes a k-step
        wgmma_ss<F2_BK>(s, da + 2 * kk, db + 2 * kk, c | kk);
    }
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    reg_fence(s);
#pragma unroll
    for (int c = 0; c < F2_CH; ++c) release(held[c]);
    refill();

    // the softmax of this tile: masked scores, the new running max, o
    // rescaled, p summed in fp32 and packed into P's bf16 A fragments
    // (n-tiles 2j, 2j + 1 of the scores form k-step j)
    const int base = it * F2_BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < F2_BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = base + nt * 8 + 2 * t + (e & 1);
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
    for (int vc = 0; vc < F2_CH; ++vc)
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[vc][dt][e] *= corr[e >> 1];
#pragma unroll
    for (int nt = 0; nt < F2_BK / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - m[0]);
      const float p1 = exp2f(s[nt][1] - m[0]);
      const float p2 = exp2f(s[nt][2] - m[1]);
      const float p3 = exp2f(s[nt][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // o += P.V over the four V chunks in one commit group
#pragma unroll
    for (int i = 0; i < F2_CH; ++i) reg_fence(o[i]);
    reg_fence(pf);
    take_turn();
    wgmma_fence();
#pragma unroll
    for (int vc = 0; vc < F2_CH; ++vc) {
      held[vc] = take();
      const uint64_t dv = sw128_desc(ring + held[vc] * F2_STAGE);
#pragma unroll
      for (int kj = 0; kj < F2_BK / 16; ++kj)  // +2048 bytes: 16 rows
        wgmma_rs_n64_t(o[vc], pf[kj], dv + kj * 128);
    }
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < F2_CH; ++i) reg_fence(o[i]);
    reg_fence(pf);
#pragma unroll
    for (int vc = 0; vc < F2_CH; ++vc) release(held[vc]);
    refill();
  }

  // epilogue: o / l in bf16, rows past N never stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // each row's 64-column chunks gathered into 16-byte pieces
  // (quad_chunks) before they are stored
  const int row0 = q0 + wg * 64 + warp * 16 + g;  // and row0 + 8
  bf16* ob = out + b * os.b + h * os.h + 8 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    bf16* orow = ob + static_cast<long long>(row) * os.n;
#pragma unroll
    for (int vc = 0; vc < F2_CH; ++vc) {
      uint32_t w[8];
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        w[dt] = pack_bf16(o[vc][dt][2 * r] / l[r], o[vc][dt][2 * r + 1] / l[r]);
      uint4 c0, c1;
      quad_chunks(w, t, c0, c1);
      if (row < n) {
        *reinterpret_cast<uint4*>(orow + 64 * vc) = c0;
        *reinterpret_cast<uint4*>(orow + 64 * vc + 32) = c1;
      }
    }
    if (lse != nullptr && t == 0 && row < n)
      lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
  }
}

// one launch on `stream`, arguments as maest_attn_fwd_bf16_d256's
inline int launch_fwd_d256_wgmma(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int batch, int n,
                                 int heads, int n_real, const long long* st,
                                 float sl, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  constexpr int smem = f2_smem_bytes();
  // once, before any launch a graph captures; the setting holds for the
  // current device only: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_d256_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  if (!encode_bnh64(&tq, q, batch, n, heads, qs, 64, F2_D) ||
      !encode_bnh64(&tk, k, batch, n, heads, ks, F2_BK, F2_D) ||
      !encode_bnh64(&tv, v, batch, n, heads, vs, F2_BK, F2_D))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid =
      static_cast<long long>((n + F2_BQ - 1) / F2_BQ) * batch * heads;
  attn_fwd_d256_wgmma_kernel<<<static_cast<unsigned>(grid), F2_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, n, n_real, heads, os, sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
