// The bf16 attention backward at head_dim 256 (129-256, zero-padded by the
// caller) on Hopper's asynchronous machinery (sm_90a): K3b and K4 at that
// width, the route of maest_attn_bwd_bf16_d256 (attention_bwd.cu), which
// keeps the mma.sync kernels of launch_bwd_bf16<WARPS, TILE, 256> beside it
// as maest_attn_bwd_bf16_d256_mma.
//
// It computes what maest_tpu/ops/attention.py::_attn_bwd_kernel +
// _bwd_body (and the split _bwd_dq_kernel / _bwd_dkv_kernel) compute:
//   delta = rowsum(do * o)                      (fp32, the prep pass)
//   p     = exp2(q.k * sl - lse)                keys >= n_real: p = 0
//   dv   += p^T . do        p rounded to bf16
//   dp    = do . v^T
//   ds    = p * (dp - delta) * scale            rounded to bf16
//   dk   += ds^T . q        dq += ds . k
// with fp32 sums; dq, dk and dv are stored in bf16. Masked keys get
// exactly zero dk and dv; query rows >= n_real still contribute.
//
// What bounds it: 5 products of N^2 256 per (batch, head), as at head_dim
// 64 for a quarter of the heads (0.186 ms at the bf16 tensor-core peak at
// (32, 866, 3, 256)); the N^2 exp2 is a quarter of head_dim 64's for the
// same operations. This design forms S and dP twice (once for dk/dv, once
// for dq): 7 products, a floor of 0.26 ms.
//
// Why this shape: a 64-key warpgroup's dK or dV sums at head_dim 256 take
// 64 x 256 fp32 / 128 threads = 128 registers a thread, and ptxas holds a
// kernel of more than 8 warps to 168 registers a thread (attn_fwd_dn_
// wgmma.cuh), so one warpgroup cannot hold both, and the head_dim-64
// design (attn_bwd_wgmma.cuh: dK, dV and a dQ partial in one consumer)
// does not carry over. Two kernels after the prep pass, each with two
// consumer warpgroups that split one tile's work:
//   - dk/dv (attn_bwd_dkv_d256_kernel): a block owns 64 keys, their K and
//     V rows loaded once (4 chunks of 64 columns each, 128-byte swizzle),
//     and streams every q tile of B2_BQ = 64 rows (q, do, lse, delta)
//     through a ring of B2_QSTAGES. Consumer 0 forms S^T = K.Q^T (m64n64,
//     16 k-steps), p^T = exp2(s sl - lse), hands p^T in fp32 to consumer 1
//     through a double buffer in shared memory, and adds P^T.dO to dV with
//     p^T in bf16 as register A fragments (the accumulator layout of S^T).
//     Consumer 1 forms dP^T = V.dO^T, takes p^T, forms ds^T and adds dS^T.Q
//     to dK the same way. dV and dK stay in registers (128 each) over every
//     q tile; S^T or dP^T take 32 more, their bf16 fragments 16. So the
//     kernel has these two warpgroups and no producer (8 warps, up to 255
//     registers a thread): thread 0 issues the loads as predicated
//     instructions, a stage's refill after consumer 0 has waited for it to
//     be released. Two stages of 64-row tiles fill 226 KB of shared
//     memory.
//   - dq (attn_bwd_dq_d256_kernel): a block owns 64 q rows, q and do loaded
//     once, and streams every real key tile of 64 (K and V) through a ring
//     of B2_KSTAGES, loaded by a producer warp (its consumers hold 152
//     registers). Consumer 0 forms S = Q.K^T and p, hands p in fp32 to
//     consumer 1, which forms dP = dO.V^T and ds and hands ds in bf16 back
//     (128-byte swizzled, the A operand of a wgmma). Each adds dS.K to half
//     of dQ's columns (64 registers): consumer 0 with dS from shared memory,
//     consumer 1 from its registers; K is read MN-major through the
//     descriptor's transpose bit. Consumer 0 issues the next tile's S
//     before it waits for ds, so S runs under consumer 1's ds arithmetic.
// Every sum is taken in one fixed order (dk, dv over q tiles, dq over key
// tiles, each in increasing order, in registers): no atomics, two runs are
// bit-equal. Key blocks wholly at or past n_real store zero dk and dv and
// stream nothing. The prep pass (attn_bwd_prep_kernel<256>) computes delta
// as attention_bwd.cu's delta kernel sums it, into (B H, N_pad) with lse
// beside it (rows past N at +1e30: p = 0).
//
// q, k, v, o and do are the strided (B, N, H, 256) views of the fused qkv
// (and the output gradient), read in place through 4-D tensor maps.

#pragma once

#include "attn_bwd_wgmma.cuh"  // the prep pass, bulk loads, mbarriers, TMA,
                               // descriptors, wgmma, maps

namespace maest {

// d (64 x 64, fp32) (+)= A (64 x 16, shared memory, K-major) . B (16 x 64,
// shared memory, MN-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64_kt(float (&d)[8][4], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// attn_fwd_wgmma.cuh's predicated loads (mbar_expect_tx_if,
// tma_load_4d_if), and a bulk copy likewise
__device__ __forceinline__ void bulk_load_if(bool on, uint32_t dst,
                                             const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%1], [%2], %3, [%4];\n}\n" ::"r"(static_cast<int>(on)),
      "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

constexpr int B2_D = 256;                    // head_dim
constexpr int B2_CH = B2_D / 64;             // 64-column chunks of a row
constexpr uint32_t B2_ROWS64 = 64 * 128;     // a chunk of 64 rows (8 KB)
constexpr uint32_t B2_ROWS = B2_CH * B2_ROWS64;  // 64 whole rows (32 KB)
constexpr int B2_KEYS = 64;       // keys a dk/dv block
constexpr int B2_BQ = 64;         // q rows a streamed tile of dk/dv
constexpr int B2_QSTAGES = 2;     // its q/do tiles in flight
constexpr int B2_QROWS = 64;      // q rows a dq block
constexpr int B2_BK = 64;         // keys a streamed tile of dq
constexpr int B2_KSTAGES = 2;     // its K/V tiles in flight
constexpr int B2_PAD = 64;        // the padded lse/delta rows: a multiple of it
constexpr int B2_DKV_THREADS = 256;       // the dk/dv kernel's two warpgroups
constexpr int B2_DQ_THREADS = 256 + 32;   // the dq kernel's, and a producer warp
static_assert(B2_KEYS == 64 && B2_QROWS == 64 && B2_BK == 64,
              "a consumer warpgroup's wgmma rows are 64");

// dynamic shared memory of the dk/dv kernel: 1024 bytes of alignment
// slack, K and V rows, per stage a q and a do tile and their lse and
// delta, two p^T buffers (64 x 64 fp32), the mbarriers; as many stages as
// fit beside the rest in the 227 KB a block may take
__host__ __device__ constexpr int b2_dkv_smem_bytes() {
  return 1024 + 2 * static_cast<int>(B2_ROWS) +
         B2_QSTAGES * (2 * B2_CH * B2_BQ * 128 + 2 * B2_BQ * 4) +
         2 * B2_KEYS * B2_BQ * 4 + 8 * (1 + 2 * B2_QSTAGES + 4);
}
static_assert(b2_dkv_smem_bytes() <= 227 * 1024, "the dk/dv kernel's ring");

// of the dq kernel: the slack, q and do rows, per stage a K and a V tile,
// the p buffer (64 x 64 fp32), the ds tile (64 x 64 bf16), the mbarriers
__host__ __device__ constexpr int b2_dq_smem_bytes() {
  return 1024 + 2 * static_cast<int>(B2_ROWS) +
         B2_KSTAGES * 2 * static_cast<int>(B2_ROWS) + B2_QROWS * B2_BK * 4 +
         B2_QROWS * 128 + 8 * (1 + 2 * B2_KSTAGES + 4);
}

// grid (B H ceil(N / 64)), the key blocks of one (b, h) on neighbouring
// blocks, B2_DKV_THREADS threads; tq, tdo: maps of the (B, N, H, 256) q and
// do views with boxes of B2_BQ rows; tk, tv of k and v with boxes of 64
// rows;
// lse_p, delta_p (B H, n_pad) from the prep pass. Two warpgroups and no
// producer: at more than 8 warps ptxas holds a thread to 168 registers,
// and a consumer's 128 registers of dV or dK, 32 of S^T or dP^T and 16 of
// their bf16 fragments spilled there (168 registers, 128 bytes, its wgmma
// serialised: C7512). Thread 0 issues the loads, each
// predicated on it, after consumer 0 has waited (all its threads alike)
// for the stage to be released.
__global__ void __launch_bounds__(B2_DKV_THREADS, 1)
attn_bwd_dkv_d256_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse_p,
                         const float* __restrict__ delta_p,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
                         int n_pad, int n_real, int heads, Strides dks,
                         Strides dvs, float sl, float scale) {
  constexpr int BQ = B2_BQ;
  constexpr int STAGES = B2_QSTAGES;
  constexpr uint32_t CHUNK = BQ * 128;          // a 64-column chunk of a tile
  constexpr uint32_t TILE = B2_CH * CHUNK;      // a q or do tile
  constexpr uint32_t LD = 2 * BQ * 4;           // a stage's lse and delta
  constexpr uint32_t PBUF = B2_KEYS * BQ * 4;   // a p^T buffer
  extern __shared__ uint8_t b2_smem[];
  const uint32_t s0 = (smem_addr(b2_smem) + 1023u) & ~1023u;
  uint8_t* const g0 = b2_smem + (s0 - smem_addr(b2_smem));  // s0, generic
  const uint32_t sk = s0;
  const uint32_t sv = sk + B2_ROWS;
  const uint32_t ring = sv + B2_ROWS;                // stage s: q, then do
  const uint32_t sld = ring + STAGES * 2 * TILE;     // stage s: lse, delta
  const uint32_t spb = sld + STAGES * LD;            // p^T buffers
  const uint32_t bars = spb + 2 * PBUF;
  auto sq = [&](int s) { return ring + 2 * s * TILE; };
  auto sdo = [&](int s) { return ring + (2 * s + 1) * TILE; };
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto p_full = [&](int j) { return bars + 8 * (1 + 2 * STAGES + j); };
  auto p_empty = [&](int j) { return bars + 8 * (3 + 2 * STAGES + j); };

  const int n_kb = (n + B2_KEYS - 1) / B2_KEYS;
  const int bh = blockIdx.x / n_kb;
  const int kb = blockIdx.x - bh * n_kb;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = kb * B2_KEYS;

  if (k0 >= n_real) {  // every key masked: zero dk and dv, no q tile
    const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = threadIdx.x; i < B2_KEYS * B2_D / 2; i += blockDim.x) {
      const int key = k0 + i / (B2_D / 2);
      if (key >= n) break;
      const int col = (i % (B2_D / 2)) * 2;
      *reinterpret_cast<__nv_bfloat162*>(
          dk + b * dks.b + h * dks.h + static_cast<long long>(key) * dks.n +
          col) = z;
      *reinterpret_cast<__nv_bfloat162*>(
          dv + b * dvs.b + h * dvs.h + static_cast<long long>(key) * dvs.n +
          col) = z;
    }
    return;
  }
  const int n_qt = (n + BQ - 1) / BQ;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // uniform
  const bool issuer = threadIdx.x == 0;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread releases
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mbar_init(p_full(j), 128);
      mbar_init(p_empty(j), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads of q tile `it` (q, do, lse, delta) into its stage, from the
  // issuer only
  const float* lse_row = lse_p + static_cast<long long>(bh) * n_pad;
  const float* delta_row = delta_p + static_cast<long long>(bh) * n_pad;
  auto load_tile = [&](int it) {
    const int s = it % STAGES;
    mbar_expect_tx_if(issuer, full(s), 2 * TILE + LD);
#pragma unroll
    for (int c = 0; c < B2_CH; ++c) {
      tma_load_4d_if(issuer, sq(s) + c * CHUNK, &tq, full(s), 64 * c, h,
                     it * BQ, b);
      tma_load_4d_if(issuer, sdo(s) + c * CHUNK, &tdo, full(s), 64 * c, h,
                     it * BQ, b);
    }
    bulk_load_if(issuer, sld + s * LD, lse_row + it * BQ, BQ * 4, full(s));
    bulk_load_if(issuer, sld + s * LD + BQ * 4, delta_row + it * BQ, BQ * 4,
                 full(s));
  };
  mbar_expect_tx_if(issuer, full_kv, 2 * B2_ROWS);
#pragma unroll
  for (int c = 0; c < B2_CH; ++c) {
    tma_load_4d_if(issuer, sk + c * B2_ROWS64, &tk, full_kv, 64 * c, h, k0, b);
    tma_load_4d_if(issuer, sv + c * B2_ROWS64, &tv, full_kv, 64 * c, h, k0, b);
  }
  for (int it = 0; it < STAGES && it < n_qt; ++it) load_tile(it);

  // wg 0 owns dV (S^T, p^T); wg 1 owns dK (dP^T, ds^T)
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = k0 + 16 * warp + g;  // accumulator rows: key0, key0 + 8
  const bool live0 = key0 < n_real, live1 = key0 + 8 < n_real;
  const uint32_t lhs = wg == 0 ? sk : sv;  // A of S^T (K) or dP^T (V)

  float acc[B2_CH][8][4];  // dV or dK of the 64 keys, a chunk of 64 columns
#pragma unroll
  for (int c = 0; c < B2_CH; ++c)
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][dt][e] = 0.f;
  float x[BQ / 8][4];        // S^T, then p^T in fp32; or dP^T
  uint32_t af[BQ / 16][4];   // p^T or ds^T in bf16: the A fragments

  qw_wait(full_kv, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int st = it % STAGES;
    qw_wait(full(st), (it / STAGES) & 1);
    // S^T = K.Q^T or dP^T = V.dO^T over the 4 chunks of d (+32 bytes a
    // k-step of 16 columns)
    const uint32_t rhs = wg == 0 ? sq(st) : sdo(st);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < B2_CH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<BQ>(x, sw128_desc(lhs + c * B2_ROWS64) + 2 * kk,
                     sw128_desc(rhs + c * CHUNK) + 2 * kk, c | kk);
    wgmma_commit();
    wgmma_wait<0>();  // and the dV or dK products of the tile before
    reg_fence(x);
#pragma unroll
    for (int c = 0; c < B2_CH; ++c) reg_fence(acc[c]);
    reg_fence(af);
    if (it > 0) {
      const int done = it - 1;  // both warpgroups are through with it
      mbar_arrive(empty(done % STAGES));
      if (wg == 0 && done + STAGES < n_qt) {
        // its stage refilled with tile done + STAGES once consumer 1 has
        // released it too
        qw_wait(empty(done % STAGES), (done / STAGES) & 1);
        load_tile(done + STAGES);
      }
    }

    const int j = it & 1;  // the p^T buffer, and its phase
    const uint32_t jph = (it >> 1) & 1;
    float* pb = reinterpret_cast<float*>(g0 + (spb + j * PBUF - s0));
    const float* lt =
        reinterpret_cast<const float*>(g0 + (sld + st * LD - s0));
    if (wg == 0) {
      // p^T = exp2(s sl - lse[q]), keys >= n_real at 0; handed over in
      // fp32 (each thread its own 4 values of an n-tile as one float4,
      // thread-major), kept in bf16
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const float2 l = *reinterpret_cast<const float2*>(lt + nt * 8 + 2 * t);
        x[nt][0] = live0 ? exp2f(x[nt][0] * sl - l.x) : 0.f;
        x[nt][1] = live0 ? exp2f(x[nt][1] * sl - l.y) : 0.f;
        x[nt][2] = live1 ? exp2f(x[nt][2] * sl - l.x) : 0.f;
        x[nt][3] = live1 ? exp2f(x[nt][3] * sl - l.y) : 0.f;
      }
      qw_wait(p_empty(j), jph ^ 1);  // the first round passes at once
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
        reinterpret_cast<float4*>(pb)[nt * 128 + tid] =
            make_float4(x[nt][0], x[nt][1], x[nt][2], x[nt][3]);
      mbar_arrive(p_full(j));
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        af[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(x[nt][0], x[nt][1]);
        af[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(x[nt][2], x[nt][3]);
      }
    } else {
      // ds^T = p^T (dP^T - delta[q]) scale in bf16
      const float* dl = lt + BQ;
      qw_wait(p_full(j), jph);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const float2 d = *reinterpret_cast<const float2*>(dl + nt * 8 + 2 * t);
        const float4 p = reinterpret_cast<const float4*>(pb)[nt * 128 + tid];
        af[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(
            p.x * (x[nt][0] - d.x) * scale, p.y * (x[nt][1] - d.y) * scale);
        af[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(
            p.z * (x[nt][2] - d.x) * scale, p.w * (x[nt][3] - d.y) * scale);
      }
      mbar_arrive(p_empty(j));
    }

    // dV += P^T.dO or dK += dS^T.Q: A from registers, B (do or q, BQ rows
    // of each chunk) MN-major, +2048 bytes a k-step of 16 rows
    const uint32_t rows = wg == 0 ? sdo(st) : sq(st);
#pragma unroll
    for (int c = 0; c < B2_CH; ++c) reg_fence(acc[c]);
    reg_fence(af);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < B2_CH; ++c)
#pragma unroll
      for (int kj = 0; kj < BQ / 16; ++kj)
        wgmma_rs_n64_t(acc[c], af[kj], sw128_desc(rows + c * CHUNK) + kj * 128);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < B2_CH; ++c) reg_fence(acc[c]);

  // epilogue: dV (wg 0) or dK (wg 1) in bf16, masked keys exactly zero,
  // rows past N never stored
  bf16* out = wg == 0 ? dv + b * dvs.b + h * dvs.h : dk + b * dks.b + h * dks.h;
  const long long ld = wg == 0 ? dvs.n : dks.n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= n) continue;
    const bool live = r == 0 ? live0 : live1;
    bf16* row = out + static_cast<long long>(key) * ld + 2 * t;
#pragma unroll
    for (int c = 0; c < B2_CH; ++c)
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(row + c * 64 + dt * 8) =
            live ? __floats2bfloat162_rn(acc[c][dt][2 * r], acc[c][dt][2 * r + 1])
                 : __floats2bfloat162_rn(0.f, 0.f);
  }
}

// grid (B H ceil(N / 64)), B2_DQ_THREADS threads; tq, tk, tv, tdo: maps of
// the (B, N, H, 256) views with boxes of 64 rows; lse_p, delta_p (B H,
// n_pad) from the prep pass
__global__ void __launch_bounds__(B2_DQ_THREADS, 1)
attn_bwd_dq_d256_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse_p,
                        const float* __restrict__ delta_p,
                        bf16* __restrict__ dq, int n, int n_pad, int n_real,
                        int heads, Strides dqs, float sl, float scale) {
  extern __shared__ uint8_t b2_smem[];
  const uint32_t s0 = (smem_addr(b2_smem) + 1023u) & ~1023u;
  uint8_t* const g0 = b2_smem + (s0 - smem_addr(b2_smem));  // s0, generic
  const uint32_t sq = s0;
  const uint32_t sdo = sq + B2_ROWS;
  const uint32_t ring = sdo + B2_ROWS;  // stage s: K, then V
  const uint32_t spb = ring + B2_KSTAGES * 2 * B2_ROWS;  // p, 64 x 64 fp32
  const uint32_t sds = spb + B2_QROWS * B2_BK * 4;       // ds, 64 x 64 bf16
  const uint32_t bars = sds + B2_QROWS * 128;
  auto skt = [&](int s) { return ring + 2 * s * B2_ROWS; };
  const uint32_t full_q = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + B2_KSTAGES + s); };
  const uint32_t p_full = bars + 8 * (1 + 2 * B2_KSTAGES);
  const uint32_t p_empty = p_full + 8;
  const uint32_t ds_full = p_full + 16;
  const uint32_t ds_empty = p_full + 24;

  const int n_qb = (n + B2_QROWS - 1) / B2_QROWS;
  const int bh = blockIdx.x / n_qb;
  const int q0 = (blockIdx.x - bh * n_qb) * B2_QROWS;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int n_kt = (n_real + B2_BK - 1) / B2_BK;  // key tiles with a real key
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // uniform

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < B2_KSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread releases
    }
    mbar_init(p_full, 128);
    mbar_init(p_empty, 128);
    mbar_init(ds_full, 128);
    mbar_init(ds_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------ the producer warp
    if (threadIdx.x == 256) {
      mbar_expect_tx(full_q, 2 * B2_ROWS);
#pragma unroll
      for (int c = 0; c < B2_CH; ++c) {
        tma_load_4d(sq + c * B2_ROWS64, &tq, full_q, 64 * c, h, q0, b);
        tma_load_4d(sdo + c * B2_ROWS64, &tdo, full_q, 64 * c, h, q0, b);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % B2_KSTAGES;
        qw_wait(empty(s), ((it / B2_KSTAGES) & 1) ^ 1);  // first round at once
        mbar_expect_tx(full(s), 2 * B2_ROWS);
#pragma unroll
        for (int c = 0; c < B2_CH; ++c) {
          tma_load_4d(skt(s) + c * B2_ROWS64, &tk, full(s), 64 * c, h,
                      it * B2_BK, b);
          tma_load_4d(skt(s) + B2_ROWS + c * B2_ROWS64, &tv, full(s), 64 * c,
                      h, it * B2_BK, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  // wg 0: S, p and dQ's columns 0-127; wg 1: dP, ds and columns 128-255
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = 16 * warp + g;  // accumulator rows: q0 + row0, + 8
  // this thread's rows' lse (wg 0) or delta (wg 1); rows past N padded
  const float* side = (wg == 0 ? lse_p : delta_p) +
                      static_cast<long long>(bh) * n_pad + q0 + row0;
  const float r0 = side[0], r1 = side[8];
  const uint32_t lhs = wg == 0 ? sq : sdo;  // A of S (q) or dP (do)
  float* pb = reinterpret_cast<float*>(g0 + (spb - s0));
  uint8_t* dst = g0 + (sds - s0);

  float x[B2_BK / 8][4];   // S, then p in fp32; or dP
  float acc[2][8][4];      // dQ's columns 128 wg + 64 c ..
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][dt][e] = 0.f;
  uint32_t dsf[B2_BK / 16][4];  // ds in bf16 (wg 1): the A fragments

  // S = Q.K^T or dP = dO.V^T of key tile it, both operands K-major
  auto issue_x = [&](int it) {
    const int st = it % B2_KSTAGES;
    qw_wait(full(st), (it / B2_KSTAGES) & 1);
    const uint32_t rhs = skt(st) + (wg == 0 ? 0u : B2_ROWS);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < B2_CH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(x, sw128_desc(lhs + c * B2_ROWS64) + 2 * kk,
                     sw128_desc(rhs + c * B2_ROWS64) + 2 * kk, c | kk);
    wgmma_commit();
  };

  qw_wait(full_q, 0);
  issue_x(0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % B2_KSTAGES;
    const uint32_t ph = it & 1;
    wgmma_wait<0>();  // x of this tile, and the dQ products of the one before
    reg_fence(x);
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    reg_fence(dsf);
    if (it > 0) {
      if (wg == 0) mbar_arrive(ds_empty);  // its dQ products read ds
      mbar_arrive(empty((it - 1) % B2_KSTAGES));
    }
    if (wg == 0) {
      // p = exp2(s sl - lse), keys >= n_real at 0, handed over in fp32
      // (each thread's 4 values of an n-tile as one float4, thread-major)
      const int base = it * B2_BK;
#pragma unroll
      for (int nt = 0; nt < B2_BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = base + nt * 8 + 2 * t + (e & 1);
          x[nt][e] = key < n_real ? exp2f(x[nt][e] * sl - (e < 2 ? r0 : r1))
                                  : 0.f;
        }
      qw_wait(p_empty, ph ^ 1);  // the first round passes at once
#pragma unroll
      for (int nt = 0; nt < B2_BK / 8; ++nt)
        reinterpret_cast<float4*>(pb)[nt * 128 + tid] =
            make_float4(x[nt][0], x[nt][1], x[nt][2], x[nt][3]);
      mbar_arrive(p_full);
    } else {
      // ds = p (dP - delta) scale in bf16: its A fragments, and once into
      // shared memory, 128-byte swizzled (chunk nt ^ row % 8), for wg 0
      qw_wait(p_full, ph);
      qw_wait(ds_empty, ph ^ 1);  // the first round passes at once
#pragma unroll
      for (int nt = 0; nt < B2_BK / 8; ++nt) {
        const float4 p = reinterpret_cast<const float4*>(pb)[nt * 128 + tid];
        const uint32_t lo = pack_bf16(p.x * (x[nt][0] - r0) * scale,
                                      p.y * (x[nt][1] - r0) * scale);
        const uint32_t hi = pack_bf16(p.z * (x[nt][2] - r1) * scale,
                                      p.w * (x[nt][3] - r1) * scale);
        dsf[nt >> 1][(nt & 1) * 2 + 0] = lo;
        dsf[nt >> 1][(nt & 1) * 2 + 1] = hi;
        const int chunk = (nt ^ g) * 16 + 4 * t;
        *reinterpret_cast<uint32_t*>(dst + row0 * 128 + chunk) = lo;
        *reinterpret_cast<uint32_t*>(dst + (row0 + 8) * 128 + chunk) = hi;
      }
      mbar_arrive(p_empty);
      fence_proxy_async();
      mbar_arrive(ds_full);
    }
    if (it + 1 < n_kt) issue_x(it + 1);  // under the other's arithmetic

    // dQ[:, 128 wg + 64 c ..] += dS.K: A = ds (wg 0 from shared memory,
    // K-major; wg 1 from registers), B = K's chunk 2 wg + c, MN-major (+2048
    // bytes a k-step of 16 keys)
    const uint32_t kt = skt(st);
    if (wg == 0) qw_wait(ds_full, ph);
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    reg_fence(dsf);
    wgmma_fence();
    if (wg == 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int kk = 0; kk < B2_BK / 16; ++kk)
          wgmma_ss_n64_kt(acc[c], sw128_desc(sds) + 2 * kk,
                          sw128_desc(kt + c * B2_ROWS64) + kk * 128, 1);
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int kk = 0; kk < B2_BK / 16; ++kk)
          wgmma_rs_n64_t(acc[c], dsf[kk],
                         sw128_desc(kt + (2 + c) * B2_ROWS64) + kk * 128);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(acc[0]);
  reg_fence(acc[1]);
  mbar_arrive(empty((n_kt - 1) % B2_KSTAGES));

  // epilogue: this consumer's 128 columns of dq in bf16, rows past N never
  // stored
  bf16* qb = dq + b * dqs.b + h * dqs.h + 128 * wg + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= n) continue;
    bf16* qrow = qb + static_cast<long long>(row) * dqs.n;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(qrow + c * 64 + dt * 8) =
            __floats2bfloat162_rn(acc[c][dt][2 * r], acc[c][dt][2 * r + 1]);
  }
}

// --------------------------------------------------------------- host ---
// floats of the scratch the backward takes (the port's wrapper allocates
// it): lse and delta of the padded rows, (B H, N_pad) each, N_pad =
// round_up(N, B2_PAD)
inline long long b2_scratch_floats(int batch, int n, int heads) {
  return 2LL * batch * heads * ((n + B2_PAD - 1) / B2_PAD * B2_PAD);
}

// the prep pass, the dk/dv kernel and the dq kernel on `stream`, arguments
// as maest_attn_bwd_bf16_d256's (scratch: b2_scratch_floats floats)
inline int launch_bwd_d256_wgmma(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          float* scratch, void* dq, void* dk, void* dv,
                          int batch, int n, int heads, int n_real,
                          const long long* st, float sl, float scale,
                          void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n_real < 1 || n_real > n) return static_cast<int>(cudaErrorInvalidValue);
  Strides s[8];  // q, k, v, o, dout, dq, dk, dv
  for (int i = 0; i < 8; ++i)
    s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int n_pad = (n + B2_PAD - 1) / B2_PAD * B2_PAD;
  const long long rows = static_cast<long long>(batch) * heads * n_pad;
  float* lse_p = scratch;
  float* delta_p = scratch + rows;
  attn_bwd_prep_kernel<B2_D><<<static_cast<unsigned>((8 * rows + 255) / 256),
                               256, 0, cs>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse_p,
      delta_p, nullptr, 0, batch, n, n_pad, heads, s[3], s[4]);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  constexpr int dkv_smem = b2_dkv_smem_bytes();
  constexpr int dq_smem = b2_dq_smem_bytes();
  // once, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  static const cudaError_t attr = [] {
    const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    const cudaError_t e =
        cudaFuncSetAttribute(attn_bwd_dkv_d256_kernel, a, dkv_smem);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(attn_bwd_dq_d256_kernel, a, dq_smem);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq64, tdo64, tk64, tv64;
  static_assert(B2_BQ == B2_QROWS, "one map of q and do serves both kernels");
  if (!encode_bnh64(&tq64, q, batch, n, heads, s[0], B2_QROWS, B2_D) ||
      !encode_bnh64(&tdo64, dout, batch, n, heads, s[4], B2_QROWS, B2_D) ||
      !encode_bnh64(&tk64, k, batch, n, heads, s[1], B2_KEYS, B2_D) ||
      !encode_bnh64(&tv64, v, batch, n, heads, s[2], B2_KEYS, B2_D))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid =
      static_cast<long long>((n + B2_KEYS - 1) / B2_KEYS) * batch * heads;
  attn_bwd_dkv_d256_kernel<<<static_cast<unsigned>(grid), B2_DKV_THREADS,
                             dkv_smem, cs>>>(
      tq64, tk64, tv64, tdo64, lse_p, delta_p, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, n_pad, n_real, heads, s[6], s[7], sl, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  attn_bwd_dq_d256_kernel<<<static_cast<unsigned>(grid), B2_DQ_THREADS,
                            dq_smem, cs>>>(tq64, tk64, tv64, tdo64, lse_p,
                                           delta_p, static_cast<bf16*>(dq), n,
                                           n_pad, n_real, heads, s[5], sl,
                                           scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
