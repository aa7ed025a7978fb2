// The fp32 attention backward at head_dim 64 on Hopper's asynchronous
// machinery (sm_90a) with 3xTF32 products (tf32_wgmma.cuh): K3b and K4,
// the kernels behind maest_attn_bwd_fp32 (attention_bwd.cu),
// which keeps the scalar FMA kernels beside it as maest_attn_bwd_fp32_fma.
//
// It computes what maest_tpu/ops/attention.py::_attn_bwd_kernel +
// _bwd_body (and the split _bwd_dq_kernel / _bwd_dkv_kernel for N > 4096)
// compute:
//   delta = rowsum(do * o)                      (fp32, the prep pass)
//   p     = exp2(q.k * sl - lse)                keys >= n_real: p = 0
//   dv    = p^T . do        dp = do . v^T
//   ds    = p * (dp - delta) * scale
//   dk    = ds^T . q        dq = ds . k
// with fp32 sums; dq, dk and dv are stored in fp32. Masked keys get exactly
// zero dk and dv; query rows >= n_real still contribute.
//
// What bounds it: 7 products of N^2 64 per (batch, head), each three tf32
// products: at (32, 866, 12, 64) 3 x 0.258 TFLOP at the 495 TFLOP/s tf32
// peak, 1.56 ms (the five products the function needs: 1.115 ms).
//
// Design. tf32 wgmma has no transpose bit, and an fp32 tile with its hi and
// lo planes takes four times a bf16 tile's bytes, so the bf16 kernel's one
// score pass (attn_bwd_wgmma.cuh: K, V, the ds^T tile and two stages of q
// and do beside it) does not fit in 227 KB here. The work is split as the
// TPU's own split backward and the scalar kernels split it:
//   1. prep: tf_split_kernel writes the hi and lo planes of q, do, k and v
//      as they lie (B H, N_pad, 64), and of q, do and k transposed (B H, 64,
//      N_pad; each 8-row group in the tf_key_at order, so that an
//      accumulator packed as it lies is the register A of the product that
//      contracts over those rows); attn_bwd_tf32_stats_kernel writes delta
//      and lse into (B H, N_pad) rows (past N: delta 0, lse +1e30, so p =
//      0). N_pad = round_up(N, 128): every q tile of the dq kernel starts
//      inside the planes.
//   2. dk/dv (attn_bwd_dkv_tf32_kernel): a block owns 64 keys, K and V
//      (hi, lo) loaded once by TMA. Its two consumer warpgroups take the
//      32-row q tiles in turn (even, odd), each through a stage of its own:
//      q, do, q^T, do^T (hi, lo) and the tile's lse and delta. S^T = K.Q^T
//      and dP^T = V.dO^T (A = K, V; B = q, do: K-major as they lie), then
//      p^T and ds^T in registers are the register A of dV += P^T.dO and dK
//      += dS^T.Q (B = the transposed copies). dK and dV stay in registers;
//      at the end consumer 1 hands its sums to consumer 0 through shared
//      memory, which adds them (a fixed order) and stores.
//   3. dq (attn_bwd_dq_tf32_kernel): a block owns 128 q rows (64 a
//      consumer), q and do (hi, lo) loaded once; 32-key tiles of K, V and
//      K^T stream through two stages. S = Q.K^T, dP = dO.V^T, then ds in
//      registers is the register A of dQ += dS.K (B = K^T). Each block sums
//      its own rows over the key tiles in order: dq is deterministic with
//      no hand-over between blocks.
// The scores are formed twice (dk/dv and dq), as in the scalar kernels and
// the TPU's split path: 7 products where one pass would take 5. Each
// kernel sums each tile's products into a fresh accumulator and adds it to
// its gradients in registers (the dk/dv kernel its dV, then its dK, through
// one tile accumulator): the tensor cores' additions round coarser than an
// fp32 FMA, and against a running sum over every tile they left the
// gradients several times farther from plain on the H100 (PERF.md), in
// about the same time.

#pragma once

#include "attn_bwd_wgmma.cuh"  // bulk_load
#include "tf32_wgmma.cuh"      // tf32 split, wgmma, planes, TMA, waits

namespace maest {

constexpr int TB_BQ = 32;                   // q rows a streamed tile (dk/dv)
constexpr int TB_BK = 32;                   // keys a streamed tile (dq)
constexpr uint32_t TB_HALF = 32 * 128;      // 32 rows x 32 tf32
constexpr uint32_t TB_TILE = 4 * TB_HALF;   // 32 x 64: hi, lo, two halves each
constexpr uint32_t TB_TTILE = 2 * TF_HALF;  // 64 x 32 transposed: hi, lo
// a dk/dv stage: q, do, q^T, do^T, lse and delta, 1024-byte aligned
constexpr uint32_t TB_KV_STAGE =
    (2 * TB_TILE + 2 * TB_TTILE + 2 * TB_BQ * 4 + 1023) / 1024 * 1024;
// a dq stage: K, V and K^T
constexpr uint32_t TB_Q_STAGE = 2 * TB_TILE + TB_TTILE;
constexpr float TB_LSE_PAD = 1e30f;  // lse of the rows past N: p = 0

// rows of the backward's planes: round_up(n, 128)
__host__ __device__ constexpr int tb_pad(int n) { return (n + 127) / 128 * 128; }

// dynamic shared memory: 1024 bytes of slack, K and V, two stages, five
// mbarriers (dk/dv); q and do of two consumers, two stages, five mbarriers
// (dq)
constexpr int TB_DKV_SMEM = 1024 + 2 * TF_TILE + 2 * TB_KV_STAGE + 8 * 5;
constexpr int TB_DQ_SMEM = 1024 + 4 * TF_TILE + 2 * TB_Q_STAGE + 8 * 5;

// ------------------------------------------------------------ prep pass ---
// eight lanes a row of the (B H, N_pad) grid: delta = rowsum(do * o) as
// attention_bwd.cu's fp32 delta kernel sums it (eight products a lane, then
// lanes 1, 2, 4 apart), lse copied, rows past N at delta 0 and lse
// TB_LSE_PAD
__global__ void __launch_bounds__(256)
attn_bwd_tf32_stats_kernel(const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ lse_p,
                           float* __restrict__ delta_p, int batch, int n,
                           int n_pad, int heads, Strides os, Strides ds) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  const bool live = r < static_cast<long long>(batch) * heads * n_pad;
  const long long bh = r / n_pad;
  const int row = static_cast<int>(r - bh * n_pad);
  float acc = 0.f;
  if (live && row < n) {
    const int b = static_cast<int>(bh / heads);
    const int h = static_cast<int>(bh - static_cast<long long>(b) * heads);
    const float* x = o + b * os.b + row * os.n + h * os.h + part * 8;
    const float* y = dout + b * ds.b + row * ds.n + h * ds.h + part * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(y[i], x[i], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (live && part == 0) {
    delta_p[r] = acc;
    lse_p[r] = row < n ? lse[bh * n + row] : TB_LSE_PAD;
  }
}

// ---------------------------------------------------------------- dk/dv ---
// grid (B H N_pad / 64), the key tiles of one (b, h) on neighbouring
// blocks, 384 threads; the maps of the planes: k, v with boxes of 64 rows,
// q, do of 32 rows, q^T, do^T of 32 positions x 64 d-rows
__global__ void __launch_bounds__(384, 1)
attn_bwd_dkv_tf32_kernel(
    const __grid_constant__ CUtensorMap tkh,
    const __grid_constant__ CUtensorMap tkl,
    const __grid_constant__ CUtensorMap tvh,
    const __grid_constant__ CUtensorMap tvl,
    const __grid_constant__ CUtensorMap tqh,
    const __grid_constant__ CUtensorMap tql,
    const __grid_constant__ CUtensorMap tdoh,
    const __grid_constant__ CUtensorMap tdol,
    const __grid_constant__ CUtensorMap tqth,
    const __grid_constant__ CUtensorMap tqtl,
    const __grid_constant__ CUtensorMap tdoth,
    const __grid_constant__ CUtensorMap tdotl,
    const float* __restrict__ lse_p, const float* __restrict__ delta_p,
    float* __restrict__ dk, float* __restrict__ dv, int n, int n_pad,
    int n_real, int heads, Strides dks, Strides dvs, float sl, float scale) {
  extern __shared__ uint8_t tb_smem[];
  const uint32_t s0 = (smem_addr(tb_smem) + 1023u) & ~1023u;
  uint8_t* const g0 = tb_smem + (s0 - smem_addr(tb_smem));  // s0, generic
  const uint32_t sk = s0;
  const uint32_t sv = sk + TF_TILE;
  const uint32_t sst = sv + TF_TILE;  // stage s: + s TB_KV_STAGE
  const uint32_t bars = sst + 2 * TB_KV_STAGE;
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (3 + s); };

  const int n_kb = n_pad / 64;
  const int bh = blockIdx.x / n_kb;
  const int kb = blockIdx.x - bh * n_kb;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = kb * 64;

  if (k0 >= n_real) {  // every key masked: zero dk and dv, no q tile
    for (int i = threadIdx.x; i < 64 * 32; i += blockDim.x) {
      const int key = k0 + (i >> 5);
      if (key >= n) break;
      const int col = (i & 31) * 2;
      *reinterpret_cast<float2*>(dk + b * dks.b + h * dks.h +
                                 static_cast<long long>(key) * dks.n + col) =
          make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(dv + b * dvs.b + h * dvs.h +
                                 static_cast<long long>(key) * dvs.n + col) =
          make_float2(0.f, 0.f);
    }
    return;
  }
  const int n_qt = (n + TB_BQ - 1) / TB_BQ;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);  // the consumer of the stage releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------ producer
    setmaxnreg_dec<wg_producer_regs(2)>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, 2 * TF_TILE);
      tma_load_3d(sk, &tkh, full_kv, 0, k0, bh);
      tma_load_3d(sk + TF_HALF, &tkh, full_kv, 32, k0, bh);
      tma_load_3d(sk + 2 * TF_HALF, &tkl, full_kv, 0, k0, bh);
      tma_load_3d(sk + 3 * TF_HALF, &tkl, full_kv, 32, k0, bh);
      tma_load_3d(sv, &tvh, full_kv, 0, k0, bh);
      tma_load_3d(sv + TF_HALF, &tvh, full_kv, 32, k0, bh);
      tma_load_3d(sv + 2 * TF_HALF, &tvl, full_kv, 0, k0, bh);
      tma_load_3d(sv + 3 * TF_HALF, &tvl, full_kv, 32, k0, bh);
      const float* lse_row = lse_p + static_cast<long long>(bh) * n_pad;
      const float* delta_row = delta_p + static_cast<long long>(bh) * n_pad;
      for (int it = 0; it < n_qt; ++it) {
        const int s = it & 1;  // consumer s's stage
        const int r0 = it * TB_BQ;
        qw_wait(empty(s), ((it >> 1) & 1) ^ 1);  // the first round at once
        mbar_expect_tx(full(s), 2 * TB_TILE + 2 * TB_TTILE + 2 * TB_BQ * 4);
        const uint32_t base = sst + s * TB_KV_STAGE;
        const uint32_t tq = base, tdo = base + TB_TILE;
        const uint32_t tqt = base + 2 * TB_TILE, tdot = tqt + TB_TTILE;
        const uint32_t tls = tdot + TB_TTILE;
        tma_load_3d(tq, &tqh, full(s), 0, r0, bh);
        tma_load_3d(tq + TB_HALF, &tqh, full(s), 32, r0, bh);
        tma_load_3d(tq + 2 * TB_HALF, &tql, full(s), 0, r0, bh);
        tma_load_3d(tq + 3 * TB_HALF, &tql, full(s), 32, r0, bh);
        tma_load_3d(tdo, &tdoh, full(s), 0, r0, bh);
        tma_load_3d(tdo + TB_HALF, &tdoh, full(s), 32, r0, bh);
        tma_load_3d(tdo + 2 * TB_HALF, &tdol, full(s), 0, r0, bh);
        tma_load_3d(tdo + 3 * TB_HALF, &tdol, full(s), 32, r0, bh);
        tma_load_3d(tqt, &tqth, full(s), r0, 0, bh);
        tma_load_3d(tqt + TF_HALF, &tqtl, full(s), r0, 0, bh);
        tma_load_3d(tdot, &tdoth, full(s), r0, 0, bh);
        tma_load_3d(tdot + TF_HALF, &tdotl, full(s), r0, 0, bh);
        bulk_load(tls, lse_row + r0, TB_BQ * 4, full(s));
        bulk_load(tls + TB_BQ * 4, delta_row + r0, TB_BQ * 4, full(s));
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<wg_consumer_regs(2)>();
    const int c = wg - 1;  // this consumer's q tiles: c, c + 2, ...
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int key0 = k0 + 16 * warp + g;  // accumulator rows: key0, key0 + 8
    const bool live0 = key0 < n_real, live1 = key0 + 8 < n_real;
    float dka[8][4], dva[8][4];  // dK and dV of the block's keys
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;
    float s[4][4], dp[4][4];  // S^T, then p^T in fp32; dP^T
    uint32_t pfh[4][4], pfl[4][4], dsh[4][4], dsl[4][4];  // p^T, ds^T hi/lo

    // d (+)= X.Y^T over head_dim, X the block's 64 rows at xa, Y the tile's
    // 32 rows at ya: the small terms, then hi.hi
    auto issue_t = [&](float (&d)[4][4], uint32_t xa, uint32_t ya) {
      if constexpr (TF_3X) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          tf_ss_n32(d, tf_desc(xa, TF_HALF, 1, kk), tf_desc(ya, TB_HALF, 0, kk),
                    kk);
          tf_ss_n32(d, tf_desc(xa, TF_HALF, 0, kk), tf_desc(ya, TB_HALF, 1, kk),
                    1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        tf_ss_n32(d, tf_desc(xa, TF_HALF, 0, kk), tf_desc(ya, TB_HALF, 0, kk),
                  TF_3X || kk > 0);
      wgmma_commit();
    };
    // d = A.Y over the tile's 32 rows, A (hi, lo) in registers, Y the
    // transposed copy at yt (64 d-rows x 32 positions, hi then lo)
    auto issue_g = [&](float (&d)[8][4], const uint32_t (&ah)[4][4],
                       const uint32_t (&al)[4][4], uint32_t yt) {
      if constexpr (TF_3X) {
#pragma unroll
        for (int kj = 0; kj < 4; ++kj) {
          tf_rs_n64(d, al[kj], sw128_desc(yt) + 2 * kj, kj > 0);
          tf_rs_n64(d, ah[kj], sw128_desc(yt + TF_HALF) + 2 * kj);
        }
      }
#pragma unroll
      for (int kj = 0; kj < 4; ++kj)
        tf_rs_n64(d, ah[kj], sw128_desc(yt) + 2 * kj, TF_3X || kj > 0);
    };
    // d += t, the tile's fresh sum, in registers
    auto add_tile = [&](float (&d)[8][4], float (&t_)[8][4]) {
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[dt][e] += t_[dt][e];
    };
    float gt[8][4];  // one tile's dV, then its dK

    qw_wait(full_kv, 0);
    for (int it = c; it < n_qt; it += 2) {
      qw_wait(full(c), (it >> 1) & 1);
      const uint32_t base = sst + c * TB_KV_STAGE;
      const uint32_t tq = base, tdo = base + TB_TILE;
      const uint32_t tqt = base + 2 * TB_TILE, tdot = tqt + TB_TTILE;
      const float* lse_t =
          reinterpret_cast<const float*>(g0 + (tdot + TB_TTILE - s0));
      const float* delta_t = lse_t + TB_BQ;
      wgmma_fence();
      issue_t(s, sk, tq);    // S^T = K.Q^T
      issue_t(dp, sv, tdo);  // dP^T = V.dO^T

      // p^T = exp2(s sl - lse[q]), keys >= n_real at 0, under dP
      wgmma_wait<1>();
      reg_fence(s);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 l = *reinterpret_cast<const float2*>(lse_t + nt * 8 + 2 * t);
        s[nt][0] = live0 ? exp2f(s[nt][0] * sl - l.x) : 0.f;
        s[nt][1] = live0 ? exp2f(s[nt][1] * sl - l.y) : 0.f;
        s[nt][2] = live1 ? exp2f(s[nt][2] * sl - l.x) : 0.f;
        s[nt][3] = live1 ? exp2f(s[nt][3] * sl - l.y) : 0.f;
        tf_pack(s[nt], pfh[nt], pfl[nt]);
      }
      // ds^T = p^T (dP^T - delta[q]) scale
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 dl =
            *reinterpret_cast<const float2*>(delta_t + nt * 8 + 2 * t);
        const float x[4] = {s[nt][0] * (dp[nt][0] - dl.x) * scale,
                            s[nt][1] * (dp[nt][1] - dl.y) * scale,
                            s[nt][2] * (dp[nt][2] - dl.x) * scale,
                            s[nt][3] * (dp[nt][3] - dl.y) * scale};
        tf_pack(x, dsh[nt], dsl[nt]);
      }
      // dV += P^T.dO, dK += dS^T.Q, each a fresh sum a tile added in
      // registers, so that the tensor cores' additions round against one
      // tile's sum
      reg_fence(dka);
      reg_fence(dva);
      reg_fence(pfh);
      reg_fence(pfl);
      reg_fence(dsh);
      reg_fence(dsl);
      reg_fence(gt);
      wgmma_fence();
      issue_g(gt, pfh, pfl, tdot);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(gt);
      add_tile(dva, gt);
      reg_fence(gt);
      wgmma_fence();
      issue_g(gt, dsh, dsl, tqt);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(gt);
      add_tile(dka, gt);
      reg_fence(dka);
      reg_fence(dva);
      reg_fence(pfh);
      reg_fence(pfl);
      reg_fence(dsh);
      reg_fence(dsl);
      mbar_arrive(empty(c));  // the stage is read
    }

    // consumer 1 hands its sums to consumer 0 through stage 0's memory,
    // once both are past their last tile (every load has landed)
    float* part = reinterpret_cast<float*>(g0 + (sst - s0));
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (c == 1) {
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[(dt * 4 + e) * 128 + tid] = dka[dt][e];
          part[(32 + dt * 4 + e) * 128 + tid] = dva[dt][e];
        }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= n) continue;
        const bool live = r == 0 ? live0 : live1;
        float* krow = dk + b * dks.b + h * dks.h +
                      static_cast<long long>(key) * dks.n + 2 * t;
        float* vrow = dv + b * dvs.b + h * dvs.h +
                      static_cast<long long>(key) * dvs.n + 2 * t;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          const int e0 = dt * 4 + 2 * r;
          const float2 kx = make_float2(
              dka[dt][2 * r] + part[e0 * 128 + tid],
              dka[dt][2 * r + 1] + part[(e0 + 1) * 128 + tid]);
          const float2 vx = make_float2(
              dva[dt][2 * r] + part[(32 + e0) * 128 + tid],
              dva[dt][2 * r + 1] + part[(32 + e0 + 1) * 128 + tid]);
          *reinterpret_cast<float2*>(krow + dt * 8) =
              live ? kx : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(vrow + dt * 8) =
              live ? vx : make_float2(0.f, 0.f);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- dq ---
// grid (B H ceil(N / 128)), 384 threads; the maps of the planes: q, do with
// boxes of 64 rows, k, v of 32 rows, k^T of 32 positions x 64 d-rows
__global__ void __launch_bounds__(384, 1)
attn_bwd_dq_tf32_kernel(
    const __grid_constant__ CUtensorMap tqh,
    const __grid_constant__ CUtensorMap tql,
    const __grid_constant__ CUtensorMap tdoh,
    const __grid_constant__ CUtensorMap tdol,
    const __grid_constant__ CUtensorMap tkh,
    const __grid_constant__ CUtensorMap tkl,
    const __grid_constant__ CUtensorMap tvh,
    const __grid_constant__ CUtensorMap tvl,
    const __grid_constant__ CUtensorMap tkth,
    const __grid_constant__ CUtensorMap tktl,
    const float* __restrict__ lse_p, const float* __restrict__ delta_p,
    float* __restrict__ dq, int n, int n_pad, int n_real, int heads,
    Strides dqs, float sl, float scale) {
  extern __shared__ uint8_t tb_smem[];
  const uint32_t s0 = (smem_addr(tb_smem) + 1023u) & ~1023u;
  const uint32_t sq = s0;                  // consumer c: + c TF_TILE
  const uint32_t sdo = sq + 2 * TF_TILE;
  const uint32_t sst = sdo + 2 * TF_TILE;  // stage s: + s TB_Q_STAGE
  const uint32_t bars = sst + 2 * TB_Q_STAGE;
  const uint32_t full_q = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (3 + s); };

  const int n_qb = (n + 127) / 128;
  const int bh = blockIdx.x / n_qb;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = (blockIdx.x - bh * n_qb) * 128;
  const int n_kt = (n_real + TB_BK - 1) / TB_BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------ producer
    setmaxnreg_dec<wg_producer_regs(2)>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, 4 * TF_TILE);
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int row = q0 + 64 * cc;
        const uint32_t qd = sq + cc * TF_TILE, dd = sdo + cc * TF_TILE;
        tma_load_3d(qd, &tqh, full_q, 0, row, bh);
        tma_load_3d(qd + TF_HALF, &tqh, full_q, 32, row, bh);
        tma_load_3d(qd + 2 * TF_HALF, &tql, full_q, 0, row, bh);
        tma_load_3d(qd + 3 * TF_HALF, &tql, full_q, 32, row, bh);
        tma_load_3d(dd, &tdoh, full_q, 0, row, bh);
        tma_load_3d(dd + TF_HALF, &tdoh, full_q, 32, row, bh);
        tma_load_3d(dd + 2 * TF_HALF, &tdol, full_q, 0, row, bh);
        tma_load_3d(dd + 3 * TF_HALF, &tdol, full_q, 32, row, bh);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int s = it & 1;
        const int key0 = it * TB_BK;
        qw_wait(empty(s), ((it >> 1) & 1) ^ 1);  // the first round at once
        mbar_expect_tx(full(s), TB_Q_STAGE);
        const uint32_t kd = sst + s * TB_Q_STAGE, vd = kd + TB_TILE;
        const uint32_t ktd = vd + TB_TILE;
        tma_load_3d(kd, &tkh, full(s), 0, key0, bh);
        tma_load_3d(kd + TB_HALF, &tkh, full(s), 32, key0, bh);
        tma_load_3d(kd + 2 * TB_HALF, &tkl, full(s), 0, key0, bh);
        tma_load_3d(kd + 3 * TB_HALF, &tkl, full(s), 32, key0, bh);
        tma_load_3d(vd, &tvh, full(s), 0, key0, bh);
        tma_load_3d(vd + TB_HALF, &tvh, full(s), 32, key0, bh);
        tma_load_3d(vd + 2 * TB_HALF, &tvl, full(s), 0, key0, bh);
        tma_load_3d(vd + 3 * TB_HALF, &tvl, full(s), 32, key0, bh);
        tma_load_3d(ktd, &tkth, full(s), key0, 0, bh);
        tma_load_3d(ktd + TF_HALF, &tktl, full(s), key0, 0, bh);
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<wg_consumer_regs(2)>();
    const int c = wg - 1;  // this consumer's rows: q0 + 64 c ..
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = q0 + 64 * c + 16 * warp + g;  // and row0 + 8
    const uint32_t qa = sq + c * TF_TILE, da = sdo + c * TF_TILE;
    float lr[2], dr[2];  // lse and delta of the thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const long long at = static_cast<long long>(bh) * n_pad + row;
      lr[r] = row < n_pad ? lse_p[at] : TB_LSE_PAD;
      dr[r] = row < n_pad ? delta_p[at] : 0.f;
    }
    float dqa[8][4], dqt[8][4];  // dQ; one key tile's, added to dQ
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;
    float s[4][4], dp[4][4];  // S, then p in fp32; dP
    uint32_t dsh[4][4], dsl[4][4];  // ds hi and lo: the A fragments of dS.K

    // d = X.Y^T over head_dim, X the consumer's 64 rows at xa, Y the
    // stage's 32 keys at ya: the small terms, then hi.hi
    auto issue_t = [&](float (&d)[4][4], uint32_t xa, uint32_t ya) {
      if constexpr (TF_3X) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          tf_ss_n32(d, tf_desc(xa, TF_HALF, 1, kk), tf_desc(ya, TB_HALF, 0, kk),
                    kk);
          tf_ss_n32(d, tf_desc(xa, TF_HALF, 0, kk), tf_desc(ya, TB_HALF, 1, kk),
                    1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        tf_ss_n32(d, tf_desc(xa, TF_HALF, 0, kk), tf_desc(ya, TB_HALF, 0, kk),
                  TF_3X || kk > 0);
      wgmma_commit();
    };

    qw_wait(full_q, 0);
    for (int it = 0; it < n_kt; ++it) {
      const int st = it & 1;
      qw_wait(full(st), (it >> 1) & 1);
      const uint32_t kd = sst + st * TB_Q_STAGE, vd = kd + TB_TILE;
      const uint32_t ktd = vd + TB_TILE;
      wgmma_fence();
      issue_t(s, qa, kd);   // S = Q.K^T
      issue_t(dp, da, vd);  // dP = dO.V^T

      // p = exp2(s sl - lse), keys >= n_real at 0, under dP
      wgmma_wait<1>();
      reg_fence(s);
      const int kbase = it * TB_BK + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = kbase + nt * 8 + (e & 1) < n_real
                         ? exp2f(s[nt][e] * sl - lr[e >> 1])
                         : 0.f;
      // ds = p (dP - delta) scale
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float x[4] = {s[nt][0] * (dp[nt][0] - dr[0]) * scale,
                            s[nt][1] * (dp[nt][1] - dr[0]) * scale,
                            s[nt][2] * (dp[nt][2] - dr[1]) * scale,
                            s[nt][3] * (dp[nt][3] - dr[1]) * scale};
        tf_pack(x, dsh[nt], dsl[nt]);
      }
      // dQ += dS.K: B = K^T (64 d-rows x 32 positions, hi then lo), a
      // fresh sum a key tile, added to dQ in registers
      reg_fence(dqa);
      reg_fence(dsh);
      reg_fence(dsl);
      wgmma_fence();
      if constexpr (TF_3X) {
#pragma unroll
        for (int kj = 0; kj < 4; ++kj) {
          tf_rs_n64(dqt, dsl[kj], sw128_desc(ktd) + 2 * kj, kj > 0);
          tf_rs_n64(dqt, dsh[kj], sw128_desc(ktd + TF_HALF) + 2 * kj);
        }
      }
#pragma unroll
      for (int kj = 0; kj < 4; ++kj)
        tf_rs_n64(dqt, dsh[kj], sw128_desc(ktd) + 2 * kj, TF_3X || kj > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dqt);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[dt][e] += dqt[dt][e];
      reg_fence(dqa);
      reg_fence(dsh);
      reg_fence(dsl);
      mbar_arrive(empty(st));  // the stage is read
    }

    // epilogue: dq in fp32, rows past N never stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n) continue;
      float* qrow = dq + b * dqs.b + h * dqs.h +
                    static_cast<long long>(row) * dqs.n + 2 * t;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<float2*>(qrow + dt * 8) =
            make_float2(dqa[dt][2 * r], dqa[dt][2 * r + 1]);
    }
  }
}

// --------------------------------------------------------------- host ---
// floats of the scratch the backward takes (the port's wrapper allocates
// it): 14 planes (q, do, k, v as they lie; q, do, k transposed; hi and lo
// each) and lse, delta (B H, N_pad)
inline long long tb_scratch_floats(int batch, int n, int heads) {
  const long long rows = static_cast<long long>(batch) * heads * tb_pad(n);
  return rows * (14 * 64 + 2);
}

// the prep pass and the two kernels on `stream`, arguments as
// maest_attn_bwd_fp32's (scratch: tb_scratch_floats floats)
inline int launch_bwd_tf32(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* scratch, void* dq, void* dk, void* dv,
                           int batch, int n, int heads, int n_real,
                           const long long* st, float sl, float scale,
                           void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  Strides s[8];  // q, k, v, o, dout, dq, dk, dv
  for (int i = 0; i < 8; ++i)
    s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads, n_pad = tb_pad(n);
  const long long plane = static_cast<long long>(bh) * n_pad * 64;
  float* p[14];
  for (int i = 0; i < 14; ++i) p[i] = scratch + i * plane;
  float *qh = p[0], *ql = p[1], *doh = p[2], *dol = p[3], *kh = p[4],
        *kl = p[5], *vh = p[6], *vl = p[7], *qth = p[8], *qtl = p[9],
        *doth = p[10], *dotl = p[11], *kth = p[12], *ktl = p[13];
  float* lse_p = scratch + 14 * plane;
  float* delta_p = lse_p + static_cast<long long>(bh) * n_pad;
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  int err;
  if ((err = tf_split(f(q), s[0], batch, n, n_pad, heads, qh, ql, qth, qtl,
                      cs)) ||
      (err = tf_split(f(dout), s[4], batch, n, n_pad, heads, doh, dol, doth,
                      dotl, cs)) ||
      (err = tf_split(f(k), s[1], batch, n, n_pad, heads, kh, kl, kth, ktl,
                      cs)) ||
      (err = tf_split(f(v), s[2], batch, n, n_pad, heads, vh, vl, nullptr,
                      nullptr, cs)))
    return err;
  const long long threads = 8LL * bh * n_pad;
  attn_bwd_tf32_stats_kernel<<<static_cast<unsigned>((threads + 255) / 256),
                               256, 0, cs>>>(f(o), f(dout), lse, lse_p,
                                             delta_p, batch, n, n_pad, heads,
                                             s[3], s[4]);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  // once each, before any launch a graph captures; the setting holds for
  // the current device only: the port drives one card a process
  const auto dkv = attn_bwd_dkv_tf32_kernel;
  const auto dqk = attn_bwd_dq_tf32_kernel;
  static const cudaError_t attr =
      cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TB_DKV_SMEM) != cudaSuccess
          ? cudaErrorInvalidValue
          : cudaFuncSetAttribute(dqk,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 TB_DQ_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap m64[8], m32[8], mt[6];  // rows of 64, rows of 32, transposed
  float* rows[8] = {qh, ql, doh, dol, kh, kl, vh, vl};
  float* trans[6] = {qth, qtl, doth, dotl, kth, ktl};
  for (int i = 0; i < 8; ++i)
    if (!tf_encode_plane(&m64[i], rows[i], bh, n_pad, 64, 64) ||
        !tf_encode_plane(&m32[i], rows[i], bh, n_pad, 64, 32))
      return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 6; ++i)
    if (!tf_encode_plane(&mt[i], trans[i], bh, 64, n_pad, 64))
      return static_cast<int>(cudaErrorInvalidValue);
  dkv<<<n_pad / 64 * bh, 384, TB_DKV_SMEM, cs>>>(
      m64[4], m64[5], m64[6], m64[7], m32[0], m32[1], m32[2], m32[3], mt[0],
      mt[1], mt[2], mt[3], lse_p, delta_p, static_cast<float*>(dk),
      static_cast<float*>(dv), n, n_pad, n_real, heads, s[6], s[7], sl, scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  dqk<<<(n + 127) / 128 * bh, 384, TB_DQ_SMEM, cs>>>(
      m64[0], m64[1], m64[2], m64[3], m32[4], m32[5], m32[6], m32[7], mt[4],
      mt[5], lse_p, delta_p, static_cast<float*>(dq), n, n_pad, n_real, heads,
      s[5], sl, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
