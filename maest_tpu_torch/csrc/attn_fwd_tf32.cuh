// The fp32 attention forward at head_dim 64 on Hopper's asynchronous
// machinery (sm_90a) with 3xTF32 products (tf32_wgmma.cuh): K2 (no lse) and
// K3a (lse), the kernel behind maest_attn_fwd_fp32 (attention_fwd.cu),
// which keeps the scalar FMA kernel beside it as maest_attn_fwd_fp32_fma.
//
// It computes what maest_tpu/ops/attention.py::_attn_kernel + _attn_body
// compute: scores q.k scaled by sl = scale log2(e), keys >= n_real at
// -1e30, the running max m and sum l in fp32, p = exp2(s - m) summed into
// l, P.V with fp32 sums, the output divided by l once at the end, lse = m +
// log2(l) (B, H, N) in the log2 domain the backward reads.
//
// What bounds it: at (32, 1676, 12, 64) the two products are 3 x 0.276
// TFLOP at the 495 TFLOP/s tf32 peak, 1.67 ms; the N^2 exp2 and the split
// of p (two cvt.rna a score) run beside them on other units.
//
// Design, the bf16 wgmma kernel's (attn_fwd_wgmma.cuh) with tf32 operands:
//   - S = Q.K^T reads k as it lies; O = P.V contracts over keys, so it
//     reads a transposed copy of v. A prep pass (tf_split_kernel) writes
//     k's hi and lo planes (B H, N_pad, 64) and v's transposed hi and lo
//     planes (B H, 64, N_pad), N_pad = round_up(N, 64), zeros past N; the
//     kernel loads them by TMA (3-D maps, 128-byte swizzle: a 64-column
//     tile is two 32-column halves of 128-byte rows).
//   - Each consumer warpgroup owns 64 query rows. It splits its q rows into
//     hi and lo tiles in shared memory once (swizzled stores), the A
//     operand of S. P, packed as it lies (tf_pack), is the register A of
//     P.V against v's transposed copy in the tf_key_at order.
//   - Warpgroup 0 is the producer: one thread keeps K and V^T tiles of 64
//     keys (hi and lo: 32 KB each) in flight in a ring of TF_STAGES, with
//     full and empty mbarriers for K and for V apart. One product is in
//     flight at a time: S, its softmax, then P.V. The two consumers take
//     turns to issue through named barriers.
//   - The tensor cores' additions into an accumulator truncate, toward
//     zero: every product they sum shrinks the sum a little. Summed into o
//     over every tile, P.V left the output several times farther from
//     plain than the scalar FMA kernel on the H100 (PERF.md). So P.V is
//     summed in fresh chains of TF_PV_STEPS k-steps (ot; TF_PV_ROUNDS a
//     tile, one at a time) and each chain added to o in registers, o = o
//     corr + ot, then o + ot: within the FMA kernel's distance of plain,
//     and o's systematic shrink (which the backward's delta = rowsum(do o)
//     carries into the gradients) smaller than with one chain a tile
//     (chip_smoke.py phase 34 prints the shrink). The 32 registers of ot
//     leave no room to issue the next tile's S beside P.V under the 168 a
//     thread that three warpgroups allow.
// A wait on an mbarrier that never completes traps (qw_wait), so a fault
// fails the launch instead of holding the card.

#pragma once

#include "tf32_wgmma.cuh"  // tf32 split, wgmma, planes, their maps, TMA

namespace maest {

// ------------------------------------------------------------- kernel ---
constexpr int TF_BK = 64;      // keys a tile
constexpr int TF_STAGES = 2;   // K and V^T tiles in flight
constexpr int TF_NC = 2;       // consumer warpgroups of 64 query rows
// P.V of a tile in TF_PV_ROUNDS fresh chains of k-steps, one at a time
constexpr int TF_PV_ROUNDS = 4;
constexpr int TF_PV_STEPS = 8 / TF_PV_ROUNDS;  // k-steps a chain

// dynamic shared memory: 1024 bytes of alignment slack, the consumers' q
// tiles (hi and lo), the K and V^T rings, the mbarriers
constexpr int TF_FWD_SMEM =
    1024 + TF_NC * TF_TILE + 2 * TF_STAGES * TF_TILE + 8 * 4 * TF_STAGES;

// grid (B H ceil(N / (64 TF_NC))), the q tiles of one head on neighbouring
// blocks, 128 (TF_NC + 1) threads; q the (B, N, H, 64) view; tkh, tkl the maps
// of k's hi and lo planes (boxes of 32 columns x 64 rows), tvh, tvl of v's
// transposed planes (the same boxes: 32 positions x 64 d-rows)
__global__ void __launch_bounds__(128 * (TF_NC + 1), 1)
attn_fwd_tf32_kernel(const float* __restrict__ q,
                     const __grid_constant__ CUtensorMap tkh,
                     const __grid_constant__ CUtensorMap tkl,
                     const __grid_constant__ CUtensorMap tvh,
                     const __grid_constant__ CUtensorMap tvl,
                     float* __restrict__ out, float* __restrict__ lse, int n,
                     int n_real, int heads, Strides qs, Strides os, float sl) {
  constexpr int NC = TF_NC;
  constexpr int BQ = 64 * NC;
  extern __shared__ uint8_t tf_smem[];
  const uint32_t sq = (smem_addr(tf_smem) + 1023u) & ~1023u;
  const uint32_t sk = sq + NC * TF_TILE;             // stage s: + s TF_TILE
  const uint32_t sv = sk + TF_STAGES * TF_TILE;
  const uint32_t bars = sv + TF_STAGES * TF_TILE;    // 8 bytes each
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 * (TF_STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 * TF_STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8 * (3 * TF_STAGES + s); };

  const int q_tiles = (n + BQ - 1) / BQ;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = (blockIdx.x - bh * q_tiles) * BQ;
  const int n_tiles = (n_real + TF_BK - 1) / TF_BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < TF_STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 128 * NC);  // every consumer thread releases
      mbar_init(empty_v(s), 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------ producer
    setmaxnreg_dec<wg_producer_regs(NC)>();
    if (threadIdx.x == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % TF_STAGES;
        const uint32_t ph = (it / TF_STAGES) & 1;
        const int key0 = it * TF_BK;
        qw_wait(empty_k(s), ph ^ 1);  // the first round passes at once
        mbar_expect_tx(full_k(s), TF_TILE);
        const uint32_t kd = sk + s * TF_TILE;
        tma_load_3d(kd, &tkh, full_k(s), 0, key0, bh);
        tma_load_3d(kd + TF_HALF, &tkh, full_k(s), 32, key0, bh);
        tma_load_3d(kd + 2 * TF_HALF, &tkl, full_k(s), 0, key0, bh);
        tma_load_3d(kd + 3 * TF_HALF, &tkl, full_k(s), 32, key0, bh);
        qw_wait(empty_v(s), ph ^ 1);
        mbar_expect_tx(full_v(s), TF_TILE);
        const uint32_t vd = sv + s * TF_TILE;
        tma_load_3d(vd, &tvh, full_v(s), key0, 0, bh);
        tma_load_3d(vd + TF_HALF, &tvh, full_v(s), key0 + 32, 0, bh);
        tma_load_3d(vd + 2 * TF_HALF, &tvl, full_v(s), key0, 0, bh);
        tma_load_3d(vd + 3 * TF_HALF, &tvl, full_v(s), key0 + 32, 0, bh);
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<wg_consumer_regs(NC)>();
    const int c = wg - 1;  // this consumer's 64 rows: q0 + 64 c ..
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // consumer c issues after named barrier 1 + c, then lets the next one
    // go; the last consumer lets consumer 0 take the first turn
    const int turns = (1 + TF_PV_ROUNDS) * n_tiles;
    int turn = 0;
    auto take_turn = [&] {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(128 * NC)
                   : "memory");
    };
    auto pass_turn = [&] {
      if (!(c == NC - 1 && turn == turns - 1))
        asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + (c + 1) % NC),
                     "n"(128 * NC)
                     : "memory");
      ++turn;
    };
    if (c == NC - 1)
      asm volatile("bar.arrive 1, %0;\n" ::"n"(128 * NC) : "memory");

    // the consumer's q rows, split into hi and lo tiles in the 128-byte
    // swizzle (16-byte chunk j of row r at chunk j ^ (r % 8)); rows past N
    // are zeros and never stored
    const uint32_t qa = sq + c * TF_TILE;
    {
      const float* qb = q + b * qs.b + h * qs.h;
      for (int i = tid; i < 64 * 16; i += 128) {
        const int r = i >> 4, c4 = i & 15;
        const int row = q0 + 64 * c + r;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (row < n) {
          const float* p = qb + static_cast<long long>(row) * qs.n + 4 * c4;
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = p[e];
        }
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(x[e], hi[e], lo[e]);
        const uint32_t at = qa + (c4 >> 3) * TF_HALF + r * 128 +
                            (((c4 & 7) ^ (r & 7)) << 4);
        tf_st4(at, hi[0], hi[1], hi[2], hi[3]);
        tf_st4(at + 2 * TF_HALF, lo[0], lo[1], lo[2], lo[3]);
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + NC + c) : "memory");
    }

    float o[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float s[8][4];            // scores, then p in fp32
    uint32_t ph[8][4], pl[8][4];  // p's hi and lo: the A fragments of P.V
    float corr[2];
    float ot[8][4];  // a chain of this tile's P.V, added to o in registers

    // s = Q.K^T of the key tile in stage st: the small terms over every
    // k-step, then hi.hi
    auto issue_s = [&](int st) {
      const uint32_t kt = sk + st * TF_TILE;
      if constexpr (TF_3X) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          tf_ss_n64(s, tf_desc(qa, TF_HALF, 1, kk), tf_desc(kt, TF_HALF, 0, kk),
                    kk);
          tf_ss_n64(s, tf_desc(qa, TF_HALF, 0, kk), tf_desc(kt, TF_HALF, 1, kk),
                    1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        tf_ss_n64(s, tf_desc(qa, TF_HALF, 0, kk), tf_desc(kt, TF_HALF, 0, kk),
                  TF_3X || kk > 0);
      wgmma_commit();
    };
    // d = the part of P.V of the key tile in stage st over k-steps k0 ..
    // k0 + TF_PV_STEPS - 1 (8 keys each), a fresh chain: its small terms,
    // then hi.hi
    auto issue_pv = [&](float (&d)[8][4], int st, int k0) {
      const uint32_t vt = sv + st * TF_TILE;
      if constexpr (TF_3X) {
#pragma unroll
        for (int j = 0; j < TF_PV_STEPS; ++j) {
          tf_rs_n64(d, pl[k0 + j], tf_desc(vt, TF_HALF, 0, k0 + j), j > 0);
          tf_rs_n64(d, ph[k0 + j], tf_desc(vt, TF_HALF, 1, k0 + j));
        }
      }
#pragma unroll
      for (int j = 0; j < TF_PV_STEPS; ++j)
        tf_rs_n64(d, ph[k0 + j], tf_desc(vt, TF_HALF, 0, k0 + j),
                  TF_3X || j > 0);
    };
    // the softmax of key tile `it` on s (as attn_fwd_wgmma.cuh's): masked
    // scores, the new running max, corr, p in fp32 (into s) and its sums
    auto softmax = [&](int it) {
      const int base = it * TF_BK;
      float mx[2] = {m[0], m[1]};
      if (base + TF_BK > n_real) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = base + nt * 8 + 2 * t + (e & 1);
            const float x = key < n_real ? s[nt][e] * sl : NEG_INF;
            s[nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[nt][e] * sl;
            s[nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        l[r] *= corr[r];
        m[r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = exp2f(s[nt][0] - m[0]);
        const float p1 = exp2f(s[nt][1] - m[0]);
        const float p2 = exp2f(s[nt][2] - m[1]);
        const float p3 = exp2f(s[nt][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        s[nt][0] = p0;
        s[nt][1] = p1;
        s[nt][2] = p2;
        s[nt][3] = p3;
      }
    };
    // p into P's hi and lo A fragments (chunk j of the scores is k-step j)
    auto pack = [&] {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) tf_pack(s[nt], ph[nt], pl[nt]);
    };

    // one product in flight at a time: S, its softmax, then P.V's chains
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % TF_STAGES;
      const uint32_t par = (it / TF_STAGES) & 1;
      qw_wait(full_k(st), par);
      take_turn();
      wgmma_fence();
      issue_s(st);
      pass_turn();
      wgmma_wait<0>();
      reg_fence(s);
      mbar_arrive(empty_k(st));
      softmax(it);
      pack();
      qw_wait(full_v(st), par);
      // P.V: a fresh chain a round, added to o in registers (o corr
      // first)
#pragma unroll
      for (int r = 0; r < TF_PV_ROUNDS; ++r) {
        take_turn();
        reg_fence(o);
        reg_fence(ot);
        reg_fence(ph);
        reg_fence(pl);
        wgmma_fence();
        issue_pv(ot, st, r * TF_PV_STEPS);
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(ot);
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[dt][e] = r == 0 ? fmaf(o[dt][e], corr[e >> 1], ot[dt][e])
                              : o[dt][e] + ot[dt][e];
      }
      mbar_arrive(empty_v(st));
    }

    // epilogue: o / l in fp32, rows past N never stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row0 = q0 + c * 64 + warp * 16 + g;  // and row0 + 8
    float* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n) continue;
      float* orow = ob + static_cast<long long>(row) * os.n + 2 * t;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<float2*>(orow + dt * 8) =
            make_float2(o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
      if (lse != nullptr && t == 0)
        lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
    }
  }
}

// floats of the scratch the forward takes (the port's wrapper allocates
// it): k's hi and lo planes, v's transposed hi and lo planes
inline long long tf_fwd_scratch_floats(int batch, int n, int heads) {
  return 4LL * batch * heads * tf_pad(n) * 64;
}

// the prep pass and the kernel on `stream`, arguments as
// maest_attn_fwd_fp32's (scratch: tf_fwd_scratch_floats floats)
inline int launch_fwd_tf32(const void* q, const void* k, const void* v,
                           void* out, float* lse, float* scratch, int batch,
                           int n, int heads, int n_real, const long long* st,
                           float sl, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads, n_pad = tf_pad(n);
  const long long plane = static_cast<long long>(bh) * n_pad * 64;
  float* kh = scratch;
  float* kl = kh + plane;
  float* vth = kl + plane;
  float* vtl = vth + plane;
  int err = tf_split(static_cast<const float*>(k), ks, batch, n, n_pad, heads,
                     kh, kl, nullptr, nullptr, cs);
  if (err) return err;
  err = tf_split(static_cast<const float*>(v), vs, batch, n, n_pad, heads,
                 nullptr, nullptr, vth, vtl, cs);
  if (err) return err;
  const auto kernel = attn_fwd_tf32_kernel;
  constexpr int smem = TF_FWD_SMEM;
  // once, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tkh, tkl, tvh, tvl;
  if (!tf_encode_plane(&tkh, kh, bh, n_pad, 64, TF_BK) ||
      !tf_encode_plane(&tkl, kl, bh, n_pad, 64, TF_BK) ||
      !tf_encode_plane(&tvh, vth, bh, 64, n_pad, 64) ||
      !tf_encode_plane(&tvl, vtl, bh, 64, n_pad, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + 64 * TF_NC - 1) / (64 * TF_NC) * bh;
  kernel<<<grid, 128 * (TF_NC + 1), smem, cs>>>(
      static_cast<const float*>(q), tkh, tkl, tvh, tvl,
      static_cast<float*>(out), lse, n, n_real, heads, qs, os, sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
