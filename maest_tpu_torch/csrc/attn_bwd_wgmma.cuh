// The bf16 attention backward at head_dim 64 on Hopper's asynchronous
// machinery (sm_90a): K3b and K4, the production instance behind
// maest_attn_bwd_bf16 (attention_bwd.cu), which keeps the mma.sync kernels
// beside it as maest_attn_bwd_bf16_mma.
//
// It computes what maest_tpu/ops/attention.py::_attn_bwd_kernel +
// _bwd_body (and the split _bwd_dq_kernel / _bwd_dkv_kernel) compute, in
// one score pass per (key tile, q tile), as _bwd_body does per key block:
//   delta = rowsum(do * o)                      (fp32, the prep pass)
//   p     = exp2(q.k * sl - lse)                keys >= n_real: p = 0
//   dv   += p^T . do        p rounded to bf16
//   dp    = do . v^T
//   ds    = p * (dp - delta) * scale            rounded to bf16
//   dk   += ds^T . q        dq += ds . k
// with fp32 sums; dq, dk and dv are stored in bf16. Masked keys get
// exactly zero dk and dv; query rows >= n_real still contribute.
//
// What bounds it: 5 products of N^2 64 per (batch, head) (0.186 ms at the
// bf16 tensor-core peak at (32, 866, 12, 64)) and the N^2 exp2 beside
// them. The mma.sync kernels form s and dp twice, once in a dk/dv kernel
// and once in a dq kernel (7 products, two exp2 passes); this one forms
// them once and feeds all three gradients from them.
//
// Design:
//   - A block owns 64 NC keys (NC consumer warpgroups of 64 keys each);
//     its K and V rows are TMA-loaded once. Warpgroup 0 is the producer:
//     one thread streams every q tile of the (b, h) (BQ rows of q and do
//     through 4-D tensor maps of the strided views, 128-byte swizzle;
//     BQ floats of lse and delta by bulk copies) through a ring of
//     BW_STAGES with full and empty mbarriers.
//   - Scores transposed: S^T = K.Q^T and dP^T = V.dO^T by wgmma with both
//     operands K-major in shared memory (as q and k lie), so a consumer's
//     accumulator rows are its keys and its columns the tile's q rows;
//     lse and delta are read along the columns from shared memory.
//   - p^T and ds^T stay in registers: the accumulator layout of S^T is the
//     register-A layout of a 16-bit wgmma, so dV += P^T.dO and dK += dS^T.Q
//     take A from registers and B (do, q) MN-major through the transpose
//     bit. dK and dV stay in registers over every q tile.
//   - dQ = dS.K: each consumer writes its ds^T (64 keys x BQ, bf16) once to
//     shared memory in the 128-byte swizzle and runs, per 64-row group of
//     the tile, one wgmma chain over its own 64 keys with A = dS (ds^T
//     read MN-major) and B = its K rows (MN-major). It leaves the fp32
//     partial in a shared-memory buffer (two, by row group parity) and
//     goes on to the next q tile.
//   - dq is summed over key tiles deterministically by three writer warps
//     of warpgroup 0: per row group, in order, they add the consumers'
//     partials (consumer 0's first) to an fp32 workspace (B H, N_pad, 64)
//     after the key tile before has added, which a counter per (b, h, row
//     group) tells: key tile kb waits until it reads kb, adds, and sets
//     kb + 1 (one fence after a barrier over the writers). Tile 0 stores,
//     the middle tiles add in L2 (red.add, no round trip), and the last
//     real key tile reads the sum and rounds it into the bf16 dq view. The
//     key tiles of a (b, h) are neighbouring blocks in increasing order,
//     so a block waits only on blocks launched before it, and the
//     consumers never wait on another block. Key tiles wholly at or past
//     n_real store zero dk and dv and take no part.
//   - With PP, the consumers take turns to issue their products through
//     named barriers (as the forward's attn_fwd_wgmma.cuh); the sweep found
//     the turns within 1 % either way, so the production route runs
//     without.
// The prep pass (attn_bwd_prep_kernel) computes delta in the arithmetic of
// attention_bwd.cu's delta kernel into a (B H, N_pad) copy, copies lse
// likewise (rows past N at +1e30: p = 0), and zeroes the counters. The
// tiles (BQ, NC, PP) were chosen by a sweep on the card (chip_smoke.py
// phase 31, maest_attn_bwd_bf16_wgmma's configurations).

#pragma once

#include "attn_fwd_wgmma.cuh"  // mbarriers, TMA, descriptors, wgmma, maps

namespace maest {

// ---------------------------------------------------------------- PTX ---
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned; completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// after a barrier over the threads whose writes it publishes: those writes
// ordered before the flag (the release of CUTLASS's semaphore)
__device__ __forceinline__ void release_flag(unsigned* p, unsigned v) {
  asm volatile("fence.acq_rel.gpu;\nst.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p),
               "r"(v)
               : "memory");
}

// *p += v in L2, no value returned (each element rounded once, as an add)
__device__ __forceinline__ void red_add4(float* p, float4 v) {
  asm volatile("red.relaxed.gpu.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16, shared memory, MN-major) . B (16 x
// 64, shared memory, MN-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[8][4], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
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

// ------------------------------------------------------------ prep pass ---
constexpr float BW_LSE_PAD = 1e30f;  // lse of the rows past N: p = 0

// 16-byte-aligned eight bf16 as fp32
__device__ __forceinline__ void bw_load8(const bf16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// eight lanes a row of the (B H, N_pad) grid at head_dim D_: delta =
// rowsum(do * o) as attention_bwd.cu's delta kernel sums it (eight products
// a lane in each 64 columns, then lanes 1, 2, 4 apart), lse copied, rows
// past N at delta 0 and lse BW_LSE_PAD; the first n_handed threads zero the
// hand-over counters
template <int D_ = 64>
__global__ void __launch_bounds__(256)
attn_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ lse_p,
                     float* __restrict__ delta_p, unsigned* __restrict__ handed,
                     long long n_handed, int batch, int n, int n_pad,
                     int heads, Strides os, Strides ds) {
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (gid < n_handed) handed[gid] = 0u;
  const long long r = gid >> 3;
  const int part = threadIdx.x & 7;
  const bool live = r < static_cast<long long>(batch) * heads * n_pad;
  const long long bh = r / n_pad;
  const int row = static_cast<int>(r - bh * n_pad);
  float acc = 0.f;
  if (live && row < n) {
    const int b = static_cast<int>(bh / heads);
    const int h = static_cast<int>(bh - static_cast<long long>(b) * heads);
#pragma unroll
    for (int c = 0; c < D_; c += 64) {
      float x[8], y[8];
      bw_load8(o + b * os.b + row * os.n + h * os.h + c + part * 8, x);
      bw_load8(dout + b * ds.b + row * ds.n + h * ds.h + c + part * 8, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(y[i], x[i], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (live && part == 0) {
    delta_p[r] = acc;
    lse_p[r] = row < n ? lse[bh * n + row] : BW_LSE_PAD;
  }
}

// ------------------------------------------------------------- kernel ---
constexpr int BW_STAGES = 2;   // q tiles in flight
constexpr int BW_WRITERS = 96; // threads of the writer warps (warps 1-3)
// registers a thread after setmaxnreg: the producer warpgroup (one loading
// thread, the writer warps) and the two consumers share the 64K of an SM
constexpr int BW_PRODUCER_REGS = 64;
constexpr int BW_CONSUMER_REGS = 216;
constexpr int BW_DQ_LD = 64;   // floats a row of a dQ partial buffer
constexpr int BW_DQ_BUFS = 2;  // row groups of dQ partials in flight
constexpr int BW_BATCH = 2;    // float4 of dq a writer thread adds at once

// dynamic shared memory of an instance: 1024 bytes of alignment slack; K
// and V (64 NC rows of 128 bytes each); per stage the q and do tiles (BQ
// rows each); the ds^T tiles (NC x BQ / 64 of 64 x 64 bf16); BW_DQ_BUFS
// dQ partial buffers (NC of 64 x 64 fp32 each); per stage lse and delta
// (BQ floats each); the mbarriers
__host__ __device__ constexpr int bw_smem_bytes(int bq, int nc) {
  return 1024 + 2 * nc * 64 * 128 + BW_STAGES * 2 * bq * 128 +
         nc * (bq / 64) * 8192 + BW_DQ_BUFS * nc * 64 * BW_DQ_LD * 4 +
         BW_STAGES * 2 * bq * 4 + 8 * (1 + 2 * BW_STAGES + 2 * BW_DQ_BUFS);
}

// the float4 column c4 of row `row` of a dQ partial buffer, swizzled so
// that a consumer's float2 stores (rows g, g + 8 of a warp) hit 32 banks
__device__ __forceinline__ int bw_dq_col4(int row, int c4) {
  return c4 ^ ((row & 3) << 1);
}

// grid (B H ceil(N / (64 NC))), the key tiles of one (b, h) on neighbouring
// blocks in increasing order, 128 (NC + 1) threads; tq, tdo: the maps of
// the (B, N, H, 64) q and do views with boxes of BQ rows, tk, tv of k and
// v with boxes of 64 NC rows; lse_p, delta_p (B H, n_pad) and handed (B H,
// n_pad / 64) from the prep pass; dq_acc (B H, n_pad, 64) fp32
template <int BQ, int NC, bool PP>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
attn_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse_p,
                      const float* __restrict__ delta_p,
                      float* __restrict__ dq_acc, unsigned* __restrict__ handed,
                      bf16* __restrict__ dq, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int n, int n_pad, int n_real,
                      int heads, Strides dqs, Strides dks, Strides dvs,
                      float sl, float scale) {
  static_assert(BQ == 64 || BQ == 128, "q tiles of 64 or 128 rows");
  static_assert(NC == 2, "the register split is two consumers'");
  constexpr int KB = 64 * NC;              // keys a block
  constexpr uint32_t TILE = BQ * 128;      // bytes of a q or do tile
  constexpr uint32_t DS_TILE = 64 * 128;   // bytes of a 64 x 64 ds^T tile
  constexpr uint32_t DQ_PART = 64 * BW_DQ_LD * 4;  // bytes of a dQ partial
  extern __shared__ uint8_t bw_smem[];
  const uint32_t s0 = (smem_addr(bw_smem) + 1023u) & ~1023u;
  uint8_t* const g0 = bw_smem + (s0 - smem_addr(bw_smem));  // s0, generic
  const uint32_t sk = s0;
  const uint32_t sv = sk + KB * 128;
  const uint32_t sq = sv + KB * 128;               // stage s: + s TILE
  const uint32_t sdo = sq + BW_STAGES * TILE;
  const uint32_t sds = sdo + BW_STAGES * TILE;     // [c][r] DS_TILE each
  const uint32_t sdq = sds + NC * (BQ / 64) * DS_TILE;  // [j][c] DQ_PART
  const uint32_t sld = sdq + BW_DQ_BUFS * NC * DQ_PART;  // lse, delta
  const uint32_t bars = sld + BW_STAGES * 2 * BQ * 4;
  auto s_lse = [&](int s) { return sld + s * 2 * BQ * 4; };
  auto s_delta = [&](int s) { return sld + s * 2 * BQ * 4 + BQ * 4; };
  auto s_ds = [&](int c, int r) { return sds + (c * (BQ / 64) + r) * DS_TILE; };
  auto dq_part = [&](int j, int c) {
    return reinterpret_cast<float*>(g0 + (sdq - s0) + (j * NC + c) * DQ_PART);
  };
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + BW_STAGES + s); };
  auto dq_full = [&](int j) { return bars + 8 * (1 + 2 * BW_STAGES + j); };
  auto dq_empty = [&](int j) {
    return bars + 8 * (1 + 2 * BW_STAGES + BW_DQ_BUFS + j);
  };

  const int n_kb = (n + KB - 1) / KB;
  const int bh = blockIdx.x / n_kb;
  const int kb = blockIdx.x - bh * n_kb;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = kb * KB;

  if (k0 >= n_real) {  // every key masked: zero dk and dv, no q tile
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
    return;
  }
  const int last = (n_real + KB - 1) / KB - 1;  // the last real key tile
  const int n_qt = (n + BQ - 1) / BQ;
  const int n_rg = n_qt * (BQ / 64);  // 64-row groups of q
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
#pragma unroll
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * NC);  // every consumer thread releases
    }
#pragma unroll
    for (int j = 0; j < BW_DQ_BUFS; ++j) {
      mbar_init(dq_full(j), 128 * NC);
      mbar_init(dq_empty(j), BW_WRITERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------- producer and writers
    setmaxnreg_dec<BW_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, 2 * KB * 128);
      tma_load_4d(sk, &tk, full_kv, 0, h, k0, b);
      tma_load_4d(sv, &tv, full_kv, 0, h, k0, b);
      const float* lse_row = lse_p + static_cast<long long>(bh) * n_pad;
      const float* delta_row = delta_p + static_cast<long long>(bh) * n_pad;
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % BW_STAGES;
        mbar_wait(empty(s), ((it / BW_STAGES) & 1) ^ 1);  // first round at once
        mbar_expect_tx(full(s), 2 * TILE + 2 * BQ * 4);
        tma_load_4d(sq + s * TILE, &tq, full(s), 0, h, it * BQ, b);
        tma_load_4d(sdo + s * TILE, &tdo, full(s), 0, h, it * BQ, b);
        bulk_load(s_lse(s), lse_row + it * BQ, BQ * 4, full(s));
        bulk_load(s_delta(s), delta_row + it * BQ, BQ * 4, full(s));
      }
    } else if (threadIdx.x >= 32) {
      // the writers: dq's key tiles summed in order, row group by row group
      const int w = threadIdx.x - 32;
      for (int rg = 0; rg < n_rg; ++rg) {
        const int j = rg % BW_DQ_BUFS;
        mbar_wait(dq_full(j), (rg / BW_DQ_BUFS) & 1);
        unsigned* cnt = handed + static_cast<long long>(bh) * (n_pad / 64) + rg;
        float* acc = dq_acc + (static_cast<long long>(bh) * n_pad + rg * 64) * 64;
        if (kb > 0) {
          if (w == 0)
            while (ld_acquire(cnt) < static_cast<unsigned>(kb)) __nanosleep(32);
          asm volatile("bar.sync %0, %1;\n" ::"n"(3 + NC), "n"(BW_WRITERS)
                       : "memory");
        }
        constexpr int ITEMS = 64 * 16;  // float4 of a row group
        // the row group's partials summed in consumer order
        auto partials = [&](int i) {
          const int row = i >> 4, c4 = i & 15;
          const int at = row * BW_DQ_LD + 4 * bw_dq_col4(row, c4);
          float4 x = *reinterpret_cast<const float4*>(dq_part(j, 0) + at);
#pragma unroll
          for (int c = 1; c < NC; ++c) {
            const float4 y = *reinterpret_cast<const float4*>(dq_part(j, c) + at);
            x.x += y.x;
            x.y += y.y;
            x.z += y.z;
            x.w += y.w;
          }
          return x;
        };
        auto store_dq = [&](int i, float4 x) {  // rows past N never stored
          const int qrow = rg * 64 + (i >> 4);
          if (qrow < n)
            *reinterpret_cast<uint2*>(dq + b * dqs.b + h * dqs.h +
                                      static_cast<long long>(qrow) * dqs.n +
                                      4 * (i & 15)) =
                make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
        };
        if (kb < last || kb == 0) {
          // the first key tile stores, the middle ones add in L2 (no round
          // trip), a single one rounds into dq
          for (int i = w; i < ITEMS; i += BW_WRITERS) {
            const float4 x = partials(i);
            float* g = acc + (i >> 4) * 64 + 4 * (i & 15);
            if (kb == last)
              store_dq(i, x);
            else if (kb == 0)
              __stcg(reinterpret_cast<float4*>(g), x);
            else
              red_add4(g, x);
          }
        } else {
          // the last key tile reads the sum (BW_BATCH float4 a thread in
          // flight, their loads from L2 overlapping) and rounds into dq
          for (int i0 = w; i0 < ITEMS; i0 += BW_BATCH * BW_WRITERS) {
            float4 prev[BW_BATCH];
#pragma unroll
            for (int u = 0; u < BW_BATCH; ++u) {
              const int i = i0 + u * BW_WRITERS;
              if (i < ITEMS)
                prev[u] = __ldcg(reinterpret_cast<const float4*>(
                    acc + (i >> 4) * 64 + 4 * (i & 15)));
            }
#pragma unroll
            for (int u = 0; u < BW_BATCH; ++u) {
              const int i = i0 + u * BW_WRITERS;
              if (i >= ITEMS) break;
              const float4 x = partials(i);
              store_dq(i, make_float4(prev[u].x + x.x, prev[u].y + x.y,
                                      prev[u].z + x.z, prev[u].w + x.w));
            }
          }
        }
        mbar_arrive(dq_empty(j));  // the partials are read
        if (kb < last) {
          asm volatile("bar.sync %0, %1;\n" ::"n"(3 + NC), "n"(BW_WRITERS)
                       : "memory");
          if (w == 0) release_flag(cnt, kb + 1);
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<BW_CONSUMER_REGS>();
    const int c = wg - 1;  // this consumer's keys: k0 + 64 c ..
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = 16 * warp + g;  // accumulator rows row0, row0 + 8
    const int key0 = k0 + 64 * c + row0;
    const bool live0 = key0 < n_real, live1 = key0 + 8 < n_real;
    // PP: consumer c issues after named barrier 1 + c, then lets the next
    // one go; the last consumer lets consumer 0 take the first turn
    const int turns = 2 * n_qt;  // S and dP, then dV and dK, each q tile
    int turn = 0;
    auto take_turn = [&] {
      if constexpr (PP)
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(128 * NC)
                     : "memory");
    };
    auto pass_turn = [&] {
      if constexpr (PP) {
        if (!(c == NC - 1 && turn == turns - 1))
          asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + (c + 1) % NC),
                       "n"(128 * NC)
                       : "memory");
      }
      ++turn;
    };
    if constexpr (PP) {
      if (c == NC - 1)
        asm volatile("bar.arrive 1, %0;\n" ::"n"(128 * NC) : "memory");
    }

    const uint64_t dk_desc = sw128_desc(sk + c * 64 * 128);
    const uint64_t dv_desc = sw128_desc(sv + c * 64 * 128);
    float dka[8][4], dva[8][4];  // dK and dV of the consumer's keys
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;
    float s[BQ / 8][4], dp[BQ / 8][4];  // S^T, then p^T in fp32; dP^T
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];  // p^T and ds^T in bf16
    float dqa[8][4];                           // a row group's dQ partial

    mbar_wait(full_kv, 0);
    for (int it = 0; it < n_qt; ++it) {
      const int st = it % BW_STAGES;
      mbar_wait(full(st), (it / BW_STAGES) & 1);
      const uint64_t q_desc = sw128_desc(sq + st * TILE);
      const uint64_t do_desc = sw128_desc(sdo + st * TILE);
      take_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // S^T = K.Q^T, +32 bytes a k-step
        wgmma_ss<BQ>(s, dk_desc + 2 * kk, q_desc + 2 * kk, kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dP^T = V.dO^T
        wgmma_ss<BQ>(dp, dv_desc + 2 * kk, do_desc + 2 * kk, kk);
      wgmma_commit();
      pass_turn();

      // p^T = exp2(s sl - lse[q]), keys >= n_real at 0, under dP
      wgmma_wait<1>();
      reg_fence(s);
      const float* lse_t = reinterpret_cast<const float*>(g0 + (s_lse(st) - s0));
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const float2 l = *reinterpret_cast<const float2*>(lse_t + nt * 8 + 2 * t);
        s[nt][0] = live0 ? exp2f(s[nt][0] * sl - l.x) : 0.f;
        s[nt][1] = live0 ? exp2f(s[nt][1] * sl - l.y) : 0.f;
        s[nt][2] = live1 ? exp2f(s[nt][2] * sl - l.x) : 0.f;
        s[nt][3] = live1 ? exp2f(s[nt][3] * sl - l.y) : 0.f;
        pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(s[nt][0], s[nt][1]);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
      }

      // ds^T = p^T (dP^T - delta[q]) scale, in registers and once into
      // shared memory, 128-byte swizzled: chunk (nt % 8) ^ (row % 8)
      wgmma_wait<0>();
      reg_fence(dp);
      const float* delta_t =
          reinterpret_cast<const float*>(g0 + (s_delta(st) - s0));
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const float2 dl =
            *reinterpret_cast<const float2*>(delta_t + nt * 8 + 2 * t);
        const uint32_t lo = pack_bf16(s[nt][0] * (dp[nt][0] - dl.x) * scale,
                                      s[nt][1] * (dp[nt][1] - dl.y) * scale);
        const uint32_t hi = pack_bf16(s[nt][2] * (dp[nt][2] - dl.x) * scale,
                                      s[nt][3] * (dp[nt][3] - dl.y) * scale);
        dsf[nt >> 1][(nt & 1) * 2 + 0] = lo;
        dsf[nt >> 1][(nt & 1) * 2 + 1] = hi;
        uint8_t* tile = g0 + (s_ds(c, nt / 8) - s0);
        const int chunk = ((nt % 8) ^ g) * 16 + 4 * t;
        *reinterpret_cast<uint32_t*>(tile + row0 * 128 + chunk) = lo;
        *reinterpret_cast<uint32_t*>(tile + (row0 + 8) * 128 + chunk) = hi;
      }

      // dV += P^T.dO, dK += dS^T.Q: A from registers, B MN-major
      take_turn();
      reg_fence(dka);
      reg_fence(dva);
      reg_fence(pf);
      reg_fence(dsf);
      wgmma_fence();
#pragma unroll
      for (int kj = 0; kj < BQ / 16; ++kj)  // +2048 bytes: 16 rows
        wgmma_rs_n64_t(dva, pf[kj], do_desc + kj * 128);
#pragma unroll
      for (int kj = 0; kj < BQ / 16; ++kj)
        wgmma_rs_n64_t(dka, dsf[kj], q_desc + kj * 128);
      wgmma_commit();
      pass_turn();

      // dQ partial of each row group over this consumer's keys: A = dS
      // (its ds^T, MN-major), B = its K rows (MN-major); handed to the
      // writers through the row group's buffer
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + NC + c) : "memory");
#pragma unroll
      for (int r = 0; r < BQ / 64; ++r) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64_tt(dqa, sw128_desc(s_ds(c, r)) + kk * 128,
                          dk_desc + kk * 128, kk);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dqa);
        if (r == 0) {
          reg_fence(dka);
          reg_fence(dva);
          reg_fence(pf);
          reg_fence(dsf);
          mbar_arrive(empty(st));  // q, do, lse, delta of the stage are read
        }
        const int rg = it * (BQ / 64) + r;
        const int j = rg % BW_DQ_BUFS;
        mbar_wait(dq_empty(j), ((rg / BW_DQ_BUFS) & 1) ^ 1);  // first at once
        float* part = dq_part(j, c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + 8 * e;
#pragma unroll
          for (int dt = 0; dt < 8; ++dt) {
            const int c4 = 2 * dt + (t >> 1);
            *reinterpret_cast<float2*>(part + row * BW_DQ_LD +
                                       4 * bw_dq_col4(row, c4) + 2 * (t & 1)) =
                make_float2(dqa[dt][2 * e], dqa[dt][2 * e + 1]);
          }
        }
        mbar_arrive(dq_full(j));
      }
    }

    // epilogue: dK and dV in bf16, masked keys exactly zero, rows past N
    // never stored
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
        *reinterpret_cast<__nv_bfloat162*>(krow + dt * 8) =
            live ? __floats2bfloat162_rn(dka[dt][2 * r], dka[dt][2 * r + 1])
                 : __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(vrow + dt * 8) =
            live ? __floats2bfloat162_rn(dva[dt][2 * r], dva[dt][2 * r + 1])
                 : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
  }
}

// --------------------------------------------------------------- host ---
// floats of the scratch the wgmma backward takes (the port's wrapper
// allocates it): dq's fp32 sums (B H, N_pad, 64), lse and delta (B H,
// N_pad) each, the hand-over counters (B H, N_pad / 64), N_pad =
// round_up(N, 128)
inline long long bw_scratch_floats(int batch, int n, int heads) {
  const long long rows =
      static_cast<long long>(batch) * heads * ((n + 127) / 128 * 128);
  return rows * 66 + rows / 64;
}

// the prep pass and one launch of an instance on `stream`, arguments as
// maest_attn_bwd_bf16's (scratch: bw_scratch_floats floats)
template <int BQ, int NC, bool PP>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* scratch, void* dq, void* dk, void* dv, int batch,
                     int n, int heads, int n_real, const long long* st,
                     float sl, float scale, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  Strides s[8];  // q, k, v, o, dout, dq, dk, dv
  for (int i = 0; i < 8; ++i) s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int n_pad = (n + 127) / 128 * 128;
  const long long rows = static_cast<long long>(batch) * heads * n_pad;
  float* dq_acc = scratch;
  float* lse_p = scratch + rows * 64;
  float* delta_p = lse_p + rows;
  unsigned* handed = reinterpret_cast<unsigned*>(delta_p + rows);
  attn_bwd_prep_kernel<64><<<static_cast<unsigned>((8 * rows + 255) / 256), 256, 0,
                         cs>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse_p,
      delta_p, handed, rows / 64, batch, n, n_pad, heads, s[3], s[4]);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const auto kernel = attn_bwd_wgmma_kernel<BQ, NC, PP>;
  constexpr int smem = bw_smem_bytes(BQ, NC);
  // once an instance, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_bnh64(&tq, q, batch, n, heads, s[0], BQ) ||
      !encode_bnh64(&tk, k, batch, n, heads, s[1], 64 * NC) ||
      !encode_bnh64(&tv, v, batch, n, heads, s[2], 64 * NC) ||
      !encode_bnh64(&tdo, dout, batch, n, heads, s[4], BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + 64 * NC - 1) / (64 * NC) * batch * heads;
  kernel<<<grid, 128 * (NC + 1), smem, cs>>>(
      tq, tk, tv, tdo, lse_p, delta_p, dq_acc, handed, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, n_pad, n_real, heads,
      s[5], s[6], s[7], sl, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
