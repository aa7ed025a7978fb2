// The bf16 attention backward at any head_dim dp above 256 (a multiple of
// 64; a head_dim between is zero-padded by the caller) on Hopper's
// asynchronous machinery (sm_90a): K3b and K4 at those widths, the route
// of maest_attn_bwd_bf16_dn (attention_bwd.cu), which keeps the mma.sync
// kernels of launch_bwd_dn<bf16> beside it as maest_attn_bwd_bf16_dn_mma.
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
// What bounds it: 5 products of N^2 dp per (batch, head) (0.186 ms at the
// bf16 tensor-core peak at (32, 866, 2, 384)); the N^2 exp2 is a sixth of
// head_dim 64's for the same operations at 384.
//
// Why this shape: a 64-key warpgroup's dK or dV sums take dp / 2
// registers a thread (192 at dp 384, 256 at 512), over ptxas's 168 for a
// kernel of more than 8 warps and, at 512, over the 255 of any kernel. A
// fused kernel has to sum them in column slices and form S and dP again
// for each slice (the mma.sync control: 9 products at 384, 12 at 512;
// two slices of 192 on wgmma: 7 and 8). This design forms S and dP once
// and writes p and ds once instead, so the three gradients become plain
// products over device memory at any dp:
//   - scores (attn_bwd_dn_scores_kernel): a block owns 128 keys, two
//     consumer warpgroups of 64; their K and V rows stay in shared memory
//     where they fit beside a 4-stage ring (dp <= 384: 192 KB at 384),
//     else stream through the ring with the q chunks. A producer warp
//     streams each q tile of 64 rows, q and do, in 64-column chunks of 8
//     KB (128-byte swizzle) through the ring. Each consumer forms S^T =
//     K.Q^T and dP^T = V.dO^T (m64n64k16, both operands K-major, one
//     commit group a chunk), then p^T = exp2(s sl - lse[q]) (keys >=
//     n_real at 0) and ds^T = p^T (dP^T - delta[q]) scale, and stores p^T
//     and ds^T in bf16 into two (B H, N_pad, N_pad) planes of the scratch,
//     key-major (row = key, column = q row). S and dP: 2 products.
//   - products (attn_bwd_dn_mm_kernel<TRANS_A>): C = A.B over the planes,
//     128 output rows (64 a consumer warpgroup) x up to BD_NW 64-column
//     chunks a block, k-steps of 64 through a ring of BD_MM_STAGES (A: two
//     64 x 64 boxes of a plane; B: BD_NW boxes of the strided (B, N, H, dp)
//     view), a producer warp issuing every TMA load. dV = P^T.dO and dK =
//     dS^T.Q (one launch, job = blockIdx's slowest digit; A K-major, B
//     MN-major through the transpose bit); dQ = dS.K (a second launch;
//     dS read from the key-major plane MN-major). 3 products. One block an
//     SM walks the tiles (a tile's k-steps are only N / 64), so the ring
//     fills for a tile under the one before.
//   - Stores: each quad's 4-byte words of a row are gathered by shuffles
//     into whole 16-byte chunks (quad_chunks) before they are stored, so a
//     warp writes 64 contiguous bytes a row.
// So 5 products at every dp, the floor: at dp 384 and 512 against the
// control's 9 and 12. The price is the planes' bytes: 2 x 2 N_pad^2 bytes
// a head written and 3 x 2 N_pad^2 read (0.308 GB at (32, 866, 2, 384),
// 0.092 ms at 3.35 TB/s, against 0.186 ms of products), and scratch of
// 2 N_pad^2 bf16 a (batch, head) (205 MB at (32, 866, 2, 384)).
// Registers: a scores consumer holds S^T and dP^T (64 of them); a product
// consumer BD_NW x 32 of C (96) beside its descriptors, under the 168 of a
// kernel with a producer warp. Shared memory: the scores kernel's K and V
// (2 x 128 x dp x 2 bytes) and a ring of 8 KB stages; the product kernel's
// ring of 40 KB stages (200 KB).
// Every sum is taken in one fixed order (dv, dk over q tiles of 64, dq
// over key tiles of 64, each in increasing order, in registers): no
// atomics, two runs are bit-equal. Masked keys' p^T and ds^T rows are zero
// and their dk and dv rows are stored as zero; key blocks wholly at or past
// n_real form no scores and store zero dk and dv. The prep pass
// (attn_bwd_prep_dn_kernel) computes delta as attn_bwd_prep_kernel does,
// at a runtime width, into (B H, N_pad) with lse beside it (rows past N at
// +1e30: p = 0, so the planes' columns past N are zero).
//
// q, k, v, o and do are the strided (B, N, H, dp) views of the fused qkv
// (and the output gradient), read in place through 4-D tensor maps.

#pragma once

#include "attn_bwd_d256_wgmma.cuh"  // the predicated loads, wgmma_ss_n64_kt,
                                    // and through it the prep pass's
                                    // helpers, mbarriers, TMA, descriptors

namespace maest {

constexpr int BD_KEYS = 128;       // keys a scores block, 64 a consumer
constexpr int BD_BQ = 64;          // q rows a streamed tile of the scores
constexpr int BD_PAD = 128;        // N_pad: planes, lse and delta rows
constexpr uint32_t BD_STAGE = 64 * 128;  // a 64-row chunk of 64 columns
constexpr int BD_SMEM = 227 * 1024;      // dynamic shared memory a block
constexpr int BD_BAR_BYTES = 512;
constexpr int BD_MIN_STAGES = 4;   // the scores ring beside resident K, V
constexpr int BD_MAX_STAGES = 28;  // barriers fit in BD_BAR_BYTES
constexpr int BD_THREADS = 256 + 32;  // two consumer warpgroups, a producer
constexpr int BD_NW = 3;           // 64-column chunks of a product tile
constexpr int BD_MM_STAGES = 5;    // k-steps in flight in a product block
constexpr uint32_t BD_MM_STAGE = (2 + BD_NW) * BD_STAGE;  // A, then B
static_assert(BD_KEYS == 2 * 64 && BD_BQ == 64 && BD_PAD % BD_KEYS == 0,
              "a consumer warpgroup's wgmma rows are 64");

__host__ __device__ constexpr int bd_mm_smem_bytes() {
  return 1024 + BD_MM_STAGES * static_cast<int>(BD_MM_STAGE) + BD_BAR_BYTES;
}
static_assert(bd_mm_smem_bytes() <= BD_SMEM, "the product kernel's ring");

// the scores ring's stages at width dp with K and V resident (a
// BD_MIN_STAGES ring at least), or 0 where they do not fit and K and V
// stream through the ring
inline int bd_resident_stages(int dp) {
  const int left = BD_SMEM - 1024 - BD_BAR_BYTES -
                   2 * (dp / 64) * 2 * static_cast<int>(BD_STAGE);
  const int stages = left < 0 ? 0 : left / static_cast<int>(BD_STAGE);
  return stages >= BD_MIN_STAGES
             ? (stages < BD_MAX_STAGES ? stages : BD_MAX_STAGES)
             : 0;
}

// eight lanes a row of the (B H, N_pad) grid at width dp: delta =
// rowsum(do * o) as attn_bwd_prep_kernel sums it (eight products a lane in
// each 64 columns, then lanes 1, 2, 4 apart), lse copied, rows past N at
// delta 0 and lse BW_LSE_PAD
__global__ void __launch_bounds__(256)
attn_bwd_prep_dn_kernel(const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ lse_p, float* __restrict__ delta_p,
                        int batch, int n, int n_pad, int heads, int dp,
                        Strides os, Strides ds) {
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long r = gid >> 3;
  const int part = threadIdx.x & 7;
  const bool live = r < static_cast<long long>(batch) * heads * n_pad;
  const long long bh = r / n_pad;
  const int row = static_cast<int>(r - bh * n_pad);
  float acc = 0.f;
  if (live && row < n) {
    const int b = static_cast<int>(bh / heads);
    const int h = static_cast<int>(bh - static_cast<long long>(b) * heads);
    for (int c = 0; c < dp; c += 64) {
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

// grid (B H N_pad / 128), the key blocks of one (b, h) on neighbouring
// blocks, BD_THREADS threads; tq, tk, tv, tdo: maps of the (B, N, H, dp)
// views with boxes of 64 columns x 64 rows; lse_p, delta_p (B H, n_pad)
// from the prep pass; pt, dst: the p^T and ds^T planes (B H, n_pad,
// n_pad). resident: K and V held in shared memory (else each chunk of a q
// tile streams K's and V's two 64-row halves through the ring after q's
// and do's); stages: the ring's length.
__global__ void __launch_bounds__(BD_THREADS, 1)
attn_bwd_dn_scores_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse_p,
                          const float* __restrict__ delta_p,
                          bf16* __restrict__ pt, bf16* __restrict__ dst,
                          int n, int n_pad, int n_real, int heads, int dp,
                          int resident, int stages, float sl, float scale) {
  extern __shared__ uint8_t bd_smem[];
  const int nch = dp / 64;
  constexpr uint32_t KCHUNK = 2 * BD_STAGE;  // a chunk of the 128 keys
  const uint32_t sk = (smem_addr(bd_smem) + 1023u) & ~1023u;
  const uint32_t sv = sk + (resident ? nch * KCHUNK : 0u);
  const uint32_t ring = sv + (resident ? nch * KCHUNK : 0u);
  const uint32_t bars = ring + stages * BD_STAGE;  // 8 bytes each
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + stages + s); };

  const int n_kb = n_pad / BD_KEYS;
  const int bh = blockIdx.x / n_kb;
  const int k0 = (blockIdx.x - bh * n_kb) * BD_KEYS;
  if (k0 >= n_real) return;  // every key masked: the products store zeros
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int n_qt = (n + BD_BQ - 1) / BD_BQ;
  const int per_chunk = resident ? 2 : 6;  // q, do (, K lo/hi, V lo/hi)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // uniform

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------ producer
    if (threadIdx.x == 256) {
      if (resident) {
        mbar_expect_tx(full_kv, 2 * nch * KCHUNK);
        for (int c = 0; c < nch; ++c)
          for (int half = 0; half < 2; ++half) {
            tma_load_4d(sk + c * KCHUNK + half * BD_STAGE, &tk, full_kv,
                        64 * c, h, k0 + 64 * half, b);
            tma_load_4d(sv + c * KCHUNK + half * BD_STAGE, &tv, full_kv,
                        64 * c, h, k0 + 64 * half, b);
          }
      }
      int st = 0;
      uint32_t ph = 0;
      for (int it = 0; it < n_qt; ++it)
        for (int c = 0; c < nch; ++c)
          for (int i = 0; i < per_chunk; ++i) {
            qw_wait(empty(st), ph ^ 1);  // the first round passes at once
            const uint32_t to = ring + st * BD_STAGE;
            mbar_expect_tx(full(st), BD_STAGE);
            if (i < 2)  // q's or do's chunk c of q tile it
              tma_load_4d(to, i == 0 ? &tq : &tdo, full(st), 64 * c, h,
                          it * BD_BQ, b);
            else  // K's or V's half (i - 2) & 1 of chunk c
              tma_load_4d(to, i < 4 ? &tk : &tv, full(st), 64 * c, h,
                          k0 + 64 * ((i - 2) & 1), b);
            if (++st == stages) {
              st = 0;
              ph ^= 1;
            }
          }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = k0 + 64 * wg + 16 * warp + g;  // rows key0, key0 + 8
  const bool live0 = key0 < n_real, live1 = key0 + 8 < n_real;
  const long long plane = static_cast<long long>(bh) * n_pad * n_pad;
  bf16* const prow = pt + plane + static_cast<long long>(key0) * n_pad;
  bf16* const drow = dst + plane + static_cast<long long>(key0) * n_pad;
  const float* const lrow = lse_p + static_cast<long long>(bh) * n_pad + 2 * t;
  const float* const drow_f =
      delta_p + static_cast<long long>(bh) * n_pad + 2 * t;

  float s[8][4];   // S^T: this warpgroup's 64 keys x the tile's 64 q rows
  float x[8][4];   // dP^T
  int st = 0;  // the ring position of the next item
  uint32_t ph = 0;
  auto take = [&] {  // waits for the next item; its stage
    const int mine = st;
    qw_wait(full(st), ph);
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
    return mine;
  };
  // the stages of the chunk in flight: q's, do's and, streamed, K's and
  // V's halves (-1: resident)
  int hq = -1, hdo = -1, hkl = -1, hkh = -1, hvl = -1, hvh = -1;
  auto release_held = [&] {
    mbar_arrive(empty(hq));
    mbar_arrive(empty(hdo));
    if (hkl >= 0) {
      mbar_arrive(empty(hkl));
      mbar_arrive(empty(hkh));
      mbar_arrive(empty(hvl));
      mbar_arrive(empty(hvh));
    }
  };

  if (resident) qw_wait(full_kv, 0);
  for (int it = 0; it < n_qt; ++it) {
    wgmma_fence();
    for (int c = 0; c < nch; ++c) {
      const int iq = take();
      const int ido = take();
      const int ikl = resident ? -1 : take();
      const int ikh = resident ? -1 : take();
      const int ivl = resident ? -1 : take();
      const int ivh = resident ? -1 : take();
      const uint32_t ak = resident ? sk + c * KCHUNK + wg * BD_STAGE
                                   : ring + (wg ? ikh : ikl) * BD_STAGE;
      const uint32_t av = resident ? sv + c * KCHUNK + wg * BD_STAGE
                                   : ring + (wg ? ivh : ivl) * BD_STAGE;
      const uint64_t dk_ = sw128_desc(ak), dv_ = sw128_desc(av);
      const uint64_t dq_ = sw128_desc(ring + iq * BD_STAGE);
      const uint64_t ddo = sw128_desc(ring + ido * BD_STAGE);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // +32 bytes a k-step of 16 columns
        wgmma_ss_n64(s, dk_ + 2 * kk, dq_ + 2 * kk, c | kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(x, dv_ + 2 * kk, ddo + 2 * kk, c | kk);
      wgmma_commit();
      if (c > 0) {  // the chunk before is done
        wgmma_wait<1>();
        release_held();
      }
      hq = iq;
      hdo = ido;
      hkl = ikl;
      hkh = ikh;
      hvl = ivl;
      hvh = ivh;
    }
    // the tile's lse and delta, read while the last chunk's products run
    const int q0 = it * BD_BQ;
    float2 lq[8], dq2[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      lq[nt] = *reinterpret_cast<const float2*>(lrow + q0 + 8 * nt);
      dq2[nt] = *reinterpret_cast<const float2*>(drow_f + q0 + 8 * nt);
    }
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(x);
    release_held();

    // p^T = exp2(s sl - lse[q]) (keys >= n_real at 0), ds^T = p^T (dP^T -
    // delta[q]) scale; both in bf16 into the planes, row key, column q,
    // each row's 64 columns gathered into whole 16-byte chunks first
    uint32_t pw[2][8], dw[2][8];  // rows key0, key0 + 8
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l = lq[nt], d = dq2[nt];
      const float p0 = live0 ? exp2f(s[nt][0] * sl - l.x) : 0.f;
      const float p1 = live0 ? exp2f(s[nt][1] * sl - l.y) : 0.f;
      const float p2 = live1 ? exp2f(s[nt][2] * sl - l.x) : 0.f;
      const float p3 = live1 ? exp2f(s[nt][3] * sl - l.y) : 0.f;
      pw[0][nt] = pack_bf16(p0, p1);
      pw[1][nt] = pack_bf16(p2, p3);
      dw[0][nt] = pack_bf16(p0 * (x[nt][0] - d.x) * scale,
                            p1 * (x[nt][1] - d.y) * scale);
      dw[1][nt] = pack_bf16(p2 * (x[nt][2] - d.x) * scale,
                            p3 * (x[nt][3] - d.y) * scale);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint4 c0, c1;
      const long long at = 8LL * r * n_pad + q0 + 8 * t;  // chunk t
      quad_chunks(pw[r], t, c0, c1);
      *reinterpret_cast<uint4*>(prow + at) = c0;
      *reinterpret_cast<uint4*>(prow + at + 32) = c1;
      quad_chunks(dw[r], t, c0, c1);
      *reinterpret_cast<uint4*>(drow + at) = c0;
      *reinterpret_cast<uint4*>(drow + at + 32) = c1;
    }
  }
}

// C (rows x dp, bf16, a strided (B, N, H, dp) view) = A . B, 128 rows and
// up to BD_NW 64-column chunks a block. TRANS_A false: one launch of two
// jobs (blockIdx's slowest digit: 0 dV = P^T.dO with ta0, tb0, c0; 1 dK =
// dS^T.Q with ta1, tb1, c1); rows are keys, k-steps q tiles of 64 up to N,
// A read K-major; key blocks wholly at or past n_real store zeros, masked
// keys' rows are stored as zero. TRANS_A true: dQ = dS.K (ta0 the ds^T
// plane, tb0 K's map, c0 dq); rows are q rows, k-steps key tiles of 64 up
// to n_real, A read MN-major from the key-major plane. ta*: maps of the
// planes (B H, n_pad, n_pad) in 64 x 64 boxes; tb*: of the (B, N, H, dp)
// views in 64-column x 64-row boxes; bhs: B H. Tiles (jobs B H n_pad / 128
// col_tiles), the column tiles of a row block consecutive; one block an SM
// walks them gridDim.x apart, its ring running on from tile to tile, so a
// tile's first loads fly under the tile before.
template <bool TRANS_A>
__global__ void __launch_bounds__(BD_THREADS, 1)
attn_bwd_dn_mm_kernel(const __grid_constant__ CUtensorMap ta0,
                      const __grid_constant__ CUtensorMap tb0,
                      const __grid_constant__ CUtensorMap ta1,
                      const __grid_constant__ CUtensorMap tb1,
                      bf16* __restrict__ c0, bf16* __restrict__ c1,
                      Strides cs0, Strides cs1, int n, int n_pad, int n_real,
                      int bhs, int heads, int dp) {
  extern __shared__ uint8_t bd_smem[];
  const uint32_t ring = (smem_addr(bd_smem) + 1023u) & ~1023u;
  const uint32_t bars = ring + BD_MM_STAGES * BD_MM_STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (BD_MM_STAGES + s); };

  const int nch = dp / 64;
  const int col_tiles = (nch + BD_NW - 1) / BD_NW;
  const int n_mb = n_pad / 128;
  const int tiles = (TRANS_A ? 1 : 2) * bhs * n_mb * col_tiles;
  const int rows_live = TRANS_A ? n : n_real;  // rows stored other than 0
  // k-steps: q tiles up to N (dV, dK) or key tiles up to n_real (dQ)
  const int n_k = ((TRANS_A ? n_real : n) + 63) / 64;
  // tile x: its column tile, row block, (b, h), job (0 where TRANS_A) and
  // k-steps, none for a key block wholly at or past n_real (its rows
  // stored as zero)
  struct Tile {
    int ch0, nw, m0, b, h, job, n_k, bh;
  };
  auto tile_of = [&](int x) {
    Tile tl;
    const int ct = x % col_tiles;
    x /= col_tiles;
    const int mb = x % n_mb;
    x /= n_mb;
    tl.bh = x % bhs;
    tl.job = x / bhs;
    tl.b = tl.bh / heads;
    tl.h = tl.bh - tl.b * heads;
    tl.m0 = mb * 128;
    tl.ch0 = ct * BD_NW;
    tl.nw = min(BD_NW, nch - tl.ch0);
    tl.n_k = !TRANS_A && tl.m0 >= n_real ? 0 : n_k;
    return tl;
  };
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // uniform

  if (threadIdx.x == 0) {
    for (int s = 0; s < BD_MM_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------ producer
    if (threadIdx.x == 256) {
      int gk = 0;  // k-steps loaded, over every tile of this block
      for (int x = blockIdx.x; x < tiles; x += gridDim.x) {
        const Tile tl = tile_of(x);
        const CUtensorMap* ta = tl.job ? &ta1 : &ta0;
        const CUtensorMap* tb = tl.job ? &tb1 : &tb0;
        for (int kt = 0; kt < tl.n_k; ++kt, ++gk) {
          const int s = gk % BD_MM_STAGES;
          qw_wait(empty(s), ((gk / BD_MM_STAGES) & 1) ^ 1);  // first at once
          const uint32_t to = ring + s * BD_MM_STAGE;
          mbar_expect_tx(full(s), (2 + tl.nw) * BD_STAGE);
          for (int w = 0; w < 2; ++w)  // A: consumer w's 64 rows x 64 k
            if (TRANS_A)  // ds^T (key, q): keys kt, q rows m0 + 64 w
              tma_load_3d(to + w * BD_STAGE, ta, full(s), tl.m0 + 64 * w,
                          64 * kt, tl.bh);
            else  // p^T or ds^T (key, q): keys m0 + 64 w, q rows kt
              tma_load_3d(to + w * BD_STAGE, ta, full(s), 64 * kt,
                          tl.m0 + 64 * w, tl.bh);
          for (int c = 0; c < tl.nw; ++c)  // B: rows kt, the tile's chunk c
            tma_load_4d(to + (2 + c) * BD_STAGE, tb, full(s),
                        64 * (tl.ch0 + c), tl.h, 64 * kt, tl.b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[BD_NW][8][4];
  int gk = 0;  // k-steps taken, over every tile of this block
  for (int x = blockIdx.x; x < tiles; x += gridDim.x) {
    const Tile tl = tile_of(x);
#pragma unroll
    for (int c = 0; c < BD_NW; ++c)
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][dt][e] = 0.f;
    for (int kt = 0; kt < tl.n_k; ++kt, ++gk) {
      const int s = gk % BD_MM_STAGES;
      qw_wait(full(s), (gk / BD_MM_STAGES) & 1);
      const uint32_t st = ring + s * BD_MM_STAGE;
      const uint64_t da = sw128_desc(st + wg * BD_STAGE);
#pragma unroll
      for (int c = 0; c < BD_NW; ++c) reg_fence(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < BD_NW; ++c)
        if (c < tl.nw) {
          const uint64_t db = sw128_desc(st + (2 + c) * BD_STAGE);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // B: +2048 bytes a k-step of 16
            if (TRANS_A)  // A MN-major: +2048 bytes too
              wgmma_ss_n64_tt(acc[c], da + 128 * kk, db + 128 * kk, 1);
            else  // A K-major: +32 bytes
              wgmma_ss_n64_kt(acc[c], da + 2 * kk, db + 128 * kk, 1);
        }
      wgmma_commit();
      if (kt > 0) {  // the k-step before is done: its stage released
        wgmma_wait<1>();
        mbar_arrive(empty((gk - 1) % BD_MM_STAGES));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < BD_NW; ++c) reg_fence(acc[c]);
    if (tl.n_k > 0) mbar_arrive(empty((gk - 1) % BD_MM_STAGES));

    // epilogue: bf16 in whole 16-byte chunks (quad_chunks), rows past N
    // never stored, masked keys' rows zero (every thread of a quad takes
    // the same branch: the quad shares its rows)
    bf16* const cout = tl.job ? c1 : c0;
    const Strides cst = tl.job ? cs1 : cs0;
    bf16* const base = cout + tl.b * cst.b + tl.h * cst.h + 64 * tl.ch0 + 8 * t;
    const int row0 = tl.m0 + 64 * wg + 16 * warp + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool live = row < rows_live;
      bf16* const out = base + static_cast<long long>(row) * cst.n;
#pragma unroll
      for (int c = 0; c < BD_NW; ++c)
        if (c < tl.nw) {
          uint32_t w[8];
#pragma unroll
          for (int dt = 0; dt < 8; ++dt)
            w[dt] = live ? pack_bf16(acc[c][dt][2 * r],
                                     acc[c][dt][2 * r + 1])
                         : 0u;
          uint4 c0_, c1_;
          quad_chunks(w, t, c0_, c1_);
          if (row < n) {
            *reinterpret_cast<uint4*>(out + 64 * c) = c0_;
            *reinterpret_cast<uint4*>(out + 64 * c + 32) = c1_;
          }
        }
    }
  }
}

// --------------------------------------------------------------- host ---
inline long long bd_n_pad(int n) {
  return (n + BD_PAD - 1) / BD_PAD * static_cast<long long>(BD_PAD);
}

// floats of the scratch the backward takes (the port's wrapper allocates
// it): lse and delta of the padded rows, (B H, N_pad) each, then the p^T
// and ds^T planes, (B H, N_pad, N_pad) bf16 each; N_pad = round_up(N,
// BD_PAD)
inline long long bd_scratch_floats(int batch, int n, int heads) {
  const long long np = bd_n_pad(n);
  return 2LL * batch * heads * np + static_cast<long long>(batch) * heads *
                                        np * np;
}

// the map of a plane (B H, n_pad, n_pad) bf16 at `ptr`: dims (n_pad,
// n_pad, B H), 64 x 64 boxes, the 128-byte swizzle
inline bool encode_plane64(CUtensorMap* map, const void* ptr, long long bh,
                           long long n_pad) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n_pad),
                              static_cast<cuuint64_t>(n_pad),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n_pad) * 2,
                                 static_cast<cuuint64_t>(n_pad * n_pad) * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the prep pass, the scores kernel and the two product launches on
// `stream`, arguments as maest_attn_bwd_bf16_dn's (scratch:
// bd_scratch_floats floats)
inline int launch_bwd_dn_wgmma(int dp, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               const float* lse, float* scratch, void* dq,
                               void* dk, void* dv, int batch, int n,
                               int heads, int n_real, const long long* st,
                               float sl, float scale, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (dp <= 256 || dp % 64 || n_real < 1 || n_real > n)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[8];  // q, k, v, o, dout, dq, dk, dv
  for (int i = 0; i < 8; ++i)
    s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const long long n_pad = bd_n_pad(n);
  const long long bh = static_cast<long long>(batch) * heads;
  const long long rows = bh * n_pad;
  float* lse_p = scratch;
  float* delta_p = scratch + rows;
  bf16* pt = reinterpret_cast<bf16*>(scratch + 2 * rows);
  bf16* dst = pt + bh * n_pad * n_pad;
  attn_bwd_prep_dn_kernel<<<static_cast<unsigned>((8 * rows + 255) / 256),
                            256, 0, cs>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse_p,
      delta_p, batch, n, static_cast<int>(n_pad), heads, dp, s[3], s[4]);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // once, before any launch a graph captures; the setting holds for the
  // current device only: the port drives one card a process
  static const cudaError_t attr = [] {
    const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t e = cudaFuncSetAttribute(attn_bwd_dn_scores_kernel, a,
                                         BD_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_dn_mm_kernel<false>, a,
                               bd_mm_smem_bytes());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_dn_mm_kernel<true>, a,
                               bd_mm_smem_bytes());
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv, tdo, tpt, tds;
  if (!encode_bnh64(&tq, q, batch, n, heads, s[0], 64, dp) ||
      !encode_bnh64(&tk, k, batch, n, heads, s[1], 64, dp) ||
      !encode_bnh64(&tv, v, batch, n, heads, s[2], 64, dp) ||
      !encode_bnh64(&tdo, dout, batch, n, heads, s[4], 64, dp) ||
      !encode_plane64(&tpt, pt, bh, n_pad) ||
      !encode_plane64(&tds, dst, bh, n_pad))
    return static_cast<int>(cudaErrorInvalidValue);

  int stages = bd_resident_stages(dp);
  const int resident = stages > 0;
  if (!resident)
    stages = (BD_SMEM - 1024 - BD_BAR_BYTES) / static_cast<int>(BD_STAGE);
  if (stages > BD_MAX_STAGES) stages = BD_MAX_STAGES;
  const int smem = 1024 + (resident ? 2 * (dp / 64) * 2 * BD_STAGE : 0) +
                   stages * static_cast<int>(BD_STAGE) + BD_BAR_BYTES;
  const int n_mb = static_cast<int>(n_pad / BD_KEYS);
  attn_bwd_dn_scores_kernel<<<static_cast<unsigned>(bh * n_mb), BD_THREADS,
                              smem, cs>>>(
      tq, tk, tv, tdo, lse_p, delta_p, pt, dst, n, static_cast<int>(n_pad),
      n_real, heads, dp, resident, stages, sl, scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const int col_tiles = (dp / 64 + BD_NW - 1) / BD_NW;
  const long long tiles = bh * n_mb * col_tiles;
  constexpr int mm_smem = bd_mm_smem_bytes();
  // one product block an SM, each walking tiles gridDim.x apart: a tile's
  // k-steps are few (N / 64), so its ring fills under the tile before
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  attn_bwd_dn_mm_kernel<false><<<static_cast<unsigned>(
                                     2 * tiles < sms ? 2 * tiles : sms),
                                 BD_THREADS, mm_smem, cs>>>(
      tpt, tdo, tds, tq, static_cast<bf16*>(dv), static_cast<bf16*>(dk), s[7],
      s[6], n, static_cast<int>(n_pad), n_real, static_cast<int>(bh), heads,
      dp);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  attn_bwd_dn_mm_kernel<true><<<static_cast<unsigned>(
                                    tiles < sms ? tiles : sms),
                                BD_THREADS, mm_smem, cs>>>(
      tds, tk, tds, tk, static_cast<bf16*>(dq), static_cast<bf16*>(dq), s[5],
      s[5], n, static_cast<int>(n_pad), n_real, static_cast<int>(bh), heads,
      dp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
