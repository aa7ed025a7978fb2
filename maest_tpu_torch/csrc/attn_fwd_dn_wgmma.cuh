// The bf16 attention forward at any head_dim dp above 256 (a multiple of 64)
// on Hopper's asynchronous machinery (sm_90a): K2 (no lse) and K3a (lse),
// the route of maest_attn_fwd_bf16_dn (attention_fwd.cu), which keeps the
// mma.sync kernel beside it as maest_attn_fwd_bf16_dn_mma.
//
// It computes what maest_tpu/ops/attention.py::_attn_kernel + _attn_body
// compute, as the head_dim-64 kernel of attn_fwd_wgmma.cuh does: scores
// q.k scaled by sl = scale log2(e), keys >= n_real at -1e30, the running max
// m and sum l in fp32, p = exp2(s - m) in fp32 summed into l, p rounded to
// bf16 for P.V with fp32 sums, the output divided by l once at the end,
// lse = m + log2(l) (B, H, N) in the log2 domain the backward reads.
//
// What bounds it: the two products, 4 B H N^2 dp operations, at the bf16
// tensor-core peak (0.279 ms at (32, 1676, 2, 384)); exp2 counts N^2 a head,
// 1/6 of head_dim 64's for the same operations at 384, so the products bind.
// Each score sums dp values: 24 wgmma k-steps at 384.
//
// Design:
//   - Grid: one block a (batch, head), 128 query rows and one output slice
//     of up to 192 columns (DN_VC V chunks of 64), the slices of a q tile
//     on neighbouring blocks (they read the same q and K from L2). A block
//     computes the scores over the full dp, so at dp 384 (two slices) they
//     are made twice: 6 B H N^2 dp operations in all, not 4.
//   - TMA: q, k and v are read through 4-D tensor maps of their strided
//     (B, N, H, dp) views, dims (dp, H, N, B), in boxes of 64 columns x 64
//     rows (8 KB) under the 128-byte swizzle; rows past N arrive as zeros.
//   - Shared memory: q's 128 x dp block stays resident (96 KB at 384) and a
//     ring of 8 KB stages streams, for each key tile of 64 keys, its dp/64
//     K chunks and then the slice's V chunks, with full and empty mbarriers
//     (16 stages at 384). Where q and a 4-stage ring do not fit in the 227
//     KB a block may take (dp above 768), q's chunks stream through the ring
//     too, each as two items of 64 rows before the K chunk it multiplies (a
//     branch of the same kernel).
//   - Warp specialisation: two consumer warpgroups own 64 query rows each;
//     one producer warp after them issues every TMA load from one thread.
//   - Registers: ptxas holds a kernel of more than 8 warps to 168 registers
//     a thread whatever setmaxnreg grants (nvcc 12.9: a producer warpgroup
//     or warp alike), so a consumer keeps O (96 of them for 192 columns), S
//     and P of a 64-key tile (32 and 16); 128-key tiles spilled and
//     serialised the wgmma, and 128-column slices (S made 3 times at 384)
//     ran 1.3x slower on the H100.
//   - Products: S = Q.K^T by wgmma m64n64k16 with both operands from
//     shared-memory descriptors (K-major), summed over the chunks, one
//     commit group a chunk and each chunk's stages released once the next
//     chunk's products are issued and its own are done (wgmma.wait_group
//     1); the first chunk's first product overwrites S (scale_d a
//     constant 0, so S holds no registers between tiles). O += P.V by wgmma
//     m64n64k16 with P from registers (S's accumulator layout is the
//     register-A layout, so p is packed where it is made) and V as it lies,
//     MN-major, through the transpose bit.
//   - Each consumer runs its S, softmax and P.V in turn; the two consumers
//     drift apart, so one's softmax runs under the other's products.

#pragma once

#include "attn_fwd_wgmma.cuh"

namespace maest {

constexpr int DN_BQ = 128;                 // query rows a block
constexpr int DN_BK = 64;                  // keys a tile
constexpr int DN_VC = 3;                   // V chunks of 64 columns a slice
constexpr int DN_SLICE_COLS = 64 * DN_VC;  // output columns a block
// a ring stage: a K or V chunk of a key tile, or 64 rows of a q chunk
constexpr uint32_t DN_STAGE = DN_BK * 128;
constexpr uint32_t DN_QCHUNK = DN_BQ * 128;  // a q chunk: 128 rows of 64
constexpr int DN_SMEM = 227 * 1024;  // dynamic shared memory a block takes
constexpr int DN_MIN_STAGES = 4;     // the ring beside a resident q
constexpr int DN_MAX_STAGES = 28;    // barriers fit in DN_BAR_BYTES
constexpr int DN_BAR_BYTES = 512;
constexpr int DN_THREADS = 256 + 32;  // two consumer warpgroups, a producer warp
static_assert(DN_BK == 64, "a stage holds 64 rows of q as of K or V");

// the ring's stages at width dp beside a resident q (a DN_MIN_STAGES ring
// at least), or 0 where they do not fit and q streams through the ring
inline int dn_resident_stages(int dp) {
  const int left = DN_SMEM - 1024 - DN_BAR_BYTES -
                   dp / 64 * static_cast<int>(DN_QCHUNK);
  const int stages = left < 0 ? 0 : left / static_cast<int>(DN_STAGE);
  return stages >= DN_MIN_STAGES ? (stages < DN_MAX_STAGES ? stages
                                                           : DN_MAX_STAGES)
                                 : 0;
}

// grid (B H ceil(N / 128) slices), DN_THREADS threads; tq, tk, tv: the maps
// of the (B, N, H, dp) views in boxes of 64 columns x 64 rows. resident: q
// is held in shared memory (else streamed through the ring, each 64-column
// chunk as two items of 64 rows, then the K chunk); stages: the ring's
// length.
__global__ void __launch_bounds__(DN_THREADS, 1)
attn_fwd_dn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         bf16* __restrict__ out, float* __restrict__ lse,
                         int n, int n_real, int heads, int dp, int slices,
                         int resident, int stages, Strides os, float sl) {
  extern __shared__ uint8_t dn_smem[];
  const int nch = dp / 64;  // K (and q) chunks
  const uint32_t sq = (smem_addr(dn_smem) + 1023u) & ~1023u;
  const uint32_t ring = sq + (resident ? nch * DN_QCHUNK : 0u);
  const uint32_t bars = ring + stages * DN_STAGE;  // 8 bytes each
  const uint32_t full_q = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + stages + s); };

  const int q_tiles = (n + DN_BQ - 1) / DN_BQ;
  const int z = blockIdx.x % slices;  // this block's output slice
  const int rest = blockIdx.x / slices;
  const int bh = rest / q_tiles;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = (rest - bh * q_tiles) * DN_BQ;
  const int c0 = z * DN_SLICE_COLS;  // its first column
  const int nvc = min(DN_SLICE_COLS, dp - c0) / 64;
  const int kitems = resident ? nch : 3 * nch;  // ring items of S a tile
  const int per_tile = kitems + nvc;
  const int n_tiles = (n_real + DN_BK - 1) / DN_BK;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // uniform

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
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
        mbar_expect_tx(full_q, nch * DN_QCHUNK);
        for (int c = 0; c < nch; ++c)
          for (int half = 0; half < 2; ++half)
            tma_load_4d(sq + c * DN_QCHUNK + half * DN_STAGE, &tq, full_q,
                        64 * c, h, q0 + 64 * half, b);
      }
      int st = 0;
      uint32_t ph = 0;
      for (int it = 0; it < n_tiles; ++it) {
        for (int c = 0; c < per_tile; ++c) {
          qw_wait(empty(st), ph ^ 1);  // the first round passes at once
          const uint32_t dst = ring + st * DN_STAGE;
          const int kc = resident ? c : c / 3;  // the chunk of an S item
          mbar_expect_tx(full(st), DN_STAGE);
          if (c >= kitems)  // the slice's V chunk c - kitems
            tma_load_4d(dst, &tv, full(st), c0 + 64 * (c - kitems), h,
                        it * DN_BK, b);
          else if (!resident && c % 3 < 2)  // q's chunk kc, 64 rows
            tma_load_4d(dst, &tq, full(st), 64 * kc, h, q0 + 64 * (c % 3), b);
          else  // K's chunk
            tma_load_4d(dst, &tk, full(st), 64 * kc, h, it * DN_BK, b);
          if (++st == stages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    const int cw = wg;  // this consumer's 64 rows: q0 + 64 cw ..
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t rows = cw * DN_STAGE;  // its rows' offset in a q chunk

    float o[DN_VC][8][4];
#pragma unroll
    for (int vc = 0; vc < DN_VC; ++vc)
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[vc][dt][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float s[DN_BK / 8][4];    // scores
    uint32_t pf[DN_BK / 16][4];  // p in bf16: the A fragments of P.V

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
    auto release = [&](int stage) { mbar_arrive(empty(stage)); };
    auto release_s = [&](int q0s, int q1s, int ks) {  // an S chunk's items
      if (q0s >= 0) {
        release(q0s);
        release(q1s);
      }
      release(ks);
    };

    if (resident) qw_wait(full_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      // s = Q.K^T, one commit group a 64-column chunk of dp; the first
      // chunk's first product overwrites s (a constant scale_d, so s is
      // dead from the last tile's softmax on). held_*: the stages of the
      // chunk in flight, q's two halves (streamed) and K
      int held_q0 = -1, held_q1 = -1, held_k = -1;
      auto s_chunk = [&](int kc, int acc) {
        const int q0s = resident ? -1 : take();
        const int q1s = resident ? -1 : take();
        const int ks = take();
        const uint32_t qa = resident ? sq + kc * DN_QCHUNK + rows
                                     : ring + (cw ? q1s : q0s) * DN_STAGE;
        const uint64_t da = sw128_desc(qa);
        const uint64_t db = sw128_desc(ring + ks * DN_STAGE);
        wgmma_ss<DN_BK>(s, da, db, acc);
#pragma unroll
        for (int kk = 1; kk < 4; ++kk)  // +32 bytes a k-step
          wgmma_ss<DN_BK>(s, da + 2 * kk, db + 2 * kk, 1);
        wgmma_commit();
        if (acc) {  // the chunk before is done
          wgmma_wait<1>();
          release_s(held_q0, held_q1, held_k);
        }
        held_q0 = q0s;
        held_q1 = q1s;
        held_k = ks;
      };
      wgmma_fence();
      s_chunk(0, 0);
      for (int kc = 1; kc < nch; ++kc) s_chunk(kc, 1);
      wgmma_wait<0>();
      reg_fence(s);
      release_s(held_q0, held_q1, held_k);

      // the softmax of this tile: masked scores, the new running max, o
      // rescaled, p summed in fp32 and packed into P's bf16 A fragments
      // (n-tiles 2j, 2j + 1 of the scores form k-step j)
      const int base = it * DN_BK;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < DN_BK / 8; ++nt)
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
      for (int vc = 0; vc < DN_VC; ++vc)
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[vc][dt][e] *= corr[e >> 1];
#pragma unroll
      for (int nt = 0; nt < DN_BK / 8; ++nt) {
        const float p0 = exp2f(s[nt][0] - m[0]);
        const float p1 = exp2f(s[nt][1] - m[0]);
        const float p2 = exp2f(s[nt][2] - m[1]);
        const float p3 = exp2f(s[nt][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      }

      // o += P.V over the slice's chunks, one commit group a chunk
      int held_v = -1;
#pragma unroll
      for (int vc = 0; vc < DN_VC; ++vc) {
        if (vc < nvc) {
          const int vs = take();
          const uint64_t dv = sw128_desc(ring + vs * DN_STAGE);
          if (vc == 0) {
#pragma unroll
            for (int i = 0; i < DN_VC; ++i) reg_fence(o[i]);
            reg_fence(pf);
            wgmma_fence();
          }
#pragma unroll
          for (int kj = 0; kj < DN_BK / 16; ++kj)  // +2048 bytes: 16 rows
            wgmma_rs_n64_t(o[vc], pf[kj], dv + kj * 128);
          wgmma_commit();
          if (vc > 0) {
            wgmma_wait<1>();
            release(held_v);
          }
          held_v = vs;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DN_VC; ++i) reg_fence(o[i]);
      reg_fence(pf);
      release(held_v);
    }

    // epilogue: o / l in bf16, rows past N never stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row0 = q0 + cw * 64 + warp * 16 + g;  // and row0 + 8
    bf16* ob = out + b * os.b + h * os.h + c0 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n) continue;
      bf16* orow = ob + static_cast<long long>(row) * os.n;
#pragma unroll
      for (int vc = 0; vc < DN_VC; ++vc)
        if (vc < nvc)
#pragma unroll
          for (int dt = 0; dt < 8; ++dt)
            *reinterpret_cast<__nv_bfloat162*>(orow + 64 * vc + 8 * dt) =
                __floats2bfloat162_rn(o[vc][dt][2 * r] / l[r],
                                      o[vc][dt][2 * r + 1] / l[r]);
      if (lse != nullptr && z == 0 && t == 0)
        lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
    }
  }
}

// one launch on `stream`, arguments as maest_attn_fwd_bf16_dn's
inline int launch_fwd_dn_wgmma(int dp, const void* q, const void* k,
                               const void* v, void* out, float* lse,
                               int batch, int n, int heads, int n_real,
                               const long long* st, float sl, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (dp <= 256 || dp % 64) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  int stages = dn_resident_stages(dp);
  const int resident = stages > 0;
  if (!resident)
    stages = (DN_SMEM - 1024 - DN_BAR_BYTES) / static_cast<int>(DN_STAGE);
  if (stages > DN_MAX_STAGES) stages = DN_MAX_STAGES;
  const int smem = 1024 +
                   (resident ? dp / 64 * static_cast<int>(DN_QCHUNK) : 0) +
                   stages * static_cast<int>(DN_STAGE) + DN_BAR_BYTES;
  // once, before any launch a graph captures; the setting holds for the
  // current device only: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_dn_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DN_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  if (!encode_bnh64(&tq, q, batch, n, heads, qs, 64, dp) ||
      !encode_bnh64(&tk, k, batch, n, heads, ks, DN_BK, dp) ||
      !encode_bnh64(&tv, v, batch, n, heads, vs, DN_BK, dp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (dp + DN_SLICE_COLS - 1) / DN_SLICE_COLS;
  const long long grid =
      static_cast<long long>((n + DN_BQ - 1) / DN_BQ) * batch * heads * slices;
  attn_fwd_dn_wgmma_kernel<<<static_cast<unsigned>(grid), DN_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, n, n_real, heads, dp, slices,
      resident, stages, os, sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
