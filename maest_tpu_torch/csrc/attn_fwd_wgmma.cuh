// The bf16 attention forward at head_dim 64 and 128 on Hopper's
// asynchronous machinery (sm_90a): K2 (no lse) and K3a (lse), the
// production instances behind maest_attn_fwd_bf16 and
// maest_attn_fwd_bf16_d128 (attention_fwd.cu), which keep the mma.sync
// kernels of attn_fwd_bf16.cuh beside them as maest_attn_fwd_bf16_mma and
// maest_attn_fwd_bf16_d128_mma; and the decomposition rig's P6d (BF16S) and
// P6e (G heads a block, maest_attn_probe_gh in attention_probe.cu).
//
// It computes what maest_tpu/ops/attention.py::_attn_kernel + _attn_body
// compute, as that kernel does: scores q.k scaled by sl = scale log2(e),
// keys >= n_real at -1e30, the running max m and sum l in fp32, p =
// exp2(s - m) in fp32 summed into l, p rounded to bf16 for P.V with fp32
// sums, the output divided by l once at the end, lse = m + log2(l) (B, H,
// N) in the log2 domain the backward reads.
//
// What bounds it: at (32, 1676, 12, 64) the two products take 0.279 ms at
// the bf16 tensor-core peak and the N^2 exp2 ~0.26 ms on the special-
// function units, so it is bound by operations of two kinds that run on
// different units, and the design's aim is to overlap them. At (32, 1676,
// 6, 128) the products take the same 0.279 ms and the exp2 half as long.
//
// Design (the usual shape of a fast Hopper kernel):
//   - TMA: q, k and v are read through 4-D tensor maps of their strided
//     (B, N, H, D) views, dims (D, H, N, B), in boxes of 64 columns with
//     the 128-byte swizzle (one bf16 row of 64 is one swizzle row; at D =
//     128 a row is two boxes, each landing as a tile of head_dim 64's
//     layout). Rows past N arrive as zeros; the key mask covers them since
//     n_real <= N, and query rows past N are never stored. The maps are
//     encoded on the host per call (cuTensorMapEncodeTiled, fetched through
//     cudaGetDriverEntryPoint so the library needs no -lcuda) and passed as
//     __grid_constant__.
//   - Warp specialisation: warpgroup 0 is the producer: one thread loads
//     the block's q and keeps K and V tiles of BK keys in flight in a ring
//     of ST stages, with full and empty mbarriers for K and for V apart (K
//     of a stage is released as soon as its scores are made). NC consumer
//     warpgroups own 64 query rows each. setmaxnreg gives the consumers the
//     producer's registers.
//   - Products: S = Q.K^T by wgmma m64nBKk16 with Q and K from shared-
//     memory descriptors (K-major, as both lie), 4 k-steps a 64-column
//     chunk of D; O += P.V by wgmma m64n64k16, one a chunk of V, with P from
//     registers (the accumulator layout of S is the register-A layout of a
//     16-bit wgmma, so P is packed in place) and V as it lies, MN-major,
//     through the descriptor's transpose bit.
//   - Overlap: each iteration issues the next tile's S and this tile's
//     P.V together, then runs the next tile's softmax while P.V is in
//     flight (wgmma.wait_group 1). With PP, the consumer warpgroups take
//     turns to issue through named barriers, so one's exp2 runs under the
//     other's products.
// The tiles (BK, NC, PP, ST) were chosen by sweeps on the card (chip_smoke.py
// phase 30 at head_dim 64, maest_attn_fwd_bf16_wgmma's configurations:
// three consumer warpgroups taking turns, 96 or 112 keys a tile, whichever
// pads the real keys least; phase 43 at head_dim 128,
// maest_attn_fwd_bf16_d128_wgmma's: two consumer warpgroups, since ptxas
// holds a kernel of 16 warps to 128 registers a thread and O alone takes 64
// of them at D = 128 (three warpgroups spilled), 80 or 96 keys, two stages).
//
// BF16S: the decomposition rig's bf16-score forward (P6d,
// scripts/attn_profile_r2.py:113 _bf16_scores_kernel, the route of
// attention_probe.cu's maest_attn_probe_bf16s_wgmma). Each consumer
// pre-scales its TMA-loaded q rows in shared memory once, bf16(fp32(q) sl)
// as the rig's caller does (ops/attention_probe.py prescale_q), and makes
// them visible to wgmma (fence.proxy.async, a barrier over the
// warpgroup); S comes from the same wgmma chain, is rounded to bf16 in
// registers after the mask (bf16_round2, a pair at a time; masked keys at
// bf16(-1e30)), and the max, exp2, sums and correction run as K2's on the
// rounded values. No lse.
//
// G > 1: the rig's G heads a program (P6e, scripts/attn_profile_r2.py:148
// _gh_kernel), K2's function with G (batch, head) pairs a block in turn;
// see the kernel's note.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked

#include "mma_bf16.cuh"

namespace maest {

// ---------------------------------------------------------------- PTX ---
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a 4-D box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at dst; completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// until the phase of the given parity has completed (mbar_wait's); a wait that outlasts 2^22 polls, far past any tile's work,
// traps, so a fault fails the launch instead of holding the card
__device__ __forceinline__ void qw_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 22)) __trap();
  } while (!done);
}

// a 3-D box of `map` at coordinates (c0, c1, c2), innermost first, into
// shared memory at dst; completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// the PTX of the loads above, each issued only where `on` holds, as a
// predicate of the instruction and not a branch: every thread of a kernel
// whose consumers also issue its loads (attn_bwd_d256_wgmma.cuh's dk/dv
// kernel, attn_fwd_d256_wgmma.cuh) runs the same code, so ptxas sees no
// divergent path around the wgmma pipeline
__device__ __forceinline__ void mbar_expect_tx_if(bool on, uint32_t bar,
                                                  uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %2;\n}\n" ::"r"(
          static_cast<int>(on)),
      "r"(bar), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d_if(bool on, uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1,
                                               int c2, int c3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%1], [%2, {%4, %5, %6, %7}], [%3];\n}\n" ::"r"(
          static_cast<int>(on)),
      "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// this thread's writes to shared memory, visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the shared-memory matrix descriptor of a tile of 128-byte rows written
// by TMA with the 128-byte swizzle (8-row atoms of 1024 bytes, the tile
// 1024-byte aligned): start address >> 4, both byte offsets 1024 (the one
// the layout reads, between 8-row groups; the other is unused at 64
// columns), layout 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (64ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it
template <int R>
__device__ __forceinline__ void reg_fence(float (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[i][e])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
}

// d (64 x 64, fp32, C layout a warp) (+)= A (64 x 16, shared memory) . B
// (16 x 64, shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
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

// d (64 x 80, fp32, C layout a warp) (+)= A (64 x 16, shared memory) . B
// (16 x 80, shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[10][4], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 96, fp32, C layout a warp) (+)= A (64 x 16, shared memory) . B
// (16 x 96, shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[12][4], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 112, fp32, C layout a warp) (+)= A (64 x 16, shared memory) . B
// (16 x 112, shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n112(float (&d)[14][4], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "%56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128, fp32, C layout a warp) (+)= A (64 x 16, shared memory) . B
// (16 x 128, shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 192, fp32, C layout a warp) (+)= A (64 x 16, shared memory) . B
// (16 x 192, shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[24][4], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16 bf16, registers: the m16n8k16 A fragment
// of each warp's 16 rows) . B (16 x 64, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_ss(float (&d)[BK / 8][4], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (BK == 64)
    wgmma_ss_n64(d, a, b, scale_d);
  else if constexpr (BK == 80)
    wgmma_ss_n80(d, a, b, scale_d);
  else if constexpr (BK == 96)
    wgmma_ss_n96(d, a, b, scale_d);
  else if constexpr (BK == 112)
    wgmma_ss_n112(d, a, b, scale_d);
  else if constexpr (BK == 128)
    wgmma_ss_n128(d, a, b, scale_d);
  else
    wgmma_ss_n192(d, a, b, scale_d);
}

// ------------------------------------------------------------- kernel ---
constexpr int WG_STAGES = 2;  // K/V tiles in flight at head_dim 64
constexpr int WG_BAR_BYTES = 256;  // the mbarriers' room

// dynamic shared memory of an instance: 1024 bytes of alignment slack, q
// (64 NC rows of d / 64 chunks of 128-byte rows; two buffers where a block
// takes g > 1 heads), the K and V rings (st stages of bk rows a chunk) and
// the mbarriers
__host__ __device__ constexpr int wg_smem_bytes(int bk, int nc, int d = 64,
                                                int g = 1,
                                                int st = WG_STAGES) {
  return 1024 + (g > 1 ? 2 : 1) * 64 * nc * 2 * d + 2 * st * bk * 2 * d +
         WG_BAR_BYTES;
}

// the registers a consumer thread may hold (setmaxnreg): all but the
// producer's share of the 64K an SM has
__host__ __device__ constexpr int wg_producer_regs(int nc) {
  return nc == 2 ? 24 : 32;
}
__host__ __device__ constexpr int wg_consumer_regs(int nc) {
  return nc == 2 ? 240 : 160;
}

// the key tile that maest_attn_fwd_bf16 (K2, K3a), the bf16s probe and the
// gh probe take at n_real real keys: 112 where it pads them less than 96
// does, else 96 (ops/attention.py wg_key_tile is the same rule)
__host__ __device__ constexpr int wg_key_tile(int n_real) {
  return (n_real + 111) / 112 * 112 < (n_real + 95) / 96 * 96 ? 112 : 96;
}

// the key tile that maest_attn_fwd_bf16_d128 (K2, K3a at head_dim 128)
// takes at n_real real keys: 96 where it pads them less than 80 does, else
// 80 (ops/attention.py wg128_key_tile is the same rule)
__host__ __device__ constexpr int wg128_key_tile(int n_real) {
  return (n_real + 95) / 96 * 96 < (n_real + 79) / 80 * 80 ? 96 : 80;
}

// a and b rounded to the nearest bf16, ties to even, in place, as fp32:
// one conversion of the pair (the unit that also runs the softmax's exp2;
// a conversion each, or the rounding in integer instructions, measured
// slower on the H100) and two integer instructions to widen it back
__device__ __forceinline__ void bf16_round2(float& a, float& b) {
  const uint32_t u = pack_bf16(a, b);  // a in the low half
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xFFFF0000u);
}

// a when i is 0, b when 1, c when 2, d when 3: a register picked by a
// runtime index without an array in local memory
__device__ __forceinline__ uint32_t pick4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// a row's 8 16-byte chunks (64 bf16) as the accumulator layout spreads
// them over a quad: thread t holds word t (columns 8 j + 2 t, + 1) of
// every chunk j, w[j]. Three shuffles a half move them so that thread t
// holds whole chunks t (c0) and t + 4 (c1), which it stores as 16 bytes:
// a warp then writes 64 contiguous bytes a row, two full sectors, where
// four-byte stores left each 32-byte sector half written per instruction.
__device__ __forceinline__ void quad_chunks(const uint32_t (&w)[8], int t,
                                            uint4& c0, uint4& c1) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t a = w[4 * h], b = w[4 * h + 1], c = w[4 * h + 2],
                   d = w[4 * h + 3];
    uint32_t g[4];  // g[i]: thread t ^ i's word of chunk 4 h + t
    g[0] = pick4(a, b, c, d, t);
#pragma unroll
    for (int i = 1; i < 4; ++i)
      g[i] = __shfl_xor_sync(0xffffffffu, pick4(a, b, c, d, t ^ i), i);
    uint4& out = h ? c1 : c0;  // word s of the chunk is thread s's
    out.x = pick4(g[0], g[1], g[2], g[3], t);
    out.y = pick4(g[0], g[1], g[2], g[3], 1 ^ t);
    out.z = pick4(g[0], g[1], g[2], g[3], 2 ^ t);
    out.w = pick4(g[0], g[1], g[2], g[3], 3 ^ t);
  }
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// grid (B H / G ceil(N / (64 NC))): block x takes the q tile x % q_tiles of
// the G (batch, head) pairs G (x / q_tiles) .., in turn; the q tiles of one
// head group on neighbouring blocks (they share K and V in L2). 128 (NC +
// 1) threads. tq, tk, tv: the maps of the (B, N, H, D) views with boxes of
// 64 columns and 64 NC (q) or BK (k, v) rows; a row of D is D / 64 boxes.
//
// G > 1 (P6e, the gh probe): the producer runs ahead across a head
// boundary, loading the next head's q into the other of two q buffers
// (each with its full and empty mbarrier) and its K and V tiles into the
// same ring, so the ring never drains between heads; each head keeps its
// own m, l and o, so its output is G = 1's bit for bit.
//
// D = 128 (K2 and K3a at head_dim 65-128): every q, K and V tile is two
// 64-column chunks, each a tile of head_dim 64's layout (rows of 128 bytes
// under the 128-byte swizzle); S sums the 4 k-steps of each chunk (8 in
// all) and P.V runs one m64n64k16 a chunk of V, each on its own descriptor
// (no stride across the chunks to get wrong), into o's two halves. O takes
// 64 registers a thread, S BK / 2 and P BK / 4 beside it.
template <int BK, int NC, bool PP, bool BF16S = false, int G = 1, int D = 64,
          int ST = WG_STAGES>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ out, float* __restrict__ lse, int n,
                      int n_real, int heads, Strides os, float sl_arg) {
  constexpr int BQ = 64 * NC;
  constexpr int NCH = D / 64;       // 64-column chunks of a row
  constexpr int QB = G > 1 ? 2 : 1;  // q buffers
  constexpr uint32_t Q_CHUNK = BQ * 128;
  constexpr uint32_t Q_BYTES = NCH * Q_CHUNK;   // a head's q tile
  constexpr uint32_t KV_CHUNK = BK * 128;
  constexpr uint32_t KV_BYTES = NCH * KV_CHUNK;  // a K or a V stage
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static_assert(8 * (2 * QB + 4 * ST) <= WG_BAR_BYTES, "mbarriers' room");
  extern __shared__ uint8_t wg_smem[];
  const uint32_t sq = (smem_addr(wg_smem) + 1023u) & ~1023u;  // + qb Q_BYTES
  const uint32_t sk = sq + QB * Q_BYTES;  // stage s: + s KV_BYTES
  const uint32_t sv = sk + ST * KV_BYTES;
  const uint32_t bars = sv + ST * KV_BYTES;  // 8 bytes each
  auto full_q = [&](int qb) { return bars + 8 * qb; };
  auto empty_q = [&](int qb) { return bars + 8 * (QB + qb); };
  auto full_k = [&](int s) { return bars + 8 * (2 * QB + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 * QB + ST + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 * QB + 2 * ST + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 * QB + 3 * ST + s); };

  const int q_tiles = (n + BQ - 1) / BQ;
  const int grp = blockIdx.x / q_tiles;  // (batch, head) pairs G grp ..
  const int q0 = (blockIdx.x - grp * q_tiles) * BQ;
  const int n_tiles = (n_real + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int qb = 0; qb < QB; ++qb) {
      mbar_init(full_q(qb), 1);
      mbar_init(empty_q(qb), 128 * NC);  // every consumer thread releases
    }
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 128 * NC);
      mbar_init(empty_v(s), 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------ producer
    setmaxnreg_dec<wg_producer_regs(NC)>();
    // the producer's waits trap after 2^22 polls (qw_wait), so a fault in
    // the ring fails the launch instead of holding the card; the consumers
    // spin plainly (mbar_wait): a poll counter in their loop spilled the
    // head_dim-64 instances (ptxas, 128 registers at 16 warps)
    if (threadIdx.x == 0) {
      int j = 0;  // the block's K/V tiles so far, over its heads
      for (int hg = 0; hg < G; ++hg) {
        const int bh = grp * G + hg;
        const int b = bh / heads;
        const int h = bh - b * heads;
        const int qb = hg % QB;
        // the first use of a buffer passes at once; a later one waits for
        // the consumers to release the head before
        qw_wait(empty_q(qb), ((hg / QB) & 1) ^ 1);
        mbar_expect_tx(full_q(qb), Q_BYTES);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)  // q of this head
          tma_load_4d(sq + qb * Q_BYTES + ch * Q_CHUNK, &tq, full_q(qb),
                      64 * ch, h, q0, b);
        for (int it = 0; it < n_tiles; ++it, ++j) {
          const int s = j % ST;
          const uint32_t ph = (j / ST) & 1;
          qw_wait(empty_k(s), ph ^ 1);  // the first round passes at once
          mbar_expect_tx(full_k(s), KV_BYTES);
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch)
            tma_load_4d(sk + s * KV_BYTES + ch * KV_CHUNK, &tk, full_k(s),
                        64 * ch, h, it * BK, b);
          qw_wait(empty_v(s), ph ^ 1);
          mbar_expect_tx(full_v(s), KV_BYTES);
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch)
            tma_load_4d(sv + s * KV_BYTES + ch * KV_CHUNK, &tv, full_v(s),
                        64 * ch, h, it * BK, b);
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<wg_consumer_regs(NC)>();
    // the factor of the scores in the softmax: scale log2(e), or 1 where
    // (BF16S) q is pre-scaled by it
    const float sl = BF16S ? 1.f : sl_arg;
    const int c = wg - 1;  // this consumer's 64 rows: q0 + 64 c ..
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // PP: consumer c issues after named barrier 1 + c, then lets the next
    // one go; the last consumer lets consumer 0 take the first turn. Each
    // head takes n_tiles + 1 turns: S_0, then S_it with P.V_it-1, P.V_last
    const int turns = G * (n_tiles + 1);
    int turn = 0;
    auto take_turn = [&] {
      if constexpr (PP)
        asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
    };
    auto pass_turn = [&] {
      if constexpr (PP) {
        // the last consumer's last turn has no one to hand over to: its
        // first hand-over went to consumer 0 ahead of any turn
        if (!(c == NC - 1 && turn == turns - 1))
          asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (c + 1) % NC)
                       : "memory");
      }
      ++turn;
    };
    if constexpr (PP) {
      if (c == NC - 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    }

    float o[NCH][8][4];
    float m[2], l[2];         // l: this thread's share of the row sums
    float s[BK / 8][4];       // scores, then p in fp32
    uint32_t pf[BK / 16][4];  // p in bf16: the A fragments of P.V
    float corr[2];
    uint64_t dq = 0;  // this consumer's q rows of the head (chunk 0)
    int j0 = 0;       // the block's K/V tiles before this head
    // the ring stage and phase of this head's key tile it
    auto stage = [&](int it) { return (G > 1 ? j0 + it : it) % ST; };
    auto parity = [&](int it) {
      return static_cast<uint32_t>(((G > 1 ? j0 + it : it) / ST) & 1);
    };
    auto fence_o = [&] {
#pragma unroll
      for (int vc = 0; vc < NCH; ++vc) reg_fence(o[vc]);
    };

    // s = Q.K^T of the key tile in stage st (4 k-steps of 16 a chunk of d)
    auto issue_s = [&](int st) {
      const uint64_t dk = sw128_desc(sk + st * KV_BYTES);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)  // S sums every chunk of d
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // +32 bytes a k-step
          wgmma_ss<BK>(s, dq + ch * (Q_CHUNK >> 4) + 2 * kk,
                       dk + ch * (KV_CHUNK >> 4) + 2 * kk, ch * 4 + kk);
      wgmma_commit();
    };
    // o += P.V of the key tile in stage st (BK / 16 k-steps over keys, one
    // product a 64-column chunk of V)
    auto issue_pv = [&](int st) {
      const uint64_t dv = sw128_desc(sv + st * KV_BYTES);
#pragma unroll
      for (int kj = 0; kj < BK / 16; ++kj)
#pragma unroll
        for (int vc = 0; vc < NCH; ++vc)  // +2048 bytes: 16 rows
          wgmma_rs_n64_t(o[vc], pf[kj], dv + vc * (KV_CHUNK >> 4) + kj * 128);
      wgmma_commit();
    };
    // the softmax of key tile `it` on s: masked scores, the new running
    // max, corr, p in fp32 (into s) and its sums; o is rescaled later, once
    // the P.V in flight has added to it
    auto softmax = [&](int it) {
      const int base = it * BK;
      float mx[2] = {m[0], m[1]};
      if (base + BK > n_real) {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = base + nt * 8 + 2 * t + (e & 1);
            const float x = key < n_real ? s[nt][e] * sl : NEG_INF;
            s[nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[nt][e] * sl;
            s[nt][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      }
      if constexpr (BF16S) {
        // the scores (masked keys' -1e30 too) and this thread's maxima
        // rounded to bf16: rounding is monotone, so the max of the rounded
        // scores is the rounded max
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          bf16_round2(s[nt][0], s[nt][1]);
          bf16_round2(s[nt][2], s[nt][3]);
        }
        bf16_round2(mx[0], mx[1]);
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
      for (int nt = 0; nt < BK / 8; ++nt) {
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
    // o *= corr, then p into P's bf16 A fragments (n-tiles 2j, 2j + 1 of
    // the scores form k-step j)
    auto rescale_pack = [&] {
#pragma unroll
      for (int vc = 0; vc < NCH; ++vc)
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          o[vc][dt][0] *= corr[0];
          o[vc][dt][1] *= corr[0];
          o[vc][dt][2] *= corr[1];
          o[vc][dt][3] *= corr[1];
        }
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(s[nt][0], s[nt][1]);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
      }
    };

    for (int hg = 0; hg < G; ++hg, j0 += n_tiles) {
      const int bh = grp * G + hg;
      const int b = bh / heads;
      const int h = bh - b * heads;
      const int qb = hg % QB;
      const uint32_t qrows = sq + qb * Q_BYTES + c * 64 * 128;
      dq = sw128_desc(qrows);
#pragma unroll
      for (int vc = 0; vc < NCH; ++vc)
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[vc][dt][e] = 0.f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;

      mbar_wait(full_q(qb), (hg / QB) & 1);
      if constexpr (BF16S) {
        // this consumer's 64 q rows (8 KB a chunk) pre-scaled in place, 16
        // bytes a thread at a time: the swizzle moves whole 16-byte chunks,
        // so every element is scaled where it lies; then visible to
        // wgmma's reads
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          uint4* rows = reinterpret_cast<uint4*>(
              wg_smem + (qrows + ch * Q_CHUNK - smem_addr(wg_smem)));
#pragma unroll 4
          for (int i = tid; i < 64 * 128 / 16; i += 128) {
            uint4 w = rows[i];
            uint32_t* x = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&x[jj]));
              x[jj] = pack_bf16(f.x * sl_arg, f.y * sl_arg);
            }
            rows[i] = w;
          }
        }
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + NC + c) : "memory");
      }
      mbar_wait(full_k(stage(0)), parity(0));
      take_turn();
      wgmma_fence();
      issue_s(stage(0));
      pass_turn();
      wgmma_wait<0>();
      reg_fence(s);
      mbar_arrive(empty_k(stage(0)));
      softmax(0);
      rescale_pack();
      for (int it = 1; it < n_tiles; ++it) {
        const int st = stage(it), prev = stage(it - 1);
        mbar_wait(full_k(st), parity(it));
        mbar_wait(full_v(prev), parity(it - 1));
        take_turn();
        fence_o();
        reg_fence(pf);
        wgmma_fence();
        issue_s(st);      // S of this tile
        issue_pv(prev);   // and P.V of the last one, under its softmax
        pass_turn();
        wgmma_wait<1>();  // S is done
        reg_fence(s);
        mbar_arrive(empty_k(st));
        softmax(it);
        wgmma_wait<0>();  // P.V is done
        fence_o();
        reg_fence(pf);
        mbar_arrive(empty_v(prev));
        rescale_pack();
      }
      // every product that reads this head's q is done: the producer may
      // load the head after the next into its buffer
      if constexpr (G > 1) mbar_arrive(empty_q(qb));
      const int last = stage(n_tiles - 1);
      mbar_wait(full_v(last), parity(n_tiles - 1));
      take_turn();
      fence_o();
      reg_fence(pf);
      wgmma_fence();
      issue_pv(last);
      pass_turn();
      wgmma_wait<0>();
      fence_o();
      mbar_arrive(empty_v(last));

      // epilogue: o / l in bf16, rows past N never stored
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const int row0 = q0 + c * 64 + warp * 16 + g;  // and row0 + 8
      bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= n) continue;
        bf16* orow = ob + static_cast<long long>(row) * os.n + 2 * t;
#pragma unroll
        for (int vc = 0; vc < NCH; ++vc)
#pragma unroll
          for (int dt = 0; dt < 8; ++dt)
            *reinterpret_cast<__nv_bfloat162*>(orow + 64 * vc + dt * 8) =
                __floats2bfloat162_rn(o[vc][dt][2 * r] / l[r],
                                      o[vc][dt][2 * r + 1] / l[r]);
        if (lse != nullptr && t == 0)
          lse[static_cast<long long>(bh) * n + row] = m[r] + log2f(l[r]);
      }
    }
  }
}

// --------------------------------------------------------------- host ---
// cuTensorMapEncodeTiled from the driver the runtime has loaded: the
// library links no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// the map of a bf16 (B, N, H, width) view at `ptr` with element strides s
// (b, n, h): dims (width, H, N, B), boxes of 64 columns x `rows` rows of
// one head, the 128-byte swizzle, zeros past the edges
inline bool encode_bnh64(CUtensorMap* map, const void* ptr, int batch, int n,
                         int heads, const Strides& s, int rows,
                         int width = 64) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.n) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one launch of an instance on `stream`, arguments as maest_attn_fwd_bf16's
// (BF16S: sl is q's pre-scale, lse nullptr; G > 1: batch * heads a multiple
// of G; D: the views' head_dim). Internal linkage: a library's own copy of
// `attr` must set its own kernel's limit. A function-local static of a
// template with external linkage is one object in the whole process (a
// unique symbol), so the second library that instantiates the same kernel
// (K2's in attention_fwd and the gh probe's G = 1 in attention_probe) would
// find it set and launch without the limit (invalid argument).
template <int BK, int NC, bool PP, bool BF16S = false, int G = 1, int D = 64,
          int ST = WG_STAGES>
static int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     float* lse, int batch, int n, int heads, int n_real,
                     const long long* st, float sl, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (batch * heads % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const auto kernel = attn_fwd_wgmma_kernel<BK, NC, PP, BF16S, G, D, ST>;
  constexpr int smem = wg_smem_bytes(BK, NC, D, G, ST);
  // once an instance, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  if (!encode_bnh64(&tq, q, batch, n, heads, qs, 64 * NC, D) ||
      !encode_bnh64(&tk, k, batch, n, heads, ks, BK, D) ||
      !encode_bnh64(&tv, v, batch, n, heads, vs, BK, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + 64 * NC - 1) / (64 * NC) * (batch * heads / G);
  kernel<<<grid, 128 * (NC + 1), smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, n, n_real, heads, os, sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
