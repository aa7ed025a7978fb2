// The product kernel of the tensor-core rate rigs P1 and P8 on Hopper's
// asynchronous machinery (sm_90a): the bf16 and e4m3 instances behind
// maest_mma_probe_wgmma (mma_probe.cu), which keeps the mma.sync kernel
// beside it as the control (maest_mma_probe).
//
// It computes what mma_probe_kernel computes: out[z] (m, ncols) = sum over
// r < R of A[z] (m, k) . B_r[z], fp32 sums, a bf16 output; B_r is columns
// r ncols.. of a row-major bf16 B[z] (k, R ncols), or rows r ncols.. of a
// row-major e4m3 B[z]^T (R ncols, k); B[z] = b + z b_batch, b_batch 0
// where every program shares the weights (P8). It replaces the same TPU
// kernels: scripts/mxu_probe.py::_probe_kernel (P1) and
// scripts/fp8_mlp_probe.py::_mm_kernel (P8), and the bf16 and e4m3
// products of scripts/int8_probe.py and int8_probe2.py (P2, P3).
//
// What bounds it on the H100: arithmetic at the P8 shapes and the folded
// P1 kinds (fc1 0.27 ms bf16, 0.14 ms e4m3 at 32 programs; k64big 0.16
// ms at 48), device memory where an (N, N) operand or output moves (k64w,
// pv, pvwide 0.099 ms, pvbig 0.39 ms).
//
// Design (the usual shape of a Hopper product kernel):
//   - A block owns 128 output rows x BN columns: warpgroup 0 is the
//     producer, warpgroups 1 and 2 consume 64 rows each. BN is 256 in bf16
//     (every P1 fold kind and P8 shape is a multiple), 64 for the p.v
//     kinds (an output 64 wide), and 128 in e4m3 (see below).
//   - TMA with the 128-byte swizzle fills a ring of stages in shared
//     memory (192 KB: 4 stages at BN 256, 6 at 128, 8 at 64; one block an
//     SM). A stage holds 128 bytes of the contraction of each row: 64 bf16
//     or 128 e4m3 values. One producer thread keeps the loads in flight
//     through full and empty mbarriers; every consumer thread releases a
//     stage once the products that read it are done.
//   - A is K-major for both types. bf16 B arrives as it lies, row-major (k,
//     n): MN-major, read through the descriptor's transpose bit in 64-
//     column atoms of 8 KB (the leading byte offset), 1024 bytes between
//     8-row groups of k. 8-bit wgmma has no transpose bit, so e4m3 B
//     arrives as B^T rows, K-major like A (the wrapper hands it so).
//   - The fold kinds (R 7 or 56, K at most 512 bytes a row) load their A
//     tile once and keep it for every column block; the ring then carries
//     B alone. The products walk (r, k-stage) in order, so the fp32 sums
//     keep the rig's order of column blocks.
//   - bf16: wgmma m64nBNk16 from shared-memory descriptors, one group in
//     flight (a stage is released when the next one's products are
//     issued and the group before has retired). e4m3: the tensor core's
//     fp8 sums keep fewer bits than fp32 (truncated alignment), so each
//     stage's four m64n128k32 products start a fresh fp32 set (scale_d 0)
//     and are added into fp32 totals once they retire (two-level sums,
//     every 128 values of K); the two sets are why e4m3 takes BN 128.
//     An e4m3 K that is 64 modulo 128 (P3's k64) leaves the last stage
//     half past K, where TMA fills A and B with zeros: its two upper
//     products add exact zeros.
//   - Epilogue: the fp32 sums to bf16 in shared memory (the ring, once
//     both consumers are done with it), in the 128-byte swizzle so that the
//     stores from registers hit every bank, then out by TMA stores of
//     64 x 64 boxes: whole 128-byte rows of device memory, where stores
//     from registers write 16 of a sector's 32 bytes at a time.

#pragma once

#include "attn_fwd_wgmma.cuh"  // mbarriers, 3-D TMA, descriptors, maps

namespace maest {

// ---------------------------------------------------------------- PTX ---
// d (64 x 256, fp32, C layout a warp) (+)= A (64 x 16 bf16, shared memory,
// K-major) . B (16 x 256, shared memory, MN-major); scale_d 0 overwrites d
__device__ __forceinline__ void mp_bf16_n256(float (&d)[32][4], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32) (+)= A (64 x 16 bf16, shared memory, K-major) . B
// (16 x 64, shared memory, MN-major); scale_d 0 overwrites d
__device__ __forceinline__ void mp_bf16_n64(float (&d)[8][4], uint64_t a,
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

// d (64 x 128, fp32) (+)= A (64 x 32 e4m3, shared memory, K-major) . B
// (32 x 128, shared memory, K-major: 8-bit wgmma has no transpose);
// scale_d 0 overwrites d
__device__ __forceinline__ void mp_e4m3_n128(float (&d)[16][4], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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

// ------------------------------------------------------------- kernel ---
constexpr int MP_BM = 128;         // output rows a block
constexpr int MP_ROW = 128;        // bytes of the contraction a stage row
constexpr int MP_A_STAGE = MP_BM * MP_ROW;  // 16 KB
constexpr int MP_RING = 196608;    // the ring's bytes, A and B stages
constexpr int MP_RESIDENT = 4;     // A stages a fold keeps (K <= 512 bytes)
constexpr int MP_THREADS = 384;    // the producer and two consumers

// the ring's stages at an output tile of bn columns (B: bn x 128 bytes)
__host__ __device__ constexpr int mp_stages(int bn) {
  return MP_RING / (MP_A_STAGE + bn * MP_ROW);
}

// dynamic shared memory: 1024 bytes of alignment slack, the ring, the
// full and empty mbarriers of each stage and A's own
__host__ __device__ constexpr int mp_smem(int bn) {
  return 1024 + MP_RING + 8 * (2 * mp_stages(bn) + 1);
}

// the descriptor of a bf16 B stage, MN-major with the 128-byte swizzle:
// 64-column atoms of 64 k rows (8 KB, the leading byte offset), 1024 bytes
// between 8-row groups of k (the stride byte offset), layout 1
__device__ __forceinline__ uint64_t mp_mn_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (512ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// the 3-D box at (c0, c1, c2) of `map` from shared memory at src, one
// bulk group; the tile staged in the map's swizzle
__device__ __forceinline__ void mp_tma_store_3d(const CUtensorMap* map,
                                                uint32_t src, int c0, int c1,
                                                int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the bulk groups this thread issued: committed, then waited for until
// they have read shared memory
__device__ __forceinline__ void mp_bulk_commit_wait_read() {
  asm volatile(
      "cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" :::
          "memory");
}

__device__ __forceinline__ void mp_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

template <int BN>
__device__ __forceinline__ void mp_bf16(float (&d)[BN / 8][4], uint64_t a,
                                        uint64_t b) {
  if constexpr (BN == 256)
    mp_bf16_n256(d, a, b, 1);
  else
    mp_bf16_n64(d, a, b, 1);
}

// grid (ncols / BN, m / 128, batch), MP_THREADS threads; ta: the map of A
// (k, m, batch) with boxes of (stage, 128 rows); tb: bf16 B (R ncols, k,
// batches of b) with boxes of (64 columns, 64 k rows), or e4m3 B^T (k, R
// ncols, batches) with boxes of (128 k, BN rows); tout: bf16 out (ncols,
// m, batch) with boxes of (64 columns, 64 rows); b_batched: b has a batch
// (else one b serves every z)
template <bool E4M3, int BN>
__global__ void __launch_bounds__(MP_THREADS, 1)
mma_probe_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tout, int k,
                       int ncols, int fold, int b_batched) {
  constexpr int ST = mp_stages(BN);
  constexpr int KE = E4M3 ? 128 : 64;  // K a stage
  constexpr int KS = E4M3 ? 32 : 16;   // K a product
  constexpr int NK = KE / KS;          // products a stage
  constexpr uint32_t B_STAGE = BN * MP_ROW;
  extern __shared__ uint8_t mp_smem_raw[];
  const uint32_t sa = (smem_addr(mp_smem_raw) + 1023u) & ~1023u;
  const uint32_t sb = sa + ST * MP_A_STAGE;  // stage s: + s B_STAGE
  const uint32_t bars = sb + ST * B_STAGE;   // 8 bytes each
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  const uint32_t full_a = bars + 16 * ST;

  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * MP_BM;
  const int z = blockIdx.z;
  const int kchunks = (k + KE - 1) / KE;
  const bool resident = fold > 1;
  const int n_it = fold * kchunks;  // (column block r, stage kc), in order
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mp_prefetch_map(&ta);
    mp_prefetch_map(&tb);
    mp_prefetch_map(&tout);
    mbar_init(full_a, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int bz = b_batched ? z : 0;
      if (resident) {
        mbar_expect_tx(full_a, kchunks * MP_A_STAGE);
        for (int c = 0; c < kchunks; ++c)
          tma_load_3d(sa + c * MP_A_STAGE, &ta, full_a, c * KE, row0, z);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST;
        const int r = it / kchunks;
        const int kc = it - r * kchunks;
        qw_wait(empty(s), ((it / ST) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full(s), (resident ? 0 : MP_A_STAGE) + B_STAGE);
        if (!resident)
          tma_load_3d(sa + s * MP_A_STAGE, &ta, full(s), kc * KE, row0, z);
        const int col = r * ncols + n0;
        if constexpr (E4M3) {
          tma_load_3d(sb + s * B_STAGE, &tb, full(s), kc * KE, col, bz);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(sb + s * B_STAGE + j * 8192, &tb, full(s),
                        col + 64 * j, kc * KE, bz);
        }
      }
    }
  } else {  // ----------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int c = wg - 1;  // this consumer's 64 rows: row0 + 64 c ..
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int t = tid & 3;
    float acc[BN / 8][4];  // the sums (e4m3: the fp32 totals)
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    if (resident) qw_wait(full_a, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      const int kc = it % kchunks;
      qw_wait(full(s), (it / ST) & 1);
      const uint64_t da = sw128_desc(
          (resident ? sa + kc * MP_A_STAGE : sa + s * MP_A_STAGE) +
          c * 64 * MP_ROW);
      const uint32_t b_at = sb + s * B_STAGE;
      if constexpr (E4M3) {
        float part[BN / 8][4];  // this stage's sums, fresh
        const uint64_t db = sw128_desc(b_at);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < NK; ++j)  // +32 bytes of K a product
          mp_e4m3_n128(part, da + 2 * j, db + 2 * j, j);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(part);
        mbar_arrive(empty(s));
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[nt][e] = __fadd_rn(acc[nt][e], part[nt][e]);
      } else {
        const uint64_t db = mp_mn_desc(b_at);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < NK; ++j)  // +32 bytes of A, +16 rows of B
          mp_bf16<BN>(acc, da + 2 * j, db + 128 * j);
        wgmma_commit();
        wgmma_wait<1>();  // the stage before is read
        if (it > 0) mbar_arrive(empty((it - 1) % ST));
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);

    // epilogue: both consumers are done with the ring, so each stages its
    // 64 x BN bf16 tile there, in the 128-byte swizzle (64-column boxes of
    // 8 KB: the 8 rows a store instruction writes fall on 8 different
    // 16-byte chunks, all 32 banks), and one thread writes it out by TMA
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const uint32_t so = sa + c * 64 * BN * 2;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const uint32_t at = so + (nt >> 3) * 8192 + r * 128 +
                            (((nt & 7) ^ (r & 7)) << 4) + 4 * t;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                     "r"(pack_bf16(acc[nt][2 * h], acc[nt][2 * h + 1]))
                     : "memory");
      }
    fence_proxy_async();  // the stores, visible to the TMA unit
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
    if (tid == 0) {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        mp_tma_store_3d(&tout, so + j * 8192, n0 + 64 * j, row0 + 64 * c, z);
      mp_bulk_commit_wait_read();  // shared memory outlives the reads
    }
  }
}

// --------------------------------------------------------------- host ---
// a 3-D map of `ptr` (dims innermost first, strides of dims 1 and 2 in
// bytes), boxes of `box`, the 128-byte swizzle, zeros past the edges
inline bool mp_encode(CUtensorMap* map, CUtensorMapDataType type,
                      const void* ptr, const cuuint64_t (&dims)[3],
                      const cuuint64_t (&strides)[2],
                      const cuuint32_t (&box)[3]) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one launch on `stream`, arguments as maest_mma_probe_wgmma's
template <bool E4M3, int BN>
int launch_probe_wgmma(const void* a, const void* b, void* out, int batch,
                       int m, int k, int ncols, int fold, long long b_batch,
                       void* stream) {
  constexpr int EB = E4M3 ? 1 : 2;
  constexpr int KE = MP_ROW / EB;
  if (m % MP_BM || ncols % BN || k <= 0 || k % 64 || batch < 0 ||
      b_batch < 0 || !(fold == 1 || fold == 7 || fold == 56) ||
      (fold > 1 && (BN == 64 || k * EB > MP_RESIDENT * MP_ROW)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || m == 0 || ncols == 0) return 0;
  const auto kernel = mma_probe_wgmma_kernel<E4M3, BN>;
  constexpr int smem = mp_smem(BN);
  // once an instance, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cuuint64_t cols = static_cast<cuuint64_t>(fold) * ncols;
  const cuuint64_t nb = b_batch ? batch : 1;
  const cuuint64_t b_stride = (b_batch ? b_batch : cols * k) * EB;
  const auto type = E4M3 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ta, tb, tout;
  const bool ok =
      mp_encode(&ta, type, a,
                {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m),
                 static_cast<cuuint64_t>(batch)},
                {static_cast<cuuint64_t>(k) * EB,
                 static_cast<cuuint64_t>(m) * k * EB},
                {static_cast<cuuint32_t>(KE), MP_BM, 1}) &&
      (E4M3 ? mp_encode(&tb, type, b, {static_cast<cuuint64_t>(k), cols, nb},
                        {static_cast<cuuint64_t>(k), b_stride},
                        {static_cast<cuuint32_t>(KE), BN, 1})
            : mp_encode(&tb, type, b, {cols, static_cast<cuuint64_t>(k), nb},
                        {cols * EB, b_stride}, {64, 64, 1})) &&
      mp_encode(&tout, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out,
                {static_cast<cuuint64_t>(ncols), static_cast<cuuint64_t>(m),
                 static_cast<cuuint64_t>(batch)},
                {static_cast<cuuint64_t>(ncols) * 2,
                 static_cast<cuuint64_t>(m) * ncols * 2},
                {64, 64, 1});
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(ncols / BN, m / MP_BM, batch);
  kernel<<<grid, MP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, tout, k, ncols, fold, b_batch != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maest
