// The tensor-core rate rigs on Hopper (sm_90a): one hand-written product
// kernel, out = sum over r < R of A . B_r, with bf16, e4m3 or int8
// operands, fp32 (int32) sums and a bf16 (int32) output, and beside it the
// quantising product of the int8 rig.
//
// Replaces scripts/mxu_probe.py::_probe_kernel (P1, the bf16 products at
// the attention kernel's own shapes: the scores product of contraction
// depth 64, the p.v product of output width 64, and full 256-wide tiles as
// the control), scripts/fp8_mlp_probe.py::_mm_kernel (P8, one bf16 or
// e4m3 product at the MLP and qkv shapes, B shared by every program), and
// the single and folded products of scripts/int8_probe.py::_probe_kernel
// (P2: k64_i8, pv_i8, k64_i8q; its bf16 kinds are P1's k64w and pvwide,
// its mix kinds attention_probe.cu's) and scripts/int8_probe2.py::
// _probe_kernel (P3: k64big_i8, k64big_i8cvt, k64big_fp8, pvbig_i8; its
// bf16 kinds are P1's k64big and pvbig). On the H100 all are instances of
// this kernel: A (M, K) is reused against R column blocks B_r of B (k64,
// ctrl, ctrlbig and the k64big kinds fold 7 or 56 of them into one (M,
// 256) output; the other kinds and P8 take R = 1), and B has a batch
// stride, 0 where every program shares the weights (P8). pv's seven
// 256-deep slices and pvbig's heads are one product each here: the kernel
// walks the whole contraction.
//
// Two kernels compute it. The bf16 and e4m3 products run on wgmma fed by
// TMA (mma_probe_wgmma.cuh, entry maest_mma_probe_wgmma): the route of
// P1, P8 and the bf16 and e4m3 kinds of P2 and P3. The kernel below
// (entry maest_mma_probe) uses K2's instruction path (mma.sync m16n8k16
// bf16 and m16n8k32 e4m3 and s8 from mma_bf16.cuh / mma_8bit.cuh,
// ldmatrix fragments, cp.async staging): it is the route of the int8
// instances (S8_I32, S8_CVT) and of k64_i8q, and in bf16 and e4m3 the
// control that ops/mma_probe.py reaches only through its *_mma wrappers,
// to time the two in one run.
//
// What bounds it on the H100: arithmetic at the P1 shapes whose output is
// narrow or folded (k64, ctrl, ctrlbig, k64big: 0.02-0.64 ms at 989
// TFLOP/s for the rig's 48 programs) and at every P8 shape (fc1, fc2 0.27
// ms bf16, 0.14 ms e4m3; qkv 0.21 / 0.10), and device memory where an
// (N, N) operand or output is moved (k64w, pv, pvwide: 0.099 ms; pvbig
// 0.39 ms at 3.35 TB/s). P2's single int8 products write an (N, N) int32
// output or read an (N, N) operand: bytes bind them (k64_i8 0.184 ms for
// 616 MB against 0.010 ms of int8 operations at 1979 TOP/s); P3's folded
// int8 products are bound by operations (k64big_i8 0.013 ms at 8
// programs).
//
// The output tile: a block owns 128 rows x BN columns (BN 128, or 64 for
// an output of width 64: the p.v kinds). bf16: one warp 64 x 64 (4 m-tiles
// x 8 n-tiles, 128 fp32 sums a thread), so 4 warps (BN 128) or 2. A warp
// tile of 64 x 64 reads 8 KB of fragments through ldmatrix for each 32
// mma.sync of 16 x 8 x 16 (262 kflop): ~32 flops a byte of shared memory,
// the H100's ratio of tensor-core flops to shared-memory bytes a clock,
// where a 32 x 64 tile stays at 21. Each stage brings 128 bytes of the
// contraction (64 bf16 values) of each A row and, per output column, of B,
// through a 3-stage cp.async ring in dynamic shared memory (83-111 KB, two
// blocks an SM) with one barrier a stage. Rows are padded from 128 to 144
// bytes (A) and bf16 B's (k, BN) rows by 8 values, so the 8 rows an
// ldmatrix phase reads hit 32 banks. bf16 B is row-major (K, N) as the
// rigs give it and reaches the B fragment through ldmatrix.trans. The fold
// kinds re-read A from L2 for each of their R column blocks.
//
// The 8-bit instances (e4m3 and s8) take a warp tile of 64 x 32 (4 x 4
// n-tiles, 64 sums a thread; 8 warps at BN 128): at 64 x 64 the e4m3
// instance used 255 registers and spilled, since each of its four k-steps a
// stage holds the A fragments of 4 m-tiles beside 128 sums. A k-step of 32
// bytes is twice as deep as bf16's, so the narrower tile still reads 3 KB
// of fragments for 16 mma.sync of 16 x 8 x 32 (262 kop): 85 operations a
// byte. Each stage brings 64 bytes of the contraction (the depth of the
// k64 kinds; rows padded to 80 bytes), through a 4-stage ring (80 KB).
// ldmatrix cannot transpose 8-bit values, so 8-bit B arrives column-major,
// as (N, K) rows, which ldmatrix reads as it reads A (two n-tiles of one
// k-step a call); the wrapper makes that copy. int8 sums are exact int32
// (at most 56 x 64 x 127^2 ~ 5.8e7 here) and are written as int32, except
// in the CVT epilogue (k64big_i8cvt, the qk8 pattern): after each column
// block r its int32 sums are converted to fp32, scaled by the row's
// factor (float(A[row, 0]) 1e-4, as the rig forms it) and added into fp32
// totals, each step rounded on its own; one int32 and one fp32 set of sums
// (64 + 64 registers) are live. The rescale is not hoisted out of the
// fold: the rig measures the convert and multiply on all 56 blocks.
//
// k64_i8q (mma_i8q_kernel): from bf16 a (M, 64) and b (64, N) a program
// takes sa = max|a| / 127 and sb = max|b| / 127, rounds a / sa and b / sb
// half to even into int8 (saturating, as jnp's astype), multiplies the
// codes with int32 sums and writes bf16(float(sum) (sa sb)). A TPU program
// holds its whole block in VMEM and reduces it before the product; CUDA
// blocks cannot share a reduction within one launch, so a first kernel
// (mma_amax_kernel) takes the two maxima per program with atomicMax on the
// bits of non-negative floats, and the product kernel then stages bf16
// tiles, quantises them into int8 tiles in shared memory (B transposed on
// the way), and runs s8 products. Each block quantises its own 128 rows of
// a and 128 columns of b: at the rig's N 1792 every element of a is
// quantised 14 times and every element of b 14 times, where the TPU
// program does it once.

#include <type_traits>

#include "mma_8bit.cuh"         // and mma_bf16.cuh
#include "mma_probe_wgmma.cuh"  // the bf16 and e4m3 route on wgmma and TMA

namespace {

using namespace maest;

// operand types and epilogues of an instance
enum ProbeType {
  BF16_OUT = 0,  // bf16 operands, fp32 sums, bf16 out
  E4M3_OUT = 1,  // e4m3 operands, fp32 sums, bf16 out
  S8_I32 = 2,    // int8 operands, int32 sums, int32 out
  S8_CVT = 3     // int8 operands; per column block fp32(int32 sums) * row
                 // scale into fp32 totals; bf16 out
};

constexpr int BM = 128;             // output rows a block
constexpr int WT = 64;              // rows (and bf16 columns) a warp
constexpr int KB = 128;             // bytes of the contraction a stage
constexpr int LDA = KB + 16;        // padded A row, bytes
constexpr int STAGES = 3;           // the cp.async ring

// the 8-bit instances: warp columns, bytes of K a stage, padded rows and
// the ring's stages
constexpr int WN8 = 32;
constexpr int KB8 = 64;
constexpr int LDA8 = KB8 + 16;
constexpr int STAGES8 = 4;

// threads of an instance: (BM / WT) x (BN / warp columns) warps
__host__ __device__ constexpr int probe_threads(int bn, bool eight = false) {
  return 32 * (BM / WT) * (bn / (eight ? WN8 : WT));
}

// bytes of one stage's B tile: (KB / 2, BN + 8) bf16, or (BN, LDA8) bytes
__host__ __device__ constexpr int b_bytes(bool eight, int bn) {
  return eight ? bn * LDA8 : KB / 2 * (bn + 8) * 2;
}

// dynamic shared memory of an instance: the ring of A and B tiles
__host__ __device__ constexpr int probe_smem(bool eight, int bn) {
  return eight ? STAGES8 * (BM * LDA8 + b_bytes(true, bn))
               : STAGES * (BM * LDA + b_bytes(false, bn));
}

// out[z] (m, ncols) = sum over r < R of A[z] (m, k) . B_r[z], where B_r is
// columns r ncols.. of B[z] (k, R ncols) row-major (bf16), or rows r
// ncols.. of B[z]^T (R ncols, k) row-major (8-bit); out bf16, or int32
// (S8_I32). A[z] = a + z m k, B[z] = b + z b_batch, out[z] = out + z m
// ncols; every dimension a multiple of its tile (the entry checks). Grid
// (ncols / BN, m / BM, batch).
template <int TYPE, int BN, int R>
__global__ void __launch_bounds__(probe_threads(BN, TYPE != BF16_OUT))
mma_probe_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 void* __restrict__ out, int m, int k, int ncols,
                 long long b_batch) {
  constexpr bool EIGHT = TYPE != BF16_OUT;
  constexpr bool INT = TYPE == S8_I32 || TYPE == S8_CVT;  // int32 sums
  constexpr int EB = EIGHT ? 1 : 2;      // bytes an element
  constexpr int KB_ = EIGHT ? KB8 : KB;  // bytes of K a stage
  constexpr int LDA_ = EIGHT ? LDA8 : LDA;
  constexpr int STAGES_ = EIGHT ? STAGES8 : STAGES;
  constexpr int WN = EIGHT ? WN8 : WT;   // a warp's columns
  constexpr int NT = WN / 8;             // and n-tiles
  constexpr int CPR = KB_ / 16;          // 16-byte chunks of a staged row
  constexpr int KE = KB_ / EB;           // elements of K a stage
  constexpr int THREADS = probe_threads(BN, EIGHT);
  constexpr int LDB = BN + 8;            // bf16 B row (k, BN), elements
  constexpr int BBYTES = b_bytes(EIGHT, BN);
  using Acc = std::conditional_t<INT, int, float>;
  extern __shared__ __align__(128) uint8_t ring[];
  uint8_t(*a_sm)[BM][LDA_] = reinterpret_cast<uint8_t(*)[BM][LDA_]>(ring);
  uint8_t(*b_sm)[BBYTES] =
      reinterpret_cast<uint8_t(*)[BBYTES]>(ring + STAGES_ * BM * LDA_);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;
  const int li = lane >> 3;
  const int wm = warp & 1;   // this warp's 64 rows
  const int wn = warp >> 1;  // and WN columns
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const long long z = blockIdx.z;
  const uint8_t* ab = a + (z * m + m0) * k * EB;
  const uint8_t* bb = b + z * b_batch * EB;

  const int ksteps = k / KE;
  const int n_it = R * ksteps;  // (column block r, stage kk), in order
  // stage `it` into ring slot `buf`; past the last stage an empty group,
  // so that every iteration waits on the same count
  auto stage = [&](int it, int buf) {
    if (it < n_it) {
      const int r = it / ksteps;
      const int kk = it - r * ksteps;
      for (int i = threadIdx.x; i < BM * CPR; i += THREADS) {
        const int row = i >> ilog2(CPR);
        const int c = (i & (CPR - 1)) * 16;
        cp_async16(&a_sm[buf][row][c], ab + (static_cast<long long>(row) * k +
                                             kk * KE) * EB + c, 16);
      }
      if constexpr (EIGHT) {  // BN rows of B^T, KB_ bytes of K each
        uint8_t(*bt)[LDA_] = reinterpret_cast<uint8_t(*)[LDA_]>(b_sm[buf]);
        for (int i = threadIdx.x; i < BN * CPR; i += THREADS) {
          const int row = i >> ilog2(CPR);
          const int c = (i & (CPR - 1)) * 16;
          cp_async16(&bt[row][c],
                     bb + static_cast<long long>(r * ncols + n0 + row) * k +
                         kk * KE + c, 16);
        }
      } else {  // KE rows of B, BN values each
        bf16(*bs)[LDB] = reinterpret_cast<bf16(*)[LDB]>(b_sm[buf]);
        const long long ld = static_cast<long long>(R) * ncols;
        for (int i = threadIdx.x; i < KE * (BN / 8); i += THREADS) {
          const int row = i / (BN / 8);
          const int c = (i % (BN / 8)) * 8;
          cp_async16(&bs[row][c],
                     bb + ((kk * KE + row) * ld + r * ncols + n0 + c) * 2, 16);
        }
      }
    }
    cp_async_commit();
  };

  Acc acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
  // S8_CVT: the fp32 totals and the factors of this thread's rows
  // (m-tile mt, row g + 8 h)
  constexpr bool CVT = TYPE == S8_CVT;
  float tot[CVT ? 4 : 1][CVT ? NT : 1][4];
  float rowf[CVT ? 4 : 1][2];
  if constexpr (CVT) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[mt][nt][e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int8_t a0 = static_cast<int8_t>(
            ab[static_cast<long long>(wm * WT + mt * 16 + g + 8 * h) * k]);
        rowf[mt][h] = __fmul_rn(static_cast<float>(a0), 1e-4f);
      }
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES_ - 1; ++s) stage(s, s);
  for (int it = 0; it < n_it; ++it) {
    const int buf = it % STAGES_;
    cp_async_wait<STAGES_ - 2>();
    // stage `it` is in shared memory for every warp, and every warp is done
    // with the slot that the next stage refills (read at iteration it - 1)
    __syncthreads();
    stage(it + STAGES_ - 1, (it + STAGES_ - 1) % STAGES_);
    const uint8_t(*as)[LDA_] = a_sm[buf];
    if constexpr (EIGHT) {
      const uint8_t(*bt)[LDA_] = reinterpret_cast<const uint8_t(*)[LDA_]>(b_sm[buf]);
#pragma unroll
      for (int ks = 0; ks < KB_ / 32; ++ks) {  // k-steps of 32 bytes
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(af[mt], &as[wm * WT + mt * 16 + (li & 1) * 8 + lr]
                                 [ks * 32 + (li >> 1) * 16]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {  // n-tiles 2 np and 2 np + 1
          // B^T rows of the two n-tiles: lanes 8i.. address n-tile 2 np +
          // (i >> 1), bytes 16 (i & 1) of this k-step
          uint32_t f[4];
          ldmatrix_x4(f, &bt[wn * WN + np * 16 + (li >> 1) * 8 + lr]
                            [ks * 32 + (li & 1) * 16]);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            if constexpr (INT) {
              mma_s8(acc[mt][2 * np], af[mt], f[0], f[1]);
              mma_s8(acc[mt][2 * np + 1], af[mt], f[2], f[3]);
            } else {
              mma_e4m3(acc[mt][2 * np], af[mt], f[0], f[1]);
              mma_e4m3(acc[mt][2 * np + 1], af[mt], f[2], f[3]);
            }
          }
        }
      }
      if constexpr (CVT) {  // the end of column block r: fold it
        if (it % ksteps == ksteps - 1) {
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                tot[mt][nt][e] = __fadd_rn(
                    tot[mt][nt][e], __fmul_rn(__int2float_rn(acc[mt][nt][e]),
                                              rowf[mt][e >> 1]));
                acc[mt][nt][e] = 0;
              }
        }
      }
    } else {
      const bf16(*bs)[LDB] = reinterpret_cast<const bf16(*)[LDB]>(b_sm[buf]);
#pragma unroll
      for (int ks = 0; ks < KE / 16; ++ks) {  // k-steps of 16
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(af[mt], &as[wm * WT + mt * 16 + (li & 1) * 8 + lr]
                                 [(ks * 16 + (li >> 1) * 8) * 2]);
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {  // n-tiles 2 dp and 2 dp + 1
          uint32_t f[4];
          ldmatrix_x4_trans(f, &bs[ks * 16 + (li & 1) * 8 + lr]
                                  [wn * WT + dp * 16 + (li >> 1) * 8]);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma_16816(acc[mt][2 * dp], af[mt], f[0], f[1]);
            mma_16816(acc[mt][2 * dp + 1], af[mt], f[2], f[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  using Out = std::conditional_t<TYPE == S8_I32, int, bf16>;
  Out* ob = static_cast<Out*>(out) + (z * m + m0 + wm * WT) * ncols + n0 +
            wn * WN + 2 * t;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Out* orow = ob + static_cast<long long>(mt * 16 + g + 8 * r) * ncols;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if constexpr (TYPE == S8_I32)
          *reinterpret_cast<int2*>(orow + nt * 8) =
              make_int2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
        else if constexpr (CVT)
          *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) =
              __floats2bfloat162_rn(tot[mt][nt][2 * r], tot[mt][nt][2 * r + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) =
              __floats2bfloat162_rn(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
      }
    }
}

template <int TYPE, int BN, int R>
int launch_probe(const void* a, const void* b, void* out, int batch, int m,
                 int k, int ncols, long long b_batch, void* stream) {
  constexpr bool EIGHT = TYPE != BF16_OUT;
  constexpr int KE = EIGHT ? KB8 : KB / 2;
  if (m % BM || ncols % BN || k % KE || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || m == 0 || ncols == 0) return 0;
  const auto kernel = mma_probe_kernel<TYPE, BN, R>;
  constexpr int smem = probe_smem(EIGHT, BN);
  // once an instance, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(ncols / BN, m / BM, batch);
  kernel<<<grid, probe_threads(BN, EIGHT), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), out, m,
      k, ncols, b_batch);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- k64_i8q ---
constexpr int QK = 64;        // the quantising product's contraction
constexpr int QTHREADS = 256;  // 8 warps of 64 x 32, a 128 x 128 tile

__device__ __forceinline__ float bf16_bits(uint32_t w, int hi) {
  return __uint_as_float(hi ? w & 0xffff0000u : w << 16);
}

// amax[2 z] = max|a[z]|, amax[2 z + 1] = max|b[z]| over na and nb bf16
// values a program (multiples of 8), zeroed by the caller: grid (blocks a
// program, batch), atomicMax on the bits of non-negative floats
__global__ void __launch_bounds__(256)
mma_amax_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                float* __restrict__ amax, long long na, long long nb) {
  __shared__ float red[8][2];
  const long long z = blockIdx.y;
  float mx[2] = {0.f, 0.f};
  const long long n8[2] = {na / 8, nb / 8};
  const uint4* src[2] = {reinterpret_cast<const uint4*>(a + z * na),
                         reinterpret_cast<const uint4*>(b + z * nb)};
#pragma unroll
  for (int x = 0; x < 2; ++x)
    for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n8[x];
         i += 256LL * gridDim.x) {
      const uint4 w = src[x][i];
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx[x] = fmaxf(mx[x], fabsf(bf16_bits(ws[j >> 1], j & 1)));
    }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][x] = mx[x];
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v = fmaxf(v, red[w][threadIdx.x]);
    atomicMax(reinterpret_cast<int*>(amax + 2 * z + threadIdx.x),
              __float_as_int(v));
  }
}

// out[z] (m, n) bf16 = bf16(float(qa . qb) (sa sb)) with sa = amax[2 z] /
// 127, sb = amax[2 z + 1] / 127, qa = int8(round(a / sa)), qb likewise,
// from bf16 a[z] (m, 64) and b[z] (64, n) row-major. Grid (n / 128, m /
// 128, batch).
__global__ void __launch_bounds__(QTHREADS)
mma_i8q_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
               const float* __restrict__ amax, bf16* __restrict__ out, int m,
               int n) {
  __shared__ __align__(128) uint8_t a8[BM][LDA8];  // int8 a rows
  __shared__ __align__(128) uint8_t b8[BM][LDA8];  // int8 b^T rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;
  const int li = lane >> 3;
  const int wm = warp & 1;   // this warp's 64 rows
  const int wn = warp >> 1;  // and 32 columns
  const int n0 = blockIdx.x * BM;
  const int m0 = blockIdx.y * BM;
  const long long z = blockIdx.z;
  // the rig's scalars: IEEE division, as its x / 127.0 and a / sa
  const float sa = __fdiv_rn(amax[2 * z], 127.f);
  const float sb = __fdiv_rn(amax[2 * z + 1], 127.f);

  // a: 128 rows of 64 values, 8 a chunk; b: 64 rows of this block's 128
  // columns, 8 a chunk, stored transposed
  const bf16* ab = a + (z * m + m0) * QK;
  const bf16* bb = b + z * QK * static_cast<long long>(n) + n0;
  for (int i = threadIdx.x; i < BM * QK / 8; i += QTHREADS) {
    const int row = i >> 3;
    const int c = (i & 7) * 8;
    const uint4 w = *reinterpret_cast<const uint4*>(ab + row * QK + c);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
    uint32_t q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      q[j] = to_s8_sat(__fdiv_rn(bf16_bits(ws[j >> 1], j & 1), sa));
    *reinterpret_cast<uint2*>(&a8[row][c]) =
        make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
  }
  for (int i = threadIdx.x; i < QK * BM / 8; i += QTHREADS) {
    const int kk = i >> 4;
    const int c = (i & 15) * 8;
    const uint4 w = *reinterpret_cast<const uint4*>(
        bb + static_cast<long long>(kk) * n + c);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b8[c + j][kk] = static_cast<uint8_t>(
          to_s8_sat(__fdiv_rn(bf16_bits(ws[j >> 1], j & 1), sb)));
  }
  __syncthreads();

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
#pragma unroll
  for (int ks = 0; ks < QK / 32; ++ks) {
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldmatrix_x4(af[mt], &a8[wm * WT + mt * 16 + (li & 1) * 8 + lr]
                             [ks * 32 + (li >> 1) * 16]);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t f[4];
      ldmatrix_x4(f, &b8[wn * WN8 + np * 16 + (li >> 1) * 8 + lr]
                        [ks * 32 + (li & 1) * 16]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        mma_s8(acc[mt][2 * np], af[mt], f[0], f[1]);
        mma_s8(acc[mt][2 * np + 1], af[mt], f[2], f[3]);
      }
    }
  }

  const float sab = __fmul_rn(sa, sb);  // formed before the multiply
  bf16* ob = out + (z * m + m0 + wm * WT) * static_cast<long long>(n) + n0 +
             wn * WN8 + 2 * t;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* orow = ob + static_cast<long long>(mt * 16 + g + 8 * r) * n;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) = __floats2bfloat162_rn(
            __fmul_rn(__int2float_rn(acc[mt][nt][2 * r]), sab),
            __fmul_rn(__int2float_rn(acc[mt][nt][2 * r + 1]), sab));
    }
}

}  // namespace

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (batch, m, ncols) = sum over r < fold of a (batch, m, k) . B_r, all
// contiguous. type 0: bf16 operands, b (batch, k, fold ncols) row-major
// and B_r its columns r ncols..; types 1-3: 8-bit operands, b the
// transposed (batch, fold ncols, k) and B_r^T its rows r ncols..: 1 e4m3,
// 2 int8 with an int32 out, 3 int8 with the CVT epilogue (the fp32 totals
// of fp32(sum of block r) float(a[row, 0]) 1e-4). out bf16 but for type 2.
// b_batch: elements between two batches' b, 0 where they share one. bn:
// the output tile's columns, 128 or 64. The instances: bf16 at (bn 128,
// fold 1, 7, 56) and (64, 1); e4m3 at (128, 1) and (128, 56); int8 (type
// 2) at (128, 1), (128, 56) and (64, 1); type 3 at (128, 56). m a multiple
// of 128, ncols of bn, k of 64. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or instance the
// kernel does not have.
int maest_mma_probe(int type, int bn, int fold, const void* a, const void* b,
                    void* out, int batch, int m, int k, int ncols,
                    long long b_batch, void* stream) {
  decltype(&launch_probe<BF16_OUT, 128, 1>) fn;
  switch (type * 100000 + bn * 100 + fold) {
    case 12801: fn = launch_probe<BF16_OUT, 128, 1>; break;
    case 12807: fn = launch_probe<BF16_OUT, 128, 7>; break;
    case 12856: fn = launch_probe<BF16_OUT, 128, 56>; break;
    case 6401: fn = launch_probe<BF16_OUT, 64, 1>; break;
    case 112801: fn = launch_probe<E4M3_OUT, 128, 1>; break;
    case 112856: fn = launch_probe<E4M3_OUT, 128, 56>; break;
    case 212801: fn = launch_probe<S8_I32, 128, 1>; break;
    case 212856: fn = launch_probe<S8_I32, 128, 56>; break;
    case 206401: fn = launch_probe<S8_I32, 64, 1>; break;
    case 312856: fn = launch_probe<S8_CVT, 128, 56>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(a, b, out, batch, m, k, ncols, b_batch, stream);
}

// The bf16 and e4m3 route: maest_mma_probe's arguments for types 0 and 1,
// on the wgmma kernel of mma_probe_wgmma.cuh. Its instances: bf16 at bn
// 256 (fold 1, 7 or 56) and at bn 64 (fold 1); e4m3 at bn 128 (fold 1, 7
// or 56). m a multiple of 128, ncols of bn, k a positive multiple of 64,
// and at most 512 bytes a row where fold > 1 (A stays in shared memory
// for every column block). Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or instance the
// kernel does not have (or a tensor map cuTensorMapEncodeTiled refuses).
int maest_mma_probe_wgmma(int type, int bn, int fold, const void* a,
                          const void* b, void* out, int batch, int m, int k,
                          int ncols, long long b_batch, void* stream) {
  switch (type * 1000 + bn) {
    case 256:
      return launch_probe_wgmma<false, 256>(a, b, out, batch, m, k, ncols,
                                            fold, b_batch, stream);
    case 64:
      return launch_probe_wgmma<false, 64>(a, b, out, batch, m, k, ncols,
                                           fold, b_batch, stream);
    case 1128:
      return launch_probe_wgmma<true, 128>(a, b, out, batch, m, k, ncols,
                                           fold, b_batch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// k64_i8q: out (batch, m, n) bf16 from bf16 a (batch, m, 64) and b (batch,
// 64, n), contiguous; amax: fp32 scratch of 2 batch values. m and n
// multiples of 128. Three launches on `stream` (amax zeroed, the maxima,
// the product); returns the first non-zero error, or cudaErrorInvalidValue
// for another shape.
int maest_mma_i8q(const void* a, const void* b, float* amax, void* out,
                  int batch, int m, int n, void* stream) {
  if (m % BM || n % BM || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || m == 0 || n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, 2 * sizeof(float) * batch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long na = static_cast<long long>(m) * QK, nb = static_cast<long long>(n) * QK;
  const int blocks = static_cast<int>(min(32LL, (max(na, nb) / 8 + 255) / 256));
  mma_amax_kernel<<<dim3(blocks, batch), 256, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), amax, na, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mma_i8q_kernel<<<dim3(n / BM, m / BM, batch), QTHREADS, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), amax,
      static_cast<bf16*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
