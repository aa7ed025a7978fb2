// The tensor-core rate rigs on Hopper (sm_90a): one hand-written product
// kernel, out = sum over r < R of A . B_r, with bf16 or e4m3 operands, fp32
// sums and a bf16 output.
//
// Replaces scripts/mxu_probe.py::_probe_kernel (P1, the bf16 products at
// the attention kernel's own shapes: the scores product of contraction
// depth 64, the p.v product of output width 64, and full 256-wide tiles as
// the control) and scripts/fp8_mlp_probe.py::_mm_kernel (P8, one bf16 or
// e4m3 product at the MLP and qkv shapes, B shared by every program). On
// the H100 both are instances of this kernel: A (M, K) is reused against R
// column blocks B_r of B (k64, ctrl, ctrlbig and k64big fold 7 or 56 of
// them into one (M, 256) output; the other kinds and P8 take R = 1), and B
// has a batch stride, 0 where every program shares the weights (P8). pv's
// seven 256-deep slices and pvbig's heads are one product each here: the
// kernel walks the whole contraction.
//
// It uses K2's instruction path (mma.sync m16n8k16 bf16 and m16n8k32 e4m3
// from mma_bf16.cuh / mma_8bit.cuh, ldmatrix fragments, cp.async staging),
// so its rate is K2's product ceiling in like terms; wgmma and
// TMA, the only way to the card's full tensor-core rate, are not used
// (ROADMAP's redesign queue).
//
// What bounds it on the H100: arithmetic at the P1 shapes whose output is
// narrow or folded (k64, ctrl, ctrlbig, k64big: 0.02-0.64 ms at 989
// TFLOP/s for the rig's 48 programs) and at every P8 shape (fc1, fc2 0.27
// ms bf16, 0.14 ms e4m3; qkv 0.21 / 0.10), and device memory where an
// (N, N) operand or output is moved (k64w, pv, pvwide: 0.099 ms; pvbig
// 0.39 ms at 3.35 TB/s).
//
// The output tile: a block owns 128 rows x BN columns (BN 128, or 64 for
// an output of width 64: the p.v kinds), one warp 64 x 64 (4 m-tiles x 8
// n-tiles, 128 fp32 sums a thread), so 4 warps (BN 128) or 2. A warp tile
// of 64 x 64 reads 8 KB of fragments through ldmatrix for each 32 mma.sync
// of 16 x 8 x 16 (262 kflop): ~32 flops a byte of shared memory, the
// H100's ratio of tensor-core flops to shared-memory bytes a clock, where a
// 32 x 64 tile stays at 21. Each stage brings 128 bytes of the
// contraction (64 bf16 or 128 e4m3 values) of each A row and, per output
// column, of B, through a 3-stage cp.async ring in dynamic shared memory
// (83-111 KB, two blocks an SM) with one barrier a stage. Rows are padded
// from 128 to 144 bytes (A, e4m3 B^T) and bf16 B's (k, BN) rows by 8
// values, so the 8 rows an ldmatrix phase reads hit 32 banks. bf16 B is
// row-major (K, N) as the rigs give it and reaches the B fragment through
// ldmatrix.trans; ldmatrix cannot transpose 8-bit values, so e4m3 B
// arrives column-major, as (N, K) rows, which ldmatrix reads as it reads A
// (two n-tiles of one k-step a call). The fold kinds re-read A from L2 for each of their R column blocks.

#include "mma_8bit.cuh"  // and mma_bf16.cuh

namespace {

using namespace maest;

constexpr int BM = 128;             // output rows a block
constexpr int WT = 64;              // rows and columns a warp: 4 x 8 tiles
constexpr int KB = 128;             // bytes of the contraction a stage
constexpr int LDA = KB + 16;        // padded A (and e4m3 B^T) row, bytes
constexpr int STAGES = 3;           // the cp.async ring

// threads of an instance: (BM / WT) x (BN / WT) warps
__host__ __device__ constexpr int probe_threads(int bn) {
  return 32 * (BM / WT) * (bn / WT);
}

// bytes of one stage's B tile: (KB / 2, BN + 8) bf16, or (BN, LDA) bytes
__host__ __device__ constexpr int b_bytes(bool fp8, int bn) {
  return fp8 ? bn * LDA : KB / 2 * (bn + 8) * 2;
}

// dynamic shared memory of an instance: the ring of A and B tiles
__host__ __device__ constexpr int probe_smem(bool fp8, int bn) {
  return STAGES * (BM * LDA + b_bytes(fp8, bn));
}

// out[z] (m, ncols), bf16, = sum over r < R of A[z] (m, k) . B_r[z], where
// B_r is columns r ncols.. of B[z] (k, R ncols) row-major (bf16), or rows
// r ncols.. of B[z]^T (R ncols, k) row-major (e4m3, FP8). A[z] = a + z m k,
// B[z] = b + z b_batch, out[z] = out + z m ncols; every dimension a
// multiple of its tile (the entry checks). Grid (ncols / BN, m / BM, batch).
template <bool FP8, int BN, int R>
__global__ void __launch_bounds__(probe_threads(BN))
mma_probe_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 bf16* __restrict__ out, int m, int k, int ncols,
                 long long b_batch) {
  constexpr int EB = FP8 ? 1 : 2;        // bytes an element
  constexpr int KE = KB / EB;            // elements of K a stage
  constexpr int THREADS = probe_threads(BN);
  constexpr int LDB = BN + 8;            // bf16 B row (k, BN), elements
  constexpr int BBYTES = b_bytes(FP8, BN);
  extern __shared__ __align__(128) uint8_t ring[];
  uint8_t(*a_sm)[BM][LDA] = reinterpret_cast<uint8_t(*)[BM][LDA]>(ring);
  uint8_t(*b_sm)[BBYTES] =
      reinterpret_cast<uint8_t(*)[BBYTES]>(ring + STAGES * BM * LDA);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lr = lane & 7;
  const int li = lane >> 3;
  const int wm = warp & 1;   // this warp's 64 rows
  const int wn = warp >> 1;  // and 64 columns
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
      for (int i = threadIdx.x; i < BM * (KB / 16); i += THREADS) {
        const int row = i >> 3;
        const int c = (i & 7) * 16;
        cp_async16(&a_sm[buf][row][c], ab + (static_cast<long long>(row) * k +
                                             kk * KE) * EB + c, 16);
      }
      if constexpr (FP8) {  // BN rows of B^T, 128 bytes of K each
        uint8_t(*bt)[LDA] = reinterpret_cast<uint8_t(*)[LDA]>(b_sm[buf]);
        for (int i = threadIdx.x; i < BN * (KB / 16); i += THREADS) {
          const int row = i >> 3;
          const int c = (i & 7) * 16;
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

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage(s, s);
  for (int it = 0; it < n_it; ++it) {
    const int buf = it % STAGES;
    cp_async_wait<STAGES - 2>();
    // stage `it` is in shared memory for every warp, and every warp is done
    // with the slot that the next stage refills (read at iteration it - 1)
    __syncthreads();
    stage(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    const uint8_t(*as)[LDA] = a_sm[buf];
    if constexpr (FP8) {
      const uint8_t(*bt)[LDA] = reinterpret_cast<const uint8_t(*)[LDA]>(b_sm[buf]);
#pragma unroll
      for (int ks = 0; ks < KB / 32; ++ks) {  // k-steps of 32 bytes
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(af[mt], &as[wm * WT + mt * 16 + (li & 1) * 8 + lr]
                                 [ks * 32 + (li >> 1) * 16]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // n-tiles 2 np and 2 np + 1
          // B^T rows of the two n-tiles: lanes 8i.. address n-tile 2 np +
          // (i >> 1), bytes 16 (i & 1) of this k-step
          uint32_t f[4];
          ldmatrix_x4(f, &bt[wn * WT + np * 16 + (li >> 1) * 8 + lr]
                            [ks * 32 + (li & 1) * 16]);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma_e4m3(acc[mt][2 * np], af[mt], f[0], f[1]);
            mma_e4m3(acc[mt][2 * np + 1], af[mt], f[2], f[3]);
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
        for (int dp = 0; dp < 4; ++dp) {  // n-tiles 2 dp and 2 dp + 1
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

  bf16* ob = out + (z * m + m0 + wm * WT) * ncols + n0 + wn * WT + 2 * t;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* orow = ob + static_cast<long long>(mt * 16 + g + 8 * r) * ncols;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) =
            __floats2bfloat162_rn(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
    }
}

template <bool FP8, int BN, int R>
int launch_probe(const void* a, const void* b, void* out, int batch, int m,
                 int k, int ncols, long long b_batch, void* stream) {
  constexpr int KE = FP8 ? KB : KB / 2;
  if (m % BM || ncols % BN || k % KE || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || m == 0 || ncols == 0) return 0;
  const auto kernel = mma_probe_kernel<FP8, BN, R>;
  constexpr int smem = probe_smem(FP8, BN);
  // once an instance, before any launch a graph captures; the setting holds
  // for the current device only: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(ncols / BN, m / BM, batch);
  kernel<<<grid, probe_threads(BN), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<bf16*>(out), m, k, ncols, b_batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (batch, m, ncols) bf16 = sum over r < fold of a (batch, m, k) .
// B_r, all contiguous: bf16 (fp8 = 0) with b (batch, k, fold ncols)
// row-major, B_r its columns r ncols..; e4m3 (fp8 = 1) with b the
// transposed (batch, fold ncols, k), B_r^T its rows r ncols... b_batch:
// elements between two batches' b, 0 where they share one. bn: the output
// tile's columns, 128 or 64. The instances: bf16 at (bn 128, fold 1, 7,
// 56) and (64, 1); e4m3 at (128, 1). m a multiple of 128, ncols of bn, k of
// 64 (bf16) or 128 (e4m3). Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or instance the
// kernel does not have.
int maest_mma_probe(int fp8, int bn, int fold, const void* a, const void* b,
                    void* out, int batch, int m, int k, int ncols,
                    long long b_batch, void* stream) {
  decltype(&launch_probe<false, 128, 1>) fn;
  switch (fp8 * 100000 + bn * 100 + fold) {
    case 12801: fn = launch_probe<false, 128, 1>; break;
    case 12807: fn = launch_probe<false, 128, 7>; break;
    case 12856: fn = launch_probe<false, 128, 56>; break;
    case 6401: fn = launch_probe<false, 64, 1>; break;
    case 112801: fn = launch_probe<true, 128, 1>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(a, b, out, batch, m, k, ncols, b_batch, stream);
}

}  // extern "C"
