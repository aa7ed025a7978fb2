// Fused log-mel front-end for Hopper (sm_90a): two kernels.
//
// Both replace maest_tpu/ops/mel_kernel.py::_mel_kernel (called from
// fused_logmel_from_frames, :95): for each 512-sample frame
//   Hann window, 512-point DFT, power of bins 0..256,
//   mel = power @ fb                                      (257 x 96)
//   out = log10(1 + scale*mel), optionally (out - mean) / (2 std)
// Frames of the whole batch arrive flattened as (M, 512); out is (M, n_mels).
// The TPU kernel takes the DFT as two products against hann*cos and
// hann*sin, because that is what its MXU is for.
//
// logmel_fft_kernel (entry maest_logmel_fft, the route of every CUDA
// tensor) takes it as a real FFT instead.
//
// What bounds it on the H100: bytes. At (60032, 512), 32 clips of 30 s, the
// frames are 122.9 MB in and the log-mels 23.1 MB out: 0.0436 ms at 3.35
// TB/s. The FFT route does ~12 kFLOP a frame (0.74 GFLOP, 0.011 ms at 67
// fp32 TFLOP/s; chip_smoke.py mel_fft_ops counts them). The DFT as a
// product, which it replaces, does ~575 kFLOP a
// frame (34.6 GFLOP): 0.517 ms in fp32 FMA, and 0.21 ms on the tensor cores
// in 3xTF32, the cheapest product that holds the front-end's 1e-4 against
// fp64 (tf32 alone does not). The FFT drops both below the bytes, so the
// design is about the bytes and the shared memory that the FFT runs in:
//   - A persistent grid, two blocks an SM, walks over groups of 8 frames
//     (16 KB, contiguous rows). A producer warp keeps a ring of 4 groups in
//     flight by TMA 1-D bulk copies (cp.async.bulk) on mbarriers: up to
//     ~96 KB an SM in flight, no registers or address math spent on the
//     loads. The ragged last group is copied short and masked, not padded.
//   - Each of 8 consumer warps transforms one frame of a group. The window
//     is applied as the samples leave shared memory (a host table, fp32).
//     z[n] = x[2n] + i x[2n+1] goes through a 256-point complex FFT in
//     registers, 8 values a lane: radix 8 over n = 32 n1 + n2, twiddles
//     W_256^(n2 k1), radix 8 over n2 = 4 m1 + m2, twiddles W_32^(m2 j1),
//     radix 4 over m2, giving Z[k1 + 8 j1 + 64 j2]. The values cross
//     between lanes through a per-warp buffer padded against bank
//     conflicts (rows of 36, then of 33 float2; Z at k + 4 (k >> 4)).
//   - The split step: X[k] = E + W_512^k O, X[256 - k] = conj(E - W_512^k
//     O), with E = (Z[k] + conj Z[256 - k]) / 2 and O = -i (Z[k] - conj
//     Z[256 - k]) / 2; DC and Nyquist, Re Z[0] +- Im Z[0], are real and
//     taken apart. Every twiddle comes from one host table of W_512^k,
//     cos and -sin of 2 pi k / 512 in float64 rounded to fp32 (no sincos,
//     no fast math), held in registers for the kernel's life.
//   - The mel projection sums each band over its run of nonzero bins
//     (502 of the 24672 weights at 96 bands; at most 15 bins a band), in
//     ascending bin order. Every term the dense sum adds beyond the run is
//     fmaf(p, 0, acc) = acc exactly (p finite and >= 0), so given the same
//     power spectrum the band sums equal the dense loop's bit for bit
//     (tests/test_torch_mel_fft.py). A lane owns up to 4 bands (32 j +
//     lane, or 32 j + 31 - lane for odd j, so that narrow and wide bands
//     share a lane); the 96 floats of a frame are stored as coalesced rows.
// fused_logmel_fft_reference (ops/mel_kernel.py) walks the same route in
// PyTorch: the same passes, tables and band runs.
//
// logmel_kernel (entry maest_logmel_fp32, the FFT kernel's control; the
// route of the port before the FFT): the DFT as a product in plain fp32
// FMA. One block owns TILE_F frames, staged once in shared memory. Each
// thread owns one DFT bin and keeps that bin's re/im for all TILE_F frames
// in registers, so every window*cos / window*sin coefficient it reads from
// L2 feeds 2*TILE_F FMAs and every frame sample comes from a shared-memory
// broadcast. The power spectrum then overwrites the frame tile in shared
// memory, and the block projects it onto the mel bands (densely, all 257
// bins), takes the log and the z-norm, and stores. The ragged last tile is
// masked, not padded. It is bound by its fp32 FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 512;
constexpr int N_BINS = N_FFT / 2 + 1;  // 257
constexpr int TILE_F = 32;             // frames per block
constexpr int THREADS = 288;           // 9 warps: one bin per thread, 257 busy
constexpr size_t SMEM_BYTES = sizeof(float) * TILE_F * N_FFT;  // 64 KB
static_assert(TILE_F * N_BINS <= TILE_F * N_FFT, "power must fit the frame tile");
static_assert(THREADS >= N_BINS, "one thread per bin");

__global__ void __launch_bounds__(THREADS)
logmel_kernel(const float* __restrict__ frames, int64_t m_frames,
              const float* __restrict__ cosw, const float* __restrict__ sinw,
              const float* __restrict__ fb, int n_mels,
              float* __restrict__ out, float scale, float mean,
              float inv_two_std, int normalize) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * TILE_F;

  // stage the frame tile; rows past the end are zeros
  const float4* src = reinterpret_cast<const float4*>(frames);
  constexpr int ROW4 = N_FFT / 4;
  for (int i = tid; i < TILE_F * ROW4; i += THREADS) {
    const int f = i / ROW4;
    const int64_t row = f0 + f;
    smem4[i] = row < m_frames ? src[row * ROW4 + (i - f * ROW4)]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  float re[TILE_F], im[TILE_F];
#pragma unroll
  for (int f = 0; f < TILE_F; ++f) re[f] = im[f] = 0.f;

  if (tid < N_BINS) {
    for (int n = 0; n < N_FFT; n += 4) {
      float c[4], s[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[k] = __ldg(cosw + (n + k) * N_BINS + tid);
        s[k] = __ldg(sinw + (n + k) * N_BINS + tid);
      }
#pragma unroll
      for (int f = 0; f < TILE_F; ++f) {
        const float4 x = smem4[f * ROW4 + n / 4];
        re[f] = fmaf(x.x, c[0], re[f]);
        im[f] = fmaf(x.x, s[0], im[f]);
        re[f] = fmaf(x.y, c[1], re[f]);
        im[f] = fmaf(x.y, s[1], im[f]);
        re[f] = fmaf(x.z, c[2], re[f]);
        im[f] = fmaf(x.z, s[2], im[f]);
        re[f] = fmaf(x.w, c[3], re[f]);
        im[f] = fmaf(x.w, s[3], im[f]);
      }
    }
  }
  __syncthreads();  // every thread is done with the frames: reuse for power
  if (tid < N_BINS) {
#pragma unroll
    for (int f = 0; f < TILE_F; ++f)
      smem[f * N_BINS + tid] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int o = tid; o < TILE_F * n_mels; o += THREADS) {
    const int f = o / n_mels;
    const int m = o - f * n_mels;
    const int64_t row = f0 + f;
    if (row >= m_frames) break;  // o only grows, so every later row is past too
    const float* p = smem + f * N_BINS;
    float acc = 0.f;
    for (int b = 0; b < N_BINS; ++b) acc = fmaf(p[b], __ldg(fb + b * n_mels + m), acc);
    float v = log10f(1.f + acc * scale);
    if (normalize) v = (v - mean) * inv_two_std;
    out[row * n_mels + m] = v;
  }
}

// ------------------------------------------------------ the FFT kernel ---
namespace fft {

constexpr int WARPS = 8;                   // consumer warps: a frame each
constexpr int THREADS = 32 * (WARPS + 1);  // and one producer warp
constexpr int GROUP = WARPS;               // frames a group, one bulk copy
constexpr int STAGES = 4;                  // groups in the ring
constexpr int FRAME_BYTES = N_FFT * 4;
constexpr int STAGE_BYTES = GROUP * FRAME_BYTES;  // 16 KB
constexpr int EX1 = 36;       // float2 stride of k1 in the first exchange
constexpr int EX2 = 33;       // float2 stride of j1 in the second
constexpr int SCRATCH = 320;  // float2 a warp: 36*7+32, 33*7+32, zpos(255)+1
constexpr int POWER = 260;    // floats a warp: the 257 bins
constexpr int MAX_MELS = 128;  // 4 bands a lane
constexpr int MAX_NNZ = 1024;  // band weights staged in shared memory
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int SCRATCH_OFF = RING_BYTES;
constexpr int POWER_OFF = SCRATCH_OFF + WARPS * SCRATCH * 8;
constexpr int WEIGHTS_OFF = POWER_OFF + WARPS * POWER * 4;
constexpr int BARS_OFF = WEIGHTS_OFF + MAX_NNZ * 4;
constexpr int SMEM_BYTES = BARS_OFF + 2 * STAGES * 8;  // 96.2 KB: 2 blocks an SM
static_assert(SCRATCH >= EX1 * 7 + 32 && SCRATCH >= EX2 * 7 + 32 &&
              SCRATCH >= 255 + 4 * 15 + 1, "the exchange buffer");
static_assert(BARS_OFF % 8 == 0 && SCRATCH_OFF % 128 == 0, "alignment");

// The mbarrier and bulk-copy PTX that the attention headers also wrap; this
// library includes none of them.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// until the phase of the given parity has completed; a wait that outlasts
// 2^22 polls, far past any group's work, traps, so a fault fails the launch
// instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
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

// complex values as float2 (re, im); twiddles w = (cos, -sin)
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// the 4-point DFT in place, in natural order
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2,
                                     float2& x3) {
  const float2 e0 = cadd(x0, x2), f0 = csub(x0, x2), e1 = cadd(x1, x3),
               d = csub(x1, x3);
  const float2 f1 = make_float2(d.y, -d.x);  // -i (x1 - x3)
  x0 = cadd(e0, e1);
  x1 = cadd(f0, f1);
  x2 = csub(e0, e1);
  x3 = csub(f0, f1);
}

// the 8-point DFT in place, in natural order: a radix-2 step (a_j +-
// a_(j+4), the differences times W_8^j; h = cos(pi / 4) from the table),
// then a 4-point DFT of the sums (even outputs) and of the differences (odd)
__device__ __forceinline__ void dft8(float2 (&a)[8], float h) {
  float2 b[4], c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j] = cadd(a[j], a[j + 4]);
    c[j] = csub(a[j], a[j + 4]);
  }
  c[1] = make_float2(h * (c[1].x + c[1].y), h * (c[1].y - c[1].x));
  c[2] = make_float2(c[2].y, -c[2].x);
  c[3] = make_float2(h * (c[3].y - c[3].x), -(h * (c[3].x + c[3].y)));
  dft4(b[0], b[1], b[2], b[3]);
  dft4(c[0], c[1], c[2], c[3]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[2 * r] = b[r];
    a[2 * r + 1] = c[r];
  }
}

// where Z[k] lies in a warp's buffer: the step-3 lanes write 16 distinct
// banks, and the split step reads runs of 16 from it
__device__ __forceinline__ int zpos(int k) { return k + 4 * (k >> 4); }

// the split step's power for 0 < k < 256, za = Z[k], zb = Z[256 - k]:
// E = (za + conj zb) / 2, O = -i (za - conj zb) / 2, |E + W O|^2 to *pk
// and, where pnk is not null, |E - W O|^2 (X[256 - k] = conj(E - W O)) to
// *pnk; w = W_512^k
__device__ __forceinline__ void split_bins(float2 za, float2 zb, float2 w,
                                           float* pk, float* pnk) {
  const float2 e = make_float2(0.5f * (za.x + zb.x), 0.5f * (za.y - zb.y));
  const float2 o = make_float2(0.5f * (za.y + zb.y), -(0.5f * (za.x - zb.x)));
  const float2 wo = cmul(o, w);
  const float2 x1 = cadd(e, wo);
  *pk = x1.x * x1.x + x1.y * x1.y;
  if (pnk) {
    const float2 x2 = csub(e, wo);
    *pnk = x2.x * x2.x + x2.y * x2.y;
  }
}

// frames (m_frames, 512) fp32, 16-byte aligned; window (512); tw (512)
// twiddles W_512^k; bands (n_mels) of (start, width, offset, 0); weights
// (nnz) the bands' runs; out (m_frames, n_mels)
__global__ void __launch_bounds__(fft::THREADS, 2)
logmel_fft_kernel(const float* __restrict__ frames, int64_t m_frames,
                  const float2* __restrict__ window,
                  const float2* __restrict__ tw, const int4* __restrict__ bands,
                  const float* __restrict__ weights, int nnz, int n_mels,
                  float* __restrict__ out, float scale, float mean,
                  float inv_two_std, int normalize) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* wts = reinterpret_cast<float*>(smem + WEIGHTS_OFF);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full0 = ring + BARS_OFF, empty0 = full0 + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t groups = (m_frames + GROUP - 1) / GROUP;

  for (int i = threadIdx.x; i < nnz; i += THREADS) wts[i] = weights[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WARPS);  // each consumer warp releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      int it = 0;
      for (int64_t g = blockIdx.x; g < groups; g += gridDim.x, ++it) {
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);  // first round at once
        const int64_t row0 = g * GROUP;
        const int rows = static_cast<int>(
            m_frames - row0 < GROUP ? m_frames - row0 : GROUP);
        const uint32_t bytes = static_cast<uint32_t>(rows * FRAME_BYTES);
        mbar_expect_tx(full0 + 8 * s, bytes);
        bulk_load(ring + s * STAGE_BYTES, frames + row0 * N_FFT, bytes,
                  full0 + 8 * s);
      }
    }
    return;
  }

  // a consumer: this lane's window, twiddles and bands for the kernel's life
  const float h = tw[64].x;
  float2 win[8], t1[7], t2[7], ts[4];
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1) win[n1] = window[32 * n1 + lane];
#pragma unroll
  for (int k1 = 1; k1 < 8; ++k1) {
    t1[k1 - 1] = tw[(2 * lane * k1) & 511];  // W_256^(n2 k1), n2 = lane
    t2[k1 - 1] = tw[(16 * (lane & 3) * k1) & 511];  // W_32^(m2 j1)
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) ts[r] = tw[lane + 32 * r];
  const float2 t128 = tw[128];
  // band j of this lane: 32 j + lane, or 32 j + 31 - lane for odd j;
  // code = start | width << 9 | offset << 16, -1 for none
  int code[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = 32 * j + ((j & 1) ? 31 - lane : lane);
    code[j] = -1;
    if (m < n_mels) {
      const int4 b = bands[m];
      code[j] = b.x | (b.y << 9) | (b.z << 16);
    }
  }
  float2* buf = reinterpret_cast<float2*>(smem + SCRATCH_OFF) + warp * SCRATCH;
  float* pw = reinterpret_cast<float*>(smem + POWER_OFF) + warp * POWER;

  int it = 0;
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x, ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const int64_t row = g * GROUP + warp;
    const bool live = row < m_frames;  // the ragged last group is masked
    float2 a[8];
    if (live) {
      const float2* x = reinterpret_cast<const float2*>(
          smem + s * STAGE_BYTES + warp * FRAME_BYTES);
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) {
        const float2 v = x[32 * n1 + lane];  // z[32 n1 + lane], windowed
        a[n1] = make_float2(v.x * win[n1].x, v.y * win[n1].y);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the frame is in registers
    if (!live) continue;

    // radix 8 over n1, then W_256^(n2 k1); across lanes: (k1, m2) = (lane
    // >> 2, lane & 3) takes n2 = 4 m1 + m2
    dft8(a, h);
#pragma unroll
    for (int k1 = 1; k1 < 8; ++k1) a[k1] = cmul(a[k1], t1[k1 - 1]);
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) buf[EX1 * k1 + lane] = a[k1];
    __syncwarp();
#pragma unroll
    for (int m1 = 0; m1 < 8; ++m1)
      a[m1] = buf[EX1 * (lane >> 2) + 4 * m1 + (lane & 3)];
    __syncwarp();
    // radix 8 over m1, then W_32^(m2 j1); across lanes: (k1, jj) = (lane >>
    // 2, lane & 3) takes j1 = jj and jj + 4, every m2
    dft8(a, h);
#pragma unroll
    for (int j1 = 1; j1 < 8; ++j1) a[j1] = cmul(a[j1], t2[j1 - 1]);
#pragma unroll
    for (int j1 = 0; j1 < 8; ++j1) buf[lane + EX2 * j1] = a[j1];
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int m2 = 0; m2 < 4; ++m2)
        a[4 * t + m2] =
            buf[4 * (lane >> 2) + m2 + EX2 * ((lane & 3) + 4 * t)];
    __syncwarp();
    // radix 4 over m2: Z[k1 + 8 j1 + 64 j2]
    dft4(a[0], a[1], a[2], a[3]);
    dft4(a[4], a[5], a[6], a[7]);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
        buf[zpos((lane >> 2) + 8 * ((lane & 3) + 4 * t) + 64 * j2)] =
            a[4 * t + j2];
    __syncwarp();

    // the split step: bins k and 256 - k from Z[k] and Z[256 - k]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = lane + 32 * r;
      const float2 za = buf[zpos(k)], zb = buf[zpos((256 - k) & 255)];
      if (k == 0) {  // DC and Nyquist are real
        const float dc = za.x + za.y, ny = za.x - za.y;
        pw[0] = dc * dc;
        pw[256] = ny * ny;
      } else {
        split_bins(za, zb, ts[r], pw + k, pw + 256 - k);
      }
    }
    if (lane == 0) {  // bin 128 pairs with itself
      const float2 z = buf[zpos(128)];
      split_bins(z, z, t128, pw + 128, nullptr);
    }
    __syncwarp();

    // the bands over their runs, log10 and z-norm; stores of 32 floats
    float* orow = out + row * n_mels;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (code[j] < 0) continue;
      const int start = code[j] & 511, width = (code[j] >> 9) & 127,
                off = code[j] >> 16;
      float acc = 0.f;
      for (int q = 0; q < width; ++q) acc = fmaf(pw[start + q], wts[off + q], acc);
      float v = log10f(1.f + acc * scale);
      if (normalize) v = (v - mean) * inv_two_std;
      orow[32 * j + ((j & 1) ? 31 - lane : lane)] = v;
    }
  }
}

}  // namespace fft

}  // namespace

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// frames (m_frames, 512) fp32 contiguous; cosw, sinw (512, 257); fb
// (257, n_mels); out (m_frames, n_mels). Launches on `stream` and returns
// cudaGetLastError().
int maest_logmel_fp32(const float* frames, long long m_frames,
                      const float* cosw, const float* sinw, const float* fb,
                      int n_mels, float* out, float scale, float mean,
                      float inv_two_std, int normalize, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m_frames <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((m_frames + TILE_F - 1) / TILE_F);
  logmel_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      frames, m_frames, cosw, sinw, fb, n_mels, out, scale, mean, inv_two_std,
      normalize);
  return static_cast<int>(cudaGetLastError());
}

// The FFT kernel: frames (m_frames, 512) fp32 contiguous and 16-byte
// aligned; window (512); twiddle (512, 2) cos, -sin; bands (n_mels, 4)
// int32 start, width, offset, 0; weights (nnz); out (m_frames, n_mels).
// At most 128 bands, 1024 weights and 127 bins a band. Launches on
// `stream` a persistent grid of at most as many blocks as fit on the card
// at once and returns cudaGetLastError().
int maest_logmel_fft(const float* frames, long long m_frames,
                     const float* window, const float* twiddle,
                     const int* bands, const float* weights, int nnz,
                     int n_mels, float* out, float scale, float mean,
                     float inv_two_std, int normalize, void* stream) {
  if (n_mels > fft::MAX_MELS || nnz > fft::MAX_NNZ || nnz < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // once, before any launch a graph captures; the settings hold for the
  // current device only: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute(
      fft::logmel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fft::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fft::logmel_fft_kernel, fft::THREADS, fft::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = sms * per_sm;
  }
  if (m_frames <= 0) return 0;
  const long long groups = (m_frames + fft::GROUP - 1) / fft::GROUP;
  const unsigned grid =
      static_cast<unsigned>(groups < resident ? groups : resident);
  fft::logmel_fft_kernel<<<grid, fft::THREADS, fft::SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      frames, m_frames, reinterpret_cast<const float2*>(window),
      reinterpret_cast<const float2*>(twiddle),
      reinterpret_cast<const int4*>(bands), weights, nnz, n_mels, out, scale,
      mean, inv_two_std, normalize);
  return static_cast<int>(cudaGetLastError());
}

// The FFT kernel's launch shape, for reports: cfg[0] dynamic shared memory
// bytes a block, cfg[1] threads a block, cfg[2] blocks an SM at once,
// cfg[3] bytes of its ring of frame groups; returns a cudaError_t.
int maest_logmel_fft_config(int* cfg) {
  cfg[0] = fft::SMEM_BYTES;
  cfg[1] = fft::THREADS;
  cfg[3] = fft::RING_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      fft::logmel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fft::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cfg[2], fft::logmel_fft_kernel, fft::THREADS, fft::SMEM_BYTES);
  return static_cast<int>(err);
}

}  // extern "C"
