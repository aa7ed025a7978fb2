// Fused log-mel front-end for Hopper (sm_90a), plain fp32 FMA.
//
// Replaces maest_tpu/ops/mel_kernel.py::_mel_kernel (called from
// fused_logmel_from_frames): for each 512-sample frame
//   re = frame @ (hann*cos), im = frame @ (hann*sin)      (512 x 257 each)
//   power = re^2 + im^2                                   (257 bins)
//   mel = power @ fb                                      (257 x 96)
//   out = log10(1 + scale*mel), optionally (out - mean) / (2 std)
// Frames of the whole batch arrive flattened as (M, 512); out is (M, n_mels).
//
// What bounds it on the H100: the fp32 FMA rate. Per frame it does 263k
// FMAs for the DFT and 25k for the mel projection against 2 KB read and
// 384 B written, far above the card's bytes-per-flop line. The front-end
// must hold 1e-4 against the fp64 oracle, so it uses plain fp32 FMA: no
// TF32 (a reduced-precision pass measured 2.5e-2 on the TPU).
//
// Design: one block owns TILE_F frames, staged once in shared memory. Each
// thread owns one DFT bin and keeps that bin's re/im for all TILE_F frames
// in registers, so every window*cos / window*sin coefficient it reads from
// L2 feeds 2*TILE_F FMAs and every frame sample comes from a shared-memory
// broadcast. The power spectrum then overwrites the frame tile in shared
// memory, and the block projects it onto the mel bands, takes the log and
// the z-norm, and stores. The ragged last tile is masked, not padded.

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

}  // extern "C"
