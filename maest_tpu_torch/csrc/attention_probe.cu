// The attention-decomposition variants of the bf16 forward (sm_90a),
// head_dim 64: measurement kernels, on no production path.
//
// Replaces scripts/attn_profile_r2.py::_mxu_only_kernel (:47),
// _noexp_max_kernel (:63), _novmax_kernel (:88) and _bf16_scores_kernel
// (:113), the TPU rig that split the flash forward's time between the
// matrix products and pipeline, the softmax arithmetic and the running-max
// bookkeeping. Each is an instantiation of the production loop of
// attn_fwd_bf16.cuh (K2, attention_fwd.cu) with its softmax section and
// epilogue changed as that header lists, so K2's time minus a variant's is
// the time of what the variant leaves out.
//
// What bounds them on the H100: as K2, arithmetic: the two products
// (4 N n_real 64 flops per (batch, head)) on mma.sync and, in every
// variant but MXU_ONLY, the N n_real exp2 on the special-function units
// (16 a clock per SM). MXU_ONLY keeps the products, the cp.async pipeline
// and the bf16 packing of p; the difference to K2 is the softmax time K2
// does not hide behind them.

#include "attn_fwd_bf16.cuh"

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// variant: 1 mxu_only, 2 noexp_max, 3 novmax, 4 bf16s (maest::FwdVariant).
// q, k, v, out: (batch, n, heads, 64) bf16 with element strides
// strides[0..11] = (q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h, o_b, o_n,
// o_h), a contiguous last dimension and rows on 16-byte boundaries.
// sl: the factor of the scores: head_dim^-0.5 for mxu_only,
// head_dim^-0.5 * log2(e) for noexp_max and novmax, unused by bf16s (whose
// q comes pre-scaled). 1 <= n_real <= n, and n_real == n for mxu_only.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for another variant.
int maest_attn_probe_bf16(int variant, const void* q, const void* k,
                          const void* v, void* out, int batch, int n,
                          int heads, int n_real, const long long* strides,
                          float sl, void* stream) {
  using namespace maest;
  decltype(&attn_fwd_bf16_kernel<MXU_ONLY>) kernel;
  switch (variant) {
    case MXU_ONLY: kernel = attn_fwd_bf16_kernel<MXU_ONLY>; break;
    case NOEXP_MAX: kernel = attn_fwd_bf16_kernel<NOEXP_MAX>; break;
    case NOVMAX: kernel = attn_fwd_bf16_kernel<NOVMAX>; break;
    case BF16S: kernel = attn_fwd_bf16_kernel<BF16S>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<bf16>(kernel, MQ, 32 * WARPS, q, k, v, out, nullptr, batch, n,
                      heads, n_real, strides, sl, stream);
}

}  // extern "C"
