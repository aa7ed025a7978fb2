// 8-bit attention forward for Hopper (sm_90a), head_dim 64, 128 and 256: the
// int8 modes qk8 / qk8pv8 (K5) and the e4m3 modes fp8 / fp8pv8 (K6).
//
// Replaces maest_tpu/ops/attention.py::_attn_kernel_q8 + _attn_body_q8
// (K5, called from _flash_fwd_lse with quant "qk8" / "qk8pv8") and
// _attn_kernel + _attn_body run on e4m3 operands (K6, quant "fp8" /
// "fp8pv8"). As there, the quantization runs before the kernel, in
// PyTorch (ops/attention.py, quantize_fwd_q8): per-row int8 q and k with
// fp32 scales, the per-column int8 v scale sv, the e4m3 casts. The kernel
// computes, per query row, over 64-key tiles:
//
//   s = (s_int * (sq * sl)) * sk       int8: exact int32 q8.k8, per-row /
//                                      per-key scales (sl = scale log2 e)
//   s = (q8.k8) * sl                   e4m3: fp32 accumulation
//   keys >= n_real: s = -1e30; online softmax in the log2 domain (m, l fp32)
//   qk8:    acc = acc corr + bf16(p) . v           (v bf16)
//   qk8pv8: acc = acc corr + int32(round(p 127) . v8); out acc (sv / 127) / l
//   fp8:    acc = acc corr + bf16(p) . v
//   fp8pv8: acc = acc corr + e4m3(p) . e4m3(v)      (fp32 accumulation)
//
// with the output divided by l at the end and lse = m + log2(l) when asked
// for (the training forward). p is rounded relative to the running max of
// the tiles seen so far, so the result depends on the key tiling; the
// plain version (attention_q8_reference) walks the same 64-key tiles.
//
// What bounds it on the H100: at the tagging shape (32, 1676, 12, 64) the
// two products take 0.209 ms at the data-sheet rates in qk8 / fp8 (8-bit
// q.k, bf16 p.v) and 0.140 ms in the pv8 modes; the N^2 exp2 of the
// softmax run on the special-function units at 16 a clock per SM, ~0.27 ms
// at 1.8-2.0 GHz, which is above the 8-bit tensor-core time. So this kernel
// cannot beat the bf16 one (attention_fwd.cu) by much at head_dim 64: the
// exponentials bound both. Device memory is far from binding (~0.07 ms).
//
// fp32 tier (the *_fp32 entries): q and k quantized from fp32 in the same
// way; qk8 and fp8 multiply fp32 v by unrounded p in scalar fp32 FMA,
// which bounds them as it bounds the fp32 K2 (67 TFLOP/s); qk8pv8 and
// fp8pv8 run the bf16 instances' 8-bit products and write fp32.
//
// Design: the bf16 kernel's (8 warps x 16 query rows a block, key / value
// tiles of 64 double-buffered with cp.async, the score accumulator reused
// as the A operand of P.V in registers), with mma.sync m16n8k32 for every
// 8-bit product. K tiles are (key, 64-byte) rows read by ldmatrix; in the
// pv8 modes V arrives transposed, (64, N_pad) bytes with the sequence in
// the seq_pos order of mma_8bit.cuh, so the score accumulator packs into
// P's A fragment without a shuffle. int8 P.V sums each tile in int32 from
// zero and adds it to the fp32 accumulator, as the TPU kernel does per key
// block; e4m3 P.V does the same in fp32.

#include "attn_fwd_q8.cuh"  // the kernel template (modes QK8..FP8PV8)

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q8, k8: (batch, n, heads, 64) int8 (qk8*) or e4m3 (fp8*) with element
// strides strides[0..5] and 16-byte rows; qsl, sk: contiguous fp32
// (batch, heads, n) of sq * sl and sk (int8 modes, else nullptr); v: the
// bf16 (batch, n, heads, 64) view with strides[6..8] (qk8, fp8) or the
// contiguous (batch * heads, 64, round_up(n, 64)) transposed 8-bit copy in
// seq_pos order (pv8 modes); sv127: contiguous fp32 (batch, heads, 64) of
// sv / 127 (qk8pv8, else nullptr); out: bf16 (batch, n, heads, 64) with
// strides[9..11]; lse: nullptr or contiguous fp32 (batch, heads, n).
// sl = head_dim^-0.5 * log2(e). 1 <= n_real <= n. Launches on `stream`;
// returns cudaGetLastError(). The *_fp32 entries take fp32 v (qk8, fp8;
// rows on 16-byte boundaries) and write fp32 out. The *_d128 entries take
// head_dim 128 in place of 64 everywhere above (sv127 (batch, heads, 128),
// the transposed copy (batch * heads, 128, round_up(n, 64))), the *_d256
// entries head_dim 256 the same way.
#define MAEST_FWD_Q8(NAME, MODE, T, D_)                                        \
  int NAME(const void* q8, const void* k8, const float* qsl, const float* sk, \
           const void* v, const float* sv127, void* out, float* lse,          \
           int batch, int n, int heads, int n_real, const long long* strides, \
           float sl, void* stream) {                                          \
    return maest::launch_q8<maest::MODE, T, D_>(q8, k8, qsl, sk, v, sv127,    \
                                                out, lse, batch, n, heads,    \
                                                n_real, strides, sl, stream); \
  }

MAEST_FWD_Q8(maest_attn_fwd_qk8, QK8, maest::bf16, 64)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8, QK8PV8, maest::bf16, 64)
MAEST_FWD_Q8(maest_attn_fwd_fp8, FP8, maest::bf16, 64)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8, FP8PV8, maest::bf16, 64)
MAEST_FWD_Q8(maest_attn_fwd_qk8_fp32, QK8, float, 64)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_fp32, QK8PV8, float, 64)
MAEST_FWD_Q8(maest_attn_fwd_fp8_fp32, FP8, float, 64)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_fp32, FP8PV8, float, 64)
MAEST_FWD_Q8(maest_attn_fwd_qk8_d128, QK8, maest::bf16, 128)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_d128, QK8PV8, maest::bf16, 128)
MAEST_FWD_Q8(maest_attn_fwd_fp8_d128, FP8, maest::bf16, 128)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_d128, FP8PV8, maest::bf16, 128)
MAEST_FWD_Q8(maest_attn_fwd_qk8_fp32_d128, QK8, float, 128)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_fp32_d128, QK8PV8, float, 128)
MAEST_FWD_Q8(maest_attn_fwd_fp8_fp32_d128, FP8, float, 128)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_fp32_d128, FP8PV8, float, 128)
MAEST_FWD_Q8(maest_attn_fwd_qk8_d256, QK8, maest::bf16, 256)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_d256, QK8PV8, maest::bf16, 256)
MAEST_FWD_Q8(maest_attn_fwd_fp8_d256, FP8, maest::bf16, 256)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_d256, FP8PV8, maest::bf16, 256)
MAEST_FWD_Q8(maest_attn_fwd_qk8_fp32_d256, QK8, float, 256)
MAEST_FWD_Q8(maest_attn_fwd_qk8pv8_fp32_d256, QK8PV8, float, 256)
MAEST_FWD_Q8(maest_attn_fwd_fp8_fp32_d256, FP8, float, 256)
MAEST_FWD_Q8(maest_attn_fwd_fp8pv8_fp32_d256, FP8PV8, float, 256)

}  // extern "C"
