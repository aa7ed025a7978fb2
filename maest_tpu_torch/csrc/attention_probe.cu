// The measurement variants of the attention forward (sm_90a), head_dim 64:
// kernels on no production path, each an instantiation of a production
// loop (K2's attn_fwd_bf16.cuh, K5/K6's attn_fwd_q8.cuh) with one section
// changed as the header lists, so the production kernel's time minus a
// variant's is the time of what the variant leaves out or changes.
//
// Replaces, in scripts/attn_profile_r2.py (the TPU rig that split the flash
// forward's time between the products and pipeline, the softmax arithmetic
// and the running-max bookkeeping): _mxu_only_kernel (:47),
// _noexp_max_kernel (:63), _novmax_kernel (:88), _bf16_scores_kernel
// (:113), _gh_kernel (:148, G heads a block) and _int8_kernel (:226, int8
// q.k and p.v with p's fixed scale 127); in scripts/attn_vpu_probe.py (the
// TPU rig that asked which softmax arithmetic the cheaper 8-bit products
// would expose): _variant_kernel (:54), kinds bf16sm, fp8sm, fp8noexp,
// fp8nomask and fp8lean; in scripts/qpad_probe.py (the TPU rig that padded
// q to the sublane's 8 rows instead of the block's 128): fwd_qpad (:46,
// G heads a program, with and without lse); in scripts/attn_tune.py (the
// TPU rig that swept the forward's blocks): time_config (:67). Its
// backward sweep, time_bwd (:116), is attention_bwd.cu's
// maest_attn_bwd_tile. In scripts/int8_probe.py (the TPU rig that asked
// whether int8 products run faster at the attention's depth-64 shapes):
// _probe_kernel (:46) kinds mix_bf16 and mix_i8, the scores, an exp2 and
// the p.v product in one program (MIX, MIX8); its other kinds are single
// products, mma_probe.cu's.
//
// What bounds them on the H100: as K2, arithmetic. The two products (4 N
// n_real 64 flops per (batch, head)) at the tensor-core rate of their
// types (bf16 989 TFLOP/s; int8 and e4m3 1979) and, in every variant but
// MXU_ONLY, the N n_real exp2 on the special-function units (16 a clock
// per SM: ~0.26 ms at (32, 1676, 12)). With 8-bit products the exp2 floor
// lies above the product bound (0.140-0.209 ms there), which is what the
// fp8 kinds measure: the softmax arithmetic each one removes. Bf16sm and
// the fp8 kinds with a bf16 softmax run max, subtraction and exp2 on packed
// bf16x2 pairs (two values an instruction). G > 1 amortises a block's
// prologue (q fragments, first tile) and epilogue over G heads at the cost
// of G times fewer blocks. QPAD spares the products of the warps whose
// rows all lie past N (at N 281, 6 of the last block's 8), so at most 15
// padded rows a head are multiplied where K2 multiplies up to 127. The tile
// instances trade per-block fixed costs (q fragments, the first tile's
// wait, the epilogue) and parallelism against registers and shared memory:
// 64-row blocks double the grid, 256-row blocks halve it; 32-key tiles
// double the loop's trips and syncs, 128-key tiles halve them and need 74
// KB of dynamic shared memory and twice the score registers.

// P6d (bf16s) runs, since it was redesigned for Hopper, on K2's wgmma/TMA
// kernel (attn_fwd_wgmma.cuh, its BF16S form: q pre-scaled in shared
// memory, the scores rounded to bf16 in registers), through
// maest_attn_probe_bf16s_wgmma; its mma.sync variant BF16S behind the
// PyTorch pre-scaling pass stays as the control (maest_attn_probe_bf16,
// variant 4). P6e (gh<G>) runs on the same kernel with G heads a block
// (the producer loading the next head's q into a second buffer and its K
// and V into the same ring, so the ring never drains between heads),
// through maest_attn_probe_gh; K2's mma.sync template with G heads a block
// stays as its control (maest_attn_probe_gh_mma). The same products as
// K2's wgmma kernel bound both.

#include "attn_fwd_q8.cuh"     // and attn_fwd_bf16.cuh
#include "attn_fwd_wgmma.cuh"  // K2's wgmma kernel, its BF16S form

namespace {

// the gh probe's wgmma instance of group G at K2's key tile for n_real
template <int G>
int launch_gh_wgmma(const void* q, const void* k, const void* v, void* out,
                    int batch, int n, int heads, int n_real,
                    const long long* strides, float sl, void* stream) {
  using namespace maest;
  if (wg_key_tile(n_real) == 112)
    return launch_fwd_wgmma<112, 3, true, false, G>(
        q, k, v, out, nullptr, batch, n, heads, n_real, strides, sl, stream);
  return launch_fwd_wgmma<96, 3, true, false, G>(
      q, k, v, out, nullptr, batch, n, heads, n_real, strides, sl, stream);
}

}  // namespace

extern "C" {

const char* maest_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// variant: 1 mxu_only, 2 noexp_max, 3 novmax, 4 bf16s, 5 bf16sm, 6
// mix_bf16 (maest::FwdVariant; mix_bf16 takes k = v and n_real = n). q, k, v, out: (batch, n, heads, 64) bf16 with
// element strides strides[0..11] = (q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n,
// v_h, o_b, o_n, o_h), a contiguous last dimension and rows on 16-byte
// boundaries. sl: the factor of the scores: head_dim^-0.5 for mxu_only,
// head_dim^-0.5 * log2(e) for noexp_max, novmax and bf16sm, unused by
// bf16s (whose q comes pre-scaled). 1 <= n_real <= n, and n_real == n for
// mxu_only. Launches on `stream`; returns cudaGetLastError(), or
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
    case BF16SM: kernel = attn_fwd_bf16_kernel<BF16SM>; break;
    case MIX: kernel = attn_fwd_bf16_kernel<MIX>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<bf16>(kernel, MQ, 32 * WARPS, q, k, v, out, nullptr, batch, n,
                      heads, n_real, strides, sl, stream);
}

// P6d on wgmma: the bf16-score forward of K2's wgmma kernel on the
// unscaled q, three consumer warpgroups taking turns and K2's key tile, 96
// or 112 keys, whichever pads n_real the least (96 on a tie; wg_key_tile,
// as maest_attn_fwd_bf16 chooses it). q, k, v, out, strides as
// maest_attn_probe_bf16's, each view's base address and strides in
// multiples of 16 bytes (TMA); sl = head_dim^-0.5 * log2(e), the factor q
// is pre-scaled by in the kernel. 1 <= n_real <= n. Returns
// cudaGetLastError(), or the first error of the launch's set-up.
int maest_attn_probe_bf16s_wgmma(const void* q, const void* k, const void* v,
                                 void* out, int batch, int n, int heads,
                                 int n_real, const long long* strides,
                                 float sl, void* stream) {
  using namespace maest;
  if (n_real < 1 || n_real > n) return static_cast<int>(cudaErrorInvalidValue);
  if (wg_key_tile(n_real) == 112)
    return launch_fwd_wgmma<112, 3, true, true>(q, k, v, out, nullptr, batch,
                                                n, heads, n_real, strides, sl,
                                                stream);
  return launch_fwd_wgmma<96, 3, true, true>(q, k, v, out, nullptr, batch, n,
                                             heads, n_real, strides, sl,
                                             stream);
}

// P6e on wgmma: K2's wgmma kernel with `group` (batch, head) pairs a
// block, group 1, 2, 4 or 8 dividing batch * heads, three consumer
// warpgroups taking turns and K2's key tile, 96 or 112 keys, whichever pads
// n_real the least (96 on a tie; wg_key_tile, as maest_attn_fwd_bf16
// chooses it), so each head's output is K2's bit for bit. The arguments as
// maest_attn_probe_bf16's, each view's base address and strides in
// multiples of 16 bytes (TMA); sl = head_dim^-0.5 * log2(e). Returns
// cudaErrorInvalidValue for another group.
int maest_attn_probe_gh(int group, const void* q, const void* k,
                        const void* v, void* out, int batch, int n, int heads,
                        int n_real, const long long* strides, float sl,
                        void* stream) {
  if (n_real < 1 || n_real > n) return static_cast<int>(cudaErrorInvalidValue);
  switch (group) {  // launch_fwd_wgmma refuses a group not dividing B H
    case 1:
      return launch_gh_wgmma<1>(q, k, v, out, batch, n, heads, n_real,
                                strides, sl, stream);
    case 2:
      return launch_gh_wgmma<2>(q, k, v, out, batch, n, heads, n_real,
                                strides, sl, stream);
    case 4:
      return launch_gh_wgmma<4>(q, k, v, out, batch, n, heads, n_real,
                                strides, sl, stream);
    case 8:
      return launch_gh_wgmma<8>(q, k, v, out, batch, n, heads, n_real,
                                strides, sl, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The mma.sync kernel that maest_attn_probe_gh ran before the wgmma one,
// kept as its control: K2's mma.sync template (FLASH) with `group` (batch,
// head) pairs a block, its 64-key tiles; the same arguments and groups.
int maest_attn_probe_gh_mma(int group, const void* q, const void* k,
                            const void* v, void* out, int batch, int n,
                            int heads, int n_real, const long long* strides,
                            float sl, void* stream) {
  using namespace maest;
  decltype(&attn_fwd_bf16_kernel<FLASH>) kernel;
  switch (group) {
    case 1: kernel = attn_fwd_bf16_kernel<FLASH, 1>; break;
    case 2: kernel = attn_fwd_bf16_kernel<FLASH, 2>; break;
    case 4: kernel = attn_fwd_bf16_kernel<FLASH, 4>; break;
    case 8: kernel = attn_fwd_bf16_kernel<FLASH, 8>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * heads % group != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<bf16>(kernel, MQ, 32 * WARPS, q, k, v, out, nullptr, batch, n,
                      heads, n_real, strides, sl, stream, group);
}

// K2 with the QPAD flag (a warp whose rows all lie past N does no work) and
// `group` (batch, head) pairs a block, group 1, 8, 12 or 24 dividing batch
// * heads; lse: nullptr, or a contiguous fp32 (batch, heads, n) that
// receives m + log2(l) (K3a's). The other arguments as
// maest_attn_probe_bf16's, sl = head_dim^-0.5 * log2(e). Returns
// cudaErrorInvalidValue for another group.
int maest_attn_probe_qpad(int group, const void* q, const void* k,
                          const void* v, void* out, float* lse, int batch,
                          int n, int heads, int n_real,
                          const long long* strides, float sl, void* stream) {
  using namespace maest;
  decltype(&launch_fwd<FLASH>) fn;
  switch (group) {
    case 1: fn = launch_fwd<FLASH, 1, WARPS, MK, true>; break;
    case 8: fn = launch_fwd<FLASH, 8, WARPS, MK, true>; break;
    case 12: fn = launch_fwd<FLASH, 12, WARPS, MK, true>; break;
    case 24: fn = launch_fwd<FLASH, 24, WARPS, MK, true>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * heads % group != 0) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, out, lse, batch, n, heads, n_real, strides, sl, stream);
}

// K2 (FLASH) at another tile: q_rows query rows a block (16 a warp: 64, 128
// or 256) and key_tile keys a shared-memory tile (32, 64 or 128); (128, 64)
// is K2. lse and the other arguments as maest_attn_probe_qpad's. Returns
// cudaErrorInvalidValue for another tile.
int maest_attn_probe_tile(int q_rows, int key_tile, const void* q,
                          const void* k, const void* v, void* out, float* lse,
                          int batch, int n, int heads, int n_real,
                          const long long* strides, float sl, void* stream) {
  using namespace maest;
  decltype(&launch_fwd<FLASH>) fn;
  switch (q_rows * 1000 + key_tile) {
    case 64032: fn = launch_fwd<FLASH, 1, 4, 32>; break;
    case 64064: fn = launch_fwd<FLASH, 1, 4, 64>; break;
    case 64128: fn = launch_fwd<FLASH, 1, 4, 128>; break;
    case 128032: fn = launch_fwd<FLASH, 1, 8, 32>; break;
    case 128064: fn = launch_fwd<FLASH, 1, 8, 64>; break;
    case 128128: fn = launch_fwd<FLASH, 1, 8, 128>; break;
    case 256032: fn = launch_fwd<FLASH, 1, 16, 32>; break;
    case 256064: fn = launch_fwd<FLASH, 1, 16, 64>; break;
    case 256128: fn = launch_fwd<FLASH, 1, 16, 128>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(q, k, v, out, lse, batch, n, heads, n_real, strides, sl, stream);
}

// mode: 4 int8 (the rig's _int8_kernel), 5 fp8sm, 6 fp8noexp, 7 fp8nomask,
// 3 fp8lean (maest::Q8Mode; fp8lean is FP8PV8 on a pre-scaled q, sl 1), 8
// mix_i8 (int8 q8 and k8 and v the transposed int8 copy as for int8, no
// scales, n_real = n, fp32 out; sl unused).
// q8, k8: (batch, n, heads, 64) int8 (int8) or e4m3 with element strides
// strides[0..5] and 16-byte rows. int8: qsl contiguous fp32 (batch, heads,
// n) of qs / 127^2 * sl, sk of max|k| per key, the same shape; v the
// contiguous (batch * heads, 64, round_up(n, 64)) transposed int8 copy in
// seq_pos order, sv127 contiguous fp32 (batch, heads, 64) of vs / 127^2;
// out fp32. fp8lean: v the transposed e4m3 copy, no scales. fp8sm,
// fp8noexp, fp8nomask: v the bf16 (batch, n, heads, 64) view with
// strides[6..8], no scales. out: (batch, n, heads, 64), bf16 but for int8,
// strides[9..11], 8-byte aligned rows. sl: head_dim^-0.5 * log2(e), 1 for
// fp8lean. 1 <= n_real <= n, but for fp8nomask, which takes n_pad there:
// a multiple of 64 at or past n. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for another mode or an
// n_real out of range.
int maest_attn_probe_q8(int mode, const void* q8, const void* k8,
                        const float* qsl, const float* sk, const void* v,
                        const float* sv127, void* out, int batch, int n,
                        int heads, int n_real, const long long* strides,
                        float sl, void* stream) {
  using namespace maest;
  const bool nomask_ok = n_real >= n && n_real % MK == 0;
  if (mode == FP8NOMASK ? !nomask_ok : n_real < 1 || n_real > n)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case INT8_RIG:
      return launch_q8<INT8_RIG, float>(q8, k8, qsl, sk, v, sv127, out,
                                        nullptr, batch, n, heads, n_real,
                                        strides, sl, stream);
    case FP8SM:
      return launch_q8<FP8SM>(q8, k8, qsl, sk, v, sv127, out, nullptr, batch,
                              n, heads, n_real, strides, sl, stream);
    case FP8NOEXP:
      return launch_q8<FP8NOEXP>(q8, k8, qsl, sk, v, sv127, out, nullptr,
                                 batch, n, heads, n_real, strides, sl, stream);
    case FP8NOMASK:
      return launch_q8<FP8NOMASK>(q8, k8, qsl, sk, v, sv127, out, nullptr,
                                  batch, n, heads, n_real, strides, sl, stream);
    case MIX8:
      return launch_q8<MIX8, float>(q8, k8, qsl, sk, v, sv127, out, nullptr,
                                    batch, n, heads, n_real, strides, sl,
                                    stream);
    case FP8PV8:
      return launch_q8<FP8PV8>(q8, k8, qsl, sk, v, sv127, out, nullptr, batch,
                               n, heads, n_real, strides, sl, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
