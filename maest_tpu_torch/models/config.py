"""Model configuration.

A copy of ``maest_tpu/models/config.py``, its values unchanged: the port keeps
its own, so that it reads nothing of the JAX package.

Mirrors the reference constructor surface (reference: models/maest.py:431-460
and the ``maest`` Sacred ingredient defaults at models/maest.py:1444-1464) as a
frozen dataclass so every shape is static at trace time — the key TPU design
decision (patchout keep-counts, pos-embed cuts and chunk counts are all
compile-time constants).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MAESTConfig:
    # input geometry
    img_size: tuple[int, int] = (96, 998)  # (freq bins, time frames)
    patch_size: int = 16
    stride: tuple[int, int] = (10, 10)
    in_chans: int = 1

    # transformer
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True

    # heads
    num_classes: int = 527
    distilled: bool = True
    distilled_type: str = "mean"  # "mean" | "separated" (anything else raises)

    # regularization
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0

    # patchout (reference: models/maest.py:433-439)
    u_patchout: int = 0
    s_patchout_t: int = 0
    s_patchout_f: int = 0
    s_patchout_f_indices: tuple[int, ...] = ()
    s_patchout_f_interleaved: int = 0
    s_patchout_t_indices: tuple[int, ...] = ()
    s_patchout_t_interleaved: int = 0

    # experimental per-frequency-row patch embedding (reference:
    # models/maest.py:259-343): each of the grid_f patch rows gets its own
    # projection. Enabled via fix_embedding_layer(embed="freq_embed").
    per_freq_patch_embed: bool = False

    # numerics
    layer_norm_eps: float = 1e-6
    # attention implementation: "auto" picks the Pallas flash kernel on TPU
    # and XLA elsewhere; "xla"/"flash" force a path.
    attention_impl: str = "auto"
    # 8-bit attention arithmetic on the flash path: "none" | "qk8" |
    # "qk8pv8" (int8, int32 accumulation, exact rescale) | "fp8" |
    # "fp8pv8" (e4m3, scale-free). Forward-only: the backward stays bf16
    # (straight-through). Ignored on the XLA path. MEASURED SLOWER than
    # bf16 at MAEST's d=64 geometry (the softmax VPU floor binds once the
    # MXU speeds up — docs/DESIGN.md round-3); provided for d>=128
    # geometries where the MXU share dominates.
    attention_quant: str = "none"
    # int8 arithmetic for the attention BACKWARD (all five matmuls,
    # exact-factoring per-(head,block) scales, shifted p quantization):
    # "none" | "int8". MEASURED SLOWER (-4.0%) than bf16 at MAEST's d=64
    # geometry — in-kernel quantize/dequant VPU passes cancel the 2x int8
    # MXU rate (docs/DESIGN.md round-3, four scale designs A/B'd) —
    # provided for d>=128 geometries. On-device gradients track the
    # oracle at cos > 0.9998, worst relmax 0.024 (acceptance-gated).
    attention_bwd_quant: str = "none"
    # rematerialize transformer blocks during training (jax.checkpoint):
    # trades ~30% more FLOPs on backward for O(depth) less activation
    # memory, buying larger per-chip batches.
    remat: bool = False
    # what the remat'd block may keep instead of recomputing:
    #   "full"     — save nothing, recompute the whole block (default);
    #   "dots"     — jax.checkpoint_policies.dots_with_no_batch_dims_saveable:
    #                keeps matmul outputs (qkv/proj/mlp), recomputes the
    #                cheap elementwise ops only;
    #   "attn_out" — save just the flash-attention outputs (tagged with
    #                checkpoint_name), so the backward never re-runs the
    #                attention forward kernel but activation memory stays
    #                O(N·E) per block rather than O(N·4E).
    remat_policy: str = "full"
    # GELU flavor: the reference uses torch nn.GELU() = exact erf. The exact
    # erf does not fuse into the matmul epilogue on TPU and doubles MLP time;
    # the tanh approximation is free. "auto" uses tanh under bf16 compute
    # (error ~1e-3, below bf16 rounding) and exact erf under fp32 (the
    # parity-oracle mode); "exact"/"tanh" force a flavor.
    gelu_approx: str = "auto"
    # Megatron-style sequence parallelism (only meaningful with tensor
    # parallelism): the residual stream is sharded over the `model` axis on
    # the TOKEN dim between blocks, so LayerNorm/dropout/residual math and
    # activation memory scale 1/TP; XLA turns the TP all-reduces into
    # reduce-scatter + all-gather pairs around the sharded regions.
    sequence_parallel: bool = False

    @property
    def grid_size(self) -> tuple[int, int]:
        # Pos-embed table sizes use img_size // stride (reference:
        # models/maest.py:234); the conv itself emits
        # floor((dim - patch)/stride) + 1 patches and the time table is cut to
        # the actual width, absorbing the off-by-one (models/maest.py:659).
        return (self.img_size[0] // self.stride[0], self.img_size[1] // self.stride[1])

    @property
    def num_tokens(self) -> int:
        return 2 if self.distilled else 1


    def replace(self, **kw) -> "MAESTConfig":
        return dataclasses.replace(self, **kw)
