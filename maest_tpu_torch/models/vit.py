"""MAEST ViT, port of ``maest_tpu/models/vit.py``: eval and train modes.

Parameter names follow the torch layout of the released checkpoints
(``blocks.{i}.attn.qkv.weight``, ``head.0``/``head.1``, ``head_dist``, ...),
so a released state dict loads with a prefix strip alone. The module
takes NCHW ``(B, 1, F, T)`` spectrograms; the JAX module takes NHWC.

Numerics tiers, as in the JAX package: float32 is the parity tier (exact
erf GELU, full-fp32 patch projection); bfloat16 is the production tier
(tanh GELU). ``dtype`` is the compute dtype; ``param_dtype`` (default: the
compute dtype) is the storage dtype of the parameters, which are cast per
use, as flax's ``dtype``/``param_dtype`` do. Inference stores bf16
weights for the bf16 tier; training keeps fp32 parameters under bf16
compute, so that an optimizer step smaller than bf16's spacing is not
lost. Attention goes through ``ops.attention.flash_attention``: the CUDA
kernels on the card, the plain versions on the CPU; ``attention_quant``
selects an 8-bit forward (int8 or e4m3) and ``attention_bwd_quant="int8"``
the int8 backward, as in the JAX package.

The train forward (``forward(x, train=True, generator=...)``) ports the
random time pos-embed crop, structured and unstructured patchout, token /
projection / MLP dropout, attention-matrix dropout (materialised softmax,
the JAX package's XLA path), per-sample drop_path, and block remat with
the policies ``full``, ``dots`` and ``attn_out``. Its random draws come
from an explicit CPU ``torch.Generator`` (``draw_train``), or are handed
in as ``TrainDraws``; dropout masks are drawn on the tensors' device from
per-block seeds, so a rematerialized block redraws the same masks.

Tensor and sequence parallelism (``set_layout``, by
``parallel.mesh.shard_params``): ``Attention`` and ``Mlp`` run on this
rank's heads and hidden columns, with the region seams of
``parallel.tensor_parallel`` around them (all-reduces, or under sequence
parallelism an all-gather before qkv / fc1 and a reduce-scatter after
proj / fc2, the residual stream token-sharded between); the attention
kernels see plain local tensors. Dropout and drop_path masks are drawn at
the global shape and cut to the rank's slice, so every layout draws a
single process's masks.

The pipeline seams (``forward_mode``, for ``parallel.pipeline``): "front"
runs the patch embedding, the positional embeddings, patchout, the token
assembly and its dropout, and returns ``(tokens, n_tokens)``; "tail"
runs the final norm and the heads on the blocks' output. The port pads
no stream once for the attention kernels (they take any length), so
``n_tokens`` is the stream's length. A train front takes the same draws
as the full forward (``block_seeds`` gives the blocks' mask seeds of
those draws, ``run_block`` runs one block), so front, blocks and tail
give the full forward bit for bit.

Not ported yet, and refused with ``NotImplementedError``: the
per-frequency patch embedding and non-distilled configs (ROADMAP queue
1 item 2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.attention import flash_attention_qkv, record_outputs, replay_outputs
from ..parallel.tensor_parallel import Layout, masked_keep
from .config import MAESTConfig

# timm trunc_normal_(std=0.02) for dense kernels; the pos embeds / tokens
# use the std-corrected draw the JAX package uses (0.02 / 0.8796...)
_DENSE_STD = 0.02
_POS_STD = 0.02 / 0.87962566103423978
_REMAT_POLICIES = ("full", "dots", "attn_out")


def _gelu_mode(cfg: MAESTConfig, dtype: torch.dtype) -> str:
    mode = cfg.gelu_approx
    if mode == "auto":
        mode = "tanh" if dtype == torch.bfloat16 else "exact"
    if mode not in ("exact", "tanh"):
        raise ValueError(f"unknown gelu_approx {cfg.gelu_approx!r}")
    return "none" if mode == "exact" else "tanh"


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
    """A parameter in the compute dtype (no copy when it is stored so)."""
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computing in its input's dtype."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape,
                            _cast(self.weight, x.dtype),
                            _cast(self.bias, x.dtype), self.eps)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            shard: tuple = ()) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale by
    1 / (1 - rate); off when ``generator`` is None (eval) or rate is 0.
    ``shard``: (dim, start, full) triples placing ``x`` in the global
    tensor, whose mask is drawn and cut (``masked_keep``)."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    if not shard:
        mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    else:
        mask = masked_keep(x.shape, shard, keep, x.device, x.dtype, generator)
    return x * mask / keep


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              shard: tuple = ()) -> torch.Tensor:
    """Per-sample stochastic depth (reference:
    models/helpers/vit_helpers.py:74-104): one keep draw per sample
    (``shard``: as ``dropout``'s, its batch rows only)."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = masked_keep((x.shape[0],) + (1,) * (x.ndim - 1), shard, keep,
                       x.device, x.dtype, generator)
    return x * mask / keep


class Mlp(nn.Module):
    """Transformer MLP (reference: models/maest.py:183-208)."""

    def __init__(self, dim: int, hidden: int, gelu: str, drop: float = 0.0):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.gelu = gelu  # "none" = exact erf, "tanh" = approximation
        self.drop = drop
        self.layout: Optional[Layout] = None

    def forward(self, x, generator=None, n_tokens: Optional[int] = None):
        lay = self.layout
        if lay is None or not lay.tensor_parallel:
            rows = () if lay is None else lay.rows(x.shape[0])
            x = dropout(F.gelu(self.fc1(x), approximate=self.gelu), self.drop,
                        generator, rows)
            return dropout(self.fc2(x), self.drop, generator, rows)
        # tensor parallel: this rank's hidden columns, one sum after fc2
        n = n_tokens or x.shape[1]
        rows = lay.rows(x.shape[0])
        h = F.gelu(self.fc1(lay.enter(x, n)), approximate=self.gelu)
        h = dropout(h, self.drop, generator,
                    rows + lay.columns(2, h.shape[-1]))
        out = lay.leave(F.linear(h, _cast(self.fc2.weight, h.dtype)))
        out = out + _cast(self.fc2.bias, out.dtype)
        return dropout(out, self.drop, generator,
                       rows + lay.token_shard(out.shape[1], n))


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection (reference:
    models/maest.py:346-378). q, k and v are strided views of the qkv
    output; the kernels read them in place.

    ``impl`` (the JAX package's ``attention_impl``, models/vit.py:153-193):
    "xla" materialises the softmax, as the JAX package's XLA path does, on
    any device and without ``quant``; "auto" and "flash" run the attention
    kernels, "auto" the materialised softmax where attention dropout is on
    (train mode with ``attn_drop`` > 0), where "flash" raises as the JAX
    package does. The JAX package's "auto" also takes the XLA path off the
    TPU and below head_dim 64 (its ``use_flash``); the port's kernels run
    on the card at every head_dim, in bf16, fp32 and every 8-bit mode
    (instances at 64, 128 and 256 and one of runtime width for multiples
    of 64 above; a head_dim between zero-padded to the next)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 quant: str = "none", bwd_quant: str = "none",
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed_dim {dim} not divisible by num_heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.quant = quant
        self.bwd_quant = bwd_quant
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.impl = impl
        self.head_dim = dim // num_heads
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.layout: Optional[Layout] = None

    def forward(self, x, generator=None, n_tokens: Optional[int] = None):
        lay = self.layout
        tp = lay is not None and lay.tensor_parallel
        rows = () if lay is None else lay.rows(x.shape[0])
        if tp:  # this rank's heads: the full stream in, local heads out
            x = lay.enter(x, n_tokens or x.shape[1])
        b, n, _ = x.shape
        d = self.head_dim
        heads = self.qkv.weight.shape[0] // (3 * d)
        c = heads * d
        qkv = self.qkv(x).view(b, n, 3, heads, d)
        needs_drop = generator is not None and self.attn_drop > 0.0
        if needs_drop and self.impl == "flash":
            # the kernels have no attention-matrix dropout; skipping it
            # would train another model (maest_tpu/models/vit.py:157-164)
            raise ValueError(
                "attention_impl='flash' cannot apply attn_drop_rate > 0 "
                "in train mode; use 'auto' or 'xla'")
        if needs_drop or self.impl == "xla":
            # the materialised softmax (the JAX package's XLA path,
            # models/vit.py:179-193), which attention dropout needs
            q, k, v = qkv.unbind(2)
            s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
            p = torch.softmax(s * q.shape[-1] ** -0.5, dim=-1)
            p = dropout(p, self.attn_drop, generator,
                        rows + (lay.columns(1, heads) if tp else ()))
            out = torch.einsum("bhnm,bmhd->bnhd", p.to(x.dtype), v)
        else:
            out = flash_attention_qkv(qkv, quant=self.quant,
                                      bwd_quant=self.bwd_quant)
        out = out.reshape(b, n, c)
        if not tp:
            return dropout(self.proj(out), self.proj_drop, generator, rows)
        # proj's partial products summed over the heads' ranks, then bias
        out = lay.leave(F.linear(out, _cast(self.proj.weight, out.dtype)))
        out = out + _cast(self.proj.bias, out.dtype)
        return dropout(out, self.proj_drop, generator,
                       rows + lay.token_shard(out.shape[1], n))


class Block(nn.Module):
    """Pre-LN transformer block (reference: models/maest.py:381-420)."""

    def __init__(self, cfg: MAESTConfig, gelu: str, drop_path_rate: float = 0.0):
        super().__init__()
        e = cfg.embed_dim
        self.norm1 = LayerNorm(e, eps=cfg.layer_norm_eps)
        self.attn = Attention(e, cfg.num_heads, cfg.qkv_bias,
                              cfg.attention_quant, cfg.attention_bwd_quant,
                              cfg.attn_drop_rate, cfg.drop_rate,
                              cfg.attention_impl)
        self.norm2 = LayerNorm(e, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(e, int(e * cfg.mlp_ratio), gelu, cfg.drop_rate)
        self.drop_path_rate = drop_path_rate

    def forward(self, x, seed: Optional[int] = None,
                return_self_attention: bool = False,
                n_tokens: Optional[int] = None):
        """``seed``: train mode with dropout; the block's masks are drawn
        from a generator on ``x``'s device seeded with it. ``n_tokens``:
        the stream's token count where ``x`` is a token shard (sequence
        parallelism)."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
        if return_self_attention:
            return self.attn(self.norm1(x), gen, n_tokens)
        lay = self.attn.layout
        rows = () if lay is None else lay.rows(x.shape[0])
        x = x + drop_path(self.attn(self.norm1(x), gen, n_tokens),
                          self.drop_path_rate, gen, rows)
        return x + drop_path(self.mlp(self.norm2(x), gen, n_tokens),
                             self.drop_path_rate, gen, rows)


class PatchEmbed(nn.Module):
    """Patch projection, computed as im2col + matmul. cuDNN would run a
    float32 convolution in TF32 by default (~1e-3 relative); a float32
    matmul stays full fp32, which the parity tier needs, and the global
    backend flags stay untouched. The patches are strided views of the
    input gathered by one copy (``F.unfold`` launches one kernel per
    sample, and its backward as many)."""

    def __init__(self, cfg: MAESTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.stride)

    def forward(self, x):
        w, stride = self.proj.weight, self.proj.stride
        p = w.shape[-1]
        b, c = x.shape[:2]
        # (B, C, F', T', p, p) -> (B, C*p*p, F'*T'), features (c, kh, kw)
        # as in w.flatten(1)
        patches = x.unfold(2, p, stride[0]).unfold(3, p, stride[1])
        f_out, t_out = patches.shape[2:4]
        cols = patches.permute(0, 1, 4, 5, 2, 3).reshape(
            b, c * p * p, f_out * t_out)
        out = (_cast(w, x.dtype).flatten(1) @ cols
               + _cast(self.proj.bias, x.dtype)[:, None])
        return out.view(x.shape[0], -1, f_out, t_out)


def _static_keep_indices(dim: int, drop_indices, interleave: int):
    """Deterministic patchout index sets (reference: models/maest.py:703-766)."""
    if drop_indices:
        drop = set(int(j) for j in drop_indices)
        bad = sorted(j for j in drop if not 0 <= j < dim)
        if bad:
            raise ValueError(
                f"patchout drop indices {bad} out of range for grid dim {dim}")
        kept = [i for i in range(dim) if i not in drop]
        if not kept:
            raise ValueError(
                f"patchout drop indices remove all {dim} rows of the grid")
        return kept
    if interleave:
        return list(range(0, dim, interleave))
    return None


@dataclass
class TrainDraws:
    """The random draws of one train forward: the time pos-embed crop
    offset, the sorted kept indices of structured (time, frequency) and
    unstructured patchout (None: that patchout is off), and the seed of the
    dropout / drop_path masks (None: every rate is 0)."""

    time_offset: int = 0
    keep_t: Optional[torch.Tensor] = None
    keep_f: Optional[torch.Tensor] = None
    keep_u: Optional[torch.Tensor] = None
    seed: Optional[int] = None


def _save_dots(ctx, op, *args, **kwargs):
    """``dots`` remat: keep the outputs of the 2-D matrix products (the
    qkv / proj / fc1 / fc2 projections: jax's dots_with_no_batch_dims),
    recompute the rest, attention included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def _attn_out_contexts():
    """``attn_out`` remat: keep each attention output (and its lse) from
    the forward, so the recomputed block never runs the attention forward
    again; the rest of the block is recomputed."""
    store: list = []
    return record_outputs(store), replay_outputs(store)


class _LaidOut:
    """A block called under ``layout``: set on its attention and MLP at
    every call, so a recomputed block cuts its masks as its forward did."""

    def __init__(self, blk: Block, layout: Layout):
        self.blk, self.layout = blk, layout

    def __call__(self, *args):
        self.blk.attn.layout = self.blk.mlp.layout = self.layout
        return self.blk(*args)


class MAESTNet(nn.Module):
    """The MAEST transformer body + heads.

    ``forward`` returns, depending on ``transformer_block``:
      * -1: per ``distilled_type`` — "mean": (logits, features),
        "separated": (logits_cls, logits_dist, features); with ``tap_block``
        the block embedding is appended, with ``return_layer_tokens`` the
        tuple of per-block token tensors;
      * >= 0: (None, [cls | dist | mean(tokens)] embedding of that block)
        (reference: models/maest.py:811-829).

    ``forward_mode`` "front" returns ``(tokens, n_tokens)``, the stream
    before the first block; "tail" takes the stream after the last block
    and returns the ``transformer_block == -1`` tuple.
    """

    def __init__(self, cfg: MAESTConfig, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.per_freq_patch_embed:
            raise NotImplementedError(
                "per_freq_patch_embed is not ported yet (ROADMAP queue 1)")
        if cfg.attention_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}"
                             "; expected 'auto', 'flash' or 'xla'")
        if not cfg.distilled:
            raise NotImplementedError("non-distilled configs are not ported yet")
        if cfg.distilled_type not in ("mean", "separated"):
            raise ValueError(f"unknown distilled_type {cfg.distilled_type!r}; "
                             "expected 'mean' or 'separated'")
        if cfg.attention_quant not in ("none", None, "qk8", "qk8pv8", "fp8",
                                       "fp8pv8"):
            raise ValueError(f"unknown attention_quant {cfg.attention_quant!r}"
                             "; expected 'none', 'qk8', 'qk8pv8', 'fp8' or "
                             "'fp8pv8'")
        if cfg.attention_bwd_quant not in ("none", None, "int8"):
            raise ValueError("unknown attention_bwd_quant "
                             f"{cfg.attention_bwd_quant!r}; expected 'none' "
                             "or 'int8'")
        if cfg.remat_policy not in _REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                             "expected 'full' | 'dots' | 'attn_out'")
        self.cfg = cfg
        self.compute_dtype = dtype
        e = cfg.embed_dim
        gf, gt = cfg.grid_size
        gelu = _gelu_mode(cfg, dtype)

        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, e))
        self.dist_token = nn.Parameter(torch.empty(1, 1, e))
        self.new_pos_embed = nn.Parameter(torch.empty(1, cfg.num_tokens, e))
        self.freq_new_pos_embed = nn.Parameter(torch.empty(1, e, gf, 1))
        self.time_new_pos_embed = nn.Parameter(torch.empty(1, e, 1, gt))
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(Block(cfg, gelu, float(dpr[i]))
                                    for i in range(cfg.depth))
        self.norm = LayerNorm(e, eps=cfg.layer_norm_eps)
        # head norm keeps torch's default eps 1e-5 (reference:
        # models/maest.py:570-571 vs :499)
        self.head = nn.Sequential(LayerNorm(e), Linear(e, cfg.num_classes))
        self.head_dist = Linear(e, cfg.num_classes)
        self.layout: Optional[Layout] = None
        # (lo, hi): the blocks of a pipeline stage this net holds
        # (``parallel.pipeline.cut_to_stage``); None: every block
        self.stage: Optional[tuple] = None
        self._static_indices: dict = {}
        self.reset_parameters(generator)
        self.to(device=device, dtype=param_dtype or dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's initializers, drawn from ``generator``."""
        for p in (self.cls_token, self.dist_token, self.new_pos_embed,
                  self.freq_new_pos_embed, self.time_new_pos_embed):
            nn.init.trunc_normal_(p, std=_POS_STD, a=-2 * _POS_STD,
                                  b=2 * _POS_STD, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=_DENSE_STD,
                                      a=-2 * _DENSE_STD, b=2 * _DENSE_STD,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        # the JAX package's conv default: lecun_normal kernel, zero bias
        w = self.patch_embed.proj.weight
        std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        # heads start at zero (reference: models/maest.py:951-953)
        for lin in (self.head[1], self.head_dist):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.compute_dtype

    def _kept_len(self, dim: int, s_patchout: int, drop_indices,
                  interleave: int) -> int:
        if s_patchout:
            dim -= s_patchout
        kept = _static_keep_indices(dim, drop_indices, interleave)
        return dim if kept is None else len(kept)

    def draw_train(self, generator: Optional[torch.Generator], f_dim: int,
                   t_dim: int) -> TrainDraws:
        """Draw one train forward's randomness from ``generator`` (a CPU
        generator; None: torch's default one) for a patch grid of
        (f_dim, t_dim) (reference draws: models/vit.py:470-533)."""
        cfg = self.cfg
        grid_t = cfg.grid_size[1]

        def keep(n, drop):
            if n - drop <= 0:
                raise ValueError(f"patchout of {drop} >= the {n} positions")
            return torch.sort(torch.randperm(n, generator=generator)[:n - drop]
                              ).values

        d = TrainDraws()
        if t_dim < grid_t:
            d.time_offset = int(torch.randint(0, grid_t - t_dim + 1, (),
                                              generator=generator))
        if cfg.s_patchout_t:
            d.keep_t = keep(t_dim, cfg.s_patchout_t)
        if cfg.s_patchout_f:
            d.keep_f = keep(f_dim, cfg.s_patchout_f)
        if cfg.u_patchout:
            n = self._kept_len(f_dim, cfg.s_patchout_f, cfg.s_patchout_f_indices,
                               cfg.s_patchout_f_interleaved) * self._kept_len(
                t_dim, cfg.s_patchout_t, cfg.s_patchout_t_indices,
                cfg.s_patchout_t_interleaved)
            d.keep_u = keep(n, cfg.u_patchout)
        if (cfg.drop_rate or cfg.attn_drop_rate or cfg.drop_path_rate):
            d.seed = int(torch.randint(0, 2**62, (), generator=generator))
        return d

    def forward(self, x: torch.Tensor, *, train: bool = False,
                transformer_block: int = -1,
                return_self_attention: bool = False,
                return_layer_tokens: bool = False,
                tap_block: Optional[int] = None,
                forward_mode: str = "full",
                generator: Optional[torch.Generator] = None,
                draws: Optional[TrainDraws] = None):
        """``train``: the train forward, with its draws taken from
        ``generator`` or handed in as ``draws``."""
        cfg = self.cfg
        if tap_block is not None and (transformer_block != -1
                                      or return_layer_tokens):
            raise ValueError(
                "tap_block rides the transformer_block == -1 forward and "
                "is exclusive with return_layer_tokens")
        if not -1 <= transformer_block < cfg.depth:
            raise ValueError(
                f"transformer_block {transformer_block} out of range for "
                f"depth {cfg.depth}")
        if tap_block is not None and not 0 <= tap_block < cfg.depth:
            raise ValueError(
                f"tap_block {tap_block} out of range for depth {cfg.depth}")
        if forward_mode not in ("full", "front", "tail"):
            raise ValueError(f"unknown forward_mode {forward_mode!r}")
        if forward_mode != "full" and (
                transformer_block != -1 or return_self_attention
                or return_layer_tokens or tap_block is not None):
            raise ValueError(
                "front/tail forward modes only support the plain "
                "transformer_block == -1 forward")
        dt = self.dtype
        if forward_mode == "tail":
            # x: the (B, N, E) stream after the blocks
            return self._heads(self.norm(x.to(dt)))

        # --- patch embedding: (B, C, F, T) -> (B, E, F', T') ---
        x = self.patch_embed(x.to(dt))
        b, e, f_dim, t_dim = x.shape
        grid_t = cfg.grid_size[1]
        if t_dim > grid_t:
            raise ValueError(
                f"input yields {t_dim} time patches but the time pos-embed "
                f"table has {grid_t}; reduce the input duration.")
        if train and draws is None:
            draws = self.draw_train(generator, f_dim, t_dim)
        if train and draws.seed is None and (
                cfg.drop_rate or cfg.attn_drop_rate or cfg.drop_path_rate):
            raise ValueError("train draws without a seed: the config's "
                             "dropout / drop_path masks need one")
        off = draws.time_offset if train else 0
        x = x + _cast(self.time_new_pos_embed[:, :, :, off:off + t_dim], dt)
        x = x + _cast(self.freq_new_pos_embed[:, :, :f_dim], dt)

        # structured patchout (train only), then the static index sets;
        # index_select, whose backward is one index_add (advanced indexing
        # backpropagates through a sort)
        def keep(x, dim, idx):
            return x.index_select(dim, torch.as_tensor(idx, device=x.device))

        def keep_static(x, dim, idx):
            return x.index_select(dim, self._static_index(idx, x.device))

        if train and draws.keep_t is not None:
            x = keep(x, 3, draws.keep_t)
        if train and draws.keep_f is not None:
            x = keep(x, 2, draws.keep_f)
        kept = _static_keep_indices(
            x.shape[2], cfg.s_patchout_f_indices, cfg.s_patchout_f_interleaved)
        if kept is not None:
            x = keep_static(x, 2, kept)
        kept = _static_keep_indices(
            x.shape[3], cfg.s_patchout_t_indices, cfg.s_patchout_t_interleaved)
        if kept is not None:
            x = keep_static(x, 3, kept)

        # tokens flatten frequency-major, as the reference does
        x = x.flatten(2).transpose(1, 2)  # (B, N, E)
        if train and draws.keep_u is not None:
            x = keep(x, 1, draws.keep_u)
        pos = self.new_pos_embed  # tokens + pos in the storage dtype, cast
        cls = _cast(self.cls_token + pos[:, :1], dt).expand(b, -1, -1)
        dist = _cast(self.dist_token + pos[:, 1:2], dt).expand(b, -1, -1)
        x = torch.cat([cls, dist, x], dim=1)

        lay = self.layout
        seeds = self.block_seeds(draws if train else None)
        if train and draws.seed is not None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(draws.seed)
            x = dropout(x, cfg.drop_rate, gen,
                        () if lay is None else lay.rows(b))
        if forward_mode == "front":
            return x, x.shape[1]

        remat = train and cfg.remat and not return_self_attention
        # sequence parallelism: the stream between the blocks' regions is
        # this rank's token shard; full() gathers it where all is read
        n_tokens = x.shape[1]
        sp = lay is not None and lay.sp
        if sp:
            x = lay.split_tokens(x)

        def full(x):
            return lay.gather_tokens(x, n_tokens) if sp else x

        def run(i, x):
            return self.run_block(i, x, seeds[i], n_tokens, remat)

        if transformer_block == -1:
            layer_tokens = []
            tap = None
            for i in range(cfg.depth):
                x = run(i, x)
                if return_layer_tokens:
                    layer_tokens.append(full(x))
                if tap_block is not None and i == tap_block:
                    tap = self._block_embedding(full(x))
            out = self._heads(self.norm(full(x)))
            if tap_block is not None:
                return out + (tap,)
            if return_layer_tokens:
                return out + (tuple(layer_tokens),)
            return out

        # embedding tap (reference: models/maest.py:811-829); the attention
        # map tap opts out of remat, as in the JAX package
        for i in range(transformer_block):
            x = run(i, x)
        if return_self_attention:
            x = self.blocks[transformer_block](x, seeds[transformer_block],
                                               True, n_tokens)
        else:
            x = run(transformer_block, x)
        return None, self._block_embedding(full(x))

    def _static_index(self, idx: list, device) -> torch.Tensor:
        """A static patchout index set as a tensor resident on ``device``,
        made at its first use there: a forward captured in a CUDA graph
        copies nothing from the host."""
        key = (tuple(idx), torch.device(device))
        t = self._static_indices.get(key)
        if t is None:
            t = self._static_indices[key] = torch.tensor(idx, device=device)
        return t

    def block_seeds(self, draws: Optional[TrainDraws]) -> list:
        """Each block's dropout / drop_path seed of a train forward's
        ``draws`` (None: no masks)."""
        if draws is None or draws.seed is None:
            return [None] * self.cfg.depth
        return [draws.seed + 1 + i for i in range(self.cfg.depth)]

    def patch_grid(self, shape) -> tuple:
        """(F', T'): the patch grid of an input of ``shape`` (B, C, F, T)."""
        p, (sf, st) = self.cfg.patch_size, self.cfg.stride
        return (shape[2] - p) // sf + 1, (shape[3] - p) // st + 1

    def stream_length(self, shape, draws: Optional[TrainDraws] = None) -> int:
        """The length of the stream the front hands the blocks for an input
        of ``shape`` (B, C, F, T) and, in train mode, ``draws``."""
        cfg = self.cfg
        f_dim, t_dim = self.patch_grid(shape)
        if draws is not None and draws.keep_t is not None:
            t_dim = len(draws.keep_t)
        if draws is not None and draws.keep_f is not None:
            f_dim = len(draws.keep_f)
        n = (self._kept_len(f_dim, 0, cfg.s_patchout_f_indices,
                            cfg.s_patchout_f_interleaved)
             * self._kept_len(t_dim, 0, cfg.s_patchout_t_indices,
                              cfg.s_patchout_t_interleaved))
        if draws is not None and draws.keep_u is not None:
            n = len(draws.keep_u)
        return n + 2

    def run_block(self, i: int, x, seed: Optional[int] = None,
                  n_tokens: Optional[int] = None, remat: bool = False,
                  layout: Optional[Layout] = None):
        """Block ``i`` on ``x``; ``remat``: recomputed in the backward
        under the config's policy. ``layout``: the block runs under it
        (a pipeline microbatch's rows, which its masks are cut to), also
        when it is recomputed."""
        blk = self.blocks[i]
        fn = blk if layout is None else _LaidOut(blk, layout)
        if not remat:
            return fn(x, seed, False, n_tokens)
        ctx = {"full": None, "dots": _dots_contexts,
               "attn_out": _attn_out_contexts}[self.cfg.remat_policy]
        kw = {} if ctx is None else {"context_fn": ctx}
        return checkpoint(fn, x, seed, False, n_tokens, use_reentrant=False,
                          **kw)

    def set_layout(self, layout: Optional[Layout]) -> None:
        """Run under ``layout`` (None: one process). The parameters must
        already be the layout's (``parallel.mesh.shard_params``); the
        blocks another pipeline stage holds are skipped."""
        self.layout = layout
        for blk in self.blocks:
            if isinstance(blk, Block):
                blk.attn.layout = layout
                blk.mlp.layout = layout

    @staticmethod
    def _block_embedding(x: torch.Tensor) -> torch.Tensor:
        """[cls | dist | mean(patch tokens)] (2304-d for ViT-B)."""
        return torch.cat([x[:, 0], x[:, 1], x[:, 2:].mean(dim=1)], dim=1)

    def _heads(self, x: torch.Tensor):
        """Classifier heads (reference: models/maest.py:570-582, 905-933)."""
        cls, dist = x[:, 0], x[:, 1]
        features = (cls + dist) / 2
        if self.cfg.distilled_type == "mean":
            return self.head(features), features
        return self.head(cls), self.head_dist(dist), features
