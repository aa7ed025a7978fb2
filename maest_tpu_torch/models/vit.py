"""MAEST ViT, eval mode, port of ``maest_tpu/models/vit.py``.

Parameter names follow the torch layout of the released checkpoints
(``blocks.{i}.attn.qkv.weight``, ``head.0``/``head.1``, ``head_dist``, ...),
so a released state dict loads with a prefix strip alone. The module
takes NCHW ``(B, 1, F, T)`` spectrograms; the JAX module takes NHWC.

Numerics tiers, as in the JAX package: float32 is the parity tier (exact
erf GELU, full-fp32 patch projection); bfloat16 is the production tier
(tanh GELU). Attention goes through ``ops.attention.flash_attention``:
the CUDA kernel on the card, the plain version on the CPU.

Not ported yet, and refused with ``NotImplementedError``: the training
forward (patchout, dropout, drop_path, remat, the random time pos-embed
crop), ``forward_mode`` front/tail, mesh and sequence parallelism, and the
per-frequency patch embedding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import flash_attention
from .config import MAESTConfig

# timm trunc_normal_(std=0.02) for dense kernels; the pos embeds / tokens
# use the std-corrected draw the JAX package uses (0.02 / 0.8796...)
_DENSE_STD = 0.02
_POS_STD = 0.02 / 0.87962566103423978


def _gelu_mode(cfg: MAESTConfig, dtype: torch.dtype) -> str:
    mode = cfg.gelu_approx
    if mode == "auto":
        mode = "tanh" if dtype == torch.bfloat16 else "exact"
    if mode not in ("exact", "tanh"):
        raise ValueError(f"unknown gelu_approx {cfg.gelu_approx!r}")
    return "none" if mode == "exact" else "tanh"


class Mlp(nn.Module):
    """Transformer MLP (reference: models/maest.py:183-208)."""

    def __init__(self, dim: int, hidden: int, gelu: str):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.gelu = gelu  # "none" = exact erf, "tanh" = approximation

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.gelu))


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection (reference:
    models/maest.py:346-378). q, k and v are strided views of the qkv
    output; the kernel reads them in place."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 quant: str = "none"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed_dim {dim} not divisible by num_heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.quant = quant
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, c // self.num_heads)
        out = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              quant=self.quant)
        return self.proj(out.reshape(b, n, c))


class Block(nn.Module):
    """Pre-LN transformer block (reference: models/maest.py:381-420)."""

    def __init__(self, cfg: MAESTConfig, gelu: str):
        super().__init__()
        e = cfg.embed_dim
        self.norm1 = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
        self.attn = Attention(e, cfg.num_heads, cfg.qkv_bias,
                              cfg.attention_quant)
        self.norm2 = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(e, int(e * cfg.mlp_ratio), gelu)

    def forward(self, x, return_self_attention: bool = False):
        if return_self_attention:
            return self.attn(self.norm1(x))
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Patch projection, computed as im2col + matmul. cuDNN would run a
    float32 convolution in TF32 by default (~1e-3 relative); a float32
    matmul stays full fp32, which the parity tier needs, and the global
    backend flags stay untouched."""

    def __init__(self, cfg: MAESTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.stride)

    def forward(self, x):
        w, stride = self.proj.weight, self.proj.stride
        p = w.shape[-1]
        f_out = (x.shape[2] - p) // stride[0] + 1
        t_out = (x.shape[3] - p) // stride[1] + 1
        cols = F.unfold(x, p, stride=stride)  # (B, C*p*p, F'*T')
        out = w.flatten(1) @ cols + self.proj.bias[:, None]
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


class MAESTNet(nn.Module):
    """The MAEST transformer body + heads, eval mode.

    ``forward`` returns, depending on ``transformer_block``:
      * -1: per ``distilled_type`` — "mean": (logits, features),
        "separated": (logits_cls, logits_dist, features); with ``tap_block``
        the block embedding is appended, with ``return_layer_tokens`` the
        tuple of per-block token tensors;
      * >= 0: (None, [cls | dist | mean(tokens)] embedding of that block)
        (reference: models/maest.py:811-829).
    """

    def __init__(self, cfg: MAESTConfig, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.per_freq_patch_embed:
            raise NotImplementedError(
                "per_freq_patch_embed is not ported yet (ROADMAP queue 1)")
        if cfg.sequence_parallel:
            raise NotImplementedError(
                "sequence_parallel is not ported yet (ROADMAP queue 1, "
                "parallelism)")
        if cfg.attention_impl not in ("auto", "flash"):
            raise NotImplementedError(
                f"attention_impl={cfg.attention_impl!r}: the port always runs "
                "its attention kernel on CUDA tensors")
        if not cfg.distilled:
            raise NotImplementedError("non-distilled configs are not ported yet")
        if cfg.distilled_type not in ("mean", "separated"):
            raise ValueError(f"unknown distilled_type {cfg.distilled_type!r}; "
                             "expected 'mean' or 'separated'")
        self.cfg = cfg
        e = cfg.embed_dim
        gf, gt = cfg.grid_size
        gelu = _gelu_mode(cfg, dtype)

        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, e))
        self.dist_token = nn.Parameter(torch.empty(1, 1, e))
        self.new_pos_embed = nn.Parameter(torch.empty(1, cfg.num_tokens, e))
        self.freq_new_pos_embed = nn.Parameter(torch.empty(1, e, gf, 1))
        self.time_new_pos_embed = nn.Parameter(torch.empty(1, e, 1, gt))
        self.blocks = nn.ModuleList(Block(cfg, gelu) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
        # head norm keeps torch's default eps 1e-5 (reference:
        # models/maest.py:570-571 vs :499)
        self.head = nn.Sequential(nn.LayerNorm(e), nn.Linear(e, cfg.num_classes))
        self.head_dist = nn.Linear(e, cfg.num_classes)
        self.reset_parameters(generator)
        self.to(device=device, dtype=dtype)

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
        return self.cls_token.dtype

    def forward(self, x: torch.Tensor, *, train: bool = False,
                transformer_block: int = -1,
                return_self_attention: bool = False,
                return_layer_tokens: bool = False,
                tap_block: Optional[int] = None,
                forward_mode: str = "full"):
        cfg = self.cfg
        if train:
            raise NotImplementedError(
                "the training forward is not ported yet (ROADMAP queue 1, "
                "training step)")
        if forward_mode not in ("full", "front", "tail"):
            raise ValueError(f"unknown forward_mode {forward_mode!r}")
        if forward_mode != "full":
            raise NotImplementedError(
                "forward_mode front/tail (pipeline seams) is not ported yet")
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

        # --- patch embedding: (B, C, F, T) -> (B, E, F', T') ---
        x = self.patch_embed(x.to(self.dtype))
        b, e, f_dim, t_dim = x.shape
        grid_t = cfg.grid_size[1]
        if t_dim > grid_t:
            raise ValueError(
                f"input yields {t_dim} time patches but the time pos-embed "
                f"table has {grid_t}; reduce the input duration.")
        x = x + self.time_new_pos_embed[:, :, :, :t_dim]
        x = x + self.freq_new_pos_embed[:, :, :f_dim]

        kept = _static_keep_indices(
            f_dim, cfg.s_patchout_f_indices, cfg.s_patchout_f_interleaved)
        if kept is not None:
            x = x[:, :, kept, :]
        kept = _static_keep_indices(
            x.shape[3], cfg.s_patchout_t_indices, cfg.s_patchout_t_interleaved)
        if kept is not None:
            x = x[:, :, :, kept]

        # tokens flatten frequency-major, as the reference does
        x = x.flatten(2).transpose(1, 2)  # (B, N, E)
        cls = (self.cls_token + self.new_pos_embed[:, :1]).expand(b, -1, -1)
        dist = (self.dist_token + self.new_pos_embed[:, 1:2]).expand(b, -1, -1)
        x = torch.cat([cls, dist, x], dim=1)

        if transformer_block == -1:
            layer_tokens = []
            tap = None
            for i, blk in enumerate(self.blocks):
                x = blk(x)
                if return_layer_tokens:
                    layer_tokens.append(x)
                if tap_block is not None and i == tap_block:
                    tap = self._block_embedding(x)
            out = self._heads(self.norm(x))
            if tap_block is not None:
                return out + (tap,)
            if return_layer_tokens:
                return out + (tuple(layer_tokens),)
            return out

        # embedding tap (reference: models/maest.py:811-829)
        for i, blk in enumerate(self.blocks):
            if i == transformer_block:
                x = blk(x, return_self_attention)
                break
            x = blk(x)
        return None, self._block_embedding(x)

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
