"""Model surgery on (state dict, config) pairs, port of
``maest_tpu/models/surgery.py``.

The reference's in-place surgeries (reference: models/maest.py:1391-1438)
become pure functions returning a new state dict and config, on the port's
key layout (``MAESTNet.state_dict()``):

  * ``fix_embedding_layer`` — swap the patch embedding. ``"freq_embed"``
    turns the shared conv into per-frequency-row projections that start
    from the shared weights (reference: ``replacePatchEmbedFreq``,
    models/maest.py:334-343). ``"overlap"`` and ``"am_keepconv"`` name
    classes the reference does not define either (models/maest.py:1395-1397)
    and are refused.
  * ``lighten_model`` — remove or stride transformer blocks (reference:
    models/maest.py:1403-1438): ``cut_depth > 0`` keeps block 0 and
    blocks[cut_depth+1:]; ``cut_depth < 0`` keeps the first, every
    ``-cut_depth``-th middle block and the last; ``remove_n_blocks`` drops
    the last n. Blocks are renumbered ``blocks.0..new_depth-1``.

The functions take numpy arrays or tensors and keep the values' type.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np

from .config import MAESTConfig

State = Dict[str, object]

_BLOCK = re.compile(r"^blocks\.(\d+)\.(.+)$")


def _grid_f(cfg: MAESTConfig) -> int:
    return (cfg.img_size[0] - cfg.patch_size) // cfg.stride[0] + 1


def _numpy(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else v


def per_freq_params_from_conv(state: Mapping[str, object], cfg: MAESTConfig
                              ) -> Tuple[State, MAESTConfig]:
    """The shared patch conv as per-frequency-row projections.

    Every row starts from the shared conv's weights, as the reference's
    ``old_proj.state_dict()`` copy does (models/maest.py:295-298). The
    kernel (E, C, P, P) flattens to (C*P*P, E) with features in
    ``lax.conv_general_dilated_patches``' order (channel, kernel h, w)."""
    if "patch_embed.proj.weight" not in state:
        raise KeyError("state has no shared patch_embed.proj to convert")
    kern = state["patch_embed.proj.weight"]
    bias = state["patch_embed.proj.bias"]
    torch_values = not isinstance(kern, np.ndarray)
    kern, bias = np.asarray(_numpy(kern)), np.asarray(_numpy(bias))
    e = kern.shape[0]
    flat = kern.reshape(e, -1).T  # (C*P*P, E)
    g = _grid_f(cfg)
    rows = np.broadcast_to(flat[None], (g,) + flat.shape).copy()
    biases = np.broadcast_to(bias[None], (g, e)).copy()
    if torch_values:
        import torch

        rows, biases = torch.from_numpy(rows), torch.from_numpy(biases)
    out = {k: v for k, v in state.items() if not k.startswith(
        "patch_embed.proj.")}
    out["patch_embed.freq_kernel"] = rows
    out["patch_embed.freq_bias"] = biases
    return out, cfg.replace(per_freq_patch_embed=True)


def fix_embedding_layer(state: Mapping[str, object], cfg: MAESTConfig,
                        embed: str = "default") -> Tuple[State, MAESTConfig]:
    """Patch-embedding swap dispatch (reference: models/maest.py:1391-1400)."""
    if embed == "default":
        return dict(state), cfg
    if embed == "freq_embed":
        return per_freq_params_from_conv(state, cfg)
    if embed in ("overlap", "am_keepconv"):
        raise NotImplementedError(
            f"embed={embed!r} references classes that are undefined in the "
            "reference implementation as well (models/maest.py:1395-1397)")
    raise ValueError(f"unknown embed mode {embed!r}")


def _kept_block_order(depth: int, cut_depth: int) -> list:
    if cut_depth == 0:
        return list(range(depth))
    if cut_depth < 0:
        middle = list(range(1, depth - 1))[::-cut_depth]
        return [0] + middle + [depth - 1]
    if depth < cut_depth + 2:
        raise ValueError(
            f"cut_depth for a ViT with {depth} layers should be between 1 "
            f"and {depth - 2}")
    return [0] + list(range(cut_depth + 1, depth))


def lighten_model(state: Mapping[str, object], cfg: MAESTConfig, *,
                  cut_depth: int = 0, remove_n_blocks: int = 0
                  ) -> Tuple[State, MAESTConfig]:
    """Block removal / striding (reference: models/maest.py:1403-1438)."""
    keep = _kept_block_order(cfg.depth, cut_depth)
    if remove_n_blocks:
        if not 0 < remove_n_blocks < len(keep):
            # a too-large count would slice with a negative index and keep
            # most blocks instead of failing
            raise ValueError(
                f"remove_n_blocks={remove_n_blocks} out of range: "
                f"{len(keep)} blocks present")
        keep = keep[: len(keep) - remove_n_blocks]
    if not keep:
        raise ValueError("surgery removed every block")
    new_index = {old: new for new, old in enumerate(keep)}
    out: State = {}
    for k, v in state.items():
        m = _BLOCK.match(k)
        if m is None:
            out[k] = v
        elif int(m.group(1)) in new_index:
            out[f"blocks.{new_index[int(m.group(1))]}.{m.group(2)}"] = v
    return out, cfg.replace(depth=len(keep))
