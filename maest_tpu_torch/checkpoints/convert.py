"""Weights in and out of the port's ``MAESTNet``.

* ``state_from_jax_params`` — the JAX package's param tree (nested
  numpy arrays) -> this port's ``state_dict`` (port of
  ``maest_tpu/packaging/hf_ast.py::jax_to_torch_state``).
* ``load_checkpoint_file`` / ``normalize_state`` / ``load_into`` — a
  ``.ckpt``/``.pt``/``.safetensors`` file -> SWA or live weights -> the
  module, with the JAX package's ``strict=False`` semantics: missing keys
  keep their initialization, a head whose class count differs is skipped.

The numpy helpers ``strip_prefix``, ``load_torch_checkpoint`` and
``adapt_pos_embeds`` (pos-embed grid retargeting and ImageNet table
splitting) are the JAX package's own, from ``maest_tpu/checkpoints/
convert.py``, loaded without JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .._reference import load

_convert = load("checkpoints.convert")

adapt_pos_embeds = _convert.adapt_pos_embeds
load_torch_checkpoint = _convert.load_torch_checkpoint
strip_prefix = _convert.strip_prefix


def state_from_jax_params(params: Mapping[str, object], cfg
                          ) -> dict[str, torch.Tensor]:
    """JAX param tree -> the port's state dict (float32 CPU tensors).

    Dense kernels go (in, out) -> (out, in); the patch conv HWIO -> OIHW;
    pos-embed tables regain their broadcast singleton dims. Keys follow
    the tree: ``dist_token``, the head and ``head_dist`` appear only where
    the tree has them."""
    if "patch_embed_freq_kernel" in params:
        raise NotImplementedError(
            "per-freq patch embedding is not ported yet (ROADMAP queue 1)")
    p = params
    out: dict[str, np.ndarray] = {}
    e = cfg.embed_dim

    def dense(prefix, leaf):
        out[prefix + ".weight"] = np.asarray(leaf["kernel"]).T
        if "bias" in leaf:
            out[prefix + ".bias"] = np.asarray(leaf["bias"])

    def layernorm(prefix, leaf):
        out[prefix + ".weight"] = np.asarray(leaf["scale"])
        out[prefix + ".bias"] = np.asarray(leaf["bias"])

    out["cls_token"] = np.asarray(p["cls_token"]).reshape(1, 1, e)
    if "dist_token" in p:
        out["dist_token"] = np.asarray(p["dist_token"]).reshape(1, 1, e)
    out["new_pos_embed"] = np.asarray(p["new_pos_embed"]).reshape(1, -1, e)
    out["freq_new_pos_embed"] = np.asarray(p["freq_new_pos_embed"]).T[
        None, :, :, None]  # (1, E, F, 1)
    out["time_new_pos_embed"] = np.asarray(p["time_new_pos_embed"]).T[
        None, :, None, :]  # (1, E, 1, T)
    out["patch_embed.proj.weight"] = np.asarray(
        p["patch_embed_proj"]["kernel"]).transpose(3, 2, 0, 1)
    out["patch_embed.proj.bias"] = np.asarray(p["patch_embed_proj"]["bias"])
    for i in range(cfg.depth):
        blk = p[f"blocks_{i}"]
        layernorm(f"blocks.{i}.norm1", blk["norm1"])
        layernorm(f"blocks.{i}.norm2", blk["norm2"])
        dense(f"blocks.{i}.attn.qkv", blk["attn"]["qkv"])
        dense(f"blocks.{i}.attn.proj", blk["attn"]["proj"])
        dense(f"blocks.{i}.mlp.fc1", blk["mlp"]["fc1"])
        dense(f"blocks.{i}.mlp.fc2", blk["mlp"]["fc2"])
    layernorm("norm", p["norm"])
    if "head_norm" in p:
        layernorm("head.0", p["head_norm"])
        dense("head.1", p["head_linear"])
    if "head_dist" in p:
        dense("head_dist", p["head_dist"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def load_checkpoint_file(path: str) -> dict[str, np.ndarray]:
    """Raw state dict of a ``.ckpt``/``.pt`` (restricted torch unpickler) or
    ``.safetensors`` file."""
    if str(path).endswith(".safetensors"):
        try:
            from safetensors.numpy import load_file
        except ImportError as err:
            raise ImportError(
                "loading .safetensors files needs the 'safetensors' package"
            ) from err
        return load_file(path)
    return load_torch_checkpoint(str(path))


def normalize_state(state: Mapping[str, object], *, swa_weights: bool
                    ) -> dict[str, np.ndarray]:
    """Lightning/plain MAEST state dict -> MAEST key layout (SWA weights
    shadow the live ones when ``swa_weights``)."""
    if any(str(k).startswith("audio_spectrogram_transformer.") for k in state):
        raise NotImplementedError(
            "HF AST-layout checkpoints are not ported yet (ROADMAP queue 1, "
            "checkpoints: from_hf_ast_state)")
    return strip_prefix(state, swa_weights=swa_weights)


def load_into(net: torch.nn.Module, state: Mapping[str, object], *,
              discard_head: bool = False) -> torch.nn.Module:
    """Copy a MAEST-layout state dict into ``net`` in place.

    Pos-embed tables are retargeted to the model's grid first. Keys the
    state lacks keep the module's initialization; the heads load only when
    their class count matches and ``discard_head`` is off. Any other shape
    mismatch raises."""
    cfg = net.cfg
    state = adapt_pos_embeds(
        {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
         for k, v in state.items()}, cfg)
    w = state.get("patch_embed.proj.weight")
    if w is not None and w.ndim < 4:  # legacy linear patchify
        state["patch_embed.proj.weight"] = w.reshape(
            cfg.embed_dim, -1, cfg.patch_size, cfg.patch_size)
    head = state.get("head.1.weight")
    head_ok = (not discard_head and head is not None
               and head.shape[0] == cfg.num_classes)
    with torch.no_grad():
        for k, t in net.state_dict().items():
            if k not in state or (k.startswith("head") and not head_ok):
                continue
            v = np.asarray(state[k], np.float32)
            if v.shape != tuple(t.shape):
                raise ValueError(f"shape mismatch for {k}: {v.shape} vs "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(v))
    return net
