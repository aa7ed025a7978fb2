"""Weights in and out of the port's ``MAESTNet``.

* ``state_from_jax_params`` — the JAX package's param tree (nested
  numpy arrays) -> this port's ``state_dict`` (port of
  ``maest_tpu/packaging/hf_ast.py::jax_to_torch_state``).
* ``train_state_from_jax`` — a JAX ``TrainState`` (parameters, Adam
  moments and count, SWA, accumulator) -> the port's ``TrainState``.
* ``load_checkpoint_file`` / ``normalize_state`` / ``load_into`` — a
  ``.ckpt``/``.pt``/``.safetensors`` file (Lightning, plain or HF AST
  layout) -> SWA or live weights -> the module, with the JAX package's ``strict=False`` semantics: missing keys
  keep their initialization, a head whose class count differs is skipped.

The numpy helpers ``strip_prefix``, ``load_torch_checkpoint`` and
``adapt_pos_embeds`` (pos-embed grid retargeting and ImageNet table
splitting, with the torch-equivalent bicubic resize they use) are copies of
those of ``maest_tpu/checkpoints/convert.py``, their arithmetic unchanged:
the port keeps its own, so that it reads nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, Mapping

import numpy as np
import torch

if TYPE_CHECKING:  # an import at run time would cycle through models/vit.py
    from ..models.config import MAESTConfig


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


def _cubic_weights_1d(in_size: int, out_size: int):
    """Sample positions + 4-tap weights for one axis (align_corners=False)."""
    if in_size == out_size:
        return None
    scale = in_size / out_size
    out = np.arange(out_size, dtype=np.float64)
    center = (out + 0.5) * scale - 0.5
    base = np.floor(center).astype(np.int64)
    frac = center - base
    # taps at base-1 .. base+2
    taps = base[:, None] + np.arange(-1, 3)[None, :]
    dist = taps - center[:, None]
    w = _cubic_kernel(dist)
    w = w / w.sum(axis=1, keepdims=True)
    taps = np.clip(taps, 0, in_size - 1)
    return taps, w


def _bicubic_impl(arr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    out = arr
    hw = _cubic_weights_1d(arr.shape[-2], out_h)
    if hw is not None:
        taps, wts = hw  # (out_h, 4)
        gathered = out[..., taps, :]  # (..., out_h, 4, W)
        out = (gathered * wts[..., None]).sum(axis=-2)
    ww = _cubic_weights_1d(arr.shape[-1], out_w)
    if ww is not None:
        taps, wts = ww  # (out_w, 4)
        gathered = out[..., taps]  # (..., H', out_w, 4)
        out = (gathered * wts).sum(axis=-1)
    return out


def strip_prefix(state: Mapping[str, np.ndarray], swa_weights: bool = True
                 ) -> Dict[str, np.ndarray]:
    """Select SWA or live weights from a Lightning checkpoint state dict.

    Mirrors the reference's prefix strip (models/maest.py:1554-1562): with
    ``swa_weights`` the ``net_swa.`` prefix is removed (so SWA weights shadow
    the ``net.``-prefixed live weights); otherwise keys are kept as-is minus
    the ``net.`` prefix.
    """
    out: Dict[str, np.ndarray] = {}
    if swa_weights and any(k.startswith("net_swa.") for k in state):
        # live weights first, SWA overrides
        for k, v in state.items():
            if k.startswith("net."):
                out[k[len("net."):]] = v
        for k, v in state.items():
            if k.startswith("net_swa."):
                out[k[len("net_swa."):]] = v
        return out
    for k, v in state.items():
        if k.startswith("net."):
            out[k[len("net."):]] = v
        elif not k.startswith("net_swa."):
            out[k] = v
    return out


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    try:  # torch tensor
        return v.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(v)


def adapt_pos_embeds(state: Dict[str, np.ndarray], cfg: MAESTConfig
                     ) -> Dict[str, np.ndarray]:
    """Positional-embedding adaptation (reference: models/maest.py:1051-1102)."""
    grid_f, grid_t = cfg.grid_size
    if "time_new_pos_embed" not in state and "pos_embed" in state:
        # ImageNet-style joint pos embed -> decoupled tables
        posemb = np.asarray(state.pop("pos_embed"), dtype=np.float64)  # (1, N, E)
        ntok = cfg.num_tokens
        posemb_tok, posemb_grid = posemb[:, :ntok], posemb[0, ntok:]
        gs_old = int(math.sqrt(len(posemb_grid)))
        grid = posemb_grid.reshape(gs_old, gs_old, -1).transpose(2, 0, 1)  # (E,H,W)
        grid = _bicubic_impl(grid, grid_f, grid_t)  # (E, grid_f, grid_t)
        state["new_pos_embed"] = posemb_tok.astype(np.float32)
        state["freq_new_pos_embed"] = grid.mean(axis=2, keepdims=True)[None].astype(
            np.float32
        )  # (1,E,F,1)
        state["time_new_pos_embed"] = grid.mean(axis=1, keepdims=True)[None].astype(
            np.float32
        )  # (1,E,1,T)
    elif "time_new_pos_embed" in state:
        freq = np.asarray(state["freq_new_pos_embed"], dtype=np.float64)  # (1,E,F,1)
        time = np.asarray(state["time_new_pos_embed"], dtype=np.float64)  # (1,E,1,T)
        f_old, t_old = freq.shape[2], time.shape[3]
        if f_old != grid_f or t_old != grid_t:
            state["freq_new_pos_embed"] = _bicubic_impl(freq, grid_f, 1).astype(
                np.float32
            )
            state["time_new_pos_embed"] = _bicubic_impl(time, 1, grid_t).astype(
                np.float32
            )
    return state


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a torch ``.ckpt``/``.pt`` file into a numpy state dict."""
    try:
        # The restricted unpickler: checkpoint files can arrive via
        # auto-download (checkpoints/fetch.py), and a full unpickle executes
        # arbitrary code. Plain state-dict and DeiT release files load fine
        # this way; only Lightning ckpts carrying exotic hparams objects
        # need the legacy loader — which is EXPLICIT OPT-IN: an automatic
        # fallback would hand any file that fails the restricted loader
        # straight to the unsafe one, making the protection worthless.
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as err:
        import os

        if os.environ.get("MAEST_TPU_UNSAFE_LOAD") != "1":
            raise ValueError(
                f"restricted (weights_only) torch.load failed for {path}: "
                f"{err}\nA full unpickle executes arbitrary code from the "
                "file. If you trust this checkpoint (e.g. a Lightning ckpt "
                "with custom hparams classes), set MAEST_TPU_UNSAFE_LOAD=1 "
                "to allow the legacy loader."
            ) from err
        import logging

        logging.getLogger(__name__).warning(
            "weights_only torch.load failed for %s (%s); MAEST_TPU_UNSAFE_"
            "LOAD=1 set — falling back to the full unpickler", path, err)
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if (isinstance(obj, dict) and "model" in obj
            and not torch_is_tensor(obj["model"])):
        # deit release format {"model": state_dict}
        inner = obj["model"]
        if isinstance(inner, dict):
            obj = inner
    return {k: _to_numpy(v) for k, v in obj.items()}


def torch_is_tensor(v) -> bool:
    return hasattr(v, "detach") and hasattr(v, "cpu")


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


def normalize_state(state: Mapping[str, object], cfg: MAESTConfig, *,
                    swa_weights: bool) -> dict[str, np.ndarray]:
    """A raw state dict -> MAEST key layout: Lightning checkpoints
    (``net.``/``net_swa.`` prefixes; SWA weights shadow the live ones when
    ``swa_weights``), plain MAEST state dicts, and HF AST exports (the
    ``mtg-upf/discogs-maest-*`` hub layout, told by their key prefix and
    inverted by ``packaging.hf_ast.from_hf_ast_state`` at ``cfg``'s
    frequency grid)."""
    if any(str(k).startswith("audio_spectrogram_transformer.") for k in state):
        from ..packaging.hf_ast import from_hf_ast_state

        return from_hf_ast_state(state, cfg)
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


def _find(tree, *attrs):
    """The first node of a (nested tuple / namedtuple) optax state with all
    of ``attrs``, or None."""
    if all(hasattr(tree, a) for a in attrs):
        return tree
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            hit = _find(sub, *attrs)
            if hit is not None:
                return hit
    return None


def train_state_from_jax(state, cfg, tx, *, dtype: torch.dtype = torch.float32,
                         device="cpu"):
    """A JAX ``TrainState`` (numpy leaves) -> the port's ``TrainState``.

    The parameters, the SWA parameters, the Adam moments ``mu``/``nu`` and
    the ``optax.MultiSteps`` accumulator all go through
    ``state_from_jax_params`` (one key and transpose map); the Adam update
    count, ``step``, ``swa_n`` and the accumulator's ``mini_step`` carry
    over. ``tx`` is the port's optimizer recipe (``make_optimizer``); the
    module computes in ``dtype`` over float32 parameters on ``device``."""
    from ..models.vit import MAESTNet
    from ..train.state import TrainState

    net = MAESTNet(cfg, dtype=dtype, param_dtype=torch.float32)
    load_into(net, state_from_jax_params(state.params, cfg))
    net.to(device)
    swa = dict(state.swa_params) if state.swa_params else {}
    out = TrainState.create(net, tx, with_swa=bool(swa))
    out.step = int(np.asarray(state.step))
    out.swa_n = int(np.asarray(state.swa_n))
    named = dict(net.named_parameters())
    with torch.no_grad():
        if swa:
            for k, v in state_from_jax_params(swa, cfg).items():
                out.swa_params[k].copy_(v)
        multi = _find(state.opt_state, "mini_step", "acc_grads")
        if multi is not None and out.accum:
            out.mini_step = int(np.asarray(multi.mini_step))
            for k, v in state_from_jax_params(multi.acc_grads, cfg).items():
                out.accum[k].copy_(v)
    adam = _find(state.opt_state, "mu", "nu", "count")
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in opt_state")
    out.count = int(np.asarray(adam.count))
    if out.count:
        mu = state_from_jax_params(adam.mu, cfg)
        nu = state_from_jax_params(adam.nu, cfg)
        for k, m in mu.items():
            p = named[k]
            out.optimizer.state[p] = {
                "step": torch.tensor(float(out.count)),
                "exp_avg": m.to(p.device),
                "exp_avg_sq": nu[k].to(p.device),
            }
    return out
