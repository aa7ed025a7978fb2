"""Public inference API, port of ``maest_tpu/api.py``.

``get_maest`` / ``MAEST.__call__`` / ``MAEST.predict_labels`` keep the JAX
package's input dispatch:

  rank 1            waveform -> log-mel -> chunked into a batch of windows
  rank 2 (wave)     batch of waveforms -> log-mel per row
  rank 2 (melspec)  (96, T) mel -> chunked into a batch of windows
  rank 3            (B, 96, T) mel -> channel dim added
  rank 4            (B, 1, 96, T) passthrough

Everything runs eagerly on ``device`` under ``torch.inference_mode()``.
Outputs are tensors on that device; ``predict_labels`` returns numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .checkpoints.convert import load_checkpoint_file, load_into, normalize_state
from .dsp import log_mel_spectrogram
from .labels import labels_for
from .models.config import MAESTConfig
from .models.registry import ARCHS, build_config, cached_checkpoint_path
from .models.vit import MAESTNet


class MAEST:
    """Inference wrapper holding a config and a ``MAESTNet`` on one device."""

    def __init__(self, cfg: MAESTConfig, net: MAESTNet):
        self.cfg = cfg
        self.net = net.eval()
        self.labels = labels_for(cfg.num_classes)

    @property
    def device(self) -> torch.device:
        return self.net.cls_token.device

    @property
    def dtype(self) -> torch.dtype:
        return self.net.dtype

    @property
    def img_size(self) -> tuple[int, int]:
        return self.cfg.img_size

    def melspectrogram(self, waveform) -> torch.Tensor:
        """Log-mel front-end, float32 on the model's device
        (reference: models/helpers/melspectrogram.py:47-60)."""
        with torch.inference_mode():
            return log_mel_spectrogram(torch.as_tensor(waveform,
                                                       device=self.device))

    def _chunk_melspec(self, x: torch.Tensor) -> torch.Tensor:
        """Cut a (96, T) mel into a batch of (1, 96, img_t) windows; the
        remainder past the last whole window is dropped (reference:
        models/maest.py:868-888)."""
        img_f, img_t = self.cfg.img_size
        if x.shape[1] >= img_t:
            n = x.shape[1] // img_t
            x = x[:, :n * img_t].reshape(img_f, n, img_t).transpose(0, 1)
            return x[:, None]
        return x[None, None]

    def _prepare(self, x, melspectrogram_input: bool) -> torch.Tensor:
        """Input dispatch -> (B, 1, 96, T) float32 on the model's device."""
        if isinstance(x, (list, tuple)) or not hasattr(x, "shape"):
            raise TypeError("Input must be an array (numpy or torch tensor)")
        x = torch.as_tensor(x, device=self.device)
        if x.numel() == 0:
            raise ValueError("Input tensor must not be empty")
        if not x.is_floating_point():
            # int16 is s16 PCM: decode to [-1, 1) as the serving path does;
            # other integer dtypes are ambiguous (int32 PCM? indices?)
            if x.dtype != torch.int16:
                raise TypeError(
                    f"integer input dtype {x.dtype} is ambiguous — pass a "
                    "float waveform in [-1, 1] (or int16 s16 PCM)")
            x = x.to(torch.float32) / 32768.0

        if x.ndim == 1:
            if melspectrogram_input:
                raise ValueError(
                    "Input is 1D, but melspectrogram_input is True; not "
                    "supported.")
            return self._chunk_melspec(log_mel_spectrogram(x))
        if x.ndim == 2 and melspectrogram_input:
            return self._chunk_melspec(x)
        if x.ndim == 2:
            return log_mel_spectrogram(x)[:, None]
        if x.ndim == 3:
            return x[:, None]
        if x.ndim != 4:
            raise ValueError(f"unsupported input rank {x.ndim}")
        return x

    def __call__(self, x, transformer_block: int = -1,
                 return_self_attention: bool = False,
                 melspectrogram_input: bool = False):
        """Forward pass; returns (logits, features) / (None, embeddings) /
        (logits_cls, logits_dist, features) per ``distilled_type`` and
        ``transformer_block`` (reference: models/maest.py:831-933)."""
        with torch.inference_mode():
            x = self._prepare(x, melspectrogram_input)
            return self.net(x, transformer_block=transformer_block,
                            return_self_attention=return_self_attention)

    def forward(self, *args, **kwargs):
        """Alias of ``__call__`` (reference user code calls
        ``model.forward(x, ...)``, models/maest.py:831)."""
        return self(*args, **kwargs)

    def predict_labels(self, x):
        """Sigmoid activations averaged over the chunk axis + label list
        (reference: models/maest.py:935-939)."""
        logits = self(x)[0]
        with torch.inference_mode():
            acts = torch.sigmoid(logits.float()).mean(dim=0)
        return acts.cpu().numpy(), self.labels


def get_maest(
    arch: str = "discogs-maest-30s-pw-129e",
    pretrained: bool = True,
    n_classes: Optional[int] = None,
    in_channels: int = 1,
    stride_f: int = 10,
    stride_t: int = 10,
    input_f: int = 96,
    input_t: Optional[int] = None,
    u_patchout: int = 0,
    s_patchout_t: int = 0,
    s_patchout_f: int = 0,
    s_patchout_f_indices: tuple = (),
    s_patchout_f_interleaved: int = 0,
    s_patchout_t_indices: tuple = (),
    s_patchout_t_interleaved: int = 0,
    distilled_type: str = "mean",
    checkpoint: Optional[str] = None,
    checkpoint_swa_weights: bool = True,
    checkpoint_discard_head: bool = False,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    seed: int = 0,
    embed_dim: int = 768,
    depth: int = 12,
    num_heads: int = 12,
    remat: bool = False,
    remat_policy: str = "full",
    attention_quant: str = "none",
    attention_bwd_quant: str = "none",
) -> MAEST:
    """Build a MAEST model on ``device``, optionally loading weights.

    Weights are initialized from ``torch.Generator().manual_seed(seed)``.
    ``pretrained=True`` reads the released checkpoint from the local cache
    directory (``$MAEST_TPU_CACHE``, default ``~/.cache/maest_tpu``) and
    raises ``FileNotFoundError`` when it is absent; ``checkpoint=`` loads an
    explicit ``.ckpt``/``.pt``/``.safetensors`` file. ``device="cuda"`` on
    a machine without a card raises; nothing moves to the CPU silently.
    """
    cfg = build_config(
        arch, n_classes=n_classes, in_channels=in_channels,
        stride_f=stride_f, stride_t=stride_t, input_f=input_f,
        input_t=input_t, u_patchout=u_patchout, s_patchout_t=s_patchout_t,
        s_patchout_f=s_patchout_f, s_patchout_f_indices=s_patchout_f_indices,
        s_patchout_f_interleaved=s_patchout_f_interleaved,
        s_patchout_t_indices=s_patchout_t_indices,
        s_patchout_t_interleaved=s_patchout_t_interleaved,
        distilled_type=distilled_type, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, remat=remat, remat_policy=remat_policy,
        attention_quant=attention_quant,
        attention_bwd_quant=attention_bwd_quant,
    )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch finds no CUDA "
                           "device")
    gen = torch.Generator().manual_seed(seed)
    net = MAESTNet(cfg, dtype=dtype, generator=gen)

    if pretrained:
        path = cached_checkpoint_path(ARCHS[arch])
        if not path.exists():
            raise FileNotFoundError(
                f"pretrained weights for {arch} not found at {path}. Download "
                f"{ARCHS[arch].url} into the cache dir (or set "
                "MAEST_TPU_CACHE); the port does not fetch them yet.")
        load_into(net, normalize_state(load_checkpoint_file(str(path)),
                                       swa_weights=True))
    if checkpoint:
        load_into(net, normalize_state(load_checkpoint_file(checkpoint),
                                       swa_weights=checkpoint_swa_weights),
                  discard_head=checkpoint_discard_head)
    return MAEST(cfg, net.to(device))
