"""Log-mel front-end, port of ``maest_tpu/dsp/mel.py``.

    Spectrogram(n_fft=512, win_length=512, hop_length=256, power=2)
    -> MelScale(96 mels, sr=16000, slaney norm & scale)
    -> log10(1 + 10000 * mel)
    -> (x - 2.06755686098554) / (1.268292820667291 * 2)

Reflect padding and half-overlap framing are plain tensor ops (hop is half
the window, so every frame is two consecutive hop-sized blocks side by
side). All frames of a batch then go through one call of
``ops.mel_kernel.fused_logmel_from_frames``: the CUDA kernel on the card,
its plain PyTorch version on the CPU. The output is always float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.mel_kernel import fused_logmel_from_frames

SAMPLE_RATE = 16000
N_FFT = 512
WIN_LENGTH = 512
HOP_LENGTH = 256
N_MELS = 96
# Discogs dataset statistics (reference: models/maest.py:37-38).
NORM_MEAN = 2.06755686098554
NORM_STD = 1.268292820667291


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = SAMPLE_RATE
    n_fft: int = N_FFT
    win_length: int = WIN_LENGTH
    hop_length: int = HOP_LENGTH
    n_mels: int = N_MELS
    norm_mean: float = NORM_MEAN
    norm_std: float = NORM_STD
    compression_scale: float = 10000.0


def num_frames(n_samples: int, cfg: MelConfig = MelConfig()) -> int:
    """STFT frame count for a centered transform (torch.stft center=True)."""
    return 1 + n_samples // cfg.hop_length


def frame_waveforms(waveform: torch.Tensor,
                    cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """(B, n) waveforms -> (B, T, n_fft) float32 frames, T = 1 + n // hop:
    reflect pad by n_fft // 2 on both sides (torch.stft center=True), then
    half-overlap framing without a gather."""
    n = waveform.shape[-1]
    hop, n_fft = cfg.hop_length, cfg.n_fft
    if cfg.win_length != n_fft or hop * 2 != n_fft:
        raise NotImplementedError("front-end assumes win == n_fft == 2 * hop")
    if n <= n_fft // 2:
        # reflect padding of n_fft // 2 is undefined for n <= n_fft // 2
        raise ValueError(
            f"waveform too short: {n} samples (need > {n_fft // 2})")
    pad = n_fft // 2
    padded = F.pad(waveform.to(torch.float32)[:, None, :], (pad, pad),
                   mode="reflect")[:, 0]
    t = 1 + n // hop
    # the last frame ends at (t + 1) * hop <= n + n_fft = len(padded)
    blocks = padded[:, :(t + 1) * hop].reshape(-1, t + 1, hop)
    return torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=2)


def log_mel_spectrogram(waveform: torch.Tensor, cfg: MelConfig = MelConfig(),
                        *, normalize: bool = True) -> torch.Tensor:
    """``(n,)`` or ``(B, n)`` waveform -> ``(n_mels, T)`` / ``(B, n_mels, T)``
    float32 log-mel, T = 1 + n // hop."""
    if waveform.ndim not in (1, 2):
        raise ValueError(
            f"waveform must be 1-D or 2-D, got shape {tuple(waveform.shape)}")
    frames = frame_waveforms(waveform.reshape(-1, waveform.shape[-1]), cfg)
    b, t, _ = frames.shape
    logmel = fused_logmel_from_frames(
        frames.reshape(b * t, cfg.n_fft), n_fft=cfg.n_fft, n_mels=cfg.n_mels,
        sample_rate=cfg.sample_rate,
        compression_scale=cfg.compression_scale, norm_mean=cfg.norm_mean,
        norm_std=cfg.norm_std, normalize=normalize)
    logmel = logmel.reshape(b, t, cfg.n_mels).transpose(1, 2)
    return logmel[0] if waveform.ndim == 1 else logmel
