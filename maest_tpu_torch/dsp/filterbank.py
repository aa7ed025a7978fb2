"""Slaney mel filterbank construction (host-side, numpy).

A copy of ``maest_tpu/dsp/filterbank.py``, its values unchanged: the port keeps
its own, so that it reads nothing of the JAX package.

Matches torchaudio ``MelScale(n_mels=96, sample_rate=16000, n_stft=257,
norm="slaney", mel_scale="slaney")`` used by the reference inference
front-end (reference: models/helpers/melspectrogram.py:36-42) and the
Essentia extractor settings (reference: helpers/melspectrogram_extractor.py:15-30).

The filterbank is a static (n_freqs, n_mels) matrix computed once on the host
with float64 and cached; the device-side mel projection is a single matmul.
"""

from __future__ import annotations

import functools

import numpy as np

# Slaney-style mel scale: linear below 1 kHz, logarithmic above.
_F_MIN = 0.0
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = (_MIN_LOG_HZ - _F_MIN) / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = (freq - _F_MIN) / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_MIN + _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_freqs: int = 257,
    n_mels: int = 96,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: float | None = None,
    norm: str = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_freqs, n_mels)``, float32.

    Triangles are defined by n_mels+2 mel-spaced corner frequencies; with
    ``norm="slaney"`` each filter is scaled to unit area (2 / bandwidth).
    """
    if f_max is None:
        f_max = sample_rate / 2.0

    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)

    mel_min = hz_to_mel_slaney(f_min)
    mel_max = hz_to_mel_slaney(f_max)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    f_pts = mel_to_hz_slaney(mel_pts)

    # Triangular responses via slope differences (same construction as
    # torchaudio.functional.melscale_fbanks).
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down_slopes = -slopes[:, :-2] / f_diff[None, :-1]
    up_slopes = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]

    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cosine/sine matrices, each ``(n_fft, n_fft // 2 + 1)`` float32.

    ``power = (frames @ C)**2 + (frames @ S)**2`` equals ``|rfft(frames)|**2``.
    On TPU these two matmuls ride the MXU, which beats a generic FFT lowering
    at n_fft=512.
    """
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int = 512) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default), float32."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)
