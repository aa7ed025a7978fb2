"""HF-loadable MAEST feature extractor (ships inside exported model dirs).

The reference pushes a custom ``MAESTFeatureExtractor`` next to its hub
models (reference: packaging/push_to_hub.py:7,150-158 — the class lives
hub-side in ``maest.feature_extraction_maest``, not in the repo). This is
our equivalent: :func:`maest_tpu.packaging.hf_ast.save_pretrained` copies
THIS FILE into the export directory and points ``preprocessor_config.json``
at it via ``auto_map``, so

    AutoFeatureExtractor.from_pretrained(export_dir, trust_remote_code=True)

returns a working extractor, exactly like the released
``mtg-upf/discogs-maest-*`` hub repos.

IMPORTANT: this module must stay STANDALONE (numpy + transformers only —
no maest_tpu imports) because it is executed from the export directory.
The mel math below therefore re-states the front-end
(reference: models/helpers/melspectrogram.py:13-60):

    Spectrogram(n_fft=512, win=512, hop=256, power=2, center, reflect)
    -> MelScale(96 mels, sr 16000, slaney norm & scale)
    -> log10(1 + 10000 x) -> (x - mean) / (2 * std)

and must match ``maest_tpu.dsp.mel`` bit-for-policy; a parity test
(tests/test_hf_feature_extractor.py) enforces <1e-4 agreement.
"""

from __future__ import annotations

import numpy as np
from transformers.feature_extraction_sequence_utils import (
    SequenceFeatureExtractor,
)
from transformers.feature_extraction_utils import BatchFeature

__all__ = ["MAESTFeatureExtractor"]


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = freq / f_sp
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = f_sp * mels
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freqs,
    )


def _mel_filterbank(n_freqs, n_mels, sample_rate):
    """torchaudio ``melscale_fbanks(..., norm='slaney', mel_scale='slaney')``."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(0.0), _hz_to_mel_slaney(sample_rate / 2.0), n_mels + 2
    )
    f_pts = _mel_to_hz_slaney(mel_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
    return (fb * enorm[None, :]).astype(np.float64)


class MAESTFeatureExtractor(SequenceFeatureExtractor):
    """Waveform -> normalized log-mel features for MAEST/AST models.

    Returns ``input_values`` shaped ``(batch, max_length, num_mel_bins)``
    (the AST input layout), normalized then zero-padded/truncated to
    ``max_length`` time frames.
    """

    model_input_names = ["input_values"]

    def __init__(
        self,
        feature_size: int = 1,
        sampling_rate: int = 16000,
        n_fft: int = 512,
        hop_length: int = 256,
        num_mel_bins: int = 96,
        max_length: int = 1876,
        padding_value: float = 0.0,
        log_compression_scale: float = 10000.0,
        mean: float = 2.06755686098554,
        std: float = 1.268292820667291,
        return_attention_mask: bool = False,
        **kwargs,
    ):
        super().__init__(
            feature_size=feature_size,
            sampling_rate=sampling_rate,
            padding_value=padding_value,
            **kwargs,
        )
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.num_mel_bins = num_mel_bins
        self.max_length = max_length
        self.log_compression_scale = log_compression_scale
        self.mean = mean
        self.std = std
        self.return_attention_mask = return_attention_mask

    def _log_mel(self, wave: np.ndarray) -> np.ndarray:
        """(n_samples,) -> (n_frames, num_mel_bins) float32, normalized."""
        wave = np.asarray(wave, dtype=np.float64)
        pad = self.n_fft // 2
        if wave.shape[0] <= pad:
            raise ValueError(
                f"waveform too short: {wave.shape[0]} samples (need > {pad})"
            )
        padded = np.pad(wave, (pad, pad), mode="reflect")
        n_frames = 1 + wave.shape[0] // self.hop_length
        n = np.arange(self.n_fft, dtype=np.float64)
        window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / self.n_fft))
        spec = np.empty((n_frames, self.n_fft // 2 + 1))
        for t in range(n_frames):
            seg = padded[t * self.hop_length : t * self.hop_length + self.n_fft]
            spec[t] = np.abs(np.fft.rfft(seg * window)) ** 2
        fb = _mel_filterbank(
            self.n_fft // 2 + 1, self.num_mel_bins, self.sampling_rate
        )
        logmel = np.log10(1.0 + spec @ fb * self.log_compression_scale)
        logmel = (logmel - self.mean) / (self.std * 2.0)
        return logmel.astype(np.float32)  # (T, n_mels)

    def __call__(self, raw_speech, sampling_rate=None, return_tensors=None,
                 **kwargs) -> BatchFeature:
        if sampling_rate is not None and sampling_rate != self.sampling_rate:
            raise ValueError(
                f"expected {self.sampling_rate} Hz input, got {sampling_rate}"
            )
        # HF convention (cf. ASTFeatureExtractor): a bare list of FLOATS is
        # ONE waveform; only a list of sequences (arrays/lists) is a batch
        batched = bool(
            (isinstance(raw_speech, (list, tuple)) and len(raw_speech) > 0
             and isinstance(raw_speech[0], (list, tuple, np.ndarray)))
            or (isinstance(raw_speech, np.ndarray) and raw_speech.ndim == 2)
        )
        waves = raw_speech if batched else [raw_speech]
        feats = []
        for wave in waves:
            x = self._log_mel(np.asarray(wave))
            if x.shape[0] >= self.max_length:
                x = x[: self.max_length]
            else:
                x = np.pad(
                    x,
                    ((0, self.max_length - x.shape[0]), (0, 0)),
                    constant_values=self.padding_value,
                )
            feats.append(x)
        return BatchFeature(
            {"input_values": np.stack(feats)}, tensor_type=return_tensors
        )
