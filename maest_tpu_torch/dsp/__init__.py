from .filterbank import dft_matrices, hann_window, mel_filterbank
from .mel import (
    HOP_LENGTH,
    MelConfig,
    N_FFT,
    N_MELS,
    NORM_MEAN,
    NORM_STD,
    SAMPLE_RATE,
    WIN_LENGTH,
    frame_waveforms,
    log_mel_spectrogram,
    log_mel_spectrogram_np,
    num_frames,
)

__all__ = [
    "HOP_LENGTH",
    "MelConfig",
    "N_FFT",
    "N_MELS",
    "NORM_MEAN",
    "NORM_STD",
    "SAMPLE_RATE",
    "WIN_LENGTH",
    "dft_matrices",
    "frame_waveforms",
    "hann_window",
    "log_mel_spectrogram",
    "log_mel_spectrogram_np",
    "mel_filterbank",
    "num_frames",
]
