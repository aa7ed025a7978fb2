"""Fused log-mel front-end: window + DFT + power + mel + log10 + z-norm.

Port of ``maest_tpu/ops/mel_kernel.py``. On a CUDA tensor
``fused_logmel_from_frames`` launches the hand-written kernel of
``csrc/mel_kernel.cu`` (one launch for all frames of a batch); on a CPU
tensor it runs ``fused_logmel_from_frames_reference``, the plain PyTorch
version of the same math. The Hann window is folded into the DFT matrices
on the host in float64, exactly as the JAX kernel does.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..dsp.filterbank import dft_matrices, hann_window, mel_filterbank
from . import _build

N_FFT = 512

_tables_lock = threading.Lock()
_tables: dict = {}


def _host_tables(n_fft: int, n_mels: int, sample_rate: int):
    window = hann_window(n_fft).astype(np.float64)
    cos_m, sin_m = dft_matrices(n_fft)
    cosw = (window[:, None] * cos_m).astype(np.float32)
    sinw = (window[:, None] * sin_m).astype(np.float32)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate).astype(np.float32)
    return cosw, sinw, fb


def _tables_on(device: torch.device, n_fft: int, n_mels: int,
               sample_rate: int):
    """(hann*cos, hann*sin, filterbank) fp32 on ``device``; built once per
    device and geometry."""
    key = (str(device), n_fft, n_mels, sample_rate)
    with _tables_lock:
        t = _tables.get(key)
        if t is None:
            t = tuple(torch.from_numpy(a).to(device)
                      for a in _host_tables(n_fft, n_mels, sample_rate))
            _tables[key] = t
        return t


def fused_logmel_from_frames_reference(
    frames: torch.Tensor, *, n_fft: int = N_FFT, n_mels: int = 96,
    sample_rate: int = 16000, compression_scale: float = 10000.0,
    norm_mean: float = 2.06755686098554, norm_std: float = 1.268292820667291,
    normalize: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: (M, n_fft) fp32 frames -> (M, n_mels) fp32."""
    cosw, sinw, fb = _tables_on(frames.device, n_fft, n_mels, sample_rate)
    f = frames.to(torch.float32)
    re = f @ cosw
    im = f @ sinw
    mel = (re * re + im * im) @ fb
    logmel = torch.log10(1.0 + mel * compression_scale)
    if normalize:
        logmel = (logmel - norm_mean) * (1.0 / (2.0 * norm_std))
    return logmel


def fused_logmel_from_frames(
    frames: torch.Tensor, *, n_fft: int = N_FFT, n_mels: int = 96,
    sample_rate: int = 16000, compression_scale: float = 10000.0,
    norm_mean: float = 2.06755686098554, norm_std: float = 1.268292820667291,
    normalize: bool = True,
) -> torch.Tensor:
    """(M, n_fft) fp32 frames, window not applied -> (M, n_mels) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    count the launch in ``fused_logmel_from_frames.launches``."""
    kw = dict(n_fft=n_fft, n_mels=n_mels, sample_rate=sample_rate,
              compression_scale=compression_scale, norm_mean=norm_mean,
              norm_std=norm_std, normalize=normalize)
    if frames.device.type == "cpu":
        return fused_logmel_from_frames_reference(frames, **kw)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if n_fft != N_FFT:
        raise ValueError(f"the CUDA mel kernel is built for n_fft={N_FFT}, "
                         f"got {n_fft}")
    if frames.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {frames.dtype}")
    if frames.ndim != 2 or frames.shape[1] != n_fft:
        raise ValueError(f"frames must be (M, {n_fft}), got "
                         f"{tuple(frames.shape)}")
    if not frames.is_contiguous() or frames.data_ptr() % 16:
        # the kernel stages frames with 16-byte loads
        raise ValueError("frames must be contiguous and start on a 16-byte "
                         "boundary")
    lib = _build.load_library("mel_kernel")
    fn = lib.maest_logmel_fp32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    cosw, sinw, fb = _tables_on(frames.device, n_fft, n_mels, sample_rate)
    out = torch.empty((frames.shape[0], n_mels), dtype=torch.float32,
                      device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(frames.data_ptr(), frames.shape[0], cosw.data_ptr(),
                 sinw.data_ptr(), fb.data_ptr(), n_mels, out.data_ptr(),
                 compression_scale, norm_mean, 1.0 / (2.0 * norm_std),
                 int(normalize), stream)
    _build.check(lib, err, "maest_logmel_fp32")
    fused_logmel_from_frames.launches += 1
    return out


fused_logmel_from_frames.launches = 0
