"""Mel filterbank, DFT matrices and Hann window (host-side numpy), shared
with ``maest_tpu/dsp/filterbank.py``."""

from .._reference import load

_fb = load("dsp.filterbank")

dft_matrices = _fb.dft_matrices
hann_window = _fb.hann_window
mel_filterbank = _fb.mel_filterbank

__all__ = ["dft_matrices", "hann_window", "mel_filterbank"]
