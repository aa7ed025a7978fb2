"""Log-mel front-end of the PyTorch port against the JAX package: the XLA
path (``impl="xla"``) and the Pallas kernel in interpret mode. Tolerance
rtol = atol = 1e-4, the JAX package's own front-end bound.

On the CPU the port's wrapper runs the kernel's plain version;
tests/test_torch_cuda.py holds the kernel to it on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maest_tpu.dsp.mel import log_mel_spectrogram as jax_log_mel
from maest_tpu.ops.mel_kernel import fused_logmel_from_frames as jax_fused
from maest_tpu_torch.dsp.mel import frame_waveforms, log_mel_spectrogram
from maest_tpu_torch.ops.mel_kernel import (
    fused_logmel_from_frames,
    fused_logmel_from_frames_reference,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def _wave(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.2


@pytest.mark.parametrize("shape", [(16000,), (5 * 16000 + 123,), (2, 16000)],
                         ids=["1s", "5s_odd", "batch2"])
def test_log_mel_matches_jax_xla(shape):
    wave = _wave(shape)
    ref = np.asarray(jax_log_mel(jnp.asarray(wave), impl="xla"))
    ours = log_mel_spectrogram(torch.from_numpy(wave)).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    assert ours.shape[-1] == 1 + shape[-1] // 256
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("n_samples", [16000, 5 * 16000 + 123])
def test_frame_function_matches_pallas_interpret(n_samples):
    wave = _wave((n_samples,), seed=1)
    frames = frame_waveforms(torch.from_numpy(wave)[None])[0]
    ref = np.asarray(jax_fused(jnp.asarray(frames.numpy()), interpret=True))
    ours = fused_logmel_from_frames(frames).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    raw = fused_logmel_from_frames(frames, normalize=False).numpy()
    ref_raw = np.asarray(jax_fused(jnp.asarray(frames.numpy()),
                                   normalize=False, interpret=True))
    np.testing.assert_allclose(raw, ref_raw, **TOL)


def test_cpu_takes_plain_version_and_counts_no_launch():
    frames = frame_waveforms(torch.from_numpy(_wave((2, 4000), seed=2)))
    frames = frames.reshape(-1, 512)
    before = fused_logmel_from_frames.launches
    out = fused_logmel_from_frames(frames)
    assert fused_logmel_from_frames.launches == before
    assert torch.equal(out, fused_logmel_from_frames_reference(frames))


def test_too_short_raises():
    with pytest.raises(ValueError, match="too short"):
        log_mel_spectrogram(torch.zeros(256))
    log_mel_spectrogram(torch.zeros(257))  # the shortest valid input
    with pytest.raises(ValueError, match="1-D or 2-D"):
        log_mel_spectrogram(torch.zeros(1, 1, 1000))
