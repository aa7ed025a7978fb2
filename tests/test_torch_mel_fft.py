"""The FFT route of the port's log-mel front-end on the CPU: its host tables
and its plain version ``fused_logmel_fft_reference``, which walks the CUDA
kernel's route (``csrc/mel_kernel.cu logmel_fft_kernel``) step by step.

- The band table reproduces the filterbank exactly; the band sums equal
  the dense sums of the same power spectrum in sequential fp32.
- The twiddle and Hann tables are within 1 fp32 ulp of numpy float64.
- The route's power spectrum against numpy's float64 FFT; the route's
  log-mels against the port's plain version, the JAX package's XLA front-end
  and its Pallas kernel in interpret mode, rtol = atol = 1e-4 (the JAX
  package's front-end bound), on noise at 0.1 and at full scale, silence,
  a tone on a bin centre, at DC and at Nyquist. Each test prints its
  measured maximum (``pytest -s``).

tests/test_torch_cuda.py holds the kernel to both plain versions on the
card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maest_tpu.dsp.mel import log_mel_spectrogram as jax_log_mel
from maest_tpu.ops.mel_kernel import fused_logmel_from_frames as jax_fused
from maest_tpu_torch.dsp.filterbank import hann_window, mel_filterbank
from maest_tpu_torch.dsp.mel import frame_waveforms
from maest_tpu_torch.ops import mel_kernel as K

TOL = dict(rtol=1e-4, atol=1e-4)
SR = 16000


def _signal(kind: str, n: int = SR) -> np.ndarray:
    t = np.arange(n)
    if kind == "noise_0.1":
        return (np.random.default_rng(0).standard_normal(n) * 0.1).astype(
            np.float32)
    if kind == "noise_full":
        return np.random.default_rng(1).uniform(-1, 1, n).astype(np.float32)
    if kind == "silence":
        return np.zeros(n, np.float32)
    if kind == "tone_bin40":  # bin 40 of 512 at 16 kHz: 1250 Hz
        return (0.5 * np.sin(2 * np.pi * 40 * t / 512)).astype(np.float32)
    if kind == "dc":
        return np.full(n, 0.5, np.float32)
    if kind == "nyquist":
        return (0.5 * (-1.0) ** t).astype(np.float32)
    raise ValueError(kind)


SIGNALS = ["noise_0.1", "noise_full", "silence", "tone_bin40", "dc", "nyquist"]


def _frames(kind: str) -> torch.Tensor:
    wave = torch.from_numpy(_signal(kind))[None]
    return frame_waveforms(wave).reshape(-1, 512)


def _ulps32(got: np.ndarray, exact: np.ndarray) -> float:
    """|got - exact| in fp32 ulps at |exact| (the spacing of fp32 values
    there; below the smallest normal, that of the smallest normal)."""
    mag = np.maximum(np.abs(exact), np.finfo(np.float32).tiny)
    ulp = np.spacing(mag.astype(np.float32)).astype(np.float64)
    return float((np.abs(got.astype(np.float64) - exact) / ulp).max())


def test_band_table_reproduces_the_filterbank():
    fb = mel_filterbank(257, 96, SR)
    tab = K.fft_tables(96, SR)
    assert tab.bands.shape == (96, 4) and tab.bands.dtype == np.int32
    start, width, offset = tab.bands[:, 0], tab.bands[:, 1], tab.bands[:, 2]
    assert tab.weights.size == 502 == int((fb != 0).sum())
    assert width.max() == 15 and width.min() >= 1
    assert (offset == np.concatenate([[0], np.cumsum(width)[:-1]])).all()
    dense = np.zeros_like(fb)
    for m in range(96):
        run = tab.weights[offset[m]:offset[m] + width[m]]
        assert (run != 0).all()  # contiguous: no zero inside a band's run
        dense[start[m]:start[m] + width[m], m] = run
    np.testing.assert_array_equal(dense, fb)
    # no bin lies in more than two bands
    assert int((fb != 0).sum(1).max()) == 2


def _fma32(a, b, c):
    """a * b + c with one rounding to fp32 after the add: the product exact
    in float64 (24 + 24 bits), the sum rounded to float64 and then to fp32.
    Both sums below take their terms through the same function, so a rare
    double rounding touches both alike."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


@pytest.mark.parametrize("step", ["mul_add", "fma"])
def test_band_sums_equal_the_dense_sums(step):
    """Sequential fp32 over all 257 bins in ascending order against the
    sums over each band's run alone: every skipped term is p * 0 = 0 for
    finite p >= 0, and acc + 0 = acc exactly, so the two are equal bit for
    bit (the kernel's fmaf(p, 0, acc) = acc, against the control's dense
    loop)."""
    fb = mel_filterbank(257, 96, SR)
    tab = K.fft_tables(96, SR)
    frames = torch.cat([_frames("noise_0.1")[:8], _frames("tone_bin40")[:4],
                        _frames("silence")[:2]])
    p = K.fft_power_reference(frames).numpy()
    assert (p >= 0).all() and np.isfinite(p).all() and (p == 0).any()

    def add(acc, x, w):
        if step == "fma":
            return _fma32(x, w, acc)
        return (acc + (x * w).astype(np.float32)).astype(np.float32)

    dense = np.zeros((p.shape[0], 96), np.float32)
    for b in range(257):
        dense = add(dense, p[:, b:b + 1], fb[b][None, :])
    sparse = np.zeros_like(dense)
    for m in range(96):
        s, w, o = tab.bands[m, :3]
        acc = np.zeros(p.shape[0], np.float32)
        for q in range(w):
            acc = add(acc, p[:, s + q], tab.weights[o + q])
        sparse[:, m] = acc
    np.testing.assert_array_equal(sparse, dense)
    # the route's plain version takes the same ascending mul-add order
    if step == "mul_add":
        np.testing.assert_array_equal(
            K.band_sum_reference(torch.from_numpy(p)).numpy(), dense)


def test_twiddle_and_window_tables_within_one_ulp():
    tab = K.fft_tables()
    ang = 2 * np.pi * np.arange(512, dtype=np.float64) / 512
    assert tab.twiddle.dtype == np.float32 and tab.twiddle.shape == (512, 2)
    cos_u, sin_u = (_ulps32(tab.twiddle[:, 0], np.cos(ang)),
                    _ulps32(tab.twiddle[:, 1], -np.sin(ang)))
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(512, dtype=np.float64) / 512))
    win_u = _ulps32(tab.window, win)
    print(f"twiddle cos {cos_u:.3f}, -sin {sin_u:.3f}, Hann {win_u:.3f} ulps")
    assert max(cos_u, sin_u, win_u) <= 1.0
    np.testing.assert_array_equal(tab.window, hann_window(512))
    # cos(pi / 4), the radix-8 passes' h, and the exact values
    assert tab.twiddle[64, 0] == np.float32(np.sqrt(0.5))
    assert tab.twiddle[0, 0] == 1 and tab.twiddle[0, 1] == 0
    assert tab.twiddle[256, 0] == -1


@pytest.mark.parametrize("kind", SIGNALS)
def test_fft_power_against_numpy_float64(kind):
    frames = _frames(kind)
    p = K.fft_power_reference(frames).numpy().astype(np.float64)
    x = frames.double().numpy() * hann_window(512).astype(np.float64)
    ref = np.abs(np.fft.rfft(x, axis=1)) ** 2
    err = float(np.abs(p - ref).max())
    scale = max(float(ref.max()), 1e-30)
    print(f"{kind}: power max abs err {err:.3e}, relative to max "
          f"{err / scale:.3e}")
    assert err <= 1e-5 * scale or err == 0.0
    if kind == "silence":
        assert (p == 0).all()


@pytest.mark.parametrize("kind", SIGNALS)
def test_fft_route_matches_plain_version(kind):
    frames = _frames(kind)
    for normalize in (True, False):
        ours = K.fused_logmel_fft_reference(frames, normalize=normalize)
        ref = K.fused_logmel_from_frames_reference(frames, normalize=normalize)
        assert ours.shape == ref.shape == (frames.shape[0], 96)
        print(f"{kind} normalize={normalize}: max abs err vs the plain "
              f"version {(ours - ref).abs().max().item():.3e}")
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("kind", SIGNALS)
def test_fft_route_matches_jax_xla(kind):
    wave = _signal(kind)
    ref = np.asarray(jax_log_mel(jnp.asarray(wave), impl="xla"))
    frames = frame_waveforms(torch.from_numpy(wave)[None])[0]
    ours = K.fused_logmel_fft_reference(frames).numpy().T
    assert ours.shape == ref.shape
    print(f"{kind}: max abs err vs the JAX XLA front-end "
          f"{np.abs(ours - ref).max():.3e}")
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("kind", SIGNALS)
def test_fft_route_matches_pallas_interpret(kind):
    frames = _frames(kind)
    ref = np.asarray(jax_fused(jnp.asarray(frames.numpy()), interpret=True))
    ours = K.fused_logmel_fft_reference(frames).numpy()
    print(f"{kind}: max abs err vs the Pallas kernel (interpret) "
          f"{np.abs(ours - ref).max():.3e}")
    np.testing.assert_allclose(ours, ref, **TOL)


def test_fft_route_refuses_other_sizes():
    with pytest.raises(ValueError, match="n_fft=512"):
        K.fused_logmel_fft_reference(torch.zeros(2, 256), n_fft=256)


def test_cpu_control_takes_plain_version_and_counts_no_launch():
    frames = _frames("noise_0.1")
    before = (K.fused_logmel_from_frames.launches,
              K.fused_logmel_from_frames_fma.launches)
    out = K.fused_logmel_from_frames_fma(frames)
    assert torch.equal(out, K.fused_logmel_from_frames_reference(frames))
    assert (K.fused_logmel_from_frames.launches,
            K.fused_logmel_from_frames_fma.launches) == before


@pytest.mark.parametrize("n_mels", [64, 128])
def test_band_table_at_other_widths(n_mels):
    """The kernel takes up to 128 bands; the table holds any filterbank's
    runs, here against the dense product in float64."""
    fb = mel_filterbank(257, n_mels, SR)
    tab = K.fft_tables(n_mels, SR)
    assert tab.weights.size == int((fb != 0).sum()) <= K.MAX_NNZ
    assert int(tab.bands[:, 1].max()) <= K.MAX_WIDTH
    p = K.fft_power_reference(_frames("noise_0.1")[:6])
    got = K.band_sum_reference(p, n_mels, SR).double()
    ref = p.double() @ torch.from_numpy(fb).double()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-9)


def test_mel_parts_rig_patches_the_kernel_source():
    """``probes/mel_parts.py`` builds the FFT kernel with its later stages
    taken out by replacing lines of ``csrc/mel_kernel.cu``: each line is
    there once, so every stage it times is the kernel's own."""
    from maest_tpu_torch.ops import _build
    from maest_tpu_torch.probes import mel_parts

    src = (_build.CSRC / "mel_kernel.cu").read_text()
    assert list(mel_parts.PARTS) == ["ring", "fft", "bands", "full"]
    for part, lines in mel_parts.PARTS.items():
        for old, _ in lines:
            assert src.count(old) == 1, (part, old)
