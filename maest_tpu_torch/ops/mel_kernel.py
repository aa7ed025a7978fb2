"""Fused log-mel front-end: window + DFT + power + mel + log10 + z-norm.

Port of ``maest_tpu/ops/mel_kernel.py``. On a CUDA tensor
``fused_logmel_from_frames`` launches the hand-written kernel of
``csrc/mel_kernel.cu``, ``logmel_fft_kernel`` (one launch for all frames of
a batch): a 512-point real FFT in shared memory behind TMA bulk loads, and
the mel projection over each band's run of nonzero bins. On a CPU tensor
it runs ``fused_logmel_from_frames_reference``, the plain PyTorch version
of the same function: the DFT as two products with the Hann window folded
into the DFT matrices on the host in float64, as the JAX kernel does.

Beside them: ``fused_logmel_fft_reference`` walks the kernel's own route
step by step in PyTorch (packing, the same radix passes over the same host
twiddle table, the split step, the band table), for the tests; and
``fused_logmel_from_frames_fma``, the scalar FMA kernel that computed the
DFT as a product before the FFT, kept as the FFT kernel's control. The main
path reaches neither.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..dsp.filterbank import dft_matrices, hann_window, mel_filterbank
from . import _build

N_FFT = 512
# the FFT kernel's limits (csrc/mel_kernel.cu): four bands a lane, the band
# weights staged in shared memory, a band's width in 7 bits of its code
MAX_MELS = 128
MAX_NNZ = 1024
MAX_WIDTH = 127

_tables_lock = threading.Lock()
_tables: dict = {}


def _host_tables(n_fft: int, n_mels: int, sample_rate: int):
    window = hann_window(n_fft).astype(np.float64)
    cos_m, sin_m = dft_matrices(n_fft)
    cosw = (window[:, None] * cos_m).astype(np.float32)
    sinw = (window[:, None] * sin_m).astype(np.float32)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate).astype(np.float32)
    return cosw, sinw, fb


class FftTables(NamedTuple):
    """Host tables of the FFT route (n_fft 512)."""
    window: np.ndarray    # (512,) fp32 Hann window
    twiddle: np.ndarray   # (512, 2) fp32: cos, -sin of 2 pi k / 512, k < 512
    bands: np.ndarray     # (n_mels, 4) int32: start bin, width, offset, 0
    weights: np.ndarray   # (nnz,) fp32: each band's run of weights in order


@functools.lru_cache(maxsize=8)
def fft_tables(n_mels: int = 96, sample_rate: int = 16000) -> FftTables:
    """The FFT route's tables. Twiddles W_512^k = e^(-2 pi i k / 512) are
    computed in float64 and rounded to fp32 once. Each mel band is the run
    of bins from its first nonzero filterbank weight to its last (slaney
    triangles have no zero inside it; a band with no nonzero weight has
    width 0), its weights stored in ascending bin order."""
    k = np.arange(N_FFT, dtype=np.float64)
    ang = 2.0 * np.pi * k / N_FFT
    twiddle = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    fb = mel_filterbank(N_FFT // 2 + 1, n_mels, sample_rate)
    bands = np.zeros((n_mels, 4), np.int32)
    runs = []
    offset = 0
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        start, width = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        bands[m, :3] = start, width, offset
        runs.append(fb[start:start + width, m])
        offset += width
    weights = np.concatenate(runs).astype(np.float32)
    return FftTables(hann_window(N_FFT).astype(np.float32), twiddle, bands,
                     weights)


def _tables_on(device: torch.device, n_fft: int, n_mels: int,
               sample_rate: int, route: str = "dft"):
    """The route's tables as fp32 / int32 tensors on ``device``, built once
    per device, geometry and route: "dft" (hann*cos, hann*sin, filterbank),
    "fft" (window, twiddles, bands, weights)."""
    key = (str(device), n_fft, n_mels, sample_rate, route)
    with _tables_lock:
        t = _tables.get(key)
        if t is None:
            host = (fft_tables(n_mels, sample_rate) if route == "fft"
                    else _host_tables(n_fft, n_mels, sample_rate))
            t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for a in host)
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


# complex values of the FFT route as (re, im) pairs of fp32 tensors, each
# operation written as the kernel writes it
def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _mul(a, w):
    """a times the twiddle w = (cos, -sin)."""
    return a[0] * w[0] - a[1] * w[1], a[0] * w[1] + a[1] * w[0]


def _dft4(x0, x1, x2, x3):
    e0, f0, e1, d = _add(x0, x2), _sub(x0, x2), _add(x1, x3), _sub(x1, x3)
    f1 = (d[1], -d[0])  # -i (x1 - x3)
    return _add(e0, e1), _add(f0, f1), _sub(e0, e1), _sub(f0, f1)


def _dft8(a, h):
    """The 8-point DFT of a[0..7]: a radix-2 step (a_j +- a_(j+4), the
    differences times W_8^j; h = cos(pi / 4) from the twiddle table), then a
    4-point DFT of the sums (even outputs) and of the differences (odd)."""
    b = [_add(a[j], a[j + 4]) for j in range(4)]
    c = [_sub(a[j], a[j + 4]) for j in range(4)]
    c[1] = (h * (c[1][0] + c[1][1]), h * (c[1][1] - c[1][0]))
    c[2] = (c[2][1], -c[2][0])
    c[3] = (h * (c[3][1] - c[3][0]), -(h * (c[3][0] + c[3][1])))
    e, o = _dft4(*b), _dft4(*c)
    return [e[0], o[0], e[1], o[1], e[2], o[2], e[3], o[3]]


def fft_power_reference(frames: torch.Tensor) -> torch.Tensor:
    """(M, 512) fp32 frames, window not applied -> (M, 257) fp32 power
    spectrum of the windowed frames by the FFT kernel's route: z[n] =
    x[2n] + i x[2n+1] (windowed), a 256-point complex FFT as radix 8 over n
    = 32 n1 + n2, twiddles W_256^(n2 k1), radix 8 over n2 = 4 m1 + m2,
    twiddles W_32^(m2 j1), radix 4 over m2, giving Z[k1 + 8 j1 + 64 j2];
    then the split step X[k] = E + W_512^k O, X[256 - k] = conj(E - W_512^k
    O), E = (Z[k] + conj Z[256 - k]) / 2, O = -i (Z[k] - conj Z[256 - k]) /
    2, with DC and Nyquist real: Re Z[0] +- Im Z[0]."""
    tab = fft_tables()
    dev = frames.device
    tw = torch.from_numpy(tab.twiddle).to(dev)
    h = tw[64, 0]
    x = frames.to(torch.float32) * torch.from_numpy(tab.window).to(dev)
    m = x.shape[0]
    zr, zi = x[:, 0::2].reshape(m, 8, 32), x[:, 1::2].reshape(m, 8, 32)
    # radix 8 over n1 (stride 32), then W_256^(n2 k1) = W_512^(2 n2 k1)
    a = _dft8([(zr[:, n1], zi[:, n1]) for n1 in range(8)], h)
    n2 = torch.arange(32, device=dev)
    a = [a[0]] + [_mul(a[k1], (tw[(2 * n2 * k1) % 512, 0],
                               tw[(2 * n2 * k1) % 512, 1]))
                  for k1 in range(1, 8)]
    # radix 8 over m1 (n2 = 4 m1 + m2), then W_32^(m2 j1) = W_512^(16 m2 j1)
    yr = torch.stack([p[0] for p in a], 1).reshape(m, 8, 8, 4)
    yi = torch.stack([p[1] for p in a], 1).reshape(m, 8, 8, 4)
    a = _dft8([(yr[:, :, m1], yi[:, :, m1]) for m1 in range(8)], h)
    m2 = torch.arange(4, device=dev)
    a = [a[0]] + [_mul(a[j1], (tw[(16 * m2 * j1) % 512, 0],
                               tw[(16 * m2 * j1) % 512, 1]))
                  for j1 in range(1, 8)]
    # radix 4 over m2; Z[k1 + 8 j1 + 64 j2]
    sr, si = torch.stack([p[0] for p in a], 2), torch.stack([p[1] for p in a], 2)
    d = _dft4(*[(sr[..., q], si[..., q]) for q in range(4)])  # (m, k1, j1)
    z = [torch.stack([p[c] for p in d], 1).transpose(2, 3).reshape(m, 256)
         for c in (0, 1)]
    # the split step, k = 0..128 against 256 - k
    k = torch.arange(129, device=dev)
    ar, ai = z[0][:, :129], z[1][:, :129]
    br, bi = z[0][:, (256 - k) % 256], z[1][:, (256 - k) % 256]
    e = (0.5 * (ar + br), 0.5 * (ai - bi))
    o = (0.5 * (ai + bi), -(0.5 * (ar - br)))
    wo = _mul(o, (tw[:129, 0], tw[:129, 1]))
    x1, x2 = _add(e, wo), _sub(e, wo)
    p1 = x1[0] * x1[0] + x1[1] * x1[1]  # bins 0..128
    p2 = x2[0] * x2[0] + x2[1] * x2[1]  # bins 256..128
    dc, ny = ar[:, 0] + ai[:, 0], ar[:, 0] - ai[:, 0]
    return torch.cat([(dc * dc)[:, None], p1[:, 1:],
                      p2[:, 1:128].flip(1), (ny * ny)[:, None]], 1)


def band_sum_reference(power: torch.Tensor, n_mels: int = 96,
                       sample_rate: int = 16000) -> torch.Tensor:
    """(M, 257) power -> (M, n_mels) mel over the band table: each band's
    products summed in ascending bin order from 0. The dense product over
    all 257 bins in the same order gives the same fp32 sums: every term it
    adds beyond the band's run is p * 0 = 0 (p finite), and acc + 0 = acc
    exactly (tests/test_torch_mel_fft.py)."""
    tab = fft_tables(n_mels, sample_rate)
    dev = power.device
    width = int(tab.bands[:, 1].max(initial=0))
    q = np.arange(width)
    live = q[None, :] < tab.bands[:, 1:2]
    idx = np.where(live, tab.bands[:, :1] + q[None, :], 0)
    w = np.where(live, tab.weights[np.where(live, tab.bands[:, 2:3] + q, 0)],
                 np.float32(0))
    idx, w = torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)
    acc = torch.zeros((power.shape[0], n_mels), dtype=torch.float32,
                      device=dev)
    for c in range(width):
        acc = acc + power[:, idx[:, c]] * w[:, c]
    return acc


def fused_logmel_fft_reference(
    frames: torch.Tensor, *, n_fft: int = N_FFT, n_mels: int = 96,
    sample_rate: int = 16000, compression_scale: float = 10000.0,
    norm_mean: float = 2.06755686098554, norm_std: float = 1.268292820667291,
    normalize: bool = True,
) -> torch.Tensor:
    """The FFT kernel's route in plain PyTorch: (M, 512) fp32 frames ->
    (M, n_mels) fp32 (``fft_power_reference``, ``band_sum_reference``,
    log10 and z-norm as the kernel takes them)."""
    if n_fft != N_FFT:
        raise ValueError(f"the FFT route is built for n_fft={N_FFT}, got "
                         f"{n_fft}")
    mel = band_sum_reference(fft_power_reference(frames), n_mels, sample_rate)
    logmel = torch.log10(1.0 + mel * compression_scale)
    if normalize:
        logmel = (logmel - norm_mean) * (1.0 / (2.0 * norm_std))
    return logmel


def _check_frames(frames: torch.Tensor, n_fft: int) -> None:
    """What both kernels take: (M, 512) fp32 CUDA frames, contiguous, on a
    16-byte boundary."""
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if n_fft != N_FFT:
        raise ValueError(f"the CUDA mel kernels are built for n_fft={N_FFT}, "
                         f"got {n_fft}")
    if frames.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {frames.dtype}")
    if frames.ndim != 2 or frames.shape[1] != n_fft:
        raise ValueError(f"frames must be (M, {n_fft}), got "
                         f"{tuple(frames.shape)}")
    if not frames.is_contiguous() or frames.data_ptr() % 16:
        # 16-byte loads (the control) and TMA bulk copies (the FFT kernel)
        raise ValueError("frames must be contiguous and start on a 16-byte "
                         "boundary")


def _launch(frames: torch.Tensor, n_mels: int, sample_rate: int,
            compression_scale: float, norm_mean: float, norm_std: float,
            normalize: bool, route: str) -> torch.Tensor:
    """One launch of the FFT kernel (``route`` "fft", entry
    ``maest_logmel_fft``) or of the FMA control ("dft", entry
    ``maest_logmel_fp32``) on checked frames."""
    if route == "fft":
        host = fft_tables(n_mels, sample_rate)
        if n_mels > MAX_MELS or host.weights.size > MAX_NNZ or int(
                host.bands[:, 1].max(initial=0)) > MAX_WIDTH:
            raise ValueError(
                f"the FFT mel kernel takes at most {MAX_MELS} bands, "
                f"{MAX_NNZ} filterbank nonzeros and {MAX_WIDTH} bins a band; "
                f"got {n_mels} bands, {host.weights.size} nonzeros")
    lib = _build.load_library("mel_kernel")
    tables = _tables_on(frames.device, N_FFT, n_mels, sample_rate, route)
    extra = [t.data_ptr() for t in tables]
    if route == "fft":
        name = "maest_logmel_fft"
        fn = lib.maest_logmel_fft
        argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
        extra.append(host.weights.size)
    else:
        name = "maest_logmel_fp32"
        fn = lib.maest_logmel_fp32
        argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, *argtypes,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    out = torch.empty((frames.shape[0], n_mels), dtype=torch.float32,
                      device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(frames.data_ptr(), frames.shape[0], *extra, n_mels,
                 out.data_ptr(), compression_scale, norm_mean,
                 1.0 / (2.0 * norm_std), int(normalize), stream)
    _build.check(lib, err, name)
    return out


# Private: True routes ``fused_logmel_from_frames`` on CUDA tensors through
# the FMA control (``fused_logmel_from_frames_fma``) instead of the FFT
# kernel, so that a measurement can time the steps of the model with each.
# Nothing in the package sets it.
_K1_CONTROL = False


def fused_logmel_from_frames(
    frames: torch.Tensor, *, n_fft: int = N_FFT, n_mels: int = 96,
    sample_rate: int = 16000, compression_scale: float = 10000.0,
    norm_mean: float = 2.06755686098554, norm_std: float = 1.268292820667291,
    normalize: bool = True,
) -> torch.Tensor:
    """(M, n_fft) fp32 frames, window not applied -> (M, n_mels) fp32.

    CPU tensors take the plain version; CUDA tensors launch the FFT kernel
    and count the launch in ``fused_logmel_from_frames.launches``."""
    kw = dict(n_fft=n_fft, n_mels=n_mels, sample_rate=sample_rate,
              compression_scale=compression_scale, norm_mean=norm_mean,
              norm_std=norm_std, normalize=normalize)
    if frames.device.type == "cpu":
        return fused_logmel_from_frames_reference(frames, **kw)
    if _K1_CONTROL:
        return fused_logmel_from_frames_fma(frames, **kw)
    _check_frames(frames, n_fft)
    out = _launch(frames, n_mels, sample_rate, compression_scale, norm_mean,
                  norm_std, normalize, "fft")
    fused_logmel_from_frames.launches += 1
    return out


fused_logmel_from_frames.launches = 0


def fused_logmel_from_frames_fma(
    frames: torch.Tensor, *, n_fft: int = N_FFT, n_mels: int = 96,
    sample_rate: int = 16000, compression_scale: float = 10000.0,
    norm_mean: float = 2.06755686098554, norm_std: float = 1.268292820667291,
    normalize: bool = True,
) -> torch.Tensor:
    """The control of the FFT kernel: the scalar fp32 FMA kernel that takes
    the DFT as a product against hann*cos and hann*sin (entry
    ``maest_logmel_fp32``), one bin a thread. It computes what
    ``fused_logmel_from_frames`` computes; counted in
    ``fused_logmel_from_frames_fma.launches``. CPU tensors take the plain
    version."""
    if frames.device.type == "cpu":
        return fused_logmel_from_frames_reference(
            frames, n_fft=n_fft, n_mels=n_mels, sample_rate=sample_rate,
            compression_scale=compression_scale, norm_mean=norm_mean,
            norm_std=norm_std, normalize=normalize)
    _check_frames(frames, n_fft)
    out = _launch(frames, n_mels, sample_rate, compression_scale, norm_mean,
                  norm_std, normalize, "dft")
    fused_logmel_from_frames_fma.launches += 1
    return out


fused_logmel_from_frames_fma.launches = 0
