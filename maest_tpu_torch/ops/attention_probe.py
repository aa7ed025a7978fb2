"""The attention-decomposition variants of the bf16 forward, port of the
four float kernels of ``scripts/attn_profile_r2.py``.

``attention_probe(q, k, v, variant, n_real=None)`` takes and returns
(B, N, H, 64) bf16. Each variant is K2's loop (``csrc/attn_fwd_bf16.cuh``)
with one piece changed, so that K2's time minus the variant's is the time
of that piece (``maest_tpu_torch.probes.attn_profile`` times them):

- ``mxu_only``: p = bf16(s * scale), no mask, no max, no sum; out =
  bf16(sum of p.V), not divided. Takes n_real = N only.
- ``noexp_max``: p = exp2(s * scale * log2(e)) with no shift, keys >=
  n_real masked; out = sum of p.V / sum of p. Softmax attention while the
  scores stay well under fp32 exp2's range (|s * scale * log2(e)| < 128):
  the rig's inputs, N(0, 0.1^2) and N(0, 1) under ``--check``, keep them
  under ~10.
- ``novmax``: p = exp2(x - the max over this 64-key tile only), no
  correction across tiles: a function of the key tiling, not attention.
- ``bf16s``: q pre-scaled by scale * log2(e) in bf16, scores rounded to
  bf16 (masked keys at bf16(-1e30)), then K2's online softmax on them.

Every variant rounds p to bf16 for the P.V product and sums in fp32. On
CUDA tensors the wrapper launches ``csrc/attention_probe.cu`` (counted per
variant in ``attention_probe.launches``); on CPU tensors it runs the plain
version, ``attention_probe_reference``, which walks the same 64-key tiles.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import (
    _LOG2E,
    _NEG_INF,
    HEAD_DIM,
    _check_args,
    _check_views,
    _strides,
)

VARIANTS = ("mxu_only", "noexp_max", "novmax", "bf16s")
BLOCK_K = 64  # the kernel's key tile: novmax's max is taken over it
_ID = {name: i + 1 for i, name in enumerate(VARIANTS)}  # maest::FwdVariant


def _check(q, k, v, variant, n_real):
    """Validate; return n_real as an int."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown attention probe variant {variant!r}; "
                         f"expected one of {', '.join(VARIANTS)}")
    n_real, _, _ = _check_args(q, k, v, n_real, None)
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("the attention probe kernels take bfloat16 q/k/v, got "
                        f"{', '.join(str(t.dtype) for t in (q, k, v))}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the CUDA attention kernels are built for head_dim "
                         f"{HEAD_DIM}, got {q.shape[-1]}")
    if variant == "mxu_only" and n_real is not None:
        raise ValueError("mxu_only masks no key: it takes n_real = N only, "
                         f"got n_real={n_real} of {q.shape[1]}")
    return q.shape[1] if n_real is None else n_real


def prescale_q(q: torch.Tensor) -> torch.Tensor:
    """bf16(fp32(q) * scale * log2(e)): the rig's q for ``bf16s``."""
    return (q.float() * (q.shape[-1]**-0.5 * _LOG2E)).to(q.dtype)


def attention_probe_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, variant: str,
                              n_real: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``attention_probe``: 64-key tiles in fp32,
    rounding where the kernel rounds (p to bf16 before P.V; for ``bf16s``
    the pre-scaled q, the scores and the mask value to bf16)."""
    nr = _check(q, k, v, variant, n_real)
    d = q.shape[-1]
    scale = d**-0.5
    sl = scale * _LOG2E
    if variant == "bf16s":
        q = prescale_q(q)
    # (B, H, N, D) fp32
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    b, h, n, _ = qh.shape
    neg = _NEG_INF
    if variant == "bf16s":
        neg = torch.tensor(_NEG_INF).to(torch.bfloat16).item()
    acc = torch.zeros((b, h, n, d), device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    m = torch.full((b, h, n, 1), _NEG_INF, device=q.device)
    for base in range(0, nr, BLOCK_K):
        hi = min(base + BLOCK_K, n)
        s = qh @ kh[:, :, base:hi].transpose(-1, -2)
        vt = vh[:, :, base:hi]
        if variant == "mxu_only":
            acc += (s * scale).to(torch.bfloat16).float() @ vt
            continue
        s = s.to(torch.bfloat16).float() if variant == "bf16s" else s * sl
        if hi > nr:
            s[..., nr - base:] = neg
        if variant == "noexp_max":
            p = torch.exp2(s)
        elif variant == "novmax":
            p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        else:  # bf16s: the online softmax
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l *= corr
            acc *= corr
            m = m_new
        l += p.sum(dim=-1, keepdim=True)
        acc += p.to(torch.bfloat16).float() @ vt
    out = acc if variant == "mxu_only" else acc / l
    return out.transpose(1, 2).to(torch.bfloat16)


def attention_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    variant: str, n_real: int | None = None) -> torch.Tensor:
    """The ``variant`` forward on (B, N, H, 64) bf16: the kernel on CUDA
    tensors, ``attention_probe_reference`` on CPU tensors."""
    _check(q, k, v, variant, n_real)
    if q.device.type == "cpu":
        return attention_probe_reference(q, k, v, variant, n_real)
    return launch_probe(prescale_q(q) if variant == "bf16s" else q, k, v,
                        variant, n_real)


def launch_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 variant: str, n_real: int | None = None) -> torch.Tensor:
    """The ``variant`` kernel alone on CUDA tensors, as ``attention_probe``
    launches it: for ``bf16s`` q must come through ``prescale_q`` (the rig
    times the kernel so, apart from that pass)."""
    nr = _check(q, k, v, variant, n_real)
    if q.device.type != "cuda":
        raise ValueError(f"launch_probe launches the CUDA kernel; got {q.device}"
                         " tensors (attention_probe runs the plain version)")
    _check_views((q, k, v), torch.bfloat16, "q/k/v")
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library("attention_probe")
    fn = lib.maest_attn_probe_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_void_p])
    sl = d**-0.5 * (1.0 if variant == "mxu_only" else _LOG2E)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_ID[variant], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, n, h, nr, _strides(q, k, v, out), sl,
                 stream)
    _build.check(lib, err, f"maest_attn_probe_bf16 ({variant})")
    attention_probe.launches[variant] += 1
    return out


attention_probe.launches = dict.fromkeys(VARIANTS, 0)
