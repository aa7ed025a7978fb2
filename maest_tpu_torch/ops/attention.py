"""Attention forward (inference), port of ``maest_tpu/ops/attention.py``.

``flash_attention(q, k, v, n_real=None, quant=None)`` takes and returns
(B, N, H, D). On CUDA tensors it launches the hand-written kernel of
``csrc/attention_fwd.cu`` (bf16 on the tensor cores, fp32 in scalar fp32
FMA; head_dim 64, any N, strided q/k/v views); on CPU tensors it runs
``attention_reference``, the plain PyTorch version. The TPU kernel's
block tuning, head grouping and sublane padding have no counterpart here.
The backward and the 8-bit modes are not ported yet (ROADMAP queue 2,
K3-K7).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
HEAD_DIM = 64

_QUANT_MODES = (None, "qk8", "qk8pv8", "fp8", "fp8pv8")


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_real: int | None = None) -> torch.Tensor:
    """Plain PyTorch attention on (B, N, H, D): fp32 scores and softmax,
    keys >= n_real masked with -1e30, probabilities cast to the input dtype
    before the P.V product (as the bf16 kernels do)."""
    n, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * d**-0.5
    if n_real is not None and n_real < n:
        s[..., n_real:] = _NEG_INF
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v).to(q.dtype)


def _check_args(q, k, v, n_real, quant):
    if quant == "none":  # config-file spelling of "off"
        quant = None
    if quant not in _QUANT_MODES:
        raise ValueError(f"unknown attention quant mode {quant!r}; expected "
                         "None, 'qk8', 'qk8pv8', 'fp8' or 'fp8pv8'")
    if quant is not None:
        raise NotImplementedError(
            f"attention quant mode {quant!r} is not ported yet (ROADMAP "
            "queue 2: K5 for qk8/qk8pv8, K6 for fp8/fp8pv8)")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one (B, N, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n = q.shape[1]
    if n_real is not None and n_real > n:
        raise ValueError(f"n_real={n_real} exceeds the sequence length {n}")
    if n_real is not None and n_real < 1:
        raise ValueError(f"n_real={n_real} must be at least 1")
    return None if n_real is None or n_real == n else n_real


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_real: int | None = None,
                    quant: str | None = None) -> torch.Tensor:
    """Fused multi-head attention forward; inputs/outputs (B, N, H, D).

    ``n_real``: keys at positions >= n_real get no softmax mass (their
    query rows are still computed). ``quant``: only None / "none"; the
    8-bit modes raise ``NotImplementedError``. CUDA launches are counted
    in ``flash_attention.launches``."""
    n_real = _check_args(q, k, v, n_real, quant)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, n_real)
    return _launch(q, k, v, n_real)


def _launch(q, k, v, n_real):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError("the CUDA attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, n, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA attention kernel is built for head_dim "
                         f"{HEAD_DIM}, got {d}")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("q/k/v need a contiguous last (head_dim) axis")
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            # the bf16 kernel stages rows with 16-byte loads
            raise ValueError("bf16 q/k/v rows must start on 16-byte "
                             "boundaries (strides in multiples of 8)")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _build.load_library("attention_fwd")
    name = ("maest_attn_fwd_fp32" if q.dtype == torch.float32
            else "maest_attn_fwd_bf16")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, n, h, n if n_real is None else n_real, strides,
                 d**-0.5 * _LOG2E, stream)
    _build.check(lib, err, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
