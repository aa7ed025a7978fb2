"""Attention forward and backward, port of ``maest_tpu/ops/attention.py``.

``flash_attention(q, k, v, n_real=None, quant=None, bwd_quant=None)``
takes and returns (B, N, H, D). With gradients off it runs the inference
forward (K2, no lse). When autograd records it (grad mode on and an input
that requires a gradient) it is a ``torch.autograd.Function``: the forward
(K3a) also writes the per-row log2-sum-exp ``lse`` (B, H, N) and saves
(q, k, v, o, lse); the backward (K3b/K4) rebuilds the probabilities from
lse and returns dq, dk, dv in the inputs' dtype.

On CUDA tensors each step launches its hand-written kernel
(``csrc/attention_fwd.cu``, ``csrc/attention_bwd.cu``: bf16 on the tensor
cores, fp32 in scalar fp32 FMA; head_dim 64, any N, strided views); on CPU
tensors it runs the plain PyTorch version (``attention_reference``,
``attention_reference_lse``, ``attention_bwd_reference``). The TPU
kernels' block tuning, head grouping, sublane padding and the full-K /
split backward switch have no counterpart here: one backward design covers
every N. The 8-bit modes are not ported yet (ROADMAP queue 2, K5-K7).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from . import _build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
HEAD_DIM = 64

_QUANT_MODES = (None, "qk8", "qk8pv8", "fp8", "fp8pv8")


def _scores(q, k, n_real):
    """fp32 scaled scores (B, H, N, N), keys >= n_real at -1e30."""
    n, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * d**-0.5
    if n_real is not None and n_real < n:
        s[..., n_real:] = _NEG_INF
    return s


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_real: int | None = None) -> torch.Tensor:
    """Plain PyTorch attention on (B, N, H, D): fp32 scores and softmax,
    keys >= n_real masked with -1e30, probabilities cast to the input dtype
    before the P.V product (as the bf16 kernels do)."""
    p = torch.softmax(_scores(q, k, n_real), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v).to(q.dtype)


def attention_reference_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, n_real: int | None = None):
    """``attention_reference`` plus the per-row log2-sum-exp of the scaled
    scores, fp32 (B, H, N): m + log2(l) in the log2 domain of the TPU
    kernel's ``_attn_body``."""
    s2 = _scores(q, k, n_real) * _LOG2E
    m = s2.amax(dim=-1, keepdim=True)
    e = torch.exp2(s2 - m)
    lse = (m + torch.log2(e.sum(dim=-1, keepdim=True)))[..., 0]
    p = torch.exp2(s2 - lse[..., None]).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v).to(q.dtype), lse


def attention_bwd_reference(q, k, v, o, lse, do, n_real: int | None = None):
    """Plain PyTorch backward of ``_bwd_body`` over materialised (N, N)
    tensors: p = exp2(s * scale * log2(e) - lse), dv = p^T.do with p in the
    input dtype, ds = p (do.v^T - rowsum(do*o)) scale in the input dtype,
    dq = ds.k, dk = ds^T.q; fp32 accumulation, results in the inputs'
    dtypes."""
    dt, d = q.dtype, q.shape[-1]
    p = torch.exp2(_scores(q, k, n_real) * _LOG2E - lse[..., None])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # (B, H, N)
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(dt).float(), do.float())
    dp = torch.einsum("bnhd,bmhd->bhnm", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * d**-0.5).to(dt).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k.float())
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q.float())
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _check_args(q, k, v, n_real, quant, bwd_quant=None):
    if quant == "none":  # config-file spelling of "off"
        quant = None
    if quant not in _QUANT_MODES:
        raise ValueError(f"unknown attention quant mode {quant!r}; expected "
                         "None, 'qk8', 'qk8pv8', 'fp8' or 'fp8pv8'")
    if quant is not None:
        raise NotImplementedError(
            f"attention quant mode {quant!r} is not ported yet (ROADMAP "
            "queue 2: K5 for qk8/qk8pv8, K6 for fp8/fp8pv8)")
    if bwd_quant not in (None, "none", "int8"):
        raise ValueError(f"unknown attention bwd_quant mode {bwd_quant!r}; "
                         "expected None or 'int8'")
    if bwd_quant == "int8":
        raise NotImplementedError(
            "attention bwd_quant 'int8' is not ported yet (ROADMAP queue 2, "
            "K7)")
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


class _SavedOutputs(threading.local):
    """Where ``attn_out`` rematerialization keeps the attention outputs.

    While a checkpointed block runs its forward, ``record`` is a list and
    each attention call appends its (o, lse); when the block is recomputed
    for the backward, ``replay`` is that list and each call takes its
    (o, lse) back instead of launching the forward again."""

    record: list | None = None
    replay: list | None = None


_saved = _SavedOutputs()


@contextlib.contextmanager
def record_outputs(store: list):
    """Keep every (o, lse) that attention computes in here into ``store``."""
    prev, _saved.record = _saved.record, store
    try:
        yield
    finally:
        _saved.record = prev


@contextlib.contextmanager
def replay_outputs(store: list):
    """Hand the (o, lse) of ``store`` back, in order, instead of computing."""
    prev, _saved.replay = _saved.replay, list(store)
    try:
        yield
    finally:
        _saved.replay = prev


def _forward_lse(q, k, v, n_real):
    if _saved.replay:
        return _saved.replay.pop(0)
    if q.device.type == "cpu":
        o, lse = attention_reference_lse(q, k, v, n_real)
    else:
        o, lse = _launch_fwd(q, k, v, n_real, with_lse=True)
    if _saved.record is not None:
        _saved.record.append((o.detach(), lse))
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """Attention of a fused (B, N, 3, H, D) q/k/v tensor. The backward
    returns one gradient in that layout, which the kernel writes directly:
    three separate q/k/v views would each cost autograd a zero-filled
    (B, N, 3, H, D) gradient, a copy and a sum."""

    @staticmethod
    def forward(ctx, qkv, n_real):
        o, lse = _forward_lse(*qkv.unbind(2), n_real)
        ctx.save_for_backward(qkv, o, lse)
        ctx.n_real = n_real
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        return _bwd_qkv(*qkv.unbind(2), o, lse, do, ctx.n_real), None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_real: int | None = None,
                    quant: str | None = None,
                    bwd_quant: str | None = None) -> torch.Tensor:
    """Fused multi-head attention; inputs/outputs (B, N, H, D).

    ``n_real``: keys at positions >= n_real get no softmax mass (their
    query rows are still computed, and still reach dk/dv). ``quant`` and
    ``bwd_quant``: only None / "none"; the 8-bit modes raise
    ``NotImplementedError``. CUDA launches are counted in
    ``flash_attention.launches`` (inference forward, K2),
    ``flash_attention_fwd_lse.launches`` (training forward, K3a) and
    ``attention_bwd.launches`` (backward, K3b/K4)."""
    n_real = _check_args(q, k, v, n_real, quant, bwd_quant)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(torch.stack((q, k, v), dim=2), n_real)
    return _forward(q, k, v, n_real)


def flash_attention_qkv(qkv: torch.Tensor, n_real: int | None = None,
                        quant: str | None = None,
                        bwd_quant: str | None = None) -> torch.Tensor:
    """``flash_attention`` of the fused projection output (B, N, 3, H, D):
    the kernels read q, k, v as strided views of it, and under autograd
    its gradient is written in the same layout."""
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, D), got {tuple(qkv.shape)}")
    q, k, v = qkv.unbind(2)
    n_real = _check_args(q, k, v, n_real, quant, bwd_quant)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashAttention.apply(qkv, n_real)
    return _forward(q, k, v, n_real)


def _forward(q, k, v, n_real):
    """The inference forward: K2 on the card, the plain version on the CPU."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, n_real)
    return _launch_fwd(q, k, v, n_real, with_lse=False)[0]


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, n_real: int | None = None):
    """The training forward alone: (o, lse (B, H, N) fp32)."""
    n_real = _check_args(q, k, v, n_real, None)
    if q.device.type == "cpu":
        return attention_reference_lse(q, k, v, n_real)
    return _launch_fwd(q, k, v, n_real, with_lse=True)


def _aligned(t):
    """Rows start on 16-byte boundaries (vector loads of a row)."""
    e = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * e % 16 == 0
                                          for s in t.stride()[:3])


def _check_views(tensors, dtype, what):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what} must lie on one device")
    if dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dtype for t in tensors):
        raise TypeError(f"the CUDA attention kernels take float32 or bfloat16 "
                        f"{what} of one dtype, got "
                        f"{', '.join(str(t.dtype) for t in tensors)}")
    d = tensors[0].shape[-1]
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA attention kernels are built for head_dim "
                         f"{HEAD_DIM}, got {d}")
    for t in tensors:
        if t.stride(3) != 1:
            raise ValueError(f"{what} need a contiguous last (head_dim) axis")
        if dtype == torch.bfloat16 and not _aligned(t):
            # the bf16 kernels stage rows with 16-byte loads
            raise ValueError(f"bf16 {what} rows must start on 16-byte "
                             "boundaries (strides in multiples of 8)")


def _entry(lib, name, n_ptrs, n_floats):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_float] * n_floats + [
        ctypes.c_void_p]
    return fn


def _strides(*ts):
    return (ctypes.c_longlong * (3 * len(ts)))(
        *(s for t in ts for s in t.stride()[:3]))


def _launch_fwd(q, k, v, n_real, with_lse):
    _check_views((q, k, v), q.dtype, "q/k/v")
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.load_library("attention_fwd")
    name = ("maest_attn_fwd_fp32" if q.dtype == torch.float32
            else "maest_attn_fwd_bf16")
    fn = _entry(lib, name, 5, 1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, n, h, n if n_real is None else n_real,
                 _strides(q, k, v, out), d**-0.5 * _LOG2E, stream)
    _build.check(lib, err, name)
    if with_lse:
        flash_attention_fwd_lse.launches += 1
    else:
        flash_attention.launches += 1
    return out, lse


def attention_bwd(q, k, v, o, lse, do, n_real: int | None = None):
    """(dq, dk, dv) of attention from the saved (q, k, v, o, lse) and the
    output gradient ``do``; all (B, N, H, D) but lse (B, H, N) fp32. CUDA
    tensors launch ``csrc/attention_bwd.cu`` (counted in
    ``attention_bwd.launches``), CPU tensors run
    ``attention_bwd_reference``."""
    return _bwd_qkv(q, k, v, o, lse, do, n_real).unbind(2)


def _bwd_qkv(q, k, v, o, lse, do, n_real):
    """The backward as one (B, N, 3, H, D) gradient of q, k, v."""
    if q.device.type == "cpu":
        return torch.stack(attention_bwd_reference(q, k, v, o, lse, do,
                                                   n_real), dim=2)
    # the delta pass reads o and do rows with 16-byte loads
    o, do = (t if t.dtype == q.dtype and t.stride(3) == 1 and _aligned(t)
             else t.to(q.dtype).contiguous() for t in (o, do))
    _check_views((q, k, v, o, do), q.dtype, "q/k/v/o/do")
    b, n, h, d = q.shape
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or (
            not lse.is_contiguous()) or lse.device != q.device:
        raise ValueError("lse must be a contiguous float32 (B, H, N) tensor "
                         "on q's device")
    # one buffer for the three gradients, laid out as the fused qkv
    # projection's output (B, N, 3, H, D)
    grads = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
    dq, dk, dv = grads[:, :, 0], grads[:, :, 1], grads[:, :, 2]
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lib = _build.load_library("attention_bwd")
    name = ("maest_attn_bwd_fp32" if q.dtype == torch.float32
            else "maest_attn_bwd_bf16")
    fn = _entry(lib, name, 10, 2)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, n, h, n if n_real is None else n_real,
                 _strides(q, k, v, o, do, dq, dk, dv),
                 d**-0.5 * _LOG2E, d**-0.5, stream)
    _build.check(lib, err, name)
    attention_bwd.launches += 1
    return grads


flash_attention.launches = 0
flash_attention_fwd_lse.launches = 0
attention_bwd.launches = 0
