"""The softmax-arithmetic probes of the attention forward, port of
``scripts/attn_vpu_probe.py`` (``_variant_kernel``, :54).

The rig asks which part of the softmax the cheaper 8-bit products would
expose. ``attention_vpu_probe(q, k, v, kind, n_real=None, n_pad=None)``
takes and returns (B, N, H, 64) bf16, walks 64-key tiles with fp32 l and
acc, and computes, with x the scaled scores:

- ``bf16sm``: bf16 q.k; x = bf16(s * scale * log2(e)), keys >= n_real at
  bf16(-1e30); the running max m, x - m and p = exp2(x - m) in bf16, corr
  = exp2(fp32(bf16(m_old - m))) in fp32; l sums the bf16 p; bf16 p.v.
- ``fp8sm``: as bf16sm on e4m3 q and k (cast with no scale).
- ``fp8noexp``: e4m3 q.k; x in fp32, keys >= n_real at -1e30; p =
  exp2(x - 32) with no max and no correction; bf16(p).v.
- ``fp8nomask``: fp8sm with no key mask, over every key up to ``n_pad``
  (default the rig's, N rounded up to 128): the zero keys from N on each
  add exp2(bf16(0 - m)) to l and nothing to acc. The rig's function, not
  attention.
- ``fp8lean``: q pre-scaled by scale * log2(e) in fp32, then q, k and v
  cast to e4m3; the online softmax in fp32 and e4m3(p).e4m3(v): K6's
  fp8pv8 loop on a pre-scaled q.

On CUDA tensors the wrapper casts (the casts are PyTorch ops, XLA in the
rig) and launches ``csrc/attention_probe.cu`` (bf16sm: K2's template,
``csrc/attn_fwd_bf16.cuh``; the fp8 kinds: K5/K6's, ``csrc/attn_fwd_q8.cuh``),
counted per kind in ``attention_vpu_probe.launches``; on CPU tensors it
runs ``attention_vpu_probe_reference``, which walks the same tiles and
rounds where the kernel rounds, but for one rounding: the kernel's packed
exp2 (``ex2.approx.ftz.bf16x2``, relative error at most 2^-7 by the PTX
ISA) is not the plain version's exact exp2 rounded to bf16 (2^-8). Both
feed the same p to l and acc, and the errors of the p of one row, one a
key, average out in o = sum p v / sum p: ``plain_gap`` holds a kernel to
its plain version by relative L2 and by a few bf16 ulps of max|o|.
"""

from __future__ import annotations

import math

import torch

from .attention import _LOG2E, _NEG_INF, _check_views, _seq_major, to_e4m3
from .attention_probe import BLOCK_K, _check_qkv, launch_bf16, launch_q8

KINDS = ("bf16sm", "fp8sm", "fp8noexp", "fp8nomask", "fp8lean")
NOEXP_SHIFT = 32.0  # fp8noexp's constant max (attn_vpu_probe.py:67)
# kernel vs plain (``plain_gap``): the output's bf16 rounding, PLAIN_ULPS
# ulps of max|o|; for the kinds of the packed ex2 also EXP2_REL max|o|, its
# relative error in each p, which averages out over the keys of a row (a
# statistical bound, not a worst case); and PLAIN_REL_L2 of |o| in all:
# the packed ex2 kinds lay 3.3e-3 to 3.4e-3 from plain on an H100 SXM
# (700 W) at (3, 100), (2, 1676) and (32, 1676)
PLAIN_ULPS = 2
EXP2_REL = 2.0**-7
PLAIN_REL_L2 = 1e-2
_BF16SM = 5                                               # maest::FwdVariant
_MODE = {"fp8sm": 5, "fp8noexp": 6, "fp8nomask": 7, "fp8lean": 3}  # Q8Mode
_BF16_SOFTMAX = ("bf16sm", "fp8sm", "fp8nomask")


def _walk_of(n: int, kind: str, n_real, n_pad) -> tuple[int, int]:
    """(n_real, keys walked) of ``kind`` at sequence length n, validated."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention vpu probe kind {kind!r}; "
                         f"expected one of {', '.join(KINDS)}")
    nr = n if n_real is None else n_real
    if not 1 <= nr <= n:
        raise ValueError(f"n_real={n_real} must lie in 1..{n}")
    if kind != "fp8nomask":
        if n_pad is not None:
            raise ValueError(f"{kind} masks the keys past n_real and takes "
                             "no n_pad (only fp8nomask walks the padding)")
        return nr, nr
    if nr != n:
        raise ValueError("fp8nomask masks no key: it takes n_real = N only, "
                         f"got n_real={n_real} of {n}")
    walk = -(-n // 128) * 128 if n_pad is None else n_pad
    if walk < n or walk % BLOCK_K:
        raise ValueError(f"n_pad={n_pad} must be a multiple of {BLOCK_K} at "
                         f"or past N = {n}")
    return nr, walk


def _check(q, k, v, kind, n_real, n_pad):
    """Validate; return (n_real, keys walked) as ints."""
    _check_qkv(q, k, v, n_real)
    return _walk_of(q.shape[1], kind, n_real, n_pad)


def plain_gap(kind: str, out: torch.Tensor,
              ref: torch.Tensor) -> tuple[float, float, float]:
    """(max|out - ref|, its bound, |out - ref| / |ref|) of the ``kind``
    kernel's output against its plain version; within when the first is at
    most the second and the third at most PLAIN_REL_L2."""
    o, r = out.float(), ref.float()
    top = r.abs().max().item()
    tol = PLAIN_ULPS * 2.0 ** (math.frexp(top)[1] - 8)  # bf16 ulps of top
    if kind in _BF16_SOFTMAX:
        tol += EXP2_REL * top
    return ((o - r).abs().max().item(), tol,
            ((o - r).norm() / r.norm()).item())


def attention_vpu_probe_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, kind: str,
                                  n_real: int | None = None,
                                  n_pad: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``attention_vpu_probe``: the same 64-key
    tiles, products exact in fp32 (bf16 and e4m3 operands) and summed in
    fp32, rounding where the kernel rounds; bf16 arithmetic as PyTorch's
    (each op in fp32, rounded to bf16)."""
    nr, walk = _check(q, k, v, kind, n_real, n_pad)
    d = q.shape[-1]
    sl = d**-0.5 * _LOG2E
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, D)
    if kind == "bf16sm":
        qa, ka = qh.float(), kh.float()
    elif kind == "fp8lean":
        qa, ka, sl = to_e4m3(qh.float() * sl).float(), to_e4m3(kh).float(), 1.0
    else:
        qa, ka = to_e4m3(qh).float(), to_e4m3(kh).float()
    va = to_e4m3(vh).float() if kind == "fp8lean" else vh.float()
    b, h, n, _ = qa.shape
    if walk > n:  # the zero keys past N (fp8nomask)
        ka, va = (torch.nn.functional.pad(t, (0, 0, 0, walk - n))
                  for t in (ka, va))
    bf16 = kind in _BF16_SOFTMAX
    dt = torch.bfloat16 if bf16 else torch.float32
    neg = torch.tensor(_NEG_INF).to(dt).item()
    m = torch.full((b, h, n, 1), neg, dtype=dt, device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    acc = torch.zeros((b, h, n, d), device=q.device)
    for base in range(0, walk, BLOCK_K):
        hi = min(base + BLOCK_K, ka.shape[2])
        s = qa @ ka[:, :, base:hi].transpose(-1, -2)
        if sl != 1.0:
            s = s * sl
        s = s.to(dt)
        if kind != "fp8nomask" and hi > nr:
            s[..., nr - base:] = neg
        vt = va[:, :, base:hi]
        if kind == "fp8noexp":
            p = torch.exp2(s - NOEXP_SHIFT)
            l += p.sum(dim=-1, keepdim=True)
            acc += p.to(torch.bfloat16).float() @ vt
            continue
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2((m - m_new).float())  # bf16sm: m - m_new in bf16
        p = torch.exp2(s - m_new)               # in bf16 for the bf16 kinds
        l = l * corr + p.float().sum(dim=-1, keepdim=True)
        pv = p.to(torch.float8_e4m3fn) if kind == "fp8lean" else p
        acc = acc * corr + pv.float() @ vt
        m = m_new
    return (acc / l).transpose(1, 2).to(torch.bfloat16)


def vpu_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             kind: str) -> tuple:
    """The PyTorch pass before the ``kind`` kernel (XLA in the rig) on CUDA
    bf16 (B, N, H, 64) views: (q, k, v) as the kernel reads them. bf16sm:
    the views; fp8sm, fp8noexp, fp8nomask: q and k cast to e4m3; fp8lean:
    q scaled by scale * log2(e) in fp32 and cast, k cast, v cast and laid
    out transposed in seq_pos order (``_seq_major``)."""
    _check_qkv(q, k, v, None)
    _check_views((q, k, v), torch.bfloat16, "q/k/v")
    if kind == "bf16sm":
        return q, k, v
    if kind == "fp8lean":
        q8 = to_e4m3(q.float() * (q.shape[-1]**-0.5 * _LOG2E))
        v_in = _seq_major(to_e4m3(v.transpose(1, 2)))
    else:
        q8, v_in = to_e4m3(q), v
    return q8.contiguous(), to_e4m3(k).contiguous(), v_in


def launch_vpu(inputs: tuple, kind: str, n_real: int | None = None,
               n_pad: int | None = None) -> torch.Tensor:
    """The ``kind`` kernel alone on what ``vpu_pass`` made (the rig times
    it so, apart from the pass); bf16 (B, N, H, 64) out."""
    q, k, v = inputs
    nr, walk = _walk_of(q.shape[1], kind, n_real, n_pad)
    if q.device.type != "cuda":
        raise ValueError(f"launch_vpu launches the CUDA kernel; got {q.device}"
                         " tensors (attention_vpu_probe runs the plain version"
                         " there)")
    sl = q.shape[-1]**-0.5 * _LOG2E
    if kind == "bf16sm":
        out = launch_bf16("maest_attn_probe_bf16", _BF16SM, q, k, v, nr, sl)
    else:
        out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
        lean = kind == "fp8lean"  # v: a transposed copy, or a bf16 view
        launch_q8(_MODE[kind], q, k, None, None, v, None, out, walk,
                  1.0 if lean else sl, q if lean else v)
    attention_vpu_probe.launches[kind] += 1
    return out


def attention_vpu_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kind: str, n_real: int | None = None,
                        n_pad: int | None = None) -> torch.Tensor:
    """The ``kind`` forward on (B, N, H, 64) bf16: ``vpu_pass`` and the
    kernel on CUDA tensors, ``attention_vpu_probe_reference`` on CPU
    tensors."""
    _check(q, k, v, kind, n_real, n_pad)
    if q.device.type == "cpu":
        return attention_vpu_probe_reference(q, k, v, kind, n_real, n_pad)
    return launch_vpu(vpu_pass(q, k, v, kind), kind, n_real, n_pad)


attention_vpu_probe.launches = dict.fromkeys(KINDS, 0)
