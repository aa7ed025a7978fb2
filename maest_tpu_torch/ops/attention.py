"""Attention forward and backward, port of ``maest_tpu/ops/attention.py``.

``flash_attention(q, k, v, n_real=None, quant=None, bwd_quant=None)``
takes and returns (B, N, H, D). With gradients off it runs the inference
forward (K2, no lse; K5/K6 under an 8-bit ``quant`` mode). When autograd
records it (grad mode on and an input that requires a gradient) it is a
``torch.autograd.Function``: the forward (K3a, or K5/K6 with ``quant``)
also writes the per-row log2-sum-exp ``lse`` (B, H, N) and saves
(q, k, v, o, lse); the backward (K3b/K4, or K7 with ``bwd_quant="int8"``)
rebuilds the probabilities from lse and returns dq, dk, dv in the inputs'
dtype.

On CUDA tensors each step launches its hand-written kernel
(``csrc/attention_fwd.cu``, ``csrc/attention_bwd.cu``: bf16 on the tensor
cores; fp32 at head_dim 64 on them too, as 3xTF32 products, and at the
other widths in scalar fp32 FMA; ``csrc/attention_fwd_q8.cu`` and
``csrc/attention_bwd_q8.cu``: int8 / e4m3 products, bf16 or fp32 inputs;
any N, strided views). The kernels are built for head_dim 64, 128 and
256, and each also as one instance whose width, a multiple of 64 above
256, is a runtime argument (the ``_dn`` entries); any other head_dim runs
the next of these on inputs zero-padded to its width with its own
softmax scale (``pad_head_dim``). The bf16 forward at head_dim 64 and
128 (65-127 zero-padded) runs the ``wgmma`` / TMA kernel
(``csrc/attn_fwd_wgmma.cuh``, at 128 each row two 64-column chunks), at
256 (129-255 zero-padded) the one of ``csrc/attn_fwd_d256_wgmma.cuh`` (two
consumer warpgroups and no producer warp, O whole), and at every width
above 256 the one of ``csrc/attn_fwd_dn_wgmma.cuh`` (q resident in shared
memory, 192-column output slices); the bf16 backward at head_dim 64 the
one of ``csrc/attn_bwd_wgmma.cuh`` (one score pass per key tile and q
tile), at head_dim 256 (and 129-255, zero-padded) the two of
``csrc/attn_bwd_d256_wgmma.cuh`` (a dk/dv and a dq kernel, each tile's
work split between two consumer warpgroups), above 256 those of
``csrc/attn_bwd_dn_wgmma.cuh`` (a scores kernel that writes p and ds once
in bf16, then dv, dk and dq as products over them), the int8 backward in bf16 at head_dim 64
the s8 ``wgmma`` kernels of ``csrc/attn_bwd_q8_wgmma.cuh``, and the 8-bit
forwards in bf16 at head_dim 64 the s8 / bf16 / e4m3 ``wgmma`` kernel of
``csrc/attn_fwd_q8_wgmma.cuh`` behind its CUDA quantisation pass; their
``mma.sync`` controls stay as ``attention_fwd_mma`` (the bf16 forwards),
``attention_bwd_mma`` (both bf16 backwards), ``attention_bwd_int8_mma`` and
``attention_fwd_q8_mma``. The fp32 forward
and backward at head_dim 64 run the tf32 ``wgmma`` kernels of
``csrc/attn_fwd_tf32.cuh`` and ``csrc/attn_bwd_tf32.cuh`` (each product
three tf32 products of split operands, ``tf32_split``); their scalar FMA
controls stay as ``attention_fwd_fp32_fma`` and
``attention_bwd_fp32_fma``. On CPU
tensors it runs the plain PyTorch version (``attention_reference``,
``attention_reference_lse``, ``attention_bwd_reference``,
``attention_q8_reference``, ``attention_bwd_int8_reference``). Production
keeps one tile per kernel and one backward design for every N (the TPU's
full-K / split switch has no counterpart); the TPU kernels' block tuning,
head grouping and sublane padding live as probe instances of the same
templates in ``ops/attention_probe.py`` (``attention_probe_tile``,
``attention_bwd_tile``, ``attention_probe_gh``, ``attention_probe_qpad``),
which the measurement rigs run. Two TPU blockings are semantics, not
tuning, and are kept: the
8-bit forward rounds p against the running max of its key blocks (the
kernel's key tile: 128 keys, ``Q8_WG_BLOCK_K``, on the wgmma route, bf16
at head_dim 64; 64, ``Q8_BLOCK_K``, on the mma.sync kernel, its control
and every other instance: ``q8_block_k``), and the int8 backward's scales
are taken over the TPU's q blocks (``bwd_q_block``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from . import _build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
HEAD_DIM = 64               # the probe kernels' head_dim
HEAD_DIMS = (HEAD_DIM, 128, 256)  # the production kernels' fixed widths
# the key tiles of the head_dim-64 wgmma forward (K2, K3a and the bf16s
# and gh probes), one of them chosen by wg_key_tile; and of the head_dim-128
# one, chosen by wg128_key_tile
WG_KEY_TILES = (96, 112)
WG128_KEY_TILES = (80, 96)

_QUANT_MODES = (None, "qk8", "qk8pv8", "fp8", "fp8pv8")


def _scale(x, scale):
    """The softmax scale: ``scale``, or head_dim^-0.5 of x (B, N, H, D)."""
    return x.shape[-1]**-0.5 if scale is None else scale


def wg_key_tile(n_real: int, tiles=WG_KEY_TILES) -> int:
    """The key tile the head_dim-64 ``wgmma`` forward takes at ``n_real``
    real keys, as ``csrc/attn_fwd_wgmma.cuh wg_key_tile`` chooses it: 112
    where it pads them less than 96 does, else 96; of ``tiles`` (small,
    big) in general."""
    small, big = tiles
    return big if -(-n_real // big) * big < -(-n_real // small) * small \
        else small


def wg128_key_tile(n_real: int) -> int:
    """The key tile the head_dim-128 ``wgmma`` forward takes, as
    ``csrc/attn_fwd_wgmma.cuh wg128_key_tile`` chooses it: 96 where it pads
    ``n_real`` less than 80 does, else 80."""
    return wg_key_tile(n_real, WG128_KEY_TILES)


def _scores(q, k, n_real, scale=None):
    """fp32 scaled scores (B, H, N, N), keys >= n_real at -1e30."""
    n = q.shape[1]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * _scale(
        q, scale)
    if n_real is not None and n_real < n:
        s[..., n_real:] = _NEG_INF
    return s


# Every plain version takes ``scale``, the softmax scale, which defaults to
# head_dim^-0.5: on inputs zero-padded along head_dim (``pad_head_dim``) the
# caller passes the scale of the unpadded head_dim.
def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_real: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch attention on (B, N, H, D): fp32 scores and softmax,
    keys >= n_real masked with -1e30, probabilities cast to the input dtype
    before the P.V product (as the bf16 kernels do)."""
    p = torch.softmax(_scores(q, k, n_real, scale), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v).to(q.dtype)


def attention_reference_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, n_real: int | None = None,
                            scale: float | None = None):
    """``attention_reference`` plus the per-row log2-sum-exp of the scaled
    scores, fp32 (B, H, N): m + log2(l) in the log2 domain of the TPU
    kernel's ``_attn_body``."""
    s2 = _scores(q, k, n_real, scale) * _LOG2E
    m = s2.amax(dim=-1, keepdim=True)
    e = torch.exp2(s2 - m)
    lse = (m + torch.log2(e.sum(dim=-1, keepdim=True)))[..., 0]
    p = torch.exp2(s2 - lse[..., None]).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v).to(q.dtype), lse


def attention_bwd_reference(q, k, v, o, lse, do, n_real: int | None = None,
                            scale: float | None = None):
    """Plain PyTorch backward of ``_bwd_body`` over materialised (N, N)
    tensors: p = exp2(s * scale * log2(e) - lse), dv = p^T.do with p in the
    input dtype, ds = p (do.v^T - rowsum(do*o)) scale in the input dtype,
    dq = ds.k, dk = ds^T.q; fp32 accumulation, results in the inputs'
    dtypes."""
    dt, scale = q.dtype, _scale(q, scale)
    p = torch.exp2(_scores(q, k, n_real, scale) * _LOG2E - lse[..., None])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # (B, H, N)
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(dt).float(), do.float())
    dp = torch.einsum("bnhd,bmhd->bhnm", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k.float())
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q.float())
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


BWD_KEY_TILE = 128  # the wgmma backward's keys a block
BWD_Q_TILE = 64     # and its q rows a streamed tile
_BWD_WG_KEYS = 64   # keys a consumer warpgroup: its own partial of dq
# the wgmma backward at head_dim 256: its dk/dv kernel's keys a block and q
# rows a streamed tile; its dq kernel sums dq over key tiles of 64 in order
BWD_D256_KEY_TILE = 64
BWD_D256_Q_TILE = 64
# the wgmma backward above 256: dv and dk summed over q tiles of
# BWD_DN_Q_TILE rows, dq over key tiles of BWD_DN_KEY_TILE, each in
# increasing order, from p and ds written once in bf16 by a scores kernel
# of BWD_DN_KEYS keys a block; each product block writes BWD_DN_COLS
# columns of its gradient (its column slice: no score is formed again)
BWD_DN_KEY_TILE = 64
BWD_DN_Q_TILE = 64
BWD_DN_KEYS = 128
BWD_DN_COLS = 192
# the wgmma forward at head_dim 256: key tiles of FWD_D256_KEY_TILE keys
FWD_D256_KEY_TILE = 64


def attention_bwd_tiled_reference(q, k, v, o, lse, do,
                                  n_real: int | None = None,
                                  scale: float | None = None,
                                  key_tile: int = BWD_KEY_TILE,
                                  q_tile: int = BWD_Q_TILE):
    """``attention_bwd_reference``'s function, walked over the tiles of the
    ``wgmma`` backward (``csrc/attn_bwd_wgmma.cuh``; at head_dim 256, with
    ``BWD_D256_KEY_TILE`` and ``BWD_D256_Q_TILE``, those of
    ``csrc/attn_bwd_d256_wgmma.cuh``, whose dq kernel sums its one
    64-key slice a tile in the same order; above 256, with
    ``BWD_DN_KEY_TILE`` and ``BWD_DN_Q_TILE``, those of
    ``csrc/attn_bwd_dn_wgmma.cuh``, whose products sum dv and dk over the
    q tiles and dq over the key tiles of p and ds as its scores kernel
    rounded them) in its order: per key
    tile of ``key_tile`` keys, every q tile of ``q_tile`` rows in turn
    forms s and dp once, p = exp2(s scale log2(e) - lse) (keys >= n_real
    at 0) and ds = p (dp - delta) scale, each rounded to the input dtype,
    and adds p^T.do and ds^T.q to the tile's dv and dk; the tile's ds.k,
    summed over its 64-key warpgroup slices in order, is added to dq, key
    tile after key tile in increasing order. fp32 sums, results in the
    inputs' dtypes; key tiles wholly at or past n_real leave zero dk and
    dv."""
    dt, scale = q.dtype, _scale(q, scale)
    sl = scale * _LOG2E
    n = q.shape[1]
    nr = n if n_real is None else n_real
    qh, kh, vh, oh, doh = (x.float() for x in _heads(q, k, v, o, do))
    delta = (doh * oh).sum(-1)  # (B, H, N)
    dq = None
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for k0 in range(0, nr, key_tile):
        ks = slice(k0, min(k0 + key_tile, n))
        live = torch.arange(k0, ks.stop, device=q.device) < nr
        part = torch.empty_like(qh)
        for q0 in range(0, n, q_tile):
            qs = slice(q0, min(q0 + q_tile, n))
            s = qh[:, :, qs] @ kh[:, :, ks].transpose(-1, -2) * sl
            p = torch.where(live, torch.exp2(s - lse[:, :, qs, None]), 0.0)
            dv[:, :, ks] += p.to(dt).float().transpose(-1, -2) @ doh[:, :, qs]
            dp = doh[:, :, qs] @ vh[:, :, ks].transpose(-1, -2)
            ds = (p * (dp - delta[:, :, qs, None]) * scale).to(dt).float()
            part[:, :, qs] = sum(
                ds[..., w0:w0 + _BWD_WG_KEYS]
                @ kh[:, :, k0 + w0:min(k0 + w0 + _BWD_WG_KEYS, n)]
                for w0 in range(0, ks.stop - k0, _BWD_WG_KEYS))
            dk[:, :, ks] += ds.transpose(-1, -2) @ qh[:, :, qs]
        dq = part if dq is None else dq + part
    dq, dk, dv = _heads(dq, dk, dv)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def attention_fwd_tiled_reference(q, k, v, n_real: int | None = None,
                                  scale: float | None = None,
                                  key_tile: int = FWD_D256_KEY_TILE):
    """``attention_reference_lse``'s function, walked over the key tiles of
    the ``wgmma`` forward at head_dim 256 (``csrc/attn_fwd_d256_wgmma.cuh``)
    in its order: per tile of ``key_tile`` keys, fp32 scores scaled by
    scale log2(e) (keys >= n_real at -1e30), the running max m, o and the
    running sum l rescaled by exp2(m_old - m), p = exp2(s - m) summed into
    l in fp32 and rounded to the input dtype for P.V (fp32 sums); o / l at
    the end in the input dtype, lse = m + log2(l) (B, H, N) fp32."""
    dt, scale = q.dtype, _scale(q, scale)
    n = q.shape[1]
    nr = n if n_real is None else n_real
    qh, kh, vh = (x.float() for x in _heads(q, k, v))
    m = torch.full(qh.shape[:3], _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qh)
    for k0 in range(0, nr, key_tile):
        ks = slice(k0, min(k0 + key_tile, n))
        s = qh @ kh[:, :, ks].transpose(-1, -2) * (scale * _LOG2E)
        live = torch.arange(k0, ks.stop, device=q.device) < nr
        s = torch.where(live, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + p.to(dt).float() @ vh[:, :, ks]
        m = m_new
    out = _heads(o / l[..., None])[0].to(dt)
    return out, m + torch.log2(l)


# --- fp32 at head_dim 64: 3xTF32 (csrc/attn_fwd_tf32.cuh, attn_bwd_tf32.cuh) -
TF32_KEY_TILE = 64      # the tf32 forward's keys a tile
TF32_PV_CHAIN = 16      # and the keys of each fresh chain of its P.V
TF32_BWD_Q_TILE = 32    # the tf32 dk/dv kernel's q rows a tile
TF32_BWD_KEY_TILE = 32  # the tf32 dq kernel's keys a tile


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to tf32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds it, returned as fp32: the low 13
    bits of the magnitude rounded off by integer arithmetic on the bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) of fp32 x: hi = tf32_round(x), lo = tf32_round(x - hi), the
    kernels' split (x - hi is exact in fp32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32_matmul(a, b, terms: int = 3):
    """a @ b as the tf32 kernels form one tile's product: 3 ``terms``
    (lo.hi and hi.lo, then hi.hi, added in that order; each product exact
    in fp32, the sums fp32), or 1 (hi.hi alone, one tf32 product)."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def tf32_pos(r):
    """The position of sequence row ``r`` (an int or an integer tensor) in
    the tf32 kernels' transposed copies (``csrc/attn_fwd_tf32.cuh``
    tf_pos_of): within each 8-row group, row 2a + c sits at 4c + a, the
    order in which the fp32 accumulator of an m64nN product hands thread t
    its columns (2t, 2t + 1 of each 8), so that the accumulator, packed as
    it lies, is the next product's tf32 register-A fragment (k positions t
    and t + 4 of each 8-deep k-step)."""
    i = r & 7
    return (r & ~7) + (i & 1) * 4 + (i >> 1)


def _tf32_by_position(x, n_pad: int):
    """x (..., N, D) -> (..., D, n_pad): position tf32_pos(r) holds row r,
    zeros past N (the tf32 kernels' transposed copies)."""
    out = x.new_zeros(x.shape[:-2] + (x.shape[-1], n_pad))
    out[..., tf32_pos(torch.arange(x.shape[-2], device=x.device))] = (
        x.transpose(-1, -2))
    return out


def attention_tf32_reference(q, k, v, n_real: int | None = None,
                             scale: float | None = None, terms: int = 3):
    """The fp32 forward as the tf32 kernel computes it, on fp32 (B, N, H, D):
    (o, lse). Per key tile of TF32_KEY_TILE in order: s = Q.K^T by
    ``tf32_matmul`` with ``terms`` products, scaled by scale log2(e), keys
    >= n_real at -1e30, the running max and sum, o = o corr + P.V with the
    tile's P.V in chains of TF32_PV_CHAIN keys, each by ``tf32_matmul`` (a
    fresh sum) added to o in fp32 in turn; o / l at the end, lse = m +
    log2(l). With terms=1 it is the one-product kernel a planted fault
    builds."""
    n = q.shape[1]
    nr = n if n_real is None else n_real
    sl = _scale(q, scale) * _LOG2E
    qh, kh, vh = (x.float() for x in _heads(q, k, v))
    m = torch.full(qh.shape[:-1] + (1,), _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qh)
    for base in range(0, nr, TF32_KEY_TILE):
        ks = slice(base, min(base + TF32_KEY_TILE, n))
        s = tf32_matmul(qh, kh[:, :, ks].transpose(-1, -2), terms) * sl
        if ks.stop > nr:
            s[..., nr - base:] = _NEG_INF
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        vt = vh[:, :, ks]
        o = o * corr
        for c in range(0, ks.stop - base, TF32_PV_CHAIN):
            o = o + tf32_matmul(p[..., c:c + TF32_PV_CHAIN],
                                vt[:, :, c:c + TF32_PV_CHAIN], terms)
        m = m_new
    return (o / l).transpose(1, 2).to(q.dtype), (m + torch.log2(l))[..., 0]


def attention_bwd_tf32_reference(q, k, v, o, lse, do,
                                 n_real: int | None = None,
                                 scale: float | None = None, terms: int = 3):
    """The fp32 backward as the tf32 kernels compute it: delta =
    rowsum(do o); the dq kernel's key tiles of TF32_BWD_KEY_TILE in order,
    each forming s = Q.K^T and dp = dO.V^T, p = exp2(s scale log2(e) - lse)
    (keys >= n_real at 0), ds = p (dp - delta) scale, dq += dS.K; the dk/dv
    kernel's q tiles of TF32_BWD_Q_TILE, the even ones summed, then the odd
    ones, then the two added, each adding P^T.dO to dv and dS^T.Q to dk;
    each tile's product by ``tf32_matmul`` with ``terms`` products (a fresh
    sum, added in fp32). Masked keys get exactly zero dk and dv."""
    n = q.shape[1]
    nr = n if n_real is None else n_real
    scale = _scale(q, scale)
    sl = scale * _LOG2E
    qh, kh, vh, oh, doh = (x.float() for x in _heads(q, k, v, o, do))
    delta = (doh * oh).sum(-1)  # (B, H, N)
    live = torch.arange(n, device=q.device) < nr

    def p_ds(qs, ks):
        s = tf32_matmul(qh[:, :, qs], kh[:, :, ks].transpose(-1, -2),
                        terms) * sl
        p = torch.where(live[ks], torch.exp2(s - lse[:, :, qs, None]), 0.0)
        dp = tf32_matmul(doh[:, :, qs], vh[:, :, ks].transpose(-1, -2), terms)
        return p, p * (dp - delta[:, :, qs, None]) * scale

    rows = slice(0, n)
    dq = torch.zeros_like(qh)
    for k0 in range(0, nr, TF32_BWD_KEY_TILE):
        ks = slice(k0, min(k0 + TF32_BWD_KEY_TILE, n))
        dq = dq + tf32_matmul(p_ds(rows, ks)[1], kh[:, :, ks], terms)
    parts = []
    for first in (0, TF32_BWD_Q_TILE):  # the two consumers' q tiles
        dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
        for q0 in range(first, n, 2 * TF32_BWD_Q_TILE):
            qs = slice(q0, min(q0 + TF32_BWD_Q_TILE, n))
            p, ds = p_ds(qs, rows)
            dv = dv + tf32_matmul(p.transpose(-1, -2), doh[:, :, qs], terms)
            dk = dk + tf32_matmul(ds.transpose(-1, -2), qh[:, :, qs], terms)
        parts.append((dk, dv))
    dq, dk, dv = _heads(dq, parts[0][0] + parts[1][0],
                        parts[0][1] + parts[1][1])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- 8-bit modes (K5, K6, K7) ---------------------------------------------
Q8_BLOCK_K = 64      # the mma.sync 8-bit forward's key tile (the control's)
Q8_WG_BLOCK_K = 128  # the wgmma 8-bit forward's (bf16 at head_dim 64)
_EPS = 1e-30     # scale floor: all-zero rows and heads stay finite
# |x| above 464 rounds past e4m3's largest finite value (448, ties to even)
_E4M3_OVERFLOW = 464.0


def _div(x, c: float) -> torch.Tensor:
    """x / c, rounded once. PyTorch's CUDA kernels multiply by the
    reciprocal of a Python-scalar divisor, which can land one ulp off the
    TPU package's division."""
    return x / torch.full_like(x, c)


def _rdiv(c: float, x) -> torch.Tensor:
    """c / x, rounded once (``c / tensor`` is ``reciprocal(x) * c``)."""
    return torch.full_like(x, c) / x


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 over the last axis (copy of the JAX package's
    ``_quantize_rows``): x (..., d) -> (int8 values, fp32 scales (...,)),
    scale max(amax, 1e-30) / 127, values round(x / scale) half to even."""
    xf = x.float()
    scales = _div(torch.clamp_min(xf.abs().amax(dim=-1), _EPS), 127.0)
    return torch.round(xf / scales[..., None]).to(torch.int8), scales


def quantize_tensor(x: torch.Tensor, dim=None):
    """Symmetric int8 with one scale (copy of ``_q8_tensor``): over all of
    ``x``, or over the axes ``dim`` (one scale per the rest, kept as size-1
    axes). scale = max(amax, 1e-30) * (1/127); values round(x * (1/scale))
    half to even: a multiply by the reciprocal, as the TPU kernel does."""
    xf = x.float()
    amax = xf.abs().amax() if dim is None else xf.abs().amax(dim=dim,
                                                              keepdim=True)
    scale = torch.clamp_min(amax, _EPS) * (1.0 / 127.0)
    return torch.round(xf * (1.0 / scale)).to(torch.int8), scale


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x cast to float8_e4m3fn as the JAX package casts it: round to nearest
    even, and NaN where the value rounds past 448 (torch's own cast
    saturates to +-448 there)."""
    xf = x.float()
    return torch.where(xf.abs() > _E4M3_OVERFLOW, float("nan"), xf).to(
        torch.float8_e4m3fn)


def _heads(*ts):
    return [t.transpose(1, 2) for t in ts]  # (B, N, H, D) -> (B, H, N, D)


def q8_block_k(q: torch.Tensor) -> int:
    """The key tile of the 8-bit forward kernel that q's route runs, and so
    the ``block_k`` of its plain version: ``Q8_WG_BLOCK_K`` (128, the JAX
    kernel's own floor, ``_pick_block``) for bf16 at head_dim 64 (or less,
    zero-padded to 64), the wgmma route; ``Q8_BLOCK_K`` (64) for every other
    instance, the mma.sync kernel's. The route's control
    (``attention_fwd_q8_mma``) keeps 64 at bf16 head_dim 64 too."""
    wg = q.dtype == torch.bfloat16 and padded_dim(q.shape[-1]) == HEAD_DIM
    return Q8_WG_BLOCK_K if wg else Q8_BLOCK_K


def attention_q8_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_real: int | None = None, quant: str = "qk8",
                           block_k: int | None = None,
                           scale: float | None = None):
    """Plain PyTorch forward of an 8-bit mode on (B, N, H, D): (o, lse).

    The arithmetic of ``_attn_body_q8`` ("qk8", "qk8pv8") and of
    ``_attn_body`` on e4m3 operands ("fp8", "fp8pv8"), walked over key
    blocks of ``block_k`` (by default ``q8_block_k(q)``, the tile of the
    kernel q's route runs): p is taken against the running max of the
    blocks seen so far, so its 8-bit (or bf16) rounding depends on the
    blocks.
    int8 products are integers, summed exactly in float64 (|sum| < 2^24,
    so the fp32 value is the TPU's int32 one); e4m3 products are exact in
    fp32 (4-bit mantissas), so those run in fp32 and round only in the
    sums, as the kernels' fp32 accumulators do."""
    if quant not in _QUANT_MODES[1:]:
        raise ValueError(f"unknown attention quant mode {quant!r}")
    b, n, h, d = q.shape
    nr = n if n_real is None else n_real
    if block_k is None:
        block_k = q8_block_k(q)
    sl = _scale(q, scale) * _LOG2E
    qh, kh, vh = _heads(q, k, v)
    int8 = quant in ("qk8", "qk8pv8")
    if int8:
        qi, sq = quantize_rows(qh)
        ki, sk = quantize_rows(kh)
        qa, ka, qs = qi.double(), ki.double(), sq * sl
    else:
        qa, ka = to_e4m3(qh).float(), to_e4m3(kh).float()
    if quant == "qk8pv8":
        sv = _div(torch.clamp_min(vh.float().abs().amax(dim=2), _EPS), 127.0)
        va = torch.round(vh.float() / sv[:, :, None]).to(torch.int8).double()
    elif quant == "fp8pv8":
        va = to_e4m3(vh).float()
    else:
        va = vh.float()
    m = torch.full((b, h, n, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    acc = torch.zeros((b, h, n, d), device=q.device)
    # key blocks wholly at or past n_real add exactly nothing (p = 0)
    for base in range(0, nr, block_k):
        hi = min(base + block_k, n)
        s = (qa @ ka[:, :, base:hi].transpose(-1, -2)).float()
        s = s * qs[..., None] * sk[:, :, None, base:hi] if int8 else s * sl
        if hi > nr:
            s[..., nr - base:] = _NEG_INF
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if quant == "qk8pv8":
            pv = (torch.round(p * 127.0).double() @ va[:, :, base:hi]).float()
        elif quant == "fp8pv8":
            pv = p.to(torch.float8_e4m3fn).float() @ va[:, :, base:hi]
        else:  # p rounded to v's dtype, products exact in fp32
            pv = p.to(v.dtype).float() @ va[:, :, base:hi]
        acc = acc * corr + pv
        m = m_new
    if quant == "qk8pv8":
        acc = acc * _div(sv, 127.0)[:, :, None]
    o = (acc / l).transpose(1, 2).to(q.dtype)
    return o, (m + torch.log2(l))[..., 0]


def q8_n_pad(n: int) -> int:
    """N_pad of the wgmma 8-bit forward's copies: whole 128-key tiles."""
    return -(-n // Q8_WG_BLOCK_K) * Q8_WG_BLOCK_K


def q8_pass_reference(q, k, v, quant: str, scale: float | None = None):
    """Plain version of the wgmma 8-bit forward's quantisation pass
    (``csrc/attn_fwd_q8_wgmma.cuh``) on (B, N, H, 64) q, k, v: what it
    writes, as a dict of (B H, ...) tensors, N_pad = ``q8_n_pad(N)``:

    * ``q8``, ``k8`` (B H, N_pad, 64): the int8 codes of ``quantize_rows``
      as uint8 ("qk8", "qk8pv8"), or the values of ``to_e4m3`` as bf16
      ("fp8", "fp8pv8": the kernel multiplies them on bf16 tensor cores,
      whose fp32 sums hold the plain version's bounds where e4m3 ones do
      not), zeros past N;
    * ``qsl``, ``sk`` (B H, N_pad) fp32, int8 modes: the rows' scales, q's
      times scale log2(e), zeros past N (``None`` in the e4m3 modes);
    * ``vmax`` (B H, 64) fp32, "qk8pv8": max|v| per (head, column);
    * ``v8t`` (B H, 64, N_pad) uint8, pv8 modes: v's int8 codes (scale
      max(vmax, 1e-30) / 127 a column) or e4m3 bytes, transposed, row r of
      the sequence at ``seq_pos(r)``, zeros past N.

    The e4m3 NaN of an overflow is 0x7f; compare NaN as NaN."""
    b, n, h, d = q.shape
    n_pad = q8_n_pad(n)
    sl = _scale(q, scale) * _LOG2E
    qh, kh, vh = (t.reshape(b * h, n, d) for t in _heads(q, k, v))
    pad = (0, 0, 0, n_pad - n)
    out = {"qsl": None, "sk": None, "vmax": None, "v8t": None}
    if quant in ("qk8", "qk8pv8"):
        (q8, sq), (k8, sk) = quantize_rows(qh), quantize_rows(kh)
        out["qsl"] = F.pad(sq * sl, (0, n_pad - n))
        out["sk"] = F.pad(sk, (0, n_pad - n))
        q8, k8 = q8.view(torch.uint8), k8.view(torch.uint8)
    else:
        q8, k8 = (to_e4m3(t).to(torch.bfloat16) for t in (qh, kh))
    out["q8"], out["k8"] = F.pad(q8, pad), F.pad(k8, pad)
    if quant == "qk8pv8":
        vmax = vh.float().abs().amax(dim=1)
        sv = _div(torch.clamp_min(vmax, _EPS), 127.0)
        v8 = torch.round(vh.float() / sv[:, None]).to(torch.int8)
        out["vmax"] = vmax
    elif quant == "fp8pv8":
        v8 = to_e4m3(vh)
    if quant.endswith("pv8"):
        out["v8t"] = _by_position(v8.view(torch.uint8), n_pad)
    return out


def q8_pass_views(bytes8, scratch, b: int, n: int, h: int, quant: str):
    """The wgmma 8-bit forward's pass outputs, its byte and float scratch
    as the route allocates them (``maest_attn_fwd_<quant>_bytes`` /
    ``_scratch``), viewed as ``q8_pass_reference`` returns them."""
    bh, n_pad = b * h, q8_n_pad(n)
    int8 = quant in ("qk8", "qk8pv8")
    plane = bh * n_pad * 64 * (1 if int8 else 2)  # bytes of q8, k8
    u8 = bytes8.view(torch.uint8)
    qk = (lambda x: x) if int8 else (lambda x: x.view(torch.bfloat16))
    out = {"q8": qk(u8[:plane]).view(bh, n_pad, 64),
           "k8": qk(u8[plane:2 * plane]).view(bh, n_pad, 64),
           "qsl": None, "sk": None, "vmax": None, "v8t": None}
    if int8:
        out["qsl"] = scratch[:bh * n_pad].view(bh, n_pad)
        out["sk"] = scratch[bh * n_pad:2 * bh * n_pad].view(bh, n_pad)
    if quant == "qk8pv8":
        out["vmax"] = scratch[2 * bh * n_pad:2 * bh * n_pad + bh * 64].view(
            bh, 64)
    if quant.endswith("pv8"):
        out["v8t"] = u8[2 * plane:2 * plane + bh * 64 * n_pad].view(
            bh, 64, n_pad)
    return out


# The TPU's int8 backward is full-K only; past this n_pad its caller runs
# the bf16 split backward (maest_tpu/ops/attention.py _bwd).
_FULL_K_BWD_MAX_N_PAD = 4096
_BWD_VMEM_ROWS = 896 * 1792


def bwd_q_block(n: int) -> int:
    """The q-block of the int8 backward's scales, for sequence length n.

    A copy of the TPU package's ``_pick_bwd_block(round_up(n, 128))``: the
    largest 128-multiple divisor of n_pad with block * n_pad <= 896 * 1792.
    It is kept as semantics, not tuning: q, do, p and ds each share one
    int8 scale over a (head, q-block), so another blocking moves every int8
    grid and gives other numbers everywhere. One block per head at every
    shipped training shape (n_pad 384, 640, 896, 1152)."""
    n_pad = -(-n // 128) * 128
    best = 128
    for cand in range(128, n_pad + 1, 128):
        if n_pad % cand == 0 and cand * n_pad <= _BWD_VMEM_ROWS:
            best = cand
    return best


def int8_bwd_applies(n: int) -> bool:
    """Whether ``bwd_quant="int8"`` runs the int8 backward (K7) at length
    n; beyond n_pad 4096 the TPU package runs its bf16 backward instead."""
    return -(-n // 128) * 128 <= _FULL_K_BWD_MAX_N_PAD


def attention_bwd_int8_reference(q, k, v, o, lse, do,
                                 n_real: int | None = None,
                                 scale: float | None = None, delta=None):
    """Plain PyTorch int8 backward (``_attn_bwd_kernel_q8``): per (head,
    q-block) scalar scales for q and do, per head for k and v; p and ds
    requantized with their block maxima; all five products int8, summed
    exactly in float64 (an integer sum below 2^53, which fp32 then rounds
    as the TPU's int32 -> fp32 cast does). Every scale product keeps the
    TPU's association order. dq in q's dtype; dk and dv summed over the q
    blocks in fp32, then cast. Beyond n_pad 4096: the bf16 backward.
    ``delta`` (B, H, N) fp32, where given, stands for rowsum(do o), as
    ``k7_delta`` sums it in a kernel's order."""
    b, n, h, d = q.shape
    if not int8_bwd_applies(n):
        return attention_bwd_reference(q, k, v, o, lse, do, n_real, scale)
    nr = n if n_real is None else n_real
    scale = _scale(q, scale)
    sl = scale * _LOG2E
    qh, kh, vh, oh, doh = _heads(q, k, v, o, do)
    k8, ks = quantize_tensor(kh, dim=(2, 3))
    v8, vs = quantize_tensor(vh, dim=(2, 3))
    k8, v8 = k8.double(), v8.double()
    if delta is None:
        delta = (doh.float() * oh.float()).sum(-1)
    delta = delta[..., None]  # (B, H, N, 1)
    dq = torch.empty((b, h, n, d), device=q.device)
    dk = torch.zeros((b, h, n, d), device=q.device)
    dv = torch.zeros((b, h, n, d), device=q.device)
    bq = bwd_q_block(n)
    for r0 in range(0, n, bq):
        r = slice(r0, min(r0 + bq, n))
        q8, qs = quantize_tensor(qh[:, :, r], dim=(2, 3))
        do8, dos = quantize_tensor(doh[:, :, r], dim=(2, 3))
        q8, do8 = q8.double(), do8.double()
        s = (q8 @ k8.transpose(-1, -2)).float() * (qs * ks * sl)
        s[..., nr:] = _NEG_INF
        p = torch.exp2(s - lse[:, :, r, None])
        pst = torch.clamp_min(p.amax(dim=(2, 3), keepdim=True), _EPS)
        p8 = torch.round(p * _rdiv(127.0, pst)).double()
        dv += (p8.transpose(-1, -2) @ do8).float() * (dos * pst * (1.0 / 127.0))
        dp = (do8 @ v8.transpose(-1, -2)).float() * (dos * vs)
        ds = p * (dp - delta[:, :, r]) * scale
        dst = torch.clamp_min(ds.abs().amax(dim=(2, 3), keepdim=True), _EPS)
        ds8 = torch.round(ds * _rdiv(127.0, dst)).double()
        dq[:, :, r] = (ds8 @ k8).float() * (dst * ks * (1.0 / 127.0))
        dk += (ds8.transpose(-1, -2) @ q8).float() * (dst * qs * (1.0 / 127.0))
    dq, dk, dv = _heads(dq, dk, dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def k7_delta(o, do):
    """delta = rowsum(do o) (B, H, N) fp32 of (B, N, H, D) views, D a
    multiple of 64, in the order of the fp32 K7's quant pass
    (``csrc/attention_bwd_q8.cu`` bwd_q8_quant_kernel): lane j of a row's
    four chains the columns 16 j .. 16 j + 15 of each 64 in turn by fp32
    FMA, then (lane 0 + lane 1) + (lane 2 + lane 3). An FMA is the exact
    product plus the sum in float64, rounded to fp32 (exact but where the
    float64 sum rounds onto an fp32 midpoint)."""
    oh, doh = (t.float() for t in _heads(o, do))
    b, h, n, d = oh.shape
    x = doh.reshape(b, h, n, d // 64, 4, 16).double()
    y = oh.reshape(b, h, n, d // 64, 4, 16).double()
    acc = torch.zeros((b, h, n, 4), dtype=torch.float32, device=o.device)
    for hh in range(d // 64):
        for i in range(16):
            acc = (x[..., hh, :, i] * y[..., hh, :, i] + acc.double()).float()
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


K7_KEY_TILE = 128  # the wgmma K7's keys a block
K7_Q_TILE = 64     # and its q rows a streamed tile


def seq_pos(r):
    """The position of sequence row ``r`` (an int or an integer tensor) in
    the transposed 8-bit copies of the int8 backward (``csrc/mma_8bit.cuh``
    seq_pos): within each 16-row group, row 8a + 2t + c sits at 4t + 2a + c,
    the order in which the s32 accumulator of an m16n8k32 or m64nNk32
    product hands thread t its columns (8j + 2t + c), so the accumulator,
    packed as it lies, is the next product's s8 register-A fragment (k
    positions 4t + {0..3} and 16 + 4t + {0..3} of each 32-deep k-step)."""
    i = r & 15
    return (r & ~15) + ((i >> 1) & 3) * 4 + (i >> 3) * 2 + (i & 1)


def _by_position(x, n_pad: int):
    """x (..., N, D) -> (..., D, n_pad): position seq_pos(r) holds row r,
    zeros past N (the kernels' transposed copies)."""
    out = x.new_zeros(x.shape[:-2] + (x.shape[-1], n_pad))
    out[..., seq_pos(torch.arange(x.shape[-2], device=x.device))] = (
        x.transpose(-1, -2))
    return out


def attention_bwd_int8_tiled_reference(q, k, v, o, lse, do,
                                       n_real: int | None = None,
                                       scale: float | None = None,
                                       key_tile: int = K7_KEY_TILE,
                                       q_tile: int = K7_Q_TILE):
    """``attention_bwd_int8_reference``'s function, walked over the tiles of
    the ``wgmma`` K7 (``csrc/attn_bwd_q8_wgmma.cuh``) in its passes: the
    int8 copies and their scales (per (head, q-block) for q and do, per
    head for k and v), then a stats pass over (key tile, q tile) for max p
    and max|ds| per (head, q-block), then the main pass: per key tile,
    every q tile forms s and dp once, p8^T and ds8^T are taken in the order
    the accumulator hands them out (their q columns at ``seq_pos``) and
    contracted with the transposed copies (``_by_position``), dk and dv
    summed per q-block and folded into fp32 at its end, and dq's integer
    sums over the key tiles (in any order: integers) scaled once. Integer
    sums exact in float64. It equals ``attention_bwd_int8_reference``
    exactly. Beyond n_pad 4096: the bf16 backward."""
    b, n, h, d = q.shape
    if not int8_bwd_applies(n):
        return attention_bwd_reference(q, k, v, o, lse, do, n_real, scale)
    nr = n if n_real is None else n_real
    scale = _scale(q, scale)
    sl = scale * _LOG2E
    qh, kh, vh, oh, doh = _heads(q, k, v, o, do)
    k8, ks = quantize_tensor(kh, dim=(2, 3))
    v8, vs = quantize_tensor(vh, dim=(2, 3))
    k8, v8 = k8.double(), v8.double()
    bq = bwd_q_block(n)
    blocks = [slice(r0, min(r0 + bq, n)) for r0 in range(0, n, bq)]
    q8, do8 = torch.empty_like(qh, dtype=torch.float64), torch.empty_like(
        doh, dtype=torch.float64)
    qs, dos = [], []
    for r in blocks:
        for x, x8, scales in ((qh, q8, qs), (doh, do8, dos)):
            codes, xs = quantize_tensor(x[:, :, r], dim=(2, 3))
            x8[:, :, r] = codes.double()
            scales.append(xs)
    delta = (doh.float() * oh.float()).sum(-1, keepdim=True)  # (B, H, N, 1)
    n_pad = -(-n // key_tile) * key_tile
    qt, dot, kt = (_by_position(x, n_pad) for x in (q8, do8, k8))
    # the accumulator's q columns (or keys) at each position of a tile
    order = torch.argsort(seq_pos(torch.arange(q_tile, device=q.device)))
    korder = torch.argsort(seq_pos(torch.arange(key_tile, device=q.device)))
    tiles = [(q0, slice(q0, min(q0 + q_tile, n)), q0 // bq)
             for q0 in range(0, n, q_tile)]

    def scores(ksl, qsl, j):
        """p^T and ds^T (B, H, keys, q rows) of a key tile and a q tile."""
        live = torch.arange(ksl.start, ksl.stop, device=q.device) < nr
        s = (k8[:, :, ksl] @ q8[:, :, qsl].transpose(-1, -2)).float() * (
            qs[j] * ks * sl)
        s = torch.where(live[:, None], s, _NEG_INF)
        p = torch.exp2(s - lse[:, :, None, qsl])
        dp = (v8[:, :, ksl] @ do8[:, :, qsl].transpose(-1, -2)).float() * (
            dos[j] * vs)
        return p, p * (dp - delta[:, :, qsl].transpose(-1, -2)) * scale

    key_tiles = [slice(k0, min(k0 + key_tile, n)) for k0 in range(0, nr,
                                                                  key_tile)]
    pst = [torch.full_like(ks, _EPS) for _ in blocks]
    dst = [torch.full_like(ks, _EPS) for _ in blocks]
    for ksl in key_tiles:  # stats
        for q0, qsl, j in tiles:
            p, ds = scores(ksl, qsl, j)
            pst[j] = torch.maximum(pst[j], p.amax(dim=(2, 3), keepdim=True))
            dst[j] = torch.maximum(dst[j], ds.abs().amax(dim=(2, 3),
                                                         keepdim=True))
    dq_int = torch.zeros((b, h, n, d), dtype=torch.float64, device=q.device)
    dk = torch.zeros((b, h, n, d), device=q.device)
    dv = torch.zeros((b, h, n, d), device=q.device)
    for ksl in key_tiles:  # main
        nk = ksl.stop - ksl.start
        dk_int = dv_int = 0.0
        for q0, qsl, j in tiles:
            p, ds = scores(ksl, qsl, j)
            p8 = torch.round(p * _rdiv(127.0, pst[j])).double()
            ds8 = torch.round(ds * _rdiv(127.0, dst[j])).double()
            m = qsl.stop - q0  # q rows of the tile; positions past them 0
            pad = (0, q_tile - m)
            a_p = F.pad(p8, pad)[..., order]   # as the accumulator lies
            a_ds = F.pad(ds8, pad)[..., order]
            pos = slice(q0, q0 + q_tile)
            dv_int = dv_int + a_p @ dot[..., pos].transpose(-1, -2)
            dk_int = dk_int + a_ds @ qt[..., pos].transpose(-1, -2)
            # dQ: the ds8 tile keys at their K8^T positions
            kpad = (0, 0, 0, key_tile - nk)
            a_q = F.pad(ds8, kpad)[..., korder, :].transpose(-1, -2)
            dq_int[:, :, qsl] += a_q @ kt[..., ksl.start:ksl.start
                                         + key_tile].transpose(-1, -2)
            last = q0 + q_tile >= n or (q0 + q_tile) // bq != j
            if last:  # the q-block's sums into fp32, in order
                dk[:, :, ksl] += dk_int.float() * (dst[j] * qs[j] * (
                    1.0 / 127.0))
                dv[:, :, ksl] += dv_int.float() * (dos[j] * pst[j] * (
                    1.0 / 127.0))
                dk_int = dv_int = 0.0
    dq = torch.empty((b, h, n, d), device=q.device)
    for j, r in enumerate(blocks):
        dq[:, :, r] = dq_int[:, :, r].float() * (dst[j] * ks * (1.0 / 127.0))
    dq, dk, dv = _heads(dq, dk, dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_args(q, k, v, n_real, quant, bwd_quant=None):
    """Validate; return (n_real or None when it is N, quant, bwd_quant) with
    the config-file spelling "none" of off turned into None."""
    if quant == "none":
        quant = None
    if quant not in _QUANT_MODES:
        raise ValueError(f"unknown attention quant mode {quant!r}; expected "
                         "None, 'qk8', 'qk8pv8', 'fp8' or 'fp8pv8'")
    if bwd_quant == "none":
        bwd_quant = None
    if bwd_quant not in (None, "int8"):
        raise ValueError(f"unknown attention bwd_quant mode {bwd_quant!r}; "
                         "expected None or 'int8'")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one (B, N, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n = q.shape[1]
    if n_real is not None and n_real > n:
        raise ValueError(f"n_real={n_real} exceeds the sequence length {n}")
    if n_real is not None and n_real < 1:
        raise ValueError(f"n_real={n_real} must be at least 1")
    return (None if n_real is None or n_real == n else n_real), quant, bwd_quant


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


def _forward_lse(q, k, v, n_real, quant):
    if _saved.replay:
        return _saved.replay.pop(0)
    o, lse = _fwd(q, k, v, n_real, quant, with_lse=True)
    if _saved.record is not None:
        _saved.record.append((o.detach(), lse))
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """Attention of a fused (B, N, 3, H, D) q/k/v tensor. The backward
    returns one gradient in that layout, which the kernel writes directly:
    three separate q/k/v views would each cost autograd a zero-filled
    (B, N, 3, H, D) gradient, a copy and a sum."""

    @staticmethod
    def forward(ctx, qkv, n_real, quant, bwd_quant):
        o, lse = _forward_lse(*qkv.unbind(2), n_real, quant)
        ctx.save_for_backward(qkv, o, lse)
        ctx.n_real, ctx.bwd_quant = n_real, bwd_quant
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        return (_bwd_qkv(*qkv.unbind(2), o, lse, do, ctx.n_real,
                         ctx.bwd_quant), None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_real: int | None = None,
                    quant: str | None = None,
                    bwd_quant: str | None = None) -> torch.Tensor:
    """Fused multi-head attention; inputs/outputs (B, N, H, D).

    ``n_real``: keys at positions >= n_real get no softmax mass (their
    query rows are still computed, and still reach dk/dv). ``quant``:
    None | "qk8" | "qk8pv8" | "fp8" | "fp8pv8", the 8-bit forward (K5 for
    the int8 modes, K6 for the e4m3 ones; under autograd the backward of
    the saved quantized forward is the bf16 one, straight through).
    ``bwd_quant``: None | "int8", the int8 backward (K7) while
    round_up(N, 128) <= 4096, the bf16 one beyond, as the TPU package
    does. On CUDA the 8-bit modes take bf16 inputs. Launches are counted
    in ``flash_attention.launches`` (K2), ``flash_attention_fwd_lse.
    launches`` (K3a), ``attention_bwd.launches`` (K3b/K4),
    ``attention_fwd_int8.launches`` (K5), ``attention_fwd_fp8.launches``
    (K6) and ``attention_bwd_int8.launches`` (K7); the controls in
    ``attention_fwd_mma.launches``, ``attention_bwd_mma.launches``,
    ``attention_bwd_int8_mma.launches`` and
    ``attention_fwd_q8_mma.launches``."""
    n_real, quant, bwd_quant = _check_args(q, k, v, n_real, quant, bwd_quant)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(torch.stack((q, k, v), dim=2), n_real,
                                     quant, bwd_quant)
    return _fwd(q, k, v, n_real, quant, with_lse=False)[0]


def flash_attention_qkv(qkv: torch.Tensor, n_real: int | None = None,
                        quant: str | None = None,
                        bwd_quant: str | None = None) -> torch.Tensor:
    """``flash_attention`` of the fused projection output (B, N, 3, H, D):
    the kernels read q, k, v as strided views of it, and under autograd
    its gradient is written in the same layout."""
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, D), got {tuple(qkv.shape)}")
    q, k, v = qkv.unbind(2)
    n_real, quant, bwd_quant = _check_args(q, k, v, n_real, quant, bwd_quant)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashAttention.apply(qkv, n_real, quant, bwd_quant)
    return _fwd(q, k, v, n_real, quant, with_lse=False)[0]


def _fwd(q, k, v, n_real, quant, with_lse):
    """(o, lse or None) of the forward that ``quant`` names."""
    if quant in ("qk8", "qk8pv8"):
        return attention_fwd_int8(q, k, v, n_real, quant == "qk8pv8", with_lse)
    if quant in ("fp8", "fp8pv8"):
        return attention_fwd_fp8(q, k, v, n_real, quant == "fp8pv8", with_lse)
    if q.device.type == "cpu":
        if with_lse:
            return attention_reference_lse(q, k, v, n_real)
        return attention_reference(q, k, v, n_real), None
    if _F32_CONTROL and q.dtype == torch.float32 and padded_dim(
            q.shape[-1]) == HEAD_DIM:
        out = padded_fwd(_launch_fwd_fma, q, k, v, n_real, with_lse)
        attention_fwd_fp32_fma.launches += 1
        return out
    if _K2_CONTROL and q.dtype == torch.bfloat16 and _has_fwd_control(
            padded_dim(q.shape[-1])):
        out = padded_fwd(_launch_fwd_mma, q, k, v, n_real, with_lse)
        attention_fwd_mma.launches += 1
        return out
    out = padded_fwd(_launch_fwd, q, k, v, n_real, with_lse)
    if with_lse:
        flash_attention_fwd_lse.launches += 1
    else:
        flash_attention.launches += 1
    return out


# Private: True routes the bf16 forward at head_dim 64, 128 and 256 (and
# the widths zero-padded to them) and at the widths above 256 through the
# control (``attention_fwd_mma``) instead of the wgmma kernels, so that a
# measurement can time the steps of the model with each. Nothing in the
# package sets it.
_K2_CONTROL = False


def _has_fwd_control(d: int) -> bool:
    """A bf16 kernel width whose forward kept its ``mma.sync`` kernel as the
    control of a ``wgmma`` one: 64, 128, 256, and every multiple of 64
    above 256."""
    return d in HEAD_DIMS or (d > HEAD_DIMS[-1] and d % 64 == 0)


def attention_fwd_mma(q, k, v, n_real: int | None = None,
                      with_lse: bool = False):
    """The control of K2/K3a's wgmma kernels: the ``mma.sync`` kernels, at
    head_dim 64, 128 and 256 variant FLASH of ``csrc/attn_fwd_bf16.cuh``
    (entries ``maest_attn_fwd_bf16_mma``, ``maest_attn_fwd_bf16_d128_mma``,
    ``maest_attn_fwd_bf16_d256_mma``) and at a multiple of 64 above 256 the
    runtime-width kernel of
    ``csrc/attention_fwd.cu`` (entry ``maest_attn_fwd_bf16_dn_mma``), on
    bf16 CUDA (B, N, H, D) views; (o, lse or None). It computes what
    ``flash_attention`` computes, with its own 64-key tiles; counted in
    ``attention_fwd_mma.launches``."""
    n_real, _, _ = _check_args(q, k, v, n_real, None)
    if q.device.type == "cpu":
        if with_lse:
            return attention_reference_lse(q, k, v, n_real)
        return attention_reference(q, k, v, n_real), None
    if q.dtype != torch.bfloat16 or not _has_fwd_control(q.shape[-1]):
        raise ValueError("the control takes bf16 q, k, v at head_dim 64, 128, "
                         "256 or a multiple of 64 above 256")
    out = _launch_fwd_mma(q, k, v, n_real, with_lse, q.shape[-1]**-0.5)
    attention_fwd_mma.launches += 1
    return out


# Private: True routes fp32 at head_dim 64, forward and backward, through
# the scalar FMA controls (``attention_fwd_fp32_fma``,
# ``attention_bwd_fp32_fma``) instead of the tf32 kernels, so that a
# measurement can time the steps of the model with each. Nothing in the
# package sets it.
_F32_CONTROL = False


def attention_fwd_fp32_fma(q, k, v, n_real: int | None = None,
                           with_lse: bool = False):
    """The control of the fp32 forward's tf32 kernel: the scalar fp32 FMA
    kernel (entry ``maest_attn_fwd_fp32_fma``) on fp32 CUDA (B, N, H, 64)
    views; (o, lse or None). It computes what ``flash_attention`` computes
    in fp32; counted in ``attention_fwd_fp32_fma.launches``."""
    n_real, _, _ = _check_args(q, k, v, n_real, None)
    if q.device.type == "cpu":
        if with_lse:
            return attention_reference_lse(q, k, v, n_real)
        return attention_reference(q, k, v, n_real), None
    if q.dtype != torch.float32 or q.shape[-1] != HEAD_DIM:
        raise ValueError("the control takes fp32 q, k, v at head_dim 64")
    out = _launch_fwd_fma(q, k, v, n_real, with_lse, q.shape[-1]**-0.5)
    attention_fwd_fp32_fma.launches += 1
    return out


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, n_real: int | None = None):
    """The training forward alone: (o, lse (B, H, N) fp32)."""
    n_real, _, _ = _check_args(q, k, v, n_real, None)
    return _fwd(q, k, v, n_real, None, with_lse=True)


def attention_fwd_int8(q, k, v, n_real: int | None = None, pv8: bool = False,
                       with_lse: bool = False):
    """The int8 forward (K5): "qk8", or "qk8pv8" with ``pv8``; (o, lse or
    None). CUDA tensors launch ``csrc/attention_fwd_q8.cu`` (in bf16 at
    head_dim 64 its wgmma route, ``csrc/attn_fwd_q8_wgmma.cuh``: the CUDA
    quantisation pass, then the kernel over 128-key tiles; the mma.sync
    instances otherwise), CPU tensors run ``attention_q8_reference`` at the
    route's tile (``q8_block_k``)."""
    return _fwd_q8(attention_fwd_int8, "qk8pv8" if pv8 else "qk8", q, k, v,
                   n_real, with_lse)


def attention_fwd_fp8(q, k, v, n_real: int | None = None, pv8: bool = False,
                      with_lse: bool = False):
    """The e4m3 forward (K6): "fp8", or "fp8pv8" with ``pv8``; (o, lse or
    None). CUDA tensors launch ``csrc/attention_fwd_q8.cu`` (in bf16 at
    head_dim 64 its wgmma route, as ``attention_fwd_int8``; the mma.sync
    instances otherwise), CPU tensors run ``attention_q8_reference`` at the
    route's tile (``q8_block_k``)."""
    return _fwd_q8(attention_fwd_fp8, "fp8pv8" if pv8 else "fp8", q, k, v,
                   n_real, with_lse)


def _fwd_q8(wrapper, quant, q, k, v, n_real, with_lse):
    if q.device.type == "cpu":
        o, lse = attention_q8_reference(q, k, v, n_real, quant)
        return o, (lse if with_lse else None)
    if _Q8_CONTROL and q.dtype == torch.bfloat16 and padded_dim(
            q.shape[-1]) == HEAD_DIM:
        out = padded_fwd(functools.partial(_launch_fwd_q8, control=True), q, k,
                         v, n_real, with_lse, quant=quant)
        attention_fwd_q8_mma.launches += 1
        return out
    out = padded_fwd(_launch_fwd_q8, q, k, v, n_real, with_lse, quant=quant)
    wrapper.launches += 1
    return out


# Private: True routes the 8-bit forwards in bf16 at head_dim 64 through the
# control (``attention_fwd_q8_mma``) instead of the wgmma route, so that a
# measurement can time the steps of the model with each. Nothing in the
# package sets it.
_Q8_CONTROL = False


def attention_fwd_q8_mma(q, k, v, n_real: int | None = None,
                         quant: str = "qk8", with_lse: bool = False):
    """The control of the wgmma 8-bit forwards (K5/K6): the ``mma.sync``
    kernel (``csrc/attn_fwd_q8.cuh``, entries ``maest_attn_fwd_<quant>_mma``)
    after the PyTorch quantisation, on bf16 CUDA (B, N, H, 64) views; (o,
    lse or None). It computes what ``flash_attention`` computes under
    ``quant`` with its own 64-key tiles (``Q8_BLOCK_K``); counted in
    ``attention_fwd_q8_mma.launches``. CPU tensors run
    ``attention_q8_reference`` with block_k 64."""
    n_real, quant, _ = _check_args(q, k, v, n_real, quant)
    if quant is None:
        raise ValueError("the control runs an 8-bit mode: qk8, qk8pv8, fp8 "
                         "or fp8pv8")
    if q.device.type == "cpu":
        o, lse = attention_q8_reference(q, k, v, n_real, quant, Q8_BLOCK_K)
        return o, (lse if with_lse else None)
    if q.dtype != torch.bfloat16 or q.shape[-1] != HEAD_DIM:
        raise ValueError("the control takes bf16 q, k, v at head_dim 64")
    out = _launch_fwd_q8(q, k, v, n_real, with_lse, q.shape[-1]**-0.5, quant,
                         control=True)
    attention_fwd_q8_mma.launches += 1
    return out


# --- head_dim other than 64, 128 and 256 on the card -----------------------
def padded_dim(d: int) -> int:
    """The kernel width that takes head_dim d: the smallest of HEAD_DIMS
    (64, 128, 256) at or above it, and above 256 the next multiple of 64
    (every kernel's runtime-width ``_dn`` instance)."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // 64) * 64


def pad_head_dim(*ts):
    """(ts zero-padded along head_dim, their last axis, to the next kernel
    width (``padded_dim``: 64, 128, 256 or a multiple of 64 above); the
    softmax scale of their own head_dim, d^-0.5). Zero columns add nothing
    to q.k, to do.v or to rowsum(do o), leave every |x| maximum and so
    every 8-bit scale as it was, and give zero output and gradient
    columns, which the caller slices off; the scale must be the unpadded
    head_dim's."""
    d = ts[0].shape[-1]
    width = padded_dim(d)
    if d < width:
        ts = tuple(F.pad(t, (0, width - d)) for t in ts)
    return ts, d**-0.5


def padded_fwd(launch, q, k, v, n_real, with_lse, **kw):
    """``launch(q, k, v, n_real, with_lse, scale, **kw)``, a forward that
    returns (o, lse or None), on q, k, v zero-padded to the next kernel
    instance with their own softmax scale; o sliced back to their
    head_dim."""
    d = q.shape[-1]
    (q, k, v), scale = pad_head_dim(q, k, v)
    o, lse = launch(q, k, v, n_real, with_lse, scale, **kw)
    return (o if d == q.shape[-1] else o[..., :d]), lse


def padded_bwd(launch, q, k, v, o, lse, do, n_real, **kw):
    """``launch(q, k, v, o, lse, do, n_real, scale, **kw)``, a backward that
    returns the (B, N, 3, H, D) gradients of q, k, v, on tensors
    zero-padded to the next kernel instance D with their own softmax
    scale; the gradients of their head_dim in the same layout (a copy of
    the slice)."""
    d = q.shape[-1]
    (q, k, v, o, do), scale = pad_head_dim(q, k, v, o, do)
    grads = launch(q, k, v, o, lse, do, n_real, scale, **kw)
    return grads if d == q.shape[-1] else grads[..., :d].contiguous()


def _aligned(t):
    """Rows start on 16-byte boundaries (vector loads of a row)."""
    e = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * e % 16 == 0
                                          for s in t.stride()[:3])


def _check_views(tensors, dtype, what, aligned=None):
    """Views a kernel takes: one CUDA device, ``dtype`` (fp32 or bf16),
    a head_dim a kernel width (``padded_dim``) with a contiguous last axis,
    and (bf16, or ``aligned``) rows on 16-byte boundaries."""
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
    if d != padded_dim(d):
        raise ValueError(f"the CUDA attention kernels take head_dim 64, 128, "
                         f"256 or a multiple of 64 above (pad_head_dim pads "
                         f"to one); got {d}")
    if aligned is None:
        aligned = dtype == torch.bfloat16
    for t in tensors:
        if t.stride(3) != 1:
            raise ValueError(f"{what} need a contiguous last (head_dim) axis")
        if aligned and not _aligned(t):
            # rows are staged with 16-byte loads
            raise ValueError(f"{what} rows must start on 16-byte boundaries "
                             "(strides in multiples of 16 bytes)")


def _entry(lib, name, n_ptrs, n_floats, n_lead=0):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * n_lead + [ctypes.c_void_p] * n_ptrs + [
        ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [
        ctypes.c_float] * n_floats + [ctypes.c_void_p]
    return fn


def _strides(*ts):
    return (ctypes.c_longlong * (3 * len(ts)))(
        *(s for t in ts for s in t.stride()[:3]))


def _instance(name, d):
    """(the C entry of ``name`` at kernel width d, its leading int
    arguments): ``name`` at 64, ``name_d128``, ``name_d256``, and above
    256 ``name_dn``, which takes d."""
    if d > HEAD_DIMS[-1]:
        return f"{name}_dn", (d,)
    return (name if d == HEAD_DIM else f"{name}_d{d}"), ()


def _launch_fwd(q, k, v, n_real, with_lse, scale):
    """K2 (K3a with lse) on checked views of a kernel width."""
    name, lead = _instance("maest_attn_fwd_fp32" if q.dtype == torch.float32
                           else "maest_attn_fwd_bf16", q.shape[-1])
    return launch_fwd_entry("attention_fwd", name, lead, q, k, v, n_real,
                            with_lse, scale)


def _launch_fwd_mma(q, k, v, n_real, with_lse, scale):
    """The control of K2/K3a on checked bf16 views at head_dim 64, 128, 256
    or a multiple of 64 above 256 (``maest_attn_fwd_bf16_dn_mma``, which
    takes the width)."""
    name, lead = _instance("maest_attn_fwd_bf16", q.shape[-1])
    name += "_mma"
    return launch_fwd_entry("attention_fwd", name, lead, q, k, v, n_real,
                            with_lse, scale)


def _launch_fwd_fma(q, k, v, n_real, with_lse, scale):
    """The control of the fp32 K2/K3a on checked fp32 views at head_dim 64."""
    return launch_fwd_entry("attention_fwd", "maest_attn_fwd_fp32_fma", (), q,
                            k, v, n_real, with_lse, scale)


def _scratch_floats(lib, name, b, n, h):
    """The floats of the fp32 scratch that the entry ``name`` of ``lib``
    takes, by the libraries' rule: an entry X that takes scratch exports
    ``X_scratch(batch, n, heads)``. None where ``lib`` exports no such
    function."""
    try:
        fn = getattr(lib, f"{name}_scratch")
    except AttributeError:
        return None
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return fn(b, n, h)


def launch_fwd_entry(lib_name, name, lead, q, k, v, n_real, with_lse, scale):
    """Launch the forward entry ``name`` of ``csrc/<lib_name>.cu`` with the
    leading int arguments ``lead`` on checked CUDA views and softmax scale
    ``scale``; (o, lse or None)."""
    _check_views((q, k, v), q.dtype, "q/k/v")
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.load_library(lib_name)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr()]
    floats = _scratch_floats(lib, name, b, n, h)
    if floats is not None:  # the tf32 forward's planes, after lse
        scratch = torch.empty(floats, dtype=torch.float32, device=q.device)
        ptrs.append(scratch.data_ptr())
    fn = _entry(lib, name, len(ptrs), 1, len(lead))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*lead, *ptrs, b, n, h, n if n_real is None else n_real,
                 _strides(q, k, v, out), scale * _LOG2E, stream)
    _build.check(lib, err, f"{name} {lead}" if lead else name)
    return out, lse


def _seq_major(x8: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) 8-bit -> (B, H, D, N_pad) bytes, N_pad = round_up(N,
    64), zero-filled. An 8-bit product that contracts over the sequence
    reads this copy: ldmatrix cannot transpose 8-bit elements. Within each
    16-row group, row 8a + 2t + c goes to column 4t + 2a + c: the order in
    which the m16n8 accumulator of the preceding product hands a thread its
    values, so that accumulator becomes the next product's A operand as it
    lies (csrc/mma_8bit.cuh)."""
    b, h, n, d = x8.shape
    npad = -(-n // 64) * 64
    xp = torch.zeros((b, h, npad, d), dtype=torch.uint8, device=x8.device)
    xp[:, :, :n] = x8.view(torch.uint8)
    xp = xp.view(b, h, npad // 16, 2, 4, 2, d).permute(0, 1, 6, 2, 4, 3, 5)
    return xp.reshape(b, h, d, npad)


def q8_entry(quant: str, dtype, d: int, control: bool = False):
    """(the C entry of ``csrc/attention_fwd_q8.cu`` that runs ``quant`` on
    ``dtype`` views of kernel width d, its leading int arguments): the
    wgmma route ``maest_attn_fwd_<quant>`` at bf16 d 64, its control
    ``..._mma`` there with ``control``; the mma.sync instances otherwise
    (``_fp32``, ``_d128``, ``_d256``, ``_dn``)."""
    if dtype == torch.bfloat16 and d == HEAD_DIM:
        return f"maest_attn_fwd_{quant}" + ("_mma" if control else ""), ()
    return _instance(f"maest_attn_fwd_{quant}" + (
        "_fp32" if dtype == torch.float32 else ""), d)


def _q8_scratch(lib, name, q):
    """(the uint8 bytes, the fp32 scratch) that the wgmma route's entry
    ``name`` takes for q's (B, N, H, 64), sized by its ``_bytes`` and
    ``_scratch`` exports; uninitialised."""
    b, n, h, _ = q.shape
    fn = getattr(lib, f"{name}_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return (torch.empty(fn(b, n, h), dtype=torch.uint8, device=q.device),
            torch.empty(_scratch_floats(lib, name, b, n, h),
                        dtype=torch.float32, device=q.device))


def launch_q8_pass(q, k, v, quant, scale=None):
    """The wgmma route's quantisation pass alone (entry
    ``maest_attn_fwd_q8w_pass``) on bf16 CUDA (B, N, H, 64) views: (its
    uint8 bytes, its fp32 scratch), as the route's kernel reads them
    (``q8_pass_views``); for the checks and timings of the pass."""
    _check_views((q, k, v), q.dtype, "q/k/v", aligned=True)
    b, n, h, d = q.shape
    if q.dtype != torch.bfloat16 or d != HEAD_DIM:
        raise ValueError("the pass takes bf16 q, k, v at head_dim 64")
    lib = _build.load_library("attention_fwd_q8")
    bytes8, scratch = _q8_scratch(lib, f"maest_attn_fwd_{quant}", q)
    fn = lib.maest_attn_fwd_q8w_pass
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    sl = _scale(q, scale) * _LOG2E
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_QUANT_MODES.index(quant) - 1, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bytes8.data_ptr(), scratch.data_ptr(), b, n, h,
                 _strides(q, k, v), sl, stream)
    _build.check(lib, err, "maest_attn_fwd_q8w_pass")
    return bytes8, scratch


def _launch_fwd_q8(q, k, v, n_real, with_lse, scale, quant, control=False):
    """K5/K6 on checked views of a kernel width; (o, lse or None). In bf16
    at head_dim 64 the wgmma route (its CUDA pass makes the 8-bit inputs;
    ``q8_entry``), unless ``control``; else the 8-bit inputs made in
    PyTorch as the TPU package makes them in XLA outside its kernel, then
    the mma.sync kernel (its fp32 instance for fp32 q, k, v)."""
    _check_views((q, k, v), q.dtype, "q/k/v", aligned=True)
    b, n, h, d = q.shape
    name, lead = q8_entry(quant, q.dtype, d, control)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.load_library("attention_fwd_q8")
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    if q.dtype == torch.bfloat16 and d == HEAD_DIM and not control:
        bytes8, scratch = _q8_scratch(lib, name, q)
        fn = _entry(lib, name, 7, 1)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     ptr(lse), bytes8.data_ptr(), scratch.data_ptr(), b, n, h,
                     n if n_real is None else n_real, _strides(q, k, v, out),
                     scale * _LOG2E, stream)
        _build.check(lib, err, name)
        return out, lse
    sl = scale * _LOG2E
    qs = sk = sv127 = None
    if quant in ("qk8", "qk8pv8"):
        q8, sq = quantize_rows(q)
        k8, sk = quantize_rows(k)
        qs = (sq * sl).transpose(1, 2).contiguous()  # (B, H, N)
        sk = sk.transpose(1, 2).contiguous()
    else:
        q8, k8 = to_e4m3(q), to_e4m3(k)
    q8, k8 = q8.contiguous(), k8.contiguous()  # 16-byte rows for cp.async
    if quant == "qk8pv8":
        vh = v.transpose(1, 2).float()
        sv = _div(torch.clamp_min(vh.abs().amax(dim=2), _EPS), 127.0)
        v_in = _seq_major(torch.round(vh / sv[:, :, None]).to(torch.int8))
        sv127 = _div(sv, 127.0).contiguous()  # (B, H, D)
    elif quant == "fp8pv8":
        v_in = _seq_major(to_e4m3(v.transpose(1, 2)))
    else:
        v_in = v
    fn = _entry(lib, name, 8, 1, len(lead))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*lead, q8.data_ptr(), k8.data_ptr(), ptr(qs), ptr(sk),
                 v_in.data_ptr(), ptr(sv127), out.data_ptr(), ptr(lse),
                 b, n, h, n if n_real is None else n_real,
                 _strides(q8, k8, v, out), sl, stream)
    _build.check(lib, err, f"{name} {lead}" if lead else name)
    return out, lse


def attention_bwd(q, k, v, o, lse, do, n_real: int | None = None):
    """(dq, dk, dv) of attention from the saved (q, k, v, o, lse) and the
    output gradient ``do``; all (B, N, H, D) but lse (B, H, N) fp32. CUDA
    tensors launch ``csrc/attention_bwd.cu`` (in bf16 at head_dim 64 its
    ``wgmma`` kernel, ``csrc/attn_bwd_wgmma.cuh``, at 129-256 those of
    ``csrc/attn_bwd_d256_wgmma.cuh``, above 256 those of
    ``csrc/attn_bwd_dn_wgmma.cuh``; counted in
    ``attention_bwd.launches``), CPU tensors run
    ``attention_bwd_reference``."""
    return _bwd_qkv(q, k, v, o, lse, do, n_real, None).unbind(2)


# Private: True routes the bf16 backward at head_dim 64, 256 (129-256
# zero-padded) and above 256 through the control (``attention_bwd_mma``)
# instead of the wgmma kernels, so that a measurement can time the steps of
# the model with each. Nothing in the package sets it.
_K3B_CONTROL = False


def _bwd_control(d: int):
    """(the C entry, its leading int arguments) of the bf16 backward's
    control at kernel width d, the mma.sync kernels that the wgmma kernels
    replaced (64, 256 and every multiple of 64 above 256), or None."""
    if d == HEAD_DIM:
        return "maest_attn_bwd_bf16_mma", ()
    if d == 256:
        return "maest_attn_bwd_bf16_d256_mma", ()
    if d > 256 and d % 64 == 0:
        return "maest_attn_bwd_bf16_dn_mma", (d,)
    return None


def attention_bwd_mma(q, k, v, o, lse, do, n_real: int | None = None):
    """The control of K3b/K4's wgmma kernels: the ``mma.sync`` kernels
    (delta, dk/dv, dq; entry ``maest_attn_bwd_bf16_mma`` at head_dim 64,
    ``maest_attn_bwd_bf16_d256_mma`` at 256, ``maest_attn_bwd_bf16_dn_mma``
    at a multiple of 64 above 256, of ``csrc/attention_bwd.cu``) on bf16
    CUDA (B, N, H, D) views; (dq, dk, dv). They compute what
    ``attention_bwd`` computes, forming the scores once for dk/dv and once
    for dq (at 256 in 128-column slices of dk/dv, above 256 once for each
    64-column slice of dk/dv and each 128-column slice of dq); counted in
    ``attention_bwd_mma.launches``. CPU tensors run
    ``attention_bwd_reference``."""
    n_real, _, _ = _check_args(q, k, v, n_real, None)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do, n_real)
    entry = _bwd_control(q.shape[-1])
    if q.dtype != torch.bfloat16 or entry is None:
        raise ValueError("the control takes bf16 q, k, v at head_dim 64, 256 "
                         "or a multiple of 64 above 256")
    grads = launch_bwd_entry(*entry, q, k, v, o, lse, do, n_real,
                             q.shape[-1]**-0.5)
    attention_bwd_mma.launches += 1
    return grads.unbind(2)


def attention_bwd_fp32_fma(q, k, v, o, lse, do, n_real: int | None = None):
    """The control of the fp32 backward's tf32 kernels: the scalar FMA
    kernels (delta, dk/dv, dq; entry ``maest_attn_bwd_fp32_fma`` of
    ``csrc/attention_bwd.cu``) on fp32 CUDA (B, N, H, 64) views; (dq, dk,
    dv). They compute what ``attention_bwd`` computes in fp32; counted in
    ``attention_bwd_fp32_fma.launches``. CPU tensors run
    ``attention_bwd_reference``."""
    n_real, _, _ = _check_args(q, k, v, n_real, None)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do, n_real)
    if q.dtype != torch.float32 or q.shape[-1] != HEAD_DIM:
        raise ValueError("the control takes fp32 q, k, v at head_dim 64")
    grads = launch_bwd_entry("maest_attn_bwd_fp32_fma", (), q, k, v, o, lse,
                             do, n_real, q.shape[-1]**-0.5)
    attention_bwd_fp32_fma.launches += 1
    return grads.unbind(2)


def attention_bwd_int8(q, k, v, o, lse, do, n_real: int | None = None):
    """The int8 backward (K7): as ``attention_bwd``, with the arithmetic of
    ``attention_bwd_int8_reference``. CUDA tensors launch
    ``csrc/attention_bwd_q8.cu`` (in bf16 at head_dim 64 its ``wgmma``
    kernels, ``csrc/attn_bwd_q8_wgmma.cuh``; the fp32 and wider instances
    otherwise; counted in ``attention_bwd_int8.launches``) while
    round_up(N, 128) <= 4096, and the bf16 or fp32 backward beyond, as the
    TPU package does."""
    return _bwd_qkv(q, k, v, o, lse, do, n_real, "int8").unbind(2)


# Private: True routes the int8 backward in bf16 at head_dim 64 through the
# control (``attention_bwd_int8_mma``) instead of the wgmma kernels, so that
# a measurement can time the steps of the model with each. Nothing in the
# package sets it.
_K7_CONTROL = False


def attention_bwd_int8_mma(q, k, v, o, lse, do, n_real: int | None = None):
    """The control of K7's wgmma kernels: the ``mma.sync`` kernels (amax,
    quant, scale pass, dk/dv, dq; entry ``maest_attn_bwd_q8_mma`` of
    ``csrc/attention_bwd_q8.cu``) on bf16 CUDA (B, N, H, 64) views with
    round_up(N, 128) <= 4096; (dq, dk, dv). They compute what
    ``attention_bwd_int8`` computes, forming the scores three times;
    counted in ``attention_bwd_int8_mma.launches``. CPU tensors run
    ``attention_bwd_int8_reference``."""
    n_real, _, _ = _check_args(q, k, v, n_real, None)
    if q.device.type == "cpu":
        return attention_bwd_int8_reference(q, k, v, o, lse, do, n_real)
    if (q.dtype != torch.bfloat16 or q.shape[-1] != HEAD_DIM
            or not int8_bwd_applies(q.shape[1])):
        raise ValueError("the control takes bf16 q, k, v at head_dim 64 and "
                         "round_up(N, 128) <= 4096")
    grads = _launch_bwd_q8(q, k, v, o, lse, do, n_real, q.shape[-1]**-0.5,
                           name="maest_attn_bwd_q8_mma")
    attention_bwd_int8_mma.launches += 1
    return grads.unbind(2)


def _bwd_qkv(q, k, v, o, lse, do, n_real, bwd_quant):
    """The backward as one (B, N, 3, H, D) gradient of q, k, v."""
    int8 = bwd_quant == "int8" and int8_bwd_applies(q.shape[1])
    if q.device.type == "cpu":
        ref = attention_bwd_int8_reference if int8 else attention_bwd_reference
        return torch.stack(ref(q, k, v, o, lse, do, n_real), dim=2)
    if int8 and _K7_CONTROL and q.dtype == torch.bfloat16 and padded_dim(
            q.shape[-1]) == HEAD_DIM:
        grads = padded_bwd(functools.partial(
            _launch_bwd_q8, name="maest_attn_bwd_q8_mma"), q, k, v, o, lse, do,
            n_real)
        attention_bwd_int8_mma.launches += 1
        return grads
    if int8:
        grads = padded_bwd(_launch_bwd_q8, q, k, v, o, lse, do, n_real)
        attention_bwd_int8.launches += 1
        return grads
    if _F32_CONTROL and q.dtype == torch.float32 and padded_dim(
            q.shape[-1]) == HEAD_DIM:
        grads = padded_bwd(functools.partial(
            launch_bwd_entry, "maest_attn_bwd_fp32_fma", ()), q, k, v, o, lse,
            do, n_real)
        attention_bwd_fp32_fma.launches += 1
        return grads
    control = _bwd_control(padded_dim(q.shape[-1]))
    if _K3B_CONTROL and q.dtype == torch.bfloat16 and control is not None:
        grads = padded_bwd(functools.partial(launch_bwd_entry, *control), q,
                           k, v, o, lse, do, n_real)
        attention_bwd_mma.launches += 1
        return grads
    name, lead = _instance("maest_attn_bwd_fp32" if q.dtype == torch.float32
                           else "maest_attn_bwd_bf16",
                           padded_dim(q.shape[-1]))
    grads = padded_bwd(functools.partial(launch_bwd_entry, name, lead), q, k,
                       v, o, lse, do, n_real)
    attention_bwd.launches += 1
    return grads


def _bwd_views(q, k, v, o, lse, do, aligned=None):
    """Check the backward's views; o and do as the delta pass reads them
    (q's dtype, rows on 16-byte boundaries: copies where they are not)."""
    o, do = (t if t.dtype == q.dtype and t.stride(3) == 1 and _aligned(t)
             else t.to(q.dtype).contiguous() for t in (o, do))
    _check_views((q, k, v, o, do), q.dtype, "q/k/v/o/do", aligned)
    b, n, h, _ = q.shape
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or (
            not lse.is_contiguous()) or lse.device != q.device:
        raise ValueError("lse must be a contiguous float32 (B, H, N) tensor "
                         "on q's device")
    return o, do


def _grads(q):
    """One buffer for the gradients of q, k, v, laid out as the fused qkv
    projection's output (B, N, 3, H, D), and its three views."""
    b, n, h, d = q.shape
    grads = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
    return grads, grads[:, :, 0], grads[:, :, 1], grads[:, :, 2]


def _bwd_scratch(lib, name, b, n, h):
    """The floats of the fp32 scratch the entry ``name`` takes in delta's
    place: ``_scratch_floats`` (the wgmma backward's: dq's sums, the padded
    lse and delta, the hand-over counters; above 256: the padded lse and
    delta, the bf16 p^T and ds^T planes; the tf32 backward's: the tf32
    planes, the padded lse and delta), else delta (B, H, N)."""
    floats = _scratch_floats(lib, name, b, n, h)
    return b * h * n if floats is None else floats


def launch_bwd_entry(name, lead, q, k, v, o, lse, do, n_real, scale):
    """Launch the backward entry ``name`` of ``csrc/attention_bwd.cu`` (the
    delta, dk/dv and dq kernels, or the prep pass and the wgmma kernel) with
    the leading int arguments ``lead`` on checked CUDA views and softmax
    scale ``scale``; return the (B, N, 3, H, D) gradients."""
    o, do = _bwd_views(q, k, v, o, lse, do)
    b, n, h, _ = q.shape
    grads, dq, dk, dv = _grads(q)
    lib = _build.load_library("attention_bwd")
    delta = torch.empty(_bwd_scratch(lib, name, b, n, h), dtype=torch.float32,
                        device=q.device)
    fn = _entry(lib, name, 10, 2, len(lead))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*lead, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, n, h, n if n_real is None else n_real,
                 _strides(q, k, v, o, do, dq, dk, dv), scale * _LOG2E, scale,
                 stream)
    _build.check(lib, err, f"{name} {lead}" if lead else name)
    return grads


def _launch_bwd_q8(q, k, v, o, lse, do, n_real, scale, name=None):
    """K7: scratch for the maxima and the int8 copies, then the kernels of
    ``csrc/attention_bwd_q8.cu`` (in bf16 at head_dim 64 the wgmma route:
    amax, quant, stats, main, dq; else, and for the entry ``name``
    ``maest_attn_bwd_q8_mma``, the mma.sync kernels: amax, quant, scale
    pass, dk/dv, dq; the fp32 instance for fp32 tensors); the (B, N, 3, H,
    D) gradients."""
    o, do = _bwd_views(q, k, v, o, lse, do, aligned=True)
    b, n, h, d = q.shape
    grads, dq, dk, dv = _grads(q)
    lib = _build.load_library("attention_bwd_q8")
    lead = ()
    if name is None:
        name, lead = _instance("maest_attn_bwd_q8" + (
            "_fp32" if q.dtype == torch.float32 else ""), d)
    bq = bwd_q_block(n)
    nqb = -(-n // bq)
    # the wgmma K7 (csrc/attn_bwd_q8_wgmma.cuh) exports its scratch's
    # floats, in delta's place, and the bytes of its int8 copies
    n_floats = _scratch_floats(lib, name, b, n, h)
    if n_floats is not None:
        fn = getattr(lib, f"{name}_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
        n_bytes = fn(b, n, h)
    else:
        n_floats, n_bytes = b * h * n, 7 * b * h * (-(-n // 64) * 64) * d
    # delta (B, H, N), or the wgmma route's scratch
    delta = torch.empty(n_floats, dtype=torch.float32, device=q.device)
    # maxima of |q|, |do| per (head, q-block), of |k|, |v| per head, and of
    # p, |ds| per (head, q-block): atomicMax targets, so zeroed
    stats = torch.zeros(4 * b * h * nqb + 2 * b * h, dtype=torch.float32,
                        device=q.device)
    # q8, k8, v8, do8 (B*H, N_pad, D) and q, do, k transposed (_seq_major)
    bytes8 = torch.empty(n_bytes, dtype=torch.int8, device=q.device)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(lead) + [ctypes.c_void_p] * 12 + [
        ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*lead, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(), stats.data_ptr(),
                 bytes8.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, n, h,
                 n if n_real is None else n_real, bq,
                 _strides(q, k, v, o, do, dq, dk, dv), scale * _LOG2E, scale,
                 stream)
    _build.check(lib, err, f"{name} {lead}" if lead else name)
    return grads


flash_attention.launches = 0
flash_attention_fwd_lse.launches = 0
attention_fwd_mma.launches = 0
attention_bwd.launches = 0
attention_bwd_mma.launches = 0
attention_fwd_int8.launches = 0
attention_fwd_fp8.launches = 0
attention_fwd_q8_mma.launches = 0
attention_bwd_int8.launches = 0
attention_bwd_int8_mma.launches = 0
attention_fwd_fp32_fma.launches = 0
attention_bwd_fp32_fma.launches = 0
