"""The attention-decomposition variants of the forward, port of the six
kernels of ``scripts/attn_profile_r2.py``.

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
version, ``attention_probe_reference``, which walks the kernel's key tiles:
64 keys (``BLOCK_K``), and for ``bf16s`` the 96 or 112 of K2's ``wgmma``
kernel (``wg_key_tile``). ``bf16s`` runs on K2's ``wgmma``/TMA kernel in
its bf16-score form (``csrc/attn_fwd_wgmma.cuh``, entry
``maest_attn_probe_bf16s_wgmma``: q pre-scaled in shared memory, no
PyTorch pass); the other three, and ``bf16s``'s control, on the
``mma.sync`` variants of K2's template ``csrc/attn_fwd_bf16.cuh``.

``attention_probe_mma(q, k, v, "bf16s")`` is that control: the
``mma.sync`` kernel behind the PyTorch pre-scaling pass ``prescale_q``,
counted in ``attention_probe_mma.launches``, its plain version
``attention_probe_mma_reference`` on 64-key tiles. ``launch_probe`` runs a
``mma.sync`` variant's kernel alone (for ``bf16s`` the control's, on a
pre-scaled q).

Two more wrappers, each with its plain version and launch count:

- ``attention_probe_gh(q, k, v, group)``: K2 with ``group`` (batch, head)
  pairs a block (the rig's ``_gh_kernel``), the same function as K2: on
  K2's ``wgmma`` kernel with G heads a block (``csrc/attn_fwd_wgmma.cuh``,
  entry ``maest_attn_probe_gh``; its plain version on that kernel's 96- or
  112-key tiles), and ``attention_probe_gh_mma``, its control, on K2's
  ``mma.sync`` template (entry ``maest_attn_probe_gh_mma``, 64-key tiles).
- ``attention_probe_int8(q, k, v)``: the rig's ``_int8_kernel`` with its
  quantization pass, fp32 in and out; its output is attention / 127 (see
  its docstring).

And K2 and K3b at other tile shapes, the kernels of ``scripts/qpad_probe.py``
and ``scripts/attn_tune.py`` (``maest_tpu_torch.probes.qpad`` and
``probes.attn_tune`` time them), each with its plain version and launch
count:

- ``attention_probe_qpad(q, k, v, group, with_lse=False)``: K2 (K3a with
  lse) whose warps with no row below N skip their work, ``group`` (batch,
  head) pairs a block (``fwd_qpad``): K2's function.
- ``attention_probe_tile(q, k, v, q_rows, key_tile, with_lse=False)``: K2's
  loop at q_rows query rows a block and key_tile keys a tile
  (``time_config``). The key tile is where p is rounded against the running
  max, so the plain version walks the same tiles.
- ``attention_bwd_tile(q, k, v, o, lse, do, rows, tile)``: K3b's kernels at
  rows a block and tile streamed rows (``time_bwd``); its plain version is
  ``attention_bwd_reference``.
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
    _div,
    _seq_major,
    _strides,
    attention_bwd_reference,
    launch_bwd_entry,
    launch_fwd_entry,
    wg_key_tile,
)

VARIANTS = ("mxu_only", "noexp_max", "novmax", "bf16s")
BLOCK_K = 64  # the mma.sync kernels' key tile: novmax's max is taken over it
_ID = {name: i + 1 for i, name in enumerate(VARIANTS)}  # maest::FwdVariant
GROUPS = (1, 2, 4, 8)  # the head groups attention_probe_gh's kernel takes
P127_SHIFT = 6.9886    # the int8 rig's log2(127): p = exp2(s - m + it) <= 127
_INT8_RIG = 4          # maest::Q8Mode
_SCALE_FLOOR = 1e-6    # the int8 rig's floor of a scale (max|x|)
QPAD_GROUPS = (1, 8, 12, 24)   # attention_probe_qpad's head groups
Q_ROWS = (64, 128, 256)        # attention_probe_tile's query rows a block
KEY_TILES = (32, 64, 128)      # and its keys a tile
BWD_TILES = (32, 64, 128)      # attention_bwd_tile's rows and tiles


def _check_qkv(q, k, v, n_real, dtype=torch.bfloat16):
    """Validate (B, N, H, 64) q, k, v of ``dtype`` (bf16; fp32 for the int8
    rig); return n_real as an int."""
    n_real, _, _ = _check_args(q, k, v, n_real, None)
    if any(t.dtype != dtype for t in (q, k, v)):
        raise TypeError(f"the attention probe kernels take {dtype} q/k/v "
                        "here, got "
                        f"{', '.join(str(t.dtype) for t in (q, k, v))}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the CUDA attention kernels are built for head_dim "
                         f"{HEAD_DIM}, got {q.shape[-1]}")
    return q.shape[1] if n_real is None else n_real


def _check(q, k, v, variant, n_real):
    """Validate; return n_real as an int."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown attention probe variant {variant!r}; "
                         f"expected one of {', '.join(VARIANTS)}")
    nr = _check_qkv(q, k, v, n_real)
    if variant == "mxu_only" and nr != q.shape[1]:
        raise ValueError("mxu_only masks no key: it takes n_real = N only, "
                         f"got n_real={n_real} of {q.shape[1]}")
    return nr


def prescale_q(q: torch.Tensor) -> torch.Tensor:
    """bf16(fp32(q) * scale * log2(e)): the rig's q for ``bf16s``."""
    return (q.float() * (q.shape[-1]**-0.5 * _LOG2E)).to(q.dtype)


def _walk(q, k, v, variant, nr, block_k=BLOCK_K, with_lse=False):
    """Key tiles of ``block_k`` in fp32, rounding where the kernel of
    ``variant`` (one of VARIANTS, or "flash": K2's online softmax) rounds;
    with ``with_lse`` (flash) also the rows' m + log2(l), (B, H, N)."""
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
    for base in range(0, nr, block_k):
        hi = min(base + block_k, n)
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
        else:  # bf16s and flash: the online softmax
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l *= corr
            acc *= corr
            m = m_new
        l += p.sum(dim=-1, keepdim=True)
        acc += p.to(torch.bfloat16).float() @ vt
    out = acc if variant == "mxu_only" else acc / l
    out = out.transpose(1, 2).to(torch.bfloat16)
    return (out, (m + torch.log2(l))[..., 0]) if with_lse else out


def attention_probe_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, variant: str,
                              n_real: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``attention_probe``: the kernel's key
    tiles in fp32 (64 keys; ``wg_key_tile`` for ``bf16s``), rounding
    where the kernel rounds (p to bf16 before P.V; for ``bf16s`` the
    pre-scaled q, the scores and the mask value to bf16)."""
    nr = _check(q, k, v, variant, n_real)
    return _walk(q, k, v, variant, nr,
                 wg_key_tile(nr) if variant == "bf16s" else BLOCK_K)


def attention_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    variant: str, n_real: int | None = None) -> torch.Tensor:
    """The ``variant`` forward on (B, N, H, 64) bf16: the kernel on CUDA
    tensors (``bf16s``: the ``wgmma`` kernel on the unscaled q),
    ``attention_probe_reference`` on CPU tensors."""
    nr = _check(q, k, v, variant, n_real)
    if q.device.type == "cpu":
        return attention_probe_reference(q, k, v, variant, n_real)
    if variant != "bf16s":
        return launch_probe(q, k, v, variant, n_real)
    out = launch_bf16("maest_attn_probe_bf16s_wgmma", None, q, k, v, nr,
                      q.shape[-1]**-0.5 * _LOG2E)
    attention_probe.launches["bf16s"] += 1
    return out


def _check_mma(q, k, v, variant, n_real):
    if variant != "bf16s":
        raise ValueError(f"attention_probe_mma is the control of bf16s only "
                         f"(the variant whose route moved to wgmma); got "
                         f"{variant!r}")
    return _check(q, k, v, variant, n_real)


def attention_probe_mma_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, variant: str = "bf16s",
                                  n_real: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``attention_probe_mma``: ``bf16s`` over
    the control's 64-key tiles."""
    return _walk(q, k, v, variant, _check_mma(q, k, v, variant, n_real))


def attention_probe_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        variant: str = "bf16s",
                        n_real: int | None = None) -> torch.Tensor:
    """The control of the ``wgmma`` bf16s kernel: the PyTorch pre-scaling
    pass ``prescale_q``, then the ``mma.sync`` variant BF16S of K2's
    template (``launch_probe``), on (B, N, H, 64) bf16 CUDA tensors;
    ``attention_probe_mma_reference`` on CPU tensors. Takes ``bf16s``
    only. Launches counted in ``attention_probe_mma.launches``."""
    _check_mma(q, k, v, variant, n_real)
    if q.device.type == "cpu":
        return attention_probe_mma_reference(q, k, v, variant, n_real)
    return launch_probe(prescale_q(q), k, v, variant, n_real)


def _on_card(t, fn):
    """Refuse CPU tensors, where the wrappers run the plain version (other
    devices are refused by ``_check_views`` at the launch)."""
    if t.device.type == "cpu":
        raise ValueError(f"{fn} launches the CUDA kernel; got {t.device} "
                         "tensors (the wrappers run the plain version there)")


def _call(lib, name, argtypes, *args):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn(*args)


_BF16_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
              + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                 ctypes.c_void_p])
_Q8_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
               ctypes.c_void_p])


def launch_bf16(name: str, select: int | None, q, k, v, n_real: int,
                sl: float) -> torch.Tensor:
    """Launch the bf16 entry ``name`` of ``csrc/attention_probe.cu`` (its
    variant or group ``select`` first, where it takes one: None for the
    bf16s wgmma entry) on checked CUDA views; return the bf16 output."""
    _check_views((q, k, v), torch.bfloat16, "q/k/v")
    b, n, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.load_library("attention_probe")
    lead = () if select is None else (select,)
    with torch.cuda.device(q.device):
        err = _call(lib, name, _BF16_ARGS[1 - len(lead):], *lead,
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, n, h, n_real, _strides(q, k, v, out), sl,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"{name} ({select})" if lead else name)
    return out


def launch_q8(mode: int, q8, k8, qsl, sk, v, sv127, out, n_real: int,
              sl: float, v_strides_of) -> torch.Tensor:
    """Launch ``maest_attn_probe_q8`` (the 8-bit loop's ``mode``) on made
    CUDA inputs; ``v_strides_of`` is the (B, N, H, 64) view whose strides
    stand for v's (unused where v is a transposed copy)."""
    b, n, h, _ = q8.shape
    lib = _build.load_library("attention_probe")
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(q8.device):
        err = _call(lib, "maest_attn_probe_q8", _Q8_ARGS, mode, q8.data_ptr(),
                    k8.data_ptr(), ptr(qsl), ptr(sk), v.data_ptr(), ptr(sv127),
                    out.data_ptr(), b, n, h, n_real,
                    _strides(q8, k8, v_strides_of, out), sl,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"maest_attn_probe_q8 ({mode})")
    return out


def launch_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 variant: str, n_real: int | None = None) -> torch.Tensor:
    """The ``mma.sync`` kernel of ``variant`` alone on CUDA tensors, as
    ``attention_probe`` launches it (mxu_only, noexp_max, novmax; counted
    there) or, for ``bf16s``, as its control ``attention_probe_mma`` does
    (counted there): q must then come through ``prescale_q`` (the rig times
    the kernel so, apart from that pass)."""
    nr = _check(q, k, v, variant, n_real)
    _on_card(q, "launch_probe")
    sl = q.shape[-1]**-0.5 * (1.0 if variant == "mxu_only" else _LOG2E)
    out = launch_bf16("maest_attn_probe_bf16", _ID[variant], q, k, v, nr, sl)
    if variant == "bf16s":
        attention_probe_mma.launches += 1
    else:
        attention_probe.launches[variant] += 1
    return out


# --- P6e: G heads a block ---------------------------------------------------
def _check_gh(q, k, v, group, n_real, fn="attention_probe_gh"):
    if group not in GROUPS:
        raise ValueError(f"{fn} takes a group of "
                         f"{', '.join(map(str, GROUPS))}; got {group!r}")
    nr = _check_qkv(q, k, v, n_real)
    if q.shape[0] * q.shape[2] % group:
        raise ValueError(f"batch * heads = {q.shape[0] * q.shape[2]} is not "
                         f"divisible by the group {group}")
    return nr


def attention_probe_gh_reference(q, k, v, group: int,
                                 n_real: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``attention_probe_gh``: K2's online softmax
    over the key tiles of K2's ``wgmma`` kernel, 96 or 112 keys
    (``wg_key_tile``; the group changes which block computes a head, not
    what it computes)."""
    nr = _check_gh(q, k, v, group, n_real)
    return _walk(q, k, v, "flash", nr, wg_key_tile(nr))


def attention_probe_gh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       group: int, n_real: int | None = None) -> torch.Tensor:
    """K2's forward on (B, N, H, 64) bf16 with ``group`` (batch, head) pairs
    a block, B*H divisible by it (the rig's ``gh<G>``): on CUDA tensors K2's
    ``wgmma`` kernel with G heads a block (entry ``maest_attn_probe_gh``),
    whose output equals K2's (``flash_attention``) bit for bit; on CPU
    tensors ``attention_probe_gh_reference``. Launches counted per group in
    ``attention_probe_gh.launches``."""
    nr = _check_gh(q, k, v, group, n_real)
    if q.device.type == "cpu":
        return attention_probe_gh_reference(q, k, v, group, n_real)
    out = launch_bf16("maest_attn_probe_gh", group, q, k, v, nr,
                      q.shape[-1]**-0.5 * _LOG2E)
    attention_probe_gh.launches[group] += 1
    return out


def attention_probe_gh_mma_reference(q, k, v, group: int,
                                     n_real: int | None = None):
    """Plain PyTorch version of ``attention_probe_gh_mma``: K2's online
    softmax over the control's 64-key tiles."""
    nr = _check_gh(q, k, v, group, n_real, "attention_probe_gh_mma")
    return _walk(q, k, v, "flash", nr)


def attention_probe_gh_mma(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, group: int,
                           n_real: int | None = None) -> torch.Tensor:
    """The control of the ``wgmma`` gh kernel: K2's ``mma.sync`` template
    with ``group`` (batch, head) pairs a block (entry
    ``maest_attn_probe_gh_mma``), whose output equals K2's ``mma.sync``
    kernel's (``attention_fwd_mma``) bit for bit, on (B, N, H, 64) bf16 CUDA
    tensors; ``attention_probe_gh_mma_reference`` on CPU tensors. Launches
    counted per group in ``attention_probe_gh_mma.launches``."""
    nr = _check_gh(q, k, v, group, n_real, "attention_probe_gh_mma")
    if q.device.type == "cpu":
        return attention_probe_gh_mma_reference(q, k, v, group, n_real)
    out = launch_bf16("maest_attn_probe_gh_mma", group, q, k, v, nr,
                      q.shape[-1]**-0.5 * _LOG2E)
    attention_probe_gh_mma.launches[group] += 1
    return out


# --- P6f: int8 q.k and p.v, p's fixed scale 127 ------------------------------
def _quantize_int8_rig(q, k, v):
    """The rig's quantization (attn_profile_r2.py:290-299): q8, k8 (B, N, H,
    64) int8 = round(x / s * 127), s = max(max|x| over d, 1e-6), with their
    s as qs, ks (B, H, N); v8 (B, H, N, 64) int8 and vs (B, H, 64), s over
    the sequence for each column."""
    def quant(x, dim):
        s = torch.clamp_min(x.abs().amax(dim=dim, keepdim=True), _SCALE_FLOOR)
        return torch.round(x / s * 127.0).to(torch.int8), s

    q8, qs = quant(q, -1)
    k8, ks = quant(k, -1)
    v8, vs = quant(v.transpose(1, 2), 2)
    return (q8, k8, qs[..., 0].transpose(1, 2), ks[..., 0].transpose(1, 2),
            v8, vs[:, :, 0])


def _fold127(s):
    """s / 127 / 127, each division rounded as the rig's (:303-304)."""
    return _div(_div(s, 127.0), 127.0)


def int8_rig_pass(q, k, v):
    """The int8 rig's pass before its kernel, as PyTorch ops (XLA in the
    rig): the quantization and the folds of /127^2 into the row scales (with
    scale * log2(e)) and into v's column scales; returns the kernel's inputs
    (q8, k8, qsl, ks, v8 transposed in seq_pos order, vs / 127^2)."""
    q8, k8, qs, ks, v8, vs = _quantize_int8_rig(q, k, v)
    sl = q.shape[-1]**-0.5 * _LOG2E
    return (q8.contiguous(), k8.contiguous(), (_fold127(qs) * sl).contiguous(),
            ks.contiguous(), _seq_major(v8), _fold127(vs).contiguous())


def attention_probe_int8_reference(q, k, v, n_real: int | None = None, *,
                                   with_l: bool = False):
    """Plain PyTorch version of ``attention_probe_int8``, the rig's
    ``_int8_kernel`` (:226-267) over the same 64-key tiles: s = (q8.k8 *
    (qs / 127^2 * sl)) * ks, keys >= n_real at -1e30, the online max m,
    p = exp2((s - m) + 6.9886), l = l corr + sum of p, acc = acc corr +
    round(p).v8, out = (acc * vs / 127^2) / l, fp32. Integer products are
    summed exactly in float64. With ``with_l`` also the row sums l (B, N,
    H): one p that rounds the other way moves a row by at most max|v| /
    (127 l)."""
    nr = _check_qkv(q, k, v, n_real, torch.float32)
    q8, k8, qs, ks, v8, vs = _quantize_int8_rig(q, k, v)
    d = q.shape[-1]
    qsl = _fold127(qs) * (d**-0.5 * _LOG2E)
    qa, ka = (t.transpose(1, 2).double() for t in (q8, k8))
    va = v8.double()
    b, h, n, _ = qa.shape
    m = torch.full((b, h, n, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    acc = torch.zeros((b, h, n, d), device=q.device)
    for base in range(0, nr, BLOCK_K):
        hi = min(base + BLOCK_K, n)
        s = (qa @ ka[:, :, base:hi].transpose(-1, -2)).float()
        s = s * qsl[..., None] * ks[:, :, None, base:hi]
        if hi > nr:
            s[..., nr - base:] = _NEG_INF
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new + P127_SHIFT)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + (torch.round(p).double() @ va[:, :, base:hi]).float()
        m = m_new
    out = (acc * _fold127(vs)[:, :, None] / l).transpose(1, 2)
    return (out, l[..., 0].transpose(1, 2)) if with_l else out


def launch_int8(inputs, n_real: int | None = None) -> torch.Tensor:
    """The int8 kernel alone on the CUDA inputs ``int8_rig_pass`` made (the
    rig times it so, apart from that pass); fp32 (B, N, H, 64) out."""
    q8 = inputs[0]
    _on_card(q8, "launch_int8")
    n = q8.shape[1]
    nr = n if n_real is None else n_real
    if not 1 <= nr <= n:
        raise ValueError(f"n_real={n_real} must lie in 1..{n}")
    out = torch.empty(q8.shape, dtype=torch.float32, device=q8.device)
    launch_q8(_INT8_RIG, *inputs, out, nr, q8.shape[-1]**-0.5 * _LOG2E, q8)
    attention_probe_int8.launches += 1
    return out


def attention_probe_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_real: int | None = None) -> torch.Tensor:
    """The int8 rig's forward (``_int8_kernel`` with ``time_int8``'s
    quantization, attn_profile_r2.py:226-321) on fp32 (B, N, H, 64): int8
    q.k and int8 p.v with p's fixed scale 127, fp32 out. On CUDA tensors
    ``int8_rig_pass`` then the kernel (``launch_int8``); on CPU tensors
    ``attention_probe_int8_reference``. Launches counted in
    ``attention_probe_int8.launches``.

    The output is attention / 127, as the rig's is: its fold ``vsc = vs /
    127 / 127`` (:304) divides by a second 127 for p, but l sums the same
    127-scaled p (:258-260), so that factor never cancels. Run in interpret
    mode at (1, 100, 2, 64) on N(0, 0.5^2) inputs, the rig's kernel gave
    max|out| 1.382e-3 against 0.1751 for attention (a ratio of 126.7), and
    out * 127 lay within 1.94e-3 of attention. The port computes the rig's
    function, factor included; a later rig would fold ``vs / 127``."""
    _check_qkv(q, k, v, n_real, torch.float32)
    if q.device.type == "cpu":
        return attention_probe_int8_reference(q, k, v, n_real)
    _check_views((q, k, v), torch.float32, "q/k/v")
    return launch_int8(int8_rig_pass(q, k, v), n_real)


# --- P9: K2 with the q rows padded to mma.sync's 16 -------------------------
def _check_group(q, k, v, group):
    if group not in QPAD_GROUPS:
        raise ValueError(f"attention_probe_qpad takes a group of "
                         f"{', '.join(map(str, QPAD_GROUPS))}; got {group!r}")
    _check_qkv(q, k, v, None)
    if q.shape[0] * q.shape[2] % group:
        raise ValueError(f"batch * heads = {q.shape[0] * q.shape[2]} is not "
                         f"divisible by the group {group}")


def attention_probe_qpad_reference(q, k, v, group: int,
                                   with_lse: bool = False):
    """Plain PyTorch version of ``attention_probe_qpad``: K2's online
    softmax over the same 64-key tiles (padding and grouping change which
    warp and block compute a row, not what they compute); (o, lse or
    None)."""
    _check_group(q, k, v, group)
    out = _walk(q, k, v, "flash", q.shape[1], BLOCK_K, with_lse)
    return out if with_lse else (out, None)


def attention_probe_qpad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group: int, with_lse: bool = False):
    """K2's forward on (B, N, H, 64) bf16 (K3a's with ``with_lse``) with
    the warps whose 16 rows all lie past N skipping their work, and
    ``group`` (batch, head) pairs a block (1, 8, 12 or 24, dividing B*H):
    ``scripts/qpad_probe.py``'s ``fwd_qpad``. (o, lse or None): on CUDA
    tensors the kernel, equal to K2 (K3a) bit for bit; on CPU tensors
    ``attention_probe_qpad_reference``. Launches counted per group in
    ``attention_probe_qpad.launches``."""
    _check_group(q, k, v, group)
    if q.device.type == "cpu":
        return attention_probe_qpad_reference(q, k, v, group, with_lse)
    out = launch_fwd_entry("attention_probe", "maest_attn_probe_qpad",
                           (group,), q, k, v, None, with_lse,
                           q.shape[-1]**-0.5)
    attention_probe_qpad.launches[group] += 1
    return out


# --- P7: K2 and K3b at other tiles -----------------------------------------
def _check_tile(q, k, v, q_rows, key_tile):
    if q_rows not in Q_ROWS or key_tile not in KEY_TILES:
        raise ValueError(
            f"attention_probe_tile takes q_rows of "
            f"{', '.join(map(str, Q_ROWS))} and key_tile of "
            f"{', '.join(map(str, KEY_TILES))}; got ({q_rows!r}, "
            f"{key_tile!r})")
    _check_qkv(q, k, v, None)


def attention_probe_tile_reference(q, k, v, q_rows: int, key_tile: int,
                                   with_lse: bool = False):
    """Plain PyTorch version of ``attention_probe_tile``: K2's online
    softmax over tiles of ``key_tile`` keys (the query rows a block change
    nothing); (o, lse or None)."""
    _check_tile(q, k, v, q_rows, key_tile)
    out = _walk(q, k, v, "flash", q.shape[1], key_tile, with_lse)
    return out if with_lse else (out, None)


def attention_probe_tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_rows: int, key_tile: int, with_lse: bool = False):
    """K2's forward on (B, N, H, 64) bf16 (K3a's with ``with_lse``) at
    ``q_rows`` query rows a block (64, 128, 256) and ``key_tile`` keys a
    tile (32, 64, 128): ``scripts/attn_tune.py``'s ``time_config``. (o, lse
    or None): on CUDA tensors the kernel ((128, 64) is K2's instance); on
    CPU tensors ``attention_probe_tile_reference``. Launches counted per
    (q_rows, key_tile) in ``attention_probe_tile.launches``."""
    _check_tile(q, k, v, q_rows, key_tile)
    if q.device.type == "cpu":
        return attention_probe_tile_reference(q, k, v, q_rows, key_tile,
                                              with_lse)
    out = launch_fwd_entry("attention_probe", "maest_attn_probe_tile",
                           (q_rows, key_tile), q, k, v, None, with_lse,
                           q.shape[-1]**-0.5)
    attention_probe_tile.launches[(q_rows, key_tile)] += 1
    return out


def _check_bwd_tile(q, k, v, o, lse, do, rows, tile):
    if rows not in BWD_TILES or tile not in BWD_TILES:
        raise ValueError(
            f"attention_bwd_tile takes rows and tile of "
            f"{', '.join(map(str, BWD_TILES))}; got ({rows!r}, {tile!r})")
    _check_qkv(q, k, v, None)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o and do must have q's (B, N, H, 64) shape, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}")
    b, n, h, _ = q.shape
    if lse.shape != (b, h, n):
        raise ValueError(f"lse must be (B, H, N) = {(b, h, n)}, got "
                         f"{tuple(lse.shape)}")


def attention_bwd_tile(q, k, v, o, lse, do, rows: int, tile: int):
    """K3b's backward on (B, N, H, 64) bf16 q, k, v, o, do and the
    forward's lse (B, H, N) at ``rows`` keys (dk/dv) or q rows (dq) a block
    and ``tile`` streamed rows a shared-memory tile, each 32, 64 or 128:
    ``scripts/attn_tune.py``'s ``time_bwd``. (dq, dk, dv): on CUDA tensors
    the kernels ((64, 64) is K3b's instance); on CPU tensors
    ``attention_bwd_reference``. Launches counted per (rows, tile) in
    ``attention_bwd_tile.launches``."""
    _check_bwd_tile(q, k, v, o, lse, do, rows, tile)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do)
    grads = launch_bwd_entry("maest_attn_bwd_tile", (rows, tile), q, k, v, o,
                             lse, do, None, q.shape[-1]**-0.5)
    attention_bwd_tile.launches[(rows, tile)] += 1
    return grads.unbind(2)


attention_probe.launches = dict.fromkeys(VARIANTS, 0)
attention_probe_mma.launches = 0
attention_probe_gh.launches = dict.fromkeys(GROUPS, 0)
attention_probe_gh_mma.launches = dict.fromkeys(GROUPS, 0)
attention_probe_int8.launches = 0
attention_probe_qpad.launches = dict.fromkeys(QPAD_GROUPS, 0)
attention_probe_tile.launches = {(r, t): 0 for r in Q_ROWS for t in KEY_TILES}
attention_bwd_tile.launches = {(r, t): 0 for r in BWD_TILES
                               for t in BWD_TILES}
