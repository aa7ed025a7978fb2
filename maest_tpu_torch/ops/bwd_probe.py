"""The backward rig's kernels, port of ``scripts/bwd_int8_probe.py``'s
``_bwd_rig_kernel`` (P4).

``bwd_probe(q, kt, v, do, o, lse, kind)`` computes one kind of the rig per
head, over every row and key (no key mask: the rig's pad rows hold random
values too), with delta = rowsum(do o) in fp32, SCALE = head_dim^-0.5 (the
rig's 64^-0.5) and sl = SCALE log2(e). q, v, do, o are (bh, N, 64), kt (bh,
64, N) (K transposed, in natural key order), lse (bh, 1, N) fp32, o bf16:

- ``int8``: q, kt, v, do int8. s = float(q.kt) (sl 1e-4); p = exp2(s -
  lse); p8 = int8(p 127); dv = float(p8^T.do) 1e-2; dp = float(do.v^T)
  1e-4; ds8 = int8(p (dp - delta) (SCALE 127)); dq = float(ds8.K) 1e-2; dk
  = float(ds8^T.q) 1e-2; int32 sums. **The output is not a gradient**: the
  rig carries fixed scales, not real ones, and its numerics are garbage by
  design (bwd_int8_probe.py:9-13); the port computes its function as it
  is, factor for factor.
- ``fp8``: q, kt, v, do e4m3. s = (q.kt, fp32 sums) sl; p = exp2(s - lse);
  dv = bf16(p)^T.do; dp = do.v^T in e4m3; ds = bf16(p (dp - delta) SCALE);
  dq = ds.K; dk = ds^T.q; fp32 sums.
- ``ctrl``: the production backward (K3b, the wgmma kernel of
  ``csrc/attn_bwd_wgmma.cuh``): q, k (in kt's place), v, do, o
  are (B, N, H, 64) bf16 and lse the rig's (B H, 1, N_pad) draw, of which
  the first N entries are the (B, H, N) lse.

Out: dq bf16, dk and dv fp32, (bh, N, 64); ctrl dq, dk, dv (B, N, H, 64)
bf16. int8(x) is jnp's ``round(x).astype(int8)``: half to even, saturated
(``ops/int8_probe.py to_int8``): ds8 leaves the int8 range at the rig's
inputs, so saturation is part of the function.

On CUDA tensors the wrapper launches hand-written kernels, counted per
kind in ``bwd_probe.launches``: the int8 kind K7's dk/dv and dq kernels
with the rig's fixed scalars (``csrc/attention_bwd_q8.cu``, ``RIG``), the
fp8 kind K3b's with e4m3 s and dp products (``csrc/attention_bwd.cu``,
``E4M3``), ctrl K3b itself (``ops/attention.py launch_bwd_entry``, entry
``maest_attn_bwd_bf16``: the prep pass and the wgmma kernel). A
layout pass (``bwd_pass``, one kernel: ``maest_bwd_rig_layout``) first
makes what those kernels read and the rig does not hold: K's rows from
kt (8-bit B operands are read column-major; ldmatrix cannot transpose
bytes), q, do and K transposed in the seq_pos order of
``csrc/mma_8bit.cuh`` (int8, for its products over the sequence), and
delta; ctrl's pass takes lse's first N entries. The rig times the pass inside the call and the kernels alone
apart. head_dim 64 (the rig's D) and, for the 8-bit kinds, N a multiple
of 64; another shape raises. On CPU tensors the wrapper runs the plain
version, ``bwd_probe_reference``: integer products summed exactly (fp64,
every sum below 2^24), fp32 elsewhere, the constants formed as the rig
forms them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import (
    _LOG2E,
    attention_bwd_reference,
    launch_bwd_entry,
)
from .attention_probe import _call
from .int8_probe import bf16_ulp, to_int8

KINDS = ("ctrl", "int8", "fp8")
HEAD_DIM = 64  # the rig's D
_RIG_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python double rounded once to fp32, as jnp takes a weak scalar."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _exact(a, b):
    """a . b on integer-valued operands, exact in fp64."""
    return a.double() @ b.double()


def _check(q, kt, v, do, o, lse, kind):
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of "
                         f"{', '.join(KINDS)}")
    ts = (q, kt, v, do, o, lse)
    if any(t.device != q.device for t in ts):
        raise ValueError("the rig's tensors must lie on one device")
    if lse.dtype != torch.float32 or lse.ndim != 3 or lse.shape[1] != 1:
        raise ValueError(f"lse must be fp32 (bh, 1, N), got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if kind == "ctrl":
        if q.ndim != 4 or any(t.shape != q.shape or t.dtype != torch.bfloat16
                              for t in (q, kt, v, do, o)):
            raise ValueError("ctrl takes (B, N, H, D) bf16 q, k, v, do, o")
        b, n, h, _ = q.shape
        if lse.shape[0] != b * h or lse.shape[2] < n:
            raise ValueError(f"ctrl's lse must be (B H, 1, >= N) = ({b * h}, "
                             f"1, >= {n}), got {tuple(lse.shape)}")
        return
    dt = _RIG_DTYPE[kind]
    if q.ndim != 3 or any(t.dtype != dt for t in (q, kt, v, do)):
        raise TypeError(f"{kind} takes {dt} (bh, N, D) q, v, do and (bh, D, "
                        f"N) kt")
    bh, n, d = q.shape
    if (kt.shape != (bh, d, n) or v.shape != q.shape or do.shape != q.shape
            or o.shape != q.shape or o.dtype != torch.bfloat16
            or lse.shape != (bh, 1, n)):
        raise ValueError(f"{kind} takes q, v, do, o (bh, N, D) (o bf16), kt "
                         f"(bh, D, N) and lse (bh, 1, N); got "
                         f"{[tuple(t.shape) for t in ts]}")


def ctrl_lse(lse: torch.Tensor, b: int, h: int, n: int) -> torch.Tensor:
    """ctrl's (B, H, N) lse: the first N entries of the rig's (B H, 1,
    N_pad) draw (its pad rows carry zero q, do and o into _flash_bwd and
    add nothing)."""
    return lse[:, 0, :n].reshape(b, h, n)


def _delta(do, o):
    """rowsum(do o) in fp32, (bh, N, 1)."""
    return (do.float() * o.float()).sum(-1, keepdim=True)


def int8_values(q, kt, v, do, o, lse, delta=None):
    """(p, p 127, p (dp - delta) SCALE 127): the int8 kind's p and the fp32
    values of its codes p8 and ds8 before rounding, in the rig's order;
    ``delta`` (bh, N) in place of the plain rowsum(do o) where given."""
    scale = q.shape[-1]**-0.5
    s = _exact(q, kt).float() * _f32(scale * _LOG2E * 1e-4, q)
    p = torch.exp2(s - lse.transpose(1, 2))
    dp = _exact(do, v.transpose(1, 2)).float() * _f32(1e-4, q)
    dl = _delta(do, o) if delta is None else delta[..., None]
    return p, p * 127.0, p * (dp - dl) * _f32(scale * 127.0, q)


def int8_codes(q, kt, v, do, o, lse, delta=None):
    """(p8, ds8), the int8 kind's (bh, N, N) codes of the plain version;
    with ``delta`` (bh, N) in place of its own rowsum(do o) where given."""
    _, x, y = int8_values(q, kt, v, do, o, lse, delta)
    return to_int8(x), to_int8(y)


def int8_outputs(q, kt, do, p8, ds8):
    """(dq bf16, dk, dv) of the int8 kind from its codes."""
    c = _f32(1e-2, q)
    dv = _exact(p8.transpose(1, 2), do).float() * c
    dq = (_exact(ds8, kt.transpose(1, 2)).float() * c).to(torch.bfloat16)
    dk = _exact(ds8.transpose(1, 2), q).float() * c
    return dq, dk, dv


def bwd_probe_reference(q, kt, v, do, o, lse, kind: str):
    """Plain PyTorch P4 ``kind`` (see the module docstring)."""
    _check(q, kt, v, do, o, lse, kind)
    if kind == "ctrl":
        b, n, h, _ = q.shape
        return attention_bwd_reference(q, kt, v, o, ctrl_lse(lse, b, h, n),
                                       do)
    if kind == "int8":
        return int8_outputs(q, kt, do, *int8_codes(q, kt, v, do, o, lse))
    scale = q.shape[-1]**-0.5
    qf, kf, vf, df = (t.float() for t in (q, kt, v, do))
    s = (qf @ kf) * _f32(scale * _LOG2E, q)
    p = torch.exp2(s - lse.transpose(1, 2))
    dv = p.to(torch.bfloat16).float().transpose(1, 2) @ df
    dp = df @ vf.transpose(1, 2)
    ds = (p * (dp - _delta(do, o)) * _f32(scale, q)).to(torch.bfloat16).float()
    dq = (ds @ kf.transpose(1, 2)).to(torch.bfloat16)
    dk = ds.transpose(1, 2) @ qf
    return dq, dk, dv


# --- the card ----------------------------------------------------------------
def _check_card(q, kt, v, do, o, lse, kind):
    """Raise for what the kernels have no instance of, before any work:
    head_dim other than 64, an 8-bit N that is not a multiple of 64, a
    device other than CUDA, non-contiguous tensors."""
    d = q.shape[-1]
    if d != HEAD_DIM:
        raise ValueError(f"the backward rig's kernels take head_dim "
                         f"{HEAD_DIM} (the rig's D), got {d}")
    if kind != "ctrl" and q.shape[1] % 64:
        raise ValueError(f"the {kind} kernels take N a multiple of 64, got "
                         f"{q.shape[1]}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device} for the rig")
    if not all(t.is_contiguous() for t in (q, kt, v, do, o, lse)):
        raise ValueError("the backward rig's kernels take contiguous tensors")


def bwd_pass(q, kt, v, do, o, lse, kind: str) -> tuple:
    """What a kind's kernels read, made on the card (the rig times it inside
    the call): ctrl (q, k, v, o, (B, H, N) lse, do); the 8-bit kinds the
    layout kernel's K rows and delta (int8 also q, do and K transposed in
    the seq_pos order): int8 (q, K rows, v, do, qt, dot, kts, lse (bh, N),
    delta), fp8 (q, K rows, v, do, lse (bh, N), delta)."""
    if kind == "ctrl":
        b, n, h, _ = q.shape
        return q, kt, v, o, ctrl_lse(lse, b, h, n).contiguous(), do
    bh, n, d = q.shape
    i8 = kind == "int8"
    krows = torch.empty((bh, n, d), dtype=torch.uint8, device=q.device)
    tr = (torch.empty((3, bh, d, n), dtype=torch.uint8, device=q.device)
          if i8 else None)  # q, do, K transposed
    delta = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    lib = _build.load_library("attention_bwd_q8")
    with torch.cuda.device(q.device):
        err = _call(lib, "maest_bwd_rig_layout", [ctypes.c_int]
                    + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p], int(i8), q.data_ptr(),
                    kt.data_ptr(), do.data_ptr(), o.data_ptr(),
                    krows.data_ptr(), *((x.data_ptr() for x in tr) if i8
                                        else (None,) * 3),
                    delta.data_ptr(), bh, n,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "maest_bwd_rig_layout")
    lse2 = lse.view(bh, n)
    if i8:
        return (q, krows, v, do, *tr.unbind(0), lse2, delta)
    return q, krows, v, do, lse2, delta


def launch_pass(made: tuple, kind: str) -> tuple:
    """The kernels of ``kind`` alone on what ``bwd_pass`` made; uncounted
    (the rig times them so, apart from the pass). (dq, dk, dv)."""
    if kind == "ctrl":
        q, k, v, o, lse, do = made
        return launch_bwd_entry("maest_attn_bwd_bf16", (), q, k, v, o, lse,
                                do, None, q.shape[-1]**-0.5).unbind(2)
    q = made[0]
    bh, n, d = q.shape
    dq = torch.empty((bh, n, d), dtype=torch.bfloat16, device=q.device)
    dk = torch.empty((bh, n, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    scale = d**-0.5
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in made + (dq, dk, dv)]
    if kind == "int8":
        lib = _build.load_library("attention_bwd_q8")
        name, sl, ds_scale = "maest_bwd_rig_i8", scale * _LOG2E * 1e-4, (
            scale * 127.0)
    else:
        lib = _build.load_library("attention_bwd")
        name, sl, ds_scale = "maest_bwd_rig_fp8", scale * _LOG2E, scale
    with torch.cuda.device(q.device):
        err = _call(lib, name, [ctypes.c_void_p] * len(ptrs)
                    + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                    + [ctypes.c_void_p], *ptrs, bh, n, sl, ds_scale, stream)
    _build.check(lib, err, name)
    return dq, dk, dv


def bwd_probe(q, kt, v, do, o, lse, kind: str) -> tuple:
    """P4 ``kind`` (see the module docstring): (dq, dk, dv). CUDA tensors:
    the layout pass and the kernels, counted per kind in
    ``bwd_probe.launches``; CPU tensors: ``bwd_probe_reference``."""
    _check(q, kt, v, do, o, lse, kind)
    if q.device.type == "cpu":
        return bwd_probe_reference(q, kt, v, do, o, lse, kind)
    _check_card(q, kt, v, do, o, lse, kind)
    out = launch_pass(bwd_pass(q, kt, v, do, o, lse, kind), kind)
    bwd_probe.launches[kind] += 1
    return out


# --- the bounds a kernel is held to against its plain version ---------------
FLIP = 127 * 1e-2  # one int8 code one apart moves a dq, dk, dv element by
                   # at most 127 (the other operand's largest |code|) x 1e-2


def int8_gap(out, ref, codes, alt) -> dict:
    """The int8 kind's kernel outputs ``out`` against the plain version's
    ``ref`` (dq, dk, dv), with the plain codes ``codes`` (p8, ds8) and the
    codes ``alt`` the kernel's side takes (JAX's, or the plain codes on the
    kernel's own delta): every code of ``alt`` within 1 of the plain one;
    dq, dk, dv equal wherever no code of their row (dq: ds8's row) or
    column (dk: ds8's column, dv: p8's) differs, and otherwise within FLIP
    per differing code, plus one bf16 ulp of the element for dq (rounded to
    bf16 after the sums) and 2 fp32 ulps for dk, dv. Returns {"p8", "ds8":
    codes that differ, "err": max |out - ref| per output, "ok"}."""
    dp8 = codes[0].int() - alt[0].int()
    dds = codes[1].int() - alt[1].int()
    ok = bool(dp8.abs().max() <= 1 and dds.abs().max() <= 1)
    col_p = (dp8 != 0).sum(1).float()[..., None]   # (bh, keys, 1)
    col_ds = (dds != 0).sum(1).float()[..., None]
    row_ds = (dds != 0).sum(2).float()[..., None]  # (bh, q rows, 1)
    err = {}
    for w, a, r, count in zip(("dq", "dk", "dv"), out, ref,
                              (row_ds, col_ds, col_p)):
        diff = (a.float() - r.float()).abs()
        rf = torch.maximum(a.float().abs(), r.float().abs())
        if w == "dq":
            slack = torch.exp2(torch.floor(torch.log2(rf.clamp_min(1e-30)))
                               - 7) * (count > 0)
        else:
            slack = 2 * torch.finfo(torch.float32).eps * rf * (count > 0)
        ok = ok and bool((diff <= FLIP * count + slack).all())
        err[w] = diff.max().item()
    return {"p8": int((dp8 != 0).sum()), "ds8": int((dds != 0).sum()),
            "err": err, "ok": ok}


def _ulps_of_max(out, ref) -> dict:
    """(dq, dk, dv) ``out`` against ``ref``: each output within 2 bf16 ulps
    of its largest |element| in ``ref``. Returns {"err", "bound" per
    output, "ok"}."""
    err, bound, ok = {}, {}, True
    for w, a, r in zip(("dq", "dk", "dv"), out, ref):
        err[w] = (a.float() - r.float()).abs().max().item()
        bound[w] = 2 * bf16_ulp(r.float().abs().max().item())
        ok = ok and err[w] <= bound[w]
    return {"err": err, "bound": bound, "ok": ok}


def fp8_gap(out, ref) -> dict:
    """The fp8 kind's kernel outputs against the plain version's: both sum
    exact e4m3 and bf16 products in fp32 in other orders and round p and ds
    to bf16 (an fp32 ulp apart at a rounding boundary moves one of them by a
    bf16 ulp), dq once more to bf16: each output within 2 bf16 ulps of its
    largest |element|. Returns {"err", "bound" per output, "ok"}."""
    return _ulps_of_max(out, ref)


def ctrl_gap(out, ref) -> dict:
    """ctrl (K3b, or JAX's ``_flash_bwd``) against its plain version, which
    sums in fp32 and rounds dq, dk, dv to bf16 once: K3b rounds p and ds to
    bf16 before their products and sums in other orders, then rounds each
    output to bf16 (one ulp of the element at a boundary). Each output
    within 2 bf16 ulps of its largest |element|: a bound relative to the
    output's size, because at the rig's inputs (lse ~ N(8, 1), so p is
    near 2^-8) the gradients are small and an absolute bf16 bound would let
    a wrong dk through. Returns {"err", "bound" per output, "ok"}."""
    return _ulps_of_max(out, ref)


def flops(bh: int, n: int, d: int = HEAD_DIM) -> int:
    """The five products' operations: 5 x 2 N^2 d a head."""
    return 5 * 2 * bh * n * n * d


def nbytes(kind: str, bh: int, n: int, d: int = HEAD_DIM) -> int:
    """Each input read once and each output written once: q, kt, v, do
    (1 byte an element; ctrl 2), o (2), lse (4); dq (2), dk and dv (4;
    ctrl 2)."""
    x = bh * n * d
    if kind == "ctrl":
        return 8 * x * 2 + 4 * bh * n
    return 4 * x + 2 * x + 4 * bh * n + 2 * x + 8 * x


def exp2_count(bh: int, n: int) -> int:
    """One score pass's exp2: one a (row, key)."""
    return bh * n * n


bwd_probe.launches = dict.fromkeys(KINDS, 0)
