"""The int8 product rigs' kernels, port of ``scripts/int8_probe.py``'s
``_probe_kernel`` (P2) and ``scripts/int8_probe2.py``'s ``_probe_kernel``
(P3).

``int8_probe(a, b, kind)`` computes one P2 kind, batched over programs
(shapes a program at the rig's N 1792):

- ``k64_bf16`` (N, 64) . (64, N) and ``pv_bf16`` (N, N) . (N, 64): bf16
  operands, fp32 sums, bf16 out.
- ``k64_i8``, ``pv_i8``: the same shapes in int8, int32 out.
- ``k64_i8q``: bf16 a (N, 64) and b (64, N); sa = max|a| / 127 and sb =
  max|b| / 127 over the program; qa = int8(round(a / sa)), qb likewise;
  out = bf16(float(qa . qb) (sa sb)), (N, N).
- ``mix_bf16``: s = a . b (fp32) for a (N, 64), b (64, N); p = exp2(s
  1e-4 - 1); out[:, :64] = bf16(bf16(p) . b^T), of an (N, N) bf16 output.
- ``mix_i8``: s = a . b (int32); p the same of float(s); p8 =
  int8(round(p 127)); out[:, :64] = float(p8 . b^T), (N, N) fp32.

``int8_big_probe(a, b, kind)`` computes one P3 kind (N 1792, R 56):

- ``k64big_bf16``, ``k64big_i8``, ``k64big_fp8``: out = sum over j < 56 of
  a . b[:, 256 j : 256 (j + 1)] for a (N, 64), b (64, 56 256): bf16, int8
  (int32 sums and out) or e4m3 operands, fp32 sums, bf16 out but for i8.
- ``k64big_i8cvt``: int8 operands; acc += float(a . b_j) row with row =
  float(a[:, 0]) 1e-4, in fp32; bf16 out.
- ``pvbig_bf16``, ``pvbig_i8``: 4 heads, each (N, N) . (N, 64).

Every int8(...) above is jnp's ``round(x).astype(int8)``: half to even,
saturated to [-128, 127], NaN to 0 (``to_int8``).

On CUDA tensors the wrappers launch hand-written kernels, counted in
``int8_probe.launches`` and ``int8_big_probe.launches``: the bf16 kinds are
P1's products (``k64_bf16`` is ``mxu_probe``'s k64w, ``pv_bf16`` its
pvwide, ``k64big_bf16`` and ``pvbig_bf16`` its own) and ``k64big_fp8`` an
e4m3 one, all on the product kernel's route, ``wgmma`` fed by TMA
(``csrc/mma_probe_wgmma.cuh``); the int8 products the mma.sync kernel's
8-bit instances (``csrc/mma_probe.cu``; ``k64_i8q`` its amax pass and
quantising product), and the mix kinds K2's and K5's loops (``csrc/attention_probe.cu``, variants MIX and MIX8). The
8-bit products read B column-major and the 8-bit p.v reads b in the
seq_pos order of ``csrc/mma_8bit.cuh``, so the wrappers copy b into those
layouts (``int8_pass``); the rigs time the copies inside the call and
report the kernel alone apart. A shape without an instance raises. On CPU
tensors they run the plain versions, ``int8_probe_reference`` and
``int8_big_probe_reference``: each kind's function with exact integer sums
(fp64, exact below 2^53) and fp32 where the rig's arithmetic is fp32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import mma_probe as M
from .attention import _seq_major, _strides
from .attention_probe import _BF16_ARGS, _Q8_ARGS, _call

P2_KINDS = ("k64_bf16", "k64_i8", "k64_i8q", "pv_bf16", "pv_i8", "mix_bf16",
            "mix_i8")
P3_KINDS = ("k64big_bf16", "k64big_i8", "k64big_i8cvt", "k64big_fp8",
            "pvbig_bf16", "pvbig_i8")
FOLD = 56            # P3's column blocks (int8_probe2.py:40 R)
MIX_COLS = 64        # the columns the mix kinds write
_MIX_BF16, _MIX8 = 6, 8  # attention_probe.cu's variant and mode ids
# the bf16 kinds are P1's kinds
_P1 = {"k64_bf16": "k64w", "pv_bf16": "pvwide", "k64big_bf16": "k64big",
       "pvbig_bf16": "pvbig"}
# the product kernel's type of the 8-bit products but S8_I32's
_TYPE = {"k64big_fp8": M.E4M3, "k64big_i8cvt": M.S8_CVT}


def operand_dtype(kind: str) -> torch.dtype:
    """The rig's operand type of ``kind``."""
    if kind.endswith("fp8"):
        return torch.float8_e4m3fn
    if "_i8" in kind and kind != "k64_i8q":
        return torch.int8
    return torch.bfloat16


def out_dtype(kind: str) -> torch.dtype:
    """The rig's output type of ``kind`` (int8_probe.py:104,
    int8_probe2.py:102)."""
    if kind == "mix_i8":
        return torch.float32
    if "_i8" in kind and kind not in ("k64_i8q", "k64big_i8cvt"):
        return torch.int32
    return torch.bfloat16


def _check(a, b, kind, kinds):
    if kind not in kinds:
        raise ValueError(f"unknown kind {kind!r}; expected one of "
                         f"{', '.join(kinds)}")
    dt = operand_dtype(kind)
    if a.dtype != dt or b.dtype != dt:
        raise TypeError(f"{kind} takes {dt} operands, got {a.dtype}, "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")
    lead = 2 if kind.startswith("pvbig") else 1
    if (a.ndim != lead + 2 or b.ndim != lead + 2 or a.shape[:lead] !=
            b.shape[:lead] or a.shape[-1] != b.shape[-2]):
        raise ValueError(f"{kind} takes a (programs{', heads' * (lead - 1)}, "
                         f"M, K) and b (..., K, cols) of one batch, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if kind.startswith("k64big") and b.shape[-1] % FOLD:
        raise ValueError(f"{kind} folds b's columns in {FOLD} blocks, got "
                         f"{b.shape[-1]}")
    if kind.startswith("mix") and (a.shape[-1] != MIX_COLS
                                   or a.shape[-2] != b.shape[-1]):
        raise ValueError(f"{kind} takes a (programs, N, 64) and b "
                         f"(programs, 64, N), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")


def to_int8(x: torch.Tensor) -> torch.Tensor:
    """jnp's ``round(x).astype(int8)`` on fp32 x: round half to even,
    saturate to [-128, 127], NaN to 0."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), torch.round(x))
    return x.clamp(-128, 127).to(torch.int8)


def _exact(a, b):
    """a . b on integer-valued operands, exact: fp64 sums of exact
    products (every sum here stays far below 2^53)."""
    return a.double() @ b.double()


def _mix_out(rows, dtype, device, lead):
    """The rig's (N, N) mix output as interpret mode leaves it: NaN past
    column 64 (undefined on the card, where the kernel writes columns 0-63
    and leaves the rest as ``torch.empty`` left it)."""
    return torch.full(lead + (rows, rows), float("nan"), dtype=dtype,
                      device=device)


def _mix_p(s):
    """p = exp2(s 1e-4 - 1) in fp32, each step rounded on its own."""
    return torch.exp2(s.float() * 1e-4 - 1.0)


def int8_probe_reference(a: torch.Tensor, b: torch.Tensor,
                         kind: str) -> torch.Tensor:
    """Plain PyTorch P2 ``kind`` (see the module docstring)."""
    _check(a, b, kind, P2_KINDS)
    if kind in _P1:
        return M.mxu_probe_reference(a, b, _P1[kind])
    if kind in ("k64_i8", "pv_i8"):
        return _exact(a, b).to(torch.int32)
    if kind == "k64_i8q":
        af, bf = a.float(), b.float()
        sa = af.abs().amax(dim=(-2, -1), keepdim=True) / 127.0
        sb = bf.abs().amax(dim=(-2, -1), keepdim=True) / 127.0
        qa, qb = to_int8(af / sa), to_int8(bf / sb)
        return (_exact(qa, qb).float() * (sa * sb)).to(torch.bfloat16)
    lead = a.shape[:-2]
    n = a.shape[-2]
    if kind == "mix_bf16":
        p = _mix_p(a.float() @ b.float()).to(torch.bfloat16)
        pv = (p.float() @ b.float().transpose(-1, -2)).to(torch.bfloat16)
    else:
        p8 = to_int8(_mix_p(_exact(a, b)) * 127.0)
        pv = _exact(p8, b.transpose(-1, -2)).float()
    out = _mix_out(n, pv.dtype, a.device, lead)
    out[..., :MIX_COLS] = pv
    return out


def int8_big_probe_reference(a: torch.Tensor, b: torch.Tensor,
                             kind: str) -> torch.Tensor:
    """Plain PyTorch P3 ``kind`` (see the module docstring): the fold kinds
    sum their 56 blocks in the rig's order."""
    _check(a, b, kind, P3_KINDS)
    if kind in _P1:
        return M.mxu_probe_reference(a, b, _P1[kind])
    if kind == "pvbig_i8":
        return _exact(a, b).to(torch.int32)
    width = b.shape[-1] // FOLD
    blocks = [b[..., j * width:(j + 1) * width] for j in range(FOLD)]
    if kind == "k64big_i8":
        return sum(_exact(a, bj) for bj in blocks).to(torch.int32)
    if kind == "k64big_fp8":
        acc = torch.zeros(a.shape[:-1] + (width,), device=a.device)
        for bj in blocks:
            acc = acc + a.float() @ bj.float()
        return acc.to(torch.bfloat16)
    row = a[..., :1].float() * 1e-4  # k64big_i8cvt
    acc = torch.zeros(a.shape[:-1] + (width,), device=a.device)
    for bj in blocks:
        acc = acc + _exact(a, bj).float() * row
    return acc.to(torch.bfloat16)


# --- the card ----------------------------------------------------------------
def _cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device} for the int8 rigs")
    return t.contiguous()


def int8_pass(a: torch.Tensor, b: torch.Tensor, kind: str) -> tuple:
    """The copies a kind's kernel reads, made on the card (the rigs time
    them inside the call): 8-bit b column-major (B^T rows) for the
    products, and for ``mix_i8`` also b in the seq_pos order of its p.v;
    for ``mix_bf16`` b^T, which serves as k and v. Returns (a, b as the
    kernel reads it, the seq_pos copy or None)."""
    a, b = _cuda(a), _cuda(b)
    if kind in _P1 or kind == "k64_i8q":
        return a, b, None
    bt = b.transpose(-1, -2).contiguous()
    if kind != "mix_i8":
        return a, bt, None
    p, n = bt.shape[0], bt.shape[1]
    return a, bt, _seq_major(bt.view(p, 1, n, MIX_COLS))


def _check_instance(a, b, kind):
    """Raise for a shape the kernels have no instance of (before any
    copy): the bf16 and e4m3 products the tiles of their route
    (``mma_probe.tile``); the int8 products M a multiple of 128, output
    columns of the control's tile and K of 64; k64_i8q K = 64 and M, N
    multiples of 128; the mix kinds any N."""
    if kind.startswith("mix"):
        return
    m, k = a.shape[-2:]
    big = kind.startswith("k64big")
    if kind in _P1 or kind == "k64big_fp8":  # the product kernel's route
        M.tile(m, k, b.shape[-1] // (FOLD if big else 1), FOLD if big else 1,
               _TYPE.get(kind, M.BF16), M.route(_TYPE.get(kind, M.BF16)))
        return
    if kind == "k64_i8q":
        ncols, bn = b.shape[-1], M.TILE_M
        ok = k == 64 and not m % M.TILE_M and not ncols % bn
    else:
        ncols = b.shape[-1] // (FOLD if big else 1)
        bn = 64 if ncols == 64 else 128
        ok = not (m % M.TILE_M or ncols % bn or k % 64)
    if not ok:
        raise ValueError(
            f"the {kind} kernel takes M a multiple of {M.TILE_M}, output "
            f"columns of {bn} and K of 64{' exactly' * (kind == 'k64_i8q')};"
            f" got M {m}, columns {ncols}, K {k}")


def launch_pass(a, b, extra, kind: str) -> torch.Tensor:
    """The kernel of ``kind`` alone on the copies ``int8_pass`` made;
    uncounted (the rigs time it so, apart from the pass)."""
    if kind in _P1:
        return M.launch_mxu(a, b, _P1[kind], FOLD if kind == "k64big_bf16"
                            else 1)
    od = out_dtype(kind)
    if kind.startswith("mix"):
        return _launch_mix(a, b, extra, kind, od)
    if kind == "k64_i8q":
        return launch_i8q(a, b)[0]
    # 8-bit products: a (.., M, K), b as (.., cols, K) rows
    big = kind.startswith("k64big")
    fold = FOLD if big else 1
    m, k = a.shape[-2:]
    ncols = b.shape[-2] // fold
    a3 = a.reshape((-1, m, k))
    b3 = b.reshape((-1,) + b.shape[-2:])
    out = torch.empty(a.shape[:-1] + (ncols,), dtype=od, device=a.device)
    M._launch(a3, b3, out.view(a3.shape[0], m, ncols), fold, b3[0].numel(),
              _TYPE.get(kind, M.S8_I32))
    return out


def launch_i8q(a, b):
    """k64_i8q's amax pass and quantising product on contiguous CUDA a, b;
    (out, the (programs, 2) maxima max|a|, max|b| it scaled by)."""
    p, m, _ = a.shape
    n = b.shape[-1]
    out = torch.empty((p, m, n), dtype=torch.bfloat16, device=a.device)
    amax = torch.empty(2 * p, dtype=torch.float32, device=a.device)
    lib = _build.load_library("mma_probe")
    with torch.cuda.device(a.device):
        err = _call(lib, "maest_mma_i8q", [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p], a.data_ptr(), b.data_ptr(),
            amax.data_ptr(), out.data_ptr(), p, m, n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "maest_mma_i8q")
    return out, amax.view(p, 2)


def _launch_mix(a, bt, vt, kind, od):
    """K2's loop (mix_bf16: k = v = b^T) or K5's (mix_i8: k8 = b^T, v8 the
    seq_pos copy) over one head a program; out (programs, N, N), columns
    0-63 written."""
    p, n, _ = a.shape
    out = torch.empty((p, n, n), dtype=od, device=a.device)
    q4, k4 = a.view(p, n, 1, MIX_COLS), bt.view(p, n, 1, MIX_COLS)
    o4 = out[..., :MIX_COLS].unsqueeze(2)  # (N N, N, -, 1) strides
    lib = _build.load_library("attention_probe")
    stream = torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(a.device):
        if kind == "mix_bf16":
            err = _call(lib, "maest_attn_probe_bf16", _BF16_ARGS, _MIX_BF16,
                        q4.data_ptr(), k4.data_ptr(), k4.data_ptr(),
                        out.data_ptr(), p, n, 1, n, _strides(q4, k4, k4, o4),
                        0.0, stream)
        else:
            err = _call(lib, "maest_attn_probe_q8", _Q8_ARGS, _MIX8,
                        q4.data_ptr(), k4.data_ptr(), None, None,
                        vt.data_ptr(), None, out.data_ptr(), p, n, 1, n,
                        _strides(q4, k4, q4, o4), 0.0, stream)
    _build.check(lib, err, f"{kind} (attention_probe.cu)")
    return out


def int8_probe(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """P2 ``kind`` (see the module docstring). CUDA tensors: the kernels,
    counted in ``int8_probe.launches``; CPU tensors:
    ``int8_probe_reference``."""
    _check(a, b, kind, P2_KINDS)
    if a.device.type == "cpu":
        return int8_probe_reference(a, b, kind)
    _check_instance(a, b, kind)
    out = launch_pass(*int8_pass(a, b, kind), kind)
    int8_probe.launches += 1
    return out


def int8_big_probe(a: torch.Tensor, b: torch.Tensor,
                   kind: str) -> torch.Tensor:
    """P3 ``kind`` (see the module docstring). CUDA tensors: the kernels,
    counted in ``int8_big_probe.launches``; CPU tensors:
    ``int8_big_probe_reference``."""
    _check(a, b, kind, P3_KINDS)
    if a.device.type == "cpu":
        return int8_big_probe_reference(a, b, kind)
    _check_instance(a, b, kind)
    out = launch_pass(*int8_pass(a, b, kind), kind)
    int8_big_probe.launches += 1
    return out


# --- the bounds a kernel is held to against its plain version ---------------
MIX_FLIP = 127.0  # mix_i8: one p8 a row one apart moves it by max|b| <= 127
REL_L2 = 1e-2     # the bf16 and e4m3 products' relative L2 bound (P1, P8)


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def plain_gap(kind: str, out: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |out - ref| over the columns the kernel writes, its bound,
    within) of a kernel's output against its plain version on the same
    inputs. int32 outputs: exact (integer sums in any order). mix_i8: its
    int32 sums are exact too, so only a p8 rounded one apart (an exp2 ulp
    at a rounding boundary) moves an element, by at most max|b| <= 127
    (MIX_FLIP: one such p8 a row). k64_i8q: both sides take the same codes
    (the maxima equal, the division IEEE) and exact sums, and round once:
    1 bf16 ulp of max|out|. The others sum in other orders (and fold
    k64big_i8cvt's blocks with each step rounded) and round once to bf16:
    2 bf16 ulps of max|out|, and for the bf16 and e4m3 products a relative
    L2 of at most REL_L2."""
    if kind.startswith("mix"):
        out, ref = out[..., :MIX_COLS], ref[..., :MIX_COLS]
    if out.dtype == torch.int32:
        err = (out.long() - ref.long()).abs().max().item()
        return float(err), 0.0, err == 0
    o, r = out.float(), ref.float()
    diff = o - r
    err = diff.abs().max().item()
    top = r.abs().max().item()
    tol = (MIX_FLIP if kind == "mix_i8" else bf16_ulp(top)
           if kind == "k64_i8q" else 2 * bf16_ulp(top))
    ok = err <= tol
    if operand_dtype(kind) != torch.int8 and kind != "k64_i8q":
        ok = ok and (diff.norm() / r.norm()).item() <= REL_L2
    return err, tol, ok


int8_probe.launches = 0
int8_big_probe.launches = 0
