"""The tensor-core rate rigs' products, port of ``scripts/mxu_probe.py``'s
``_probe_kernel`` (P1) and ``scripts/fp8_mlp_probe.py``'s ``_mm_kernel``
(P8).

``mxu_probe(a, b, kind)`` computes one P1 kind on bf16 operands batched
over programs, with fp32 sums and a bf16 output (shapes a program, rig
defaults, N 1792):

- ``k64`` (N, 64) . (64, N) folded over its 7 column blocks of 256 into
  (N, 256); ``ctrl`` (N, 256) . (256, 7 256) and ``ctrlbig`` (N, 256) .
  (256, 56 256) the same way; ``k64big`` (N, 64) . (64, 56 256): out =
  sum over j of a . b[:, 256 j : 256 (j + 1)].
- ``k64w`` (N, 64) . (64, N) and ``pvwide`` (N, N) . (N, 64): one product.
- ``pv`` (N, N) . (N, 64) as 256-deep slices of the contraction, summed.
- ``pvbig`` (4, N, N) . (4, N, 64): one full product a head.

``mlp_probe(a, b)`` computes P8: a (programs, N, K) . b (K, M), bf16 or
float8_e4m3fn operands (b shared by every program), fp32 sums, bf16 out.

Two hand-written kernels of ``csrc/mma_probe.cu`` compute them on CUDA
tensors:

- the route: ``wgmma`` fed by TMA (``csrc/mma_probe_wgmma.cuh``, entry
  ``maest_mma_probe_wgmma``), 128 output rows by 256 columns a block in
  bf16 (64 for the p.v kinds, whose output is 64 wide) and by 128 in
  e4m3. ``mxu_probe``, ``mlp_probe`` and ``launch_mxu`` (the bf16 kinds
  of the int8 rigs) launch it;
- the control: the ``mma.sync`` kernel (entry ``maest_mma_probe``, 128 by
  128 or 64), reached only through ``mxu_probe_mma`` and
  ``mlp_probe_mma``, so that a measurement can time both in one run.

Each wrapper counts its launches in its ``launches``; ``mlp_probe`` and
``mlp_probe_mma`` also count them by operand type, in ``launches_bf16``
and ``launches_e4m3``.

8-bit ``wgmma`` has no transpose bit and the control's ``ldmatrix`` cannot
transpose 8-bit values, so both read e4m3 B column-major: ``mlp_probe``
copies a row-major e4m3 b once into that layout, and a column-major b,
``b_t.t()``, goes in as it lies (the rig hands it so: no copy in its timed
call). A shape a kernel has no instance of raises; a CUDA tensor never
falls back to the other kernel or to the plain version. On CPU tensors
the wrappers run the plain versions, ``mxu_probe_reference`` and
``mlp_probe_reference``: the rig's function in fp32 on the exact operand
values (e4m3 upcast first), each kind's sums in the rig's order, rounded
to bf16 once.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KINDS = ("k64", "k64w", "pv", "pvwide", "ctrl", "ctrlbig", "k64big", "pvbig")
FOLD_KINDS = ("k64", "ctrl", "ctrlbig", "k64big")  # out = sum_j a . b_j
BLOCK = 256          # the rig's column block (fold kinds) and pv's slice
FOLDS = (1, 7, 56)   # the folds the kernel has instances of
TILE_M = 128         # output rows a block
DTYPES = (torch.bfloat16, torch.float8_e4m3fn)


def _check_pair(a, b, dtypes=(torch.bfloat16,)):
    if a.dtype not in dtypes or b.dtype != a.dtype:
        raise TypeError(f"the product rigs take {' or '.join(map(str, dtypes))}"
                        f" operands of one dtype, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")


def _check_kind(a, b, kind):
    """Validate a P1 pair; return the fold (1 for the one-product kinds)."""
    if kind not in KINDS:
        raise ValueError(f"unknown product kind {kind!r}; expected one of "
                         f"{', '.join(KINDS)}")
    _check_pair(a, b)
    lead = 2 if kind == "pvbig" else 1  # programs (and pvbig's heads)
    if (a.ndim != lead + 2 or b.ndim != lead + 2 or a.shape[:lead] !=
            b.shape[:lead] or a.shape[-1] != b.shape[-2]):
        raise ValueError(f"{kind} takes a (programs{', heads' * (lead - 1)}, "
                         f"M, K) and b (..., K, cols) of one batch, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if kind not in FOLD_KINDS:
        return 1
    if b.shape[-1] % BLOCK:
        raise ValueError(f"{kind} folds b's columns in blocks of {BLOCK}, "
                         f"got {b.shape[-1]}")
    return b.shape[-1] // BLOCK


def mxu_probe_reference(a: torch.Tensor, b: torch.Tensor,
                        kind: str) -> torch.Tensor:
    """Plain PyTorch P1: fp32 products of the bf16 values, summed as the
    rig sums them (fold kinds: acc + a . b_j for j in order; pv: acc + the
    product of each 256-deep slice in order), rounded to bf16."""
    fold = _check_kind(a, b, kind)
    af, bf = a.float(), b.float()
    if kind in FOLD_KINDS:
        acc = torch.zeros(a.shape[:-1] + (BLOCK,), device=a.device)
        for j in range(fold):
            acc = acc + af @ bf[..., j * BLOCK:(j + 1) * BLOCK]
    elif kind == "pv":
        acc = torch.zeros(a.shape[:-1] + (b.shape[-1],), device=a.device)
        for j in range(0, a.shape[-1], BLOCK):
            acc = acc + af[..., j:j + BLOCK] @ bf[..., j:j + BLOCK, :]
    else:
        acc = af @ bf
    return acc.to(torch.bfloat16)


def mlp_probe_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch P8: a (programs, N, K) . b (K, M) in fp32 on the exact
    operand values, rounded to bf16."""
    _check_mlp(a, b)
    return (a.float() @ b.float()).to(torch.bfloat16)


def _check_mlp(a, b):
    _check_pair(a, b, DTYPES)
    if a.ndim != 3 or b.ndim != 2 or a.shape[-1] != b.shape[0]:
        raise ValueError("mlp_probe takes a (programs, N, K) and a shared b "
                         f"(K, M), got {tuple(a.shape)}, {tuple(b.shape)}")


# the kernel's operand types and epilogues (``maest_mma_probe``'s type)
BF16, E4M3, S8_I32, S8_CVT = range(4)
# the wgmma route's output columns a block: bf16 (256, or 64 for an output
# 64 wide), e4m3 128 (two fp32 sets a thread: a stage's and the totals)
WG_BN = {BF16: 256, E4M3: 128}
RESIDENT_BYTES = 512  # K a row (bytes) that a fold keeps in shared memory
ENTRIES = {"wgmma": "maest_mma_probe_wgmma", "control": "maest_mma_probe"}


def route(kind_type: int) -> str:
    """The kernel that takes products of ``kind_type``: "wgmma" for bf16
    and e4m3, "control" for int8."""
    return "wgmma" if kind_type in WG_BN else "control"


def tile(m: int, k: int, ncols: int, fold: int, kind_type: int = BF16,
         which: str = "wgmma") -> int:
    """The output columns a block of ``which`` kernel takes for this
    shape; raise for a shape it has no instance of."""
    if which == "wgmma":
        bn = 64 if kind_type == BF16 and ncols == 64 else WG_BN[kind_type]
        elem = 2 if kind_type == BF16 else 1
        ok = (not (m % TILE_M or ncols % bn or k % 64) and k > 0
              and fold in FOLDS and (fold == 1 or bn != 64
                                     and k * elem <= RESIDENT_BYTES))
        if not ok:
            raise ValueError(
                f"the wgmma product kernel takes M a multiple of {TILE_M}, "
                f"output columns of {bn}, K of 64 (at most "
                f"{RESIDENT_BYTES // elem} over a fold of 7 or 56 column "
                f"blocks, which a 64-wide output does not take) and a fold "
                f"of {', '.join(map(str, FOLDS))}; got M {m}, columns "
                f"{ncols}, K {k}, fold {fold}")
        return bn
    bn = 64 if ncols == 64 else 128
    if m % TILE_M or ncols % bn or k % 64 or fold not in FOLDS:
        raise ValueError(
            f"the product kernel takes M a multiple of {TILE_M}, output "
            f"columns of {bn}, K of 64 and a fold of "
            f"{', '.join(map(str, FOLDS))}; got M {m}, columns {ncols}, K "
            f"{k}, fold {fold}")
    return bn


def _launch(a, b, out, fold, b_batch, kind_type=BF16, which=None):
    """One product of type ``kind_type``: a (batch, m, k), b as the kernel
    reads it and out (batch, m, ncols), on ``which`` kernel (``route``'s
    by default), its tile checked first."""
    batch, m, k = a.shape
    which = which or route(kind_type)
    bn = tile(m, k, out.shape[-1], fold, kind_type, which)
    _run_entry(ENTRIES[which], kind_type, bn, fold, a, b, out, b_batch)
    return out


def _run_entry(entry, kind_type, bn, fold, a, b, out, b_batch):
    """Load the library and launch ``entry`` on CUDA a, b (made contiguous)
    and a contiguous out, on the current stream; raise on another device
    or a failed launch."""
    for t in (a, b, out):
        if t.device.type != "cuda":
            raise ValueError(f"unsupported device {t.device} for {entry}")
    a, b = a.contiguous(), b.contiguous()
    batch, m, k = a.shape
    lib = _build.load_library("mma_probe")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(kind_type, bn, fold, a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), batch, m, k, out.shape[-1], b_batch, stream)
    _build.check(lib, err, f"{entry} type={kind_type} bn={bn} fold={fold}")


def mxu_probe(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """P1 ``kind`` on bf16 a and b (see the module docstring); the bf16
    output. CUDA tensors: the wgmma kernel; CPU tensors:
    ``mxu_probe_reference``."""
    fold = _check_kind(a, b, kind)
    if a.device.type == "cpu":
        return mxu_probe_reference(a, b, kind)
    out = launch_mxu(a, b, kind, fold)
    mxu_probe.launches += 1
    return out


def mxu_probe_mma(a: torch.Tensor, b: torch.Tensor,
                  kind: str) -> torch.Tensor:
    """The control of ``mxu_probe``: the mma.sync kernel on CUDA tensors,
    counted in ``mxu_probe_mma.launches``; CPU tensors run
    ``mxu_probe_reference``."""
    fold = _check_kind(a, b, kind)
    if a.device.type == "cpu":
        return mxu_probe_reference(a, b, kind)
    out = launch_mxu(a, b, kind, fold, "control")
    mxu_probe_mma.launches += 1
    return out


def launch_mxu(a, b, kind, fold, which=None):
    """The kernel of P1 ``kind`` on checked CUDA a and b (``route``'s, or
    ``which``), uncounted (the int8 rigs' bf16 kinds are these products,
    counted by their own wrappers)."""
    ncols = BLOCK if kind in FOLD_KINDS else b.shape[-1]
    a3 = a.reshape((-1,) + a.shape[-2:])
    b3 = b.reshape((-1,) + b.shape[-2:])
    out = torch.empty(a.shape[:-1] + (ncols,), dtype=torch.bfloat16,
                      device=a.device)
    _launch(a3, b3, out.view(a3.shape[0], a.shape[-2], ncols), fold,
            b3[0].numel(), BF16, which)
    return out


def mlp_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P8 on a (programs, N, K) and b (K, M), bf16 or e4m3; the bf16
    (programs, N, M). CUDA tensors: the wgmma kernel; CPU tensors:
    ``mlp_probe_reference``."""
    _check_mlp(a, b)
    if a.device.type == "cpu":
        return mlp_probe_reference(a, b)
    return _launch_mlp(a, b, "wgmma", mlp_probe)


def mlp_probe_mma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control of ``mlp_probe``: the mma.sync kernel on CUDA tensors;
    CPU tensors run ``mlp_probe_reference``."""
    _check_mlp(a, b)
    if a.device.type == "cpu":
        return mlp_probe_reference(a, b)
    return _launch_mlp(a, b, "control", mlp_probe_mma)


def _launch_mlp(a, b, which, wrapper):
    """P8 on ``which`` kernel, counted in ``wrapper``'s launches: all, and
    those of the operand type."""
    fp8 = a.dtype == torch.float8_e4m3fn
    out = torch.empty(a.shape[:2] + (b.shape[1],), dtype=torch.bfloat16,
                      device=a.device)
    # e4m3: B^T rows (neither kernel transposes 8-bit values)
    _launch(a, b.t() if fp8 else b, out, 1, 0, E4M3 if fp8 else BF16, which)
    wrapper.launches += 1
    if fp8:
        wrapper.launches_e4m3 += 1
    else:
        wrapper.launches_bf16 += 1
    return out


def reset_launches():
    """Set every launch count of the product wrappers to 0."""
    for f in (mxu_probe, mxu_probe_mma, mlp_probe, mlp_probe_mma):
        f.launches = 0
    for f in (mlp_probe, mlp_probe_mma):
        f.launches_bf16 = f.launches_e4m3 = 0


reset_launches()
