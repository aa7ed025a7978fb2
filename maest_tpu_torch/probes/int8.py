"""int8 against bf16 product rates at the attention's depth-64 shapes on the
card, port of ``scripts/int8_probe.py``.

    python -m maest_tpu_torch.probes.int8 [--iters 30] [--programs 48]
        [--kinds k64_bf16,k64_i8,k64_i8q,pv_bf16,pv_i8,mix_bf16,mix_i8]
        [--device cuda]

Times each ``--kinds`` entry of ``ops/int8_probe.py`` (``int8_probe``:
hand-written mma.sync kernels) over ``--programs`` programs at the rig's N
1792, on operands made as the rig makes them (numpy ``default_rng(0)``
anew for each kind: int8 from ``integers(-127, 127)``, bf16 from N(0,
0.1^2)):

  k64_bf16  (N, 64) . (64, N)  bf16, bf16 out          the scores product
  k64_i8    the same in int8, int32 out
  k64_i8q   bf16 in, quantised per program inside the call (amax pass,
            int8 codes, int32 sums rescaled), bf16 out
  pv_bf16   (N, N) . (N, 64)  bf16                     the p.v product
  pv_i8     the same in int8, int32 out
  mix_bf16  scores, p = exp2(s 1e-4 - 1), p.v in one program (K2's loop)
  mix_i8    the same with int8 products, p8 = round(p 127) saturated (K5's)

Each time is the median of three replays of a CUDA graph of ``--iters``
calls (``probes.attn_profile``'s ``graph_ms``), which stands in for the
rig's chain of calls inside one jitted loop. The call includes the copies
the kernel reads (b column-major for the 8-bit products, b in seq_pos
order for mix_i8's p.v: ``int8_pass``); the kernel alone is timed apart
where there is such a copy. One line per kind: ms, T(FL)OP/s and the
share of the product type's dense peak on the H100 SXM data sheet (989
TFLOP/s bf16, 1979 TOP/s int8; the rig prints a share of a TPU's 197),
then the bound, the larger of the kind's operations over that peak and its
bytes (each operand read once, the output written once) over 3.35 TB/s,
and the time over it. The mix kinds write columns 0-63 of their (N, N)
output, and the bound counts those bytes; the TPU rig wrote its whole
output block back. Beside each line, the library's time as a yardstick
the port never calls: ``torch.matmul`` for the bf16 products,
``torch._int_mm`` for the int8 ones (2-D only: one call a program, in one
graph), none for k64_i8q and the mix kinds (no PyTorch call computes
them). mix_i8 also prints the share of p8 that saturated (program 0). It
prints the card's name and power limit first and writes no file.
``--device cpu`` runs the plain versions with the host's clock, for tests,
and prints no device rate and no library time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import int8_probe as I
from .attn_profile import PEAK_BF16, PEAK_INT8, card_line, graph_ms, time_ms

N = 1792         # the rig's N (scripts/int8_probe.py:42)
HBM = 3.35e12    # H100 SXM data sheet, bytes/s
PEAK = {torch.bfloat16: PEAK_BF16, torch.int8: PEAK_INT8,
        torch.float8_e4m3fn: PEAK_INT8}  # e4m3's dense peak is int8's


def shapes(kind: str, n: int = N) -> tuple:
    """(a shape, b shape, out shape, flops) of one program of a P2 kind
    (int8_probe.py:84-93)."""
    if kind.startswith("pv"):
        return (n, n), (n, 64), (n, 64), 2 * n * n * 64
    flops = 2 * n * 64 * n * (2 if kind.startswith("mix") else 1)
    return (n, 64), (64, n), (n, n), flops


def out_cols(kind: str, n: int) -> int:
    """The output columns the port writes: 64 for the mix kinds."""
    return I.MIX_COLS if kind.startswith("mix") else n


def operands(kind: str, programs: int, device, shape_of=shapes):
    """a, b of ``kind`` for ``programs`` programs, made as the rig makes
    them: numpy default_rng(0), int8 from integers(-127, 127), else N(0,
    0.1^2) cast to the operand type."""
    rng = np.random.default_rng(0)
    sa, sb = shape_of(kind)[:2]
    dt = I.operand_dtype(kind)
    if dt == torch.int8:
        a, b = (torch.from_numpy(rng.integers(-127, 127, (programs,) + s)
                                 .astype(np.int8)) for s in (sa, sb))
    else:
        a, b = (torch.from_numpy((rng.standard_normal((programs,) + s) * 0.1)
                                 .astype(np.float32)).to(dt)
                for s in (sa, sb))
    return a.to(device), b.to(device)


def bound(kind: str, programs: int, shape_of=shapes,
          cols=out_cols) -> tuple[float, str]:
    """(ms, what binds) of ``programs`` programs at the data-sheet rates:
    the kind's operations at its type's peak, its operands read and its
    written output columns moved once."""
    sa, sb, so, flops = shape_of(kind)
    elem = torch.empty((), dtype=I.operand_dtype(kind)).element_size()
    out_elem = torch.empty((), dtype=I.out_dtype(kind)).element_size()
    lead = int(np.prod(so[:-1]))
    nbytes = programs * (elem * (int(np.prod(sa)) + int(np.prod(sb)))
                         + out_elem * lead * cols(kind, so[-1]))
    t_ops = programs * flops / PEAK[I.operand_dtype(kind)]
    t_bytes = nbytes / HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                         else "bytes")


def library_fn(kind: str, a, b):
    """One PyTorch product of ``kind`` as a yardstick the port never calls,
    or None: ``torch.matmul`` in bf16, ``torch._int_mm`` a program (and a
    head) in int8 on b column-major (cuBLASLt's int8 layout), unit-scaled
    ``torch._scaled_mm`` a program in e4m3. The fold kinds take one
    product over K 56 x 64: a repeated along K against b's 56 column
    blocks stacked along K."""
    if kind in ("k64_i8q", "k64big_i8cvt") or kind.startswith("mix"):
        return None
    if kind.startswith("k64big"):
        folds = I.FOLD
        width = b.shape[-1] // folds
        a = a.repeat(1, 1, folds)
        b = b.reshape(b.shape[0], b.shape[1], folds, width).transpose(
            1, 2).reshape(b.shape[0], folds * b.shape[1], width)
    dt = I.operand_dtype(kind)
    if dt == torch.bfloat16:
        return lambda: torch.matmul(a, b)
    a2 = a.reshape((-1,) + a.shape[-2:])
    bt = b.reshape((-1,) + b.shape[-2:]).transpose(-1, -2).contiguous()
    if dt == torch.int8:
        return lambda: [torch._int_mm(x, y.t()) for x, y in zip(a2, bt)]
    one = torch.ones((), device=a.device)
    return lambda: [torch._scaled_mm(x, y.t(), scale_a=one, scale_b=one,
                                     out_dtype=torch.bfloat16)
                    for x, y in zip(a2, bt)]


def _library_name(kind: str) -> str:
    dt = I.operand_dtype(kind)
    return {torch.bfloat16: "torch.matmul", torch.int8: "torch._int_mm",
            torch.float8_e4m3fn: "torch._scaled_mm"}[dt]


_NO_LIBRARY = ("no PyTorch call computes it (in-kernel quantisation, the "
               "convert-and-rescale fold, or the rig's exp2 between two "
               "products)")


def saturated_share(a, b) -> float:
    """The share of mix_i8's p8 = round(p 127) past 127 in program 0."""
    s = a[0].double() @ b[0].double()
    p = torch.exp2(s.float() * 1e-4 - 1.0)
    return (torch.round(p * 127.0) > 127).double().mean().item()


def run(wrapper, kinds, programs: int, iters: int, device, shape_of=shapes,
        cols=out_cols) -> dict:
    """Time ``wrapper`` (``int8_probe`` or ``int8_big_probe``) at each kind;
    {kind: {"ms", "tops", "bound_ms", "bound_by", "alone_ms", "library_ms",
    ...}} (no rate on the CPU)."""
    cuda = device.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the rig times the kernel on "
                               "the card (--device cpu runs plain versions)")
        print(card_line(device), flush=True)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    results = {}
    for kind in kinds:
        a, b = operands(kind, programs, device, shape_of)
        fn = lambda a=a, b=b, kind=kind: wrapper(a, b, kind)  # noqa: E731
        bms, binds = bound(kind, programs, shape_of, cols)
        flops = programs * shape_of(kind)[3]
        unit = "TFLOP/s" if I.operand_dtype(kind) == torch.bfloat16 else (
            "TOP/s")
        if not cuda:
            ms = time_ms(fn, iters, device)
            print(f"{kind:12s} {ms:8.4f} ms (host clock, plain version); "
                  f"bound on the card {bms:.4f} ms ({binds})", flush=True)
            results[kind] = {"ms": ms, "bound_ms": bms, "bound_by": binds}
            continue
        ms = graph_ms(fn, iters, device)
        made = I.int8_pass(a, b, kind)
        alone = graph_ms(lambda: I.launch_pass(*made, kind), iters, device)
        del made
        lib_fn = library_fn(kind, a, b)
        lib = None if lib_fn is None else graph_ms(lib_fn, iters, device)
        tops = flops / ms / 1e9
        peak = PEAK[I.operand_dtype(kind)]
        line = (f"{kind:12s} {ms:8.4f} ms {tops:7.1f} {unit} "
                f"({tops * 1e12 / peak * 100:5.1f}% of the type's peak); "
                f"kernel alone {alone:.4f} ms; bound {bms:.4f} ms ({binds}), "
                f"x{ms / bms:.2f}; library ")
        line += (_NO_LIBRARY if lib is None else
                 f"{_library_name(kind)} {lib:.4f} ms")
        res = {"ms": ms, "tops": tops, "bound_ms": bms, "bound_by": binds,
               "alone_ms": alone, "library_ms": lib}
        if kind == "mix_i8":
            res["saturated"] = saturated_share(a, b)
            line += (f"; p8 saturated at 127: "
                     f"{res['saturated'] * 100:.2f} % (program 0)")
        print(line, flush=True)
        results[kind] = res
        del a, b
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> dict:
    """Run the rig; return its results (see ``run``)."""
    ap = argparse.ArgumentParser(
        prog="python -m maest_tpu_torch.probes.int8",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--programs", type=int, default=48)
    ap.add_argument("--kinds", default=",".join(I.P2_KINDS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    args = ap.parse_args(argv)
    kinds = args.kinds.split(",")
    for kind in kinds:  # refuse before any work
        if kind not in I.P2_KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of "
                             f"{', '.join(I.P2_KINDS)}")
    return run(I.int8_probe, kinds, args.programs, args.iters,
               torch.device(args.device))


if __name__ == "__main__":
    main()
