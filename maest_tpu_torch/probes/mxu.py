"""Tensor-core product rates at the attention kernel's product shapes on
the card, port of ``scripts/mxu_probe.py``.

    python -m maest_tpu_torch.probes.mxu [--iters 30] [--programs 48]
        [--kinds k64,k64w,pv,pvwide,ctrl] [--device cuda]

Times each ``--kinds`` entry of ``ops/mma_probe.py`` over ``--programs``
programs, on operands drawn N(0, 0.1^2) from a fixed seed, to separate the
rate the tensor cores reach at a product shape of K2 from the losses of
K2's pipeline (N 1792, the rig's): ``mxu_probe`` (the hand-written
``wgmma`` kernel fed by TMA, bf16 operands, fp32 sums, bf16 out) beside
``mxu_probe_mma`` (its mma.sync control):

  k64      (N, 64) . (64, 256) x7     the scores product (depth head_dim)
  k64w     (N, 64) . (64, N) x1       scores as one wide product
  pv       (N, 256) . (256, 64) x7    the p.v product (width head_dim)
  pvwide   (N, N) . (N, 64) x1        p.v as one full-depth product
  ctrl     (N, 256) . (256, 256) x7   full 256-wide tiles, the control
  ctrlbig  (N, 256) . (256, 256) x56  the control with 8x the work
  k64big   (N, 64) . (64, 256) x56    the scores shape, 8 heads' keys
  pvbig    4 x (N, N) . (N, 64)       full-depth p.v, 4 heads a program

Each kind's two kernels are CUDA graphs of ``--iters`` calls
(``probes.attn_profile``'s ``graph_rounds``), which stand in for the rig's
chain of calls inside one jitted loop, replayed in ``ROUNDS``
interleaved rounds (wgmma, control, control, wgmma); each time is the
median of the rounds. One line per kind: the wgmma kernel's ms, TFLOP/s
and share of the H100's 989 TFLOP/s (dense bf16, data sheet), the kind's
bound, the larger of its flops over 989 TFLOP/s and its bytes (each
operand read once, the output written once) over 3.35 TB/s, its time over
the bound, and the control's ms beside it; at k64big also the library's
product (``library_fn``: one ``torch.matmul`` over K 56 x 64, a yardstick
the port never calls), timed in the same rounds. It prints the card's
name and power limit first and writes no file. ``--device cpu`` runs the plain
versions with the host's clock, for tests, and prints no device rate.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.mma_probe import BLOCK, KINDS, mxu_probe, mxu_probe_mma
from .attn_profile import PEAK_BF16, card_line, graph_rounds, time_ms

N = 1792         # the rig's sequence length (scripts/mxu_probe.py:34)
HBM = 3.35e12    # H100 SXM data sheet, bytes/s
ROUNDS = 2       # interleaved rounds of the graphs (a, b, b, a)
DEFAULT_KINDS = "k64,k64w,pv,pvwide,ctrl"


def shapes(kind: str, n: int = N) -> tuple:
    """(a shape, b shape, out shape) of one program of ``kind``."""
    return {"k64": ((n, 64), (64, n), (n, 256)),
            "k64w": ((n, 64), (64, n), (n, n)),
            "pv": ((n, n), (n, 64), (n, 64)),
            "pvwide": ((n, n), (n, 64), (n, 64)),
            "ctrl": ((n, 256), (256, 7 * 256), (n, 256)),
            "ctrlbig": ((n, 256), (256, 56 * 256), (n, 256)),
            "k64big": ((n, 64), (64, 56 * 256), (n, 256)),
            "pvbig": ((4, n, n), (4, n, 64), (4, n, 64))}[kind]


def flops(kind: str) -> int:
    """Flops of one program: 2 M K (the product's columns), per head."""
    sa, sb, _ = shapes(kind)
    heads = sa[0] if len(sa) == 3 else 1
    return 2 * heads * sa[-2] * sa[-1] * sb[-1]


def bound(kind: str, programs: int) -> tuple[float, str]:
    """(ms, what binds) of ``programs`` programs at the data-sheet rates:
    bf16 operands and output, each moved once."""
    nbytes = 2 * programs * sum(
        int(torch.Size(s).numel()) for s in shapes(kind))
    t_ops = programs * flops(kind) / PEAK_BF16
    t_bytes = nbytes / HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                         else "bytes")


def operands(kind: str, programs: int, device):
    """a, b of ``kind`` for ``programs`` programs, N(0, 0.1^2) from seed 0,
    bf16."""
    gen = torch.Generator(device=device).manual_seed(0)
    sa, sb, _ = shapes(kind)
    a, b = (torch.randn((programs,) + s, generator=gen, device=device)
            .mul_(0.1).to(torch.bfloat16) for s in (sa, sb))
    return a, b


def library_fn(kind: str, a, b):
    """The library's product computing ``kind``'s function, a yardstick the
    port never calls: k64big as one ``torch.matmul`` of a repeated 56 times
    along K and b's column blocks stacked along K (the same flops, one
    product); None for the other kinds (not timed)."""
    if kind != "k64big":
        return None
    p, _, k = a.shape
    fold = b.shape[-1] // BLOCK
    a_rep = a.repeat(1, 1, fold)  # (programs, N, fold K): a once a block
    b_stack = b.reshape(p, k, fold, BLOCK).transpose(1, 2).reshape(
        p, fold * k, BLOCK)
    return lambda: torch.matmul(a_rep, b_stack)


def main(argv=None) -> dict:
    """Run the rig; return {kind: {"ms", "tflops", "bound_ms", "bound_by",
    "control_ms", "rounds"}, "library_k64big": {"ms", ...}}, "rounds" each
    call's ms a round (no rate, no control and no library on the CPU)."""
    ap = argparse.ArgumentParser(
        prog="python -m maest_tpu_torch.probes.mxu",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--programs", type=int, default=48)
    ap.add_argument("--kinds", default=DEFAULT_KINDS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    args = ap.parse_args(argv)

    kinds = args.kinds.split(",")
    for kind in kinds:  # refuse before any work
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of "
                             f"{', '.join(KINDS)}")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the rig times the kernel on "
                               "the card (--device cpu runs plain versions)")
        print(card_line(device), flush=True)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    results = {}
    for kind in kinds:
        a, b = operands(kind, args.programs, device)
        fn = lambda a=a, b=b, kind=kind: mxu_probe(a, b, kind)  # noqa: E731
        bms, binds = bound(kind, args.programs)
        if device.type == "cuda":
            fns = {"wgmma": fn, "control": (
                lambda a=a, b=b, kind=kind: mxu_probe_mma(a, b, kind))}
            lib = library_fn(kind, a, b)
            if lib is not None:
                fns["library"] = lib
            runs = graph_rounds(fns, args.iters, device, ROUNDS)
            ms, cms = (float(np.median(runs[w])) for w in ("wgmma",
                                                            "control"))
            tf = args.programs * flops(kind) / ms / 1e9
            print(f"{kind:7s} {ms:8.4f} ms {tf:6.1f} TFLOP/s "
                  f"({tf * 1e12 / PEAK_BF16 * 100:4.1f}% of bf16 peak); bound "
                  f"{bms:.4f} ms ({binds}), x{ms / bms:.2f}; control "
                  f"(mma.sync) {cms:.4f} ms, x{cms / ms:.2f} the wgmma "
                  f"kernel's", flush=True)
            results[kind] = {"ms": ms, "tflops": tf, "bound_ms": bms,
                             "bound_by": binds, "control_ms": cms,
                             "rounds": runs}
            if lib is not None:
                lms = float(np.median(runs["library"]))
                print(f"library_{kind} torch.matmul {lms:.4f} ms (one "
                      f"product over K {b.shape[-1] // BLOCK} x "
                      f"{a.shape[-1]}), x{lms / bms:.2f} the bound",
                      flush=True)
                results[f"library_{kind}"] = {
                    "ms": lms, "tflops": args.programs * flops(kind) / lms
                    / 1e9, "bound_ms": bms, "bound_by": binds}
            del fns, lib
        else:
            ms = time_ms(fn, args.iters, device)
            print(f"{kind:7s} {ms:8.4f} ms (host clock, plain version); "
                  f"bound on the card {bms:.4f} ms ({binds})", flush=True)
            results[kind] = {"ms": ms, "bound_ms": bms, "bound_by": binds}
        del a, b
    return results


if __name__ == "__main__":
    main()
