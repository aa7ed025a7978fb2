"""Folded int8, e4m3 and bf16 product rates on the card, port of
``scripts/int8_probe2.py``.

    python -m maest_tpu_torch.probes.int8_2 [--iters 30] [--programs 8]
        [--kinds k64big_bf16,k64big_i8,k64big_i8cvt,k64big_fp8,pvbig_bf16,
                 pvbig_i8] [--device cuda]

The single products of ``probes.int8`` are bound by their outputs' bytes
(an (N, N) int32 write), as the rig's docstring says they were on the TPU
(int8_probe2.py:3-7); these kinds fold many depth-64 products into one
small output, so the product's rate shows. Times each ``--kinds`` entry
of ``ops/int8_probe.py``'s ``int8_big_probe`` over ``--programs``
programs at the rig's N 1792 and R 56 (operands made as the rig makes
them, numpy ``default_rng(0)`` anew for each kind; e4m3 from N(0, 0.1^2)
cast):

  k64big_bf16   (N, 64) . (64, 56 256) bf16, fp32 sums of the 56 column
                blocks into (N, 256)                    the control
  k64big_i8     the same in int8, int32 sums           the int8 rate
  k64big_i8cvt  int8 products, each block's int32 sums converted to fp32
                and scaled by a row vector before they are added: the qk8
                pattern
  k64big_fp8    e4m3 operands, fp32 sums               no convert pass
  pvbig_bf16    4 heads of (N, N) . (N, 64) bf16       the p.v control
  pvbig_i8      the same in int8, int32 out

The timing, the lines and the library yardstick are ``probes.int8``'s
(``run``): CUDA-graph replays of the call with its copies, the kernel
alone apart, the share of the type's dense peak (989 bf16, 1979 int8 and
e4m3), the bound, and ``torch.matmul`` / ``torch._int_mm`` /
``torch._scaled_mm`` (a program a call in 8 bits) with the fold as one
product over K 56 x 64; none for k64big_i8cvt. ``--device cpu`` runs the
plain versions with the host's clock, for tests.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import int8_probe as I
from . import int8 as P2

N = 1792   # the rig's N (scripts/int8_probe2.py:39)
R = 56     # and its column blocks (:40)


def shapes(kind: str, n: int = N) -> tuple:
    """(a shape, b shape, out shape, flops) of one program of a P3 kind
    (int8_probe2.py:80-93)."""
    if kind.startswith("pvbig"):
        return (4, n, n), (4, n, 64), (4, n, 64), 4 * 2 * n * n * 64
    return (n, 64), (64, R * 256), (n, 256), 2 * n * 64 * R * 256


def out_cols(kind: str, n: int) -> int:
    """Every kind writes its whole output."""
    return n


def bound(kind: str, programs: int) -> tuple[float, str]:
    """(ms, what binds) of ``programs`` programs (``probes.int8.bound``)."""
    return P2.bound(kind, programs, shapes, out_cols)


def main(argv=None) -> dict:
    """Run the rig; return its results (``probes.int8.run``)."""
    ap = argparse.ArgumentParser(
        prog="python -m maest_tpu_torch.probes.int8_2",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--programs", type=int, default=8)
    ap.add_argument("--kinds", default=",".join(I.P3_KINDS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    args = ap.parse_args(argv)
    kinds = args.kinds.split(",")
    for kind in kinds:  # refuse before any work
        if kind not in I.P3_KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of "
                             f"{', '.join(I.P3_KINDS)}")
    return P2.run(I.int8_big_probe, kinds, args.programs, args.iters,
               torch.device(args.device), shapes, out_cols)


if __name__ == "__main__":
    main()
