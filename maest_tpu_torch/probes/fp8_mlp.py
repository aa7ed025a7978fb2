"""bf16 and e4m3 product rates at the MLP and qkv shapes on the card, port
of ``scripts/fp8_mlp_probe.py``.

    python -m maest_tpu_torch.probes.fp8_mlp [--iters 30]
        [--programs 32] [--device cuda]

Times ``ops/mma_probe.py``'s ``mlp_probe`` (the hand-written ``wgmma``
product kernel fed by TMA: a (programs, N, K) . b (K, M), one b shared by
every program, fp32 sums, bf16 out) beside ``mlp_probe_mma`` (its mma.sync
control) at the ViT-B shapes of the rig, N 1792:

  fc1   (N, 768) . (768, 3072)
  fc2   (N, 3072) . (3072, 768)
  qkv   (N, 768) . (768, 2304)

each in bf16 and in e4m3 (float8_e4m3fn; a drawn N(0, 0.1^2), b N(0,
0.05^2), as the rig's, then cast). Both kernels read e4m3 b column-major:
the rig makes b that way once, as weights are prepared once, and hands the
view ``b_t.t()`` to the kernels and to the library call alike, so no copy
is in the timed call. The kernels (and at fc1 the library call) are CUDA
graphs of ``--iters`` calls (``probes.attn_profile``'s ``graph_rounds``),
replayed in ``ROUNDS`` interleaved rounds; each time is the median of the
rounds. One line per shape, type and call: ms, TFLOP/s, the share of
the H100's 989 TFLOP/s (dense bf16, data sheet; e4m3's own peak is 1979),
and the bound, the larger of the flops over the type's peak and the bytes
(a and b read once, the bf16 output written once) over 3.35 TB/s.

The rig's ``xla_fc1`` lines, plain ``jnp.einsum`` under jit, become the
library's own product at fc1, a yardstick that the port never calls:
``torch.matmul`` in bf16, and ``torch._scaled_mm`` with unit scales in
e4m3 on a (programs N, K) row-major a and the column-major b (its layout
rule; every size here is a multiple of 16). It prints the card's name and
power limit first and writes no file. ``--device cpu`` runs the plain
versions with the host's clock, for tests, and prints no device rate, no
control and no library line.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.mma_probe import mlp_probe, mlp_probe_mma
from .attn_profile import PEAK_BF16, card_line, graph_rounds, time_ms

N = 1792  # the rig's tokens a program (scripts/fp8_mlp_probe.py:37)
SHAPES = {"fc1": ((N, 768), (768, 3072)),
          "fc2": ((N, 3072), (3072, 768)),
          "qkv": ((N, 768), (768, 2304))}
DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
PEAK = {"bf16": PEAK_BF16, "fp8": 1979e12}  # dense, H100 SXM data sheet
HBM = 3.35e12  # H100 SXM data sheet, bytes/s
ROUNDS = 2     # interleaved rounds of the graphs (a, b, b, a)


def bound(shape: str, dtype: str, programs: int) -> tuple[float, str]:
    """(ms, what binds) of ``programs`` programs at the data-sheet rates."""
    (n, k), (_, m) = SHAPES[shape]
    elem = 1 if dtype == "fp8" else 2
    nbytes = programs * n * k * elem + k * m * elem + programs * n * m * 2
    t_ops = 2 * programs * n * k * m / PEAK[dtype]
    t_bytes = nbytes / HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                         else "bytes")


def operands(shape: str, dtype: str, programs: int, device):
    """a (programs, N, K) and b (K, M) of ``dtype`` from seed 0; e4m3 b
    column-major."""
    gen = torch.Generator(device=device).manual_seed(0)
    sa, sb = SHAPES[shape]
    a = torch.randn((programs,) + sa, generator=gen, device=device) * 0.1
    b = torch.randn(sb, generator=gen, device=device) * 0.05
    if dtype == "fp8":
        return a.to(DTYPES[dtype]), b.t().contiguous().to(DTYPES[dtype]).t()
    return a.to(DTYPES[dtype]), b.to(DTYPES[dtype])


def library_fn(a, b):
    """The library's product of a (programs, N, K) and b (K, M): a yardstick
    the port never calls."""
    if a.dtype == torch.float8_e4m3fn:
        one = torch.ones((), device=a.device)
        a2 = a.reshape(-1, a.shape[-1])
        return lambda: torch._scaled_mm(a2, b, scale_a=one, scale_b=one,
                                        out_dtype=torch.bfloat16)
    return lambda: torch.matmul(a, b)


def main(argv=None) -> dict:
    """Run the rig; return {"fc1_bf16": {"ms", "tflops", "bound_ms",
    "bound_by", "control_ms", "rounds"}, ..., "library_fc1_bf16": ...,
    "library_fc1_fp8": ...}, "rounds" each call's ms a round (no rate, no
    control and no library on the CPU)."""
    ap = argparse.ArgumentParser(
        prog="python -m maest_tpu_torch.probes.fp8_mlp",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--programs", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the rig times the kernel on "
                               "the card (--device cpu runs plain versions)")
        print(card_line(device), flush=True)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    cuda = device.type == "cuda"
    results = {}
    for shape in SHAPES:
        for dtype in DTYPES:
            a, b = operands(shape, dtype, args.programs, device)
            bms, binds = bound(shape, dtype, args.programs)
            name = f"{shape}_{dtype}"
            if not cuda:
                ms = time_ms(lambda: mlp_probe(a, b), args.iters, device)
                print(f"{name:17s} {ms:8.4f} ms (host clock, plain "
                      f"version); bound on the card {bms:.4f} ms ({binds})",
                      flush=True)
                results[name] = {"ms": ms, "bound_ms": bms,
                                 "bound_by": binds}
                continue
            fns = {"wgmma": lambda: mlp_probe(a, b),
                   "control": lambda: mlp_probe_mma(a, b)}
            if shape == "fc1":
                fns["library"] = library_fn(a, b)
            runs = graph_rounds(fns, args.iters, device, ROUNDS)
            ms = {w: float(np.median(r)) for w, r in runs.items()}
            (n, k), (_, m) = SHAPES[shape]
            calls = {"wgmma": "mlp_probe", "control": "mlp_probe_mma",
                     "library": "torch.matmul" if dtype == "bf16"
                     else "torch._scaled_mm"}
            for what, t in ms.items():
                tf = 2 * args.programs * n * k * m / t / 1e9
                print(f"{name if what != 'library' else 'library_' + name:17s}"
                      f" {calls[what]:16s} {t:8.4f} ms {tf:6.1f} TFLOP/s "
                      f"({tf * 1e12 / PEAK_BF16 * 100:5.1f}% of bf16 peak); "
                      f"bound {bms:.4f} ms ({binds}), x{t / bms:.2f}",
                      flush=True)
            tf = 2 * args.programs * n * k * m / ms["wgmma"] / 1e9
            results[name] = {"ms": ms["wgmma"], "tflops": tf, "bound_ms": bms,
                             "bound_by": binds, "control_ms": ms["control"],
                             "rounds": runs}
            if "library" in ms:
                results["library_" + name] = {
                    "ms": ms["library"], "bound_ms": bms, "bound_by": binds,
                    "tflops": 2 * args.programs * n * k * m / ms["library"]
                    / 1e9}
            del a, b
    return results


if __name__ == "__main__":
    main()
