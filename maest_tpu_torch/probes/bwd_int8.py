"""The attention backward's 8-bit speed ceiling on the card, port of
``scripts/bwd_int8_probe.py`` (P4).

    python -m maest_tpu_torch.probes.bwd_int8 [--iters 30] [--rounds 3]
        [--kinds ctrl,int8,fp8] [--device cuda]

The TPU rig asks whether the backward, "the one kernel where 8-bit could
still win", beats the bf16 backward by more than 20 % in 8-bit; if not, the
production version is not built (bwd_int8_probe.py:1-13). Its kinds, at
the 30 s training shape (B 32, H 12, D 64, N 866 padded to 896), each
``ops/bwd_probe.py``'s ``bwd_probe`` on operands made as the rig's
``build`` makes them (numpy ``default_rng(0)`` anew for each kind: q, kt,
v, do, o, lse in that order, int8 from ``integers(-127, 127)``, e4m3 and
bf16 from N(0, 0.3^2), lse from N(8, 1); ctrl's five (B, N, H, D) bf16
tensors q, k, v, do, o drawn after those):

  ctrl  the production backward (K3b) at (32, 866, 12, 64)
  int8  all five products in int8 with fixed scales and no scale pass (K7's
        dk/dv and dq kernels); its output is not a gradient
  fp8   s and dp in e4m3, dv, dq, dk in bf16 (K3b's kernels)

Each kind's call (its layout pass included) and its kernels alone are
captured once as CUDA graphs of ``--iters`` calls, then replayed in
``--rounds`` interleaved rounds, one line a kind and round, as the rig
times its jitted loops. Then a summary a kind: the median ms of the call
and of the kernels alone, T(FL)OP/s of the five products, the share of
the dense peak of the kind's product types (H100 SXM data sheet: 989
TFLOP/s bf16, 1979 int8 and e4m3), the bound (the larger of those
operations at that peak and the bytes, each input read once and each
output written once, at 3.35 TB/s), the exp2 floor of one score pass (the
(row, key) exp2 at 16 a clock an SM; ctrl's and both 8-bit designs form
the scores in two kernels, so twice that), the time over the bound, and
the time over ctrl's against the rig's gate (8-bit pays only at or below
0.8 times ctrl's time). Beside ctrl the library's yardstick, the port
never calls it: SDPA (flash backend) forward plus backward less forward,
by CUDA events; none for the 8-bit kinds (no PyTorch call computes an
8-bit attention backward). It prints the card's name and power limit
first and writes no file. ``--device cpu`` runs the plain versions with
the host's clock at bh 2 (B 1, H 2) for tests, and prints no rate.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import bwd_probe as P
from .attn_profile import (
    PEAK_BF16,
    PEAK_INT8,
    capture,
    card_line,
    exp2_floor_ms,
    replay_ms,
    time_ms,
)

N, N_PAD = 866, 896   # the 30 s train tokens and their pad (:44-45)
B, H, D = 32, 12, 64  # (:46)
HBM = 3.35e12         # H100 SXM data sheet, bytes/s
GATE = 0.8            # the rig's margin: 8-bit must beat ctrl by > 20 %
CPU_HEADS = 2         # --device cpu: B 1, H 2
_NO_LIBRARY = "none (no PyTorch call computes an 8-bit attention backward)"


def operands(kind: str, device, b: int = B, h: int = H) -> tuple:
    """The call's (q, kt, v, do, o, lse) of ``kind`` at (b, h), made as the
    rig's ``build`` makes them (for ctrl, kt is k, all (b, N, h, 64))."""
    rng = np.random.default_rng(0)
    bh = b * h

    def mk(shape, dtype):
        if dtype == torch.int8:
            return torch.from_numpy(rng.integers(-127, 127, shape).astype(
                np.int8)).to(device)
        return torch.from_numpy(rng.standard_normal(shape) * 0.3).to(
            device=device, dtype=dtype)

    dt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(kind,
                                                              torch.bfloat16)
    q = mk((bh, N_PAD, D), dt)
    kt = mk((bh, D, N_PAD), dt)
    v = mk((bh, N_PAD, D), dt)
    do = mk((bh, N_PAD, D), dt)
    o = mk((bh, N_PAD, D), torch.bfloat16)
    lse = torch.from_numpy((rng.standard_normal((bh, 1, N_PAD)) + 8.0)
                           .astype(np.float32)).to(device)
    if kind != "ctrl":
        return q, kt, v, do, o, lse
    qb, kb, vb, dob, ob = (mk((b, N, h, D), torch.bfloat16) for _ in range(5))
    return qb, kb, vb, dob, ob, lse


def shape_of(kind: str, b: int = B, h: int = H) -> tuple[int, int]:
    """(bh, the rows and keys its products run over): N_PAD, or ctrl's N."""
    return b * h, (N if kind == "ctrl" else N_PAD)


def ops_ms(kind: str, b: int = B, h: int = H) -> float:
    """The five products alone at their types' peaks (int8: all five int8;
    fp8: s and dp e4m3, three bf16; ctrl: five bf16), ms."""
    bh, n = shape_of(kind, b, h)
    f = P.flops(bh, n) / 5
    return {"ctrl": 5 * f / PEAK_BF16, "int8": 5 * f / PEAK_INT8,
            "fp8": 2 * f / PEAK_INT8 + 3 * f / PEAK_BF16}[kind] * 1e3


def bound(kind: str, b: int = B, h: int = H) -> tuple[float, str]:
    """(ms, what binds) at the data-sheet rates: ``ops_ms`` against
    ``bwd_probe.nbytes`` at the memory rate."""
    t_ops = ops_ms(kind, b, h)
    t_bytes = P.nbytes(kind, *shape_of(kind, b, h)) / HBM * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sdpa_bwd_ms(q, k, v, do, iters: int, device) -> float:
    """SDPA (flash backend) forward + backward less forward on (B, N, H, D)
    bf16, by CUDA events: the library's backward, which the port never
    calls."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    gs = do.transpose(1, 2)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs),
                      iters, device)
        both = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs).backward(gs), iters, device)
    return both - fwd


def run(kinds, iters: int, rounds: int, device) -> dict:
    """Time each kind; {kind: {"ms", "alone_ms", "rounds", "tflops",
    "share", "bound_ms", "bound_by", "exp2_ms", "over_bound", "over_ctrl",
    "library_ms"}} (on the CPU {"ms", "bound_ms", "bound_by"})."""
    if device.type == "cpu":
        out = {}
        for kind in kinds:
            ops = operands(kind, device, 1, CPU_HEADS)
            ms = time_ms(lambda ops=ops, kind=kind: P.bwd_probe(*ops, kind),
                         iters, device, reps=1)
            bms, binds = bound(kind)
            print(f"{kind:5s} {ms:9.3f} ms (host clock, plain version, bh "
                  f"{CPU_HEADS}); bound on the card at bh {B * H} "
                  f"{bms:.4f} ms ({binds})", flush=True)
            out[kind] = {"ms": ms, "bound_ms": bms, "bound_by": binds}
        return out
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the rig times the kernels on the "
                           "card (--device cpu runs the plain versions)")
    print(card_line(device), flush=True)
    graphs, keep = {}, []
    for kind in kinds:
        ops = operands(kind, device)
        made = P.bwd_pass(*ops, kind)
        graphs[kind] = (
            capture(lambda ops=ops, kind=kind: P.bwd_probe(*ops, kind),
                    iters, device),
            capture(lambda made=made, kind=kind: P.launch_pass(made, kind),
                    iters, device))
        keep += [ops, made]
        print(f"# captured {kind}", flush=True)
    if "int8" in kinds:
        print("# int8: fixed scales, as the rig's: its dq, dk, dv are not "
              "gradients (scripts/bwd_int8_probe.py:9-13)", flush=True)
    times = {kind: [] for kind in kinds}
    for r in range(rounds):
        for kind in kinds:
            times[kind].append(tuple(replay_ms(g, iters, device, 1)
                                     for g in graphs[kind]))
            print(f"round {r} {kind:5s} {times[kind][-1][0]:8.4f} ms/call "
                  f"(kernels alone {times[kind][-1][1]:.4f})", flush=True)
    ctrl = float(np.median([t[0] for t in times["ctrl"]])) if (
        "ctrl" in kinds) else None
    out = {}
    for kind in kinds:
        ms = float(np.median([t[0] for t in times[kind]]))
        alone = float(np.median([t[1] for t in times[kind]]))
        bh, n = shape_of(kind)
        bms, binds = bound(kind)
        exp2 = exp2_floor_ms(P.exp2_count(bh, n), device)
        res = {"ms": ms, "alone_ms": alone, "rounds": times[kind],
               "tflops": P.flops(bh, n) / ms / 1e9,
               "share": ops_ms(kind) / ms, "bound_ms": bms,
               "bound_by": binds, "exp2_ms": exp2, "over_bound": ms / bms,
               "over_ctrl": None if ctrl is None else ms / ctrl,
               "library_ms": None}
        unit = "TFLOP/s" if kind == "ctrl" else "T(FL)OP/s"
        line = (f"{kind:5s} {ms:8.4f} ms (kernels alone {alone:.4f}) "
                f"{res['tflops']:7.1f} {unit}, {res['share'] * 100:5.1f} % "
                f"of its product types' peak; bound {bms:.4f} ms ({binds}), "
                f"x{res['over_bound']:.2f}; exp2 floor {exp2:.4f} ms a score "
                f"pass, {2 * exp2:.4f} for two")
        if ctrl is not None:
            gate = ("clears" if ms <= GATE * ctrl else "misses")
            line += (f"; x{res['over_ctrl']:.3f} ctrl's time: {gate} the "
                     f"rig's 20 % gate (<= {GATE} x ctrl)")
        if kind == "ctrl":
            q, k, v, do = ops_ctrl = operands("ctrl", device)[:4]
            res["library_ms"] = sdpa_bwd_ms(q, k, v, do, iters, device)
            line += f"; library SDPA bwd {res['library_ms']:.4f} ms"
            del ops_ctrl, q, k, v, do
        else:
            line += f"; library {_NO_LIBRARY}"
        print(line, flush=True)
        out[kind] = res
    del graphs, keep
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    """Run the rig; return its results (see ``run``)."""
    ap = argparse.ArgumentParser(
        prog="python -m maest_tpu_torch.probes.bwd_int8",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kinds", default="ctrl,int8,fp8")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    args = ap.parse_args(argv)
    kinds = args.kinds.split(",")
    for kind in kinds:  # refuse before any work
        if kind not in P.KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of "
                             f"{', '.join(P.KINDS)}")
    return run(kinds, args.iters, args.rounds, torch.device(args.device))


if __name__ == "__main__":
    main()
