"""Softmax-arithmetic probes on the card, port of
``scripts/attn_vpu_probe.py``.

    python -m maest_tpu_torch.probes.attn_vpu [--kinds ctrl,bf16sm,...]
        [--iters 50] [--rounds 3] [--seed 0] [--device cuda]
        [--batch 32] [--tokens 1676] [--heads 12]

Asks which part of the softmax the cheaper 8-bit products would expose:
times the attention forward at (batch, tokens, heads, 64) bf16, inputs
drawn N(0, 0.3^2) from ``--seed`` (the rig's), in each kind of
``ops/attention_vpu.py`` beside ``ctrl``, K2's mma.sync kernel, the
template the kinds change (``attention_fwd_mma``, the control of the wgmma
kernel that ``flash_attention`` now runs):

  bf16sm     bf16 products, the softmax in bf16 (packed bf16x2 pairs)
  fp8sm      e4m3 q.k, the same bf16 softmax, bf16 p.v
  fp8noexp   e4m3 q.k, exp2(x - 32): no running max, no correction
  fp8nomask  fp8sm without the key mask, over --tokens rounded up to 128
             keys (the rig's N_PAD: the zero keys past --tokens get mass)
  fp8lean    q pre-scaled, e4m3 q, k, v and p: K6's fp8pv8 loop

It prints the card's name and power limit; "numerics <kind> max|dout| vs
ctrl" (and the relative L2 distance) on the first call; then, for each of
``--rounds`` rounds, each kind's time from CUDA events over ``--iters``
calls and from a replayed CUDA graph of them (``attn_profile.time_ms`` and
``graph_ms``, one run each); then a summary for each kind: the medians
over the rounds, the idle share 1 - graph / events, for the fp8 kinds the
kernel alone on inputs cast once (``launch_vpu``, events and graph) and
the cast pass alone (``vpu_pass``, events), TFLOP/s (the two products over
the keys walked, 4 b h N keys 64 flop) and the share of the product bound
at the peaks of the kind's product types (989 TFLOP/s bf16, 1979 e4m3),
and the exp2 floor (b h N keys exp2 at 16 a clock per SM).

The rig runs on the card; ``--device cpu`` runs the plain versions with the
host's clock, for tests, and prints no device rate.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.attention import attention_fwd_mma
from ..ops.attention_vpu import (
    KINDS,
    attention_vpu_probe,
    launch_vpu,
    vpu_pass,
)
from .attn_profile import (
    PEAK_BF16,
    _inputs,
    card_line,
    exp2_floor_ms,
    graph_ms,
    time_ms,
)

ALL = ("ctrl", *KINDS)
BATCH, TOKENS, HEADS = 32, 1676, 12  # the rig's (32, 1676, 12, 64)
PEAK_FP8 = 1979e12  # H100 SXM data sheet, dense e4m3 flop/s
# the types of the two products (q.k, p.v) of each kind
PRODUCTS = {"ctrl": ("bf16", "bf16"), "bf16sm": ("bf16", "bf16"),
            "fp8sm": ("fp8", "bf16"), "fp8noexp": ("fp8", "bf16"),
            "fp8nomask": ("fp8", "bf16"), "fp8lean": ("fp8", "fp8")}
_PEAK = {"bf16": PEAK_BF16, "fp8": PEAK_FP8}


def kind_fn(kind: str, q, k, v):
    """The call that computes ``kind`` on (B, N, H, 64) bf16 q, k, v."""
    if kind == "ctrl":
        return lambda: attention_fwd_mma(q, k, v)[0]
    if kind in KINDS:
        return lambda: attention_vpu_probe(q, k, v, kind)
    raise ValueError(f"unknown kind {kind!r}; expected one of "
                     f"{', '.join(ALL)}")


def product_bound_ms(kind: str, flop_each: float) -> float:
    """The two products' least time at the peaks of their types."""
    return sum(flop_each / _PEAK[t] for t in PRODUCTS[kind]) * 1e3


def run(kinds, batch: int, n: int, heads: int, iters: int, rounds: int,
        seed: int, device: torch.device) -> dict:
    """{kind: {"max_dout", "rel_l2", "ms", "graph_ms", "idle", "rounds"}},
    the fp8 kinds also "kernel_ms", "kernel_graph_ms" and "pass_ms" (graph
    and kernel fields ``None`` on the CPU), printing as the module says."""
    on_card = device.type == "cuda"
    n_pad = -(-n // 128) * 128  # the rig's N_PAD, the keys fp8nomask walks
    q, k, v = _inputs(batch, n, heads, 0.3, seed, device)
    fns = {kind: kind_fn(kind, q, k, v) for kind in kinds}
    out = {kind: {} for kind in kinds}
    with torch.inference_mode():
        ref = fns["ctrl"]().float() if "ctrl" in fns else None
        for kind, fn in fns.items():
            if kind == "ctrl" or ref is None:
                continue
            d = fn().float() - ref
            out[kind]["max_dout"] = d.abs().max().item()
            out[kind]["rel_l2"] = (d.norm() / ref.norm()).item()
            print(f"numerics {kind:9s} max|dout| vs ctrl = "
                  f"{out[kind]['max_dout']:.2e} (relative L2 "
                  f"{out[kind]['rel_l2']:.2e})", flush=True)
        for r in range(rounds):
            for kind, fn in fns.items():
                e = time_ms(fn, iters, device, reps=1)
                g = graph_ms(fn, iters, device, reps=1) if on_card else None
                out[kind].setdefault("rounds", []).append((e, g))
                line = f"round {r} {kind:9s} {e:8.4f} ms/call"
                print(line + (f" (events), {g:8.4f} (graph)" if on_card else
                              " (host clock on the cpu)"), flush=True)
        for kind, fn in fns.items():
            row = out[kind]
            row["ms"] = float(np.median([e for e, _ in row["rounds"]]))
            keys = n_pad if kind == "fp8nomask" else n
            flop_each = 2 * batch * heads * n * keys * 64
            line = f"{kind:9s} {row['ms']:8.4f} ms"
            if not on_card:
                row["graph_ms"] = row["idle"] = None
                print(line + " (host clock on the cpu: no device rate)",
                      flush=True)
                continue
            row["graph_ms"] = float(np.median([g for _, g in row["rounds"]]))
            row["idle"] = 1.0 - row["graph_ms"] / row["ms"]
            line += (f" (events), {row['graph_ms']:.4f} (graph), idle "
                     f"{row['idle'] * 100:.1f} %")
            t = row["graph_ms"]
            if kind.startswith("fp8"):
                made = vpu_pass(q, k, v, kind)
                alone = lambda: launch_vpu(made, kind)  # noqa: E731
                row["kernel_ms"] = time_ms(alone, iters, device)
                row["kernel_graph_ms"] = t = graph_ms(alone, iters, device)
                row["pass_ms"] = time_ms(lambda: vpu_pass(q, k, v, kind),
                                         iters, device)
                line += (f"; kernel alone {row['kernel_ms']:.4f} (events), "
                         f"{t:.4f} (graph), cast pass {row['pass_ms']:.4f}")
                del made
            bound = product_bound_ms(kind, flop_each)
            tf = 2 * flop_each / (t / 1e3) / 1e12
            types = "/".join(PRODUCTS[kind])
            floor = exp2_floor_ms(batch * heads * n * keys, device)
            line += (f"; {'kernel ' if kind.startswith('fp8') else ''}"
                     f"{tf:.1f} TFLOP/s, product bound ({types}) "
                     f"{bound:.4f} ms = {bound / t * 100:.1f} %; exp2 floor "
                     f"{floor:.4f} ms")
            print(line, flush=True)
    return out


def main(argv=None) -> dict:
    """Run the rig; return ``run``'s {kind: numerics and times}."""
    ap = argparse.ArgumentParser(
        prog="python -m maest_tpu_torch.probes.attn_vpu",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinds", default=",".join(ALL))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--tokens", type=int, default=TOKENS)
    ap.add_argument("--heads", type=int, default=HEADS)
    args = ap.parse_args(argv)

    kinds = args.kinds.split(",")
    for kind in kinds:  # refuse before any work
        kind_fn(kind, None, None, None)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the rig times the kernels on "
                               "the card (--device cpu runs plain versions)")
        print(card_line(device), flush=True)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return run(kinds, args.batch, args.tokens, args.heads, args.iters,
               args.rounds, args.seed, device)


if __name__ == "__main__":
    main()
