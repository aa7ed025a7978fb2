"""The attention tile sweep on the card, port of ``scripts/attn_tune.py``.

    python -m maest_tpu_torch.probes.attn_tune [--archs 30s,20s,10s,5s]
        [--batch 32] [--heads 12] [--iters 20] [--bwd] [--device cuda]

For each released arch's sequence length (``ARCH_N``, the rig's own
table), times K2's loop at each tile (``attention_probe_tile``: query rows
a block of 64, 128 or 256 and keys a tile of 32, 64 or 128) on (batch, N,
heads, 64) bf16 drawn N(0, 0.1^2), or with ``--bwd`` K3b's kernels at each
tile (``attention_bwd_tile``: rows a block and streamed rows a tile, each
32, 64 or 128) on the saved tensors of K3a. It prints one line per tile and
the best tile per arch. Each forward line gives the share of the q rows
that are real (N over N rounded up to the block's rows), the TFLOP/s of
the two products over the real keys against the bf16 peak, 989, and K2
(128, 64), the mma.sync kernel whose loop the tiles change
(``attention_fwd_mma``, the control of the wgmma kernel that
``flash_attention`` now runs), timed in the same call; each backward
line gives K3b (64, 64), the mma.sync kernels whose tiles the others are
(``attention_bwd_mma``, the control of the wgmma kernel that
``attention_bwd`` now runs), beside it and the TFLOP/s of its five
products. Times are CUDA-graph
replays (``probes.attn_profile``'s ``graph_ms``) at every N: K2, K3b and
the probe entries differ in host cost, which CUDA events would add to the
slower wrapper wherever the host cannot stay ahead of the card. The
control and the nine tiles are timed in ROUNDS
interleaved rounds, each once a round in turn, so a drift of the card or
the host lands on all of them; a line gives the median and the range over
the rounds, and the best tile is called resolved only where its slowest
round beats the control's fastest.

The TPU rig also swept n_pad, the keys padded past the minimal multiple of
128 when a larger pad gave better block divisors (``candidates``). The
port has no such axis: its loop stops at the last tile holding a real key,
any N works, and a tile need not divide anything.

The rig runs on the card; ``--device cpu`` runs the plain versions with the
host's clock, for tests, and prints no device rate.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.attention import attention_fwd_mma, flash_attention_fwd_lse
from ..ops.attention import attention_bwd_mma as k3b
from ..ops.attention_probe import (
    BWD_TILES,
    KEY_TILES,
    Q_ROWS,
    attention_bwd_tile,
    attention_probe_tile,
)
from .attn_profile import PEAK_BF16, _inputs, card_line, graph_ms, time_ms

# actual model sequence lengths (scripts/attn_tune.py:37-40): eval per clip
# length, and the pretraining lengths after structured time patchout
ARCH_N = {
    "5s": 272, "10s": 551, "20s": 1118, "30s": 1676,
    "10s-train": 281, "20s-train": 578, "30s-train": 866,
}


ROUNDS = 5  # interleaved rounds of the control and the nine tiles


def _tflops(flop: float, ms: float) -> str:
    tf = flop / (ms / 1e3) / 1e12
    return f"{tf:6.1f} TFLOP/s = {tf / (PEAK_BF16 / 1e12) * 100:4.1f} % of 989"


def tile_ms(fn, iters, device) -> float:
    """ms a call of ``fn``: CUDA-graph replays on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        return graph_ms(fn, iters, device)
    return time_ms(fn, iters, device)


def _rounds(fns: dict, iters, device) -> dict:
    """{name: [ms of each round]}: every fn timed once a round, in turn."""
    runs = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            runs[name].append(tile_ms(fn, iters, device))
    return runs


def _spread(runs: list) -> str:
    return (f"{float(np.median(runs)):.4f} ms [{min(runs):.4f}-"
            f"{max(runs):.4f}]")


def sweep_fwd(n, batch, heads, iters, device) -> dict:
    """{"K2": [ms a round], "<q_rows>x<key_tile>": [ms a round]}, one line
    per tile."""
    q, k, v = _inputs(batch, n, heads, 0.1, 0, device)
    flop = 4 * batch * heads * n * n * 64
    fns = {"K2": lambda: attention_fwd_mma(q, k, v)}
    for qr in Q_ROWS:
        for kt in KEY_TILES:
            fns[f"{qr}x{kt}"] = (lambda qr=qr, kt=kt: attention_probe_tile(
                q, k, v, qr, kt))
    with torch.inference_mode():
        runs = _rounds(fns, iters, device)
    for qr in Q_ROWS:
        for kt in KEY_TILES:
            ms = runs[f"{qr}x{kt}"]
            line = (f"  fwd q_rows={qr:3d} key_tile={kt:3d}: {_spread(ms)};"
                    f" real q rows {n / (-(-n // qr) * qr) * 100:5.1f} %")
            if device.type == "cuda":
                line += f"; {_tflops(flop, float(np.median(ms)))}"
            print(line + f"; K2 (128, 64) {_spread(runs['K2'])}", flush=True)
    return runs


def sweep_bwd(n, batch, heads, iters, device) -> dict:
    """{"K3b": [ms a round], "<rows>x<tile>": [ms a round]}, one line per
    tile."""
    q, k, v = _inputs(batch, n, heads, 0.1, 0, device)
    gen = torch.Generator(device=device).manual_seed(1)
    do = (torch.randn(q.shape, generator=gen, device=device) * 0.1).to(
        q.dtype)
    o, lse = flash_attention_fwd_lse(q, k, v)
    flop = 10 * batch * heads * n * n * 64
    fns = {"K3b": lambda: k3b(q, k, v, o, lse, do)}
    for rows in BWD_TILES:
        for tile in BWD_TILES:
            fns[f"{rows}x{tile}"] = (lambda rows=rows, tile=tile:
                                     attention_bwd_tile(q, k, v, o, lse, do,
                                                        rows, tile))
    runs = _rounds(fns, iters, device)
    for rows in BWD_TILES:
        for tile in BWD_TILES:
            ms = runs[f"{rows}x{tile}"]
            line = f"  bwd rows={rows:3d} tile={tile:3d}: {_spread(ms)}"
            if device.type == "cuda":
                line += (f"; {_tflops(flop, float(np.median(ms)))} "
                         "(5 products)")
            print(line + f"; K3b (64, 64) {_spread(runs['K3b'])}",
                  flush=True)
    return runs


def main(argv=None) -> dict:
    """Run the sweep; return {arch: {"K2" or "K3b": [ms a round], tile:
    [ms a round]}}."""
    ap = argparse.ArgumentParser(
        prog="python -m maest_tpu_torch.probes.attn_tune",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--archs", default="30s,20s,10s,5s")
    ap.add_argument("--bwd", action="store_true",
                    help="sweep the backward's tiles instead")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    args = ap.parse_args(argv)

    archs = args.archs.split(",")
    for name in archs:  # refuse before any work
        if name not in ARCH_N:
            raise ValueError(f"unknown arch {name!r}; expected one of "
                             f"{', '.join(ARCH_N)}")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the sweep times the kernels "
                               "on the card (--device cpu runs plain "
                               "versions)")
        print(card_line(device), flush=True)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    sweep = sweep_bwd if args.bwd else sweep_fwd
    results, best = {}, {}
    for name in archs:
        n = ARCH_N[name]
        print(f"== {name} (N={n}): ({args.batch}, {n}, {args.heads}, 64) "
              f"bf16, {'backward' if args.bwd else 'forward'} ==", flush=True)
        rows = results[name] = sweep(n, args.batch, args.heads, args.iters,
                                     device)
        best[name] = min((t for t in rows if "x" in t),
                         key=lambda t: float(np.median(rows[t])))
    print("\n== best per arch ==")
    ctrl = "K3b (64, 64)" if args.bwd else "K2 (128, 64)"
    for name, tile in best.items():
        ms, base = results[name][tile], results[name][ctrl.split()[0]]
        verdict = ("resolved: its slowest round beats the control's fastest"
                   if max(ms) < min(base) else "within the control's spread")
        print(f"{name}: {_spread(ms)} at {tile.replace('x', ' x ')} "
              f"({'rows x tile' if args.bwd else 'q_rows x key_tile'}), "
              f"{ctrl} {_spread(base)}; {verdict}", flush=True)
    return results


if __name__ == "__main__":
    main()
