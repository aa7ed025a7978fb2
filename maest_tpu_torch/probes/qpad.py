"""K2 with its q rows padded to mma.sync's 16 on the card, port of
``scripts/qpad_probe.py``.

    python -m maest_tpu_torch.probes.qpad [--shapes 100x281,32x272,...]
        [--iters 30] [--seed 0] [--device cuda]

The TPU rig padded the q rows of the 10 s recipe's attention to the
sublane's 8 (281 -> 288) instead of the block's 384, G heads a program
(G 8, 12, 24), and timed the forward, the forward with lse and the
production vjp. On the H100 K2 tiles q in blocks of 128 rows, so at N 281
its three blocks multiply 103 padded rows a head; the port's counterpart
(``attention_probe_qpad``) skips the products of every warp whose 16 rows
all lie past N, so at most 15 padded rows a head are multiplied, with G 1
(the production grid), 8, 12 or 24 heads a block.

For each ``--shapes`` entry BxN (default the rig's 100x281; heads 12,
head_dim 64, bf16, inputs drawn N(0, 0.1^2) from ``--seed``), numerics
first: every G against plain attention within the rig's 5e-2
and, on the card, equal bit for bit to K2's mma.sync kernel, the template
qpad changes (``attention_fwd_mma``, the control of the wgmma kernel that
``flash_attention`` now runs). Then it times that K2 under
``torch.inference_mode()``, qpad at each G, the same kernel with lse
(K3a), qpad with lse at each G, and the vjp through ``flash_attention``
under autograd (the production K3a and K3b, with a dense random
cotangent, as the rig's). Each time is ``probes.attn_profile``'s
``rig_ms``: CUDA-graph replays below N 300, CUDA events above (median of
three runs of ``--iters`` calls). It prints the card's name and power
limit first, one line per call and each qpad's difference from K2; it
writes no file. ``--device cpu`` runs the plain versions with the host's
clock, for tests.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.attention import (
    attention_fwd_mma,
    attention_reference,
    flash_attention,
)
from ..ops.attention_probe import QPAD_GROUPS, attention_probe_qpad
from .attn_profile import GRAPH_BELOW_N, _inputs, card_line, rig_ms

HEADS = 12
RIG_TOL = 5e-2  # the rig's bound of each G against attention (qpad_probe.py:124)


def shape(text: str) -> tuple[int, int]:
    """(B, N) of a BxN entry of ``--shapes``."""
    b, _, n = text.partition("x")
    if not (b.isdigit() and n.isdigit() and int(b) > 0 and int(n) > 0):
        raise ValueError(f"unknown shape {text!r}: expected BxN, as 100x281")
    return int(b), int(n)


def groups(b: int) -> list[int]:
    """The G of QPAD_GROUPS that divide b * HEADS."""
    return [g for g in QPAD_GROUPS if b * HEADS % g == 0]


def check(b, n, seed, device) -> float:
    """Every G against plain attention (the rig's numerics check) and, on
    the card, against K2 bit for bit; returns the largest distance."""
    q, k, v = _inputs(b, n, HEADS, 0.1, seed, device)
    with torch.inference_mode():
        ref = attention_reference(q, k, v).float()
        k2 = attention_fwd_mma(q, k, v)[0]
        worst = 0.0
        for g in groups(b):
            out = attention_probe_qpad(q, k, v, g)[0]
            err = (out.float() - ref).abs().max().item()
            if err >= RIG_TOL:
                raise AssertionError(f"qpad G{g} ({b}, {n}) diverged: {err}")
            if device.type == "cuda" and not torch.equal(out, k2):
                raise AssertionError(f"qpad G{g} ({b}, {n}) differs from K2")
            worst = max(worst, err)
    print(f"  numerics: qpad G{', G'.join(map(str, groups(b)))} within "
          f"{worst:.3e} of plain attention (< {RIG_TOL})"
          + ("; each equal to K2" if device.type == "cuda" else ""),
          flush=True)
    return worst


def profile(b, n, iters, seed, device) -> dict:
    """{call: ms} at (b, n, 12, 64), printing one line per call."""
    q, k, v = _inputs(b, n, HEADS, 0.1, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    ct = (torch.randn(q.shape, generator=gen, device=device) * 0.1).to(
        q.dtype)
    qg = q.detach().clone().requires_grad_(True)
    calls = {"K2": lambda: attention_fwd_mma(q, k, v)}
    calls.update({f"qpad G{g}": lambda g=g: attention_probe_qpad(q, k, v, g)
                  for g in groups(b)})
    calls["K3a"] = lambda: attention_fwd_mma(q, k, v, with_lse=True)
    calls.update({f"qpad+lse G{g}":
                  lambda g=g: attention_probe_qpad(q, k, v, g, with_lse=True)
                  for g in groups(b)})
    how = ("CUDA-graph replays" if device.type == "cuda" and n < GRAPH_BELOW_N
           else "CUDA events" if device.type == "cuda" else "host clock")
    out = {}
    for name, fn in calls.items():
        with torch.inference_mode():
            out[name] = rig_ms(fn, n, iters, device)
    out["vjp"] = rig_ms(
        lambda: torch.autograd.grad(flash_attention(qg, k, v), qg, ct), n,
        iters, device)
    for name, ms in out.items():
        base = out["K3a" if "lse" in name else "K2"]
        line = f"  {name:14s} {ms:9.4f} ms ({how})"
        if name.startswith("qpad"):
            line += (f", {ms - base:+.4f} ms = {(ms / base - 1) * 100:+.1f} "
                     f"% vs {'K3a' if 'lse' in name else 'K2'}")
        print(line, flush=True)
    return out


def main(argv=None) -> dict:
    """Run the rig; return {BxN: {call: ms, "max_err": numerics}}."""
    ap = argparse.ArgumentParser(
        prog="python -m maest_tpu_torch.probes.qpad",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    ap.add_argument("--shapes", default="100x281",
                    help="comma-separated BxN, heads 12 (the rig's 100x281)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    shapes = [shape(s) for s in args.shapes.split(",")]  # refuse first
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the rig times the kernels on "
                               "the card (--device cpu runs plain versions)")
        print(card_line(device), flush=True)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    results = {}
    for b, n in shapes:
        print(f"== ({b}, {n}, {HEADS}, 64) bf16: q rows padded to 16, not "
              f"128 (K2 multiplies {-(-n // 128) * 128 - n} padded rows a "
              f"head, qpad at most {-(-n // 16) * 16 - n}) ==", flush=True)
        err = check(b, n, args.seed, device)
        results[f"{b}x{n}"] = dict(profile(b, n, args.iters, args.seed,
                                           device), max_err=err)
    return results


if __name__ == "__main__":
    main()
