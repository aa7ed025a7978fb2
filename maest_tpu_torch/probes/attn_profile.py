"""Attention decomposition on the card, port of ``scripts/attn_profile_r2.py``.

    python -m maest_tpu_torch.probes.attn_profile [--shapes 30s,30s-train]
        [--batch 32] [--heads 12] [--iters 20] [--variants ...] [--seed 0]
        [--check] [--device cuda]

Times variants of the bf16 attention forward at (batch, N, heads, 64), N
from ``--shapes`` (names of ``ARCH_N`` or token counts), on inputs drawn
N(0, 0.1^2) from ``--seed``, to split K2's time between the products and
pipeline, the softmax arithmetic and the running-max bookkeeping:

  flash      K2, ``flash_attention`` under ``torch.inference_mode()``
  mxu_only   the same grid, copies and products, softmax replaced by a cast
  noexp_max  exp2 with no shift: no running max, no correction
  novmax     the max of each 64-key tile only, no correction
  bf16s      the online softmax on bf16 scores, q pre-scaled in bf16 (the
             pre-scaling pass is part of its time, as in the TPU rig)
  plain      ``attention_reference``, the materialising plain version
  sdpa       ``scaled_dot_product_attention`` on its flash backend: a
             library yardstick, called by nothing else in the port

(``ops/attention_probe.py`` defines the four probes.) Each time is the
median of three runs of ``--iters`` calls after one warm-up call, from CUDA
events; the calls repeat on the same inputs, which take no dependency on
each other. Each line prints ms, TFLOP/s and the share of the H100's 989
TFLOP/s bf16 peak, counting the two products over the real keys, 4 b h N
n_real 64 flop (n_real = N here; the TPU rig counted its padded length),
and the exp2 floor: b h N n_real exp2 at 16 a clock per SM (the
special-function units' ex2 throughput, assumed) on the SM count and
clock of ``torch.cuda.get_device_properties``.

On the card the line adds the time a call of a CUDA graph that replays
the same ``--iters`` calls (median of three replays; not for plain, which
materialises its N^2 scores and is no yardstick of speed): the
device's time with no host issue between the calls, and the idle share of
the event-timed calls, 1 - graph time / event time. A large idle share says
the host's issue rate set that reading, not the kernels. bf16s adds its
kernel alone, on a q pre-scaled once outside the timing (``launch_probe``),
and the pre-scaling pass alone (``prescale_q``), both from events.

After each shape it prints the differences the rig exists for (flash -
mxu_only, flash - noexp_max, flash - novmax, bf16s - flash), from the event
times and, on the card, from the graph times; for bf16s - flash also its
kernel alone and its pass.

``--check`` instead prints each variant's max|diff| against fp32 attention
(``attention_reference`` on fp32 copies) at (2, N, heads, 64) on N(0, 1)
inputs, N the first shape's. Only flash, noexp_max, bf16s, plain and sdpa
compute softmax attention; mxu_only and novmax are printed beside them.

The rig runs on the card; ``--device cpu`` runs the plain versions with the
host's clock, for tests, and prints no device rate. ``gh<G>`` and ``int8``
(the TPU rig's head-grouped and int8 kernels) are not ported yet.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..ops.attention import attention_reference, flash_attention
from ..ops.attention_probe import VARIANTS as PROBES
from ..ops.attention_probe import attention_probe, launch_probe, prescale_q

ARCH_N = {"5s": 272, "10s": 551, "20s": 1118, "30s": 1676,
          "30s-train": 866, "10s-train": 281, "20s-train": 578}
DEFAULT_VARIANTS = "flash,mxu_only,noexp_max,novmax,bf16s,plain,sdpa"
PEAK_BF16 = 989e12          # H100 SXM data sheet, dense bf16 flop/s
EXP2_PER_CLOCK_PER_SM = 16  # special-function unit ex2 rate, assumed
DIFFS = (("flash", "mxu_only", "softmax time K2 does not hide"),
         ("flash", "noexp_max", "running-max bookkeeping"),
         ("flash", "novmax", "correction multiplies"),
         ("bf16s", "flash", "bf16 scores against fp32 ones"))
_SOFTMAX = {"flash", "noexp_max", "bf16s", "plain", "sdpa"}
_NOT_PORTED = ("the TPU rig's {} kernel is not ported yet (ROADMAP queue 2: "
               "P6e/P6f)")


def tokens(shape: str) -> int:
    """N of a shape name of ARCH_N, or of a token count."""
    if shape in ARCH_N:
        return ARCH_N[shape]
    if shape.isdigit() and int(shape) > 0:
        return int(shape)
    raise ValueError(f"unknown shape {shape!r}: a token count or one of "
                     f"{', '.join(ARCH_N)}")


def _sdpa(q, k, v):
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ).transpose(1, 2)


def variant_fn(variant: str, q, k, v):
    """The call that computes ``variant`` on (B, N, H, 64) q, k, v."""
    if variant.startswith("gh") or variant == "int8":
        raise NotImplementedError(_NOT_PORTED.format(variant))
    if variant == "flash":
        return lambda: flash_attention(q, k, v)
    if variant in PROBES:
        return lambda: attention_probe(q, k, v, variant)
    if variant == "plain":
        return lambda: attention_reference(q, k, v)
    if variant == "sdpa":
        return lambda: _sdpa(q, k, v)
    raise ValueError(f"unknown variant {variant!r}; expected one of "
                     f"{DEFAULT_VARIANTS}")


def time_ms(fn, iters: int, device: torch.device, reps: int = 3) -> float:
    """Median over ``reps`` runs of the mean ms of ``iters`` calls, after
    one warm-up call: CUDA events on the card, the host clock on the CPU."""
    fn()
    runs = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            runs.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / iters)
    return float(np.median(runs))


def graph_ms(fn, iters: int, device: torch.device, reps: int = 3) -> float:
    """Median over ``reps`` replays of a CUDA graph of ``iters`` calls of
    ``fn``, ms a call: the device's time with no host issue between calls."""
    side = torch.cuda.Stream(device)  # warm-up off the capture, as torch asks
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        runs.append(start.elapsed_time(end) / iters)
    del graph
    return float(np.median(runs))


def exp2_floor_ms(n_exp2: float, device: torch.device) -> float:
    """ms of ``n_exp2`` exp2 at EXP2_PER_CLOCK_PER_SM on every SM."""
    prop = torch.cuda.get_device_properties(device)
    rate = prop.multi_processor_count * EXP2_PER_CLOCK_PER_SM * (
        prop.clock_rate * 1e3)  # clock_rate in kHz
    return n_exp2 / rate * 1e3


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader",
                              f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return torch.cuda.get_device_name(device) + ", power limit unknown"
    return out.stdout.strip() or torch.cuda.get_device_name(device)


def _inputs(b, n, h, scale, seed, device):
    """q, k, v as strided views of one (B, N, 3, H, 64) bf16 tensor (the
    fused projection's layout), drawn N(0, scale^2) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, n, 3, h, 64), generator=gen, device=device) * scale
    x = x.to(torch.bfloat16)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def check(n: int, heads: int, variants, seed: int, device) -> dict:
    """max|diff| of each variant against fp32 attention at (2, n, heads,
    64), inputs N(0, 1)."""
    q, k, v = _inputs(2, n, heads, 1.0, seed, device)
    ref = attention_reference(q.float(), k.float(), v.float())
    diffs = {}
    with torch.inference_mode():
        for variant in variants:
            got = variant_fn(variant, q, k, v)().float()
            diffs[variant] = (got - ref).abs().max().item()
            what = ("softmax attention" if variant in _SOFTMAX
                    else "not softmax attention")
            print(f"  check {variant:10s} max|diff| vs fp32 attention: "
                  f"{diffs[variant]:.3e} ({what})", flush=True)
    return diffs


def profile(shapes, batch: int, heads: int, iters: int, variants, seed: int,
            device: torch.device) -> dict:
    """{shape: {variant: {"ms", "graph_ms", "idle"}}}, and for bf16s also
    "kernel_ms" and "pass_ms" (``None`` where not measured: every field but
    ms on the CPU, graph_ms and idle for plain), printing one line per
    variant and the decomposition after each shape."""
    on_card = device.type == "cuda"
    out = {}
    for name in shapes:
        n = tokens(name)
        flop = 4 * batch * heads * n * n * 64
        n_exp2 = batch * heads * n * n
        print(f"== {name}: ({batch}, {n}, {heads}, 64) bf16, "
              f"{flop / 1e9:.1f} GFLOP and {n_exp2 / 1e9:.3f} G exp2 a call "
              "over the real keys ==", flush=True)
        q, k, v = _inputs(batch, n, heads, 0.1, seed, device)
        rows = out[name] = {}
        with torch.inference_mode():
            for variant in variants:
                fn = variant_fn(variant, q, k, v)
                row = rows[variant] = dict(ms=time_ms(fn, iters, device),
                                           graph_ms=None, idle=None)
                line = f"  {variant:10s} {row['ms']:9.4f} ms"
                if not on_card:
                    print(line + " (host clock on the cpu: no device rate)",
                          flush=True)
                    continue
                tf = flop / (row["ms"] / 1e3) / 1e12
                peak = PEAK_BF16 / 1e12
                line += (f" {tf:7.1f} TFLOP/s {tf / peak * 100:5.1f} % of "
                         f"{peak:.0f}; exp2 floor "
                         f"{exp2_floor_ms(n_exp2, device):.4f} ms")
                if variant != "plain":
                    row["graph_ms"] = graph_ms(fn, iters, device)
                    row["idle"] = 1.0 - row["graph_ms"] / row["ms"]
                    line += (f"; graph {row['graph_ms']:.4f} ms, idle "
                             f"{row['idle'] * 100:.1f} %")
                if variant == "bf16s":
                    qs = prescale_q(q)
                    row["kernel_ms"] = time_ms(
                        lambda: launch_probe(qs, k, v, "bf16s"), iters, device)
                    row["pass_ms"] = time_ms(lambda: prescale_q(q), iters,
                                             device)
                    line += (f"; kernel alone {row['kernel_ms']:.4f} ms, "
                             f"pre-scaling pass {row['pass_ms']:.4f} ms")
                    del qs
                print(line, flush=True)
        del q, k, v
        for a, b, what in DIFFS:
            if a in rows and b in rows:
                ra, rb = rows[a], rows[b]
                line = f"  {a} - {b} = {ra['ms'] - rb['ms']:+.4f} ms"
                if on_card:
                    line += f" (events), {ra['graph_ms'] - rb['graph_ms']:+.4f}"
                    line += " ms (graphs)"
                    if a == "bf16s":
                        line += (f"; its kernel alone "
                                 f"{ra['kernel_ms'] - rb['ms']:+.4f} ms, its "
                                 f"pass {ra['pass_ms']:.4f} ms")
                print(f"{line}: {what}", flush=True)
    return out


def main(argv=None) -> dict:
    """Run the rig; return ``profile``'s {shape: {variant: times}}, or with
    ``--check`` {variant: max|diff|}."""
    ap = argparse.ArgumentParser(
        prog="python -m maest_tpu_torch.probes.attn_profile",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--shapes", default="30s")
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="print each variant's max|diff| vs fp32 attention")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    args = ap.parse_args(argv)

    variants = args.variants.split(",")
    for variant in variants:  # refuse before any work
        variant_fn(variant, None, None, None)
    shapes = args.shapes.split(",")
    for shape in shapes:
        tokens(shape)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the rig times the kernels on "
                               "the card (--device cpu runs plain versions)")
        print(card_line(device), flush=True)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    if args.check:
        return check(tokens(shapes[0]), args.heads, variants, args.seed + 1,
                     device)
    return profile(shapes, args.batch, args.heads, args.iters, variants,
                   args.seed, device)


if __name__ == "__main__":
    main()
