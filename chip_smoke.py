#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``maest_tpu_torch``) on one card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``maest_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, checks the full-width 30 s
ViT-B fp32 forward against the JAX package's golden logits, drives the
tagging path (``get_maest(...).predict_labels`` in bf16, and the HTTP
server) with the kernels' launch counters reset, and times the kernels and
the batch-32 tagging step with CUDA events (phases 1-8). Then the training
path: the training forward (K3a) and backward (K3b/K4) against their plain
versions, one full-width fp32 train step against the JAX package's golden,
the 30 s pre-training recipe step (ViT-B, batch 32, bf16 over fp32
parameters) with its launch counters reset, and the kernels' and both
recipe shapes' times (phases 9-12). Then the 8-bit attention modes: the
int8 / e4m3 forward (K5, K6) against its plain version in every mode
(phase 13), the tagging path in each mode with the counters reset (14),
the int8 backward (K7) against its plain version and against the bf16
backward (15), the 30 s recipe step with ``attention_bwd_quant="int8"``,
then with ``attention_quant="qk8"`` and with both (16), and the PyTorch
library calls timed as yardsticks beside K2, K3a, K3b and K4 (17). Then
the decomposition rig: its four probe kernels (P6a-d, the variants of K2's
loop in ``csrc/attention_probe.cu``) against their plain versions and K2
(18), and ``python -m maest_tpu_torch.probes.attn_profile`` at both
tagging and training shapes, called in process with the launch counters
reset (19). Every phase prints one line per check; any failure raises, so
the exit code is not 0.
The card's name and power limit, the JSON record of the kernels (with each
one's bound: the least time the card could take for its work at the
data-sheet rates) and the device record are the last three lines. Without
torch or a CUDA card, or outside a checkout, it exits with a non-zero code
and prints no result.

Weights are random, drawn from the golden files' seeds; no file is fetched.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ARCH = "discogs-maest-30s-pw-129e"
SR = 16000
CLIP = 30 * SR  # samples of one native-length clip
BATCH = 32
DEVICE = "cuda:0"

# Tolerances, each against the stated reference on the same inputs:
MEL_TOL = 1e-4      # K1 vs plain: the front-end's fp32 bound (1e-4 vs fp64)
ATTN_TOL = {"float32": 2e-5,    # K2 fp32 vs plain: fp32 sums in other orders
            "bfloat16": 2e-2}   # K2 bf16 vs plain, compared in fp32: bf16
                                # rounds p and the output at ~4e-3 relative
GOLDEN_TOL = 5e-4   # fp32 logits vs tests/golden (the JAX package's bound)
TIER_TOL = 1e-2     # bf16 activations vs the fp32 tier's
SERVE_TOL = 1e-2    # served vs predict_labels, bf16: another bucket size may
                    # take other cuBLAS kernels that round in another order
LSE_TOL = 1e-4      # K3a lse vs plain: fp32 log2-sum-exp, sums in other orders
# the fp32 train step vs tests/golden/vitb_30s_train_step.npz (JAX on the
# CPU): fp32 sums in other orders through 12 layers and back; measured on
# the H100 8e-8, 3.8e-7, 2.1e-6 and 4.6e-6, so each bound keeps a margin
# of ~20x or more and still catches a wrong roundoff-sized term
STEP_LOSS_RTOL = 1e-6
STEP_NORM_TOL = (2e-5, 1e-9)   # (rtol, atol) of each gradient's L2 norm
STEP_GRAD_RTOL = 1e-4          # small gradients, relative to their max
STEP_LOGIT_TOL = 1e-4          # logits after the AdamW step (lr 1e-4)
RECIPE = "maest_30s_from_passt_pretrain"
Q8_MODES = ("qk8", "qk8pv8", "fp8", "fp8pv8")
# K5/K6 vs plain on the same 64-key tiles, compared in fp32: both round
# one fp32 output to bf16, and their fp32 values differ by far less than a
# bf16 ulp (sums in another order; an exp2 ulp that flips one 8-bit p moves
# o by ~|v| / (127 l)), so an element may round one ulp apart: the bound is
# Q8_ULPS bf16 ulps of the largest |o| of the plain version
Q8_ULPS = 2
K7_TOL = 2e-2       # K7 vs plain, relative to each gradient's max: the bf16
                    # bound (bf16 outputs; an exp2 ulp may flip one p8/ds8)
K7_COS = 0.9999
# P6a-d vs plain on the same 64-key tiles: as Q8_ULPS, both round one fp32
# output to bf16 and their fp32 values differ by sums in other orders
PROBE_ULPS = 2
# noexp_max and bf16s vs K2 (both softmax attention): bf16 rounds their p
# (and bf16s its scores) elsewhere than K2's, relative errors, so the bound
# is 1e-2 of max(1, the largest |o|): at N 100 |o| reaches 1.5, where one
# bf16 ulp is 7.8e-3
PROBE_VS_K2 = 1e-2
# H100 SXM data-sheet peaks (dense), for the bounds of the kernels line
PEAK = {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12, "fp32": 67e12}
HBM = 3.35e12       # bytes/s


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """(ms, what binds): the larger of the bytes over the memory rate and
    the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM
    t_ops = sum(n / PEAK[k] for k, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def attn_bound(b, n, h, n_real=None, pv="bf16", qk="bf16", lse=False):
    """The forward at (b, n, h, 64): the two products over the real keys,
    q/k/v read and the bf16 output (and the fp32 lse) written once."""
    flops = 2 * b * h * n * (n_real or n) * 64
    nbytes = 4 * b * n * h * 64 * 2 + (4 * b * h * n if lse else 0)
    ops: dict = {}
    ops[qk] = ops.get(qk, 0) + flops
    ops[pv] = ops.get(pv, 0) + flops
    return bound(nbytes, ops)


def bwd_bound(b, n, h, n_real=None, kind="bf16"):
    """The backward at (b, n, h, 64): its five products over the real keys
    (dv, dp, dq, dk and the score recompute), q/k/v/o/do and lse read, and
    dq/dk/dv written once."""
    flops = 5 * 2 * b * h * n * (n_real or n) * 64
    nbytes = 8 * b * n * h * 64 * 2 + 4 * b * h * n
    return bound(nbytes, {kind: flops})


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_median(fn, iters: int, reps: int = 3) -> float:
    """The median of ``reps`` runs of ``cuda_ms``: one run's mean carries
    any stall of the shared host that lands in it."""
    return float(np.median([cuda_ms(fn, iters) for _ in range(reps)]))


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def cosine(a, b) -> float:
    """Cosine similarity of two tensors, summed in float64: an fp32 sum over
    millions of elements can miss 1 by more than the 1e-4 it must show."""
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_kernels_vs_plain(dev):
    """Phases 3-4: each kernel against its plain version at the main path's
    shapes."""
    from maest_tpu_torch.dsp.mel import frame_waveforms
    from maest_tpu_torch.ops.attention import attention_reference, flash_attention
    from maest_tpu_torch.ops.mel_kernel import (
        fused_logmel_from_frames,
        fused_logmel_from_frames_reference,
    )

    rng = np.random.default_rng(0)
    waves = torch.from_numpy(
        rng.standard_normal((BATCH, CLIP)).astype(np.float32) * 0.1).to(dev)
    frames = frame_waveforms(waves).reshape(-1, 512).contiguous()
    before = fused_logmel_from_frames.launches
    mel_err = max_err(fused_logmel_from_frames(frames),
                      fused_logmel_from_frames_reference(frames))
    torch.cuda.synchronize()
    check(fused_logmel_from_frames.launches == before + 1, "mel counter")
    check(mel_err <= MEL_TOL, f"K1 err {mel_err} > {MEL_TOL}")
    print(f"phase 3 K1 mel: frames {tuple(frames.shape)} max_abs_err "
          f"{mel_err:.3e} <= {MEL_TOL}", flush=True)

    attn_err = {}
    for n, n_real in ((1676, None), (1792, 1676)):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.from_numpy(rng.standard_normal(
                (BATCH, n, 3, 12, 64)).astype(np.float32)).to(dev, dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            before = flash_attention.launches
            err = max_err(flash_attention(q, k, v, n_real=n_real),
                          attention_reference(q, k, v, n_real=n_real))
            torch.cuda.synchronize()
            check(flash_attention.launches == before + 1, "attention counter")
            name = str(dtype).split(".")[1]
            check(err <= ATTN_TOL[name], f"K2 {name} N{n} err {err}")
            attn_err[(n, name)] = err
            print(f"phase 4 K2 attention: ({BATCH}, {n}, 12, 64) n_real "
                  f"{n_real} {name} max_abs_err {err:.3e} <= "
                  f"{ATTN_TOL[name]}", flush=True)
            del qkv, q, k, v
    return mel_err, attn_err[(1676, "bfloat16")]


def phase_golden(dev):
    """Phase 5: full-width fp32 forward against the JAX package's golden
    logits; returns the state dict it drew."""
    from maest_tpu_torch.checkpoints import load_into
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.ops.attention import flash_attention
    from torch_oracle import make_state

    golden = np.load(ROOT / "tests" / "golden" / "vitb_30s_logits.npz")
    cfg = build_config(ARCH)
    rng = np.random.default_rng(int(golden["seed"]))
    sd = make_state(rng, cfg)
    x = rng.standard_normal((2, 1, *cfg.img_size)).astype("float32") * 0.1
    net = load_into(MAESTNet(cfg, device=dev), sd).eval()
    before = flash_attention.launches
    with torch.inference_mode():
        logits = net(torch.from_numpy(x).to(dev))[0]
    torch.cuda.synchronize()
    grew = flash_attention.launches - before
    check(grew == cfg.depth, f"attention launches {grew} != {cfg.depth}")
    err = float(np.abs(logits.cpu().numpy() - golden["logits"]).max())
    check(bool(np.isfinite(logits.cpu().numpy()).all()), "golden not finite")
    check(err <= GOLDEN_TOL, f"golden err {err} > {GOLDEN_TOL}")
    print(f"phase 5 golden: 30 s ViT-B fp32 logits {tuple(logits.shape)} "
          f"max_abs_err {err:.3e} <= {GOLDEN_TOL} vs "
          f"tests/golden/vitb_30s_logits.npz; attention launches +{grew}",
          flush=True)
    del net
    return sd


def phase_main_path(dev, sd, tmp):
    """Phase 6: the user's entry point on the card with the counters reset;
    returns (bf16 model, launches, inputs)."""
    from maest_tpu_torch import get_maest
    from maest_tpu_torch.ops.attention import flash_attention
    from maest_tpu_torch.ops.mel_kernel import fused_logmel_from_frames

    ckpt = str(Path(tmp) / "random-vitb.pt")
    torch.save(sd, ckpt)
    kw = dict(pretrained=False, checkpoint=ckpt, device=dev)
    model = get_maest(ARCH, dtype=torch.bfloat16, **kw)
    rng = np.random.default_rng(1)
    wave = rng.standard_normal(CLIP).astype(np.float32) * 0.1
    inputs = {
        "wave_30s": wave,
        "wave_95s": rng.standard_normal(95 * SR).astype(np.float32) * 0.1,
        "pcm16_30s": (np.clip(wave, -1, 1) * 32767).astype(np.int16),
        f"batch_{BATCH}x30s": rng.standard_normal((BATCH, CLIP)).astype(
            np.float32) * 0.1,
    }
    fused_logmel_from_frames.launches = 0
    flash_attention.launches = 0
    acts = {k: model.predict_labels(x)[0] for k, x in inputs.items()}
    torch.cuda.synchronize()
    launches = {"mel": fused_logmel_from_frames.launches,
                "attention": flash_attention.launches}
    check(launches["mel"] == len(inputs), f"mel launches {launches}")
    check(launches["attention"] == 12 * len(inputs),
          f"attention launches {launches}")

    ref = get_maest(ARCH, dtype=torch.float32, **kw)
    worst = 0.0
    for k, x in inputs.items():
        a = acts[k]
        check(a.shape == (400,) and bool(np.isfinite(a).all()), f"{k} acts")
        worst = max(worst, float(np.abs(a - ref.predict_labels(x)[0]).max()))
    del ref
    check(worst <= TIER_TOL, f"bf16 vs fp32 {worst} > {TIER_TOL}")
    top = model.labels[int(np.argmax(acts["wave_30s"]))]
    with torch.inference_mode():
        chunks = model._chunk_melspec(
            model.melspectrogram(inputs["wave_95s"])).shape[0]
    print(f"phase 6 main path: predict_labels bf16 on {list(inputs)} "
          f"(95 s -> {chunks} chunks); launches {launches}; bf16 vs fp32 "
          f"activations max_abs_err {worst:.3e} <= {TIER_TOL}; top label "
          f"{top!r}", flush=True)
    return model, launches, inputs


def phase_server(model, inputs):
    """Phase 7: the HTTP server answers 4 concurrent requests as
    predict_labels does."""
    from maest_tpu_torch.apps.serve import serve_forever
    from maest_tpu_torch.serve import TagService

    svc = TagService(model, buckets=(1, 2, 4), max_wait_ms=5.0)
    server, thread = serve_forever(svc, "127.0.0.1", 0, top_k=400)
    url = f"http://127.0.0.1:{server.server_port}"
    ten_s = inputs["wave_95s"][:10 * SR]
    cases = [
        ("native float32", inputs["wave_30s"].tobytes(),
         "application/octet-stream", inputs["wave_30s"]),
        ("native pcm16", inputs["pcm16_30s"].astype("<i2").tobytes(),
         "audio/pcm", inputs["pcm16_30s"]),
        ("95 s float32", inputs["wave_95s"].tobytes(),
         "application/octet-stream", inputs["wave_95s"]),
        ("10 s json", json.dumps({"waveform": ten_s.tolist()}).encode(),
         "application/json", ten_s),
    ]
    answers: list = [None] * len(cases)
    errors: list = []

    def post(i):
        try:
            req = urllib.request.Request(
                f"{url}/tag", data=cases[i][1],
                headers={"Content-Type": cases[i][2]})
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[i] = json.loads(r.read())
        except Exception as e:  # reported below, fails the phase
            errors.append((cases[i][0], repr(e)))

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(cases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "request hung")
        check(not errors, f"requests failed: {errors}")
        index = {name: i for i, name in enumerate(model.labels)}
        worst = 0.0
        for (what, _, _, x), res in zip(cases, answers):
            got = np.zeros(400, np.float32)
            for name, score in res["labels"]:
                got[index[name]] = score
            worst = max(worst, float(np.abs(
                got - model.predict_labels(x)[0]).max()))
        check(worst <= SERVE_TOL, f"served vs predict_labels {worst}")
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        check(stats["requests"] == len(cases), f"stats {stats}")
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=60)
    print(f"phase 7 server: {len(cases)} concurrent POST /tag "
          f"({', '.join(c[0] for c in cases)}) equal to predict_labels, max "
          f"abs diff {worst:.3e} <= {SERVE_TOL}; /stats {json.dumps(stats)}",
          flush=True)


def phase_times(dev, model, gpu):
    """Phase 8: kernel vs plain at the main path's shapes, and the batch-32
    30 s bf16 step, all with CUDA events after warm-up."""
    from maest_tpu_torch.dsp.mel import frame_waveforms
    from maest_tpu_torch.ops.attention import attention_reference, flash_attention
    from maest_tpu_torch.ops.mel_kernel import (
        fused_logmel_from_frames,
        fused_logmel_from_frames_reference,
    )
    from maest_tpu_torch.serve import BucketPrograms

    rng = np.random.default_rng(2)
    waves = torch.from_numpy(
        rng.standard_normal((BATCH, CLIP)).astype(np.float32) * 0.1).to(dev)
    frames = frame_waveforms(waves).reshape(-1, 512).contiguous()
    t = {"mel": (cuda_ms(lambda: fused_logmel_from_frames(frames), 20),
                 cuda_ms(lambda: fused_logmel_from_frames_reference(frames),
                         20))}
    print(f"phase 8 time K1 mel frames {tuple(frames.shape)}: kernel "
          f"{t['mel'][0]:.4f} ms, plain {t['mel'][1]:.4f} ms [{gpu}]",
          flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.from_numpy(rng.standard_normal(
            (BATCH, 1676, 3, 12, 64)).astype(np.float32)).to(dev, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        name = str(dtype).split(".")[1]
        t[name] = (cuda_ms(lambda: flash_attention(q, k, v), 5),
                   cuda_ms(lambda: attention_reference(q, k, v), 5))
        print(f"phase 8 time K2 attention ({BATCH}, 1676, 12, 64) {name}: "
              f"kernel {t[name][0]:.4f} ms, plain {t[name][1]:.4f} ms [{gpu}]",
              flush=True)
        del qkv, q, k, v

    prog = BucketPrograms(model, buckets=(BATCH,), fused_wave=True)
    with torch.inference_mode():
        step = cuda_ms(lambda: prog._activations(waves), 5)
    rate = BATCH * 30 / (step / 1e3)
    print(f"phase 8 time main path: batch-{BATCH} 30 s bf16 "
          f"wave->mel->ViT->sigmoid step {step:.3f} ms = {rate:.1f} audio-s/s "
          f"[{gpu}]", flush=True)
    return t


def phase_train_kernels(dev):
    """Phase 9: K3a and the backward (K3b at both recipes' shapes; K4's
    regime at N 4500) against their plain versions on the same inputs and
    saved tensors."""
    from maest_tpu_torch.ops.attention import (
        attention_bwd,
        attention_bwd_reference,
        attention_reference_lse,
        flash_attention_fwd_lse,
    )

    rng = np.random.default_rng(3)
    errs = {}
    # the 30 s recipe's N, padded with n_real, the 10 s recipe's batch and
    # N, and K4's regime (N 4500 > the TPU's 4096 switch)
    for b, n, n_real in ((BATCH, 866, None), (BATCH, 896, 866),
                         (100, 281, None), (2, 4500, 4400)):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            qkv = torch.from_numpy(rng.standard_normal(
                (b, n, 3, 12, 64)).astype(np.float32)).to(dev, dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            g = torch.from_numpy(rng.standard_normal(
                (b, n, 12, 64)).astype(np.float32)).to(dev, dtype)
            before = (flash_attention_fwd_lse.launches, attention_bwd.launches)
            o, lse = flash_attention_fwd_lse(q, k, v, n_real=n_real)
            ro, rlse = attention_reference_lse(q, k, v, n_real)
            grads = attention_bwd(q, k, v, ro, rlse, g, n_real)
            ref = attention_bwd_reference(q, k, v, ro, rlse, g, n_real)
            torch.cuda.synchronize()
            check((flash_attention_fwd_lse.launches, attention_bwd.launches)
                  == (before[0] + 1, before[1] + 1), "K3a/K3b counters")
            e = {"o": max_err(o, ro), "lse": max_err(lse, rlse)}
            e.update({w: max_err(a, r) for w, a, r in zip(
                ("dq", "dk", "dv"), grads, ref)})
            tol = ATTN_TOL[name]
            check(e["lse"] <= LSE_TOL, f"K3a lse {name} N{n} {e['lse']}")
            for w in ("o", "dq", "dk", "dv"):
                check(e[w] <= tol, f"K3 {w} {name} N{n} err {e[w]} > {tol}")
            if n_real is not None:
                check(not grads[1][:, n_real:].any()
                      and not grads[2][:, n_real:].any(), "masked dk/dv")
            errs[(b, n, name)] = e
            print(f"phase 9 K3a/K3b train attention: ({b}, {n}, 12, 64) "
                  f"n_real {n_real} {name} max_abs_err lse {e['lse']:.3e} <= "
                  f"{LSE_TOL}, o {e['o']:.3e}, dq {e['dq']:.3e}, dk "
                  f"{e['dk']:.3e}, dv {e['dv']:.3e} <= {tol}", flush=True)
            del qkv, q, k, v, g, o, lse, ro, rlse, grads, ref
            torch.cuda.empty_cache()
    return errs[(BATCH, 866, "bfloat16")], errs[(2, 4500, "bfloat16")]


def _launch_counts():
    from maest_tpu_torch.ops.attention import (
        attention_bwd,
        flash_attention,
        flash_attention_fwd_lse,
    )
    return (flash_attention.launches, flash_attention_fwd_lse.launches,
            attention_bwd.launches)


def phase_golden_step(dev):
    """Phase 10: one full-width fp32 train step (K3a, K3b in fp32) against
    the JAX package's golden: loss, every gradient's L2 norm, the small
    gradients, and the logits after the AdamW step."""
    from maest_tpu_torch.checkpoints import load_into
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet, TrainDraws
    from maest_tpu_torch.train import (
        AugmentConfig,
        TrainState,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from torch_oracle import make_state

    golden = np.load(ROOT / "tests" / "golden" / "vitb_30s_train_step.npz")
    rng = np.random.default_rng(int(golden["seed"]))  # the golden's draws
    drop = np.sort(rng.choice(186, 90, replace=False))
    check(np.array_equal(drop, golden["drop_t"]), "golden draws")
    cfg = build_config(ARCH, s_patchout_t_indices=tuple(int(i) for i in drop))
    sd = make_state(rng, cfg)
    x = rng.standard_normal((2, 96, 1875)).astype("f4") + 2.0
    y = (rng.random((2, 400)) < 0.05).astype("f4")

    net = load_into(MAESTNet(cfg, device=dev), sd)
    tx = make_optimizer(lr_schedule=float(golden["lr"]), weight_decay=1e-4)
    state = TrainState.create(net, tx, with_swa=False)
    names = {id(p): k for k, p in net.named_parameters()}
    grads = {}

    def keep_grads(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    grads[names[id(p)]] = p.grad.detach().double()

    state.optimizer.register_step_pre_hook(keep_grads)
    aug = AugmentConfig(masking=False, mixup_alpha=0.0)
    before = _launch_counts()
    state, metrics = make_train_step(net, tx, aug)(
        state, {"x": x, "y": y},
        draws=TrainDraws(time_offset=int(golden["time_offset"])))
    grew = [a - b for a, b in zip(_launch_counts(), before)]
    check(grew == [0, cfg.depth, cfg.depth], f"golden step launches {grew}")
    logits = make_eval_step(net, aug, with_swa=False)(state, x)[""]
    torch.cuda.synchronize()

    loss_err = abs(metrics["train_loss"] - float(golden["loss"])) / float(
        golden["loss"])
    check(metrics["nonfinite_skipped"] == 0.0, "golden step skipped")
    check(loss_err <= STEP_LOSS_RTOL, f"golden loss rel err {loss_err}")
    norm_err = grad_err = 0.0
    for key in golden.files:
        if key.startswith("norm:"):
            want = float(golden[key])
            got = grads[key[5:]].norm().item()
            check(abs(got - want) <= STEP_NORM_TOL[0] * want + STEP_NORM_TOL[1],
                  f"gradient norm {key}: {got} vs {want}")
            norm_err = max(norm_err, abs(got - want) / want)
        elif key.startswith("grad:"):
            want = torch.from_numpy(golden[key]).double()
            err = (grads[key[5:]].cpu() - want).abs().max().item()
            rel = err / max(want.abs().max().item(), 1e-30)
            check(rel <= STEP_GRAD_RTOL, f"gradient {key}: rel err {rel}")
            grad_err = max(grad_err, rel)
    n_norms = sum(k.startswith("norm:") for k in golden.files)
    check(n_norms == len(grads), f"{len(grads)} gradients, golden {n_norms}")
    logit_err = float(np.abs(logits.cpu().numpy() - golden["logits"]).max())
    check(bool(torch.isfinite(logits).all()), "golden step logits")
    check(logit_err <= STEP_LOGIT_TOL, f"post-step logits err {logit_err}")
    print(f"phase 10 golden train step: 30 s ViT-B fp32 batch 2 N 866 vs "
          f"tests/golden/vitb_30s_train_step.npz: loss {metrics['train_loss']:.6f}"
          f" rel err {loss_err:.3e} <= {STEP_LOSS_RTOL}; {n_norms} gradient "
          f"norms max rel err {norm_err:.3e} <= {STEP_NORM_TOL[0]}; "
          f"{sum(k.startswith('grad:') for k in golden.files)} small gradients"
          f" max rel err {grad_err:.3e} <= {STEP_GRAD_RTOL}; post-step logits "
          f"max_abs_err {logit_err:.3e} <= {STEP_LOGIT_TOL}; launches K3a "
          f"+{grew[1]} K3b +{grew[2]}", flush=True)
    del net, state, grads


def _recipe(dev, preset, batch, seed, overrides=()):
    """The pre-training recipe of ``preset`` (with dotted ``overrides``) at
    full width: the model (bf16 compute over fp32 parameters), its AdamW
    state, the step and a batch of random mel input on the card."""
    from maest_tpu_torch.configs import build_experiment_config
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.train import (
        TrainState,
        augment_config,
        make_optimizer,
        make_schedule,
        make_train_step,
        model_config,
    )

    cfg = build_experiment_config([preset], ["maest.pretrained=False",
                                             *overrides])
    mcfg = model_config(cfg)
    opt = cfg["module"]["optimizer"]
    steps_per_epoch = cfg["datamodule"]["sampler"]["epoch_len"] // batch
    schedule = make_schedule(
        opt["schedule_mode"], opt["lr"], steps_per_epoch,
        warm_up_len=opt["warm_up_len"], ramp_down_start=opt["ramp_down_start"],
        ramp_down_len=opt["ramp_down_len"], last_lr_value=opt["last_lr_value"],
        do_swa=cfg["module"]["do_swa"],
        swa_epoch_start=cfg["module"]["swa_epoch_start"],
        swa_lr=cfg["module"]["swa_lrs"])
    net = MAESTNet(mcfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                   device=dev, generator=torch.Generator().manual_seed(seed))
    tx = make_optimizer(lr_schedule=schedule, adamw=opt["adamw"],
                        weight_decay=opt["weight_decay"])
    state = TrainState.create(net, tx, with_swa=cfg["module"]["do_swa"])
    teacher = cfg["datamodule"]["teacher_student"]["do"]
    step = make_train_step(net, tx, augment_config(cfg),
                           teacher_student=teacher)
    rng = np.random.default_rng(seed)
    f, t = mcfg.img_size
    data = {"x": torch.from_numpy(rng.standard_normal((batch, f, t)).astype(
        np.float32) * 1.3 + 2.0).to(dev),
        "y": torch.from_numpy((rng.random((batch, 400)) < 0.05).astype(
            np.float32)).to(dev)}
    if teacher:
        data["y_teacher"] = torch.from_numpy(rng.random((batch, 400)).astype(
            np.float32)).to(dev)
    return cfg, mcfg, net, state, step, data


def phase_recipe(dev):
    """Phase 11: the 30 s pre-training recipe step (ViT-B, batch 32, s
    patchout t 90: N 866, bf16 over fp32 parameters, SpecAugment and
    mixup on) with the launch counters reset: 12 K3a and 12 K3b a step, a
    finite loss, moving parameters; then swa_update, an eval step over the
    live and SWA weights, and one teacher-student step (batch 4)."""
    from maest_tpu_torch.ops.attention import (
        attention_bwd,
        flash_attention,
        flash_attention_fwd_lse,
    )
    from maest_tpu_torch.train import make_eval_step, swa_update

    cfg, mcfg, net, state, step, data = _recipe(dev, RECIPE, BATCH, 0)
    start = {k: p.detach().clone() for k, p in net.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    steps = 3
    flash_attention.launches = 0
    flash_attention_fwd_lse.launches = 0
    attention_bwd.launches = 0
    per_step, losses = [], []
    for _ in range(steps):
        before = _launch_counts()
        state, metrics = step(state, data, gen)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        losses.append(metrics["train_loss"])
        check(metrics["nonfinite_skipped"] == 0.0, "recipe step skipped")
    torch.cuda.synchronize()
    launches = {"fwd_lse": flash_attention_fwd_lse.launches,
                "bwd": attention_bwd.launches}
    check(all(c == [0, mcfg.depth, mcfg.depth] for c in per_step),
          f"recipe launches per step {per_step}")
    check(all(np.isfinite(losses)), f"recipe losses {losses}")
    moved = [k for k, p in net.named_parameters()
             if not torch.equal(p.detach(), start[k])]
    # under distilled_type "mean" the loss never reaches head_dist
    idle = ({"head_dist.weight", "head_dist.bias"}
            if mcfg.distilled_type == "mean" else set())
    check(set(start) - set(moved) == idle,
          f"parameters that did not move: {sorted(set(start) - set(moved))}")
    check(state.step == steps and state.count == steps, "recipe counters")

    # remat at full depth: full and dots recompute each block, attention
    # included (2 K3a a layer); attn_out keeps o and lse (1 a layer)
    remat = {}
    for policy, fwd in (("full", 2), ("dots", 2), ("attn_out", 1)):
        net.cfg = dataclasses.replace(mcfg, remat=True, remat_policy=policy)
        before = _launch_counts()
        state, metrics = step(state, data, gen)
        remat[policy] = [a - b for a, b in zip(_launch_counts(), before)]
        check(remat[policy] == [0, fwd * mcfg.depth, mcfg.depth]
              and np.isfinite(metrics["train_loss"])
              and metrics["nonfinite_skipped"] == 0.0,
              f"remat {policy}: launches {remat[policy]}, {metrics}")
    net.cfg = mcfg

    swa_update(state)
    swa_update(state)  # the mean of the last two states
    out = make_eval_step(net)(state, data["x"])
    check(set(out) == {"", "swa"} and all(
        o.shape == (BATCH, 400) and bool(torch.isfinite(o).all())
        for o in out.values()), "eval step")
    check(state.swa_n == 2, "swa_n")
    print(f"phase 11 recipe step: {RECIPE} ViT-B batch {BATCH} N "
          f"{9 * (186 - mcfg.s_patchout_t) + 2} bf16 over fp32 parameters, "
          f"{steps} steps: losses {[round(v, 6) for v in losses]}, "
          f"nonfinite_skipped 0, {len(moved)}/{len(start)} parameters moved; "
          f"launches per step (K2, K3a, K3b) {per_step}, one step under "
          f"each remat policy {remat}; swa_update x2 + eval step live/SWA "
          f"logits {tuple(out[''].shape)} finite", flush=True)
    del net, state, step, data, start, out
    torch.cuda.empty_cache()

    ts = "maest_30s_from_passt_teacher_student_pretrain"
    cfg, mcfg, net, state, step, data = _recipe(dev, ts, 4, 1)
    b = cfg["datamodule"]["batch_size_train"]
    check(b == 4 and mcfg.distilled_type == "separated", "TS preset")
    # the heads start at zero, which gives both losses ln 2 whatever the
    # rest computes: draw them, so each loss reads its own head
    heads = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for lin in (net.head[1], net.head_dist):
            lin.weight.normal_(0.0, 0.05, generator=heads)
    state, metrics = step(state, data, torch.Generator().manual_seed(1))
    parts = ("train_loss", "train_loss_standard", "train_loss_teacher")
    check(metrics["nonfinite_skipped"] == 0.0 and all(
        np.isfinite(metrics[k]) for k in parts), "TS step")
    check(abs(metrics["train_loss_standard"] - metrics["train_loss_teacher"])
          > 1e-3 and all(abs(metrics[k] - np.log(2)) > 1e-3 for k in parts),
          f"TS losses not apart from each other and from ln 2: {metrics}")
    check(abs(metrics["train_loss"] - (metrics["train_loss_standard"]
                                       + metrics["train_loss_teacher"]) / 2)
          <= 1e-6, "TS loss is the mean of its parts")
    print(f"phase 11 teacher-student step: {ts} batch {b}: "
          + ", ".join(f"{k} {metrics[k]:.6f}" for k in sorted(metrics)),
          flush=True)
    del net, state, step, data
    torch.cuda.empty_cache()
    return launches


def phase_train_times(dev, gpu):
    """Phase 12: K3a and the backward against their plain versions at the
    recipe's (32, 866, 12, 64) and at K4's regime (2, 4500, 12, 64), bf16,
    and the recipe step at both bench_train.py shapes, all with CUDA events
    after warm-up; the launch counters are reset before each recipe shape's
    steps, which must launch K3a and K3b once a layer each."""
    from maest_tpu_torch.ops.attention import (
        attention_bwd,
        attention_bwd_reference,
        attention_reference_lse,
        flash_attention,
        flash_attention_fwd_lse,
    )

    rng = np.random.default_rng(4)
    t = {}
    # the recipe's shape, and K4's regime (N 4500 > the TPU's 4096 switch)
    for b, n, n_real, tag in ((BATCH, 866, None, ""), (2, 4500, 4400, "_k4")):
        qkv = torch.from_numpy(rng.standard_normal(
            (b, n, 3, 12, 64)).astype(np.float32)).to(dev, torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        g = torch.randn((b, n, 12, 64), device=dev, dtype=torch.bfloat16)
        o, lse = flash_attention_fwd_lse(q, k, v, n_real)
        t["fwd_lse" + tag] = (
            cuda_ms(lambda: flash_attention_fwd_lse(q, k, v, n_real), 10),
            cuda_ms(lambda: attention_reference_lse(q, k, v, n_real), 5))
        t["bwd" + tag] = (
            cuda_ms(lambda: attention_bwd(q, k, v, o, lse, g, n_real), 10),
            cuda_ms(lambda: attention_bwd_reference(q, k, v, o, lse, g,
                                                    n_real), 5))
        for name, what in (("fwd_lse", "K3a forward+lse"),
                           ("bwd", "K4 backward" if tag else "K3b backward")):
            print(f"phase 12 time {what} ({b}, {n}, 12, 64) n_real {n_real} "
                  f"bf16: kernel {t[name + tag][0]:.4f} ms, plain "
                  f"{t[name + tag][1]:.4f} ms [{gpu}]", flush=True)
        del qkv, q, k, v, g, o, lse
        torch.cuda.empty_cache()

    for preset, batch in ((RECIPE, BATCH), ("maest_10s_from_passt_pretrain",
                                            100)):
        cfg, mcfg, net, state, step, data = _recipe(dev, preset, batch, 2)
        gen = torch.Generator().manual_seed(2)
        per_step, losses = [], []

        def one_step():
            before = _launch_counts()
            _, metrics = step(state, data, gen)
            per_step.append([a - b for a, b in zip(_launch_counts(), before)])
            losses.append(metrics["train_loss"]
                          if metrics["nonfinite_skipped"] == 0.0 else None)

        flash_attention.launches = 0
        flash_attention_fwd_lse.launches = 0
        attention_bwd.launches = 0
        ms = cuda_ms(one_step, 5)
        check(all(c == [0, mcfg.depth, mcfg.depth] for c in per_step),
              f"{preset} launches per step {per_step}")
        check(all(v is not None and np.isfinite(v) for v in losses),
              f"{preset} losses {losses}")
        n = 9 * ((mcfg.img_size[1] - 16) // 10 + 1 - mcfg.s_patchout_t) + 2
        t[preset] = (ms, batch / (ms / 1e3))
        print(f"phase 12 time recipe step {preset}: batch {batch}, s patchout "
              f"t {mcfg.s_patchout_t}, N {n}, bf16 over fp32 parameters, "
              f"AdamW + SWA + SpecAugment + mixup: {ms:.3f} ms/step = "
              f"{t[preset][1]:.1f} specs/s [{gpu}]; {len(per_step)} steps, "
              f"each with launches (K2, K3a, K3b) {per_step[0]}, finite loss",
              flush=True)
        del net, state, step, data
        torch.cuda.empty_cache()
    return t


def _q8_counts():
    from maest_tpu_torch.ops.attention import (
        attention_bwd,
        attention_bwd_int8,
        attention_fwd_fp8,
        attention_fwd_int8,
        flash_attention,
        flash_attention_fwd_lse,
    )
    fns = (flash_attention, flash_attention_fwd_lse, attention_bwd,
           attention_fwd_int8, attention_fwd_fp8, attention_bwd_int8)
    return fns, [f.launches for f in fns]


def _reset_counts():
    for f in _q8_counts()[0]:
        f.launches = 0


def phase_q8_kernels(dev, gpu):
    """Phase 13: K5 (qk8, qk8pv8) and K6 (fp8, fp8pv8) against their plain
    versions on the same 64-key tiles, with and without lse, at the tagging
    shape, the 30 s recipe's (32, 866) (K5 with lse on the qk8 training
    path) and (2, 300) with n_real 290. The bound is Q8_ULPS bf16 ulps of
    the largest |o|, and each mode's kernel must miss every other mode's
    plain version by more than it: the check tells the modes' arithmetic
    apart. An e4m3 overflow case; times at the tagging shape: the wrapper
    (PyTorch quantization + kernel) and the plain version with CUDA events,
    the kernel alone from torch.profiler."""
    from maest_tpu_torch.ops import attention as A

    rng = np.random.default_rng(5)
    err = {"int8": 0.0, "fp8": 0.0}
    times = {}
    for b, n, n_real in ((BATCH, 1676, None), (BATCH, 866, None),
                         (2, 300, 290)):
        qkv = torch.from_numpy(rng.standard_normal(
            (b, n, 3, 12, 64)).astype(np.float32)).to(dev, torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        plain = {m: A.attention_q8_reference(q, k, v, n_real, m)
                 for m in Q8_MODES}
        for mode in Q8_MODES:
            kind = "int8" if mode.startswith("qk8") else "fp8"
            wrap = getattr(A, f"attention_fwd_{kind}")
            pv8 = mode.endswith("pv8")
            before = wrap.launches
            o, none = wrap(q, k, v, n_real, pv8)
            o2, lse = wrap(q, k, v, n_real, pv8, with_lse=True)
            ro, rlse = plain[mode]
            torch.cuda.synchronize()
            check(wrap.launches == before + 2 and none is None,
                  f"{mode} counter")
            tol = Q8_ULPS * bf16_ulp(ro.float().abs().max().item())
            e = max(max_err(o, ro), max_err(o2, ro))
            el = max_err(lse, rlse)
            other, apart = min(((m, max_err(o, plain[m][0]))
                                for m in Q8_MODES if m != mode),
                               key=lambda x: x[1])
            check(e <= tol and el <= LSE_TOL,
                  f"{mode} ({b}, {n}) err o {e} (bound {tol}) lse {el}")
            check(apart > tol, f"{mode} ({b}, {n}) kernel within {apart} of "
                  f"{other}'s plain version: the bound {tol} cannot tell them "
                  "apart")
            err[kind] = max(err[kind], e, el)
            line = (f"phase 13 {'K5' if kind == 'int8' else 'K6'} {mode}: "
                    f"({b}, {n}, 12, 64) n_real {n_real} bf16 max_abs_err o "
                    f"{e:.3e} <= {tol:.3e} ({Q8_ULPS} bf16 ulps of max|o|), "
                    f"lse {el:.3e} <= {LSE_TOL}; vs the nearest other mode's "
                    f"plain version ({other}) {apart:.3e} > {tol:.3e}")
            if n == 1676:
                times[mode] = (
                    cuda_ms(lambda: wrap(q, k, v, n_real, pv8), 5),
                    cuda_ms(lambda: A.attention_q8_reference(
                        q, k, v, n_real, mode), 3))
                alone = _kernel_ms(lambda: wrap(q, k, v, n_real, pv8),
                                   "attn_fwd_q8_kernel")
                line += (f"; time: kernel with its quantization "
                         f"{times[mode][0]:.4f} ms, plain {times[mode][1]:.4f}"
                         f" ms, kernel alone (torch.profiler) "
                         f"{_fmt_ms(alone)} [{gpu}]")
            print(line, flush=True)
            del o, o2, lse
        del qkv, q, k, v, plain
        torch.cuda.empty_cache()

    # e4m3 overflow: |x| past 464 is NaN, as the JAX package casts
    qkv = torch.from_numpy(rng.standard_normal((1, 130, 3, 2, 64)).astype(
        np.float32)).to(dev, torch.bfloat16)
    qkv[0, 5, 0, 0, 3] = 470.0    # q: row 5 of head 0
    qkv[0, 9, 1, 1, 7] = -600.0   # k: key 9 of head 1, every row of it
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    for mode in ("fp8", "fp8pv8"):
        o, _ = A.attention_fwd_fp8(q, k, v, None, mode == "fp8pv8")
        ro, _ = A.attention_q8_reference(q, k, v, None, mode)
        nan = torch.isnan(o)
        check(torch.equal(nan, torch.isnan(ro)) and bool(nan[0, 5, 0].all())
              and bool(nan[:, :, 1].all()) and not bool(nan[0, 6, 0].any()),
              f"{mode} overflow NaN pattern")
        tol = Q8_ULPS * bf16_ulp(ro[~nan].float().abs().max().item())
        check(max_err(o[~nan], ro[~nan]) <= tol, f"{mode} overflow err")
    print("phase 13 K6 e4m3 overflow: q 470 and k -600 give NaN in the rows "
          "they reach, as the plain version (and the JAX package's cast) "
          f"does, and values within {Q8_ULPS} bf16 ulps elsewhere", flush=True)
    return {"err_int8": err["int8"], "err_fp8": err["fp8"],
            "qk8": times["qk8"], "fp8": times["fp8"]}


def phase_q8_tagging(dev, sd, gpu):
    """Phase 14: the tagging path in each 8-bit mode: get_maest with
    attention_quant on phase 5's weights, bf16, predict_labels on 32 clips
    of 30 s with the counters reset; 12 launches of the mode's kernel and
    none of K2; activations within TIER_TOL of the unquantized bf16
    model's; the batch-32 step time."""
    from maest_tpu_torch import get_maest
    from maest_tpu_torch.serve import BucketPrograms

    rng = np.random.default_rng(6)
    waves = rng.standard_normal((BATCH, CLIP)).astype(np.float32) * 0.1
    waves_dev = torch.from_numpy(waves).to(dev)
    launches = {"int8": 0, "fp8": 0}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "random-vitb.pt")
        torch.save(sd, ckpt)
        kw = dict(pretrained=False, checkpoint=ckpt, device=dev,
                  dtype=torch.bfloat16)
        def per_clip(model):  # (32, 400) sigmoid activations
            with torch.inference_mode():
                return torch.sigmoid(model(waves)[0].float()).cpu().numpy()

        ref = per_clip(get_maest(ARCH, **kw))
        for mode in Q8_MODES:
            model = get_maest(ARCH, attention_quant=mode, **kw)
            _reset_counts()
            acts = model.predict_labels(waves)[0]
            torch.cuda.synchronize()
            fns, counts = _q8_counts()
            kind = "int8" if mode.startswith("qk8") else "fp8"
            want = [0, 0, 0, 12 if kind == "int8" else 0,
                    12 if kind == "fp8" else 0, 0]
            check(counts == want, f"{mode} tagging launches {counts}")
            launches[kind] += counts[3] + counts[4]
            clips = per_clip(model)
            err = float(np.abs(clips - ref).max())
            check(acts.shape == (400,) and bool(np.isfinite(clips).all())
                  and np.allclose(acts, clips.mean(0), rtol=0, atol=1e-6)
                  and err <= TIER_TOL, f"{mode} activations err {err}")
            prog = BucketPrograms(model, buckets=(BATCH,), fused_wave=True)
            with torch.inference_mode():
                step = cuda_ms(lambda: prog._activations(waves_dev), 3)
            print(f"phase 14 tagging {mode}: get_maest(attention_quant="
                  f"{mode!r}) bf16 predict_labels on {BATCH} clips of 30 s: "
                  f"launches {'K5' if kind == 'int8' else 'K6'} "
                  f"{counts[3] + counts[4]}, K2 {counts[0]}; per-clip "
                  f"activations vs the unquantized bf16 model max_abs_err "
                  f"{err:.3e} <= "
                  f"{TIER_TOL}; batch-{BATCH} step {step:.3f} ms = "
                  f"{BATCH * 30 / (step / 1e3):.1f} audio-s/s [{gpu}]",
                  flush=True)
            del model, prog
            torch.cuda.empty_cache()
    return launches


def phase_k7_kernel(dev, gpu):
    """Phase 15: K7 against its plain version on the same saved tensors at
    the 30 s recipe's (32, 866), padded (32, 896) with n_real 866, the 10 s
    recipe's (100, 281), and (2, 1800) with n_real 1790 (three 640-row
    q-blocks of scales), q, k and v drawn normal x 1; masked keys get zero
    dk/dv. Then at (32, 866) with q, k and v drawn as the JAX package's
    tests draw them (normal x 0.5): K7 against its plain version, against
    the bf16 backward (K3b) within the JAX package's bounds, which were set
    on that draw (the int8 gradients' distance from the bf16 ones grows
    with the spread of the scores, as p and ds share one scale per (head,
    q-block): at normal x 1 the cosine is ~0.99), and the times."""
    from maest_tpu_torch.ops import attention as A

    rng = np.random.default_rng(7)
    worst, out = 0.0, {}
    for b, n, n_real, scale in ((BATCH, 866, None, 1.0),
                                (BATCH, 896, 866, 1.0),
                                (100, 281, None, 1.0),
                                (2, 1800, 1790, 1.0),
                                (BATCH, 866, None, 0.5)):
        qkv = torch.from_numpy(rng.standard_normal(
            (b, n, 3, 12, 64)).astype(np.float32) * scale).to(
            dev, torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        g = torch.from_numpy(rng.standard_normal(
            (b, n, 12, 64)).astype(np.float32)).to(dev, torch.bfloat16)
        o, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
        before = A.attention_bwd_int8.launches
        got = A.attention_bwd_int8(q, k, v, o, lse, g, n_real)
        ref = A.attention_bwd_int8_reference(q, k, v, o, lse, g, n_real)
        torch.cuda.synchronize()
        check(A.attention_bwd_int8.launches == before + 1, "K7 counter")
        parts = []
        for w, a, r in zip(("dq", "dk", "dv"), got, ref):
            e = max_err(a, r)
            top = r.float().abs().max().item()
            cos = cosine(a, r)
            check(e <= K7_TOL * top and cos >= K7_COS,
                  f"K7 {w} ({b}, {n}) x{scale} err {e} of max {top}, "
                  f"cos {cos}")
            worst = max(worst, e)
            parts.append(f"{w} {e:.3e} ({e / top:.2e} of max, cos {cos:.6f})")
        if n_real is not None:
            check(not got[1][:, n_real:].any() and not got[2][:, n_real:].any(),
                  "K7 masked dk/dv")
        line = (f"phase 15 K7 int8 backward: ({b}, {n}, 12, 64) n_real "
                f"{n_real} q, k, v normal x {scale} q-block "
                f"{A.bwd_q_block(n)} max_abs_err " + ", ".join(parts)
                + f" <= {K7_TOL} of max, cos >= {K7_COS}")
        if scale == 0.5:
            bf = A.attention_bwd(q, k, v, o, lse, g, n_real)
            vs = []
            for w, a, r in zip(("dq", "dk", "dv"), got, bf):
                a, r = a.float(), r.float()
                cos = cosine(a, r)
                rel = ((a - r).abs().max() / r.abs().max()).item()
                check(cos > 0.999 and rel < 0.15,
                      f"K7 vs K3b {w}: cos {cos} relmax {rel}")
                vs.append(f"{w} cos {cos:.5f} relmax {rel:.3f}")
            out["ms"] = (
                cuda_ms(lambda: A.attention_bwd_int8(q, k, v, o, lse, g), 10),
                cuda_ms(lambda: A.attention_bwd_int8_reference(
                    q, k, v, o, lse, g), 3))
            k3b = cuda_ms(lambda: A.attention_bwd(q, k, v, o, lse, g), 10)
            parts = _kernel_ms(
                lambda: A.attention_bwd_int8(q, k, v, o, lse, g), "bwd_q8_")
            line += ("; vs the bf16 backward (K3b): " + ", ".join(vs)
                     + " (cos > 0.999, relmax < 0.15); time: kernel "
                     f"{out['ms'][0]:.4f} ms, plain {out['ms'][1]:.4f} ms, "
                     f"K3b {k3b:.4f} ms [{gpu}]; K7's launches by device "
                     f"time: {_fmt_ms(parts)}")
            del bf
        print(line, flush=True)
        del qkv, q, k, v, g, o, lse, got, ref
        torch.cuda.empty_cache()
    out["err"] = worst
    return out


def _kernel_ms(fn, prefix: str) -> dict:
    """Device ms of each kernel whose name holds ``prefix`` in one call of
    ``fn``, from torch.profiler; empty where it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        name = re.search(prefix + r"\w*(<\w+>)?", e.key)
        if name:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            rows[name.group(0)] = rows.get(name.group(0), 0.0) + us / 1e3
    return rows


def _fmt_ms(rows: dict) -> str:
    return (", ".join(f"{k} {v:.4f} ms" for k, v in rows.items())
            or "not measured (no device events)")


def phase_int8_recipe(dev, gpu):
    """Phase 16: the 30 s recipe step (B32, N 866) with
    attention_bwd_quant="int8": five steps timed one by one (their median:
    a single step's host work spreads), with the counters reset,
    each launching 12 K3a, 12 K7 and no K3b, with a finite loss; then one
    step with attention_quant="qk8" (12 K5 with lse, 12 K3b) and one with
    both options (12 K5 with lse, 12 K7)."""
    runs = (("int8", ["maest.attention_bwd_quant=int8"], [0, 12, 0, 0, 0, 12]),
            ("qk8", ["maest.attention_quant=qk8"], [0, 0, 12, 12, 0, 0]),
            ("qk8+int8", ["maest.attention_quant=qk8",
                          "maest.attention_bwd_quant=int8"],
             [0, 0, 0, 12, 0, 12]))
    k7 = 0
    for name, over, want in runs:
        cfg, mcfg, net, state, step, data = _recipe(dev, RECIPE, BATCH, 3, over)
        gen = torch.Generator().manual_seed(3)
        per_step, losses = [], []

        def one_step():
            before = _q8_counts()[1]
            _, metrics = step(state, data, gen)
            per_step.append([a - b for a, b in zip(_q8_counts()[1], before)])
            losses.append(metrics["train_loss"]
                          if metrics["nonfinite_skipped"] == 0.0 else None)

        _reset_counts()
        if name == "int8":  # one warm-up step, five timed one by one
            one_step()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                one_step()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms = float(np.median(times))
            k7 = _q8_counts()[1][5]
        else:
            one_step()
            torch.cuda.synchronize()
        check(all(c == want for c in per_step),
              f"{name} recipe launches per step {per_step}")
        check(all(v is not None and np.isfinite(v) for v in losses),
              f"{name} recipe losses {losses}")
        line = (f"phase 16 recipe step {RECIPE} batch {BATCH} N 866 with "
                f"{', '.join(over)}: {len(per_step)} steps, launches (K2, K3a,"
                f" K3b, K5, K6, K7) {per_step[0]} each, losses "
                f"{[round(v, 6) for v in losses]}")
        if name == "int8":
            line += (f"; median {ms:.3f} ms/step = {BATCH / (ms / 1e3):.1f} "
                     f"specs/s (steps {[round(x, 3) for x in times]} ms) "
                     f"[{gpu}]")
        print(line, flush=True)
        del net, state, step, data
        torch.cuda.empty_cache()
    return k7


def phase_library(dev, gpu):
    """Phase 17: one PyTorch call that computes what K2, K3a, K3b and K4
    compute, on the same shapes, timed as a yardstick (the port never calls
    them): scaled_dot_product_attention on its flash backend (K2), the
    flash forward that also returns the log-sum-exp (K3a), and SDPA's
    backward through autograd, its forward time subtracted (K3b; K4 at
    (2, 4400) over the real keys of its (2, 4500) n_real 4400 regime: the
    flash backend takes no key mask). Each is the median of three timed
    runs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rng = np.random.default_rng(8)
    out = {}
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        for b, n, key in ((BATCH, 1676, "fwd"), (BATCH, 866, "bwd"),
                          (2, 4400, "bwd_k4")):
            x = torch.from_numpy(rng.standard_normal(
                (b, n, 3, 12, 64)).astype(np.float32)).to(
                dev, torch.bfloat16)
            q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
            if key == "fwd":
                out["fwd"] = cuda_ms_median(
                    lambda: F.scaled_dot_product_attention(q, k, v), 10)
                del x, q, k, v
                continue
            if key == "bwd":
                out["fwd_lse"] = cuda_ms_median(
                    lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                        q, k, v), 10)
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            g = torch.randn_like(qg)

            def fwd_bwd():
                F.scaled_dot_product_attention(qg, kg, vg).backward(g)

            fwd = cuda_ms_median(
                lambda: F.scaled_dot_product_attention(qg, kg, vg), 10)
            out[key] = cuda_ms_median(fwd_bwd, 10) - fwd
            del x, q, k, v, qg, kg, vg, g
    torch.cuda.empty_cache()
    print(f"phase 17 library yardsticks (bf16, flash backend, never called "
          f"by the port): scaled_dot_product_attention ({BATCH}, 1676, 12, "
          f"64) {out['fwd']:.4f} ms (beside K2); _scaled_dot_product_flash_"
          f"attention with its log-sum-exp ({BATCH}, 866) {out['fwd_lse']:.4f}"
          f" ms (beside K3a); its backward through autograd, forward "
          f"subtracted, {out['bwd']:.4f} ms (beside K3b) and at (2, 4400) "
          f"{out['bwd_k4']:.4f} ms (beside K4 at (2, 4500) n_real 4400) "
          f"[{gpu}]", flush=True)
    return out


def phase_probe_kernels(dev):
    """Phase 18: the four probe kernels (P6a-d) against their plain
    versions on the same 64-key tiles, N(0, 1) inputs, at (2, 1676),
    (2, 866), (3, 100) and the rig's (32, 1676) and (32, 866): within
    PROBE_ULPS bf16
    ulps of the largest |o| (mxu_only: of its own, ~250). noexp_max and
    bf16s compute softmax attention: within PROBE_VS_K2 of K2's output at
    the first three shapes; novmax is another function, farther than that
    at (2, 1676). Returns each variant's max_abs_err and its plain
    version's ms at (32, 1676)."""
    from maest_tpu_torch.ops.attention import flash_attention
    from maest_tpu_torch.ops.attention_probe import (
        VARIANTS,
        attention_probe,
        attention_probe_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(9)
    err, plain = {}, {}
    for b, n in ((2, 1676), (2, 866), (3, 100), (BATCH, 1676),
                 (BATCH, 866)):
        qkv = torch.randn((b, n, 3, 12, 64), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        k2 = flash_attention(q, k, v)
        top_k2 = k2.float().abs().max().item()
        parts = []
        for var in VARIANTS:
            before = attention_probe.launches[var]
            o = attention_probe(q, k, v, var)
            r = attention_probe_reference(q, k, v, var)
            torch.cuda.synchronize()
            check(attention_probe.launches[var] == before + 1,
                  f"{var} counter")
            tol = PROBE_ULPS * bf16_ulp(r.float().abs().max().item())
            e = max_err(o, r)
            check(e <= tol, f"{var} ({b}, {n}) err {e} > {tol}")
            d = max_err(o, k2)
            part = f"{var} {e:.3e} <= {tol:.3e}, vs K2 {d:.3e}"
            if b != BATCH and var in ("noexp_max", "bf16s"):
                bound = PROBE_VS_K2 * max(1.0, top_k2)
                check(d <= bound, f"{var} ({b}, {n}) vs K2 {d} > {bound}")
                part += f" <= {bound:.3e}"
            if (b, n) == (2, 1676) and var == "novmax":
                check(d > PROBE_VS_K2, f"novmax within {d} of K2")
                part += f" > {PROBE_VS_K2}"
            if (b, n) == (BATCH, 1676):
                err[var] = e
                plain[var] = cuda_ms(
                    lambda: attention_probe_reference(q, k, v, var), 3)
            parts.append(part)
            del o, r
        print(f"phase 18 P6a-d probe kernels ({b}, {n}, 12, 64) bf16 "
              f"max_abs_err vs plain ({PROBE_ULPS} bf16 ulps of max|o|): "
              + "; ".join(parts), flush=True)
        del qkv, q, k, v, k2
        torch.cuda.empty_cache()
    return err, plain


def phase_probe_rig():
    """Phase 19: the slice's path, the decomposition rig as a user runs it
    (``python -m maest_tpu_torch.probes.attn_profile --shapes
    30s,30s-train --batch 32``, here its ``main`` in process; it prints
    the card's name and power limit first), with the launch counters of
    K2 and the probes set to 0 just before and read just after: each
    kernel must have run (a CUDA graph's replays are launches the counters
    do not see: they count the captured calls), every variant but plain
    must have a graph time, and bf16s's kernel alone and its pre-scaling
    pass must each take less than the two together.
    Returns {shape: {variant: times}} and the launches."""
    from maest_tpu_torch.ops.attention import flash_attention
    from maest_tpu_torch.ops.attention_probe import attention_probe
    from maest_tpu_torch.probes import attn_profile

    print("phase 19 decomposition rig: python -m "
          "maest_tpu_torch.probes.attn_profile --shapes 30s,30s-train "
          f"--batch {BATCH}", flush=True)
    flash_attention.launches = 0
    for var in attention_probe.launches:
        attention_probe.launches[var] = 0
    times = attn_profile.main(["--shapes", "30s,30s-train", "--batch",
                               str(BATCH)])
    launches = {"flash": flash_attention.launches, **attention_probe.launches}
    check(all(launches.values()), f"rig launches {launches}")
    for rows in times.values():
        check(all(r["graph_ms"] > 0 for v, r in rows.items() if v != "plain"),
              f"rig graph times {rows}")
        bf = rows["bf16s"]
        check(0 < bf["kernel_ms"] < bf["ms"] and 0 < bf["pass_ms"] < bf["ms"],
              f"bf16s split {bf}")
    print(f"phase 19 launches in the rig's run: {launches}", flush=True)
    return times, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "maest_tpu_torch").is_dir():
        print("chip_smoke: run from the root of a maest-tpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "tests"))  # torch_oracle.make_state
    from maest_tpu_torch.ops import _build

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    gpu = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {gpu}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {kind}; fp32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}", flush=True)

    def timed_build(lib):
        t = time.perf_counter()
        log = _build.build(lib)[1]
        return log, time.perf_counter() - t

    t0 = time.perf_counter()
    libs = ("mel_kernel", "attention_fwd", "attention_bwd", "attention_fwd_q8",
            "attention_bwd_q8", "attention_probe")
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source
        built = dict(zip(libs, pool.map(timed_build, libs)))
    wall = time.perf_counter() - t0
    for lib in libs:
        _build.load_library(lib)
    # ptxas's spill line, then its register line, for each kernel
    regs = [line.split(":")[-1].strip()
            for log, _ in built.values()
            for line in log.splitlines()
            if "registers" in line or "spill" in line]
    print(f"phase 2 build: {wall:.1f} s with nvcc sm_90a into "
          f"build/maest_tpu_torch, one nvcc per source at once ("
          + ", ".join(f"{lib} {s:.1f} s" for lib, (_, s) in built.items())
          + f"); ptxas {regs}", flush=True)

    mel_err, attn_err = phase_kernels_vs_plain(dev)
    sd = phase_golden(dev)
    with tempfile.TemporaryDirectory() as tmp:
        model, launches, inputs = phase_main_path(dev, sd, tmp)
    phase_server(model, inputs)
    t = phase_times(dev, model, gpu)
    del model
    torch.cuda.empty_cache()
    train_err, k4_err = phase_train_kernels(dev)
    phase_golden_step(dev)
    train_launches = phase_recipe(dev)
    tt = phase_train_times(dev, gpu)

    q8 = phase_q8_kernels(dev, gpu)
    q8_launches = phase_q8_tagging(dev, sd, gpu)
    k7 = phase_k7_kernel(dev, gpu)
    k7_launches = phase_int8_recipe(dev, gpu)
    lib = phase_library(dev, gpu)
    probe_err, probe_plain = phase_probe_kernels(dev)
    rig, rig_launches = phase_probe_rig()

    frames = BATCH * 1876  # frames of 32 clips of 30 s
    mel_ops = frames * (512 + 4 * 512 * 257 + 3 * 257 + 2 * 257 * 96 + 96)
    bounds = {
        "mel": bound(frames * (512 + 96) * 4, {"fp32": mel_ops}),
        "fwd": attn_bound(BATCH, 1676, 12),
        "fwd_lse": attn_bound(BATCH, 866, 12, lse=True),
        "bwd": bwd_bound(BATCH, 866, 12),
        "qk8": attn_bound(BATCH, 1676, 12, qk="int8"),
        "fp8": attn_bound(BATCH, 1676, 12, qk="fp8"),
        "k7": bwd_bound(BATCH, 866, 12, kind="int8"),
        "k4": bwd_bound(2, 4500, 12, 4400),
    }
    src = "maest_tpu_torch/csrc/"
    rows = [
        ("fused_logmel", "mel_kernel.cu", "maest_tpu/ops/mel_kernel.py:39",
         launches["mel"], mel_err, t["mel"], "mel", None),
        ("attention_fwd", "attention_fwd.cu", "maest_tpu/ops/attention.py:176",
         launches["attention"], attn_err, t["bfloat16"], "fwd", lib["fwd"]),
        ("attention_fwd_lse", "attention_fwd.cu",
         "maest_tpu/ops/attention.py:404", train_launches["fwd_lse"],
         max(train_err["o"], train_err["lse"]), tt["fwd_lse"], "fwd_lse",
         lib["fwd_lse"]),
        ("attention_bwd", "attention_bwd.cu", "maest_tpu/ops/attention.py:483",
         train_launches["bwd"], max(train_err[w] for w in ("dq", "dk", "dv")),
         tt["bwd"], "bwd", lib["bwd"]),
        ("attention_fwd_int8", "attention_fwd_q8.cu",
         "maest_tpu/ops/attention.py:140", q8_launches["int8"], q8["err_int8"],
         q8["qk8"], "qk8", None),
        ("attention_fwd_fp8", "attention_fwd_q8.cu",
         "maest_tpu/ops/attention.py:390", q8_launches["fp8"], q8["err_fp8"],
         q8["fp8"], "fp8", None),
        ("attention_bwd_int8", "attention_bwd_q8.cu",
         "maest_tpu/ops/attention.py:530", k7_launches, k7["err"], k7["ms"],
         "k7", None),
        ("attention_bwd_split", "attention_bwd.cu",
         "maest_tpu/ops/attention.py:739", 0,
         max(k4_err[w] for w in ("dq", "dk", "dv")), tt["bwd_k4"], "k4",
         lib["bwd_k4"]),
    ]
    # P6a-d: times from phase 19's rig at (32, 1676); SDPA computes what
    # the two softmax variants compute, no PyTorch call the other two
    for var, line in (("mxu_only", 47), ("noexp_max", 63), ("novmax", 88),
                      ("bf16s", 113)):
        rows.append((f"attention_probe_{var}", "attention_probe.cu",
                     f"scripts/attn_profile_r2.py:{line}", rig_launches[var],
                     probe_err[var], (rig["30s"][var]["ms"], probe_plain[var]),
                     "fwd", rig["30s"]["sdpa"]["ms"]
                     if var in ("noexp_max", "bf16s") else None))
    kernels = [{"name": name, "route": "cuda", "source": src + file,
                "replaces": rep, "launches": n, "max_abs_err": err,
                "ms": ms[0], "plain_ms": ms[1], "bound_ms": bounds[key][0],
                "bound_by": bounds[key][1], "library_ms": library}
               for name, file, rep, n, err, ms, key, library in rows]
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
