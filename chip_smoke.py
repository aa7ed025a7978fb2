#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``maest_tpu_torch``) on one card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``maest_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, checks the full-width 30 s
ViT-B fp32 forward against the JAX package's golden logits, drives the main
path (``get_maest(...).predict_labels`` in bf16, and the HTTP server) with
the kernels' launch counters reset, and times the kernels and the batch-32
tagging step with CUDA events. Every phase prints one line; any failure
raises, so the exit code is not 0. The line before the last is the JSON
record of the kernels, the last line the device record. Without torch or a
CUDA card, or outside a checkout, it exits with a non-zero code and prints
no result.

Weights are random, drawn from the golden file's seed; no file is fetched.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
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


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


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

    t0 = time.perf_counter()
    for lib in ("mel_kernel", "attention_fwd"):
        _build.load_library(lib)
    regs = [line.split(":", 1)[1].strip()
            for lib in ("mel_kernel", "attention_fwd")
            for line in _build.build_log[lib].splitlines()
            if "registers" in line]
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s with nvcc "
          f"sm_90a into build/maest_tpu_torch; ptxas {regs}", flush=True)

    mel_err, attn_err = phase_kernels_vs_plain(dev)
    sd = phase_golden(dev)
    with tempfile.TemporaryDirectory() as tmp:
        model, launches, inputs = phase_main_path(dev, sd, tmp)
    phase_server(model, inputs)
    t = phase_times(dev, model, gpu)

    kernels = [
        {"name": "fused_logmel", "route": "cuda",
         "source": "maest_tpu_torch/csrc/mel_kernel.cu",
         "replaces": "maest_tpu/ops/mel_kernel.py:39",
         "launches": launches["mel"], "max_abs_err": mel_err,
         "ms": t["mel"][0], "plain_ms": t["mel"][1]},
        {"name": "attention_fwd", "route": "cuda",
         "source": "maest_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "maest_tpu/ops/attention.py:176",
         "launches": launches["attention"], "max_abs_err": attn_err,
         "ms": t["bfloat16"][0], "plain_ms": t["bfloat16"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
