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
int8 / e4m3 forward (K5, K6; in bf16 at head_dim 64 the wgmma route of
phase 35) against its plain version at the route's key tile in every mode
(phase 13), the tagging path in each mode with the counters reset (14),
the int8 backward (K7) against its plain version and against the bf16
backward (15), the 30 s recipe step with ``attention_bwd_quant="int8"``,
then with ``attention_quant="qk8"`` and with both (16), and the PyTorch
library calls timed as yardsticks beside K2, K3a, K3b and K4 (17). Then
the decomposition rig: its four probe kernels (P6a-c, the variants of K2's
mma.sync loop in ``csrc/attention_probe.cu``; P6d, bf16 scores, on K2's
wgmma kernel, with its mma.sync variant behind the PyTorch pre-scaling
pass as its control) against their plain versions and K2, the wgmma P6d
built with the bf16 rounding of its scores left out refused (18), and
``python -m
maest_tpu_torch.probes.attn_profile`` at both tagging and training shapes,
called in process with the launch counters reset, then P6d, its control,
K2's two kernels and SDPA timed by CUDA-graph replays in interleaved
rounds (19). Then the last rigs' kernels: K2's wgmma kernel with G heads a
block (P6e) bit-equal to K2's wgmma route, its mma.sync control (K2's
mma.sync template with G heads a block) bit-equal to K2's mma.sync
kernel, both within 2 bf16 ulps of their plain versions, the gh kernel
built with each head after a block's first loading the q of the head
before refused, and the int8 rig's kernel (P6f) against its plain
version and, times 127, against attention (20), the five
softmax-arithmetic kinds of ``scripts/attn_vpu_probe.py`` (P5) against
their plain versions and K2 (21), and both rigs, ``attn_profile`` with
``gh<G>``, ``gh<G>_mma``, ``int8`` and three interleaved rounds of
CUDA-graph replays (each gh<G> beside K2's wgmma kernel, each control
beside K2's mma.sync kernel, SDPA beside both; gh8 must beat SDPA and its
control, every G printed beside its wave-count prediction) and ``python
-m maest_tpu_torch.probes.attn_vpu``, called in process with the launch
counters reset (22). Then the routes that close ROADMAP queue 3 on
the card: head_dim 16 and 32 through the kernels on zero-padded inputs,
fp32 under every 8-bit mode (the fp32 instances of K5/K6 and K7), head_dim
96 and 128 through the D = 128 instances of every production kernel in
bf16 and fp32, 192 and 256 through the D = 256 instances, 320 and 512
through the runtime-width (_dn) instances of K2, K3a, K3b, K5/K6 in every
mode and K7 in bf16 and fp32 (and K4's shape at 320) (23); K2 and K3b at
other tiles, the kernels of ``scripts/qpad_probe.py`` (P9) and
``scripts/attn_tune.py`` (P7), against their plain versions at every shape
a phase launches them at and bit-equal to K2's / K3b's mma.sync kernels
where their arithmetic is theirs (24); and both rigs,
``python -m maest_tpu_torch.probes.qpad`` and ``python -m
maest_tpu_torch.probes.attn_tune [--bwd]``, called in process with the
launch counters reset (25). Then the product kernel of
``scripts/mxu_probe.py`` (P1) and ``scripts/fp8_mlp_probe.py`` (P8), on
``wgmma`` fed by TMA, and its mma.sync control, against the plain
versions in every kind, shape and type, with planted faults in the
wgmma kernel's bf16 and e4m3 paths refused (26); both rigs, ``python -m maest_tpu_torch.probes.mxu``
and ``... probes.fp8_mlp``, in process with the counters reset (the wgmma
kernel, the control and the library's product timed by CUDA-graph
replays in interleaved rounds), and
head_dim 128 (and 96, zero-padded), 256 and 384 at full width through the
kernels' D = 128, D = 256 and runtime-width instances:
``get_maest(embed_dim=768, num_heads=6 | 3 | 2)`` tagging against the CPU
and timed at batch 32 (at 2 heads also under ``attention_quant="qk8"``
against bf16), one 30 s recipe step each, K2, K3a, K3b (and at 128 and 384
K7 and the 8-bit forwards) against plain, timed beside the d 64 kernels at
the same flops and SDPA; at head_dim 384 (and 320, 512, 1024 at a small
shape) the bf16 forward's runtime-width kernel on ``wgmma`` and TMA
(``csrc/attn_fwd_dn_wgmma.cuh``) and its mma.sync control against plain
with and without lse, the kernel built with the last K chunk of each key
tile left out of S refused, both timed beside SDPA's efficient attention
by CUDA-graph replays in interleaved rounds, the tagging step with each in
alternating rounds and one recipe step with the control (27). Then the int8
product rigs
``scripts/int8_probe.py`` (P2) and ``scripts/int8_probe2.py`` (P3), every
kind's kernel against its plain version with a planted fault refused, and
both rigs, ``python -m maest_tpu_torch.probes.int8`` and ``...
probes.int8_2``, in process with the counters reset (28). Then this
slice: the backward rig ``scripts/bwd_int8_probe.py`` (P4), its int8 kind
(K7's kernels with the rig's fixed scales), fp8 kind (K3b's mma.sync
kernels on e4m3) and ctrl (K3b, the wgmma backward since phase 31's
slice) against their plain versions at the rig's own shape, planted
faults refused (the int8 kind built with the wrapping ``to_s8`` for ds8;
ctrl's dq zeroed and its lse misplaced), and the rig, ``python -m
maest_tpu_torch.probes.bwd_int8``, in process with the counters reset
(29). Then K2/K3a's kernel on ``wgmma`` and TMA
(``csrc/attn_fwd_wgmma.cuh``, the route of ``flash_attention`` at
head_dim 64 in bf16) against plain and its mma.sync control at the main
path's shapes on strided and contiguous views, every tile configuration
of its sweep against plain, the kernel built with its key mask dropped
refused, then the kernel, the control, SDPA and the sweep timed by
CUDA-graph replays in interleaved rounds, and the tagging and recipe
steps with each kernel in turn (30). Then K3b/K4's kernel on ``wgmma``
and TMA (``csrc/attn_bwd_wgmma.cuh``, one score pass per key tile and q
tile, the route of the bf16 backward at head_dim 64) against its tiled
plain version, ``attention_bwd_reference`` and its mma.sync control at
(32, 866), (32, 896) n_real 866, (100, 281) and (2, 4500) n_real 4400 on
strided views, two launches bit-equal, masked dk/dv exactly zero, every
configuration of its sweep against plain, the kernel built with its key
mask dropped refused, then the kernel, the control, SDPA's backward and
the sweep timed by CUDA-graph replays in interleaved rounds, and the 30 s
and 10 s recipe steps with each backward in turn (31). Then K7 on
``wgmma`` and TMA (``csrc/attn_bwd_q8_wgmma.cuh``, the route of the int8
backward in bf16 at head_dim 64: a stats pass, then one score pass per key
tile and q tile on s8 wgmma, dq summed in int32 by TMA bulk adds) against
its plain version, its tiled plain version and its mma.sync control at
phase 15's five draws, two launches bit-equal, masked dk/dv exactly zero,
the kernel built with one key tile's dq adds dropped refused, then the
kernel, the control and K3b timed by CUDA-graph replays in interleaved
rounds, and the int8 recipe step with each K7 in turn (32); and the
yardsticks the kernels table lacked: K2, K3a, K3b in fp32 beside SDPA's
efficient attention, SDPA's forward with its log-sum-exp at head_dim 128,
256 and 384, K4's runtime-width instance and K5/K6 at head_dim 256 timed
(33). Then fp32 K2/K3a and K3b/K4 on tf32 ``wgmma`` and TMA with 3xTF32
products (``csrc/attn_fwd_tf32.cuh``, ``csrc/attn_bwd_tf32.cuh``: the
route of fp32 at head_dim 64, and so of phases 4, 5, 9 and 10 and of
``get_maest``'s default dtype) against plain and their scalar FMA
controls at (32, 1676), (32, 866), (100, 281) and (2, 4500) n_real 4400,
two backward launches bit-equal, masked dk/dv exactly zero, the kernels
built with one tf32 product refused (in a process of their own), then the kernels, the
controls, plain and SDPA's efficient attention timed by CUDA-graph
replays in interleaved rounds, and the fp32 tagging and 30 s recipe steps
with each route in turn (34). Then K5/K6 on s8 and e4m3 ``wgmma`` and
TMA behind one CUDA quantisation pass (``csrc/attn_fwd_q8_wgmma.cuh``,
the route of the 8-bit modes in bf16 at head_dim 64, and so of phases 13,
14 and 16): the pass equal to its plain version, the route against plain
at its 128-key tile and its mma.sync control against plain at 64 keys in
every mode with and without lse at (32, 1676), (32, 866) and (2, 300)
n_real 290, the e4m3 overflow, the kernel built with its key mask dropped
and the pass built rounding half away refused (each in a process of its
own), then the route, the control and K2 timed by CUDA-graph replays in
interleaved rounds, the pass and the kernel alone by torch.profiler, and
the tagging step in each mode with the route and the control in turn
(35). Then K1 as a 512-point real FFT in shared memory behind TMA bulk
loads (``csrc/mel_kernel.cu logmel_fft_kernel``, the route of the
front-end on the card, and so of phases 3, 6-8 and every tagging step)
against plain, its route's plain version and a float64 oracle at (60032,
512), ragged counts, silence and tones, the inputs it refuses, the kernel
built with one twiddle's sign flipped refused (in a process of its own);
the kernel, its FMA control (``fused_logmel_from_frames_fma``), plain and
the stock PyTorch front-end timed by CUDA-graph replays in interleaved
rounds, split by torch.profiler with the framing pass and the bf16
tagging step; and the bf16 and fp32 tagging steps with the kernel and
with the control in turn (36). Last the training CLI,
``maest_tpu_torch.apps.ex_maest.run(["main", "with",
"maest_10s_random_weights_pretrain", ...])`` in process on a synthetic
corpus: the native reader, the batch loader, the prefetch onto the card
and the Trainer for 2 epochs at full width and 4 of the preset's 12
blocks with the launch counters reset (K3a and K3b one a block a step,
K2 one a block an eval batch, the controls never), its checkpoints, a
run resumed from epoch-0 held to the uninterrupted one, ``test`` and
``extract_embeddings`` on ``best``, and the Trainer's step timed beside
the bare recipe step (37). Then the Trainer's parallel modes (38):
``ex_maest main`` at the same preset and depth in ranks spawned with
torchrun's variables, 2 on the one card over gloo on CUDA tensors (data
parallelism, tensor parallelism, FSDP2, tensor with sequence
parallelism), 4 (data x tensor x sequence parallelism), and 1 over NCCL
(FSDP2), each mode held to one process at the same global batch (its
losses, the eval's input rows, probabilities and val losses, rank 0's
final checkpoint), the replicas of each parameter element equal after
every step, the launch counters of each rank, and K3a/K3b and K2 held
to plain at tensor parallelism's local shapes. Then GPipe through the
Trainer (39) at phase 38's 4 blocks, 2 stages of 2: pp (2
ranks), dp+pp, pp+tp and dp+pp+fsdp (4 ranks) over gloo on the one card,
each held to phase 38's one-process run with its bounds, each
rank's launches (K3a and K3b 2 x M microbatches a step, K2 2 an eval
forward) and K3a/K3b/K2 held to plain at each rank's microbatch and
eval shapes. Last the tagging entry points (40): the bf16 TagService on
CUDA graphs (one a bucket and family, captured at warmup), every
bucket's replay against its eager run and an fp32 model's wave buckets
1 and 32, phase 7's four requests through graphs against
``predict_labels``, the launches a replayed batch (torch.profiler's
kernel names over one replay of each bucket: K1 1, K2 12, no control), a
wave batch's time by bucket, a bucket-32 wave batch's copy in, replay
and copy out by CUDA events, and latency under load
(``scripts/serve_bench.py``'s shape) with and without graphs in
alternating rounds; ``python -m maest_tpu_torch.apps.tag`` in processes
of its own on an HF AST layout checkpoint against ``predict_labels`` and
the block-7 embeddings; and the inference mesh in 2 ranks over gloo on
the one card (``MAEST`` at dp 2 and tp 2, ``tag --devices 2``, a mesh
TagService) held to one process. The kernels line gives K1 and K2 (and
fp32 K2) the served path's launches under graph replay, as
``launches_serve``. Phase 41 runs the modules of the last slice at full
width: the per-frequency and non-distilled 30 s models (random weights
from their goldens' seeds) through ``predict_labels`` in bf16 and fp32
and one bf16 train step each against the card's plain attention route,
``export_release --format torch`` of phase 37's checkpoint reloaded by
``get_maest`` against the Trainer's eval, and ``ex_tl.tl_pipeline`` on
the card against its CPU run; ``launches_surgery`` in the kernels line.
Phase 5 also holds the port to the goldens of ``tests/torch_goldens.py``
(5 s, 10 s, 20 s, the 519-label head, per-frequency, non-distilled).
Phase 42 holds K3b at head_dim 256 on wgmma (``csrc/attn_bwd_d256_wgmma.cuh``,
a dk/dv and a dq kernel; the route of head_dim 129-256 in bf16, and so of
phase 27's ``num_heads=3`` recipe step) to its tiled plain version, plain
and its mma.sync control at (2, 200) n_real 190, (32, 866) and head_dim
192, two launches bit-equal, masked dk/dv exactly zero, the kernels
built with dV's last q tile left out refused; then
times it beside the control and SDPA by CUDA-graph replays in interleaved
rounds, and the 30 s recipe step at ``num_heads=3`` with each backward in
turn.
Phase 43 holds K2/K3a at head_dim 128 on wgmma (``csrc/attn_fwd_wgmma.cuh``
at D = 128, the route of head_dim 65-128 in bf16) to plain at (2, 1676),
(32, 1676), (32, 866), (2, 1000) n_real 997 and head_dim 96 zero-padded,
with its mma.sync control and every configuration of its tile sweep
(the 64-key ones bit-equal to the control), counts its registers, spills
and HGMMA/UTMALDG/HMMA instructions, refuses the kernel built with S over
64 of its 128 dimensions in a process of its own, times the route, the
control, SDPA and the sweep by CUDA-graph replays in interleaved rounds
at (32, 1676, 6, 128) and (32, 866, 6, 128), then the ``num_heads=6``
tagging and recipe steps with each kernel in alternating rounds, each
gap beside 12 x the kernel gap.
Phase 44 holds the bf16 backward above head_dim 256 on wgmma
(``csrc/attn_bwd_dn_wgmma.cuh``: a scores kernel writing p and ds once in
bf16, then dv, dk and dq as products over them; the route of every width
above 256, and so of phase 27's ``num_heads=2`` recipe step and phase
23's K4 shape) and K2/K3a at head_dim 256 on wgmma
(``csrc/attn_fwd_d256_wgmma.cuh``: two consumer warpgroups, no producer
warp; the route of 129-256) to plain and to their tiled plain versions at
dp 320, 384, 512, 1024 and 300 zero-padded, (32, 866, 2, 384), K4's (1,
4500, 2, 320) n_real 4400 and at 256, 192 zero-padded, with and without
lse, two backward launches bit-equal, masked dk/dv exactly zero, their
mma.sync controls (``maest_attn_bwd_bf16_dn_mma``,
``maest_attn_fwd_bf16_d256_mma``) likewise; counts their registers,
spills and HGMMA/UTMALDG/HMMA instructions; refuses the kernels built
with dv's and dk's last q tile left out and with the forward's key mask
dropped, in a process of its own; times each kernel, its control and
SDPA by CUDA-graph replays in interleaved rounds at (32, 1676, 3, 256),
(32, 866, 3, 256), (32, 866, 2, 384) and (1, 4500, 2, 320), then the
``num_heads=2`` recipe step and the ``num_heads=3`` tagging and recipe
steps with each kernel in alternating rounds, each gap beside 12 x the
kernel gap.
Each phase's seconds print as it ends. A
split by torch.profiler
is printed only from a trace that holds every launch its route makes, by
name and count, and a device total within SPLIT_SHARE of the call's
time; else "not measured" and why. Phase 2 also counts the wgmma and TMA instructions in
the SASS of the wgmma kernels, prints the FFT kernel's launch shape and
checks that the production kernels spill nothing.
Every phase
prints one line per check; any failure raises, so the exit code is not 0.
The card's name and power limit, the JSON record of the kernels (with each
one's bound: the least time the card could take for its work at the
data-sheet rates) and the device record are the last three lines. Without
torch or a CUDA card, or outside a checkout, it exits with a non-zero code
and prints no result.

Weights are random, drawn from the golden files' seeds; no file is fetched.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import re
import shutil
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
# K5/K6 vs plain on the same key tiles, compared in fp32: both round
# one fp32 output to bf16, and their fp32 values differ by far less than a
# bf16 ulp (sums in another order; an exp2 ulp that flips one 8-bit p moves
# o by ~|v| / (127 l)), so an element may round one ulp apart: the bound is
# Q8_ULPS bf16 ulps of the largest |o| of the plain version
Q8_ULPS = 2
K7_TOL = 2e-2       # K7 vs plain, relative to each gradient's max: the bf16
                    # bound (bf16 outputs; an exp2 ulp may flip one p8/ds8)
K7_COS = 0.9999
# K7's fp32 instance vs plain, relative to each gradient's max: both take
# the same exact int8 products and dequantize them in fp32; measured on an
# H100 0 at (2, 866, 12, 64) and 5.5e-8 at head_dim 32 (zero-padded), while
# the same gradients rounded to bf16 land ~1e-3 away (phase 23 checks that
# they fail the bound)
K7F32_TOL = 1e-5
# K7's fp32 runtime-width instance (head_dim above 256) vs plain: delta =
# rowsum(do * o) sums its 320 or more products in another order than the
# plain version, so the q-block's max |ds| may move by an fp32 ulp and flip
# one ds8 (or p8) code, which moves one row of dq and one of dk (or dv) by
# a code's weight: at most K7F32_FLIP_ROWS rows (b, n, h) beyond K7F32_TOL
# of the gradient's max, all within K7_TOL (measured on the H100 at (4,
# 281, 12, 320): one dq row at 4.3e-3 of its max)
K7F32_FLIP_ROWS = 4
# P6a-d vs plain on the same 64-key tiles: as Q8_ULPS, both round one fp32
# output to bf16 and their fp32 values differ by sums in other orders
PROBE_ULPS = 2
# noexp_max and bf16s vs K2 (both softmax attention): bf16 rounds their p
# (and bf16s its scores) elsewhere than K2's, relative errors, so the bound
# is 1e-2 of max(1, the largest |o|): at N 100 |o| reaches 1.5, where one
# bf16 ulp is 7.8e-3
PROBE_VS_K2 = 1e-2
# bf16s and its control are nearer their own plain version than K2's output:
# max|o - K2| above max|o - plain| (the CPU test's check, whose 4x margin
# does not hold at (3, 100), where a few outputs of the largest |o| set both
# maxima), and mean|o - K2| above PROBE_NEAR times mean|o - plain| (the two
# round at the same points, so most outputs agree to the bit; K2 rounds
# neither q's pre-scale nor the scores, which moves most of them)
PROBE_NEAR = 4
# P6e: gh<G> vs K2 is torch.equal (each head runs K2's arithmetic).
# P6f int8 vs plain (fp32 outputs), each row (b, n, h): one exp2 ulp may
# flip the rounding of one p8, which moves the row by at most
# max|v| / (127 l), l its sum of p; INT8_FLIPS such flips a row, plus
# INT8_SUMS of max|o| for fp32 sums taken in another order
INT8_FLIPS = 1
INT8_SUMS = 1e-5
# int8 * 127 vs fp32 attention on the rig's N(0, 0.5^2) inputs: int8 rounds
# q, k, v and p to 1/254 of their row / column maxima (the rig's output is
# attention / 127: ops/attention_probe.py attention_probe_int8)
INT8_X127 = 1e-2
# P5 vs plain: ops/attention_vpu.py plain_gap, within 2 bf16 ulps of
# max|o| (plus 2^-7 max|o| for bf16sm, fp8sm and fp8nomask, whose p comes
# from the packed ex2.approx.ftz.bf16x2: relative error <= 2^-7, against
# 2^-8 for the plain version's exp2 rounded to bf16, independent from key
# to key) and within 1e-2 by relative L2; a planted fault (mask off, corr
# 1) fails it (tests/test_torch_cuda.py). Against K2, on
# the rig's N(0, 0.3^2) inputs, as a relative L2 distance |o - K2| / |K2|:
# bf16sm, fp8sm, fp8noexp and fp8lean within VPU_VS_K2 (fp8lean's e4m3 v
# and p, 3 mantissa bits, cost ~3.6 %), fp8nomask farther at N 1676 (its 116
# zero keys take ~6.5 % of the mass)
VPU_VS_K2 = 0.05
# fp32 under an 8-bit mode (phase 23), vs plain on the same 64-key tiles:
# the int8 and e4m3 products are exact and summed in fp32 on both sides, so
# qk8 and fp8 (p unrounded times fp32 v) differ only by sums in other
# orders, Q8F32_REL_L2 by relative L2; qk8pv8 and fp8pv8 round p to 8 bits,
# where an exp2 ulp may flip one p: Q8_ULPS bf16 ulps of max|o|, as K5/K6
Q8F32_REL_L2 = 1e-5
# P9/P7 forwards vs plain (phase 24): PROBE_ULPS bf16 ulps of max|o| and a
# relative L2 of at most TILE_REL_L2, which a zero output (1.0) and the
# last tile's zero keys left unmasked (~0.2 at N 281) both exceed
TILE_REL_L2 = 1e-2
# P1/P8 vs plain (phase 26): both sum exact products of bf16 (or e4m3)
# values in fp32, in other orders, and round once to bf16, so an element
# may round one ulp apart (the wgmma kernel's e4m3 sums keep fewer bits
# within each 128 values of K, then add into fp32): MMA_ULPS bf16 ulps of
# max|out|, and a relative L2 of at most MMA_REL_L2, which one of k64big's
# 56 column blocks left out (~sqrt(1/56) = 0.13) exceeds
MMA_ULPS = 2
MMA_REL_L2 = 1e-2
# e4m3 P8 shapes, tighter: on the H100 the wgmma kernel's two-level sums
# measured a relative L2 of 4.6e-4 to 4.7e-4 (the control 0), and its e4m3
# sums kept on the tensor core across every stage 1.1e-3 (fc1, qkv) to
# 2.0e-3 (fc2), both within MMA_ULPS; the bound refuses the latter
MMA_E4M3_REL_L2 = 7.5e-4
# K2/K3a's wgmma kernel vs its mma.sync control (phase 30), lse: the same
# running max, and l the same fp32 p summed in another order (96-key
# tiles against 64), so lse moves by a few fp32 ulps of log2(l); measured
# on the H100 at most 1.9e-6 at (32, 866, 12, 64)
WG_LSE_TOL = 1e-5
# the configurations of maest_attn_fwd_bf16_wgmma (csrc/attention_fwd.cu):
# key tile x consumer warpgroups, with or without turns; the production
# route takes 0 or 4 (``wg_production``), 2 (64-key tiles) gives the
# control's numbers bit for bit
WG_CONFIGS = ("96x3 turns", "96x3", "64x3 turns", "64x2 turns",
              "112x3 turns", "128x3 turns", "128x2 turns", "192x2 turns")
WG_ROUNDS = 5
# the configurations of maest_attn_fwd_bf16_d128_wgmma (csrc/attention_fwd.cu,
# head_dim 128): key tile x ring stages, two consumer warpgroups taking
# turns; the production route takes 2 or 4 (``wg128_production``), the
# 64-key ones (0, 1, 6) give the control's numbers bit for bit
WG128_CONFIGS = ("64x2", "64x3", "80x2", "80x3", "96x2", "96x3", "64x4",
                 "80x4", "96x4")
D128_ROUNDS = 3  # interleaved rounds of phase 43's timings
# phase 43's shapes (b, n, n_real, head_dim): the model's at 6 heads
# (tagging's N 1676, the 30 s recipe's 866), a small N, an odd n_real past
# which TMA's zero rows and the key mask meet, head_dim 96 zero-padded
D128_SHAPES = ((2, 1676, None, 128), (BATCH, 1676, None, 128),
               (BATCH, 866, None, 128), (2, 1000, 997, 128),
               (2, 300, 281, 96))
# P6e's wave count at (32, 1676, 12, 64) on 132 SMs, one block an SM: the
# head-tiles the busiest SM runs at G heads a block (9 q tiles x 384 / G
# blocks, ceil(blocks / 132) waves of G heads each)
GH_SMS = 132
# the configurations of maest_attn_bwd_bf16_wgmma (csrc/attention_bwd.cu):
# q rows a tile x consumer warpgroups of 64 keys, with or without turns;
# the production route takes WG_BWD_PRODUCTION
WG_BWD_CONFIGS = ("64x2", "64x2 turns", "128x2", "128x2 turns")
WG_BWD_PRODUCTION = 0
# phase 31's shapes: the 30 s recipe's, padded with n_real, the 10 s
# recipe's and K4's regime (as phase 9)
BWD_WG_SHAPES = ((BATCH, 866, None), (BATCH, 896, 866), (100, 281, None),
                 (2, 4500, 4400))


# phase 42's shapes (b, n, n_real, heads, head_dim): K3b at head_dim 256 past
# n_real at a small N, at the 30 s recipe's (32, 866) with num_heads 3, and
# at head_dim 192, zero-padded to 256 by the route
D256_BWD_SHAPES = ((2, 200, 190, 3, 256), (BATCH, 866, None, 3, 256),
                   (2, 300, 281, 2, 192))
# its bound: each gradient within 1e-2 of max(1, its max |x|) of the tiled
# plain version and of plain (tests/test_torch_bwd_wgmma.py's bf16
# PLAIN_TOL: an fp32 sum in another order may round p, ds or an output to
# the neighbouring bf16 value)
D256_REL_TOL = 1e-2
D256_ROUNDS = 5  # interleaved rounds of phase 19's and 42's timings


def wg128_production(n_real: int) -> int:
    """The configuration maest_attn_fwd_bf16_d128 takes at n_real keys:
    80-key tiles (2) or 96-key ones (4), two stages, as ``wg128_key_tile``
    chooses."""
    from maest_tpu_torch.ops.attention import wg128_key_tile

    return 4 if wg128_key_tile(n_real) == 96 else 2


def gh_head_tiles(g: int, b: int = BATCH, n: int = 1676,
                  heads: int = 12) -> int:
    """Head-tiles of the busiest SM at G heads a block: ceil(blocks / 132)
    waves of G (K2's 192-row q tiles)."""
    blocks = -(-n // 192) * b * heads // g
    return -(-blocks // GH_SMS) * g


def wg_production(n_real: int) -> int:
    """The configuration maest_attn_fwd_bf16 takes at n_real keys: 112-key
    tiles (4) or 96-key ones (0), as ``wg_key_tile`` chooses."""
    from maest_tpu_torch.ops.attention import wg_key_tile

    return 4 if wg_key_tile(n_real) == 112 else 0
# H100 SXM data-sheet peaks (dense), for the bounds of the kernels line;
# "tf32x3": an fp32-accurate product as three tf32 products (3xTF32)
PEAK = {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12, "fp32": 67e12,
        "tf32x3": 495e12 / 3}
HBM = 3.35e12       # bytes/s


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """(ms, what binds): the larger of the bytes over the memory rate and
    the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM
    t_ops = sum(n / PEAK[k] for k, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def attn_bound(b, n, h, n_real=None, pv="bf16", qk="bf16", lse=False,
               elem=2, d=64):
    """The forward at (b, n, h, d): the two products over the real keys
    (n_real of them), q.k in ``qk``'s type and p.v in ``pv``'s, q/k/v read
    and the output (and the fp32 lse) written once, ``elem`` bytes an
    element (bf16; fp32 for the int8 rig and the fp32 tier)."""
    flops = 2 * b * h * n * (n_real or n) * d
    nbytes = 4 * b * n * h * d * elem + (4 * b * h * n if lse else 0)
    ops: dict = {}
    ops[qk] = ops.get(qk, 0) + flops
    ops[pv] = ops.get(pv, 0) + flops
    return bound(nbytes, ops)


def bwd_bound(b, n, h, n_real=None, kind="bf16", elem=2, d=64):
    """The backward at (b, n, h, d): its five products over the real keys
    (dv, dp, dq, dk and the score recompute) in ``kind``'s type,
    q/k/v/o/do and lse read, and dq/dk/dv written once, ``elem`` bytes an
    element."""
    flops = 5 * 2 * b * h * n * (n_real or n) * d
    nbytes = 8 * b * n * h * d * elem + 4 * b * h * n
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


def ptxas_rows(log: str) -> list[str]:
    """'kernel: R registers, spills S/L bytes' for each entry of an
    ``nvcc -Xptxas -v`` log, the names demangled by cu++filt where it runs
    and cut before their parameter lists."""
    rows, name, spill = [], None, "0/0"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, m.group(1), spill))
            name, spill = None, "0/0"
    names = [r[0] for r in rows]
    try:
        names = subprocess.run(
            ["/usr/local/cuda/bin/cu++filt"], input="\n".join(names),
            capture_output=True, text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        pass
    # cut each demangled name before its parameter list, after dropping
    # the casts of its template arguments, as in <(int)0, (bool)1>
    names = [re.sub(r"\([\w: ]+\)(?=[-\w])", "",
                    n.replace("(anonymous namespace)::", "")).split("(")[0]
             .removeprefix("void ") for n in names]
    return [f"{n}: {r} registers, spills {sp} bytes"
            for n, (_, r, sp) in zip(names, rows)]


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
        fused_logmel_from_frames_fma,
        fused_logmel_from_frames_reference,
    )

    rng = np.random.default_rng(0)
    waves = torch.from_numpy(
        rng.standard_normal((BATCH, CLIP)).astype(np.float32) * 0.1).to(dev)
    frames = frame_waveforms(waves).reshape(-1, 512).contiguous()
    before = (fused_logmel_from_frames.launches,
              fused_logmel_from_frames_fma.launches)
    mel_err = max_err(fused_logmel_from_frames(frames),
                      fused_logmel_from_frames_reference(frames))
    torch.cuda.synchronize()
    check((fused_logmel_from_frames.launches,
           fused_logmel_from_frames_fma.launches) == (before[0] + 1,
                                                      before[1]),
          "mel counters")
    check(mel_err <= MEL_TOL, f"K1 err {mel_err} > {MEL_TOL}")
    print(f"phase 3 K1 mel (the FFT kernel, logmel_fft_kernel): frames "
          f"{tuple(frames.shape)} max_abs_err {mel_err:.3e} <= {MEL_TOL}; "
          "its counter +1, the FMA control's +0", flush=True)

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
    logits, then against each golden of ``tests/torch_goldens.py`` (the
    5 s, 10 s and 20 s geometries, the 519-label head, the 30 s
    per-frequency and non-distilled models), K2's launches counted on
    each; returns the state dict it drew and the (config, state) of the
    per-frequency and the non-distilled golden."""
    from maest_tpu_torch.checkpoints import load_into
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.ops.attention import flash_attention
    from torch_goldens import GOLDENS, golden_case, golden_path
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
    cases = {}
    for name in sorted(GOLDENS):
        golden = np.load(golden_path(name))
        cfg, state, x = golden_case(name)
        if GOLDENS[name][1] != "shared":  # phase 41's models
            cases[name] = cfg, state
        net = load_into(MAESTNet(cfg, device=dev), state).eval()
        before = flash_attention.launches
        with torch.inference_mode():
            logits = net(torch.from_numpy(x).to(dev))[0].cpu().numpy()
        grew = flash_attention.launches - before
        del net
        err = float(np.abs(logits - golden["logits"]).max())
        check(logits.shape == golden["logits"].shape
              and bool(np.isfinite(logits).all()), f"golden {name} logits")
        check(grew == cfg.depth, f"golden {name}: attention launches {grew}")
        check(err <= GOLDEN_TOL, f"golden {name} err {err} > {GOLDEN_TOL}")
        print(f"phase 5 golden {name} ({GOLDENS[name][0]}, "
              f"{GOLDENS[name][1]}, input {tuple(x.shape)}): fp32 logits "
              f"{logits.shape} max_abs_err {err:.3e} <= {GOLDEN_TOL} vs "
              f"tests/golden/{name}.npz; attention launches +{grew}",
              flush=True)
    return sd, cases


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
    print(f"phase 8 time K1 mel (the FFT kernel) frames "
          f"{tuple(frames.shape)}: kernel {t['mel'][0]:.4f} ms, plain {t['mel'][1]:.4f} ms [{gpu}]",
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


def _recipe(dev, preset, batch, seed, overrides=(), dtype=torch.bfloat16):
    """The pre-training recipe of ``preset`` (with dotted ``overrides``) at
    full width: the model (``dtype`` compute over fp32 parameters), its
    AdamW state, the step and a batch of random mel input on the card."""
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
    net = MAESTNet(mcfg, dtype=dtype, param_dtype=torch.float32,
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
    """Phase 13: K5 (qk8, qk8pv8) and K6 (fp8, fp8pv8), the wgmma route in
    bf16 at head_dim 64 (``csrc/attn_fwd_q8_wgmma.cuh``, phase 35), against
    their plain versions on the same 128-key tiles (the route's,
    ``q8_block_k``), with and without lse, at the tagging shape, the 30 s
    recipe's (32, 866) (K5 with lse on the qk8 training path) and (2, 300)
    with n_real 290. The bound is Q8_ULPS bf16 ulps of the largest |o|, and
    each mode's kernel must miss every other mode's plain version by more
    than it: the check tells the modes' arithmetic apart. An e4m3 overflow
    case; times at the tagging shape: the wrapper (the CUDA quantisation
    pass + kernel) and the plain version with CUDA events, the pass and the
    kernel alone from torch.profiler."""
    from maest_tpu_torch.ops import attention as A

    rng = np.random.default_rng(5)
    err = dict.fromkeys(Q8_MODES, 0.0)
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
            err[mode] = max(err[mode], e, el)
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
                                   _q8w_expect(mode))
                line += (f"; time: kernel with its quantisation pass "
                         f"{times[mode][0]:.4f} ms, plain {times[mode][1]:.4f}"
                         f" ms, pass and kernel alone (torch.profiler) "
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
    return {"err": err, "qk8": times["qk8"], "fp8": times["fp8"]}


def phase_q8_tagging(dev, sd, gpu):
    """Phase 14: the tagging path in each 8-bit mode: get_maest with
    attention_quant on phase 5's weights, bf16, predict_labels on 32 clips
    of 30 s with the counters reset; 12 launches of the mode's kernel (the
    wgmma route) and none of K2 or of the route's control; activations
    within TIER_TOL of the unquantized bf16 model's; the batch-32 step
    time. Returns the launches of each mode's entry."""
    from maest_tpu_torch import get_maest
    from maest_tpu_torch.ops.attention import attention_fwd_q8_mma
    from maest_tpu_torch.serve import BucketPrograms

    rng = np.random.default_rng(6)
    waves = rng.standard_normal((BATCH, CLIP)).astype(np.float32) * 0.1
    waves_dev = torch.from_numpy(waves).to(dev)
    launches = {}
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
            attention_fwd_q8_mma.launches = 0
            acts = model.predict_labels(waves)[0]
            torch.cuda.synchronize()
            fns, counts = _q8_counts()
            kind = "int8" if mode.startswith("qk8") else "fp8"
            want = [0, 0, 0, 12 if kind == "int8" else 0,
                    12 if kind == "fp8" else 0, 0]
            check(counts == want and attention_fwd_q8_mma.launches == 0,
                  f"{mode} tagging launches {counts}, control "
                  f"{attention_fwd_q8_mma.launches}")
            launches[mode] = counts[3] + counts[4]
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
                  f"{counts[3] + counts[4]}, K2 {counts[0]}, the control "
                  f"{attention_fwd_q8_mma.launches}; per-clip "
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
                lambda: A.attention_bwd_int8(q, k, v, o, lse, g), K7W_EXPECT)
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


# a split of a call's device time by kernel is printed only from a trace
# whose device total is within SPLIT_SHARE of the call's time (its graph
# median, or a step's event time): a trace that lost launches, or caught
# stray ones, reads otherwise
SPLIT_SHARE = 0.2


def _kernel_ms(fn, expect: dict, ref_ms: float | None = None
               ) -> tuple[dict, str]:
    """Device ms of the launches of one call of ``fn`` by torch.profiler
    (the second call of a window whose first warms the tracer): ({label:
    ms} for each ``label: (regex, launches)`` of ``expect``, with "all" the
    trace's device total, ""), from the first of three traces that records
    every expected launch by name and count and whose total is within
    SPLIT_SHARE of ``ref_ms`` (None: the graph median of ``fn``,
    ``probes.attn_profile.graph_ms``); else ({}, why none was taken)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from maest_tpu_torch.probes.attn_profile import graph_ms

    if ref_ms is None:
        ref_ms = graph_ms(fn, 3, torch.device(DEVICE))
    fn()
    torch.cuda.synchronize()
    why = ""
    for trace in range(1, 4):
        # a trace loses the first launches of its window: one call runs
        # with the tracer on and is dropped, the next one is kept
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            rows.append((e.key, e.count,
                         (e.cuda_time_total if us is None else us) / 1e3))
        split = {"all": sum(ms for _, _, ms in rows)}
        missing = []
        for label, (pattern, launches) in expect.items():
            hit = [(n, ms) for key, n, ms in rows if re.search(pattern, key)]
            if sum(n for n, _ in hit) != launches:
                missing.append(f"{label} {sum(n for n, _ in hit)} of "
                               f"{launches} launches")
            split[label] = sum(ms for _, ms in hit)
        if missing:
            why = f"trace {trace} recorded " + ", ".join(missing)
        elif abs(split["all"] - ref_ms) > SPLIT_SHARE * ref_ms:
            why = (f"trace {trace}'s device total {split['all']:.4f} ms is not"
                   f" within {SPLIT_SHARE:.0%} of the call's {ref_ms:.4f} ms")
        else:
            return split, ""
    return {}, why


def _fmt_ms(split: tuple[dict, str]) -> str:
    rows, why = split
    if why:
        return f"not measured ({why})"
    return ", ".join(f"{k} {v:.4f} ms" for k, v in rows.items() if k != "all") \
        + f" (device total {rows['all']:.4f} ms)"


def _q8w_expect(mode: str) -> dict:
    """The launches of the wgmma 8-bit forward's route in ``mode``: the
    vmax pass (qk8pv8 only), the quantisation pass and the kernel."""
    out = {"vmax": (r"fwd_q8w_vmax_kernel", 1)} if mode == "qk8pv8" else {}
    return {**out, "pass": (r"fwd_q8w_pass_kernel", 1),
            "kernel": (r"fwd_q8w_kernel", 1)}


# the launches of the wgmma K7's route (bf16, head_dim 64)
K7W_EXPECT = {"amax": (r"bwd_q8_amax_kernel", 1),
              "quant": (r"bwd_q8w_quant_kernel", 1),
              "stats": (r"bwd_q8w_kernel<true>", 1),
              "main": (r"bwd_q8w_kernel<false>", 1),
              "dq": (r"bwd_q8w_dq_kernel", 1)}


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
    them): scaled_dot_product_attention on its flash backend (K2; at (100,
    281) beside qpad, P9, and at (32, 281) beside the tiles, P7), the
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
        for b, n, key in ((BATCH, 1676, "fwd"), (100, 281, "fwd_qpad"),
                          (BATCH, 281, "fwd_281"), (BATCH, 866, "bwd"),
                          (2, 4400, "bwd_k4")):
            x = torch.from_numpy(rng.standard_normal(
                (b, n, 3, 12, 64)).astype(np.float32)).to(
                dev, torch.bfloat16)
            q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
            if key.startswith("fwd"):
                out[key] = cuda_ms_median(
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
          f"64) {out['fwd']:.4f} ms (beside K2), (100, 281) "
          f"{out['fwd_qpad']:.4f} ms (beside qpad), ({BATCH}, 281) "
          f"{out['fwd_281']:.4f} ms (beside the tiles); "
          "_scaled_dot_product_flash_"
          f"attention with its log-sum-exp ({BATCH}, 866) {out['fwd_lse']:.4f}"
          f" ms (beside K3a); its backward through autograd, forward "
          f"subtracted, {out['bwd']:.4f} ms (beside K3b) and at (2, 4400) "
          f"{out['bwd_k4']:.4f} ms (beside K4 at (2, 4500) n_real 4400) "
          f"[{gpu}]", flush=True)
    return out


def _bf16s_planted_inputs(dev, n: int = 866):
    """Phase 18's planted fault's (2, n, 3, 12, 64) bf16 q/k/v, N(0, 1),
    drawn from seed 40 + n."""
    gen = torch.Generator(device=dev).manual_seed(40 + n)
    return torch.randn((2, n, 3, 12, 64), generator=gen, device=dev).to(
        torch.bfloat16)


def _near_plain(o, r, k2) -> dict:
    """o's distances to its plain version r and to K2's output k2: max and
    mean |difference|."""
    def mean(a, b):
        return (a.float() - b.float()).abs().mean().item()
    return {"err": max_err(o, r), "k2": max_err(o, k2), "mean": mean(o, r),
            "mean_k2": mean(o, k2)}


def _near_holds(d: dict, tol: float) -> bool:
    """Phase 18's checks of bf16s (and its control) on ``_near_plain``'s
    distances: within ``tol`` of plain, and nearer plain than K2 (PROBE_NEAR
    on the means)."""
    return (d["err"] <= tol and d["k2"] > d["err"]
            and d["mean_k2"] > PROBE_NEAR * d["mean"])


def _bf16s_gap(n: int) -> dict:
    """``_near_plain`` of bf16s on ``_bf16s_planted_inputs(n)`` at n_real
    n - 16, and the PROBE_ULPS bound of its plain version ("tol")."""
    from maest_tpu_torch.ops.attention import flash_attention
    from maest_tpu_torch.ops.attention_probe import (
        attention_probe,
        attention_probe_reference,
    )

    q, k, v = _bf16s_planted_inputs(torch.device(DEVICE), n).unbind(2)
    o = attention_probe(q, k, v, "bf16s", n - 16)
    r = attention_probe_reference(q, k, v, "bf16s", n - 16)
    d = _near_plain(o, r, flash_attention(q, k, v, n_real=n - 16))
    d["tol"] = PROBE_ULPS * bf16_ulp(r.float().abs().max().item())
    return d


# the shapes of phase 18's planted fault: (2, n, 12, 64) at n_real n - 16
BF16S_PLANT_NS = (866, 1676)


def phase_probe_kernels(dev, planted_lib):
    """Phase 18: the four probe kernels (P6a-d) against their plain
    versions on the same key tiles (64 keys; bf16s, on K2's wgmma kernel,
    96 or 112 as that kernel takes them), N(0, 1) inputs, at (2, 1676),
    (2, 866), (3, 100) and the rig's (32, 1676) and (32, 866): within
    PROBE_ULPS bf16 ulps of the largest |o| (mxu_only: of its own, ~250);
    bf16s's mma.sync control (``attention_probe_mma``, its PyTorch
    pre-scaling pass and 64-key tiles) the same against its own plain
    version. noexp_max and bf16s compute softmax attention: within
    PROBE_VS_K2 of K2's output at the first three shapes; novmax is another
    function, farther than that at (2, 1676). bf16s and its control are
    nearer their plain version than K2's output at every shape
    (``_near_holds``: the max and, by PROBE_NEAR, the mean |difference|).
    Then the wgmma bf16s kernel built with the bf16 rounding of its scores
    left out (the one step that tells bf16s from K2), run in a process of
    its own at (2, 866) n_real 850 and (2, 1676) n_real 1660: the same
    checks refuse it. Returns each variant's (and the control's,
    "bf16s_mma") max_abs_err and its plain version's ms at (32, 1676)."""
    from maest_tpu_torch.ops.attention import flash_attention, wg_key_tile
    from maest_tpu_torch.ops.attention_probe import (
        VARIANTS,
        attention_probe,
        attention_probe_mma,
        attention_probe_mma_reference,
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
        for var in (*VARIANTS, "bf16s_mma"):
            control = var == "bf16s_mma"
            counter = attention_probe_mma if control else attention_probe
            before = (counter.launches if control
                      else counter.launches[var])
            if control:
                o = attention_probe_mma(q, k, v, "bf16s")
                ref_fn = lambda: attention_probe_mma_reference(  # noqa: E731
                    q, k, v, "bf16s")
            else:
                o = attention_probe(q, k, v, var)
                ref_fn = lambda: attention_probe_reference(  # noqa: E731
                    q, k, v, var)
            r = ref_fn()
            torch.cuda.synchronize()
            check((counter.launches if control else counter.launches[var])
                  == before + 1, f"{var} counter")
            tol = PROBE_ULPS * bf16_ulp(r.float().abs().max().item())
            e = max_err(o, r)
            check(e <= tol, f"{var} ({b}, {n}) err {e} > {tol}")
            d = max_err(o, k2)
            part = f"{var} {e:.3e} <= {tol:.3e}, vs K2 {d:.3e}"
            if var in ("bf16s", "bf16s_mma"):
                near = _near_plain(o, r, k2)
                check(_near_holds(near, tol), f"{var} ({b}, {n}) not nearer "
                      f"its plain version than K2: {near}")
                part += (f" > {e:.3e} (mean |diff| vs K2 "
                         f"{near['mean_k2']:.3e} > {PROBE_NEAR} x "
                         f"{near['mean']:.3e} vs plain)")
            if b != BATCH and var in ("noexp_max", "bf16s", "bf16s_mma"):
                bound = PROBE_VS_K2 * max(1.0, top_k2)
                check(d <= bound, f"{var} ({b}, {n}) vs K2 {d} > {bound}")
                part += f" <= {bound:.3e}"
            if (b, n) == (2, 1676) and var == "novmax":
                check(d > PROBE_VS_K2, f"novmax within {d} of K2")
                part += f" > {PROBE_VS_K2}"
            if (b, n) == (BATCH, 1676):
                err[var] = e
                plain[var] = cuda_ms(ref_fn, 3)
            parts.append(part)
            del o, r
        print(f"phase 18 P6a-d probe kernels ({b}, {n}, 12, 64) bf16 "
              f"max_abs_err vs plain ({PROBE_ULPS} bf16 ulps of max|o|; "
              f"bf16s on the wgmma kernel's {wg_key_tile(n)}-key tiles, "
              f"bf16s_mma its control): " + "; ".join(parts), flush=True)
        del qkv, q, k, v, k2
        torch.cuda.empty_cache()

    # the planted fault: the scores not rounded to bf16, so the kernel
    # computes K2's function on the pre-scaled q
    sound = {n: _bf16s_gap(n) for n in BF16S_PLANT_NS}
    bad = _own_process(
        "import ctypes, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as C\n"
        "from maest_tpu_torch.ops import _build\n"
        f"_build._libs['attention_probe'] = ctypes.CDLL({str(planted_lib)!r})\n"
        f"print(json.dumps([C._bf16s_gap(n) for n in {BF16S_PLANT_NS!r}]))\n")
    bad = dict(zip(BF16S_PLANT_NS, bad))
    check(all(_near_holds(d, d["tol"]) for d in sound.values())
          and not any(_near_holds(d, d["tol"]) for d in bad.values()),
          f"planted bf16s without its score rounding {bad}, sound {sound}")

    def text(d):
        return (f"max_abs_err vs plain {d['err']:.3e} (<= {d['tol']:.3e}), "
                f"vs K2 {d['k2']:.3e}; mean |diff| vs plain {d['mean']:.3e}, "
                f"vs K2 {d['mean_k2']:.3e}")
    print("phase 18 planted fault, the wgmma bf16s kernel built with the "
          "bf16 rounding of its scores left out: " + "; ".join(
              f"at (2, {n}, 12, 64) n_real {n - 16} {text(bad[n])}: "
              f"refused by " + ", ".join(
                  name for name, fails in (
                      ("the bound", bad[n]["err"] > bad[n]["tol"]),
                      ("max nearer K2", bad[n]["k2"] <= bad[n]["err"]),
                      ("mean nearer K2", bad[n]["mean_k2"]
                       <= PROBE_NEAR * bad[n]["mean"])) if fails)
              + f" (the sound kernel {text(sound[n])})"
              for n in BF16S_PLANT_NS), flush=True)
    return err, plain


def phase_probe_rig(dev, gpu):
    """Phase 19: the slice's path, the decomposition rig as a user runs it
    (``python -m maest_tpu_torch.probes.attn_profile --shapes
    30s,30s-train --batch 32``, here its ``main`` in process; it prints
    the card's name and power limit first), with the launch counters of
    K2 (its mma.sync kernel, "flash", and its wgmma kernel, "wgmma"), the
    probes and bf16s's control set to 0 just before and read just after:
    each kernel must have run (a CUDA graph's replays are launches the
    counters do not see: they count the captured calls), every variant but
    plain must have a graph time, and the control's kernel alone and its
    pre-scaling pass must each take less than the two together. bf16s on
    the wgmma kernel has no pass to split off: it is held to its plain
    version within PROBE_ULPS (here at (2, 1676) n_real 1600; phase 18 at
    every shape) and must have a graph time. Then bf16s, its control, K2's
    two kernels and SDPA (flash backend) at (32, 1676, 12, 64) by
    CUDA-graph replays in D256_ROUNDS interleaved rounds, every round
    printed; the route must beat the control in each. Returns {shape:
    {variant: times}}, the launches and the rounds' medians."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from maest_tpu_torch.ops.attention import (
        attention_fwd_mma,
        flash_attention,
    )
    from maest_tpu_torch.ops.attention_probe import (
        attention_probe,
        attention_probe_mma,
        attention_probe_reference,
    )
    from maest_tpu_torch.probes import attn_profile

    print("phase 19 decomposition rig: python -m "
          "maest_tpu_torch.probes.attn_profile --shapes 30s,30s-train "
          f"--batch {BATCH}", flush=True)
    attention_fwd_mma.launches = 0
    flash_attention.launches = 0
    attention_probe_mma.launches = 0
    for var in attention_probe.launches:
        attention_probe.launches[var] = 0
    times = attn_profile.main(["--shapes", "30s,30s-train", "--batch",
                               str(BATCH)])
    # the rig's "flash" is K2's mma.sync kernel, the control; "wgmma" K2's
    # wgmma kernel, the template of bf16s
    launches = {"flash": attention_fwd_mma.launches,
                "wgmma": flash_attention.launches,
                "bf16s_mma": attention_probe_mma.launches,
                **attention_probe.launches}
    check(all(launches.values()), f"rig launches {launches}")
    for rows in times.values():
        check(all(r["graph_ms"] > 0 for v, r in rows.items() if v != "plain"),
              f"rig graph times {rows}")
        bf = rows["bf16s_mma"]
        check(0 < bf["kernel_ms"] < bf["ms"] and 0 < bf["pass_ms"] < bf["ms"],
              f"bf16s control split {bf}")
    print(f"phase 19 launches in the rig's run: {launches}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn((2, 1676, 3, 12, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = x.unbind(2)
    o = attention_probe(q, k, v, "bf16s", 1600)
    r = attention_probe_reference(q, k, v, "bf16s", 1600)
    e = max_err(o, r)
    tol = PROBE_ULPS * bf16_ulp(r.float().abs().max().item())
    check(e <= tol, f"bf16s (2, 1676) n_real 1600 vs plain {e} > {tol}")
    print(f"phase 19 bf16s on the wgmma kernel (no pass to split off) at "
          f"(2, 1676, 12, 64) n_real 1600: max_abs_err vs plain {e:.3e} <= "
          f"{tol:.3e}; graph ms " + ", ".join(
              f"{s} {rows['bf16s']['graph_ms']:.4f}"
              for s, rows in times.items()), flush=True)
    del x, q, k, v, o, r

    x = torch.randn((BATCH, 1676, 3, 12, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = x.unbind(2)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qs, ks, vs)

    fns = {"bf16s": lambda: attention_probe(q, k, v, "bf16s"),
           "bf16s_mma": lambda: attention_probe_mma(q, k, v, "bf16s"),
           "wgmma": lambda: flash_attention(q, k, v),
           "flash": lambda: attention_fwd_mma(q, k, v)[0], "sdpa": sdpa}
    with torch.inference_mode():
        runs = attn_profile.graph_rounds(fns, 10, dev, D256_ROUNDS)
    for rnd in range(D256_ROUNDS):
        print(f"phase 19 P6d ({BATCH}, 1676, 12, 64) round {rnd + 1} "
              f"CUDA-graph ms: " + ", ".join(
                  f"{key} {ms[rnd]:.4f}" for key, ms in runs.items())
              + f" [{gpu}]", flush=True)
    med = {key: float(np.median(ms)) for key, ms in runs.items()}
    every = all(a < c for a, c in zip(runs["bf16s"], runs["bf16s_mma"]))
    check(every, f"bf16s on wgmma not faster than its control in every "
          f"round: {runs}")
    print(f"phase 19 P6d medians of {D256_ROUNDS} rounds: bf16s on wgmma "
          f"{med['bf16s']:.4f} ms, its control (pass and mma.sync kernel) "
          f"{med['bf16s_mma']:.4f} ({med['bf16s_mma'] / med['bf16s']:.2f}x), "
          f"K2 on wgmma {med['wgmma']:.4f} (bf16s - K2 "
          f"{med['bf16s'] - med['wgmma']:+.4f}), K2 mma.sync {med['flash']:.4f},"
          f" SDPA {med['sdpa']:.4f}; the route beat the control in every "
          f"round [{gpu}]", flush=True)
    del x, q, k, v, qs, ks, vs, fns
    torch.cuda.empty_cache()
    return times, launches, med


def _gh_planted_inputs(dev):
    """Phase 20's planted fault's (2, 300, 3, 12, 64) bf16 q/k/v, N(0, 1),
    drawn from seed 20."""
    gen = torch.Generator(device=dev).manual_seed(20)
    return torch.randn((2, 300, 3, 12, 64), generator=gen, device=dev).to(
        torch.bfloat16)


def _gh_planted(lib: Path) -> dict:
    """{G: (torch.equal to K2's wgmma route, max|o - K2|)} of the gh kernel
    from the library ``lib`` on ``_gh_planted_inputs`` at n_real 290, run
    in a process of its own (the copy is that process's only
    attention_probe)."""
    code = (
        "import ctypes, json, sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as C\n"
        "from maest_tpu_torch.ops import _build, attention as A\n"
        "from maest_tpu_torch.ops import attention_probe as P\n"
        f"_build._libs['attention_probe'] = ctypes.CDLL({str(lib)!r})\n"
        "q, k, v = C._gh_planted_inputs(torch.device('cuda')).unbind(2)\n"
        "k2 = A.flash_attention(q, k, v, n_real=290)\n"
        "out = {}\n"
        "for g in P.GROUPS:\n"
        "    o = P.attention_probe_gh(q, k, v, g, 290)\n"
        "    out[g] = (torch.equal(o, k2), C.max_err(o, k2))\n"
        "print(json.dumps(out))\n")
    return {int(g): tuple(r) for g, r in _own_process(code).items()}


def phase_gh_int8(dev, planted_lib):
    """Phase 20: P6e and P6f against the kernels whose function they
    compute and against their plain versions, at the shapes phase 22's rig
    runs them and smaller ones. gh<G>, G 1, 2, 4 and 8 (K2's wgmma kernel
    with G heads a block), must equal K2's wgmma route (``flash_attention``)
    bit for bit, and its control (``attention_probe_gh_mma``, K2's mma.sync
    template with G heads a block) K2's mma.sync kernel
    (``attention_fwd_mma``), at (2, 1676), (32, 1676), (32, 272), (32, 281)
    and (2, 300) n_real 290 on N(0, 1) bf16 inputs, each within PROBE_ULPS
    of its plain version (the route's on 96- or 112-key tiles, the
    control's on 64) at (2, 1676), (32, 272) and (2, 300); the gh kernel
    built with each head after a block's first taking the q of the head
    before (``planted_lib``), in a process of its own, must differ from K2
    at G 2, 4 and 8. int8 on the rig's N(0, 0.5^2) fp32
    inputs at (3, 100), (2, 1676), (32, 1676), (32, 272) and (32, 281):
    each row within INT8_FLIPS p flips of its plain version (plus
    INT8_SUMS of max|o|), and its output times 127 within INT8_X127 of
    fp32 attention. Returns each one's max_abs_err against its plain
    version and plain ms at (32, 1676)."""
    from maest_tpu_torch.ops.attention import (
        attention_fwd_mma,
        attention_reference,
        flash_attention,
    )
    from maest_tpu_torch.ops.attention_probe import (
        GROUPS,
        attention_probe_gh,
        attention_probe_gh_mma,
        attention_probe_gh_mma_reference,
        attention_probe_gh_reference,
        attention_probe_int8,
        attention_probe_int8_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(10)
    out = {"gh_err": 0.0, "gh_mma_err": 0.0, "int8_err": 0.0}
    for b, n, n_real in ((2, 1676, None), (BATCH, 1676, None),
                         (BATCH, 272, None), (BATCH, 281, None),
                         (2, 300, 290)):
        qkv = torch.randn((b, n, 3, 12, 64), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        k2 = flash_attention(q, k, v, n_real=n_real)  # K2's wgmma route
        k2_mma = attention_fwd_mma(q, k, v, n_real)[0]  # and its control
        for g in GROUPS:
            before = (attention_probe_gh.launches[g],
                      attention_probe_gh_mma.launches[g])
            o = attention_probe_gh(q, k, v, g, n_real)
            c = attention_probe_gh_mma(q, k, v, g, n_real)
            torch.cuda.synchronize()
            check((attention_probe_gh.launches[g],
                   attention_probe_gh_mma.launches[g])
                  == (before[0] + 1, before[1] + 1), f"gh{g} counters")
            check(torch.equal(o, k2), f"gh{g} ({b}, {n}) differs from K2's "
                  f"wgmma route by {max_err(o, k2)}")
            check(torch.equal(c, k2_mma), f"gh{g}_mma ({b}, {n}) differs "
                  f"from K2's mma.sync kernel by {max_err(c, k2_mma)}")
        text = ""
        if b == 2 or n == 272:
            r = attention_probe_gh_reference(q, k, v, 8, n_real)
            rc = attention_probe_gh_mma_reference(q, k, v, 8, n_real)
            e, ec = max_err(o, r), max_err(c, rc)
            tol = PROBE_ULPS * bf16_ulp(r.float().abs().max().item())
            check(e <= tol and ec <= tol, f"gh ({b}, {n}) vs plain {e}, "
                  f"control {ec}, bound {tol}")
            out["gh_err"] = max(out["gh_err"], e)
            out["gh_mma_err"] = max(out["gh_mma_err"], ec)
            text = (f"; gh8 vs its plain version (96- or 112-key tiles) "
                    f"{e:.3e}, its control vs its own (64-key tiles) {ec:.3e}"
                    f" <= {tol:.3e}")
            del r, rc
        if (b, n) == (BATCH, 1676):
            out["gh_plain"] = cuda_ms(
                lambda: attention_probe_gh_reference(q, k, v, 8), 3)
            out["gh_mma_plain"] = cuda_ms(
                lambda: attention_probe_gh_mma_reference(q, k, v, 8), 3)
        print(f"phase 20 P6e ({b}, {n}, 12, 64) n_real {n_real} bf16: "
              "gh1/gh2/gh4/gh8 torch.equal to K2's wgmma route, "
              "gh1_mma/gh2_mma/gh4_mma/gh8_mma to K2's mma.sync kernel"
              + text, flush=True)
        del qkv, q, k, v, k2, k2_mma, o, c
    bad = _gh_planted(planted_lib)
    check(bad[1][0] and not any(bad[g][0] for g in (2, 4, 8)),
          f"planted gh previous q {bad}")
    print("phase 20 planted fault, the gh kernel built with each head after "
          "a block's first loading the q of the head before, at (2, 300, 12, "
          "64) n_real 290: " + ", ".join(
              f"gh{g} {'torch.equal to K2' if eq else 'differs from K2'} "
              f"(max {e:.3e})" for g, (eq, e) in bad.items())
          + ": refused at G 2, 4 and 8 (G 1 has no head after its first)",
          flush=True)
    for b, n in ((3, 100), (2, 1676), (BATCH, 1676), (BATCH, 272),
                 (BATCH, 281)):
        qkv = torch.randn((b, n, 3, 12, 64), generator=gen, device=dev) * 0.5
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        before = attention_probe_int8.launches
        o = attention_probe_int8(q, k, v)
        r, l = attention_probe_int8_reference(q, k, v, with_l=True)
        att = attention_reference(q, k, v)
        torch.cuda.synchronize()
        check(attention_probe_int8.launches == before + 1, "int8 counter")
        check(o.dtype == torch.float32 and o.shape == q.shape, "int8 output")
        top = r.abs().max().item()
        row_err = (o - r).abs().amax(dim=-1)
        row_tol = (INT8_FLIPS * v.abs().max().item() / (127 * l)
                   + INT8_SUMS * top)
        e, x127 = max_err(o, r), max_err(o * 127, att)
        check(bool((row_err <= row_tol).all()),
              f"int8 ({b}, {n}) err {e} beyond its rows' bounds")
        check(x127 <= INT8_X127, f"int8 ({b}, {n}) x 127 vs attention {x127}")
        out["int8_err"] = max(out["int8_err"], e)
        if (b, n) == (BATCH, 1676):
            out["int8_plain"] = cuda_ms(
                lambda: attention_probe_int8_reference(q, k, v), 3)
        print(f"phase 20 P6f int8 ({b}, {n}, 12, 64) fp32: max_abs_err vs "
              f"plain {e:.3e} (max|o| {top:.3e}; each row within "
              f"{INT8_FLIPS} p flip, max|v| / (127 l), + {INT8_SUMS} max|o|: "
              f"the tightest row's bound {row_tol.min().item():.3e}); its "
              f"output x 127 vs fp32 attention {x127:.3e} <= {INT8_X127} "
              "(the rig's output is attention / 127)", flush=True)
        del qkv, q, k, v, o, r, l, att
        torch.cuda.empty_cache()
    return out


def phase_vpu_kernels(dev):
    """Phase 21: the five P5 kinds against their plain versions at
    (3, 100), (2, 1676) and (32, 1676) on the rig's N(0, 0.3^2) bf16
    inputs, within the bounds stated at VPU_VS_K2; against K2 by relative
    L2 distance: within VPU_VS_K2 but for fp8nomask, which must lie
    farther at N 1676. Returns each kind's max_abs_err and plain ms at
    (32, 1676)."""
    from maest_tpu_torch.ops.attention import flash_attention
    from maest_tpu_torch.ops.attention_vpu import (
        KINDS,
        PLAIN_REL_L2,
        attention_vpu_probe,
        attention_vpu_probe_reference,
        plain_gap,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    err, plain = dict.fromkeys(KINDS, 0.0), {}
    for b, n in ((3, 100), (2, 1676), (BATCH, 1676)):
        qkv = (torch.randn((b, n, 3, 12, 64), generator=gen, device=dev)
               * 0.3).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        k2 = flash_attention(q, k, v).float()
        parts = []
        for kind in KINDS:
            before = attention_vpu_probe.launches[kind]
            o = attention_vpu_probe(q, k, v, kind)
            r = attention_vpu_probe_reference(q, k, v, kind)
            torch.cuda.synchronize()
            check(attention_vpu_probe.launches[kind] == before + 1,
                  f"{kind} counter")
            e, tol, rel = plain_gap(kind, o, r)
            vs = ((o.float() - k2).norm() / k2.norm()).item()
            check(e <= tol and rel <= PLAIN_REL_L2,
                  f"{kind} ({b}, {n}) err {e} > {tol} or relative L2 {rel} "
                  f"> {PLAIN_REL_L2}")
            if kind != "fp8nomask":
                check(vs <= VPU_VS_K2, f"{kind} ({b}, {n}) vs K2 {vs}")
            elif n == 1676:
                check(vs > VPU_VS_K2, f"fp8nomask ({b}, {n}) within {vs} of K2")
            err[kind] = max(err[kind], e)
            parts.append(f"{kind} {e:.3e} <= {tol:.3e}, relative L2 "
                         f"{rel:.2e} <= {PLAIN_REL_L2}; vs K2 {vs:.2e}")
            if b == BATCH:
                plain[kind] = cuda_ms(
                    lambda: attention_vpu_probe_reference(q, k, v, kind), 3)
            del o, r
        print(f"phase 21 P5 kinds ({b}, {n}, 12, 64) bf16 max_abs_err vs "
              f"plain (relative L2 vs K2 <= {VPU_VS_K2} but fp8nomask, "
              f"farther at N 1676): " + "; ".join(parts), flush=True)
        del qkv, q, k, v, k2
        torch.cuda.empty_cache()
    return err, plain


GH_VARIANTS = ("flash", "wgmma", "gh1", "gh2", "gh4", "gh8", "gh1_mma",
               "gh2_mma", "gh4_mma", "gh8_mma", "int8", "sdpa")
GH_ROUNDS = 3  # interleaved rounds of phase 22's rig


def phase_rigs(gpu):
    """Phase 22: the slice's path, both rigs as a user runs them, here
    their ``main`` in process (each prints the card's name and power limit
    first): ``python -m maest_tpu_torch.probes.attn_profile --variants
    flash,wgmma,gh1,...,gh8_mma,int8,sdpa --shapes 30s,5s,10s-train
    --rounds 3`` (each gh<G> beside K2's wgmma kernel, each gh<G>_mma beside
    the mma.sync control, SDPA beside both, by CUDA-graph replays in
    interleaved rounds) and ``python -m maest_tpu_torch.probes.attn_vpu``,
    with the launch counters of K2 (both kernels), gh, its control, int8 and
    the P5 kinds set to 0 just before and read just after: each kernel must
    have run and every variant and kind must have a graph time. At 30s,
    gh8 must beat SDPA and its control (medians of the rounds), and each
    G's median is printed beside the wave-count prediction (K2's median
    times the busiest SM's head-tiles at G over G 1's). Returns both rigs'
    results and the launches."""
    from maest_tpu_torch.ops.attention import attention_fwd_mma, flash_attention
    from maest_tpu_torch.ops.attention_probe import (
        GROUPS,
        attention_probe_gh,
        attention_probe_gh_mma,
        attention_probe_int8,
    )
    from maest_tpu_torch.ops.attention_vpu import attention_vpu_probe
    from maest_tpu_torch.probes import attn_profile, attn_vpu

    args = ["--variants", ",".join(GH_VARIANTS), "--shapes",
            "30s,5s,10s-train", "--batch", str(BATCH), "--rounds",
            str(GH_ROUNDS)]
    print("phase 22 rigs: python -m maest_tpu_torch.probes.attn_profile "
          + " ".join(args) + "; python -m maest_tpu_torch.probes.attn_vpu",
          flush=True)
    attention_fwd_mma.launches = 0
    flash_attention.launches = 0
    attention_probe_int8.launches = 0
    for counts in (attention_probe_gh.launches,
                   attention_probe_gh_mma.launches,
                   attention_vpu_probe.launches):
        for key in counts:
            counts[key] = 0
    times = attn_profile.main(args)
    vpu = attn_vpu.main([])
    # the rigs' "flash" and "ctrl" are K2's mma.sync kernel, the control;
    # "wgmma" K2's wgmma route
    launches = {"flash": attention_fwd_mma.launches,
                "wgmma": flash_attention.launches,
                **{f"gh{g}": c for g, c in attention_probe_gh.launches.items()},
                **{f"gh{g}_mma": c
                   for g, c in attention_probe_gh_mma.launches.items()},
                "int8": attention_probe_int8.launches,
                **attention_vpu_probe.launches}
    check(all(launches.values()), f"rig launches {launches}")
    for rows in times.values():
        check(all(r["graph_ms"] > 0 for r in rows.values()),
              f"rig graph times {rows}")
        check(all(r["round_median"] > 0 for r in rows.values()),
              f"rig rounds {rows}")
        check(0 < rows["int8"]["kernel_ms"] < rows["int8"]["ms"],
              f"int8 split {rows['int8']}")
    check(all(r["graph_ms"] > 0 for r in vpu.values()),
          f"vpu graph times {vpu}")
    med = {k: r["round_median"] for k, r in times["30s"].items()}
    check(med["gh8"] < med["sdpa"] and med["gh8"] < med["gh8_mma"],
          f"gh8 at 30s against SDPA and its control {med}")
    tiles1 = gh_head_tiles(1)
    print(f"phase 22 P6e at ({BATCH}, 1676, 12, 64), medians of {GH_ROUNDS} "
          "interleaved rounds of CUDA-graph replays, against the wave-count "
          "prediction (K2 wgmma x the busiest SM's head-tiles / G 1's): "
          + ", ".join(
              f"gh{g} {med[f'gh{g}']:.4f} ms (predicted "
              f"{med['wgmma'] * gh_head_tiles(g) / tiles1:.4f}: "
              f"{gh_head_tiles(g)} head-tiles; control {med[f'gh{g}_mma']:.4f})"
              for g in GROUPS)
          + f"; K2 wgmma {med['wgmma']:.4f}, K2 mma.sync {med['flash']:.4f}, "
          f"SDPA {med['sdpa']:.4f} [{gpu}]", flush=True)
    print(f"phase 22 launches in the rigs' run: {launches}", flush=True)
    return times, vpu, launches


def _queue3_routes(dev):
    """Phase 23's path, as a user takes it, with the launch counters set to
    0 just before and read just after: ``get_maest`` at head_dim 16 (embed
    192, 12 heads, depth 2) tagging a 30 s clip through K2 on zero-padded
    inputs, fp32 against the same weights on the CPU (plain attention) and
    bf16 against the fp32 tier; then one step of the 30 s recipe in fp32
    (ViT-B, batch 2, N 866: attention at (2, 866, 12, 64), the shape
    phase 23 holds both kernels to their plain versions at) with
    attention_quant qk8 and attention_bwd_quant int8, through the fp32
    instances of K5 (with lse) and K7. Returns the launches: K2 and the
    fp32 K5 and K7."""
    from maest_tpu_torch import get_maest

    _reset_counts()
    small = dict(pretrained=False, embed_dim=192, depth=2, num_heads=12,
                 n_classes=16)
    cpu = get_maest(device="cpu", **small)
    heads = torch.Generator().manual_seed(14)  # zero heads would hide all
    with torch.no_grad():
        for lin in (cpu.net.head[1], cpu.net.head_dist):
            lin.weight.normal_(0.0, 0.2, generator=heads)
    card = {dt: get_maest(device=dev, dtype=dt, **small)
            for dt in (torch.float32, torch.bfloat16)}
    for m in card.values():
        m.net.load_state_dict(cpu.net.state_dict())
    wave = np.random.default_rng(14).standard_normal(CLIP).astype(
        np.float32) * 0.3
    ref = cpu.predict_labels(wave)[0]
    got = {dt: m.predict_labels(wave)[0] for dt, m in card.items()}
    e32 = float(np.abs(got[torch.float32] - ref).max())
    e16 = float(np.abs(got[torch.bfloat16] - got[torch.float32]).max())
    check(e32 <= 2e-4 * float(np.abs(ref).max()) + 2e-5 and e16 <= TIER_TOL
          and np.ptp(ref) > 1e-2, f"head_dim 16 tagging fp32 {e32} bf16 "
          f"{e16}, activations spread {np.ptp(ref)}")
    k2 = _q8_counts()[1][0]
    del cpu, card
    _, mcfg, net, state, step, data = _recipe(
        dev, RECIPE, 2, 5, ["maest.attention_quant=qk8",
                            "maest.attention_bwd_quant=int8"],
        dtype=torch.float32)
    drawn = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        for lin in (net.head[1], net.head_dist):
            lin.weight.normal_(0.0, 0.05, generator=drawn)
    before = _q8_counts()[1]
    _, metrics = step(state, data, torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    grew = [a - b for a, b in zip(_q8_counts()[1], before)]
    check(grew == [0, 0, 0, mcfg.depth, 0, mcfg.depth]
          and metrics["nonfinite_skipped"] == 0.0
          and np.isfinite(metrics["train_loss"])
          and abs(metrics["train_loss"] - np.log(2)) > 1e-3,
          f"fp32 qk8+int8 recipe step: launches {grew}, {metrics}")
    counts = _q8_counts()[1]
    launches = {"k2": k2, "fwd_q8_fp32": counts[3] + counts[4],
                "k7_fp32": counts[5]}
    check(all(launches.values()), f"queue 3 routes launches {launches}")
    print(f"phase 23 routes: get_maest head_dim 16 (embed 192, 12 heads, "
          f"depth 2) tagging a 30 s clip through K2 on zero-padded inputs: "
          f"fp32 vs the CPU's plain attention max_abs_err {e32:.3e}, bf16 vs "
          f"fp32 {e16:.3e} <= {TIER_TOL} (activations spread over "
          f"{np.ptp(ref):.3f}); {RECIPE} in fp32 batch 2 with "
          f"attention_quant qk8 and attention_bwd_quant int8: launches (K2, "
          f"K3a, K3b, K5, K6, K7) {grew}, loss "
          f"{metrics['train_loss']:.6f}; launches in the routes' run "
          f"{launches}", flush=True)
    del net, state, step, data
    torch.cuda.empty_cache()
    return launches


def phase_queue3(dev, gpu):
    """Phase 23: ROADMAP queue 3 on the card. First its path
    (``_queue3_routes``). Then head_dim 16 and 32 run K2, K3a and K3b on
    zero-padded inputs: the forward, lse and backward against their plain
    versions at (4, 281, 12, d) in bf16 and fp32, and K5/K6 and K7 at d 32
    in fp32; head_dim 96 (zero-padded) and 128 run the D = 128 instances of
    K2, K3a, K3b, K5/K6 in every mode and K7, in bf16 and fp32, and head_dim
    192 (zero-padded) and 256 the D = 256 instances, and head_dim 320 and
    512 the runtime-width (_dn) instances of K2, K3a, K3b, K5/K6 in every
    mode and K7 (bf16 and fp32), each against its plain version within the
    bound head_dim 64 is held to, each launch counted; K3b's _dn
    instance also at K4's shape, (1, 4500, 2, 320) n_real 4400. fp32 under
    every 8-bit mode runs the fp32 instances of K5/K6
    (with lse, as the recipe step launches them) and K7: against
    attention_q8_reference and attention_bwd_int8_reference at the path's
    (2, 866, 12, 64), with the launch counters checked and the times; K7's
    gradients rounded to bf16 fail its bound (plain with delta in the
    kernel's order, ``k7_delta``). Returns the errors, times,
    the path's launches and the launches of the 8-bit _dn instances."""
    from maest_tpu_torch.ops import attention as A

    launches = _queue3_routes(dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    dn8 = {"int8": 0, "fp8": 0, "k7": 0}  # the 8-bit _dn launches
    for d in (16, 32, 96, 128, 192, 256, 320, 512):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            x = torch.randn((4, 281, 5, 12, d), generator=gen, device=dev).to(
                dtype)
            q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
            before = _q8_counts()[1]
            o, lse = A.flash_attention_fwd_lse(q, k, v)
            o2 = A.flash_attention(q, k, v, n_real=270)
            ro, rlse = A.attention_reference_lse(q, k, v)
            grads = A.attention_bwd(q, k, v, ro, rlse, g)
            ref = A.attention_bwd_reference(q, k, v, ro, rlse, g)
            torch.cuda.synchronize()
            grew = [a - b for a, b in zip(_q8_counts()[1], before)]
            check(grew[:3] == [1, 1, 1], f"d{d} {name} launches {grew}")
            tol = ATTN_TOL[name]
            e = max([max_err(o, ro), max_err(o2, A.attention_reference(
                q, k, v, 270))] + [max_err(a, r) for a, r in zip(grads, ref)])
            el = max_err(lse, rlse)
            check(e <= tol and el <= LSE_TOL and o.shape == q.shape
                  and grads[0].shape == q.shape, f"d{d} {name} err {e} {el}")
            pad = ("" if A.padded_dim(d) == d else
                   f" on inputs zero-padded to {A.padded_dim(d)}")
            if d > A.HEAD_DIMS[-1]:
                pad += " (the _dn instances)"
            line = (f"phase 23 head_dim {d} {name}: (4, 281, 12, {d}) K2, K3a "
                    f"and K3b{pad} vs plain max_abs_err {e:.3e} <= {tol}, lse "
                    f"{el:.3e} <= {LSE_TOL}")
            if d > 64 or (d == 32 and dtype == torch.float32):
                counted = [A.attention_fwd_int8.launches,
                           A.attention_fwd_fp8.launches,
                           A.attention_bwd_int8.launches]
                line += ("; " + _q8_fwd_vs_plain(q, k, v) + "; "
                         + _k7_vs_plain(q, k, v, ro, rlse, g))
                if d > A.HEAD_DIMS[-1]:
                    for key, f, c in zip(dn8, (A.attention_fwd_int8,
                                               A.attention_fwd_fp8,
                                               A.attention_bwd_int8), counted):
                        dn8[key] += f.launches - c
            print(line, flush=True)
            del x, q, k, v, g, o, o2, lse, ro, rlse, grads, ref

    x = torch.randn((2, 866, 5, 12, 64), generator=gen, device=dev)
    q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    out = {"fwd_err": 0.0, "ms": {}, "alone": {}}
    for mode in Q8_MODES:
        kind = "int8" if mode.startswith("qk8") else "fp8"
        wrap = getattr(A, f"attention_fwd_{kind}")
        pv8 = mode.endswith("pv8")
        before = wrap.launches
        o, lse = wrap(q, k, v, None, pv8, with_lse=True)
        ro, rlse = A.attention_q8_reference(q, k, v, None, mode)
        torch.cuda.synchronize()
        check(wrap.launches == before + 1 and o.dtype == torch.float32,
              f"{mode} fp32 counter")
        e, rel = _q8_fp32_gap(mode, o, ro)
        el = max_err(lse, rlse)
        check(el <= LSE_TOL, f"{mode} fp32 lse {el}")
        out["fwd_err"] = max(out["fwd_err"], e, el)
        def run():
            return wrap(q, k, v, None, pv8, with_lse=True)

        out["ms"][mode] = (cuda_ms_median(run, 10), cuda_ms(
            lambda: A.attention_q8_reference(q, k, v, None, mode), 3))
        out["alone"][mode] = _kernel_ms(
            run, {"kernel": (r"attn_fwd_q8_kernel", 1)})
        print(f"phase 23 fp32 {mode} (the fp32 instance of "
              f"{'K5' if kind == 'int8' else 'K6'}) with lse: (2, 866, 12, 64) "
              f"max_abs_err {e:.3e}, relative L2 {rel:.3e}, lse {el:.3e} <= "
              f"{LSE_TOL}; time: wrapper {out['ms'][mode][0]:.4f} ms, plain "
              f"{out['ms'][mode][1]:.4f} ms, kernel alone (torch.profiler) "
              f"{_fmt_ms(out['alone'][mode])} [{gpu}]", flush=True)
        del o, lse, ro, rlse
    # K7 on the route's o and lse (the tf32 forward's), against plain with
    # delta summed in the kernel's order (k7_delta): plain's own order puts
    # delta an fp32 ulp away on some rows, which can flip a ds8 code on a
    # rounding edge
    o, lse = A.flash_attention_fwd_lse(q, k, v)
    before = A.attention_bwd_int8.launches
    got = A.attention_bwd_int8(q, k, v, o, lse, g)
    ref = A.attention_bwd_int8_reference(q, k, v, o, lse, g,
                                         delta=A.k7_delta(o, g))
    torch.cuda.synchronize()
    check(A.attention_bwd_int8.launches == before + 1
          and got[0].dtype == torch.float32, "K7 fp32 counter")
    parts, out["k7_err"] = [], 0.0
    for w, a, r in zip(("dq", "dk", "dv"), got, ref):
        e, top, cos = max_err(a, r), r.abs().max().item(), cosine(a, r)
        e16 = max_err(a.bfloat16(), r)  # planted: fp32 gradients as bf16
        check(e <= K7F32_TOL * top and cos >= K7_COS
              and e16 > K7F32_TOL * top, f"K7 fp32 {w} {e} {cos} {e16}")
        out["k7_err"] = max(out["k7_err"], e)
        parts.append(f"{w} {e:.3e} ({e / top:.2e} of max, cos {cos:.6f}; "
                     f"rounded to bf16 {e16 / top:.2e} of max)")
    # more draws, on the route's and the FMA control's o and lse: plain
    # with the kernel's delta holds every row within K7F32_TOL; plain's own
    # delta is counted (rows beyond K7F32_TOL), for the record
    def beyond(got, ref):
        return sum(int(((a - r).abs().amax(dim=-1) > K7F32_TOL
                        * r.abs().max()).sum()) for a, r in zip(got, ref))
    flips = {"own": beyond(got, A.attention_bwd_int8_reference(
        q, k, v, o, lse, g)), "kernel": 0}
    draws = torch.Generator(device=dev).manual_seed(23)
    for _ in range(4):
        qd, kd, vd, gd = torch.randn((2, 866, 4, 12, 64), generator=draws,
                                     device=dev).unbind(2)
        for od, ld in (A.flash_attention_fwd_lse(qd, kd, vd),
                       A.attention_fwd_fp32_fma(qd, kd, vd, None, True)):
            gotd = A.attention_bwd_int8(qd, kd, vd, od, ld, gd)
            flips["own"] += beyond(gotd, A.attention_bwd_int8_reference(
                qd, kd, vd, od, ld, gd))
            flips["kernel"] += beyond(gotd, A.attention_bwd_int8_reference(
                qd, kd, vd, od, ld, gd, delta=A.k7_delta(od, gd)))
    check(flips["kernel"] == 0, f"K7 fp32 against plain with the kernel's "
          f"delta, rows beyond {K7F32_TOL}: {flips}")
    out["k7_ms"] = (cuda_ms_median(
        lambda: A.attention_bwd_int8(q, k, v, o, lse, g), 10),
        cuda_ms(lambda: A.attention_bwd_int8_reference(q, k, v, o, lse, g), 3))
    out["launches"] = launches
    print(f"phase 23 K7 fp32 (2, 866, 12, 64) on the route's o and lse, plain "
          f"with the kernel's delta: max_abs_err "
          + ", ".join(parts) + f": <= {K7F32_TOL} of max, cos >= {K7_COS},"
          " and the bf16-rounded gradients fail it; over this draw and 4 "
          "more on the route's and the FMA control's o and lse, rows (b, n, "
          f"h) beyond {K7F32_TOL} of max: {flips['kernel']} with the "
          f"kernel's delta, {flips['own']} with plain's own; "
          f"time: kernel {out['k7_ms'][0]:.4f} ms, plain {out['k7_ms'][1]:.4f}"
          f" ms [{gpu}]", flush=True)
    del x, q, k, v, g, o, lse, got, ref
    out["k4_dn_err"] = _k4_dn(dev, gen)
    check(all(dn8.values()), f"8-bit _dn launches {dn8}")
    out["dn8_launches"] = dn8
    print(f"phase 23 the 8-bit _dn instances at head_dim 320 and 512 in bf16 "
          f"and fp32, launches (K5, K6, K7): {dn8}", flush=True)
    torch.cuda.empty_cache()
    return out


def _k4_dn(dev, gen):
    """K3b's _dn instance at K4's shape, (1, 4500, 2, 320) n_real 4400,
    bf16 and fp32: the forward with lse and the backward against their
    plain versions within head_dim 64's bounds, each launch counted.
    Returns the largest gradient error."""
    from maest_tpu_torch.ops import attention as A

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        x = torch.randn((1, 4500, 4, 2, 320), generator=gen, device=dev).to(
            dtype)
        q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
        before = _q8_counts()[1]
        o, lse = A.flash_attention_fwd_lse(q, k, v, n_real=4400)
        ro, rlse = A.attention_reference_lse(q, k, v, 4400)
        grads = A.attention_bwd(q, k, v, ro, rlse, g, 4400)
        ref = A.attention_bwd_reference(q, k, v, ro, rlse, g, 4400)
        torch.cuda.synchronize()
        grew = [a - b for a, b in zip(_q8_counts()[1], before)]
        tol = ATTN_TOL[name]
        e = max(max_err(a, r) for a, r in zip(grads, ref))
        eo, el = max_err(o, ro), max_err(lse, rlse)
        check(grew[1:3] == [1, 1] and max(e, eo) <= tol and el <= LSE_TOL
              and not grads[1][:, 4400:].any(),
              f"K4 shape d320 {name}: launches {grew}, err {e} {eo} {el}")
        worst = max(worst, e)
        print(f"phase 23 K4's shape (1, 4500, 2, 320) n_real 4400 {name}: "
              f"K3a and K3b (_dn) vs plain max_abs_err o {eo:.3e}, dq/dk/dv "
              f"{e:.3e} <= {tol}, lse {el:.3e} <= {LSE_TOL}; masked keys' dk, "
              f"dv zero", flush=True)
        del x, q, k, v, g, o, lse, ro, rlse, grads, ref
    return worst


def _q8_fwd_vs_plain(q, k, v):
    """Every K5/K6 mode, with and without lse, against
    attention_q8_reference, each launch counted, within the bounds head_dim
    64 is held to: in bf16 Q8_ULPS bf16 ulps of max|o| (phase 13), in fp32
    ``_q8_fp32_gap``; lse within LSE_TOL. Returns the line's text."""
    from maest_tpu_torch.ops import attention as A

    parts = []
    for mode in Q8_MODES:
        wrap = getattr(A, "attention_fwd_int8" if mode.startswith("qk8")
                       else "attention_fwd_fp8")
        pv8 = mode.endswith("pv8")
        before = wrap.launches
        o, none = wrap(q, k, v, None, pv8)
        o2, lse = wrap(q, k, v, None, pv8, with_lse=True)
        ro, rlse = A.attention_q8_reference(q, k, v, None, mode)
        torch.cuda.synchronize()
        check(wrap.launches == before + 2 and none is None,
              f"{mode} {tuple(q.shape)} counter")
        el = max_err(lse, rlse)
        check(el <= LSE_TOL, f"{mode} {tuple(q.shape)} lse {el}")
        if q.dtype == torch.bfloat16:
            tol = Q8_ULPS * bf16_ulp(ro.float().abs().max().item())
            e = max(max_err(o, ro), max_err(o2, ro))
            check(e <= tol, f"{mode} {tuple(q.shape)} err {e} > {tol}")
            parts.append(f"{mode} {e:.3e} <= {tol:.3e}")
        else:
            gaps = [_q8_fp32_gap(mode, x, ro) for x in (o, o2)]
            parts.append(f"{mode} {max(x[0] for x in gaps):.3e} (relative "
                         f"L2 {max(x[1] for x in gaps):.2e})")
        del o, o2, lse, ro, rlse
    return (f"the {str(q.dtype).split('.')[1]} 8-bit forward with and "
            "without lse vs plain max_abs_err " + ", ".join(parts)
            + f", lse <= {LSE_TOL}")


def _k7_vs_plain(q, k, v, o, lse, g):
    """K7 against attention_bwd_int8_reference on the same saved tensors,
    its launch counted, within the bound head_dim 64 is held to: K7_TOL
    (bf16, phase 15) or K7F32_TOL (fp32) of each gradient's max, and a
    cosine of at least K7_COS. Returns (the line's text, the worst error
    relative to its gradient's max)."""
    from maest_tpu_torch.ops import attention as A

    before = A.attention_bwd_int8.launches
    got = A.attention_bwd_int8(q, k, v, o, lse, g)
    ref = A.attention_bwd_int8_reference(q, k, v, o, lse, g)
    torch.cuda.synchronize()
    check(A.attention_bwd_int8.launches == before + 1
          and got[0].dtype == q.dtype, f"K7 {tuple(q.shape)} counter")
    tol = K7_TOL if q.dtype == torch.bfloat16 else K7F32_TOL
    flips = q.dtype == torch.float32 and q.shape[-1] > A.HEAD_DIMS[-1]
    parts = []
    for w, a, r in zip(("dq", "dk", "dv"), got, ref):
        top = r.float().abs().max().item()
        err = (a.float() - r.float()).abs()
        e = err.max().item() / top
        cos = cosine(a, r)
        if flips:  # rows moved by a flipped code, the rest within tol
            rows = int((err.amax(dim=-1) > tol * top).sum())
            ok = rows <= K7F32_FLIP_ROWS and e <= K7_TOL
        else:
            rows, ok = 0, e <= tol
        check(ok and cos >= K7_COS,
              f"K7 {tuple(q.shape)} {w} {e} of max, {rows} rows, cos {cos}")
        parts.append(f"{w} {e:.2e} of max (cos {cos:.6f}"
                     + (f", {rows} rows beyond {tol}" if flips else "") + ")")
    bound = (f"<= {tol} but for at most {K7F32_FLIP_ROWS} rows, all <= "
             f"{K7_TOL}" if flips else f"<= {tol}")
    return (f"K7 {str(q.dtype).split('.')[1]} vs plain " + ", ".join(parts)
            + f" {bound}, cos >= {K7_COS}")


def _q8_fp32_gap(mode, o, r):
    """(max_abs_err, relative L2) of an fp32 8-bit forward against its
    plain version, checked against the bound of its mode (Q8F32_REL_L2)."""
    e = max_err(o, r)
    rel = ((o - r).norm() / r.norm()).item()
    if mode.endswith("pv8"):
        tol = Q8_ULPS * bf16_ulp(r.abs().max().item())
        check(e <= tol, f"{mode} fp32 err {e} > {tol}")
    else:
        check(rel <= Q8F32_REL_L2, f"{mode} fp32 relative L2 {rel}")
    return e, rel


def _tile_gap(o, r):
    """(max_abs_err, relative L2, bound) of a P9/P7 forward against its
    plain version, checked: PROBE_ULPS bf16 ulps of max|o| and TILE_REL_L2."""
    tol = PROBE_ULPS * bf16_ulp(r.float().abs().max().item())
    e = max_err(o, r)
    rel = ((o.float() - r.float()).norm() / r.float().norm()).item()
    return e, rel, tol, e <= tol and rel <= TILE_REL_L2


FWD_SHAPES = ((BATCH, 272), (BATCH, 281), (BATCH, 1676), (100, 281))
BWD_SHAPES = ((BATCH, 281), (BATCH, 866))


def phase_tile_kernels(dev):
    """Phase 24: P9 and P7 against their plain versions at every shape a
    phase launches them at, N(0, 1) bf16 inputs: qpad (G 1, 8, 12, 24) and
    each of the nine forward tiles, with and without lse, at (32, 272),
    (32, 281), (32, 1676) and (100, 281) within PROBE_ULPS bf16 ulps of
    max|o| and TILE_REL_L2, lse within LSE_TOL; every qpad and every tile
    (q rows, 64) equal to K2 (and K3a) bit for bit (their mma.sync
    kernel, the control of the wgmma one: ``attention_fwd_mma``); the nine
    backward tiles
    at (32, 281) and (32, 866) within phase 9's bound of
    attention_bwd_reference and equal bit for bit to K3b's mma.sync
    kernels (the control of the wgmma backward: ``attention_bwd_mma``; a
    tile changes which block holds a warp's rows, not the order of its
    sums: the rows
    past N that a longer last tile adds contribute exact zeros). A zero
    output and the
    last tile's zero keys left unmasked fail the forward check. Returns the
    errors and the plain versions' ms at the kernels line's shapes."""
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.ops import attention_probe as P

    gen = torch.Generator(device=dev).manual_seed(13)
    out = {"qpad_err": 0.0, "tile_err": 0.0, "bwd_err": 0.0, "plain": {}}
    for b, n in FWD_SHAPES:
        x = torch.randn((b, n, 3, 12, 64), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = x.unbind(2)
        # K2 and K3a's mma.sync kernel, the template qpad and the tiles change
        k2 = A.attention_fwd_mma(q, k, v)[0]
        k3a = A.attention_fwd_mma(q, k, v, with_lse=True)
        worst = [0.0, 0.0]
        for g in P.QPAD_GROUPS:
            if b * 12 % g:
                continue
            before = P.attention_probe_qpad.launches[g]
            o = P.attention_probe_qpad(q, k, v, g)[0]
            ol, lse = P.attention_probe_qpad(q, k, v, g, with_lse=True)
            r, rl = P.attention_probe_qpad_reference(q, k, v, g, True)
            torch.cuda.synchronize()
            check(P.attention_probe_qpad.launches[g] == before + 2,
                  f"qpad G{g} counter")
            e, rel, tol, ok = _tile_gap(o, r)
            el = max_err(lse, rl)
            check(ok and el <= LSE_TOL, f"qpad G{g} ({b}, {n}) err {e} "
                  f"relative L2 {rel} lse {el}")
            check(torch.equal(o, k2) and torch.equal(ol, k3a[0])
                  and torch.equal(lse, k3a[1]), f"qpad G{g} ({b}, {n}) "
                  "differs from K2 / K3a")
            out["qpad_err"] = max(out["qpad_err"], e, el)
            worst[0] = max(worst[0], e)
            if (b, n, g) == (100, 281, 1):
                out["plain"]["qpad"] = cuda_ms(
                    lambda: P.attention_probe_qpad_reference(q, k, v, 1), 3)
        for qr in P.Q_ROWS:
            for kt in P.KEY_TILES:
                before = P.attention_probe_tile.launches[(qr, kt)]
                o = P.attention_probe_tile(q, k, v, qr, kt)[0]
                ol, lse = P.attention_probe_tile(q, k, v, qr, kt, True)
                r, rl = P.attention_probe_tile_reference(q, k, v, qr, kt,
                                                         True)
                torch.cuda.synchronize()
                check(P.attention_probe_tile.launches[(qr, kt)] == before + 2,
                      f"tile {qr}x{kt} counter")
                e, rel, tol, ok = _tile_gap(o, r)
                el = max_err(lse, rl)
                check(ok and el <= LSE_TOL and torch.equal(o, ol),
                      f"tile {qr}x{kt} ({b}, {n}) err {e} relative L2 {rel} "
                      f"lse {el}")
                if kt == 64:
                    check(torch.equal(o, k2) and torch.equal(lse, k3a[1]),
                          f"tile {qr}x64 ({b}, {n}) differs from K2 / K3a")
                out["tile_err"] = max(out["tile_err"], e, el)
                worst[1] = max(worst[1], e)
                if (b, qr) == (BATCH, 128) and n == 281:
                    out["plain"][("tile", kt)] = cuda_ms(
                        lambda: P.attention_probe_tile_reference(
                            q, k, v, 128, kt), 3)
        if (b, n) == (BATCH, 281):  # the check refuses planted faults
            r = P.attention_probe_tile_reference(q, k, v, 128, 64)[0]
            zero = _tile_gap(torch.zeros_like(r), r)
            pad = -(-n // 64) * 64 - n  # the last tile's zero keys, unmasked
            kz, vz = (torch.cat([t, t.new_zeros((b, pad, 12, 64))], 1)
                      for t in (k, v))
            qz = torch.cat([q, q.new_zeros((b, pad, 12, 64))], 1)
            unmasked = P._walk(qz, kz, vz, "flash", n + pad)[:, :n]
            nomask = _tile_gap(unmasked, r)
            check(not zero[3] and not nomask[3], "planted faults pass")
            print(f"phase 24 planted faults at ({b}, {n}): a zero output "
                  f"(relative L2 {zero[1]:.3f}) and the last tile's {pad} "
                  f"zero keys unmasked (max_abs_err {nomask[0]:.3e} > "
                  f"{nomask[2]:.3e}, relative L2 {nomask[1]:.3e} > "
                  f"{TILE_REL_L2}) fail the check", flush=True)
        print(f"phase 24 P9 qpad G1/8/12/24 and P7 tiles (64, 128, 256) x "
              f"(32, 64, 128) ({b}, {n}, 12, 64) bf16 with and without lse: "
              f"max_abs_err vs plain qpad {worst[0]:.3e}, tiles "
              f"{worst[1]:.3e} <= {PROBE_ULPS} bf16 ulps of max|o|, relative"
              f" L2 <= {TILE_REL_L2}, lse <= {LSE_TOL}; every qpad and tile "
              "(q rows, 64) torch.equal to K2 and K3a", flush=True)
        del x, q, k, v, k2, k3a
        torch.cuda.empty_cache()
    for b, n in BWD_SHAPES:
        x = torch.randn((b, n, 4, 12, 64), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v, do = x.unbind(2)
        o, lse = A.flash_attention_fwd_lse(q, k, v)
        k3b = A.attention_bwd_mma(q, k, v, o, lse, do)  # their own kernels
        ref = A.attention_bwd_reference(q, k, v, o, lse, do)
        worst = 0.0
        for rows in P.BWD_TILES:
            for tile in P.BWD_TILES:
                before = P.attention_bwd_tile.launches[(rows, tile)]
                got = P.attention_bwd_tile(q, k, v, o, lse, do, rows, tile)
                torch.cuda.synchronize()
                check(P.attention_bwd_tile.launches[(rows, tile)]
                      == before + 1, f"bwd tile {rows}x{tile} counter")
                e = max(max_err(a, r) for a, r in zip(got, ref))
                check(e <= ATTN_TOL["bfloat16"], f"bwd tile {rows}x{tile} "
                      f"({b}, {n}) err {e}")
                check(all(torch.equal(a, r) for a, r in zip(got, k3b)),
                      f"bwd tile {rows}x{tile} ({b}, {n}) differs from K3b's "
                      "control by " + ", ".join(f"{max_err(a, r):.3e}"
                                                for a, r in zip(got, k3b)))
                worst = max(worst, e)
        out["bwd_err"] = max(out["bwd_err"], worst)
        if n == 866:
            out["plain"]["bwd"] = cuda_ms(
                lambda: A.attention_bwd_reference(q, k, v, o, lse, do), 3)
        print(f"phase 24 P7 backward tiles (32, 64, 128) x (32, 64, 128) "
              f"({b}, {n}, 12, 64) bf16: max_abs_err vs plain {worst:.3e} <= "
              f"{ATTN_TOL['bfloat16']}; every tile torch.equal to K3b's "
              "mma.sync control (attention_bwd_mma)", flush=True)
        del x, q, k, v, do, o, lse, k3b, ref
        torch.cuda.empty_cache()
    return out


def phase_tune_rigs():
    """Phase 25: the slice's path, both rigs as a user runs them, here their
    ``main`` in process (each prints the card's name and power limit
    first): ``python -m maest_tpu_torch.probes.qpad --shapes
    100x281,32x272,32x281,32x1676``, ``python -m
    maest_tpu_torch.probes.attn_tune --archs 30s,10s-train`` (N 1676 and
    281) and ``--bwd --archs 30s-train,10s-train`` (N 866 and 281), with the
    launch counters of K2, K3a, K3b, their controls, the qpad groups and
    the tiles set to 0 just before and read just after: each must have
    run. Then the tile
    with the lowest median over the sweep's rounds, forward at (32, 281)
    and backward at (32, 866), is timed again on its own, so the kernels
    line does not take the fastest of nine noisy readings (CUDA-graph
    replays, as the sweep times them). Returns the
    rigs' results, those times and the launches."""
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.ops import attention_probe as P
    from maest_tpu_torch.probes import attn_tune, qpad
    from maest_tpu_torch.probes.attn_profile import _inputs

    args = (["--shapes", "100x281,32x272,32x281,32x1676"],
            ["--archs", "30s,10s-train"],
            ["--bwd", "--archs", "30s-train,10s-train"])
    print("phase 25 rigs: python -m maest_tpu_torch.probes.qpad "
          + " ".join(args[0]) + "; python -m maest_tpu_torch.probes."
          "attn_tune " + " ".join(args[1]) + "; ... attn_tune "
          + " ".join(args[2]), flush=True)
    _reset_counts()
    A.attention_fwd_mma.launches = A.attention_bwd_mma.launches = 0
    for counts in (P.attention_probe_qpad.launches,
                   P.attention_probe_tile.launches,
                   P.attention_bwd_tile.launches):
        for key in counts:
            counts[key] = 0
    res = {"qpad": qpad.main(args[0]), "fwd": attn_tune.main(args[1]),
           "bwd": attn_tune.main(args[2])}
    fns, counts = _q8_counts()
    # the rigs' K2, K3a and K3b are the controls; qpad's vjp the production
    # K3a and K3b
    launches = {"control": A.attention_fwd_mma.launches, "fwd_lse": counts[1],
                "bwd": counts[2], "bwd control": A.attention_bwd_mma.launches,
                **{f"qpad G{g}": c
                   for g, c in P.attention_probe_qpad.launches.items()},
                **{f"tile {r}x{t}": c
                   for (r, t), c in P.attention_probe_tile.launches.items()},
                **{f"bwd {r}x{t}": c
                   for (r, t), c in P.attention_bwd_tile.launches.items()}}
    check(all(launches.values()), f"rig launches {launches}")
    print(f"phase 25 launches in the rigs' run: {launches}", flush=True)
    dev = torch.device(DEVICE)
    alone = {}
    for way, arch in (("fwd", "10s-train"), ("bwd", "30s-train")):
        runs = {t: r for t, r in res[way][arch].items() if "x" in t}
        best = min(runs, key=lambda t: float(np.median(runs[t])))
        a, b = map(int, best.split("x"))
        n = attn_tune.ARCH_N[arch]
        q, k, v = _inputs(BATCH, n, 12, 0.1, 0, dev)
        if way == "fwd":
            with torch.inference_mode():
                ms = attn_tune.tile_ms(
                    lambda: P.attention_probe_tile(q, k, v, a, b), 20, dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(1)  # the rig's do
            do = (torch.randn(q.shape, generator=gen, device=dev) * 0.1).to(
                q.dtype)
            o, lse = A.flash_attention_fwd_lse(q, k, v)
            ms = attn_tune.tile_ms(lambda: P.attention_bwd_tile(
                q, k, v, o, lse, do, a, b), 20, dev)
        alone[way] = (best, ms)
    print(f"phase 25 the best tiles timed again alone: forward "
          f"{alone['fwd'][0]} at ({BATCH}, 281) {alone['fwd'][1]:.4f} ms, "
          f"backward {alone['bwd'][0]} at ({BATCH}, 866) "
          f"{alone['bwd'][1]:.4f} ms", flush=True)
    return res, alone, launches


def _mma_gap(out, ref):
    """(max |out - ref|, MMA_ULPS bf16 ulps of max|ref|, relative L2)."""
    ref = ref.float()
    diff = out.float() - ref
    return (diff.abs().max().item(), MMA_ULPS * bf16_ulp(ref.abs().max().item()),
            (diff.norm() / ref.norm()).item())


def _mma_rel_bound(key: str) -> float:
    """The relative L2 bound of a phase 26 key: MMA_E4M3_REL_L2 for an e4m3
    P8 shape ("<shape>_fp8"), else MMA_REL_L2."""
    return MMA_E4M3_REL_L2 if key.endswith("_fp8") else MMA_REL_L2


MMA_COUNTS = ("mxu", "mxu_mma", "mlp_bf16", "mlp_e4m3", "mlp_mma_bf16",
              "mlp_mma_e4m3")


def _mma_counts():
    """The launch counts of the product kernel's wrappers, named as in
    MMA_COUNTS: mxu_probe, mxu_probe_mma, and mlp_probe and mlp_probe_mma
    by operand type."""
    from maest_tpu_torch.ops import mma_probe as M

    return (M.mxu_probe.launches, M.mxu_probe_mma.launches,
            M.mlp_probe.launches_bf16, M.mlp_probe.launches_e4m3,
            M.mlp_probe_mma.launches_bf16, M.mlp_probe_mma.launches_e4m3)


def phase_mma_kernels(dev, gpu, planted_libs):
    """Phase 26: the product kernel of P1 and P8 on its route, ``wgmma`` fed
    by TMA (``csrc/mma_probe_wgmma.cuh``), and its mma.sync control
    (``csrc/mma_probe.cu``), each against the plain versions at the rigs'
    shapes with the programs cut to 2: every P1 kind, and every P8 shape in
    bf16 and e4m3, within MMA_ULPS bf16 ulps of max|out| and a relative L2
    of MMA_REL_L2 (e4m3 MMA_E4M3_REL_L2), each launch counted in its own
    wrapper's counter and operand type. Three faults are refused: one of
    k64big's 56 column blocks zeroed in b (as a kernel that skipped it), and
    the wgmma kernel built with the last of each bf16 stage's four products
    dropped, and with the e4m3 sums kept on the tensor core across stages
    (``planted_libs``, phase 2's builds of PLANT_MMA_BF16 and
    PLANT_MMA_E4M3, each run here by ``_mma_planted_errs``). Then the plain
    versions' times at the rigs' programs for the kernels line: k64big (48
    programs), fc1 in bf16 and e4m3 (32); the folded library product of
    ``probes.mxu.library_fn`` is held to k64big's plain version. Returns
    the errors and times."""
    from maest_tpu_torch.ops import mma_probe as M
    from maest_tpu_torch.probes import fp8_mlp, mxu

    err, parts = {"wgmma": {}, "control": {}}, []
    runs = [(kind, "bf16") for kind in M.KINDS] + [
        (shape, dt) for shape in fp8_mlp.SHAPES for dt in fp8_mlp.DTYPES]
    wraps = {"wgmma": (M.mxu_probe, M.mlp_probe),
             "control": (M.mxu_probe_mma, M.mlp_probe_mma)}
    for name, dt in runs:
        p1 = name in M.KINDS
        a, b = (mxu.operands(name, 2, dev) if p1
                else fp8_mlp.operands(name, dt, 2, dev))
        ref = (M.mxu_probe_reference(a, b, name) if p1
               else M.mlp_probe_reference(a, b))
        key = name if p1 else f"{name}_{dt}"
        for which, (w1, w8) in wraps.items():
            before = _mma_counts()
            out = w1(a, b, name) if p1 else w8(a, b)
            torch.cuda.synchronize()
            grew = [x - y for x, y in zip(_mma_counts(), before)]
            want = [0] * len(MMA_COUNTS)
            want[MMA_COUNTS.index(
                ("mxu" if p1 else "mlp") + ("_mma" if which == "control"
                                            else "")
                + ("" if p1 else "_e4m3" if dt == "fp8" else "_bf16"))] = 1
            e, tol, rel = _mma_gap(out, ref)
            check(grew == want and out.shape == ref.shape and e <= tol
                  and rel <= _mma_rel_bound(key),
                  f"{key} {which}: max_abs_err {e} (bound {tol}), relative "
                  f"L2 {rel}, launches {grew}")
            err[which][key] = e
            parts.append(f"{key} {which} {e:.2e} (<= {tol:.2e}; rel L2 "
                         f"{rel:.2e} <= {_mma_rel_bound(key):.1e})")
            del out
        del a, b, ref
    a, b = mxu.operands("k64big", 2, dev)
    skipped = b.clone()
    skipped[..., 13 * M.BLOCK:14 * M.BLOCK] = 0
    e, tol, rel = _mma_gap(M.mxu_probe(a, skipped, "k64big"),
                           M.mxu_probe_reference(a, b, "k64big"))
    check(e > tol and rel > MMA_REL_L2, f"the zeroed block passed: {e} {rel}")
    e_lib = max_err(mxu.library_fn("k64big", a, b)(),
                    M.mxu_probe_reference(a, b, "k64big"))
    check(e_lib <= MMA_ULPS * bf16_ulp(M.mxu_probe_reference(
        a, b, "k64big").float().abs().max().item()),
          f"the folded library product is not k64big's: {e_lib}")
    del a, b, skipped
    bad = _mma_planted_errs(dict(zip(planted_libs, MMA_PLANTED_KEYS)))
    check(all(g[0] > g[1] or g[2] > _mma_rel_bound(k)
              for k, g in bad.items()), f"a planted fault passed: {bad}")
    print("phase 26 P1/P8 product kernel, wgmma (csrc/mma_probe_wgmma.cuh) "
          "and its mma.sync control (csrc/mma_probe.cu), vs plain at the "
          "rigs' shapes, 2 programs: max_abs_err " + ", ".join(parts)
          + f"; k64big's column block 13 of 56 zeroed: {e:.3e} > {tol:.3e}, "
          f"relative L2 {rel:.4f} > {MMA_REL_L2}: refused; the wgmma kernel "
          f"built with the last of each bf16 stage's four products dropped,"
          f" and with its e4m3 sums kept on the tensor core across stages: "
          + ", ".join(f"{k} {g[0]:.3e} (bound {g[1]:.3e}), relative L2 "
                      f"{g[2]:.3e} (bound {_mma_rel_bound(k):.1e})"
                      for k, g in bad.items())
          + f": refused; the folded library product (torch.matmul) "
          f"{e_lib:.3e} from k64big's plain version", flush=True)
    t = {}
    a, b = mxu.operands("k64big", 48, dev)
    t["k64big"] = cuda_ms(lambda: M.mxu_probe_reference(a, b, "k64big"), 3)
    for dt in fp8_mlp.DTYPES:
        a, b = fp8_mlp.operands("fc1", dt, 32, dev)
        t[f"fc1_{dt}"] = cuda_ms(lambda: M.mlp_probe_reference(a, b), 3)
    del a, b
    torch.cuda.empty_cache()
    print(f"phase 26 plain versions (CUDA events) ms: k64big (48 programs) "
          f"{t['k64big']:.4f}, fc1 (32 programs) bf16 {t['fc1_bf16']:.4f}, "
          f"e4m3 {t['fc1_fp8']:.4f} [{gpu}]", flush=True)
    return {"err": err, "plain": t}


def _tagging(dev, heads, seed):
    """get_maest(embed_dim=768, num_heads=heads) at full depth on random
    weights, tagging 2 clips of 30 s: fp32 on the card against the same
    weights on the CPU (plain attention), bf16 against the card's fp32
    tier; returns (bf16 model, errors, the spread of the CPU's
    activations). The heads are drawn N(0, 0.05^2): zero heads would hide
    every difference, and at 0.05 the 768 features give logits of about
    unit scale, where the activations move with the logits (at 0.2, as
    phase 23 draws 192 features, most saturate and bf16's logit errors
    reach the rest 4x amplified)."""
    from maest_tpu_torch import get_maest

    geo = dict(pretrained=False, embed_dim=768, num_heads=heads)
    cpu = get_maest(device="cpu", **geo)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for lin in (cpu.net.head[1], cpu.net.head_dist):
            lin.weight.normal_(0.0, 0.05, generator=gen)
    card = {dt: get_maest(device=dev, dtype=dt, **geo)
            for dt in (torch.float32, torch.bfloat16)}
    for m in card.values():
        m.net.load_state_dict(cpu.net.state_dict())
    waves = np.random.default_rng(seed).standard_normal((2, CLIP)).astype(
        np.float32) * 0.3
    ref = cpu.predict_labels(waves)[0]
    got = {dt: m.predict_labels(waves)[0] for dt, m in card.items()}
    e32 = float(np.abs(got[torch.float32] - ref).max())
    e16 = float(np.abs(got[torch.bfloat16] - got[torch.float32]).max())
    check(e32 <= 2e-4 * float(np.abs(ref).max()) + 2e-5 and e16 <= TIER_TOL
          and np.ptp(ref) > 1e-2 and got[torch.bfloat16].shape == ref.shape,
          f"head_dim {768 // heads} tagging fp32 {e32} bf16 {e16}, "
          f"activations spread {np.ptp(ref)}")
    return card[torch.bfloat16], (e32, e16), float(np.ptp(ref))


def _dn8_times(dev, gen, out, gpu):
    """Phase 27's 8-bit runtime-width instances at head_dim 384: the four
    forwards at (32, 1676, 2, 384) and K7 at (32, 866, 2, 384), each held
    to its plain version within phase 13's and phase 15's bounds
    (``_q8_fwd_vs_plain``, ``_k7_vs_plain``), then timed (the wrappers,
    their PyTorch pass included; CUDA events) beside one call of the plain
    version; into ``out``."""
    from maest_tpu_torch.ops import attention as A

    for n in (1676, 866):
        x = (torch.randn((BATCH, n, 4, 2, 384), generator=gen, device=dev)
             ).to(torch.bfloat16)
        q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
        if n == 866:
            o, lse = A.flash_attention_fwd_lse(q, k, v)
            text = _k7_vs_plain(q, k, v, o, lse, g)
            ref = A.attention_bwd_int8_reference(q, k, v, o, lse, g)
            out["err"]["k7_d384"] = max(
                max_err(a, r) for a, r in zip(A.attention_bwd_int8(
                    q, k, v, o, lse, g), ref))
            out["ms"]["k7_d384"] = (cuda_ms_median(
                lambda: A.attention_bwd_int8(q, k, v, o, lse, g), 5), cuda_ms(
                lambda: A.attention_bwd_int8_reference(q, k, v, o, lse, g), 1))
            del o, lse, ref
        else:
            text = _q8_fwd_vs_plain(q, k, v)
            for mode in Q8_MODES:
                kind = "int8" if mode.startswith("qk8") else "fp8"
                wrap = getattr(A, f"attention_fwd_{kind}")
                pv8 = mode.endswith("pv8")
                r = A.attention_q8_reference(q, k, v, None, mode)[0]
                out["err"][f"{mode}_d384"] = max_err(
                    wrap(q, k, v, None, pv8)[0], r)
                with torch.inference_mode():
                    out["ms"][f"{mode}_d384"] = (cuda_ms_median(
                        lambda: wrap(q, k, v, None, pv8), 5), cuda_ms(
                        lambda: A.attention_q8_reference(q, k, v, None, mode),
                        1))
                del r
        print(f"phase 27 the 8-bit _dn instances at ({BATCH}, {n}, 2, 384): "
              f"{text}", flush=True)
        del x, q, k, v, g
        torch.cuda.empty_cache()
    print("phase 27 the 8-bit _dn times at head_dim 384 (CUDA events, ms, "
          "kernel / plain): at (32, 1676, 2, 384) the forward wrappers "
          + ", ".join(f"{m} {out['ms'][m + '_d384'][0]:.4f} / "
                      f"{out['ms'][m + '_d384'][1]:.4f}" for m in Q8_MODES)
          + f"; K7 at (32, 866, 2, 384) {out['ms']['k7_d384'][0]:.4f} / "
          f"{out['ms']['k7_d384'][1]:.4f}; bf16's _dn K2 at (32, 1676, 2, "
          f"384) {out['ms']['fwd_d384'][0]:.4f} [{gpu}]", flush=True)


def _tagging_q8(dev, model, seed):
    """get_maest(embed_dim=768, num_heads=2, attention_quant="qk8") in bf16
    on the weights of ``model`` (the bf16 head_dim-384 model of
    ``_tagging``), tagging the same 2 clips of 30 s: (the model, its
    largest distance from ``model``'s activations, which must be within
    TIER_TOL, the launches (K2, K3a, K3b, K5, K6, K7))."""
    from maest_tpu_torch import get_maest

    q8m = get_maest(device=dev, dtype=torch.bfloat16, pretrained=False,
                    embed_dim=768, num_heads=2, attention_quant="qk8")
    q8m.net.load_state_dict(model.net.state_dict())
    waves = np.random.default_rng(seed).standard_normal((2, CLIP)).astype(
        np.float32) * 0.3
    before = _q8_counts()[1]
    got = q8m.predict_labels(waves)[0]
    grew = [a - b for a, b in zip(_q8_counts()[1], before)]
    ref = model.predict_labels(waves)[0]
    e = float(np.abs(got - ref).max())
    check(e <= TIER_TOL and np.isfinite(got).all()
          and grew[3] == q8m.net.cfg.depth and grew[0] == 0,
          f"head_dim 384 qk8 tagging err {e}, launches {grew}")
    return q8m, e, grew


DN_ROUNDS = 3  # interleaved rounds of phase 27's runtime-width timings


def _dn_planted_inputs(dev):
    """Phase 27's planted fault's (2, 200, 3, 2, 384) bf16 q/k/v, drawn
    from seed 27."""
    gen = torch.Generator(device=dev).manual_seed(27)
    return torch.randn((2, 200, 3, 2, 384), generator=gen, device=dev).to(
        torch.bfloat16)


def _dn_wgmma(dev, gen, gpu, planted_lib) -> dict:
    """Phase 27's runtime-width bf16 forward on ``wgmma`` and TMA
    (``csrc/attn_fwd_dn_wgmma.cuh``, the route of maest_attn_fwd_bf16_dn)
    and its mma.sync control (``attention_fwd_mma``, entry
    maest_attn_fwd_bf16_dn_mma), each against plain within
    ATTN_TOL["bfloat16"] and LSE_TOL, each launch counted: K2 at (32, 1676,
    2, 384), K3a at (32, 866, 2, 384), both at 320, 512 and 1024 at (2,
    200) n_real 190; the kernel built with the last K chunk of each key
    tile left out of S refused (``_planted_err``); then CUDA-graph
    replays of the kernel, the control and SDPA's efficient attention
    (``sdpa_efficient``) in DN_ROUNDS interleaved rounds at K2's and K3a's
    shapes and (in 2 rounds) K2's at head_dim 320 and 512, plain timed by
    CUDA events.
    Returns the errors and times."""
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.probes.attn_profile import graph_rounds

    tol = ATTN_TOL["bfloat16"]
    err = dict.fromkeys(("wgmma", "wgmma_lse", "control", "control_lse"), 0.0)
    counted = (A.flash_attention, A.flash_attention_fwd_lse,
               A.attention_fwd_mma)
    for b, n, n_real, d in ((BATCH, 1676, None, 384), (BATCH, 866, None, 384),
                            (2, 200, 190, 320), (2, 200, 190, 512),
                            (2, 200, 190, 1024)):
        x = torch.randn((b, n, 3, 2, d), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = x.unbind(2)
        lse_runs = (False, True) if b == 2 else ((True,) if n == 866
                                                  else (False,))
        before = [f.launches for f in counted]
        got = {}
        with torch.inference_mode():
            for lse in lse_runs:
                got[("wgmma", lse)] = (
                    A.flash_attention_fwd_lse(q, k, v, n_real) if lse else
                    (A.flash_attention(q, k, v, n_real=n_real), None))
                got[("control", lse)] = A.attention_fwd_mma(q, k, v, n_real,
                                                            lse)
            r, rl = A.attention_reference_lse(q, k, v, n_real)
        torch.cuda.synchronize()
        grew = [f.launches - c for f, c in zip(counted, before)]
        want = [int(False in lse_runs), int(True in lse_runs), len(lse_runs)]
        check(grew == want, f"_dn ({b}, {n}, 2, {d}) launches {grew}")
        text = []
        for (route, lse), (o, ol) in got.items():
            e = max_err(o, r)
            el = max_err(ol, rl) if lse else 0.0
            check(o.shape == q.shape and e <= tol and el <= LSE_TOL,
                  f"_dn {route} ({b}, {n}, 2, {d}) lse {lse}: o {e} lse {el}")
            key = route + ("_lse" if lse else "")
            err[key] = max(err[key], e, el)
            text.append(f"{route}{' with lse' * lse} o {e:.3e}"
                        + (f" lse {el:.3e}" if lse else ""))
        print(f"phase 27 the bf16 _dn forward at ({b}, {n}, 2, {d}) n_real "
              f"{n_real}: the wgmma kernel and the control vs plain: "
              + ", ".join(text) + f" (bounds {tol}, lse {LSE_TOL}); "
              f"launches (K2, K3a, control) {grew}", flush=True)
        del x, q, k, v, got, r, rl
        torch.cuda.empty_cache()

    x = _dn_planted_inputs(dev)
    q, k, v = x.unbind(2)
    sound = max_err(A.flash_attention(q, k, v, n_real=190),
                    A.attention_reference(q, k, v, 190))
    bad = _planted_err(planted_lib, "_dn_planted_inputs",
                       "maest_attn_fwd_bf16_dn", 190, 384)
    check(sound <= tol < bad, f"planted _dn last chunk {bad}, sound {sound}")
    print(f"phase 27 planted fault, the _dn wgmma kernel built with the last K "
          f"chunk of each key tile left out of S, at (2, 200, 2, 384) n_real "
          f"190: max_abs_err {bad:.3e} > {tol}, refused (the sound kernel "
          f"{sound:.3e})", flush=True)
    del x, q, k, v

    ms = {}
    for name, n, lse, d in (("K2", 1676, False, 384), ("K3a", 866, True, 384),
                            ("K2_d320", 1676, False, 320),
                            ("K2_d512", 1676, False, 512)):
        x = torch.randn((BATCH, n, 3, 2, d), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = x.unbind(2)
        fns = {"wgmma": (lambda: A.flash_attention_fwd_lse(q, k, v)) if lse
               else (lambda: A.flash_attention(q, k, v)),
               "control": lambda: A.attention_fwd_mma(q, k, v, None, lse),
               "sdpa": sdpa_efficient(q, k, v, lse=lse)}
        with torch.inference_mode():  # 2 rounds at 320 and 512
            rows = graph_rounds(fns, 10, dev, DN_ROUNDS if d == 384 else 2)
            plain = cuda_ms(lambda: A.attention_reference_lse(q, k, v) if lse
                            else A.attention_reference(q, k, v), 1)
        med = {key: float(np.median(v_)) for key, v_ in rows.items()}
        ms[name] = {**med, "plain": plain, "rounds": rows}
        print(f"phase 27 the bf16 _dn {'K3a' if lse else 'K2'} at ({BATCH}, "
              f"{n}, 2, {d}), CUDA-graph ms in {len(rows['wgmma'])} interleaved "
              "rounds: "
              + "; ".join(f"{key} " + ", ".join(f"{x_:.4f}" for x_ in v_)
                          for key, v_ in rows.items())
              + f"; medians: wgmma {med['wgmma']:.4f}, control "
              f"{med['control']:.4f} ({med['control'] / med['wgmma']:.2f}x),"
              f" SDPA (efficient attention) {med['sdpa']:.4f} "
              f"({med['sdpa'] / med['wgmma']:.2f}x); plain {plain:.4f} "
              f"(CUDA events) [{gpu}]", flush=True)
        del x, q, k, v, fns
        torch.cuda.empty_cache()
    return {"err": err, "ms": ms}


def _tag_dn_rounds(prog, waves, depth, launches, gpu) -> dict:
    """Phase 27's batch-32 30 s bf16 tagging step at head_dim 384 (``prog``,
    a BucketPrograms of the num_heads=2 model, run eagerly) with the _dn
    wgmma kernel and with its mma.sync control (``_K2_CONTROL``) in DN_ROUNDS
    alternating rounds, CUDA events over 3 steps after one, the launches
    checked on each; the control's launches into ``launches``. Returns the
    medians and every round."""
    from maest_tpu_torch.ops import attention as A

    counted = (A.flash_attention, A.attention_fwd_mma)
    rows = {"wgmma": [], "control": []}
    launches["k2_d384_control"] = 0
    try:
        for rnd in range(DN_ROUNDS):
            for route in (("wgmma", "control") if rnd % 2 == 0
                          else ("control", "wgmma")):
                A._K2_CONTROL = route == "control"
                before = [f.launches for f in counted]
                with torch.inference_mode():
                    rows[route].append(cuda_ms(lambda: prog._activations(
                        waves), 3))
                grew = [f.launches - c for f, c in zip(counted, before)]
                want = [4 * depth, 0] if route == "wgmma" else [0, 4 * depth]
                check(grew == want, f"head_dim 384 tagging with the {route}: "
                      f"launches (K2, control) {grew}")
                launches["k2_d384_control"] += grew[1]
    finally:
        A._K2_CONTROL = False
    med = {r: float(np.median(ms)) for r, ms in rows.items()}
    won = sum(a < b for a, b in zip(rows["wgmma"], rows["control"]))
    print(f"phase 27 head_dim 384 batch-{BATCH} 30 s bf16 tagging step, "
          f"CUDA events over 3 steps, {DN_ROUNDS} alternating rounds: "
          f"wgmma {', '.join(f'{x:.3f}' for x in rows['wgmma'])}; control "
          f"{', '.join(f'{x:.3f}' for x in rows['control'])}; medians "
          f"{med['wgmma']:.3f} ms ({BATCH * 30 / (med['wgmma'] / 1e3):.1f} "
          f"audio-s/s) against {med['control']:.3f} (gap "
          f"{med['control'] - med['wgmma']:.3f} ms), rounds won by the "
          f"wgmma kernel {won} of {DN_ROUNDS} [{gpu}]", flush=True)
    return {**med, "rounds": rows}


def phase_wide_heads_and_mma_rigs(dev, gpu, dn_planted_lib):
    """Phase 27: the slice's path, with the launch counters set to 0 just
    before and read just after. Both rigs as a user runs them, here their
    ``main`` in process at their default programs (``python -m
    maest_tpu_torch.probes.mxu --kinds <every kind>``, ``python -m
    maest_tpu_torch.probes.fp8_mlp``). Then head_dim 128 and 256 at full
    width: ``get_maest(embed_dim=768, num_heads=6)`` tagging 2 clips of 30
    s through K2's D = 128 instance (``_tagging``), its batch-32 30 s bf16
    step timed; ``num_heads=8`` (head_dim 96, zero-padded to 128) the same,
    ``num_heads=3`` (head_dim 256) through the D = 256 instance, and
    ``num_heads=2`` (head_dim 384) through the runtime-width (_dn)
    instance; one bf16 step of the 30 s recipe at 6, 3 and 2 heads (N 866),
    heads drawn so the loss is not ln 2, through K3a and K3b at D = 128,
    256 and 384, 12 of each. Then K2 at (32, 1676, 6, 128), (32, 1676, 3,
    256) and (32, 1676, 2, 384), and K3a and K3b at (32, 866, 6, 128), (32,
    866, 3, 256) and (32, 866, 2, 384), the shapes their steps above ran
    them at, against their plain versions, K2 and K3b timed beside them,
    beside the d 64 kernels at the same flops ((32, 1676 | 866, 12, 64),
    held to plain and timed here too), and beside SDPA (never called by the
    port; flash backend up to head_dim 256, efficient attention at 384),
    and K7 and the 8-bit forwards at D = 128 against their plain versions
    and timed, K3a timed. At head_dim 384 the bf16 forward runs the
    runtime-width wgmma kernel: the tagging step is timed with it and with
    its mma.sync control (``ops.attention._K2_CONTROL``) in DN_ROUNDS
    alternating rounds, one more recipe step runs K3a's control, and
    ``_dn_wgmma`` holds both to plain, refuses a planted fault and times
    them beside SDPA. Returns the rigs' results, the launches, errors and
    times."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.ops import mma_probe as M
    from maest_tpu_torch.probes import fp8_mlp, mxu
    from maest_tpu_torch.serve import BucketPrograms

    kinds = ",".join(M.KINDS)
    print(f"phase 27 rigs: python -m maest_tpu_torch.probes.mxu --kinds "
          f"{kinds}; python -m maest_tpu_torch.probes.fp8_mlp (the wgmma "
          f"kernel, its mma.sync control and the library's product in "
          f"CUDA-graph replays, interleaved rounds)", flush=True)
    _reset_counts()
    M.reset_launches()
    laps = [("start", time.perf_counter())]  # the parts' seconds, printed
    rigs = {"mxu": mxu.main(["--kinds", kinds]), "mlp": fp8_mlp.main([])}
    laps.append(("rigs", time.perf_counter()))
    launches = dict(zip(MMA_COUNTS, _mma_counts()))
    # each kernel once in each kind's or shape's graph (31 calls: a warm-up
    # and 30 captured), the control as often, only because the rigs time
    # it; P8's three shapes in each operand type
    check(launches["mxu"] == launches["mxu_mma"] == 31 * len(M.KINDS)
          and all(launches[k] == 31 * len(fp8_mlp.SHAPES) for k in (
              "mlp_bf16", "mlp_e4m3", "mlp_mma_bf16", "mlp_mma_e4m3")),
          f"rig launches {launches}")

    out = {"err": {}, "ms": {}}
    waves = torch.from_numpy(np.random.default_rng(27).standard_normal(
        (BATCH, CLIP)).astype(np.float32) * 0.1).to(dev)
    for heads in (6, 8, 3, 2):
        before = _q8_counts()[1]
        model, errs, spread = _tagging(dev, heads, 27 + heads)
        grew = [a - b for a, b in zip(_q8_counts()[1], before)]
        check(grew[0] == 2 * model.net.cfg.depth and not any(grew[1:]),
              f"head_dim {768 // heads} tagging launches {grew}")
        prog = BucketPrograms(model, buckets=(BATCH,), fused_wave=True)
        with torch.inference_mode():
            step = cuda_ms(lambda: prog._activations(waves), 5)
        out["ms"][f"tag_d{768 // heads}"] = step
        if heads == 2:  # the _dn kernel and its control in turn
            out["tag_dn"] = _tag_dn_rounds(prog, waves, model.net.cfg.depth,
                                           launches, gpu)
        launches[f"k2_d{768 // heads}"] = grew[0]
        if heads == 2:  # head_dim 384 under qk8: K5's _dn instance
            q8m, e8, grew8 = _tagging_q8(dev, model, 27 + heads)
            launches["k5_d384"] = grew8[3]
            out["err"]["tag_qk8_d384"] = e8
            print(f"phase 27 head_dim 384 under attention_quant qk8: "
                  f"get_maest(embed_dim=768, num_heads=2, attention_quant="
                  f"'qk8') tagging 2 clips of 30 s through K5's runtime-width "
                  f"(_dn) instance, bf16, vs the bf16 model on the same "
                  f"weights max_abs_err {e8:.3e} <= {TIER_TOL}; launches (K2, "
                  f"K3a, K3b, K5, K6, K7) {grew8}", flush=True)
            del q8m
        width = A.padded_dim(768 // heads)
        print(f"phase 27 head_dim {768 // heads}: get_maest(embed_dim=768, "
              f"num_heads={heads}) tagging 2 clips of 30 s through K2's "
              + (f"D = {width} instance" if width in A.HEAD_DIMS else
                 f"runtime-width (_dn) instance at {width}")
              + f"{' on inputs zero-padded to 128' * (heads == 8)}"
              f": fp32 vs the CPU's plain attention max_abs_err {errs[0]:.3e}, "
              f"bf16 vs fp32 {errs[1]:.3e} <= {TIER_TOL} (activations spread "
              f"over {spread:.3f}); launches (K2, K3a, K3b, K5, K6, K7) "
              f"{grew}; batch-{BATCH} 30 s bf16 step {step:.3f} ms = "
              f"{BATCH * 30 / (step / 1e3):.1f} audio-s/s [{gpu}]", flush=True)
        del model, prog
        torch.cuda.empty_cache()
    del waves
    laps.append(("tagging at 4 widths", time.perf_counter()))

    for heads in (6, 3, 2):
        d = 768 // heads
        _, mcfg, net, state, step, data = _recipe(
            dev, RECIPE, BATCH, 27, [f"maest.num_heads={heads}"])
        drawn = torch.Generator(device=dev).manual_seed(27)
        with torch.no_grad():  # zero heads give loss ln 2 and do = 0
            for lin in (net.head[1], net.head_dist):
                lin.weight.normal_(0.0, 0.05, generator=drawn)
        before = _q8_counts()[1]
        _, metrics = step(state, data, torch.Generator().manual_seed(27))
        torch.cuda.synchronize()
        grew = [a - b for a, b in zip(_q8_counts()[1], before)]
        check(grew == [0, mcfg.depth, mcfg.depth, 0, 0, 0]
              and metrics["nonfinite_skipped"] == 0.0
              and np.isfinite(metrics["train_loss"])
              and abs(metrics["train_loss"] - np.log(2)) > 1e-3,
              f"head_dim {d} recipe step: launches {grew}, {metrics}")
        launches[f"k3a_d{d}"], launches[f"k3b_d{d}"] = grew[1], grew[2]
        if heads == 2:  # one more step with K3a's control
            before = A.attention_fwd_mma.launches
            A._K2_CONTROL = True
            try:
                _, m2 = step(state, data, torch.Generator().manual_seed(28))
                torch.cuda.synchronize()
            finally:
                A._K2_CONTROL = False
            launches["k3a_d384_control"] = A.attention_fwd_mma.launches - before
            check(launches["k3a_d384_control"] == mcfg.depth
                  and m2["nonfinite_skipped"] == 0.0
                  and np.isfinite(m2["train_loss"])
                  and abs(m2["train_loss"] - np.log(2)) > 1e-3,
                  f"head_dim 384 recipe step with the control: launches "
                  f"{launches['k3a_d384_control']}, {m2}")
            print(f"phase 27 {RECIPE} at num_heads 2, one more step with K3a's "
                  f"control (_K2_CONTROL): loss {m2['train_loss']:.6f}, "
                  f"control launches {launches['k3a_d384_control']}",
                  flush=True)
        print(f"phase 27 {RECIPE} at num_heads {heads} (head_dim {d}), batch "
              f"{BATCH}, bf16 over fp32 parameters, heads drawn N(0, 0.05^2):"
              f" one step, loss {metrics['train_loss']:.6f} (not ln 2), "
              f"launches (K2, K3a, K3b, K5, K6, K7) {grew}", flush=True)
        del net, state, step, data
        torch.cuda.empty_cache()
    laps.append(("recipe steps", time.perf_counter()))

    gen = torch.Generator(device=dev).manual_seed(28)
    for b, n, heads, d in ((BATCH, 1676, 6, 128), (BATCH, 866, 6, 128),
                           (BATCH, 1676, 3, 256), (BATCH, 866, 3, 256),
                           (BATCH, 1676, 2, 384), (BATCH, 866, 2, 384),
                           (BATCH, 1676, 12, 64), (BATCH, 866, 12, 64)):
        # SDPA's flash backend takes head_dim up to 256; past it the
        # efficient-attention backend
        backend = (SDPBackend.FLASH_ATTENTION if d <= 256
                   else SDPBackend.EFFICIENT_ATTENTION)
        x = (torch.randn((b, n, 4, heads, d), generator=gen, device=dev)
             ).to(torch.bfloat16)
        q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        if n == 1676:
            with torch.inference_mode():
                e = max_err(A.flash_attention(q, k, v),
                            A.attention_reference(q, k, v))
                ms = (cuda_ms_median(lambda: A.flash_attention(q, k, v), 10),
                      cuda_ms(lambda: A.attention_reference(q, k, v), 3))
                with sdpa_kernel(backend):
                    lib = cuda_ms_median(
                        lambda: F.scaled_dot_product_attention(qs, ks, vs), 10)
            key = f"fwd_d{d}"
        else:
            o, lse = A.flash_attention_fwd_lse(q, k, v)
            ro, rlse = A.attention_reference_lse(q, k, v)
            ea, el = max_err(o, ro), max_err(lse, rlse)
            check(ea <= ATTN_TOL["bfloat16"] and el <= LSE_TOL,
                  f"K3a D = {d} vs plain {ea} lse {el}")
            out["err"][f"fwd_lse_d{d}"] = max(ea, el)
            out["ms"][f"k3a_d{d}"] = cuda_ms_median(
                lambda: A.flash_attention_fwd_lse(q, k, v), 10)
            print(f"phase 27 K3a D = {d} at ({b}, {n}, {heads}, {d}) bf16: "
                  f"max_abs_err vs plain o {ea:.3e} <= {ATTN_TOL['bfloat16']},"
                  f" lse {el:.3e} <= {LSE_TOL}; kernel "
                  f"{out['ms'][f'k3a_d{d}']:.4f} ms [{gpu}]", flush=True)
            del ro, rlse
            got = A.attention_bwd(q, k, v, o, lse, g)
            ref = A.attention_bwd_reference(q, k, v, o, lse, g)
            e = max(max_err(a, r) for a, r in zip(got, ref))
            ms = (cuda_ms_median(
                lambda: A.attention_bwd(q, k, v, o, lse, g), 10), cuda_ms(
                lambda: A.attention_bwd_reference(q, k, v, o, lse, g), 3))
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (qs, ks, vs))
            gs = g.transpose(1, 2)
            with sdpa_kernel(backend):
                fwd = cuda_ms_median(
                    lambda: F.scaled_dot_product_attention(qg, kg, vg), 10)
                lib = cuda_ms_median(lambda: F.scaled_dot_product_attention(
                    qg, kg, vg).backward(gs), 10) - fwd
            key = f"bwd_d{d}"
            del o, lse, got, ref, qg, kg, vg
        check(e <= ATTN_TOL["bfloat16"], f"{key} vs plain {e}")
        out["err"][key], out["ms"][key], out["ms"][f"{key}_sdpa"] = e, ms, lib
        print(f"phase 27 {'K2' if n == 1676 else 'K3b'} D = {d} at ({b}, {n}, "
              f"{heads}, {d}) bf16: max_abs_err vs plain {e:.3e} <= "
              f"{ATTN_TOL['bfloat16']}; kernel {ms[0]:.4f} ms, plain "
              f"{ms[1]:.4f} ms, SDPA ({backend.name.lower()} backend) "
              f"{lib:.4f} ms [{gpu}]", flush=True)
        del x, q, k, v, g, qs, ks, vs
        torch.cuda.empty_cache()
    # the other production kernels at D = 128, each against its plain
    # version within phase 15's and phase 13's bounds, then timed: K7 at
    # (32, 866, 6, 128) (K3a is held to plain and timed above), the four 8-bit
    # forwards (the wrappers, their PyTorch pass included) at (32, 1676, 6,
    # 128)
    for n in (866, 1676):
        x = (torch.randn((BATCH, n, 4, 6, 128), generator=gen, device=dev)
             ).to(torch.bfloat16)
        q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
        if n == 866:
            o, lse = A.flash_attention_fwd_lse(q, k, v)
            text = _k7_vs_plain(q, k, v, o, lse, g)
            del o, lse
        else:
            text = _q8_fwd_vs_plain(q, k, v)
        print(f"phase 27 D = 128 at ({BATCH}, {n}, 6, 128): {text}",
              flush=True)
        torch.cuda.empty_cache()
        with torch.inference_mode():
            if n == 866:
                o, lse = A.flash_attention_fwd_lse(q, k, v)
                out["ms"]["k7_d128"] = cuda_ms_median(
                    lambda: A.attention_bwd_int8(q, k, v, o, lse, g), 10)
                del o, lse
            else:
                for mode in Q8_MODES:
                    wrap = getattr(A, "attention_fwd_int8" if mode.startswith(
                        "qk8") else "attention_fwd_fp8")
                    out["ms"][f"{mode}_d128"] = cuda_ms_median(
                        lambda: wrap(q, k, v, None, mode.endswith("pv8")), 10)
        del x, q, k, v, g
    print("phase 27 D = 128 times (CUDA events, ms): K3a (32, 866, 6, 128) "
          f"{out['ms']['k3a_d128']:.4f}, K7 {out['ms']['k7_d128']:.4f}; at "
          "(32, 1676, 6, 128) the 8-bit forward wrappers " + ", ".join(
              f"{m} {out['ms'][m + '_d128']:.4f}" for m in Q8_MODES)
          + f" [{gpu}]", flush=True)
    torch.cuda.empty_cache()
    laps.append(("kernels at the steps' shapes", time.perf_counter()))
    _dn8_times(dev, gen, out, gpu)
    laps.append(("8-bit _dn", time.perf_counter()))
    out["dn"] = _dn_wgmma(dev, gen, gpu, dn_planted_lib)
    laps.append(("bf16 _dn on wgmma", time.perf_counter()))
    print("phase 27 time: " + ", ".join(
        f"{name} {t - laps[i][1]:.1f} s"
        for i, (name, t) in enumerate(laps[1:])), flush=True)
    print(f"phase 27 launches in the path's run: {launches}", flush=True)
    out["rigs"], out["launches"] = rigs, launches
    return out


def phase_int8_rigs(dev, gpu):
    """Phase 28: the kernels of the int8 product rigs P2
    (``scripts/int8_probe.py``) and P3 (``scripts/int8_probe2.py``), ported
    in ``ops/int8_probe.py``. Every kind's kernel against its plain version
    at the rigs' N with the programs cut to 2 (``plain_gap``: exact for
    int32 outputs, mix_i8 within one p8 a row one apart, k64_i8q within 1
    bf16 ulp of max|out| with the maxima its codes came from equal to
    plain's, the rest 2 bf16 ulps and relative L2 1e-2), each launch
    counted, mix_i8's differing rows counted; one of k64big_i8's 56 column
    blocks skipped is refused. Then the slice's path: both rigs as a user
    runs them, their ``main`` in process at their default programs
    (``python -m maest_tpu_torch.probes.int8`` and ``... probes.int8_2``),
    the counters set to 0 just before and read just after. Then the plain
    versions' times at the kernels line's kinds: k64_i8q (48 programs) and
    k64big_i8 (8). Returns the errors, the rigs' results, the launches and
    the plain times."""
    from maest_tpu_torch.ops import int8_probe as I
    from maest_tpu_torch.probes import int8, int8_2

    err, parts = {}, []
    for kinds, mod, wrap, ref_fn in (
            (I.P2_KINDS, int8, I.int8_probe, I.int8_probe_reference),
            (I.P3_KINDS, int8_2, I.int8_big_probe,
             I.int8_big_probe_reference)):
        for kind in kinds:
            a, b = int8.operands(kind, 2, dev, mod.shapes)
            before = wrap.launches
            out, ref = wrap(a, b, kind), ref_fn(a, b, kind)
            torch.cuda.synchronize()
            e, tol, ok = I.plain_gap(kind, out, ref)
            check(wrap.launches == before + 1 and out.shape == ref.shape
                  and out.dtype == I.out_dtype(kind) and ok,
                  f"{kind}: max_abs_err {e} (bound {tol})")
            note = ""
            if kind == "k64_i8q":
                _, amax = I.launch_i8q(a, b)
                want = torch.stack([a.float().abs().amax(dim=(1, 2)),
                                    b.float().abs().amax(dim=(1, 2))], dim=1)
                check(torch.equal(amax, want), f"k64_i8q maxima {amax} {want}")
                note = ", maxima equal"
            if kind == "mix_i8":
                rows = (out[..., :I.MIX_COLS] != ref[..., :I.MIX_COLS]).any(
                    dim=-1).sum().item()
                note = f", rows apart {rows} of {2 * int8.N}"
            err[kind] = e
            parts.append(f"{kind} {e:.3g} (<= {tol:.3g}{note})")
            del a, b, out, ref
    a, b = int8.operands("k64big_i8", 2, dev, int8_2.shapes)
    skipped = b.clone()
    skipped[..., 13 * 256:14 * 256] = 0
    e, tol, ok = I.plain_gap("k64big_i8", I.int8_big_probe(a, skipped,
                                                           "k64big_i8"),
                             I.int8_big_probe_reference(a, b, "k64big_i8"))
    check(not ok, f"the planted fault passed: {e}")
    print("phase 28 P2/P3 kernels (csrc/mma_probe.cu's int8 instances and "
          "i8q, csrc/attention_probe.cu MIX/MIX8; the bf16 kinds and "
          "k64big_fp8 on the wgmma product kernel, csrc/mma_probe_wgmma.cuh)"
          " vs plain at the rigs' N, 2 programs: max_abs_err "
          + ", ".join(parts)
          + f"; planted fault (k64big_i8's column block 13 of 56 skipped): "
          f"{e:.0f} > {tol:.0f}: refused", flush=True)
    del a, b, skipped
    torch.cuda.empty_cache()

    print("phase 28 rigs: python -m maest_tpu_torch.probes.int8; python -m "
          "maest_tpu_torch.probes.int8_2", flush=True)
    _reset_counts()
    I.int8_probe.launches = I.int8_big_probe.launches = 0
    rigs = {"p2": int8.main([]), "p3": int8_2.main([])}
    launches = {"p2": I.int8_probe.launches, "p3": I.int8_big_probe.launches}
    check(all(launches.values()), f"rig launches {launches}")
    plain = {}
    a, b = int8.operands("k64_i8q", 48, dev)
    plain["k64_i8q"] = cuda_ms(lambda: I.int8_probe_reference(a, b, "k64_i8q"),
                               3)
    a, b = int8.operands("k64big_i8", 8, dev, int8_2.shapes)
    plain["k64big_i8"] = cuda_ms(
        lambda: I.int8_big_probe_reference(a, b, "k64big_i8"), 3)
    del a, b
    torch.cuda.empty_cache()
    print(f"phase 28 launches in the rigs' run: {launches}; plain versions "
          f"(CUDA events): k64_i8q (48 programs) {plain['k64_i8q']:.4f} ms, "
          f"k64big_i8 (8) {plain['k64big_i8']:.4f} ms [{gpu}]", flush=True)
    return {"err": err, "rigs": rigs, "launches": launches, "plain": plain}


# phase 26's planted faults in the wgmma product kernel: the bf16
# consumers skip the last of each stage's four products (a quarter of K);
# the e4m3 consumers sum every product on the tensor core (scale_d carried
# across stages into the totals, no fresh stage sums added in fp32)
PLANT_MMA_BF16 = ((
    "          mp_bf16<BN>(acc, da + 2 * j, db + 128 * j);",
    "          if (j < NK - 1) mp_bf16<BN>(acc, da + 2 * j, db + 128 * j);"),)
PLANT_MMA_E4M3 = (
    ("          mp_e4m3_n128(part, da + 2 * j, db + 2 * j, j);",
     "          mp_e4m3_n128(acc, da + 2 * j, db + 2 * j, 1);"),
    ("            acc[nt][e] = __fadd_rn(acc[nt][e], part[nt][e]);",
     "            (void)part[nt][e];"))
# what each planted copy is run on (kinds of P1, shapes of P8 and a type)
MMA_PLANTED_KEYS = (("k64big", "fc1_bf16"), ("fc1_fp8", "fc2_fp8",
                                             "qkv_fp8"))


def build_planted_mma() -> tuple[tuple[Path, Path], float]:
    """``csrc/mma_probe.cu`` twice with a planted fault in the wgmma
    product kernel, PLANT_MMA_BF16 and PLANT_MMA_E4M3 (phase 26 shows its
    check refusing each); the libraries and the builds' seconds."""
    bf16, s1 = _build_planted("mma_bf16", "mma_probe", "mma_probe_wgmma.cuh",
                              *PLANT_MMA_BF16)
    e4m3, s2 = _build_planted("mma_e4m3", "mma_probe", "mma_probe_wgmma.cuh",
                              *PLANT_MMA_E4M3)
    return (bf16, e4m3), s1 + s2


def _mma_planted_errs(plants: dict) -> dict:
    """{key: (max_abs_err, bound, relative L2)} against plain at 2 programs
    of each planted copy of ``mma_probe`` in ``plants`` ({library: keys, a
    P1 kind or "<P8 shape>_<type>"}), through ``mxu_probe`` and
    ``mlp_probe``. Each copy runs in a process of its own (a second copy of
    a kernel that a process has launched fails there, see
    ``_planted_err``); the processes run at once and are waited for."""
    procs = []
    for lib, keys in plants.items():
        code = (
            "import ctypes, json, sys, torch\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke as C\n"
            "from maest_tpu_torch.ops import _build, mma_probe as M\n"
            "from maest_tpu_torch.probes import fp8_mlp, mxu\n"
            f"_build._libs['mma_probe'] = ctypes.CDLL({str(lib)!r})\n"
            "dev, bad = torch.device('cuda'), {}\n"
            f"for key in {list(keys)!r}:\n"
            "    if key in M.KINDS:\n"
            "        a, b = mxu.operands(key, 2, dev)\n"
            "        bad[key] = C._mma_gap(M.mxu_probe(a, b, key),\n"
            "                              M.mxu_probe_reference(a, b, key))\n"
            "    else:\n"
            "        a, b = fp8_mlp.operands(*key.split('_'), 2, dev)\n"
            "        bad[key] = C._mma_gap(M.mlp_probe(a, b),\n"
            "                              M.mlp_probe_reference(a, b))\n"
            "print(json.dumps(bad))\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    bad = {}
    for proc in procs:
        out, fault = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"a planted fault's process failed:\n{out}"
                               f"{fault}")
        bad.update(json.loads(out.strip().splitlines()[-1]))
    return bad


# phase 29's planted fault: the int8 rig's ds8 through the wrapping to_s8
PLANT_TO_S8 = ("    return to_s8_sat(x);", "    return to_s8(x);")


# phase 30's planted fault: the wgmma kernel's key mask dropped, so the
# keys at or past n_real in the last tile (and the zeros TMA fills in past
# N) take softmax mass
PLANT_NO_MASK = (
    "            const float x = key < n_real ? s[nt][e] * sl : NEG_INF;",
    "            const float x = s[nt][e] * sl;")


# phase 31's planted fault: the wgmma backward's key mask dropped, so the
# keys at or past n_real take mass (and get dk, dv)
PLANT_BWD_NO_MASK = (
    "    const bool live0 = key0 < n_real, live1 = key0 + 8 < n_real;",
    "    const bool live0 = key0 < n, live1 = key0 + 8 < n;")


# phase 27's planted fault: the runtime-width wgmma kernel's last K chunk of
# each key tile left out of S (its ring items still taken and released), so
# the scores miss 64 of dp's columns
PLANT_DN_LAST_CHUNK = (
    ("        wgmma_ss<DN_BK>(s, da, db, acc);",
     "        if (kc + 1 < nch) wgmma_ss<DN_BK>(s, da, db, acc);"),
    ("        for (int kk = 1; kk < 4; ++kk)  // +32 bytes a k-step",
     "        for (int kk = 1; kk < 4 * (kc + 1 < nch); ++kk)"))


# phase 18's planted fault: the wgmma bf16s kernel's bf16 rounding of the
# scores (and of its running maxima) left out, bf16_round2 returning at once,
# so it computes K2's softmax on the pre-scaled q
PLANT_BF16S_NO_ROUND = (
    "  const uint32_t u = pack_bf16(a, b);  // a in the low half",
    "  const uint32_t u = 0u; return;")


# phase 42's planted fault: the head_dim-256 wgmma backward's dV products of
# the last q tile left out, so dV misses those query rows' share
PLANT_D256_DV_LAST = (
    "        wgmma_rs_n64_t(acc[c], af[kj], sw128_desc(rows + c * CHUNK) + kj * 128);",
    "        if (wg != 0 || it + 1 < n_qt) wgmma_rs_n64_t(acc[c], af[kj], sw128_desc(rows + c * CHUNK) + kj * 128);")


# phase 44's planted faults: the _dn wgmma backward's dv and dk products
# leave out the last q tile (its k-steps end one early), so those q rows'
# share is missing; the head_dim-256 wgmma forward's key mask dropped
PLANT_DN_LAST_Q = (
    "  const int n_k = ((TRANS_A ? n_real : n) + 63) / 64;",
    "  const int n_k = ((TRANS_A ? n_real : n) + 63) / 64 - !TRANS_A;")
PLANT_D256_FWD_NO_MASK = (
    "        const float x = key < n_real ? s[nt][e] * sl : NEG_INF;",
    "        const float x = s[nt][e] * sl;")


# phase 20's planted fault: the gh kernel's producer loads the q of the head
# before (from the second head of a block on), so every head but a block's
# first takes its neighbour's queries
PLANT_GH_PREV_Q = (
    """          tma_load_4d(sq + qb * Q_BYTES + ch * Q_CHUNK, &tq, full_q(qb),
                      64 * ch, h, q0, b);""",
    """          tma_load_4d(sq + qb * Q_BYTES + ch * Q_CHUNK, &tq, full_q(qb),
                      64 * ch, (bh - (hg > 0)) % heads, q0,
                      (bh - (hg > 0)) / heads);""")


# phase 43's planted fault: the head_dim-128 wgmma kernel's S taken over the
# first 64 of its 128 dimensions only
PLANT_D128_HALF_S = (
    "      for (int ch = 0; ch < NCH; ++ch)  // S sums every chunk of d",
    "      for (int ch = 0; ch < 1; ++ch)  // S sums every chunk of d")


def _build_planted(tag, lib, header, *plants) -> tuple[Path, float]:
    """``csrc/<lib>.cu`` with, for each plant of ``plants``, the one line
    ``plant[0]`` of ``header`` (a file of ``csrc/``) replaced by
    ``plant[1]`` (a plant of three, (file, line, replacement), names its
    own file), built from a copy of ``csrc/`` under
    ``build/maest_tpu_torch/planted_<tag>/``; the library's path and the
    build's seconds."""
    import shutil

    from maest_tpu_torch.ops import _build

    t = time.perf_counter()
    root = _build.BUILD_DIR / f"planted_{tag}"
    src = root / "csrc"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(_build.CSRC, src)
    for plant in plants:
        name, line, repl = plant if len(plant) == 3 else (header, *plant)
        source = src / name
        text = source.read_text()
        check(text.count(line) == 1, f"the planted fault's line ({tag})")
        source.write_text(text.replace(line, repl))
    out = root / f"{lib}_{tag}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src / f"{lib}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build the planted fault {tag}:\n"
                           + proc.stdout + proc.stderr)
    return out, time.perf_counter() - t


def build_planted_to_s8() -> tuple[Path, float]:
    """``csrc/attention_bwd_q8.cu`` with the wrapping ``to_s8`` in place of
    the saturating conversion of the rig's ds8 (phase 29 shows its check
    refusing the kernels so built)."""
    return _build_planted("to_s8", "attention_bwd_q8", "attention_bwd_q8.cu",
                          PLANT_TO_S8)


def build_planted_no_mask() -> tuple[Path, float]:
    """``csrc/attention_fwd.cu`` with the head_dim-64 wgmma kernel's key
    mask dropped, the runtime-width wgmma kernel's last K chunk of each
    key tile left out of S and the head_dim-256 wgmma kernel's key mask
    dropped, three kernels of one library, so one build serves phase 30
    (maest_attn_fwd_bf16), phase 27 (maest_attn_fwd_bf16_dn) and phase 44
    (maest_attn_fwd_bf16_d256), each showing its check refusing its kernel
    so built."""
    return _build_planted("no_mask", "attention_fwd", "attn_fwd_wgmma.cuh",
                          PLANT_NO_MASK, *(("attn_fwd_dn_wgmma.cuh", *plant)
                                           for plant in PLANT_DN_LAST_CHUNK),
                          ("attn_fwd_d256_wgmma.cuh", *PLANT_D256_FWD_NO_MASK))


def build_planted_bwd_no_mask() -> tuple[Path, float]:
    """``csrc/attention_bwd.cu`` with the head_dim-64 wgmma backward's key
    mask dropped, the head_dim-256 wgmma backward's dV of the last q tile
    left out and the _dn wgmma backward's dv and dk of the last q tile left
    out, three kernels of one library, so one build serves phase 31
    (maest_attn_bwd_bf16), phase 42 (maest_attn_bwd_bf16_d256) and phase 44
    (maest_attn_bwd_bf16_dn), each showing its check refusing its kernel so
    built."""
    return _build_planted("bwd_no_mask", "attention_bwd",
                          "attn_bwd_wgmma.cuh", PLANT_BWD_NO_MASK,
                          ("attn_bwd_d256_wgmma.cuh", *PLANT_D256_DV_LAST),
                          ("attn_bwd_dn_wgmma.cuh", *PLANT_DN_LAST_Q))


def build_planted_bf16s() -> tuple[Path, float]:
    """``csrc/attention_probe.cu`` with the wgmma bf16s kernel's bf16
    rounding of the scores left out (phase 18 shows its checks refusing
    the kernel so built)."""
    return _build_planted("bf16s_no_round", "attention_probe",
                          "attn_fwd_wgmma.cuh", PLANT_BF16S_NO_ROUND)


def build_planted_gh_prev_q() -> tuple[Path, float]:
    """``csrc/attention_probe.cu`` with the gh kernel's producer loading the
    q of the head before (phase 20 shows its check refusing it)."""
    return _build_planted("gh_prev_q", "attention_probe",
                          "attn_fwd_wgmma.cuh", PLANT_GH_PREV_Q)


def build_planted_d128_half_s() -> tuple[Path, float]:
    """``csrc/attention_fwd.cu`` with the head_dim-128 wgmma kernel's S over
    the first 64 dimensions only (phase 43 shows its check refusing it)."""
    return _build_planted("d128_half_s", "attention_fwd",
                          "attn_fwd_wgmma.cuh", PLANT_D128_HALF_S)


def _own_process(code: str):
    """The JSON that ``code`` prints last, run by this interpreter in a
    process of its own from the checkout's root: a second copy of a kernel
    that this process has launched does not take its dynamic
    shared-memory limit here (its launch fails)."""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the planted fault's process failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _sass_text(path: Path) -> str:
    """``cuobjdump -sass`` of a built library, once a library: phase 2
    reads several kernels of attention_fwd and attention_bwd."""
    return subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(path)], capture_output=True, text=True,
                          timeout=600, check=True).stdout


def sass_kinds(path: Path, pattern: str) -> dict:
    """{kernel: {IGMMA, QGMMA, HGMMA, UTMALDG, HMMA, QMMA, instructions}} of
    the kernels of a built library whose mangled name holds ``pattern``,
    from ``cuobjdump -sass``: wgmma on s8 (IGMMA), e4m3 (QGMMA) and 16-bit
    (HGMMA) operands, TMA loads, mma.sync on 16-bit (HMMA) and 8-bit float
    (QMMA) operands, all instructions; the names demangled by cu++filt
    where it runs."""
    sass = _sass_text(path)
    keys = ("IGMMA", "QGMMA", "HGMMA", "UTMALDG", "HMMA", "QMMA")
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if pattern in m.group(1) else None
            if name:
                counts[name] = dict.fromkeys(keys + ("instructions",), 0)
            continue
        if name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[name]["instructions"] += 1
            for key in keys:
                counts[name][key] += key in line
    names = list(counts)
    try:
        plain = subprocess.run(
            ["/usr/local/cuda/bin/cu++filt"], input="\n".join(names),
            capture_output=True, text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    return {re.sub(r"\([\w: ]+\)(?=[-\w])", "", p).split("(")[0]
            .removeprefix("void "): counts[n] for n, p in zip(names, plain)}


def sass_counts(path: Path, pattern: str) -> dict:
    """{kernel: (wgmma, UTMALDG, instructions)} of the kernels of a built
    library whose mangled name contains ``pattern`` (``sass_kinds``, the
    wgmma kinds summed: HGMMA on 16-bit types, IGMMA on 8-bit integers,
    QGMMA on e4m3)."""
    return {k: (c["IGMMA"] + c["QGMMA"] + c["HGMMA"], c["UTMALDG"],
                c["instructions"]) for k, c in sass_kinds(path, pattern).items()}


def _events_call(fn):
    """(fn(), its ms by CUDA events): one call, after what is queued."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _gap_text(gap) -> str:
    return ", ".join(f"{w} {gap['err'][w]:.3e} (bound {gap['bound'][w]:.3e})"
                     for w in ("dq", "dk", "dv"))


def phase_bwd_rig(dev, gpu, planted_lib):
    """Phase 29: the backward rig P4 (``scripts/bwd_int8_probe.py``), ported
    in ``ops/bwd_probe.py``. Each kind's kernels against their plain
    version at the rig's own shape (operands made as the rig's ``build``
    makes them: bh 384, N_PAD 896; ctrl (32, 866, 12, 64)), each launch
    counted, the plain version timed by CUDA events on the call whose
    outputs are compared (after one warm-up call): int8 (K7's dk/dv and dq
    kernels with the rig's fixed scalars, after the layout pass) by
    ``int8_gap``: the plain version's p8 and ds8 codes against the codes it
    takes on the kernel's own delta (the layout pass sums delta in another
    order; exp2f on both sides), counted, the kernel's outputs equal to
    those codes' outputs, and dq, dk, dv equal to plain wherever no code of
    their row or column differs, within 1.27 per differing code otherwise;
    the plain ds8 saturated where p (dp - delta) SCALE 127 leaves the int8
    range, as jnp's cast gives it; fp8 (K3b's kernels on e4m3) by
    ``fp8_gap`` and ctrl (K3b) by ``ctrl_gap``, each output within 2 bf16
    ulps of its max. Planted faults, each refused: the int8 kernels built
    with the wrapping ``to_s8`` for ds8 (``planted_lib``, built in phase
    2), and for ctrl dq zeroed and K3b given lse with its second 64-entry
    tile replaced by the third. Then the slice's path: the rig as a user
    runs it, ``python -m maest_tpu_torch.probes.bwd_int8`` (``main`` in
    process at its defaults: bh 384, 30 iterations, 3 rounds), the counters
    set to 0 just before and read just after. Returns the errors (at bh
    384), the rig's results, the launches and the plain times."""
    import ctypes

    from maest_tpu_torch.ops import _build
    from maest_tpu_torch.ops import bwd_probe as P
    from maest_tpu_torch.probes import bwd_int8 as R

    err, plain, parts = {}, {}, []
    for kind in P.KINDS:
        ops = R.operands(kind, dev)  # the rig's defaults
        before = P.bwd_probe.launches[kind]
        out = P.bwd_probe(*ops, kind)
        torch.cuda.synchronize()
        check(P.bwd_probe.launches[kind] == before + 1, f"{kind} counter")
        P.bwd_probe_reference(*ops, kind)  # warm-up
        ref, plain[kind] = _events_call(
            lambda: P.bwd_probe_reference(*ops, kind))
        check([(t.shape, t.dtype) for t in out]
              == [(t.shape, t.dtype) for t in ref], f"{kind} shapes")
        if kind == "int8":
            codes = P.int8_codes(*ops)
            alt = P.int8_codes(*ops, delta=P.bwd_pass(*ops, kind)[-1])
            gap = P.int8_gap(out, ref, codes, alt)
            same = all(torch.equal(a, b) for a, b in zip(
                out, P.int8_outputs(ops[0], ops[1], ops[3], *alt)))
            _, _, y = P.int8_values(*ops)
            hi, lo = y > 127.5, y < -128.5
            sat = int(hi.sum() + lo.sum())
            check(gap["ok"] and same and sat > 0 and bool(
                (codes[1][hi] == 127).all() and (codes[1][lo] == -128).all()),
                f"int8 vs plain {gap}, equal on its codes {same}")
            del y, hi, lo
            real = _build._libs["attention_bwd_q8"]
            _build._libs["attention_bwd_q8"] = ctypes.CDLL(str(planted_lib))
            try:
                bad = P.launch_pass(P.bwd_pass(*ops, kind), kind)
            finally:
                _build._libs["attention_bwd_q8"] = real
            planted = P.int8_gap(bad, ref, codes, alt)
            check(not planted["ok"], f"the planted fault passed: {planted}")
            err[kind] = max(gap["err"].values())
            parts.append(
                f"int8 codes apart from plain p8 {gap['p8']}, ds8 "
                f"{gap['ds8']} of {codes[0].numel()} each (delta's sum order;"
                f" outputs equal to those codes' outputs: {same}), "
                f"max_abs_err {err[kind]:.4g} (bound 1.27 a differing code); "
                f"ds8 saturated in {sat} places (127 / -128, as jnp's cast); "
                f"planted fault (the kernels built with the wrapping to_s8 "
                f"for ds8): max_abs_err {max(planted['err'].values()):.4g}: "
                f"refused")
            del codes, alt, bad
        elif kind == "fp8":
            gap = P.fp8_gap(out, ref)
            check(gap["ok"], f"fp8 vs plain {gap}")
            err[kind] = max(gap["err"].values())
            parts.append("fp8 max_abs_err " + _gap_text(gap))
        else:
            gap = P.ctrl_gap(out, ref)
            zeroed = P.ctrl_gap((torch.zeros_like(out[0]), *out[1:]), ref)
            moved = ops[5].clone()
            moved[..., 64:128] = ops[5][..., 128:192]
            shifted = P.ctrl_gap(P.bwd_probe(*ops[:5], moved, kind), ref)
            check(gap["ok"], f"ctrl vs plain {gap}")
            check(not zeroed["ok"] and not shifted["ok"],
                  f"a planted ctrl fault passed: {zeroed} {shifted}")
            err[kind] = max(gap["err"].values())
            parts.append(
                f"ctrl (K3b) max_abs_err {_gap_text(gap)}; planted: dq "
                f"zeroed {_gap_text(zeroed)}: refused; lse's second tile "
                f"replaced by the third {_gap_text(shifted)}: refused")
        del ops, out, ref
        torch.cuda.empty_cache()
    print("phase 29 P4 kernels vs plain at the rig's shape (bh 384, N_PAD "
          "896; ctrl (32, 866, 12, 64)): " + "; ".join(parts), flush=True)

    print("phase 29 rig: python -m maest_tpu_torch.probes.bwd_int8",
          flush=True)
    _reset_counts()
    P.bwd_probe.launches = dict.fromkeys(P.KINDS, 0)
    rig = R.main([])
    launches = dict(P.bwd_probe.launches)
    check(all(launches.values()), f"rig launches {launches}")
    print(f"phase 29 launches in the rig's run: {launches}; plain versions "
          f"at bh 384 (CUDA events, the compared call): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in plain.items()) + f" [{gpu}]",
          flush=True)
    return {"err": err, "rig": rig, "launches": launches, "plain": plain}


def _wgmma_cfg(cfg, q, k, v, n_real=None, with_lse=False):
    """The wgmma kernel in sweep configuration ``cfg`` (WG_CONFIGS), (o,
    lse or None): the entry the production route does not take."""
    from maest_tpu_torch.ops import attention as A

    return A.launch_fwd_entry("attention_fwd", "maest_attn_fwd_bf16_wgmma",
                              (cfg,), q, k, v, n_real, with_lse,
                              q.shape[-1]**-0.5)


def _wgmma_checks(dev, planted_lib):
    """Phase 30's checks: K2 and K3a (the wgmma kernel, through
    ``flash_attention`` and ``flash_attention_fwd_lse``, each launch
    counted) against their plain versions within ATTN_TOL["bfloat16"] and
    LSE_TOL, lse within WG_LSE_TOL of the control's, at (32, 1676), (32,
    1792) n_real 1676, (32, 866), (100, 281) and (2, 1000) n_real 997, each
    on strided views of a fused qkv and on contiguous q, k, v; every sweep
    configuration against plain, the 64-key one bit-equal to the control;
    the kernel built with its key mask dropped refused. Returns the worst
    errors."""
    from maest_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(30)
    tol = ATTN_TOL["bfloat16"]
    worst = {"o": 0.0, "lse": 0.0, "lse_control": 0.0, "sweep": 0.0,
             "control": 0.0}
    for b, n, n_real in ((BATCH, 1676, None), (BATCH, 1792, 1676),
                         (BATCH, 866, None), (100, 281, None),
                         (2, 1000, 997)):
        x = torch.randn((b, n, 3, 12, 64), generator=gen, device=dev).to(
            torch.bfloat16)
        for layout in ("strided", "contiguous"):
            q, k, v = x.unbind(2)
            if layout == "contiguous":
                q, k, v = (t.contiguous() for t in (q, k, v))
            before = (A.flash_attention.launches,
                      A.flash_attention_fwd_lse.launches)
            with torch.inference_mode():
                o = A.flash_attention(q, k, v, n_real=n_real)
            ol, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
            c, cl = A.attention_fwd_mma(q, k, v, n_real, with_lse=True)
            r, rl = A.attention_reference_lse(q, k, v, n_real)
            torch.cuda.synchronize()
            check((A.flash_attention.launches, A.flash_attention_fwd_lse
                   .launches) == (before[0] + 1, before[1] + 1),
                  "wgmma counters")
            e, el, elc = max_err(o, r), max_err(lse, rl), max_err(lse, cl)
            check(e <= tol and el <= LSE_TOL and elc <= WG_LSE_TOL
                  and torch.equal(o, ol), f"wgmma ({b}, {n}) n_real {n_real} "
                  f"{layout}: o {e} lse {el} vs control {elc}")
            worst["o"] = max(worst["o"], e)
            worst["lse"] = max(worst["lse"], el)
            worst["lse_control"] = max(worst["lse_control"], elc)
            worst["control"] = max(worst["control"], max_err(c, r))
            sweep = 0.0
            for cfg in range(len(WG_CONFIGS)):
                oc, lc = _wgmma_cfg(cfg, q, k, v, n_real, True)
                torch.cuda.synchronize()
                ec = max_err(oc, r)
                check(ec <= tol and max_err(lc, rl) <= LSE_TOL,
                      f"wgmma {WG_CONFIGS[cfg]} ({b}, {n}) err {ec}")
                if cfg == wg_production(n_real or n):
                    check(torch.equal(oc, ol) and torch.equal(lc, lse),
                          f"config {cfg} is the production route at {n}")
                if cfg == 2:
                    check(torch.equal(oc, c) and torch.equal(lc, cl),
                          f"wgmma 64x3 ({b}, {n}) differs from the control")
                sweep = max(sweep, ec)
            worst["sweep"] = max(worst["sweep"], sweep)
            print(f"phase 30 wgmma K2/K3a ({b}, {n}, 12, 64) n_real {n_real} "
                  f"{layout}: vs plain o {e:.3e} <= {tol}, lse {el:.3e} <= "
                  f"{LSE_TOL}; lse vs the control {elc:.3e} <= {WG_LSE_TOL}; "
                  f"every sweep configuration vs plain <= {sweep:.3e}, 64x3 "
                  "torch.equal to the control", flush=True)
            del o, ol, lse, c, cl, r, rl
        del x
        torch.cuda.empty_cache()

    # the planted fault: keys at or past n_real hold v = 8, so any mass
    # they take moves the output far past the bound
    x = _planted_inputs(dev)
    q, k, v = x.unbind(2)
    sound = max_err(A.flash_attention(q, k, v, n_real=900),
                    A.attention_reference(q, k, v, 900))
    eb = _planted_err(planted_lib)
    check(sound <= tol < eb, f"planted no-mask {eb}, sound {sound}")
    print(f"phase 30 planted fault, the wgmma kernel built with its key mask "
          f"dropped, at (2, 1000, 12, 64) n_real 900 with v = 8 past it: "
          f"max_abs_err {eb:.3e} > {tol}, refused (the sound kernel "
          f"{sound:.3e})", flush=True)
    del x, q, k, v
    return worst


def _planted_inputs(dev):
    """Phase 30's planted fault's (2, 1000, 3, 12, 64) bf16 q/k/v, v = 8
    at keys 900 on, drawn from seed 33."""
    gen = torch.Generator(device=dev).manual_seed(33)
    x = torch.randn((2, 1000, 3, 12, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    x[:, 900:, 2] = 8.0
    return x


def _planted_err(lib: Path, inputs: str = "_planted_inputs",
                 entry: str = "maest_attn_fwd_bf16", n_real: int = 900,
                 width: int = 64) -> float:
    """max|o - plain| of ``entry`` (its width as its leading argument
    above 256) from the library ``lib`` on the q/k/v that this module's
    function ``inputs`` draws, with ``n_real``, run in a process of its
    own: a second copy of a kernel that this process has launched does not
    take its dynamic shared-memory limit here (its launch fails), so the
    copy is the only ``attention_fwd`` of that process."""
    lead = (width,) if width > 256 else ()
    code = (
        "import ctypes, json, sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as C\n"
        "from maest_tpu_torch.ops import _build, attention as A\n"
        f"_build._libs['attention_fwd'] = ctypes.CDLL({str(lib)!r})\n"
        f"q, k, v = C.{inputs}(torch.device('cuda')).unbind(2)\n"
        f"bad = A.launch_fwd_entry('attention_fwd', {entry!r}, {lead!r}, q, "
        f"k, v, {n_real}, False, {width ** -0.5})[0]\n"
        "print(json.dumps(C.max_err(bad, A.attention_reference(q, k, v, "
        f"{n_real}))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the planted fault's process failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    return float(json.loads(proc.stdout.strip().splitlines()[-1]))


def phase_wgmma(dev, gpu, planted_lib):
    """Phase 30: K2/K3a's wgmma kernel (``csrc/attn_fwd_wgmma.cuh``, the
    production route of ``maest_attn_fwd_bf16``) beside its mma.sync
    control (``attention_fwd_mma``) and SDPA. First ``_wgmma_checks``. Then
    CUDA-graph replays of the kernel, the control, SDPA and every other
    sweep configuration in WG_ROUNDS interleaved rounds (each once a round,
    the order reversed every other round) at K2's (32, 1676, 12, 64) and
    K3a's (32, 866, 12, 64) and (100, 281, 12, 64), every round printed;
    then the batch-32 30 s tagging step and the 30 s recipe step (B32,
    N 866) with each kernel in turn, the control reached through the
    private hook ``ops.attention._K2_CONTROL``, CUDA events over 3 steps a
    round after one, the launch counters checked on each; the 10 s recipe
    step at batch 100 (N 281) the same way. Returns the errors, the
    medians and the launches."""
    import torch.nn.functional as F

    from maest_tpu_torch import get_maest
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.probes.attn_profile import graph_ms
    from maest_tpu_torch.serve import BucketPrograms

    out = {"err": _wgmma_checks(dev, planted_lib), "rounds": {}, "ms": {},
           "launches": {}}
    gen = torch.Generator(device=dev).manual_seed(31)
    for name, b, n, lse in (("K2", BATCH, 1676, False),
                            ("K3a", BATCH, 866, True),
                            ("K3a", 100, 281, True)):
        x = torch.randn((b, n, 3, 12, 64), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = x.unbind(2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fns = {"wgmma": (lambda: A.flash_attention_fwd_lse(q, k, v)) if lse
               else (lambda: A.flash_attention(q, k, v)),
               "control": lambda: A.attention_fwd_mma(q, k, v, None, lse),
               "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt)}
        for cfg in range(len(WG_CONFIGS)):
            fns[WG_CONFIGS[cfg]] = (lambda cfg=cfg: _wgmma_cfg(
                cfg, q, k, v, None, lse))
        rows = {key: [] for key in fns}
        with torch.inference_mode():
            for rnd in range(WG_ROUNDS):
                order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
                for key in order:
                    rows[key].append(graph_ms(fns[key], 20, dev, reps=1))
                print(f"phase 30 {name} ({b}, {n}, 12, 64) round {rnd + 1} "
                      "CUDA-graph ms: wgmma {:.4f}, control {:.4f}, SDPA "
                      "{:.4f}; ".format(rows["wgmma"][-1],
                                        rows["control"][-1], rows["sdpa"][-1])
                      + ", ".join(f"{key} {rows[key][-1]:.4f}"
                                  for key in fns if key not in (
                                      "wgmma", "control", "sdpa"))
                      + f" [{gpu}]", flush=True)
        med = {key: float(np.median(ms)) for key, ms in rows.items()}
        every = all(w < c for w, c in zip(rows["wgmma"], rows["control"]))
        resolved = max(rows["wgmma"]) < min(rows["control"])
        best = min(med, key=med.get)
        print(f"phase 30 {name} ({b}, {n}, 12, 64) medians: wgmma "
              f"{med['wgmma']:.4f} ms (its tile "
              f"{WG_CONFIGS[wg_production(n)]}), control "
              f"{med['control']:.4f} ms "
              f"({med['control'] / med['wgmma']:.2f}x), SDPA {med['sdpa']:.4f}"
              f" ms; the wgmma kernel beat the control in every round: "
              f"{every}, resolved (its slowest round under the control's "
              f"fastest): {resolved}; fastest of all: {best} [{gpu}]",
              flush=True)
        out["rounds"][(name, b, n)] = rows
        out["ms"][(name, b, n)] = med
        del x, q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    # the steps with each kernel, in turn
    counts = (A.flash_attention, A.flash_attention_fwd_lse,
              A.attention_fwd_mma)
    model = get_maest(arch=ARCH, pretrained=False, device=dev,
                      dtype=torch.bfloat16)
    prog = BucketPrograms(model, buckets=(BATCH,), fused_wave=True)
    waves = torch.from_numpy(np.random.default_rng(30).standard_normal(
        (BATCH, CLIP)).astype(np.float32) * 0.1).to(dev)
    _, mcfg, net, state, step, data = _recipe(dev, RECIPE, BATCH, 30)
    _, mcfg10, net10, state10, step10, data10 = _recipe(
        dev, "maest_10s_from_passt_pretrain", 100, 30)
    gen_step = torch.Generator().manual_seed(30)
    depth = model.net.cfg.depth
    steps = {"tagging": lambda: prog._activations(waves),
             "recipe": lambda: step(state, data, gen_step),
             "recipe 10 s B100": lambda: step10(state10, data10, gen_step)}
    want = {}
    for what, d in (("tagging", depth), ("recipe", mcfg.depth),
                    ("recipe 10 s B100", mcfg10.depth)):
        mine = (4 * d, 0, 0) if what == "tagging" else (0, 4 * d, 0)
        want[(what, False)], want[(what, True)] = mine, (0, 0, 4 * d)
    step_ms = {(s_, c_): [] for s_ in steps for c_ in ("wgmma", "control")}
    try:
        for rnd in range(WG_ROUNDS):
            for what, fn in steps.items():
                order = ("wgmma", "control") if rnd % 2 == 0 else (
                    "control", "wgmma")
                for route in order:
                    A._K2_CONTROL = route == "control"
                    for f in counts:
                        f.launches = 0
                    with torch.inference_mode(what == "tagging"):
                        step_ms[(what, route)].append(cuda_ms(fn, 3))
                    got = tuple(f.launches for f in counts)
                    check(got == want[(what, A._K2_CONTROL)],
                          f"{what} with the {route}: launches {got}")
                    out["launches"][(what, route)] = got
            print(f"phase 30 steps round {rnd + 1} (CUDA events, ms a step): "
                  + ", ".join(f"{w} with the {r} {ms[-1]:.3f}"
                              for (w, r), ms in step_ms.items())
                  + f" [{gpu}]", flush=True)
    finally:
        A._K2_CONTROL = False
    for (what, route), ms in step_ms.items():
        out["ms"][(what, route)] = float(np.median(ms))
    tag = {r: out["ms"][("tagging", r)] for r in ("wgmma", "control")}
    rec = {r: out["ms"][("recipe", r)] for r in ("wgmma", "control")}
    r10 = {r: out["ms"][("recipe 10 s B100", r)] for r in ("wgmma", "control")}
    won = {w: sum(a < b for a, b in zip(step_ms[(w, "wgmma")],
                                        step_ms[(w, "control")]))
           for w in steps}
    print(f"phase 30 steps, medians of {WG_ROUNDS} rounds: batch-{BATCH} 30 s "
          f"bf16 tagging {tag['wgmma']:.3f} ms with the wgmma kernel ("
          f"{BATCH * 30 / (tag['wgmma'] / 1e3):.1f} audio-s/s) against "
          f"{tag['control']:.3f} with the control; {RECIPE} B{BATCH} "
          f"{rec['wgmma']:.3f} ms against {rec['control']:.3f}; the 10 s "
          f"recipe B100 {r10['wgmma']:.3f} ms against {r10['control']:.3f}; "
          f"rounds won by the wgmma kernel {won}; launches a round (K2, K3a, "
          f"control) {out['launches']} [{gpu}]", flush=True)
    del model, prog, waves, net, state, step, data, net10, state10, step10
    del data10
    torch.cuda.empty_cache()
    return out


def _bwd_cfg(cfg, q, k, v, o, lse, do, n_real=None):
    """The wgmma backward in sweep configuration ``cfg`` (WG_BWD_CONFIGS),
    (dq, dk, dv): the entry the production route does not take."""
    from maest_tpu_torch.ops import attention as A

    return A.launch_bwd_entry("maest_attn_bwd_bf16_wgmma", (cfg,), q, k, v, o,
                              lse, do, n_real, q.shape[-1]**-0.5).unbind(2)


def _bwd_wgmma_checks(dev, planted_lib):
    """Phase 31's checks: K3b/K4 (the wgmma kernel, through
    ``attention_bwd``, each launch counted) at (32, 866), (32, 896) n_real
    866, (100, 281) and (2, 4500) n_real 4400 on strided views of one fused
    q/k/v/do, against the tiled plain version and ``attention_bwd_reference``
    within ATTN_TOL["bfloat16"]; masked dk and dv exactly zero; two launches
    torch.equal; the control within the same bound of plain; every sweep
    configuration against plain, the production one torch.equal to the
    route; the kernel built with its key mask dropped refused. Returns the
    worst errors, and phase 42's planted gap ("planted_d256"), taken in the
    same planted process."""
    from maest_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(31)
    tol = ATTN_TOL["bfloat16"]
    worst = dict.fromkeys(("plain", "tiled", "control", "sweep"), 0.0)
    for b, n, n_real in BWD_WG_SHAPES:
        x = torch.randn((b, n, 4, 12, 64), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v, do = x.unbind(2)
        o, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
        before = A.attention_bwd.launches
        g = A.attention_bwd(q, k, v, o, lse, do, n_real)
        again = A.attention_bwd(q, k, v, o, lse, do, n_real)
        c = A.attention_bwd_mma(q, k, v, o, lse, do, n_real)
        r = A.attention_bwd_reference(q, k, v, o, lse, do, n_real)
        tr = A.attention_bwd_tiled_reference(q, k, v, o, lse, do, n_real)
        torch.cuda.synchronize()
        check(A.attention_bwd.launches == before + 2, "K3b counter")
        e = max(max_err(a, z) for a, z in zip(g, r))
        et = max(max_err(a, z) for a, z in zip(g, tr))
        ec = max(max_err(a, z) for a, z in zip(c, r))
        same = all(torch.equal(a, z) for a, z in zip(g, again))
        zero = n_real is None or not (g[1][:, n_real:].any()
                                      or g[2][:, n_real:].any())
        check(e <= tol and et <= tol and ec <= tol and same and zero,
              f"wgmma backward ({b}, {n}) n_real {n_real}: vs plain {e}, vs "
              f"tiled {et}, control {ec}, deterministic {same}, masked zero "
              f"{zero}")
        sweep = 0.0
        for cfg in range(len(WG_BWD_CONFIGS)):
            gc = _bwd_cfg(cfg, q, k, v, o, lse, do, n_real)
            torch.cuda.synchronize()
            es = max(max_err(a, z) for a, z in zip(gc, r))
            check(es <= tol, f"wgmma backward {WG_BWD_CONFIGS[cfg]} ({b}, "
                  f"{n}) err {es}")
            if cfg == WG_BWD_PRODUCTION:
                check(all(torch.equal(a, z) for a, z in zip(gc, g)),
                      f"config {cfg} is the production route")
            sweep = max(sweep, es)
        for key, val in (("plain", e), ("tiled", et), ("control", ec),
                         ("sweep", sweep)):
            worst[key] = max(worst[key], val)
        print(f"phase 31 wgmma K3b/K4 ({b}, {n}, 12, 64) n_real {n_real} "
              f"strided: max_abs_err vs plain {e:.3e}, vs the tiled plain "
              f"version {et:.3e}, the control vs plain {ec:.3e} <= {tol}; "
              f"two launches torch.equal: {same}; masked dk/dv exactly 0: "
              f"{zero}; every sweep configuration vs plain <= {sweep:.3e}",
              flush=True)
        del x, q, k, v, do, o, lse, g, again, c, r, tr
        torch.cuda.empty_cache()

    # the planted fault: keys at or past n_real hold k = 4, so any mass they
    # take moves dq far past the bound and gives them dk, dv
    x = _bwd_planted_inputs(dev)
    q, k, v, do = x.unbind(2)
    o, lse = A.flash_attention_fwd_lse(q, k, v, 900)
    sound = max(max_err(a, z) for a, z in zip(
        A.attention_bwd(q, k, v, o, lse, do, 900),
        A.attention_bwd_reference(q, k, v, o, lse, do, 900)))
    eb, masked, worst["planted_d256"] = _bwd_planted_err(planted_lib)
    check(sound <= tol < eb and masked > 0,
          f"planted no-mask {eb} (masked dk/dv {masked}), sound {sound}")
    print(f"phase 31 planted fault, the wgmma backward built with its key "
          f"mask dropped, at (2, 1000, 12, 64) n_real 900 with k = 4 past "
          f"it: max_abs_err {eb:.3e} > {tol}, masked dk/dv up to "
          f"{masked:.3e}: refused (the sound kernel {sound:.3e})", flush=True)
    del x, q, k, v, do, o, lse
    return worst


def _bwd_planted_inputs(dev):
    """Phase 31's planted fault's (2, 1000, 4, 12, 64) bf16 q/k/v/do, k = 4
    at keys 900 on, drawn from seed 34."""
    gen = torch.Generator(device=dev).manual_seed(34)
    x = torch.randn((2, 1000, 4, 12, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    x[:, 900:, 1] = 4.0
    return x


def _bwd_planted_err(lib: Path) -> tuple[float, float, float]:
    """(max|grads - plain|, max|dk, dv past n_real|) of maest_attn_bwd_bf16
    from the library ``lib`` on ``_bwd_planted_inputs`` with n_real 900,
    and phase 42's ``_d256_gap`` of maest_attn_bwd_bf16_d256 from it (its
    planted fault is in the same build), run in a process of its own (as
    ``_planted_err``)."""
    code = (
        "import ctypes, json, sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as C\n"
        "from maest_tpu_torch.ops import _build, attention as A\n"
        f"_build._libs['attention_bwd'] = ctypes.CDLL({str(lib)!r})\n"
        "q, k, v, do = C._bwd_planted_inputs(torch.device('cuda')).unbind(2)\n"
        "o, lse = A.flash_attention_fwd_lse(q, k, v, 900)\n"
        "bad = A.launch_bwd_entry('maest_attn_bwd_bf16', (), q, k, v, o, lse,"
        " do, 900, 0.125).unbind(2)\n"
        "ref = A.attention_bwd_reference(q, k, v, o, lse, do, 900)\n"
        "print(json.dumps([max(C.max_err(a, r) for a, r in zip(bad, ref)), "
        "max(g[:, 900:].float().abs().max().item() for g in bad[1:]), "
        "C._d256_gap(C._d256_planted_inputs(torch.device('cuda')))]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the planted fault's process failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    return tuple(json.loads(proc.stdout.strip().splitlines()[-1]))


def sdpa_bwd_call(q, k, v, do):
    """One call of SDPA's backward (the flash backend's aten op, on its own
    forward's saved tensors) on (B, N, H, D) bf16: the library call that
    computes K3b's function, which the port never calls."""
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    saved = torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt)
    o, lse, cq, ck, mq, mk, seed, offset = saved[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, o, lse, cq, ck, mq, mk, 0.0, False, seed, offset)


def phase_bwd_wgmma(dev, gpu, planted_lib):
    """Phase 31: K3b/K4's wgmma kernel (``csrc/attn_bwd_wgmma.cuh``, the
    production route of ``maest_attn_bwd_bf16``) beside its mma.sync
    control (``attention_bwd_mma``) and SDPA's backward. First
    ``_bwd_wgmma_checks``. Then CUDA-graph replays of the kernel, the
    control, SDPA's backward and every other sweep configuration in
    WG_ROUNDS interleaved rounds (each once a round, the order reversed
    every other round) at (32, 866, 12, 64), (100, 281, 12, 64) and (2,
    4500, 12, 64) n_real 4400 (SDPA at (2, 4400): its flash backend takes no
    key mask), every round printed; then the 30 s recipe step (B32, N 866)
    and the 10 s recipe step (B100, N 281) with each kernel in turn, the
    control reached through the private hook ``ops.attention._K3B_CONTROL``,
    CUDA events over 3 steps a round after one, the launch counters checked
    on each. Returns the errors, the medians, the launches and phase 42's
    planted fault's gap ("planted_d256", from the same planted process)."""
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.probes.attn_profile import graph_ms

    err = _bwd_wgmma_checks(dev, planted_lib)
    out = {"err": err, "planted_d256": err.pop("planted_d256"), "rounds": {},
           "ms": {}, "launches": {}}
    gen = torch.Generator(device=dev).manual_seed(32)
    for b, n, n_real in ((BATCH, 866, None), (100, 281, None),
                         (2, 4500, 4400)):
        x = torch.randn((b, n, 4, 12, 64), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v, do = x.unbind(2)
        o, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
        real = slice(0, n_real or n)
        fns = {"wgmma": lambda: A.attention_bwd(q, k, v, o, lse, do, n_real),
               "control": lambda: A.attention_bwd_mma(q, k, v, o, lse, do,
                                                      n_real),
               "sdpa": sdpa_bwd_call(*(t[:, real] for t in (q, k, v, do)))}
        for cfg in range(len(WG_BWD_CONFIGS)):
            if cfg != WG_BWD_PRODUCTION:
                fns[WG_BWD_CONFIGS[cfg]] = (lambda cfg=cfg: _bwd_cfg(
                    cfg, q, k, v, o, lse, do, n_real))
        rows = {key: [] for key in fns}
        for rnd in range(WG_ROUNDS):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for key in order:
                rows[key].append(graph_ms(fns[key], 10, dev, reps=1))
            print(f"phase 31 K3b/K4 ({b}, {n}, 12, 64) n_real {n_real} round "
                  f"{rnd + 1} CUDA-graph ms: " + ", ".join(
                      f"{key} {rows[key][-1]:.4f}" for key in fns)
                  + f" [{gpu}]", flush=True)
        med = {key: float(np.median(ms)) for key, ms in rows.items()}
        every = all(w < c for w, c in zip(rows["wgmma"], rows["control"]))
        print(f"phase 31 K3b/K4 ({b}, {n}, 12, 64) n_real {n_real} medians: "
              f"wgmma {med['wgmma']:.4f} ms "
              f"({WG_BWD_CONFIGS[WG_BWD_PRODUCTION]}), control "
              f"{med['control']:.4f} ms ({med['control'] / med['wgmma']:.2f}"
              f"x), SDPA's backward {med['sdpa']:.4f} ms; the wgmma kernel "
              f"beat the control in every round: {every}; fastest of all: "
              f"{min(med, key=med.get)} [{gpu}]", flush=True)
        out["rounds"][(b, n)] = rows
        out["ms"][(b, n)] = med
        del x, q, k, v, do, o, lse, fns
        torch.cuda.empty_cache()

    # the recipe steps with each kernel, in turn
    _, mcfg, net, state, step, data = _recipe(dev, RECIPE, BATCH, 31)
    _, mcfg10, net10, state10, step10, data10 = _recipe(
        dev, "maest_10s_from_passt_pretrain", 100, 31)
    gen_step = torch.Generator().manual_seed(31)
    steps = {"recipe": (lambda: step(state, data, gen_step), mcfg.depth),
             "recipe 10 s B100": (lambda: step10(state10, data10, gen_step),
                                  mcfg10.depth)}
    counts = (A.attention_bwd, A.attention_bwd_mma)
    step_ms = {(s_, r_): [] for s_ in steps for r_ in ("wgmma", "control")}
    try:
        for rnd in range(WG_ROUNDS):
            for what, (fn, depth) in steps.items():
                order = ("wgmma", "control") if rnd % 2 == 0 else (
                    "control", "wgmma")
                for route in order:
                    A._K3B_CONTROL = route == "control"
                    for f in counts:
                        f.launches = 0
                    step_ms[(what, route)].append(cuda_ms(fn, 3))
                    got = tuple(f.launches for f in counts)
                    want = (0, 4 * depth) if A._K3B_CONTROL else (4 * depth, 0)
                    check(got == want, f"{what} with the {route}: launches "
                          f"{got}")
                    out["launches"][(what, route)] = got
            print(f"phase 31 steps round {rnd + 1} (CUDA events, ms a step): "
                  + ", ".join(f"{w} with the {r} {ms[-1]:.3f}"
                              for (w, r), ms in step_ms.items())
                  + f" [{gpu}]", flush=True)
    finally:
        A._K3B_CONTROL = False
    for key, ms in step_ms.items():
        out["ms"][key] = float(np.median(ms))
    won = {w: sum(a < c for a, c in zip(step_ms[(w, "wgmma")],
                                        step_ms[(w, "control")]))
           for w in steps}
    print(f"phase 31 steps, medians of {WG_ROUNDS} rounds: {RECIPE} B{BATCH} "
          f"{out['ms'][('recipe', 'wgmma')]:.3f} ms with the wgmma backward "
          f"against {out['ms'][('recipe', 'control')]:.3f} with the control; "
          f"the 10 s recipe B100 {out['ms'][('recipe 10 s B100', 'wgmma')]:.3f}"
          f" against {out['ms'][('recipe 10 s B100', 'control')]:.3f}; rounds "
          f"won by the wgmma backward {won}; launches a round (K3b, control) "
          f"{out['launches']} [{gpu}]", flush=True)
    del net, state, step, data, net10, state10, step10, data10
    torch.cuda.empty_cache()
    return out


# phase 32's planted fault: the wgmma K7 with key tile 1's dq adds dropped,
# so dq misses the keys 128..255 of every head
PLANT_K7_DQ = (
    "          bulk_add_s32(dq_acc + (static_cast<long long>(bh) * n_pad + it * QW_BQ) * 64,",
    "          if (kb != 1) bulk_add_s32(dq_acc + (static_cast<long long>(bh) * n_pad + it * QW_BQ) * 64,")
# phase 32's draws: phase 15's five (the 30 s recipe's (32, 866), padded
# with n_real, the 10 s recipe's, three 640-row q-blocks, normal x 0.5)
K7_WG_SHAPES = ((BATCH, 866, None, 1.0), (BATCH, 896, 866, 1.0),
                (100, 281, None, 1.0), (2, 1800, 1790, 1.0),
                (BATCH, 866, None, 0.5))

# and the shapes it times: the 30 s and 10 s recipes', three q-blocks
K7_WG_TIMED = ((BATCH, 866, None), (100, 281, None), (2, 1800, 1790))


def build_planted_k7_dq() -> tuple[Path, float]:
    """``csrc/attention_bwd_q8.cu`` with the wgmma K7's bulk dq add of key
    tile 1 dropped (phase 32 shows its check refusing the kernel so
    built)."""
    return _build_planted("k7_dq", "attention_bwd_q8", "attn_bwd_q8_wgmma.cuh",
                          PLANT_K7_DQ)


def _k7_inputs(rng, dev, b, n, scale):
    """(q, k, v, do) bf16 (B, N, H, 64): q, k, v strided views of one fused
    draw, normal x ``scale``, do normal, from the numpy generator."""
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, 12, 64)).astype(
        np.float32) * scale).to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((b, n, 12, 64)).astype(
        np.float32)).to(dev, torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], g


def _k7_gap(got, ref) -> tuple[list, bool]:
    """([(name, max_abs_err, of max, cos)], all within K7_TOL and K7_COS)."""
    rows, ok = [], True
    for w, a, r in zip(("dq", "dk", "dv"), got, ref):
        e = max_err(a, r)
        top = r.float().abs().max().item()
        cos = cosine(a, r)
        ok = ok and e <= K7_TOL * top and cos >= K7_COS
        rows.append((w, e, e / top, cos))
    return rows, ok


def _k7_planted_err(lib: Path) -> list:
    """[max|grad - plain| / max|plain| for dq, dk, dv] of the wgmma K7 from
    the library ``lib`` at (2, 866, 12, 64) (phase 32's draw), run in a
    process of its own (as ``_planted_err``)."""
    code = (
        "import ctypes, json, sys, numpy as np, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as C\n"
        "from maest_tpu_torch.ops import _build, attention as A\n"
        f"_build._libs['attention_bwd_q8'] = ctypes.CDLL({str(lib)!r})\n"
        "q, k, v, g = C._k7_inputs(np.random.default_rng(33), "
        "torch.device('cuda'), 2, 866, 0.5)\n"
        "o, lse = A.flash_attention_fwd_lse(q, k, v)\n"
        "bad = A.attention_bwd_int8(q, k, v, o, lse, g)\n"
        "ref = A.attention_bwd_int8_reference(q, k, v, o, lse, g)\n"
        "print(json.dumps([C.max_err(a, r) / r.float().abs().max().item() "
        "for a, r in zip(bad, ref)]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the planted fault's process failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_k7_wgmma(dev, gpu, planted_lib):
    """Phase 32: K7 on wgmma and TMA (``csrc/attn_bwd_q8_wgmma.cuh``, the
    route of ``attention_bwd_int8`` in bf16 at head_dim 64) at phase 15's
    five draws against ``attention_bwd_int8_reference`` (K7_TOL of each
    gradient's max, cosine K7_COS), its tiled plain version
    (``attention_bwd_int8_tiled_reference``, the same bound) and its
    mma.sync control (``attention_bwd_int8_mma``, the same bound); two
    launches torch.equal (dq's int32 sums are order-free); masked dk/dv
    exactly zero; the kernel built with key tile 1's dq adds dropped
    refused (in a process of its own). Then CUDA-graph replays of the
    kernel, the control and the bf16 backward (K3b) in WG_ROUNDS
    interleaved rounds at (32, 866), (100, 281) and (2, 1800) n_real 1790,
    every round printed; the kernel's launches by device time at (32, 866)
    (amax, quant, stats, main, dq); and phase 16's recipe step (30 s, B32,
    attention_bwd_quant="int8") with each kernel in turn through the
    private hook ``ops.attention._K7_CONTROL``, CUDA events over 3 steps a
    round after one, the launch counters checked on each. Returns the
    errors, the medians and the launches."""
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.probes.attn_profile import graph_ms

    rng = np.random.default_rng(32)
    out = {"err": 0.0, "err_control": 0.0, "ms": {}, "launches": {}}
    for b, n, n_real, scale in K7_WG_SHAPES:
        q, k, v, g = _k7_inputs(rng, dev, b, n, scale)
        o, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
        before = (A.attention_bwd_int8.launches,
                  A.attention_bwd_int8_mma.launches)
        got = A.attention_bwd_int8(q, k, v, o, lse, g, n_real)
        again = A.attention_bwd_int8(q, k, v, o, lse, g, n_real)
        ctl = A.attention_bwd_int8_mma(q, k, v, o, lse, g, n_real)
        ref = A.attention_bwd_int8_reference(q, k, v, o, lse, g, n_real)
        tiled = A.attention_bwd_int8_tiled_reference(q, k, v, o, lse, g,
                                                     n_real)
        torch.cuda.synchronize()
        check((A.attention_bwd_int8.launches, A.attention_bwd_int8_mma.launches)
              == (before[0] + 2, before[1] + 1), "K7 and control counters")
        rows, ok = _k7_gap(got, ref)
        _, ok_tiled = _k7_gap(got, tiled)
        crows, ok_ctl = _k7_gap(ctl, ref)
        same = all(torch.equal(a, z) for a, z in zip(got, again))
        zero = n_real is None or not (got[1][:, n_real:].any()
                                      or got[2][:, n_real:].any())
        check(ok and ok_tiled and ok_ctl and same and zero,
              f"wgmma K7 ({b}, {n}) n_real {n_real} x{scale}: {rows}, "
              f"tiled {ok_tiled}, control {crows}, bitwise {same}, masked "
              f"zero {zero}")
        out["err"] = max(out["err"], max(r[1] for r in rows))
        out["err_control"] = max(out["err_control"], max(r[1] for r in crows))
        plain_eq = all(torch.equal(a, z) for a, z in zip(tiled, ref))
        print(f"phase 32 wgmma K7 ({b}, {n}, 12, 64) n_real {n_real} q, k, v "
              f"normal x {scale} q-block {A.bwd_q_block(n)}: vs plain "
              + ", ".join(f"{w} {e:.3e} ({rel:.2e} of max, cos {c:.6f})"
                          for w, e, rel, c in rows)
              + f" <= {K7_TOL} of max, cos >= {K7_COS}; vs the tiled plain "
              f"version within the same; the tiled plain version torch.equal "
              f"to plain: {plain_eq}; the control vs plain "
              + ", ".join(f"{w} {rel:.2e}" for w, _, rel, _ in crows)
              + f"; two launches torch.equal: {same}; masked dk/dv exactly "
              f"0: {zero}", flush=True)
        del q, k, v, g, o, lse, got, again, ctl, ref, tiled
        torch.cuda.empty_cache()

    errs = _k7_planted_err(planted_lib)
    check(errs[0] > K7_TOL, f"planted dq drop refused: {errs}")
    print(f"phase 32 planted fault, the wgmma K7 built with key tile 1's dq "
          f"adds dropped, at (2, 866, 12, 64): dq {errs[0]:.3e} of max > "
          f"{K7_TOL}: refused (dk {errs[1]:.2e}, dv {errs[2]:.2e} of max)",
          flush=True)

    for b, n, n_real in K7_WG_TIMED:
        q, k, v, g = _k7_inputs(rng, dev, b, n, 0.5)
        o, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
        fns = {"wgmma": lambda: A.attention_bwd_int8(q, k, v, o, lse, g,
                                                     n_real),
               "control": lambda: A.attention_bwd_int8_mma(q, k, v, o, lse, g,
                                                           n_real),
               "K3b": lambda: A.attention_bwd(q, k, v, o, lse, g, n_real)}
        rows = {key: [] for key in fns}
        for rnd in range(WG_ROUNDS):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for key in order:
                rows[key].append(graph_ms(fns[key], 10, dev, reps=1))
            print(f"phase 32 K7 ({b}, {n}, 12, 64) n_real {n_real} round "
                  f"{rnd + 1} CUDA-graph ms: " + ", ".join(
                      f"{key} {rows[key][-1]:.4f}" for key in fns)
                  + f" [{gpu}]", flush=True)
        med = {key: float(np.median(ms)) for key, ms in rows.items()}
        every = all(w < c for w, c in zip(rows["wgmma"], rows["control"]))
        line = (f"phase 32 K7 ({b}, {n}, 12, 64) n_real {n_real} medians: "
                f"wgmma {med['wgmma']:.4f} ms, control {med['control']:.4f} "
                f"ms ({med['control'] / med['wgmma']:.2f}x), the bf16 "
                f"backward (K3b) {med['K3b']:.4f} ms; the wgmma K7 beat the "
                f"control in every round: {every}")
        if b == BATCH:
            parts = _kernel_ms(fns["wgmma"], K7W_EXPECT)
            out["split"] = parts
            line += f"; its launches by device time: {_fmt_ms(parts)}"
        print(line + f" [{gpu}]", flush=True)
        if (b, n) == (BATCH, 866):
            check(every, "the wgmma K7 beats its control in every round at "
                  f"({b}, {n})")
        out["ms"][(b, n)] = med
        del q, k, v, g, o, lse, fns
        torch.cuda.empty_cache()

    _, mcfg, net, state, step, data = _recipe(
        dev, RECIPE, BATCH, 32, ["maest.attention_bwd_quant=int8"])
    gen = torch.Generator().manual_seed(32)
    counts = (A.attention_bwd_int8, A.attention_bwd_int8_mma)
    step_ms = {"wgmma": [], "control": []}
    try:
        for rnd in range(WG_ROUNDS):
            order = ("wgmma", "control") if rnd % 2 == 0 else (
                "control", "wgmma")
            for route in order:
                A._K7_CONTROL = route == "control"
                for f in counts:
                    f.launches = 0
                step_ms[route].append(cuda_ms(lambda: step(state, data, gen),
                                              3))
                got = tuple(f.launches for f in counts)
                want = ((0, 4 * mcfg.depth) if A._K7_CONTROL
                        else (4 * mcfg.depth, 0))
                check(got == want, f"int8 recipe with the {route}: launches "
                      f"{got}")
                out["launches"][route] = got
            print(f"phase 32 int8 recipe step round {rnd + 1} (CUDA events, "
                  f"ms a step): with the wgmma K7 {step_ms['wgmma'][-1]:.3f}, "
                  f"with the control {step_ms['control'][-1]:.3f} [{gpu}]",
                  flush=True)
    finally:
        A._K7_CONTROL = False
    for route, ms in step_ms.items():
        out["ms"][("recipe", route)] = float(np.median(ms))
    won = sum(a < c for a, c in zip(step_ms["wgmma"], step_ms["control"]))
    print(f"phase 32 int8 recipe step {RECIPE} B{BATCH} with "
          f"attention_bwd_quant=int8, medians of {WG_ROUNDS} rounds: "
          f"{out['ms'][('recipe', 'wgmma')]:.3f} ms with the wgmma K7 against "
          f"{out['ms'][('recipe', 'control')]:.3f} with the control; rounds "
          f"won by the wgmma K7 {won} of {WG_ROUNDS}; launches a round (K7, "
          f"control) {out['launches']} [{gpu}]", flush=True)
    del net, state, step, data
    torch.cuda.empty_cache()
    return out


# phase 34's planted fault: one tf32 product (hi.hi) where the kernels take
# three, in the forward and the backward alike
PLANT_TF32_1X = ("constexpr bool TF_3X = true;",
                 "constexpr bool TF_3X = false;")
# phase 34's shapes: K2's, the 30 s and 10 s recipes' and K4's regime
TF_FWD_SHAPES = ((BATCH, 1676, None), (BATCH, 866, None), (100, 281, None),
                 (2, 4500, 4400))
TF_BWD_SHAPES = ((BATCH, 866, None), (100, 281, None), (2, 4500, 4400))


def build_planted_tf32_fwd() -> tuple[Path, float]:
    """``csrc/attention_fwd.cu`` with one tf32 product in the tf32 kernel
    (phase 34 shows its check refusing the kernel so built)."""
    return _build_planted("tf32_1x_fwd", "attention_fwd", "tf32_wgmma.cuh",
                          PLANT_TF32_1X)


def build_planted_tf32_bwd() -> tuple[Path, float]:
    """``csrc/attention_bwd.cu`` with one tf32 product in the tf32 kernels
    (phase 34 shows its check refusing the kernels so built)."""
    return _build_planted("tf32_1x_bwd", "attention_bwd", "tf32_wgmma.cuh",
                          PLANT_TF32_1X)


def _tf32_planted_err(fwd_lib: Path, bwd_lib: Path) -> list:
    """[max|o - plain|, max|grads - plain|] of fp32 K2 and K3b from the
    libraries built with one tf32 product, at (2, 1000, 12, 64) n_real 997
    drawn from seed 34, run in a process of its own (as ``_planted_err``)."""
    code = (
        "import ctypes, json, sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as C\n"
        "from maest_tpu_torch.ops import _build, attention as A\n"
        f"_build._libs['attention_fwd'] = ctypes.CDLL({str(fwd_lib)!r})\n"
        f"_build._libs['attention_bwd'] = ctypes.CDLL({str(bwd_lib)!r})\n"
        "gen = torch.Generator(device='cuda').manual_seed(34)\n"
        "q, k, v, do = torch.randn((2, 1000, 4, 12, 64), generator=gen, "
        "device='cuda').unbind(2)\n"
        "ro, rl = A.attention_reference_lse(q, k, v, 997)\n"
        "o = A.flash_attention(q, k, v, 997)\n"
        "g = A.attention_bwd(q, k, v, ro, rl, do, 997)\n"
        "r = A.attention_bwd_reference(q, k, v, ro, rl, do, 997)\n"
        "print(json.dumps([C.max_err(o, ro), max(C.max_err(a, b) for a, b in "
        "zip(g, r))]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the planted fault's process failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _tf32_shrink(dev, gen) -> dict:
    """{route: [shrink of o, dq, dk, dv]}: sum(x r) / sum(r r) - 1 against
    attention and its gradients in fp64, of the tf32 kernels, the FMA
    controls and plain, at (4, 866, 12, 64): the systematic part of each
    one's error (a sum that truncates shrinks)."""
    from maest_tpu_torch.ops import attention as A

    q, k, v, do = torch.randn((4, 866, 4, 12, 64), generator=gen,
                              device=dev).unbind(2)
    qh, kh, vh, doh = (t.double().transpose(1, 2) for t in (q, k, v, do))
    p = torch.softmax(qh @ kh.transpose(-1, -2) * 0.125, -1)
    o = p @ vh
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * o).sum(-1, True)) * 0.125
    ref = [t.transpose(1, 2) for t in (o, ds @ kh, ds.transpose(-1, -2) @ qh,
                                       p.transpose(-1, -2) @ doh)]
    del p, ds
    runs = {"tf32": (A.flash_attention_fwd_lse, A.attention_bwd),
            "FMA control": (lambda *a: A.attention_fwd_fp32_fma(*a, None, True),
                            A.attention_bwd_fp32_fma),
            "plain": (A.attention_reference_lse, A.attention_bwd_reference)}
    out = {}
    for name, (fwd, bwd) in runs.items():
        o, lse = fwd(q, k, v)
        got = (o, *bwd(q, k, v, o, lse, do))
        out[name] = [float((a.double() * r).sum() / (r * r).sum() - 1)
                     for a, r in zip(got, ref)]
    return out


def _tf32_checks(dev, planted):
    """Phase 34's checks: fp32 K2 and K3a (the tf32 kernel) and their scalar
    FMA control against plain at TF_FWD_SHAPES (o within ATTN_TOL, lse
    within LSE_TOL, K2's o torch.equal to K3a's); K3b/K4 (the tf32 kernels)
    and their control against plain at TF_BWD_SHAPES (ATTN_TOL), masked
    dk/dv exactly zero, two launches torch.equal; the kernels built with
    one tf32 product refused. Every launch counted.
    Returns the largest errors."""
    from maest_tpu_torch.ops import attention as A

    tol = ATTN_TOL["float32"]
    gen = torch.Generator(device=dev).manual_seed(34)
    err = {"fwd": 0.0, "lse": 0.0, "bwd": 0.0, "fwd_control": 0.0,
           "bwd_control": 0.0}
    for b, n, n_real in TF_FWD_SHAPES:
        q, k, v = torch.randn((b, n, 3, 12, 64), generator=gen,
                              device=dev).unbind(2)
        before = (A.flash_attention.launches, A.flash_attention_fwd_lse.launches,
                  A.attention_fwd_fp32_fma.launches)
        o2 = A.flash_attention(q, k, v, n_real)
        o, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
        co, cl = A.attention_fwd_fp32_fma(q, k, v, n_real, with_lse=True)
        ro, rl = A.attention_reference_lse(q, k, v, n_real)
        torch.cuda.synchronize()
        grew = tuple(f.launches - c for f, c in zip(
            (A.flash_attention, A.flash_attention_fwd_lse,
             A.attention_fwd_fp32_fma), before))
        check(grew == (1, 1, 1), f"fp32 forward counters {grew}")
        check(torch.equal(o2, o), f"fp32 K2 and K3a differ at ({b}, {n})")
        e = (max_err(o, ro), max_err(lse, rl), max_err(co, ro),
             max_err(cl, rl))
        check(e[0] <= tol and e[2] <= tol, f"fp32 K2/K3a ({b}, {n}) {e}")
        check(e[1] <= LSE_TOL and e[3] <= LSE_TOL, f"fp32 lse ({b}, {n}) {e}")
        err["fwd"], err["lse"] = max(err["fwd"], e[0]), max(err["lse"], e[1])
        err["fwd_control"] = max(err["fwd_control"], e[2])
        print(f"phase 34 fp32 K2/K3a tf32 ({b}, {n}, 12, 64) n_real {n_real}: "
              f"max_abs_err o {e[0]:.3e} <= {tol}, lse {e[1]:.3e} <= "
              f"{LSE_TOL}; K2 = K3a bit for bit; the FMA control o "
              f"{e[2]:.3e}, lse {e[3]:.3e}", flush=True)
        del q, k, v, o2, o, lse, co, cl, ro, rl
        torch.cuda.empty_cache()
    for b, n, n_real in TF_BWD_SHAPES:
        q, k, v, do = torch.randn((b, n, 4, 12, 64), generator=gen,
                                  device=dev).unbind(2)
        o, lse = A.attention_reference_lse(q, k, v, n_real)
        before = (A.attention_bwd.launches, A.attention_bwd_fp32_fma.launches)
        got = A.attention_bwd(q, k, v, o, lse, do, n_real)
        again = A.attention_bwd(q, k, v, o, lse, do, n_real)
        ctrl = A.attention_bwd_fp32_fma(q, k, v, o, lse, do, n_real)
        ref = A.attention_bwd_reference(q, k, v, o, lse, do, n_real)
        torch.cuda.synchronize()
        grew = (A.attention_bwd.launches - before[0],
                A.attention_bwd_fp32_fma.launches - before[1])
        check(grew == (2, 1), f"fp32 backward counters {grew}")
        e = [max_err(a, r) for a, r in zip(got, ref)]
        ec = max(max_err(a, r) for a, r in zip(ctrl, ref))
        same = all(torch.equal(a, z) for a, z in zip(got, again))
        zero = n_real is None or not (got[1][:, n_real:].any()
                                      or got[2][:, n_real:].any())
        check(max(e) <= tol and ec <= tol, f"fp32 K3b ({b}, {n}) {e} {ec}")
        check(same, f"fp32 K3b ({b}, {n}): two launches differ")
        check(zero, f"fp32 K3b ({b}, {n}): masked dk/dv not zero")
        err["bwd"] = max(err["bwd"], max(e))
        err["bwd_control"] = max(err["bwd_control"], ec)
        print(f"phase 34 fp32 K3b/K4 tf32 ({b}, {n}, 12, 64) n_real {n_real}: "
              f"max_abs_err dq {e[0]:.3e}, dk {e[1]:.3e}, dv {e[2]:.3e} <= "
              f"{tol}; two launches bit-equal {same}; masked dk/dv zero "
              f"{zero}; the FMA control {ec:.3e}", flush=True)
        del q, k, v, do, o, lse, got, again, ctrl, ref
        torch.cuda.empty_cache()

    err["shrink"] = _tf32_shrink(dev, gen)
    print("phase 34 systematic shrink against fp64 at (4, 866, 12, 64), "
          "sum(x r) / sum(r r) - 1 of o, dq, dk, dv (the tensor cores' sums "
          "truncate; the backward's delta = rowsum(do o) carries o's into "
          "the gradients): " + "; ".join(
              f"{k_} " + ", ".join(f"{x:.3e}" for x in v_)
              for k_, v_ in err["shrink"].items()), flush=True)

    bad = _tf32_planted_err(*planted)
    check(bad[0] > tol and bad[1] > tol,
          f"the check passes the kernels built with one tf32 product: {bad}")
    print(f"phase 34 planted fault refused: the kernels built with one tf32 "
          f"product (TF_3X false, a process of its own): forward max_abs_err "
          f"{bad[0]:.3e}, backward {bad[1]:.3e} > {tol} at (2, 1000, 12, 64) "
          f"n_real 997", flush=True)
    err["planted"] = bad
    return err


def sdpa_efficient(q, k, v, do=None, lse=False):
    """One call of SDPA's efficient-attention backend (the aten op, the one
    that takes fp32) on (B, N, H, D): its forward, with its log-sum-exp when
    ``lse``, or, given ``do``, its backward alone on its own forward's saved
    tensors. The library call that computes K2's, K3a's or K3b's function
    in fp32, which the port never calls."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd = torch.ops.aten._scaled_dot_product_efficient_attention
    if do is None:
        return lambda: fwd(qt, kt, vt, None, lse)
    o, lse_, seed, offset = fwd(qt, kt, vt, None, True)
    dot = do.transpose(1, 2)
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention_backward(
        dot, qt, kt, vt, None, o, lse_, seed, offset, 0.0,
        [True, True, True, False])


# the launches of the tf32 routes: K2 splits k and v into tf32 planes, K3b
# q, do, k and v
TF32_EXPECT = {"K2": {"split": (r"tf_split_kernel", 2),
                      "kernel": (r"attn_fwd_tf32_kernel", 1)},
               "K3b": {"split": (r"tf_split_kernel", 4),
                       "stats": (r"attn_bwd_tf32_stats_kernel", 1),
                       "dkv": (r"attn_bwd_dkv_tf32_kernel", 1),
                       "dq": (r"attn_bwd_dq_tf32_kernel", 1)}}


def phase_tf32(dev, gpu, planted):
    """Phase 34: fp32 K2/K3a and K3b/K4 on tf32 ``wgmma`` and TMA with
    3xTF32 products (``csrc/attn_fwd_tf32.cuh``, ``csrc/attn_bwd_tf32.cuh``,
    the routes of fp32 at head_dim 64) beside their scalar FMA controls,
    plain and SDPA's efficient attention. First ``_tf32_checks``. Then
    CUDA-graph replays of the kernel, the control, plain and SDPA in
    WG_ROUNDS interleaved rounds (each once a round, the order reversed
    every other round) at K2's (32, 1676, 12, 64),
    K3a's and K3b's (32, 866, 12, 64) and K4's (2, 4500, 12, 64) n_real
    4400 (SDPA at (2, 4400): it takes no key mask), every round printed;
    then the default-dtype ``predict_labels`` on one batch of 32 clips of
    30 s (one K2 a block), and the batch-32 30 s fp32 tagging step
    (``get_maest``'s default dtype) and the 30 s recipe step in fp32 (B32,
    N 866) with each route in turn, the controls reached through the
    private hook ``ops.attention._F32_CONTROL``, CUDA events over 2 steps a
    round after one, the launch counters checked on each; the launches of
    the tf32 route (prep passes, kernels) by device time at K2's and K3b's
    shapes. Returns the errors, the medians, the launches and the parts."""
    from maest_tpu_torch import get_maest
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.probes.attn_profile import graph_ms
    from maest_tpu_torch.serve import BucketPrograms

    out = {"err": _tf32_checks(dev, planted), "ms": {}, "launches": {},
           "parts": {}}
    gen = torch.Generator(device=dev).manual_seed(35)
    for name, b, n, nr in (("K2", BATCH, 1676, None), ("K3a", BATCH, 866, None),
                           ("K3b", BATCH, 866, None), ("K4", 2, 4500, 4400)):
        q, k, v, do = torch.randn((b, n, 4, 12, 64), generator=gen,
                                  device=dev).unbind(2)
        if name in ("K3b", "K4"):
            o, lse = A.flash_attention_fwd_lse(q, k, v, nr)
            real = slice(0, nr or n)  # SDPA's takes no key mask: N = n_real
            fns = {"tf32": lambda: A.attention_bwd(q, k, v, o, lse, do, nr),
                   "control": lambda: A.attention_bwd_fp32_fma(
                       q, k, v, o, lse, do, nr),
                   "plain": lambda: A.attention_bwd_reference(
                       q, k, v, o, lse, do, nr),
                   "sdpa": sdpa_efficient(*(t[:, real] for t in (q, k, v)),
                                          do[:, real])}
        else:
            lse_ = name == "K3a"
            fns = {"tf32": (lambda: A.flash_attention_fwd_lse(q, k, v))
                   if lse_ else (lambda: A.flash_attention(q, k, v)),
                   "control": lambda: A.attention_fwd_fp32_fma(q, k, v, None,
                                                               lse_),
                   "plain": (lambda: A.attention_reference_lse(q, k, v))
                   if lse_ else (lambda: A.attention_reference(q, k, v)),
                   "sdpa": sdpa_efficient(q, k, v, lse=lse_)}
        rows = {key: [] for key in fns}
        for rnd in range(WG_ROUNDS):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for key in order:
                rows[key].append(graph_ms(fns[key], 3, dev, reps=1))
            print(f"phase 34 fp32 {name} ({b}, {n}, 12, 64) n_real {nr} round "
                  f"{rnd + 1} CUDA-graph ms: " + ", ".join(
                      f"{key} {rows[key][-1]:.4f}" for key in fns)
                  + f" [{gpu}]", flush=True)
        med = {key: float(np.median(ms)) for key, ms in rows.items()}
        every = all(t < c for t, c in zip(rows["tf32"], rows["control"]))
        print(f"phase 34 fp32 {name} ({b}, {n}, 12, 64) n_real {nr} medians: "
              f"tf32 "
              f"{med['tf32']:.4f} ms, control {med['control']:.4f} ms "
              f"({med['control'] / med['tf32']:.2f}x), plain "
              f"{med['plain']:.4f} ms, SDPA (efficient attention"
              f"{', its backward alone' if name in ('K3b', 'K4') else ''}"
              f"{' at N 4400' if nr else ''}) "
              f"{med['sdpa']:.4f} ms; the tf32 kernel beat the control in "
              f"every round: {every}; fastest of all: "
              f"{min(med, key=med.get)} [{gpu}]", flush=True)
        check(every, f"fp32 {name}: the tf32 kernel lost a round to the "
              f"control {rows}")
        out["ms"][name] = med
        if name in ("K2", "K3b"):
            out["parts"][name] = _kernel_ms(fns["tf32"], TF32_EXPECT[name])
            print(f"phase 34 fp32 {name} the tf32 route's launches by device "
                  f"time (torch.profiler): {_fmt_ms(out['parts'][name])} "
                  f"[{gpu}]", flush=True)
        del q, k, v, do, fns
        torch.cuda.empty_cache()

    # the fp32 steps with each route, in turn
    counts = (A.flash_attention, A.flash_attention_fwd_lse, A.attention_bwd,
              A.attention_fwd_fp32_fma, A.attention_bwd_fp32_fma)
    model = get_maest(arch=ARCH, pretrained=False, device=dev)
    prog = BucketPrograms(model, buckets=(BATCH,), fused_wave=True)
    waves = torch.from_numpy(np.random.default_rng(34).standard_normal(
        (BATCH, CLIP)).astype(np.float32) * 0.1).to(dev)
    _, mcfg, net, state, step, data = _recipe(dev, RECIPE, BATCH, 34,
                                              dtype=torch.float32)
    gen_step = torch.Generator().manual_seed(34)
    depth = model.net.cfg.depth
    # the default-dtype API: one batch of 30 s clips, K2 once a block
    for f in counts:
        f.launches = 0
    acts, _ = model.predict_labels(waves)
    got = tuple(f.launches for f in counts)
    check(got == (depth, 0, 0, 0, 0) and bool(np.isfinite(acts).all()),
          f"fp32 predict_labels: launches {got}")
    print(f"phase 34 fp32 predict_labels (get_maest's default dtype) on "
          f"{BATCH} clips of 30 s, one batch: launches (K2, K3a, K3b, fwd "
          f"control, bwd control) {got}, activations {acts.shape} finite",
          flush=True)
    steps = {"tagging": lambda: prog._activations(waves),
             "recipe": lambda: step(state, data, gen_step)}
    want = {("tagging", False): (3 * depth, 0, 0, 0, 0),
            ("tagging", True): (0, 0, 0, 3 * depth, 0),
            ("recipe", False): (0, 3 * mcfg.depth, 3 * mcfg.depth, 0, 0),
            ("recipe", True): (0, 0, 0, 3 * mcfg.depth, 3 * mcfg.depth)}
    step_ms = {(s_, r_): [] for s_ in steps for r_ in ("tf32", "control")}
    try:
        for rnd in range(WG_ROUNDS):
            for what, fn in steps.items():
                order = ("tf32", "control") if rnd % 2 == 0 else (
                    "control", "tf32")
                for route in order:
                    A._F32_CONTROL = route == "control"
                    for f in counts:
                        f.launches = 0
                    with torch.inference_mode(what == "tagging"):
                        step_ms[(what, route)].append(cuda_ms(fn, 2))
                    got = tuple(f.launches for f in counts)
                    check(got == want[(what, A._F32_CONTROL)],
                          f"fp32 {what} with the {route}: launches {got}")
                    out["launches"][(what, route)] = got
            print(f"phase 34 fp32 steps round {rnd + 1} (CUDA events, ms a "
                  f"step): " + ", ".join(f"{w} with the {r} {ms[-1]:.3f}"
                                         for (w, r), ms in step_ms.items())
                  + f" [{gpu}]", flush=True)
    finally:
        A._F32_CONTROL = False
    for key, ms in step_ms.items():
        out["ms"][key] = float(np.median(ms))
    won = {w: sum(a < c for a, c in zip(step_ms[(w, "tf32")],
                                        step_ms[(w, "control")]))
           for w in steps}
    tag = {r: out["ms"][("tagging", r)] for r in ("tf32", "control")}
    rec = {r: out["ms"][("recipe", r)] for r in ("tf32", "control")}
    print(f"phase 34 fp32 steps, medians of {WG_ROUNDS} rounds: batch-{BATCH} "
          f"30 s fp32 tagging {tag['tf32']:.3f} ms with the tf32 kernels ("
          f"{BATCH * 30 / (tag['tf32'] / 1e3):.1f} audio-s/s) against "
          f"{tag['control']:.3f} with the controls; {RECIPE} B{BATCH} in fp32 "
          f"{rec['tf32']:.3f} ms against {rec['control']:.3f}; rounds won by "
          f"the tf32 kernels {won}; launches a round (K2, K3a, K3b, fwd "
          f"control, bwd control) {out['launches']} [{gpu}]", flush=True)
    del model, prog, waves, net, state, step, data
    torch.cuda.empty_cache()
    return out


def phase_yardsticks(dev, gpu):
    """Phase 33: the numbers the kernels table lacked. K2, K3a and K3b in
    fp32 (K2 at (32, 1676, 12, 64), K3a and K3b at (32, 866)): kernel,
    plain and SDPA's time (its efficient-attention backend, the one that
    takes fp32: the forward, the forward with its log-sum-exp, the
    backward through autograd with the forward subtracted); SDPA's forward
    with its log-sum-exp beside K3a at head_dim 128, 256 (flash backend)
    and 384 (efficient attention), on K3a's shapes of phase 27 (32, 866, 6
    | 3 | 2, D); K4's runtime-width instance at (1, 4500, 2, 320) n_real
    4400 against plain, timed beside SDPA's efficient-attention backward on
    the 4400 real keys; K5/K6 at head_dim 256 (32, 1676, 3, 256) in
    every mode, timed (the wrappers, their PyTorch pass included). CUDA
    events, medians of three runs. Returns the times."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from maest_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(33)
    out = {}
    for key, b, n, in (("K2", BATCH, 1676), ("K3a", BATCH, 866),
                       ("K3b", BATCH, 866)):
        x = torch.randn((b, n, 4, 12, 64), generator=gen, device=dev)
        q, k, v, do = x.unbind(2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            if key == "K2":
                fns = (lambda: A.flash_attention(q, k, v),
                       lambda: A.attention_reference(q, k, v),
                       lambda: F.scaled_dot_product_attention(qt, kt, vt))
            elif key == "K3a":
                fns = (lambda: A.flash_attention_fwd_lse(q, k, v),
                       lambda: A.attention_reference_lse(q, k, v),
                       lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                           qt, kt, vt, None, True))
            else:
                o, lse = A.flash_attention_fwd_lse(q, k, v)
                qg, kg, vg = (t.detach().requires_grad_(True)
                              for t in (qt, kt, vt))
                gt = do.transpose(1, 2)
                sdpa_fwd = cuda_ms_median(
                    lambda: F.scaled_dot_product_attention(qg, kg, vg), 5)

                def sdpa_bwd():
                    F.scaled_dot_product_attention(qg, kg, vg).backward(gt)

                fns = (lambda: A.attention_bwd(q, k, v, o, lse, do),
                       lambda: A.attention_bwd_reference(q, k, v, o, lse, do),
                       sdpa_bwd)
            ms = [cuda_ms_median(fns[0], 5), cuda_ms_median(fns[1], 2),
                  cuda_ms_median(fns[2], 5)]
        if key == "K3b":
            ms[2] -= sdpa_fwd
        out[f"{key}_fp32"] = ms
        del x, q, k, v, do, qt, kt, vt
        torch.cuda.empty_cache()
    print("phase 33 fp32 (32, N, 12, 64): " + "; ".join(
        f"{key} kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms, SDPA "
        f"(efficient attention{', backward less forward' if key == 'K3b' else ''}"
        f") {ms[2]:.4f} ms" for key, ms in (
            (k_.split('_')[0], out[k_]) for k_ in ("K2_fp32", "K3a_fp32",
                                                  "K3b_fp32")))
          + f" [{gpu}]", flush=True)

    for heads, d in ((6, 128), (3, 256), (2, 384)):
        x = torch.randn((BATCH, 866, 3, heads, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        qt, kt, vt = (x[:, :, i].transpose(1, 2) for i in range(3))
        if d <= 256:
            fn = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt)
        else:
            fn = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, None, True)
        out[f"K3a_sdpa_d{d}"] = cuda_ms_median(fn, 5)
        del x, qt, kt, vt
    print("phase 33 SDPA with its log-sum-exp beside K3a (bf16, (32, 866, H, "
          "D)): " + ", ".join(f"D = {d} {out[f'K3a_sdpa_d{d}']:.4f} ms" for d in
                             (128, 256, 384))
          + f" (flash backend to 256, efficient attention at 384) [{gpu}]",
          flush=True)

    x = torch.randn((1, 4500, 4, 2, 320), generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v, do = x.unbind(2)
    o, lse = A.flash_attention_fwd_lse(q, k, v, 4400)
    got = A.attention_bwd(q, k, v, o, lse, do, 4400)
    ref = A.attention_bwd_reference(q, k, v, o, lse, do, 4400)
    err = max(max_err(a, r) for a, r in zip(got, ref))
    check(err <= ATTN_TOL["bfloat16"], f"K4 _dn at (1, 4500, 2, 320): {err}")
    out["K4_dn"] = (cuda_ms_median(
        lambda: A.attention_bwd(q, k, v, o, lse, do, 4400), 5),
        cuda_ms_median(lambda: A.attention_bwd_reference(
            q, k, v, o, lse, do, 4400), 2))
    # its library yardstick, timed only: SDPA's efficient-attention backward
    # alone (the aten op, on its own forward's saved tensors) on the first
    # 4400 rows, the real keys (SDPA takes no key mask)
    real = slice(0, 4400)
    out["K4_dn_sdpa"] = cuda_ms_median(sdpa_efficient(
        *(t[:, real] for t in (q, k, v)), do=do[:, real]), 5)
    print(f"phase 33 K4's _dn instance at (1, 4500, 2, 320) n_real 4400: "
          f"max_abs_err vs plain {err:.3e} <= {ATTN_TOL['bfloat16']}, kernel "
          f"{out['K4_dn'][0]:.4f} ms, plain {out['K4_dn'][1]:.4f} ms, SDPA's "
          f"efficient-attention backward alone at (1, 4400, 2, 320) "
          f"{out['K4_dn_sdpa']:.4f} ms (events) [{gpu}]", flush=True)
    del x, q, k, v, do, o, lse, got, ref

    x = torch.randn((BATCH, 1676, 3, 3, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = x.unbind(2)
    for mode in ("qk8", "qk8pv8", "fp8", "fp8pv8"):
        fwd = A.attention_fwd_int8 if mode.startswith("qk8") else \
            A.attention_fwd_fp8
        pv8 = mode.endswith("pv8")
        out[f"{mode}_d256"] = cuda_ms_median(
            lambda: fwd(q, k, v, None, pv8), 5)
    print("phase 33 K5/K6 at (32, 1676, 3, 256) (the wrappers): " + ", ".join(
        f"{mode} {out[f'{mode}_d256']:.4f} ms" for mode in
        ("qk8", "qk8pv8", "fp8", "fp8pv8")) + f" [{gpu}]", flush=True)
    del x, q, k, v
    torch.cuda.empty_cache()
    return out


# phase 35's planted faults, each in a process of its own: the wgmma
# 8-bit forward's key mask dropped (the keys from n_real on, and the zero
# codes of the padded keys past N, take softmax mass), and the pass's int8
# codes rounded half away from zero in place of half to even
PLANT_Q8W_NO_MASK = (
    "            if (base + nt * 8 + 2 * t + (e & 1) >= n_real) s[nt][e] = NEG_INF;",
    "            (void)e;")
PLANT_Q8W_HALF_AWAY = (
    "  return static_cast<uint32_t>(__float2int_rn(__fdiv_rn(x, s))) & 0xffu;",
    "  return static_cast<uint32_t>(static_cast<int>(roundf(__fdiv_rn(x, s)))) "
    "& 0xffu;")
# phase 35's checked shapes: the tagging step's, the 30 s recipe's with
# lse (the qk8 training forward), and a short one with n_real < N
Q8W_SHAPES = ((BATCH, 1676, None, False), (BATCH, 866, None, True),
              (2, 300, 290, True))


def build_planted_q8w_no_mask() -> tuple[Path, float]:
    """``csrc/attention_fwd_q8.cu`` with the wgmma 8-bit forward's key mask
    dropped (phase 35 shows its check refusing the kernel so built)."""
    return _build_planted("q8w_no_mask", "attention_fwd_q8",
                          "attn_fwd_q8_wgmma.cuh", PLANT_Q8W_NO_MASK)


def build_planted_q8w_half_away() -> tuple[Path, float]:
    """``csrc/attention_fwd_q8.cu`` with the pass's int8 codes rounded half
    away from zero (phase 35 shows its check refusing the pass so built)."""
    return _build_planted("q8w_half_away", "attention_fwd_q8",
                          "attn_fwd_q8_wgmma.cuh", PLANT_Q8W_HALF_AWAY)


def _q8_wrap(mode):
    from maest_tpu_torch.ops import attention as A

    return A.attention_fwd_int8 if mode.startswith("qk8") else \
        A.attention_fwd_fp8


def _q8_same(got: dict, ref: dict) -> dict:
    """{output of the pass: its elements that differ from the plain
    version's} (NaN equal to NaN; None where neither has the output)."""
    out = {}
    for key, r in ref.items():
        g = got[key]
        if r is None or g is None:
            out[key] = None if r is None and g is None else -1
            continue
        if r.dtype == torch.uint8 and key in ("q8", "k8", "v8t"):
            out[key] = int((g != r).sum())
        else:
            diff = (g != r) & ~(torch.isnan(g) & torch.isnan(r))
            out[key] = int(diff.sum())
    return out


def _q8w_tie_inputs(dev):
    """(2, 300, 3, 12, 64) bf16 q/k/v of multiples of 0.5 in [-63.5, 63.5]
    with 127 in column 0 of every q and k row and in row 0 of v: every
    int8 scale is 127 / 127 = 1 exactly, so x / s = x and every odd
    multiple of 0.5 is a tie of the int8 rounding."""
    gen = torch.Generator(device=dev).manual_seed(35)
    x = (torch.randint(-127, 128, (2, 300, 3, 12, 64), generator=gen,
                       device=dev) * 0.5).to(torch.bfloat16)
    x[:, :, :2, :, 0] = 127.0
    x[:, 0, 2] = 127.0
    return x


def _q8w_planted(lib: Path, what: str) -> dict:
    """Run a planted copy of the 8-bit forward library ``lib`` in a process
    of its own (as ``_planted_err``). ``what`` "mask": max|o - plain| /
    the Q8_ULPS bound of each mode at (2, 300, 12, 64) n_real 290 (normal
    draws); "ties": each int8 mode's codes that differ from the pass's
    plain version on ``_q8w_tie_inputs``, and max|o - plain| / bound."""
    code = (
        "import ctypes, json, sys, numpy as np, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as C\n"
        "from maest_tpu_torch.ops import _build, attention as A\n"
        f"_build._libs['attention_fwd_q8'] = ctypes.CDLL({str(lib)!r})\n"
        f"print(json.dumps(C._q8w_gaps({what!r})))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the planted fault's process failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _q8w_gaps(what: str) -> dict:
    """``_q8w_planted``'s measurement in this process, on whatever library
    ``attention_fwd_q8`` it has loaded: {mode: [differing codes, max|o -
    plain| / bound]}."""
    from maest_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    if what == "ties":
        x, n_real, modes = _q8w_tie_inputs(dev), None, ("qk8", "qk8pv8")
    else:
        gen = torch.Generator(device=dev).manual_seed(36)
        x = torch.randn((2, 300, 3, 12, 64), generator=gen, device=dev).to(
            torch.bfloat16)
        n_real, modes = 290, Q8_MODES
    q, k, v = x.unbind(2)
    out = {}
    for mode in modes:
        b8, sc = A.launch_q8_pass(q, k, v, mode)
        diff = _q8_same(A.q8_pass_views(b8, sc, 2, 300, 12, mode),
                        A.q8_pass_reference(q, k, v, mode))
        o, _ = _q8_wrap(mode)(q, k, v, n_real, mode.endswith("pv8"))
        ro, _ = A.attention_q8_reference(q, k, v, n_real, mode)
        tol = Q8_ULPS * bf16_ulp(ro.float().abs().max().item())
        out[mode] = [sum(n for n in diff.values() if n), max_err(o, ro) / tol]
    return out


def _q8_shrink(o, ref) -> float:
    """The route's systematic scale against its plain version: sum(o r) /
    sum(r r) - 1 in float64 (negative where the sums shrink o)."""
    o, ref = o.double().flatten(), ref.double().flatten()
    return (o @ ref / (ref @ ref) - 1.0).item()


def phase_q8_wgmma(dev, gpu, sd, planted):
    """Phase 35: K5/K6 on wgmma and TMA (``csrc/attn_fwd_q8_wgmma.cuh``,
    the route of the 8-bit modes in bf16 at head_dim 64, behind its CUDA
    quantisation pass). At Q8W_SHAPES, in every mode: the pass (entry
    ``maest_attn_fwd_q8w_pass``) equal to its plain version
    (``q8_pass_reference``: codes, scales, the transposed v8 in seq_pos
    order), the route with and without lse within Q8_ULPS bf16 ulps of
    max|o| of its plain version at the route's 128-key tile (lse within
    LSE_TOL) and farther than that from every other mode's, its mma.sync
    control (``attention_fwd_q8_mma``) within the same bound of the plain
    version at its 64-key tile, each counter checked, and o's systematic
    scale against plain; the e4m3 overflow (450 and 464 -> 448, 466 and
    past -> NaN) in the pass and the output. The kernel built with its key
    mask dropped, and the pass built rounding half away from zero, refused
    (each in a process of its own). Then at (32, 1676) CUDA-graph replays
    of the route, the control and K2 in WG_ROUNDS interleaved rounds,
    every round printed, the pass and the kernel alone by torch.profiler
    and the plain version's time; and phase 14's tagging step (B32, 30 s,
    bf16) in every mode with the route and with the control in turn
    (private hook ``ops.attention._Q8_CONTROL``), CUDA events over 3 steps
    a round after one, the counters checked on each. Returns the errors,
    the medians and the launches."""
    from maest_tpu_torch import get_maest
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.probes.attn_profile import graph_ms
    from maest_tpu_torch.serve import BucketPrograms

    rng = np.random.default_rng(35)
    out = {"err": dict.fromkeys(Q8_MODES, 0.0),
           "err_control": dict.fromkeys(Q8_MODES, 0.0), "ms": {},
           "launches": {}}
    for b, n, n_real, lse in Q8W_SHAPES:
        qkv = torch.from_numpy(rng.standard_normal(
            (b, n, 3, 12, 64)).astype(np.float32)).to(dev, torch.bfloat16)
        q, k, v = qkv.unbind(2)
        plain = {m: A.attention_q8_reference(q, k, v, n_real, m)
                 for m in Q8_MODES}
        for mode in Q8_MODES:
            wrap, pv8 = _q8_wrap(mode), mode.endswith("pv8")
            b8, sc = A.launch_q8_pass(q, k, v, mode)
            diff = _q8_same(A.q8_pass_views(b8, sc, b, n, 12, mode),
                            A.q8_pass_reference(q, k, v, mode))
            del b8, sc
            before = (wrap.launches, A.attention_fwd_q8_mma.launches)
            o, none = wrap(q, k, v, n_real, pv8)
            o2, lse_o = wrap(q, k, v, n_real, pv8, with_lse=True)
            co, clse = A.attention_fwd_q8_mma(q, k, v, n_real, mode,
                                              with_lse=True)
            ro, rlse = plain[mode]
            r64, rl64 = A.attention_q8_reference(q, k, v, n_real, mode,
                                                 A.Q8_BLOCK_K)
            torch.cuda.synchronize()
            check((wrap.launches, A.attention_fwd_q8_mma.launches) == (
                before[0] + 2, before[1] + 1) and none is None,
                f"{mode} route and control counters")
            check(not any(diff.values()), f"{mode} ({b}, {n}) pass vs plain "
                  f"{diff}")
            tol = Q8_ULPS * bf16_ulp(ro.float().abs().max().item())
            e = max(max_err(o, ro), max_err(o2, ro))
            el = max_err(lse_o, rlse)
            tol64 = Q8_ULPS * bf16_ulp(r64.float().abs().max().item())
            ec, ecl = max_err(co, r64), max_err(clse, rl64)
            other, apart = min(((m, max_err(o, plain[m][0]))
                                for m in Q8_MODES if m != mode),
                               key=lambda x: x[1])
            check(e <= tol and el <= LSE_TOL, f"wgmma {mode} ({b}, {n}) err "
                  f"o {e} (bound {tol}) lse {el}")
            check(apart > tol, f"wgmma {mode} ({b}, {n}) within {apart} of "
                  f"{other}'s plain version: the bound {tol} cannot tell "
                  "them apart")
            check(ec <= tol64 and ecl <= LSE_TOL, f"control {mode} ({b}, {n}) "
                  f"err o {ec} (bound {tol64}) lse {ecl}")
            out["err"][mode] = max(out["err"][mode], e, el)
            out["err_control"][mode] = max(out["err_control"][mode], ec, ecl)
            print(f"phase 35 wgmma {mode} ({b}, {n}, 12, 64) n_real {n_real}"
                  f"{' (the training forward with lse)' if lse else ''}: "
                  f"the pass equal to its plain version (codes, scales, "
                  f"v8^T in seq_pos order); o vs plain at the 128-key tile "
                  f"{e:.3e} <= {tol:.3e} ({Q8_ULPS} bf16 ulps of max|o|), "
                  f"lse {el:.3e} <= {LSE_TOL}; vs the nearest other mode's "
                  f"plain version ({other}) {apart:.3e}; o's scale vs plain "
                  f"{_q8_shrink(o, ro):+.2e}; the control vs plain at the "
                  f"64-key tile o {ec:.3e} <= {tol64:.3e}, lse {ecl:.3e}",
                  flush=True)
            del o, o2, lse_o, co, clse, r64, rl64
        del qkv, q, k, v, plain
        torch.cuda.empty_cache()

    # e4m3 overflow: past 464 NaN, (448, 464] to 448, as the JAX cast
    qkv = torch.from_numpy(rng.standard_normal((1, 130, 3, 2, 64)).astype(
        np.float32)).to(dev, torch.bfloat16)
    qkv[0, 5, 0, 0, 3] = 470.0    # q: row 5 of head 0
    qkv[0, 9, 1, 1, 7] = -600.0   # k: key 9 of head 1, every row of it
    qkv[0, 20, 0, 1, 2] = 450.0   # 448 in q, k and v
    qkv[0, 21, 1, 0, 2] = 464.0
    qkv[0, 22, 2, 0, 2] = -464.0
    qkv[0, 23, 2, 1, 4] = 466.0   # v: NaN in column 4 of head 1
    q, k, v = qkv.unbind(2)
    for mode in ("fp8", "fp8pv8"):
        b8, sc = A.launch_q8_pass(q, k, v, mode)
        got = A.q8_pass_views(b8, sc, 1, 130, 2, mode)
        diff = _q8_same(got, A.q8_pass_reference(q, k, v, mode))
        q8, k8 = got["q8"].float(), got["k8"].float()  # e4m3 values
        check(not any(diff.values()) and q8[1, 20, 2].item() == 448.0
              and k8[0, 21, 2].item() == 448.0 and bool(torch.isnan(
                  q8[0, 5, 3])) and bool(torch.isnan(k8[1, 9, 7])),
              f"{mode} overflow pass {diff}")
        o, _ = A.attention_fwd_fp8(q, k, v, None, mode == "fp8pv8")
        ro, _ = A.attention_q8_reference(q, k, v, None, mode)
        nan = torch.isnan(o)
        check(torch.equal(nan, torch.isnan(ro)) and bool(nan[0, 5, 0].all())
              and bool(nan[:, :, 1].all()) and not bool(nan[0, 6, 0].any()),
              f"wgmma {mode} overflow NaN pattern")
        tol = Q8_ULPS * bf16_ulp(ro[~nan].float().abs().max().item())
        check(max_err(o[~nan], ro[~nan]) <= tol, f"wgmma {mode} overflow err")
    print("phase 35 wgmma K6 e4m3 overflow: the pass writes 448 for 450 and "
          "464 and NaN past 464 (470, -600, 466), as the plain version (the "
          "JAX package's cast) does; q 470 and k -600 give NaN in the rows "
          f"they reach, and values within {Q8_ULPS} bf16 ulps elsewhere",
          flush=True)
    del qkv, q, k, v

    mask = _q8w_planted(planted["no_mask"], "mask")
    check(all(r > 1 for _, r in mask.values()), f"planted no mask {mask}")
    ties = _q8w_planted(planted["half_away"], "ties")
    good = _q8w_gaps("ties")
    check(all(c > 0 for c, _ in ties.values()) and not any(
        c for c, _ in good.values()), f"planted half-away {ties}, good {good}")
    print("phase 35 planted faults, each in a process of its own: the kernel "
          "built with its key mask dropped, at (2, 300, 12, 64) n_real 290, "
          "max|o - plain| in units of the bound " + ", ".join(
              f"{m} {r:.1f}" for m, (_, r) in mask.items())
          + " > 1: refused; the pass built rounding half away from zero, on "
          "inputs whose int8 scales are 1 (ties at every odd multiple of "
          "0.5), codes unequal to the plain version's " + ", ".join(
              f"{m} {c} (o {r:.2f} of the bound)" for m, (c, r) in ties.items())
          + " > 0: refused (the route's own pass: " + ", ".join(
              f"{m} {c}" for m, (c, _) in good.items()) + ")", flush=True)

    qkv = torch.from_numpy(rng.standard_normal(
        (BATCH, 1676, 3, 12, 64)).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    for mode in Q8_MODES:
        wrap, pv8 = _q8_wrap(mode), mode.endswith("pv8")
        fns = {"wgmma": lambda: wrap(q, k, v, None, pv8),
               "control": lambda: A.attention_fwd_q8_mma(q, k, v, None, mode),
               "K2": lambda: A.flash_attention(q, k, v)}
        rows = {key: [] for key in fns}
        for rnd in range(WG_ROUNDS):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for key in order:
                rows[key].append(graph_ms(fns[key], 10, dev, reps=1))
            print(f"phase 35 {mode} ({BATCH}, 1676, 12, 64) round {rnd + 1} "
                  "CUDA-graph ms: " + ", ".join(
                      f"{key} {rows[key][-1]:.4f}" for key in fns)
                  + f" [{gpu}]", flush=True)
        med = {key: float(np.median(ms)) for key, ms in rows.items()}
        every = all(w < c for w, c in zip(rows["wgmma"], rows["control"]))
        split = _kernel_ms(fns["wgmma"], _q8w_expect(mode))
        med["plain"] = cuda_ms(lambda: A.attention_q8_reference(
            q, k, v, None, mode), 2)
        out["ms"][mode] = med
        out["split"] = {**out.get("split", {}), mode: split}
        print(f"phase 35 {mode} ({BATCH}, 1676, 12, 64) medians: wgmma "
              f"{med['wgmma']:.4f} ms, control {med['control']:.4f} ms "
              f"({med['control'] / med['wgmma']:.2f}x), K2 (bf16) "
              f"{med['K2']:.4f} ms, plain (CUDA events) {med['plain']:.4f} "
              f"ms; the route beat the control in every round: {every}; the "
              f"route's launches by device time (torch.profiler): "
              f"{_fmt_ms(split)} [{gpu}]", flush=True)
        check(every, f"the wgmma {mode} beats its control in every round")
    del qkv, q, k, v, fns
    torch.cuda.empty_cache()

    rng = np.random.default_rng(6)
    waves = torch.from_numpy(rng.standard_normal((BATCH, CLIP)).astype(
        np.float32) * 0.1).to(dev)
    counts = (A.attention_fwd_int8, A.attention_fwd_fp8,
              A.attention_fwd_q8_mma, A.flash_attention)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "random-vitb.pt")
        torch.save(sd, ckpt)
        for mode in Q8_MODES:
            model = get_maest(ARCH, pretrained=False, checkpoint=ckpt,
                              device=dev, dtype=torch.bfloat16,
                              attention_quant=mode)
            prog = BucketPrograms(model, buckets=(BATCH,), fused_wave=True)
            steps = {"wgmma": [], "control": []}
            try:
                for rnd in range(WG_ROUNDS):
                    order = ("wgmma", "control") if rnd % 2 == 0 else (
                        "control", "wgmma")
                    for route in order:
                        A._Q8_CONTROL = route == "control"
                        for f in counts:
                            f.launches = 0
                        with torch.inference_mode():
                            steps[route].append(cuda_ms(
                                lambda: prog._activations(waves), 3))
                        got = tuple(f.launches for f in counts)
                        per = 4 * 12  # 4 steps of 12 layers
                        want = (0, 0, per, 0) if A._Q8_CONTROL else (
                            (per, 0, 0, 0) if mode.startswith("qk8")
                            else (0, per, 0, 0))
                        check(got == want, f"{mode} tagging with the {route}:"
                              f" launches {got}")
                        out["launches"][(mode, route)] = per // 4
            finally:
                A._Q8_CONTROL = False
            med = {r: float(np.median(ms)) for r, ms in steps.items()}
            out["ms"][("tagging", mode)] = med
            won = sum(a < c for a, c in zip(steps["wgmma"], steps["control"]))
            print(f"phase 35 tagging {mode}: get_maest(attention_quant="
                  f"{mode!r}) bf16, batch-{BATCH} step (CUDA events, 3 steps "
                  f"a round) medians of {WG_ROUNDS} rounds: "
                  f"{med['wgmma']:.3f} ms with the wgmma route, "
                  f"{med['control']:.3f} with the control; rounds won by the "
                  f"route {won} of {WG_ROUNDS}; rounds "
                  + ", ".join(f"{a:.3f}/{c:.3f}" for a, c in zip(
                      steps["wgmma"], steps["control"]))
                  + f"; launches a step 12 of the mode's entry [{gpu}]",
                  flush=True)
            del model, prog
            torch.cuda.empty_cache()
    return out


# phase 36's planted fault: one twiddle of the FFT kernel's first pass,
# W_256^(7 n2), with the sign of its imaginary part flipped
PLANT_MEL_TWIDDLE = (
    "    t1[k1 - 1] = tw[(2 * lane * k1) & 511];  // W_256^(n2 k1), n2 = lane",
    "    t1[k1 - 1] = make_float2(tw[(2 * lane * k1) & 511].x, (k1 == 7 ? "
    "-1.f : 1.f) * tw[(2 * lane * k1) & 511].y);")
# K1's frames: 32 clips of 30 s
MEL_FRAMES = BATCH * (1 + CLIP // 256)


def mel_fft_ops(frames: int, nnz: int = 502, n_mels: int = 96) -> int:
    """fp32 operations of the FFT kernel's route a batch: the window (512
    a frame); three passes of the 256-point FFT, 32 8-point DFTs (56
    each: 16 for the radix-2 step, 8 for W_8 and W_8^3, two 4-point DFTs
    of 16) and 7 x 32 twiddle products (6 each) twice, and 64 4-point DFTs;
    the split step (128 pairs of bins, 24 each: E, O, W O, the two bins
    and their powers); the band sums (2 a weight); log10, scale and the
    z-norm (5 a band)."""
    fft = 2 * (32 * 56 + 7 * 32 * 6) + 64 * 16
    return frames * (512 + fft + 128 * 24 + 2 * nnz + 5 * n_mels)


def mel_dft_ops(frames: int, n_mels: int = 96) -> int:
    """The operations of the DFT taken as a product, K1's route before the
    FFT (and the TPU kernel's): the window (512 a frame), two 512 x 257
    products (2 each a multiply-add), the power, the dense 257 x 96 mel
    product, the log."""
    return frames * (512 + 4 * 512 * 257 + 3 * 257 + 2 * 257 * n_mels
                     + n_mels)


def build_planted_mel_twiddle() -> tuple[Path, float]:
    """``csrc/mel_kernel.cu`` with one twiddle's sign flipped (phase 36
    shows its check refusing the kernel so built)."""
    return _build_planted("mel_twiddle", "mel_kernel", "mel_kernel.cu",
                          PLANT_MEL_TWIDDLE)


def _mel_frames(dev, seed: int = 36) -> torch.Tensor:
    """(MEL_FRAMES, 512) frames of 32 clips of 30 s of N(0, 0.1^2) noise."""
    from maest_tpu_torch.dsp.mel import frame_waveforms

    waves = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (BATCH, CLIP)).astype(np.float32) * 0.1).to(dev)
    return frame_waveforms(waves).reshape(-1, 512).contiguous()


def _mel_gap() -> float:
    """max|K1 - plain| on ``_mel_frames``, with whatever ``mel_kernel``
    library this process has loaded."""
    from maest_tpu_torch.ops import mel_kernel as M

    frames = _mel_frames(torch.device("cuda"))
    return max_err(M.fused_logmel_from_frames(frames),
                   M.fused_logmel_from_frames_reference(frames))


def _mel_planted_err(lib: Path) -> float:
    """``_mel_gap`` of the library ``lib`` in a process of its own (as
    ``_planted_err``)."""
    code = (
        "import ctypes, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as C\n"
        "from maest_tpu_torch.ops import _build\n"
        f"_build._libs['mel_kernel'] = ctypes.CDLL({str(lib)!r})\n"
        "print(json.dumps(C._mel_gap()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the planted fault's process failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    return float(json.loads(proc.stdout.strip().splitlines()[-1]))


def _mel_oracle(frames: torch.Tensor) -> np.ndarray:
    """The front-end in float64 numpy on the host: the Hann window, rfft,
    power, the filterbank, log10 and the z-norm."""
    from maest_tpu_torch.dsp.filterbank import hann_window, mel_filterbank
    from maest_tpu_torch.dsp.mel import NORM_MEAN, NORM_STD

    x = frames.double().cpu().numpy() * hann_window(512).astype(np.float64)
    power = np.abs(np.fft.rfft(x, axis=1)) ** 2
    mel = power @ mel_filterbank(257, 96, SR).astype(np.float64)
    return (np.log10(1.0 + 1e4 * mel) - NORM_MEAN) / (2.0 * NORM_STD)


def stock_frontend(frames: torch.Tensor, window: torch.Tensor,
                   fb: torch.Tensor) -> torch.Tensor:
    """The stock PyTorch front-end on the same frames, a yardstick that the
    port never calls: rfft of the windowed frames, power, the filterbank
    product, log10 and the z-norm."""
    from maest_tpu_torch.dsp.mel import NORM_MEAN, NORM_STD

    spec = torch.fft.rfft(frames * window, dim=1)
    mel = (spec.real.square() + spec.imag.square()) @ fb
    return (torch.log10(1.0 + mel * 1e4) - NORM_MEAN) * (0.5 / NORM_STD)


def phase_mel_fft(dev, gpu, sd, planted_lib):
    """Phase 36: K1 as a 512-point real FFT in shared memory behind TMA
    bulk loads (``csrc/mel_kernel.cu logmel_fft_kernel``, the route of
    ``fused_logmel_from_frames`` on the card). At (60032, 512), 32 clips of
    30 s: the kernel against the plain version (MEL_TOL), the route's plain
    version ``fused_logmel_fft_reference`` and a float64 numpy oracle
    (reported), its counter moving and the FMA control's not; the control
    against plain; ragged 60025 and 1 frames; silence; the inputs the
    kernel refuses; the kernel built with one twiddle's sign flipped
    refused (in a process of its own). Then CUDA-graph replays of the
    kernel, the control, the plain version and the stock PyTorch front-end
    (``stock_frontend``, a yardstick) in WG_ROUNDS interleaved rounds,
    every round printed, medians and spread; torch.profiler's split of the
    kernel and of the framing pass, and of the bf16 tagging step naming K1
    and the framing's reflect pad (``_kernel_ms``); and the bf16 and fp32
    tagging steps (B32, 30 s) with the kernel and with the control (the
    private hook ``ops.mel_kernel._K1_CONTROL``) in interleaved rounds,
    CUDA events over 3 steps a round after one, the counters checked on
    each. Returns the errors, the medians and the launches."""
    from maest_tpu_torch import get_maest
    from maest_tpu_torch.dsp.filterbank import hann_window, mel_filterbank
    from maest_tpu_torch.dsp.mel import frame_waveforms
    from maest_tpu_torch.ops import mel_kernel as M
    from maest_tpu_torch.probes.attn_profile import graph_ms
    from maest_tpu_torch.serve import BucketPrograms

    out = {"ms": {}, "launches": {}}
    frames = _mel_frames(dev)
    check(frames.shape == (MEL_FRAMES, 512), f"K1 frames {frames.shape}")
    before = (M.fused_logmel_from_frames.launches,
              M.fused_logmel_from_frames_fma.launches)
    got = M.fused_logmel_from_frames(frames)
    torch.cuda.synchronize()
    check((M.fused_logmel_from_frames.launches,
           M.fused_logmel_from_frames_fma.launches) == (before[0] + 1,
                                                        before[1]),
          "K1's counter moves and the control's does not")
    ctrl = M.fused_logmel_from_frames_fma(frames)
    torch.cuda.synchronize()
    check(M.fused_logmel_from_frames_fma.launches == before[1] + 1,
          "the control's counter")
    plain = M.fused_logmel_from_frames_reference(frames)
    route = M.fused_logmel_fft_reference(frames)
    oracle = _mel_oracle(frames)
    err = {"plain": max_err(got, plain), "route": max_err(got, route),
           "control": max_err(ctrl, plain)}
    to_oracle = {k: float(np.abs(v.double().cpu().numpy() - oracle).max())
                 for k, v in (("kernel", got), ("control", ctrl),
                              ("plain", plain), ("route", route))}
    check(bool(torch.isfinite(got).all()) and got.shape == (MEL_FRAMES, 96),
          "K1 output")
    check(max(err.values()) <= MEL_TOL, f"K1 errors {err} > {MEL_TOL}")
    check(to_oracle["kernel"] <= MEL_TOL, f"K1 vs fp64 {to_oracle}")
    out["err"], out["err_control"] = max(err["plain"], err["route"]), \
        err["control"]
    print(f"phase 36 K1 FFT kernel at ({MEL_FRAMES}, 512): max_abs_err vs "
          f"plain {err['plain']:.3e}, vs the route's plain version "
          f"{err['route']:.3e} <= {MEL_TOL}; the FMA control vs plain "
          f"{err['control']:.3e}; vs the float64 numpy oracle: " + ", ".join(
              f"{k} {v:.3e}" for k, v in to_oracle.items())
          + "; K1's counter +1, the control's +0 (and +1 for its own call)",
          flush=True)
    del ctrl, route, plain, got
    rag = {}
    for m in (60025, 1):
        f = frames[:m]
        rag[m] = max_err(M.fused_logmel_from_frames(f),
                         M.fused_logmel_from_frames_reference(f))
        check(rag[m] <= MEL_TOL, f"K1 at {m} frames: {rag[m]}")
    t = np.arange(CLIP)
    tones = torch.from_numpy(np.stack([
        np.zeros(CLIP), 0.5 * np.sin(2 * np.pi * 40 * t / 512),
        np.full(CLIP, 0.5), 0.5 * (-1.0) ** t]).astype(np.float32)).to(dev)
    tf = frame_waveforms(tones).reshape(-1, 512).contiguous()
    tone_got = M.fused_logmel_from_frames(tf)
    tone_err = max(max_err(tone_got, M.fused_logmel_from_frames_reference(tf)),
                   float(np.abs(tone_got.double().cpu().numpy()
                                - _mel_oracle(tf)).max()))
    silent = tone_got[:tf.shape[0] // 4]
    check(tone_err <= MEL_TOL and bool((silent == silent[0, 0]).all()),
          f"K1 on silence and tones: {tone_err}")
    refused = []
    for what, bad, kw in (
            ("misaligned", torch.zeros(4 * 512 + 1, device=dev)[1:].view(
                4, 512), {}),
            ("float64", torch.zeros(4, 512, device=dev, dtype=torch.float64),
             {}),
            ("200 bands", torch.zeros(4, 512, device=dev), {"n_mels": 200})):
        try:
            M.fused_logmel_from_frames(bad, **kw)
        except (ValueError, TypeError):
            refused.append(what)
    check(len(refused) == 3, f"K1 refused only {refused}")
    planted = _mel_planted_err(planted_lib)
    check(planted > MEL_TOL, f"the planted twiddle fault passed: {planted}")
    print(f"phase 36 K1 ragged: 60025 frames (a last group of 1) "
          f"{rag[60025]:.3e}, 1 frame {rag[1]:.3e}; silence, a tone on bin "
          f"40, DC and Nyquist (4 clips of 30 s) vs plain and fp64 "
          f"{tone_err:.3e}; refused: {', '.join(refused)}; the kernel built "
          f"with one twiddle's sign flipped (W_256^(7 n2), a process of its "
          f"own) {planted:.3e} > {MEL_TOL}: refused", flush=True)

    window = torch.from_numpy(hann_window(512)).to(dev)
    fb = torch.from_numpy(mel_filterbank(257, 96, SR)).to(dev)
    fns = {"fft": lambda: M.fused_logmel_from_frames(frames),
           "control": lambda: M.fused_logmel_from_frames_fma(frames),
           "plain": lambda: M.fused_logmel_from_frames_reference(frames),
           "stock": lambda: stock_frontend(frames, window, fb)}
    stock_err = max_err(fns["stock"](), fns["plain"]())
    check(stock_err <= MEL_TOL, f"the stock front-end vs plain {stock_err}")
    rows = {key: [] for key in fns}
    for rnd in range(WG_ROUNDS):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for key in order:
            rows[key].append(graph_ms(fns[key], 10, dev, reps=1))
        print(f"phase 36 K1 ({MEL_FRAMES}, 512) round {rnd + 1} CUDA-graph "
              "ms: " + ", ".join(f"{key} {rows[key][-1]:.4f}" for key in fns)
              + f" [{gpu}]", flush=True)
    med = {key: float(np.median(ms)) for key, ms in rows.items()}
    out["ms"]["K1"] = med
    every = all(a < c for a, c in zip(rows["fft"], rows["control"]))
    b_ms, b_by = bound(MEL_FRAMES * (512 + 96) * 4,
                       {"fp32": mel_fft_ops(MEL_FRAMES)})
    # the DFT as a product, the yardstick of the control and of the TPU
    # kernel: in fp32 FMA, and in 3xTF32 on the tensor cores
    dft = {k: bound(MEL_FRAMES * (512 + 96) * 4,
                    {k: mel_dft_ops(MEL_FRAMES)})[0] for k in ("fp32", "tf32x3")}
    kernel_split = _kernel_ms(fns["fft"], {"K1": (r"logmel_fft_kernel", 1)},
                              med["fft"])
    waves = torch.from_numpy(np.random.default_rng(37).standard_normal(
        (BATCH, CLIP)).astype(np.float32) * 0.1).to(dev)
    framing = _kernel_ms(lambda: frame_waveforms(waves),
                         {"reflect pad": (r"reflection_pad1d", 1)})
    print(f"phase 36 K1 ({MEL_FRAMES}, 512) medians of {WG_ROUNDS} rounds "
          "(spread min-max): " + ", ".join(
              f"{key} {med[key]:.4f} ({min(rows[key]):.4f}-"
              f"{max(rows[key]):.4f})" for key in fns)
          + f" ms; the FFT kernel beat the control in every round: {every}; "
          f"bound {b_ms:.4f} ms ({b_by}: {MEL_FRAMES * 608 * 4 / 1e6:.1f} MB "
          f"at 3.35 TB/s; {mel_fft_ops(MEL_FRAMES) / 1e9:.2f} GFLOP fp32), "
          f"{b_ms / med['fft']:.0%} of it (the DFT as a product, "
          f"{mel_dft_ops(MEL_FRAMES) / 1e9:.1f} GFLOP, would be bound at "
          f"{dft['fp32']:.4f} ms in fp32 FMA, {dft['tf32x3']:.4f} in 3xTF32); "
          f"by torch.profiler: {_fmt_ms(kernel_split)}; the "
          f"framing pass (reflect pad, cat) alone {_fmt_ms(framing)}; the "
          f"stock front-end vs plain {stock_err:.3e} [{gpu}]", flush=True)
    check(every, f"the FFT kernel lost a round to its control {rows}")
    del fns, frames

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "random-vitb.pt")
        torch.save(sd, ckpt)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            model = get_maest(ARCH, pretrained=False, checkpoint=ckpt,
                              device=dev, dtype=dtype)
            prog = BucketPrograms(model, buckets=(BATCH,), fused_wave=True)
            steps = {"fft": [], "control": []}
            try:
                for rnd in range(WG_ROUNDS):
                    order = ("fft", "control") if rnd % 2 == 0 else (
                        "control", "fft")
                    for r in order:
                        M._K1_CONTROL = r == "control"
                        M.fused_logmel_from_frames.launches = 0
                        M.fused_logmel_from_frames_fma.launches = 0
                        with torch.inference_mode():
                            steps[r].append(cuda_ms(
                                lambda: prog._activations(waves), 3))
                        got = (M.fused_logmel_from_frames.launches,
                               M.fused_logmel_from_frames_fma.launches)
                        check(got == ((0, 4) if M._K1_CONTROL else (4, 0)),
                              f"{name} tagging with the {r}: launches {got}")
                        out["launches"][(name, r)] = sum(got)
            finally:
                M._K1_CONTROL = False
            med = {r: float(np.median(ms)) for r, ms in steps.items()}
            out["ms"][("tagging", name)] = med
            won = sum(a < c for a, c in zip(steps["fft"], steps["control"]))
            line = (f"phase 36 tagging {name}: batch-{BATCH} 30 s step (CUDA "
                    f"events, 3 steps a round) medians of {WG_ROUNDS} rounds:"
                    f" {med['fft']:.3f} ms with the FFT kernel, "
                    f"{med['control']:.3f} with the FMA control "
                    f"({med['control'] - med['fft']:+.3f}); rounds won by the "
                    f"FFT kernel {won} of {WG_ROUNDS}; rounds " + ", ".join(
                        f"{a:.3f}/{c:.3f}" for a, c in zip(
                            steps["fft"], steps["control"]))
                    + "; one K1 launch a step")
            if dtype == torch.bfloat16:
                with torch.inference_mode():
                    split = _kernel_ms(
                        lambda: prog._activations(waves),
                        {"K1": (r"logmel_fft_kernel", 1),
                         "reflect pad": (r"reflection_pad1d", 1)},
                        med["fft"])
                out["split"] = split
                line += f"; the step by torch.profiler: {_fmt_ms(split)}"
            print(line + f" [{gpu}]", flush=True)
            del model, prog
            torch.cuda.empty_cache()
    return out


# phase 37: the training CLI, ``ex_maest main`` with the 10 s pre-training
# preset at full width on a synthetic corpus
CLI_PRESET = "maest_10s_random_weights_pretrain"
CLI_FILES = 48        # 48 files a batch of 12: 4 train steps an epoch
CLI_RESUME_FILES = 24
# the largest parameter difference between a run resumed from epoch-0 and
# the uninterrupted run, after epoch 1: the same draws (seeded by step),
# the same kernels (K3b sums dq in a fixed order) and the state restored
# bit for bit give 0; the bound leaves room for a reduction of another
# order, far below what epoch 1 moves a parameter (printed beside it; the
# resume runs raise the learning rate so that it moves them by ~1e-4)
CLI_RESUME_TOL = 1e-6
CLI_RESUME_LR = ("module.optimizer.lr=0.001", "module.optimizer.warm_up_len=1")
# the eval's tokens at 10 s: 9 x 61 patches of 625 frames and 2 tokens
CLI_EVAL_N = 551
# the Trainer's step and the bare step timed in alternating rounds
CLI_ROUNDS = 6
CLI_ROUND_STEPS = 3
# phases 37-39 run the preset's width at 4 of its 12 blocks (their
# full-depth readings stay in PERF.md), which keeps the script in its time
CLI_DEPTH = 4


def _cli_corpus(root: Path, n: int, frames, seed: int) -> None:
    """``n`` float16 .mmap files of 96 bands, ``frames(rng)`` frames each,
    and one 400-class multi-hot groundtruth pickle for every split."""
    import pickle

    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    gt = {}
    for i in range(n):
        name = f"track{i:03d}.mmap"
        (rng.standard_normal((frames(rng), 96)) * 1.3 + 2.0).astype(
            np.float16).tofile(root / name)
        y = (rng.random(400) < 0.02).astype(np.float16)
        y[rng.integers(0, 400, 2)] = 1.0
        gt[name] = y
    for split in ("train", "val", "test", "predict"):
        with open(root / f"gt_{split}.pk", "wb") as f:
            pickle.dump(gt, f)


def _cli_overrides(corpus: Path, out: Path, epoch_len: int, extra=()):
    """The overrides of a phase 37-39 run, at ``CLI_DEPTH`` blocks unless
    ``extra`` sets ``maest.depth``."""
    return [f"maest.depth={CLI_DEPTH}", f"datamodule.base_dir='{corpus}'",
            *(f"datamodule.groundtruth_{s}='{corpus}/gt_{s}.pk'"
              for s in ("train", "val", "test", "predict")),
            f"datamodule.sampler.epoch_len={epoch_len}",
            "trainer.max_epochs=2", "module.swa_epoch_start=1",
            "trainer.limit_val_batches=2", "trainer.log_every_n_steps=1",
            f"trainer.default_root_dir='{out}/runs'",
            f"predict.out_dir='{out}/predict'", *extra]


def _cli_run_dir(out: Path) -> Path:
    (run,) = (out / "runs").iterdir()
    return run


def _cli_record(run: Path) -> tuple[dict, list]:
    record = json.loads((run / "run.json").read_text())
    metrics = [json.loads(s) for s in
               (run / "metrics.jsonl").read_text().splitlines()]
    return record, metrics


def _cli_counters():
    from maest_tpu_torch.ops import attention as A
    return {"K2": A.flash_attention, "K3a": A.flash_attention_fwd_lse,
            "K3b": A.attention_bwd, "attention_fwd_mma": A.attention_fwd_mma,
            "attention_bwd_mma": A.attention_bwd_mma,
            "attention_fwd_fp32_fma": A.attention_fwd_fp32_fma,
            "attention_bwd_fp32_fma": A.attention_bwd_fp32_fma}


def _cli_params(run: Path, tag: str) -> dict:
    from maest_tpu_torch.train.loop import read_checkpoint
    return read_checkpoint(run / "checkpoints" / tag)["params"]


def phase_trainer_cli(dev, gpu, keep: Path):
    """Phase 37: the training CLI. ``maest_tpu_torch.apps.ex_maest.run``
    in process: ``main with maest_10s_random_weights_pretrain`` (ViT-B's
    width at ``CLI_DEPTH`` blocks, bf16 over fp32 parameters, batch 12, N
    281 with s patchout t 30, SpecAugment and mixup on, random weights)
    for 2 epochs of 4 steps on 48 synthetic files of 640-1900 frames,
    through the native reader, ``BatchLoader``, ``device_prefetch`` and
    the ``Trainer``, with the launch counters reset: K3a and K3b one a
    block a step, K2 one a block an eval batch for the live and the SWA
    weights, the control kernels never; a run
    resumed from epoch-0 against the uninterrupted one on files of exactly
    one clip; ``test`` and ``extract_embeddings`` on ``best``. K2 is held
    to its plain version on the first qkv the eval hands it, (20, 551)
    bf16, and on a draw of that shape. Times the Trainer's step by CUDA
    events, and the loop's time between steps; then the Trainer's step and
    the bare recipe step at the same shape in alternating rounds of one
    process. Returns the main run's K2, K3a and K3b launches and K2's
    largest error at the eval's shape; leaves a copy of the main run's
    config.json and its epoch-1 checkpoint under ``keep`` (phase 41)."""
    import gc

    from maest_tpu_torch import native
    from maest_tpu_torch.apps import ex_maest
    from maest_tpu_torch.configs import build_experiment_config
    from maest_tpu_torch.data import BatchLoader, device_prefetch
    from maest_tpu_torch.models import vit
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.train import loop
    from maest_tpu_torch.utils.profiling import StepTimer

    t_phase = time.perf_counter()
    check(native.available(), "the native mel reader did not build (g++)")
    counters = _cli_counters()
    timer = StepTimer(warmup=1, device=dev)  # leaves out epoch 0's first step
    spans = []  # host (start, end) of every train step
    real = loop.make_train_step

    def timed_make(*args, **kw):
        step = real(*args, **kw)

        def timed(state, batch, generator=None, draws=None):
            t0 = time.perf_counter()
            timer.start()
            out = step(state, batch, generator, draws)
            timer.stop()
            spans.append((t0, time.perf_counter()))
            return out

        return timed

    evals = {}  # the first qkv the eval hands K2, and every eval shape
    real_qkv = vit.flash_attention_qkv

    def spy_qkv(qkv, *args, **kw):
        if not qkv.requires_grad:
            evals.setdefault("shapes", set()).add(
                (tuple(qkv.shape), str(qkv.dtype).split(".")[1]))
            if "qkv" not in evals:
                evals["qkv"] = (qkv.clone(), dict(zip(
                    ("n_real", "quant", "bwd_quant"), args), **kw))
        return real_qkv(qkv, *args, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _cli_corpus(tmp / "corpus", CLI_FILES,
                    lambda r: int(r.integers(640, 1901)), 37)
        main_out = tmp / "main"
        argv = ["main", "with", CLI_PRESET,
                *_cli_overrides(tmp / "corpus", main_out, CLI_FILES)]
        for c in counters.values():
            c.launches = 0
        loop.make_train_step = timed_make
        vit.flash_attention_qkv = spy_qkv
        try:
            t0 = time.perf_counter()
            res = ex_maest.run(argv)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
        finally:
            loop.make_train_step = real
            vit.flash_attention_qkv = real_qkv
        launches = {k: c.launches for k, c in counters.items()}
        run = _cli_run_dir(main_out)
        record, metrics = _cli_record(run)
        steps = 2 * CLI_FILES // 12
        losses = [m["value"] for m in metrics if m["name"] == "train_loss"]
        skipped = [m["value"] for m in metrics
                   if m["name"] == "nonfinite_skipped"]
        val = {(m["name"], m["step"]): m["value"] for m in metrics
               if m["name"].startswith("val_")}
        check(res == {"done": True} and record["status"] == "COMPLETED",
              f"ex_maest main: {res}, run.json {record['status']}")
        check(len(losses) == steps and all(np.isfinite(losses))
              and skipped == [0.0] * steps,
              f"train losses {losses}, nonfinite_skipped {skipped}")
        ckpts = run / "checkpoints"
        check(all((ckpts / t).is_dir() and (ckpts / f"{t}.meta.json").exists()
                  for t in ("epoch-0", "epoch-1", "best")),
              f"checkpoints {sorted(p.name for p in ckpts.iterdir())}")
        check(all(np.isfinite(v) for (n, _), v in val.items()
                  if "loss" in n) and len(val) == 12,
              f"val metrics {val}")
        (keep / "checkpoints").mkdir(parents=True)
        shutil.copy(run / "config.json", keep)
        shutil.copytree(ckpts / "epoch-1", keep / "checkpoints" / "epoch-1")
        # eval: 2 val batches an epoch, the live and the SWA weights
        want = {"K2": CLI_DEPTH * 2 * 2 * 2, "K3a": CLI_DEPTH * steps,
                "K3b": CLI_DEPTH * steps}
        check(all(launches[k] == n for k, n in want.items())
              and not any(n for k, n in launches.items() if k not in want),
              f"launches on the CLI's run {launches}, wanted {want} and no "
              "control")
        # K2 at the eval's shape against its plain version: the qkv the
        # eval handed it (random weights, the first block of the first val
        # batch) and a draw of the same shape, as strided views of qkv
        qkv, call = evals["qkv"]
        b_test = build_experiment_config([CLI_PRESET], [])["datamodule"][
            "batch_size_test"]
        check(tuple(qkv.shape) == (b_test, CLI_EVAL_N, 3, 12, 64)
              and qkv.dtype == torch.bfloat16
              and call.get("quant") in (None, "none"),
              f"the eval's qkv {tuple(qkv.shape)} {qkv.dtype} {call}")
        n_real = call.get("n_real")
        gen = torch.Generator(device=dev).manual_seed(37)
        draw = torch.randn(qkv.shape, device=dev, generator=gen)
        eval_err = {}
        with torch.inference_mode():
            for name, t in (("eval", qkv), ("draw", draw.to(torch.bfloat16))):
                eval_err[name] = max_err(A.flash_attention_qkv(t, **call),
                                         A.attention_reference(*t.unbind(2),
                                                               n_real))
        check(max(eval_err.values()) <= ATTN_TOL["bfloat16"],
              f"K2 at the eval's {tuple(qkv.shape)}: {eval_err}")
        del qkv, draw
        # the loop's time between steps within an epoch (the loader's
        # wait, the step's generator and the metrics log): epoch starts
        # follow the eval and the checkpoint, so they are left out
        per_epoch = steps // 2
        gaps = [spans[i][0] - spans[i - 1][1] for i in range(len(spans))
                if i % per_epoch]
        busy = [spans[i][1] - spans[i][0] for i in range(len(spans))
                if i % per_epoch]
        wait_share = sum(gaps) / (sum(gaps) + sum(busy))
        trainer_ms = [t * 1e3 for t in timer.times]
        print(f"phase 37 training CLI: ex_maest main with {CLI_PRESET} "
              f"(ViT-B's width at depth {CLI_DEPTH}, bf16 over fp32 "
              f"parameters, batch 12, N 281) on "
              f"{CLI_FILES} synthetic files of 640-1900 frames, 2 epochs of "
              f"{per_epoch} steps, native reader {native.available()}: "
              f"run.json {record['status']}, losses "
              f"{[round(v, 6) for v in losses]}, nonfinite_skipped 0, "
              f"val_loss {val[('val_loss', 0)]:.6f} / "
              f"{val[('val_loss', 1)]:.6f}, val_ap {val[('val_ap', 1)]:.6f}, "
              f"val_loss_swa {val[('val_loss_swa', 1)]:.6f}; checkpoints "
              f"epoch-0, epoch-1, best with markers; launches {launches}; "
              f"K2 at the eval's shapes {sorted(evals['shapes'])} against "
              f"plain: the eval's qkv {eval_err['eval']:.3e}, a draw "
              f"{eval_err['draw']:.3e} <= {ATTN_TOL['bfloat16']}; "
              f"{main_s:.1f} s", flush=True)
        print(f"phase 37 time: the Trainer's step in ex_maest main (CUDA "
              f"events, epoch 0's first step left out, {len(trainer_ms)} "
              f"steps) median {np.median(trainer_ms):.3f} ms (steps "
              f"{', '.join(f'{t:.3f}' for t in trainer_ms)}); the loop's time "
              f"between steps within an epoch {sum(gaps) * 1e3:.3f} ms over "
              f"{len(gaps)} gaps = {100 * wait_share:.2f} % of their steps' "
              f"wall time [{gpu}]", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        # the Trainer's step (a Trainer of the same config, its batches from
        # its loader through device_prefetch), the same step of the
        # Trainer's state on the bare step's batch, and the bare recipe
        # step at the same shape (_recipe: fixed data on the card) in
        # alternating rounds, each step timed the same way; the loader's
        # and the prefetch's threads stay alive through all three
        cfg = build_experiment_config([CLI_PRESET], _cli_overrides(
            tmp / "corpus", tmp / "rounds", CLI_FILES))
        trainer = loop.Trainer(cfg, run_dir=str(tmp / "rounds"), device=dev)
        ds = trainer._train_dataset()
        idx = np.concatenate([trainer._epoch_indices(ds, e) for e in range(
            -(-CLI_ROUNDS * CLI_ROUND_STEPS // trainer.steps_per_epoch))])
        batches = device_prefetch(BatchLoader(
            ds, trainer.global_batch, num_workers=cfg["datamodule"][
                "num_workers"], drop_last=True).iter_indices(idx), dev)
        *_, state, step, data = _recipe(dev, CLI_PRESET, 12, 37,
                                        (f"maest.depth={CLI_DEPTH}",))
        timers = {k: StepTimer(warmup=1, device=dev)
                  for k in ("trainer", "trainer_fixed", "bare")}
        seed = cfg.get("seed", 0)
        try:
            for r in range(CLI_ROUNDS):
                for kind in ("trainer", "trainer_fixed"):
                    for _ in range(CLI_ROUND_STEPS):
                        batch = (loop._step_batch(next(batches))
                                 if kind == "trainer" else data)
                        gen = loop._step_generator(seed, trainer.state.step)
                        timers[kind].start()
                        trainer.state, m = trainer.train_step(trainer.state,
                                                              batch, gen)
                        timers[kind].stop()
                    check(np.isfinite(float(m["train_loss"])),
                          f"the {kind} step loss")
                for i in range(CLI_ROUND_STEPS):
                    gen = torch.Generator().manual_seed(r * CLI_ROUND_STEPS + i)
                    timers["bare"].start()
                    state, m = step(state, data, gen)
                    timers["bare"].stop()
                check(np.isfinite(float(m["train_loss"])), "the bare step loss")
        finally:
            batches.close()
        rounds = {k: [t * 1e3 for t in v.times] for k, v in timers.items()}
        med = {k: float(np.median(v)) for k, v in rounds.items()}
        del trainer, ds, state, step, data, batch
        gc.collect()
        torch.cuda.empty_cache()
        steps_of = {k: ", ".join(f"{t:.3f}" for t in v)
                    for k, v in rounds.items()}
        print(f"phase 37 rounds: {CLI_ROUNDS} alternating rounds of "
              f"{CLI_ROUND_STEPS} steps of each kind in one process (CUDA "
              f"events, each kind's first step left out): the Trainer's step "
              f"median {med['trainer']:.3f} ms (steps {steps_of['trainer']}); "
              f"the Trainer's state on the bare step's batch median "
              f"{med['trainer_fixed']:.3f} ms (steps "
              f"{steps_of['trainer_fixed']}); the bare recipe step at the "
              f"same shape (_recipe, {CLI_PRESET} at depth {CLI_DEPTH}, "
              f"batch 12) median "
              f"{med['bare']:.3f} ms (steps {steps_of['bare']}); the "
              f"Trainer's step {med['trainer'] - med['bare']:+.3f} ms over "
              f"the bare step [{gpu}]", flush=True)

        # resume: files of exactly one clip (625 frames), so every train
        # crop starts at 0; two epochs, then epoch 1 again from epoch-0
        _cli_corpus(tmp / "clips", CLI_RESUME_FILES, lambda r: 625, 38)
        resume = {}
        for name, extra in (("full", CLI_RESUME_LR), ("resumed", None)):
            out = tmp / name
            if extra is None:
                start = _cli_run_dir(tmp / "full") / "checkpoints" / "epoch-0"
                extra = (*CLI_RESUME_LR, f"ckpt_path='{start}'")
            argv = ["main", "with", CLI_PRESET, *_cli_overrides(
                tmp / "clips", out, CLI_RESUME_FILES, extra)]
            check(ex_maest.run(argv) == {"done": True}, f"resume run {name}")
            resume[name] = _cli_run_dir(out)
        full = _cli_params(resume["full"], "epoch-1")
        again = _cli_params(resume["resumed"], "epoch-1")
        before = _cli_params(resume["full"], "epoch-0")
        diff = max((full[k] - again[k]).abs().max().item() for k in full)
        moved = max((full[k] - before[k]).abs().max().item() for k in full)
        meta = json.loads((resume["resumed"] / "checkpoints" /
                           "epoch-1.meta.json").read_text())
        check(diff <= CLI_RESUME_TOL and moved > 10 * CLI_RESUME_TOL
              and meta["epoch"] == 1
              and not (resume["resumed"] / "checkpoints" / "epoch-0").exists(),
              f"resume from epoch-0: largest parameter difference {diff} "
              f"(bound {CLI_RESUME_TOL}), epoch 1 moved {moved}, meta {meta}")
        print(f"phase 37 resume: {CLI_RESUME_FILES} files of 625 frames, 2 "
              f"epochs of 2 steps, then epoch 1 again from epoch-0: largest "
              f"parameter difference after epoch 1 {diff:.3e} (bound "
              f"{CLI_RESUME_TOL:.0e}); epoch 1 moved a parameter by up to "
              f"{moved:.3e}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        # test and extract_embeddings on the main run's best checkpoint
        best = f"ckpt_path='{ckpts / 'best'}'"
        for c in counters.values():
            c.launches = 0
        test = ex_maest.run(["test", "with", CLI_PRESET, *_cli_overrides(
            tmp / "corpus", tmp / "test", CLI_FILES, (best,))])
        test_k2 = counters["K2"].launches
        check(sorted(test) == ["test_ap", "test_loss", "test_roc"]
              and all(np.isfinite(v) for v in test.values()),
              f"ex_maest test: {test}")
        # the preset taps block 11; the last of CLI_DEPTH here
        ext = ex_maest.run(["extract_embeddings", "with", CLI_PRESET,
                            *_cli_overrides(tmp / "corpus", tmp / "ext",
                                            CLI_FILES, (
                                                best, "predict.transformer_"
                                                f"block={CLI_DEPTH - 1}"))])
        files = sorted(Path(ext["out_dir"]).glob("*.embeddings.npy"))
        shapes = {}
        for f in files:
            frames = (tmp / "corpus" / f.name.split(".")[0]).with_suffix(
                ".mmap").stat().st_size // (2 * 96)
            windows = min(int(frames * 1.1 // 625), -(-frames // 625))
            e = np.load(f)
            shapes[e.shape] = shapes.get(e.shape, 0) + 1
            check(e.shape == (windows, 3 * 768) and np.isfinite(e).all(),
                  f"{f.name}: {e.shape}, wanted ({windows}, 2304)")
        check(ext["n_files"] == len(files) == CLI_FILES,
              f"extract_embeddings: {ext['n_files']} files, {len(files)} .npy")
        print(f"phase 37 test on best (live weights only): "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(test.items()))
              + f", K2 launches {test_k2}; extract_embeddings: "
              f"{len(files)} files, shapes {shapes}; phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {**{k: launches[k] for k in ("K2", "K3a", "K3b")},
            "K2_err": max(eval_err.values())}


# phase 38: the Trainer's parallel modes, each launched as torchrun
# launches a user's ranks (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
# MASTER_PORT set in each process), at the 10 s preset's full width with
# a global batch of 12: (name, ranks, overrides)
P38_MODES = (
    ("dp", 2, ("trainer.devices=2", "datamodule.batch_size_train=6")),
    ("tp", 2, ("trainer.devices=2", "trainer.model_parallel=2")),
    ("fsdp", 2, ("trainer.devices=2", "trainer.fsdp=True",
                 "datamodule.batch_size_train=6")),
    ("tp+sp", 2, ("trainer.devices=2", "trainer.model_parallel=2",
                  "trainer.sequence_parallel=True")),
    ("dp+tp+sp", 4, ("trainer.devices=4", "trainer.model_parallel=2",
                     "trainer.sequence_parallel=True",
                     "datamodule.batch_size_train=6")),
    ("fsdp-nccl", 1, ("trainer.devices=1", "trainer.fsdp=True")),
)
P38_FILES = 48         # one epoch of 4 steps of 12; one eval batch
P38_EXTRA = ("trainer.max_epochs=1", "trainer.limit_val_batches=1",
             *CLI_RESUME_LR)
# Each mode against the one-process run of the same global batches and
# draws (stated in PERF.md before the runs that check them): bf16
# products over other row and head splits round apart.
# every step's train_loss and the val losses, relative
P38_LOSS_RTOL = 1e-3
# the eval's probabilities (sigmoid of the logits), absolute
P38_PROB_ATOL = 1e-2
# macro AP and ROC over the eval batch's 20 rows: equal to one process's
# where every probability is; elsewhere not bounded, since they rank rows
# whose probabilities lie closer together than the probabilities' rounding
# (the reference's line prints how close), and rounding reorders them
# the final parameters: |theta - theta_one| / |theta_one - theta_0| over
# every parameter but the key bias (whose gradient is zero in exact
# arithmetic, so Adam normalises rounding noise into whole steps)
P38_UPDATE_RTOL = 0.2
P38_TIMEOUT = 300.0    # every rank of a launch is killed after it


def _p38_replica_gap(model, par) -> tuple[float, int]:
    """The largest difference between ranks that hold a replica of the
    same parameter elements, and the number of elements compared: each
    parameter tensor parallelism does not split over the model ranks,
    every unsharded parameter over the data ranks of one model rank, the
    embeddings and heads over the pipeline's stages. An FSDP shard has no
    replica and is not compared."""
    import torch.distributed as dist

    from maest_tpu_torch.parallel import mesh as pmesh

    named = [(k, p.detach().reshape(-1)) for k, p in model.named_parameters()
             if not pmesh.is_sharded(p)]
    gap, n = 0.0, 0
    for size, group, keep in (
            (par.data, par.data_group, lambda k: True),
            (par.model, par.model_group,
             lambda k: pmesh._tp_rule(k) is None),
            (par.pipe, par.pipe_group,
             lambda k: not k.startswith("blocks."))):
        parts = [t for k, t in named if keep(k)]
        if size == 1 or not parts:
            continue
        flat = torch.cat(parts)
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        gap, n = max(gap, float((hi - lo).max())), n + flat.numel()
    return gap, n


def _p38_instrument(records: dict):
    """Wrap the Trainer's step, eval step and metrics in this process:
    each step timed by CUDA events and followed by ``_p38_replica_gap``;
    in one process, the whole parameters before the first step; a digest
    of each eval row's input; the targets and probabilities each macro
    AP/ROC is taken from; each validation's metrics; the first train and
    eval qkv the attention kernels get."""
    import hashlib

    from maest_tpu_torch.models import vit
    from maest_tpu_torch.parallel import pipeline
    from maest_tpu_torch.train import loop

    real_make, real_make_eval = loop.make_train_step, loop.make_eval_step
    real_make_pp = pipeline.make_pipeline_train_step
    real_ap_roc, real_qkv = loop.macro_ap_roc, vit.flash_attention_qkv
    real_validate = loop.Trainer.validate

    def make(*args, parallel=None, _real=real_make, **kw):
        step = _real(*args, parallel=parallel, **kw)

        def timed(state, batch, generator=None, draws=None):
            if parallel is None and "init" not in records:
                records["init"] = {k: p.detach().cpu().clone() for k, p
                                   in state.model.named_parameters()}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch, generator, draws)
            end.record()
            end.synchronize()
            records["step_ms"].append(start.elapsed_time(end))
            if parallel is not None:
                with torch.no_grad():
                    records["replica_gap"].append(
                        _p38_replica_gap(state.model, parallel))
            return out

        return timed

    def make_eval(*args, **kw):
        step = real_make_eval(*args, **kw)

        def spy(state, x):
            rows = torch.as_tensor(x).float().cpu().numpy()
            records["eval_rows"].append(
                [hashlib.sha1(r.tobytes()).hexdigest() for r in rows])
            return step(state, x)

        return spy

    def validate(self):
        out = real_validate(self)
        records["val"].append(out)
        return out

    def ap_roc(y, y_hat):
        records["scores"].append((np.array(y), np.array(y_hat)))
        return real_ap_roc(y, y_hat)

    def spy_qkv(qkv, *args, **kw):
        kind = "train" if qkv.requires_grad else "eval"
        if kind not in records["qkv"]:
            records["qkv"][kind] = qkv.detach().clone()
        return real_qkv(qkv, *args, **kw)

    def make_pp(*args, **kw):
        return make(*args, _real=real_make_pp, **kw)

    loop.make_train_step, loop.make_eval_step = make, make_eval
    pipeline.make_pipeline_train_step = make_pp
    loop.macro_ap_roc, vit.flash_attention_qkv = ap_roc, spy_qkv
    loop.Trainer.validate = validate

    def undo():
        loop.make_train_step, loop.make_eval_step = real_make, real_make_eval
        pipeline.make_pipeline_train_step = real_make_pp
        loop.macro_ap_roc, vit.flash_attention_qkv = real_ap_roc, real_qkv
        loop.Trainer.validate = real_validate

    return undo


def _p38_run(argv: list, name: str) -> dict:
    """``ex_maest.run(argv)`` in this process with the launch counters
    reset and read just after; the record of its steps, evals and
    launches."""
    import torch.distributed as dist

    from maest_tpu_torch.apps import ex_maest

    records = {"step_ms": [], "replica_gap": [], "eval_rows": [],
               "scores": [], "val": [], "qkv": {}}
    counters = _cli_counters()
    undo = _p38_instrument(records)
    for c in counters.values():
        c.launches = 0
    try:
        t0 = time.perf_counter()
        res = ex_maest.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        undo()
    launches = {k: c.launches for k, c in counters.items()}
    return {"name": name, "result": res, "launches": launches, **records,
            "wall_s": wall,
            "backend": dist.get_backend() if dist.is_initialized() else None}


def _p38_kernel_gaps(qkv: dict) -> dict:
    """K3a and K3b on the first train qkv a rank handed them (strided
    views, a drawn output gradient), K2 on the first eval qkv, against
    their plain versions; called after the counters were read."""
    from maest_tpu_torch.ops import attention as A

    out = {}
    with torch.no_grad():
        t = qkv["train"]
        q, k, v = t.unbind(2)
        g = torch.randn(q.shape, device=t.device, dtype=t.dtype,
                        generator=torch.Generator(device=t.device
                                                  ).manual_seed(38))
        o, lse = A.flash_attention_fwd_lse(q, k, v)
        ro, rlse = A.attention_reference_lse(q, k, v)
        grads = A.attention_bwd(q, k, v, ro, rlse, g)
        ref = A.attention_bwd_reference(q, k, v, ro, rlse, g)
        out["train_shape"] = tuple(t.shape)
        out["K3a"] = max(max_err(o, ro), max_err(lse, rlse))
        out["K3a_lse"] = max_err(lse, rlse)
        out["K3b"] = max(max_err(a, r) for a, r in zip(grads, ref))
        e = qkv["eval"]
        out["eval_shape"] = tuple(e.shape)
        out["K2"] = max_err(A.flash_attention_qkv(e),
                            A.attention_reference(*e.unbind(2)))
    return out


def _p38_rank(rank: int, world: int, argvs: list,
              all_gaps: bool = False) -> dict:
    """One rank of a phase 38 or 39 launch (``parallel.launch.spawn`` sets
    torchrun's variables): each mode's ``ex_maest.run`` in turn; returns
    its records by mode, with the kernels held to plain at the rank's
    shapes under tensor parallelism, or in every mode (``all_gaps``)."""
    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    out = {}
    for name, argv in argvs:
        rec = _p38_run(argv, name)
        if rec["qkv"].get("train") is not None and (
                all_gaps or rec["qkv"]["train"].shape[3] < 12):
            rec["gaps"] = _p38_kernel_gaps(rec["qkv"])
        rec["qkv"] = {k: tuple(v.shape) for k, v in rec["qkv"].items()}
        out[name] = rec
        torch.cuda.empty_cache()
    return out


def _p38_update_gap(params: dict, ref: dict, init: dict) -> tuple:
    """|params - ref| / |ref - init| over every parameter but the key
    bias, and the tensor with the largest such ratio of its own."""
    num = den = 0.0
    worst = (0.0, "")
    for k, b in ref.items():
        a, b, z = (t.double().reshape(-1) for t in (params[k], b, init[k]))
        if k.endswith("attn.qkv.bias"):
            e = a.numel() // 3
            a, b, z = (torch.cat([t[:e], t[2 * e:]]) for t in (a, b, z))
        d, u = float((a - b).square().sum()), float((b - z).square().sum())
        num, den = num + d, den + u
        if u > 0:
            worst = max(worst, (math.sqrt(d / u), k))
    return math.sqrt(num / den), worst


def _p38_reference(argv, name: str, out: Path, phase: int, gpu) -> dict:
    """The one-process reference of phases 38 and 39: ``ex_maest main``
    in this process, and what every mode is held to (its losses, val
    metrics, the eval's rows and scores, its final checkpoint and the
    initial parameters)."""
    ref = _p38_run(argv, name)
    steps = P38_FILES // 12
    check(ref["result"] == {"done": True} and len(ref["step_ms"]) == steps
          and len(ref["eval_rows"]) == 1 and len(ref["scores"]) == 2,
          f"phase {phase} reference run: {ref['result']}, "
          f"{len(ref['step_ms'])} steps, {len(ref['eval_rows'])} eval "
          f"batches, {len(ref['scores'])} metric calls")
    run = _cli_run_dir(out)
    _, metrics = _cli_record(run)
    loss = [m["value"] for m in metrics if m["name"] == "train_loss"]
    val = {m["name"]: m["value"] for m in metrics
           if m["name"].startswith("val_")}
    # what a row taken from the wrong place would change: the largest
    # difference between two rows of the reference's probabilities
    y_hat = ref["scores"][0][1]
    row_spread = float(np.abs(y_hat[:, None] - y_hat[None]).max())
    depth = next(int(a.split("=")[1]) for a in reversed(argv)
                 if a.startswith("maest.depth="))
    print(f"phase {phase} reference: ex_maest main with {CLI_PRESET} at "
          f"depth {depth}, one process, batch 12, {steps} steps and one eval "
          f"batch of {len(ref['eval_rows'][0])}: losses "
          f"{[round(v, 6) for v in loss]}, "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(val.items()))
          + f"; the eval probabilities of two rows differ by up to "
          f"{row_spread:.4f}; median step "
          f"{np.median(ref['step_ms'][1:]):.3f} ms, launches "
          f"{ref['launches']}; {ref['wall_s']:.1f} s [{gpu}]", flush=True)
    check(len(loss) == steps and abs(loss[-1] - math.log(2)) > 1e-4
          and {"val_loss", "val_ap", "val_roc", "val_loss_swa"} <= set(val),
          f"reference losses {loss} (the head must have moved), val {val}")
    return {"loss": loss, "val": val, "params": _cli_params(run, "epoch-0"),
            "init": ref["init"], "rows": ref["eval_rows"][0],
            "scores": ref["scores"], "steps": steps, "depth": depth}


def _p38_check_mode(phase: int, name: str, ranks: list, run: Path,
                    R: dict, data: int, want: dict,
                    backend_want: str) -> tuple[str, dict]:
    """One mode's ranks against the reference ``R``: every step's loss;
    the replicas after each step; the eval's input rows (each data rank's,
    in the reference's order; every rank of a data rank the same), targets,
    probabilities, val losses and AP/ROC; rank 0's final checkpoint; each
    rank's launches (``want``, the controls 0); the backend. Returns the
    mode's line and rank 0's record."""
    world = len(ranks)
    per_data = world // data
    r0 = ranks[0]
    steps = R["steps"]
    _, metrics = _cli_record(run)
    loss = [m["value"] for m in metrics if m["name"] == "train_loss"]
    rel = [abs(a - b) / abs(b) for a, b in zip(loss, R["loss"])]
    check(r0["result"] == {"done": True} and len(loss) == steps
          and max(rel) <= P38_LOSS_RTOL,
          f"phase {phase} {name}: losses {loss} against {R['loss']}, "
          f"relative {rel} (bound {P38_LOSS_RTOL})")
    gaps = [g for r in ranks for g, _ in r["replica_gap"]]
    compared = max(n for r in ranks for _, n in r["replica_gap"])
    check(len(gaps) == world * steps and max(gaps) == 0.0,
          f"phase {phase} {name}: the replicas' parameters after each "
          f"step differ by up to {gaps}")
    check(all(len(r["eval_rows"]) == 1 for r in ranks)
          and [h for r in ranks[::per_data] for h in r["eval_rows"][0]]
          == R["rows"] and all(
              r["eval_rows"] == ranks[i - i % per_data]["eval_rows"]
              for i, r in enumerate(ranks)),
          f"phase {phase} {name}: the eval's input rows are not one "
          "process's")
    val_gap = {"prob": 0.0, "loss": 0.0, "rank": 0.0}
    for r, rec in enumerate(ranks):
        check(len(rec["scores"]) == 2 and len(rec["val"]) == 1
              and set(rec["val"][0]) == set(R["val"]) and all(
                  np.array_equal(y, y1) for (y, _), (y1, _)
                  in zip(rec["scores"], R["scores"])),
              f"phase {phase} {name} rank {r}: the eval's targets or "
              f"metrics {rec['val']}")
        val_gap["prob"] = max(val_gap["prob"], *(
            float(np.abs(p - p1).max()) for (_, p), (_, p1)
            in zip(rec["scores"], R["scores"])))
        for k, x in rec["val"][0].items():
            if "_loss" in k:
                d = abs(x - R["val"][k]) / abs(R["val"][k])
                val_gap["loss"] = max(val_gap["loss"], d)
            else:
                val_gap["rank"] = max(val_gap["rank"], abs(x - R["val"][k]))
    same = all(np.array_equal(p, p1) for rec in ranks
               for (_, p), (_, p1) in zip(rec["scores"], R["scores"]))
    check(val_gap["prob"] <= P38_PROB_ATOL
          and val_gap["loss"] <= P38_LOSS_RTOL
          and (val_gap["rank"] == 0.0 or not same),
          f"phase {phase} {name}: the eval against one process's "
          f"{val_gap} (bounds {P38_PROB_ATOL}, {P38_LOSS_RTOL}, and 0 for "
          f"AP/ROC where the probabilities are equal: {same}); rank 0 "
          f"{r0['val']}, one {R['val']}")
    upd, (t_worst, k_worst) = _p38_update_gap(
        _cli_params(run, "epoch-0"), R["params"], R["init"])
    check(upd <= P38_UPDATE_RTOL,
          f"phase {phase} {name}: final parameters {upd} of the update from "
          f"one process's (bound {P38_UPDATE_RTOL}; worst {k_worst} "
          f"{t_worst})")
    for r, rec in enumerate(ranks):
        got = rec["launches"]
        check(all(got[k] == n for k, n in want.items())
              and not any(n for k, n in got.items() if k not in want),
              f"phase {phase} {name} rank {r}: launches {got}, wanted "
              f"{want} and no control")
    backend = r0["backend"]
    check(backend == backend_want, f"phase {phase} {name}: backend {backend}")
    counts = [r["launches"] for r in ranks]
    counts = counts[0] if all(c == counts[0] for c in counts) else counts
    replicas = (f"the replicas of {compared} parameter elements after each "
                f"of {steps} steps differ by {max(gaps)}" if compared else
                "no parameter element has a replica to compare (FSDP "
                "shards every one)" if world > 1 else "one rank: no replica")
    line = (f"phase {phase} {name}: {world} rank(s) on the one card over "
            f"{backend}{' (CUDA tensors)' if backend == 'gloo' else ''}, "
            f"depth {R['depth']}, global batch 12: losses "
            f"{[round(v, 6) for v in loss]} (largest relative gap to one "
            f"process {max(rel):.2e} <= {P38_LOSS_RTOL}); {replicas}; final "
            f"parameters (rank 0's checkpoint) {upd:.3e} of one process's "
            f"update from it <= {P38_UPDATE_RTOL} (worst tensor {k_worst} "
            f"{t_worst:.3e}); the eval's {len(R['rows'])} input rows "
            f"bit-equal to one process's and every rank's targets equal; "
            f"against one process's, every rank's probabilities "
            f"{val_gap['prob']:.2e} <= {P38_PROB_ATOL}, val losses "
            f"{val_gap['loss']:.2e} <= {P38_LOSS_RTOL} (relative), AP and ROC "
            f"{val_gap['rank']:.2e} ("
            + ("the probabilities bit-equal, so 0" if same else
               "not bounded: the probabilities round apart") +
            f"; val_loss {r0['val'][0]['val_loss']:.6f}, val_ap "
            f"{r0['val'][0]['val_ap']:.6f}, val_roc "
            f"{r0['val'][0]['val_roc']:.6f}); launches a rank {counts}"
            f"; median step (rank 0, CUDA events, the first left out) "
            f"{np.median(r0['step_ms'][1:]):.3f} ms (steps "
            f"{', '.join(f'{t:.3f}' for t in r0['step_ms'])}); ex_maest.run "
            f"{r0['wall_s']:.1f} s")
    return line, r0


def _p38_gap_line(phase: int, name: str, g: dict, train_shape: tuple,
                  eval_shape: tuple) -> str:
    """K3a/K3b and K2 held to plain at the shapes a rank handed them."""
    check(g["train_shape"] == train_shape and g["eval_shape"] == eval_shape,
          f"phase {phase} {name}: local shapes {g}")
    tol = ATTN_TOL["bfloat16"]
    check(g["K3a"] <= tol and g["K3a_lse"] <= LSE_TOL and g["K3b"] <= tol
          and g["K2"] <= tol, f"phase {phase} {name}: kernels against plain "
          f"{g}")
    return (f"; K3a/K3b at the rank's {g['train_shape']} against plain "
            f"{g['K3a']:.3e} (lse {g['K3a_lse']:.3e}) / {g['K3b']:.3e}, K2 at "
            f"{g['eval_shape']} {g['K2']:.3e} <= {tol}")


def phase_parallel(dev, gpu):
    """Phase 38: the Trainer's parallel modes at full width. ``ex_maest
    main with maest_10s_random_weights_pretrain`` (ViT-B's width, 12 heads
    of 64, N 281, bf16 over fp32 parameters, global batch 12; one epoch of
    4 steps and one eval batch of 20) on 48 synthetic files of one clip,
    cut to ``CLI_DEPTH`` blocks: first in this process (the reference),
    then in ranks launched with torchrun's variables: 2 on the one card
    over gloo on CUDA tensors (NCCL refuses two ranks of one card) in dp,
    tp, fsdp and tp+sp, 4 in dp+tp+sp, and 1 over NCCL in fsdp. Each mode
    against the reference (``_p38_check_mode``): every step's train_loss
    (P38_LOSS_RTOL); the eval rows' inputs bit-equal, in the reference's
    order across the data ranks, and their targets equal; every rank's
    eval probabilities (P38_PROB_ATOL), val losses (P38_LOSS_RTOL), macro
    AP and ROC (equal where the probabilities are), live and SWA; rank 0's
    final checkpoint (P38_UPDATE_RTOL); the replicas of each parameter
    element equal after every step (FSDP shards every parameter, so it
    has none); each rank's launches (K3a and K3b one a block a step, K2
    one a block an eval batch for the live and again for the SWA weights,
    the controls 0); under tensor parallelism K3a/K3b at (12, 281, 6, 64)
    and K2 at (20, 551, 6, 64) held to plain (a data rank's rows of them
    under dp+tp+sp). Returns rank 0's launches summed over the modes, the
    largest kernel error and the one-process reference, which phase 39
    holds its modes to."""
    import gc

    from maest_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # files of exactly one clip: every train crop starts at 0, so
        # every layout reads the same rows (longer files are cropped at a
        # random offset each run)
        _cli_corpus(tmp / "corpus", P38_FILES, lambda r: 625, 38)

        def argv(name, extra):
            return ["main", "with", CLI_PRESET, *_cli_overrides(
                tmp / "corpus", tmp / name.replace("+", "_"), P38_FILES,
                (*P38_EXTRA, *extra))]

        R = _p38_reference(argv("one", ("trainer.devices=1",)), "one",
                           tmp / "one", 38, gpu)
        gc.collect()
        torch.cuda.empty_cache()

        recs, walls = {}, {}
        for world in (2, 4, 1):
            modes = [(n, argv(n, extra)) for n, w, extra in P38_MODES
                     if w == world]
            t0 = time.perf_counter()
            ranks = spawn(_p38_rank, world, modes, timeout=P38_TIMEOUT)
            walls[world] = time.perf_counter() - t0
            for n, _ in modes:
                recs[n] = [r[n] for r in ranks]

        total = {"K2": 0, "K3a": 0, "K3b": 0}
        err = 0.0
        depth, steps = R["depth"], R["steps"]
        want = {"K2": depth * 2, "K3a": depth * steps, "K3b": depth * steps}
        for name, world, extra in P38_MODES:
            model = 2 if "trainer.model_parallel=2" in extra else 1
            line, r0 = _p38_check_mode(
                38, name, recs[name], _cli_run_dir(tmp / name.replace(
                    "+", "_")), R, world // model, want,
                "nccl" if world == 1 else "gloo")
            for k in total:
                total[k] += r0["launches"][k]
            if "gaps" in r0:
                data = world // model
                line += _p38_gap_line(38, name, r0["gaps"],
                                      (12 // data, 281, 3, 6, 64),
                                      (20 // data, CLI_EVAL_N, 3, 6, 64))
                err = max(err, *(r0["gaps"][k] for k in ("K3a", "K3b", "K2")))
            print(line + f" [{gpu}]", flush=True)
        print(f"phase 38 time: launches of 2, 4 and 1 rank(s) "
              f"{walls[2]:.1f}, {walls[4]:.1f} and {walls[1]:.1f} s "
              f"(each rank's start included); phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {**total, "err": err, "reference": R}


# phase 39: GPipe through the Trainer, each mode launched as phase 38's,
# at phase 38's CLI_DEPTH blocks (2 a stage) and global batch 12:
# (name, ranks, overrides); the microbatches divide each data rank's rows
P39_MODES = (
    ("pp", 2, ("trainer.devices=2", "trainer.pipeline_parallel=2",
               "trainer.num_microbatches=4")),
    ("dp+pp", 4, ("trainer.devices=4", "trainer.pipeline_parallel=2",
                  "trainer.num_microbatches=3",
                  "datamodule.batch_size_train=6")),
    ("pp+tp", 4, ("trainer.devices=4", "trainer.pipeline_parallel=2",
                  "trainer.model_parallel=2", "trainer.num_microbatches=4")),
    ("dp+pp+fsdp", 4, ("trainer.devices=4", "trainer.pipeline_parallel=2",
                       "trainer.fsdp=True", "trainer.num_microbatches=3",
                       "datamodule.batch_size_train=6")),
)
P39_TIMEOUT = 400.0    # every rank of a launch is killed after it


def phase_pipeline(dev, gpu, R: dict):
    """Phase 39: GPipe through the Trainer at full width.
    ``ex_maest main with maest_10s_random_weights_pretrain`` (ViT-B's
    width at CLI_DEPTH blocks, 2 stages of 2, bf16 over fp32 parameters,
    global batch 12,
    one epoch of 4 steps, one eval batch of 20 at one microbatch) on
    phase 38's corpus, in ranks launched as phase 38's, sharing the one
    card over gloo on CUDA tensors: pp (2 ranks, 4 microbatches), dp+pp
    (data 2 x pipe 2, 3), pp+tp (pipe 2 x model 2, 4) and dp+pp+fsdp (3).
    Each mode held to phase 38's one-process run ``R`` with
    phase 38's bounds (``_p38_check_mode``), the replicas compared over
    the data, model and pipe ranks (the embeddings and heads every stage
    holds); each rank's launches: K3a and K3b 2 blocks x M microbatches a
    step, K2 2 an eval forward, live and SWA; K3a/K3b at each rank's
    microbatch shape and K2 at its eval shape held to plain. Returns each
    mode's launches on every rank and the largest kernel error."""
    import gc

    from maest_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    stages, depth, steps = 2, R["depth"], R["steps"]
    per_stage = depth // stages
    launches, err, walls = {}, 0.0, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _cli_corpus(tmp / "corpus", P38_FILES, lambda r: 625, 38)

        def argv(name, extra):
            return ["main", "with", CLI_PRESET, *_cli_overrides(
                tmp / "corpus", tmp / name.replace("+", "_"), P38_FILES,
                (*P38_EXTRA, f"maest.depth={depth}", *extra))]

        recs = {}
        for world in (2, 4):
            modes = [(n, argv(n, extra)) for n, w, extra in P39_MODES
                     if w == world]
            t0 = time.perf_counter()
            ranks = spawn(_p38_rank, world, modes, True, timeout=P39_TIMEOUT)
            walls[world] = time.perf_counter() - t0
            for n, _ in modes:
                recs[n] = [r[n] for r in ranks]

        for name, world, extra in P39_MODES:
            model = 2 if "trainer.model_parallel=2" in extra else 1
            data = world // (stages * model)
            m = next(int(a.split("=")[1]) for a in extra
                     if a.startswith("trainer.num_microbatches="))
            want = {"K2": per_stage * 2, "K3a": per_stage * m * steps,
                    "K3b": per_stage * m * steps}
            line, r0 = _p38_check_mode(
                39, name, recs[name], _cli_run_dir(tmp / name.replace(
                    "+", "_")), R, data, want, "gloo")
            launches[name] = [r["launches"] for r in recs[name]]
            heads = 12 // model
            for r, rec in enumerate(recs[name]):
                line += _p38_gap_line(
                    39, f"{name} rank {r}", rec["gaps"],
                    (12 // data // m, 281, 3, heads, 64),
                    (20 // data, CLI_EVAL_N, 3, heads, 64)) if r in (
                        0, world - 1) else ""
                err = max(err, *(rec["gaps"][k] for k in ("K3a", "K3b",
                                                          "K2")))
            print(line + f"; launches wanted a rank {want} [{gpu}]",
                  flush=True)
        print(f"phase 39 time: launches of 2 and 4 ranks {walls[2]:.1f} "
              f"and {walls[4]:.1f} s (each rank's start included); phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": launches, "err": err}


# phase 40: the tagging entry points on the card. The graph-backed
# TagService at full width (bf16, the 6 default buckets x 3 families, each
# replay held to the eager run with SERVE_TOL; fp32 wave buckets 1 and 32
# with P40_F32_TOL: the same kernels on the same buffers, 0 expected), the
# served answers, launches a replayed batch, latency under load with and
# without graphs; apps/tag.py in a process of its own on an HF AST layout
# checkpoint; and the inference mesh in 2 ranks over gloo on the one card,
# at P40_MESH_DEPTH blocks, held to one process (GOLDEN_TOL, fp32)
P40_F32_TOL = 2e-5
P40_MESH_DEPTH = 4
P40_SEQUENTIAL = 16    # scripts/serve_bench.py's shape: 16 requests in turn,
P40_CLIENTS = 32       # then 32 client threads x 4 native requests
P40_PER_CLIENT = 4
P40_JSON_TOL = 1e-4    # tag --json rounds activations to 4 decimals
P40_BLOCK = 7          # tag --embeddings-dir's block (its default)
P40_BUCKET_ROUNDS = 5  # a bucket's replay and eager run timed in turn
P40_TIMEOUT = 300.0
# the kernels a served batch may run, by the profiler's names
P40_KERNELS = {"K1": r"logmel_fft_kernel", "K1_control": r"logmel_kernel",
               "K2": r"attn_fwd_wgmma_kernel",
               "K2_control": r"attn_fwd_bf16_kernel",
               "K2_fp32": r"attn_fwd_tf32_kernel",
               "K2_fp32_control": r"attn_fwd_fp32_kernel"}


def _p40_elements(progs, n: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(
        (n, *progs.elem_shape)).astype(np.float32) * 0.1
    if progs.pcm16:
        return (np.clip(x, -1, 1) * 32767).astype(np.int16)
    return x


def _p40_graphs_vs_eager(progs, seed: int) -> float:
    """Every bucket of ``progs`` replayed and run eagerly on the same
    elements; the largest difference."""
    worst = 0.0
    for b in progs.buckets:
        batch = _p40_elements(progs, b, seed + b)
        got, want = progs.run(batch), progs.eager(batch)
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"{progs.kind} bucket {b} replay")
        worst = max(worst, float(np.abs(got - want).max()))
    return worst


def _p40_replay_kernels(progs, seed: int, **want) -> dict:
    """{bucket: {label: launches}} of one replay of each bucket of
    ``progs`` by torch.profiler's kernel names (P40_KERNELS; the host
    counters tick at capture only), the largest count of its traces; each must be ``want``, the other labels 0. ``"short"``: the
    traces that lost a record."""
    from maest_tpu_torch.utils.profiling import kernel_launches

    out = {}
    for b in progs.buckets:
        batch = _p40_elements(progs, b, seed + b)
        seen = kernel_launches(lambda: progs.run(batch), P40_KERNELS)
        out[b] = {k: seen[k] for k in P40_KERNELS}
        out[b]["short"] = seen["short"]
        check({k: seen[k] for k in P40_KERNELS}
              == {k: want.get(k, 0) for k in P40_KERNELS},
              f"{progs.kind} bucket {b} replay's kernels {seen}")
    return out


def _p40_serve_launches(families, traced: dict, label: str) -> dict:
    """A kernel's launches under graph replay in ``families``: per_batch,
    the profiler's count over one replay (the same in every bucket, as
    ``_p40_replay_kernels`` checked), the batches replayed, and their
    total, each bucket's count times its replays."""
    per = {traced[p.kind][b][label] for p in families for b in p.buckets}
    check(len(per) == 1, f"{label} launches differ between buckets {per}")
    return {"per_batch": per.pop(),
            "replays": sum(sum(p.replays.values()) for p in families),
            "total": sum(traced[p.kind][b][label] * n for p in families
                         for b, n in p.replays.items())}


def _p40_split(progs, batch: np.ndarray) -> dict:
    """A full bucket's batch through its graph as ``run`` takes it, step
    by step: ms of the copy in (pageable, as ``run`` copies it, and from
    pinned memory), the replay and the copy out, by CUDA events on the
    current stream, and the host's clock over the three; medians of
    P40_BUCKET_ROUNDS rounds."""
    dev = progs.model.device
    g = progs._graphs[batch.shape[0]]
    src = torch.from_numpy(batch)
    pinned = src.pin_memory()
    names = ("h2d", "replay", "d2h", "h2d_pinned", "host")
    runs = {k: [] for k in names}
    with progs._lock, torch.inference_mode():
        for _ in range(P40_BUCKET_ROUNDS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            ev[0].record()
            g.static_in.copy_(src)
            ev[1].record()
            g.graph.replay()
            ev[2].record()
            g.static_out.cpu()
            ev[3].record()
            runs["host"].append((time.perf_counter() - t0) * 1e3)
            g.static_in.copy_(pinned, non_blocking=True)
            ev[4].record()
            ev[4].synchronize()
            for k, (a, z) in zip(names, ((0, 1), (1, 2), (2, 3), (3, 4))):
                runs[k].append(ev[a].elapsed_time(ev[z]))
    out = {k: float(np.median(v)) for k, v in runs.items()}
    out["mb"] = src.numel() * src.element_size() / 1e6
    return out


def _p40_load(svc, waves: list, pcm: list) -> dict:
    """scripts/serve_bench.py's shape on ``svc``: P40_SEQUENTIAL native
    float32 requests in turn, then P40_CLIENTS threads x P40_PER_CLIENT in
    float32 and in pcm16; audio-s/s, p50/p99 ms and mean batch fill of
    each, the latency window cleared between them."""
    out = {}

    def window():
        svc.stats_reset_window()
        svc.batcher.stats.batches = svc.batcher.stats.batched_chunks = 0

    window()
    t0 = time.perf_counter()
    for i in range(P40_SEQUENTIAL):
        svc.tag(waves[i % len(waves)])
    dt = time.perf_counter() - t0
    st = svc.stats()
    out["sequential"] = {"audio_s_per_s": P40_SEQUENTIAL * 30 / dt,
                         "p50": st["latency_ms_p50"],
                         "p99": st["latency_ms_p99"],
                         "fill": st["mean_batch_fill"]}
    for kind, clips in (("float32", waves), ("pcm16", pcm)):
        window()
        errors: list = []
        barrier = threading.Barrier(P40_CLIENTS + 1)

        def client(ci):
            barrier.wait()
            for r in range(P40_PER_CLIENT):
                try:
                    svc.tag(clips[(ci + r) % len(clips)], timeout=600)
                except Exception as e:  # reported below, fails the phase
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(P40_CLIENTS)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=600)
        dt = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in threads),
              f"load {kind}: {errors[:3]}")
        st = svc.stats()
        out[kind] = {"audio_s_per_s": P40_CLIENTS * P40_PER_CLIENT * 30 / dt,
                     "p50": st["latency_ms_p50"], "p99": st["latency_ms_p99"],
                     "fill": st["mean_batch_fill"]}
    return out


def _p40_tag_lines(argv: list) -> list:
    """``apps.tag.main(argv)``'s printed lines, in this process."""
    import contextlib
    import io

    from maest_tpu_torch.apps import tag

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(tag.main(argv) == 0, f"tag {argv}")
    return buf.getvalue().splitlines()


def _p40_json(lines: list) -> dict:
    return {d["file"]: d["tags"] for d in map(json.loads, lines)}


def _p40_json_gap(a: dict, b: dict) -> float:
    check(list(a) == list(b) and all(set(a[f]) == set(b[f]) for f in a),
          "tag --json files or labels differ")
    return max(abs(a[f][k] - b[f][k]) for f in a for k in a[f])


def _p40_rank(rank: int, world: int, ckpt: str, wave: np.ndarray,
              requests: list, tag_argv: list, device: str = "cuda") -> dict:
    """One rank of phase 40's mesh (``parallel.launch.spawn`` sets
    torchrun's variables; 2 ranks share the card over gloo): ``MAEST`` at
    dp 2 and at tp 2 on ``wave``; ``tag --devices 2``; a mesh TagService
    at dp 2, rank 0 answering ``requests`` from as many threads, rank 1
    following."""
    sys.path.insert(0, str(ROOT))
    if device == "cuda":
        torch.cuda.set_device(0)
    from maest_tpu_torch import get_maest
    from maest_tpu_torch.parallel import mesh as pmesh
    from maest_tpu_torch.serve import TagService

    pmesh.init_distributed(device)
    out = {"backend": torch.distributed.get_backend()}
    kw = dict(pretrained=False, checkpoint=ckpt, device=device,
              depth=P40_MESH_DEPTH)
    for mp in (1, 2):
        model = get_maest(ARCH, mesh=pmesh.make_mesh(world, mp, device), **kw)
        out[mp] = [t.cpu().numpy() for t in model(wave)]
        del model
    out["tag"] = _p40_tag_lines(tag_argv + ["--devices", str(world)])
    model = get_maest(ARCH, mesh=pmesh.make_mesh(world, 1, device), **kw)
    svc = TagService(model, buckets=(1, 2, 4), max_wait_ms=5.0)
    if svc.follower:
        out["followed"] = svc.follow()
        return out
    got: list = [None] * len(requests)

    def worker(i):
        got[i] = svc.tag(requests[i], timeout=300)[0]

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    svc.close()
    out["served"] = got
    return out


def phase_tagging(dev, gpu, sd):
    """Phase 40: the tagging entry points on the card at full width
    (``discogs-maest-30s-pw-129e``, ViT-B/16, 12 blocks, phase 5's random
    weights). A bf16 TagService whose programs are CUDA graphs, captured at
    warmup (6 buckets x the mel-chunk, wave and pcm16 families): each
    bucket's replay against the eager run (SERVE_TOL), an fp32 model's wave
    buckets 1 and 32 (P40_F32_TOL); phase 7's four requests served through
    graphs against ``predict_labels``; the launches of one replay of every
    bucket by torch.profiler's kernel names (K1 1 a wave or pcm16 batch, K2
    12, the controls 0); a bucket-32 wave batch's copy in (pageable, and
    from pinned memory for comparison), replay and copy out by CUDA events;
    latency under load (scripts/serve_bench.py's shape) with graphs and eagerly in
    alternating rounds. ``python -m maest_tpu_torch.apps.tag`` in processes
    of their own on 3 wavs (30 s at 16 kHz, 95 s and 10 s at 44.1 kHz)
    from an HF AST layout checkpoint (``to_hf_ast_state``): ``--json``
    against ``predict_labels`` on the loaded waves (P40_JSON_TOL),
    ``--embeddings-dir`` against ``model(wave, transformer_block=7)[1]``
    (GOLDEN_TOL). The mesh, 2 ranks over gloo on the card at
    P40_MESH_DEPTH blocks, fp32: ``MAEST`` at dp 2 and tp 2 on a wave of 3
    chunks (padded to 4 rows), ``tag --devices 2`` and a mesh TagService
    answering 4 requests, each held to one process. Returns the launches
    and times for the kernels line."""
    from maest_tpu_torch import get_maest, serve
    from maest_tpu_torch.apps.extract_mel import load_audio
    from maest_tpu_torch.ops.attention import flash_attention
    from maest_tpu_torch.packaging import to_hf_ast_state
    from maest_tpu_torch.parallel.launch import spawn
    from maest_tpu_torch.utils.profiling import KERNEL_TRACES
    from scipy.io import wavfile

    t_phase = time.perf_counter()
    rng = np.random.default_rng(40)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = str(tmp / "random-vitb.pt")
        torch.save(sd, ckpt)
        kw = dict(pretrained=False, checkpoint=ckpt, device=dev)

        # --- graphs against eager, every bucket and family --------------
        model = get_maest(ARCH, dtype=torch.bfloat16, **kw)
        t0 = time.perf_counter()
        svc = serve.TagService(model, max_wait_ms=5.0, warmup=True,
                               warmup_pcm16=True)
        capture_s = time.perf_counter() - t0
        families = (svc.wave_programs, svc.pcm16_programs, svc.programs)
        gaps = {p.kind: _p40_graphs_vs_eager(p, 400) for p in families}
        check(max(gaps.values()) <= SERVE_TOL, f"graphs vs eager {gaps}")
        traced = {p.kind: _p40_replay_kernels(p, 401, K1=int(p.fused_wave),
                                              K2=12) for p in families}
        print(f"phase 40 graphs: {sum(len(p._graphs) for p in families)} "
              f"captured at warmup in {capture_s:.1f} s (buckets "
              f"{svc.wave_programs.buckets} x chunk, wave, pcm16); replay vs "
              f"eager max abs diff " + ", ".join(
                  f"{k} {v:.3e}" for k, v in gaps.items())
              + f" <= {SERVE_TOL}; launches a replayed batch by "
              "torch.profiler's kernel names, one replay of each bucket: "
              + "; ".join(f"{k} " + ", ".join(
                  f"{n} {c}" for n, c in v[max(v)].items()
                  if c and n in P40_KERNELS)
                  + f" (the same in {len(v)} buckets)"
                  for k, v in traced.items())
              + f"; the largest of {KERNEL_TRACES} traces each, "
              f"{sum(c['short'] for v in traced.values() for c in v.values())}"
              f" of {KERNEL_TRACES * sum(map(len, traced.values()))} traces "
              f"lost a record [{gpu}]", flush=True)

        # --- a bucket-32 wave batch step by step -------------------------
        split = _p40_split(svc.wave_programs, _p40_elements(
            svc.wave_programs, 32, 405))
        out["split_ms"] = split
        print(f"phase 40 wave bucket 32 ({split['mb']:.1f} MB a batch) step "
              f"by step, median of {P40_BUCKET_ROUNDS} rounds, CUDA events: "
              f"copy in (pageable, as run) {split['h2d']:.3f} ms, from pinned "
              f"memory {split['h2d_pinned']:.3f}; replay {split['replay']:.3f}"
              f"; copy out {split['d2h']:.3f}; the host's clock over the "
              f"three {split['host']:.3f} ms [{gpu}]", flush=True)

        # --- a wave batch's latency by bucket, replay against eager -----
        bucket_ms = {}
        p = svc.wave_programs
        for b in p.buckets:
            batch = _p40_elements(p, b, 404)
            runs = {"graph": [], "eager": []}
            for _ in range(P40_BUCKET_ROUNDS):
                for name, fn in (("graph", p.run), ("eager", p.eager)):
                    t0 = time.perf_counter()
                    fn(batch)
                    runs[name].append((time.perf_counter() - t0) * 1e3)
            bucket_ms[b] = {k: float(np.median(v)) for k, v in runs.items()}
        out["bucket_ms"] = bucket_ms
        print("phase 40 wave batch, host ms (copy in, forward, copy out; "
              f"median of {P40_BUCKET_ROUNDS} alternating rounds) by bucket, "
              "graph / eager: " + ", ".join(
                  f"{b} {v['graph']:.3f} / {v['eager']:.3f}"
                  for b, v in bucket_ms.items()) + f" [{gpu}]", flush=True)

        # --- phase 7's four requests, served through graphs -------------
        wave_30 = rng.standard_normal(CLIP).astype(np.float32) * 0.1
        wave_95 = rng.standard_normal(95 * SR).astype(np.float32) * 0.1
        reqs = {"native float32": wave_30,
                "native pcm16": (np.clip(wave_30, -1, 1) * 32767).astype(
                    np.int16),
                "95 s float32": wave_95, "10 s": wave_95[:10 * SR]}
        answers: dict = {}

        def ask(name):
            answers[name] = svc.tag(reqs[name], timeout=300)[0]

        threads = [threading.Thread(target=ask, args=(n,)) for n in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(len(answers) == len(reqs), "served requests")
        served = max(float(np.abs(answers[n] - model.predict_labels(x)[0])
                           .max()) for n, x in reqs.items())
        check(served <= SERVE_TOL, f"served vs predict_labels {served}")
        print(f"phase 40 served through graphs: {', '.join(reqs)} at once, "
              f"max abs diff from predict_labels {served:.3e} <= "
              f"{SERVE_TOL}", flush=True)

        # --- latency under load: graphs and eager in alternating rounds --
        waves = [rng.standard_normal(CLIP).astype(np.float32) * 0.1
                 for _ in range(8)]
        pcm = [(np.clip(w, -1, 1) * 32767).astype(np.int16) for w in waves]
        eager = serve.TagService(model, max_wait_ms=5.0)
        for p in (eager.wave_programs, eager.pcm16_programs, eager.programs):
            p.graphs = False
            p.warmup()
        check(not any(p._graphs for p in (
            eager.programs, eager.wave_programs, eager.pcm16_programs)),
              "the eager service captured")
        load = {"graphs": [], "eager": []}
        for order in (("graphs", "eager"), ("eager", "graphs")):
            for name in order:
                load[name].append(_p40_load(
                    svc if name == "graphs" else eager, waves, pcm))
        eager.close()
        for name, rounds in load.items():
            for i, r in enumerate(rounds):
                print(f"phase 40 load {name} round {i + 1}: " + "; ".join(
                    f"{k} {v['audio_s_per_s']:.1f} audio-s/s, p50 "
                    f"{v['p50']:.2f} ms, p99 {v['p99']:.2f} ms, fill "
                    f"{v['fill']:.2f}" for k, v in r.items())
                    + f" [{gpu}]", flush=True)
        out["load"] = load
        out["serve"] = {
            "K1": _p40_serve_launches(
                [p for p in families if p.fused_wave], traced, "K1"),
            "K2": _p40_serve_launches(families, traced, "K2")}
        svc.close()
        del svc, eager, model
        torch.cuda.empty_cache()

        # --- fp32: the wave family's buckets 1 and 32 -------------------
        model = get_maest(ARCH, **kw)
        progs = serve.BucketPrograms(model, (1, 32), fused_wave=True)
        progs.warmup()
        f32 = _p40_graphs_vs_eager(progs, 402)
        check(f32 <= P40_F32_TOL, f"fp32 graphs vs eager {f32}")
        f32_traced = {"wave": _p40_replay_kernels(progs, 403, K1=1,
                                                  K2_fp32=12)}
        out["serve_fp32"] = _p40_serve_launches([progs], f32_traced,
                                                "K2_fp32")
        seen = f32_traced["wave"][32]
        print(f"phase 40 fp32 graphs: wave buckets 1 and 32 replay vs eager "
              f"max abs diff {f32:.3e} <= {P40_F32_TOL}; a replay of each "
              f"runs K1 {seen['K1']}, the tf32 K2 {seen['K2_fp32']}, no "
              f"control ({sum(c['short'] for c in f32_traced['wave'].values())}"
              f" of {2 * KERNEL_TRACES} traces lost a record)", flush=True)
        del progs

        # --- apps/tag.py on an HF AST layout checkpoint -----------------
        files = [(tmp / "a16k.wav", 16000, 30.0), (tmp / "b44k.wav", 44100,
                                                    95.0),
                 (tmp / "c44k.wav", 44100, 10.0)]
        for path, sr, sec in files:
            wavfile.write(path, sr, (rng.standard_normal(int(sr * sec))
                                     * 0.1).astype(np.float32))
        paths = [str(p) for p, _, _ in files]
        ast_ckpt = str(tmp / "ast.pt")
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in to_hf_ast_state(
                        {k: t.numpy() for k, t in sd.items()}).items()},
                   ast_ckpt)
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "maest_tpu_torch.apps.tag", *paths,
               "--checkpoint", ast_ckpt, "--device", dev.type]
        procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in (cmd + ["--json", "--top-k", "400"],
                           cmd + ["--embeddings-dir", str(tmp / "emb"),
                                  "--block", str(P40_BLOCK)])]
        try:
            res = [p.communicate(timeout=P40_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
        tag_s = time.perf_counter() - t0
        for p, (so, se) in zip(procs, res):
            check(p.returncode == 0, f"apps.tag exited {p.returncode}: "
                  f"{se[-2000:]}")
        tags = _p40_json(res[0][0].splitlines())
        loaded = {p: load_audio(Path(p)) for p in paths}
        json_gap = max(
            float(np.abs(np.array([tags[p][label] for label in model.labels])
                         - model.predict_labels(w)[0]).max())
            for p, w in loaded.items())
        check(json_gap <= P40_JSON_TOL, f"tag --json vs predict_labels "
              f"{json_gap}")
        emb_gap = 0.0
        with torch.inference_mode():
            for p, w in loaded.items():
                got = np.load(tmp / "emb" / (Path(p).stem + ".embeddings.npy"))
                want = model(w, transformer_block=P40_BLOCK)[1].cpu().numpy()
                check(got.shape == want.shape, f"embeddings {got.shape}")
                emb_gap = max(emb_gap, float(np.abs(got - want).max()))
        check(emb_gap <= GOLDEN_TOL, f"tag --embeddings-dir {emb_gap}")
        import importlib.util

        if importlib.util.find_spec("safetensors") is None:
            st = "the .safetensors case skipped: no safetensors here"
        else:
            from safetensors.torch import save_file

            st_path = str(tmp / "ast.safetensors")
            save_file(torch.load(ast_ckpt), st_path)
            m2 = get_maest(ARCH, pretrained=False, checkpoint=st_path,
                           device=dev)
            g = float(np.abs(m2.predict_labels(wave_30)[0] - model
                             .predict_labels(wave_30)[0]).max())
            check(g <= GOLDEN_TOL, f"AST .safetensors {g}")
            st = f"the .safetensors AST file {g:.3e} from the .pt"
            del m2
        print(f"phase 40 apps.tag: 2 processes ({tag_s:.1f} s) on 30 s at 16 "
              f"kHz, 95 s and 10 s at 44.1 kHz from an HF AST layout .pt: "
              f"--json vs predict_labels on the loaded waves {json_gap:.3e} "
              f"<= {P40_JSON_TOL}; --embeddings-dir vs model(wave, "
              f"transformer_block=7)[1] {emb_gap:.3e} <= {GOLDEN_TOL}; {st}",
              flush=True)
        del model
        torch.cuda.empty_cache()

        # --- the mesh: 2 ranks over gloo on the card ---------------------
        one = get_maest(ARCH, depth=P40_MESH_DEPTH, **kw)
        wave = rng.standard_normal(3 * CLIP + SR).astype(np.float32) * 0.1
        ref = [t.cpu().numpy() for t in one(wave)]
        requests = list(reqs.values())
        want = [one.predict_labels(r)[0] for r in requests]
        tag_argv = [*paths, "--checkpoint", ckpt, "--json", "--top-k", "400",
                    "--depth", str(P40_MESH_DEPTH), "--device", dev.type]
        tag_one = _p40_json(_p40_tag_lines(tag_argv))
        del one
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn(_p40_rank, 2, ckpt, wave, requests, tag_argv,
                      dev.type, timeout=P40_TIMEOUT)
        mesh_s = time.perf_counter() - t0
        lead, follower = ranks
        check(all(r["backend"] == "gloo" for r in ranks), "mesh backend")
        mesh_gap = {}
        for mp, name in ((1, "dp 2"), (2, "tp 2")):
            for r in ranks:
                check(all(a.shape == b.shape for a, b in zip(r[mp], ref)),
                      f"{name} shapes")
            mesh_gap[name] = max(float(np.abs(a - b).max())
                                 for r in ranks for a, b in zip(r[mp], ref))
        check(max(mesh_gap.values()) <= GOLDEN_TOL, f"mesh {mesh_gap}")
        tag_gap = _p40_json_gap(_p40_json(lead["tag"]), tag_one)
        check(tag_gap <= P40_JSON_TOL and follower["tag"] == [],
              f"tag --devices 2 {tag_gap}")
        svc_gap = max(float(np.abs(g - w).max())
                      for g, w in zip(lead["served"], want))
        check(svc_gap <= GOLDEN_TOL and follower["followed"] >= 3,
              f"mesh service {svc_gap}, {follower.get('followed')}")
        print(f"phase 40 mesh: 2 ranks over gloo on the card ({mesh_s:.1f} "
              f"s, each rank's start included), fp32 at {P40_MESH_DEPTH} "
              f"blocks: MAEST on a wave of 3 chunks (4 rows padded) vs one "
              f"process, logits and features max abs diff " + ", ".join(
                  f"{k} {v:.3e}" for k, v in mesh_gap.items())
              + f" <= {GOLDEN_TOL}; tag --devices 2 vs --devices 1 "
              f"{tag_gap:.3e} <= {P40_JSON_TOL}; the mesh TagService's 4 "
              f"answers vs predict_labels {svc_gap:.3e} <= {GOLDEN_TOL} "
              f"(rank 1 ran {follower['followed']} batches)", flush=True)
    print(f"phase 40 time: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# phase 41: the last slice's modules at full width
SURGERY_GOLDENS = {"per_freq": "vitb_30s_per_freq_logits",
                   "non_distilled": "vitb_30s_non_distilled_logits"}
SURGERY_WAVE_S = 120   # 4 chunks of 30 s: one mel call, one forward
SURGERY_BATCH = 8      # the train step's batch (N 866 / 865)
SURGERY_STEP_RTOL = 1e-2  # bf16 loss, kernels vs the plain attention route
RELEASE_TOL = 1e-5     # exported weights' probabilities vs the Trainer's eval
TL_TOL = 1e-4          # tl_pipeline's metrics on the card vs the CPU


def _surgery_counters():
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.ops import mel_kernel as M
    return {"K1": M.fused_logmel_from_frames, "K2": A.flash_attention,
            "K3a": A.flash_attention_fwd_lse, "K3b": A.attention_bwd,
            "fused_logmel_fma": M.fused_logmel_from_frames_fma,
            "attention_fwd_mma": A.attention_fwd_mma,
            "attention_bwd_mma": A.attention_bwd_mma,
            "attention_fwd_fp32_fma": A.attention_fwd_fp32_fma,
            "attention_bwd_fp32_fma": A.attention_bwd_fp32_fma}


def _tl_fixture(root: Path) -> dict:
    """tests/test_torch_release_apps.py's embeddings fixture (two latent
    clusters, 6 classes, token 16) and the probe's config for it."""
    import pickle

    from maest_tpu_torch.apps import ex_tl

    emb_dir = root / "emb"
    emb_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    protos = rng.standard_normal((2, 48)).astype("float32") * 2
    for split, n in (("train", 40), ("validation", 16), ("test", 16)):
        gt = {}
        for i in range(n):
            name = f"{split}{i}.mp3"
            np.save(emb_dir / (name + ".embeddings.npy"), protos[i % 2]
                    + rng.standard_normal((3, 48)).astype("float32") * 0.3)
            y = np.zeros(6, dtype="float32")
            y[i % 2::2] = 1.0
            gt[name] = y
        with open(root / f"groundtruth-{split}.pk", "wb") as f:
            pickle.dump(gt, f)
    cfg = ex_tl.default_config()
    cfg["trainer"]["max_epochs"] = 8
    cfg["optimizer"].update(max_epochs=8, warmup_epochs=1, max_lr=1e-2,
                            max_lr_epochs=2)
    cfg["model"]["hidden_units"] = 32
    cfg["data"].update(base_dir=str(emb_dir), metadata_dir=str(root),
                       batch_size=8, token_size=16, n_classes=6)
    return cfg


def phase_surgery(dev, gpu, cases: dict, cli_run: Path):
    """Phase 41: the modules of the last slice at full width (the 30 s
    ViT-B, random weights from the goldens' seeds). The per-frequency and
    the non-distilled model: ``predict_labels`` of a 120 s wave (4 chunks)
    in fp32 and bf16, the launch counters reset before each call (K1 1 and
    K2 12 a call, the controls 0), bf16 within TIER_TOL of fp32; one bf16
    train step each (fp32 parameters, batch SURGERY_BATCH, 90 of the 186
    time columns dropped by the same draws) through the kernels (K3a and
    K3b 12, the controls 0) and on the plain attention route
    (``attention_impl="xla"``, no kernel), the losses within
    SURGERY_STEP_RTOL; K2 (bf16, fp32) at (4, 1675) and K3a, K3b at
    (SURGERY_BATCH, 865) against their plain versions (ATTN_TOL, LSE_TOL).
    ``export_release --format torch`` (on the card, its
    default) of phase 37's epoch-1 checkpoint, reloaded by ``get_maest``,
    against the fp32 Trainer's eval of the same weights within
    RELEASE_TOL; ``ex_tl.tl_pipeline`` on the card against its CPU run
    within TL_TOL. Returns the launches of every call and the phase's
    seconds."""
    from maest_tpu_torch.api import MAEST, get_maest
    from maest_tpu_torch.apps import ex_tl, export_release
    from maest_tpu_torch.checkpoints import load_into
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.train import (
        AugmentConfig,
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from maest_tpu_torch.train import loop

    t_phase = time.perf_counter()
    counters = _surgery_counters()

    def reset():
        for c in counters.values():
            c.launches = 0

    def read():
        return {k: c.launches for k, c in counters.items()}

    def exact(got, want, what):
        check(all(n == want.get(k, 0) for k, n in got.items()),
              f"{what}: launches {got}, wanted {want} and no other")

    launches = {}
    rng = np.random.default_rng(41)
    wave = rng.standard_normal(SURGERY_WAVE_S * SR).astype(np.float32) * 0.1
    tier = {}
    for kind, name in SURGERY_GOLDENS.items():
        cfg, state = cases[name]
        acts = {}
        for dt in ("float32", "bfloat16"):
            net = load_into(MAESTNet(cfg, dtype=getattr(torch, dt),
                                     device=dev), state)
            model = MAEST(cfg, net)
            reset()
            acts[dt] = model.predict_labels(wave)[0]
            torch.cuda.synchronize()
            launches[f"{kind} {dt} predict_labels"] = got = read()
            exact(got, {"K1": 1, "K2": cfg.depth}, f"{kind} {dt} tagging")
            check(acts[dt].shape == (cfg.num_classes,)
                  and bool(np.isfinite(acts[dt]).all()), f"{kind} {dt} acts")
            del model, net
        tier[kind] = float(np.abs(acts["bfloat16"] - acts["float32"]).max())
        check(tier[kind] <= TIER_TOL, f"{kind}: bf16 vs fp32 {tier[kind]}")

    x = torch.from_numpy(rng.standard_normal(
        (SURGERY_BATCH, 96, 1875)).astype(np.float32) * 1.3 + 2.0).to(dev)
    y = torch.from_numpy((rng.random((SURGERY_BATCH, 400)) < 0.05).astype(
        np.float32)).to(dev)
    steps = {}
    for kind, name in SURGERY_GOLDENS.items():
        cfg, state = cases[name]
        for route, impl in (("kernels", "auto"), ("plain", "xla")):
            net = load_into(MAESTNet(
                cfg.replace(s_patchout_t=90, attention_impl=impl),
                dtype=torch.bfloat16, param_dtype=torch.float32, device=dev),
                state)
            tx = make_optimizer(lr_schedule=1e-4)
            step = make_train_step(net, tx, AugmentConfig(masking=False,
                                                          mixup_alpha=0.0))
            st = TrainState.create(net, tx, with_swa=False)
            reset()
            st, m = step(st, {"x": x, "y": y}, torch.Generator().manual_seed(41))
            torch.cuda.synchronize()
            launches[f"{kind} train step {route}"] = got = read()
            exact(got, {"K3a": cfg.depth, "K3b": cfg.depth}
                  if route == "kernels" else {}, f"{kind} {route} step")
            steps[(kind, route)] = float(m["train_loss"])
            check(np.isfinite(steps[(kind, route)])
                  and m["nonfinite_skipped"] == 0.0, f"{kind} {route} step")
            del net, st, step, tx
        rel = abs(steps[(kind, "kernels")] - steps[(kind, "plain")]) / abs(
            steps[(kind, "plain")])
        check(rel <= SURGERY_STEP_RTOL, f"{kind} step loss rel err {rel}")
        steps[kind] = rel
    torch.cuda.empty_cache()

    # the kernels against their plain versions at the non-distilled
    # shapes: K2 at (4, 1675) in bf16 and fp32 (the tagging forward), K3a
    # and K3b at (SURGERY_BATCH, 865) in bf16 (the train step)
    kerr = {}
    for n, dtypes, train in ((1675, ("bfloat16", "float32"), False),
                             (865, ("bfloat16",), True)):
        b_ = SURGERY_BATCH if train else 4
        for dt in dtypes:
            q, k, v, g = torch.from_numpy(rng.standard_normal(
                (b_, n, 4, 12, 64)).astype(np.float32)).to(
                    dev, getattr(torch, dt)).unbind(2)
            tol = ATTN_TOL[dt]
            if not train:
                e = {"o": max_err(A.flash_attention(q, k, v),
                                  A.attention_reference(q, k, v))}
            else:
                o, lse = A.flash_attention_fwd_lse(q, k, v)
                ro, rlse = A.attention_reference_lse(q, k, v)
                e = {"o": max_err(o, ro), "lse": max_err(lse, rlse)}
                e.update(zip(("dq", "dk", "dv"), map(max_err, A.attention_bwd(
                    q, k, v, ro, rlse, g), A.attention_bwd_reference(
                        q, k, v, ro, rlse, g))))
                check(e["lse"] <= LSE_TOL, f"K3a lse N{n} {e['lse']}")
            check(all(x <= tol for w, x in e.items() if w != "lse"),
                  f"the kernels at ({b_}, {n}) {dt}: {e}")
            kerr[(n, dt)] = e
    torch.cuda.synchronize()

    # export_release of phase 37's checkpoint, back through get_maest
    ckpt = cli_run / "checkpoints" / "epoch-1"
    out = cli_run / "release.pt"
    check(export_release.main([str(ckpt), "--format", "torch", "--out",
                               str(out)]) == 0, "export_release")
    _, which = export_release.select_params(
        export_release.load_training_checkpoint(str(ckpt)), swa=True)
    run_cfg = export_release.run_config_for(str(ckpt))
    mc = run_cfg["maest"]
    m = get_maest(arch=mc["arch"], pretrained=False, checkpoint=str(out),
                  device=dev, n_classes=mc["n_classes"],
                  input_t=mc["input_t"], embed_dim=mc["embed_dim"],
                  depth=mc["depth"], num_heads=mc["num_heads"])
    run_cfg["trainer"]["precision"] = "fp32"
    trainer = loop.Trainer(run_cfg, run_dir=str(cli_run / "eval"), device=dev)
    trainer.restore_checkpoint(str(ckpt))
    xm = torch.from_numpy(rng.standard_normal((4, 96, mc["input_t"])).astype(
        np.float32) * 1.3 + 2.0).to(dev)
    ref = torch.sigmoid(trainer.eval_step(trainer.state, xm)[
        "swa" if which == "swa" else ""])
    aug = trainer.aug
    reset()
    got = torch.sigmoid(m((xm - aug.norm_mean) / (aug.norm_std * 2.0))[0])
    torch.cuda.synchronize()
    launches["export_release get_maest"] = n = read()
    exact(n, {"K2": mc["depth"]}, "the exported model's forward")
    release_gap = max_err(got, ref)
    check(release_gap <= RELEASE_TOL, f"export_release {release_gap}")
    del trainer, m

    # the transfer-learning probe on the card against its CPU run
    tl_cfg = _tl_fixture(cli_run / "tl")
    tl = {d: ex_tl.tl_pipeline(tl_cfg, device=d) for d in (dev, "cpu")}
    tl_gap = max(abs(tl[dev][k] - tl["cpu"][k]) for k in tl["cpu"])
    check(tl[dev]["test_roc"] > 0.9 and tl_gap <= TL_TOL,
          f"tl_pipeline on the card {tl[dev]}, on the CPU {tl['cpu']}")
    secs = time.perf_counter() - t_phase
    print(f"phase 41 surgery: 30 s ViT-B per-frequency and non-distilled, "
          f"predict_labels of {SURGERY_WAVE_S} s (4 chunks) in fp32 and bf16:"
          f" bf16 vs fp32 {', '.join(f'{k} {v:.3e}' for k, v in tier.items())}"
          f" <= {TIER_TOL}; one bf16 train step (B{SURGERY_BATCH}, N 866 / "
          f"865) kernels vs plain attention: losses "
          + ", ".join(f"{k} {steps[(k, 'kernels')]:.6f} / "
                      f"{steps[(k, 'plain')]:.6f} (rel {steps[k]:.2e})"
                      for k in SURGERY_GOLDENS)
          + f" <= {SURGERY_STEP_RTOL}; the kernels against plain at the "
          "non-distilled shapes: " + "; ".join(
              f"N {n} {dt} " + ", ".join(f"{w} {x:.3e}" for w, x in e.items())
              for (n, dt), e in kerr.items())
          + f" (bounds {ATTN_TOL}, lse {LSE_TOL}); export_release --format torch of "
          f"phase 37's epoch-1 ({which}) through get_maest vs the Trainer's "
          f"fp32 eval {release_gap:.3e} <= {RELEASE_TOL}; tl_pipeline on the "
          f"card {tl[dev]} vs the CPU within {tl_gap:.3e} <= {TL_TOL}; "
          f"launches {launches}; {secs:.1f} s [{gpu}]", flush=True)
    return {"launches": launches, "seconds": secs,
            "err": {"K2": max(kerr[(1675, "bfloat16")].values()),
                    "K2_fp32": max(kerr[(1675, "float32")].values()),
                    "K3a": max(kerr[(865, "bfloat16")][w] for w in ("o", "lse")),
                    "K3b": max(kerr[(865, "bfloat16")][w]
                               for w in ("dq", "dk", "dv"))}}


def _d256_rel(got, want) -> float:
    """The largest of each gradient's max|got - want| over max(1, its max
    |want|)."""
    return max(max_err(a, z) / max(1.0, z.float().abs().max().item())
               for a, z in zip(got, want))


def _d256_schedule(q, k, v, o, lse, do, n_real):
    """The head_dim-256 kernels' plain version on the route's inputs:
    ``attention_bwd_tiled_reference`` at their tiles on the inputs
    zero-padded to 256 with the unpadded head_dim's scale, sliced back."""
    from maest_tpu_torch.ops import attention as A

    d = q.shape[-1]
    (qp, kp, vp, op, dop), scale = A.pad_head_dim(q, k, v, o, do)
    grads = A.attention_bwd_tiled_reference(
        qp, kp, vp, op, lse, dop, n_real, scale,
        key_tile=A.BWD_D256_KEY_TILE, q_tile=A.BWD_D256_Q_TILE)
    return tuple(g[..., :d] for g in grads)


def _d256_planted_inputs(dev):
    """Phase 42's planted fault's (2, 256, 4, 3, 256) bf16 q/k/v/do, drawn
    from seed 42: the last 64-row q tile is a quarter of every key's
    rows."""
    gen = torch.Generator(device=dev).manual_seed(42)
    return torch.randn((2, 256, 4, 3, 256), generator=gen, device=dev).to(
        torch.bfloat16)


def _d256_gap(x) -> float:
    """``_d256_rel`` of the route (``attention_bwd``) against its plain
    version on ``_d256_planted_inputs`` at n_real 250."""
    from maest_tpu_torch.ops import attention as A

    q, k, v, do = x.unbind(2)
    o, lse = A.flash_attention_fwd_lse(q, k, v, 250)
    return _d256_rel(A.attention_bwd(q, k, v, o, lse, do, 250),
                     _d256_schedule(q, k, v, o, lse, do, 250))


def phase_bwd_d256(dev, gpu, planted_gap):
    """Phase 42: K3b at head_dim 256 on wgmma (``csrc/attn_bwd_d256_wgmma.cuh``,
    the route of ``maest_attn_bwd_bf16_d256``: the prep pass, the dk/dv and
    the dq kernel) beside its mma.sync control (``attention_bwd_mma`` at
    256, entry ``maest_attn_bwd_bf16_d256_mma``) and SDPA. At
    D256_BWD_SHAPES, on strided views of one fused q/k/v/do: the route
    (``attention_bwd``, each launch counted) within D256_REL_TOL of its
    plain version (the tiled schedule) and of plain, two launches
    torch.equal, masked dk and dv exactly zero; the control (reached
    through ``_K3B_CONTROL``, zero-padded at 192 as the route) within the
    same bound of plain. Then the kernels built with dV's last q tile left
    out (``planted_gap``, their ``_d256_gap`` from phase 31's planted
    process, whose library holds this fault too): refused. Then CUDA-graph replays
    of the route, the control and SDPA's backward (the aten flash op
    alone) in D256_ROUNDS interleaved rounds at (32, 866, 3, 256), every
    round printed, SDPA's fwd+bwd - fwd and plain by events; then the 30 s
    recipe step at num_heads 3 (heads drawn so the loss is not ln 2) with
    each backward in turn, the control through ``_K3B_CONTROL``, CUDA events
    over 3 steps a round after one, the launch counters checked on each,
    the first loss off ln 2 and the last below the first. Returns the errors, the
    medians and the launches."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.probes.attn_profile import graph_rounds

    out = {"err": dict.fromkeys(("route", "control"), 0.0),
           "abs": dict.fromkeys(("route", "control"), 0.0), "ms": {},
           "launches": {}}
    gen = torch.Generator(device=dev).manual_seed(42)
    tol = D256_REL_TOL
    for b, n, n_real, heads, d in D256_BWD_SHAPES:
        x = torch.randn((b, n, 4, heads, d), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v, do = x.unbind(2)
        o, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
        before = (A.attention_bwd.launches, A.attention_bwd_mma.launches)
        g = A.attention_bwd(q, k, v, o, lse, do, n_real)
        again = A.attention_bwd(q, k, v, o, lse, do, n_real)
        A._K3B_CONTROL = True
        try:
            c = A.attention_bwd(q, k, v, o, lse, do, n_real)
        finally:
            A._K3B_CONTROL = False
        r = A.attention_bwd_reference(q, k, v, o, lse, do, n_real)
        tr = _d256_schedule(q, k, v, o, lse, do, n_real)
        torch.cuda.synchronize()
        check((A.attention_bwd.launches - before[0],
               A.attention_bwd_mma.launches - before[1]) == (2, 1),
              "K3b D = 256 counters")
        e, et, ec = _d256_rel(g, r), _d256_rel(g, tr), _d256_rel(c, r)
        same = all(torch.equal(a, z) for a, z in zip(g, again))
        zero = n_real is None or not (g[1][:, n_real:].any()
                                      or g[2][:, n_real:].any())
        check(e <= tol and et <= tol and ec <= tol and same and zero,
              f"K3b D = 256 ({b}, {n}, {heads}, {d}) n_real {n_real}: vs "
              f"plain {e}, vs tiled {et}, control {ec}, deterministic {same}, "
              f"masked zero {zero}")
        for key, val in (("route", max(e, et)), ("control", ec)):
            out["err"][key] = max(out["err"][key], val)
        for key, grads in (("route", g), ("control", c)):
            out["abs"][key] = max(out["abs"][key], max(
                max_err(a, z) for a, z in zip(grads, r)))
        print(f"phase 42 K3b at head_dim {d} ({b}, {n}, {heads}, {d}) n_real "
              f"{n_real}{' zero-padded to 256' * (d < 256)} strided: "
              f"relative err vs plain {e:.3e}, vs the tiled plain version "
              f"{et:.3e}, the control vs plain {ec:.3e} <= {tol}; two "
              f"launches torch.equal: {same}; masked dk/dv exactly 0: {zero}",
              flush=True)
        del x, q, k, v, do, o, lse, g, again, c, r, tr
        torch.cuda.empty_cache()

    # the planted fault: dV misses the last q tile's 64 rows of 256
    sound, bad = _d256_gap(_d256_planted_inputs(dev)), planted_gap
    check(sound <= tol < bad, f"planted dV last tile {bad}, sound {sound}")
    print(f"phase 42 planted fault, the head_dim-256 wgmma backward built "
          f"with dV's last q tile left out, at (2, 256, 3, 256) n_real 250: "
          f"relative err vs the tiled plain version {bad:.3e} > {tol}: "
          f"refused (the sound kernels {sound:.3e})", flush=True)

    x = torch.randn((BATCH, 866, 4, 3, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v, do = x.unbind(2)
    o, lse = A.flash_attention_fwd_lse(q, k, v)
    fns = {"wgmma": lambda: A.attention_bwd(q, k, v, o, lse, do),
           "control": lambda: A.attention_bwd_mma(q, k, v, o, lse, do),
           "sdpa": sdpa_bwd_call(q, k, v, do)}
    runs = graph_rounds(fns, 10, dev, D256_ROUNDS)
    for rnd in range(D256_ROUNDS):
        print(f"phase 42 K3b ({BATCH}, 866, 3, 256) round {rnd + 1} "
              f"CUDA-graph ms: " + ", ".join(
                  f"{key} {ms[rnd]:.4f}" for key, ms in runs.items())
              + f" [{gpu}]", flush=True)
    med = {key: float(np.median(ms)) for key, ms in runs.items()}
    every = all(w < c for w, c in zip(runs["wgmma"], runs["control"]))
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    gs = do.transpose(1, 2)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd = cuda_ms_median(lambda: F.scaled_dot_product_attention(
            qs, ks, vs), 10)
        med["sdpa_fwd_bwd"] = cuda_ms_median(
            lambda: F.scaled_dot_product_attention(qs, ks, vs).backward(gs),
            10) - fwd
    med["plain"] = cuda_ms(
        lambda: A.attention_bwd_reference(q, k, v, o, lse, do), 1)
    out["ms"][(BATCH, 866)] = med
    print(f"phase 42 K3b ({BATCH}, 866, 3, 256) medians: wgmma "
          f"{med['wgmma']:.4f} ms, control {med['control']:.4f} "
          f"({med['control'] / med['wgmma']:.2f}x), SDPA's backward alone "
          f"{med['sdpa']:.4f}, SDPA fwd+bwd - fwd {med['sdpa_fwd_bwd']:.4f} "
          f"(events), plain {med['plain']:.4f} (events); the wgmma kernels "
          f"beat the control in every round: {every} [{gpu}]", flush=True)
    del x, q, k, v, do, o, lse, qs, ks, vs, gs, fns
    torch.cuda.empty_cache()

    # the 30 s recipe step at num_heads 3 with each backward, in turn
    _, mcfg, net, state, step, data = _recipe(
        dev, RECIPE, BATCH, 42, ["maest.num_heads=3"])
    drawn = torch.Generator(device=dev).manual_seed(42)
    with torch.no_grad():  # zero heads give loss ln 2 and do = 0
        for lin in (net.head[1], net.head_dist):
            lin.weight.normal_(0.0, 0.05, generator=drawn)
    gen_step = torch.Generator().manual_seed(42)
    losses = []

    def one():
        _, metrics = step(state, data, gen_step)
        losses.append(metrics["train_loss"])

    counts = (A.attention_bwd, A.attention_bwd_mma)
    step_ms = {"wgmma": [], "control": []}
    try:
        for rnd in range(D256_ROUNDS):
            for route in (("wgmma", "control") if rnd % 2 == 0
                          else ("control", "wgmma")):
                A._K3B_CONTROL = route == "control"
                for f in counts:
                    f.launches = 0
                step_ms[route].append(cuda_ms(one, 3))
                got = tuple(f.launches for f in counts)
                want = ((0, 4 * mcfg.depth) if A._K3B_CONTROL
                        else (4 * mcfg.depth, 0))
                check(got == want, f"recipe step at num_heads 3 with the "
                      f"{route}: launches {got}")
                out["launches"][route] = got
            print(f"phase 42 {RECIPE} B{BATCH} at num_heads 3 round {rnd + 1} "
                  f"(CUDA events, ms a step): " + ", ".join(
                      f"with the {r} {ms[-1]:.3f}" for r, ms in
                      step_ms.items()) + f" [{gpu}]", flush=True)
    finally:
        A._K3B_CONTROL = False
    # the drawn heads keep the first loss off ln 2; the steps repeat one
    # batch, so the loss falls (through ln 2 on the way)
    check(all(np.isfinite(losses)) and abs(losses[0] - np.log(2)) > 1e-3
          and losses[-1] < losses[0], f"recipe losses {losses}")
    for route, ms in step_ms.items():
        out["ms"][("recipe", route)] = float(np.median(ms))
    gap = out["ms"][("recipe", "control")] - out["ms"][("recipe", "wgmma")]
    print(f"phase 42 {RECIPE} B{BATCH} at num_heads 3 (head_dim 256), "
          f"medians of {D256_ROUNDS} rounds: "
          f"{out['ms'][('recipe', 'wgmma')]:.3f} ms a step with the wgmma "
          f"backward against {out['ms'][('recipe', 'control')]:.3f} with the "
          f"control, a gap of {gap:.3f} ms against 12 x the kernel gap "
          f"{12 * (med['control'] - med['wgmma']):.3f}; the loss fell from "
          f"{losses[0]:.6f} (not ln 2) to {losses[-1]:.6f} over "
          f"{len(losses)} steps on one batch; launches a round (K3b, "
          f"control) {out['launches']} [{gpu}]", flush=True)
    del net, state, step, data
    torch.cuda.empty_cache()
    return out


def _d128_cfg(cfg, q, k, v, n_real=None, with_lse=False):
    """The head_dim-128 wgmma kernel in sweep configuration ``cfg``
    (WG128_CONFIGS), (o, lse or None)."""
    from maest_tpu_torch.ops import attention as A

    return A.launch_fwd_entry("attention_fwd",
                              "maest_attn_fwd_bf16_d128_wgmma", (cfg,), q, k,
                              v, n_real, with_lse, q.shape[-1]**-0.5)


def _d128_planted_inputs(dev):
    """Phase 43's planted fault's (2, 500, 3, 6, 128) bf16 q/k/v, N(0, 1),
    drawn from seed 43."""
    gen = torch.Generator(device=dev).manual_seed(43)
    return torch.randn((2, 500, 3, 6, 128), generator=gen, device=dev).to(
        torch.bfloat16)


def _d128_checks(dev, out):
    """Phase 43's checks at D128_SHAPES on strided views of a fused qkv: K2
    and K3a (the route, each launch counted) within ATTN_TOL and LSE_TOL of
    plain, the two outputs equal; at head_dim 128 the control
    (``attention_fwd_mma``) within the same bounds, every sweep
    configuration too, the production one equal to the route and the
    64-key ones equal to the control. Worst errors into ``out["err"]``."""
    from maest_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(43)
    tol = ATTN_TOL["bfloat16"]
    counted = (A.flash_attention, A.flash_attention_fwd_lse,
               A.attention_fwd_mma)
    for b, n, n_real, d in D128_SHAPES:
        x = torch.randn((b, n, 3, 6, d), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = x.unbind(2)
        before = [f.launches for f in counted]
        with torch.inference_mode():
            o = A.flash_attention(q, k, v, n_real=n_real)
        ol, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
        r, rl = A.attention_reference_lse(q, k, v, n_real)
        e, el = max_err(o, r), max_err(lse, rl)
        check(e <= tol and el <= LSE_TOL and torch.equal(o, ol),
              f"D = 128 route ({b}, {n}, 6, {d}) n_real {n_real}: o {e}, "
              f"lse {el}")
        out["err"]["K2"] = max(out["err"]["K2"], e)
        out["err"]["K3a"] = max(out["err"]["K3a"], e, el)
        text = ""
        if d == 128:
            c, cl = A.attention_fwd_mma(q, k, v, n_real, with_lse=True)
            ec, ecl = max_err(c, r), max_err(cl, rl)
            check(ec <= tol and ecl <= LSE_TOL,
                  f"D = 128 control ({b}, {n}): o {ec}, lse {ecl}")
            out["err"]["control"] = max(out["err"]["control"], ec)
            out["err"]["control_lse"] = max(out["err"]["control_lse"], ec,
                                            ecl)
            sweep = 0.0
            for cfg, name in enumerate(WG128_CONFIGS):
                oc, lc = _d128_cfg(cfg, q, k, v, n_real, True)
                torch.cuda.synchronize()
                es, esl = max_err(oc, r), max_err(lc, rl)
                check(es <= tol and esl <= LSE_TOL,
                      f"D = 128 {name} ({b}, {n}): o {es}, lse {esl}")
                if cfg == wg128_production(n_real or n):
                    check(torch.equal(oc, ol) and torch.equal(lc, lse),
                          f"D = 128 config {name} is the route at {n}")
                if name.startswith("64x"):
                    check(torch.equal(oc, c) and torch.equal(lc, cl),
                          f"D = 128 {name} ({b}, {n}) differs from the "
                          "control")
                sweep = max(sweep, es)
            text = (f"; the control vs plain o {ec:.3e}, lse {ecl:.3e}; every "
                    f"sweep configuration vs plain <= {sweep:.3e}, the route "
                    f"torch.equal to {WG128_CONFIGS[wg128_production(n_real or n)]}"
                    ", the 64-key ones to the control")
            del c, cl
        torch.cuda.synchronize()
        grew = [f.launches - c0 for f, c0 in zip(counted, before)]
        check(grew == [1, 1, int(d == 128)], f"D = 128 counters {grew}")
        print(f"phase 43 K2/K3a ({b}, {n}, 6, {d}) n_real {n_real}"
              f"{' zero-padded to 128' * (d < 128)} strided: route vs plain "
              f"o {e:.3e} <= {tol}, lse {el:.3e} <= {LSE_TOL}, K2 torch.equal "
              f"to K3a's o" + text, flush=True)
        del x, q, k, v, o, ol, lse, r, rl
        torch.cuda.empty_cache()


def phase_d128_wgmma(dev, gpu, planted_lib, fwd_log):
    """Phase 43: K2/K3a at head_dim 128 on wgmma (``csrc/attn_fwd_wgmma.cuh``
    at D = 128, the route of ``maest_attn_fwd_bf16_d128``: two consumer
    warpgroups taking turns, 80- or 96-key tiles by ``wg128_key_tile``, a
    ring of two stages) beside its mma.sync control (``attention_fwd_mma``
    at 128, entry ``maest_attn_fwd_bf16_d128_mma``) and SDPA. The D = 128
    instances' registers and spills (``fwd_log``, ptxas) and SASS (HGMMA,
    UTMALDG, no HMMA); ``_d128_checks``; the kernel built with S over the
    first 64 dimensions only (``planted_lib``), in a process of its own,
    refused by the bound against plain. Then CUDA-graph replays of the
    route, the control, SDPA and every sweep configuration in D128_ROUNDS
    interleaved rounds at K2's (32, 1676, 6, 128) and K3a's (32, 866, 6,
    128), every round printed, plain by events; then the batch-32 30 s bf16
    tagging step of ``get_maest(embed_dim=768, num_heads=6)`` and the 30 s
    recipe step at num_heads 6 (heads drawn so the loss is not ln 2) with
    the route and the control (``_K2_CONTROL``) in D128_ROUNDS alternating
    rounds, CUDA events over 3 steps a round after one, the launch
    counters checked on each, each gap set beside 12 x the kernel gap.
    Returns the errors, the medians and the launches."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from maest_tpu_torch import get_maest
    from maest_tpu_torch.ops import _build
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.probes.attn_profile import graph_rounds
    from maest_tpu_torch.serve import BucketPrograms

    out = {"err": dict.fromkeys(("K2", "K3a", "control", "control_lse"), 0.0),
           "ms": {}, "launches": {}}
    rows = [r for r in ptxas_rows(fwd_log) if re.search(
        r"attn_fwd_wgmma_kernel<\d+, \d+, \w+, \w+, \d+, 128,", r)]
    sass = {k: c for k, c in sass_kinds(_build.build("attention_fwd")[0],
                                        "attn_fwd_wgmma_kernel").items()
            if re.search(r", 128, \d+>$", k)}
    check(len(sass) == len(WG128_CONFIGS) and all(
        c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0
        for c in sass.values()),
        f"wgmma/TMA instructions of the head_dim-128 kernels {sass}")
    check(not rows or len(rows) == len(WG128_CONFIGS) and all(
        r.endswith("spills 0/0 bytes") for r in rows),
        f"the head_dim-128 wgmma kernels spill: {rows}")
    print("phase 43 the head_dim-128 wgmma instances (HGMMA = bf16 wgmma, "
          "UTMALDG = TMA load, HMMA = mma.sync): " + "; ".join(
              f"{k}: " + ", ".join(f"{c[g]} {g}" for g in (
                  "HGMMA", "UTMALDG", "HMMA")) + f" of {c['instructions']} "
              "instructions" for k, c in sorted(sass.items()))
          + "; ptxas: " + "; ".join(rows), flush=True)
    _d128_checks(dev, out)

    # the planted fault: S misses half of every score's 128 products
    tol = ATTN_TOL["bfloat16"]
    q, k, v = _d128_planted_inputs(dev).unbind(2)
    sound = max_err(A.flash_attention(q, k, v, n_real=490),
                    A.attention_reference(q, k, v, 490))
    bad = _planted_err(planted_lib, "_d128_planted_inputs",
                       "maest_attn_fwd_bf16_d128", 490, 128)
    check(sound <= tol < bad, f"planted D = 128 half S {bad}, sound {sound}")
    print(f"phase 43 planted fault, the head_dim-128 wgmma kernel built with "
          f"S over the first 64 dimensions only, at (2, 500, 6, 128) n_real "
          f"490: max_abs_err vs plain {bad:.3e} > {tol}: refused (the sound "
          f"kernel {sound:.3e})", flush=True)
    del q, k, v

    gen = torch.Generator(device=dev).manual_seed(44)
    for name, n, lse in (("K2", 1676, False), ("K3a", 866, True)):
        x = torch.randn((BATCH, n, 3, 6, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = x.unbind(2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return F.scaled_dot_product_attention(qt, kt, vt)
        fns = {"wgmma": (lambda: A.flash_attention_fwd_lse(q, k, v)) if lse
               else (lambda: A.flash_attention(q, k, v)),
               "control": lambda: A.attention_fwd_mma(q, k, v, None, lse),
               "sdpa": sdpa}
        for cfg, key in enumerate(WG128_CONFIGS):
            fns[key] = (lambda cfg=cfg: _d128_cfg(cfg, q, k, v, None, lse))
        with torch.inference_mode():
            runs = graph_rounds(fns, 10, dev, D128_ROUNDS)
        for rnd in range(D128_ROUNDS):
            print(f"phase 43 {name} ({BATCH}, {n}, 6, 128) round {rnd + 1} "
                  "CUDA-graph ms: " + ", ".join(
                      f"{key} {ms[rnd]:.4f}" for key, ms in runs.items())
                  + f" [{gpu}]", flush=True)
        med = {key: float(np.median(ms)) for key, ms in runs.items()}
        med["plain"] = cuda_ms(
            (lambda: A.attention_reference_lse(q, k, v)) if lse
            else (lambda: A.attention_reference(q, k, v)), 1)
        every = all(w < c for w, c in zip(runs["wgmma"], runs["control"]))
        best = min(WG128_CONFIGS, key=med.get)
        print(f"phase 43 {name} ({BATCH}, {n}, 6, 128) medians: wgmma "
              f"{med['wgmma']:.4f} ms (its tile "
              f"{WG128_CONFIGS[wg128_production(n)]}), control "
              f"{med['control']:.4f} ({med['control'] / med['wgmma']:.2f}x), "
              f"SDPA {med['sdpa']:.4f}, plain {med['plain']:.4f} (events); "
              f"the wgmma kernel beat the control in every round: {every}; "
              f"fastest configuration {best} [{gpu}]", flush=True)
        check(med["wgmma"] < med["control"] and med["wgmma"] < med["sdpa"],
              f"D = 128 {name} against the control and SDPA {med}")
        out["ms"][name] = med
        del x, q, k, v, qt, kt, vt, fns
        torch.cuda.empty_cache()

    # the num_heads=6 tagging and recipe steps with each kernel, in turn
    model = get_maest(pretrained=False, embed_dim=768, num_heads=6,
                      device=dev, dtype=torch.bfloat16)
    prog = BucketPrograms(model, buckets=(BATCH,), fused_wave=True)
    waves = torch.from_numpy(np.random.default_rng(43).standard_normal(
        (BATCH, CLIP)).astype(np.float32) * 0.1).to(dev)
    _, mcfg, net, state, step, data = _recipe(
        dev, RECIPE, BATCH, 43, ["maest.num_heads=6"])
    drawn = torch.Generator(device=dev).manual_seed(43)
    with torch.no_grad():  # zero heads give loss ln 2 and do = 0
        for lin in (net.head[1], net.head_dist):
            lin.weight.normal_(0.0, 0.05, generator=drawn)
    gen_step = torch.Generator().manual_seed(43)
    losses = []

    def one():
        _, metrics = step(state, data, gen_step)
        losses.append(metrics["train_loss"])

    counts = (A.flash_attention, A.flash_attention_fwd_lse,
              A.attention_fwd_mma)
    steps = {"tagging": (lambda: prog._activations(waves),
                         model.net.cfg.depth, 0),
             "recipe": (one, mcfg.depth, 1)}
    step_ms = {(s_, r_): [] for s_ in steps for r_ in ("wgmma", "control")}
    try:
        for rnd in range(D128_ROUNDS):
            for what, (fn, depth, slot) in steps.items():
                for route in (("wgmma", "control") if rnd % 2 == 0
                              else ("control", "wgmma")):
                    A._K2_CONTROL = route == "control"
                    for f in counts:
                        f.launches = 0
                    with torch.inference_mode(what == "tagging"):
                        step_ms[(what, route)].append(cuda_ms(fn, 3))
                    got = tuple(f.launches for f in counts)
                    want = [0, 0, 0]
                    want[2 if A._K2_CONTROL else slot] = 4 * depth
                    check(got == tuple(want), f"num_heads=6 {what} with the "
                          f"{route}: launches {got}")
                    out["launches"][(what, route)] = got
            print(f"phase 43 num_heads=6 steps round {rnd + 1} (CUDA events, "
                  "ms a step): " + ", ".join(
                      f"{w} with the {r} {ms[-1]:.3f}"
                      for (w, r), ms in step_ms.items()) + f" [{gpu}]",
                  flush=True)
    finally:
        A._K2_CONTROL = False
    check(all(np.isfinite(losses)) and abs(losses[0] - np.log(2)) > 1e-3,
          f"num_heads=6 recipe losses {losses}")
    for key, ms in step_ms.items():
        out["ms"][key] = float(np.median(ms))
    for what, name, depth in (("tagging", "K2", model.net.cfg.depth),
                              ("recipe", "K3a", mcfg.depth)):
        gap = out["ms"][(what, "control")] - out["ms"][(what, "wgmma")]
        kgap = out["ms"][name]["control"] - out["ms"][name]["wgmma"]
        won = sum(a < b for a, b in zip(step_ms[(what, "wgmma")],
                                        step_ms[(what, "control")]))
        out["ms"][(what, "gap")] = (gap, depth * kgap)
        print(f"phase 43 num_heads=6 {what} step (batch {BATCH}, "
              f"{'30 s bf16' if what == 'tagging' else RECIPE + ' N 866'}), "
              f"medians of {D128_ROUNDS} alternating rounds: "
              f"{out['ms'][(what, 'wgmma')]:.3f} ms with the wgmma kernel "
              f"against {out['ms'][(what, 'control')]:.3f} with the control: "
              f"a gap of {gap:.3f} ms against {depth} x the {name} gap "
              f"{depth * kgap:.3f} ({gap / (depth * kgap) * 100:.1f} %); "
              f"rounds won by the wgmma kernel {won} of {D128_ROUNDS}"
              + (f"; the loss {losses[0]:.6f} (not ln 2) to {losses[-1]:.6f}"
                 if what == "recipe" else "") + f" [{gpu}]", flush=True)
    del model, prog, waves, net, state, step, data
    torch.cuda.empty_cache()
    return out


# phase 44's shapes (b, n, n_real, heads, head_dim): K3b/K4 above 256 at
# each width phase 23 holds (320, 384, 512, 1024), 300 zero-padded to 320,
# the 30 s recipe's (32, 866) at num_heads 2 and K4's (1, 4500) n_real
# 4400; K2/K3a at 256 past n_real, at the tagging and recipe shapes of
# num_heads 3, 192 zero-padded to 256, one real key
P44_BWD_SHAPES = ((2, 300, 281, 2, 320), (2, 300, 281, 2, 384),
                  (2, 200, 190, 2, 512), (2, 200, 190, 1, 1024),
                  (2, 100, 90, 2, 300), (BATCH, 866, None, 2, 384),
                  (1, 4500, 4400, 2, 320))
P44_FWD_SHAPES = ((2, 1000, 997, 3, 256), (BATCH, 1676, None, 3, 256),
                  (BATCH, 866, None, 3, 256), (2, 300, 281, 3, 192),
                  (4, 130, 2, 2, 256))
P44_ROUNDS = 3  # interleaved rounds of phase 44's timings
# the launches of one call of the wgmma backward above 256, by
# torch.profiler's kernel names: the prep pass, the scores kernel, the
# dv/dk and the dq products
DN_BWD_EXPECT = {"prep": (r"attn_bwd_prep_dn_kernel", 1),
                 "scores": (r"attn_bwd_dn_scores_kernel", 1),
                 "dv_dk": (r"attn_bwd_dn_mm_kernel<false>", 1),
                 "dq": (r"attn_bwd_dn_mm_kernel<true>", 1)}


def _p44_bwd_schedule(q, k, v, o, lse, do, n_real):
    """The wgmma backward above 256's plain version on the route's inputs:
    ``attention_bwd_tiled_reference`` at its tiles on the inputs
    zero-padded to the next multiple of 64 with the unpadded head_dim's
    scale, sliced back."""
    from maest_tpu_torch.ops import attention as A

    d = q.shape[-1]
    (qp, kp, vp, op, dop), scale = A.pad_head_dim(q, k, v, o, do)
    grads = A.attention_bwd_tiled_reference(
        qp, kp, vp, op, lse, dop, n_real, scale,
        key_tile=A.BWD_DN_KEY_TILE, q_tile=A.BWD_DN_Q_TILE)
    return tuple(g[..., :d] for g in grads)


def _p44_planted_inputs(dev):
    """Phase 44's planted faults' bf16 inputs, drawn from seed 44: (2, 256,
    4, 2, 384) q/k/v/do for the backward (the last 64-row q tile a quarter
    of every key's rows) and (2, 1000, 3, 3, 256) q/k/v for the forward, v
    = 8 at keys 900 on."""
    gen = torch.Generator(device=dev).manual_seed(44)
    bwd = torch.randn((2, 256, 4, 2, 384), generator=gen, device=dev).to(
        torch.bfloat16)
    fwd = torch.randn((2, 1000, 3, 3, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    fwd[:, 900:, 2] = 8.0
    return bwd, fwd


def _p44_gaps() -> list:
    """[the backward's relative gap to its plain version at n_real 250, the
    forward's max|o - plain| at n_real 900] of this process's libraries on
    ``_p44_planted_inputs``."""
    from maest_tpu_torch.ops import attention as A

    bwd, fwd = _p44_planted_inputs(torch.device(DEVICE))
    q, k, v, do = bwd.unbind(2)
    o, lse = A.attention_reference_lse(q, k, v, 250)
    gb = _d256_rel(A.attention_bwd(q, k, v, o, lse, do, 250),
                   _p44_bwd_schedule(q, k, v, o, lse, do, 250))
    q, k, v = fwd.unbind(2)
    gf = max_err(A.flash_attention(q, k, v, n_real=900),
                 A.attention_reference(q, k, v, 900))
    return [gb, gf]


def _p44_planted(fwd_lib: Path, bwd_lib: Path) -> list:
    """``_p44_gaps`` of the planted builds (``fwd_lib`` as attention_fwd,
    ``bwd_lib`` as attention_bwd) in a process of its own: a second copy
    of a kernel that this process has launched does not take its dynamic
    shared-memory limit here."""
    return _own_process(
        "import ctypes, json, sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as C\n"
        "from maest_tpu_torch.ops import _build\n"
        f"_build._libs['attention_fwd'] = ctypes.CDLL({str(fwd_lib)!r})\n"
        f"_build._libs['attention_bwd'] = ctypes.CDLL({str(bwd_lib)!r})\n"
        "print(json.dumps(C._p44_gaps()))\n")


def _p44_checks(dev, out):
    """Phase 44's checks on strided views of a fused q/k/v(/do): the
    backward above 256 at P44_BWD_SHAPES (``attention_bwd``, each launch
    counted) within D256_REL_TOL of its plain version and of plain, two
    launches torch.equal, masked dk/dv exactly zero, its control (through
    ``_K3B_CONTROL``) within the same bound of plain; K2 and K3a at
    P44_FWD_SHAPES within ATTN_TOL x max(1, max |o|) of plain and of
    their tiled plain version, lse within LSE_TOL, K2 torch.equal to K3a's
    o, the control within the same bounds. Worst errors into ``out``."""
    from maest_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(44)
    tol = D256_REL_TOL
    for b, n, n_real, heads, d in P44_BWD_SHAPES:
        x = torch.randn((b, n, 4, heads, d), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v, do = x.unbind(2)
        o, lse = A.attention_reference_lse(q, k, v, n_real)
        before = (A.attention_bwd.launches, A.attention_bwd_mma.launches)
        g = A.attention_bwd(q, k, v, o, lse, do, n_real)
        again = A.attention_bwd(q, k, v, o, lse, do, n_real)
        A._K3B_CONTROL = True
        try:
            c = A.attention_bwd(q, k, v, o, lse, do, n_real)
        finally:
            A._K3B_CONTROL = False
        r = A.attention_bwd_reference(q, k, v, o, lse, do, n_real)
        tr = _p44_bwd_schedule(q, k, v, o, lse, do, n_real)
        torch.cuda.synchronize()
        check((A.attention_bwd.launches - before[0],
               A.attention_bwd_mma.launches - before[1]) == (2, 1),
              "K3b above 256 counters")
        e, et, ec = _d256_rel(g, r), _d256_rel(g, tr), _d256_rel(c, r)
        same = all(torch.equal(a, z) for a, z in zip(g, again))
        zero = n_real is None or not (g[1][:, n_real:].any()
                                      or g[2][:, n_real:].any())
        check(e <= tol and et <= tol and ec <= tol and same and zero,
              f"K3b ({b}, {n}, {heads}, {d}) n_real {n_real}: vs plain {e}, "
              f"vs tiled {et}, control {ec}, deterministic {same}, masked "
              f"zero {zero}")
        out["err"]["bwd"] = max(out["err"]["bwd"], e, et)
        out["err"]["bwd_control"] = max(out["err"]["bwd_control"], ec)
        out["abs"]["bwd"] = max(out["abs"]["bwd"], max(
            max_err(a, z) for a, z in zip(g, r)))
        out["abs"]["bwd_control"] = max(out["abs"]["bwd_control"], max(
            max_err(a, z) for a, z in zip(c, r)))
        print(f"phase 44 K3b ({b}, {n}, {heads}, {d}) n_real {n_real}"
              f"{' zero-padded to 320' * (d == 300)} strided: relative err "
              f"vs plain {e:.3e}, vs the tiled plain version {et:.3e}, the "
              f"control vs plain {ec:.3e} <= {tol}; two launches "
              f"torch.equal: {same}; masked dk/dv exactly 0: {zero}",
              flush=True)
        del x, q, k, v, do, o, lse, g, again, c, r, tr
        torch.cuda.empty_cache()
    counted = (A.flash_attention, A.flash_attention_fwd_lse,
               A.attention_fwd_mma)
    for b, n, n_real, heads, d in P44_FWD_SHAPES:
        x = torch.randn((b, n, 3, heads, d), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = x.unbind(2)
        before = [f.launches for f in counted]
        with torch.inference_mode():
            o = A.flash_attention(q, k, v, n_real=n_real)
        ol, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
        A._K2_CONTROL = True
        try:
            c, cl = A.flash_attention_fwd_lse(q, k, v, n_real)
        finally:
            A._K2_CONTROL = False
        r, rl = A.attention_reference_lse(q, k, v, n_real)
        (qp, kp, vp), scale = A.pad_head_dim(q, k, v)
        t, tl = A.attention_fwd_tiled_reference(qp, kp, vp, n_real, scale)
        torch.cuda.synchronize()
        grew = [f.launches - c0 for f, c0 in zip(counted, before)]
        e, el = max_err(o, r), max_err(lse, rl)
        et, etl = max_err(o, t[..., :d]), max_err(lse, tl)
        ec, ecl = max_err(c, r), max_err(cl, rl)
        # o's bound relative to max(1, max |o|): with 2 real keys |o|
        # reaches 4-8, where one bf16 ulp is 0.03125
        top = max(1.0, r.float().abs().max().item())
        check(grew == [1, 1, 1] and torch.equal(o, ol)
              and max(e, et, ec) <= ATTN_TOL["bfloat16"] * top
              and max(el, etl, ecl) <= LSE_TOL,
              f"K2/K3a ({b}, {n}, {heads}, {d}) n_real {n_real}: launches "
              f"{grew}, o {e} {et}, lse {el} {etl}, control {ec} {ecl}")
        out["err"]["fwd"] = max(out["err"]["fwd"], e, et)
        out["err"]["fwd_lse"] = max(out["err"]["fwd_lse"], e, et, el, etl)
        out["err"]["fwd_control"] = max(out["err"]["fwd_control"], ec)
        out["err"]["fwd_lse_control"] = max(out["err"]["fwd_lse_control"],
                                            ec, ecl)
        print(f"phase 44 K2/K3a ({b}, {n}, {heads}, {d}) n_real {n_real}"
              f"{' zero-padded to 256' * (d < 256)} strided: vs plain o "
              f"{e:.3e}, lse {el:.3e}; vs the tiled plain version o {et:.3e},"
              f" lse {etl:.3e}; K2 torch.equal to K3a's o; the control vs "
              f"plain o {ec:.3e}, lse {ecl:.3e} (<= {ATTN_TOL['bfloat16']} "
              f"x max(1, max|o|) = {ATTN_TOL['bfloat16'] * top:.3e}, lse "
              f"{LSE_TOL})", flush=True)
        del x, q, k, v, o, ol, lse, c, cl, r, rl, t, tl
        torch.cuda.empty_cache()


def phase_dn_d256_wgmma(dev, gpu, planted_libs, fwd_log, bwd_log):
    """Phase 44: K3b/K4 above head_dim 256 on wgmma
    (``csrc/attn_bwd_dn_wgmma.cuh``, the route of ``maest_attn_bwd_bf16_dn``:
    the prep pass, the scores kernel writing p^T and ds^T once, the dv/dk
    and the dq products) beside its mma.sync control
    (``maest_attn_bwd_bf16_dn_mma``), and K2/K3a at head_dim 256 on wgmma
    (``csrc/attn_fwd_d256_wgmma.cuh``, the route of
    ``maest_attn_fwd_bf16_d256``: two consumer warpgroups, no producer
    warp) beside its control (``maest_attn_fwd_bf16_d256_mma``). Their
    registers and spills (phase 2's ptxas) and SASS (HGMMA, UTMALDG, no
    HMMA); ``_p44_checks``; the builds of phase 30's and 31's planted
    libraries with dv/dk's last q tile left out and the forward's key mask
    dropped (``planted_libs``), refused in a process of their own. Then
    CUDA-graph replays in P44_ROUNDS interleaved rounds of each kernel, its
    control and SDPA (flash backend at 256; efficient attention's backward
    at 320 and 384) at K2's (32, 1676, 3, 256), K3a's (32, 866, 3, 256),
    K3b's (32, 866, 2, 384) and K4's (1, 4500, 2, 320) n_real 4400, plain
    by events (the median of 3 calls), the backward's kernels split by
    torch.profiler (DN_BWD_EXPECT); then the 30 s recipe step at
    num_heads 2 with each backward (``_K3B_CONTROL``) and the batch-32 30 s
    bf16 tagging and 30 s recipe steps at num_heads 3 with each forward
    (``_K2_CONTROL``) in alternating rounds, CUDA events over 3 steps a
    round after one, the launch counters checked on each, each gap beside
    12 x the kernel gap. Returns the errors, the medians and the
    launches."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from maest_tpu_torch import get_maest
    from maest_tpu_torch.ops import _build
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.probes.attn_profile import graph_rounds
    from maest_tpu_torch.serve import BucketPrograms

    out = {"err": dict.fromkeys(("bwd", "bwd_control", "fwd", "fwd_lse",
                                 "fwd_control", "fwd_lse_control"), 0.0),
           "abs": dict.fromkeys(("bwd", "bwd_control"), 0.0), "ms": {},
           "launches": {}}
    laps = [("start", time.perf_counter())]  # the parts' seconds, printed
    rows = [r for r in ptxas_rows(fwd_log) + ptxas_rows(bwd_log)
            if "attn_fwd_d256_wgmma_kernel" in r or "attn_bwd_dn_" in r
            or "attn_bwd_prep_dn_kernel" in r]
    sass = {**sass_kinds(_build.build("attention_fwd")[0],
                         "attn_fwd_d256_wgmma_kernel"),
            **sass_kinds(_build.build("attention_bwd")[0], "attn_bwd_dn_")}
    check(len(sass) == 4 and all(
        c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0
        for c in sass.values()),
        f"wgmma/TMA instructions of phase 44's kernels {sass}")
    check(not rows or len(rows) == 5 and all(
        r.endswith("spills 0/0 bytes") for r in rows),
        f"phase 44's kernels spill: {rows}")
    print("phase 44 the head_dim-256 forward's and the _dn backward's wgmma "
          "kernels (HGMMA = bf16 wgmma, UTMALDG = TMA load, HMMA = mma.sync):"
          " " + "; ".join(
              f"{k}: " + ", ".join(f"{c[g]} {g}" for g in (
                  "HGMMA", "UTMALDG", "HMMA")) + f" of {c['instructions']} "
              "instructions" for k, c in sorted(sass.items()))
          + "; ptxas: " + "; ".join(rows), flush=True)
    _p44_checks(dev, out)
    laps.append(("checks", time.perf_counter()))

    # the planted faults: dv and dk miss the last q tile; the forward's key
    # mask dropped
    sound = _p44_gaps()
    bad = _p44_planted(*planted_libs)
    tol = (D256_REL_TOL, ATTN_TOL["bfloat16"])
    check(all(s <= t < p for s, t, p in zip(sound, tol, bad)),
          f"phase 44 planted {bad}, sound {sound}")
    print(f"phase 44 planted faults, each in a process of its own: the _dn "
          f"backward built with dv's and dk's products of the last q tile "
          f"left out, at (2, 256, 2, 384) n_real 250: relative err vs the "
          f"tiled plain version {bad[0]:.3e} > {tol[0]}: refused (the sound "
          f"kernels {sound[0]:.3e}); the head_dim-256 forward built with its "
          f"key mask dropped, at (2, 1000, 3, 256) n_real 900, v = 8 past "
          f"it: max_abs_err vs plain {bad[1]:.3e} > {tol[1]}: refused (the "
          f"sound kernel {sound[1]:.3e})", flush=True)
    laps.append(("planted", time.perf_counter()))

    gen = torch.Generator(device=dev).manual_seed(45)
    for name, b, n, n_real, heads, d in (
            ("K2", BATCH, 1676, None, 3, 256), ("K3a", BATCH, 866, None, 3, 256),
            ("K3b", BATCH, 866, None, 2, 384), ("K4", 1, 4500, 4400, 2, 320)):
        x = torch.randn((b, n, 4, heads, d), generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v, do = x.unbind(2)
        nr = n_real or n
        if name in ("K2", "K3a"):
            lse_ = name == "K3a"
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    return F.scaled_dot_product_attention(qt, kt, vt)
            fns = {"wgmma": (lambda: A.flash_attention_fwd_lse(q, k, v))
                   if lse_ else (lambda: A.flash_attention(q, k, v)),
                   "control": lambda: A.attention_fwd_mma(q, k, v, None, lse_),
                   "sdpa": sdpa}
            plain = ((lambda: A.attention_reference_lse(q, k, v)) if lse_
                     else (lambda: A.attention_reference(q, k, v)))
        else:
            o, lse = A.flash_attention_fwd_lse(q, k, v, n_real)
            fns = {"wgmma": lambda: A.attention_bwd(q, k, v, o, lse, do,
                                                    n_real),
                   "control": lambda: A.attention_bwd_mma(q, k, v, o, lse, do,
                                                          n_real),
                   # the library takes no key mask: its backward over the
                   # real keys' rows
                   "sdpa": sdpa_efficient(q[:, :nr], k[:, :nr], v[:, :nr],
                                          do[:, :nr])}
            plain = (lambda: A.attention_bwd_reference(q, k, v, o, lse, do,
                                                       n_real))
        with torch.inference_mode(name in ("K2", "K3a")):
            runs = graph_rounds(fns, 10 if n < 4500 else 5, dev, P44_ROUNDS)
        for rnd in range(P44_ROUNDS):
            print(f"phase 44 {name} ({b}, {n}, {heads}, {d}) n_real {n_real} "
                  f"round {rnd + 1} CUDA-graph ms: " + ", ".join(
                      f"{key} {ms[rnd]:.4f}" for key, ms in runs.items())
                  + f" [{gpu}]", flush=True)
        med = {key: float(np.median(ms)) for key, ms in runs.items()}
        # the median of 3: one call of plain's (N, N) tensors may meet the
        # allocator freeing and taking memory back
        med["plain"] = cuda_ms_median(plain, 1)
        every = all(w < c and w < s for w, c, s in zip(
            runs["wgmma"], runs["control"], runs["sdpa"]))
        print(f"phase 44 {name} ({b}, {n}, {heads}, {d}) medians: wgmma "
              f"{med['wgmma']:.4f} ms, control {med['control']:.4f} "
              f"({med['control'] / med['wgmma']:.2f}x), SDPA "
              f"{med['sdpa']:.4f}, plain {med['plain']:.4f} (events); the "
              f"wgmma kernel beat the control and SDPA in every round: "
              f"{every} [{gpu}]", flush=True)
        check(med["wgmma"] < med["control"] and med["wgmma"] < med["sdpa"],
              f"phase 44 {name} against the control and SDPA {med}")
        out["ms"][name] = med
        if name in ("K3b", "K4"):
            split = _kernel_ms(fns["wgmma"], DN_BWD_EXPECT, med["wgmma"])
            out.setdefault("split", {})[name] = split
            print(f"phase 44 {name} ({b}, {n}, {heads}, {d}) by torch.profiler:"
                  f" {_fmt_ms(split)} [{gpu}]", flush=True)
        del x, q, k, v, do, fns
        torch.cuda.empty_cache()
    laps.append(("kernel rounds", time.perf_counter()))

    # the steps with each kernel, in turn: the recipe at num_heads 2
    # (K3b), the tagging (K2) and recipe (K3a) steps at num_heads 3
    model = get_maest(pretrained=False, embed_dim=768, num_heads=3,
                      device=dev, dtype=torch.bfloat16)
    prog = BucketPrograms(model, buckets=(BATCH,), fused_wave=True)
    waves = torch.from_numpy(np.random.default_rng(44).standard_normal(
        (BATCH, CLIP)).astype(np.float32) * 0.1).to(dev)
    recipes, losses = {}, {}
    for heads in (2, 3):
        _, mcfg, net, state, step, data = _recipe(
            dev, RECIPE, BATCH, 44, [f"maest.num_heads={heads}"])
        drawn = torch.Generator(device=dev).manual_seed(44)
        with torch.no_grad():  # zero heads give loss ln 2 and do = 0
            for lin in (net.head[1], net.head_dist):
                lin.weight.normal_(0.0, 0.05, generator=drawn)
        gen_step = torch.Generator().manual_seed(44)
        losses[heads] = []

        def one(step=step, state=state, data=data, gen_step=gen_step,
                heads=heads):
            _, metrics = step(state, data, gen_step)
            losses[heads].append(metrics["train_loss"])
        recipes[heads] = (one, mcfg.depth, net, state, data)
    counted = (A.flash_attention, A.flash_attention_fwd_lse, A.attention_bwd,
               A.attention_fwd_mma, A.attention_bwd_mma)
    # (step, depth, the hook, the counters a step launches with the kernel
    # and with the control)
    steps = {
        "recipe_d384": (recipes[2][0], recipes[2][1], "_K3B_CONTROL",
                        (0, 1, 1, 0, 0), (0, 1, 0, 0, 1)),
        "tagging_d256": (lambda: prog._activations(waves),
                         model.net.cfg.depth, "_K2_CONTROL",
                         (1, 0, 0, 0, 0), (0, 0, 0, 1, 0)),
        "recipe_d256": (recipes[3][0], recipes[3][1], "_K2_CONTROL",
                        (0, 1, 1, 0, 0), (0, 0, 1, 1, 0))}
    step_ms = {(s_, r_): [] for s_ in steps for r_ in ("wgmma", "control")}
    try:
        for rnd in range(P44_ROUNDS):
            for what, (fn, depth, hook, per_k, per_c) in steps.items():
                for route in (("wgmma", "control") if rnd % 2 == 0
                              else ("control", "wgmma")):
                    setattr(A, hook, route == "control")
                    for f in counted:
                        f.launches = 0
                    with torch.inference_mode(what.startswith("tagging")):
                        step_ms[(what, route)].append(cuda_ms(fn, 3))
                    setattr(A, hook, False)
                    got = tuple(f.launches for f in counted)
                    want = tuple(4 * depth * w for w in (
                        per_c if route == "control" else per_k))
                    check(got == want, f"phase 44 {what} with the {route}: "
                          f"launches {got}")
                    out["launches"][(what, route)] = got
            print(f"phase 44 steps round {rnd + 1} (CUDA events, ms a step): "
                  + ", ".join(f"{w} with the {r} {ms[-1]:.3f}"
                              for (w, r), ms in step_ms.items())
                  + f" [{gpu}]", flush=True)
    finally:
        A._K2_CONTROL = A._K3B_CONTROL = False
    for heads, ls in losses.items():
        check(all(np.isfinite(ls)) and abs(ls[0] - np.log(2)) > 1e-3,
              f"phase 44 num_heads={heads} recipe losses {ls}")
    for key, ms in step_ms.items():
        out["ms"][key] = float(np.median(ms))
    for what, name, depth in (("recipe_d384", "K3b", recipes[2][1]),
                              ("tagging_d256", "K2", model.net.cfg.depth),
                              ("recipe_d256", "K3a", recipes[3][1])):
        gap = out["ms"][(what, "control")] - out["ms"][(what, "wgmma")]
        kgap = out["ms"][name]["control"] - out["ms"][name]["wgmma"]
        won = sum(a < b for a, b in zip(step_ms[(what, "wgmma")],
                                        step_ms[(what, "control")]))
        out["ms"][(what, "gap")] = (gap, depth * kgap)
        print(f"phase 44 {what} step (batch {BATCH}, "
              f"{'30 s bf16' if what.startswith('tagging') else RECIPE + ' N 866'}"
              f", num_heads {2 if what.endswith('384') else 3}), medians of "
              f"{P44_ROUNDS} alternating rounds: "
              f"{out['ms'][(what, 'wgmma')]:.3f} ms with the wgmma kernel "
              f"against {out['ms'][(what, 'control')]:.3f} with the control: "
              f"a gap of {gap:.3f} ms against {depth} x the {name} gap "
              f"{depth * kgap:.3f} ({gap / (depth * kgap) * 100:.1f} %); "
              f"rounds won by the wgmma kernel {won} of {P44_ROUNDS} [{gpu}]",
              flush=True)
    print(f"phase 44 recipe losses: num_heads 2 {losses[2][0]:.6f} (not ln 2)"
          f" to {losses[2][-1]:.6f}, num_heads 3 {losses[3][0]:.6f} to "
          f"{losses[3][-1]:.6f}", flush=True)
    laps.append(("steps", time.perf_counter()))
    print("phase 44 time: " + ", ".join(
        f"{name} {t - laps[i][1]:.1f} s"
        for i, (name, t) in enumerate(laps[1:])), flush=True)
    del model, prog, waves, recipes
    torch.cuda.empty_cache()
    return out


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

    t_main = time.perf_counter()
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    gpu = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    kind = torch.cuda.get_device_name(0)  # the device record's "kind"
    print(f"phase 1 device: {gpu}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {kind}; fp32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}", flush=True)

    def timed_build(lib):
        t = time.perf_counter()
        log = _build.build(lib)[1]
        return log, time.perf_counter() - t

    t0 = time.perf_counter()
    libs = ("mel_kernel", "attention_fwd", "attention_bwd", "attention_fwd_q8",
            "attention_bwd_q8", "attention_probe", "mma_probe")
    with ThreadPoolExecutor(len(libs) + 13) as pool:  # one nvcc per source
        gh_plant = pool.submit(build_planted_gh_prev_q)
        d128_plant = pool.submit(build_planted_d128_half_s)
        bf16s_plant = pool.submit(build_planted_bf16s)
        planted = pool.submit(build_planted_to_s8)
        q8w_no_mask = pool.submit(build_planted_q8w_no_mask)
        q8w_half_away = pool.submit(build_planted_q8w_half_away)
        no_mask = pool.submit(build_planted_no_mask)
        bwd_no_mask = pool.submit(build_planted_bwd_no_mask)
        k7_dq = pool.submit(build_planted_k7_dq)
        tf32_fwd = pool.submit(build_planted_tf32_fwd)
        tf32_bwd = pool.submit(build_planted_tf32_bwd)
        mel_twiddle = pool.submit(build_planted_mel_twiddle)
        mma_wgmma = pool.submit(build_planted_mma)
        built = dict(zip(libs, pool.map(timed_build, libs)))
        planted_lib, planted_s = planted.result()
        no_mask_lib, no_mask_s = no_mask.result()
        bwd_no_mask_lib, bwd_no_mask_s = bwd_no_mask.result()
        k7_dq_lib, k7_dq_s = k7_dq.result()
        tf32_libs = (tf32_fwd.result(), tf32_bwd.result())
        q8w_libs = (q8w_no_mask.result(), q8w_half_away.result())
        mel_lib, mel_s = mel_twiddle.result()
        mma_libs, mma_s = mma_wgmma.result()
        bf16s_lib, bf16s_s = bf16s_plant.result()
        gh_lib, gh_s = gh_plant.result()
        d128_lib, d128_s = d128_plant.result()
    wall = time.perf_counter() - t0
    for lib in libs:
        _build.load_library(lib)
    print(f"phase 2 build: {wall:.1f} s with nvcc sm_90a into "
          f"build/maest_tpu_torch, one nvcc per source at once ("
          + ", ".join(f"{lib} {s:.1f} s" for lib, (_, s) in built.items())
          + f"; phase 29's planted copy of attention_bwd_q8, to_s8 for ds8, "
          f"{planted_s:.1f} s; phase 30's and 27's of attention_fwd, the "
          f"wgmma kernel's key mask dropped, the _dn wgmma kernel's last "
          f"K chunk left out of S and (phase 44) the head_dim-256 wgmma "
          f"kernel's key mask dropped, {no_mask_s:.1f} s; phase 31's, 42's and "
          f"44's of attention_bwd, the wgmma backward's key mask dropped, the "
          f"head_dim-256 wgmma backward's dV of the last q tile left out and "
          f"the _dn wgmma backward's dv and dk of the last q tile left out, "
          f"{bwd_no_mask_s:.1f} s; phase 32's of attention_bwd_q8, the wgmma "
          f"K7's dq adds of key tile 1 dropped, {k7_dq_s:.1f} s; phase 34's "
          f"of attention_fwd and attention_bwd, one tf32 product in the tf32 "
          f"kernels, {tf32_libs[0][1]:.1f} and {tf32_libs[1][1]:.1f} s; phase "
          f"35's of attention_fwd_q8, the wgmma 8-bit forward's key mask "
          f"dropped and its pass rounding half away from zero, "
          f"{q8w_libs[0][1]:.1f} and {q8w_libs[1][1]:.1f} s; phase 36's of "
          f"mel_kernel, one twiddle's sign flipped, {mel_s:.1f} s; phase "
          f"26's of mma_probe, the wgmma product kernel's last bf16 product "
          f"of each stage dropped and its e4m3 sums kept on the tensor core "
          f"across stages, {mma_s:.1f} s for both; phase 18's of "
          f"attention_probe, the wgmma bf16s kernel's bf16 rounding of the "
          f"scores left out, {bf16s_s:.1f} s; phase 20's of attention_probe, "
          f"the gh kernel loading the q of the head before, {gh_s:.1f} s; "
          f"phase 43's of attention_fwd, the head_dim-128 kernel's S over 64 "
          f"of its 128 dimensions, {d128_s:.1f} s)", flush=True)
    for lib, (log, _) in built.items():  # empty where a build was reused
        print(f"phase 2 ptxas {lib}: " + "; ".join(ptxas_rows(log)),
              flush=True)
    wg_rows = [r for r in ptxas_rows(built["attention_fwd"][0])
               if "attn_fwd_wgmma_kernel" in r]
    sass = sass_counts(_build.build("attention_fwd")[0],
                       "attn_fwd_wgmma_kernel")
    # head_dim 64's sweep configurations and head_dim 128's (the
    # production instances among them)
    check(len(sass) == len(WG_CONFIGS) + len(WG128_CONFIGS) and all(
        h > 0 and t > 0 for h, t, _ in sass.values()),
        f"wgmma/TMA instructions of the wgmma kernels {sass}")
    check(all(r.endswith("spills 0/0 bytes") for r in wg_rows),
          f"the wgmma kernels spill: {wg_rows}")
    print("phase 2 SASS of the wgmma kernels (cuobjdump -sass; HGMMA = "
          "wgmma, UTMALDG = TMA load): " + "; ".join(
              f"{k}: {h} HGMMA, {t} UTMALDG of {i} instructions"
              for k, (h, t, i) in sorted(sass.items()))
          + "; ptxas: " + "; ".join(wg_rows), flush=True)
    # the runtime-width wgmma kernel (head_dim above 256): products on bf16
    # wgmma, loads on TMA, no mma.sync, no spill
    dn_rows = [r for r in ptxas_rows(built["attention_fwd"][0])
               if "attn_fwd_dn_wgmma_kernel" in r]
    dn_sass = sass_kinds(_build.build("attention_fwd")[0],
                         "attn_fwd_dn_wgmma_kernel")
    check(len(dn_sass) == 1 and all(
        c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0
        for c in dn_sass.values()),
        f"wgmma/TMA instructions of the _dn wgmma kernel {dn_sass}")
    check(not dn_rows or len(dn_rows) == 1
          and dn_rows[0].endswith("spills 0/0 bytes"),
          f"the _dn wgmma kernel spills: {dn_rows}")
    print("phase 2 SASS of the _dn wgmma kernel (HGMMA = bf16 wgmma, UTMALDG "
          "= TMA load, HMMA = mma.sync): " + "; ".join(
              f"{k}: " + ", ".join(f"{c[g]} {g}" for g in (
                  "HGMMA", "UTMALDG", "HMMA")) + f" of {c['instructions']} "
              "instructions" for k, c in sorted(dn_sass.items()))
          + "; ptxas: " + "; ".join(dn_rows), flush=True)
    # the wgmma backward: every sweep configuration forms its products on
    # wgmma and loads on TMA; the production one spills nothing
    bw_rows = [r for r in ptxas_rows(built["attention_bwd"][0])
               if "attn_bwd_wgmma_kernel" in r or "attn_bwd_prep" in r]
    bw_sass = sass_counts(_build.build("attention_bwd")[0],
                          "attn_bwd_wgmma_kernel")
    check(len(bw_sass) == len(WG_BWD_CONFIGS) and all(
        h > 0 and t > 0 for h, t, _ in bw_sass.values()),
        f"wgmma/TMA instructions of the wgmma backward kernels {bw_sass}")
    production = "attn_bwd_wgmma_kernel<64, 2, 0>"
    check(any(production in r for r in bw_rows) and all(
        r.endswith("spills 0/0 bytes") for r in bw_rows
        if production in r or "attn_bwd_prep" in r),
        f"the production wgmma backward spills: {bw_rows}")
    # the wgmma K7: its stats and main kernels form their products on s8
    # wgmma (IGMMA) and load on TMA; none of its kernels spills
    q8_rows = [r for r in ptxas_rows(built["attention_bwd_q8"][0])
               if "q8w" in r]
    q8_sass = sass_counts(_build.build("attention_bwd_q8")[0],
                          "attn_bwd_q8w_kernel")
    check(len(q8_sass) == 2 and all(h > 0 and t > 0
                                    for h, t, _ in q8_sass.values()),
          f"wgmma/TMA instructions of the wgmma K7 {q8_sass}")
    check(not q8_rows or len(q8_rows) == 4 and all(
        r.endswith("spills 0/0 bytes") for r in q8_rows),
        f"the wgmma K7 spills: {q8_rows}")
    print("phase 2 SASS of the wgmma K7 (IGMMA = s8 wgmma): " + "; ".join(
              f"{k}: {h} IGMMA, {t} UTMALDG of {i} instructions"
              for k, (h, t, i) in sorted(q8_sass.items()))
          + "; ptxas: " + "; ".join(q8_rows), flush=True)
    print("phase 2 SASS of the wgmma backward kernels: " + "; ".join(
              f"{k}: {h} HGMMA, {t} UTMALDG of {i} instructions"
              for k, (h, t, i) in sorted(bw_sass.items()))
          + "; ptxas: " + "; ".join(bw_rows), flush=True)

    # P6d and P6e on K2's wgmma kernel (its BF16S instances and its G 1, 2,
    # 4 and 8 instances in attention_probe, each at 96 and 112 keys) and K3b
    # at head_dim 256 (the dk/dv and the dq kernel): bf16 wgmma, TMA loads,
    # no mma.sync, no spill
    new_rows, new_sass = [], {}
    for lib, pattern in (("attention_probe", "attn_fwd_wgmma_kernel"),
                         ("attention_bwd", "d256_kernel")):
        new_rows += [r for r in ptxas_rows(built[lib][0]) if (
            "d256_kernel" in r if lib == "attention_bwd" else
            "attn_fwd_wgmma_kernel" in r)]
        new_sass.update(sass_kinds(_build.build(lib)[0], pattern))
    check(len(new_sass) == 12 and all(
        c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0
        for c in new_sass.values()),
        f"wgmma/TMA instructions of the bf16s, gh and head_dim-256 kernels "
        f"{new_sass}")
    check(not new_rows or len(new_rows) == 12 and all(
        r.endswith("spills 0/0 bytes") for r in new_rows),
        f"the bf16s, gh or head_dim-256 wgmma kernels spill: {new_rows}")
    print("phase 2 SASS of P6d's and P6e's wgmma kernel (attention_probe, "
          "BF16S and G 1-8) and K3b's at head_dim 256 (HGMMA = bf16 wgmma, "
          "UTMALDG = TMA load, "
          "HMMA = mma.sync): " + "; ".join(
              f"{k}: " + ", ".join(f"{c[g]} {g}" for g in (
                  "HGMMA", "UTMALDG", "HMMA")) + f" of {c['instructions']} "
              "instructions" for k, c in sorted(new_sass.items()))
          + "; ptxas: " + "; ".join(new_rows), flush=True)

    # the tf32 kernels (fp32 at head_dim 64): the forward, the dk/dv and dq
    # kernels form their products on tf32 wgmma (HGMMA) and load on TMA;
    # none spills
    tf_rows = [r for lib in ("attention_fwd", "attention_bwd")
               for r in ptxas_rows(built[lib][0]) if "tf32" in r]
    tf_sass = {**sass_counts(_build.build("attention_fwd")[0],
                             "attn_fwd_tf32_kernel"),
               **sass_counts(_build.build("attention_bwd")[0], "tf32_kernel")}
    tf_sass = {k: c for k, c in tf_sass.items() if "stats" not in k}
    check(len(tf_sass) == 3 and all(
        h > 0 and t > 0 for h, t, _ in tf_sass.values()),
        f"wgmma/TMA instructions of the tf32 kernels {tf_sass}")
    kernels = ("attn_fwd_tf32_kernel", "attn_bwd_dkv_tf32_kernel",
               "attn_bwd_dq_tf32_kernel")
    check(not tf_rows or all(any(p in r for r in tf_rows) for p in kernels)
          and all(r.endswith("spills 0/0 bytes") for r in tf_rows),
          f"the tf32 kernels spill: {tf_rows}")
    print("phase 2 SASS of the tf32 kernels (HGMMA = tf32 wgmma): " + "; ".join(
              f"{k}: {h} HGMMA, {t} UTMALDG of {i} instructions"
              for k, (h, t, i) in sorted(tf_sass.items()))
          + "; ptxas: " + "; ".join(tf_rows), flush=True)

    # the wgmma 8-bit forwards: S on s8 (IGMMA) wgmma in the int8 modes and
    # on bf16 (HGMMA) of the e4m3 values in the e4m3 ones, P.V on bf16 in
    # qk8 / fp8 and on s8 or e4m3 (QGMMA) in the pv8 modes, loads on TMA;
    # the kernels and the passes spill nothing
    q8w_rows = [r for r in ptxas_rows(built["attention_fwd_q8"][0])
                if "fwd_q8w" in r]
    q8w_sass = sass_kinds(_build.build("attention_fwd_q8")[0],
                          "attn_fwd_q8w_kernel")
    by_mode = dict(zip(("<0>", "<1>", "<2>", "<3>"), Q8_MODES))
    kinds = {m: next((c for k, c in q8w_sass.items() if k.endswith(t)), None)
             for t, m in by_mode.items()}
    want_kinds = {"qk8": ("IGMMA", "HGMMA"), "qk8pv8": ("IGMMA",),
                  "fp8": ("HGMMA",), "fp8pv8": ("HGMMA", "QGMMA")}
    check(all(kinds[m] is not None and kinds[m]["UTMALDG"] > 0 and all(
        (kinds[m][g] > 0) == (g in want_kinds[m])
        for g in ("IGMMA", "QGMMA", "HGMMA")) for m in Q8_MODES),
        f"wgmma/TMA instructions of the wgmma 8-bit forwards {q8w_sass}")
    check(not q8w_rows or len(q8w_rows) == 9 and all(
        r.endswith("spills 0/0 bytes") for r in q8w_rows),
        f"the wgmma 8-bit forwards spill: {q8w_rows}")
    print("phase 2 SASS of the wgmma 8-bit forwards (IGMMA = s8 wgmma, "
          "QGMMA = e4m3 wgmma, HGMMA = bf16 wgmma, UTMALDG = TMA load): "
          + "; ".join(f"{m}: " + ", ".join(f"{c[g]} {g}" for g in (
              "IGMMA", "QGMMA", "HGMMA", "UTMALDG")) + f" of "
              f"{c['instructions']} instructions" for m, c in kinds.items())
          + "; ptxas: " + "; ".join(q8w_rows), flush=True)

    # the product kernel of P1/P8 on wgmma: bf16 instances on HGMMA, the
    # e4m3 one on QGMMA, loads on TMA, no mma.sync (HMMA, QMMA), no spill
    mp_rows = [r for r in ptxas_rows(built["mma_probe"][0])
               if "mma_probe_wgmma_kernel" in r]
    mp_sass = sass_kinds(_build.build("mma_probe")[0],
                         "mma_probe_wgmma_kernel")
    # the instances <E4M3, BN>, the bool demangled as 1 or true
    check(len(mp_sass) == 3 and all(
        c["UTMALDG"] > 0 and c["HMMA"] == c["QMMA"] == c["IGMMA"] == 0
        and c["QGMMA" if re.search(r"<(1|true),", k) else "HGMMA"] > 0
        for k, c in mp_sass.items()),
        f"wgmma/TMA instructions of the wgmma product kernel {mp_sass}")
    check(not mp_rows or len(mp_rows) == 3 and all(
        r.endswith("spills 0/0 bytes") for r in mp_rows),
        f"the wgmma product kernel spills: {mp_rows}")
    print("phase 2 SASS of the wgmma product kernel of P1/P8 (HGMMA = bf16 "
          "wgmma, QGMMA = e4m3 wgmma, UTMALDG = TMA load, HMMA / QMMA = "
          "mma.sync): " + "; ".join(f"{k}: " + ", ".join(
              f"{c[g]} {g}" for g in ("HGMMA", "QGMMA", "UTMALDG", "HMMA",
                                      "QMMA")) + f" of {c['instructions']} "
              "instructions" for k, c in sorted(mp_sass.items()))
          + "; ptxas: " + "; ".join(mp_rows), flush=True)

    # K1, the FFT kernel: no spill; its launch shape
    mel_rows = [r for r in ptxas_rows(built["mel_kernel"][0])
                if "logmel" in r]
    fft_rows = [r for r in mel_rows if "logmel_fft_kernel" in r]
    check(not mel_rows or len(fft_rows) == 1 and all(
        r.endswith("spills 0/0 bytes") for r in fft_rows),
        f"the FFT mel kernel spills: {mel_rows}")
    cfg = (ctypes.c_int * 4)()
    mel_so = _build.load_library("mel_kernel")
    _build.check(mel_so, mel_so.maest_logmel_fft_config(cfg),
                 "maest_logmel_fft_config")
    check(cfg[2] >= 1, f"the FFT mel kernel fits no block on an SM {list(cfg)}")
    print(f"phase 2 K1, the FFT kernel (mel_kernel.cu logmel_fft_kernel): "
          f"{cfg[1]} threads, {cfg[0]} bytes of dynamic shared memory a block "
          f"({cfg[3]} of them the ring of frame groups), {cfg[2]} blocks an "
          f"SM; ptxas: " + "; ".join(mel_rows), flush=True)

    seconds = {}  # each phase's wall time, printed as it ends

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t
        print(f"phase {phase} seconds: {seconds[phase]:.1f}", flush=True)
        return out

    mel_err, attn_err = timed(3, phase_kernels_vs_plain, dev)
    sd, golden_cases = timed(4, phase_golden, dev)
    with tempfile.TemporaryDirectory() as tmp:
        model, launches, inputs = timed(6, phase_main_path, dev, sd, tmp)
    timed(7, phase_server, model, inputs)
    t = timed(8, phase_times, dev, model, gpu)
    del model
    torch.cuda.empty_cache()
    train_err, k4_err = timed(9, phase_train_kernels, dev)
    timed(10, phase_golden_step, dev)
    train_launches = timed(11, phase_recipe, dev)
    tt = timed(12, phase_train_times, dev, gpu)

    q8 = timed(13, phase_q8_kernels, dev, gpu)
    q8_launches = timed(14, phase_q8_tagging, dev, sd, gpu)
    k7 = timed(15, phase_k7_kernel, dev, gpu)
    k7_launches = timed(16, phase_int8_recipe, dev, gpu)
    lib = timed(17, phase_library, dev, gpu)
    probe_err, probe_plain = timed(18, phase_probe_kernels, dev, bf16s_lib)
    rig, rig_launches, p6d = timed(19, phase_probe_rig, dev, gpu)
    p6ef = timed(20, phase_gh_int8, dev, gh_lib)
    vpu_err, vpu_plain = timed(21, phase_vpu_kernels, dev)
    rig2, vpu, rig2_launches = timed(22, phase_rigs, gpu)
    q3 = timed(23, phase_queue3, dev, gpu)
    tiles = timed(24, phase_tile_kernels, dev)
    tune, alone, tune_launches = timed(25, phase_tune_rigs)
    mma = timed(26, phase_mma_kernels, dev, gpu, mma_libs)
    wide = timed(27, phase_wide_heads_and_mma_rigs, dev, gpu, no_mask_lib)
    i8 = timed(28, phase_int8_rigs, dev, gpu)
    p4 = timed(29, phase_bwd_rig, dev, gpu, planted_lib)
    wg = timed(30, phase_wgmma, dev, gpu, no_mask_lib)
    bw = timed(31, phase_bwd_wgmma, dev, gpu, bwd_no_mask_lib)
    k7w = timed(32, phase_k7_wgmma, dev, gpu, k7_dq_lib)
    timed(33, phase_yardsticks, dev, gpu)
    tf = timed(34, phase_tf32, dev, gpu, [p for p, _ in tf32_libs])
    q8w = timed(35, phase_q8_wgmma, dev, gpu, sd,
                {"no_mask": q8w_libs[0][0], "half_away": q8w_libs[1][0]})
    k1 = timed(36, phase_mel_fft, dev, gpu, sd, mel_lib)
    keep = tempfile.TemporaryDirectory()  # phase 37's run, for phase 41
    cli = timed(37, phase_trainer_cli, dev, gpu, Path(keep.name) / "cli_run")
    par = timed(38, phase_parallel, dev, gpu)
    pp = timed(39, phase_pipeline, dev, gpu, par["reference"])
    tg = timed(40, phase_tagging, dev, gpu, sd)
    sg = timed(41, phase_surgery, dev, gpu, golden_cases,
               Path(keep.name) / "cli_run")
    keep.cleanup()
    bd = timed(42, phase_bwd_d256, dev, gpu, bw["planted_d256"])
    d128 = timed(43, phase_d128_wgmma, dev, gpu, d128_lib,
                 built["attention_fwd"][0])
    p44 = timed(44, phase_dn_d256_wgmma, dev, gpu,
                (no_mask_lib, bwd_no_mask_lib), built["attention_fwd"][0],
                built["attention_bwd"][0])

    # K1: the bytes of the frames in and the log-mels out, and the FFT
    # route's fp32 operations (the DFT as a product does ~40x more)
    bounds = {
        "mel": bound(MEL_FRAMES * (512 + 96) * 4,
                     {"fp32": mel_fft_ops(MEL_FRAMES)}),
        "fwd": attn_bound(BATCH, 1676, 12),
        "fwd_lse": attn_bound(BATCH, 866, 12, lse=True),
        "bwd": bwd_bound(BATCH, 866, 12),
        "qk8": attn_bound(BATCH, 1676, 12, qk="int8"),
        "fp8": attn_bound(BATCH, 1676, 12, qk="fp8"),
        "qk8pv8": attn_bound(BATCH, 1676, 12, qk="int8", pv="int8"),
        "fp8pv8": attn_bound(BATCH, 1676, 12, qk="fp8", pv="fp8"),
        "k7": bwd_bound(BATCH, 866, 12, kind="int8"),
        "k4": bwd_bound(2, 4500, 12, 4400),
        "int8_rig": attn_bound(BATCH, 1676, 12, qk="int8", pv="int8", elem=4),
        "bf16sm": attn_bound(BATCH, 1676, 12),
        "fp8sm": attn_bound(BATCH, 1676, 12, qk="fp8"),
        "fp8noexp": attn_bound(BATCH, 1676, 12, qk="fp8"),
        "fp8nomask": attn_bound(BATCH, 1676, 12, 1792, qk="fp8"),
        "fp8lean": attn_bound(BATCH, 1676, 12, qk="fp8", pv="fp8"),
        "qpad": attn_bound(100, 281, 12),
        "tile": attn_bound(BATCH, 281, 12),
        "bwd_tile": bwd_bound(BATCH, 866, 12),
        # q.k in int8, p.v in fp32 on fp32 q, k, v, o and the lse (qk8 with
        # lse, as the recipe step runs it; qk8pv8's p.v is int8); K7's five
        # products int8 on fp32 tensors
        "fwd_q8_fp32": attn_bound(2, 866, 12, qk="int8", pv="fp32", lse=True,
                                  elem=4),
        "k7_fp32": bwd_bound(2, 866, 12, kind="int8", elem=4),
        "fwd_d128": attn_bound(BATCH, 1676, 6, d=128),
        "fwd_lse_d128": attn_bound(BATCH, 866, 6, lse=True, d=128),
        "bwd_d128": bwd_bound(BATCH, 866, 6, d=128),
        "fwd_d256": attn_bound(BATCH, 1676, 3, d=256),
        "fwd_lse_d256": attn_bound(BATCH, 866, 3, lse=True, d=256),
        "bwd_d256": bwd_bound(BATCH, 866, 3, d=256),
        "fwd_dn": attn_bound(BATCH, 1676, 2, d=384),
        "fwd_lse_dn": attn_bound(BATCH, 866, 2, d=384, lse=True),
        "bwd_dn": bwd_bound(BATCH, 866, 2, d=384),
        "qk8_dn": attn_bound(BATCH, 1676, 2, qk="int8", d=384),
        "fp8_dn": attn_bound(BATCH, 1676, 2, qk="fp8", d=384),
        "k7_dn": bwd_bound(BATCH, 866, 2, kind="int8", d=384),
        # fp32 at head_dim 64: three tf32 products a product
        "fwd_fp32": attn_bound(BATCH, 1676, 12, qk="tf32x3", pv="tf32x3",
                               elem=4),
        "fwd_lse_fp32": attn_bound(BATCH, 866, 12, qk="tf32x3",
                                   pv="tf32x3", lse=True, elem=4),
        "bwd_fp32": bwd_bound(BATCH, 866, 12, kind="tf32x3", elem=4),
    }
    # P1 k64big (48 programs) and P8 fc1 bf16 and e4m3 (32): the rigs' own
    # bounds
    from maest_tpu_torch.probes import fp8_mlp, mxu
    bounds["mxu"] = mxu.bound("k64big", 48)
    bounds["mlp"] = fp8_mlp.bound("fc1", "bf16", 32)
    bounds["mlp_fp8"] = fp8_mlp.bound("fc1", "fp8", 32)
    # P2 k64_i8q (48 programs) and P3 k64big_i8 (8): the rigs' own bounds
    from maest_tpu_torch.probes import int8, int8_2
    bounds["int8_probe"] = int8.bound("k64_i8q", 48)
    bounds["int8_big_probe"] = int8_2.bound("k64big_i8", 8)
    # P4 at the rig's bh 384: its int8 kind and fp8 beside it
    from maest_tpu_torch.probes import bwd_int8
    bounds["bwd_rig"] = bwd_int8.bound("int8")
    bounds["bwd_rig_fp8"] = bwd_int8.bound("fp8")
    src = "maest_tpu_torch/csrc/"
    # K1: the FFT kernel (launches on phase 6's main path, its largest error
    # of phases 3 and 36, phase 36's CUDA-graph medians) and its FMA control
    # (launches on phase 36's control steps); no one PyTorch call computes
    # the front-end (phase 36 times the stock one as a yardstick)
    m1 = k1["ms"]["K1"]
    print("kernels line: the launches of attention_fwd (K2), "
          "attention_fwd_lse (K3a) and attention_bwd (K3b) are the tagging "
          "path's (phase 6) and the 30 s recipe steps' (phase 11); "
          "launches_cli the training CLI's (phase 37); launches_parallel "
          "rank 0's over phase 38's parallel modes; launches_pipeline each "
          "rank's in each of phase 39's GPipe modes; attention_fwd's "
          "max_abs_err includes phase 37's at the eval's shape, phase 38's "
          "at tensor parallelism's local shapes and phase 39's at each "
          "rank's microbatch and eval shapes (K3a and K3b there too)",
          flush=True)
    print(f"kernels line: fused_logmel is the FFT kernel, fused_logmel_fma "
          f"its FMA control; phase 36's CUDA-graph medians at ({MEL_FRAMES}, "
          f"512), the stock PyTorch front-end {m1['stock']:.4f} ms beside "
          "them", flush=True)
    rows = [
        ("fused_logmel", "mel_kernel.cu", "maest_tpu/ops/mel_kernel.py:39",
         launches["mel"], max(mel_err, k1["err"]), (m1["fft"], m1["plain"]),
         "mel", None),
        ("fused_logmel_fma", "mel_kernel.cu", "maest_tpu/ops/mel_kernel.py:39",
         k1["launches"][("bfloat16", "control")], k1["err_control"],
         (m1["control"], m1["plain"]), "mel", None),
        ("attention_fwd", "attn_fwd_wgmma.cuh",
         "maest_tpu/ops/attention.py:176", launches["attention"],
         max(attn_err, cli["K2_err"], par["err"], pp["err"]), t["bfloat16"],
         "fwd",
         lib["fwd"]),
        ("attention_fwd_lse", "attn_fwd_wgmma.cuh",
         "maest_tpu/ops/attention.py:404", train_launches["fwd_lse"],
         max(train_err["o"], train_err["lse"]), tt["fwd_lse"], "fwd_lse",
         lib["fwd_lse"]),
        ("attention_bwd", "attn_bwd_wgmma.cuh",
         "maest_tpu/ops/attention.py:483", train_launches["bwd"],
         max(train_err[w] for w in ("dq", "dk", "dv")), tt["bwd"], "bwd",
         lib["bwd"]),
        ("attention_bwd_int8", "attn_bwd_q8_wgmma.cuh",
         "maest_tpu/ops/attention.py:530", k7_launches, k7["err"], k7["ms"],
         "k7", None),
        ("attention_bwd_split", "attn_bwd_wgmma.cuh",
         "maest_tpu/ops/attention.py:739", 0,
         max(k4_err[w] for w in ("dq", "dk", "dv")), tt["bwd_k4"], "k4",
         lib["bwd_k4"]),
    ]
    # P6a-c: times from phase 19's rig at (32, 1676); SDPA computes what
    # noexp_max computes, no PyTorch call the other two. P6d: the wgmma
    # route and its mma.sync control (the pass included), phase 19's
    # CUDA-graph medians of interleaved rounds at (32, 1676) beside SDPA's
    for var, line in (("mxu_only", 47), ("noexp_max", 63), ("novmax", 88)):
        rows.append((f"attention_probe_{var}", "attention_probe.cu",
                     f"scripts/attn_profile_r2.py:{line}", rig_launches[var],
                     probe_err[var], (rig["30s"][var]["ms"], probe_plain[var]),
                     "fwd", rig["30s"]["sdpa"]["ms"]
                     if var == "noexp_max" else None))
    print("kernels line: attention_probe_bf16s is P6d on K2's wgmma kernel "
          "(BF16S), attention_probe_bf16s_mma its mma.sync control with the "
          "PyTorch pre-scaling pass; phase 19's CUDA-graph medians at (32, "
          "1676) beside SDPA's, launches in phase 19's rig", flush=True)
    for var, file in (("bf16s", "attn_fwd_wgmma.cuh"),
                      ("bf16s_mma", "attention_probe.cu")):
        rows.append((f"attention_probe_{var}", file,
                     "scripts/attn_profile_r2.py:113", rig_launches[var],
                     probe_err[var], (p6d[var], probe_plain[var]), "fwd",
                     p6d["sdpa"]))
    # P6e (gh8, the TPU rig's group) on K2's wgmma kernel and its mma.sync
    # control, and P6f: times from phase 22's rig at (32, 1676), P6e's the
    # medians of its interleaved CUDA-graph rounds; gh computes K2's
    # function, whose library call is SDPA
    r30 = rig2["30s"]
    print("kernels line: attention_probe_gh is P6e on K2's wgmma kernel with "
          "G heads a block, attention_probe_gh_mma its mma.sync control; "
          "gh8 at (32, 1676), phase 22's medians of interleaved CUDA-graph "
          "rounds beside SDPA's; launches over every G in phase 22's rig; "
          "max_abs_err against each one's plain version (phase 20)",
          flush=True)
    rows.append(("attention_probe_gh", "attn_fwd_wgmma.cuh",
                 "scripts/attn_profile_r2.py:148",
                 sum(rig2_launches[f"gh{g}"] for g in (1, 2, 4, 8)),
                 p6ef["gh_err"], (r30["gh8"]["round_median"],
                                  p6ef["gh_plain"]), "fwd",
                 r30["sdpa"]["round_median"]))
    rows.append(("attention_probe_gh_mma", "attention_probe.cu",
                 "scripts/attn_profile_r2.py:148",
                 sum(rig2_launches[f"gh{g}_mma"] for g in (1, 2, 4, 8)),
                 p6ef["gh_mma_err"], (r30["gh8_mma"]["round_median"],
                                      p6ef["gh_mma_plain"]), "fwd",
                 r30["sdpa"]["round_median"]))
    rows.append(("attention_probe_int8", "attention_probe.cu",
                 "scripts/attn_profile_r2.py:226", rig2_launches["int8"],
                 p6ef["int8_err"], (r30["int8"]["ms"], p6ef["int8_plain"]),
                 "int8_rig", None))
    # P5: the wrapper's time (casts included) from phase 22's vpu rig. SDPA
    # computes bf16sm's function on its bf16 q, k, v (bf16 only rounds the
    # softmax's insides), as for bf16s; no PyTorch call computes the e4m3
    # kinds' (their q.k operands are e4m3-rounded) or fp8noexp's and
    # fp8nomask's (not attention)
    for vk in ("bf16sm", "fp8sm", "fp8noexp", "fp8nomask", "fp8lean"):
        rows.append((f"attention_vpu_{vk}", "attention_probe.cu",
                     "scripts/attn_vpu_probe.py:54", rig2_launches[vk],
                     vpu_err[vk], (vpu[vk]["ms"], vpu_plain[vk]), vk,
                     r30["sdpa"]["ms"] if vk == "bf16sm" else None))
    # P9: G1 (the production grid) at the rig's (100, 281); P7: the best
    # tile of phase 25's sweep at (32, 281), where the tile decides, and,
    # backward, at (32, 866), each timed again alone, beside its plain
    # version (the key tile's) and SDPA from phase 17; the fp32 8-bit
    # instances at (2, 866), qk8 for the forward (phase 23; no PyTorch
    # call multiplies 8-bit q.k)
    (best_f, fwd_ms), (best_b, bwd_ms) = alone["fwd"], alone["bwd"]
    print(f"kernels line: attention_probe_qpad G1 at (100, 281), "
          f"attention_probe_tile at its best (q rows, key tile) "
          f"({best_f.replace('x', ', ')}) at ({BATCH}, 281), "
          f"attention_bwd_tile at its best (rows, tile) "
          f"({best_b.replace('x', ', ')}) at ({BATCH}, 866), "
          f"attention_fwd_q8_fp32 qk8 with lse at (2, 866)", flush=True)
    rows += [
        ("attention_probe_qpad", "attention_probe.cu",
         "scripts/qpad_probe.py:46",
         sum(c for k, c in tune_launches.items() if k.startswith("qpad")),
         tiles["qpad_err"], (tune["qpad"]["100x281"]["qpad G1"],
                             tiles["plain"]["qpad"]), "qpad",
         lib["fwd_qpad"]),
        ("attention_probe_tile", "attention_probe.cu",
         "scripts/attn_tune.py:67",
         sum(c for k, c in tune_launches.items() if k.startswith("tile")),
         tiles["tile_err"], (fwd_ms, tiles["plain"][(
             "tile", int(best_f.split("x")[1]))]), "tile", lib["fwd_281"]),
        ("attention_bwd_tile", "attention_bwd.cu", "scripts/attn_tune.py:116",
         sum(c for k, c in tune_launches.items() if k.startswith("bwd ")),
         tiles["bwd_err"], (bwd_ms, tiles["plain"]["bwd"]),
         "bwd_tile", lib["bwd"]),
        ("attention_fwd_q8_fp32", "attention_fwd_q8.cu",
         "maest_tpu/ops/attention.py:140", q3["launches"]["fwd_q8_fp32"],
         q3["fwd_err"], q3["ms"]["qk8"], "fwd_q8_fp32", None),
        ("attention_bwd_int8_fp32", "attention_bwd_q8.cu",
         "maest_tpu/ops/attention.py:530", q3["launches"]["k7_fp32"],
         q3["k7_err"], q3["k7_ms"], "k7_fp32", None),
    ]
    # P1 k64big and P8 fc1 bf16 and e4m3 at the rigs' programs, on the
    # wgmma kernel and (the *_mma rows) its mma.sync control: the times of
    # phase 27's rigs (CUDA-graph replays in interleaved rounds with the
    # library's product: k64big's folded torch.matmul, fc1's torch.matmul
    # and torch._scaled_mm), errors and plain versions from phase 26,
    # launches of each wrapper over the rigs' run (the mlp rows: of their
    # operand type); K2 and K3b at D = 128 from phase 27, library SDPA
    r = wide["rigs"]
    print("kernels line: mma_probe_mxu (P1 k64big, 48 programs), "
          "mma_probe_mlp (P8 fc1 bf16, 32) and mma_probe_mlp_fp8 (fc1 e4m3) "
          "are the wgmma kernel; the *_mma rows its mma.sync control; phase "
          "27's rigs, CUDA-graph replays in interleaved rounds with the "
          "library's product; each mlp row's launches are of its operand "
          "type", flush=True)
    mw = wide["launches"]
    for which, file, sfx in (("wgmma", "mma_probe_wgmma.cuh", ""),
                             ("control", "mma_probe.cu", "_mma")):
        ms = "ms" if which == "wgmma" else "control_ms"
        rows += [
            ("mma_probe_mxu" + sfx, file, "scripts/mxu_probe.py:38",
             mw["mxu" + sfx], mma["err"][which]["k64big"],
             (r["mxu"]["k64big"][ms], mma["plain"]["k64big"]), "mxu",
             r["mxu"]["library_k64big"]["ms"]),
            ("mma_probe_mlp" + sfx, file, "scripts/fp8_mlp_probe.py:47",
             mw["mlp" + sfx + "_bf16"], mma["err"][which]["fc1_bf16"],
             (r["mlp"]["fc1_bf16"][ms], mma["plain"]["fc1_bf16"]), "mlp",
             r["mlp"]["library_fc1_bf16"]["ms"]),
            ("mma_probe_mlp_fp8" + sfx, file, "scripts/fp8_mlp_probe.py:47",
             mw["mlp" + sfx + "_e4m3"], mma["err"][which]["fc1_fp8"],
             (r["mlp"]["fc1_fp8"][ms], mma["plain"]["fc1_fp8"]), "mlp_fp8",
             r["mlp"]["library_fc1_fp8"]["ms"])]
    # K2/K3a at head_dim 128 on wgmma (launches on phase 27's path: tagging
    # at num_heads 6 and 8, one recipe step at 6; errors of phases 27 and
    # 43; phase 43's CUDA-graph medians beside SDPA's) and their mma.sync
    # control (launches on phase 43's control steps)
    print("kernels line: attention_fwd_d128 (K2 at (32, 1676, 6, 128)) and "
          "attention_fwd_lse_d128 (K3a at (32, 866, 6, 128)) are the wgmma "
          "kernel at D = 128, the *_d128_mma rows its mma.sync control; "
          "phase 43's medians of interleaved CUDA-graph rounds beside SDPA's, "
          "plain by events; launches on phase 27's path (the controls' on "
          "phase 43's control steps)", flush=True)
    m43 = d128["ms"]
    l43 = d128["launches"]
    rows += [
        ("attention_fwd_d128", "attn_fwd_wgmma.cuh",
         "maest_tpu/ops/attention.py:176", wide["launches"]["k2_d128"]
         + wide["launches"]["k2_d96"], max(wide["err"]["fwd_d128"],
                                           d128["err"]["K2"]),
         (m43["K2"]["wgmma"], m43["K2"]["plain"]), "fwd_d128",
         m43["K2"]["sdpa"]),
        ("attention_fwd_lse_d128", "attn_fwd_wgmma.cuh",
         "maest_tpu/ops/attention.py:404", wide["launches"]["k3a_d128"],
         max(wide["err"]["fwd_lse_d128"], d128["err"]["K3a"]),
         (m43["K3a"]["wgmma"], m43["K3a"]["plain"]), "fwd_lse_d128",
         m43["K3a"]["sdpa"]),
        ("attention_fwd_d128_mma", "attn_fwd_bf16.cuh",
         "maest_tpu/ops/attention.py:176", l43[("tagging", "control")][2],
         d128["err"]["control"], (m43["K2"]["control"], m43["K2"]["plain"]),
         "fwd_d128", m43["K2"]["sdpa"]),
        ("attention_fwd_lse_d128_mma", "attn_fwd_bf16.cuh",
         "maest_tpu/ops/attention.py:404", l43[("recipe", "control")][2],
         d128["err"]["control_lse"], (m43["K3a"]["control"],
                                      m43["K3a"]["plain"]), "fwd_lse_d128",
         m43["K3a"]["sdpa"]),
        ("attention_bwd_d128", "attention_bwd.cu",
         "maest_tpu/ops/attention.py:483", wide["launches"]["k3b_d128"],
         wide["err"]["bwd_d128"], wide["ms"]["bwd_d128"], "bwd_d128",
         wide["ms"]["bwd_d128_sdpa"]),
    ]
    # K2/K3a at head_dim 256 on wgmma (launches on phase 27's path: tagging
    # at num_heads 3, one recipe step; errors of phases 27 and 44; phase
    # 44's CUDA-graph medians beside SDPA's) and their mma.sync control
    # (launches on phase 44's control steps)
    m44, l44 = p44["ms"], p44["launches"]
    print("kernels line: attention_fwd_d256 (K2 at (32, 1676, 3, 256)) and "
          "attention_fwd_lse_d256 (K3a at (32, 866, 3, 256)) are the wgmma "
          "kernel of csrc/attn_fwd_d256_wgmma.cuh, the *_d256_mma rows its "
          "mma.sync control; phase 44's medians of interleaved CUDA-graph "
          "rounds beside SDPA's, plain by events; launches on phase 27's path "
          "(the controls' on phase 44's control steps)", flush=True)
    rows += [
        ("attention_fwd_d256", "attn_fwd_d256_wgmma.cuh",
         "maest_tpu/ops/attention.py:176", wide["launches"]["k2_d256"],
         max(wide["err"]["fwd_d256"], p44["err"]["fwd"]),
         (m44["K2"]["wgmma"], m44["K2"]["plain"]), "fwd_d256",
         m44["K2"]["sdpa"]),
        ("attention_fwd_lse_d256", "attn_fwd_d256_wgmma.cuh",
         "maest_tpu/ops/attention.py:404", wide["launches"]["k3a_d256"],
         max(wide["err"]["fwd_lse_d256"], p44["err"]["fwd_lse"]),
         (m44["K3a"]["wgmma"], m44["K3a"]["plain"]), "fwd_lse_d256",
         m44["K3a"]["sdpa"]),
        ("attention_fwd_d256_mma", "attn_fwd_bf16.cuh",
         "maest_tpu/ops/attention.py:176",
         l44[("tagging_d256", "control")][3], p44["err"]["fwd_control"],
         (m44["K2"]["control"], m44["K2"]["plain"]), "fwd_d256",
         m44["K2"]["sdpa"]),
        ("attention_fwd_lse_d256_mma", "attn_fwd_bf16.cuh",
         "maest_tpu/ops/attention.py:404",
         l44[("recipe_d256", "control")][3], p44["err"]["fwd_lse_control"],
         (m44["K3a"]["control"], m44["K3a"]["plain"]), "fwd_lse_d256",
         m44["K3a"]["sdpa"]),
    ]
    # K3b at head_dim 256 on wgmma (launches on phase 27's recipe step, its
    # errors of phases 27 and 42, phase 42's CUDA-graph medians at (32, 866,
    # 3, 256) beside SDPA's fwd+bwd - fwd) and its mma.sync control
    # (launches on phase 42's control steps)
    m42 = bd["ms"][(BATCH, 866)]
    print("kernels line: attention_bwd_d256 is K3b at head_dim 256 on wgmma "
          "(csrc/attn_bwd_d256_wgmma.cuh), attention_bwd_d256_mma its mma.sync "
          "control; phase 42's CUDA-graph medians at (32, 866, 3, 256), plain "
          "by events, SDPA fwd+bwd - fwd by events; max_abs_err against "
          "plain over phases 27 and 42 (phase 42 holds each gradient within "
          f"{D256_REL_TOL} of max(1, its max) of plain and the tiled plain "
          "version)", flush=True)
    rows += [
        ("attention_bwd_d256", "attn_bwd_d256_wgmma.cuh",
         "maest_tpu/ops/attention.py:483", wide["launches"]["k3b_d256"],
         max(wide["err"]["bwd_d256"], bd["abs"]["route"]),
         (m42["wgmma"], m42["plain"]), "bwd_d256", m42["sdpa_fwd_bwd"]),
        ("attention_bwd_d256_mma", "attention_bwd.cu",
         "maest_tpu/ops/attention.py:483", bd["launches"]["control"][1],
         bd["abs"]["control"], (m42["control"], m42["plain"]), "bwd_d256",
         m42["sdpa_fwd_bwd"]),
    ]
    # P2 at k64_i8q (48 programs; no PyTorch call quantises inside a
    # product) and P3 at k64big_i8 (8; torch._int_mm is 2-D, so no single
    # PyTorch call computes the 8 programs' products: the rig's line gives
    # one _int_mm a program beside it): the kernel's time from phase 28's
    # rigs (CUDA-graph replays of the call, its copies included), the plain
    # version's from phase 28
    r = i8["rigs"]
    print(f"kernels line: int8_probe at k64_i8q (48 programs), int8_big_probe"
          f" at k64big_i8 (8 programs; library none as one call, one "
          f"torch._int_mm a program {r['p3']['k64big_i8']['library_ms']:.4f}"
          f" ms)", flush=True)
    rows += [
        ("int8_probe", "mma_probe.cu", "scripts/int8_probe.py:46",
         i8["launches"]["p2"], i8["err"]["k64_i8q"],
         (r["p2"]["k64_i8q"]["ms"], i8["plain"]["k64_i8q"]), "int8_probe",
         None),
        ("int8_big_probe", "mma_probe.cu", "scripts/int8_probe2.py:44",
         i8["launches"]["p3"], i8["err"]["k64big_i8"],
         (r["p3"]["k64big_i8"]["ms"], i8["plain"]["k64big_i8"]),
         "int8_big_probe", None),
    ]
    # K2 and K3b's runtime-width instances at head_dim 384 (phase 27: K2 at
    # (32, 1676, 2, 384), K3b at (32, 866, 2, 384); library SDPA's efficient
    # attention, its flash backend takes head_dim up to 256); P4's int8 and
    # fp8 kinds at bh 384 (phase 29's rig, CUDA-graph replays of the call,
    # its layout pass included; no PyTorch call computes an 8-bit
    # attention backward)
    print("kernels line: attention_fwd_dn (K2 at (32, 1676, 2, 384)) and "
          "attention_fwd_lse_dn (K3a at (32, 866, 2, 384)) are the _dn wgmma "
          "kernel, the *_dn_mma rows its mma.sync control, phase 27's "
          "CUDA-graph medians beside SDPA's efficient attention, launches on "
          "phase 27's tagging and recipe steps (the controls' with "
          "_K2_CONTROL); attention_bwd_dn at head_dim 384 is the wgmma "
          "kernels of csrc/attn_bwd_dn_wgmma.cuh, attention_bwd_dn_mma their "
          "mma.sync control, phase 44's medians of interleaved CUDA-graph "
          "rounds, library SDPA's efficient-attention backward alone, "
          "launches on phase 27's recipe step (the control's on phase 44's "
          "control steps); bwd_rig at the rig's int8 kind, "
          "bwd_rig_fp8 at its fp8 kind, both at bh 384", flush=True)
    dn, wl = wide["dn"], wide["launches"]
    dk2, dk3 = dn["ms"]["K2"], dn["ms"]["K3a"]
    rows += [
        ("attention_fwd_dn", "attn_fwd_dn_wgmma.cuh",
         "maest_tpu/ops/attention.py:176", wl["k2_d384"],
         max(wide["err"]["fwd_d384"], dn["err"]["wgmma"]),
         (dk2["wgmma"], dk2["plain"]), "fwd_dn", dk2["sdpa"]),
        ("attention_fwd_lse_dn", "attn_fwd_dn_wgmma.cuh",
         "maest_tpu/ops/attention.py:404", wl["k3a_d384"],
         max(wide["err"]["fwd_lse_d384"], dn["err"]["wgmma_lse"]),
         (dk3["wgmma"], dk3["plain"]), "fwd_lse_dn", dk3["sdpa"]),
        ("attention_fwd_dn_mma", "attention_fwd.cu",
         "maest_tpu/ops/attention.py:176", wl["k2_d384_control"],
         dn["err"]["control"], (dk2["control"], dk2["plain"]), "fwd_dn",
         dk2["sdpa"]),
        ("attention_fwd_lse_dn_mma", "attention_fwd.cu",
         "maest_tpu/ops/attention.py:404", wl["k3a_d384_control"],
         dn["err"]["control_lse"], (dk3["control"], dk3["plain"]),
         "fwd_lse_dn", dk3["sdpa"]),
        ("attention_bwd_dn", "attn_bwd_dn_wgmma.cuh",
         "maest_tpu/ops/attention.py:483", wide["launches"]["k3b_d384"],
         max(wide["err"]["bwd_d384"], p44["abs"]["bwd"]),
         (p44["ms"]["K3b"]["wgmma"], p44["ms"]["K3b"]["plain"]), "bwd_dn",
         p44["ms"]["K3b"]["sdpa"]),
        ("attention_bwd_dn_mma", "attention_bwd.cu",
         "maest_tpu/ops/attention.py:483",
         p44["launches"][("recipe_d384", "control")][4],
         p44["abs"]["bwd_control"],
         (p44["ms"]["K3b"]["control"], p44["ms"]["K3b"]["plain"]), "bwd_dn",
         p44["ms"]["K3b"]["sdpa"]),
        ("bwd_rig", "attention_bwd_q8.cu", "scripts/bwd_int8_probe.py:52",
         p4["launches"]["int8"], p4["err"]["int8"],
         (p4["rig"]["int8"]["ms"], p4["plain"]["int8"]), "bwd_rig", None),
        ("bwd_rig_fp8", "attention_bwd.cu", "scripts/bwd_int8_probe.py:52",
         p4["launches"]["fp8"], p4["err"]["fp8"],
         (p4["rig"]["fp8"]["ms"], p4["plain"]["fp8"]), "bwd_rig_fp8", None),
    ]
    # K2's mma.sync kernel, the control of the wgmma one (phase 30: its
    # launches on the tagging steps with the control, CUDA-graph medians at
    # (32, 1676) beside SDPA's); the 8-bit runtime-width instances (phase
    # 23's launches at head_dim 320 and 512 with phase 27's, errors and
    # times at head_dim 384: forwards at (32, 1676, 2, 384), K7 at (32,
    # 866, 2, 384); no PyTorch call multiplies 8-bit operands)
    k2 = wg["ms"][("K2", BATCH, 1676)]
    print("kernels line: attention_fwd and attention_fwd_lse are the wgmma "
          "kernel; attention_fwd_mma, its control, CUDA-graph medians of "
          "phase 30 at (32, 1676) beside SDPA's, launches on phase 30's "
          "control steps; the 8-bit _dn rows at head_dim 384, qk8 and fp8 "
          "(the wrappers, their PyTorch pass included)", flush=True)
    rows += [
        ("attention_fwd_mma", "attn_fwd_bf16.cuh",
         "maest_tpu/ops/attention.py:176",
         wg["launches"][("tagging", "control")][2], wg["err"]["control"],
         (k2["control"], t["bfloat16"][1]), "fwd", k2["sdpa"]),
        ("attention_fwd_int8_dn", "attention_fwd_q8.cu",
         "maest_tpu/ops/attention.py:140",
         q3["dn8_launches"]["int8"] + wide["launches"]["k5_d384"],
         max(wide["err"]["qk8_d384"], wide["err"]["qk8pv8_d384"]),
         wide["ms"]["qk8_d384"], "qk8_dn", None),
        ("attention_fwd_fp8_dn", "attention_fwd_q8.cu",
         "maest_tpu/ops/attention.py:390", q3["dn8_launches"]["fp8"],
         max(wide["err"]["fp8_d384"], wide["err"]["fp8pv8_d384"]),
         wide["ms"]["fp8_d384"], "fp8_dn", None),
        ("attention_bwd_int8_dn", "attention_bwd_q8.cu",
         "maest_tpu/ops/attention.py:530", q3["dn8_launches"]["k7"],
         wide["err"]["k7_d384"], wide["ms"]["k7_d384"], "k7_dn", None),
    ]
    # K3b/K4's mma.sync kernels, the control of the wgmma backward (phase 31:
    # its launches on the 30 s recipe steps with the control, CUDA-graph
    # medians at (32, 866) beside SDPA's backward alone, the aten op)
    k3b = bw["ms"][(BATCH, 866)]
    print("kernels line: attention_bwd and attention_bwd_split are the wgmma "
          "backward; attention_bwd_mma, its control, CUDA-graph medians of "
          "phase 31 at (32, 866) beside SDPA's backward, launches on phase "
          "31's control steps", flush=True)
    rows.append(
        ("attention_bwd_mma", "attention_bwd.cu",
         "maest_tpu/ops/attention.py:483",
         bw["launches"][("recipe", "control")][1], bw["err"]["control"],
         (k3b["control"], tt["bwd"][1]), "bwd", k3b["sdpa"]))
    # K7's mma.sync kernels, the control of the wgmma K7 (phase 32: its
    # launches on the int8 recipe steps with the control, its error against
    # plain, its CUDA-graph median at (32, 866); no PyTorch call computes an
    # int8 attention backward)
    print("kernels line: attention_bwd_int8 is the wgmma K7; "
          "attention_bwd_int8_mma, its control, CUDA-graph median of phase 32 "
          "at (32, 866), launches on phase 32's control steps", flush=True)
    rows.append(
        ("attention_bwd_int8_mma", "attention_bwd_q8.cu",
         "maest_tpu/ops/attention.py:530", k7w["launches"]["control"][1],
         k7w["err_control"], (k7w["ms"][(BATCH, 866)]["control"], k7["ms"][1]),
         "k7", None))
    # fp32 at head_dim 64 on tf32 wgmma (phase 34: launches on its tf32
    # tagging and recipe steps, the checks' largest errors, CUDA-graph
    # medians beside plain's and SDPA's efficient attention, the backward's
    # alone) and the scalar FMA controls (launches on phase 34's control
    # steps); bounds: three tf32 products a product, the lower of the two
    print("kernels line: attention_fwd_fp32, attention_fwd_lse_fp32 and "
          "attention_bwd_fp32 are the tf32 kernels (fp32 at head_dim 64); "
          "attention_fwd_fp32_fma and attention_bwd_fp32_fma their scalar FMA "
          "controls; phase 34's CUDA-graph medians at (32, 1676) and (32, "
          "866), launches on its fp32 tagging and recipe steps, SDPA's "
          "efficient attention", flush=True)
    m_ = tf["ms"]
    rows += [
        ("attention_fwd_fp32", "attn_fwd_tf32.cuh",
         "maest_tpu/ops/attention.py:176",
         tf["launches"][("tagging", "tf32")][0], tf["err"]["fwd"],
         (m_["K2"]["tf32"], m_["K2"]["plain"]), "fwd_fp32", m_["K2"]["sdpa"]),
        ("attention_fwd_lse_fp32", "attn_fwd_tf32.cuh",
         "maest_tpu/ops/attention.py:404",
         tf["launches"][("recipe", "tf32")][1],
         max(tf["err"]["fwd"], tf["err"]["lse"]),
         (m_["K3a"]["tf32"], m_["K3a"]["plain"]), "fwd_lse_fp32",
         m_["K3a"]["sdpa"]),
        ("attention_bwd_fp32", "attn_bwd_tf32.cuh",
         "maest_tpu/ops/attention.py:483",
         tf["launches"][("recipe", "tf32")][2], tf["err"]["bwd"],
         (m_["K3b"]["tf32"], m_["K3b"]["plain"]), "bwd_fp32",
         m_["K3b"]["sdpa"]),
        ("attention_fwd_fp32_fma", "attention_fwd.cu",
         "maest_tpu/ops/attention.py:176",
         tf["launches"][("tagging", "control")][3], tf["err"]["fwd_control"],
         (m_["K2"]["control"], m_["K2"]["plain"]), "fwd_fp32",
         m_["K2"]["sdpa"]),
        ("attention_bwd_fp32_fma", "attention_bwd.cu",
         "maest_tpu/ops/attention.py:483",
         tf["launches"][("recipe", "control")][4], tf["err"]["bwd_control"],
         (m_["K3b"]["control"], m_["K3b"]["plain"]), "bwd_fp32",
         m_["K3b"]["sdpa"]),
    ]
    # K5/K6 on wgmma (phase 35: launches on phase 14's tagging steps, each
    # mode's largest error of phases 13 and 35, CUDA-graph medians at (32,
    # 1676) with the pass, plain's by CUDA events) and their mma.sync
    # control (launches on phase 35's control tagging steps); no PyTorch
    # call multiplies 8-bit operands
    print("kernels line: attention_fwd_int8 (qk8), attention_fwd_int8_pv8 "
          "(qk8pv8), attention_fwd_fp8 (fp8) and attention_fwd_fp8_pv8 "
          "(fp8pv8) are the wgmma route with its CUDA pass; the *_mma rows "
          "their mma.sync control with the PyTorch quantisation; phase 35's "
          "CUDA-graph medians at (32, 1676), launches on phase 14's and "
          "phase 35's tagging steps", flush=True)
    q8_rows = {"qk8": "attention_fwd_int8", "qk8pv8": "attention_fwd_int8_pv8",
               "fp8": "attention_fwd_fp8", "fp8pv8": "attention_fwd_fp8_pv8"}
    for mode, row in q8_rows.items():
        rep_line = ("maest_tpu/ops/attention.py:140" if mode.startswith("qk8")
                    else "maest_tpu/ops/attention.py:390")
        ms = q8w["ms"][mode]
        rows += [
            (row, "attn_fwd_q8_wgmma.cuh", rep_line, q8_launches[mode],
             max(q8w["err"][mode], q8["err"][mode]),
             (ms["wgmma"], ms["plain"]), mode, None),
            (row + "_mma", "attn_fwd_q8.cuh", rep_line,
             q8w["launches"][(mode, "control")], q8w["err_control"][mode],
             (ms["control"], ms["plain"]), mode, None)]
    kernels = [{"name": name, "route": "cuda", "source": src + file,
                "replaces": rep, "launches": n, "max_abs_err": err,
                "ms": ms[0], "plain_ms": ms[1], "bound_ms": bounds[key][0],
                "bound_by": bounds[key][1], "library_ms": library}
               for name, file, rep, n, err, ms, key, library in rows]
    for k in kernels:  # the training CLI's own launches (phases 37-39)
        cli_key = {"attention_fwd": "K2", "attention_fwd_lse": "K3a",
                   "attention_bwd": "K3b"}.get(k["name"])
        if cli_key:
            k["launches_cli"] = cli[cli_key]
            k["launches_parallel"] = par[cli_key]
            k["launches_pipeline"] = {
                mode: [r[cli_key] for r in ranks]
                for mode, ranks in pp["launches"].items()}
    # the served path's launches under CUDA-graph replay (phase 40), by
    # torch.profiler's kernel names over one replay of each bucket
    print("kernels line: launches_serve of fused_logmel (K1), attention_fwd "
          "(K2) and attention_fwd_fp32 are phase 40's graph-backed serving: "
          "per_batch = torch.profiler's count by kernel name over one replay "
          "(the same in every bucket), replays = the batches replayed in the "
          "phase, total = each bucket's count times its replays", flush=True)
    for k in kernels:
        key = {"fused_logmel": "K1", "attention_fwd": "K2"}.get(k["name"])
        if key:
            k["launches_serve"] = tg["serve"][key]
        if k["name"] == "attention_fwd_fp32":
            k["launches_serve"] = tg["serve_fp32"]
    # phase 41's launches: K1 and K2 (bf16 and fp32) a predict_labels call,
    # K3a and K3b a train step, the controls over every call of the phase
    print("kernels line: launches_surgery of fused_logmel (K1), "
          "attention_fwd (K2), attention_fwd_fp32, attention_fwd_lse (K3a), "
          "attention_bwd (K3b) and the controls are phase 41's: each "
          "predict_labels call of the per-frequency and non-distilled "
          "models, each one's bf16 train step through the kernels, and the "
          "exported model's forward (the controls summed over the phase); "
          "the max_abs_err of K2, fp32 K2, K3a and K3b include phase 41's at "
          "the non-distilled shapes", flush=True)
    sl = sg["launches"]
    per_call = {
        "fused_logmel": ("K1", "predict_labels"),
        "attention_fwd": ("K2", "bfloat16 predict_labels"),
        "attention_fwd_fp32": ("K2", "float32 predict_labels"),
        "attention_fwd_lse": ("K3a", "train step kernels"),
        "attention_bwd": ("K3b", "train step kernels")}
    surgery_err = {"attention_fwd": "K2", "attention_fwd_fp32": "K2_fp32",
                   "attention_fwd_lse": "K3a", "attention_bwd": "K3b"}
    for k in kernels:
        if k["name"] in per_call:
            key, what = per_call[k["name"]]
            k["launches_surgery"] = {call: n[key] for call, n in sl.items()
                                     if what in call}
        elif k["name"] in _surgery_counters():
            k["launches_surgery"] = sum(n[k["name"]] for n in sl.values())
        if k["name"] in surgery_err:  # phase 41's shapes too
            k["max_abs_err"] = max(k["max_abs_err"],
                                   sg["err"][surgery_err[k["name"]]])
    print("phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(seconds.items(),
                                          key=lambda kv: -kv[1]))
          + f"; the script {time.perf_counter() - t_main:.1f} s", flush=True)
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
