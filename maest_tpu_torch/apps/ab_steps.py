"""Time the bf16 and fp32 tagging steps, the bf16 tagging step under each
8-bit attention mode, the 30 s and 10 s pre-training recipe steps and the
30 s recipe step with the int8 attention backward of one or more
checkouts of this repo on one CUDA card, each run in a process of its own,
in the order given:

    python3 maest_tpu_torch/apps/ab_steps.py PARENT . . PARENT

Each argument is the root of a checkout (``git archive`` of a commit,
unpacked into a git-ignored directory, or ``.``). Its process imports that
checkout's ``maest_tpu_torch`` and ``chip_smoke.py``, builds its kernels,
and times three steps with CUDA events, one step at a time after two
warm-up steps; it reports the median and every reading:

- tagging: ``BucketPrograms._activations`` on 32 clips of 30 s, bf16,
  random weights (wave -> mel -> ViT-B -> sigmoid, as ``chip_smoke.py``
  phase 8 times it), the same in fp32, ``get_maest``'s default dtype
  (as phase 34 times it), and in bf16 with ``attention_quant`` "qk8",
  "qk8pv8", "fp8" and "fp8pv8" (K5 / K6 in place of K2, as phase 14 times
  them);
- training: ``chip_smoke._recipe`` of ``maest_30s_from_passt_pretrain``
  (ViT-B, batch 32, N 866, bf16 over fp32 parameters), as phase 12, and
  of ``maest_10s_from_passt_pretrain`` (batch 100, N 281), and the 30 s
  step again with ``maest.attention_bwd_quant=int8`` (K7 in place of K3b,
  as phase 16 runs it).

Compare readings only within one run: the card's host is shared, so single
steps spread by several per cent between runs. Prints the card's name and
power limit, one JSON line per checkout, and a summary.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

STEPS = 11

CHILD = r"""
import json, sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
import numpy as np, torch
sys.path.insert(0, "tests")
import chip_smoke as cs
from maest_tpu_torch import get_maest
from maest_tpu_torch.ops import _build
from maest_tpu_torch.serve import BucketPrograms

steps = int(sys.argv[1])
libs = sorted(p.stem for p in Path("maest_tpu_torch/csrc").glob("*.cu"))
with ThreadPoolExecutor(len(libs)) as pool:
    list(pool.map(_build.build, libs))
dev = torch.device("cuda:0")
torch.cuda.set_device(dev)


def single_steps(fn):
    for _ in range(2):
        fn()
    ms = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms)), [round(x, 3) for x in ms]


model = get_maest(cs.ARCH, pretrained=False, dtype=torch.bfloat16, device=dev)
prog = BucketPrograms(model, buckets=(cs.BATCH,), fused_wave=True)
waves = torch.from_numpy(np.random.default_rng(2).standard_normal(
    (cs.BATCH, cs.CLIP)).astype(np.float32) * 0.1).to(dev)
with torch.inference_mode():
    tag = single_steps(lambda: prog._activations(waves))
del model, prog
torch.cuda.empty_cache()
model = get_maest(cs.ARCH, pretrained=False, device=dev)  # fp32
prog = BucketPrograms(model, buckets=(cs.BATCH,), fused_wave=True)
with torch.inference_mode():
    tag32 = single_steps(lambda: prog._activations(waves))
del model, prog
torch.cuda.empty_cache()
tag8 = {}
for mode in ("qk8", "qk8pv8", "fp8", "fp8pv8"):
    model = get_maest(cs.ARCH, pretrained=False, dtype=torch.bfloat16,
                      device=dev, attention_quant=mode)
    prog = BucketPrograms(model, buckets=(cs.BATCH,), fused_wave=True)
    with torch.inference_mode():
        tag8[mode] = single_steps(lambda: prog._activations(waves))
    del model, prog
    torch.cuda.empty_cache()
del waves

cfg, mcfg, net, state, step, data = cs._recipe(dev, cs.RECIPE, cs.BATCH, 2)
gen = torch.Generator().manual_seed(2)
train = single_steps(lambda: step(state, data, gen))
del net, state, step, data
torch.cuda.empty_cache()
cfg, mcfg, net, state, step, data = cs._recipe(
    dev, "maest_10s_from_passt_pretrain", 100, 2)
train10 = single_steps(lambda: step(state, data, gen))
del net, state, step, data
torch.cuda.empty_cache()
cfg, mcfg, net, state, step, data = cs._recipe(
    dev, cs.RECIPE, cs.BATCH, 2, ["maest.attention_bwd_quant=int8"])
train8 = single_steps(lambda: step(state, data, gen))
print(json.dumps({"tag_ms": tag[0], "tag_steps": tag[1],
                  "tag_fp32_ms": tag32[0], "tag_fp32_steps": tag32[1],
                  **{f"tag_{m}_ms": t[0] for m, t in tag8.items()},
                  **{f"tag_{m}_steps": t[1] for m, t in tag8.items()},
                  "train_ms": train[0], "train_steps": train[1],
                  "train10_ms": train10[0], "train10_steps": train10[1],
                  "train_int8_ms": train8[0], "train_int8_steps": train8[1]}))
"""


def main(roots: list[str]) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    rows = []
    for i, root in enumerate(roots):
        out = subprocess.run([sys.executable, "-c", CHILD, str(STEPS)],
                             cwd=Path(root).resolve(), capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        row = {"run": i, "root": root, **json.loads(
            out.stdout.strip().splitlines()[-1])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for row in rows:
        print(f"run {row['run']} {row['root']}: tagging batch-32 30 s bf16 "
              f"median {row['tag_ms']:.3f} ms, in fp32 {row['tag_fp32_ms']:.3f}"
              f" ms, in bf16 under qk8 {row['tag_qk8_ms']:.3f}, qk8pv8 "
              f"{row['tag_qk8pv8_ms']:.3f}, fp8 {row['tag_fp8_ms']:.3f}, "
              f"fp8pv8 {row['tag_fp8pv8_ms']:.3f} ms, 30 s recipe step B32 median "
              f"{row['train_ms']:.3f} ms, 10 s recipe step B100 median "
              f"{row['train10_ms']:.3f} ms, 30 s recipe step B32 with the int8 "
              f"backward median {row['train_int8_ms']:.3f} ms, of {STEPS} "
              f"single steps each [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
