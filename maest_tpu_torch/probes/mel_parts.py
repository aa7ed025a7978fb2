"""Where K1's time goes on the card: the FFT mel kernel built with its later
stages taken out, each build timed in a process of its own.

    python -m maest_tpu_torch.probes.mel_parts [--rounds 7]

Builds copies of ``csrc/mel_kernel.cu`` under ``build/maest_tpu_torch/
mel_parts/`` (``_build.NVCC_FLAGS``), each with one more stage of
``logmel_fft_kernel`` left in:

  ring    the TMA ring and each frame's first read from shared memory; 3
          floats stored a frame (the loads and the stores' floor)
  fft     and the window, the 256-point FFT and the split step's power
          spectrum; the band sums and the log left out
  bands   and the band sums; the log left out
  full    the kernel as the port runs it

and times each at (60032, 512), 32 clips of 30 s of N(0, 0.1^2) noise, by
CUDA-graph replays (``probes.attn_profile.graph_ms``, 20 launches a
replay, ``--rounds`` replays; median, min and max), beside the bytes bound
(0.0436 ms at 3.35 TB/s). The differences between lines are what each
stage adds where the stages overlap as they do in the kernel; only
``full`` computes the front-end. Raises without a card or nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from ..ops import _build

_CONT = "    if (!live) continue;\n"
_LOOP = ("      for (int q = 0; q < width; ++q) acc = fmaf(pw[start + q], "
         "wts[off + q], acc);\n")
_LOG = "      float v = log10f(1.f + acc * scale);\n"
_NO_LOG = "      float v = acc * scale;\n"
# each stage: the lines of the source replaced to leave it and the earlier
# ones alone
PARTS = {
    "ring": [(_CONT, _CONT + "    if (lane < 3) out[row * n_mels + lane] = "
              "a[0].x + a[7].y;\n    continue;\n")],
    "fft": [(_LOOP, ""), (_LOG, _NO_LOG)],
    "bands": [(_LOG, _NO_LOG)],
    "full": [],
}

_TIME = """
import ctypes, json, sys
import numpy as np, torch
from maest_tpu_torch.dsp.mel import frame_waveforms
from maest_tpu_torch.ops import _build, mel_kernel as M
from maest_tpu_torch.probes.attn_profile import graph_ms
_build._libs["mel_kernel"] = ctypes.CDLL(sys.argv[1])
dev = torch.device("cuda")
waves = torch.from_numpy(np.random.default_rng(36).standard_normal(
    (32, 480000)).astype(np.float32) * 0.1).to(dev)
f = frame_waveforms(waves).reshape(-1, 512).contiguous()
err = (M.fused_logmel_from_frames(f)
       - M.fused_logmel_from_frames_reference(f)).abs().max().item()
ms = sorted(graph_ms(lambda: M.fused_logmel_from_frames(f), 20, dev, reps=1)
            for _ in range(int(sys.argv[2])))
print(json.dumps([f.shape[0], err, ms]))
"""


def build(part: str) -> str:
    """The library of ``part``'s copy of ``csrc/mel_kernel.cu``."""
    src = (_build.CSRC / "mel_kernel.cu").read_text()
    for old, new in PARTS[part]:
        if src.count(old) != 1:
            raise RuntimeError(f"mel_parts {part}: the line to replace is "
                               f"not in csrc/mel_kernel.cu once: {old!r}")
        src = src.replace(old, new)
    root = _build.BUILD_DIR / "mel_parts" / part
    root.mkdir(parents=True, exist_ok=True)
    (root / "mel_kernel.cu").write_text(src)
    out = root / "mel_kernel.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(root / "mel_kernel.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on mel_parts {part}:\n"
                           + proc.stdout + proc.stderr)
    return str(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="K1's time with its later stages taken out")
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    with ThreadPoolExecutor(len(PARTS)) as pool:  # one nvcc a copy
        libs = dict(zip(PARTS, pool.map(build, PARTS)))
    bound = 60032 * (512 + 96) * 4 / 3.35e12 * 1e3
    out = {}
    for part, lib in libs.items():
        proc = subprocess.run([sys.executable, "-c", _TIME, lib,
                               str(args.rounds)], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"mel_parts {part} failed:\n{proc.stderr}")
        frames, err, ms = json.loads(proc.stdout.strip().splitlines()[-1])
        med = ms[len(ms) // 2]
        out[part] = med
        print(f"mel_parts {part:5s} ({frames}, 512): {med:.4f} ms (min "
              f"{ms[0]:.4f}, max {ms[-1]:.4f}), {med / bound:.2f}x the bytes "
              f"bound {bound:.4f} ms; max|out - plain| {err:.3e}"
              + (" (the front-end)" if part == "full" else
                 " (not the front-end)"), flush=True)
    return out


if __name__ == "__main__":
    main()
