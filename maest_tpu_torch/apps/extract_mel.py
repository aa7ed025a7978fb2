"""Offline mel-spectrogram extraction to ``.mmap`` files, port of
``maest_tpu/apps/extract_mel.py`` (numpy and scipy only, as there).

The dataset-side equivalent of the reference's Essentia extractor
(reference: helpers/melspectrogram_extractor.py:15-51): 16 kHz mono,
frame 512 / hop 256, 96 slaney-mel bands, power spectrum,
``log10(1 + 10000 x)`` compression, float16, center-trimmed to a maximum
of 300 s, written as a raw ``np.memmap`` with layout ``(frames, 96)``
(consumed by ``data.dataset.MelChunkDataset``; reference layout per
``discogs/dataset.py:90-92``).

The compute path is the port's numpy mel (``dsp.mel.log_mel_spectrogram_np``,
the same arithmetic as the JAX package's), which the card's front-end
matches within its tolerance, instead of the reference's Essentia-vs-
torchaudio gap (models/helpers/melspectrogram.py:8-10).

Audio input: ``.wav`` (stdlib/scipy), ``.npy`` raw waveform arrays, or
anything ffmpeg can decode when an ``ffmpeg`` binary is present (without one,
mp3 and other compressed formats are refused).

Usage:
    python -m maest_tpu_torch.apps.extract_mel AUDIO... --out-dir MELS [--workers 8]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

SAMPLE_RATE = 16000
MAX_SECONDS = 300.0


def _resample(wave: np.ndarray, sr: int, target: int = SAMPLE_RATE) -> np.ndarray:
    if sr == target:
        return wave
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target)
    return resample_poly(wave, target // g, sr // g).astype(np.float32)


def load_audio(path: Path) -> np.ndarray:
    """Decode to mono float32 @16 kHz."""
    suffix = path.suffix.lower()
    if suffix == ".npy":
        wave = np.load(path).astype(np.float32)
        if wave.ndim == 2:
            wave = wave.mean(axis=-1 if wave.shape[-1] <= 2 else 0)
        return wave
    if suffix == ".wav":
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        data = np.asarray(data)
        if data.dtype.kind == "i":
            data = data.astype(np.float32) / float(np.iinfo(data.dtype).max)
        elif data.dtype.kind == "u":
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        if data.ndim == 2:
            data = data.mean(axis=1)
        return _resample(data, sr)
    # compressed formats -> ffmpeg (gated)
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"cannot decode {path.suffix} without ffmpeg; provide .wav/.npy "
            "input or install ffmpeg"
        )
    try:
        proc = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", str(path), "-f", "f32le",
             "-ac", "1", "-ar", str(SAMPLE_RATE), "-"],
            capture_output=True, check=True,
        )
    except subprocess.CalledProcessError as e:
        # CalledProcessError's message carries only the exit status; the
        # actual decode diagnostic (bad file vs missing codec) is on stderr
        raise RuntimeError(
            f"ffmpeg failed on {path}: "
            f"{e.stderr.decode(errors='replace').strip() or 'no stderr'}"
        ) from e
    return np.frombuffer(proc.stdout, np.float32).copy()


def melspectrogram_to_mmap(wave: np.ndarray, out_path: Path,
                           max_seconds: float = MAX_SECONDS) -> Path:
    """Compressed log-mel -> float16 raw memmap, center-trimmed.

    Trim happens on the mel frames (center ``max_seconds`` worth), matching
    the reference behavior (helpers/melspectrogram_extractor.py:37-44).
    """
    from ..dsp.mel import MelConfig, log_mel_spectrogram_np

    cfg = MelConfig()
    mel = log_mel_spectrogram_np(wave, cfg, normalize=False)  # (96, T)
    mel = mel.T.astype(np.float16)  # (T, 96)
    # derive from the SAME MelConfig that produced the frames — a literal
    # hop here would silently disagree with the file layout if the config
    # ever changed
    max_frames = int(max_seconds * cfg.sample_rate / cfg.hop_length)
    if mel.shape[0] > max_frames:
        start = (mel.shape[0] - max_frames) // 2
        mel = mel[start:start + max_frames]
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fp = np.memmap(out_path, dtype=np.float16, mode="w+", shape=mel.shape)
    fp[:] = mel
    fp.flush()
    del fp
    return out_path


def extract_one(audio_path: str, out_dir: str, suffix: str = ".mmap",
                out_name: str | None = None) -> str:
    path = Path(audio_path)
    out_path = Path(out_dir) / ((out_name or path.stem) + suffix)
    wave = load_audio(path)
    melspectrogram_to_mmap(wave, out_path)
    return str(out_path)


def output_names(paths: list[str]) -> list[str]:
    """Collision-safe output names: bare stems when unique; otherwise the
    path relative to the deepest common ancestor (albumA/01 and albumB/01
    must not silently overwrite — and race-corrupt — one .mmap under the
    process pool)."""
    import os

    stems = [Path(p).stem for p in paths]
    if len(set(stems)) == len(stems):
        return stems
    parents = [str(Path(p).resolve().parent) for p in paths]
    common = os.path.commonpath(parents)
    names = [
        str((Path(par).relative_to(common) / Path(p).stem))
        for p, par in zip(paths, parents)
    ]
    if len(set(names)) != len(names):
        # the same path given twice (or two paths resolving to one file)
        # would race-write a single .mmap under the process pool — the
        # exact corruption this function exists to prevent
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate output names for inputs: {dupes}")
    return names


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("audio", nargs="+", help="audio files (.wav/.npy/ffmpeg)")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    names = output_names(args.audio)
    if args.workers <= 1 or len(args.audio) == 1:
        for a, n in zip(args.audio, names):
            print(extract_one(a, args.out_dir, out_name=n))
        return
    with ProcessPoolExecutor(max_workers=args.workers) as pool:
        futures = [pool.submit(extract_one, a, args.out_dir, out_name=n)
                   for a, n in zip(args.audio, names)]
        for f in futures:
            try:
                print(f.result())
            except Exception as e:  # keep going like the reference pool does
                print(f"FAILED: {e}", file=sys.stderr)


if __name__ == "__main__":
    main()
