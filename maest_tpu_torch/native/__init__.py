"""Native (C++) IO runtime with ctypes bindings.

Builds ``libmel_loader.so`` on first use (g++, cached in the checkout's
``build/maest_tpu_torch/native/``) and exposes a threaded loader. Falls back
cleanly when no compiler is available — callers check ``available()``.

Replaces the reference's multiprocessing DataLoader worker pool for the
memmap read path (reference: discogs/datamodule.py:246-252).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).with_name("mel_loader.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[2]
    out = root / "build" / "maest_tpu_torch" / "native"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _compile() -> Optional[Path]:
    gxx = shutil.which("g++") or shutil.which("clang++")
    if gxx is None:
        return None
    so = _build_dir() / "libmel_loader.so"
    if so.exists() and so.stat().st_mtime >= _SRC.stat().st_mtime:
        return so
    # compile to a private name and rename into place: a concurrent
    # process (multi-process launch, train + serve) must never dlopen a
    # half-written .so
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [gxx, "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", str(tmp), str(_SRC), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    except (subprocess.CalledProcessError, OSError):
        tmp.unlink(missing_ok=True)
        return None
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _compile()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.mel_file_frames.restype = ctypes.c_int64
        lib.mel_file_frames.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.mel_load_chunk.restype = ctypes.c_int64
        lib.mel_load_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.mel_load_batch.restype = ctypes.c_int64
        lib.mel_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def file_frames(path: str, n_bands: int = 96) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    r = lib.mel_file_frames(str(path).encode(), n_bands)
    if r < 0:
        raise FileNotFoundError(path)
    return int(r)


def load_chunk(path: str, offset: int, chunk_frames: int,
               n_bands: int = 96) -> np.ndarray:
    """Read ``chunk_frames`` frames at ``offset``; short reads center-pad.

    Returns ``(chunk_frames, n_bands)`` float16.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    out = np.empty((chunk_frames, n_bands), dtype=np.float16)
    r = lib.mel_load_chunk(
        str(path).encode(), int(offset), int(chunk_frames), int(n_bands),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if r < 0:
        raise FileNotFoundError(path)
    return out


def load_batch(paths: Sequence[str], offsets: Sequence[int],
               chunk_frames: int, n_bands: int = 96,
               threads: int = 8) -> np.ndarray:
    """Threaded batch read -> ``(len(paths), chunk_frames, n_bands)`` f16.

    Raises on any failed row, as the reference loader does
    (discogs/dataset.py:112-117, log-and-raise) and as this module's
    per-item path does (FileNotFoundError) — a silently zeroed
    spectrogram with a real label is a poisoned training sample.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    threads = max(1, min(threads, os.cpu_count() or 1))
    n = len(paths)
    out = np.empty((n, chunk_frames, n_bands), dtype=np.float16)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_offs = (ctypes.c_int64 * n)(*[int(o) for o in offsets])
    failures = lib.mel_load_batch(
        c_paths, c_offs, n, int(chunk_frames), int(n_bands), int(threads),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if failures:
        raise RuntimeError(
            f"native loader failed to read {failures} of {n} chunks "
            "(missing/corrupt mel files?)"
        )
    return out
