"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` file has a plain C interface. It is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library under ``build/maest_tpu_torch/``
at the root of the checkout, named by a hash of its source and flags, and
loaded with ``ctypes``. The build runs at the first call that needs the
library, never at import, so the package imports on machines with no CUDA
toolkit. Nothing here falls back: a missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "maest_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per library built by this process: nvcc's output, which carries ptxas's
# register/spill report ("" when an earlier build was reused)
build_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin); the "
        "CUDA kernels of maest_tpu_torch are built from source at first use")


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{name}-{digest}.so"
        log = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        build_log[name] = log
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch. Every
    library exports ``maest_cuda_error_string`` to name it."""
    if err != 0:
        fn = lib.maest_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {err} ({fn(err).decode()}) at launch")
