"""Sacred-style run records.

The reference attaches a Sacred ``FileStorageObserver`` (reference:
ex_maest.py:37, ex_tl.py:22) that records a ``run.json`` (command, argv,
experiment info, status) and per-metric files for every run. Equivalent
capability here: the Trainer writes ``run.json`` (argv, command, presets,
overrides, resolved-config hash, git sha, host, start/stop times, status)
and an append-only ``metrics.jsonl`` into the run dir, next to the existing
``config.json`` + TensorBoard scalars.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["write_run_json", "finalize_run_json", "MetricsLog", "git_sha",
           "classify_exit"]


def classify_exit(exc: BaseException) -> str:
    """Triage status for a run ended by ``exc``.

    KeyboardInterrupt and stop-shaped ``SystemExit`` (code None/0, or the
    128+signum shell convention — 130 SIGINT / 143 SIGTERM raised by
    preemption wrappers) are INTERRUPTED: the run was stopped, not broken.
    A nonzero ``sys.exit(1)``-style exit from library code is a real
    failure and must not be triaged as a preemption."""
    if isinstance(exc, KeyboardInterrupt):
        return "INTERRUPTED"
    if isinstance(exc, SystemExit):
        code = exc.code
        if code is None or code == 0 or code in (130, 143):
            return "INTERRUPTED"
        return "FAILED"
    return "FAILED"


def git_sha(cwd: str | os.PathLike | None = None) -> str | None:
    """Best-effort commit hash of the working tree this run started from."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=10,
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def config_hash(cfg: dict) -> str:
    return hashlib.sha256(
        json.dumps(cfg, sort_keys=True, default=str).encode()
    ).hexdigest()


def write_run_json(run_dir: str | os.PathLike, cfg: dict,
                   run_info: dict | None = None) -> Path:
    """Write ``run.json`` at run start (status RUNNING)."""
    record = {
        "status": "RUNNING",
        "start_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "argv": sys.argv,
        "python": sys.version.split()[0],
        "host": socket.gethostname(),
        "cwd": os.getcwd(),
        "git_sha": git_sha(),
        "config_sha256": config_hash(cfg),
    }
    if run_info:
        record.update(run_info)
    path = Path(run_dir) / "run.json"
    path.write_text(json.dumps(record, indent=2, default=str))
    return path


def finalize_run_json(run_dir: str | os.PathLike, status: str = "COMPLETED",
                      result=None) -> None:
    """Stamp the final status (COMPLETED/FAILED/INTERRUPTED) + stop time."""
    path = Path(run_dir) / "run.json"
    try:
        record = json.loads(path.read_text())
    except (OSError, ValueError):
        record = {}
    record["status"] = status
    record["stop_time"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    if result is not None:
        record["result"] = result
    path.write_text(json.dumps(record, indent=2, default=str))


class MetricsLog:
    """Append-only ``metrics.jsonl``: one ``{"name", "value", "step", "ts"}``
    object per line, flushed per write so a killed run keeps its history.

    ``enabled=False`` turns it into a no-op — multi-process training logs
    host-side records on process 0 only (the other ranks would interleave
    duplicate lines into the same shared-FS file)."""

    def __init__(self, path: str | os.PathLike, enabled: bool = True):
        self.path = Path(path)
        self._fh = None
        self.enabled = enabled

    def log(self, name: str, value, step: int) -> None:
        if not self.enabled:
            return
        if self._fh is None:
            self._fh = open(self.path, "a", buffering=1)
        self._fh.write(json.dumps(
            {"name": name, "value": float(value), "step": int(step),
             "ts": time.time()}
        ) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
