"""Profiling / tracing helpers, port of ``maest_tpu/utils/profiling.py``
(SURVEY §5: the reference has none beyond a specs/s loop,
ex_maest.py:108-159).

``trace(dir)``   — context manager writing a ``torch.profiler`` trace
                   (CPU and, where there is a card, CUDA activity),
                   loadable in TensorBoard or Perfetto.
``force(x)``     — wait for the card and fetch a scalar from a tensor.
``StepTimer``    — step timing after a warmup prefix: CUDA events on the
                   card, wall clock on the CPU.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str = "exp_logs/trace"):
    """``torch.profiler`` trace context writing into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def force(x) -> float:
    """Wait for everything ``x`` depends on; returns its first element."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return float(x.reshape(-1)[0].item())
    return float(np.asarray(x, dtype=np.float64).reshape(-1)[0])


class StepTimer:
    """Accumulates step times (seconds) after a warmup prefix. On a CUDA
    ``device`` a step is timed by CUDA events recorded on the current
    stream (``stop`` waits for the end event); otherwise by the host's
    clock."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._times: list = []
        self._t0 = None
        self._count = 0

    def start(self):
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return dt

    @property
    def times(self) -> list:
        """The step times kept (after the warmup prefix), in seconds."""
        return list(self._times)

    @property
    def mean(self) -> float:
        return float(np.mean(self._times)) if self._times else float("nan")

    def throughput(self, items_per_step: float) -> float:
        return items_per_step / self.mean if self._times else float("nan")
