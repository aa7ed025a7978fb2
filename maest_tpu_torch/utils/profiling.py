"""Profiling / tracing helpers, port of ``maest_tpu/utils/profiling.py``
(SURVEY §5: the reference has none beyond a specs/s loop,
ex_maest.py:108-159).

``trace(dir)``   — context manager writing a ``torch.profiler`` trace
                   (CPU and, where there is a card, CUDA activity),
                   loadable in TensorBoard or Perfetto.
``force(x)``     — wait for the card and fetch a scalar from a tensor.
``kernel_launches(fn, patterns)`` — the kernels one call of ``fn``
                   runs on the card, counted by name from
                   ``torch.profiler`` traces (also those a CUDA graph's
                   replay runs, which no host counter sees).
``StepTimer``    — step timing after a warmup prefix: CUDA events on the
                   card, wall clock on the CPU.
"""

from __future__ import annotations

import contextlib
import re
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


# windows ``kernel_launches`` traces: a trace can lose a record
KERNEL_TRACES = 3


def kernel_launches(fn, patterns: dict) -> dict:
    """{label: launches} of the kernels whose names match each ``label:
    regex`` of ``patterns`` in one call of ``fn``, traced by
    ``torch.profiler`` on the card: the second call of a window, since a
    trace loses the first launches of its window. ``"device"``: every
    activity of the call on the card (kernels, copies, sets). Over
    KERNEL_TRACES windows each count is the largest: a trace can lose a
    record (on an H100, a CUDA graph's replay that matched its eager run
    exactly was once traced without its K1), never add one. ``"short"``:
    the windows that fell below those counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    runs = []
    for _ in range(KERNEL_TRACES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        run = {label: sum(bool(re.search(pattern, n)) for n in names)
               for label, pattern in patterns.items()}
        run["device"] = len(names)
        runs.append(run)
    out = {k: max(r[k] for r in runs) for k in runs[0]}
    out["short"] = sum(r != out for r in runs)
    return out


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
