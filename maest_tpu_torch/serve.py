"""Serving: dynamic cross-request batching over fixed batch buckets, port
of ``maest_tpu/serve.py``.

The unit of batching is the *chunk* (one ``img_t``-frame mel window): a
90 s track contributes three 30 s chunks that ride in the same device
batch as other clients' chunks, and its sigmoid activations are averaged
per request afterwards — the math of ``MAEST.predict_labels``.

Batches are padded up to the nearest bucket so the device sees a small,
fixed set of shapes. The programs run eagerly here; one CUDA graph per
bucket is later work (ROADMAP queue 1, serving). Each batcher's dispatcher
thread runs on the model's device.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from .dsp import HOP_LENGTH, log_mel_spectrogram

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest bucket if none fits; callers
    split oversized batches first)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def _on_device(device: torch.device):
    """Context that makes ``device`` current for CUDA work in this thread."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class BucketPrograms:
    """Sigmoid-activation programs, one per batch bucket.

    ``run`` pads the batch up to the nearest bucket, runs it, and slices
    the padding back off. Two program families:
      * mel-chunk (default): elements are (96, img_t) mel windows;
      * fused wave (``fused_wave=True``): elements are native-length
        (img_t * hop samples) waveforms; mel front-end, ViT and sigmoid run
        back to back on the device, so a clip costs one host->device copy.
        With ``pcm16`` the elements are int16 s16 PCM, decoded on the
        device (half the copy bytes).
    """

    def __init__(self, model, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 fused_wave: bool = False, pcm16: bool = False):
        if pcm16 and not fused_wave:
            raise ValueError("pcm16 requires fused_wave")
        self.model = model
        self.fused_wave = fused_wave
        self.pcm16 = pcm16
        buckets = sorted(set(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"invalid buckets {buckets}")
        self.buckets = tuple(buckets)
        img_f, img_t = model.cfg.img_size
        self.img_t = img_t
        if fused_wave:
            self.native_len = img_t * HOP_LENGTH
            self.elem_shape = (self.native_len,)
            self.elem_dtype = np.int16 if pcm16 else np.float32
        else:
            self.native_len = None
            self.elem_shape = (img_f, img_t)
            self.elem_dtype = np.float32

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def _activations(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_wave:
            if self.pcm16:
                x = x.to(torch.float32) / 32768.0
            x = log_mel_spectrogram(x)[:, :, :self.img_t]  # (b, 96, img_t)
        logits = self.model.net(x[:, None])[0]
        return torch.sigmoid(logits.float())

    def warmup(self) -> None:
        """Run every bucket once (first-request latency on a cold server
        would otherwise include the kernels' build and cuBLAS set-up)."""
        for b in self.buckets:
            self.run(np.zeros((b,) + self.elem_shape, self.elem_dtype))

    def run(self, batch: np.ndarray) -> np.ndarray:
        """(n, *elem_shape) elements -> (n, num_classes) sigmoid
        activations. n must be <= max_batch."""
        batch = np.asarray(batch, self.elem_dtype)
        n = batch.shape[0]
        if batch.shape[1:] != self.elem_shape:
            raise ValueError(
                f"expected (n, {self.elem_shape}), got {batch.shape}")
        if n > self.max_batch:
            raise ValueError(f"batch {n} exceeds max bucket {self.max_batch}")
        bucket = pick_bucket(n, self.buckets)
        if bucket != n:
            batch = np.concatenate(
                [batch, np.zeros((bucket - n,) + batch.shape[1:],
                                 batch.dtype)])
        device = self.model.device
        with _on_device(device), torch.inference_mode():
            acts = self._activations(torch.from_numpy(batch).to(device))
            return acts[:n].cpu().numpy()


@dataclass
class ServeStats:
    """Running counters, exported by the /stats endpoint. Updates come from
    many threads, so they go through the locked helpers; ``latency_ms`` is
    a bounded window."""

    requests: int = 0
    chunks: int = 0
    batches: int = 0
    batched_chunks: int = 0
    latency_ms: "deque" = field(default_factory=lambda: deque(maxlen=2048))
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def bump(self, *, requests: int = 0, chunks: int = 0, batches: int = 0,
             batched_chunks: int = 0, latency_ms: Optional[float] = None):
        with self._lock:
            self.requests += requests
            self.chunks += chunks
            self.batches += batches
            self.batched_chunks += batched_chunks
            if latency_ms is not None:
                self.latency_ms.append(latency_ms)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self.latency_ms)
            requests, chunks = self.requests, self.chunks
            batches, batched = self.batches, self.batched_chunks

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

        return {
            "requests": requests,
            "chunks": chunks,
            "batches": batches,
            "mean_batch_fill": batched / batches if batches else 0.0,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p99": pct(0.99),
        }


class _Pending:
    __slots__ = ("chunks", "future", "consumed", "parts")

    def __init__(self, chunks: np.ndarray):
        self.chunks = chunks
        self.future: Future = Future()
        self.consumed = 0  # chunks taken into device batches so far
        self.parts: list = []  # per-batch activation slices, in order


class DynamicBatcher:
    """Batches chunk requests across clients before dispatching to the
    device.

    A background dispatcher thread drains the queue: it waits up to
    ``max_wait_ms`` after the first pending request for more chunks (a full
    batch dispatches at once), packs up to ``programs.max_batch`` chunks
    into one device call, and resolves each request's Future with its own
    slice of the activations. Requests larger than the biggest bucket are
    split across consecutive batches.
    """

    def __init__(self, programs: BucketPrograms, max_wait_ms: float = 5.0):
        self.programs = programs
        self.max_wait_ms = float(max_wait_ms)
        self.stats = ServeStats()
        self._queue: list[_Pending] = []
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()

    def submit(self, chunks: np.ndarray) -> Future:
        """Enqueue (n, *elem_shape) elements; the Future resolves to the
        (n, num_classes) activations for exactly those elements."""
        if chunks.shape[1:] != self.programs.elem_shape:
            raise ValueError(
                f"expected (n, {self.programs.elem_shape}), "
                f"got {chunks.shape}")
        p = _Pending(np.asarray(chunks, self.programs.elem_dtype))
        if chunks.shape[0] == 0:
            # the dispatcher keys on chunk counts: resolve 0-row requests here
            p.future.set_result(np.zeros(
                (0, self.programs.model.cfg.num_classes), np.float32))
            return p.future
        with self._lock:
            if self._stop:
                raise RuntimeError("batcher is shut down")
            self._queue.append(p)
        self._event.set()
        return p.future

    def close(self) -> None:
        with self._lock:
            self._stop = True
        self._event.set()
        self._thread.join(timeout=10)
        with self._lock:  # a dispatcher that outlived the join still runs
            pending = list(self._queue)
        for p in pending:
            try:
                p.future.set_exception(RuntimeError("batcher shut down"))
            except InvalidStateError:
                pass

    def _pending_chunks(self) -> int:
        return sum(p.chunks.shape[0] - p.consumed for p in self._queue)

    def _dispatch_loop(self) -> None:
        max_batch = self.programs.max_batch
        with _on_device(self.programs.model.device):
            while True:
                self._event.wait()
                with self._lock:
                    if self._stop and not self._queue:
                        return
                    have = self._pending_chunks()
                    if not have:
                        # clear under the lock so a racing submit() is seen
                        self._event.clear()
                if not have:
                    continue
                # linger briefly for co-batching unless a full batch is ready
                if have < max_batch and self.max_wait_ms > 0:
                    deadline = time.monotonic() + self.max_wait_ms / 1e3
                    while time.monotonic() < deadline:
                        with self._lock:
                            have = self._pending_chunks()
                        if have >= max_batch or self._stop:
                            break
                        time.sleep(min(0.001, self.max_wait_ms / 1e3))
                self._drain_once(max_batch)

    def _drain_once(self, max_batch: int) -> None:
        """Take up to max_batch chunks, run them as one device batch, and
        resolve the requests that are complete."""
        take: list[tuple[_Pending, int, int]] = []  # (req, start, count)
        with self._lock:
            room = max_batch
            for p in list(self._queue):
                if room == 0:
                    break
                c = min(p.chunks.shape[0] - p.consumed, room)
                take.append((p, p.consumed, c))
                p.consumed += c
                room -= c
                if p.consumed == p.chunks.shape[0]:
                    self._queue.remove(p)
            if not self._queue and not self._stop:
                # never clear after close(): its set() wakes the loop to exit
                self._event.clear()
        if not take:
            return
        batch = np.concatenate([p.chunks[s:s + c] for p, s, c in take])
        try:
            acts = self.programs.run(batch)
        except Exception as e:  # resolve the callers, keep the dispatcher
            for p, _, _ in take:
                try:
                    p.future.set_exception(e)
                except InvalidStateError:
                    pass
            return
        self.stats.bump(batches=1, batched_chunks=batch.shape[0])
        off = 0
        for p, _s, c in take:
            p.parts.append(acts[off:off + c])
            off += c
            if sum(q.shape[0] for q in p.parts) == p.chunks.shape[0]:
                try:  # the client may have cancelled the future
                    p.future.set_result(np.concatenate(p.parts))
                except InvalidStateError:
                    pass


class TagService:
    """End-to-end tagging: mel front-end + chunking + dynamic batching +
    per-request activation averaging.

    ``tag(waveform)`` is thread-safe and blocking; concurrent callers'
    chunks share device batches. Native-length clips (``img_t * hop``
    samples) take the fused wave programs; int16 native-length input is
    s16 PCM decoded on the device. Other lengths run the mel front-end per
    request and go through the chunk batcher.
    """

    def __init__(self, model, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 5.0, warmup: bool = False,
                 warmup_pcm16: bool = False):
        self.model = model
        self.programs = BucketPrograms(model, buckets)
        self.wave_programs = BucketPrograms(model, buckets, fused_wave=True)
        self.pcm16_programs = BucketPrograms(model, buckets, fused_wave=True,
                                             pcm16=True)
        if warmup:
            self.wave_programs.warmup()  # the hot path first
            if warmup_pcm16:
                self.pcm16_programs.warmup()
            self.programs.warmup()
        self.batcher = DynamicBatcher(self.programs, max_wait_ms=max_wait_ms)
        self.wave_batcher = DynamicBatcher(self.wave_programs,
                                           max_wait_ms=max_wait_ms)
        self.pcm16_batcher = DynamicBatcher(self.pcm16_programs,
                                            max_wait_ms=max_wait_ms)
        # one stats object for the service: requests/latency per service,
        # batches/fill count device dispatches of any kind
        self.wave_batcher.stats = self.batcher.stats
        self.pcm16_batcher.stats = self.batcher.stats
        self.labels = model.labels

    def tag(self, waveform: np.ndarray, timeout: Optional[float] = 60.0):
        """16 kHz mono waveform -> (activations (C,), labels)."""
        t0 = time.monotonic()
        wave = np.asarray(waveform)
        pcm16 = wave.dtype == np.int16
        if not pcm16:
            wave = wave.astype(np.float32, copy=False)
        if wave.ndim == 1 and wave.shape[0] == self.wave_programs.native_len:
            n_chunks = 1
            batcher = self.pcm16_batcher if pcm16 else self.wave_batcher
            acts = batcher.submit(wave[None]).result(timeout=timeout)[0]
        elif pcm16:
            raise ValueError(
                "int16 PCM input must be exactly native length "
                f"({self.wave_programs.native_len} samples); convert to "
                "float for arbitrary-length audio")
        else:
            mel = self.model.melspectrogram(wave)  # (96, T) on the device
            if mel.shape[-1] < self.model.cfg.img_size[1]:
                # a clip shorter than one window: the model takes it (the
                # time pos-embed is cut to the input), the fixed-shape
                # buckets do not, so run it directly
                acts = self.model.predict_labels(mel[None, None])[0]
                n_chunks = 1
            else:
                with torch.inference_mode():
                    chunks = self.model._chunk_melspec(mel)[:, 0].cpu().numpy()
                n_chunks = chunks.shape[0]
                acts = self.tag_mel_chunks(chunks, timeout=timeout)
        self.batcher.stats.bump(
            requests=1, chunks=n_chunks,
            latency_ms=(time.monotonic() - t0) * 1e3)
        return acts, self.labels

    def tag_mel_chunks(self, chunks: np.ndarray,
                       timeout: Optional[float] = 60.0) -> np.ndarray:
        """(n, 96, img_t) mel windows -> (C,) mean sigmoid activations."""
        if chunks.shape[0] == 0:
            # a mean over zero rows would be silent all-NaN activations
            raise ValueError("tag_mel_chunks needs at least one mel window")
        acts = self.batcher.submit(chunks).result(timeout=timeout)
        return acts.mean(axis=0)

    def stats(self) -> dict:
        return self.batcher.stats.snapshot()

    def close(self) -> None:
        self.batcher.close()
        self.wave_batcher.close()
        self.pcm16_batcher.close()
