"""Serving: dynamic cross-request batching over fixed batch buckets, port
of ``maest_tpu/serve.py``.

The unit of batching is the *chunk* (one ``img_t``-frame mel window): a
90 s track contributes three 30 s chunks that ride in the same device
batch as other clients' chunks, and its sigmoid activations are averaged
per request afterwards — the math of ``MAEST.predict_labels``.

Batches are padded up to the nearest bucket so the device sees a small,
fixed set of shapes: on a CUDA device, one CUDA graph per bucket and
family, the counterpart of the JAX package's one compiled program per
bucket. A bucket's graph is captured at ``warmup()`` (or at its first
batch) after one eager call on the capture's side stream, which builds
the kernels, uploads the mel tables and sets the kernels' attributes; a
batch then costs a copy into the graph's static input, one replay and a
copy of its rows back. A family's buckets share one memory pool (its one
dispatcher thread replays them in turn); the three families do not, since
their dispatchers run at once. Captures take one at a time in the process
and in ``thread_local`` mode, so other threads' CUDA work goes on beside
them; a capture that fails raises. On the CPU the programs run eagerly.

Under a mesh (``MAEST(mesh=...)``, several processes) the JAX package
serves only within one process; here rank 0 runs the front, the batchers
and one device thread for every family (``_MeshDispatch``), so that the
collectives keep one order: each batch's family, shape and rows are
broadcast to the other ranks, which run it with rank 0 in ``follow()``
until ``close()`` stops them. Each data rank runs its rows under its
tensor-parallel layout (``MAEST.sharded``), eagerly: collectives over gloo
cannot be captured.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .dsp import HOP_LENGTH, log_mel_spectrogram, log_mel_spectrogram_np

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)

# one capture at a time in the process: the three families' dispatchers may
# each capture a bucket at its first batch
_CAPTURE_LOCK = threading.Lock()


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


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    static_in: torch.Tensor
    static_out: torch.Tensor


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

    On a CUDA device each bucket is one CUDA graph (the module's
    docstring); ``graphs`` says so, and set False before the first batch
    it makes the programs eager there too. ``replays[b]``: bucket b's
    replays. The kernels' host launch counters tick once at a capture and
    never on a replay: ``utils.profiling.kernel_launches`` counts the
    kernels a replay runs by name. Under a mesh every bucket is a
    multiple of the data ranks.
    """

    def __init__(self, model, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 fused_wave: bool = False, pcm16: bool = False):
        if pcm16 and not fused_wave:
            raise ValueError("pcm16 requires fused_wave")
        self.model = model
        self.fused_wave = fused_wave
        self.pcm16 = pcm16
        self.kind = "pcm16" if pcm16 else "wave" if fused_wave else "chunk"
        buckets = sorted(set(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"invalid buckets {buckets}")
        par = getattr(model, "parallel", None)
        if par is not None:  # every bucket fills the data ranks
            buckets = sorted(set(-(-b // par.data) * par.data
                                 for b in buckets))
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
        self.graphs = model.device.type == "cuda" and par is None
        self._graphs: dict[int, _Graph] = {}
        self._pool = None  # the family's graph memory pool
        self._stream = None  # the family's capture stream
        self._lock = threading.Lock()
        self.replays: dict[int, int] = {}
        # under a mesh, rank 0's one device thread (set by TagService)
        self.mesh_run = None

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

    def eager(self, batch: np.ndarray) -> np.ndarray:
        """A padded batch's activations without a graph: under a mesh this
        data rank's rows and the gather (every rank calls it)."""
        device = self.model.device
        with _on_device(device), torch.inference_mode():
            x = torch.from_numpy(batch).to(device)
            return self.model.sharded(x, self._activations).cpu().numpy()

    def _capture(self, bucket: int) -> _Graph:
        """Bucket ``bucket``'s graph: one eager call on the side stream
        (first-use work), then the capture, sharing the family's pool."""
        device = self.model.device
        with _CAPTURE_LOCK:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            dtype = torch.from_numpy(np.zeros(0, self.elem_dtype)).dtype
            static_in = torch.zeros((bucket, *self.elem_shape), dtype=dtype,
                                    device=device)
            self._stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(self._stream):
                self._activations(static_in)
            torch.cuda.current_stream(device).wait_stream(self._stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                static_out = self._activations(static_in)
        self.replays[bucket] = 0
        if self._pool is None:
            self._pool = graph.pool()
        g = self._graphs[bucket] = _Graph(graph, static_in, static_out)
        return g

    def warmup(self) -> None:
        """Capture every bucket's graph up front (or, without graphs, run
        every bucket once): first-request latency on a cold server would
        otherwise include the kernels' build and the capture."""
        for b in self.buckets:
            if self.graphs:
                with self._lock, _on_device(self.model.device), \
                        torch.inference_mode():
                    if b not in self._graphs:
                        self._capture(b)
            else:
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
        if self.mesh_run is not None:
            return self.mesh_run(self.kind, batch)[:n]
        if not self.graphs:
            return self.eager(batch)[:n]
        with self._lock, _on_device(self.model.device), \
                torch.inference_mode():
            g = self._graphs.get(bucket) or self._capture(bucket)
            g.static_in.copy_(torch.from_numpy(batch))
            g.graph.replay()
            self.replays[bucket] += 1
            return g.static_out[:n].cpu().numpy()


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

    def reset_window(self):
        """Clear the latency window (a benchmark's phase boundaries)."""
        with self._lock:
            self.latency_ms.clear()

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


class _MeshDispatch:
    """Under a mesh: rank 0's one thread of device work for every family,
    and the other ranks' loop that follows it.

    A job is (kind, array): a program family's padded batch ("chunk",
    "wave", "pcm16") or a clip shorter than one window ("direct"). Rank 0
    broadcasts its header (kind, dtype, shape) and bytes from its one
    thread, then every rank runs ``fns[kind]`` on it, whose collectives
    (the gather of the rows, tensor parallelism's sums) thus keep one
    order on every rank. Broadcasts go over host tensors on gloo, device
    tensors on NCCL."""

    _DTYPES = (np.float32, np.int16)
    _STOP = -1

    def __init__(self, model, fns: dict):
        import torch.distributed as dist

        self.model = model
        self.fns = fns
        self.kinds = tuple(fns)
        self.rank = dist.get_rank()
        self._device = (model.device if dist.get_backend() == "nccl"
                        else torch.device("cpu"))
        self._jobs: queue.Queue = queue.Queue()
        self._thread = None
        if self.rank == 0:
            self._thread = threading.Thread(target=self._lead, daemon=True)
            self._thread.start()

    def run(self, kind: str, arr: np.ndarray) -> np.ndarray:
        """Rank 0: ``fns[kind](arr)`` on every rank; rank 0's result."""
        fut: Future = Future()
        self._jobs.put((kind, np.ascontiguousarray(arr), fut))
        return fut.result()

    def _header(self, values) -> torch.Tensor:
        h = torch.full((8,), 0, dtype=torch.int64)
        h[:len(values)] = torch.tensor(values, dtype=torch.int64)
        return h.to(self._device)

    def _lead(self) -> None:
        import torch.distributed as dist

        with _on_device(self.model.device):
            while True:
                job = self._jobs.get()
                if job is None:
                    dist.broadcast(self._header([self._STOP]), 0)
                    return
                kind, arr, fut = job
                try:
                    code = next(i for i, d in enumerate(self._DTYPES)
                                if arr.dtype == d)
                    dist.broadcast(self._header(
                        [self.kinds.index(kind), code, arr.ndim,
                         *arr.shape]), 0)
                    dist.broadcast(torch.from_numpy(
                        arr.reshape(-1).view(np.uint8)).to(self._device), 0)
                    fut.set_result(self.fns[kind](arr))
                except Exception as e:  # resolve the caller, keep leading
                    fut.set_exception(e)

    def follow(self) -> int:
        """Another rank: run rank 0's jobs until it stops; returns how
        many ran."""
        import torch.distributed as dist

        done = 0
        with _on_device(self.model.device):
            while True:
                h = self._header([])
                dist.broadcast(h, 0)
                h = h.cpu().tolist()
                if h[0] == self._STOP:
                    return done
                dtype, shape = self._DTYPES[h[1]], h[3:3 + h[2]]
                buf = torch.empty(int(np.prod(shape)) * np.dtype(dtype).itemsize,
                                  dtype=torch.uint8, device=self._device)
                dist.broadcast(buf, 0)
                self.fns[self.kinds[h[0]]](
                    buf.cpu().numpy().view(dtype).reshape(shape))
                done += 1

    def close(self) -> None:
        if self._thread is not None:
            self._jobs.put(None)
            self._thread.join(timeout=60)


class TagService:
    """End-to-end tagging: mel front-end + chunking + dynamic batching +
    per-request activation averaging.

    ``tag(waveform)`` is thread-safe and blocking; concurrent callers'
    chunks share device batches. Native-length clips (``img_t * hop``
    samples) take the fused wave programs; int16 native-length input is
    s16 PCM decoded on the device. Other lengths run the mel front-end per
    request (on the host in numpy with ``host_mel``) and go through the
    chunk batcher; a clip shorter than one window runs the model directly.

    Under a mesh, build the service on every rank: rank 0 serves, every
    other rank calls ``follow()``, which returns when rank 0's ``close()``
    stops it (``follower`` says which a rank is).
    """

    def __init__(self, model, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 5.0, warmup: bool = False,
                 warmup_pcm16: bool = False, host_mel: bool = False):
        # host_mel: the front-end of non-native-length clips in numpy on
        # the host (``log_mel_spectrogram_np``, float64 inside) in place of
        # the device's front-end (~1e-6 mel deltas), as the JAX package
        # offers it to spare its per-length compiles
        self.host_mel = host_mel
        self.model = model
        self.programs = BucketPrograms(model, buckets)
        self.wave_programs = BucketPrograms(model, buckets, fused_wave=True)
        self.pcm16_programs = BucketPrograms(model, buckets, fused_wave=True,
                                             pcm16=True)
        self.labels = model.labels
        self._mesh = None
        if getattr(model, "mesh", None) is not None:
            families = (self.programs, self.wave_programs,
                        self.pcm16_programs)
            fns = {p.kind: p.eager for p in families}
            fns["direct"] = lambda mel: self.model.predict_labels(mel)[0]
            self._mesh = _MeshDispatch(model, fns)
            if self._mesh.rank != 0:
                return
            for p in families:
                p.mesh_run = self._mesh.run
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

    @property
    def follower(self) -> bool:
        """A rank of a mesh other than 0: it runs ``follow()``, not
        ``tag()``."""
        return self._mesh is not None and self._mesh.rank != 0

    def follow(self) -> int:
        """A follower rank: run rank 0's batches until its ``close()``;
        returns how many ran."""
        if not self.follower:
            raise RuntimeError("follow() runs on a mesh's ranks other than 0")
        return self._mesh.follow()

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
            if self.host_mel:
                mel = torch.from_numpy(log_mel_spectrogram_np(wave))
            else:
                mel = self.model.melspectrogram(wave)  # (96, T) on the device
            if mel.shape[-1] < self.model.cfg.img_size[1]:
                # a clip shorter than one window: the model takes it (the
                # time pos-embed is cut to the input), the fixed-shape
                # buckets do not, so run it directly
                acts = self._direct(mel[None, None])
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

    def _direct(self, mel: torch.Tensor) -> np.ndarray:
        if self._mesh is not None:
            return self._mesh.run("direct", mel.cpu().numpy())
        return self.model.predict_labels(mel)[0]

    def tag_mel_chunks(self, chunks: np.ndarray,
                       timeout: Optional[float] = 60.0) -> np.ndarray:
        """(n, 96, img_t) mel windows -> (C,) mean sigmoid activations."""
        if chunks.shape[0] == 0:
            # a mean over zero rows would be silent all-NaN activations
            raise ValueError("tag_mel_chunks needs at least one mel window")
        acts = self.batcher.submit(chunks).result(timeout=timeout)
        return acts.mean(axis=0)

    def stats_reset_window(self) -> None:
        """Clear the latency window (a benchmark's phase boundaries)."""
        self.batcher.stats.reset_window()

    def stats(self) -> dict:
        return self.batcher.stats.snapshot()

    def close(self) -> None:
        """Stop the batchers and, under a mesh, the follower ranks."""
        if self.follower:
            return
        self.batcher.close()
        self.wave_batcher.close()
        self.pcm16_batcher.close()
        if self._mesh is not None:
            self._mesh.close()
