"""Batch assembly + device prefetch.

Replaces the reference's 16-worker torch DataLoader (reference:
discogs/datamodule.py:246-252) with a thread pool (numpy memmap reads
release the GIL) and a double-buffered copy to the card through pinned
memory on a side CUDA stream, so host IO and the copies overlap the
card's compute. When the native C++ reader is built
(maest_tpu_torch/native), the per-item read path dispatches there.
``BatchLoader`` is the JAX package's, unchanged.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch


def _collate(items: Sequence[dict]) -> dict:
    batch = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if key == "filename":
            batch[key] = vals
        else:
            batch[key] = np.stack(vals)
    return batch


class BatchLoader:
    """Iterate index batches through a dataset with a thread pool.

    When the dataset exposes ``batch_spec`` and the native C++ reader is
    built, whole batches are read by one ``mel_load_batch`` call (a C
    thread pool over pread) — no per-item Python in the hot loop.
    """

    def __init__(self, dataset, batch_size: int, *, num_workers: int = 8,
                 drop_last: bool = False, use_native: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.use_native = use_native

    def _native_ok(self) -> bool:
        if not self.use_native or not hasattr(self.dataset, "batch_spec"):
            return False
        from .. import native

        return native.available()

    def _load_batch_native(self, idxs) -> Optional[dict]:
        from .. import native

        spec = self.dataset.batch_spec(idxs)
        if spec is None:
            return None
        paths, offsets, metas = spec
        mels = native.load_batch(
            paths, offsets, self.dataset.cfg.melspectrogram_size,
            self.dataset.cfg.n_bands, threads=self.num_workers,
        )  # (B, T, bands)
        batch = _collate(metas)
        batch["x"] = np.ascontiguousarray(mels.transpose(0, 2, 1))
        return batch

    def iter_indices(self, indices: Iterable[int]) -> Iterator[dict]:
        indices = list(indices)
        bs = self.batch_size
        batches = [indices[i : i + bs] for i in range(0, len(indices), bs)]
        if self.drop_last and batches and len(batches[-1]) < bs:
            batches.pop()
        if not batches:
            return

        native_ok = self._native_ok()
        with ThreadPoolExecutor(self.num_workers) as pool:
            # pipeline: keep up to 2 batches in flight
            pending = collections.deque()
            it = iter(batches)

            def fetch(idxs):
                if native_ok:
                    batch = self._load_batch_native(idxs)
                    if batch is not None:
                        return batch
                return _collate(list(map(self.dataset.__getitem__, idxs)))

            def submit_next():
                try:
                    idxs = next(it)
                except StopIteration:
                    return False
                pending.append(pool.submit(fetch, idxs))
                return True

            for _ in range(2):
                if not submit_next():
                    break
            while pending:
                batch = pending.popleft().result()
                submit_next()
                yield batch

    def __iter__(self) -> Iterator[dict]:
        return self.iter_indices(range(len(self.dataset)))


def device_prefetch(batches: Iterator[dict], device="cuda", size: int = 2,
                    keys: Sequence[str] = ("x", "y", "y_teacher"),
                    shard=None) -> Iterator[dict]:
    """Move batches to ``device`` ahead of their use (double buffering).

    Array values under ``keys`` become tensors on ``device``; other
    entries (filenames, ``_n``) pass through on the host unchanged. On a
    CUDA device a producer thread pins each array and copies it with
    ``non_blocking=True`` on a side stream, up to ``size`` batches ahead;
    the consumer's stream waits on the copy's event before the batch is
    handed out, and ``record_stream`` keeps the allocator from reusing a
    buffer while the consumer's stream may still read it. On the CPU the
    arrays are only converted to tensors.

    ``shard=(rank, ranks)``: each batch is the whole global batch, and
    only rank ``rank`` of ``ranks``' block of rows under ``keys`` goes to
    the card. A batch that already holds only this rank's rows goes with
    ``shard=None``, as it is.
    """
    device = torch.device(device)

    def _rows(arr, shard):
        """Rank ``shard[0]`` of ``shard[1]``'s block of rows of ``arr``."""
        arr = np.asarray(arr)
        if shard is None:
            return arr
        rank, ranks = shard
        if len(arr) % ranks:
            raise ValueError(f"a batch of {len(arr)} rows does not split "
                             f"over {ranks} ranks")
        per = len(arr) // ranks
        return arr[rank * per:(rank + 1) * per]
    if device.type != "cuda":
        try:
            for batch in batches:
                out = dict(batch)
                for k in keys:
                    if k in out:
                        out[k] = torch.from_numpy(_rows(out[k], shard))
                yield out
        finally:
            if hasattr(batches, "close"):
                batches.close()
        return

    copy_stream = torch.cuda.Stream(device)

    def put_device(batch):
        out = dict(batch)
        with torch.cuda.stream(copy_stream):
            for k in keys:
                if k in out:
                    host = torch.from_numpy(np.ascontiguousarray(
                        _rows(out[k], shard))).pin_memory()
                    out[k] = host.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copy_stream)
        return out, done

    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    err_box: list = []  # producer exception, re-raised on the consumer side
    stop = threading.Event()

    def producer():
        try:
            for batch in batches:
                item = put_device(batch)
                # bounded put that aborts when the consumer went away —
                # a plain q.put would block forever if the consumer broke
                # early (limit_*_batches), leaking this thread, the
                # loader's pool, and the device-resident batches
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    break
        except Exception as e:  # noqa: BLE001 — re-raised on the consumer
            # a producer failure (bad read, failed copy) must surface in
            # the training/eval loop, not silently end the epoch early as
            # if the data ran out
            err_box.append(e)
        finally:
            if hasattr(batches, "close"):
                batches.close()  # unwinds BatchLoader's pool deterministically
            # the sentinel must not be dropped on a momentarily-full queue
            # (the consumer would drain the queue and then block forever);
            # bounded-put until it lands or the consumer has gone away
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err_box:
                    raise err_box[0]
                break
            out, done = item
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            for k in keys:
                if k in out:
                    out[k].record_stream(compute)
            yield out
    finally:
        stop.set()
        try:
            while True:  # unblock a producer waiting on a full queue
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=10.0)
