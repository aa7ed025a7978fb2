"""Mel-spectrogram chunk datasets.

Feature-complete equivalent of the reference loaders
(reference: discogs/dataset.py:26-318):

  * groundtruth = pickle dict filename -> multi-hot target
  * ``.mmap`` files are raw float16 (frames, n_bands) arrays read with
    numpy memmap at a random (train) or fixed (exhaustive) frame offset
  * ``.npy`` files are loaded whole, truncated or center-zero-padded
  * exhaustive mode expands each file into consecutive windows with an
    optional half-overlap hop and a 10% zero-pad margin
  * teacher-student variants attach thresholded teacher activations

Returned chunks are (n_bands, T) float16, channel-free; normalization,
masking and mixup happen on-device inside the train step
(maest_tpu/train/steps.py), not here.
"""

from __future__ import annotations

import pathlib
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np


def load_groundtruth(path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _center_pad(mel: np.ndarray, size: int, n_bands: int) -> np.ndarray:
    """Zero-pad (frames, bands) up to ``size`` frames, centering the content
    via roll (reference: discogs/dataset.py:75-87, 122-132)."""
    pad = size - mel.shape[0]
    if pad <= 0:
        return mel[:size]
    mel = np.vstack([mel, np.zeros([pad, n_bands], dtype="float16")])
    return np.roll(mel, pad // 2, axis=0)


@dataclass
class DatasetConfig:
    """Reference defaults (reference: discogs/dataset.py:15-23)."""

    sample_rate: int = 16000
    hop_size: int = 256
    n_bands: int = 96
    clip_length: int = 10  # seconds

    @property
    def melspectrogram_size(self) -> int:
        return self.clip_length * self.sample_rate // self.hop_size


class MelChunkDataset:
    """Random-crop loader over memmap/npy mel files
    (reference: discogs/dataset.py:26-140)."""

    def __init__(self, groundtruth_file, base_dir, cfg: DatasetConfig,
                 rng: Optional[np.random.Generator] = None,
                 crop_seed: Optional[int] = None):
        self.base_dir = pathlib.Path(base_dir)
        self.cfg = cfg
        self.groundtruth = load_groundtruth(groundtruth_file)
        self.filenames = list(self.groundtruth.keys())
        self.rng = rng or np.random.default_rng()
        # ``crop_seed`` switches the random-crop draw to a PER-ITEM rng
        # keyed on (seed, filename) — order-independent, so offsets do not
        # depend on loader thread scheduling, and every process of a
        # multi-host run picks identical crops. Required for eval, whose
        # batches are fed replicated to a multi-process mesh (the
        # reference's val loader reseeds per worker instead and never needs
        # cross-rank agreement because DDP eval is rank-sharded,
        # discogs/datamodule.py:79-97).
        self.crop_seed = crop_seed
        # BatchLoader keeps two batches in flight on a thread pool;
        # np.random.Generator is not thread-safe, so crop draws take a lock
        import threading

        self._rng_lock = threading.Lock()

    def _crop_offset(self, path: pathlib.Path, frames_num: int) -> int:
        """Random crop offset; deterministic per item under ``crop_seed``."""
        hi = max(frames_num - self.cfg.melspectrogram_size, 0) + 1
        if self.crop_seed is not None:
            import zlib

            try:
                key = str(path.relative_to(self.base_dir))
            except ValueError:
                key = path.name
            r = np.random.default_rng(
                (self.crop_seed, zlib.crc32(key.encode()))
            )
            return int(r.integers(0, hi))
        with self._rng_lock:
            return int(self.rng.integers(0, hi))

    def __len__(self):
        return len(self.filenames)

    def _file_frames(self, path: pathlib.Path) -> int:
        return path.stat().st_size // (2 * self.cfg.n_bands)

    def load_melspectrogram(self, path: pathlib.Path,
                            offset: Optional[int] = None) -> np.ndarray:
        size = self.cfg.melspectrogram_size
        n_bands = self.cfg.n_bands
        if path.suffix == ".npy":
            mel = np.load(path).astype("float16")
            mel = _center_pad(mel, size, n_bands)
        else:
            frames_num = self._file_frames(path)
            if offset is None:
                offset = self._crop_offset(path, frames_num)
            mel = self._read_chunk(path, offset, frames_num)
        return mel.T  # (bands, time)

    def _read_chunk(self, path: pathlib.Path, offset: int,
                    frames_num: int) -> np.ndarray:
        """Raw-memmap chunk read; native pread loader when built, numpy
        memmap otherwise (same center-pad semantics)."""
        size = self.cfg.melspectrogram_size
        n_bands = self.cfg.n_bands
        from .. import native

        if native.available():
            return native.load_chunk(str(path), offset, size, n_bands)
        skip = max(offset + size - frames_num, 0)
        frames_to_read = size - skip
        fp = np.memmap(
            path, dtype="float16", mode="r",
            shape=(frames_to_read, n_bands),
            offset=offset * n_bands * 2,
        )
        mel = np.array(fp, dtype="float16")
        del fp
        if frames_to_read < size:
            mel = _center_pad(mel, size, n_bands)
        return mel

    def __getitem__(self, index: int):
        filename = self.filenames[index]
        target = np.asarray(self.groundtruth[filename], dtype="float16")
        mel = self.load_melspectrogram(self.base_dir / filename)
        return {"x": mel, "filename": str(filename), "y": target}

    def _target_filename(self, index: int) -> str:
        return self.filenames[index]

    def targets_for(self, indices) -> dict:
        """Per-row targets WITHOUT loading mel. Rank-sharded eval computes
        the full global batch's targets on every host from groundtruth
        metadata alone — the hosts only split the (expensive) mel IO
        (the reference instead gathers targets across DDP ranks,
        reference: models/module.py:163-180)."""
        y = np.stack([
            np.asarray(self.groundtruth[self._target_filename(i)], "float16")
            for i in indices])
        return {"y": y}

    def batch_spec(self, indices):
        """(paths, offsets, per-item dicts) for the native batch fast path,
        or None when any item needs the python path (.npy files)."""
        paths, offsets, metas = [], [], []
        for i in indices:
            filename = self.filenames[i]
            path = self.base_dir / filename
            if path.suffix == ".npy":
                return None
            frames = self._file_frames(path)
            offset = self._crop_offset(path, frames)
            paths.append(str(path))
            offsets.append(offset)
            metas.append({
                "filename": str(filename),
                "y": np.asarray(self.groundtruth[filename], dtype="float16"),
            })
        return paths, offsets, metas


def _teacher_target(teacher_dir, filename, threshold: float) -> np.ndarray:
    """Thresholded teacher activations with argmax fallback
    (reference: discogs/dataset.py:177-192)."""
    path = pathlib.Path(teacher_dir, str(filename) + ".logits.npy")
    logits = np.load(path).astype("float32").squeeze()
    acts = 1.0 / (1.0 + np.exp(-logits))
    hard = (acts > threshold).astype("float16")
    if not hard.sum():
        hard = np.zeros(hard.shape, dtype="float16")
        hard[int(np.argmax(acts))] = 1.0
    return hard


class _TSTargetsMixin:
    """Shared teacher-target metadata path for the TS dataset variants
    (requires ``teacher_dir`` / ``threshold`` attributes)."""

    def targets_for(self, indices) -> dict:
        out = super().targets_for(indices)
        out["y_teacher"] = np.stack([
            _teacher_target(self.teacher_dir, self._target_filename(i),
                            self.threshold)
            for i in indices])
        return out


class MelChunkDatasetTS(_TSTargetsMixin, MelChunkDataset):
    """Teacher-student variant (reference: discogs/dataset.py:143-193)."""

    def __init__(self, groundtruth_file, base_dir, cfg: DatasetConfig,
                 teacher_target_base_dir, teacher_target_threshold: float = 0.45,
                 rng=None, crop_seed=None):
        super().__init__(groundtruth_file, base_dir, cfg, rng,
                         crop_seed=crop_seed)
        self.teacher_dir = teacher_target_base_dir
        self.threshold = teacher_target_threshold

    def __getitem__(self, index: int):
        item = super().__getitem__(index)
        item["y_teacher"] = _teacher_target(
            self.teacher_dir, self.filenames[index], self.threshold
        )
        return item

    def batch_spec(self, indices):
        spec = super().batch_spec(indices)
        if spec is None:
            return None
        paths, offsets, metas = spec
        for meta in metas:
            meta["y_teacher"] = _teacher_target(
                self.teacher_dir, meta["filename"], self.threshold
            )
        return paths, offsets, metas


class ExhaustiveMelDataset(MelChunkDataset):
    """Consecutive-window inference dataset
    (reference: discogs/dataset.py:196-257)."""

    def __init__(self, groundtruth_file, base_dir, cfg: DatasetConfig,
                 half_overlapped_inference: bool = False, rng=None):
        super().__init__(groundtruth_file, base_dir, cfg, rng)
        size = cfg.melspectrogram_size
        self.hop = size // 2 if half_overlapped_inference else size
        self.half_overlap = half_overlapped_inference

        # Per-FILE dispatch (the reference keys on the first file's suffix
        # only, discogs/dataset.py:226 — a mixed .mmap/.npy corpus then
        # either byte-mismeasures the .npy files or collapses every .mmap
        # to a single offset-0 window; per-file dispatch is identical for
        # the homogeneous corpora the reference supports).
        entries: list[tuple[str, int]] = []
        dropped = 0
        for filename in self.filenames:
            path = self.base_dir / filename
            if path.suffix != ".mmap":
                entries.append((filename, 0))  # .npy: loaded whole
                continue
            frames_num = self._file_frames(path)
            if self.half_overlap:
                frames_num -= self.hop
            # 10% zero-pad margin (reference: discogs/dataset.py:236),
            # clamped so every window starts before EOF. The raw
            # reference formula accumulates the margin over the WHOLE
            # file, emitting offsets past EOF for anything longer than
            # 10 clips — a negative read that crashes its own loader
            # (discogs/dataset.py:101-110); where the reference works,
            # the clamp never binds and window sets are identical.
            n_patches = min(
                int((frames_num * 1.1) // self.hop),
                -(-frames_num // self.hop),  # ceil: start < frames_num
            )
            if n_patches == 0:
                dropped += 1  # reference-faithful drop, but not silent
            entries.extend((filename, i * self.hop) for i in range(n_patches))
        if dropped:
            import logging

            logging.getLogger(__name__).warning(
                "exhaustive dataset: %d file(s) shorter than ~0.91x the "
                "%d-frame window emit ZERO windows and are absent from "
                "test/predict output (reference semantics, "
                "discogs/dataset.py:236; the train/val chunk loader "
                "center-pads such files instead)", dropped,
                cfg.melspectrogram_size)
        self.entries = entries

    def __len__(self):
        return len(self.entries)

    def _target_filename(self, index: int) -> str:
        return self.entries[index][0]

    def __getitem__(self, index: int):
        filename, offset = self.entries[index]
        target = np.asarray(self.groundtruth[filename], dtype="float16")
        mel = self.load_melspectrogram(self.base_dir / filename, offset)
        return {"x": mel, "filename": str(filename), "y": target}

    def batch_spec(self, indices):
        paths, offsets, metas = [], [], []
        for i in indices:
            filename, offset = self.entries[i]
            path = self.base_dir / filename
            if path.suffix == ".npy":
                return None
            paths.append(str(path))
            offsets.append(int(offset))
            metas.append({
                "filename": str(filename),
                "y": np.asarray(self.groundtruth[filename], dtype="float16"),
            })
        return paths, offsets, metas


class ExhaustiveMelDatasetTS(_TSTargetsMixin, ExhaustiveMelDataset):
    """Exhaustive + teacher targets (reference: discogs/dataset.py:260-318)."""

    def __init__(self, groundtruth_file, base_dir, cfg: DatasetConfig,
                 teacher_target_base_dir, teacher_target_threshold: float = 0.45,
                 half_overlapped_inference: bool = False, rng=None):
        super().__init__(groundtruth_file, base_dir, cfg,
                         half_overlapped_inference, rng)
        self.teacher_dir = teacher_target_base_dir
        self.threshold = teacher_target_threshold

    def __getitem__(self, index: int):
        item = super().__getitem__(index)
        item["y_teacher"] = _teacher_target(
            self.teacher_dir, item["filename"], self.threshold
        )
        return item

    def batch_spec(self, indices):
        spec = super().batch_spec(indices)
        if spec is None:
            return None
        paths, offsets, metas = spec
        for meta in metas:
            meta["y_teacher"] = _teacher_target(
                self.teacher_dir, meta["filename"], self.threshold
            )
        return paths, offsets, metas
