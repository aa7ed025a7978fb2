"""The data pipeline, port of ``maest_tpu/data``: the mel chunk datasets
and the class-balanced sampler (copies of the JAX package's numpy files),
the batch loader and the prefetch onto the card."""

from .dataset import (
    DatasetConfig,
    ExhaustiveMelDataset,
    ExhaustiveMelDatasetTS,
    MelChunkDataset,
    MelChunkDatasetTS,
    load_groundtruth,
)
from .loader import BatchLoader, device_prefetch
from .sampler import (
    class_balanced_weights,
    class_balanced_weights_streaming,
    weighted_epoch_indices,
)

__all__ = [
    "BatchLoader",
    "DatasetConfig",
    "ExhaustiveMelDataset",
    "ExhaustiveMelDatasetTS",
    "MelChunkDataset",
    "MelChunkDatasetTS",
    "class_balanced_weights",
    "class_balanced_weights_streaming",
    "device_prefetch",
    "load_groundtruth",
    "weighted_epoch_indices",
]
