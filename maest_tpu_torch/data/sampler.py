"""Class-balanced weighted sampling with per-host sharding.

Reference semantics (reference: discogs/datamodule.py:79-97, 154-209):
  * per-sample weight = sum over positive labels of 1000 / (class_freq + offset)
  * an epoch draws ``epoch_len`` indices, weighted, without replacement by
    default (torch ``WeightedRandomSampler(replacement=False)``)
  * seeded by ``seed + epoch`` so all replicas draw the identical sequence,
    then each host takes the strided slice ``indices[rank::num_replicas]``.

Weighted sampling without replacement uses the Gumbel top-k trick
(equivalent to the Efraimidis-Spirakis scheme torch implements).
"""

from __future__ import annotations

import numpy as np


def class_balanced_weights(
    targets: np.ndarray,
    sample_weight_offset: float = 100.0,
    sample_weight_sum: bool = True,
) -> np.ndarray:
    """Per-sample sampling weights (reference: discogs/datamodule.py:154-181)."""
    all_y = np.asarray(targets, dtype=np.float64)
    per_class = all_y.sum(axis=0, keepdims=True) + sample_weight_offset
    per_class_weights = 1000.0 / per_class
    all_weight = all_y * per_class_weights
    if sample_weight_sum:
        return all_weight.sum(axis=1)
    return all_weight.max(axis=1)


def class_balanced_weights_streaming(
    groundtruth: dict,
    filenames,
    sample_weight_offset: float = 100.0,
    sample_weight_sum: bool = True,
    chunk_size: int = 65536,
) -> np.ndarray:
    """``class_balanced_weights`` without materialising the dense
    ``(N, n_classes)`` targets matrix.

    At Discogs scale (N≈2M × 400 labels) the dense float64 matrix the
    reference implicitly builds (reference: discogs/datamodule.py:158-170)
    is 6.4 GB of transient host RAM; two streamed passes (class counts,
    then per-sample weights) keep the peak at ``chunk_size`` rows
    (~200 MB at the default) and return bit-identical weights — summation
    order per class is preserved because chunks are contiguous."""
    filenames = list(filenames)
    n = len(filenames)
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    counts = None
    for lo in range(0, n, chunk_size):
        block = np.asarray(
            [groundtruth[f] for f in filenames[lo:lo + chunk_size]],
            dtype=np.float64)
        c = block.sum(axis=0)
        counts = c if counts is None else counts + c
    per_class_weights = 1000.0 / (counts + sample_weight_offset)
    out = np.empty(n, dtype=np.float64)
    for lo in range(0, n, chunk_size):
        block = np.asarray(
            [groundtruth[f] for f in filenames[lo:lo + chunk_size]],
            dtype=np.float64)
        w = block * per_class_weights
        out[lo:lo + len(block)] = (
            w.sum(axis=1) if sample_weight_sum else w.max(axis=1))
    return out


def weighted_epoch_indices(
    weights: np.ndarray,
    epoch_len: int,
    *,
    seed: int = 0,
    epoch: int = 0,
    replacement: bool = False,
    rank: int = 0,
    num_replicas: int = 1,
) -> np.ndarray:
    """Draw one epoch of weighted indices, sharded by rank."""
    rng = np.random.default_rng(seed + epoch)
    w = np.asarray(weights, dtype=np.float64)
    n = len(w)
    if w.sum() <= 0:
        # with-replacement would die on 0/0 -> NaN probabilities and the
        # Gumbel path would silently degrade to uniform — either way the
        # groundtruth is unusable (no sample has a positive label); say so
        raise ValueError(
            "all sampling weights are zero — no sample has a positive "
            "label (check the groundtruth pickle)")
    n_pos = int((w > 0).sum())
    if not replacement and epoch_len <= n and epoch_len > n_pos:
        # torch's WeightedRandomSampler(replacement=False) raises here;
        # Gumbel top-k fills the remainder uniformly from the zero-weight
        # samples (label-less tracks) — allowed for small/debug corpora,
        # but loudly: it changes the training statistics
        import logging

        logging.getLogger(__name__).warning(
            "epoch_len %d > %d positively-weighted samples: %d draws will "
            "be zero-weight (label-less) tracks", epoch_len, n_pos,
            epoch_len - n_pos,
        )
    if not replacement and epoch_len > n:
        # torch's WeightedRandomSampler would raise here; we fall back to
        # with-replacement (small/debug datasets) but LOUDLY — duplicate
        # samples change the training statistics vs the documented
        # without-replacement semantics
        import logging

        logging.getLogger(__name__).warning(
            "epoch_len %d > dataset size %d: sampling WITH replacement "
            "despite sampler_replace=False", epoch_len, n,
        )
    if replacement or epoch_len > n:
        p = w / w.sum()
        idx = rng.choice(n, size=epoch_len, replace=True, p=p)
    else:
        # Gumbel top-k == weighted sampling without replacement
        gumbel = rng.gumbel(size=n)
        keys = np.log(np.maximum(w, 1e-30)) + gumbel
        idx = np.argpartition(-keys, epoch_len - 1)[:epoch_len]
        idx = idx[np.argsort(-keys[idx])]
    total = (len(idx) // num_replicas) * num_replicas if num_replicas > 1 else len(idx)
    return idx[rank:total:num_replicas]
