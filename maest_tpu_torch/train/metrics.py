"""Quality metrics (host-side), port of ``maest_tpu/train/metrics.py``.

Macro average precision and ROC AUC as in the reference (reference:
models/module.py:190-191, ex_tl.py:132-133), computed in numpy with
sklearn's definitions (``average_precision_score`` and ``roc_auc_score``
with ``average="macro"``), since the port runs where sklearn is absent.
"""

from __future__ import annotations

import numpy as np


def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """True and false positives at each distinct score, highest first
    (sklearn's ``_binary_clf_curve``: tied scores form one threshold)."""
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[order]
    y_true = y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """The step sum over distinct thresholds, sum_n (R_n - R_{n-1}) P_n
    (sklearn's ``average_precision_score`` of one column)."""
    fps, tps = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.hstack((precision[::-1], 1))
    recall = np.hstack((recall[::-1], 0))
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """The trapezoid area under the ROC curve through every distinct
    threshold (sklearn's ``roc_auc_score`` of one column; the curve's
    collinear points sklearn drops add no area)."""
    fps, tps = _binary_clf_curve(y_true, y_score)
    fpr = np.r_[0.0, fps / fps[-1]]
    tpr = np.r_[0.0, tps / tps[-1]]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def macro_ap_roc(y_true: np.ndarray, y_score: np.ndarray) -> tuple[float, float]:
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    # drop classes with no positives or no negatives (undefined AUC)
    pos = y_true.sum(axis=0)
    valid = (pos > 0) & (pos < len(y_true))
    if not valid.any():
        # tiny/degenerate eval subsets (e.g. limit_val_batches smoke runs)
        # can leave no scoreable class
        return float("nan"), float("nan")
    y_true = (y_true[:, valid] == 1).astype(np.float64)
    y_score = y_score[:, valid]
    cols = range(y_true.shape[1])
    ap = np.mean([average_precision(y_true[:, j], y_score[:, j]) for j in cols])
    roc = np.mean([roc_auc(y_true[:, j], y_score[:, j]) for j in cols])
    return float(ap), float(roc)


def gather_across_hosts(arr: np.ndarray) -> np.ndarray:
    """Concatenate a per-rank array across the process group, in rank
    order (the identity for one process). Ranks may hold different row
    counts; the trailing shape must agree."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return arr
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, np.asarray(arr))
    return np.concatenate(parts, axis=0)
