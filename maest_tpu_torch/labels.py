"""Discogs label vocabularies, shared with ``maest_tpu/labels.py``."""

from ._reference import load

_labels = load("labels")

DISCOGS_400_LABELS = _labels.DISCOGS_400_LABELS
DISCOGS_519_LABELS = _labels.DISCOGS_519_LABELS
labels_for = _labels.labels_for

__all__ = ["DISCOGS_400_LABELS", "DISCOGS_519_LABELS", "labels_for"]
