"""Parameter-count utilities (reference: helpers/models_size.py:1-35),
port of ``maest_tpu/utils/params.py``: counts over the tensors of a
module's ``state_dict`` or of a mapping of tensors."""

from __future__ import annotations

import torch


def _tensors(params):
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return list(params.values()) if hasattr(params, "values") else list(params)


def count_params(params) -> int:
    """Total element count."""
    return int(sum(t.numel() for t in _tensors(params)))


def count_non_zero_params(params) -> dict:
    """Total vs non-zero element counts (sparsity report)."""
    total = nonzero = 0
    for t in _tensors(params):
        total += t.numel()
        nonzero += int(torch.count_nonzero(t))
    return {
        "total": total,
        "non_zero": nonzero,
        "sparsity": (1.0 - nonzero / total) if total else 0.0,
    }
