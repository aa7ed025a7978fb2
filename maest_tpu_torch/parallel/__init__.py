"""Parallel training across processes, port of ``maest_tpu/parallel``:
the process group, the ``(data, model)`` mesh and the parameter sharding
(data parallelism, FSDP2, tensor and sequence parallelism). The GPipe
pipeline (``maest_tpu/parallel/pipeline.py``) is not ported yet (ROADMAP
queue 1 item 4)."""

from .mesh import (
    Parallel,
    init_distributed,
    make_mesh,
    shard_params,
)
from .tensor_parallel import Layout

__all__ = [
    "Layout",
    "Parallel",
    "init_distributed",
    "make_mesh",
    "shard_params",
]
