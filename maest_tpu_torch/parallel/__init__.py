"""Parallel training across processes, port of ``maest_tpu/parallel``:
the process group, the ``(data, model)`` mesh and the parameter sharding
(data parallelism, FSDP2, tensor and sequence parallelism), and GPipe
over a ``(data, pipe, model)`` mesh (``pipeline``)."""

from .mesh import (
    Parallel,
    init_distributed,
    make_mesh,
    shard_params,
)
from .pipeline import (
    make_pipeline_forward,
    make_pipeline_mesh,
    make_pipeline_train_step,
    pipeline_apply,
)
from .tensor_parallel import Layout

__all__ = [
    "Layout",
    "Parallel",
    "init_distributed",
    "make_mesh",
    "make_pipeline_forward",
    "make_pipeline_mesh",
    "make_pipeline_train_step",
    "pipeline_apply",
    "shard_params",
]
