"""Architecture registry, shared with ``maest_tpu/models/registry.py``."""

from .._reference import load

_registry = load("models.registry")

ARCHS = _registry.ARCHS
ArchSpec = _registry.ArchSpec
build_config = _registry.build_config
cache_dir = _registry.cache_dir
cached_checkpoint_path = _registry.cached_checkpoint_path
list_architectures = _registry.list_architectures

__all__ = ["ARCHS", "ArchSpec", "build_config", "cache_dir",
           "cached_checkpoint_path", "list_architectures"]
