from .config import MAESTConfig
from .registry import ARCHS, build_config, list_architectures
from .vit import MAESTNet

__all__ = ["ARCHS", "MAESTConfig", "MAESTNet", "build_config",
           "list_architectures"]
