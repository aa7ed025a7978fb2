"""Model configuration, shared with ``maest_tpu/models/config.py``."""

from .._reference import load

MAESTConfig = load("models.config").MAESTConfig

__all__ = ["MAESTConfig"]
