"""Experiment configuration (defaults, named presets, dotted overrides),
shared with ``maest_tpu/configs.py``::

    cfg = build_experiment_config(["maest_30s_from_passt_pretrain"],
                                  ["maest.pretrained=False"])
"""

from ._reference import load

_configs = load("configs")

PRESETS = _configs.PRESETS
build_experiment_config = _configs.build_experiment_config
default_config = _configs.default_config

__all__ = ["PRESETS", "build_experiment_config", "default_config"]
