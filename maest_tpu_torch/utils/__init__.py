"""Utilities: profiling, parameter counting, run records (port of
``maest_tpu/utils``; the XLA compilation cache and the Mosaic tile maths
have no counterpart)."""

from .params import count_non_zero_params, count_params  # noqa: F401
from .profiling import StepTimer, force, trace  # noqa: F401
