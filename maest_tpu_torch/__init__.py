"""maest_tpu_torch — the MAEST tagging stack on PyTorch and CUDA.

A port of ``maest_tpu`` (JAX/TPU) to one NVIDIA Hopper GPU. It imports
torch and never jax; the JAX package stays the reference it is tested
against. The mel front-end and attention run hand-written CUDA kernels on
the card (``maest_tpu_torch/csrc``) and their plain PyTorch versions on
the CPU::

    from maest_tpu_torch import get_maest
    model = get_maest(arch="discogs-maest-30s-pw-129e", device="cuda")
    activations, labels = model.predict_labels(waveform)
"""

from .api import MAEST, get_maest
from .labels import DISCOGS_400_LABELS, DISCOGS_519_LABELS, labels_for
from .models.config import MAESTConfig
from .models.registry import ARCHS, build_config, list_architectures

__version__ = "0.1.0"

__all__ = [
    "ARCHS",
    "DISCOGS_400_LABELS",
    "DISCOGS_519_LABELS",
    "MAEST",
    "MAESTConfig",
    "build_config",
    "get_maest",
    "labels_for",
    "list_architectures",
    "__version__",
]
