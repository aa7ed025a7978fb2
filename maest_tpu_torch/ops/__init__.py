"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions."""

from .attention import attention_reference, flash_attention
from .mel_kernel import (
    fused_logmel_from_frames,
    fused_logmel_from_frames_reference,
)

__all__ = [
    "attention_reference",
    "flash_attention",
    "fused_logmel_from_frames",
    "fused_logmel_from_frames_reference",
]
