"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions."""

from .attention import (
    attention_bwd,
    attention_bwd_reference,
    attention_reference,
    attention_reference_lse,
    flash_attention,
    flash_attention_fwd_lse,
)
from .mel_kernel import (
    fused_logmel_from_frames,
    fused_logmel_from_frames_reference,
)

__all__ = [
    "attention_bwd",
    "attention_bwd_reference",
    "attention_reference",
    "attention_reference_lse",
    "flash_attention",
    "flash_attention_fwd_lse",
    "fused_logmel_from_frames",
    "fused_logmel_from_frames_reference",
]
