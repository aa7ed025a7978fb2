from .convert import (
    adapt_pos_embeds,
    load_checkpoint_file,
    load_into,
    load_torch_checkpoint,
    normalize_state,
    state_from_jax_params,
    strip_prefix,
)

__all__ = [
    "adapt_pos_embeds",
    "load_checkpoint_file",
    "load_into",
    "load_torch_checkpoint",
    "normalize_state",
    "state_from_jax_params",
    "strip_prefix",
]
