"""Checkpoint interchange layouts (the HF AST hub layout)."""

from .hf_ast import from_hf_ast_state, to_hf_ast_state

__all__ = ["from_hf_ast_state", "to_hf_ast_state"]
