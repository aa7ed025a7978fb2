"""Checkpoint interchange and release packaging: the HF AST hub layout
(both directions, ``save_pretrained``, ``push_to_hub``), MAEST-layout
``.pt`` files and the ONNX export."""

from .hf_ast import (
    ast_config_dict,
    feature_extractor_config,
    from_hf_ast_state,
    push_to_hub,
    save_pretrained,
    save_torch_checkpoint,
    to_hf_ast_state,
)
from .onnx_export import export_onnx, read_onnx_io

__all__ = ["ast_config_dict", "export_onnx", "feature_extractor_config",
           "from_hf_ast_state", "push_to_hub", "read_onnx_io",
           "save_pretrained", "save_torch_checkpoint", "to_hf_ast_state"]
