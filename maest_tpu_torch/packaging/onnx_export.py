"""ONNX export of the port's model.

The reference builds its deployment ONNX with optimum-cli and then
graph-surgers the interface (reference: packaging/convert_to_onnx.sh,
packaging/onnx_to_tf.sh) into:

  input  ``melspectrogram`` (B, T, 96), the batch axis dynamic
  output ``logits``, ``activations`` (sigmoid), ``layer_{i}_tokens``

``export_onnx`` traces the port's own ``MAESTNet``, fp32 on the CPU with
the materialised softmax (``attention_impl="xla"``), behind a wrapper that
only transposes the input and names the outputs; the patch projection is
exported as the convolution it computes. The TorchScript exporter
(``dynamo=False``, opset 17) serializes the graph in C++; the ``onnx``
package is consulted only to append onnx-script functions, which this
graph has none of, so that step is bypassed and the file is complete
without the package.

``read_onnx_io`` reads a file's interface off the protobuf wire format,
without the ``onnx`` package (a copy of the JAX package's reader).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from ..models.config import MAESTConfig


class _Deployed(nn.Module):
    """The Essentia signature around ``net``: (B, T, F) mels in; logits,
    their sigmoid and every block's tokens out."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, melspectrogram):
        x = melspectrogram.transpose(1, 2).unsqueeze(1)  # (B, 1, F, T)
        logits, _, layer_tokens = self.net(x, return_layer_tokens=True)
        return (logits, torch.sigmoid(logits), *layer_tokens)


def deployed_model(model, cfg: Optional[MAESTConfig] = None) -> nn.Module:
    """The module ``export_onnx`` traces: a fresh fp32 CPU ``MAESTNet`` of
    ``model``'s weights (a ``MAESTNet``, the ``MAEST`` wrapper, or a state
    dict with its ``cfg``) on the materialised-softmax route, in eval
    mode. Only the deployed head (distilled, ``"mean"``) is exported."""
    from ..checkpoints.convert import load_into
    from ..models.vit import MAESTNet
    from .hf_ast import export_state

    net = getattr(model, "net", model)
    cfg = cfg or getattr(net, "cfg", None)
    if cfg is None:
        raise ValueError("a state dict needs its config (cfg=)")
    if not cfg.distilled or cfg.distilled_type != "mean":
        raise NotImplementedError(
            "ONNX export implements the deployed head (distilled 'mean', "
            "all released discogs archs); reference deploys the same "
            "(packaging/onnx_to_tf.sh sigmoid-on-Gemm surgery).")
    state, cfg = export_state(model, cfg)
    out = MAESTNet(cfg.replace(attention_impl="xla"), dtype=torch.float32,
                   device="cpu")
    return _Deployed(load_into(out, state)).eval()


@contextlib.contextmanager
def _passthrough_onnxscript_hook():
    """The exporter's last step re-parses the model bytes with the onnx
    package only to append onnx-script custom functions; this graph has
    none, so the step is the identity. Replace it so export works without
    the package."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        yield
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


def export_onnx(model, path: str, *, cfg: Optional[MAESTConfig] = None,
                opset: int = 17) -> str:
    """Write ``path`` as an ONNX model with the Essentia deployment
    signature (dynamic batch axis). Returns the path."""
    import warnings

    deployed = deployed_model(model, cfg)
    cfg = deployed.net.cfg
    f_bands, t_frames = cfg.img_size
    example = torch.zeros(2, t_frames, f_bands)
    out_names = ["logits", "activations"] + [
        f"layer_{i}_tokens" for i in range(cfg.depth)]
    dyn = {"melspectrogram": {0: "batch_size"}}
    for n in out_names:
        dyn[n] = {0: "batch_size"}
    with _passthrough_onnxscript_hook(), warnings.catch_warnings(), \
            torch.no_grad():
        warnings.simplefilter("ignore")
        torch.onnx.export(
            deployed, (example,), path,
            input_names=["melspectrogram"],
            output_names=out_names,
            dynamic_axes=dyn,
            opset_version=opset,
            dynamo=False,
        )
    return path


# ---------------------------------------------------------------------------
# Dependency-free ONNX inspection (protobuf wire format)

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = val = 0
    while True:
        if i >= len(buf) or shift > 63:
            # truncated file (interrupted export) or corrupt continuation
            # bytes: a parse error, not an IndexError / unbounded shift
            raise ValueError("truncated or corrupt varint — not an ONNX file?")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int) top-level fields."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
            yield field, wire, val
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            yield field, wire, buf[i:i + ln]
            i += ln
        elif wire == 5:
            yield field, wire, buf[i:i + 4]
            i += 4
        elif wire == 1:
            yield field, wire, buf[i:i + 8]
            i += 8
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")


def read_onnx_io(path: str) -> dict:
    """Graph input/output names + op-type histogram of an ONNX file, parsed
    straight off the protobuf wire format (no onnx package needed)."""
    buf = open(path, "rb").read()
    graph = None
    ir_version = opset = None
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            ir_version = val
        elif field == 7 and wire == 2:  # ModelProto.graph
            graph = val
        elif field == 8 and wire == 2:  # ModelProto.opset_import
            dom, ver = b"", None
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:  # OperatorSetIdProto.domain
                    dom = v2
                elif f2 == 2 and w2 == 0:  # OperatorSetIdProto.version
                    ver = v2
            # only the default ai.onnx opset: a custom-domain import (e.g.
            # com.microsoft after ORT processing) must not shadow it
            if dom in (b"", b"ai.onnx") and ver is not None:
                opset = ver
    if graph is None:
        raise ValueError("no GraphProto found — not an ONNX file?")

    def names(field_no: int) -> List[str]:
        out = []
        for f, w, v in _fields(graph):
            if f == field_no and w == 2:  # ValueInfoProto
                for f2, w2, v2 in _fields(v):
                    if f2 == 1 and w2 == 2:  # name
                        out.append(v2.decode("utf-8"))
        return out

    ops: dict = {}
    initializers = set()
    for f, w, v in _fields(graph):
        if f == 1 and w == 2:  # NodeProto
            for f2, w2, v2 in _fields(v):
                if f2 == 4 and w2 == 2:  # op_type
                    op = v2.decode("utf-8")
                    ops[op] = ops.get(op, 0) + 1
        elif f == 5 and w == 2:  # TensorProto initializer
            for f2, w2, v2 in _fields(v):
                if f2 == 8 and w2 == 2:  # name
                    initializers.add(v2.decode("utf-8"))

    # graph inputs include initializers in some exporters; drop them
    inputs = [n for n in names(11) if n not in initializers]
    return {
        "ir_version": ir_version,
        "opset": opset,
        "inputs": inputs,
        "outputs": names(12),
        "ops": ops,
        "n_initializers": len(initializers),
    }
