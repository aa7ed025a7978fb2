"""HF ``ASTForAudioClassification`` state dicts, port of the key maps of
``maest_tpu/packaging/hf_ast.py`` (numpy only, their arithmetic unchanged).

The reference ships MAEST weights to the HF hub in AST layout
(reference: packaging/push_to_hub.py:30-144):

  * ``to_hf_ast_state``   — MAEST state dict -> AST state dict: key
    renames, the fused qkv projection split into q/k/v, the decoupled
    freq/time positional tables summed into AST's one joint table
    (flattened row-major over (F, T), token embeds first), the
    distillation head dropped.
  * ``from_hf_ast_state`` — the inverse, so the ``mtg-upf/discogs-maest-*``
    hub checkpoints load into the port's model (``checkpoints.convert.
    normalize_state`` routes their keys here). The joint table splits back
    as freq = row mean, time = column mean of the de-meaned rest, which is
    exact for tables ``to_hf_ast_state`` made.

The rest of the JAX module (the AST config and feature-extractor files,
``save_pretrained``, ``push_to_hub``, the ONNX and TF exports) is not
ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Mapping

import numpy as np

if TYPE_CHECKING:
    from ..models.config import MAESTConfig

State = Dict[str, np.ndarray]

_AST_PREFIX = "audio_spectrogram_transformer"


# ---------------------------------------------------------------------------
# MAEST torch layout <-> HF AST layout
# ---------------------------------------------------------------------------

def _grid_pos_table(state: Mapping[str, np.ndarray]) -> np.ndarray:
    """freq (1,E,F,1) + time (1,E,1,T) -> (F*T, E), row-major over (F, T)."""
    freq = np.asarray(state["freq_new_pos_embed"], np.float32)
    time = np.asarray(state["time_new_pos_embed"], np.float32)
    joint = freq + time  # (1, E, F, T)
    e = joint.shape[1]
    return joint.reshape(e, -1).T  # (F*T, E)


def to_hf_ast_state(state: Mapping[str, np.ndarray]) -> State:
    """MAEST torch-style state dict -> HF AST state dict.

    Mirrors the reference hub conversion (push_to_hub.py:30-115): the fused
    qkv projection splits into thirds, the decoupled pos tables recombine
    into AST's single ``position_embeddings``, the distillation head drops.
    """
    state = {k: np.asarray(v) for k, v in state.items()}
    emb = f"{_AST_PREFIX}.embeddings"
    out: State = {}

    if "dist_token" not in state:
        raise NotImplementedError(
            "HF AST export requires a distilled model (cls + dist tokens); "
            "this state has no dist_token — AST's embedding layout has no "
            "non-distilled variant (reference: push_to_hub.py:78-97)"
        )
    out[f"{emb}.cls_token"] = state["cls_token"].reshape(1, 1, -1)
    out[f"{emb}.distillation_token"] = state["dist_token"].reshape(1, 1, -1)
    tok = state["new_pos_embed"].reshape(1, -1, state["cls_token"].shape[-1])
    grid = _grid_pos_table(state)[None]  # (1, F*T, E)
    out[f"{emb}.position_embeddings"] = np.concatenate([tok, grid], axis=1)
    out[f"{emb}.patch_embeddings.projection.weight"] = state[
        "patch_embed.proj.weight"
    ]
    out[f"{emb}.patch_embeddings.projection.bias"] = state[
        "patch_embed.proj.bias"
    ]

    i = 0
    while f"blocks.{i}.norm1.weight" in state:
        src = f"blocks.{i}"
        dst = f"{_AST_PREFIX}.encoder.layer.{i}"
        for a, b in (("norm1", "layernorm_before"), ("norm2", "layernorm_after")):
            out[f"{dst}.{b}.weight"] = state[f"{src}.{a}.weight"]
            out[f"{dst}.{b}.bias"] = state[f"{src}.{a}.bias"]
        qkv_w = state[f"{src}.attn.qkv.weight"]  # (3E, E)
        if f"{src}.attn.qkv.bias" not in state:
            raise NotImplementedError(
                "HF AST export requires qkv_bias=True: the AST layout has "
                "separate q/k/v biases and its config is emitted with "
                "qkv_bias on (ast_config_dict); this state has none")
        qkv_b = state[f"{src}.attn.qkv.bias"]
        e = qkv_w.shape[1]
        for j, name in enumerate(("query", "key", "value")):
            out[f"{dst}.attention.attention.{name}.weight"] = qkv_w[
                j * e:(j + 1) * e
            ]
            out[f"{dst}.attention.attention.{name}.bias"] = qkv_b[
                j * e:(j + 1) * e
            ]
        out[f"{dst}.attention.output.dense.weight"] = state[
            f"{src}.attn.proj.weight"
        ]
        out[f"{dst}.attention.output.dense.bias"] = state[f"{src}.attn.proj.bias"]
        out[f"{dst}.intermediate.dense.weight"] = state[f"{src}.mlp.fc1.weight"]
        out[f"{dst}.intermediate.dense.bias"] = state[f"{src}.mlp.fc1.bias"]
        out[f"{dst}.output.dense.weight"] = state[f"{src}.mlp.fc2.weight"]
        out[f"{dst}.output.dense.bias"] = state[f"{src}.mlp.fc2.bias"]
        i += 1

    out[f"{_AST_PREFIX}.layernorm.weight"] = state["norm.weight"]
    out[f"{_AST_PREFIX}.layernorm.bias"] = state["norm.bias"]
    if "head.0.weight" in state:
        out["classifier.layernorm.weight"] = state["head.0.weight"]
        out["classifier.layernorm.bias"] = state["head.0.bias"]
        out["classifier.dense.weight"] = state["head.1.weight"]
        out["classifier.dense.bias"] = state["head.1.bias"]
    return out


def from_hf_ast_state(state: Mapping[str, np.ndarray], cfg: MAESTConfig) -> State:
    """HF AST state dict -> MAEST torch-style state dict.

    The joint positional table splits back into decoupled tables: the grid
    part is reshaped to (F, T) and decomposed as ``freq = row-mean`` and
    ``time = remainder column-mean`` — exact for ``to_hf_ast_state`` output
    (a rank-1 sum), and the same convention the reference uses when
    importing joint ImageNet tables (reference: models/maest.py:1008-1034).
    """
    state = {k: np.asarray(v) for k, v in state.items()}
    emb = f"{_AST_PREFIX}.embeddings"
    grid_f, grid_t = cfg.grid_size
    out: State = {}

    if not cfg.distilled:
        raise NotImplementedError(
            "HF AST checkpoints always carry [cls | dist | grid] position "
            "entries (push_to_hub.py:78-97); a non-distilled target cfg "
            "would misparse the table — use a distilled config")
    out["cls_token"] = state[f"{emb}.cls_token"]
    out["dist_token"] = state[f"{emb}.distillation_token"]
    pos = state[f"{emb}.position_embeddings"].astype(np.float64)  # (1, 2+F*T, E)
    ntok = 2  # the AST layout is fixed, not a property of the target cfg
    out["new_pos_embed"] = pos[:, :ntok].astype(np.float32)
    grid = pos[0, ntok:]  # (F*T_src, E)
    if grid.shape[0] % grid_f:
        raise ValueError(
            f"pos table has {grid.shape[0]} grid entries, not divisible by "
            f"the {grid_f}-row frequency grid (input_f/stride_f fix F; only "
            "the time grid may differ between export and target)"
        )
    # T_src may differ from the target grid (e.g. loading a 30 s hub export
    # into a 10 s config): split at the EXPORT geometry; the loader's
    # adapt_pos_embeds then bicubic-resizes the time table to the target,
    # exactly as the torch-checkpoint path does (checkpoints/convert.py
    # adapt_pos_embeds)
    t_src = grid.shape[0] // grid_f
    g = grid.reshape(grid_f, t_src, -1)  # (F, T_src, E)
    freq = g.mean(axis=1)  # (F, E)
    time = (g - freq[:, None]).mean(axis=0)  # (T, E)
    out["freq_new_pos_embed"] = freq.T[None, :, :, None].astype(np.float32)
    out["time_new_pos_embed"] = time.T[None, :, None, :].astype(np.float32)

    out["patch_embed.proj.weight"] = state[
        f"{emb}.patch_embeddings.projection.weight"
    ]
    out["patch_embed.proj.bias"] = state[
        f"{emb}.patch_embeddings.projection.bias"
    ]

    for i in range(cfg.depth):
        src = f"{_AST_PREFIX}.encoder.layer.{i}"
        dst = f"blocks.{i}"
        for a, b in (("layernorm_before", "norm1"), ("layernorm_after", "norm2")):
            out[f"{dst}.{b}.weight"] = state[f"{src}.{a}.weight"]
            out[f"{dst}.{b}.bias"] = state[f"{src}.{a}.bias"]
        qw = [state[f"{src}.attention.attention.{n}.weight"]
              for n in ("query", "key", "value")]
        qb = [state[f"{src}.attention.attention.{n}.bias"]
              for n in ("query", "key", "value")]
        out[f"{dst}.attn.qkv.weight"] = np.concatenate(qw, axis=0)
        out[f"{dst}.attn.qkv.bias"] = np.concatenate(qb, axis=0)
        out[f"{dst}.attn.proj.weight"] = state[f"{src}.attention.output.dense.weight"]
        out[f"{dst}.attn.proj.bias"] = state[f"{src}.attention.output.dense.bias"]
        out[f"{dst}.mlp.fc1.weight"] = state[f"{src}.intermediate.dense.weight"]
        out[f"{dst}.mlp.fc1.bias"] = state[f"{src}.intermediate.dense.bias"]
        out[f"{dst}.mlp.fc2.weight"] = state[f"{src}.output.dense.weight"]
        out[f"{dst}.mlp.fc2.bias"] = state[f"{src}.output.dense.bias"]

    out["norm.weight"] = state[f"{_AST_PREFIX}.layernorm.weight"]
    out["norm.bias"] = state[f"{_AST_PREFIX}.layernorm.bias"]
    if "classifier.dense.weight" in state:
        out["head.0.weight"] = state["classifier.layernorm.weight"]
        out["head.0.bias"] = state["classifier.layernorm.bias"]
        out["head.1.weight"] = state["classifier.dense.weight"]
        out["head.1.bias"] = state["classifier.dense.bias"]
    return out
