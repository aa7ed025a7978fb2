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

The export half writes a release from the port's model (an ``nn.Module``
— ``MAESTNet`` or the ``MAEST`` wrapper — or its state dict with its
config):

  * ``ast_config_dict`` / ``feature_extractor_config`` — the HF
    ``ASTConfig`` and the ``MAESTFeatureExtractor`` preprocessor dicts;
  * ``save_pretrained`` — config.json, model.safetensors (AST layout),
    preprocessor_config.json and the port's copy of
    ``feature_extraction_maest.py``; ``push_to_hub`` uploads that directory;
  * ``save_torch_checkpoint`` — a MAEST-layout ``.pt`` state dict.

As in the JAX package, a per-frequency model is not exported (export the
weights from before ``fix_embedding_layer``), and the AST layout refuses a
non-distilled model or one without qkv biases. The TF SavedModel export
(jax2tf) has no counterpart.
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Dict, Mapping, Optional

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


# ---------------------------------------------------------------------------
# the port's model -> MAEST torch layout, config and feature-extractor
# metadata, save / push
# ---------------------------------------------------------------------------

def export_state(model, cfg: Optional[MAESTConfig] = None
                 ) -> tuple[State, MAESTConfig]:
    """(MAEST-layout float32 numpy state, config) of ``model``: a
    ``MAESTNet``, a ``MAEST`` wrapper (``cfg`` taken from it) or a state
    dict with its ``cfg``. The keys are those the JAX package's
    ``jax_to_torch_state`` writes for the same model: ``head_dist`` only
    under ``distilled_type="separated"``."""
    net = getattr(model, "net", model)
    if hasattr(net, "state_dict"):
        cfg = cfg or net.cfg
        model = net.state_dict()
    if cfg is None:
        raise ValueError("a state dict needs its config (cfg=)")
    if "patch_embed.freq_kernel" in model:
        raise NotImplementedError(
            "per-freq patch embedding has no torch/AST export mapping — the "
            "reference's fix_embedding_layer surgery is load-time only "
            "(models/maest.py:295-298); export the pre-surgery params")
    drop_dist = cfg.distilled_type != "separated"
    state = {k: np.asarray(v.detach().float().cpu().numpy()
                           if hasattr(v, "detach") else v, np.float32)
             for k, v in model.items()
             if not (drop_dist and k.startswith("head_dist."))}
    return state, cfg


def _ast_max_length(cfg: MAESTConfig) -> int:
    """Smallest frame count whose VALID conv emits exactly ``grid_t`` time
    patches: ``patch + stride_t*(grid_t-1)`` (reference per-duration table
    316/626/1256/1876, push_to_hub.py:100-108), for config.json and
    preprocessor_config.json alike."""
    return cfg.patch_size + cfg.stride[1] * (cfg.grid_size[1] - 1)


def ast_config_dict(cfg: MAESTConfig, labels=None) -> dict:
    """HF ``ASTConfig`` dict (reference: push_to_hub.py:100-144): 96 mel
    bins, stride 10, eps 1e-6, ``max_length`` from ``_ast_max_length`` so
    AST's position-embedding count matches the exported (grid_f*grid_t +
    2) table."""
    d = {
        "architectures": ["ASTForAudioClassification"],
        "model_type": "audio-spectrogram-transformer",
        "hidden_size": cfg.embed_dim,
        "num_hidden_layers": cfg.depth,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": int(cfg.embed_dim * cfg.mlp_ratio),
        "hidden_act": "gelu",
        "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0,
        "initializer_range": 0.02,
        "layer_norm_eps": 1e-6,
        "patch_size": cfg.patch_size,
        "qkv_bias": True,
        "frequency_stride": cfg.stride[0],
        "time_stride": cfg.stride[1],
        "max_length": _ast_max_length(cfg),
        "num_mel_bins": cfg.img_size[0],
        "num_labels": cfg.num_classes,
    }
    if labels is not None:
        d["id2label"] = {str(i): l for i, l in enumerate(labels)}
        d["label2id"] = {l: i for i, l in enumerate(labels)}
    return d


def feature_extractor_config(cfg: MAESTConfig) -> dict:
    """Mel front-end constants in HF feature-extractor form (the hub-side
    ``MAESTFeatureExtractor`` the reference points at — push_to_hub.py:7).
    ``auto_map`` names the ``feature_extraction_maest.py`` shipped beside
    the weights, which ``AutoFeatureExtractor`` loads with
    ``trust_remote_code=True``."""
    from ..dsp.mel import MelConfig

    mel = MelConfig()
    return {
        "feature_extractor_type": "MAESTFeatureExtractor",
        "auto_map": {
            "AutoFeatureExtractor":
                "feature_extraction_maest.MAESTFeatureExtractor",
        },
        "sampling_rate": mel.sample_rate,
        "n_fft": mel.n_fft,
        "hop_length": mel.hop_length,
        "num_mel_bins": mel.n_mels,
        "mel_scale": "slaney",
        "mel_norm": "slaney",
        "log_compression_scale": mel.compression_scale,
        "mean": mel.norm_mean,
        "std": mel.norm_std,
        "max_length": _ast_max_length(cfg),
        "padding_value": 0.0,
        "return_attention_mask": False,
    }


def save_pretrained(model, cfg: Optional[MAESTConfig], out_dir: str,
                    labels=None) -> str:
    """Write an HF-layout model directory: config.json, model.safetensors
    (AST layout), preprocessor_config.json and feature_extraction_maest.py.
    Needs the ``safetensors`` package."""
    try:
        from safetensors.numpy import save_file
    except ImportError as err:
        raise ImportError(
            "writing model.safetensors needs the 'safetensors' package"
        ) from err
    import shutil

    state, cfg = export_state(model, cfg)
    ast_state = to_hf_ast_state(state)
    os.makedirs(out_dir, exist_ok=True)
    save_file(
        {k: np.ascontiguousarray(v, dtype=np.float32)
         for k, v in ast_state.items()},
        os.path.join(out_dir, "model.safetensors"),
        # "pt" is a metadata tag only (the byte format is identical);
        # transformers refuses to load files tagged "np"
        metadata={"format": "pt"},
    )
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(ast_config_dict(cfg, labels), f, indent=2)
    with open(os.path.join(out_dir, "preprocessor_config.json"), "w") as f:
        json.dump(feature_extractor_config(cfg), f, indent=2)
    shutil.copyfile(
        os.path.join(os.path.dirname(__file__), "feature_extraction_maest.py"),
        os.path.join(out_dir, "feature_extraction_maest.py"))
    return out_dir


def save_torch_checkpoint(model, cfg: Optional[MAESTConfig], path: str,
                          swa_prefix: bool = False) -> str:
    """Write a torch ``.pt`` state dict in MAEST layout (the reference's
    safetensors->pytorch direction, packaging/safetensors_to_pytorch.py:7-17),
    loadable by the upstream repo and by ``get_maest(checkpoint=...)``.
    ``swa_prefix`` stores keys as ``net_swa.*``, as released files do."""
    import torch

    state, _ = export_state(model, cfg)
    prefix = "net_swa." if swa_prefix else ""
    torch.save({prefix + k: torch.from_numpy(v) for k, v in state.items()},
               path)
    return path


def push_to_hub(model, cfg: Optional[MAESTConfig], repo_id: str, labels=None,
                private: bool = True) -> str:
    """Upload ``save_pretrained``'s directory to the HF hub (needs the
    network, ``huggingface_hub`` and a login)."""
    import tempfile

    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise RuntimeError("huggingface_hub is not available") from e

    with tempfile.TemporaryDirectory() as tmp:
        save_pretrained(model, cfg, tmp, labels)
        api = HfApi()
        api.create_repo(repo_id, private=private, exist_ok=True)
        api.upload_folder(folder_path=tmp, repo_id=repo_id)
    return repo_id
