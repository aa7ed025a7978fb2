"""Layered configuration: defaults + named presets + dotted CLI overrides.

A copy of ``maest_tpu/configs.py``, its values unchanged: the port keeps
its own, so that it reads nothing of the JAX package.

The reference uses Sacred (one Experiment + 4 Ingredients, 17 named configs,
CLI dotted overrides — reference: ex_maest.py:28-69, config_updates.py:4-266).
This module provides the equivalent as plain nested dicts:

    cfg = build_experiment_config(["maest_30s_from_passt_pretrain"],
                                  ["trainer.max_epochs=2"])

Preset names and key paths match the reference so recipes translate 1:1.
"""

from __future__ import annotations

import ast
import copy
from typing import Iterable, Mapping


def default_config() -> dict:
    """Defaults mirroring the reference config functions
    (reference: ex_maest.py:41-65, discogs/dataset.py:15-23,
    discogs/datamodule.py:24-76, models/maest.py:1444-1464,
    models/module.py:22-41)."""
    return {
        "ckpt_path": None,
        "seed": 0,
        "trainer": {
            "max_epochs": 130,
            "devices": None,  # None -> all visible devices
            "precision": "bf16",  # TPU-native mixed precision
            "limit_train_batches": None,
            "limit_val_batches": None,
            # separate from limit_val_batches (Lightning semantics): a
            # cheap mid-training val limit must not truncate test metrics
            "limit_test_batches": None,
            "log_every_n_steps": 50,
            "default_root_dir": "exp_logs",
            "model_parallel": 1,
            "sequence_parallel": False,  # Megatron-SP (needs model_parallel>1)
            "fsdp": False,  # ZeRO-3: shard params+opt state over the data axis
            "pipeline_parallel": 0,  # >1: GPipe stages over a 'pipe' mesh axis
            "num_microbatches": 4,  # GPipe microbatches per step
            "accumulate_grad_batches": 1,  # optax.MultiSteps grad accumulation
            "resilient": False,  # restart from ckpt on infra failures
            "max_restarts": 3,
        },
        "predict": {
            "transformer_block": 11,
            "out_dir": "exp_out/",
        },
        "speed_test": {  # model_speed_test command (reference: ex_maest.py:108)
            "batch_size": 100,
            "test_length": 100,
        },
        "dataset": {
            "name": "discogs",
            "sample_rate": 16000,
            "hop_size": 256,
            "n_bands": 96,
            "half_overlapped_inference": False,
        },
        "datamodule": {
            "base_dir": "data/discotube30s/",
            "base_dir_val": "",
            "groundtruth_train": "discogs/gt_train_all_400l_super_clean.pk",
            "groundtruth_val": "discogs/gt_val_all_400l_super_clean.pk",
            "groundtruth_test": "discogs/gt_test_all_400l_super_clean.pk",
            "groundtruth_predict": "discogs/gt_val_all_400l_super_clean.pk",
            "batch_size_train": 12,
            "batch_size_test": 20,
            "num_workers": 16,
            "clip_length": 10,
            "roll": {"do": False, "axis": -1, "shift": None, "shift_range": 50},
            "norm": {
                "do": True,
                "norm_mean": 2.06755686098554,
                "norm_std": 1.268292820667291,
            },
            "masking": {
                "do": True,
                "time_mask_param": 8,
                "freq_mask_param": 5,
                "p": 0.2,
                "iid_masks": True,
                "time_masks": 20,
                "freq_masks": 8,
            },
            "sampler": {
                "sample_weight_offset": 100,
                "sample_weight_sum": True,
                "sampler_replace": False,
                "epoch_len": 200000,
            },
            "teacher_student": {
                "do": False,
                "teacher_target_base_dir": "",
                "teacher_target_threshold": 0.45,
            },
        },
        "maest": {
            "arch": "passt_s_swa_p16_128_ap476",
            "pretrained": False,
            "n_classes": 400,
            "in_channels": 1,
            "stride_f": 10,
            "stride_t": 10,
            "input_f": 96,
            "input_t": 998,
            "u_patchout": 0,
            "s_patchout_t": 0,
            "s_patchout_f": 0,
            "s_patchout_f_indices": (),
            "s_patchout_f_interleaved": 0,
            "s_patchout_t_indices": (),
            "s_patchout_t_interleaved": 0,
            "distilled_type": "mean",
            "checkpoint": None,
            "checkpoint_swa_weights": True,
            "checkpoint_discard_head": False,
            # ViT-Base constants; overridable for lightened/test models
            "embed_dim": 768,
            "depth": 12,
            "num_heads": 12,
            # TPU execution knobs (beyond reference; measured A/Bs in
            # docs/DESIGN.md round-3): transformer-block rematerialization
            # for memory-bound runs, its save policy, and 8-bit attention
            # arithmetic (off: slower than bf16 at MAEST's d=64 geometry).
            "remat": False,
            "remat_policy": "full",
            "attention_quant": "none",
            "attention_bwd_quant": "none",
        },
        "module": {
            "do_swa": True,
            "swa_epoch_start": 50,
            # SWA-phase LR: Lightning swaps the scheduler for torch SWALR
            # annealing to this value (reference: models/module.py:26,
            # 268-273); consumed by Trainer -> make_schedule(swa_lr=...).
            # The reference also has `swa_freq = 5` — dead there too
            # (nothing reads it, Lightning's SWA has no such knob); we
            # reject it instead of carrying a key no code path reads.
            "swa_lrs": 2e-5,
            "mixup_alpha": 0.3,
            "optimizer": {
                "lr": 0.00002,
                "adamw": True,
                "weight_decay": 0.0001,
                "warm_up_len": 5,
                "ramp_down_start": 50,
                "ramp_down_len": 50,
                "last_lr_value": 0.01,
                "schedule_mode": "exp_lin",
            },
        },
    }


def _merge(dst: dict, src: Mapping) -> dict:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


# ---------------------------------------------------------------------------
# named presets (reference: config_updates.py:4-266)
# ---------------------------------------------------------------------------

def _pretrain(clip_length: int, s_patchout_t: int, arch="passt_s_swa_p16_128_ap476",
              pretrained=True, **maest_extra) -> dict:
    return {
        "datamodule": {"clip_length": clip_length},
        "maest": {
            "arch": arch,
            "pretrained": pretrained,
            "input_t": clip_length * 16000 // 256,
            "s_patchout_t": s_patchout_t,
            **maest_extra,
        },
    }


def _inference(clip_length: int, arch: str, **maest_extra) -> dict:
    return {
        "datamodule": {"clip_length": clip_length},
        "maest": {
            "arch": arch,
            "pretrained": True,
            "input_t": clip_length * 16000 // 256,
            **maest_extra,
        },
        "predict": {"transformer_block": 7},
    }


PRESETS: dict[str, dict] = {
    "mini_train": {
        "trainer": {"limit_train_batches": 5, "limit_val_batches": 5},
    },
    # §4.2 impact of initial weights
    "maest_10s_random_weights_pretrain": _pretrain(10, 30, pretrained=False),
    "maest_10s_from_deit_pretrain": _pretrain(10, 30, arch="passt_deit_bd_p16_384"),
    "maest_10s_from_passt_pretrain": _pretrain(10, 30),
    "maest_10s_random_weights_inference": _inference(10, "discogs-maest-10s-fs-129e"),
    "maest_10s_from_deit_inference": _inference(10, "discogs-maest-10s-dw-75e"),
    "maest_10s_from_passt_inference": _inference(10, "discogs-maest-10s-pw-129e"),
    # §4.3 sequence length
    "maest_5s_from_passt_pretrain": _pretrain(5, 30),
    "maest_20s_from_passt_pretrain": _pretrain(20, 60),
    "maest_30s_from_passt_pretrain": _pretrain(30, 90),
    "maest_5s_from_passt_inference": _inference(5, "discogs-maest-5s-pw-129e"),
    "maest_20s_from_passt_inference": _inference(20, "discogs-maest-20s-pw-129e"),
    "maest_30s_from_passt_inference": _inference(30, "discogs-maest-30s-pw-129e"),
    # teacher-student
    # QUIRK preserved: the reference TS named configs never set
    # "pretrained", so they run with the Sacred default pretrained=False
    # (random init despite the from_passt name; reference:
    # config_updates.py:197-236 vs models/maest.py:1447) — inheriting the
    # _pretrain/_inference pretrained=True here would silently train from
    # different initial weights than the reference recipe.
    "maest_30s_from_passt_teacher_student_pretrain": _merge(
        _pretrain(30, 90, distilled_type="separated"),
        {"maest": {"pretrained": False},
         "datamodule": {
            "batch_size_train": 4,
            "teacher_student": {"do": True, "teacher_target_base_dir": ""},
        }},
    ),
    "maest_30s_from_passt_teacher_student_inference": _merge(
        _inference(30, "discogs-maest-30s-pw-73e-ts", distilled_type="separated"),
        {"maest": {"pretrained": False},
         "datamodule": {
            "batch_size_train": 4,
            "teacher_student": {"do": True, "teacher_target_base_dir": ""},
        }},
    ),
    # downstream targets
    "target_mtt": {
        "datamodule": {
            "groundtruth_predict": "datasets/mtt/groundtruth-all.pk",
            "base_dir": "datasets/mtt/data/mtt/melspec/",
        },
        "predict": {"out_dir": "outputs/embeddings/mtt/"},
    },
}


def parse_override(s: str) -> tuple[list[str], object]:
    """Parse ``a.b.c=value`` with Python-literal values (Sacred-style)."""
    if "=" not in s:
        raise ValueError(f"override {s!r} must be key=value")
    key, _, raw = s.partition("=")
    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw  # bare string
    return key.strip().split("."), value


def apply_override(cfg: dict, path: list[str], value) -> None:
    """Set ``cfg[a][b][c] = value`` for path ``[a, b, c]``.

    Unknown key paths are REJECTED, as Sacred does in the reference CLI: a
    typo'd override (``trainer.max_epoch=2``) silently creating a dead key
    while the real setting keeps its default is the worst failure mode a
    long training run can start with."""
    node = cfg
    for i, k in enumerate(path[:-1]):
        if not isinstance(node.get(k), dict):
            raise KeyError(
                f"unknown config path {'.'.join(path)!r} "
                f"({'.'.join(path[:i + 1])!r} is not a config section)"
            )
        node = node[k]
    if path[-1] not in node:
        removed = _REMOVED_KEYS.get(".".join(path))
        if removed:
            raise KeyError(f"config key {'.'.join(path)!r} is not supported: "
                           f"{removed}")
        raise KeyError(
            f"unknown config key {'.'.join(path)!r} "
            f"(valid keys here: {sorted(node)})"
        )
    node[path[-1]] = value


# Keys that exist in the reference config surface but that no code path
# reads — there OR here. Rejected with a pointer rather than silently
# accepted (see apply_override's docstring for why).
_REMOVED_KEYS = {
    "module.swa_freq": (
        "dead in the reference too (models/module.py:27 sets it; nothing "
        "consumes it — Lightning's StochasticWeightAveraging has no "
        "frequency knob). SWA updates run every epoch from "
        "module.swa_epoch_start."
    ),
    # Lightning-Trainer plumbing from the reference launch surface
    # (ex_maest.py:45-60, ex_maest519.sh) with no JAX equivalent knob —
    # rejected with the translation so the 519 launch script ports 1:1:
    "trainer.num_sanity_val_steps": (
        "Lightning sanity-val plumbing; this trainer runs no sanity val "
        "loop, so 0 is already the behavior — drop the key."
    ),
    "trainer.num_nodes": (
        "multi-host size comes from jax.distributed "
        "(parallel/mesh.py::init_distributed num_processes), not a "
        "trainer key — drop it; trainer.devices is the per-launch mesh "
        "size."
    ),
    "trainer.sync_batchnorm": (
        "MAEST has no batch-norm layers (LayerNorm only); the reference "
        "sets it (ex_maest.py:50) but it never has an effect — drop the "
        "key."
    ),
    "trainer.strategy": (
        "DDP strategy selection is implicit: multi-device runs shard via "
        "the jax mesh (trainer.devices / init_distributed) — drop the key."
    ),
    "trainer.reload_dataloaders_every_n_epochs": (
        "the sampler redraws per epoch by construction "
        "(data/sampler.py seed+epoch), which is what the reference used "
        "this Lightning flag for (ex_maest.py:56) — drop the key."
    ),
    "datamodule.num_replicas": (
        "rank sharding derives from jax.process_index/process_count "
        "(train/loop.py), not a datamodule key (reference wires "
        "trainer.devices into it, ex_maest.py:88) — drop the key."
    ),
    "module.optimizer.reaload_dataloaders_every_n_epochs": (
        "typo'd and dead in the reference (models/module.py:40; nothing "
        "reads it) — drop the key."
    ),
}


def build_experiment_config(presets: Iterable[str] = (),
                            overrides: Iterable[str] = ()) -> dict:
    cfg = default_config()
    for name in presets:
        if name not in PRESETS:
            raise KeyError(
                f"unknown preset {name!r}; available: {sorted(PRESETS)}"
            )
        _merge(cfg, PRESETS[name])
    for ov in overrides:
        path, value = parse_override(ov)
        apply_override(cfg, path, value)
    return cfg
