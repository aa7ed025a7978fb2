"""The full-width goldens of tests/golden/ beyond the 30 s logits: each
one's architecture, kind and seed, and its state and input rebuilt from
the seed with numpy, ``torch_oracle.make_state`` and the port's surgery
alone, so ``chip_smoke.py`` rebuilds them on the card without JAX.

Kinds:
  * "shared" — ``make_state``'s state as it is;
  * "per_freq" — its conv turned into per-frequency rows
    (``surgery.per_freq_params_from_conv``), each row then moved by its
    own draw, so that a row or feature order mixed up shows;
  * "non_distilled" — ``dist_token`` and ``head_dist`` dropped, only the
    cls entry of ``new_pos_embed`` kept.

The goldens are written by ``tests/test_torch_goldens.py --make-golden``
(JAX on the CPU); each file holds the JAX package's fp32 logits, its seed
and, where the torch oracle computes the model, the oracle's logits.
"""

from pathlib import Path

import numpy as np
import torch

from torch_oracle import make_state

GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
# name: (architecture, kind, seed)
GOLDENS = {
    "vitb_5s_logits": ("discogs-maest-5s-pw-129e", "shared", 20261018),
    "vitb_10s_logits": ("discogs-maest-10s-pw-129e", "shared", 20261019),
    "vitb_20s_logits": ("discogs-maest-20s-pw-129e", "shared", 20261020),
    "vitb_30s_519l_logits": ("discogs-maest-30s-pw-129e-519l", "shared",
                             20261021),
    "vitb_30s_per_freq_logits": ("discogs-maest-30s-pw-129e", "per_freq",
                                 20261022),
    "vitb_30s_non_distilled_logits": ("discogs-maest-30s-pw-129e",
                                      "non_distilled", 20261023),
}
PER_ROW_STD = 0.02  # each per-frequency row's move, beside the conv's 0.02


def golden_case(name: str):
    """(port config, torch-layout state, (2, 1, F, T) float32 input) of
    golden ``name``."""
    from maest_tpu_torch.models import surgery
    from maest_tpu_torch.models.registry import build_config

    arch, kind, seed = GOLDENS[name]
    cfg = build_config(arch)
    rng = np.random.default_rng(seed)
    sd = make_state(rng, cfg)
    if kind == "per_freq":
        sd, cfg = surgery.per_freq_params_from_conv(sd, cfg)
        for k in ("patch_embed.freq_kernel", "patch_embed.freq_bias"):
            sd[k] = sd[k] + torch.from_numpy(rng.standard_normal(
                tuple(sd[k].shape)).astype("float32") * PER_ROW_STD)
    elif kind == "non_distilled":
        cfg = cfg.replace(distilled=False)
        sd = {k: v for k, v in sd.items()
              if k != "dist_token" and not k.startswith("head_dist.")}
        sd["new_pos_embed"] = sd["new_pos_embed"][:, :1].clone()
    x = rng.standard_normal((2, 1, *cfg.img_size)).astype("float32") * 0.1
    return cfg, sd, x


def golden_path(name: str) -> Path:
    return GOLDEN_DIR / f"{name}.npz"
