"""Architecture registry and factory.

A copy of ``maest_tpu/models/registry.py``, its values unchanged: the port keeps
its own, so that it reads nothing of the JAX package.

Mirrors the reference ``default_cfgs`` + arch constructors + ``get_maest``
dispatch (reference: models/maest.py:64-153, 1151-1388, 1467-1569) with the
same public arch strings. Checkpoints are resolved from a local cache
directory (``$MAEST_TPU_CACHE``, default ``~/.cache/maest_tpu``) since the
build environment has no network egress; place the released ``.ckpt`` /
``.safetensors`` files there under their release filenames.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

from .config import MAESTConfig


@dataclass(frozen=True)
class ArchSpec:
    name: str
    url: str
    num_classes: int
    default_input_t: int
    input_f: int = 96  # mel bands (read by scripts/parity_sweep.py)
    # (norm mean/std live with the DSP layer — dsp/mel.py NORM_MEAN/
    # NORM_STD; the duplicated spec copies were dead and drift-prone)
    kind: str = "maest"  # "maest" | "imagenet" (joint pos-embed source)
    # Expected SHA256 of the released checkpoint file, verified by
    # checkpoints/fetch.py before an auto-download is committed to the
    # cache (the file is later torch.load-unpickled, so integrity matters).
    # None = no pin available: this build environment has no egress, so the
    # release digests could not be computed here; pin them when publishing.
    sha256: str | None = None


_REL = "https://github.com/palonso/MAEST/releases/download/v0.0.0-beta"

ARCHS: dict[str, ArchSpec] = {
    "passt_deit_bd_p16_384": ArchSpec(
        "passt_deit_bd_p16_384",
        "https://dl.fbaipublicfiles.com/deit/deit_base_patch16_384-8de9b5d1.pth",
        1000, 998, kind="imagenet",
    ),
    "passt_s_swa_p16_128_ap476": ArchSpec(
        "passt_s_swa_p16_128_ap476",
        "https://github.com/kkoutini/PaSST/releases/download/v0.0.1-audioset/"
        "passt-s-f128-p16-s10-ap.476-swa.pt",
        527, 998,
    ),
    "discogs-maest-5s-pw-129e": ArchSpec(
        "discogs-maest-5s-pw-129e", f"{_REL}/discogs-maest-5s-pw-129e-swa.ckpt",
        400, 312,
    ),
    "discogs-maest-10s-fs-129e": ArchSpec(
        "discogs-maest-10s-fs-129e", f"{_REL}/discogs-maest-10s-fs-129e-swa.ckpt",
        400, 625,
    ),
    "discogs-maest-10s-pw-129e": ArchSpec(
        "discogs-maest-10s-pw-129e", f"{_REL}/discogs-maest-10s-pw-129e-swa.ckpt",
        400, 625,
    ),
    "discogs-maest-10s-dw-75e": ArchSpec(
        "discogs-maest-10s-dw-75e", f"{_REL}/discogs-maest-10s-dw-75e-swa.ckpt",
        400, 625,
    ),
    "discogs-maest-20s-pw-129e": ArchSpec(
        "discogs-maest-20s-pw-129e", f"{_REL}/discogs-maest-20s-pw-129e-swa.ckpt",
        400, 1250,
    ),
    "discogs-maest-30s-pw-129e": ArchSpec(
        "discogs-maest-30s-pw-129e", f"{_REL}/discogs-maest-30s-pw-129e-swa.ckpt",
        400, 1875,
    ),
    "discogs-maest-30s-pw-73e-ts": ArchSpec(
        "discogs-maest-30s-pw-73e-ts", f"{_REL}/discogs-maest-30s-pw-73e-ts-swa.ckpt",
        400, 1875,
    ),
    "discogs-maest-30s-pw-129e-519l": ArchSpec(
        "discogs-maest-30s-pw-129e-519l",
        f"{_REL}/discogs-maest-30s-pw-129e-519l-swa.ckpt",
        519, 1875,
    ),
}


def list_architectures() -> list[str]:
    return sorted(ARCHS)


def cache_dir() -> Path:
    return Path(os.environ.get("MAEST_TPU_CACHE",
                               Path.home() / ".cache" / "maest_tpu"))


def cached_checkpoint_path(spec: ArchSpec) -> Path:
    return cache_dir() / spec.url.rsplit("/", 1)[-1]


def build_config(
    arch: str,
    *,
    n_classes: int | None = None,
    in_channels: int = 1,
    stride_f: int = 10,
    stride_t: int = 10,
    input_f: int = 96,
    input_t: int | None = None,
    u_patchout: int = 0,
    s_patchout_t: int = 0,
    s_patchout_f: int = 0,
    s_patchout_f_indices: tuple = (),
    s_patchout_f_interleaved: int = 0,
    s_patchout_t_indices: tuple = (),
    s_patchout_t_interleaved: int = 0,
    distilled_type: str = "mean",
    drop_rate: float = 0.0,
    attn_drop_rate: float = 0.0,
    drop_path_rate: float = 0.0,
    embed_dim: int = 768,
    depth: int = 12,
    num_heads: int = 12,
    remat: bool = False,
    remat_policy: str = "full",
    attention_quant: str = "none",
    attention_bwd_quant: str = "none",
) -> MAESTConfig:
    """Build the model config for an arch string (reference: models/maest.py:1467-1548).

    ``embed_dim``/``depth``/``num_heads`` default to the ViT-Base constants
    shared by every shipped arch (reference: models/maest.py:1203); ``depth``
    overrides cover the reference's ``lighten_model`` block removal
    (reference: models/maest.py:1403-1438) and small test configs.
    """
    if arch not in ARCHS:
        raise NotImplementedError(f"model {arch} not implemented")
    # fail at build time, not at trace time deep inside a train step
    if attention_quant not in ("none", "qk8", "qk8pv8", "fp8", "fp8pv8"):
        raise ValueError(
            f"unknown attention_quant {attention_quant!r}; expected 'none', "
            "'qk8', 'qk8pv8', 'fp8' or 'fp8pv8'")
    if remat_policy not in ("full", "dots", "attn_out"):
        raise ValueError(
            f"unknown remat_policy {remat_policy!r}; expected 'full', "
            "'dots' or 'attn_out'")
    if attention_bwd_quant not in ("none", "int8"):
        raise ValueError(
            f"unknown attention_bwd_quant {attention_bwd_quant!r}; "
            "expected 'none' or 'int8'")
    spec = ARCHS[arch]
    if input_t is None:
        input_t = spec.default_input_t
    if arch == "discogs-maest-30s-pw-129e-519l":
        n_classes = 519  # forced (reference: models/maest.py:1377-1379)
    if n_classes is None:
        n_classes = spec.num_classes if spec.kind == "maest" else 400
    return MAESTConfig(
        img_size=(input_f, input_t),
        patch_size=16,
        stride=(stride_f, stride_t),
        in_chans=in_channels,
        embed_dim=embed_dim,
        depth=depth,
        num_heads=num_heads,
        num_classes=n_classes,
        distilled=True,
        distilled_type=distilled_type,
        u_patchout=u_patchout,
        s_patchout_t=s_patchout_t,
        s_patchout_f=s_patchout_f,
        s_patchout_f_indices=tuple(s_patchout_f_indices),
        s_patchout_f_interleaved=s_patchout_f_interleaved,
        s_patchout_t_indices=tuple(s_patchout_t_indices),
        s_patchout_t_interleaved=s_patchout_t_interleaved,
        drop_rate=drop_rate,
        attn_drop_rate=attn_drop_rate,
        drop_path_rate=drop_path_rate,
        remat=remat,
        remat_policy=remat_policy,
        attention_quant=attention_quant,
        attention_bwd_quant=attention_bwd_quant,
    )
