"""The port at full width (ViT-B, fp32 on the CPU) against the goldens of
``tests/torch_goldens.py``: the 5 s, 10 s and 20 s geometries, the
519-label head, and the 30 s per-frequency and non-distilled models, each
within 5e-4 of the JAX package's logits (the bound of
tests/test_torch_parity_full.py); where the torch oracle computes the
model, the golden's JAX and oracle logits agree within 1e-3 in sigmoid.

The goldens are made by this file, with JAX and tests/torch_oracle.py on
the CPU (scripts/make_golden_logits.py is fixed to the 30 s model):

    JAX_PLATFORMS=cpu python tests/test_torch_goldens.py --make-golden
"""

import sys
from pathlib import Path

if __name__ == "__main__":  # run as a script: the packages of this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np
import pytest
import torch

from torch_goldens import GOLDENS, golden_case, golden_path

GOLDEN_TOL = 5e-4


def _sigmoid_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(1 / (1 + np.exp(-a)) - 1 / (1 + np.exp(-b))).max())


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_port_matches_golden(name):
    from maest_tpu_torch.checkpoints import load_into
    from maest_tpu_torch.models.vit import MAESTNet

    golden = np.load(golden_path(name))
    assert int(golden["seed"]) == GOLDENS[name][2]
    cfg, sd, x = golden_case(name)
    net = load_into(MAESTNet(cfg), sd).eval()
    with torch.inference_mode():
        logits = net(torch.from_numpy(x))[0].numpy()
    assert logits.shape == golden["logits"].shape == (2, cfg.num_classes)
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, golden["logits"], atol=GOLDEN_TOL)
    if "torch_logits" in golden.files:
        assert _sigmoid_gap(golden["logits"], golden["torch_logits"]) < 1e-3


def make_goldens(names):
    """JAX's fp32 logits (exact gelu, XLA attention: the oracle tier) of
    each golden's state and input, and the torch oracle's where it computes
    the model (a distilled model with the shared conv)."""
    import jax
    import jax.numpy as jnp

    from maest_tpu.checkpoints import merge_params, torch_to_jax_params
    from maest_tpu.models.registry import build_config
    from maest_tpu.models.vit import MAESTNet, init_params
    from torch_oracle import torch_forward

    for name in names:
        arch, kind, seed = GOLDENS[name]
        cfg, sd, x = golden_case(name)
        jcfg = build_config(arch).replace(
            distilled=cfg.distilled,
            per_freq_patch_embed=cfg.per_freq_patch_embed)
        state = {k: v.numpy() for k, v in sd.items()}
        if kind == "per_freq":  # the rows as they are, not the conv expanded
            conv = {k: v for k, v in state.items()
                    if not k.startswith("patch_embed.freq_")}
            conv["patch_embed.proj.weight"] = np.zeros(
                (cfg.embed_dim, 1, cfg.patch_size, cfg.patch_size), "f4")
            conv["patch_embed.proj.bias"] = np.zeros(cfg.embed_dim, "f4")
            loaded = torch_to_jax_params(conv, jcfg)
            loaded["patch_embed_freq_kernel"] = state["patch_embed.freq_kernel"]
            loaded["patch_embed_freq_bias"] = state["patch_embed.freq_bias"]
        else:
            loaded = torch_to_jax_params(state, jcfg)
        params = merge_params(init_params(jcfg, jax.random.PRNGKey(0)), loaded)
        assert set(params) <= set(loaded), name  # every weight loaded
        xh = jnp.asarray(x).transpose(0, 2, 3, 1)
        net = MAESTNet(jcfg)
        logits = np.asarray(jax.jit(
            lambda p, x: net.apply({"params": p}, x, train=False)[0])(
                params, xh), np.float32)
        out = {"seed": np.int64(seed), "logits": logits}
        line = f"{name}: logits {logits.shape}"
        if kind == "shared":
            ref = torch_forward(sd, x, cfg).astype(np.float32)
            out["torch_logits"] = ref
            line += f", oracle sigmoid gap {_sigmoid_gap(logits, ref):.3e}"
        golden_path(name).parent.mkdir(exist_ok=True)
        np.savez_compressed(golden_path(name), **out)
        print(f"wrote {golden_path(name)}: {line}", flush=True)


if __name__ == "__main__":
    if "--make-golden" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_goldens.py "
                 "--make-golden [name ...]")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    make_goldens([a for a in sys.argv[1:] if a in GOLDENS] or sorted(GOLDENS))
