"""The PyTorch port imports no JAX and nothing of the JAX package: it keeps
its own copies of the framework-free tables and helpers (architectures,
labels, mel filterbank, model configuration, experiment presets,
checkpoint helpers), held here equal to the originals."""

import ast
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np

import maest_tpu_torch
from maest_tpu import labels as jax_labels
from maest_tpu.dsp import filterbank as jax_fb
from maest_tpu.models import registry as jax_registry
from maest_tpu_torch.dsp import filterbank as torch_fb

ROOT = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    code = ("import sys, maest_tpu_torch, maest_tpu_torch.serve, "
            "maest_tpu_torch.apps.serve, maest_tpu_torch.train, "
            "maest_tpu_torch.configs, maest_tpu_torch.ops.augment; "
            "print(sorted(m for m in ('jax', 'jaxlib', 'flax', 'optax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_package_data_ships_every_cuda_source_and_header():
    """An installed package builds its kernels from the files its package
    data lists: every .cu source and every file one of them includes. The
    build hashes the shared .cuh headers, so an include is one of them."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "maest_tpu_torch"]
    pkg = ROOT / "maest_tpu_torch"
    csrc = pkg / "csrc"
    shipped = {p for g in globs for p in pkg.glob(g)}
    sources = sorted(csrc.glob("*.cu"))
    assert sources and set(sources) <= shipped
    headers = set(csrc.glob("*.cuh"))
    for src in sources:
        for inc in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M):
            assert csrc / inc in shipped, (src.name, inc)
            assert csrc / inc in headers, (src.name, inc)


def test_archs_match():
    assert set(maest_tpu_torch.ARCHS) == set(jax_registry.ARCHS)
    for name, spec in jax_registry.ARCHS.items():
        ours = maest_tpu_torch.ARCHS[name]
        assert (ours.url, ours.num_classes, ours.default_input_t, ours.kind) == (
            spec.url, spec.num_classes, spec.default_input_t, spec.kind)
    assert maest_tpu_torch.list_architectures() == jax_registry.list_architectures()
    cfg = maest_tpu_torch.build_config("discogs-maest-30s-pw-129e")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_registry.build_config("discogs-maest-30s-pw-129e"))
    assert cfg.img_size == (96, 1875) and cfg.num_classes == 400


def test_labels_match():
    for n in (400, 519):
        assert maest_tpu_torch.labels_for(n) == jax_labels.labels_for(n)
        assert len(maest_tpu_torch.labels_for(n)) == n
    assert maest_tpu_torch.labels_for(16) is None


def test_filterbank_matches():
    ours, ref = torch_fb.mel_filterbank(), jax_fb.mel_filterbank()
    assert ours.shape == (257, 96)
    np.testing.assert_array_equal(ours, ref)
    for a, b in zip(torch_fb.dft_matrices(512), jax_fb.dft_matrices(512)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(torch_fb.hann_window(512),
                                  jax_fb.hann_window(512))


def test_model_config_and_presets_match():
    from maest_tpu import configs as jax_configs
    from maest_tpu.models import config as jax_config
    from maest_tpu_torch import configs
    from maest_tpu_torch.models.config import MAESTConfig

    assert [(f.name, f.default) for f in dataclasses.fields(MAESTConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jax_config.MAESTConfig)]
    assert configs.PRESETS == jax_configs.PRESETS
    assert configs.default_config() == jax_configs.default_config()
    for presets, over in (
            ((), ()),
            (("maest_30s_from_passt_pretrain",), ("maest.pretrained=False",)),
            (("maest_10s_from_passt_pretrain",),
             ("maest.attention_bwd_quant=int8", "trainer.max_epochs=2",
              "module.optimizer.lr=0.0003")),
            (("maest_30s_from_passt_teacher_student_pretrain",), ())):
        assert configs.build_experiment_config(presets, over) == (
            jax_configs.build_experiment_config(presets, over))


def test_checkpoint_helpers_match(tmp_path):
    import torch

    from maest_tpu.checkpoints import convert as jax_convert
    from maest_tpu_torch.checkpoints import convert
    from maest_tpu_torch.models.registry import build_config

    cfg = build_config("discogs-maest-10s-pw-129e")
    rng = np.random.default_rng(0)
    for state in (
            {"time_new_pos_embed": rng.standard_normal((1, 768, 1, 99)),
             "freq_new_pos_embed": rng.standard_normal((1, 768, 12, 1)),
             "cls_token": rng.standard_normal((1, 1, 768))},
            {"pos_embed": rng.standard_normal((1, 2 + 14 * 14, 768))}):
        ours = convert.adapt_pos_embeds(dict(state), cfg)
        ref = jax_convert.adapt_pos_embeds(dict(state), cfg)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    state = {"net.a": 1, "net_swa.a": 2, "net.b": 3, "other": 4}
    for swa in (True, False):
        assert convert.strip_prefix(state, swa) == jax_convert.strip_prefix(
            state, swa)
    path = tmp_path / "w.pt"
    torch.save({"state_dict": {"net.w": torch.arange(6.0).view(2, 3)}}, path)
    ours, ref = (m.load_torch_checkpoint(str(path))
                 for m in (convert, jax_convert))
    assert list(ours) == list(ref) == ["net.w"]
    np.testing.assert_array_equal(ours["net.w"], ref["net.w"])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_runs_without_the_jax_package(tmp_path):
    """The port and chip_smoke.py name no module of the JAX package or of
    scripts/, and run from a directory that holds neither: every module
    imports, a tiny model tags a waveform and takes one train step (with
    the 8-bit modes on), and the decomposition rig runs."""
    files = [*(ROOT / "maest_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    for f in files:
        bad = [m for m in _imports(f)
               if m.split(".")[0] in ("maest_tpu", "scripts")]
        assert not bad, (f, bad)
    shutil.copytree(ROOT / "maest_tpu_torch", tmp_path / "maest_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    (tmp_path / "tests").mkdir()
    shutil.copy(ROOT / "tests" / "torch_oracle.py", tmp_path / "tests")
    code = """
import importlib, importlib.util, pkgutil, sys
assert importlib.util.find_spec("maest_tpu") is None
import maest_tpu_torch
for m in pkgutil.walk_packages(maest_tpu_torch.__path__, "maest_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
sys.path.insert(0, "tests")
import torch_oracle
import numpy as np, torch
from maest_tpu_torch import get_maest
from maest_tpu_torch.train import (AugmentConfig, TrainState, make_optimizer,
                                   make_train_step)
m = get_maest(pretrained=False, device="cpu", embed_dim=128, depth=2,
              num_heads=2, input_t=62, n_classes=16)
acts, labels = m.predict_labels(np.random.default_rng(0).standard_normal(
    32000).astype("f4") * 0.1)
assert acts.shape == (16,) and np.isfinite(acts).all()
net = get_maest(pretrained=False, device="cpu", embed_dim=128, depth=2,
                num_heads=2, input_t=62, n_classes=16, attention_quant="qk8",
                attention_bwd_quant="int8").net
tx = make_optimizer(lr_schedule=1e-4)
state = TrainState.create(net, tx, with_swa=False)
rng = np.random.default_rng(1)
batch = {"x": rng.standard_normal((2, 96, 62)).astype("f4"),
         "y": (rng.random((2, 16)) < 0.3).astype("f4")}
state, metrics = make_train_step(net, tx, AugmentConfig(
    masking=False, mixup_alpha=0.0))(state, batch)
assert np.isfinite(metrics["train_loss"]) and state.step == 1
from maest_tpu_torch.probes import attn_profile
times = attn_profile.main(["--device", "cpu", "--batch", "1", "--heads", "1",
                           "--shapes", "64", "--iters", "1"])
assert set(times["64"]) == set(attn_profile.DEFAULT_VARIANTS.split(","))
assert not any(n.startswith("maest_tpu.") or n == "maest_tpu"
               for n in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
