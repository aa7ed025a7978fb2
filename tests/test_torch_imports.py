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
            "maest_tpu_torch.configs, maest_tpu_torch.ops.augment, "
            "maest_tpu_torch.ops.attention_vpu, "
            "maest_tpu_torch.probes.attn_profile, "
            "maest_tpu_torch.probes.attn_vpu, "
            "maest_tpu_torch.probes.qpad, maest_tpu_torch.probes.attn_tune, "
            "maest_tpu_torch.ops.mma_probe, maest_tpu_torch.probes.mxu, "
            "maest_tpu_torch.probes.fp8_mlp, maest_tpu_torch.ops.int8_probe, "
            "maest_tpu_torch.probes.int8, maest_tpu_torch.probes.int8_2, "
            "maest_tpu_torch.ops.bwd_probe, maest_tpu_torch.probes.bwd_int8, "
            "maest_tpu_torch.data, maest_tpu_torch.native, "
            "maest_tpu_torch.utils, maest_tpu_torch.utils.run_record, "
            "maest_tpu_torch.train.loop, maest_tpu_torch.train.resilience, "
            "maest_tpu_torch.apps.ex_maest, maest_tpu_torch.parallel, "
            "maest_tpu_torch.parallel.mesh, "
            "maest_tpu_torch.parallel.launch, "
            "maest_tpu_torch.parallel.pipeline, "
            "maest_tpu_torch.parallel.tensor_parallel, "
            "maest_tpu_torch.apps.tag, maest_tpu_torch.apps.extract_mel, "
            "maest_tpu_torch.checkpoints.fetch, "
            "maest_tpu_torch.packaging.hf_ast, "
            "maest_tpu_torch.packaging.onnx_export, "
            "maest_tpu_torch.models.surgery, "
            "maest_tpu_torch.apps.export_release, maest_tpu_torch.apps.ex_tl, "
            "maest_tpu_torch.apps.mtt_prepare; "
            "print(sorted(m for m in ('jax', 'jaxlib', 'flax', 'optax', "
            "'orbax', 'sklearn', 'tensorboardX') if m in sys.modules))")
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


# the lines of native/__init__.py that differ from the JAX package's: the
# library builds into the checkout's build/ directory
NATIVE_BUILD_DIR_LINES = (
    {"Builds ``libmel_loader.so`` on first use (g++, cached next to the source or",
     "under ``$MAEST_TPU_CACHE``) and exposes a threaded batch loader. Falls back",
     '    d = os.environ.get("MAEST_TPU_CACHE")',
     '    base = Path(d) if d else Path.home() / ".cache" / "maest_tpu"',
     '    out = base / "native"'},
    {"Builds ``libmel_loader.so`` on first use (g++, cached in the checkout's",
     "``build/maest_tpu_torch/native/``) and exposes a threaded loader. Falls back",
     "    root = Path(__file__).resolve().parents[2]",
     '    out = root / "build" / "maest_tpu_torch" / "native"'},
)


def _changed_lines(ref: Path, ours: Path) -> tuple[set, set]:
    import difflib

    diff = list(difflib.ndiff(ref.read_text().splitlines(),
                              ours.read_text().splitlines()))
    return ({d[2:] for d in diff if d.startswith("- ")},
            {d[2:] for d in diff if d.startswith("+ ")})


def test_copied_data_pipeline_matches_the_originals():
    """The framework-free files of the data pipeline and the run records
    are copies: byte for byte, apart from the native library's build
    directory; ``BatchLoader`` and its collate are the JAX package's."""
    for ref, ours in (("data/dataset.py", "data/dataset.py"),
                      ("data/sampler.py", "data/sampler.py"),
                      ("native/mel_loader.cpp", "native/mel_loader.cpp"),
                      ("utils/run_record.py", "utils/run_record.py")):
        assert (ROOT / "maest_tpu_torch" / ours).read_bytes() == (
            ROOT / "maest_tpu" / ref).read_bytes(), ours
    assert _changed_lines(ROOT / "maest_tpu/native/__init__.py",
                          ROOT / "maest_tpu_torch/native/__init__.py"
                          ) == NATIVE_BUILD_DIR_LINES

    def defs(path):
        text = path.read_text()
        return {n.name: ast.get_source_segment(text, n)
                for n in ast.parse(text).body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))}

    ref = defs(ROOT / "maest_tpu/data/loader.py")
    ours = defs(ROOT / "maest_tpu_torch/data/loader.py")
    assert set(ours) == set(ref)
    for name in ("_collate", "BatchLoader"):
        assert ours[name] == ref[name], name


def _top_level_imports(tree):
    """Modules imported when a module is imported: its body's imports,
    those inside top-level ``try``/``if`` blocks included."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, (ast.Try, ast.If)):
            stack += node.body + node.orelse + getattr(node, "finalbody", [])
            stack += [s for h in getattr(node, "handlers", []) for s in h.body]


# the module save_pretrained ships beside exported weights; the package
# never imports it (it needs transformers)
SHIPPED = ROOT / "maest_tpu_torch" / "packaging" / "feature_extraction_maest.py"


def test_no_optional_trainer_dependency_at_top_level():
    """sklearn, orbax and tensorboardX are absent where the port runs, and
    transformers, onnx and safetensors may be: no module imports them
    when it is imported (tensorboardX is tried inside ``Trainer.tb`` only;
    metrics are numpy; checkpoints ``torch.save``; safetensors inside the
    loaders and ``save_pretrained``; the ONNX export needs no onnx), save
    the shipped ``feature_extraction_maest.py``."""
    optional = ("sklearn", "orbax", "tensorboardX", "transformers", "onnx",
                "safetensors")
    for f in (ROOT / "maest_tpu_torch").rglob("*.py"):
        bad = [m for m in _top_level_imports(ast.parse(f.read_text()))
               if m.split(".")[0] in optional]
        assert not bad or f == SHIPPED, (f, bad)
    assert "transformers" in {m.split(".")[0] for m in _top_level_imports(
        ast.parse(SHIPPED.read_text()))}
    for f in (ROOT / "maest_tpu_torch").rglob("*.py"):
        bad = [m for m in _imports(f) if m.split(".")[0] in ("sklearn", "orbax")]
        assert not bad, (f, bad)


def test_tune_rig_lengths_match():
    """probes/attn_tune.py's copy of the rig's ARCH_N, read from
    scripts/attn_tune.py without importing it (the rig imports jax)."""
    from maest_tpu_torch.probes import attn_tune

    tree = ast.parse((ROOT / "scripts" / "attn_tune.py").read_text())
    (rig,) = [ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign)
              and [getattr(t, "id", None) for t in node.targets] == ["ARCH_N"]]
    assert attn_tune.ARCH_N == rig


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
    the 8-bit modes on), the tagging CLI tags a wav from an HF AST layout
    checkpoint, and every rig runs (gh<G> and int8 too, the
    backward rig's 8-bit kinds; the product rigs' fp8_mlp at its full
    shapes only on the card); ``ex_maest main`` trains a tiny model for
    two epochs with sklearn, orbax and tensorboardX made unimportable."""
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
for absent in ("sklearn", "orbax", "tensorboardX", "transformers", "onnx",
               "safetensors"):  # as where the port runs
    sys.modules[absent] = None
import maest_tpu_torch
for m in pkgutil.walk_packages(maest_tpu_torch.__path__, "maest_tpu_torch."):
    if not m.name.endswith(".feature_extraction_maest"):  # shipped, not used
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
times = attn_profile.main(["--device", "cpu", "--batch", "2", "--heads", "2",
                           "--shapes", "64", "--iters", "1", "--variants",
                           "gh4,int8"])
assert set(times["64"]) == {"gh4", "int8"}
from maest_tpu_torch.probes import attn_vpu
vpu = attn_vpu.main(["--device", "cpu", "--batch", "1", "--tokens", "64",
                     "--heads", "1", "--iters", "1", "--rounds", "1"])
assert set(vpu) == set(attn_vpu.ALL)
from maest_tpu_torch.probes import attn_tune, qpad
assert set(qpad.main(["--device", "cpu", "--shapes", "1x24", "--iters",
                      "1"])) == {"1x24"}
for extra in ([], ["--bwd"]):
    tune = attn_tune.main(["--device", "cpu", "--archs", "5s", "--batch", "1",
                           "--heads", "1", "--iters", "1", *extra])
    assert len(tune["5s"]) == 10
from maest_tpu_torch.probes import fp8_mlp, mxu
assert set(mxu.main(["--device", "cpu", "--programs", "1", "--iters", "1",
                     "--kinds", "k64w,pvwide"])) == {"k64w", "pvwide"}
assert fp8_mlp.SHAPES["fc1"] == ((1792, 768), (768, 3072))
from maest_tpu_torch.probes import bwd_int8
assert set(bwd_int8.main(["--device", "cpu", "--iters", "1", "--rounds", "1",
                          "--kinds", "int8,fp8"])) == {"int8", "fp8"}
import json, pathlib, pickle
from maest_tpu_torch import native
from maest_tpu_torch.apps import ex_maest
root = pathlib.Path("corpus")
root.mkdir()
gt = {}
for i in range(6):
    (rng.standard_normal((50 + 10 * i, 96)) + 2.0).astype("float16").tofile(
        root / f"c{i}.mmap")
    gt[f"c{i}.mmap"] = (np.arange(8) % 6 == i).astype("float16")
for split in ("train", "val"):
    pickle.dump(gt, open(root / f"gt_{split}.pk", "wb"))
ov = [f"datamodule.base_dir='{root}'",
      f"datamodule.groundtruth_train='{root}/gt_train.pk'",
      f"datamodule.groundtruth_val='{root}/gt_val.pk'",
      "datamodule.clip_length=1", "datamodule.batch_size_train=2",
      "datamodule.batch_size_test=3", "datamodule.sampler.epoch_len=4",
      "maest.input_t=62", "maest.embed_dim=64", "maest.depth=2",
      "maest.num_heads=4", "maest.n_classes=8", "maest.s_patchout_t=1",
      "trainer.max_epochs=2", "trainer.precision='fp32'",
      "module.swa_epoch_start=1", "trainer.default_root_dir='runs'"]
assert ex_maest.run(["main", "with", *ov], device="cpu") == {"done": True}
assert native.available()
(run,) = pathlib.Path("runs").iterdir()
assert json.loads((run / "run.json").read_text())["status"] == "COMPLETED"
assert not (run / "tb").exists()  # no tensorboardX: the null writer ran
from scipy.io import wavfile
from maest_tpu_torch.apps import tag
from maest_tpu_torch.packaging import to_hf_ast_state
wavfile.write("clip.wav", 44100, (rng.standard_normal(88200) * 0.2).astype("f4"))
sd = {k: v.numpy() for k, v in m.net.state_dict().items()}
torch.save({k: torch.from_numpy(v) for k, v in to_hf_ast_state(sd).items()},
           "ast.pt")
assert tag.main(["clip.wav", "--checkpoint", "ast.pt", "--device", "cpu",
                 "--json", "--embed-dim", "128", "--depth", "2",
                 "--num-heads", "2", "--input-t", "62"]) == 0
assert not any(n.startswith("maest_tpu.") or n == "maest_tpu"
               for n in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# modules of the JAX package with no counterpart in the port, by design
NO_COUNTERPART = {
    # the XLA persistent compilation cache
    "utils/cache.py",
    # Mosaic tile arithmetic (round_up to TPU tiles)
    "utils/shapes.py",
    # a TF SavedModel through jax2tf, which needs JAX
    "packaging/export.py",
}


def test_every_module_of_the_jax_package_has_a_counterpart():
    """The port has a module for every module of the JAX package, save
    the three that have none by design; the feature extractor it ships
    is the JAX package's, byte for byte."""
    def modules(pkg):
        root = ROOT / pkg
        return {str(p.relative_to(root)) for p in root.rglob("*.py")
                if "__pycache__" not in p.parts}

    missing = modules("maest_tpu") - modules("maest_tpu_torch")
    assert missing == NO_COUNTERPART
    assert SHIPPED.read_bytes() == (
        ROOT / "maest_tpu/packaging/feature_extraction_maest.py").read_bytes()
