"""The port's release apps against the JAX package's:
``apps/export_release.py`` on a port Trainer checkpoint (a tiny
``ex_maest main`` run on the CPU), ``apps/ex_tl.py`` (the schedulers'
learning rates step by step, ``postprocess_embedding``, the overrides and
the probe learning on a synthetic embeddings fixture, as
tests/test_ex_tl.py asks of the JAX probe) and ``apps/mtt_prepare.py`` on
local fixture zips and annotations (its pickles equal to the JAX
package's). No test downloads anything."""

import json
import pickle
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maest_tpu.apps import ex_tl as jax_tl
from maest_tpu.apps import mtt_prepare as jax_mtt
from maest_tpu.packaging import hf_ast as jax_hf
from maest_tpu_torch.apps import ex_tl, export_release, mtt_prepare

GEOM_KW = dict(n_classes=8, input_t=62, embed_dim=64, depth=2, num_heads=4)


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """A port Trainer run on the CPU: 2 epochs, SWA from epoch 0, so
    epoch-1's SWA weights (the mean of two epochs') differ from its live
    ones."""
    from maest_tpu_torch.apps import ex_maest

    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    gt = {}
    for i in range(8):
        name = f"clip{i}.mmap"
        rng.standard_normal((100, 96)).astype("float16").tofile(root / name)
        y = (rng.random(8) > 0.6).astype("float16")
        y[i % 8] = 1.0
        gt[name] = y
    for split in ("train", "val"):
        with open(root / f"gt_{split}.pk", "wb") as f:
            pickle.dump(gt, f)
    assert ex_maest.run([
        "main", "with", f"datamodule.base_dir={root}",
        f"datamodule.groundtruth_train={root}/gt_train.pk",
        f"datamodule.groundtruth_val={root}/gt_val.pk",
        "datamodule.clip_length=1", "datamodule.batch_size_train=2",
        "datamodule.batch_size_test=3", "datamodule.num_workers=0",
        "datamodule.sampler.epoch_len=8", "maest.n_classes=8",
        "maest.input_t=62", "maest.embed_dim=64", "maest.depth=2",
        "maest.num_heads=4", "maest.s_patchout_t=1",
        "trainer.max_epochs=2", "trainer.precision=fp32",
        "trainer.limit_val_batches=1", "module.swa_epoch_start=0",
        "module.optimizer.warm_up_len=1",
        f"trainer.default_root_dir={root}/exp_logs"], device="cpu") == {
            "done": True}
    (run,) = sorted((root / "exp_logs").iterdir())
    return run / "checkpoints" / "epoch-1"


def _net_of(params):
    from maest_tpu_torch.checkpoints import load_into
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet

    cfg = build_config("discogs-maest-30s-pw-129e", **GEOM_KW)
    return load_into(MAESTNet(cfg), params).eval()


def test_export_torch_roundtrips_through_get_maest(trained_ckpt, tmp_path):
    """The exported SWA weights load back through ``get_maest`` on the CPU
    and give the outputs of the checkpoint's SWA weights, bit for bit; the
    geometry comes from the run's config.json."""
    from maest_tpu_torch import get_maest

    out = tmp_path / "release.pt"
    assert export_release.main([str(trained_ckpt), "--format", "torch",
                                "--out", str(out), "--device", "cpu"]) == 0
    m = get_maest(pretrained=False, checkpoint=str(out), device="cpu",
                  **GEOM_KW)
    state = export_release.load_training_checkpoint(str(trained_ckpt))
    swa, which = export_release.select_params(state, swa=True)
    assert which == "swa" and "opt_state" not in state
    for k, v in m.net.state_dict().items():
        assert torch.equal(v, swa[k]), k
    x = np.random.default_rng(1).standard_normal((2, 96, 62)).astype("f4")
    with torch.inference_mode():
        ref = _net_of(swa)(torch.from_numpy(x)[:, None])[0]
    got = m(x)[0]
    assert got.shape == (2, 8) and torch.equal(got, ref)
    saved = torch.load(out)
    assert "head_dist.weight" not in saved and "head.1.weight" in saved


def test_export_raw_and_swa_prefix(trained_ckpt, tmp_path):
    state = export_release.load_training_checkpoint(str(trained_ckpt),
                                                    with_opt_state=True)
    assert {"params", "swa_params", "swa_n", "step", "opt_state"} <= set(state)
    raw, which = export_release.select_params(state, swa=False)
    swa, _ = export_release.select_params(state, swa=True)
    assert which == "raw"
    assert any(not torch.equal(raw[k], swa[k]) for k in raw)
    out = tmp_path / "raw.pt"
    export_release.main([str(trained_ckpt), "--no-swa", "--swa-prefix",
                         "--out", str(out), "--device", "cpu"])
    saved = torch.load(out)
    assert all(k.startswith("net_swa.") for k in saved)
    assert torch.equal(saved["net_swa.head.1.weight"], raw["head.1.weight"])
    # no SWA yet: the live weights, labelled so
    params, which = export_release.select_params(dict(state, swa_n=0),
                                                 swa=True)
    assert params is state["params"] and which.startswith("raw (swa unava")


def test_export_hf_and_onnx(trained_ckpt, tmp_path):
    """The hf directory equals the JAX package's ``save_pretrained`` of
    the same weights; the ONNX file has the deployment interface."""
    pytest.importorskip("safetensors")
    from maest_tpu.models.registry import build_config as jax_build
    from maest_tpu.checkpoints.convert import torch_to_jax_params

    out = tmp_path / "hf"
    assert export_release.main([str(trained_ckpt), "--format", "hf",
                                "--out", str(out), "--device", "cpu"]) == 0
    swa, _ = export_release.select_params(
        export_release.load_training_checkpoint(str(trained_ckpt)), swa=True)
    jcfg = jax_build("discogs-maest-30s-pw-129e", **GEOM_KW)
    ref = jax_hf.save_pretrained(torch_to_jax_params(
        {k: v.numpy() for k, v in swa.items()}, jcfg), jcfg,
        str(tmp_path / "ref"))
    for name in ("config.json", "preprocessor_config.json",
                 "model.safetensors", "feature_extraction_maest.py"):
        assert (out / name).read_bytes() == (tmp_path / "ref" /
                                             name).read_bytes(), name
    onnx = tmp_path / "m.onnx"
    assert export_release.main([str(trained_ckpt), "--format", "onnx",
                                "--out", str(onnx), "--device", "cpu"]) == 0
    from maest_tpu_torch.packaging import read_onnx_io

    io = read_onnx_io(str(onnx))
    assert io["inputs"] == ["melspectrogram"]
    assert io["outputs"] == ["logits", "activations", "layer_0_tokens",
                             "layer_1_tokens"]


def test_export_refusals_and_run_config(trained_ckpt, tmp_path):
    run_cfg = export_release.run_config_for(str(trained_ckpt))
    assert run_cfg["maest"]["embed_dim"] == 64
    assert export_release.run_config_for(str(tmp_path / "a" / "b")) is None
    with pytest.raises(SystemExit, match="jax2tf"):
        export_release.main([str(trained_ckpt), "--format", "tf", "--out",
                             str(tmp_path / "tf")])
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_release.main([str(trained_ckpt), "--out",
                                 str(tmp_path / "x.pt")])
    # a geometry that does not fit the checkpoint is refused
    with pytest.raises(ValueError):
        export_release.main([str(trained_ckpt), "--out", str(tmp_path / "y"),
                             "--device", "cpu", "--depth", "3"])
    assert not (tmp_path / "y").exists()


# -- ex_tl ----------------------------------------------------------------

def _opt(**over):
    opt = ex_tl.default_config()["optimizer"]
    opt.update(over)
    return opt


SCHEDULES = [
    ("exp_warmup_linear_down", {}, 7),
    ("exp_warmup_linear_down", dict(max_epochs=8, warmup_epochs=1,
                                    max_lr=1e-2, max_lr_epochs=2), 5),
    ("exponential", {}, 3),
    ("exponential", dict(gamma=0.9, warmup_epochs=4), 11),
    ("cyclic", {}, 1),
    ("cyclic", dict(base_lr=1e-5, max_lr=3e-3), 4),
]


@pytest.mark.parametrize("mode,over,spe", SCHEDULES)
def test_schedulers_match_jax_step_by_step(mode, over, spe):
    """Each step's learning rate, as the float32 optax passes on (optax's
    step count is int32)."""
    opt = _opt(scheduler=mode, **over)
    ours = ex_tl._make_scheduler(opt, spe)
    ref = jax_tl._make_scheduler(opt, spe)
    steps = range(0, 2 * 290 * 3 + 7) if mode == "cyclic" else range(
        (opt["max_epochs"] + 3) * spe)
    got = np.array([ours(s) for s in steps], np.float32)
    want = np.array([ref(jnp.int32(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 3


def test_unknown_scheduler():
    for mod in (ex_tl, jax_tl):
        with pytest.raises(ValueError, match="unknown scheduler"):
            mod._make_scheduler(_opt(scheduler="step"), 2)


EMB = np.arange(4 * 3 * 8, dtype="float32").reshape(4, 24) ** 1.5


@pytest.mark.parametrize("emb,types,reduce,token", [
    (EMB, "c", "mean", 8), (EMB, "cd", "stack", 8), (EMB, "cdt", "mean", 8),
    (EMB, "dt", "stack", 8), (EMB[0], "t", "mean", 8),
    (EMB[:, :8], "c", "mean", 8), (EMB, "c", "mean", 24)])
def test_postprocess_embedding_matches_jax(emb, types, reduce, token):
    np.testing.assert_array_equal(
        ex_tl.postprocess_embedding(emb, types, reduce, token),
        jax_tl.postprocess_embedding(emb, types, reduce, token))


def test_postprocess_embedding_refusals():
    for mod in (ex_tl, jax_tl):
        with pytest.raises(ValueError, match="neither token_size"):
            mod.postprocess_embedding(np.zeros((4, 16), "f4"), "c", "mean", 8)
        with pytest.raises(ValueError, match="unknown reduce"):
            mod.postprocess_embedding(EMB, "c", "max", 8)


@pytest.mark.parametrize("args", [
    ["with", "target_mtt_tl"], ["max_epochs=120"],
    ["max_epochs=120", "optimizer.max_epochs=80"],
    ["target_mtt_tl", "data.batch_size=16", "model.drop_out=0.1"]])
def test_apply_overrides_match_jax(args):
    assert ex_tl._apply_overrides(ex_tl.default_config(), args) == \
        jax_tl._apply_overrides(jax_tl.default_config(), args)
    assert ex_tl.default_config() == jax_tl.default_config()
    assert ex_tl.PRESETS == jax_tl.PRESETS


@pytest.fixture(scope="module")
def embedding_corpus(tmp_path_factory):
    """tests/test_ex_tl.py's fixture: two latent clusters, 6 classes."""
    root = tmp_path_factory.mktemp("tl")
    emb_dir = root / "emb"
    emb_dir.mkdir()
    rng = np.random.default_rng(0)
    n_classes, token = 6, 16
    protos = rng.standard_normal((2, 3 * token)).astype("float32") * 2
    gts = {"train": {}, "validation": {}, "test": {}}
    for split, n in [("train", 40), ("validation", 16), ("test", 16)]:
        for i in range(n):
            cls = i % 2
            name = f"{split}{i}.mp3"
            emb = protos[cls] + rng.standard_normal(
                (3, 3 * token)).astype("float32") * 0.3
            np.save(emb_dir / (name + ".embeddings.npy"), emb)
            y = np.zeros(n_classes, dtype="float32")
            y[cls::2] = 1.0
            gts[split][name] = y
    for split, gt in gts.items():
        with open(root / f"groundtruth-{split}.pk", "wb") as f:
            pickle.dump(gt, f)
    return root, emb_dir, n_classes, token


def _tl_cfg(root, emb_dir, n_classes, token):
    cfg = ex_tl.default_config()
    cfg["trainer"]["max_epochs"] = 8
    cfg["optimizer"].update(max_epochs=8, warmup_epochs=1, max_lr=1e-2,
                            max_lr_epochs=2)
    cfg["model"]["hidden_units"] = 32
    cfg["data"].update(base_dir=str(emb_dir), metadata_dir=str(root),
                       batch_size=8, types="c", reduce="mean",
                       token_size=token, n_classes=n_classes)
    return cfg


def test_tl_pipeline_learns(embedding_corpus):
    """As tests/test_ex_tl.py: test ROC above 0.9 on the separable task,
    the run's records, the same data as the JAX probe's."""
    root, emb_dir, n_classes, token = embedding_corpus
    cfg = _tl_cfg(root, emb_dir, n_classes, token)
    cfg["exp_dir"] = str(root / "exp_logs")
    res = ex_tl.tl_pipeline(cfg, device="cpu")
    assert res["test_roc"] > 0.9
    assert 0 <= res["test_ap"] <= 1
    run_dir = sorted((root / "exp_logs").iterdir())[-1]
    run_json = json.loads((run_dir / "run.json").read_text())
    assert run_json["status"] == "COMPLETED"
    assert run_json["result"]["test_roc"] == res["test_roc"]
    assert len((run_dir / "metrics.jsonl").read_text().splitlines()) == 8 * 3
    ds = ex_tl.EmbeddingDataset(root / "groundtruth-test.pk", emb_dir, "c",
                                "mean", token)
    ref = jax_tl.EmbeddingDataset(root / "groundtruth-test.pk", emb_dir, "c",
                                  "mean", token)
    for a, b in zip(ds.load_all(), ref.load_all()):
        np.testing.assert_array_equal(a, b)
    # the same seed gives the same run
    cfg["exp_dir"] = ""
    assert ex_tl.tl_pipeline(cfg, device="cpu") == ex_tl.tl_pipeline(
        cfg, device="cpu")


def test_tl_main_and_device(embedding_corpus, tmp_path, monkeypatch):
    root, emb_dir, n_classes, token = embedding_corpus
    monkeypatch.chdir(tmp_path)
    args = ["with", f"data.base_dir='{emb_dir}'",
            f"data.metadata_dir='{root}'", "max_epochs=2",
            "data.batch_size=8", f"data.token_size={token}",
            f"data.n_classes={n_classes}", "model.hidden_units=16"]
    res = ex_tl.main(args + ["--device", "cpu"])
    assert set(res) == {"val_roc", "test_ap", "test_roc"}
    (run,) = (tmp_path / "exp_logs").iterdir()  # the CLI records its runs
    assert json.loads((run / "config.json").read_text())["trainer"][
        "max_epochs"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex_tl.main(args)


# -- mtt_prepare ----------------------------------------------------------

TAGS = [f"tag{i}" for i in range(55)]


def _mtt_fixture(root, rng):
    """Three zip parts of one archive of wav clips under hex directories,
    and an annotations CSV over 55 tags (the top 50 kept)."""
    from scipy.io import wavfile

    clips = [f"{d}/clip_{d}{i}.wav" for d in "03cdf" for i in range(2)]
    stage = root / "stage"
    for c in clips:
        (stage / c).parent.mkdir(parents=True, exist_ok=True)
        wavfile.write(stage / c, 16000,
                      (rng.standard_normal(8000) * 0.1).astype("f4"))
    joined = root / "joined.zip"
    with zipfile.ZipFile(joined, "w") as zf:
        for c in clips:
            zf.write(stage / c, c)
    data = joined.read_bytes()
    third = len(data) // 3 + 1
    for i, name in enumerate(mtt_prepare.MTT_ZIPS):
        (root / name).write_bytes(data[i * third:(i + 1) * third])
    joined.unlink()
    rows = ["\t".join(["clip_id", *TAGS, "mp3_path"])]
    for j, c in enumerate(clips):
        flags = (rng.random(len(TAGS)) < 0.2).astype(int)
        if j == 3:
            flags[:] = 0  # a clip with no tag: left out of the pickles
        rows.append("\t".join([str(j), *map(str, flags), c]))
    (root / mtt_prepare.MTT_ANNOTATIONS).write_text("\n".join(rows) + "\n")
    return clips


@pytest.mark.parametrize("path,split", [("0/a.mp3", "train"),
                                        ("b/x.mp3", "train"),
                                        ("c/x.mp3", "validation"),
                                        ("D/x.mp3", "test"),
                                        ("f/y/z.mp3", "test")])
def test_split_of_matches_jax(path, split):
    assert mtt_prepare.split_of(path) == jax_mtt.split_of(path) == split


def test_mtt_steps_match_jax(tmp_path):
    """extract_zips, read_annotations and build_groundtruth on the same
    fixture: the same audio tree, rows and tags, and groundtruth pickles
    equal byte for byte (the binarizer's classes equal)."""
    import shutil

    clips = _mtt_fixture(tmp_path / "ours", np.random.default_rng(0))
    shutil.copytree(tmp_path / "ours", tmp_path / "ref")
    out = {}
    for name, mod in (("ours", mtt_prepare), ("ref", jax_mtt)):
        root = tmp_path / name
        audio = mod.extract_zips(root)
        assert sorted(str(p.relative_to(audio)) for p in audio.rglob(
            "*.wav")) == sorted(clips)
        rows, tags = mod.read_annotations(root / mod.MTT_ANNOTATIONS)
        mod.build_groundtruth(rows, tags, root / "gt")
        out[name] = (rows, tags)
    assert out["ours"] == out["ref"] and len(out["ours"][1]) == 50
    for split in ("train", "validation", "test", "all"):
        f = f"gt/groundtruth-{split}.pk"
        assert (tmp_path / "ours" / f).read_bytes() == (
            tmp_path / "ref" / f).read_bytes(), split
    ours = pickle.load(open(tmp_path / "ours" / "gt" / "ohe.pk", "rb"))
    ref = pickle.load(open(tmp_path / "ref" / "gt" / "ohe.pk", "rb"))
    assert ours.classes_ == ref.classes_
    rows_ = [["tag0", "tag3"], ["nope"]]
    np.testing.assert_array_equal(ours.transform(rows_), ref.transform(rows_))
    assert ours.inverse_transform(ours.transform(rows_)) == [
        tuple(sorted(set(rows_[0]) & set(ours.classes_),
                     key=ours.classes_.index)), ()]


def test_mtt_main_skip_download(tmp_path):
    """``main --skip-download`` decodes every clip to a mel ``.mmap``
    through the port's extract_mel (the JAX package's float16 file, bit
    for bit) and writes the pickles of the clips that have mels."""
    clips = _mtt_fixture(tmp_path / "ours", np.random.default_rng(1))
    mtt_prepare.main(["--root", str(tmp_path / "ours"), "--skip-download",
                      "--workers", "1"])
    root = tmp_path / "ours"
    mels = sorted(p.name for p in (root / "mels").iterdir())
    assert mels == sorted(c.split("/")[1].replace(".wav", ".mmap")
                          for c in clips)
    from maest_tpu.apps.extract_mel import melspectrogram_to_mmap
    from maest_tpu_torch.apps.extract_mel import load_audio

    ref = tmp_path / "ref.mmap"
    melspectrogram_to_mmap(load_audio(root / "audio" / clips[0]), ref)
    got = np.fromfile(root / "mels" / mels[0], np.float16)
    want = np.fromfile(ref, np.float16)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    gt = pickle.load(open(root / "groundtruth-all.pk", "rb"))
    assert len(gt) == len(clips) - 1  # the untagged clip is left out
