"""The port's Trainer across 2 real processes (gloo on the CPU) against its
one process, through the experiment CLI's launcher: ``ex_maest.run`` with
``trainer.devices=2`` spawns the ranks and joins them (``ex_maest.launch``,
called here with a timeout that kills the ranks).

The corpus and the model are ``tests/test_torch_trainer.py``'s (embed 64,
depth 2, 4 heads, ``clip_length=3``, files of at most one clip, so every
train crop starts at 0), 2 epochs of 2 steps, SWA from epoch 1, fp32,
with SpecAugment and mixup on: the draws are the global batch's on every
layout. The one-process run takes batch 4; data parallelism (dp) and FSDP
take 2 a rank, tensor with sequence parallelism (tp+sp, 2 model ranks,
1 data rank) 4, so each step's global batch is the one process's, row for
row.

Tolerances: per-step losses rtol 1e-5; val metrics (live and SWA) rtol
1e-4; parameters rtol 1e-4, atol 2e-6, the key bias within 2 lr a step
(``tests/test_torch_train.py``); extracted embeddings rtol 1e-4, atol
5e-5. A checkpoint restores across layouts exactly.
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from maest_tpu_torch import configs
from maest_tpu_torch.apps import ex_maest as cli
from maest_tpu_torch.train import Trainer
from maest_tpu_torch.train.loop import read_checkpoint, state_snapshot

TOL = dict(rtol=1e-4, atol=2e-6)
TIMEOUT = 240.0
OUT_TOL = dict(rtol=1e-4, atol=5e-5)
LR = 1e-3
MODES = {
    "dp": ["datamodule.batch_size_train=2", "trainer.devices=2"],
    "fsdp": ["datamodule.batch_size_train=2", "trainer.devices=2",
             "trainer.fsdp=True"],
    "tp+sp": ["datamodule.batch_size_train=4", "trainer.devices=2",
              "trainer.model_parallel=2", "trainer.sequence_parallel=True"],
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def make_corpus(root: Path) -> Path:
    """``tests/test_torch_trainer.py``'s corpus: 12 .mmap files of 120-187
    frames, 8 classes; 8 give one exhaustive window."""
    rng = np.random.default_rng(0)
    gt = {}
    for i in range(12):
        name = f"clip{i}.mmap"
        frames = (120, 150, 171, 180, 187, 187)[i % 6]
        (rng.standard_normal((frames, 96)) * 1.3 + 2.0).astype(
            "float16").tofile(root / name)
        y = (rng.random(8) > 0.6).astype("float16")
        y[i % 8] = 1.0
        gt[name] = y
    for split in ("train", "val", "test"):
        with open(root / f"gt_{split}.pk", "wb") as f:
            pickle.dump(gt, f)
    return root


def overrides(corpus, out, extra=()):
    return [
        f"datamodule.base_dir={corpus}",
        *(f"datamodule.groundtruth_{s}={corpus}/gt_{s}.pk"
          for s in ("train", "val", "test")),
        f"datamodule.groundtruth_predict={corpus}/gt_val.pk",
        "datamodule.clip_length=3",
        "datamodule.batch_size_test=3",
        "datamodule.num_workers=2",
        "datamodule.sampler.epoch_len=8",
        "datamodule.masking.time_mask_param=4",
        "datamodule.masking.freq_mask_param=3",
        "maest.n_classes=8",
        "maest.input_t=187",
        "maest.embed_dim=64",
        "maest.depth=2",
        "maest.num_heads=4",
        "maest.s_patchout_t=0",
        f"module.optimizer.lr={LR}",
        "module.optimizer.warm_up_len=1",
        "module.swa_epoch_start=1",
        "trainer.max_epochs=2",
        "trainer.precision=fp32",
        "trainer.limit_val_batches=2",
        "trainer.log_every_n_steps=1",
        f"trainer.default_root_dir={out}/exp_logs",
        f"predict.out_dir={out}/exp_out",
        "predict.transformer_block=1",
        *extra,
    ]


def _launch(argv):
    """What ``cli.run(argv, device="cpu")`` does for ``trainer.devices=2``
    (``test_run_launches_the_ranks_devices_asks_for``), with a timeout."""
    return cli.launch(argv, 2, "cpu", timeout=TIMEOUT)


def test_run_launches_the_ranks_devices_asks_for(corpus, tmp_path,
                                                 monkeypatch):
    """``run`` spawns ``trainer.devices`` ranks unless torchrun's
    variables say this process is one of them; the card's launcher
    refuses more ranks than cards."""
    calls = []
    monkeypatch.setattr(cli, "launch",
                        lambda argv, n, device: calls.append((n, device)))
    argv = ["main", "with", *overrides(corpus, tmp_path, MODES["dp"])]
    cli.run(argv, device="cpu")
    assert calls == [(2, "cpu")]
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.launch(argv, 2, "cuda")
    elif torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="cards are visible"):
            cli.launch(argv, 4, "cuda")


def _run_dir(out):
    (run,) = sorted((Path(out) / "exp_logs").iterdir())
    return run


def _metrics(out):
    lines = (_run_dir(out) / "metrics.jsonl").read_text().splitlines()
    return {(m["name"], m["step"]): m["value"] for m in map(json.loads, lines)}


def _params(out, tag):
    return read_checkpoint(_run_dir(out) / "checkpoints" / tag)["params"]


def _assert_params(ours, ref, lr_sum):
    e = 64
    assert set(ours) == set(ref)
    for k, v in ref.items():
        a, b = ours[k].numpy(), v.numpy()
        if k.endswith("attn.qkv.bias"):
            np.testing.assert_allclose(a[e:2 * e], b[e:2 * e], rtol=0,
                                       atol=2 * lr_sum, err_msg=k)
            a, b = np.delete(a, np.s_[e:2 * e]), np.delete(b, np.s_[e:2 * e])
        np.testing.assert_allclose(a, b, err_msg=k, **TOL)


@pytest.fixture(scope="module")
def one(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("one")
    res = cli.run(["main", "with", *overrides(
        corpus, out, ["datamodule.batch_size_train=4", "trainer.devices=1"])],
        device="cpu")
    assert res == {"done": True}
    return out


@pytest.fixture(scope="module")
def ranked(corpus, tmp_path_factory):
    """mode -> the output directory of its 2-rank ``main`` run (each run
    spawned once, on first use)."""
    runs = {}

    def get(mode):
        if mode not in runs:
            out = tmp_path_factory.mktemp(mode.replace("+", "_"))
            res = _launch(["main", "with", *overrides(corpus, out,
                                                      MODES[mode])])
            assert res == {"done": True}
            runs[mode] = out
        return runs[mode]

    return get


@pytest.mark.parametrize("mode", list(MODES))
def test_two_rank_fit_matches_one_process(one, ranked, mode):
    """Losses, val metrics (live and SWA), checkpoints and the final
    parameters of the 2-rank run against the one process's; rank 0's
    records only."""
    out = ranked(mode)
    ours, ref = _metrics(out), _metrics(one)
    assert sorted(ours) == sorted(ref)
    steps = sorted(s for n, s in ref if n == "train_loss")
    assert steps == [1, 2, 3, 4]
    np.testing.assert_allclose([ours["train_loss", s] for s in steps],
                               [ref["train_loss", s] for s in steps],
                               rtol=1e-5)
    val = [k for k in ref if k[0].startswith("val_")]
    assert {n for n, _ in val} == {f"val_{m}{s}" for m in ("loss", "ap", "roc")
                                   for s in ("", "_swa")}
    for k in val:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=str(k))
    names = sorted(p.name for p in (_run_dir(out) / "checkpoints").iterdir())
    assert names == sorted(p.name for p in
                           (_run_dir(one) / "checkpoints").iterdir())
    lr_sum = 4 * LR
    _assert_params(_params(out, "epoch-1"), _params(one, "epoch-1"), lr_sum)
    run = _run_dir(out)
    assert json.loads((run / "run.json").read_text())["status"] == "COMPLETED"
    assert len((run / "metrics.jsonl").read_text().splitlines()) == len(ref)


def test_predict_partitions_files_over_ranks(one, corpus, tmp_path):
    """``extract_embeddings`` over 2 ranks: each rank writes its files, the
    set and the values are the one process's."""
    best = f"ckpt_path={_run_dir(one) / 'checkpoints' / 'best'}"
    ref = cli.run(["extract_embeddings", "with", *overrides(
        corpus, tmp_path / "one", [best, "trainer.devices=1"])], device="cpu")
    ours = _launch(["extract_embeddings", "with", *overrides(
        corpus, tmp_path / "two", [best, "trainer.devices=2"])])
    assert ours["n_files"] == ref["n_files"] == 8
    files = sorted(p.name for p in Path(ref["out_dir"]).glob("*.npy"))
    assert sorted(p.name for p in Path(ours["out_dir"]).glob("*.npy")) == files
    for f in files:
        np.testing.assert_allclose(np.load(Path(ours["out_dir"]) / f),
                                   np.load(Path(ref["out_dir"]) / f),
                                   err_msg=f, **OUT_TOL)


@pytest.mark.parametrize("mode", ["dp", "tp+sp"])
def test_two_rank_checkpoint_restores_in_one_process(ranked, corpus, mode,
                                                     tmp_path):
    """A checkpoint written by 2 ranks (gathered whole by rank 0) loads
    into a one-process Trainer exactly: every parameter, moment and SWA
    tensor, and the counters."""
    path = _run_dir(ranked(mode)) / "checkpoints" / "epoch-1"
    cfg = configs.build_experiment_config([], overrides(
        corpus, tmp_path, ["datamodule.batch_size_train=4",
                           "trainer.devices=1"]))
    trainer = Trainer(cfg, device="cpu")
    trainer.restore_checkpoint(str(path))
    assert trainer.epoch == 2
    snap, ref = state_snapshot(trainer.state), read_checkpoint(path)
    assert snap["step"] == ref["step"] == 4 and snap["swa_n"] == 1
    for group in ("params", "swa_params"):
        for k, v in ref[group].items():
            assert torch.equal(snap[group][k], v), (group, k)
    for m in ("mu", "nu"):
        for k, v in ref["opt_state"][m].items():
            assert torch.equal(snap["opt_state"][m][k], v), (m, k)


@pytest.mark.parametrize("start", ["one", "dp"])
def test_two_rank_resume(one, ranked, corpus, tmp_path, start):
    """2 ranks resume epoch 1 from epoch-0, of their own run or of the one
    process's: the 2-rank run's epoch-1 parameters (bit for bit when the
    checkpoint is its own) and the one process's (within tolerance)."""
    src = one if start == "one" else ranked("dp")
    ckpt = _run_dir(src) / "checkpoints" / "epoch-0"
    out = tmp_path / "resumed"
    res = _launch(["main", "with", *overrides(
        corpus, out, [*MODES["dp"], f"ckpt_path={ckpt}"])])
    assert res == {"done": True}
    ours = _params(out, "epoch-1")
    assert not (_run_dir(out) / "checkpoints" / "epoch-0").exists()
    if start == "dp":
        for k, v in _params(src, "epoch-1").items():
            assert torch.equal(ours[k], v), k
    _assert_params(ours, _params(one, "epoch-1"), 4 * LR)
    resumed = {k: v for k, v in _metrics(out).items() if k[1] == 1
               and k[0].startswith("val_")}
    ref = _metrics(one)
    for k, v in resumed.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-4, err_msg=str(k))
