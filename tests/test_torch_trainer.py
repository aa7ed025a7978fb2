"""The port's Trainer and experiment CLI against the JAX package's, on the
CPU at a tiny geometry (embed 64, depth 2, 4 heads, ``clip_length=3``: 187
frames, 8 classes, batch 2, ``epoch_len`` 8, 2 epochs, fp32).

Both Trainers run on the same corpus and config with augmentation off
(masking off, mixup alpha 0, no patchout), so the only random draws left
are the sampler's (numpy, seeded the same in both) and the train crops.
The clip is 187 frames, not 62, because at 62 the time pos-embed table
(62 // 10 = 6 columns) is one longer than the patch grid ((62 - 16) // 10
+ 1 = 5), and a train forward then crops it at an offset each package
draws from its own generator; at 187 both are 18 columns.
The train crops come from an unseeded generator in both packages
(``data/dataset.py`` ``MelChunkDataset``), so every file of the corpus is
at most one clip long: its crop offset is 0 whatever is drawn. Crops of
longer files are held equal in ``tests/test_torch_data.py`` with an
explicit generator.

The port starts from the JAX Trainer's initial state, its class head drawn
(a zero head gives every logit 0 and the loss ln 2), carried across with
``train_state_from_jax`` and written by the port's checkpoint writer; the
port's run loads it through ``ckpt_path``.

Tolerances, as ``tests/test_torch_train.py``: per-step losses rtol 1e-5;
val metrics rtol 1e-4; parameters rtol 1e-4, atol 2e-6, the key bias
within 2 lr a step (Adam normalises its fp32 noise); extracted logits and
embeddings rtol 1e-4, atol 5e-5.
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu import configs as jax_configs
from maest_tpu.apps import ex_maest as jax_cli
from maest_tpu.train.loop import Trainer as JaxTrainer
from maest_tpu_torch import configs
from maest_tpu_torch.apps import ex_maest as cli
from maest_tpu_torch.checkpoints import state_from_jax_params, train_state_from_jax
from maest_tpu_torch.train import Trainer, make_optimizer, model_config
from maest_tpu_torch.train.loop import state_snapshot, write_checkpoint

N_FILES = 12
N_WINDOWED = 8  # the files of 171 frames or more
TOL = dict(rtol=1e-4, atol=2e-6)
OUT_TOL = dict(rtol=1e-4, atol=5e-5)
LR = 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 .mmap files of 120-187 frames (at most one 187-frame clip: the
    train crop is fixed); those of 171 frames or more give one exhaustive
    window, the others none (the exhaustive dataset drops them)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    gt = {}
    for i in range(N_FILES):
        name = f"clip{i}.mmap"
        frames = (120, 150, 171, 180, 187, 187)[i % 6]
        (rng.standard_normal((frames, 96)) * 1.3 + 2.0).astype(
            "float16").tofile(root / name)
        y = (rng.random(8) > 0.6).astype("float16")
        y[i % 8] = 1.0  # every class has support
        gt[name] = y
    for split in ("train", "val", "test"):
        with open(root / f"gt_{split}.pk", "wb") as f:
            pickle.dump(gt, f)
    return root


def overrides(corpus, out, extra=()):
    return [
        f"datamodule.base_dir={corpus}",
        f"datamodule.groundtruth_train={corpus}/gt_train.pk",
        f"datamodule.groundtruth_val={corpus}/gt_val.pk",
        f"datamodule.groundtruth_test={corpus}/gt_test.pk",
        f"datamodule.groundtruth_predict={corpus}/gt_val.pk",
        "datamodule.clip_length=3",
        "datamodule.batch_size_train=2",
        "datamodule.batch_size_test=3",
        "datamodule.num_workers=2",
        "datamodule.sampler.epoch_len=8",
        "datamodule.masking.do=False",
        "maest.n_classes=8",
        "maest.input_t=187",
        "maest.embed_dim=64",
        "maest.depth=2",
        "maest.num_heads=4",
        "maest.s_patchout_t=0",
        "module.mixup_alpha=0.0",
        f"module.optimizer.lr={LR}",
        "module.optimizer.warm_up_len=1",
        "module.swa_epoch_start=1",
        "trainer.max_epochs=2",
        "trainer.devices=1",
        "trainer.precision=fp32",
        "trainer.limit_val_batches=2",
        "trainer.log_every_n_steps=1",
        f"trainer.default_root_dir={out}/exp_logs",
        f"predict.out_dir={out}/exp_out",
        "predict.transformer_block=1",
        *extra,
    ]


def _metrics(run_dir):
    lines = [json.loads(s) for s in
             (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    return [(m["name"], m["step"], m["value"]) for m in lines]


def _run_dir(out):
    (run,) = sorted((Path(out) / "exp_logs").iterdir())
    return run


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The JAX Trainer's run and the port's from the same initial state."""
    jout = tmp_path_factory.mktemp("jax")
    jcfg = jax_configs.build_experiment_config([], overrides(corpus, jout))
    jt = JaxTrainer(jcfg, run_info={"command": "main"})
    rng = np.random.default_rng(1)
    params = dict(jt.state.params)
    head = dict(params["head_linear"])
    head["kernel"] = jnp.asarray(
        rng.standard_normal(head["kernel"].shape).astype("f4") * 0.05)
    params["head_linear"] = head
    jt.state = jt.state.replace(params=params, swa_params=jax.tree.map(
        lambda x: jnp.array(x, copy=True), params))
    init = jax.tree.map(np.asarray, jt.state)
    jt.fit()

    tout = tmp_path_factory.mktemp("torch")
    cfg = configs.build_experiment_config([], overrides(corpus, tout))
    mcfg = model_config(cfg)
    start = train_state_from_jax(init, mcfg, make_optimizer(lr_schedule=LR))
    write_checkpoint(tout / "init", state_snapshot(start))
    cfg["ckpt_path"] = str(tout / "init")
    tt = Trainer(cfg, run_info={"command": "main"}, device="cpu")
    assert tt.epoch == 0
    res = tt.fit()
    return dict(jax=jt, torch=tt, res=res, mcfg=mcfg, jout=jout, tout=tout,
                cfg=cfg, init=init)


def test_fit_losses_and_val_metrics_match_jax(runs):
    assert runs["res"] == {"done": True}
    jm = {(n, s): v for n, s, v in _metrics(runs["jax"].run_dir)}
    tm = {(n, s): v for n, s, v in _metrics(runs["torch"].run_dir)}
    assert sorted(tm) == sorted(jm)
    steps = sorted(s for n, s in tm if n == "train_loss")
    assert steps == list(range(1, 9))
    ours = np.array([tm["train_loss", s] for s in steps])
    ref = np.array([jm["train_loss", s] for s in steps])
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert abs(ours[-1] - np.log(2)) > 1e-3  # the drawn head is read
    assert all(tm["nonfinite_skipped", s] == 0.0 for s in steps)
    val = sorted(k for k in tm if k[0].startswith("val_"))
    # loss, AP and ROC of the live and SWA weights, after both epochs
    assert sorted({n for n, _ in val}) == sorted(
        f"val_{m}{s}" for m in ("loss", "ap", "roc") for s in ("", "_swa"))
    assert sorted({s for _, s in val}) == [0, 1]
    for k in val:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=str(k))


def _assert_params(ours, jparams, mcfg, lr_sum):
    ref = state_from_jax_params(jax.tree.map(np.asarray, jparams), mcfg)
    e = mcfg.embed_dim
    assert set(ref) <= set(ours)
    for k, v in ref.items():
        a, b = ours[k].detach().numpy(), v.numpy()
        if k.endswith("attn.qkv.bias"):
            np.testing.assert_allclose(a[e:2 * e], b[e:2 * e], rtol=0,
                                       atol=2 * lr_sum, err_msg=k)
            a, b = np.delete(a, np.s_[e:2 * e]), np.delete(b, np.s_[e:2 * e])
        np.testing.assert_allclose(a, b, err_msg=k, **TOL)


def test_final_live_and_swa_params_match_jax(runs):
    jt, tt = runs["jax"], runs["torch"]
    lr_sum = sum(tt.tx.lr(i) for i in range(tt.state.count))
    assert tt.state.step == tt.state.count == int(jt.state.step) == 8
    assert tt.state.swa_n == int(jt.state.swa_n) == 1
    _assert_params(tt.state.params, jt.state.params, runs["mcfg"], lr_sum)
    _assert_params(tt.state.swa_params, jt.state.swa_params, runs["mcfg"],
                   lr_sum)
    moved = state_from_jax_params(runs["init"].params, runs["mcfg"])
    assert not torch.equal(tt.state.params["blocks.0.attn.qkv.weight"],
                           moved["blocks.0.attn.qkv.weight"])


def test_checkpoint_tags_and_markers_match_jax(runs):
    jdir = runs["jax"].run_dir / "checkpoints"
    tdir = runs["torch"].run_dir / "checkpoints"
    names = sorted(p.name for p in tdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir())
    assert names == ["best", "best.meta.json", "epoch-0", "epoch-0.meta.json",
                     "epoch-1", "epoch-1.meta.json"]
    for tag in ("best", "epoch-0", "epoch-1"):
        ours = json.loads((tdir / f"{tag}.meta.json").read_text())
        ref = json.loads((jdir / f"{tag}.meta.json").read_text())
        assert ours["epoch"] == ref["epoch"], tag
        np.testing.assert_allclose(ours["best_val"], ref["best_val"],
                                   rtol=1e-4)
    for name in ("run.json", "config.json"):
        assert (runs["torch"].run_dir / name).exists()
    assert json.loads((runs["torch"].run_dir / "run.json").read_text())[
        "status"] == "COMPLETED"


def test_resume_from_epoch_0_equals_the_uninterrupted_run(runs, tmp_path):
    cfg = dict(runs["cfg"])
    cfg["trainer"] = dict(cfg["trainer"],
                          default_root_dir=str(tmp_path / "exp_logs"))
    cfg["ckpt_path"] = str(runs["torch"].run_dir / "checkpoints" / "epoch-0")
    tt = Trainer(cfg, device="cpu")
    assert tt.fit() == {"done": True}
    assert tt.epoch == 2 and tt.state.step == 8
    full = runs["torch"].state
    for name in ("params", "swa_params"):
        ref = getattr(full, name)
        for k, v in getattr(tt.state, name).items():
            assert torch.equal(v, ref[k]), (name, k)
    epoch1 = [m for m in _metrics(runs["torch"].run_dir) if m[1] == 1
              and m[0].startswith("val_")]
    assert [m for m in _metrics(tt.run_dir)
            if m[0].startswith("val_")] == epoch1


@pytest.fixture(scope="module")
def best(runs):
    jbest = runs["jax"].run_dir / "checkpoints" / "best"
    tbest = runs["torch"].run_dir / "checkpoints" / "best"
    epoch = json.loads((tbest.parent / "best.meta.json").read_text())["epoch"]
    assert json.loads((jbest.parent / "best.meta.json").read_text())[
        "epoch"] == epoch
    return jbest, tbest


def test_test_command_evaluates_the_live_net_only(runs, corpus, best, tmp_path,
                                                  capsys):
    jbest, tbest = best
    ref = jax_cli.run(["test", "with", *overrides(
        corpus, tmp_path / "j", [f"ckpt_path={jbest}"])])
    ours = cli.run(["test", "with", *overrides(
        corpus, tmp_path / "t", [f"ckpt_path={tbest}"])], device="cpu")
    assert sorted(ours) == sorted(ref) == ["test_ap", "test_loss", "test_roc"]
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)
    record = json.loads((_run_dir(tmp_path / "t") / "run.json").read_text())
    assert record["status"] == "COMPLETED" and record["command"] == "test"
    assert '"test_loss"' in capsys.readouterr().out


@pytest.mark.parametrize("command", ["extract_embeddings", "extract_logits"])
def test_extract_matches_jax(runs, corpus, best, tmp_path, command):
    jbest, tbest = best
    name = "embeddings" if command == "extract_embeddings" else "logits"
    ref = jax_cli.run([command, "with", *overrides(
        corpus, tmp_path / "j", [f"ckpt_path={jbest}"])])
    ours = cli.run([command, "with", *overrides(
        corpus, tmp_path / "t", [f"ckpt_path={tbest}"])], device="cpu")
    assert ours["n_files"] == ref["n_files"] == N_WINDOWED
    files = sorted(Path(ref["out_dir"]).glob(f"*.{name}.npy"))
    assert len(files) == N_WINDOWED
    for f in files:
        a = np.load(Path(ours["out_dir"]) / f.name)
        b = np.load(f)
        width = 3 * 64 if name == "embeddings" else 8
        assert a.shape == b.shape == (1, width), f.name
        np.testing.assert_allclose(a, b, err_msg=f.name, **OUT_TOL)


@pytest.mark.parametrize("exc, status", [
    (RuntimeError("a failed step"), "FAILED"),
    (KeyboardInterrupt(), "INTERRUPTED"),
    (SystemExit(143), "INTERRUPTED"),
    (SystemExit(1), "FAILED"),
], ids=["error", "ctrl-c", "sigterm", "exit-1"])
def test_run_record_after_an_injected_exception(corpus, tmp_path, exc, status):
    cfg = configs.build_experiment_config([], overrides(corpus, tmp_path))
    tt = Trainer(cfg, run_info={"command": "main"}, device="cpu")

    def broken(*a, **k):
        raise exc

    tt.train_step = broken
    with pytest.raises(type(exc)):
        tt.fit()
    record = json.loads((tt.run_dir / "run.json").read_text())
    assert record["status"] == status and record["command"] == "main"
    assert not (tt.run_dir / "checkpoints").exists()


@pytest.mark.parametrize("key, value", [
    ("devices", 2), ("model_parallel", 2), ("fsdp", True),
    ("pipeline_parallel", 2), ("sequence_parallel", True)])
def test_parallel_modes_are_refused(corpus, tmp_path, key, value):
    """In one process, without a launch of several ranks, every parallel
    mode over 2 devices is refused, naming the launchers (the parallel
    modes across ranks: tests/test_torch_parallel*.py and
    tests/test_torch_pipeline*.py)."""
    extra = [f"trainer.{key}={value}"]
    if key != "devices":
        extra.append("trainer.devices=2")
    cfg = configs.build_experiment_config([], overrides(corpus, tmp_path,
                                                        extra))
    with pytest.raises(ValueError, match="torchrun"):
        Trainer(cfg, device="cpu")
    assert not (tmp_path / "exp_logs").exists()


def test_multi_process_launch_is_refused(corpus, tmp_path, monkeypatch):
    """torchrun's WORLD_SIZE without the coordinator's MASTER_ADDR: the
    ranks would train as independent single runs, so the launch fails
    fast (maest_tpu/parallel/mesh.py:20-65)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    cfg = configs.build_experiment_config([], overrides(corpus, tmp_path))
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        Trainer(cfg, device="cpu")


def test_cuda_is_the_default_and_never_falls_back(corpus, tmp_path):
    """``Trainer`` and ``run`` use the card unless told otherwise: without
    one they raise, and no run directory is made."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = configs.build_experiment_config([], overrides(corpus, tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["main", "with", *overrides(corpus, tmp_path)])
    assert not (tmp_path / "exp_logs").exists()


def test_model_speed_test_and_norm_stats(corpus, tmp_path):
    ov = overrides(corpus, tmp_path, ["speed_test.batch_size=2",
                                      "speed_test.test_length=2"])
    res = cli.run(["model_speed_test", "with", *ov], device="cpu")
    assert res["specs_per_second"] > 0
    ours = cli.run(["compute_norm_stats", "with", *ov], device="cpu")
    ref = jax_cli.run(["compute_norm_stats", "with", *ov])
    assert ours == ref


def test_teacher_student_main_on_extracted_logits(runs, corpus, best, tmp_path):
    """The e2e teacher-student path: ``extract_logits`` of the trained
    run writes one teacher file per track, and a teacher-student ``main``
    (two heads) trains on those files as its teacher targets."""
    _, tbest = best
    with open(corpus / "gt_train.pk", "rb") as f:
        gt = pickle.load(f)
    windowed = {k: v for k, v in gt.items()
                if (corpus / k).stat().st_size // (2 * 96) >= 171}
    assert len(windowed) == N_WINDOWED
    with open(tmp_path / "gt_ts.pk", "wb") as f:
        pickle.dump(windowed, f)
    split = [f"datamodule.groundtruth_{s}={tmp_path}/gt_ts.pk"
             for s in ("train", "val", "predict")]
    teacher = cli.run(["extract_logits", "with", *overrides(
        corpus, tmp_path / "teacher", [*split, f"ckpt_path={tbest}"])],
        device="cpu")
    assert teacher["n_files"] == N_WINDOWED
    res = cli.run(["main", "with", *overrides(corpus, tmp_path / "ts", [
        *split, "datamodule.teacher_student.do=True",
        f"datamodule.teacher_student.teacher_target_base_dir="
        f"{teacher['out_dir']}", "maest.distilled_type='separated'",
        "trainer.max_epochs=1", "datamodule.sampler.epoch_len=4"])],
        device="cpu")
    assert res == {"done": True}
    metrics = {(n, s): v for n, s, v in _metrics(_run_dir(tmp_path / "ts"))}
    steps = [s for n, s in metrics if n == "train_loss_teacher"]
    assert steps == [1, 2]
    for k in ("train_loss", "train_loss_standard", "train_loss_teacher"):
        assert all(np.isfinite(metrics[k, s]) for s in steps), k
    assert all(np.isfinite(metrics[f"val_loss{p}{s}", 0])
               for p in ("", "_standard", "_teacher") for s in ("", "_swa"))
