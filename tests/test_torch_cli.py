"""The port's experiment CLI and elastic recovery against the JAX
package's, on the CPU: the argv parse and ``print_config`` are the JAX
CLI's; a bad command leaves no run directory; ``fit_with_recovery``
restarts from the newest checkpoint after a recoverable error, stops on a
fatal one and at ``max_restarts`` (the cases of
``tests/test_resilience.py`` that need no ``jax.distributed``, on the
port's tiny Trainer)."""

import json
import pickle

import numpy as np
import pytest
import torch

from maest_tpu.apps import ex_maest as jax_cli
from maest_tpu_torch import configs
from maest_tpu_torch.apps import ex_maest as cli
from maest_tpu_torch.train import (
    Trainer,
    fit_with_recovery,
    is_recoverable,
    latest_checkpoint,
)

ARGVS = [
    ["main", "with", "mini_train", "trainer.max_epochs=1"],
    ["maest_30s_from_passt_pretrain", "trainer.max_epochs=1"],
    ["test", "with", "maest_10s_from_passt_inference",
     "ckpt_path='/x/best'"],
    ["extract_embeddings", "maest_30s_from_passt_inference", "target_mtt"],
    ["extract_logits", "with", "predict.transformer_block=3"],
    ["print_config"],
    ["print_config", "with", "maest_10s_random_weights_pretrain",
     "datamodule.sampler.epoch_len=48", "module.swa_epoch_start=1"],
    ["model_speed_test", "with", "speed_test.batch_size=4"],
    ["compute_norm_stats"],
    ["with", "maest_5s_from_passt_pretrain"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a)[:40] for a in ARGVS])
def test_parse_argv_matches_jax(argv):
    assert cli.parse_argv(argv) == jax_cli.parse_argv(argv)
    assert cli.COMMANDS == jax_cli.COMMANDS


@pytest.mark.parametrize("argv", [["-h"], ["--help"], []])
def test_help_exits_zero(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.parse_argv(argv)
    assert e.value.code == 0
    assert "commands: main, test" in capsys.readouterr().out


@pytest.mark.parametrize("presets", [
    [], ["maest_10s_random_weights_pretrain"],
    ["maest_30s_from_passt_teacher_student_pretrain", "mini_train"]])
def test_print_config_matches_jax(presets, capsys):
    argv = ["print_config", "with", *presets, "trainer.max_epochs=3",
            "maest.attention_bwd_quant='int8'"]
    ours = cli.run(argv, device="cpu")
    out = capsys.readouterr().out
    ref = jax_cli.run(argv)
    assert ours == ref and out == capsys.readouterr().out
    assert json.loads(out)["trainer"]["max_epochs"] == 3


def test_unknown_command_exits_before_any_run_dir(tmp_path, monkeypatch):
    """A word that is no command is read as a preset, which the config
    refuses; the dispatch guard refuses a listed command with no branch.
    Neither leaves a run directory behind."""
    root = tmp_path / "exp_logs"
    ov = f"trainer.default_root_dir={root}"
    with pytest.raises(KeyError, match="unknown preset"):
        cli.run(["trian", "with", ov], device="cpu")
    monkeypatch.setattr(cli, "COMMANDS", cli.COMMANDS + ("bogus",))
    with pytest.raises(SystemExit, match="unknown command bogus"):
        cli.run(["bogus", "with", ov], device="cpu")
    assert not root.exists()


class DistBackendError(RuntimeError):
    """Stand-in matched by name, like ``torch.distributed.DistBackendError``."""


def test_is_recoverable_classification():
    assert is_recoverable(DistBackendError("NCCL communicator was aborted"))
    assert is_recoverable(torch.distributed.DistBackendError("watchdog"))
    assert is_recoverable(RuntimeError("NCCL error: remote process exited"))
    assert is_recoverable(RuntimeError("worker preempted"))
    assert is_recoverable(OSError("connection reset by peer"))
    assert is_recoverable(ConnectionResetError("socket closed"))
    assert not is_recoverable(ValueError("bad config"))
    assert not is_recoverable(RuntimeError("shape mismatch"))
    assert not is_recoverable(KeyError("params"))
    assert not is_recoverable(TypeError("expected Tensor"))
    # programming-error types stay fatal even when the message quotes a
    # recoverable phrase — only runtime/IO types get the phrase check
    assert not is_recoverable(ValueError("NCCL is not a valid backend"))
    assert not is_recoverable(KeyError("preempted"))
    # out of memory and the sticky CUDA errors are fatal: a retry in this
    # process fails the same way, or has no CUDA context left
    assert not is_recoverable(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not is_recoverable(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert not is_recoverable(RuntimeError("CUDA error: unspecified launch failure"))
    assert not is_recoverable(RuntimeError(
        "CUDA error: device-side assert triggered (NCCL watchdog)"))


def test_latest_checkpoint_picks_newest_epoch(tmp_path):
    assert latest_checkpoint(tmp_path) is None
    ckpts = tmp_path / "checkpoints"
    for epoch in (0, 2, 1):
        (ckpts / f"epoch-{epoch}").mkdir(parents=True)
        (ckpts / f"epoch-{epoch}.meta.json").write_text('{"epoch": %d}' % epoch)
    (ckpts / "epoch-3").mkdir()  # an interrupted save (no meta)
    assert latest_checkpoint(tmp_path).endswith("epoch-2")
    # a save in flight: written under a temporary name, renamed on commit
    (ckpts / "epoch-4.tmp123").mkdir()
    (ckpts / "epoch-4.meta.json").write_text('{"epoch": 4}')
    assert latest_checkpoint(tmp_path).endswith("epoch-2")
    (ckpts / "epoch-5").mkdir()
    (ckpts / "epoch-5.meta.json").write_text("")  # truncated by a kill
    assert latest_checkpoint(tmp_path).endswith("epoch-2")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
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
    return root


def _config(corpus, tmp_path):
    return configs.build_experiment_config([], [
        f"datamodule.base_dir={corpus}",
        f"datamodule.groundtruth_train={corpus}/gt_train.pk",
        f"datamodule.groundtruth_val={corpus}/gt_val.pk",
        "datamodule.clip_length=1",
        "datamodule.batch_size_train=2",
        "datamodule.batch_size_test=3",
        "datamodule.num_workers=2",
        "datamodule.sampler.epoch_len=4",
        "maest.n_classes=8",
        "maest.input_t=62",
        "maest.embed_dim=64",
        "maest.depth=2",
        "maest.num_heads=4",
        "maest.s_patchout_t=1",
        "trainer.max_epochs=2",
        "trainer.precision=fp32",
        "trainer.limit_val_batches=1",
        "module.swa_epoch_start=0",
        "module.optimizer.warm_up_len=1",
        f"trainer.default_root_dir={tmp_path}/exp_logs",
    ])


def test_fit_recovers_from_mid_training_failure(corpus, tmp_path):
    """Fail during epoch 1 (after epoch 0 checkpointed): recovery resumes
    from epoch-0 and completes, reporting the restart."""
    state = {"made": 0, "steps": 0, "resumed_from": None, "trainers": []}

    def factory(cfg):
        cfg = dict(cfg, trainer=dict(
            cfg["trainer"],
            default_root_dir=f"{tmp_path}/exp_logs/attempt{state['made']}"))
        t = Trainer(cfg, device="cpu")
        state["trainers"].append(t)
        if state["made"] == 0:
            orig = t.train_step

            def flaky(s, batch, generator=None):
                state["steps"] += 1
                if state["steps"] > 2:  # 2 steps an epoch: fails in epoch 1
                    raise DistBackendError("NCCL error: remote process exited")
                return orig(s, batch, generator)

            t.train_step = flaky
        else:
            state["resumed_from"] = cfg.get("ckpt_path")
        state["made"] += 1
        return t

    res = fit_with_recovery(_config(corpus, tmp_path),
                            trainer_factory=factory, backoff_s=0.0)
    assert res["done"] and res["restarts"] == 1
    assert state["made"] == 2
    assert state["resumed_from"].endswith("epoch-0")
    # resume starts at the NEXT epoch: the recovered trainer runs epoch 1
    assert state["trainers"][1].epoch == 2
    assert state["trainers"][1].state.step == 4
    first = json.loads((state["trainers"][0].run_dir / "run.json").read_text())
    assert first["status"] == "FAILED"


def test_programming_errors_propagate(corpus, tmp_path):
    made = []

    def factory(cfg):
        t = Trainer(cfg, device="cpu")

        def broken(s, batch, generator=None):
            raise ValueError("bad shapes")

        t.train_step = broken
        made.append(t)
        return t

    with pytest.raises(ValueError, match="bad shapes"):
        fit_with_recovery(_config(corpus, tmp_path),
                          trainer_factory=factory, backoff_s=0.0)
    assert len(made) == 1


def test_restart_budget_exhaustion(corpus, tmp_path):
    made = []

    def factory(cfg):
        t = Trainer(cfg, device="cpu")

        def always_down(s, batch, generator=None):
            raise RuntimeError("NCCL error: unhandled system error")

        t.train_step = always_down
        made.append(t)
        return t

    with pytest.raises(RuntimeError, match="NCCL"):
        fit_with_recovery(_config(corpus, tmp_path),
                          trainer_factory=factory, backoff_s=0.0,
                          max_restarts=1)
    assert len(made) == 2


def test_resilient_main_runs_through_fit_with_recovery(corpus, tmp_path,
                                                       monkeypatch):
    seen = {}

    def fake(cfg, *, trainer_factory, device):
        seen["cfg"], seen["device"] = cfg, device
        seen["trainer"] = trainer_factory(cfg)
        return {"done": True}

    from maest_tpu_torch.train import resilience
    monkeypatch.setattr(resilience, "fit_with_recovery", fake)
    argv = ["main", "with", "trainer.resilient=True", *[
        f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}" for k, v in (
            ("datamodule.base_dir", str(corpus)),
            ("datamodule.groundtruth_train", f"{corpus}/gt_train.pk"),
            ("datamodule.groundtruth_val", f"{corpus}/gt_val.pk"),
            ("datamodule.clip_length", 1), ("maest.input_t", 62),
            ("maest.embed_dim", 64), ("maest.depth", 2),
            ("maest.num_heads", 4), ("maest.n_classes", 8),
            ("trainer.default_root_dir", f"{tmp_path}/exp_logs"))]]
    assert cli.run(argv, device="cpu") == {"done": True}
    assert seen["cfg"]["trainer"]["resilient"] is True
    assert seen["trainer"].device.type == "cpu" and seen["device"] == "cpu"
