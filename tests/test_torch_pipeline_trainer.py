"""The port's Trainer under GPipe across 2 real processes (gloo on the
CPU) against its one process, through the experiment CLI's launcher
(``ex_maest.launch``, with a timeout that kills the ranks).

The corpus, the model (embed 64, depth 2, 4 heads, ``clip_length=3``)
and the run (2 epochs of 2 steps of batch 4, SWA from epoch 1, fp32,
SpecAugment and mixup on) are ``tests/test_torch_parallel_trainer.py``'s;
``trainer.pipeline_parallel=2`` puts one block on each rank, 2
microbatches a step, evals at one. Tolerances as there: per-step losses
rtol 1e-5; val metrics (live and SWA) rtol 1e-4; parameters rtol 1e-4,
atol 2e-6, the key bias within 2 lr a step; extracted embeddings rtol
1e-4, atol 5e-5. Rank 0's checkpoint, gathered from both stages,
restores in one process exactly, and a resume from the run's own
checkpoint gives its parameters bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from maest_tpu_torch import configs
from maest_tpu_torch.apps import ex_maest as cli
from maest_tpu_torch.train import Trainer
from maest_tpu_torch.train.loop import read_checkpoint, state_snapshot

from test_torch_parallel_trainer import (
    LR,
    OUT_TOL,
    TIMEOUT,
    _assert_params,
    _metrics,
    _params,
    _run_dir,
    make_corpus,
    overrides,
)

PP = ["datamodule.batch_size_train=4", "trainer.devices=2",
      "trainer.pipeline_parallel=2", "trainer.num_microbatches=2"]


def _launch(argv):
    return cli.launch(argv, 2, "cpu", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


@pytest.fixture(scope="module")
def one(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("one")
    res = cli.run(["main", "with", *overrides(
        corpus, out, ["datamodule.batch_size_train=4", "trainer.devices=1"])],
        device="cpu")
    assert res == {"done": True}
    return out


@pytest.fixture(scope="module")
def pp(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    assert _launch(["main", "with", *overrides(corpus, out, PP)]) == {
        "done": True}
    return out


def test_pipeline_fit_matches_one_process(one, pp):
    """Losses, val metrics (live and SWA), checkpoints and the final
    parameters of the pipelined run against the one process's."""
    ours, ref = _metrics(pp), _metrics(one)
    assert sorted(ours) == sorted(ref)
    steps = sorted(s for n, s in ref if n == "train_loss")
    assert steps == [1, 2, 3, 4]
    np.testing.assert_allclose([ours["train_loss", s] for s in steps],
                               [ref["train_loss", s] for s in steps],
                               rtol=1e-5)
    for k in (k for k in ref if k[0].startswith("val_")):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=str(k))
    assert sorted(p.name for p in (_run_dir(pp) / "checkpoints").iterdir()) \
        == sorted(p.name for p in (_run_dir(one) / "checkpoints").iterdir())
    _assert_params(_params(pp, "epoch-1"), _params(one, "epoch-1"), 4 * LR)


def test_pipeline_checkpoint_restores_in_one_process(pp, corpus, tmp_path):
    """Rank 0's checkpoint holds both stages' blocks and loads into a
    one-process Trainer exactly: every parameter, moment and SWA tensor,
    and the counters."""
    path = _run_dir(pp) / "checkpoints" / "epoch-1"
    cfg = configs.build_experiment_config([], overrides(
        corpus, tmp_path, ["datamodule.batch_size_train=4",
                           "trainer.devices=1"]))
    trainer = Trainer(cfg, device="cpu")
    trainer.restore_checkpoint(str(path))
    snap, ref = state_snapshot(trainer.state), read_checkpoint(path)
    assert snap["step"] == ref["step"] == 4 and snap["swa_n"] == 1
    assert {"blocks.0.attn.qkv.weight", "blocks.1.attn.qkv.weight"} <= set(
        ref["params"])
    for group in ("params", "swa_params"):
        for k, v in ref[group].items():
            assert torch.equal(snap[group][k], v), (group, k)
    for m in ("mu", "nu"):
        assert set(ref["opt_state"][m]) == set(snap["opt_state"][m])
        for k, v in ref["opt_state"][m].items():
            assert torch.equal(snap["opt_state"][m][k], v), (m, k)


@pytest.mark.parametrize("start", ["one", "pp"])
def test_pipeline_resume(one, pp, corpus, tmp_path, start):
    """The pipelined ranks resume epoch 1 from epoch-0, of their own run
    (its epoch-1 parameters bit for bit) or of the one process's (within
    tolerance of the one process's)."""
    src = one if start == "one" else pp
    ckpt = _run_dir(src) / "checkpoints" / "epoch-0"
    out = tmp_path / "resumed"
    assert _launch(["main", "with", *overrides(
        corpus, out, [*PP, f"ckpt_path={ckpt}"])]) == {"done": True}
    ours = _params(out, "epoch-1")
    if start == "pp":
        for k, v in _params(pp, "epoch-1").items():
            assert torch.equal(ours[k], v), k
    _assert_params(ours, _params(one, "epoch-1"), 4 * LR)


def test_pipeline_predict_partitions_files(one, corpus, tmp_path):
    """``extract_embeddings`` under pipeline_parallel=2: the sequential
    path on each rank with the whole weights, the files partitioned over
    the ranks; the set and the values are the one process's."""
    best = f"ckpt_path={_run_dir(one) / 'checkpoints' / 'best'}"
    ref = cli.run(["extract_embeddings", "with", *overrides(
        corpus, tmp_path / "one", [best, "trainer.devices=1"])], device="cpu")
    ours = _launch(["extract_embeddings", "with", *overrides(
        corpus, tmp_path / "pp", [best, *PP])])
    assert ours["n_files"] == ref["n_files"] == 8
    files = sorted(p.name for p in Path(ref["out_dir"]).glob("*.npy"))
    assert sorted(p.name for p in Path(ours["out_dir"]).glob("*.npy")) == files
    for f in files:
        np.testing.assert_allclose(np.load(Path(ours["out_dir"]) / f),
                                   np.load(Path(ref["out_dir"]) / f),
                                   err_msg=f, **OUT_TOL)


def test_pipeline_refusals(corpus, tmp_path):
    """The JAX Trainer's refusals: sequence parallelism with a pipeline
    (before any rank joins), and a global batch that the data ranks x
    microbatches do not divide (in the ranks)."""
    cfg = configs.build_experiment_config([], overrides(
        corpus, tmp_path, [*PP, "trainer.model_parallel=2",
                           "trainer.sequence_parallel=True"]))
    with pytest.raises(ValueError, match="does not compose with "
                       "sequence_parallel"):
        Trainer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="global train batch 3 must divide "
                       "by data shards x num_microbatches = 1 x 2"):
        _launch(["main", "with", *overrides(
            corpus, tmp_path / "bad", [*PP, "datamodule.batch_size_train=3"])])
