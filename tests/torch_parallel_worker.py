"""The ranks of ``tests/test_torch_parallel.py`` and
``tests/test_torch_pipeline.py``: processes spawned over gloo on the CPU
by ``maest_tpu_torch.parallel.launch.spawn``, each running the port's
train step in every parallel mode of one world size on its rows of the
same global batches. Imports torch and the port only (no
jax): the test holds the results to the JAX package.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch


# -- the modes --------------------------------------------------------------

MODES = {
    2: {"dp": (1, False, False), "fsdp": (1, True, False),
        "tp": (2, False, False), "tp+sp": (2, False, True)},
    4: {"dp+tp": (2, False, False), "dp+tp+sp": (2, False, True),
        "fsdp+tp": (2, True, False)},
}


def run_modes(rank, world, spec_path, out_dir, modes):
    """Each mode of ``modes`` (names of ``MODES[world]``, or
    "<name>:random" with the spec's randomness on, or "<name>:accum" with
    2 micro-batches an optimizer step): build the full model from the
    spec's weights, shard it, take the spec's steps on this rank's rows of
    each global batch, and write (every rank) the losses and the whole
    parameters gathered from the shards to ``out_dir/<mode>.<rank>.pt``."""
    import torch.distributed as dist

    from maest_tpu_torch.checkpoints import load_into
    from maest_tpu_torch.models.config import MAESTConfig
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.parallel import mesh as pmesh
    from maest_tpu_torch.train import (
        AugmentConfig,
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from maest_tpu_torch.train import schedules
    from maest_tpu_torch.train.loop import state_snapshot

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    pmesh.init_distributed("cpu")
    for mode in modes:
        name, _, variant = mode.partition(":")
        random = variant == "random"
        model_parallel, fsdp, sp = MODES[world][name]
        geom = dict(spec["geom"], **(spec["random_geom"] if random else {}))
        cfg = MAESTConfig(**geom)
        net = load_into(MAESTNet(cfg), spec["state"])
        tx = make_optimizer(lr_schedule=schedules.make_schedule(
            "exp_lin", spec["lr"], 1, warm_up_len=2),
            accumulate_steps=2 if variant == "accum" else 1)
        par = pmesh.Parallel(pmesh.make_mesh(world, model_parallel, "cpu"),
                             fsdp=fsdp, sequence_parallel=sp)
        state = TrainState.create(net, tx, with_swa=False, parallel=par)
        aug = AugmentConfig(**(spec["random_aug"] if random
                               else spec["aug"]))
        step = make_train_step(net, tx, aug, parallel=par)
        losses = []
        for i, batch in enumerate(spec["batches"]):
            b = len(batch["x"]) // par.data
            rows = slice(par.data_rank * b, (par.data_rank + 1) * b)
            gen = (torch.Generator().manual_seed(spec["seed"] + i)
                   if random else None)
            state, m = step(state, {k: v[rows] for k, v in batch.items()},
                            gen)
            losses.append(m["train_loss"])
        params = state_snapshot(state, par)["params"]
        torch.save({"losses": losses, "params": params,
                    "describe": par.describe()},
                   Path(out_dir) / f"{mode}.{rank}.pt")
        dist.barrier()


def one_process(spec, random: bool, accumulate: int = 1, variant: str = ""):
    """The port's one-process run of the spec: (losses, parameters).
    ``variant``: a pipeline variant of ``PIPE_VARIANTS`` (its geometry,
    its augmentation, its batches), which sets the randomness itself."""
    from maest_tpu_torch.checkpoints import load_into
    from maest_tpu_torch.models.config import MAESTConfig
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.train import (
        AugmentConfig,
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from maest_tpu_torch.train import schedules

    if variant:
        geom, aug, random, ts, batches = _pipe_variant(spec, variant)
    else:
        geom = dict(spec["geom"], **(spec["random_geom"] if random else {}))
        aug = spec["random_aug"] if random else spec["aug"]
        ts, batches = False, spec["batches"]
    net = load_into(MAESTNet(MAESTConfig(**geom)), spec["state"])
    tx = make_optimizer(lr_schedule=schedules.make_schedule(
        "exp_lin", spec["lr"], 1, warm_up_len=2), accumulate_steps=accumulate)
    state = TrainState.create(net, tx, with_swa=False)
    step = make_train_step(net, tx, AugmentConfig(**aug), teacher_student=ts)
    losses = []
    for i, batch in enumerate(batches):
        gen = (torch.Generator().manual_seed(spec["seed"] + i)
               if random else None)
        state, m = step(state, batch, gen)
        losses.append(m["train_loss"])
    return losses, {k: p.detach().clone()
                    for k, p in net.named_parameters()}


# -- the pipeline's modes -----------------------------------------------------

# name: (stages, model_parallel, fsdp, microbatches)
PIPE_MODES = {
    2: {"pp": (2, 1, False, 2), "pp-m4": (2, 1, False, 4)},
    4: {"dp+pp": (2, 1, False, 2), "pp+tp": (2, 2, False, 2),
        "dp+pp+fsdp": (2, 1, True, 2)},
    8: {"dp+pp+tp": (2, 2, False, 2)},
}
# variant: (geometry, augmentation, randomness on, teacher-student); the
# pipeline refuses drop_path, so its random geometry has none
PIPE_VARIANTS = {
    "": ({}, "aug", False, False),
    "random": (dict(s_patchout_t_indices=(), s_patchout_t=1, u_patchout=2,
                    drop_rate=0.1, attn_drop_rate=0.1), "random_aug", True,
               False),
    "remat": (dict(remat=True, drop_rate=0.1), "aug", True, False),
    "ts": (dict(distilled_type="separated"), "aug", False, True),
}


def _pipe_variant(spec, variant):
    extra, aug, random, ts = PIPE_VARIANTS[variant]
    batches = spec["batches"]
    if ts:
        batches = [dict(b, y_teacher=t) for b, t in
                   zip(batches, spec["teacher_targets"])]
    return dict(spec["geom"], **extra), spec[aug], random, ts, batches


def run_pipeline_modes(rank, world, spec_path, out_dir, modes):
    """Each mode of ``modes`` (names of ``PIPE_MODES[world]``, or
    "<name>:<variant>" of ``PIPE_VARIANTS``): the model cut to this rank's
    stage and shard, one pipelined eval forward at M = 1 of the spec's
    ``eval_x`` (the initial weights), then the spec's steps on this rank's
    rows; writes the eval logits, the losses and the whole parameters
    (gathered from every stage) to ``out_dir/<mode>.<rank>.pt``."""
    import torch.distributed as dist

    from maest_tpu_torch.checkpoints import load_into
    from maest_tpu_torch.models.config import MAESTConfig
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.parallel import mesh as pmesh
    from maest_tpu_torch.parallel import pipeline
    from maest_tpu_torch.train import AugmentConfig, TrainState, make_optimizer
    from maest_tpu_torch.train import schedules
    from maest_tpu_torch.train.loop import state_snapshot

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    pmesh.init_distributed("cpu")
    for mode in modes:
        name, _, variant = mode.partition(":")
        stages, model_parallel, fsdp, m = PIPE_MODES[world][name]
        geom, aug, random, ts, batches = _pipe_variant(spec, variant)
        net = load_into(MAESTNet(MAESTConfig(**geom)), spec["state"])
        tx = make_optimizer(lr_schedule=schedules.make_schedule(
            "exp_lin", spec["lr"], 1, warm_up_len=2))
        par = pmesh.Parallel(pipeline.make_pipeline_mesh(
            world, stages, model_parallel, "cpu"), fsdp=fsdp)
        state = TrainState.create(net, tx, with_swa=False, parallel=par)
        for group in state.optimizer.param_groups:
            # the multi-tensor kernels the card's optimizer takes by
            # default (the CPU's takes the per-tensor loop): a stage holds
            # FSDP2 shards beside plain tensors
            group["foreach"] = True
        b = len(spec["eval_x"]) // par.data
        mine = slice(par.data_rank * b, (par.data_rank + 1) * b)
        logits = pipeline.make_pipeline_forward(net, par, num_microbatches=1)(
            torch.as_tensor(spec["eval_x"][mine]))[0]
        step = pipeline.make_pipeline_train_step(
            net, tx, AugmentConfig(**aug), parallel=par, num_microbatches=m,
            teacher_student=ts)
        losses = []
        for i, batch in enumerate(batches):
            b = len(batch["x"]) // par.data
            rows = slice(par.data_rank * b, (par.data_rank + 1) * b)
            gen = (torch.Generator().manual_seed(spec["seed"] + i)
                   if random else None)
            state, met = step(state, {k: v[rows] for k, v in batch.items()},
                              gen)
            losses.append(met["train_loss"])
        params = state_snapshot(state, par)["params"]
        torch.save({"losses": losses, "params": params, "logits": logits,
                    "describe": par.describe(),
                    "held": sorted(k for k, _ in net.named_parameters())},
                   Path(out_dir) / f"{mode}.{rank}.pt")
        dist.barrier()


def gather_rows(rank, world, out_dir):
    """``gather_across_hosts`` of rank r's r + 1 rows, before and after
    the process group is torn down and formed again
    (``resilience._reinit_distributed``)."""
    from maest_tpu_torch.parallel import mesh as pmesh
    from maest_tpu_torch.train.metrics import gather_across_hosts
    from maest_tpu_torch.train.resilience import _reinit_distributed

    torch.set_num_threads(1)
    pmesh.init_distributed("cpu")
    arr = np.full((rank + 1, 3), rank, np.int64)
    np.save(Path(out_dir) / f"gather.{rank}.npy", gather_across_hosts(arr))
    _reinit_distributed("cpu")
    np.save(Path(out_dir) / f"regather.{rank}.npy", gather_across_hosts(arr))


def fail_or_wait(rank, world, failing_rank, wait_s):
    """Rank ``failing_rank`` raises at once; the others wait ``wait_s``
    seconds and return their rank."""
    if rank == failing_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    time.sleep(wait_s)
    return rank


def recover_before_the_trainer(rank, world):
    """``fit_with_recovery`` on the CPU whose first Trainer fails to build
    with a recoverable error: the group is formed again over gloo and the
    second attempt's ``fit`` sums a tensor over it. Returns the result
    and the number of attempts."""
    import torch.distributed as dist

    from maest_tpu_torch.parallel import mesh as pmesh
    from maest_tpu_torch.train.resilience import fit_with_recovery

    torch.set_num_threads(1)
    pmesh.init_distributed("cpu")
    made = []

    class Joined:
        def fit(self):
            t = torch.ones(1)
            dist.all_reduce(t)
            return {"done": True, "sum": float(t)}

    def factory(cfg):
        made.append(cfg)
        if len(made) == 1:
            raise RuntimeError("connection reset by peer")
        return Joined()

    res = fit_with_recovery({"trainer": {}}, trainer_factory=factory,
                            max_restarts=1, backoff_s=0.0, device="cpu")
    return res, len(made)
