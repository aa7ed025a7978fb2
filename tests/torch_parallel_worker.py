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


# -- inference and serving over a mesh ----------------------------------------

def mesh_inference(rank, world, ckpt, geom, inputs, layouts, serve):
    """``get_maest`` on the checkpoint ``ckpt`` at the tiny ``geom`` with a
    ``(data, model)`` mesh of each model-parallel size of ``layouts``, the
    ``inputs`` through it: the forward of a wave and of a rank-3 mel batch,
    a block tap and ``predict_labels``. With ``serve``, a ``TagService`` on
    the first layout's model (rank 0 tags ``inputs["requests"]`` from 4
    threads at once, the other ranks follow), then the server's command
    line with ``--host-mel --devices`` (rank 0 tags the short request).
    Every rank returns what it got."""
    import threading

    from maest_tpu_torch.api import get_maest
    from maest_tpu_torch.apps.serve import build_argparser, make_service
    from maest_tpu_torch.parallel import mesh as pmesh
    from maest_tpu_torch.serve import TagService

    torch.set_num_threads(1)
    pmesh.init_distributed("cpu")
    arch = "discogs-maest-30s-pw-129e"
    out = {}
    for mp in layouts:
        mesh = pmesh.make_mesh(world, mp, "cpu")
        model = get_maest(arch, pretrained=False, checkpoint=ckpt,
                          device="cpu", mesh=mesh, **geom)
        out[mp] = {
            "wave": [t.numpy() for t in model(inputs["wave"])],
            "mel3": [t.numpy() for t in model(inputs["mel3"])],
            "tap": model(inputs["wave"], transformer_block=1)[1].numpy(),
            "acts": model.predict_labels(inputs["wave"])[0],
            "heads": model.net.blocks[0].attn.qkv.weight.shape[0],
        }
        if serve and mp == layouts[0]:
            svc = TagService(model, buckets=(1, 2, 4), max_wait_ms=20.0)
            if svc.follower:
                out["followed"] = svc.follow()
            else:
                reqs = inputs["requests"]
                got = [None] * len(reqs)

                def worker(i):
                    got[i] = svc.tag(reqs[i])[0]

                threads = [threading.Thread(target=worker, args=(i,))
                           for i in range(len(reqs))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                svc.close()
                out["served"] = got
                out["buckets"] = svc.wave_programs.buckets
                out["stats"] = svc.stats()
    if serve:
        args = build_argparser().parse_args([
            "--no-pretrained", "--checkpoint", ckpt, "--device", "cpu",
            "--dtype", "float32", "--embed-dim", str(geom["embed_dim"]),
            "--depth", str(geom["depth"]), "--num-heads",
            str(geom["num_heads"]), "--input-t", str(geom["input_t"]),
            "--n-classes", str(geom["n_classes"]), "--buckets", "1,2",
            "--host-mel", "--devices", str(world)])
        svc = make_service(args)
        assert svc.host_mel and svc.model.mesh is not None
        if svc.follower:
            out["cli_followed"] = svc.follow()
        else:
            out["cli"] = svc.tag(inputs["requests"][-1])[0]
            svc.close()
    return out
