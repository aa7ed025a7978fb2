"""Train / eval / predict steps, port of ``maest_tpu/train/steps.py``.

One eager step per call: normalization, SpecAugment, mixup, the forward
and backward pass (the attention kernels K3a and K3b on the card), the
NaN-guarded optimizer update. Random draws come from an explicit CPU
``torch.Generator`` (reference: models/module.py:73-102,
discogs/datamodule.py:126-152).

Across ranks (``parallel``, a ``parallel.mesh.Parallel``) a step runs on
this rank's rows of the global batch (under a pipeline every stage of a
data rank runs on the same rows): every draw is made for the global
batch, exactly as one process makes it, and the rank keeps its rows;
mixup pairs rows across ranks, so the prepared batch and targets are
gathered over the data ranks before mixing. Each rank's loss is the mean
over its rows and the gradients are averaged over the data ranks (FSDP2
reduce-scatters them), so the update is the global batch's; the reported
loss is the global mean and the NaN guard's verdict is the worst over
every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from ..dsp import NORM_MEAN, NORM_STD
from ..models.config import MAESTConfig
from ..models.registry import build_config
from ..models.vit import TrainDraws
from ..ops.augment import (
    apply_mixup,
    apply_spec_augment,
    mixup_draws,
    roll_augment,
    spec_augment_draws,
)
from ..parallel import mesh as pmesh
from ..parallel.tensor_parallel import all_gather_dim
from .state import TrainState


@dataclass(frozen=True)
class AugmentConfig:
    """Defaults mirror the reference datamodule config
    (reference: discogs/datamodule.py:42-63) and mixup alpha
    (models/module.py:29)."""

    normalize: bool = True
    norm_mean: float = NORM_MEAN
    norm_std: float = NORM_STD
    masking: bool = True
    time_mask_param: int = 8
    freq_mask_param: int = 5
    mask_p: float = 0.2
    time_masks: int = 20
    freq_masks: int = 8
    iid_masks: bool = True
    mixup_alpha: float = 0.3
    # roll augmentation (off by default, reference: discogs/datamodule.py:43,111-124)
    roll: bool = False
    roll_axis: int = -1
    roll_shift_range: int = 50
    roll_shift: Optional[int] = None  # fixed shift overrides the random range


def augment_config(cfg: dict) -> AugmentConfig:
    """The experiment config's augmentation settings (as
    ``maest_tpu/train/loop.py::_augment_config``)."""
    dm = cfg["datamodule"]
    return AugmentConfig(
        normalize=dm["norm"]["do"],
        norm_mean=dm["norm"]["norm_mean"],
        norm_std=dm["norm"]["norm_std"],
        masking=dm["masking"]["do"],
        time_mask_param=dm["masking"]["time_mask_param"],
        freq_mask_param=dm["masking"]["freq_mask_param"],
        mask_p=dm["masking"]["p"],
        time_masks=dm["masking"]["time_masks"],
        freq_masks=dm["masking"]["freq_masks"],
        iid_masks=dm["masking"]["iid_masks"],
        mixup_alpha=cfg["module"]["mixup_alpha"],
        roll=dm["roll"]["do"],
        roll_axis=dm["roll"]["axis"],
        roll_shift_range=dm["roll"]["shift_range"],
        roll_shift=dm["roll"]["shift"],
    )


def model_config(cfg: dict) -> MAESTConfig:
    """The model configuration of an experiment config, with the keys
    ``maest_tpu/train/loop.py::_build_model`` hands to ``get_maest``."""
    m = cfg["maest"]
    return build_config(
        m["arch"], n_classes=m["n_classes"], in_channels=m["in_channels"],
        stride_f=m["stride_f"], stride_t=m["stride_t"], input_f=m["input_f"],
        input_t=m["input_t"], u_patchout=m["u_patchout"],
        s_patchout_t=m["s_patchout_t"], s_patchout_f=m["s_patchout_f"],
        s_patchout_f_indices=tuple(m["s_patchout_f_indices"]),
        s_patchout_f_interleaved=m["s_patchout_f_interleaved"],
        s_patchout_t_indices=tuple(m["s_patchout_t_indices"]),
        s_patchout_t_interleaved=m["s_patchout_t_interleaved"],
        distilled_type=m["distilled_type"],
        embed_dim=m.get("embed_dim", 768), depth=m.get("depth", 12),
        num_heads=m.get("num_heads", 12), remat=m.get("remat", False),
        remat_policy=m.get("remat_policy", "full"),
        attention_quant=m.get("attention_quant", "none"),
        attention_bwd_quant=m.get("attention_bwd_quant", "none"),
    )


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits, in fp32."""
    logits = logits.float()
    targets = targets.float()
    return torch.mean(logits.clamp_min(0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def _prepare(x: torch.Tensor, aug: AugmentConfig,
             generator: Optional[torch.Generator], train: bool,
             rows: Optional[tuple] = None) -> torch.Tensor:
    """Normalize (+ roll / SpecAugment when training) a (B, F, T) mel batch
    and return (B, 1, F, T). ``rows`` (start, full): the batch is rows
    [start, start + B) of a global batch of ``full``, whose masks are
    drawn (default: the whole batch)."""
    x = x.float()
    if aug.normalize:
        x = (x - aug.norm_mean) / (aug.norm_std * 2.0)
    if train and aug.roll:  # one shift for the batch
        x = roll_augment(x, aug.roll_shift_range, axis=aug.roll_axis,
                         shift=aug.roll_shift, generator=generator)
    if train and aug.masking:
        b = x.shape[0]
        start, full = rows or (0, b)
        draws = spec_augment_draws(full, time_masks=aug.time_masks,
                                   freq_masks=aug.freq_masks,
                                   iid_masks=aug.iid_masks,
                                   generator=generator)
        if aug.iid_masks:
            draws = tuple(tuple(u[:, start:start + b] for u in pair)
                          for pair in draws)
        x = apply_spec_augment(x, draws, time_mask_param=aug.time_mask_param,
                               freq_mask_param=aug.freq_mask_param,
                               p=aug.mask_p)
    return x[:, None]


def _mixup_rows(x: torch.Tensor, targets: tuple, alpha: float,
                generator: Optional[torch.Generator], rows: tuple,
                group=None):
    """Mixup of rows [start, start + B) of a global batch of ``full``
    (``rows``): the pairing and weights are drawn for the global batch;
    with ``group`` (the data ranks) the rows paired with are gathered from
    the other ranks first."""
    if alpha <= 0:
        return x, targets
    start, full = rows
    b = x.shape[0]
    perm, lam = mixup_draws(full, alpha, generator)
    if group is not None:
        x = all_gather_dim(x, 0, group)
        targets = tuple(all_gather_dim(t, 0, group) for t in targets)
    x, targets = apply_mixup(x, targets, perm, lam)
    return x[start:start + b], tuple(t[start:start + b] for t in targets)


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_train_step(net: nn.Module, tx, aug: AugmentConfig = AugmentConfig(),
                    *, teacher_student: bool = False, parallel=None,
                    apply_fn=None):
    """Build the train step ``step(state, batch, generator=None,
    draws=None) -> (state, metrics)``.

    ``batch``: ``x`` (B, F, T) raw log-mel, ``y`` (B, C) [and ``y_teacher``
    (B, C) for teacher-student]; with ``parallel`` (the rank's
    ``Parallel``; None: one process) this rank's rows of the global
    batch. Loss is BCE, or the mean of the student
    and teacher BCE for the teacher-student variant (reference:
    models/module.py:73-102, 280-316). The step runs ``state.model`` (the
    module the state was created from, ``net``), updates it in place and
    returns the state. ``generator``: the CPU generator of the step's
    draws; ``draws``: the model's train draws, handed in instead of drawn.
    ``metrics`` holds Python floats.

    ``apply_fn(model, x, generator, draws) -> the net's output`` takes the
    place of the model's train forward: the pipelined step
    (``parallel.pipeline.make_pipeline_train_step``) passes its schedule
    here and shares the rest of the step."""
    if teacher_student and net.cfg.distilled_type != "separated":
        raise ValueError("teacher-student training needs distilled_type "
                         "'separated' (two heads)")
    if apply_fn is None:
        def apply_fn(model, x, generator, draws):
            return model(x, train=True, generator=generator, draws=draws)

    def step(state: TrainState, batch, generator=None,
             draws: Optional[TrainDraws] = None):
        model = state.model
        dev = _device(model)
        x = torch.as_tensor(batch["x"], device=dev)
        targets = tuple(torch.as_tensor(batch[k], device=dev) for k in
                        (("y", "y_teacher") if teacher_student else ("y",)))
        b, group = x.shape[0], None
        rows = (0, b)
        if parallel is not None:
            rows = (parallel.data_rank * b, parallel.data * b)
            group = parallel.data_group if parallel.data > 1 else None
        x = _prepare(x, aug, generator, train=True, rows=rows)
        x, targets = _mixup_rows(x, targets, aug.mixup_alpha, generator, rows,
                                 group)

        state.optimizer.zero_grad(set_to_none=True)
        out = apply_fn(model, x, generator, draws)
        if teacher_student:
            loss_standard = bce_with_logits(out[0], targets[0])
            loss_teacher = bce_with_logits(out[1], targets[1])
            loss = (loss_standard + loss_teacher) / 2
            parts = [loss, loss_standard, loss_teacher]
            names = ["train_loss", "train_loss_standard", "train_loss_teacher"]
        else:
            loss = bce_with_logits(out[0], targets[0])
            parts, names = [loss], ["train_loss"]
        loss.backward()
        if parallel is not None:
            sync_grads(model, parallel)
        return apply_guarded_update(state, parts, names, parallel)

    return step


def _all_reduce_flat(tensors, group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat buffer."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    if not tensors:
        return
    flat = _flatten_dense_tensors(tensors)
    torch.distributed.all_reduce(flat, group=group)
    for t, f in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(f)


@torch.no_grad()
def sync_grads(model: nn.Module, par) -> None:
    """Make this rank's gradients the global batch's: under a pipeline,
    the embeddings' and heads' from the stages that computed them
    (``pipeline.sync_stage_grads``); averaged over the data ranks (FSDP2
    has reduce-scattered its shards' already); under sequence parallelism
    the parameters that act on token shards (the blocks' LayerNorms and
    the biases after proj and fc2) summed over the model ranks as
    well."""
    if par.pipe > 1:
        from ..parallel.pipeline import sync_stage_grads

        sync_stage_grads(model, par)
    named = [(k, p) for k, p in model.named_parameters() if p.grad is not None]
    grads = [p.grad for _, p in named if not pmesh.is_sharded(p)]
    if par.data > 1 and grads:
        _all_reduce_flat(grads, par.data_group)
        for g in grads:
            g.div_(par.data)
    if par.sequence_parallel:
        _all_reduce_flat([pmesh.local(p.grad) for k, p in named
                          if pmesh.acts_on_token_shards(k)], par.model_group)


@torch.no_grad()
def apply_guarded_update(state: TrainState, parts, names, parallel=None):
    """Optimizer update with the NaN guard (beyond the reference, which has
    no failure detection): a non-finite loss or gradient leaves the
    parameters, the optimizer state and the accumulator as they were; the
    step counter still advances and ``nonfinite_skipped`` is 1. One host
    sync a step reads the loss and the guard together. Across ranks
    (``parallel``) the losses are averaged over the data ranks and the
    guard reads the worst value of every rank's gradient shards, so every
    rank reaches the same verdict."""
    params = [p for p in state.model.parameters() if p.grad is not None]
    grads = [g for g in (pmesh.local(p.grad) for p in params) if g.numel()]
    worst = torch.stack([*torch._foreach_norm(grads, float("inf")),
                         parts[0].detach().abs()]).max()
    if parallel is None:
        values = torch.stack([p.detach() for p in parts] + [worst]).tolist()
    else:
        dist = torch.distributed
        losses = torch.stack([p.detach().float() for p in parts])
        dist.all_reduce(losses, group=parallel.data_group)
        worst = worst.float().reshape(1)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        values = (losses / parallel.data).tolist() + worst.tolist()
    ok = math.isfinite(values[-1])
    if ok:
        k = state.tx.accumulate_steps
        if k > 1:
            n = state.mini_step
            live = [(p, state.accum[name])
                    for name, p in state.model.named_parameters()
                    if p.grad is not None]
            for p, acc in live:
                acc.mul_(n).add_(p.grad).div_(n + 1)  # the mean of the k grads
            state.mini_step = (n + 1) % k
            if state.mini_step == 0:
                for p, acc in live:
                    p.grad.copy_(acc)
                    acc.zero_()
                _optimizer_update(state)
        else:
            _optimizer_update(state)
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    metrics = dict(zip(names, values[:-1]))
    metrics["nonfinite_skipped"] = 0.0 if ok else 1.0
    return state, metrics


def _optimizer_update(state: TrainState):
    lr = state.tx.lr(state.count)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.count += 1


def make_eval_step(net: nn.Module, aug: AugmentConfig = AugmentConfig(), *,
                   with_swa: bool = True, apply_fn=None):
    """``step(state, x) -> {"": logits, "swa": logits}``: logits (fp32) of
    the live and the SWA weights in one call (reference:
    models/module.py:121-146); losses are taken from them on the host.
    FSDP2 gathers a module's own parameters in its forward, so under FSDP
    the SWA shards are copied into the parameters for that forward and
    back. ``apply_fn(model, x) -> the net's output`` takes the place of
    the model's forward (the pipelined eval; the SWA weights are then
    copied in for it too)."""

    @torch.no_grad()
    def step(state: TrainState, x):
        model = state.model
        x = _prepare(torch.as_tensor(x, device=_device(model)), aug, None,
                     train=False)
        if apply_fn is not None:
            out = {"": apply_fn(model, x)[0].float()}
            if with_swa:
                with pmesh.swapped_params(model, state.swa_params):
                    out["swa"] = apply_fn(model, x)[0].float()
            return out
        out = {"": model(x)[0].float()}
        if with_swa:
            if pmesh.is_fsdp(model):
                with pmesh.swapped_params(model, state.swa_params):
                    out["swa"] = model(x)[0].float()
            else:
                out["swa"] = functional_call(model, state.swa_params,
                                             (x,))[0].float()
        return out

    return step


def make_predict_step(net: nn.Module, aug: AugmentConfig = AugmentConfig()):
    """``step(params, batch, transformer_block) -> {"logits", "embeddings"}``:
    logits and the block-k embedding of one forward (reference:
    models/module.py:104-112); ``params`` maps parameter names to tensors,
    e.g. ``state.params`` or ``state.swa_params``."""

    @torch.no_grad()
    def step(params, batch, transformer_block: int):
        x = _prepare(torch.as_tensor(batch["x"], device=_device(net)), aug,
                     None, train=False)
        out = functional_call(net, dict(params), (x,),
                              {"tap_block": transformer_block})
        return {"logits": out[0], "embeddings": out[-1]}

    return step
