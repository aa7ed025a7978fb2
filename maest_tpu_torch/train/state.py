"""Train state: the module, the optimizer and SWA, port of
``maest_tpu/train/state.py``.

The JAX state is pure data (params, opt_state, swa_params pytrees); here
it holds the module, whose parameters the optimizer updates in place, the
``torch.optim`` optimizer, a second set of SWA tensors with a running
equal-weight average (reference: helpers/swa_callback.py:9-44), and the
counters optax keeps: the optimizer's update count, which indexes the
learning-rate schedule, and the gradient accumulator of
``optax.MultiSteps``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Union

import torch
import torch.nn as nn


@dataclass(frozen=True)
class Optimizer:
    """AdamW / Adam matching the reference (reference:
    models/module.py:237-243): betas (0.9, 0.999), eps 1e-8 outside the
    square root, decay on *all* parameters in one group (the reference has
    no parameter groups). The learning rate is ``lr_schedule(count)`` with
    ``count`` the number of updates applied before this one, as optax
    evaluates it. ``accumulate_steps`` > 1: ``optax.MultiSteps``, one
    update with the mean of k micro-batch gradients every k-th step."""

    lr_schedule: Union[float, Callable[[int], float]]
    adamw: bool = True
    weight_decay: float = 1e-4
    accumulate_steps: int = 1

    def lr(self, count: int) -> float:
        s = self.lr_schedule
        return float(s(count)) if callable(s) else float(s)

    def init(self, params) -> torch.optim.Optimizer:
        """The torch optimizer over ``params``. FSDP2's shards (DTensors)
        and plain tensors, which a pipeline stage holds side by side, go
        into two groups of the same settings: the optimizer's multi-tensor
        kernels take one kind a call."""
        from torch.distributed.tensor import DTensor

        cls = torch.optim.AdamW if self.adamw else torch.optim.Adam
        params = list(params)
        kinds = [[p for p in params if isinstance(p, DTensor) == sharded]
                 for sharded in (True, False)]
        return cls([{"params": g} for g in kinds if g], lr=self.lr(0),
                   betas=(0.9, 0.999), eps=1e-8,
                   weight_decay=self.weight_decay if self.adamw else 0.0)


def make_optimizer(*, lr_schedule, adamw: bool = True,
                   weight_decay: float = 1e-4,
                   accumulate_steps: int = 1) -> Optimizer:
    """The optimizer recipe; ``TrainState.create`` builds it on a module's
    parameters."""
    if accumulate_steps < 1:
        raise ValueError(f"accumulate_steps={accumulate_steps} must be >= 1")
    return Optimizer(lr_schedule, adamw, weight_decay, accumulate_steps)


@dataclass
class TrainState:
    """``step``: train steps taken (skipped ones included); ``count``:
    optimizer updates applied; ``accum``/``mini_step``: the MultiSteps
    accumulator (empty when ``accumulate_steps`` is 1); ``swa_params``
    ({} with ``with_swa=False``) and ``swa_n``, the models averaged so
    far."""

    step: int
    model: nn.Module
    tx: Optimizer
    optimizer: torch.optim.Optimizer
    swa_params: dict[str, torch.Tensor]
    swa_n: int = 0
    count: int = 0
    accum: dict[str, torch.Tensor] = field(default_factory=dict)
    mini_step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer,
               with_swa: bool = True, parallel=None) -> "TrainState":
        """``with_swa=False`` keeps no SWA buffer (a full extra copy of the
        parameters otherwise). ``parallel`` (a ``parallel.mesh.Parallel``):
        ``model`` holds the full weights, as on every rank, and is cut to
        this rank's part first (``shard_params``); the optimizer's moments,
        the SWA copies and the accumulator then live on the same shards,
        and ``swa_update`` stays in place on them."""
        if parallel is not None:
            from ..parallel.mesh import shard_params

            shard_params(model, parallel)
        named = dict(model.named_parameters())
        swa = ({k: p.detach().clone() for k, p in named.items()}
               if with_swa else {})
        accum = ({k: torch.zeros_like(p) for k, p in named.items()}
                 if tx.accumulate_steps > 1 else {})
        return cls(step=0, model=model, tx=tx,
                   optimizer=tx.init(named.values()), swa_params=swa,
                   accum=accum)

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


@torch.no_grad()
def swa_update(state: TrainState) -> TrainState:
    """Fold the current parameters into the SWA running mean (call at
    epoch end once past ``swa_epoch_start``)."""
    n = state.swa_n
    for name, p in state.model.named_parameters():
        avg = state.swa_params[name]
        if n == 0:
            avg.copy_(p)
        else:
            avg.add_((p - avg) / (n + 1))
    state.swa_n = n + 1
    return state
