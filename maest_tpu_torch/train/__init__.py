"""The train step of the port: state, optimizer, schedules and steps
(``maest_tpu/train/{state,schedules,steps}.py``)."""

from .schedules import (
    cosine_cycle,
    exp_rampup,
    exp_warmup_linear_down,
    linear_rampdown,
    make_schedule,
    swa_lr_overlay,
)
from .state import Optimizer, TrainState, make_optimizer, swa_update
from .steps import (
    AugmentConfig,
    apply_guarded_update,
    augment_config,
    bce_with_logits,
    make_eval_step,
    make_predict_step,
    make_train_step,
    model_config,
)

__all__ = [
    "AugmentConfig",
    "Optimizer",
    "TrainState",
    "apply_guarded_update",
    "augment_config",
    "bce_with_logits",
    "cosine_cycle",
    "exp_rampup",
    "exp_warmup_linear_down",
    "linear_rampdown",
    "make_eval_step",
    "make_optimizer",
    "make_predict_step",
    "make_schedule",
    "make_train_step",
    "model_config",
    "swa_lr_overlay",
    "swa_update",
]
