"""Training, port of ``maest_tpu/train``: the train step (state,
optimizer, schedules, steps), the metrics, the ``Trainer`` loop and its
elastic recovery."""

from .loop import Trainer, compute_norm_stats, model_speed_test, swa_epoch_window
from .metrics import gather_across_hosts, macro_ap_roc
from .resilience import fit_with_recovery, is_recoverable, latest_checkpoint
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
    "Trainer",
    "apply_guarded_update",
    "augment_config",
    "bce_with_logits",
    "compute_norm_stats",
    "cosine_cycle",
    "exp_rampup",
    "exp_warmup_linear_down",
    "fit_with_recovery",
    "gather_across_hosts",
    "is_recoverable",
    "latest_checkpoint",
    "linear_rampdown",
    "macro_ap_roc",
    "make_eval_step",
    "make_optimizer",
    "make_predict_step",
    "make_schedule",
    "make_train_step",
    "model_config",
    "model_speed_test",
    "swa_epoch_window",
    "swa_lr_overlay",
    "swa_update",
]
