"""Learning-rate schedules, port of ``maest_tpu/train/schedules.py``.

Epoch-indexed multiplier functions matching the reference
(reference: helpers/ramp.py:21-109, 124-137; selected in
models/module.py:213-226), and ``make_schedule``, which turns one into a
callable from the optimizer step to the learning rate. The JAX file
imports optax, so it is ported rather than loaded.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_MAX_EPOCHS = 4096  # the epoch table's length; later epochs take its last row


def exp_rampup(rampup_length: int):
    """Exponential warmup (reference: helpers/ramp.py:21-32)."""

    def f(epoch):
        if epoch < rampup_length:
            e = np.clip(epoch, 0.5, rampup_length)
            phase = 1.0 - e / rampup_length
            return float(np.exp(-5.0 * phase * phase))
        return 1.0

    return f


def linear_rampdown(rampdown_length: int, start: int = 0,
                    last_value: float = 0.0):
    """Linear rampdown after ``start`` (reference: helpers/ramp.py:47-63)."""

    def f(epoch):
        if epoch <= start:
            return 1.0
        if epoch - start < rampdown_length:
            return float(last_value + (1.0 - last_value)
                         * (rampdown_length - epoch + start) / rampdown_length)
        return float(last_value)

    return f


def exp_warmup_linear_down(warmup: int, rampdown_length: int,
                           start_rampdown: int, last_value: float):
    """Warmup * rampdown composition (reference: helpers/ramp.py:102-109)."""
    up = exp_rampup(warmup)
    down = linear_rampdown(rampdown_length, start_rampdown, last_value)

    def f(epoch):
        return up(epoch) * down(epoch)

    return f


def cosine_cycle(cycle_len: int = 20, ramp_down_start: int = 100,
                 last_lr_value: float = 0.01):
    """Cyclic cosine with floor (reference: helpers/ramp.py:124-137)."""
    ramp_down_start = cycle_len + (ramp_down_start - 1) // cycle_len * cycle_len

    def f(epoch):
        # floor division, as the reference: for odd cycle lengths
        # (epoch + len/2) shifts the cosine phase at every epoch
        ep = (epoch + cycle_len // 2.0) / (1.0 * cycle_len)
        if epoch > ramp_down_start:
            return float(last_lr_value)
        return float(last_lr_value + (1.0 - last_lr_value) * 0.5
                     * (np.cos(2.0 * np.pi * ep) + 1))

    return f


def swa_lr_overlay(table: np.ndarray, base_lr: float, lam, *,
                   swa_epoch_start: int, swa_lr: float,
                   anneal_epochs: int = 10) -> np.ndarray:
    """Overwrite ``table`` (LR during each epoch) with Lightning's SWA-phase
    learning rate (torch ``SWALR``) from the SWA swap epoch
    ``swa_epoch_start - 1`` onward: a cosine anneal from the old
    scheduler's last value to ``swa_lr`` over ``anneal_epochs`` epochs,
    then constant (reference: models/module.py:268-273 via
    helpers/swa_callback.py:9-44)."""
    swap = max(int(swa_epoch_start) - 1, 0)
    lr_swap = float(base_lr * lam(swap))
    for e in range(swap, len(table)):
        k = e - swap
        if anneal_epochs <= 0:
            alpha = 1.0  # SWALR clamps the anneal step to >= 1
        else:
            t = min(1.0, k / float(anneal_epochs))
            alpha = (1.0 - np.cos(np.pi * t)) / 2.0
        table[e] = swa_lr * alpha + lr_swap * (1.0 - alpha)
    return table


def make_schedule(
    schedule_mode: str,
    base_lr: float,
    steps_per_epoch: float,
    *,
    warm_up_len: int = 5,
    ramp_down_start: int = 50,
    ramp_down_len: int = 50,
    last_lr_value: float = 0.01,
    do_swa: bool = False,
    swa_epoch_start: int = 50,
    swa_lr: float | None = None,
    swa_anneal_epochs: int = 10,
) -> Callable[[int], float]:
    """``step -> lr``, holding the epoch-wise multiplier constant within an
    epoch (the reference steps LambdaLR once per epoch). ``steps_per_epoch``
    may be fractional (optimizer steps under gradient accumulation). The
    table is float32, as the JAX schedule's."""
    if schedule_mode == "exp_lin":
        lam = exp_warmup_linear_down(warm_up_len, ramp_down_len,
                                     ramp_down_start, last_lr_value)
    elif schedule_mode == "cos_cyc":
        lam = cosine_cycle(warm_up_len, ramp_down_start, last_lr_value)
    elif schedule_mode == "constant":
        if not (do_swa and swa_lr is not None):
            return lambda step: float(base_lr)
        lam = lambda e: 1.0  # noqa: E731 — the table carries the SWA swap
    else:
        raise ValueError(f"schedule_mode={schedule_mode} unknown")

    table = np.array([base_lr * lam(e) for e in range(_MAX_EPOCHS)], np.float32)
    if do_swa and swa_lr is not None:
        table = swa_lr_overlay(
            table, base_lr, lam, swa_epoch_start=swa_epoch_start,
            swa_lr=swa_lr, anneal_epochs=swa_anneal_epochs,
        ).astype(np.float32)

    def schedule(step):
        epoch = min(int(step // steps_per_epoch), _MAX_EPOCHS - 1)
        return float(table[epoch])

    return schedule
