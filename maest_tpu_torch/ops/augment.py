"""Batch augmentation of the train step, port of ``maest_tpu/ops/augment.py``.

Mixup (reference: helpers/mixup.py:5-12, models/module.py:77-86),
SpecAugment masking with torchaudio's mask statistics (reference:
helpers/spec_masking.py:4-33) and the circular time roll (reference:
discogs/datamodule.py:111-124), applied to a device batch in plain
PyTorch. Each function's random draws are separate from their
application: ``*_draws`` take a CPU ``torch.Generator`` (None: torch's
default one) and return small host tensors; the ``apply_*`` functions are
deterministic. The combined functions draw, then apply.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _gamma(shape: float, n: int, generator) -> torch.Tensor:
    """Gamma(shape, 1) samples, float64, by Marsaglia and Tsang's method
    (shape < 1 through Gamma(shape + 1) * U^(1/shape))."""
    boost = shape < 1.0
    a = shape + 1.0 if boost else shape
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, dtype=torch.float64)
    todo = torch.arange(n)
    while todo.numel():
        m = todo.numel()
        x = torch.randn(m, dtype=torch.float64, generator=generator)
        u = torch.rand(m, dtype=torch.float64, generator=generator)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if boost:
        u = torch.rand(n, dtype=torch.float64, generator=generator)
        out = out * u ** (1.0 / shape)
    return out


def mixup_draws(b: int, alpha: float, generator: Optional[torch.Generator]):
    """One pairing permutation (B,) and the per-sample weights (B,)
    lambda ~ Beta(alpha, alpha), folded to max(lambda, 1 - lambda)."""
    perm = torch.randperm(b, generator=generator)
    g1 = _gamma(alpha, b, generator)
    g2 = _gamma(alpha, b, generator)
    lam = (g1 / (g1 + g2)).float()
    return perm, torch.maximum(lam, 1.0 - lam)


def apply_mixup(x: torch.Tensor, targets: tuple, perm: torch.Tensor,
                lam: torch.Tensor):
    """x * lam + x[perm] * (1 - lam), and the same for each target (B, C)."""
    b = x.shape[0]
    perm = perm.to(x.device)
    lam_x = lam.to(x.device, x.dtype).reshape((b,) + (1,) * (x.ndim - 1))
    x = x * lam_x + x[perm] * (1.0 - lam_x)
    mixed = tuple(
        t * lam.to(t.device, t.dtype).reshape(b, 1)
        + t[perm] * (1.0 - lam.to(t.device).reshape(b, 1)).to(t.dtype)
        for t in targets)
    return x, mixed


def mixup(x: torch.Tensor, targets: tuple, alpha: float,
          generator: Optional[torch.Generator] = None):
    """Batch mixup with max(lambda, 1 - lambda) Beta weights; alpha <= 0
    disables it. Returns (mixed_x, tuple_of_mixed_targets)."""
    if alpha <= 0:
        return x, targets
    return apply_mixup(x, targets, *mixup_draws(x.shape[0], alpha, generator))


def axis_mask_draws(b: int, n_masks: int, iid: bool = True,
                    generator: Optional[torch.Generator] = None):
    """The uniforms of ``n_masks`` masks: (width draws, start draws), each
    (n_masks, B), or (n_masks, 1) with ``iid=False`` (one mask shared by
    the batch)."""
    b = b if iid else 1
    u_w = torch.rand((n_masks, b), generator=generator)
    u_s = torch.rand((n_masks, b), generator=generator)
    return u_w, u_s


def axis_keep_mask(u_w: torch.Tensor, u_s: torch.Tensor, axis_len: int,
                   max_width: int, p: float) -> torch.Tensor:
    """Boolean keep-mask (B, axis_len) of the masks drawn by ``u_w``/``u_s``.

    torchaudio semantics: width ~ U[0, W), additionally capped at
    p * axis_len for time masks; start ~ U[0, L - width]. fp32 arithmetic,
    as the JAX package's ``_axis_masks``."""
    cap = float(math.floor(p * axis_len)) if p < 1.0 else float(axis_len)
    widths = torch.floor(u_w.float() * min(float(max_width), cap))
    starts = torch.floor(u_s.float() * (axis_len - widths))
    pos = torch.arange(axis_len, device=u_w.device)[None, None, :]
    masked = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return ~masked.any(dim=0)


def spec_augment_draws(b: int, *, time_masks: int = 20, freq_masks: int = 8,
                       iid_masks: bool = True,
                       generator: Optional[torch.Generator] = None):
    """(time draws, freq draws) for ``apply_spec_augment``."""
    return (axis_mask_draws(b, time_masks, iid_masks, generator),
            axis_mask_draws(b, freq_masks, iid_masks, generator))


def apply_spec_augment(x: torch.Tensor, draws, *, time_mask_param: int = 8,
                       freq_mask_param: int = 5, p: float = 0.2,
                       mask_value: float = 0.0) -> torch.Tensor:
    """Mask a (B, F, T) or (B, C, F, T) batch with the masks of ``draws``."""
    (tw, ts), (fw, fs) = draws
    f, t = x.shape[-2:]
    keep_t = axis_keep_mask(tw.to(x.device), ts.to(x.device), t,
                            time_mask_param, p)
    keep_f = axis_keep_mask(fw.to(x.device), fs.to(x.device), f,
                            freq_mask_param, 1.0)
    keep = keep_f[:, :, None] & keep_t[:, None, :]  # (B or 1, F, T)
    if x.ndim == 4:
        keep = keep[:, None]
    return torch.where(keep, x, torch.as_tensor(mask_value, dtype=x.dtype,
                                                device=x.device))


def spec_augment(x: torch.Tensor, *, time_mask_param: int = 8,
                 freq_mask_param: int = 5, p: float = 0.2,
                 time_masks: int = 20, freq_masks: int = 8,
                 mask_value: float = 0.0, iid_masks: bool = True,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SpecAugment with torchaudio-equivalent mask statistics (defaults
    from the reference datamodule, discogs/datamodule.py:55-63)."""
    draws = spec_augment_draws(x.shape[0], time_masks=time_masks,
                               freq_masks=freq_masks, iid_masks=iid_masks,
                               generator=generator)
    return apply_spec_augment(x, draws, time_mask_param=time_mask_param,
                              freq_mask_param=freq_mask_param, p=p,
                              mask_value=mask_value)


def roll_augment(x: torch.Tensor, shift_range: int, axis: int = -1,
                 shift: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Circular shift along the time axis: a fixed ``shift`` when given,
    otherwise uniform in [-shift_range, shift_range]."""
    if shift is None:
        shift = int(torch.randint(-shift_range, shift_range + 1, (),
                                  generator=generator))
    return torch.roll(x, shift, dims=axis)
