"""Elastic recovery for long pre-training runs, port of
``maest_tpu/train/resilience.py``.

The reference has no failure handling — recovery is a manual re-launch
with ``ckpt_path`` (reference: ex_maest.py:45,90; ex_maest519.sh:6). This
module restarts ``fit`` from the newest epoch checkpoint of the failed
attempt, bounded by ``max_restarts``.

What is restartable on the card: collective and transport failures
(NCCL errors, ``torch.distributed``'s backend, network and store errors,
dropped connections, preemption). What is fatal: programming errors,
``torch.cuda.OutOfMemoryError`` and other deterministic failures, which
would fail the same way on every attempt. A sticky CUDA error (an illegal
address, a launch failure, a device-side assert) is fatal too: it loses
the process's CUDA context, so no attempt inside this process can use the
card again; only a new process can.

Enable from the CLI with ``trainer.resilient=True`` (and optionally
``trainer.max_restarts=N``).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Callable, Optional

_logger = logging.getLogger("maest_tpu_torch.resilience")

# Phrases that mark infrastructure failures (collectives, transport,
# preemption), as opposed to programming errors, which must propagate.
_RECOVERABLE_PHRASES = (
    "nccl",
    "preempt",
    "connection reset",
    "connection refused",
    "failed to connect",
    "socket closed",
    "broken pipe",
)
# torch.distributed's error types for a failed collective or rendezvous
_RECOVERABLE_TYPES = ("DistBackendError", "DistNetworkError", "DistStoreError")
# Deterministic or context-losing failures that re-running in this
# process cannot fix: out of memory, and the sticky CUDA errors.
_FATAL_PHRASES = (
    "out of memory",
    "illegal memory access",
    "illegal address",
    "illegal instruction",
    "launch failure",
    "device-side assert",
    "misaligned address",
)


def is_recoverable(exc: BaseException) -> bool:
    """Infrastructure failure (restartable) vs programming error (fatal)."""
    import torch

    msg = str(exc).lower()
    if isinstance(exc, torch.cuda.OutOfMemoryError) or any(
            p in msg for p in _FATAL_PHRASES):
        return False
    if any(k.__name__ in _RECOVERABLE_TYPES for k in type(exc).__mro__):
        return True
    # only runtime and IO errors get the phrase check: a programming error
    # whose message merely quotes one (ValueError("NCCL ...")) stays fatal
    if not isinstance(exc, (RuntimeError, OSError)):
        return False
    return any(p in msg for p in _RECOVERABLE_PHRASES)


def latest_checkpoint(run_dir) -> Optional[str]:
    """Newest per-epoch checkpoint under ``<run_dir>/checkpoints`` (falls
    back to ``best``). Returns None when nothing was saved yet."""
    ckpt_dir = Path(run_dir) / "checkpoints"
    if not ckpt_dir.is_dir():
        return None
    best_epoch, best_path = -1, None
    for p in ckpt_dir.iterdir():
        if not p.is_dir() or not p.name.startswith("epoch-"):
            continue
        meta = ckpt_dir / f"{p.name}.meta.json"
        if not meta.exists():
            continue  # interrupted save
        try:
            epoch = json.loads(meta.read_text()).get("epoch", -1)
        except (json.JSONDecodeError, OSError):
            # a corrupt marker (pre-atomic-write saves, disk truncation)
            # means "unusable checkpoint", not "abort recovery forever"
            continue
        if epoch > best_epoch:
            best_epoch, best_path = epoch, p
    if best_path is None and (ckpt_dir / "best").is_dir():
        best_path = ckpt_dir / "best"
    return str(best_path) if best_path else None


def _reinit_distributed(device="cuda") -> None:
    """Tear down and re-form the process group so a restarted attempt can
    build its mesh again (a no-op for one process); ``device``: the
    ranks' device type. The new group meets on the old group's store,
    kept alive across the teardown, under a prefix of its own: a new store
    on the same port would race the old one's closing (a rank joining
    early reaches the old store and waits there, or finds it closed)."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return
    store = dist.distributed_c10d._get_default_store()
    rank = dist.get_rank()
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — already torn down by the failure
        pass
    # every rank re-forms the group as often, so its own count names it
    n = store.add(f"maest_rejoin/{rank}", 1)
    init_distributed(device, store=dist.PrefixStore(f"maest_rejoin{n}",
                                                    store))


def fit_with_recovery(
    cfg: dict,
    *,
    trainer_factory: Optional[Callable[[dict], object]] = None,
    max_restarts: Optional[int] = None,
    backoff_s: float = 10.0,
    device="cuda",
) -> dict:
    """``Trainer(cfg, device=device).fit()`` with automatic
    restart-from-checkpoint.

    Each attempt builds a fresh Trainer (new run dir); on a recoverable
    failure the next attempt resumes from the failed run's newest epoch
    checkpoint via ``ckpt_path``, after the process group (if any) is
    formed again on ``device``'s type. Non-recoverable exceptions and
    restart exhaustion propagate.
    """
    import torch

    if trainer_factory is None:
        from .loop import Trainer

        def trainer_factory(c):
            return Trainer(c, device=device)

    if max_restarts is None:
        max_restarts = int(cfg["trainer"].get("max_restarts", 3))

    cfg = dict(cfg)
    restarts = 0
    device_type = torch.device(device).type
    while True:
        trainer = None
        try:
            # construction also does device work (the model's copy to the
            # card) and must be retryable — right after a preemption the
            # device may still be down when the next attempt starts
            trainer = trainer_factory(cfg)
            result = trainer.fit()
            if restarts:
                result = dict(result, restarts=restarts)
            return result
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_recoverable(e) or restarts >= max_restarts:
                raise
            restarts += 1
            # on a construction failure keep resuming from the previous
            # attempt's checkpoint (already in cfg["ckpt_path"])
            if trainer is not None:
                try:
                    # async saves: let the in-flight commit land (atomic
                    # tmp-dir rename) before scanning for the newest
                    # checkpoint
                    trainer.finalize_checkpoints()
                except Exception:  # the device may be gone entirely
                    pass
            ckpt = latest_checkpoint(trainer.run_dir) if trainer else None
            _logger.warning(
                "recoverable failure (%s: %s); restart %d/%d from %s",
                type(e).__name__, str(e)[:200], restarts, max_restarts,
                ckpt or cfg.get("ckpt_path") or "scratch",
            )
            if ckpt:
                cfg["ckpt_path"] = ckpt
            time.sleep(backoff_s)
            _reinit_distributed(device_type)
