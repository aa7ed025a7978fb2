"""Experiment CLI, port of ``maest_tpu/apps/ex_maest.py`` — the
reference's ``ex_maest.py`` Sacred experiment, on one card.

Usage (Sacred-compatible syntax):

    python -m maest_tpu_torch.apps.ex_maest main with maest_10s_random_weights_pretrain \
        trainer.max_epochs=2 datamodule.base_dir=/data/mels

Commands (reference: ex_maest.py:72-238): main (train), test,
extract_embeddings, extract_logits, model_speed_test, compute_norm_stats,
print_config. Everything runs on the card; ``run(argv, device="cpu")``
runs on the CPU.

Several ranks: ``trainer.devices=N`` (None: every visible card) spawns N
processes, one a card, and joins them; ``main``, ``test``,
``extract_embeddings`` and ``extract_logits`` then run across them
(``trainer.model_parallel``, ``trainer.fsdp``,
``trainer.sequence_parallel``). A torchrun launch (``torchrun
--nproc_per_node N -m maest_tpu_torch.apps.ex_maest ...``) runs one rank
in each process it starts. The ranks join over NCCL when each has a card
of its own, over gloo on CUDA tensors when they share one.
"""

from __future__ import annotations

import json
import logging
import sys

from ..configs import build_experiment_config
from ..parallel.launch import launched
from ..train.loop import Trainer, compute_norm_stats, model_speed_test

_logger = logging.getLogger("ex_maest")

# the commands that run across ranks
RANKED = ("main", "test", "extract_embeddings", "extract_logits")

COMMANDS = (
    "main",
    "test",
    "extract_embeddings",
    "extract_logits",
    "model_speed_test",
    "compute_norm_stats",
    "print_config",
)


def parse_argv(argv: list[str]) -> tuple[str, list[str], list[str]]:
    """``<command> [with preset... key=value...]`` (Sacred CLI shape)."""
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        raise SystemExit(0)
    command = argv[0] if argv[0] in COMMANDS else "main"
    rest = argv[1:] if argv[0] in COMMANDS else argv
    if rest and rest[0] == "with":
        rest = rest[1:]
    presets = [a for a in rest if "=" not in a]
    overrides = [a for a in rest if "=" in a]
    return command, presets, overrides


def _ranks_wanted(cfg: dict, device) -> int:
    """``trainer.devices`` as a rank count (None: every visible card, one
    on the CPU)."""
    import torch

    n = cfg["trainer"].get("devices")
    if n is not None:
        return int(n)
    if str(device).startswith("cuda") and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def _rank_main(rank: int, world: int, argv, device):
    """One spawned rank: ``run``; rank 0's result goes back."""
    res = run(argv, device=device)
    return res if rank == 0 else None


def launch(argv: list[str], n: int, device="cuda",
           timeout: float | None = None) -> dict:
    """Spawn ``n`` ranks of ``run(argv)`` on this host, one a visible card
    (on the CPU: ``n`` processes over gloo), and join them. Returns rank
    0's result. A rank's failure fails the launch with that rank's
    traceback, and the other ranks are killed, as they are after
    ``timeout`` seconds."""
    from ..parallel.launch import spawn_ranks

    return spawn_ranks(_rank_main, n, str(device), argv, str(device),
                       what="trainer.devices", timeout=timeout)[0]


def run(argv: list[str], device="cuda") -> dict:
    command, presets, overrides = parse_argv(argv)
    cfg = build_experiment_config(presets, overrides)

    if command in RANKED and not launched():
        n = _ranks_wanted(cfg, device)
        if n > 1:
            return launch(argv, n, device)

    if command == "print_config":
        print(json.dumps(cfg, indent=2, default=str))
        return cfg

    if command == "model_speed_test":
        st = cfg.get("speed_test", {})
        specs = model_speed_test(
            cfg,
            batch_size=int(st.get("batch_size", 100)),
            test_length=int(st.get("test_length", 100)),
            device=device,
        )
        return {"specs_per_second": specs}

    if command == "compute_norm_stats":
        mean, std = compute_norm_stats(cfg)
        print(f"mean={mean} std={std}")
        return {"mean": mean, "std": std}

    run_info = {
        "command": command, "presets": presets, "overrides": overrides,
    }
    if command == "main" and cfg["trainer"].get("resilient"):
        # restart-from-checkpoint on infrastructure failures; beyond
        # reference scope — see train/resilience.py
        from ..train.resilience import fit_with_recovery

        return fit_with_recovery(
            cfg, trainer_factory=lambda c: Trainer(c, run_info=run_info,
                                                   device=device),
            device=device)

    # defensive dispatch guard BEFORE the Trainer exists: a bad command must
    # never create a run dir whose run.json is stuck at RUNNING forever
    if command not in ("main", "test", "extract_embeddings", "extract_logits"):
        raise SystemExit(f"unknown command {command}")

    if command == "test" and not any(
            o.startswith("module.do_swa=") for o in overrides):
        # the reference test command evaluates ONLY the live net
        # (ex_maest.py:99 forces module.do_swa = False); an explicit
        # module.do_swa=True override still wins for testing SWA weights
        cfg["module"]["do_swa"] = False

    trainer = Trainer(cfg, run_info=run_info, device=device)
    if command == "main":
        return trainer.fit()  # fit finalizes its own run.json
    record = trainer.proc0  # run.json is rank 0's record
    # non-fit commands also own a run dir whose run.json says RUNNING
    # until finalized — a completed `test` must not read as a live run
    from ..utils.run_record import finalize_run_json

    try:
        if command == "test":
            if cfg.get("ckpt_path"):
                trainer.restore_checkpoint(cfg["ckpt_path"])
            res = trainer.test()
        else:  # extract_embeddings / extract_logits
            if cfg.get("ckpt_path"):
                trainer.restore_checkpoint(cfg["ckpt_path"])
            output_name = command.split("_", 1)[1].rstrip("s")
            output_name = {
                "embedding": "embeddings", "logit": "logits"}[output_name]
            res = trainer.predict(output_name=output_name)
    except BaseException as e:
        # same semantics as Trainer.fit (shared classify_exit): Ctrl-C and
        # preemption-shaped SystemExit are INTERRUPTED; sys.exit(1)-style
        # failure exits from library code and Exceptions are FAILED
        from ..utils.run_record import classify_exit
        if record:
            finalize_run_json(trainer.run_dir, classify_exit(e))
        raise
    if record:
        finalize_run_json(trainer.run_dir, "COMPLETED", res)
        print(json.dumps(res, indent=2))
    return res


def main():
    import torch.distributed as dist

    logging.basicConfig(level=logging.INFO)
    try:
        run(sys.argv[1:])
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
