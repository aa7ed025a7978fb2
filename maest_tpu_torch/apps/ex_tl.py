"""Downstream transfer-learning probe, port of ``maest_tpu/apps/ex_tl.py``
(the reference's ``ex_tl.py`` rebuilt).

Trains a 2-layer MLP on pre-extracted MAEST embeddings and reports macro
AP/ROC on the test split using the best-val-ROC weights (reference:
ex_tl.py:71-377). The probe is an ``nn.Module`` trained by
``torch.optim.AdamW`` on ``device`` (the card unless asked otherwise), its
learning rate set each step from the JAX package's schedules.

Usage:
    python -m maest_tpu_torch.apps.ex_tl with target_mtt_tl \\
        data.base_dir=outputs/embeddings/mtt/30sec/7/ \\
        data.metadata_dir=datasets/mtt/ [--device cuda|cpu]
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.dataset import load_groundtruth
from ..train.metrics import macro_ap_roc
from ..train.schedules import exp_warmup_linear_down
from ..train.steps import bce_with_logits

_logger = logging.getLogger("ex_tl")


def default_config() -> dict:
    """Reference defaults (reference: ex_tl.py:26-64)."""
    max_epochs = 60
    return {
        "max_epochs": max_epochs,
        "seed": 0,
        # "" disables run-record output (hermetic library calls); main()
        # switches the CLI default to "exp_logs", mirroring the
        # reference's FileStorageObserver("exp_logs") (reference:
        # ex_tl.py:22)
        "exp_dir": "",
        "trainer": {"max_epochs": max_epochs},
        "optimizer": {
            "monitor": "val_roc",
            "weight_decay": 1e-3,
            "scheduler": "exp_warmup_linear_down",
            "max_lr": 1e-4,
            "max_lr_epochs": 10,
            "max_epochs": max_epochs,
            "base_lr": 1e-7,
            "warmup_epochs": 10,
            "gamma": 0.5,
        },
        "model": {"drop_out": 0.5, "hidden_units": 512},
        "data": {
            "base_dir": "embeddings/mtt/30sec/no_swa/10/",
            "metadata_dir": "mtt/",
            "batch_size": 128,
            "num_workers": 16,
            "types": "c",
            "reduce": "mean",
            "token_size": 768,
            "n_classes": 50,
        },
    }


PRESETS = {
    "target_mtt_tl": {
        "data": {
            "metadata_dir": "datasets/mtt/",
            "base_dir": "outputs/embeddings/mtt/30sec/7/",
        },
    },
}


class ProbeMLP(nn.Module):
    """Linear-ReLU-Dropout-Linear probe (reference: ex_tl.py:82-87), with
    flax ``Dense``'s initialization: lecun-normal kernels (truncated
    normal), zero biases."""

    def __init__(self, in_features: int, hidden_units: int, n_classes: int,
                 drop_out: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_units)
        self.fc2 = nn.Linear(hidden_units, n_classes)
        self.drop_out = drop_out
        with torch.no_grad():
            for lin in (self.fc1, self.fc2):
                std = lin.in_features ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                nn.init.zeros_(lin.bias)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator``: train mode, the dropout mask drawn from it (a CPU
        generator, so a run on the card draws the CPU run's masks)."""
        x = F.relu(self.fc1(x))
        if generator is not None and self.drop_out > 0.0:
            keep = 1.0 - self.drop_out
            mask = torch.empty(x.shape).bernoulli_(keep, generator=generator)
            x = x * mask.to(x.device, x.dtype) / keep
        return self.fc2(x)


def postprocess_embedding(emb: np.ndarray, types: str, reduce: str,
                          token_size: int = 768) -> np.ndarray:
    """Chunk-mean + CLS/DIST/token part selection
    (reference: ex_tl.py:255-274).

    ``token_size`` is the single-part width: an embedding of exactly that
    size is already reduced and passes through. The reference hardcodes
    768 here (ex_tl.py:260); keying on ``data.token_size`` is the same for
    every released (ViT-B) arch and right for other widths."""
    if emb.ndim == 2:
        emb = emb.mean(axis=0)
    if emb.shape[-1] == token_size:
        return emb
    if emb.shape[-1] != 3 * token_size:
        # e.g. a 2E=1536 non-distilled block embedding is divisible by 3
        # and would silently split into garbage c/d/t parts
        raise ValueError(
            f"embedding width {emb.shape[-1]} is neither token_size "
            f"({token_size}) nor 3*token_size ({3 * token_size}); "
            "set data.token_size to match the backbone")
    emb = emb.reshape(3, -1)
    parts = {"c": emb[0], "d": emb[1], "t": emb[2]}
    chosen = [v for k, v in parts.items() if k in types]
    if reduce == "mean":
        return np.mean(np.array(chosen), axis=0)
    if reduce == "stack":
        return np.hstack(chosen)
    raise ValueError(f"unknown reduce {reduce!r}")


class EmbeddingDataset:
    """(embedding, target) pairs from .embeddings.npy files
    (reference: ex_tl.py:226-274)."""

    def __init__(self, groundtruth_file, base_dir, types: str, reduce: str,
                 token_size: int = 768):
        self.base_dir = Path(base_dir)
        self.groundtruth = load_groundtruth(groundtruth_file)
        self.filenames = list(self.groundtruth.keys())
        self.types = types
        self.reduce = reduce
        self.token_size = token_size

    def __len__(self):
        return len(self.filenames)

    def load_all(self) -> tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        for f in self.filenames:
            emb = np.load(self.base_dir / (str(f) + ".embeddings.npy"))
            xs.append(postprocess_embedding(emb, self.types, self.reduce,
                                            self.token_size))
            ys.append(np.asarray(self.groundtruth[f], dtype="float32"))
        return np.stack(xs).astype("float32"), np.stack(ys)


def _make_scheduler(opt: dict, steps_per_epoch: int):
    """step -> learning rate, the JAX package's schedules value for value
    (float32 tables indexed by epoch; triangular2 in float32)."""
    mode = opt["scheduler"]
    if mode == "exp_warmup_linear_down":
        lam = exp_warmup_linear_down(
            opt["warmup_epochs"],
            opt["max_epochs"] - opt["max_lr_epochs"],
            opt["max_lr_epochs"],
            opt["base_lr"],
        )
    elif mode == "exponential":
        def lam(e):
            warm = ((e + 1e-7) / opt["warmup_epochs"]
                    if e < opt["warmup_epochs"] else 1.0)
            return warm * opt["gamma"] ** e
    elif mode == "cyclic":
        # triangular2, step_size_up=145 steps (reference: ex_tl.py:160-174)
        return _triangular2(opt["base_lr"], opt["max_lr"], 145)
    else:
        raise ValueError(f"unknown scheduler {mode}")
    table = np.array([opt["max_lr"] * lam(e)
                      for e in range(opt["max_epochs"] + 1)], np.float32)

    def sched(step):
        return table[min(step // steps_per_epoch, len(table) - 1)]

    return sched


def _triangular2(base_lr: float, max_lr: float, step_size: int):
    f32 = np.float32

    def sched(step):
        s = f32(step)
        cycle = np.floor(f32(1) + s / f32(2 * step_size))
        x = np.abs(s / f32(step_size) - f32(2) * cycle + f32(1))
        scale = f32(1.0) / (f32(2.0) ** (cycle - f32(1)))
        return (f32(base_lr) + f32(max_lr - base_lr)
                * np.maximum(f32(0.0), f32(1) - x) * scale)

    return sched


def tl_pipeline(cfg: Optional[dict] = None, device="cuda") -> dict:
    """Fit the probe + test with the best weights (reference:
    ex_tl.py:360-377) on ``device``."""
    cfg = cfg or default_config()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch finds no CUDA "
                           "device")
    data_cfg = cfg["data"]
    meta = Path(data_cfg["metadata_dir"])
    types, reduce = data_cfg["types"], data_cfg["reduce"]

    in_features = (
        data_cfg["token_size"] * len(types) if reduce == "stack"
        else data_cfg["token_size"]
    )

    def split(name):
        return EmbeddingDataset(
            meta / f"groundtruth-{name}.pk", data_cfg["base_dir"], types,
            reduce, token_size=data_cfg["token_size"],
        ).load_all()

    run_dir = None
    metrics_log = None
    if cfg.get("exp_dir"):
        import json
        import time

        from ..utils.run_record import MetricsLog, write_run_json

        run_dir = Path(cfg["exp_dir"]) / time.strftime("%y%m%d-%H%M%S")
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "config.json").write_text(
            json.dumps(cfg, indent=2, default=str))
        write_run_json(run_dir, cfg, {"command": "tl_pipeline"})
        metrics_log = MetricsLog(run_dir / "metrics.jsonl")

    try:
        x_train, y_train = split("train")
        x_val, y_val = split("validation")
        x_test, y_test = split("test")

        seed = cfg.get("seed", 0)
        model = ProbeMLP(in_features, cfg["model"]["hidden_units"],
                         data_cfg["n_classes"], cfg["model"]["drop_out"],
                         generator=torch.Generator().manual_seed(seed)
                         ).to(device)
        bs = data_cfg["batch_size"]
        steps_per_epoch = max(1, len(x_train) // bs)
        sched = _make_scheduler(cfg["optimizer"], steps_per_epoch)
        opt = torch.optim.AdamW(model.parameters(), lr=float(sched(0)),
                                weight_decay=cfg["optimizer"]["weight_decay"])
        dropout_gen = torch.Generator().manual_seed(seed)

        def evaluate(x, y):
            model.eval()
            with torch.inference_mode():
                y_hat = torch.sigmoid(model(torch.from_numpy(x).to(device)))
            model.train()
            return macro_ap_roc(y, y_hat.float().cpu().numpy())

        best = {"val_roc": -1.0, "params": None}
        data_rng = np.random.default_rng(seed)
        max_epochs = cfg["trainer"]["max_epochs"]
        step = 0
        for epoch in range(max_epochs):
            order = data_rng.permutation(len(x_train))
            for i in range(steps_per_epoch):
                idx = order[i * bs: (i + 1) * bs]
                for group in opt.param_groups:
                    group["lr"] = float(sched(step))
                x = torch.from_numpy(x_train[idx]).to(device)
                y = torch.from_numpy(y_train[idx]).to(device)
                loss = bce_with_logits(model(x, dropout_gen), y)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                step += 1
            loss = float(loss.detach())
            val_ap, val_roc = evaluate(x_val, y_val)
            _logger.info("epoch %d loss=%.4f val_ap=%.4f val_roc=%.4f",
                         epoch, loss, val_ap, val_roc)
            if metrics_log is not None:
                for name, value in (("train_loss", loss),
                                    ("val_ap", val_ap), ("val_roc", val_roc)):
                    metrics_log.log(name, value, epoch)
            if val_roc > best["val_roc"]:
                best = {"val_roc": val_roc, "params": {
                    k: v.detach().clone() for k, v in
                    model.state_dict().items()}}

        if best["params"] is not None:
            model.load_state_dict(best["params"])
        test_ap, test_roc = evaluate(x_test, y_test)
    except KeyboardInterrupt:
        # user cancel is INTERRUPTED, not a crash (matches Trainer.fit)
        if run_dir is not None:
            from ..utils.run_record import finalize_run_json

            finalize_run_json(run_dir, "INTERRUPTED")
        raise
    except BaseException:
        # a crashed run must not read as RUNNING forever in its record
        if run_dir is not None:
            from ..utils.run_record import finalize_run_json

            finalize_run_json(run_dir, "FAILED")
        raise
    finally:
        if metrics_log is not None:
            metrics_log.close()
    result = {
        "val_roc": best["val_roc"],
        "test_ap": test_ap,
        "test_roc": test_roc,
    }
    _logger.info("tl_pipeline result: %s", result)
    if run_dir is not None:
        from ..utils.run_record import finalize_run_json

        finalize_run_json(run_dir, "COMPLETED", result)
    print(result)
    return result


def _apply_overrides(cfg: dict, args: list[str]) -> dict:
    from ..configs import _merge, apply_override, parse_override

    explicit = set()
    for a in args:
        if "=" in a:
            path, value = parse_override(a)
            apply_override(cfg, path, value)
            explicit.add(".".join(path))
        elif a in PRESETS:
            _merge(cfg, PRESETS[a])
        elif a != "with":
            raise SystemExit(f"unknown preset {a!r}")
    # Sacred config-scope coupling (reference ex_tl.py:26-64): the
    # top-level max_epochs value seeds BOTH the trainer loop length and
    # the LR-table length, and the reference re-derives them when the
    # top-level key is overridden; individually overridden keys still win.
    if "max_epochs" in explicit:
        if "trainer.max_epochs" not in explicit:
            cfg["trainer"]["max_epochs"] = cfg["max_epochs"]
        if "optimizer.max_epochs" not in explicit:
            cfg["optimizer"]["max_epochs"] = cfg["max_epochs"]
    return cfg


def main(argv=None, device: str = "cuda") -> dict:
    """The CLI: presets and ``key=value`` overrides; ``--device X`` picks
    the probe's device."""
    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    base = default_config()
    # CLI runs record by default like the reference's Sacred observer
    # (FileStorageObserver("exp_logs"), reference: ex_tl.py:22); library
    # callers of tl_pipeline() stay hermetic with exp_dir="".
    base["exp_dir"] = "exp_logs"
    return tl_pipeline(_apply_overrides(base, argv), device=device)


if __name__ == "__main__":
    main()
