"""Training/eval/predict loops, port of ``maest_tpu/train/loop.py``.

The reference's Lightning plumbing (reference: ex_maest.py:72-233,
models/module.py:44-349) on one card: an eager train step (the
attention kernels K3a and K3b), host-side epoch orchestration,
``torch.save`` checkpoints (best-on-val-loss + every-epoch, reference:
models/module.py:256-264) committed on a background thread, SWA
averaging, numpy macro AP/ROC, TensorBoard scalars when ``tensorboardX``
is installed.

Across processes (a torchrun launch, or ``ex_maest`` with
``trainer.devices=N``) the Trainer runs the JAX Trainer's parallel modes:
data parallelism, FSDP2, tensor parallelism and sequence parallelism
over a ``(data, model)`` mesh, and with ``trainer.pipeline_parallel=S``
GPipe over a ``(data, pipe, model)`` mesh (``trainer.num_microbatches``
M a step; evals at M = 1), alone or with data parallelism, FSDP2 and
tensor parallelism inside each stage (``parallel.pipeline``). Each data
rank loads its rows of every global batch, in rank order; evals are
rank-sharded and their logits gathered, so every rank computes the
one-process metrics; ``predict`` partitions the files over the ranks
(under a pipeline, on the sequential path with the whole weights); rank
0 writes the same checkpoint directory one process writes, gathered
whole from every stage.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..api import get_maest
from ..data import (
    BatchLoader,
    DatasetConfig,
    ExhaustiveMelDataset,
    ExhaustiveMelDatasetTS,
    MelChunkDataset,
    MelChunkDatasetTS,
    class_balanced_weights_streaming,
    device_prefetch,
    weighted_epoch_indices,
)
from ..models.vit import MAESTNet
from ..parallel import mesh as pmesh
from ..parallel import pipeline
from ..parallel.tensor_parallel import all_gather_dim
from .metrics import gather_across_hosts, macro_ap_roc
from .schedules import make_schedule
from .state import TrainState, make_optimizer, swa_update
from .steps import augment_config, make_eval_step, make_predict_step, make_train_step

_logger = logging.getLogger("maest_tpu_torch.train")



def _build_model(cfg: dict, dtype, device="cpu"):
    """``get_maest`` with the experiment's model keys: float32 parameters
    (released or ``checkpoint`` weights loaded) on ``device``."""
    m = cfg["maest"]
    return get_maest(
        arch=m["arch"],
        pretrained=m["pretrained"],
        n_classes=m["n_classes"],
        in_channels=m["in_channels"],
        stride_f=m["stride_f"],
        stride_t=m["stride_t"],
        input_f=m["input_f"],
        input_t=m["input_t"],
        u_patchout=m["u_patchout"],
        s_patchout_t=m["s_patchout_t"],
        s_patchout_f=m["s_patchout_f"],
        s_patchout_f_indices=tuple(m["s_patchout_f_indices"]),
        s_patchout_f_interleaved=m["s_patchout_f_interleaved"],
        s_patchout_t_indices=tuple(m["s_patchout_t_indices"]),
        s_patchout_t_interleaved=m["s_patchout_t_interleaved"],
        distilled_type=m["distilled_type"],
        checkpoint=m["checkpoint"],
        checkpoint_swa_weights=m["checkpoint_swa_weights"],
        checkpoint_discard_head=m["checkpoint_discard_head"],
        dtype=dtype,
        device=device,
        seed=cfg.get("seed", 0),
        embed_dim=m.get("embed_dim", 768),
        depth=m.get("depth", 12),
        num_heads=m.get("num_heads", 12),
        remat=m.get("remat", False),
        remat_policy=m.get("remat_policy", "full"),
        attention_quant=m.get("attention_quant", "none"),
        attention_bwd_quant=m.get("attention_bwd_quant", "none"),
    )


def _training_net(cfg: dict, dtype, device) -> MAESTNet:
    """The net the step trains: ``dtype`` compute over float32 parameters
    on ``device``, holding ``get_maest``'s weights."""
    wrapper = _build_model(cfg, torch.float32)
    net = MAESTNet(wrapper.cfg, dtype=dtype, param_dtype=torch.float32)
    net.load_state_dict(wrapper.net.state_dict())
    return net.to(device)


def _dataset_cfg(cfg: dict) -> DatasetConfig:
    ds = cfg["dataset"]
    return DatasetConfig(
        sample_rate=ds["sample_rate"],
        hop_size=ds["hop_size"],
        n_bands=ds["n_bands"],
        clip_length=cfg["datamodule"]["clip_length"],
    )


def swa_epoch_window(swa_epoch_start: int, max_epochs: int,
                     epoch: int) -> bool:
    """Does this END-of-(0-based)-``epoch`` moment fall in Lightning's SWA
    averaging window? (``maest_tpu/train/loop.py::swa_epoch_window``:
    Lightning averages after epochs swa_epoch_start-2..max_epochs-2.)"""
    return swa_epoch_start - 2 <= epoch <= max_epochs - 2


def _precision_dtype(precision: str):
    return {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
            "fp32": torch.float32, "32": torch.float32,
            "16-mixed": torch.bfloat16}[str(precision)]


def _pipeline_stages(tr: dict) -> int:
    """``trainer.pipeline_parallel`` as a stage count; 0 without a
    pipeline (0 and 1 alike)."""
    pp = int(tr.get("pipeline_parallel") or 0)
    return pp if pp > 1 else 0


def _parallel(tr: dict, device: torch.device):
    """The rank's ``Parallel`` for the trainer config, or None for one
    process. Joins the process group of a torchrun launch; more devices
    than launched ranks raise."""
    pp = _pipeline_stages(tr)
    if pp and tr.get("sequence_parallel"):
        raise ValueError(
            "pipeline_parallel does not compose with sequence_parallel (SP "
            "token-shards the residual stream between blocks; the pipeline "
            "owns that seam)")
    pmesh.init_distributed(device)
    devices = tr.get("devices")
    model_parallel = int(tr.get("model_parallel") or 1)
    if not (dist.is_available() and dist.is_initialized()):
        n = 1 if devices is None else int(devices)
        if n > 1:
            raise ValueError(
                f"trainer.devices={n} in one process: {pmesh._LAUNCH}")
        if pp:
            raise ValueError(
                f"1 devices not divisible by num_stages x model_parallel = "
                f"{pp} x {model_parallel}")
        if model_parallel > 1:
            raise ValueError(f"1 devices not divisible by model_parallel="
                             f"{model_parallel}")
        return None
    n = None if devices is None else int(devices)
    if pp:
        mesh = pipeline.make_pipeline_mesh(n, pp, model_parallel,
                                           device_type=device.type)
    else:
        mesh = pmesh.make_mesh(n, model_parallel, device_type=device.type)
    return pmesh.Parallel(mesh, fsdp=bool(tr.get("fsdp")),
                          sequence_parallel=bool(tr.get("sequence_parallel")))


def _step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step ``step``'s draws: seeded from (seed,
    step), so the draws are fixed per step and survive a resume."""
    key = np.random.SeedSequence((int(seed), int(step))).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(key))


# -- checkpoints ----------------------------------------------------------

_STATE_FILE = "state.pt"


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def state_snapshot(state: TrainState, parallel=None) -> dict:
    """A host copy of ``state``: ``params``, ``opt_state`` (Adam's ``mu``,
    ``nu`` and ``count``, the accumulator and its ``mini_step``),
    ``swa_params``, ``swa_n`` and ``step``. Parameters are keyed by their
    ``named_parameters`` names; ``mu``/``nu`` hold the parameters the
    optimizer has state for. Across ranks (``parallel``) every tensor is
    gathered whole (FSDP shards, TP slices, every stage's blocks), so the
    snapshot is the one a single process takes; every rank must call
    it."""
    named = dict(state.model.named_parameters())
    mu, nu = {}, {}
    for name, p in named.items():
        s = state.optimizer.state.get(p)
        if s:
            mu[name] = s["exp_avg"]
            nu[name] = s["exp_avg_sq"]

    def host(tensors):
        return _whole(tensors, parallel, state.model.cfg)

    return {
        "params": host(named),
        "opt_state": {
            "mu": host(mu), "nu": host(nu), "count": int(state.count),
            "accum": host(state.accum),
            "mini_step": int(state.mini_step),
        },
        "swa_params": host(state.swa_params),
        "swa_n": int(state.swa_n),
        "step": int(state.step),
    }


def _whole(tensors: dict, parallel, cfg) -> dict:
    """Host copies of ``tensors`` (this rank's parts, by parameter name),
    gathered whole across ranks (``parallel``): every rank must call it."""
    if parallel is None:
        return {k: _host_copy(t) for k, t in tensors.items()}
    if parallel.pipe > 1:
        return pipeline.whole_tensors(tensors, parallel, cfg)
    return {k: _host_copy(pmesh.full_tensor(k, t, parallel, cfg.num_heads))
            for k, t in tensors.items()}


def write_checkpoint(path, snapshot: dict) -> Path:
    """Write ``snapshot`` as the checkpoint directory ``path``: into a
    private temporary directory first, then renamed into place, so a
    reader never sees half a checkpoint (an older one at ``path`` is
    replaced)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(snapshot, tmp / _STATE_FILE)
    if path.exists():
        old = path.with_name(f"{path.name}.old{os.getpid()}")
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)
    return path


def read_checkpoint(path) -> dict:
    """The snapshot of the checkpoint directory ``path``, on the host."""
    return torch.load(Path(path) / _STATE_FILE, map_location="cpu",
                      weights_only=True)


@torch.no_grad()
def load_snapshot(state: TrainState, snap: dict, parallel=None) -> TrainState:
    """Copy a snapshot into ``state`` (its module, optimizer, SWA buffer
    and counters) in place. Across ranks (``parallel``) each rank takes
    its part of every whole tensor (under a pipeline, of its stage's
    blocks), so a checkpoint of any layout restores in any other."""
    named = dict(state.model.named_parameters())
    whole = (set(pipeline.whole_shapes(state.model.cfg))
             if state.model.stage else set(named))
    if set(snap["params"]) != whole:
        raise ValueError(
            "checkpoint parameters do not match the model: missing "
            f"{sorted(whole - set(snap['params']))}, unexpected "
            f"{sorted(set(snap['params']) - whole)}")
    heads = state.model.cfg.num_heads if parallel is not None else 0

    def load(name, dst, whole):
        pmesh.load_local(name, dst, whole, parallel, heads)

    def held(tensors: dict) -> dict:
        return {k: v for k, v in tensors.items() if k in named}

    opt = snap["opt_state"]
    for k, p in named.items():
        load(k, p, snap["params"][k])
    for k, v in held(snap["swa_params"]).items():
        load(k, state.swa_params[k], v)
    for k, v in held(opt["accum"]).items():
        load(k, state.accum[k], v)
    state.optimizer.state.clear()
    for k, m in held(opt["mu"]).items():
        p = named[k]
        mu, nu = torch.zeros_like(p), torch.zeros_like(p)
        load(k, mu, m)
        load(k, nu, opt["nu"][k])
        state.optimizer.state[p] = {
            "step": torch.tensor(float(opt["count"])),
            "exp_avg": mu, "exp_avg_sq": nu}
    state.count = int(opt["count"])
    state.mini_step = int(opt["mini_step"])
    state.swa_n = int(snap["swa_n"])
    state.step = int(snap["step"])
    return state


class Trainer:
    """End-to-end pre-training run (reference `main`, ex_maest.py:72-91):
    ``device`` is where the net trains ("cuda" unless the caller asks for
    the CPU). Under a launch of several ranks each process builds one,
    the mesh from ``trainer.devices`` (None: every launched rank),
    ``trainer.pipeline_parallel`` and ``trainer.model_parallel``."""

    def __init__(self, cfg: dict, run_dir: Optional[str] = None,
                 run_info: Optional[dict] = None, device="cuda"):
        self.cfg = cfg
        self._run_info = run_info
        tr = cfg["trainer"]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but torch finds no "
                               "CUDA device")
        self.parallel = _parallel(tr, self.device)
        if self.parallel is not None and self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.n_data = 1 if self.parallel is None else self.parallel.data
        self.rank = 0 if self.parallel is None else self.parallel.rank
        self.proc0 = self.rank == 0
        self.dtype = _precision_dtype(tr["precision"])
        self.teacher_student = cfg["datamodule"]["teacher_student"]["do"]
        self.aug = augment_config(cfg)

        self.net = _training_net(cfg, self.dtype, self.device)

        opt = cfg["module"]["optimizer"]
        epoch_len = cfg["datamodule"]["sampler"]["epoch_len"]
        # batch_size_train rows a data rank, as the JAX Trainer's per-shard
        # batch
        self.global_batch = cfg["datamodule"]["batch_size_train"] * self.n_data
        self.steps_per_epoch = max(1, epoch_len // self.global_batch)
        if tr["limit_train_batches"]:
            self.steps_per_epoch = min(self.steps_per_epoch, tr["limit_train_batches"])
        accum = int(tr.get("accumulate_grad_batches") or 1)
        # the LR schedule advances per OPTIMIZER step, so steps-per-epoch
        # scales down by the accumulation factor (fractional on purpose)
        schedule = make_schedule(
            opt["schedule_mode"], opt["lr"],
            self.steps_per_epoch / accum if accum > 1 else self.steps_per_epoch,
            warm_up_len=opt["warm_up_len"],
            ramp_down_start=opt["ramp_down_start"],
            ramp_down_len=opt["ramp_down_len"],
            last_lr_value=opt["last_lr_value"],
            # Lightning SWA replaces the scheduler with SWALR from the SWA
            # swap epoch (reference: models/module.py:268-273)
            do_swa=cfg["module"]["do_swa"],
            swa_epoch_start=cfg["module"]["swa_epoch_start"],
            swa_lr=cfg["module"]["swa_lrs"],
        )
        self.tx = make_optimizer(
            lr_schedule=schedule, adamw=opt["adamw"],
            weight_decay=opt["weight_decay"],
            accumulate_steps=accum,
        )
        self.state = TrainState.create(self.net, self.tx,
                                       with_swa=cfg["module"]["do_swa"],
                                       parallel=self.parallel)
        self.pipeline_parallel = _pipeline_stages(tr)
        self.num_microbatches = int(tr.get("num_microbatches") or 4)
        eval_apply = None
        if self.pipeline_parallel:
            m = self.num_microbatches
            if self.global_batch % (self.n_data * m):
                raise ValueError(
                    f"global train batch {self.global_batch} must divide by "
                    f"data shards x num_microbatches = {self.n_data} x {m}")
            self.train_step = pipeline.make_pipeline_train_step(
                self.net, self.tx, self.aug, parallel=self.parallel,
                num_microbatches=m, teacher_student=self.teacher_student)

            # eval streams one microbatch through the stages: the eval
            # batches divide only by the data ranks
            def eval_apply(model, x):
                return pipeline.pipeline_apply(model, x, self.parallel,
                                               num_microbatches=1)
        else:
            self.train_step = make_train_step(
                self.net, self.tx, self.aug,
                teacher_student=self.teacher_student, parallel=self.parallel,
            )
        self.eval_step = make_eval_step(self.net, self.aug,
                                        with_swa=cfg["module"]["do_swa"],
                                        apply_fn=eval_apply)
        if self.parallel is not None:
            _logger.info("rank %d: %s", self.rank, self.parallel.describe())

        stamp = time.strftime("%y%m%d-%H%M%S")  # fixed 13 chars
        if self.parallel is not None:
            # every rank must derive the same run dir (checkpoints are
            # gathered collectively, their path taken from it): rank 0's
            # formatted stamp, not each clock's
            box = [stamp]
            dist.broadcast_object_list(box, src=0)
            stamp = box[0]
        self.run_dir = Path(run_dir or tr["default_root_dir"]) / stamp
        self.run_dir.mkdir(parents=True, exist_ok=True)
        from ..utils.run_record import MetricsLog, write_run_json

        # host-side run records are rank 0's (the reference's Sacred
        # observer and TensorBoard logger live on rank 0 the same way)
        if self.proc0:
            (self.run_dir / "config.json").write_text(
                json.dumps(cfg, indent=2, default=str)
            )
            write_run_json(self.run_dir, cfg, self._run_info)
        self.metrics_log = MetricsLog(self.run_dir / "metrics.jsonl",
                                      enabled=self.proc0)
        self._tb = None
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: list = []
        self.epoch = 0
        self.best_val = float("inf")  # persisted in ckpt meta (resume-safe)

    # -- logging -----------------------------------------------------------
    @property
    def tb(self):
        if self._tb is None:
            if not self.proc0:
                self._tb = _NullWriter()
                return self._tb
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(str(self.run_dir / "tb"))
            except Exception:  # tensorboard optional
                self._tb = _NullWriter()
        return self._tb

    # -- data ---------------------------------------------------------------
    def _train_dataset(self):
        dm = self.cfg["datamodule"]
        ds_cfg = _dataset_cfg(self.cfg)
        if self.teacher_student:
            return MelChunkDatasetTS(
                dm["groundtruth_train"], dm["base_dir"], ds_cfg,
                teacher_target_base_dir=dm["teacher_student"]["teacher_target_base_dir"],
                teacher_target_threshold=dm["teacher_student"]["teacher_target_threshold"],
            )
        return MelChunkDataset(dm["groundtruth_train"], dm["base_dir"], ds_cfg)

    def _val_dataset(self):
        # cached: the dataset (and its groundtruth unpickle) is identical
        # every epoch
        if getattr(self, "_val_ds", None) is None:
            self._val_ds = self._build_val_dataset()
        return self._val_ds

    def _build_val_dataset(self):
        dm = self.cfg["datamodule"]
        base = dm["base_dir_val"] or dm["base_dir"]
        # crop_seed pins the val crops: val metrics compare across epochs
        # on fixed crops
        crop_seed = self.cfg.get("seed", 0)
        if self.teacher_student:
            # TS eval logs standard/teacher/combined losses, so the val
            # loader also carries teacher targets (reference:
            # models/module.py:318-349)
            return MelChunkDatasetTS(
                dm["groundtruth_val"], base, _dataset_cfg(self.cfg),
                teacher_target_base_dir=dm["teacher_student"]["teacher_target_base_dir"],
                teacher_target_threshold=dm["teacher_student"]["teacher_target_threshold"],
                crop_seed=crop_seed,
            )
        return MelChunkDataset(dm["groundtruth_val"], base,
                               _dataset_cfg(self.cfg), crop_seed=crop_seed)

    def _epoch_indices(self, dataset, epoch: int) -> np.ndarray:
        dm = self.cfg["datamodule"]
        s = dm["sampler"]
        # the class weights are epoch-invariant: streamed once, never the
        # dense (N, 400) matrix
        if getattr(self, "_weights_for", None) is not dataset:
            self._sample_weights = class_balanced_weights_streaming(
                dataset.groundtruth, dataset.filenames,
                s["sample_weight_offset"], s["sample_weight_sum"]
            )
            self._weights_for = dataset
        idx = weighted_epoch_indices(
            self._sample_weights,
            min(s["epoch_len"], self.steps_per_epoch * self.global_batch),
            seed=self.cfg.get("seed", 0),
            epoch=epoch,
            replacement=s["sampler_replace"],
        )
        return self._rank_rows(idx)

    def _rank_rows(self, idx: np.ndarray) -> np.ndarray:
        """This data rank's rows of each global batch of ``idx``: the
        rank-th block of ``batch_size_train`` rows, so the ranks' batches
        in rank order are the one-process global batch, row for row (the
        sampler's strided ``rank::num_replicas`` slice would hold the same
        rows in another order, and mixup pairs rows by position)."""
        if self.n_data == 1:
            return idx
        b, n = self.global_batch // self.n_data, self.parallel.data_rank
        full = len(idx) // self.global_batch * self.global_batch
        return idx[:full].reshape(-1, self.n_data, b)[:, n].reshape(-1)

    # -- checkpointing -------------------------------------------------------
    def finalize_checkpoints(self):
        """Block until the save in flight has committed; raise its error.
        Across ranks every rank waits here for rank 0's commit."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self.parallel is not None:
            dist.barrier()
        if self._save_error:
            raise self._save_error.pop()

    def save_checkpoint(self, tag: str):
        path = (self.run_dir / "checkpoints" / tag).absolute()
        path.parent.mkdir(parents=True, exist_ok=True)
        # one save in flight at a time: commit the previous one first
        self.finalize_checkpoints()
        # the optimizer and swa_update change tensors in place: copy the
        # state to the host before returning, then write it on a thread.
        # Across ranks the copy is gathered whole; rank 0 writes it
        snap = state_snapshot(self.state, self.parallel)
        if not self.proc0:
            return

        def commit():
            try:
                write_checkpoint(path, snap)
            except BaseException as e:  # noqa: BLE001 — raised on join
                self._save_error.append(e)

        self._save_thread = threading.Thread(target=commit, daemon=False)
        self._save_thread.start()
        # the marker may land before the commit: the checkpoint directory
        # appears under its name only by the final rename, and
        # latest_checkpoint needs both. Written atomically (tmp + rename):
        # a kill between truncate and write must not leave a corrupt
        # marker
        meta = self.run_dir / "checkpoints" / f"{tag}.meta.json"
        tmp = meta.with_suffix(".json.tmp")
        tmp.write_text(json.dumps({
            "epoch": self.epoch,
            # json has no inf: None = "no best yet"
            "best_val": (self.best_val
                         if self.best_val != float("inf") else None),
        }))
        tmp.replace(meta)

    def restore_checkpoint(self, path: str):
        self.finalize_checkpoints()
        snap = read_checkpoint(path)
        # SWA-structure mismatch between this run and the checkpoint:
        # `test` forces do_swa=False (reference ex_maest.py:99) on
        # checkpoints saved by SWA runs, and an SWA run may resume a no-SWA
        # checkpoint. Coerce to this run's setting: a fresh window (the
        # parameters) when this run wants SWA and the checkpoint has none
        # (swa_n is restored, so a restored window stays intact); no SWA
        # at all, swa_n 0, the other way round.
        want_swa = bool(self.state.swa_params)
        if bool(snap["swa_params"]) != want_swa:
            if want_swa:
                snap["swa_params"] = dict(snap["params"])
            else:
                snap["swa_params"] = {}
                snap["swa_n"] = 0
        load_snapshot(self.state, snap, self.parallel)
        meta = Path(path).parent / (Path(path).name + ".meta.json")
        if meta.exists():
            # checkpoints are written AFTER an epoch completes, so resume
            # at the next one (Lightning resume semantics)
            m = json.loads(meta.read_text())
            self.epoch = m.get("epoch", -1) + 1
            # restore the best-so-far val loss: without it every resumed
            # run's first epoch would clobber the 'best' checkpoint
            bv = m.get("best_val")
            self.best_val = float(bv) if bv is not None else float("inf")

    # -- loops ---------------------------------------------------------------
    def fit(self):
        from ..utils.run_record import finalize_run_json

        def _finalize(status, result=None):
            if self.proc0:  # run.json is rank 0's record
                finalize_run_json(self.run_dir, status, result)

        try:
            result = self._fit()
        except BaseException as e:
            # SystemExit from a SIGTERM preemption handler and Ctrl-C are
            # stops, not crashes; a sys.exit(1)-style failure exit or any
            # Exception is FAILED (see classify_exit)
            from ..utils.run_record import classify_exit
            _finalize(classify_exit(e))
            raise
        finally:
            self.metrics_log.close()  # log() reopens lazily if fit is re-run
            if self._tb is not None:  # its writer thread ends with the run
                self._tb.close()
                self._tb = None
        _finalize("COMPLETED", result)
        return result

    def _fit(self):
        cfg = self.cfg
        tr = cfg["trainer"]
        mod = cfg["module"]
        if cfg.get("ckpt_path"):
            self.restore_checkpoint(cfg["ckpt_path"])
            _logger.info("resumed from %s at epoch %d", cfg["ckpt_path"], self.epoch)

        train_ds = self._train_dataset()
        # each data rank loads only its rows of the global batch
        loader = BatchLoader(
            train_ds, self.global_batch // self.n_data,
            num_workers=cfg["datamodule"]["num_workers"], drop_last=True,
        )
        seed = cfg.get("seed", 0)

        while self.epoch < tr["max_epochs"]:
            t0 = time.time()
            idx = self._epoch_indices(train_ds, self.epoch)
            n_steps = 0
            last = {}
            for batch in device_prefetch(loader.iter_indices(idx), self.device):
                # per-step randomness from (seed, state.step)
                self.state, metrics = self.train_step(
                    self.state, _step_batch(batch),
                    _step_generator(seed, self.state.step)
                )
                n_steps += 1
                if n_steps % tr["log_every_n_steps"] == 0:
                    last = {k: float(v) for k, v in metrics.items()}
                    step = int(self.state.step)
                    for k, v in last.items():
                        self.tb.add_scalar(k, v, step)
                        self.metrics_log.log(k, v, step)
                if tr["limit_train_batches"] and n_steps >= tr["limit_train_batches"]:
                    break
            # SWA (reference: helpers/swa_callback.py:9-15; start epoch
            # models/module.py:25)
            if mod["do_swa"] and swa_epoch_window(
                    mod["swa_epoch_start"], tr["max_epochs"], self.epoch):
                self.state = swa_update(self.state)

            val = self.validate()
            dt = time.time() - t0
            _logger.info(
                "epoch %d: %d steps in %.1fs train=%s val=%s",
                self.epoch, n_steps, dt, last, val,
            )
            for k, v in val.items():
                self.tb.add_scalar(k, v, self.epoch)
                self.metrics_log.log(k, v, self.epoch)

            # update best_val BEFORE the epoch save so its meta marker
            # carries the current best
            improved = val.get("val_loss", float("inf")) < self.best_val
            if improved:
                self.best_val = float(val["val_loss"])
            self.save_checkpoint(f"epoch-{self.epoch}")
            if improved:
                self.save_checkpoint("best")
            self.epoch += 1
        self.finalize_checkpoints()
        return {"done": True}

    def _run_eval(self, dataset, stage: str) -> dict:
        cfg = self.cfg
        tr = cfg["trainer"]
        dm = cfg["datamodule"]
        par = self.parallel
        prefetch_kw = {}
        if par is None:
            loader = BatchLoader(
                dataset, dm["batch_size_test"],
                num_workers=dm["num_workers"],
            )
            batches = _pad_batches(iter(loader), dm["batch_size_test"])
        elif par.model == 1 and hasattr(dataset, "targets_for"):
            # rank-sharded eval loading (reference:
            # discogs/datamodule.py:79-97): each data rank reads its rows
            # of every global batch, the targets of the whole batch come
            # from the groundtruth
            batches = self._rank_sharded_eval_batches(dataset)
        else:
            # the JAX package's replicated fallback where the data ranks do
            # not divide the processes (model ranks > 1): every rank loads
            # the whole batch, padded to a multiple of the data ranks, and
            # keeps its data rank's rows on the card
            loader = BatchLoader(dataset, dm["batch_size_test"],
                                 num_workers=dm["num_workers"])
            batches = _pad_batches(iter(loader), dm["batch_size_test"],
                                   par.data)
            prefetch_kw = {"shard": (par.data_rank, par.data)}
        ys, yts, outs, n = [], [], {}, 0
        # only x goes to the card: the losses and metrics are taken from
        # the logits on the host
        for batch in device_prefetch(batches, self.device, keys=("x",),
                                     **prefetch_kw):
            n_true = batch["_n"]
            res = self.eval_step(self.state, batch["x"])
            ys.append(np.asarray(batch["y"], np.float32)[:n_true])
            if "y_teacher" in batch:
                yts.append(np.asarray(batch["y_teacher"], np.float32)[:n_true])
            for name, logits in res.items():
                if par is not None and par.data > 1:
                    # every rank gets the whole batch's logits, so every
                    # rank computes the one-process metrics
                    logits = all_gather_dim(logits, 0, par.data_group)
                outs.setdefault(name, []).append(
                    logits.float().cpu().numpy()[:n_true]
                )
            n += 1
            # limit_val_batches must NOT truncate the final test metrics
            # (Lightning keeps a separate limit_test_batches)
            limit = (tr["limit_val_batches"] if stage == "val"
                     else tr.get("limit_test_batches"))
            if limit and n >= limit:
                break
        if not ys:
            return {}

        def bce(z, t):
            # BCE with logits, numerically stable (reference:
            # models/module.py:90)
            return float(np.mean(
                np.maximum(z, 0) - z * t + np.log1p(np.exp(-np.abs(z)))
            ))

        y = np.concatenate(ys)
        y_teacher = np.concatenate(yts) if yts else None
        metrics = {}
        for name, chunks in outs.items():
            suffix = f"_{name}" if name else ""
            z = np.concatenate(chunks)
            loss = bce(z, y)
            if y_teacher is not None:
                # teacher-student eval: standard/teacher/combined losses,
                # both from the first-head logits (reference:
                # models/module.py:326-331)
                loss_teacher = bce(z, y_teacher)
                metrics[f"{stage}_loss_standard{suffix}"] = loss
                metrics[f"{stage}_loss_teacher{suffix}"] = loss_teacher
                loss = (loss + loss_teacher) / 2
            y_hat = 1.0 / (1.0 + np.exp(-z))
            ap, roc = macro_ap_roc(y, y_hat)
            metrics[f"{stage}_loss{suffix}"] = loss
            metrics[f"{stage}_ap{suffix}"] = ap
            metrics[f"{stage}_roc{suffix}"] = roc
        return metrics

    def _rank_sharded_eval_batches(self, dataset):
        """Eval batches of which this data rank loads only its rows (as
        ``maest_tpu/train/loop.py::_rank_sharded_eval_batches``): each
        global batch holds ``batch_size_test`` real rows, padded to a
        multiple of the data ranks by repeating its last row, the same
        rows and ``_n`` as one process's batches; ``y`` (and
        ``y_teacher``) are the whole batch's, from the groundtruth."""
        dm = self.cfg["datamodule"]
        n_data, rank = self.parallel.data, self.parallel.data_rank
        N = len(dataset)
        B = dm["batch_size_test"]
        T = B + (-B) % n_data
        per = T // n_data
        windows = []
        for k in range(-(-N // B)):
            real = np.arange(k * B, min((k + 1) * B, N))
            pad = np.full(T - len(real), real[-1])
            windows.append((np.concatenate([real, pad]), len(real)))
        if not windows:
            return
        local = np.concatenate([w[rank * per:(rank + 1) * per]
                                for w, _ in windows])
        loader = BatchLoader(dataset, per, num_workers=dm["num_workers"])
        for (w, n_true), batch in zip(windows, loader.iter_indices(local)):
            out = {"x": batch["x"]}
            out.update(dataset.targets_for(w))
            out["_n"] = n_true
            yield out

    def validate(self) -> dict:
        return self._run_eval(self._val_dataset(), "val")

    def test(self) -> dict:
        dm = self.cfg["datamodule"]
        if self.teacher_student:
            ds = ExhaustiveMelDatasetTS(
                dm["groundtruth_test"], dm["base_dir"], _dataset_cfg(self.cfg),
                teacher_target_base_dir=dm["teacher_student"]["teacher_target_base_dir"],
                teacher_target_threshold=dm["teacher_student"]["teacher_target_threshold"],
                half_overlapped_inference=self.cfg["dataset"]["half_overlapped_inference"],
            )
        else:
            ds = ExhaustiveMelDataset(
                dm["groundtruth_test"], dm["base_dir"], _dataset_cfg(self.cfg),
                half_overlapped_inference=self.cfg["dataset"]["half_overlapped_inference"],
            )
        return self._run_eval(ds, "test")

    # -- prediction / embedding extraction ------------------------------------
    def predict(self, output_name: str = "embeddings") -> dict:
        """Exhaustive-window prediction, aggregated per file and written as
        .npy (reference: ex_maest.py:162-207)."""
        cfg = self.cfg
        dm = cfg["datamodule"]
        ds = ExhaustiveMelDataset(
            dm["groundtruth_predict"], dm["base_dir"], _dataset_cfg(cfg),
            half_overlapped_inference=cfg["dataset"]["half_overlapped_inference"],
        )
        loader = BatchLoader(ds, dm["batch_size_test"],
                             num_workers=dm["num_workers"])
        net, params = self.net, self.state.params
        batch_iter = iter(loader)
        if self.parallel is not None:
            # every rank runs a whole model of its own over its files (a
            # file's windows stay on one rank: aggregation and the .npy
            # write are per file), with no collective in the loop, so the
            # ranks may take different batch counts; one gather of the
            # weights first. Under a pipeline too: the embedding tap reads
            # a block's output, which the stages do not expose
            par = self.parallel
            if self.pipeline_parallel:
                _logger.info("predict under pipeline_parallel=%d: the "
                             "sequential tap path on each of %d ranks",
                             self.pipeline_parallel, par.world)
            net = _whole_net(self.state, par, self.net.cfg, self.dtype,
                             self.device)
            params = dict(net.named_parameters())
            keep = set(ds.filenames[par.rank::par.world])
            batch_iter = loader.iter_indices(
                [i for i in range(len(ds)) if ds._target_filename(i) in keep])
        predict_step = make_predict_step(net, self.aug)
        block = cfg["predict"]["transformer_block"]

        agg: dict[str, list] = {}
        batches = _pad_batches(batch_iter, dm["batch_size_test"])
        for batch in device_prefetch(batches, self.device):
            out = predict_step(params, _step_batch(batch), block)
            n_true = batch["_n"]
            vals = out[output_name].float().cpu().numpy()[:n_true]
            for fname, v in zip(batch["filename"][:n_true], vals):
                agg.setdefault(fname, []).append(v)

        out_dir = self._predict_out_dir()
        for fname, vs in agg.items():
            path = out_dir / (fname + f".{output_name}.npy")
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, np.array(vs))
        # the global file count: one gather after every rank's loop
        n_files = int(gather_across_hosts(np.array([len(agg)], np.int64)).sum())
        return {"n_files": n_files, "out_dir": str(out_dir)}

    def _predict_out_dir(self) -> Path:
        """Output dir naming incl. deterministic-patchout tags
        (reference: ex_maest.py:186-201)."""
        cfg = self.cfg
        subdir1 = f"{cfg['datamodule']['clip_length']}sec"
        subdir2 = ""
        for po_dim in ("f", "t"):
            for po_type in ("indices", "interleaved"):
                val = cfg["maest"][f"s_patchout_{po_dim}_{po_type}"]
                if val:
                    tag = "_".join(np.array(val).astype("str")) if np.iterable(val) \
                        else str(val)
                    subdir2 += f"_patchout_{po_dim}_{po_type}" + tag
        subdir3 = str(cfg["predict"]["transformer_block"])
        return Path(cfg["predict"]["out_dir"]) / subdir1 / subdir2 / subdir3


def _whole_net(state: TrainState, par, cfg, dtype, device) -> MAESTNet:
    """A one-process model holding the whole weights of a sharded state
    (every rank must call it)."""
    net = MAESTNet(cfg, dtype=dtype, param_dtype=torch.float32)
    net.load_state_dict(_whole(dict(state.model.named_parameters()), par,
                               cfg))
    return net.to(device)


def _step_batch(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k not in ("filename", "_n")}


def _pad_batches(batches, full_size: int = 0, multiple: int = 1):
    """Pad batches to one static size, a multiple of ``multiple`` (padded
    rows repeat the last sample and are sliced off on host via ``_n``), as
    the JAX package does."""
    for batch in batches:
        b = batch["x"].shape[0]
        target = max(full_size, b)
        pad = target + (-target) % multiple - b
        if pad:
            batch = dict(batch)
            for k, v in list(batch.items()):
                if k == "filename":
                    batch[k] = list(v) + [v[-1]] * pad
                else:
                    batch[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
        batch["_n"] = b
        yield batch


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def compute_norm_stats(cfg: dict) -> tuple[float, float]:
    """Dataset mean/std over raw log-mel values (fixes the reference's broken
    ``compute_norm_stats``, ex_maest.py:220-233)."""
    dm = cfg["datamodule"]
    ds = MelChunkDataset(dm["groundtruth_train"], dm["base_dir"], _dataset_cfg(cfg))
    loader = BatchLoader(ds, dm["batch_size_test"], num_workers=dm["num_workers"])
    # streaming global moments: averaging per-batch stds would ignore the
    # between-batch variance of the means
    total, total_sq, count = 0.0, 0.0, 0
    for batch in loader:
        x = batch["x"].astype(np.float64)
        total += float(x.sum())
        total_sq += float((x * x).sum())
        count += x.size
    mean = total / count
    var = max(total_sq / count - mean * mean, 0.0)
    return float(mean), float(np.sqrt(var))


def model_speed_test(cfg: dict, batch_size: int = 100, test_length: int = 100,
                     device="cuda") -> float:
    """Train-step throughput in specs/second on a synthetic batch
    (reference: ex_maest.py:108-159), on ``device``. Input geometry
    follows the model config rather than the reference's hardcoded
    [100, 1, 128, 998]."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch finds no CUDA "
                           "device")
    net = _training_net(cfg, _precision_dtype(cfg["trainer"]["precision"]),
                        device)
    tx = make_optimizer(lr_schedule=1e-3, adamw=False)
    step = make_train_step(net, tx, augment_config(cfg))
    # no SWA buffer: the reference speed test carries none either
    state = TrainState.create(net, tx, with_swa=False)

    f, t = net.cfg.img_size
    nc = net.cfg.num_classes
    rng = np.random.default_rng(0)
    batch = {
        "x": torch.from_numpy(rng.standard_normal((batch_size, f, t),
                                                  dtype=np.float32)).to(device),
        "y": torch.from_numpy((rng.random((batch_size, nc)) > 0.9).astype(
            np.float32)).to(device),
    }
    seed = cfg.get("seed", 0)
    for _ in range(10):  # warmup
        state, m = step(state, batch, _step_generator(seed, state.step))
    t0 = time.time()
    for _ in range(test_length):
        # each step reads its loss on the host, so it has finished
        state, m = step(state, batch, _step_generator(seed, state.step))
    dt = time.time() - t0
    specs_per_s = test_length * batch_size / dt
    print(f"average speed: {specs_per_s:.1f} specs/second")
    return specs_per_s
