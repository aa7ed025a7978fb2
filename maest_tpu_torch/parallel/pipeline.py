"""GPipe pipeline parallelism for the ViT's blocks, port of
``maest_tpu/parallel/pipeline.py``.

The JAX package splits the blocks into ``num_stages`` contiguous groups
over a ``pipe`` mesh axis and streams microbatches through them with
``ppermute`` inside one ``shard_map`` region; autodiff through the
schedule gives GPipe's backward. Here each stage is a set of ranks, one
process each, and the schedule is written out:

* ``make_pipeline_mesh`` lays the ranks out as a ``(data, pipe, model)``
  ``DeviceMesh``, ``model`` innermost, as the JAX mesh. A rank holds the
  embeddings and heads and only its stage's blocks (``cut_to_stage``:
  ``depth / S`` contiguous blocks under their ``blocks.{i}`` names, the
  others replaced by empty modules), and steps only what it holds.
  Tensor parallelism inside a stage is the port's own
  (``parallel.tensor_parallel`` over the stage's ``model`` group, the
  slices of ``mesh.tp_slice``); FSDP2 shards each of the stage's blocks
  over the stage's ``data`` group.
* ``pipeline_apply``: stage 0 runs the front (``forward_mode="front"``)
  on the rank's rows and feeds M microbatches; every stage runs its
  blocks through the model's own ``Block`` (so attention takes the
  sequential step's kernels: K3a/K3b in training, K2 in eval, the 8-bit
  kernels under ``attention_quant``) and hands each microbatch on; the
  last stage runs the tail on the M outputs, and every other stage
  receives what the tail computed. Only the M real microbatches are
  computed: the JAX schedule's warm-up and drain steps, whose outputs it
  discards, have no counterpart.
* The activations move with autograd functions: ``_Recv``'s backward
  sends the gradient back to the predecessor (the transpose of JAX's
  ``ppermute``) and ``_Send``'s backward receives it, so one
  ``loss.backward()`` on every rank gives GPipe's backward. A stage
  before the last joins its sends into the received outputs (``_Join``),
  so its loss, the last stage's to the bit, runs its part of the
  backward; its sends' backwards are chained in microbatch order.
* Dropout masks are drawn at the global batch's shape from the same
  per-block seeds as one process and cut to each microbatch's rows (a
  microbatch is laid out as one of ``data x M`` row blocks), so the
  pipelined step with randomness equals the port's one-process step.
  The JAX package folds its keys per (data shard, layer, schedule step):
  the same distribution, not the same bits.

Transport: over NCCL the tensors go as they are. Over gloo (ranks that
share a card, or the CPU) every transfer crosses host memory: a CUDA
tensor is copied into a pinned host buffer before ``isend`` and
received into one, and the outputs and whole tensors are broadcast as
host tensors. Gloo's ``send``/``recv`` read a tensor's storage as host
memory, so a CUDA tensor cannot be handed to them, and no broadcast of
CUDA tensors over gloo is relied on (``DTensor.full_tensor``'s crash,
``mesh._gather_shards``). Each transfer carries a tag (forward: the
microbatch, backward: M + the microbatch), so gloo pairs a receive with
its send whatever the order the two autograd engines reach them in;
sends are asynchronous, and ``sync_stage_grads`` waits for them after
the backward.

Refused, with the JAX package's words: depth not divisible by the
stages; a batch not divisible by data x microbatches; stochastic depth
in training; sequence parallelism; heads or MLP width not divisible by
``model``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from . import mesh as pmesh


def make_pipeline_mesh(n_devices: Optional[int] = None, num_stages: int = 2,
                       model_parallel: int = 1, device_type: str = "cuda"):
    """A ``(data, pipe, model)`` ``DeviceMesh`` over the launched ranks:
    batch parallelism over ``data``, the stages over ``pipe``, tensor
    parallelism inside a stage over ``model``; rank = (data index x
    num_stages + stage) x model_parallel + model index, as the JAX mesh's
    reshape."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    model_parallel = int(model_parallel or 1)
    if n_devices > world:
        raise ValueError(
            f"requested {n_devices} devices but only {world} ranks were "
            f"launched; {pmesh._LAUNCH}")
    if n_devices % (num_stages * model_parallel):
        raise ValueError(
            f"{n_devices} devices not divisible by num_stages x "
            f"model_parallel = {num_stages} x {model_parallel}")
    if n_devices != world:
        raise ValueError(
            f"trainer.devices={n_devices} but {world} ranks were launched: "
            "every rank of the group takes part in the mesh")
    grid = torch.arange(world).view(-1, num_stages, model_parallel)
    return DeviceMesh(device_type, grid,
                      mesh_dim_names=("data", "pipe", "model"))


def stage_range(depth: int, stages: int, stage: int) -> tuple:
    """(lo, hi): the contiguous blocks stage ``stage`` of ``stages`` holds
    (``stack_block_params``'s grouping in the JAX package)."""
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by {stages} stages")
    per = depth // stages
    return stage * per, (stage + 1) * per


def block_stage(name: str, depth: int, stages: int) -> Optional[int]:
    """The stage that holds parameter ``name``; None for the embeddings
    and heads, which every stage holds."""
    if not name.startswith("blocks."):
        return None
    return int(name.split(".")[1]) // (depth // stages)


class _Elsewhere(nn.Module):
    """The place of a block another stage holds."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.held_by = index, stage

    def forward(self, *args, **kw):
        raise RuntimeError(f"block {self.index} is held by pipeline stage "
                           f"{self.held_by}")


def check_model(cfg, par) -> None:
    """The refusals that depend on the model and the mesh alone."""
    if cfg.depth % par.pipe:
        raise ValueError(f"depth {cfg.depth} not divisible by "
                         f"pipe={par.pipe}")
    if par.sequence_parallel or cfg.sequence_parallel:
        raise ValueError("sequence_parallel composes with TP, not PP")
    if par.model > 1:
        if cfg.num_heads % par.model:
            raise ValueError(f"num_heads {cfg.num_heads} not divisible by "
                             f"model={par.model}")
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        if hidden % par.model:
            raise ValueError(f"MLP hidden dim {hidden} not divisible by "
                             f"model={par.model}")


def cut_to_stage(net, par) -> None:
    """Keep this rank's stage's blocks in ``net`` (the full model, in
    place); the others become empty modules under their names, so the
    parameters keep the checkpoint's ``blocks.{i}`` names."""
    check_model(net.cfg, par)
    depth = net.cfg.depth
    lo, hi = stage_range(depth, par.pipe, par.pipe_rank)
    for i in range(depth):
        if not lo <= i < hi:
            net.blocks[i] = _Elsewhere(i, i // (hi - lo))
    net.stage = (lo, hi)


# -- the transfers between stages --------------------------------------------

class _Link:
    """This rank's transfers within its pipe group: to and from the
    neighbouring stages, and broadcasts from one stage."""

    def __init__(self, par):
        self.group = par.pipe_group
        self.stage, self.stages = par.pipe_rank, par.pipe
        self.gloo = dist.get_backend(self.group) == "gloo"
        self.pending = []  # (work, buffer) of the sends in flight

    def rank(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a buffer the backend can send."""
        t = t.detach().contiguous()
        if not self.gloo or t.device.type == "cpu":
            return t
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)

    def _in(self, shape, dtype, device) -> torch.Tensor:
        """A buffer the backend can receive ``shape`` into."""
        if self.gloo and device.type != "cpu":
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=device)

    def send(self, t: torch.Tensor, stage: int, tag: int) -> None:
        buf = self._out(t)
        work = dist.isend(buf, self.rank(stage), group=self.group, tag=tag)
        self.pending.append((work, buf))

    def recv(self, shape, dtype, device, stage: int, tag: int):
        buf = self._in(shape, dtype, device)
        dist.recv(buf, self.rank(stage), group=self.group, tag=tag)
        return buf.to(device)

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        """Stage ``stage``'s ``t`` on every stage (the others pass a tensor
        of its shape and dtype); on the host over gloo."""
        buf = t.detach().cpu() if self.gloo else t.detach().contiguous()
        dist.broadcast(buf, self.rank(stage), group=self.group)
        return buf

    def wait(self) -> None:
        """Wait for every send in flight."""
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()


def link(par) -> _Link:
    """The rank's ``_Link`` (one a ``Parallel``)."""
    if getattr(par, "_link", None) is None:
        par._link = _Link(par)
    return par._link


class _Recv(torch.autograd.Function):
    """A stage after the first: a microbatch's activation from the stage
    before; the backward sends its gradient back (``anchor``, an empty
    tensor that requires grad in training, puts the receive in the
    graph)."""

    @staticmethod
    def forward(ctx, anchor, lk, shape, dtype, tag, grad_tag):
        ctx.lk, ctx.grad_tag = lk, grad_tag
        return lk.recv(shape, dtype, anchor.device, lk.stage - 1, tag)

    @staticmethod
    def backward(ctx, g):
        ctx.lk.send(g, ctx.lk.stage - 1, ctx.grad_tag)
        return (None,) * 6


class _Send(torch.autograd.Function):
    """A stage before the last: send a microbatch's activation on; the
    output is a token chained to the previous microbatch's, and its
    backward receives the activation's gradient from the next stage (the
    chain runs the receives in the reverse microbatch order)."""

    @staticmethod
    def forward(ctx, h, token, lk, tag, grad_tag):
        lk.send(h, lk.stage + 1, tag)
        ctx.lk, ctx.grad_tag, ctx.chained = lk, grad_tag, token is not None
        ctx.meta = (h.shape, h.dtype, h.device)
        return h.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        g_h = ctx.lk.recv(*ctx.meta, ctx.lk.stage + 1, ctx.grad_tag)
        return g_h, (g if ctx.chained else None), None, None, None


class _Join(torch.autograd.Function):
    """A stage before the last: the outputs the last stage computed,
    joined to the stage's last send token, so that the loss taken from
    them runs the stage's backward."""

    @staticmethod
    def forward(ctx, token, *outs):
        return tuple(o.clone() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        return (grads[0].new_zeros(()),) + (None,) * len(grads)


# -- the pipelined forward ----------------------------------------------------

def _out_shapes(cfg, rows: int) -> list:
    """The shapes of the ``transformer_block == -1`` outputs of ``rows``."""
    heads = 2 if cfg.distilled and cfg.distilled_type == "separated" else 1
    return [(rows, cfg.num_classes)] * heads + [(rows, cfg.embed_dim)]


def check_batch(cfg, par, batch: int, num_microbatches: int,
                train: bool) -> None:
    """The refusals of one call: ``batch`` is the global batch."""
    if train and cfg.drop_path_rate > 0.0:
        raise NotImplementedError(
            "stochastic depth (drop_path_rate > 0) is not supported under "
            "pipeline parallelism; all shipped MAEST configs use 0")
    if batch % (par.data * num_microbatches):
        raise ValueError(
            f"batch {batch} not divisible by data shards x microbatches "
            f"= {par.data} x {num_microbatches}")


def pipeline_apply(net, x: torch.Tensor, par, *, num_microbatches: int = 4,
                   train: bool = False,
                   generator: Optional[torch.Generator] = None, draws=None):
    """The pipelined forward of ``net`` (this rank's stage of the model,
    ``cut_to_stage``) on ``x``, the rank's (B, 1, F, T) rows of the
    global batch: MAESTNet's ``transformer_block == -1`` output on every
    stage. ``train``: the train forward, its draws taken from
    ``generator`` or handed in as ``draws``, as ``MAESTNet.forward``
    takes them (every stage draws the same)."""
    cfg = net.cfg
    m = num_microbatches
    check_batch(cfg, par, x.shape[0] * par.data, m, train)
    lk = link(par)
    if train and draws is None:
        draws = net.draw_train(generator, *net.patch_grid(x.shape))
    train_draws = draws if train else None
    seeds = net.block_seeds(train_draws)
    n = net.stream_length(x.shape, train_draws)
    rows = x.shape[0] // m
    dev, dt = x.device, net.dtype
    grad = torch.is_grad_enabled()
    lo, hi = net.stage
    remat = train and cfg.remat
    base = par.layout()
    last = lk.stage == lk.stages - 1
    if lk.stage == 0:
        tokens, n_front = net(x, train=train, draws=draws,
                              forward_mode="front")
        if n_front != n:
            raise RuntimeError(f"the front's stream has {n_front} tokens, "
                               f"the stages expect {n}")
        feed = tokens.split(rows)
    anchor = torch.empty(0, device=dev, requires_grad=grad)
    token, outs = None, []
    for j in range(m):
        if lk.stage == 0:
            h = feed[j]
        else:
            h = _Recv.apply(anchor, lk, (rows, n, cfg.embed_dim), dt, j, m + j)
        # microbatch j as row block data_rank x m + j of data x m
        lay = dataclasses.replace(base, data=base.data * m,
                                  data_rank=base.data_rank * m + j)
        for i in range(lo, hi):
            h = net.run_block(i, h, seeds[i], n, remat, lay)
        if last:
            outs.append(h)
        else:
            token = _Send.apply(h, token, lk, j, m + j)
    if last:
        out = net(torch.cat(outs), forward_mode="tail")
        lk.broadcast(torch.cat([o.detach().reshape(-1) for o in out]),
                     lk.stage)
        return out
    lk.wait()
    shapes = _out_shapes(cfg, x.shape[0])
    flat = lk.broadcast(torch.empty(sum(a * b for a, b in shapes), dtype=dt,
                                    device="cpu" if lk.gloo else dev),
                        lk.stages - 1).to(dev)
    got = [t.view(s) for t, s in zip(
        flat.split([a * b for a, b in shapes]), shapes)]
    if not grad:
        return tuple(got)
    return _Join.apply(token, *got)


def make_pipeline_forward(net, par, *, num_microbatches: int = 4):
    """The pipelined inference forward: ``fn(x) -> (logits, ...)``."""

    @torch.no_grad()
    def forward(x):
        return pipeline_apply(net, x, par, num_microbatches=num_microbatches)

    return forward


def make_pipeline_train_step(net, tx, aug=None, *, parallel,
                             num_microbatches: int = 4,
                             teacher_student: bool = False):
    """The pipelined twin of ``train.steps.make_train_step``: the same
    step (augmentation, mixup, the loss, the guarded update) through its
    ``apply_fn`` hook, the blocks pipelined over the ``pipe`` ranks while
    the batch is split over ``data``."""
    from ..train.steps import AugmentConfig, make_train_step

    check_model(net.cfg, parallel)

    def apply_fn(model, x, generator, draws):
        return pipeline_apply(model, x, parallel,
                              num_microbatches=num_microbatches, train=True,
                              generator=generator, draws=draws)

    return make_train_step(net, tx, aug if aug is not None else AugmentConfig(),
                           teacher_student=teacher_student, parallel=parallel,
                           apply_fn=apply_fn)


# -- gradients and whole tensors ---------------------------------------------

@torch.no_grad()
def sync_stage_grads(model, par) -> None:
    """After the backward: wait for the sends in flight, then give every
    stage the gradients of the embeddings and heads (stage 0 computes the
    embeddings', the last stage the heads'): summed over the pipe group,
    the other stages adding zeros. A parameter no stage used keeps no
    gradient."""
    from ..train.steps import _all_reduce_flat

    link(par).wait()
    shared = [p for k, p in model.named_parameters()
              if block_stage(k, 1, 1) is None]
    dev = shared[0].device
    used = torch.tensor([float(p.grad is not None) for p in shared],
                        device=dev)
    dist.all_reduce(used, op=dist.ReduceOp.MAX, group=par.pipe_group)
    live = [p for p, u in zip(shared, used.tolist()) if u]
    for p in live:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _all_reduce_flat([p.grad for p in live], par.pipe_group)


def whole_shapes(cfg) -> dict:
    """name -> shape of every parameter of the whole model, in its
    order."""
    from ..models.vit import MAESTNet

    with torch.device("meta"):
        net = MAESTNet(cfg)
    return {k: tuple(p.shape) for k, p in net.named_parameters()}


@torch.no_grad()
def whole_tensors(tensors: dict, par, cfg) -> dict:
    """The whole host tensors of ``tensors`` (this rank's parts of
    parameter-shaped tensors, by parameter name) for every name some
    stage holds, on every rank: each gathered whole on its stage
    (``mesh.full_tensor``) and broadcast over the pipe group. Every rank
    must call it."""
    lk = link(par)
    held = [None] * par.pipe
    mine = (sorted(tensors), str(next(iter(tensors.values())).dtype)
            if tensors else None)
    dist.all_gather_object(held, mine, group=par.pipe_group)
    names = set().union(*(set(h[0]) for h in held))
    dtype = next((getattr(torch, h[1].split(".")[1]) for h in held if h[1]),
                 torch.float32)
    heads = cfg.num_heads
    dev = next((t.device for t in tensors.values()), torch.device("cpu"))
    out = {}
    for name, shape in whole_shapes(cfg).items():
        if name not in names:
            continue
        stage = block_stage(name, cfg.depth, par.pipe)
        if stage is None:
            t = pmesh.full_tensor(name, tensors[name], par, heads)
        else:
            if stage == par.pipe_rank:
                t = pmesh.full_tensor(name, tensors[name], par, heads)
            else:
                t = torch.empty(shape, dtype=dtype,
                                device="cpu" if lk.gloo else dev)
            t = lk.broadcast(t, stage)
        out[name] = t.detach().to("cpu", copy=True)
    return out
