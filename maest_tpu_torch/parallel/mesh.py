"""Process group, mesh and parameter sharding, port of
``maest_tpu/parallel/mesh.py``.

The reference's only parallelism is DDP over NCCL (reference:
ex_maest.py:57, ex_maest519.sh:3-9). The JAX package adds a ``model``
mesh axis for Megatron tensor parallelism and ZeRO-3 sharding over the
``data`` axis, with XLA inserting the collectives. Here each rank is one
process: ``init_distributed`` joins the process group from torchrun's
variables, ``make_mesh`` lays the ranks out as a ``(data, model)``
``DeviceMesh``, and ``shard_params`` cuts a full model into this rank's
part: its heads and hidden columns over ``model`` (head-aligned, so the
attention kernels run on whole heads) and, under FSDP, ZeRO-3 shards of
every parameter over ``data`` by FSDP2's ``fully_shard``.

The JAX helpers ``replicated``, ``batch_sharding``, ``ensure_on_mesh`` and
``param_shardings`` place JAX arrays on a mesh; a rank's torch tensors
are already where they live, so they have no counterpart.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .tensor_parallel import Layout

_logger = logging.getLogger("maest_tpu_torch.parallel")

_LAUNCH = ("launch the ranks with torchrun (RANK, WORLD_SIZE, LOCAL_RANK, "
           "MASTER_ADDR, MASTER_PORT) or with `python -m "
           "maest_tpu_torch.apps.ex_maest <command> with ... "
           "trainer.devices=N`")


def init_distributed(device="cuda", store=None) -> int:
    """Join the process group of a torchrun launch; returns the rank.

    A no-op returning 0 when no launch variable is set (one process) or
    the group already exists. ``WORLD_SIZE`` or ``RANK`` set without
    ``MASTER_ADDR`` raises ``ValueError``: the ranks must never train as
    independent single runs. On the card the rank's device is
    ``cuda:LOCAL_RANK mod visible cards``; the backend is NCCL when each
    local rank has a card of its own, gloo (on CUDA tensors) when ranks
    share a card, and gloo on the CPU only for ``device="cpu"``.
    ``store``: the rendezvous store to meet on in place of
    ``MASTER_ADDR:MASTER_PORT`` (re-forming a group)."""
    env = os.environ
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    if not (env.get("WORLD_SIZE") or env.get("RANK")):
        return 0
    if not env.get("MASTER_ADDR"):
        raise ValueError(
            "init_distributed: WORLD_SIZE/RANK are set but MASTER_ADDR is "
            "not; " + _LAUNCH)
    world = int(env.get("WORLD_SIZE", "1"))
    rank = int(env.get("RANK", "0"))
    local = int(env.get("LOCAL_RANK", str(rank)))
    device = torch.device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device='cuda' requested but torch finds no "
                               "CUDA device")
        torch.cuda.set_device(local % cards)
        local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
        backend = "nccl" if local_world <= cards else "gloo"
    else:
        backend = "gloo"
    port = env.get("MASTER_PORT", "29500")
    meet = ({"store": store} if store is not None else
            {"init_method": f"tcp://{env['MASTER_ADDR']}:{port}"})
    dist.init_process_group(backend, world_size=world, rank=rank, **meet)
    _logger.info("rank %d of %d joined over %s (%s)", rank, world, backend,
                 "CUDA tensors" if device.type == "cuda" else "CPU")
    return rank


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: str = "cuda"):
    """A ``(data, model)`` ``DeviceMesh`` over the first ``n_devices``
    ranks of the process group (all of them by default): rank = data
    index * model_parallel + model index, as the JAX mesh's reshape."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(
            f"requested {n_devices} devices but only {world} ranks were "
            f"launched; {_LAUNCH}")
    model_parallel = int(model_parallel or 1)
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model_parallel={model_parallel}")
    if n_devices != world:
        raise ValueError(
            f"trainer.devices={n_devices} but {world} ranks were launched: "
            "every rank of the group takes part in the mesh")
    grid = torch.arange(world).view(world // model_parallel, model_parallel)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def make_mesh_for(devices: Optional[int], device="cuda"):
    """The ``(data, model)`` mesh of ``devices`` ranks (data parallel)
    inside a launched process group, joined here; None for one (the
    ``--devices`` of the tagging and serving CLIs)."""
    if not devices or devices <= 1:
        return None
    init_distributed(device)
    return make_mesh(devices, 1, torch.device(device).type)


@dataclass
class Parallel:
    """A rank's place in the mesh and the modes it trains in. The mesh is
    ``(data, model)`` (``make_mesh``) or, for a pipeline,
    ``(data, pipe, model)`` (``pipeline.make_pipeline_mesh``); ``pipe``
    is 1 without one."""

    mesh: object  # DeviceMesh ("data", ["pipe",] "model")
    fsdp: bool = False
    sequence_parallel: bool = False

    def __post_init__(self):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        names = self.mesh.mesh_dim_names
        for dim in ("data", "pipe", "model"):
            if dim in names:
                size = self.mesh.size(names.index(dim))
                rank = self.mesh.get_local_rank(dim)
                group = self.mesh.get_group(dim)
            else:
                size, rank, group = 1, 0, None
            setattr(self, dim, size)
            setattr(self, f"{dim}_rank", rank)
            setattr(self, f"{dim}_group", group)
        # JAX: SP is active only over a model axis of more than one device
        self.sequence_parallel = bool(self.sequence_parallel
                                      and self.model > 1)

    def layout(self) -> Layout:
        return Layout(data=self.data, data_rank=self.data_rank,
                      model=self.model, model_rank=self.model_rank,
                      model_group=self.model_group,
                      sequence_parallel=self.sequence_parallel)

    def describe(self) -> str:
        modes = [f"data {self.data}", f"model {self.model}"]
        if self.pipe > 1:
            modes.insert(1, f"pipe {self.pipe}")
        if self.fsdp:
            modes.append("fsdp")
        if self.sequence_parallel:
            modes.append("sp")
        return f"{' x '.join(modes)} over {dist.get_backend()}"


# -- tensor-parallel slices ---------------------------------------------------

def _tp_rule(name: str):
    """How tensor parallelism splits parameter ``name`` (the torch layout,
    (out, in)): "qkv" head-aligned over qkv's (3, heads, head_dim) output
    rows, "rows" / "cols" a contiguous split of dim 0 / 1, or None
    (replicated). qkv and fc1 split their outputs (bias included), proj
    and fc2 their inputs; proj's inputs are ordered (heads, head_dim), so a
    contiguous split of them is head-aligned."""
    if not name.startswith("blocks."):
        return None
    if ".attn.qkv." in name:
        return "qkv"
    if name.endswith(".mlp.fc1.weight") or name.endswith(".mlp.fc1.bias"):
        return "rows"
    if name.endswith(".attn.proj.weight") or name.endswith(".mlp.fc2.weight"):
        return "cols"
    return None


def _qkv_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.reshape(3, heads, -1, *t.shape[1:])


def tp_slice(name: str, full: torch.Tensor, heads: int, rank: int,
             size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s part of the full parameter ``name``."""
    rule = _tp_rule(name)
    if rule is None or size == 1:
        return full
    if rule == "qkv":
        if heads % size:
            raise ValueError(f"{heads} heads do not divide over "
                             f"model_parallel={size}")
        part = _qkv_view(full, heads).chunk(size, dim=1)[rank]
        return part.reshape(-1, *full.shape[1:]).contiguous()
    dim = 0 if rule == "rows" else 1
    if full.shape[dim] % size:
        raise ValueError(f"{name} {tuple(full.shape)} does not divide over "
                         f"model_parallel={size}")
    return full.chunk(size, dim=dim)[rank].contiguous()


def tp_unslice(name: str, parts: list, heads: int) -> torch.Tensor:
    """The full parameter ``name`` from every model rank's part, in rank
    order."""
    rule = _tp_rule(name)
    if rule is None or len(parts) == 1:
        return parts[0]
    if rule == "qkv":
        local = heads // len(parts)
        full = torch.cat([_qkv_view(p, local) for p in parts], dim=1)
        return full.reshape(-1, *parts[0].shape[1:])
    return torch.cat(parts, dim=0 if rule == "rows" else 1)


# -- sharding a model -------------------------------------------------------

def _fsdp_units(net):
    """FSDP2's units: every block a rank holds, and the root with the
    rest, unless the net is cut to a pipeline stage (whose embeddings and
    heads stay replicated over the data ranks)."""
    blocks = [b for b in net.blocks if any(True for _ in b.parameters())]
    return blocks if getattr(net, "stage", None) else blocks + [net]


def shard_params(net, par: Parallel):
    """Cut the full model ``net`` (every rank holds the same weights) into
    this rank's part, in place: under a pipeline its stage's blocks
    (``pipeline.cut_to_stage``); its model rank's heads and hidden columns
    (``Attention``/``Mlp`` then run on local heads and columns, with the
    region seams of ``parallel.tensor_parallel``); and under FSDP a
    ``fully_shard`` unit per block (plus the root without a pipeline)
    over the data ranks."""
    heads = net.cfg.num_heads
    if par.pipe > 1:
        from .pipeline import cut_to_stage

        cut_to_stage(net, par)
    layout = par.layout()
    net.set_layout(layout)
    if par.model > 1:
        with torch.no_grad():
            for name, p in net.named_parameters():
                if _tp_rule(name) is not None:
                    p.data = tp_slice(name, p.data, heads, par.model_rank,
                                      par.model)
    if par.fsdp:
        from torch.distributed.fsdp import fully_shard

        data_mesh = par.mesh["data"]
        for unit in _fsdp_units(net):
            # the root too gathers anew each forward: the eval swaps SWA
            # shards into the parameters between two forwards
            fully_shard(unit, mesh=data_mesh, reshard_after_forward=True)
    return net


def acts_on_token_shards(name: str) -> bool:
    """Under sequence parallelism, parameter ``name`` acts on this rank's
    token shard only (the blocks' LayerNorms, the biases after proj and
    fc2), so its gradient is a partial sum over the model ranks."""
    return name.startswith("blocks.") and (
        ".norm1." in name or ".norm2." in name
        or name.endswith(".attn.proj.bias") or name.endswith(".mlp.fc2.bias"))


def is_fsdp(net) -> bool:
    """Whether ``fully_shard`` manages ``net``'s parameters."""
    return any(is_sharded(p) for p in net.parameters())


class swapped_params:
    """Within the block, ``net``'s parameters hold ``values`` (name ->
    tensor of the parameter's layout); they are put back after. For FSDP
    modules, whose forward gathers the parameters' shards: the shards are
    swapped, the units resharded before and after."""

    def __init__(self, net, values: dict):
        self.net, self.values, self.saved = net, values, {}

    def _reshard(self):
        for unit in _fsdp_units(self.net):
            if hasattr(unit, "reshard"):
                unit.reshard()

    def __enter__(self):
        self._reshard()
        with torch.no_grad():
            for name, p in self.net.named_parameters():
                dst = local(p)
                self.saved[name] = dst.clone()
                dst.copy_(local(self.values[name]))
        return self.net

    def __exit__(self, *exc):
        self._reshard()
        with torch.no_grad():
            for name, p in self.net.named_parameters():
                local(p).copy_(self.saved.pop(name))
        return False


def is_sharded(t) -> bool:
    """A DTensor (an FSDP shard)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's own tensor of ``t`` (a DTensor's local shard)."""
    return t.to_local() if is_sharded(t) else t


def _gather_shards(t) -> torch.Tensor:
    """An FSDP2 DTensor's whole tensor from its dim-0 shards (torch.chunk's
    split, the last shards short or empty), by one all-gather over its
    mesh. ``DTensor.full_tensor``'s functional collectives crash over gloo
    on CUDA tensors (a segmentation fault with torch 2.11 and CUDA 12.8 on
    an H100), which is the transport of ranks that share a card."""
    from torch.distributed.tensor import Shard

    if tuple(t.placements) != (Shard(0),):
        raise ValueError(f"expected FSDP2's Shard(0), got {t.placements}")
    group = t.device_mesh.get_group()
    n = dist.get_world_size(group)
    rows = -(-t.shape[0] // n)
    mine = t.to_local()
    padded = mine.new_zeros((rows, *t.shape[1:]))
    padded[:mine.shape[0]] = mine
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded, group=group)
    return torch.cat(parts)[:t.shape[0]]


def full_tensor(name: str, t: torch.Tensor, par: Optional[Parallel],
                heads: int) -> torch.Tensor:
    """The whole parameter-shaped tensor ``name`` (a parameter, a moment,
    an SWA copy) from this rank's part: gathered over the data ranks
    (FSDP), then over the model ranks (TP). Every rank of the group must
    call it, in the same order."""
    t = t.detach()
    if is_sharded(t):
        t = _gather_shards(t)
    if par is not None and par.model > 1 and _tp_rule(name) is not None:
        parts = [torch.empty_like(t) for _ in range(par.model)]
        dist.all_gather(parts, t.contiguous(), group=par.model_group)
        t = tp_unslice(name, parts, heads)
    return t


def load_local(name: str, dst: torch.Tensor, full: torch.Tensor,
               par: Optional[Parallel], heads: int) -> None:
    """Copy this rank's part of the whole tensor ``full`` into ``dst``
    (a parameter, a moment or an SWA copy of parameter ``name``)."""
    if par is not None:
        full = tp_slice(name, full, heads, par.model_rank, par.model)
    if is_sharded(dst):
        size, rank = par.data, par.data_rank
        chunks = full.chunk(size, dim=0)
        part = chunks[rank] if rank < len(chunks) else full[:0]
        dst = dst.to_local()
        full = part
    if tuple(full.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch for {name}: "
                         f"{tuple(full.shape)} vs {tuple(dst.shape)}")
    dst.copy_(full)
