"""Megatron tensor and sequence parallelism for the ViT's blocks.

The port of what GSPMD inserts in the JAX package from its partition
specs (``maest_tpu/parallel/mesh.py::param_spec``; here
``mesh._tp_rule`` and ``tp_slice``) and its sequence
constraint (``maest_tpu/models/vit.py::Block._seq_shard``), written out as
autograd functions over a process group:

* tensor parallelism (``model`` ranks > 1): qkv and fc1 hold their output
  rows for this rank's heads / hidden columns, proj and fc2 their input
  columns. A block's input enters each region through ``copy_to`` (the
  identity; its backward sums the input gradients over the group), and
  each region leaves through ``reduce_from`` (a sum over the group; its
  backward is the identity): one all-reduce after proj and one after fc2
  in the forward, one before qkv and one before fc1 in the backward;
* sequence parallelism on top (``sequence_parallel``): between the
  regions the residual stream is token-sharded over the group, so the
  LayerNorms, dropout, drop_path and the residual adds run on 1/M of the
  tokens. A region enters through an all-gather of the tokens (its
  backward a reduce-scatter) and leaves through a reduce-scatter (its
  backward an all-gather). The token count need not divide M: the stream
  is padded to a multiple of M with zero rows, which no key, query or
  LayerNorm statistic of a real token ever reads (LayerNorm is per
  token, and the gathered stream is cut back to the real tokens before
  qkv and fc1).

Sums run in float32 whatever the compute dtype, so two bf16 partial
products are rounded once, as the one-device product is.

``Layout`` tells the model which slice of the global tensors its own
tensors are, so that dropout and drop_path draw their masks at the
global shape and keep this rank's slice: every layout draws the masks a
single process draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.float().contiguous()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in rank order."""
    size = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum ``x`` over the group and keep this rank's chunk along ``dim``
    (float32 sums)."""
    size = dist.get_world_size(group)
    parts = [p.float().contiguous() for p in x.chunk(size, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(x.dtype)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=dim)[
        dist.get_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTokens(torch.autograd.Function):
    """Forward all-gather of the token shards; backward reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, 1, ctx.group), None


class _ScatterTokens(torch.autograd.Function):
    """Forward reduce-scatter to token shards; backward all-gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, 1, ctx.group), None


class _SplitTokens(torch.autograd.Function):
    """Forward: keep this rank's token chunk of a stream every rank holds;
    backward: all-gather the chunks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _chunk(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, 1, ctx.group), None


class _UnsplitTokens(torch.autograd.Function):
    """Forward: all-gather the token chunks into a stream every rank then
    uses alike; backward: keep this rank's chunk of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, 1, ctx.group), None


def _pad_tokens(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    return x if x.shape[1] == n_pad else F.pad(
        x, (0, 0, 0, n_pad - x.shape[1]))


@dataclass
class Layout:
    """Where this rank's tensors sit in the global ones.

    ``data_rank`` of ``data`` ranks hold consecutive row blocks of the
    global batch; ``model`` ranks (group ``model_group``, this one
    ``model_rank``) split the heads and hidden columns, and with
    ``sequence_parallel`` the tokens between the blocks' regions."""

    data: int = 1
    data_rank: int = 0
    model: int = 1
    model_rank: int = 0
    model_group: Optional[object] = None
    sequence_parallel: bool = False

    @property
    def tensor_parallel(self) -> bool:
        return self.model > 1

    @property
    def sp(self) -> bool:
        return self.sequence_parallel and self.model > 1

    # -- the region seams -------------------------------------------------
    def enter(self, x: torch.Tensor, n_tokens: int) -> torch.Tensor:
        """A block's stream into qkv / fc1: the full ``n_tokens`` rows."""
        if not self.tensor_parallel:
            return x
        if self.sp:
            return _GatherTokens.apply(x, self.model_group)[:, :n_tokens]
        return _CopyTo.apply(x, self.model_group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """proj / fc2's partial products (before their bias) back to the
        stream: summed over the group, token-sharded under SP."""
        if not self.tensor_parallel:
            return x
        if self.sp:
            return _ScatterTokens.apply(
                _pad_tokens(x, self.padded(x.shape[1])), self.model_group)
        return _ReduceFrom.apply(x, self.model_group)

    def padded(self, n_tokens: int) -> int:
        return -(-n_tokens // self.model) * self.model

    def split_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The stream before the first block -> this rank's token shard
        (SP only)."""
        if not self.sp:
            return x
        return _SplitTokens.apply(_pad_tokens(x, self.padded(x.shape[1])),
                                  self.model_group)

    def gather_tokens(self, x: torch.Tensor, n_tokens: int) -> torch.Tensor:
        """A token shard -> the full stream of ``n_tokens`` rows (SP
        only)."""
        if not self.sp:
            return x
        return _UnsplitTokens.apply(x, self.model_group)[:, :n_tokens]

    # -- the global slices of dropout masks -------------------------------
    def rows(self, b: int) -> tuple:
        """(dim, start, full) of a local batch of ``b`` rows."""
        if self.data == 1:
            return ()
        return ((0, self.data_rank * b, self.data * b),)

    def token_shard(self, n_local: int, n_tokens: int) -> tuple:
        """(dim 1, start, full) of a token shard (SP), else ()."""
        if not self.sp:
            return ()
        return ((1, self.model_rank * n_local, n_tokens),)

    def columns(self, dim: int, n_local: int) -> tuple:
        """(dim, start, full) of this rank's heads / hidden columns."""
        if not self.tensor_parallel:
            return ()
        return ((dim, self.model_rank * n_local, self.model * n_local),)


def masked_keep(shape, shard: tuple, keep: float, device, dtype,
                generator: torch.Generator) -> torch.Tensor:
    """A Bernoulli(``keep``) mask of the local ``shape``, drawn at the
    global shape ``shard`` describes ((dim, start, full) triples) and cut
    to this rank's slice; rows past ``full`` (the padding of a token
    shard) keep."""
    full = list(shape)
    for dim, start, n in shard:
        full[dim] = n
    mask = torch.empty(full, device=device, dtype=dtype).bernoulli_(
        keep, generator=generator)
    for dim, start, _ in shard:
        need = start + shape[dim]
        if need > mask.shape[dim]:
            pad = [0, 0] * (mask.ndim - 1 - dim) + [0, need - mask.shape[dim]]
            mask = F.pad(mask, pad, value=1.0)
        mask = mask.narrow(dim, start, shape[dim])
    return mask
