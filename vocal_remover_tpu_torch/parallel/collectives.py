"""The collectives of tensor parallelism, with the backward each needs.

GSPMD inserts these in the JAX package; here they are explicit calls on
the mesh's model group (batch norm's statistics over the data group are
nn/functional._SyncBatchNorm's):

  * `enter_model` / `gather_channels`: the two ends of an output-channel
    sharded layer. Every rank of the model axis holds the full input and
    computes the same loss; a sharded conv computes its own slice of the
    channels, which are then all-gathered. The gather's backward takes
    this rank's slice of the output gradient (each rank already holds the
    whole of it: a summed backward, torch.distributed.nn's all_gather,
    would give n_model times the gradient), and `enter_model`, the
    identity on the input, sums the input gradient over the group (each
    rank holds only its slice's part of it).
  * `all_gather_rows`: full tensors from dim-0 shards (no autograd), for
    gradients returned to the caller and for checkpoints.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def enter_model(x, group):
    """Identity; the backward sums the gradient over `group`."""
    return _EnterModel.apply(x, group)


def _gather(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.width = rank, x.shape[1]
        return _gather(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[:, lo:lo + ctx.width].contiguous(), None, None


def gather_channels(x, group, rank):
    """All-gather dim 1 (channels) over `group`; the backward takes this
    rank's slice of the gradient."""
    return _GatherChannels.apply(x, group, rank)


@torch.no_grad()
def all_gather_rows(x, group):
    """Concatenate the group's dim-0 shards, in rank order."""
    return _gather(x, group, 0)
