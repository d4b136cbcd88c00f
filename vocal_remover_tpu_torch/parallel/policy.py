"""Parameter partitioning policy: tensor (model) parallelism rules.

Counterpart of vocal_remover_tpu/parallel/policy.py, on the port's
modules. The rule is JAX's, applied to the JAX variables path of each
state-dict entry (models/convert.py's name map):

  * conv kernels — output channels (OIHW dim 0) sharded over `model`.
    A sharded conv computes its own slice of the channels, its batch
    norm and activation run on that slice, and the channels are then
    all-gathered, so every consumer sees full channels, as GSPMD's
    inserted all-gather does (collectives.py for the two ends' backward).
  * the BN vectors beside a sharded conv (weight, bias, running mean and
    variance) — the same channel axis.
  * everything else (LSTM, dense head, non-divisible layers) —
    replicated.

A dimension is sharded only when it divides by `n_model` with at least
2 rows a shard. Gradients of sharded parameters stay local, and Adam's
state follows its parameters. Data parallelism is installed here too:
train-mode batch norm takes its statistics over the data group, and
channel dropout draws the global batch's mask and keeps this rank's rows.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.nn.layers import (
    ASPPModule,
    BatchNorm,
    Conv2d,
    Conv2DBNActiv,
    Decoder,
)
from vocal_remover_tpu_torch.parallel import collectives
from vocal_remover_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_rank,
    axis_size,
)

__all__ = ["tp_partition_spec", "shard_variables", "unsharded"]


def tp_partition_spec(name: str, tensor, n_model: int) -> int | None:
    """The sharded dim of state-dict entry `name` under tensor
    parallelism over `n_model` ranks (0: OIHW output channels or a BN
    vector), or None (replicated): what JAX's rule decides for the same
    leaf."""
    path = convert._jax_path(name)
    if path is None or n_model <= 1:
        return None
    ndim = tensor.dim()

    def divisible(n):
        return n % n_model == 0 and n >= 2 * n_model

    if path[-1] == "conv" and ndim == 4 and divisible(tensor.shape[0]):
        return 0
    if (len(path) >= 2 and path[-2] == "bn"
            and path[-1] in ("scale", "bias", "mean", "var")
            and ndim == 1 and divisible(tensor.shape[0])):
        return 0
    return None


class ModelShard:
    """This rank's share of an output-channel sharded layer: rows
    [rank * k, (rank + 1) * k) of `full` channels over the model group."""

    def __init__(self, group, rank: int, size: int, full: int):
        self.group, self.rank, self.size, self.full = group, rank, size, full
        self.width = full // size

    def local(self, t):
        lo = self.rank * self.width
        return t[lo:lo + self.width].clone()

    def whole(self, t):
        return collectives.all_gather_rows(t, self.group)

    def enter(self, x):
        return collectives.enter_model(x, self.group)

    def gather(self, y):
        return collectives.gather_channels(y, self.group, self.rank)


def shard_variables(mesh, model: nn.Module) -> nn.Module:
    """Lay `model` out on the mesh, in place: batch norm's train-mode
    statistics and channel dropout over the data axis, and with a model
    axis of 2 or more ranks the policy's slices kept and the gathers
    installed. With no model axis (or one of size 1) the parameters stay
    whole: the data-parallel layout. Every rank passes the same model;
    mesh.replicate makes sure of it."""
    data_group = axis_group(mesh, DATA_AXIS)
    shard = (axis_rank(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = data_group
        elif isinstance(m, (Decoder, ASPPModule)):
            m.data_shard = shard
    n_model = axis_size(mesh, MODEL_AXIS)
    if n_model < 2:
        return model
    group, rank = axis_group(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    specs = {k: tp_partition_spec(k, v, n_model)
             for k, v in model.state_dict().items()}
    leaves = []
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, Conv2DBNActiv):
                conv, bn = m.conv[0], m.conv[1]
                w = f"{name}.conv.0.weight"
                bns = [f"{name}.conv.1.{k}" for k in
                       ("weight", "bias", "running_mean", "running_var")]
                if {specs[w], *(specs[k] for k in bns)} == {None}:
                    continue
                if specs[w] != 0 or any(specs[k] != 0 for k in bns):
                    raise ValueError(f"{name}: conv and batch norm sharded "
                                     "differently")
                owners = [(conv, "weight"), (bn, "weight"), (bn, "bias"),
                          (bn, "running_mean"), (bn, "running_var")]
            elif isinstance(m, Conv2d) and name in ("out", "aux_out"):
                if specs[f"{name}.weight"] is None:
                    continue
                owners = [(m, "weight")]
            else:
                continue
            m.tp = ModelShard(group, rank, n_model,
                              owners[0][0].weight.shape[0])
            for owner, attr in owners:
                t = getattr(owner, attr)
                t.data = m.tp.local(t.data)
                leaves.append((owner, attr, m.tp))
    handled = {id(getattr(o, a)) for o, a, _ in leaves}
    left = [k for k, t in model.state_dict(keep_vars=True).items()
            if specs[k] is not None and id(t) not in handled]
    if left:
        raise ValueError(f"sharded entries without a sharded layer: {left}")
    model._tp_leaves = leaves
    return model


@contextlib.contextmanager
def unsharded(model: nn.Module, optimizer=None):
    """Within the block, every sharded parameter and buffer of `model`
    (and each parameter's optimizer state) holds its full tensor,
    gathered over the model group (a collective: every rank enters);
    on exit each is cut back to this rank's slice, so what the block
    loaded is what the ranks keep. A no-op on an unsharded model."""
    leaves = getattr(model, "_tp_leaves", None)
    if not leaves:
        yield
        return

    def states(t):
        if optimizer is None or not isinstance(t, nn.Parameter):
            return {}
        return optimizer.state.get(t, {})

    def swap(fn, shape_of):
        for owner, attr, shard in leaves:
            t = getattr(owner, attr)
            st = states(t)
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() and v.shape[0] == shape_of(
                        shard):
                    st[k] = fn(shard, v)
            t.data = fn(shard, t.data)

    with torch.no_grad():
        swap(ModelShard.whole, lambda s: s.width)
    try:
        yield
    finally:
        with torch.no_grad():
            swap(ModelShard.local, lambda s: s.full)
