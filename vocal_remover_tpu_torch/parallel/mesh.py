"""The (data, model) device mesh and batch placement.

Counterpart of vocal_remover_tpu/parallel/mesh.py. The mesh is
torch.distributed's `DeviceMesh` over the world's ranks (one a card, or
CPU ranks on gloo), with the axes ("data", "model"), so that each axis
has its own process group; the math runs explicit collectives on those
groups (collectives.py, policy.py), not DTensor.

  data  — batch / patch axis (data parallelism; the CLIs' --data_parallel)
  model — output-channel sharding of the convs (tensor parallelism,
          policy.py)
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from vocal_remover_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_data: int | None = None, n_model: int = 1):
    """A (data, model) DeviceMesh over the world's ranks (None: all of
    them along data). Joins a world of this one process when no process
    group is up (distributed.initialize; the caller's `shutdown` ends
    it). The port runs one process per card, so a mesh takes every rank
    of the world."""
    distributed.initialize()
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model > world:
        raise AssertionError(
            f"requested {n_data}x{n_model} mesh but only {world} devices")
    if n_data * n_model != world:
        raise ValueError(
            f"requested {n_data}x{n_model} mesh in a world of {world} "
            "ranks: the port runs one process per card, so a mesh takes "
            "every rank (launch as many processes as the mesh has cards)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


@contextlib.contextmanager
def data_parallel_mesh(n: int, device):
    """The CLIs' `--data_parallel n` mesh: (n x 1) over the world's
    ranks (0: all of them), or None for 1. The process group is joined
    on `device`'s backend (NCCL for a card, gloo for the CPU) and, if
    this made it, ended on exit."""
    if n == 1:
        yield None
        return
    owns = distributed.initialize(device=device)
    try:
        yield make_mesh(n_data=n if n > 0 else None, n_model=1)
    finally:
        if owns:
            distributed.shutdown()


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def mesh_device(mesh) -> torch.device:
    """This rank's device: its card (the current CUDA device, which
    distributed.initialize set) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_rows(mesh, a, whole_ok: bool = False):
    """This rank's slice of dim 0 of a host array or tensor along its
    data coordinate. A batch that does not divide by the data axis
    raises, as JAX's batch sharding does; with `whole_ok` it is returned
    whole instead (every rank then computes all of it)."""
    n = axis_size(mesh, DATA_AXIS)
    m = a.shape[0]
    if m % n:
        if whole_ok:
            return a
        raise ValueError(
            f"batch sharding over the {n} ranks of the mesh's "
            f"'{DATA_AXIS}' axis implies that the global size of its "
            f"dimension 0 should be divisible by {n}, but it is equal to "
            f"{m} (full shape: {tuple(a.shape)})")
    k = m // n
    r = axis_rank(mesh, DATA_AXIS)
    return a[r * k:(r + 1) * k]


def shard_batch(mesh, *arrays):
    """Host batches (numpy arrays or tensors, or dicts of them such as
    the int8 staging {"q": ..., "scale": ...}) -> this rank's slice of
    dim 0 along its data coordinate, as tensors on its device. Scalars
    and 0-d leaves stay whole."""
    dev = mesh_device(mesh)

    def put(a):
        if isinstance(a, dict):
            return {k: put(v) for k, v in a.items()}
        if torch.is_tensor(a):
            t = a
        else:
            a = np.asarray(a)
            t = torch.from_numpy(np.ascontiguousarray(a) if a.ndim else a)
        if t.dim() > 0:
            t = local_rows(mesh, t)
        return t.to(dev)

    out = tuple(put(a) for a in arrays)
    return out if len(out) > 1 else out[0]


@torch.no_grad()
def replicate(mesh, tree):
    """Broadcast a module's parameters and buffers (or the tensors of a
    dict / list) in place from rank 0 of this rank's data axis; returns
    `tree`."""
    group = axis_group(mesh, DATA_AXIS)
    src = dist.get_global_rank(group, 0)
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    for t in tensors:
        if t is not None and t.numel():
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter)
                           else t, src=src, group=group)
    return tree
