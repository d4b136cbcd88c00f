"""Process groups and per-node data sharding.

Counterpart of vocal_remover_tpu/parallel/distributed.py. The port runs
one process (rank) per card, as PyTorch does; JAX runs one process per
host over all of its chips. So a rank here is a JAX device and a node
(one host's ranks, torchrun's GROUP_RANK) is a JAX process:
`process_info` returns (node index, node count), and `shard_filelist` /
`host_seed` act across nodes only. Every rank of a node draws the same
global batch from the same loader seed and keeps its slice of it
(mesh.shard_batch), so N cards on one host train as one card does.

Deployment recipe (one process per card, launched by torchrun):

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m vocal_remover_tpu_torch.cli.train ... --data_parallel N

    from vocal_remover_tpu_torch.parallel import distributed, mesh
    distributed.initialize()                  # torchrun's environment
    m = mesh.make_mesh()                      # every rank of the world
    trainer = Trainer(model, ..., mesh=m)
    train_files = distributed.shard_filelist(train_files)  # across nodes
    loader = Loader(dataset, ..., seed=distributed.host_seed(seed))
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from vocal_remover_tpu_torch import resolve_device

def launched() -> bool:
    """True under torchrun (its RANK / WORLD_SIZE environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_rank() -> int:
    """This rank's index on its node (torchrun's LOCAL_RANK; 0 alone)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def rank() -> int:
    """This process's rank in the world: the process group's, else
    torchrun's RANK (a launch without a mesh), else 0."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 only."""
    return rank() == 0


def rank_device(gpu: int) -> torch.device:
    """The CLIs' device: the CPU for a negative `gpu`; under torchrun
    this rank's card, cuda:LOCAL_RANK; else card `gpu`. A card asked
    for and missing raises."""
    if gpu < 0:
        return resolve_device("cpu")
    if launched():
        return resolve_device(f"cuda:{local_rank()}")
    return resolve_device(f"cuda:{gpu}")


def barrier():
    if dist.is_initialized():
        dist.barrier()


def _device(device) -> torch.device:
    """The card of this rank (cuda:LOCAL_RANK) where one is present, else
    the CPU; an explicit `device` is taken as it is."""
    if device is None:
        return torch.device(f"cuda:{local_rank()}"
                            if torch.cuda.is_available() else "cpu")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device(f"cuda:{local_rank()}")
    return dev


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None) -> bool:
    """Join the process group; True when this call made it (the caller
    then ends it with `shutdown`), False when one was up already.

    The backend is NCCL for a card and gloo for the CPU (`device`: None
    means this rank's card, cuda:LOCAL_RANK, where one is present; a
    card asked for and missing raises, as `resolve_device` does). With
    no addresses it joins the world that torchrun's environment
    describes (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK);
    without that environment it makes a world of this one process. With
    explicit arguments every failure propagates, as in the JAX package:
    a misconfigured launch never runs as N independent processes.
    `coordinator_address` is "host:port" (rank 0 listens there) or an
    init URL such as "file:///shared/path"."""
    if dist.is_initialized():
        return False
    dev = _device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None and num_processes is None:
        if launched():
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        return True
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return True


def shutdown():
    """Destroy the process group (and every mesh group made on it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info():
    """(node index, node count): torchrun's GROUP_RANK and WORLD_SIZE //
    LOCAL_WORLD_SIZE; outside torchrun each process of the group is a
    node, as a process of JAX's explicit `initialize` is (a world of one:
    (0, 1))."""
    env = os.environ
    if "GROUP_RANK" in env and "LOCAL_WORLD_SIZE" in env:
        return (int(env["GROUP_RANK"]),
                int(env["WORLD_SIZE"]) // int(env["LOCAL_WORLD_SIZE"]))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_filelist(filelist):
    """Disjoint per-node work: node i takes filelist[i::node_count].

    Stride sharding keeps the per-node share balanced for sorted lists;
    every rank must call this with the SAME input list. Returns the full
    list on a single node."""
    idx, count = process_info()
    if count == 1:
        return list(filelist)
    shard = list(filelist[idx::count])
    if not shard:
        raise ValueError(
            f"host {idx}/{count} received no files "
            f"({len(filelist)} total) — need >= one file per host"
        )
    return shard


def host_seed(seed: int) -> int:
    """Decorrelate host-side augmentation streams across nodes (the
    ranks of one node share it, and so draw the same global batch)."""
    idx, _ = process_info()
    return seed * 1_000_003 + idx


def host_shard_kwargs(seed: int = 0):
    """Loader kwargs for multi-node runs: a per-node shuffle seed. Use
    `shard_filelist` for the disjoint data split — a seed alone
    decorrelates sampling but does NOT partition work."""
    idx, count = process_info()
    return {"seed": host_seed(seed)} if count > 1 else {}
