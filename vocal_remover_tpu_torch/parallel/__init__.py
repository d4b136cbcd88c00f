"""Parallelism on torch.distributed: process groups, the (data, model)
mesh, the tensor-parallel policy and the collectives they use.

Counterpart of vocal_remover_tpu/parallel/. JAX runs one controller over
a mesh of devices; the port runs one process (rank) per card, so JAX's
devices are the port's ranks and JAX's processes are the port's nodes
(distributed.py). The math of a mesh is the single-device math: the loss
and batch norm's statistics are those of the global batch.
"""
